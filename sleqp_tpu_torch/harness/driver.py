"""Suite driver emitting the reference CUTEst CSV schema.

Port of ``sleqp_tpu/harness/driver.py`` (src/test/cutest/
sleqp_cutest_driver.c:104-121): one CSV line per problem,

    name;nvars;ncons;status;obj;feas_res;slack_res;stat_res;iterations;
    seconds;boundary_step;trust_radius;min_rayleigh;max_rayleigh

plus solved-% accounting at the reference default tolerances.  Every
problem is built on the driver's device (``None`` means CUDA) and solved
there: the HS and medium entries by ``Solver``, the large banded entries
(``harness/large.py``) by the banded structured solve (``banded.py``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Iterable, Optional

import torch

from ..device import resolve_device
from ..settings import Settings
from ..iterate import max0
from ..solver import Solver
from ..types import LPSolver, Status
from ..banded import BandedProblem, banded_solve
from .hs import HS_PROBLEMS
from .hs import get_problem as _get_hs
from .large import LARGE_PROBLEMS
from .large import get_problem as _get_large
from .medium import MEDIUM_PROBLEMS
from .medium import get_problem as _get_medium


def get_problem(name: str, device: Any = None):
    """Look up a suite problem across the HS, medium and large registries,
    on ``device`` (None means CUDA)."""
    for lookup in (_get_hs, _get_medium, _get_large):
        try:
            return lookup(name, device)
        except KeyError:
            pass
    raise KeyError(name)


ALL_PROBLEMS = list(HS_PROBLEMS) + list(MEDIUM_PROBLEMS) + list(LARGE_PROBLEMS)

CSV_HEADER = (
    "name;nvars;ncons;status;obj;feas_res;slack_res;stat_res;iterations;"
    "seconds;boundary_step;trust_radius;min_rayleigh;max_rayleigh"
)

# Per-problem solver options (the reference CUTEst driver reads
# per-problem option files, sleqp_cutest_main.c:29-66).  hs62's objective
# is scaled by ~3e4, so the absolute stationarity tolerance needs
# derived scaling; hs111's working-set extraction needs the simplex LP's
# exact basis.  They apply over explicit settings, as in the reference.
_PROBLEM_OPTIONS: dict = {
    "hs62": {"scaling": "auto"},
    "hs111": {"lp_solver": "SIMPLEX"},
}


_STATUS_NAMES = {
    Status.OPTIMAL: "optimal",
    Status.INFEASIBLE: "infeasible",
    Status.UNBOUNDED: "unbounded",
    Status.ABORT_ITER: "iter_limit",
    Status.ABORT_TIME: "time_limit",
    Status.ABORT_DEADPOINT: "deadpoint",
    Status.ABORT_MANUAL: "aborted",
    Status.UNKNOWN: "unknown",
}


@dataclasses.dataclass
class SuiteResult:
    rows: list[str]
    solved: int
    total: int
    wrong_objective: list[str]

    @property
    def solved_fraction(self) -> float:
        return self.solved / max(self.total, 1)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _banded_slack_res(problem: BandedProblem, st) -> float:
    """Measured complementarity residual max |slack * lam| at the final
    state (iterate.c:241 analogue).  The delta-form update can leave nonzero
    duals on rows that have since left the working set, so the residual is
    NOT structurally zero and must be measured."""
    C = problem.cons(st.X)
    lo_fin = torch.isfinite(problem.cons_lb)
    up_fin = torch.isfinite(problem.cons_ub)
    dist_lo = torch.where(lo_fin, (C - problem.cons_lb).abs(), math.inf)
    dist_up = torch.where(up_fin, (problem.cons_ub - C).abs(), math.inf)
    slack = torch.minimum(dist_lo, dist_up)
    # rows with no finite bound must carry zero dual; count |lam| itself
    slack = torch.where(lo_fin | up_fin, slack, 1.0)
    return float(max0((slack * st.lam).abs()))


def _run_banded_problem(
    name: str,
    problem: BandedProblem,
    x0,
    f_opt,
    settings: Optional[Settings],
    max_iterations: int,
    time_limit: Optional[float] = None,
) -> tuple[str, bool, bool]:
    """Large banded entries (harness/large.py) solve through the structured
    path (banded.py) but emit the SAME CSV schema; the trust-radius column
    carries the Levenberg regularization (the structured analogue) and the
    Rayleigh columns are zero (no Krylov loop on this path).  ``banded_solve``
    runs ``banded_solve_jit``: on the card each row's new problem captures
    its iteration's CUDA graphs first, and the row's seconds include that
    warm-up and capture."""
    if time_limit is not None:
        raise ValueError(
            "time_limit is not supported for banded suite entries: the "
            "structured solve (banded_solve) reads no clock, as the "
            "reference's; bound work with max_iterations instead"
        )
    settings = settings or Settings()
    dev = problem.device
    synchronize(dev)
    start = time.perf_counter()
    st = banded_solve(problem, settings, X0=x0, max_iterations=max_iterations)
    synchronize(dev)
    seconds = time.perf_counter() - start
    status = Status(int(st.status))
    obj_val, feas, stat, reg = (float(v) for v in (st.obj_val, st.feas_res, st.stat_res, st.reg))
    row = ";".join(
        [
            name,
            str(problem.n),
            str(problem.m),
            _STATUS_NAMES.get(status, "unknown"),
            f"{obj_val:.10e}",
            f"{feas:.6e}",
            f"{_banded_slack_res(problem, st):.6e}",
            f"{stat:.6e}",
            str(int(st.iteration)),
            f"{seconds:.3f}",
            "false",
            f"{reg:.6e}",
            f"{0.0:.6e}",
            f"{0.0:.6e}",
        ]
    )
    solved = status == Status.OPTIMAL
    obj_ok = True
    if solved and f_opt is not None:
        obj_ok = abs(obj_val - f_opt) <= 1e-4 * (1.0 + abs(f_opt))
    return row, solved, obj_ok


def run_problem(
    name: str,
    settings: Optional[Settings] = None,
    max_iterations: int = 3000,
    time_limit: Optional[float] = None,
    device: Any = None,
) -> tuple[str, bool, bool]:
    """Solve one problem on ``device`` (None means CUDA); returns
    (csv_row, solved, objective_matches)."""
    problem, x0, f_opt = get_problem(name, resolve_device(device))
    if isinstance(problem, BandedProblem):
        return _run_banded_problem(name, problem, x0, f_opt, settings, max_iterations,
                                   time_limit=time_limit)
    opts = dict(_PROBLEM_OPTIONS.get(name, {}))
    scaling = opts.pop("scaling", None)
    if "lp_solver" in opts:
        base = settings if settings is not None else Settings()
        settings = base.replace(lp_solver=LPSolver[opts["lp_solver"]])
    solver = Solver(problem, x0, settings, scaling=scaling, device=problem.device)
    start = time.perf_counter()
    status = solver.solve(max_iterations=max_iterations, time_limit=time_limit)
    seconds = time.perf_counter() - start

    s = solver.state
    feas, slack, stat = solver.residuals()
    boundary, trust_radius, min_ray, max_ray = (
        float(v) for v in
        (s.boundary_step, s.trust_radius, s.min_rayleigh, s.max_rayleigh))
    row = ";".join(
        [
            name,
            str(problem.num_variables),
            str(problem.num_cons),
            _STATUS_NAMES.get(status, "unknown"),
            f"{solver.obj_val:.10e}",
            f"{feas:.6e}",
            f"{slack:.6e}",
            f"{stat:.6e}",
            str(solver.iterations),
            f"{seconds:.3f}",
            str(bool(boundary)).lower(),
            f"{trust_radius:.6e}",
            f"{min_ray:.6e}",
            f"{max_ray:.6e}",
        ]
    )
    solved = status == Status.OPTIMAL
    obj_ok = True
    if solved and f_opt is not None:
        obj_ok = abs(solver.obj_val - f_opt) <= 1e-4 * (1.0 + abs(f_opt))
    return row, solved, obj_ok


def run_suite(
    names: Optional[Iterable[str]] = None,
    settings: Optional[Settings] = None,
    max_iterations: int = 3000,
    verbose: bool = False,
    device: Any = None,
) -> SuiteResult:
    """``run_problem`` over ``names`` (the HS set by default) on
    ``device`` (None means CUDA)."""
    device = resolve_device(device)
    names = list(names) if names is not None else list(HS_PROBLEMS)
    rows = []
    solved = 0
    wrong = []
    for name in names:
        row, ok, obj_ok = run_problem(name, settings, max_iterations, device=device)
        rows.append(row)
        if verbose:
            print(row, flush=True)
        if ok and obj_ok:
            solved += 1
        elif ok and not obj_ok:
            wrong.append(name)
    return SuiteResult(rows=rows, solved=solved, total=len(names), wrong_objective=wrong)
