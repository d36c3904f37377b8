"""Byrd-style penalty parameter update and the global penalty reset.

Port of ``sleqp_tpu/penalty.py`` (reference src/main/penalty.c): compare
the current average linearized violation with the best achievable one (a
FEAS-objective LP re-solve) and raise the penalty x10 (at most 100 times),
re-solving the LP from the previous basis, until the violation reduction
is acceptable.  The reference's ``lax.cond``s are branches on one read
(``lanes.lanes_any``: taken when any lane needs them, selected per lane)
and its ``lax.while_loop`` a ``lanes.lockstep`` loop.
"""

from __future__ import annotations

import torch

from .cauchy import CauchyResult, solve_cauchy_lp
from .iterate import Iterate, max0
from .lanes import lanes_any, lanes_where, lockstep
from .problem import ProblemData
from .types import LPSolver

Tensor = torch.Tensor

PENALTY_INCREASE = 10.0  # penalty.c:6
VIOLATION_TOL = 1e-8  # penalty.c:7
MIN_DECREASE = 0.1  # penalty.c:8
MAX_INCREASES = 100  # penalty.c:9


def update_penalty(
    data: ProblemData,
    it: Iterate,
    lp_trust_radius: Tensor,
    penalty: Tensor,
    current: CauchyResult,
    lp_solver: LPSolver = LPSolver.SIMPLEX,
    pdlp_tol: float = 1e-9,
    compute_dtype=None,
) -> tuple[Tensor, CauchyResult, Tensor]:
    """Returns (new_penalty, cauchy_result_at_new_penalty, changed).  When
    the penalty changes, the CauchyResult is the LP solve at the final
    penalty (trial_point/cauchy_step.c:150-166)."""
    m = it.cons_val.shape[0]
    assert m > 0
    unchanged = torch.zeros((), dtype=torch.bool, device=it.x.device)

    def solve_at(pen, basis, feas):
        # MIXED/FEAS re-solves never trigger the reduced resolve
        # (standard_cauchy.c:932-945, DEFAULT objective only)
        return solve_cauchy_lp(data, it, lp_trust_radius, pen, basis, feasibility_mode=feas,
                               lp_resolves=False, lp_solver=lp_solver, pdlp_tol=pdlp_tol,
                               compute_dtype=compute_dtype)

    # skip when already (linearly) feasible enough (penalty.c:30-37)
    skip = penalty_skip(current, m)
    if not lanes_any(~skip):
        return penalty, current, unchanged

    keep, achievable, inf_viol = penalty_keep(current, solve_at(penalty, current.basis, True), m)
    if not lanes_any(~keep):
        return penalty, current, unchanged

    def body(s, trip):
        pen = s[0] * PENALTY_INCREASE
        result = solve_at(pen, s[1].basis, False)
        return pen, result, penalty_ok(current, result, achievable, inf_viol, m)

    pen, result, _ = lockstep(lambda s: ~s[2], body, (penalty, current, keep),
                              max_trips=MAX_INCREASES, first=~keep)
    pen, result = lanes_where(~keep, (pen, result), (penalty, current))
    return pen, result, ~keep


def penalty_skip(current: CauchyResult, m: int) -> Tensor:
    """Whether the update is skipped: the LP step is (linearly) feasible
    enough (penalty.c:30-37)."""
    return current.violation / m <= VIOLATION_TOL


def penalty_keep(current: CauchyResult, feas: CauchyResult, m: int):
    """(whether the penalty stays, whether a feasible linearization is
    achievable, the best violation) from the feasibility LP ``feas``: if
    even the best violation is above tolerance and no progress is
    possible, the penalty stays (penalty.c:100-110)."""
    cur_viol = current.violation / m
    inf_viol = feas.violation / m
    achievable = inf_viol <= VIOLATION_TOL
    keep = penalty_skip(current, m) | ((~achievable) & (cur_viol - inf_viol <= VIOLATION_TOL))
    return keep, achievable, inf_viol


def penalty_ok(current: CauchyResult, result: CauchyResult, achievable: Tensor,
               inf_viol: Tensor, m: int) -> Tensor:
    """Whether the LP at the increased penalty reduces the violation
    enough (penalty.c:112-150)."""
    cur_viol = current.violation / m
    next_viol = result.violation / m
    return torch.where(achievable, next_viol <= VIOLATION_TOL,
                       (cur_viol - next_viol) >= MIN_DECREASE * (cur_viol - inf_viol))


# Global penalty reset constants (trial_point/cauchy_step.c:15-17)
ALLOWED_DUAL_FACTOR = 1000.0
ALLOWED_DUAL_OFFSET = 1.0
PENALTY_OFFSET = 10.0


def global_penalty_reset(it: Iterate, penalty: Tensor, allow_reset: Tensor):
    """Reset an inflated penalty once feasible for several steps
    (trial_point/cauchy_step.c:55-79).  Returns (penalty, did_reset)."""
    dual_norm = torch.maximum(max0(it.cons_dual.abs()), max0(it.vars_dual.abs()))
    max_allowed = ALLOWED_DUAL_FACTOR * (dual_norm + ALLOWED_DUAL_OFFSET)
    reset = allow_reset & (penalty > max_allowed)
    return torch.where(reset, dual_norm + PENALTY_OFFSET, penalty), reset
