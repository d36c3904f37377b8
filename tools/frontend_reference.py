"""The JAX package's results for ``chip_smoke.py`` phase 14's restoration
and ``LSQFunc`` lanes and phase 17's front ends, on the CPU, written as
those phases' reference (the card's machine has no JAX).

* ``lanes``: ``sleqp_tpu.parallel.batch.batched_solve`` (200 iterations)
  of the Waechter-Biegler problem with ``restoration=True`` from
  ``chip_smoke.wachbieg_starts(4)`` and ``(64)``, of broydn100 from
  ``chip_smoke.broydn_starts()`` (B = 16) and of Rosenbrock as least
  squares from ``chip_smoke.ROSEN_LSQ_STARTS``: every lane's status,
  iterations and x.
* ``minimize``: ``sleqp_tpu.minimize`` on ``chip_smoke.minimize_cases``
  written with jax.numpy: status, fun, x, nit.
* ``solve_nl``: ``sleqp_tpu.harness.ampl.solve_nl`` on
  ``tests/test_ampl.py``'s HS71 text; ``cli_hs71``: the JSON line of
  ``python -m sleqp_tpu --hs hs71 --json``; ``checkpoint``: HS71's
  uninterrupted solve; ``deriv_check``: the findings on HS71 and on a wrong
  gradient; ``profile_keys``: ``profile_iteration``'s keys on HS71 and
  chainineq200.

Writes ``artifacts/frontends_jax_cpu.json``.  Usage, from the repository
root (~3 min, most of it JAX's compilation):

    python3 tools/frontend_reference.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy.optimize import LinearConstraint, NonlinearConstraint  # noqa: E402

import chip_smoke  # noqa: E402
import fixtures  # noqa: E402
from sleqp_tpu import Func, Problem, Settings  # noqa: E402
from sleqp_tpu.__main__ import main as cli_main  # noqa: E402
from sleqp_tpu.deriv_check import check_derivatives  # noqa: E402
from sleqp_tpu.harness.ampl import solve_nl  # noqa: E402
from sleqp_tpu.harness.driver import get_problem  # noqa: E402
from sleqp_tpu.minimize import minimize  # noqa: E402
from sleqp_tpu.parallel import batch as jbatch  # noqa: E402
from sleqp_tpu.problem_solver import initial_state, solve_jit  # noqa: E402
from sleqp_tpu.profile import profile_iteration  # noqa: E402

OUT = os.path.join(REPO, chip_smoke.FRONTENDS_REF)


def lanes():
    out = {}
    for name in ("wachbieg4", "wachbieg64", "broydn100", "rosenbrock_lsq"):
        if name.startswith("wachbieg"):
            problem = fixtures.wachbieg_problem()[0]
        elif name == "rosenbrock_lsq":
            problem = fixtures.rosenbrock_lsq_problem()[0]
        else:
            problem = get_problem(name)[0]
        starts = chip_smoke.lane_starts(name)
        state = jbatch.batched_solve(problem, Settings(), jnp.asarray(starts),
                                     max_iterations=chip_smoke.LANES_MAX_IT,
                                     restoration=name.startswith("wachbieg"))
        out[name] = dict(status=np.asarray(state.status).tolist(),
                         iterations=np.asarray(state.iteration).tolist(),
                         x=np.asarray(state.it.x).tolist())
        print(name, out[name]["status"], out[name]["iterations"], flush=True)
    return out


def minimize_results():
    def hs71(x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    cases = {
        "hs71_dict": (hs71, np.array([1.0, 5.0, 5.0, 1.0]), dict(
            bounds=[(1, 5)] * 4,
            constraints=[{"type": "ineq", "fun": lambda x: x[0] * x[1] * x[2] * x[3] - 25.0},
                         {"type": "eq", "fun": lambda x: jnp.vdot(x, x) - 40.0}])),
        "rosenbrock_numpy": (chip_smoke.np_rosenbrock, np.zeros(2), {}),
        "linear_constraint": (lambda x: -x[0] - 2.0 * x[1], np.zeros(2), dict(
            bounds=[(0, None), (0, None)],
            constraints=LinearConstraint(np.array([[1.0, 1.0]]), -np.inf, 1.0))),
        "nonlinear_constraint": (lambda x: x[0] ** 2 + x[1] ** 2, np.array([2.0, 0.0]), dict(
            constraints=NonlinearConstraint(lambda x: x[0] + x[1], 1.0, np.inf))),
    }
    assert set(cases) == set(chip_smoke.minimize_cases())
    out = {}
    for name, (fun, x0, kw) in cases.items():
        res = minimize(fun, x0, **kw)
        out[name] = dict(status=int(res.status), fun=float(res.fun),
                         x=np.asarray(res.x).tolist(), nit=int(res.nit))
        print(name, out[name], flush=True)
    return out


def front_ends():
    with tempfile.TemporaryDirectory() as tmp:
        nl = os.path.join(tmp, "hs71.nl")
        with open(nl, "w") as fh:
            fh.write(chip_smoke.hs71_nl_text())
        solver, status, obj = solve_nl(nl, max_iterations=100)
    nl_result = dict(status=status.name, objective=float(obj),
                     x=np.asarray(solver.solution).tolist(), iterations=solver.iterations)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(["--hs", "hs71", "--json"])
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    problem, x0, _ = fixtures.hs71_problem()
    full = solve_jit(problem, Settings(), initial_state(problem, Settings(), x0), 100)
    wrong = Problem(Func(lambda x: jnp.vdot(x, x), 2, obj_grad=lambda x: 3.0 * x))
    deriv = dict(hs71=check_derivatives(problem, x0),
                 wrong_gradient=check_derivatives(wrong, jnp.array([1.0, 2.0]),
                                                  raise_on_failure=False))
    keys = {}
    for name in ("hs71", "chainineq200"):
        p, x, _ = get_problem(name) if name != "hs71" else (problem, x0, None)
        keys[name] = list(profile_iteration(p, x, reps=1))
    return dict(solve_nl=nl_result, cli_hs71=cli,
                checkpoint=dict(status=int(full.status), iterations=int(full.iteration),
                                x=np.asarray(full.it.x).tolist()),
                deriv_check=deriv, profile_keys=keys)


def main():
    result = dict(lanes=lanes(), minimize=minimize_results(), **front_ends())
    with open(OUT, "w") as fh:
        json.dump(result, fh, indent=1)
        fh.write("\n")
    print("wrote", OUT)


if __name__ == "__main__":
    main()
