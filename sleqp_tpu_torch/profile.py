"""Per-phase time profile of one SLP-EQP iteration.

Port of ``sleqp_tpu/profile.py``.  The reference rolls wall-clock timers
of its phases into its final statistics (SURVEY.md §5.1;
solver/print.c:10-90, func.c:25-32, standard_aug_jac.c:26-27); this module
times each component of the iteration on its own at the initial iterate,
under the reference's keys:

* ``func_eval(all)``: ``Problem.eval_all``;
* ``cauchy_lp``: ``cauchy.solve_cauchy_lp`` (constrained problems only);
* ``kkt_factorization`` and ``kkt_substitution``: ``ops/kkt.py``'s
  ``aug_jac_create`` and ``solve_lsq``;
* ``working_step`` and ``eqp_solve``: ``newton.py``'s
  ``compute_working_step`` and ``compute_newton_step``;
* ``full_iteration``: ``problem_solver.perform_iteration``.

The reference jits each component and waits with ``block_until_ready``;
here each runs eagerly, once to warm up and then ``reps`` times between
two ``torch.cuda.synchronize()`` calls on the card (``time.perf_counter``
alone on the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from .cauchy import empty_basis, solve_box_cauchy, solve_cauchy_lp
from .device import resolve_device
from .newton import compute_newton_step, compute_working_step
from .ops.kkt import aug_jac_create, solve_lsq
from .problem import Problem
from .problem_solver import initial_state, perform_iteration
from .settings import Settings


def _time(fn, *args, reps: int = 5, device: torch.device) -> float:
    """Seconds per call of ``fn(*args)``, after one warm-up call."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / reps


def profile_iteration(problem: Problem, x0, settings: Optional[Settings] = None, reps: int = 5,
                      device: Any = None) -> dict[str, float]:
    """Seconds per component at the initial iterate (see the module's
    docstring).  ``device=None`` means CUDA; the problem is moved there."""
    settings = settings or Settings()
    problem = problem.to(resolve_device(device))
    dev = problem.device
    state = initial_state(problem, settings, x0, device=dev)
    it = state.it
    data = problem.data
    n, m = problem.num_variables, problem.num_cons

    def timed(fn, *args):
        return _time(fn, *args, reps=reps, device=dev)

    results: dict[str, float] = {}
    results["func_eval(all)"] = timed(problem.eval_all, it.x)

    if m > 0:
        def cauchy_lp(i, r, p):
            return solve_cauchy_lp(data, i, r, p, empty_basis(n, m, device=dev))

        results["cauchy_lp"] = timed(cauchy_lp, it, state.lp_trust_radius, state.penalty)
        cres = cauchy_lp(it, state.lp_trust_radius, state.penalty)
    else:
        cres = solve_box_cauchy(data, it, state.lp_trust_radius)
    var_states, cons_states = cres.var_states, cres.cons_states

    results["kkt_factorization"] = timed(aug_jac_create, it.cons_jac, var_states, cons_states)
    aug_jac = aug_jac_create(it.cons_jac, var_states, cons_states)
    results["kkt_substitution"] = timed(solve_lsq, aug_jac, -it.obj_grad)

    it_ws = dataclasses.replace(it, var_states=var_states, cons_states=cons_states)
    results["working_step"] = timed(compute_working_step, data, it_ws, aug_jac,
                                    state.trust_radius)
    ws = compute_working_step(data, it_ws, aug_jac, state.trust_radius)

    def eqp(i, aj, w, pen):
        return compute_newton_step(data, i, aj, w, lambda d: problem.hess_prod(i.x, d, i.cons_dual),
                                   pen, settings.max_newton_iterations,
                                   use_gltr=not problem.func.psd_hessian)

    results["eqp_solve"] = timed(eqp, it_ws, aug_jac, ws, state.penalty)
    results["full_iteration"] = timed(lambda s: perform_iteration(problem, settings, s), state)
    return results


def print_profile(results: dict[str, float]) -> None:
    total = results.get("full_iteration", 0.0)
    for name, seconds in results.items():
        pct = 100.0 * seconds / total if total else 0.0
        print(f"{name:20s} {1e3 * seconds:10.3f} ms  ({pct:5.1f}% of iter)")
