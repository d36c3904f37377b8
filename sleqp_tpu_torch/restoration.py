"""Restoration phase: minimize the constraint violation as a box-constrained LSQ.

Port of ``sleqp_tpu/restoration.py`` (reference src/main/restoration.c):
the restoration problem over (x, s) minimizes ``0.5 ||c(x) - s||^2`` with
s bounded by the constraint bounds and x by the variable bounds
(restoration.c:149,353-440), an ``LSQFunc`` solved by the same SLP-EQP
iteration (its Newton step is Gauss-Newton + LSQR).

Phase transforms follow solver/phase.c:194: entering restoration maps the
iterate x to (x, clip(c(x), cons bounds)); leaving takes the x block back.

With ``obj_lower = 0.5 feas_tol^2`` the restoration solve stops (status
UNBOUNDED) as soon as its residual guarantees a max violation <= feas_tol,
since |c_i - s_i| bounds the violation when s lies inside the bounds.

``solve_with_restoration`` is the reference's in-graph form: its
``lax.cond`` on the INFEASIBLE status is one ``lanes.lanes_any`` read and,
under ``torch.func.vmap`` (``parallel/batch.py``), lockstep restoration
and resumed solves (``solve_from``) in which only the lanes that need them
run, selected per lane at the end.  Outside ``vmap`` it is a branch on one
host read and its solves run ``solve_jit`` (on the card, CUDA graphs).
"""

from __future__ import annotations

import dataclasses

import torch

from .iterate import create_iterate, max_violation
from .lanes import is_batched, lanes_any, lanes_where
from .problem import LSQFunc, Problem
from .problem_solver import initial_state, solve_from, solve_jit
from .settings import Settings
from .types import Status

Tensor = torch.Tensor


def make_restoration_problem(problem: Problem) -> Problem:
    """The (x, s) restoration problem (restoration.c:353-440), on the
    problem's device."""
    n = problem.num_variables
    m = problem.num_cons
    assert m > 0, "restoration requires constraints"

    def residuals(z: Tensor) -> Tensor:
        return problem.cons_val(z[:n]) - z[n:]

    func = LSQFunc(residuals, num_variables=n + m, num_residuals=m)
    d = problem.data
    return Problem(func, var_lb=torch.cat([d.var_lb, d.cons_lb]),
                   var_ub=torch.cat([d.var_ub, d.cons_ub]), dtype=problem.dtype,
                   device=problem.device)


def restoration_initial_point(problem: Problem, x: Tensor) -> Tensor:
    """Optimization -> restoration transform (solver/phase.c)."""
    c = problem.cons_val(x)
    s = torch.minimum(torch.maximum(c, problem.data.cons_lb), problem.data.cons_ub)
    return torch.cat([x, s])


def restoration_settings(settings: Settings) -> Settings:
    """Settings of the restoration solve: stop once feasible enough.
    obj <= 0.5 feas_tol^2 implies max |c_i - s_i| <= feas_tol, which bounds
    the original violation (s lies inside the constraint bounds)."""
    return settings.replace(
        obj_lower=0.5 * settings.feas_tol * settings.feas_tol,
        enable_restoration_phase=False,
        perform_soc=False,
    )


def restoration_succeeded(status: int) -> bool:
    """UNBOUNDED = the residual target is met = feasible for the original."""
    return status in (Status.UNBOUNDED, Status.OPTIMAL)


def solve_with_restoration(problem: Problem, settings: Settings, state0, max_iterations: int,
                           rest_problem: Problem | None = None,
                           max_restoration_iterations: int | None = None):
    """Solve with one restoration attempt (solver/solve.c:195-238 as one
    function): solve, and when the iteration declares local infeasibility,
    run the restoration solve, carry its x back (keeping duals, working
    set, radii and penalty, solver/phase.c:97-147) and resume if the
    original is then feasible to 10 feas_tol.

    Under ``vmap`` the lanes that did not end INFEASIBLE take no part: they
    enter the restoration solve with their own final status, so they
    neither run nor add a trip, and only the lanes that were INFEASIBLE
    and recovered resume.  Every other lane comes back as the plain solve
    left it, bit for bit.  When no lane is infeasible the attempt costs
    one read."""
    if rest_problem is None:
        rest_problem = make_restoration_problem(problem)
    rest_settings = restoration_settings(settings)
    if max_restoration_iterations is None:
        max_restoration_iterations = max_iterations
    n = problem.num_variables
    # one instance runs the fused loop; lanes keep the lockstep loop
    solve_loop = solve_from if is_batched(state0.status) else solve_jit

    out = solve_loop(problem, settings, state0, max_iterations)
    infeasible = out.status == int(Status.INFEASIBLE)
    if not lanes_any(infeasible):
        return out
    z0 = restoration_initial_point(problem, out.it.x)
    rs0 = initial_state(rest_problem, rest_settings, z0, device=problem.device)
    rs0 = dataclasses.replace(rs0, status=lanes_where(infeasible, rs0.status, out.status))
    rest = solve_loop(rest_problem, rest_settings, rs0, max_restoration_iterations)
    x_restored = rest.it.x[:n]
    viol = max_violation(problem.data, problem.cons_val(x_restored))
    recovered = infeasible & (viol <= settings.feas_tol * 10.0)
    if not lanes_any(recovered):
        return out
    new_it = dataclasses.replace(
        create_iterate(problem, x_restored), cons_dual=out.it.cons_dual,
        vars_dual=out.it.vars_dual, var_states=out.it.var_states,
        cons_states=out.it.cons_states)
    running = torch.full_like(out.status, int(Status.RUNNING))
    resumed0 = dataclasses.replace(out, it=new_it,
                                   status=lanes_where(recovered, running, out.status))
    return lanes_where(recovered, solve_loop(problem, settings, resumed0, max_iterations), out)
