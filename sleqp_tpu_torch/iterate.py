"""Iterate and KKT residuals.

Port of ``sleqp_tpu/iterate.py`` (reference src/main/iterate.c and
src/main/feas.c).  The working set lives inside the iterate as two int8
state tensors (``ActiveState``).

Dual sign conventions follow the reference (iterate.c:241-517):
  * stationarity residual r = ∇f + J^T cons_dual + vars_dual (max-abs norm)
  * duals at upper bounds are >= 0, at lower bounds <= 0
  * slackness residual per entry: d >= 0 -> max(ub - v, 0) * d,
    d < 0 -> max(v - lb, 0) * d   (iterate.c:318-325)
"""

from __future__ import annotations

import dataclasses

import torch

from .problem import Problem, ProblemData
from .types import ActiveState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Iterate:
    """Primal/dual point with cached evaluations (pub_iterate.h:14-50)."""

    x: Tensor  # (n,) primal
    obj_val: Tensor  # 0-d f(x)
    obj_grad: Tensor  # (n,) ∇f(x)
    cons_val: Tensor  # (m,) c(x)
    cons_jac: Tensor  # (m, n) J_c(x)
    cons_dual: Tensor  # (m,) constraint duals
    vars_dual: Tensor  # (n,) variable-bound duals
    var_states: Tensor  # (n,) int8 ActiveState
    cons_states: Tensor  # (m,) int8 ActiveState


def max0(t: Tensor) -> Tensor:
    """max(0, max(t)), 0 for an empty t (``jnp.max(t, initial=0.0)``)."""
    if t.numel() == 0:
        return torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.clamp(t.amax(), min=0.0)


def create_iterate(problem: Problem, x: Tensor) -> Iterate:
    """Evaluate the problem at x (clipped into the box) into an Iterate."""
    x = problem.clip_to_bounds(torch.as_tensor(x, dtype=problem.dtype, device=problem.device))
    obj_val, obj_grad, cons_val, cons_jac = problem.eval_all(x)
    n = problem.num_variables
    m = problem.num_cons
    return Iterate(
        x=x,
        obj_val=obj_val,
        obj_grad=obj_grad,
        cons_val=cons_val,
        cons_jac=cons_jac,
        cons_dual=torch.zeros((m,), dtype=x.dtype, device=x.device),
        vars_dual=torch.zeros((n,), dtype=x.dtype, device=x.device),
        var_states=torch.zeros((n,), dtype=torch.int8, device=x.device),
        cons_states=torch.zeros((m,), dtype=torch.int8, device=x.device),
    )


# ---- violation helpers (reference: src/main/feas.c) ------------------------


def violation_values(cons_val: Tensor, lb: Tensor, ub: Tensor) -> Tensor:
    """Amount by which each constraint lies outside [lb, ub]."""
    upper = torch.clamp(cons_val - ub, min=0.0)
    lower = torch.clamp(lb - cons_val, min=0.0)
    return upper + lower


def total_violation(data: ProblemData, cons_val: Tensor) -> Tensor:
    """l1 violation of the combined constraints (feas.c sleqp_total_violation)."""
    return violation_values(cons_val, data.cons_lb, data.cons_ub).sum()


def max_violation(data: ProblemData, cons_val: Tensor) -> Tensor:
    """l-inf violation (feas.c sleqp_max_violation)."""
    return max0(violation_values(cons_val, data.cons_lb, data.cons_ub))


def violated_cons_multipliers(
    data: ProblemData, cons_val: Tensor, cons_states: Tensor | None = None
) -> Tensor:
    """+1 where c > ub, -1 where c < lb, else 0 (feas.c:7-90); entries in
    the working set are zeroed when states are given."""
    up = (cons_val > data.cons_ub).to(cons_val.dtype)
    low = (cons_val < data.cons_lb).to(cons_val.dtype)
    mult = up - low
    if cons_states is not None:
        mult = torch.where(cons_states == ActiveState.INACTIVE, mult, 0.0)
    return mult


# ---- KKT residuals (reference: src/main/iterate.c:241-528) -----------------


def stationarity_residuals(data: ProblemData, it: Iterate) -> Tensor:
    """∇f + J^T cons_dual + vars_dual (iterate.c:416-480)."""
    return it.obj_grad + it.cons_jac.T @ it.cons_dual + it.vars_dual


def stationarity_residuum(data: ProblemData, it: Iterate) -> Tensor:
    return max0(stationarity_residuals(data, it).abs())


def feasibility_residuum(data: ProblemData, it: Iterate) -> Tensor:
    """Max violation of the combined constraints (iterate.c:391-399);
    iterates always stay in the variable box."""
    return max_violation(data, it.cons_val)


def slack_residual_values(v: Tensor, lb: Tensor, ub: Tensor, d: Tensor) -> Tensor:
    """Per-entry complementary-slackness residuals (iterate.c:200-239).
    Entries with zero dual contribute exactly 0, so inf * 0 from infinite
    bounds cannot give NaN."""
    up = torch.clamp(ub - v, min=0.0) * d
    low = torch.clamp(v - lb, min=0.0) * d
    return torch.where(d > 0.0, up, torch.where(d < 0.0, low, 0.0))


def _slack_residuum(v: Tensor, lb: Tensor, ub: Tensor, d: Tensor) -> Tensor:
    return max0(slack_residual_values(v, lb, ub, d).abs())


def slackness_residuum(data: ProblemData, it: Iterate) -> Tensor:
    cons_part = _slack_residuum(it.cons_val, data.cons_lb, data.cons_ub, it.cons_dual)
    var_part = _slack_residuum(it.x, data.var_lb, data.var_ub, it.vars_dual)
    return torch.maximum(cons_part, var_part)


def kkt_residuals(data: ProblemData, it: Iterate):
    """(feasibility, slackness, stationarity) residua."""
    return (
        feasibility_residuum(data, it),
        slackness_residuum(data, it),
        stationarity_residuum(data, it),
    )


def is_optimal(data: ProblemData, it: Iterate, feas_tol: float, slack_tol: float,
               stat_tol: float) -> Tensor:
    """Optimality test (iterate.c:528-560): all three residua under tolerance."""
    feas_res, slack_res, stat_res = kkt_residuals(data, it)
    return (feas_res <= feas_tol) & (stat_res < stat_tol) & (slack_res < slack_tol)
