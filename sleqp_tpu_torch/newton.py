"""EQP (Newton) step: working step + trust-region solve on the working set.

Port of ``sleqp_tpu/newton.py`` (reference working_step.c + newton.c):

1. the working step d0: the min-norm step onto the working-set bounds,
   scaled into ``NORM_RATIO * trust_radius`` if too long, with the reduced
   trust radius for the tangential step;
2. the violated multipliers at the linearized constraint values of d0;
3. the EQP gradient grad = ∇f + H d0 + penalty * J^T violated_mult;
4. GLTR or Steihaug projected CG in null(A_W) within the reduced radius,
   then newton_step = d0 + t.

With a compute dtype (mixed precision) the EQP gradient and the final
direction stay in the state dtype and the Krylov loop runs in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .iterate import Iterate, violated_cons_multipliers
from .merit import Direction, make_direction
from .ops.gltr import gltr
from .ops.kkt import AugJac, project_nullspace, solve_min_norm
from .ops.tr_cg import TRResult, steihaug_cg
from .problem import ProblemData
from .types import INF_THRESHOLD, ActiveState

Tensor = torch.Tensor

# Fraction of the trust radius the initial step may consume (working_step.c:12).
NORM_RATIO = 0.8


@dataclasses.dataclass(frozen=True)
class WorkingStep:
    """Initial EQP step data (reference SleqpWorkingStep state)."""

    step: Tensor  # (n,) d0
    cons_jac_dot: Tensor  # (m,) J d0
    obj_dot: Tensor  # 0-d ∇f·d0
    initial_cons_val: Tensor  # (m,) c + J d0
    violated_mult: Tensor  # (m,) in {-1,0,1}, excluding the working set
    reduced_trust_radius: Tensor  # 0-d


def _working_set_rhs(data: ProblemData, it: Iterate) -> Tensor:
    """Target values b - v per working-set row (working_step.c:112-276):
    ``lb - value`` for active-at-lower rows (and ACTIVE_BOTH), ``ub - value``
    at upper."""

    def per(v, lb, ub, states):
        lower_diff = torch.where(lb > -INF_THRESHOLD, lb - v, 0.0)
        upper_diff = torch.where(ub < INF_THRESHOLD, ub - v, 0.0)
        rhs = torch.where(states == ActiveState.ACTIVE_UPPER, upper_diff, 0.0)
        at_lower = (states == ActiveState.ACTIVE_LOWER) | (states == ActiveState.ACTIVE_BOTH)
        return torch.where(at_lower, lower_diff, rhs)

    var_rhs = per(it.x, data.var_lb, data.var_ub, it.var_states)
    cons_rhs = per(it.cons_val, data.cons_lb, data.cons_ub, it.cons_states)
    return torch.cat([var_rhs, cons_rhs])


def compute_working_step(data: ProblemData, it: Iterate, aug_jac: AugJac, trust_radius: Tensor,
                         eps: float = 1e-10) -> WorkingStep:
    """d0 + reduced radius + violated multipliers (working_step.c:452-483)."""
    d0 = solve_min_norm(aug_jac, _working_set_rhs(data, it))

    norm = torch.linalg.norm(d0)
    alpha = torch.clamp((NORM_RATIO * trust_radius) / torch.where(norm > 0.0, norm, 1.0), max=1.0)
    full = alpha >= 1.0 - eps  # no scaling required
    d0 = torch.where(norm > 0.0, d0 * torch.where(full, 1.0, alpha), d0)

    reduced_full = torch.sqrt(torch.clamp(trust_radius * trust_radius - norm * norm, min=0.0))
    reduced_scaled = trust_radius * (1.0 - NORM_RATIO * NORM_RATIO) ** 0.5
    reduced = torch.where(norm == 0.0, trust_radius,
                          torch.where(full, reduced_full, reduced_scaled))

    cons_jac_dot = it.cons_jac @ d0
    initial_cons_val = it.cons_val + cons_jac_dot
    return WorkingStep(
        step=d0,
        cons_jac_dot=cons_jac_dot,
        obj_dot=torch.dot(it.obj_grad, d0),
        initial_cons_val=initial_cons_val,
        violated_mult=violated_cons_multipliers(data, initial_cons_val, it.cons_states),
        reduced_trust_radius=reduced,
    )


@dataclasses.dataclass(frozen=True)
class NewtonResult:
    direction: Direction  # the full Newton direction (d0 + TR step)
    tr: TRResult


def newton_gradient(it: Iterate, ws: WorkingStep, hess_prod: Callable[[Tensor], Tensor],
                    penalty: Tensor) -> Tensor:
    """The EQP gradient grad f + H d0 + penalty J^T violated_mult."""
    return it.obj_grad + hess_prod(ws.step) + penalty * (it.cons_jac.T @ ws.violated_mult)


def krylov_inputs(aug_jac: AugJac, gradient: Tensor, ws: WorkingStep, compute_dtype):
    """(the factorization, gradient, radius and initial projection, or
    None) the Krylov loop takes, in ``compute_dtype``."""
    if compute_dtype == gradient.dtype:
        return aug_jac, gradient, ws.reduced_trust_radius, None
    # near convergence P g cancels catastrophically: project at full
    # precision and hand it to the Krylov loop
    return (aug_jac.to(compute_dtype), gradient.to(compute_dtype),
            ws.reduced_trust_radius.to(compute_dtype),
            project_nullspace(aug_jac, gradient).to(compute_dtype))


def newton_result(it: Iterate, ws: WorkingStep, tr: TRResult,
                  hess_prod: Callable[[Tensor], Tensor]) -> NewtonResult:
    """The Newton direction d0 + t from the Krylov loop's step t."""
    sdtype = it.obj_grad.dtype
    if tr.step.dtype != sdtype:
        tr = TRResult(
            step=tr.step.to(sdtype),
            on_boundary=tr.on_boundary,
            iterations=tr.iterations,
            min_rayleigh=tr.min_rayleigh.to(sdtype),
            max_rayleigh=tr.max_rayleigh.to(sdtype),
        )
    # degenerate radius: only the initial step survives (newton.c:501-508)
    zero_radius = ws.reduced_trust_radius <= 1e-20
    step = torch.where(zero_radius, ws.step, ws.step + tr.step)
    return NewtonResult(direction=make_direction(it, step, hess_prod(step)), tr=tr)


def compute_newton_step(
    data: ProblemData,
    it: Iterate,
    aug_jac: AugJac,
    ws: WorkingStep,
    hess_prod: Callable[[Tensor], Tensor],
    penalty: Tensor,
    max_iterations: int,
    use_gltr: bool = False,
    compute_dtype=None,
    hess_prod_compute: Callable[[Tensor], Tensor] | None = None,
) -> NewtonResult:
    """EQP direction (newton.c:443-556).

    ``hess_prod`` closes over the EQP multipliers (cons_dual +
    penalty*violated).  ``use_gltr`` selects GLTR instead of Steihaug CG.
    With ``compute_dtype`` the Krylov loop runs in that dtype on
    ``hess_prod_compute``, a Hessian operator evaluated at the cast iterate
    (the callables then run in float32), and the initial projection is
    computed in the state dtype.
    """
    sdtype = it.obj_grad.dtype
    gradient = newton_gradient(it, ws, hess_prod, penalty)
    cd = compute_dtype if compute_dtype is not None else sdtype
    aug_c, grad_c, rad_c, p0 = krylov_inputs(aug_jac, gradient, ws, cd)
    if cd != sdtype:
        hp_c = hess_prod_compute or (lambda d: hess_prod(d.to(sdtype)).to(cd))
    else:
        hp_c = hess_prod

    solver = gltr if use_gltr else steihaug_cg
    tr = solver(hp_c, aug_c, grad_c, rad_c, max_iterations=max_iterations, p0=p0)
    return newton_result(it, ws, tr, hess_prod)
