"""Gauss-Newton EQP step for least-squares functions.

Port of ``sleqp_tpu/gauss_newton.py`` (reference src/main/gauss_newton.c):
for an ``LSQFunc`` the EQP step minimizes the linearized residual plus the
penalty-scaled violated constraint rows inside the reduced trust region
and the working set's null space,

    min || r(x) + J_r (d0 + t) ||^2
        + penalty || viol(c + J (d0 + t)) ||^2     over t in null(A_W),
    ||t|| <= reduced_radius,

by trust-region LSQR (``ops/lsqr.py``) on the stacked operator
``A = [J_r; sqrt(penalty) D_viol J] P`` (gauss_newton.c:87-260).  The
residual products are the reverse-mode ``linearize`` of ``problem.py``.
The step runs in the problem's dtype on both routes, as in the reference.
"""

from __future__ import annotations

import torch

from .iterate import Iterate
from .merit import make_direction
from .newton import NewtonResult, WorkingStep
from .ops.kkt import AugJac, project_nullspace
from .ops.lsqr import lsqr_tr
from .ops.tr_cg import TRResult
from .problem import LSQFunc, Problem, ProblemData, linearize

Tensor = torch.Tensor


def gauss_newton_start(problem: Problem, data: ProblemData, it: Iterate, aug_jac: AugJac,
                       ws: WorkingStep, penalty: Tensor):
    """(forward, adjoint, b): the LSQR operator ``A = [J_r; sqrt(penalty)
    D_viol J] P`` and the right-hand side, the negative residuals at the
    initial step d0."""
    func = problem.func
    assert isinstance(func, LSQFunc)
    k = func.num_residuals

    r0, jvp_fn, vjp_fn = linearize(func.residuals, it.x)
    sqrt_pen = torch.sqrt(penalty)
    viol = ws.violated_mult  # in {-1, 0, +1}, the working set excluded

    def forward(t: Tensor) -> Tensor:
        p = project_nullspace(aug_jac, t)
        return torch.cat([jvp_fn(p), sqrt_pen * (viol * (it.cons_jac @ p))])

    def adjoint(u: Tensor) -> Tensor:
        g = vjp_fn(u[:k]) + sqrt_pen * (it.cons_jac.T @ (viol * u[k:]))
        return project_nullspace(aug_jac, g)

    bound = torch.where(viol > 0.0, data.cons_ub, data.cons_lb)
    bound = torch.where(viol == 0.0, 0.0, bound)
    cons_resid = torch.where(viol != 0.0, ws.initial_cons_val - bound, 0.0)
    b = -torch.cat([r0 + jvp_fn(ws.step), sqrt_pen * (viol * cons_resid)])
    return forward, adjoint, b


def gauss_newton_result(problem: Problem, it: Iterate, aug_jac: AugJac, ws: WorkingStep,
                        t: Tensor, iters: Tensor) -> NewtonResult:
    """The Gauss-Newton direction d0 + P t from LSQR's iterate t."""
    t = project_nullspace(aug_jac, t)
    zero_radius = ws.reduced_trust_radius <= 1e-20
    step = torch.where(zero_radius, ws.step, ws.step + t)
    direction = make_direction(it, step, problem.hess_prod(it.x, step, it.cons_dual))
    zero = torch.zeros((), dtype=step.dtype, device=step.device)
    tr = TRResult(
        step=t,
        on_boundary=torch.linalg.norm(t) >= ws.reduced_trust_radius * (1.0 - 1e-10),
        iterations=iters,
        min_rayleigh=zero,
        max_rayleigh=zero,
    )
    return NewtonResult(direction=direction, tr=tr)


def compute_gauss_newton_step(
    problem: Problem,
    data: ProblemData,
    it: Iterate,
    aug_jac: AugJac,
    ws: WorkingStep,
    penalty: Tensor,
    max_iterations: int,
) -> NewtonResult:
    forward, adjoint, b = gauss_newton_start(problem, data, it, aug_jac, ws, penalty)
    t, iters = lsqr_tr(forward, adjoint, b, ws.reduced_trust_radius, problem.num_variables,
                       max_iterations)
    return gauss_newton_result(problem, it, aug_jac, ws, t, iters)
