"""Steihaug projected conjugate gradient for the trust-region EQP step.

Port of ``sleqp_tpu/ops/tr_cg.py`` (reference tr/steihaug_solver.c):
minimize ``g^T d + 0.5 d^T H d`` subject to ``A_W d = 0`` and
``||d|| <= radius``, with H products from a callback and residuals
projected onto null(A_W) every iteration.  Negative curvature and crossing
the trust region both end with a step to the boundary.  The reference's
``lax.while_loop`` is a Python loop that reads one flag per iteration.

Also records the min/max Rayleigh quotients met (newton.c:318-346).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .kkt import AugJac, project_nullspace

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TRResult:
    step: Tensor  # (n,) trust-region step (in null(A_W), ||step|| <= radius)
    on_boundary: Tensor  # 0-d bool
    iterations: Tensor  # int32
    min_rayleigh: Tensor
    max_rayleigh: Tensor


def _boundary_tau(d: Tensor, p: Tensor, radius: Tensor) -> Tensor:
    """Largest tau >= 0 with ||d + tau p|| = radius (tr/tr_util.c)."""
    pp = torch.dot(p, p)
    dp = torch.dot(d, p)
    dd = torch.dot(d, d)
    safe_pp = torch.where(pp > 0.0, pp, 1.0)
    disc = torch.clamp(dp * dp + safe_pp * (radius * radius - dd), min=0.0)
    tau = (-dp + torch.sqrt(disc)) / safe_pp
    return torch.where(pp > 0.0, tau, 0.0)


def steihaug_cg(
    hess_prod: Callable[[Tensor], Tensor],
    aug_jac: AugJac,
    gradient: Tensor,
    radius: Tensor,
    max_iterations: int,
    rel_tol: float = 1e-8,
    abs_tol: float = 1e-12,
    p0: Tensor | None = None,
) -> TRResult:
    """Projected CG with Steihaug boundary handling.  ``p0`` optionally
    supplies the initial nullspace projection (the mixed-precision caller
    passes one computed in float64)."""
    n = gradient.shape[0]
    dtype, dev = gradient.dtype, gradient.device
    radius = torch.as_tensor(radius, dtype=dtype, device=dev)

    z = project_nullspace(aug_jac, gradient) if p0 is None else p0.to(dtype)
    rz = torch.dot(gradient, z)
    # tolerance on the projected-gradient norm
    tol_sq = torch.clamp(rel_tol * rel_tol * rz.abs(), min=abs_tol * abs_tol)

    d = torch.zeros((n,), dtype=dtype, device=dev)
    r = gradient
    p = -z
    on_boundary = torch.zeros((), dtype=torch.bool, device=dev)
    min_ray = torch.full((), torch.inf, dtype=dtype, device=dev)
    max_ray = torch.full((), -torch.inf, dtype=dtype, device=dev)
    it = 0
    done = bool(rz <= tol_sq)

    while not done and it < max_iterations:
        Hp = hess_prod(p)
        pp = torch.dot(p, p)
        pHp = torch.dot(p, Hp)
        rayleigh = pHp / torch.where(pp > 0.0, pp, 1.0)
        min_ray = torch.minimum(min_ray, rayleigh)
        max_ray = torch.maximum(max_ray, rayleigh)

        neg_curv = pHp <= 1e-14 * pp
        alpha = rz / torch.where(neg_curv, 1.0, pHp)

        d_next = d + alpha * p
        crosses = torch.dot(d_next, d_next) >= radius * radius

        # boundary step for negative curvature or crossing the region
        tau = _boundary_tau(d, p, radius)
        d_boundary = d + tau * p
        hit_boundary = neg_curv | crosses

        r_next = r + alpha * Hp
        z_next = project_nullspace(aug_jac, r_next)
        rz_next = torch.dot(r_next, z_next)
        converged = rz_next <= tol_sq

        beta = rz_next / torch.where(rz != 0.0, rz, 1.0)
        p_next = -z_next + beta * p

        d = torch.where(hit_boundary, d_boundary, d_next)
        r = torch.where(hit_boundary, r, r_next)
        z = torch.where(hit_boundary, z, z_next)
        p = torch.where(hit_boundary, p, p_next)
        rz = torch.where(hit_boundary, rz, rz_next)
        on_boundary = on_boundary | hit_boundary
        it += 1
        done = bool(hit_boundary | converged)

    zero_spectrum = it == 0
    return TRResult(
        step=d,
        on_boundary=on_boundary,
        iterations=torch.full((), it, dtype=torch.int32, device=dev),
        min_rayleigh=torch.zeros_like(min_ray) if zero_spectrum else min_ray,
        max_rayleigh=torch.zeros_like(max_ray) if zero_spectrum else max_ray,
    )
