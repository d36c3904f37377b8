"""Steihaug projected conjugate gradient for the trust-region EQP step.

Port of ``sleqp_tpu/ops/tr_cg.py`` (reference tr/steihaug_solver.c):
minimize ``g^T d + 0.5 d^T H d`` subject to ``A_W d = 0`` and
``||d|| <= radius``, with H products from a callback and residuals
projected onto null(A_W) every iteration.  Negative curvature and crossing
the trust region both end with a step to the boundary.  The reference's
``lax.while_loop`` is a ``lanes.lockstep`` loop that reads one flag per
iteration for all lanes.

Also records the min/max Rayleigh quotients met (newton.c:318-346).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..lanes import lockstep
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


class CGSetup(NamedTuple):
    """What the projected CG steps take from their start."""

    tol_sq: Tensor
    radius: Tensor


def cg_start(aug_jac: AugJac, gradient: Tensor, radius: Tensor, rel_tol: float = 1e-8,
             abs_tol: float = 1e-12, p0: Tensor | None = None):
    """(``CGSetup``, the loop state before the first CG step)."""
    n = gradient.shape[0]
    dtype, dev = gradient.dtype, gradient.device
    radius = torch.as_tensor(radius, dtype=dtype, device=dev)

    z = project_nullspace(aug_jac, gradient) if p0 is None else p0.to(dtype)
    rz = torch.dot(gradient, z)
    # tolerance on the projected-gradient norm
    tol_sq = torch.clamp(rel_tol * rel_tol * rz.abs(), min=abs_tol * abs_tol)

    init = dict(
        d=torch.zeros((n,), dtype=dtype, device=dev),
        r=gradient,
        z=z,
        p=-z,
        rz=rz,
        on_boundary=torch.zeros((), dtype=torch.bool, device=dev),
        min_ray=torch.full((), torch.inf, dtype=dtype, device=dev),
        max_ray=torch.full((), -torch.inf, dtype=dtype, device=dev),
        iters=torch.zeros((), dtype=torch.int32, device=dev),
        done=rz <= tol_sq,
    )
    return CGSetup(tol_sq, radius), init


def cg_running(s: dict, max_iterations: int) -> Tensor:
    """Whether the CG loop in state ``s`` goes on: not done, below the cap."""
    return ~s["done"] & (s["iters"] < max_iterations)


def cg_body(hess_prod: Callable[[Tensor], Tensor], aug_jac: AugJac, setup: CGSetup):
    """One Steihaug CG step, ``body(s, trip)``."""
    tol_sq, radius = setup.tol_sq, setup.radius

    def body(s, trip):
        d, r, p, rz = s["d"], s["r"], s["p"], s["rz"]
        Hp = hess_prod(p)
        pp = torch.dot(p, p)
        pHp = torch.dot(p, Hp)
        rayleigh = pHp / torch.where(pp > 0.0, pp, 1.0)

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
        return dict(
            d=torch.where(hit_boundary, d_boundary, d_next),
            r=torch.where(hit_boundary, r, r_next),
            z=torch.where(hit_boundary, s["z"], z_next),
            p=torch.where(hit_boundary, p, p_next),
            rz=torch.where(hit_boundary, rz, rz_next),
            on_boundary=s["on_boundary"] | hit_boundary,
            min_ray=torch.minimum(s["min_ray"], rayleigh),
            max_ray=torch.maximum(s["max_ray"], rayleigh),
            iters=s["iters"] + 1,
            done=hit_boundary | converged,
        )

    return body


def cg_result(final: dict) -> TRResult:
    """The trust-region step from the CG loop's final state."""
    zero_spectrum = final["iters"] == 0
    return TRResult(
        step=final["d"],
        on_boundary=final["on_boundary"],
        iterations=final["iters"],
        min_rayleigh=torch.where(zero_spectrum, 0.0, final["min_ray"]),
        max_rayleigh=torch.where(zero_spectrum, 0.0, final["max_ray"]),
    )


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
    setup, init = cg_start(aug_jac, gradient, radius, rel_tol, abs_tol, p0)
    final = lockstep(lambda s: ~s["done"], cg_body(hess_prod, aug_jac, setup), init,
                     max_trips=max_iterations)
    return cg_result(final)
