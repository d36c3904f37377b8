"""Trust-region LSQR (Golub-Kahan bidiagonalization).

Port of ``sleqp_tpu/ops/lsqr.py`` (reference src/main/tr/lsqr.c): solves
``min ||b - A d||`` through forward and adjoint products, stopping
Steihaug-like at the trust-region boundary (LSQR iterate norms grow
monotonically, so the first crossing is final).  Used by the Gauss-Newton
EQP step (``gauss_newton.py``).

The reference's ``lax.while_loop`` is a ``lanes.lockstep`` loop: one read
of the stop flags a step, for all lanes under ``torch.func.vmap``
(``parallel/batch.py``), capped at ``max_iterations`` as there; a lane
that has stopped keeps its iterate while the others go on.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..lanes import lockstep

Tensor = torch.Tensor


def _safe(v: Tensor) -> Tensor:
    return torch.where(v > 0.0, v, 1.0)


class LSQRSetup(NamedTuple):
    """What the LSQR steps take from their start."""

    tol: Tensor
    radius: Tensor


def lsqr_start(adjoint: Callable[[Tensor], Tensor], b: Tensor, radius, n: int,
               rel_tol: float = 1e-8):
    """(``LSQRSetup``, the loop state before the first step: (u, v, d, w,
    alpha, beta, phi_bar, rho_bar, steps, done))."""
    dtype, dev = b.dtype, b.device
    radius = torch.as_tensor(radius, dtype=dtype, device=dev)

    beta0 = torch.linalg.norm(b)
    u0 = b / _safe(beta0)
    v_raw = adjoint(u0)
    alpha0 = torch.linalg.norm(v_raw)
    v0 = v_raw / _safe(alpha0)
    tol = rel_tol * alpha0 * beta0

    d0 = torch.zeros((n,), dtype=dtype, device=dev)
    steps0 = torch.zeros((), dtype=torch.int32, device=dev)
    state = (u0, v0, d0, v0, alpha0, beta0, beta0, alpha0, steps0,
             (beta0 == 0.0) | (alpha0 == 0.0))
    return LSQRSetup(tol, radius), state


def lsqr_running(s: tuple, max_iterations: int) -> Tensor:
    """Whether the LSQR loop in state ``s`` goes on."""
    return ~s[9] & (s[8] < max_iterations)


def lsqr_body(forward: Callable[[Tensor], Tensor], adjoint: Callable[[Tensor], Tensor],
              setup: LSQRSetup):
    """One LSQR step, ``body(s, trip)``."""
    tol, radius = setup.tol, setup.radius

    def body(s, trip):
        u, v, d, w, alpha, beta, phi_bar, rho_bar, steps, _ = s
        # bidiagonalization step
        u = forward(v) - alpha * u
        beta = torch.linalg.norm(u)
        u = u / _safe(beta)
        v_next = adjoint(u) - beta * v
        alpha = torch.linalg.norm(v_next)
        v = v_next / _safe(alpha)

        # Givens rotation
        rho = torch.sqrt(rho_bar**2 + beta**2)
        c = rho_bar / rho
        sn = beta / rho
        theta = sn * alpha
        rho_bar = -c * alpha
        phi = c * phi_bar
        phi_bar = sn * phi_bar

        d_next = d + (phi / rho) * w
        w = v - (theta / rho) * w

        # the trust region crossing: ||d|| grows monotonically in LSQR
        crosses = torch.dot(d_next, d_next) >= radius * radius
        norm = torch.linalg.norm(d_next)
        d = torch.where(crosses, d_next * (radius / _safe(norm)), d_next)

        converged = (phi_bar * alpha * c).abs() <= tol
        return (u, v, d, w, alpha, beta, phi_bar, rho_bar, steps + 1, crosses | converged)

    return body


def lsqr_tr(
    forward: Callable[[Tensor], Tensor],
    adjoint: Callable[[Tensor], Tensor],
    b: Tensor,
    radius,
    n: int,
    max_iterations: int,
    rel_tol: float = 1e-8,
):
    """Returns (the boundary-clipped LSQR iterate minimizing ||b - A d||,
    the number of steps as an int32 tensor)."""
    setup, state = lsqr_start(adjoint, b, radius, n, rel_tol)
    final = lockstep(lambda s: lsqr_running(s, max_iterations), lsqr_body(forward, adjoint, setup),
                     state, max_trips=max_iterations)
    return final[2], final[8]
