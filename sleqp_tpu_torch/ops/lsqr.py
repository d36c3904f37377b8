"""Trust-region LSQR (Golub-Kahan bidiagonalization).

Port of ``sleqp_tpu/ops/lsqr.py`` (reference src/main/tr/lsqr.c): solves
``min ||b - A d||`` through forward and adjoint products, stopping
Steihaug-like at the trust-region boundary (LSQR iterate norms grow
monotonically, so the first crossing is final).  Used by the Gauss-Newton
EQP step (``gauss_newton.py``).

The reference's ``lax.while_loop`` is a Python loop that reads one stop
flag a step, capped at ``max_iterations`` as there.
"""

from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def _safe(v: Tensor) -> Tensor:
    return torch.where(v > 0.0, v, 1.0)


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
    dtype, dev = b.dtype, b.device
    radius = torch.as_tensor(radius, dtype=dtype, device=dev)

    beta = torch.linalg.norm(b)
    u = b / _safe(beta)
    v_raw = adjoint(u)
    alpha = torch.linalg.norm(v_raw)
    v = v_raw / _safe(alpha)
    tol = rel_tol * alpha * beta

    d = torch.zeros((n,), dtype=dtype, device=dev)
    w = v
    phi_bar, rho_bar = beta, alpha
    steps = 0
    done = bool((beta == 0.0) | (alpha == 0.0))
    while not done and steps < max_iterations:
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
        steps += 1
        done = bool(crosses | converged)
    return d, torch.tensor(steps, dtype=torch.int32, device=dev)
