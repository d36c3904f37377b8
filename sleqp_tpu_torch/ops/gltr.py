"""GLTR trust-region solver: projected Lanczos + tridiagonal Moré-Sorensen.

Port of ``sleqp_tpu/ops/gltr.py`` (the reference's trlib replacement):
solve

    min  g^T d + 0.5 d^T H d   s.t.  A_W d = 0,  ||d|| <= radius

for a possibly indefinite H.  A projected Lanczos recursion builds an
orthonormal basis V of the Krylov space in null(A_W) with tridiagonal
T = V^T H V; each step solves the reduced problem

    min  gamma0 * e1^T h + 0.5 h^T T h   s.t.  ||h|| <= radius

by a safeguarded Newton iteration on the secular equation
``1/||h(lam)|| - 1/radius = 0`` with factorizations of T + lam I, then
d = V h.

The Lanczos basis is a (K, n) buffer as in the reference.  The reference
factors the padded K x K tridiagonal by LDL^T scans (``lax.scan``); its
padding rows decouple exactly (unit diagonal, zero coupling and right-hand
side), so the port factors the leading k x k block of the current Lanczos
step with one ``torch.linalg.cholesky_ex``: the same factorization
(C = L D^1/2), a few launches instead of O(k) sequential steps per Newton
iteration.  Positive definiteness is the factorization's success, as
``all(d > 0)`` is in the reference.

The Lanczos loop is a ``lanes.lockstep`` body: a lane that is still
iterating at trip t is at Lanczos step k = t + 1 whatever its batch (every
lane starts at k = 1 and steps once a trip), so k is the trip count on the
host and the active block has the same size on every active lane; frozen
lanes compute on their stale state and are dropped by the select.  The
buffers are updated by selects, not by index writes, so that one body runs
on one lane and under ``vmap``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..lanes import lockstep
from .kkt import AugJac, project_nullspace
from .tr_cg import TRResult

Tensor = torch.Tensor

_MS_WARM_ITERS = 12  # Newton iterations when warm-started


def _tridiag_solve_at(T: Tensor, rhs: Tensor, lam: Tensor):
    """h = (T + lam I)^{-1} rhs (0 when not positive definite), the
    Moré-Sorensen denominator ||C^{-1} h||^2 with C the Cholesky factor of
    T + lam I, and the positive-definiteness flag."""
    k = T.shape[0]
    C, info = torch.linalg.cholesky_ex(T + lam * torch.eye(k, dtype=T.dtype, device=T.device))
    pd = info == 0
    h = torch.cholesky_solve(rhs[:, None], C, upper=False)
    wnorm2 = torch.linalg.solve_triangular(C, h, upper=False).square().sum()
    h = torch.where(pd, h[:, 0], 0.0)
    return h, wnorm2, pd


def _tridiag_tr_solve(
    alphas: Tensor,  # (K,) diagonal
    betas: Tensor,  # (K,) off-diagonal; betas[0] unused
    gamma0: Tensor,  # ||P g||
    radius: Tensor,
    k: int,  # current active dimension (1..K)
    lam_warm: Tensor | None = None,  # warm-start multiplier from the last call
    newton_iters: int = 25,
):
    """Moré-Sorensen on the active k x k block of the tridiagonal."""
    K = alphas.shape[0]
    dtype, dev = alphas.dtype, alphas.device
    tiny = torch.finfo(dtype).tiny
    a = alphas[:k]
    b = betas[1:k]
    T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)
    rhs = torch.cat([-gamma0.reshape(1), torch.zeros((k - 1,), dtype=dtype, device=dev)])

    # Gershgorin lower bound on the eigenvalues of the active block
    zero = torch.zeros((1,), dtype=dtype, device=dev)
    gersh = a - torch.cat([zero, b]).abs() - torch.cat([b, zero]).abs()
    lam_lo = torch.clamp(-gersh.amin(), min=0.0)

    # interior test at lam = 0
    h0, _, pd0 = _tridiag_solve_at(T, rhs, torch.zeros((), dtype=dtype, device=dev))
    interior = pd0 & (torch.linalg.norm(h0) <= radius)

    # The Gershgorin start is positive definite; Newton may move below it
    # (the bound is conservative) and failures bisect back up.  A warm
    # multiplier from the previous, one smaller, tridiagonal starts closer.
    lam = lam_lo + 1e-12
    last_ok = lam_lo + 1e-12
    if lam_warm is not None:
        lam = torch.maximum(lam_warm, lam)
    for _ in range(newton_iters):
        h, wnorm2, ok = _tridiag_solve_at(T, rhs, lam)
        norm = torch.clamp(torch.linalg.norm(h), min=tiny)
        wnorm2 = torch.clamp(wnorm2, min=tiny)
        dlam = (norm * norm / wnorm2) * (norm - radius) / radius
        cand = torch.clamp(lam + dlam, min=0.0)
        lam, last_ok = torch.where(ok, cand, 0.5 * (lam + last_ok)), torch.where(ok, lam, last_ok)
    h_b, _, _ = _tridiag_solve_at(T, rhs, lam)
    # exact boundary scaling guard
    norm_b = torch.linalg.norm(h_b)
    h_b = h_b * torch.where(norm_b > radius, radius / torch.clamp(norm_b, min=tiny), 1.0)

    h = torch.cat([torch.where(interior, h0, h_b), torch.zeros((K - k,), dtype=dtype, device=dev)])
    return h, torch.where(interior, 0.0, lam), interior


class GLTRSetup(NamedTuple):
    """What GLTR's Lanczos steps take from its start."""

    gamma0: Tensor  # ||P g||
    tol: Tensor
    trivial: Tensor  # P g vanishes
    radius: Tensor


def gltr_size(n: int, max_iterations: int) -> int:
    """K, the Lanczos steps at most (the basis's rows)."""
    return min(max(int(max_iterations), 1), n + 1)


def gltr_start(aug_jac: AugJac, gradient: Tensor, radius: Tensor, max_iterations: int,
               rel_tol: float = 1e-8, p0: Tensor | None = None):
    """(``GLTRSetup``, the loop state before the first Lanczos step)."""
    n = gradient.shape[0]
    dtype, dev = gradient.dtype, gradient.device
    radius = torch.as_tensor(radius, dtype=dtype, device=dev)
    K = gltr_size(n, max_iterations)
    finfo = torch.finfo(dtype)

    p0 = project_nullspace(aug_jac, gradient) if p0 is None else p0.to(dtype)
    gamma0 = torch.linalg.norm(p0)
    eps = float(finfo.eps)
    # relative termination (trlib semantics) with a denormal-scale floor
    tol = torch.clamp(max(rel_tol, 10.0 * eps) * gamma0, min=100.0 * finfo.tiny)
    trivial = gamma0 <= finfo.tiny

    rows = torch.arange(K, device=dev)
    v1 = p0 / torch.where(trivial, 1.0, gamma0)
    init = dict(
        V=torch.where(rows[:, None] == 0, v1[None, :],
                      torch.zeros((K, n), dtype=dtype, device=dev)),
        alphas=torch.ones((K,), dtype=dtype, device=dev),
        betas=torch.zeros((K,), dtype=dtype, device=dev),
        h=torch.zeros((K,), dtype=dtype, device=dev),
        lam=torch.zeros((), dtype=dtype, device=dev),
        interior=torch.ones((), dtype=torch.bool, device=dev),
        min_ray=torch.full((), torch.inf, dtype=dtype, device=dev),
        max_ray=torch.full((), -torch.inf, dtype=dtype, device=dev),
        iters=torch.zeros((), dtype=torch.int32, device=dev),
        done=trivial,
    )
    return GLTRSetup(gamma0, tol, trivial, radius), init


def gltr_body(hess_prod: Callable[[Tensor], Tensor], aug_jac: AugJac, setup: GLTRSetup,
              K: int):
    """One Lanczos step with its reduced trust-region solve,
    ``body(s, trip)``: trip t is Lanczos step t + 1 on every lane still
    iterating, so the body's shapes depend on the trip."""
    gamma0, tol, radius = setup.gamma0, setup.tol, setup.radius
    eps = float(torch.finfo(gamma0.dtype).eps)
    rows = torch.arange(K, device=gamma0.device)

    def body(s, trip):
        V = s["V"]
        k = trip + 1  # the active dimension on every lane still iterating
        j = trip  # current Lanczos index
        v_j = V[j]
        w = project_nullspace(aug_jac, hess_prod(v_j))
        alpha_j = torch.dot(v_j, w)
        alphas = torch.where(rows == j, alpha_j, s["alphas"])

        # full reorthogonalization against the stored basis
        w = w - V.T @ (V @ w)
        beta_next = torch.linalg.norm(w)

        # reduced TR solve with the updated tridiagonal (warm-started)
        h, lam, interior = _tridiag_tr_solve(alphas, s["betas"], gamma0, radius, k,
                                             lam_warm=s["lam"], newton_iters=_MS_WARM_ITERS)

        # GLTR convergence: Lanczos residual |beta_k * h_k|
        converged = beta_next * h[j].abs() <= tol
        breakdown = beta_next <= 100.0 * eps * torch.clamp(gamma0, min=1.0)
        stop = converged | breakdown

        can_store = k + 1 <= K
        betas = torch.where(rows == min(k, K - 1), beta_next if can_store else 0.0, s["betas"])
        if can_store:
            V = torch.where((rows[:, None] == k) & ~stop,
                            (w / torch.where(beta_next > 0.0, beta_next, 1.0))[None, :], V)
        return dict(V=V, alphas=alphas, betas=betas, h=h, lam=lam, interior=interior,
                    min_ray=torch.minimum(s["min_ray"], alpha_j),
                    max_ray=torch.maximum(s["max_ray"], alpha_j),
                    iters=s["iters"] + 1, done=stop)

    return body


def gltr_result(setup: GLTRSetup, final: dict) -> TRResult:
    """The trust-region step from GLTR's final loop state."""
    finfo = torch.finfo(setup.gamma0.dtype)
    radius = setup.radius
    d = final["V"].T @ final["h"]
    d = torch.where(setup.trivial, 0.0, d)
    # final safeguard: never exceed the radius
    dn = torch.linalg.norm(d)
    d = d * torch.where(dn > radius, radius / torch.clamp(dn, min=finfo.tiny), 1.0)

    zero_spectrum = final["iters"] == 0
    return TRResult(
        step=d,
        on_boundary=~final["interior"],
        iterations=final["iters"],
        min_rayleigh=torch.where(zero_spectrum, 0.0, final["min_ray"]),
        max_rayleigh=torch.where(zero_spectrum, 0.0, final["max_ray"]),
    )


def gltr(
    hess_prod: Callable[[Tensor], Tensor],
    aug_jac: AugJac,
    gradient: Tensor,
    radius: Tensor,
    max_iterations: int,
    rel_tol: float = 1e-8,
    p0: Tensor | None = None,
) -> TRResult:
    """GLTR solve; interface as ``steihaug_cg``.  ``p0`` optionally supplies
    the initial nullspace projection of the gradient (the mixed-precision
    caller computes it in float64: near convergence ``P g`` cancels
    catastrophically)."""
    setup, init = gltr_start(aug_jac, gradient, radius, max_iterations, rel_tol, p0)
    K = init["V"].shape[0]
    final = lockstep(lambda s: ~s["done"], gltr_body(hess_prod, aug_jac, setup, K), init,
                     max_trips=K)
    return gltr_result(setup, final)
