"""Exhaustive vertex enumeration for tiny LPs.

Port of ``sleqp_tpu/ops/lp_enum.py``: for

    min c^T x   s.t.  A x = 0,   lb <= x <= ub        (m rows, N cols)

with at most ``MAX_CANDIDATES`` bases, every basis B of a static index
table is evaluated at once: the duals solve A_B^T y = c_B, the reduced
costs r = c - A^T y place every nonbasic column at the bound its sign asks
for, and x_B = -A_B^{-1} A_N x_N.  A candidate is valid when that placement
is dual feasible, A_B is nonsingular (checked by its solve residuals) and
x_B lies within its bounds; the valid candidate of lowest objective wins,
the first of a tie.  One batched computation, no pivot loop.

The index table is built once per (N, m) and device and kept there.
"""

from __future__ import annotations

from itertools import combinations
from math import comb

import numpy as np
import torch

from ..types import INF_THRESHOLD, BaseStat
from .simplex import OPTIMAL, SimplexResult

Tensor = torch.Tensor

# static gate: enumeration is used when C(N, m) stays below this
MAX_CANDIDATES = 4096
MAX_ROWS = 4

_TABLES: dict = {}


def num_candidates(N: int, m: int) -> int:
    return comb(N, m)


def suitable(N: int, m: int) -> bool:
    return 0 < m <= MAX_ROWS and num_candidates(N, m) <= MAX_CANDIDATES


def _combo_table(N: int, m: int) -> np.ndarray:
    return np.array(list(combinations(range(N), m)), dtype=np.int32)


def combo_table(N: int, m: int, device) -> Tensor:
    """The (C(N, m), m) basis table on ``device`` (int64), built once."""
    key = (N, m, torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(_combo_table(N, m), device=device).long()
    return _TABLES[key]


def _ge_solve(A: Tensor, b: Tensor) -> Tensor:
    """Batched dense solve by unrolled Gaussian elimination with partial
    pivoting: A (..., m, m), b (..., m) with tiny m.  Singular systems give
    inf/nan, which the caller's residual check discards."""
    m = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)  # (..., m, m+1)
    rows = torch.arange(m, device=A.device)
    for i in range(m):
        # partial pivot: the strongest remaining row for column i
        colv = torch.where(rows >= i, M[..., :, i].abs(), -torch.inf)
        p = torch.argmax(colv, dim=-1)  # (...,)
        perm = torch.where(rows == i, p[..., None],
                           torch.where(p[..., None] == rows, i, rows))  # (..., m)
        M = torch.gather(M, -2, perm[..., None].expand(M.shape))
        piv = M[..., i, :]  # (..., m+1)
        factor = M[..., :, i] / piv[..., i : i + 1]
        factor = torch.where(rows > i, factor, 0.0)
        M = M - factor[..., None] * piv[..., None, :]
    # back substitution (U x = y), unrolled; the buffer is made from M so
    # that it carries the lanes of A or b under vmap
    x = torch.zeros_like(M[..., m])
    for i in reversed(range(m)):
        acc = M[..., i, m] - (M[..., i, :m] * x).sum(dim=-1)
        x = x.clone()
        x[..., i] = acc / M[..., i, i]
    return x


def solve_enum(A: Tensor, c: Tensor, lb: Tensor, ub: Tensor,
               tol: float | None = None) -> SimplexResult:
    """Solve the box LP by parallel basis enumeration (see module doc)."""
    m, N = A.shape
    dtype, dev = A.dtype, A.device
    if tol is None:
        # 1e-9 in float64; ~50 eps in float32
        tol = max(1e-9, 50.0 * float(torch.finfo(dtype).eps))
    idx = combo_table(N, m, dev)  # (K, m)
    K = idx.shape[0]

    finite_lb = lb > -INF_THRESHOLD
    finite_ub = ub < INF_THRESHOLD

    AB = A.T[idx].transpose(1, 2)  # (K, m, m), AB[k][:, i] = A[:, idx[k, i]]
    cB = c[idx]  # (K, m)

    # duals: A_B^T y = c_B
    y = _ge_solve(AB.transpose(1, 2), cB)
    r = c[None, :] - y @ A  # (K, N)

    scale = 1.0 + c.abs()[None, :]
    pos = r > tol * scale
    neg = r < -tol * scale
    # nonbasic placement by reduced-cost sign; a zero r rests at a finite
    # bound (0 for free columns)
    rest = torch.where(finite_lb, lb, torch.where(finite_ub, ub, 0.0))
    v = torch.where(pos, lb[None, :], torch.where(neg, ub[None, :], rest[None, :]))
    dual_ok = ~((pos & ~finite_lb[None, :]) | (neg & ~finite_ub[None, :])).any(dim=1)

    basic_mask = torch.zeros((K, N), dtype=torch.bool, device=dev)
    basic_mask[torch.arange(K, device=dev)[:, None], idx] = torch.ones((), dtype=torch.bool,
                                                                     device=dev)
    v = torch.where(basic_mask, 0.0, v)

    rhs = -(v @ A.T)  # (K, m)
    xB = _ge_solve(AB, rhs)  # (K, m)

    lbB, ubB = lb[idx], ub[idx]
    # tolerance scale from finite bounds only
    sB = 1.0 + torch.maximum(torch.where(lbB > -INF_THRESHOLD, lbB.abs(), 0.0),
                             torch.where(ubB < INF_THRESHOLD, ubB.abs(), 0.0))
    primal_ok = ((xB >= lbB - tol * sB) & (xB <= ubB + tol * sB)).all(dim=1)
    finite_ok = (torch.isfinite(xB).all(dim=1) & torch.isfinite(y).all(dim=1)
                 & torch.isfinite(r).all(dim=1))
    # a (near-)singular A_B can give large finite garbage: check the
    # basis by its solve residuals
    ab_scale = 1.0 + AB.abs().amax(dim=(1, 2))
    dual_resid = (torch.einsum("kij,ki->kj", AB, y) - cB).abs().amax(dim=1)
    primal_resid = (torch.einsum("kij,kj->ki", AB, xB) - rhs).abs().amax(dim=1)
    x_scale = 1.0 + xB.abs().amax(dim=1)
    y_scale = 1.0 + y.abs().amax(dim=1) + cB.abs().amax(dim=1)
    resid_ok = ((dual_resid <= tol * ab_scale * y_scale)
                & (primal_resid <= tol * ab_scale * x_scale))
    valid = dual_ok & primal_ok & finite_ok & resid_ok

    obj = (v * c[None, :]).sum(dim=1) + (xB * cB).sum(dim=1)
    k_best = torch.argmin(torch.where(valid, obj, torch.inf)).reshape(1)

    idx_b = idx.index_select(0, k_best)[0]
    x = v.index_select(0, k_best)[0].index_put((idx_b,), xB.index_select(0, k_best)[0])
    pos_b, neg_b = pos.index_select(0, k_best)[0], neg.index_select(0, k_best)[0]
    rest_stat = torch.where(
        finite_lb, int(BaseStat.LOWER),
        torch.where(finite_ub, int(BaseStat.UPPER), int(BaseStat.ZERO)))
    status = torch.where(pos_b, int(BaseStat.LOWER),
                         torch.where(neg_b, int(BaseStat.UPPER), rest_stat)).to(torch.int8)
    status = status.index_put((idx_b,), torch.full((m,), int(BaseStat.BASIC), dtype=torch.int8,
                                                   device=dev))

    # 1-norm condition estimate of the winning basis (inverse by the same
    # elimination, one column of the identity per solve)
    ABb = AB.index_select(0, k_best)[0]
    eye = torch.eye(m, dtype=dtype, device=dev)
    ABinv = _ge_solve(ABb.expand(m, m, m), eye).T
    cond = ABb.abs().sum(dim=0).amax() * ABinv.abs().sum(dim=0).amax()

    return SimplexResult(
        x=x,
        duals=y.index_select(0, k_best)[0],
        reduced_costs=r.index_select(0, k_best)[0],
        status=status,
        basis=idx_b.to(torch.int32),
        obj=obj.index_select(0, k_best)[0],
        state=torch.full((), OPTIMAL, dtype=torch.int32, device=dev),
        iterations=torch.ones((), dtype=torch.int32, device=dev),
        condition=cond.to(dtype),
    )
