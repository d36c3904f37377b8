"""Sequential block-Thomas solve of SPD block-tridiagonal systems.

Port of ``block_thomas_factor``, ``block_thomas_solve`` and
``block_tridiag_solve`` of ``sleqp_tpu/ops/block_tridiag.py``: the
block-LDL^T recursion C_i = D_i - L_{i-1} C_{i-1}^{-1} L_{i-1}^T with a
Cholesky factor per block.  It is the float64 route of the OCP solve and
the oracle for the float32 cyclic-reduction route.  The ``lax.scan`` of the
reference is a Python loop here.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def cholesky_or_nan(A: Tensor) -> Tensor:
    """Lower Cholesky factor of each SPD block; a block that is not PD
    gets a factor of NaNs (as JAX's ``cho_factor`` gives), so the failure
    surfaces as a non-finite step without a host sync."""
    chol, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def block_thomas_factor(D: Tensor, L: Tensor) -> Tensor:
    """Factor an SPD block-tridiagonal matrix.

    D: (N, k, k) diagonal blocks; L: (N-1, k, k) sub-diagonal blocks
    (row i+1, col i).  Returns the Cholesky factors (N, k, k) of the
    Schur-complemented diagonal blocks.
    """
    chol = cholesky_or_nan(D[0])
    chols = [chol]
    for i in range(1, D.shape[0]):
        L_im1 = L[i - 1]
        W = torch.cholesky_solve(L_im1.T, chol)  # C^{-1} L^T
        chol = cholesky_or_nan(D[i] - L_im1 @ W)
        chols.append(chol)
    return torch.stack(chols)


def block_thomas_solve(chols: Tensor, L: Tensor, b: Tensor) -> Tensor:
    """Solve with factors from ``block_thomas_factor``; b is (N, k) or
    (N, k, nrhs)."""
    squeeze = b.dim() == 2
    if squeeze:
        b = b[..., None]
    N = b.shape[0]
    # forward: ys_i = C_i^{-1} (b_i - L_{i-1} ys_{i-1})
    y = torch.cholesky_solve(b[0], chols[0])
    ys = [y]
    for i in range(1, N):
        y = torch.cholesky_solve(b[i] - L[i - 1] @ y, chols[i])
        ys.append(y)
    # backward: x_i = ys_i - C_i^{-1} L_i^T x_{i+1}
    x = ys[-1]
    xs = [x]
    for i in range(N - 2, -1, -1):
        x = ys[i] - torch.cholesky_solve(L[i].T @ x, chols[i])
        xs.append(x)
    x = torch.stack(xs[::-1])
    return x[..., 0] if squeeze else x


def block_tridiag_solve(D: Tensor, L: Tensor, b: Tensor) -> Tensor:
    """Factor + solve."""
    return block_thomas_solve(block_thomas_factor(D, L), L, b)
