"""Block-tridiagonal SPD solves: sequential block Thomas and the one-level
Schur/SPIKE decomposition, plus an LU variant for indefinite blocks.

Port of ``sleqp_tpu/ops/block_tridiag.py``:

* ``block_thomas_factor`` / ``block_thomas_solve``: the block-LDL^T
  recursion C_i = D_i - L_{i-1} C_{i-1}^{-1} L_{i-1}^T with a Cholesky
  factor per block.  It is the float64 route of the OCP solve and the
  oracle for the float32 routes.  The ``lax.scan`` of the reference is a
  Python loop here; any leading batch dimensions ride along, which takes
  the place of the reference's ``vmap`` over SPIKE chunks.
* ``schur_factor`` / ``schur_resolve`` (SPIKE): every c-th block is a
  separator, the P interior chunks factor and substitute as one batch, and
  only the (P-1)-block separator system is solved sequentially.
* ``block_thomas_factor_lu`` / ``block_thomas_solve_lu``: the same
  recursion with a pivoted LU per block.
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


def cho_solve(B: Tensor, chol: Tensor) -> Tensor:
    """``torch.cholesky_solve(B, chol)`` (lower factor) as its two
    substitutions, L y = B and L^T x = y.  On the CPU the bits are
    ``cholesky_solve``'s (LAPACK's potrs is these two trsm); on CUDA a batch
    goes to cuBLAS's batched trsm, which a CUDA graph captures, where
    ``cholesky_solve`` would call MAGMA's batched potrs, which allocates
    device memory inside the call and cannot be captured."""
    y = torch.linalg.solve_triangular(chol, B, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def block_thomas_factor(D: Tensor, L: Tensor) -> Tensor:
    """Factor an SPD block-tridiagonal matrix.

    D: (..., N, k, k) diagonal blocks; L: (..., N-1, k, k) sub-diagonal
    blocks (row i+1, col i).  Returns the Cholesky factors (..., N, k, k)
    of the Schur-complemented diagonal blocks.
    """
    chol = cholesky_or_nan(D[..., 0, :, :])
    chols = [chol]
    for i in range(1, D.shape[-3]):
        L_im1 = L[..., i - 1, :, :]
        W = cho_solve(L_im1.mT, chol)  # C^{-1} L^T
        chol = cholesky_or_nan(D[..., i, :, :] - L_im1 @ W)
        chols.append(chol)
    return torch.stack(chols, dim=-3)


def block_thomas_solve(chols: Tensor, L: Tensor, b: Tensor) -> Tensor:
    """Solve with factors from ``block_thomas_factor``; b is (..., N, k) or
    (..., N, k, nrhs) for factors (..., N, k, k)."""
    squeeze = b.dim() == chols.dim() - 1
    if squeeze:
        b = b[..., None]
    N = b.shape[-3]
    # forward: ys_i = C_i^{-1} (b_i - L_{i-1} ys_{i-1})
    y = cho_solve(b[..., 0, :, :], chols[..., 0, :, :])
    ys = [y]
    for i in range(1, N):
        y = cho_solve(
            b[..., i, :, :] - L[..., i - 1, :, :] @ y, chols[..., i, :, :]
        )
        ys.append(y)
    # backward: x_i = ys_i - C_i^{-1} L_i^T x_{i+1}
    x = ys[-1]
    xs = [x]
    for i in range(N - 2, -1, -1):
        x = ys[i] - cho_solve(L[..., i, :, :].mT @ x, chols[..., i, :, :])
        xs.append(x)
    x = torch.stack(xs[::-1], dim=-3)
    return x[..., 0] if squeeze else x


def block_tridiag_solve(D: Tensor, L: Tensor, b: Tensor) -> Tensor:
    """Factor + solve."""
    return block_thomas_solve(block_thomas_factor(D, L), L, b)


# ---------------------------------------------------------------------------
# One-level Schur / SPIKE decomposition
# ---------------------------------------------------------------------------


def _chunk_ids(P: int, c: int, device):
    """Block indices of P interior chunks of length c-1 and P-1 separators.

    Layout: [chunk_0 | sep_0 | chunk_1 | sep_1 | ... | chunk_{P-1}],
    N = P*c - 1.  Returns (ids (P, c-1), sep_idx (P-1,)); ``D[ids]`` stacks
    the chunks on a leading axis of P (the reference's ``_chunk_views``).
    """
    sep_idx = torch.arange(1, P, device=device) * c - 1
    ids = (torch.arange(P, device=device) * c)[:, None] + torch.arange(c - 1, device=device)[None, :]
    return ids, sep_idx


def _check_chunking(N: int, P: int) -> int:
    if (N + 1) % P != 0:
        raise ValueError(f"N+1={N + 1} must be divisible by num_chunks={P}")
    c = (N + 1) // P
    if c < 2:
        raise ValueError("chunks must contain at least one interior block")
    return c


def schur_factor(D: Tensor, L: Tensor, num_chunks: int) -> dict:
    """Factor the SPIKE decomposition once for repeated solves
    (``schur_resolve``).  Requires N = num_chunks * c - 1 with c >= 2.

    The interior chunks factor as one batch; the coupling columns
    VL = T^-1 [F at first], VR = T^-1 [E^T at last] of each chunk give the
    separators' Schur complement, which is factored by block Thomas.
    """
    N, k, _ = D.shape
    P = num_chunks
    c = _check_chunking(N, P)
    nin = c - 1
    ids, sep_idx = _chunk_ids(P, c, D.device)
    D_ch, L_ch = D[ids], L[ids[:, :-1]]
    # separator j sits between chunk j and chunk j+1:
    #   E_j = L[sep_j - 1] couples sep j to the last block of chunk j
    #   F_j = L[sep_j]     couples the first block of chunk j+1 to sep j
    E = L[sep_idx - 1]  # (P-1, k, k)
    F = L[sep_idx]  # (P-1, k, k)

    chols_ch = block_thomas_factor(D_ch, L_ch)  # (P, nin, k, k)
    zero = torch.zeros((1, k, k), dtype=D.dtype, device=D.device)
    F_pad = torch.cat([zero, F], dim=0)  # chunk j's left separator j-1
    E_pad = torch.cat([E, zero], dim=0)  # chunk j's right separator j
    # [F at first] and [E^T at last] of each chunk, assembled by
    # concatenation (no index write into a buffer, which vmap would refuse
    # for a lane's values)
    rest = torch.zeros((P, nin - 1, k, k), dtype=D.dtype, device=D.device)
    rhs_left = torch.cat([F_pad[:, None], rest], dim=1)
    rhs_right = torch.cat([rest, E_pad.mT[:, None]], dim=1)
    VL = block_thomas_solve(chols_ch, L_ch, rhs_left)  # (P, nin, k, k)
    VR = block_thomas_solve(chols_ch, L_ch, rhs_right)

    # separator row j: E_j x_last(j) + D_sep_j s_j + F_j^T x_first(j+1)
    # with x(chunk j) = u_j - VL_j s_{j-1} - VR_j s_j
    S_diag = (
        D[sep_idx]
        - torch.einsum("jab,jbc->jac", E, VR[:-1, -1])
        - torch.einsum("jba,jbc->jac", F, VL[1:, 0])
    )
    S_sub = -torch.einsum("jab,jbc->jac", E[1:], VL[1:-1, -1])
    sep_chols = block_thomas_factor(S_diag, S_sub)
    return dict(
        chols_ch=chols_ch,
        L_ch=L_ch,
        VL=VL,
        VR=VR,
        E=E,
        F=F,
        sep_chols=sep_chols,
        S_sub=S_sub,
        ids=ids,
        sep_idx=sep_idx,
        shape=(N, k, P, c),
    )


def schur_resolve(fact: dict, b: Tensor) -> Tensor:
    """Solve A x = b with a stored ``schur_factor``; b is (N, k) or
    (N, k, nrhs).  The interiors substitute as one batch; only the
    (P-1)-block separator substitution is sequential."""
    ids, sep_idx = fact["ids"], fact["sep_idx"]
    squeeze = b.dim() == 2
    if squeeze:
        b = b[..., None]
    u = block_thomas_solve(fact["chols_ch"], fact["L_ch"], b[ids])  # (P, nin, k, r)

    S_rhs = (
        b[sep_idx]
        - torch.einsum("jab,jbr->jar", fact["E"], u[:-1, -1])
        - torch.einsum("jba,jbr->jar", fact["F"], u[1:, 0])
    )
    s = block_thomas_solve(fact["sep_chols"], fact["S_sub"], S_rhs)

    zrow = torch.zeros((1,) + s.shape[1:], dtype=b.dtype, device=b.device)
    s_left = torch.cat([zrow, s], dim=0)
    s_right = torch.cat([s, zrow], dim=0)
    x_ch = (
        u
        - torch.einsum("pnab,pbr->pnar", fact["VL"], s_left)
        - torch.einsum("pnab,pbr->pnar", fact["VR"], s_right)
    )
    # [chunk_0 | sep_0 | chunk_1 | ... | chunk_{P-1}] by concatenation
    x = torch.cat([torch.cat([x_ch[:-1], s[:, None]], dim=1).flatten(0, 1), x_ch[-1]], dim=0)
    return x[..., 0] if squeeze else x


def schur_block_tridiag_solve(D: Tensor, L: Tensor, b: Tensor, num_chunks: int) -> Tensor:
    """Domain-decomposed solve; requires N = num_chunks * c - 1 for an
    integer c >= 2.  The reference computes the same quantities inline;
    here it is ``schur_factor`` followed by ``schur_resolve``."""
    return schur_resolve(schur_factor(D, L, num_chunks), b)


def spike_block_tridiag_solve(D: Tensor, L: Tensor, b: Tensor, num_chunks: int) -> Tensor:
    """One-shot SPIKE solve with identity padding to the chunk layout (any
    dtype).  Sequential depth ~ N/P + P instead of N."""
    N, k, _ = D.shape
    P = num_chunks
    c = max(-(-(N + 1) // P), 2)
    pad = P * c - 1 - N
    D, L = pad_identity(D, L, pad)
    return schur_resolve(schur_factor(D, L, P), pad_zeros(b, pad))[:N]


def pad_identity(D: Tensor, L: Tensor, pad: int):
    """Append ``pad`` identity diagonal blocks with zero couplings: trailing
    blocks that decouple exactly."""
    k = D.shape[-1]
    eye = torch.eye(k, dtype=D.dtype, device=D.device).expand(pad, k, k)
    return torch.cat([D, eye], dim=0), pad_zeros(L, pad)


def pad_zeros(t: Tensor, pad: int) -> Tensor:
    """Append ``pad`` zero blocks along the first axis."""
    return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])], dim=0)


# ---------------------------------------------------------------------------
# Symmetric-indefinite (quasi-definite) variant
# ---------------------------------------------------------------------------


def block_thomas_factor_lu(D: Tensor, L: Tensor):
    """Factor a symmetric indefinite block-tridiagonal matrix by the same
    Schur recursion with a pivoted LU per block.  Returns (lus, pivs) of
    the Schur-complemented diagonals (PyTorch's 1-based pivots)."""
    lu, piv = torch.linalg.lu_factor(D[0])
    lus, pivs = [lu], [piv]
    for i in range(1, D.shape[0]):
        W = torch.linalg.lu_solve(lu, piv, L[i - 1].T)  # C^{-1} L^T
        lu, piv = torch.linalg.lu_factor(D[i] - L[i - 1] @ W)
        lus.append(lu)
        pivs.append(piv)
    return torch.stack(lus), torch.stack(pivs)


def block_thomas_solve_lu(lus: Tensor, pivs: Tensor, L: Tensor, b: Tensor) -> Tensor:
    """Solve with factors from ``block_thomas_factor_lu``; b is (N, k) or
    (N, k, nrhs)."""
    squeeze = b.dim() == 2
    if squeeze:
        b = b[..., None]
    N = b.shape[0]
    y = torch.linalg.lu_solve(lus[0], pivs[0], b[0])
    ys = [y]
    for i in range(1, N):
        y = torch.linalg.lu_solve(lus[i], pivs[i], b[i] - L[i - 1] @ y)
        ys.append(y)
    x = ys[-1]
    xs = [x]
    for i in range(N - 2, -1, -1):
        x = ys[i] - torch.linalg.lu_solve(lus[i], pivs[i], L[i].T @ x)
        xs.append(x)
    x = torch.stack(xs[::-1])
    return x[..., 0] if squeeze else x


def block_tridiag_solve_lu(D: Tensor, L: Tensor, b: Tensor) -> Tensor:
    """LU factor + solve (symmetric indefinite blocks)."""
    lus, pivs = block_thomas_factor_lu(D, L)
    return block_thomas_solve_lu(lus, pivs, L, b)
