"""Batched Cholesky block Thomas for SPD block-tridiagonal systems, in
float32.

Port of ``sleqp_tpu/ops/pallas_chol_tridiag.py``.  P independent systems
(SPIKE chunks) of c blocks of k factor and solve at once; the recursion is
that of ``block_tridiag.block_thomas_factor``/``block_thomas_solve`` with a
Cholesky factor per block, so it is backward stable per step, unlike the
explicit inverses of ``pallas_tridiag``.

The two kernels (``kernels/csrc/chol_thomas.cu``) sit behind
``chol_thomas_factor`` (B5) and ``chol_thomas_solve`` (B6).  Each has its
plain PyTorch version beside it, which runs the same arithmetic (a
right-looking Cholesky; column-oriented triangular solves that multiply by
the reciprocal diagonal; C_i = D_i - Z Z^T with Z = L_i G_{i-1}^-T) and is
what the wrapper takes for a tensor on the CPU.  For a CUDA tensor the wrapper launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches, and nothing else.
The reference's transposed right-hand-side layout and its padding of r to
8 were workarounds for the TPU's compiler; the public shapes are kept.
"""

from __future__ import annotations

import torch

from ..kernels import _build
from .cyclic_reduction import fma_rank1

Tensor = torch.Tensor

# Kernel launches since the counts were last cleared, by kernel name.
LAUNCHES = {"chol_thomas_factor": 0, "chol_thomas_solve": 0}

# the largest block the kernels take: the factorization's three tiles of
# 128 x 132 floats fill 204 KB of a block's 227 KB of shared memory
MAX_CHOL_BLOCK = 128

# Right-hand sides one launch of the solve takes (chol_thomas.cu's kMaxR):
# their carry and a stage's k x r right-hand sides sit in shared memory, so
# a wider right-hand side is walked in tiles of this many columns.
RHS_TILE = 128


def chol_pallas_supported(P: int, c: int, k: int, r: int = 1) -> bool:
    """Whether the kernels take blocks of k (at most ``MAX_CHOL_BLOCK``;
    any P, c and r)."""
    return k <= MAX_CHOL_BLOCK


def _check_k(k: int, name: str) -> None:
    if k > MAX_CHOL_BLOCK:
        raise ValueError(
            f"{name}: k={k} exceeds {MAX_CHOL_BLOCK}, the largest block whose "
            "three tiles fit one thread block's shared memory"
        )


# ---------------------------------------------------------------------------
# The arithmetic of the kernels, batched over a leading axis
# ---------------------------------------------------------------------------


def _cholesky_right_looking(C: Tensor) -> Tensor:
    """Lower Cholesky factors of (P, k, k) SPD blocks: for each column j,
    col = A[j:, j] / sqrt(A[j, j]), then the trailing block loses col col^T
    (``_chol_batched`` of the reference)."""
    A = C.clone()
    k = A.shape[-1]
    for j in range(k):
        col = A[:, j:, j] * torch.rsqrt(A[:, j, j])[:, None]
        A[:, j:, j] = col
        A[:, j + 1 :, j + 1 :] = fma_rank1(A[:, j + 1 :, j + 1 :], col[:, 1:], col[:, 1:])
    return torch.tril(A)


def _forward_rows(G: Tensor, Y: Tensor) -> Tensor:
    """Rows y of Y (P, n, k) become z with z G^T = y, for G (P, k, k)
    lower triangular: column by column, z_j = y_j * (1 / G_jj), then every
    later entry l of the row loses G_lj z_j, rounded once as an FMA rounds:
    each entry takes its updates in the order the kernels apply them."""
    Y = Y.clone()
    rinv = 1.0 / torch.diagonal(G, dim1=-2, dim2=-1)  # (P, k)
    for j in range(G.shape[-1]):
        z = Y[:, :, j] * rinv[:, None, j]
        Y[:, :, j] = z
        Y[:, :, j + 1 :] = fma_rank1(Y[:, :, j + 1 :], z, G[:, j + 1 :, j])
    return Y


def _backward_rows(G: Tensor, Y: Tensor) -> Tensor:
    """Rows z of Y (P, n, k) become x with x G = z: from the last column
    back, x_j = z_j * (1 / G_jj), then every earlier entry l loses G_jl x_j,
    as ``chol_thomas.cu::backward_subst`` orders it."""
    Y = Y.clone()
    rinv = 1.0 / torch.diagonal(G, dim1=-2, dim2=-1)
    for j in range(G.shape[-1] - 1, -1, -1):
        x = Y[:, :, j] * rinv[:, None, j]
        Y[:, :, j] = x
        Y[:, :, :j] = fma_rank1(Y[:, :, :j], x, G[:, j, :j])
    return Y


def _cho_solve_rows(G: Tensor, Y: Tensor) -> Tensor:
    """Rows of Y (P, n, k) times C^-1 for C = G G^T, G (P, k, k) lower
    (``_cho_solve_t`` of the reference, in column-oriented form)."""
    return _backward_rows(G, _forward_rows(G, Y))


# ---------------------------------------------------------------------------
# B5: the factorization
# ---------------------------------------------------------------------------


def chol_thomas_factor_plain(D: Tensor, Lp: Tensor) -> Tensor:
    """Plain version of ``chol_thomas_factor``: per stage,
    Z = L_i G_{i-1}^-T (one triangular solve), C_i = D_i - Z Z^T, and its
    right-looking Cholesky.  L_i C_{i-1}^-1 L_i^T = Z Z^T, as the reference
    forms it with two solves and a full product."""
    chols = torch.empty_like(D)
    prev = _cholesky_right_looking(D[:, 0])
    chols[:, 0] = prev
    for i in range(1, D.shape[1]):
        Z = _forward_rows(prev, Lp[:, i])
        prev = _cholesky_right_looking(D[:, i] - Z @ Z.mT)
        chols[:, i] = prev
    return chols


def chol_thomas_factor(D: Tensor, Lp: Tensor) -> Tensor:
    """Cholesky factors (P, c, k, k) of the Schur-complemented diagonal
    blocks of P block-tridiagonal SPD systems: D (P, c, k, k) and the
    shifted couplings Lp (P, c, k, k), Lp[:, i] = L[:, i-1], Lp[:, 0] = 0;
    float32, contiguous, on one device.

    Kernel ``chol_thomas_factor`` in ``kernels/csrc/chol_thomas.cu``.
    Replaces ``sleqp_tpu/ops/pallas_chol_tridiag.py::_factor_kernel``
    (pallas_call at :278).  One thread block of 16 warps per system walks
    its c stages and does the least arithmetic a stage needs, ~2.33 k^3
    float32 operations: Z = L_i G_{i-1}^-T by one forward substitution (k^3;
    blocked by 8 columns: the block forms each entry's sum over the earlier
    columns, a thread per row solves the 8 x 8 triangle), the lower
    triangle of C_i = D_i - Z Z^T (k^3), and a blocked right-looking
    Cholesky (k^3/3): warp 0 factors each 16-column panel in registers with
    shuffles, the block updates the trailing triangle.  D_{i+1} and L_{i+1}
    are copied into shared memory (cp.async, zero-padded rows of
    32 ceil(k/32) + 4 floats) while stage i computes: 89 KB at k = 64; from
    k = 97 without overlap, 204 KB at k = 128.  The factors go to a fresh
    tensor, zero above the diagonal.  At the main path's (1, 160, 64):
    98 MFLOP against 7.9 MB moved, so the whole card is bound at 2.3 us by
    bytes, but one chain runs on one SM, whose bound is 0.19 ms
    (67/132 TFLOP/s); what holds it back is the panels' one-warp chain (a
    shuffle, a reciprocal square root and two multiply-adds a column) and
    the 26 barriers a stage.
    """
    _build.check_operand(D, 4, "chol_thomas_factor", "(P, c, k, k) blocks")
    _build.check_operand(Lp, 4, "chol_thomas_factor", "(P, c, k, k) couplings")
    _build.check_chain("chol_thomas_factor", {"D": D, "Lp": Lp})
    if not _build.runs_kernel(D, "chol_thomas_factor"):
        return chol_thomas_factor_plain(D, Lp)
    P, c, k, _ = D.shape
    _check_k(k, "chol_thomas_factor")
    chols = torch.empty_like(D)
    if D.numel() == 0:
        return chols
    lib = _build.load()
    with torch.cuda.device(D.device):
        code = lib.chol_thomas_factor_launch(
            _build.ptr(D), _build.ptr(Lp), _build.ptr(chols), P, c, k,
            _build.stream_handle(D),
        )
    _build.check_launch(code, "chol_thomas_factor")
    LAUNCHES["chol_thomas_factor"] += 1
    return chols


# ---------------------------------------------------------------------------
# B6: the substitutions
# ---------------------------------------------------------------------------


def chol_thomas_solve_plain(chols: Tensor, Lp: Tensor, B: Tensor) -> Tensor:
    """Plain version of ``chol_thomas_solve``: forward
    s_i = C_i^-1 (b_i - L_i s_{i-1}), backward
    x_i = s_i - C_i^-1 L_{i+1}^T x_{i+1}, with the right-hand sides as
    rows."""
    Bt = B.transpose(2, 3)  # (P, c, r, k)
    s = _cho_solve_rows(chols[:, 0], Bt[:, 0])
    xs = [s]
    for i in range(1, B.shape[1]):
        s = _cho_solve_rows(chols[:, i], Bt[:, i] - s @ Lp[:, i].mT)
        xs.append(s)
    x = s
    for i in range(B.shape[1] - 2, -1, -1):
        x = xs[i] - _cho_solve_rows(chols[:, i], x @ Lp[:, i + 1])
        xs[i] = x
    return torch.stack(xs, dim=1).transpose(2, 3).contiguous()


def chol_thomas_solve(chols: Tensor, Lp: Tensor, B: Tensor) -> Tensor:
    """Solve P systems against factors from ``chol_thomas_factor``:
    B (P, c, k, r) -> X (P, c, k, r); float32, contiguous, on one device.

    Kernel ``chol_thomas_solve`` in ``kernels/csrc/chol_thomas.cu``.
    Replaces ``sleqp_tpu/ops/pallas_chol_tridiag.py::_solve_kernel``
    (pallas_call at :302).  One thread block of 16 warps per system; a
    warp per right-hand side, its row in registers (k/32 entries a lane),
    the carry in shared memory, one barrier a stage.  The substitutions go
    8 entries at a time: the warp gathers them by shuffles, every lane
    solves their 8 x 8 diagonal block, and each lane updates its own later
    entries.  The warps without a right-hand side copy the next stage's
    factor, coupling and right-hand sides into shared memory (cp.async) and
    take 1/G_jj while the current stage solves: 169 KB at k = 64, r = 128;
    at k = 128 one stage's, 202 KB, without overlap.  One launch per
    ``RHS_TILE`` columns of B.  Work ~8 k^2 r operations per stage.  At the
    main path's (1, 160, 64, 1): it must move 5.3 MB (factors and couplings
    once, b and x), 1.6 us at 3.35 TB/s, against 5.2 MFLOP, 10 us on one
    SM; what holds it back is the warp's chain, 4k entries a stage, each
    8 behind a round of shuffles and ~20 shared-memory loads on the same
    pipe.
    """
    name = "chol_thomas_solve"
    _build.check_operand(chols, 4, name, "(P, c, k, k) factors")
    _build.check_operand(Lp, 4, name, "(P, c, k, k) couplings")
    _build.check_operand(B, 4, name, "(P, c, k, r) right-hand sides")
    _build.check_chain(name, {"chols": chols, "Lp": Lp}, B)
    tiles = _build.rhs_tiles(B, RHS_TILE)
    return _build.join_tiles([_chol_thomas_solve_tile(chols, Lp, t) for t in tiles])


def _chol_thomas_solve_tile(chols: Tensor, Lp: Tensor, B: Tensor) -> Tensor:
    """``chol_thomas_solve`` on at most ``RHS_TILE`` right-hand sides: the
    plain version for a CPU tensor, else one launch of the kernel."""
    name = "chol_thomas_solve"
    if not _build.runs_kernel(B, name):
        return chol_thomas_solve_plain(chols, Lp, B)
    P, c, k, r = B.shape
    _check_k(k, name)
    X = torch.empty_like(B)
    if B.numel() == 0:
        return X
    lib = _build.load()
    with torch.cuda.device(B.device):
        code = lib.chol_thomas_solve_launch(
            _build.ptr(chols), _build.ptr(Lp), _build.ptr(B), _build.ptr(X),
            P, c, k, r, _build.stream_handle(B),
        )
    _build.check_launch(code, name)
    LAUNCHES[name] += 1
    return X


# ---------------------------------------------------------------------------
# The reference's entry points
# ---------------------------------------------------------------------------


def _pad_sub(L: Tensor) -> Tensor:
    """(P, c-1, k, k) sub-diagonals -> (P, c, k, k) with Lp[:, 0] = 0."""
    P, _, k, _ = L.shape
    return torch.cat([torch.zeros((P, 1, k, k), dtype=L.dtype, device=L.device), L], dim=1)


def batched_thomas_factor_pallas(D: Tensor, L: Tensor):
    """float32 batched Thomas factorization.  D: (P, c, k, k);
    L: (P, c-1, k, k).  Returns (chols, Lp32) for
    ``batched_thomas_solve_pallas`` (factor once, solve many)."""
    Lp32 = _pad_sub(L.to(torch.float32)).contiguous()
    chols = chol_thomas_factor(D.to(torch.float32).contiguous(), Lp32)
    return chols, Lp32


def batched_thomas_solve_pallas(chols: Tensor, Lp32: Tensor, B: Tensor) -> Tensor:
    """Solve against a stored factorization.  B: (P, c, k) or (P, c, k, r);
    returns the same shape in float32."""
    squeeze = B.dim() == 3
    B32 = B.to(torch.float32)
    if squeeze:
        B32 = B32[..., None]
    X = chol_thomas_solve(chols, Lp32, B32.contiguous())
    return X[..., 0] if squeeze else X
