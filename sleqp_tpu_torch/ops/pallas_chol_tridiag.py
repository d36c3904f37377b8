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
right-looking Cholesky, row-wise triangular solves) and is what the wrapper
takes for a tensor on the CPU.  For a CUDA tensor the wrapper launches the
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

# the largest block the kernels take: three 64 KB tiles of shared memory
MAX_CHOL_BLOCK = 128

# Right-hand sides one launch of the solve takes (chol_thomas.cu's kMaxR):
# it keeps two r x k row sets in shared memory, so a wider right-hand side
# is walked in tiles of this many columns.
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


def _cho_solve_rows(G: Tensor, Y: Tensor) -> Tensor:
    """Rows of Y (P, n, k) times C^-1 for C = G G^T, G (P, k, k) lower:
    z G^T = y by forward substitution, then x G = z by backward
    substitution (``_cho_solve_t`` of the reference)."""
    Y = Y.clone()
    k = G.shape[-1]
    for j in range(k):
        acc = (Y[:, :, :j] * G[:, None, j, :j]).sum(-1)
        Y[:, :, j] = (Y[:, :, j] - acc) / G[:, None, j, j]
    for j in range(k - 1, -1, -1):
        acc = (Y[:, :, j + 1 :] * G[:, None, j + 1 :, j]).sum(-1)
        Y[:, :, j] = (Y[:, :, j] - acc) / G[:, None, j, j]
    return Y


# ---------------------------------------------------------------------------
# B5: the factorization
# ---------------------------------------------------------------------------


def chol_thomas_factor_plain(D: Tensor, Lp: Tensor) -> Tensor:
    """Plain version of ``chol_thomas_factor``: per stage,
    W = L_i C_{i-1}^-1 (two triangular solves), C_i = D_i - W L_i^T, and its
    right-looking Cholesky."""
    chols = torch.empty_like(D)
    prev = _cholesky_right_looking(D[:, 0])
    chols[:, 0] = prev
    for i in range(1, D.shape[1]):
        Li = Lp[:, i]
        W = _cho_solve_rows(prev, Li)
        prev = _cholesky_right_looking(D[:, i] - W @ Li.mT)
        chols[:, i] = prev
    return chols


def chol_thomas_factor(D: Tensor, Lp: Tensor) -> Tensor:
    """Cholesky factors (P, c, k, k) of the Schur-complemented diagonal
    blocks of P block-tridiagonal SPD systems: D (P, c, k, k) and the
    shifted couplings Lp (P, c, k, k), Lp[:, i] = L[:, i-1], Lp[:, 0] = 0;
    float32, contiguous, on one device.

    Kernel ``chol_thomas_factor`` in ``kernels/csrc/chol_thomas.cu``.
    Replaces ``sleqp_tpu/ops/pallas_chol_tridiag.py::_factor_kernel``
    (pallas_call at :278).  One thread block per system walks its c stages
    with at most three k x k tiles in shared memory (the previous factor,
    W, C_i); the factors go to a fresh tensor.  A stage needs at least
    ~2.33 k^3 float32 operations (Z = L_i G_{i-1}^-T by one triangular
    solve, k^3; the symmetric Z Z^T, k^3; the Cholesky, k^3/3); the kernel
    does 4.33 k^3 (two triangular solves and the full W L_i^T).  At the main
    path's (1, 160, 64): 98 MFLOP against 7.9 MB moved, so the whole card
    is bound at 2.3 us by bytes, but one chain runs on one SM, whose bound
    is 0.19 ms (67/132 TFLOP/s); the stages' 3k barriers and their row-wise
    substitutions set its time.
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
    (pallas_call at :302).  One thread block per system; the carry and the
    stage's right-hand sides live in shared memory as r rows of k, the
    factors and couplings are read from device memory in both sweeps.  One
    launch per ``RHS_TILE`` columns of B (128 KB of rows at k = 128).  Work
    ~8 k^2 r operations per stage.  At the main path's (1, 160, 64, 1): it
    must move 5.3 MB (factors and couplings once, b and x), 1.6 us at
    3.35 TB/s, against 5.2 MFLOP, 10 us on one SM; a single right-hand side
    is one thread's substitution chain, which sets its time.
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
