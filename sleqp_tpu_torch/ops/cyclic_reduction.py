"""Block cyclic reduction for SPD block-tridiagonal systems, and the batched
SPD inverses it is built on.

Port of ``sleqp_tpu/ops/cyclic_reduction.py``.  Each of the ~log2(N) levels
eliminates the even-indexed blocks with batched operations: one batched
inverse of the even diagonal blocks plus batched products, so the
sequential depth is O(log N) launches instead of O(N) tiny factorizations.
Cyclic reduction on an SPD matrix is block Gaussian elimination under an
odd-even permutation, so it needs no pivoting.  The per-block inverses are
float32; callers recover accuracy by refinement.  ``cr_factor`` stores the
per-level inverses and couplings and ``cr_resolve`` reuses them, so
refinement and multi-rhs solves do not factor again.

The two batched-inverse kernels (``csrc/bgj.cu``) sit behind
``bgj_flat`` and ``bgj_blocked64``.  Each has its plain PyTorch version
beside it, which runs the same arithmetic and is what the wrapper takes
for a tensor on the CPU.  For a CUDA tensor the wrapper launches the kernel
or raises.  ``LAUNCHES`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from ..kernels import _build

Tensor = torch.Tensor

# Kernel launches since the counts were last cleared, by kernel name.
LAUNCHES = {"bgj_flat": 0, "bgj_blocked64": 0}

_LEAF = 16  # leaf size of the blocked inverse
BLOCKED_K = 4 * _LEAF  # the only block size the blocked kernel takes


def _check_blocks(C: Tensor, name: str) -> None:
    if C.dim() != 3 or C.shape[1] != C.shape[2]:
        raise ValueError(f"{name}: expected (B, k, k) blocks, got {tuple(C.shape)}")
    if C.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 blocks, got {C.dtype}")


def _kernel_output(C: Tensor, name: str) -> Tensor:
    """Validate a batch on the card and allocate the kernel's output."""
    if not C.is_contiguous():
        raise ValueError(f"{name}: blocks must be contiguous")
    return torch.empty_like(C)


# ---------------------------------------------------------------------------
# B1: flat Gauss-Jordan inverse
# ---------------------------------------------------------------------------


def fma_rank1(A: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """A - u v^T for float32 A, u (..., m), v (..., n), each entry rounded
    once, as a fused multiply-add rounds it: the kernels' updates compile to
    FMAs, and the reference's updates round the same way (its flat inverse
    on the CPU equals ``bgj_flat_plain`` bit for bit).  The float32 product
    is exact in float64."""
    upd = torch.addcmul(A.double(), u.double()[..., :, None], v.double()[..., None, :], value=-1.0)
    return upd.to(A.dtype)


def bgj_flat_plain(C: Tensor) -> Tensor:
    """Plain version of ``bgj_flat``: k unpivoted Gauss-Jordan sweeps, each
    a rank-1 update of the tableau [A | A^-1] (the arithmetic of
    ``sleqp_tpu/ops/cyclic_reduction.py::_bgj_kernel``)."""
    B, k, _ = C.shape
    A = C
    Binv = torch.eye(k, dtype=C.dtype, device=C.device).expand(B, k, k)
    eye = torch.eye(k, dtype=C.dtype, device=C.device)
    for j in range(k):
        colj = A[:, :, j]  # (B, k)
        piv = colj[:, j : j + 1]  # (B, 1)
        rA = A[:, j, :] / piv
        rB = Binv[:, j, :] / piv
        f = colj - eye[j]
        A = fma_rank1(A, f, rA)
        Binv = fma_rank1(Binv, f, rB)
    return Binv


def bgj_flat(C: Tensor) -> Tensor:
    """Inverses of a batch of SPD float32 blocks, (B, k, k) -> (B, k, k).

    Kernel ``bgj_flat`` in ``kernels/csrc/bgj.cu``.  Replaces
    ``sleqp_tpu/ops/cyclic_reduction.py::_bgj_kernel`` (pallas_call at
    :228).  The k sweeps run in place in registers (``kernels/csrc/gj.cuh``),
    the block padded with the identity to 32, 64 or 96 rows and columns,
    one matrix a thread block of four threads a column, each thread a
    quarter of its column's rows, one ``__syncthreads`` a sweep.  Device
    memory sees each block read once and written once.  Bound: the
    2 B k^2 * 4 bytes it moves against the B k^3 float32 operations an SPD
    inverse needs at the least; at the main path's largest batch,
    (781, 32, 32), the bytes bound it (1.9 us at 3.35 TB/s against 0.4 us
    at 67 TFLOP/s).  Each matrix is a chain of k dependent sweeps, so the
    latency of one chain rather than either bound sets its time.
    """
    _check_blocks(C, "bgj_flat")
    if not _build.runs_kernel(C, "bgj_flat"):
        return bgj_flat_plain(C)
    M = _kernel_output(C, "bgj_flat")
    B, k, _ = C.shape
    if B == 0:
        return M
    lib = _build.load()
    if k > lib.bgj_flat_max_k():
        raise ValueError(
            f"bgj_flat: k={k} exceeds {lib.bgj_flat_max_k()}, the widest "
            "block the kernel pads (its registers hold the matrix)"
        )
    with torch.cuda.device(C.device):
        code = lib.bgj_flat_launch(
            _build.ptr(C), _build.ptr(M), B, k, _build.stream_handle(C)
        )
    _build.check_launch(code, "bgj_flat")
    LAUNCHES["bgj_flat"] += 1
    return M


# ---------------------------------------------------------------------------
# B2: blocked 2x2 block-Schur inverse for k = 64
# ---------------------------------------------------------------------------


def _schur_quadrants(C: Tensor, inv_half):
    """Quadrants of inv(C) for one 2x2 block-Schur level (stable without
    pivoting: leading principal blocks of an SPD matrix are PD).

        inv([[A, Bm], [Bm^T, D]]) = [[Ai + V Si W,  -V Si],
                                     [-Si W,          Si ]]
        with Ai = inv(A), W = Bm^T Ai, S = D - W Bm, Si = inv(S),
        V = Ai Bm.
    """
    h = C.shape[1] // 2
    A = C[:, :h, :h]
    Bm = C[:, :h, h:]
    D = C[:, h:, h:]
    Ai = inv_half(A)
    W = torch.bmm(Bm.transpose(1, 2), Ai)
    S = D - torch.bmm(W, Bm)
    Si = inv_half(S)
    V = torch.bmm(Ai, Bm)
    VSi = torch.bmm(V, Si)
    return Ai + torch.bmm(VSi, W), -VSi, -torch.bmm(Si, W), Si


def _schur_inverse(C: Tensor, inv_half) -> Tensor:
    tl, tr, bl, br = _schur_quadrants(C, inv_half)
    return torch.cat([torch.cat([tl, tr], dim=2), torch.cat([bl, br], dim=2)], dim=1)


def bgj_blocked64_plain(C: Tensor) -> Tensor:
    """Plain version of ``bgj_blocked64``: two Schur levels (64 -> 32 -> 16)
    over Gauss-Jordan leaves, the products in ``torch.bmm`` (the arithmetic
    of ``sleqp_tpu/ops/cyclic_reduction.py::_bgj_blocked_kernel``)."""
    return _schur_inverse(C, lambda A: _schur_inverse(A, bgj_flat_plain))


def bgj_blocked64(C: Tensor) -> Tensor:
    """Inverses of a batch of SPD float32 64 x 64 blocks, (B, 64, 64).

    Kernel ``bgj_blocked64`` in ``kernels/csrc/bgj.cu``.  Replaces
    ``sleqp_tpu/ops/cyclic_reduction.py::_bgj_blocked_kernel`` (pallas_call
    at :218).  One 128-thread block per matrix: two 2x2 block-Schur levels
    down to 16 x 16 Gauss-Jordan leaves on one warp, the six products of
    each level register-tiled float32 FMA chains in index order (the
    reference's ``Precision.HIGHEST`` products; TF32 keeps about three
    decimal digits, far from the 1e-4 identity bar of the reference test).
    Bound at the main path's (1561, 64, 64): it moves
    2 * 1561 * 64^2 * 4 B = 51 MB against 1561 * 64^3 float32 operations
    at the least, so device memory bounds it (15 us at 3.35 TB/s against
    6 us at 67 TFLOP/s); the Schur levels' ~262k FMAs a matrix take 12 us
    of the card's float32 rate.
    """
    _check_blocks(C, "bgj_blocked64")
    if not _build.runs_kernel(C, "bgj_blocked64"):
        return bgj_blocked64_plain(C)
    M = _kernel_output(C, "bgj_blocked64")
    B, k, _ = C.shape
    if k != BLOCKED_K:
        raise ValueError(f"bgj_blocked64: expected k={BLOCKED_K}, got k={k}")
    if B == 0:
        return M
    lib = _build.load()
    with torch.cuda.device(C.device):
        code = lib.bgj_blocked64_launch(
            _build.ptr(C), _build.ptr(M), B, _build.stream_handle(C)
        )
    _build.check_launch(code, "bgj_blocked64")
    LAUNCHES["bgj_blocked64"] += 1
    return M


def batched_gj_inverse(C: Tensor) -> Tensor:
    """Inverses of a batch of SPD blocks, (B, k, k) -> (B, k, k) float32.

    k = 64 goes to the blocked Schur inverse (measured on the TPU as the
    faster of the two at that size), every other k to the flat sweep.
    """
    C32 = C.to(torch.float32).contiguous()
    if C32.shape[-1] == BLOCKED_K:
        return bgj_blocked64(C32)
    return bgj_flat(C32)


# ---------------------------------------------------------------------------
# Cyclic-reduction factor / resolve
# ---------------------------------------------------------------------------


def _pad_odd(D: Tensor, L: Tensor) -> tuple[Tensor, Tensor]:
    """Append one identity block (zero coupling) when the level size is
    even, so the even/odd split is always clean."""
    n, k, _ = D.shape
    if n % 2 == 1:
        return D, L
    eye = torch.eye(k, dtype=D.dtype, device=D.device)[None]
    D = torch.cat([D, eye], dim=0)
    L = torch.cat([L, torch.zeros((1, k, k), dtype=L.dtype, device=L.device)], dim=0)
    return D, L


def cr_factor(D: Tensor, L: Tensor, *, tail_n: int = 1) -> dict:
    """Factor an SPD block-tridiagonal system by cyclic reduction.

    D: (N, k, k), L: (N-1, k, k) (L[i] couples row i+1 <- col i), both
    taken to float32.  Returns the per-level factors consumed by
    ``cr_resolve``; level sizes halve until ``tail_n`` blocks remain
    (default: down to one block).  With ``tail_n`` > 1 the remaining tail
    is factored by the streaming block-Thomas kernels (B3/B4) with a zero
    right-hand side, and ``cr_resolve`` solves it through them.
    """
    D = D.to(torch.float32)
    L = L.to(torch.float32)
    k = D.shape[1]
    levels = []
    while D.shape[0] > max(tail_n, 1):
        n_in = D.shape[0]
        D, L = _pad_odd(D, L)
        n = D.shape[0]
        m_o = (n - 1) // 2  # odds survive
        M_ev = batched_gj_inverse(D[0::2])  # (m_o + 1, k, k)
        # couplings around each odd j = 2m+1:
        #   L_left[m]  = L[j-1] = L[0::2][m]   (row j <- col j-1)
        #   L_right[m] = L[j]   = L[1::2][m]   (row j+1 <- col j)
        L_left = L[0::2][:m_o]
        L_right = L[1::2][:m_o]
        Ml = M_ev[:m_o]  # inverse of even j-1
        Mr = M_ev[1 : m_o + 1]  # inverse of even j+1
        Wl = torch.einsum("mij,mjk->mik", L_left, Ml)  # L[j-1] M_{j-1}
        Wr = torch.einsum("mji,mjk->mik", L_right, Mr)  # L[j]^T M_{j+1}
        # D'_j = D_j - L_{j-1} M_{j-1} L_{j-1}^T - L_j^T M_{j+1} L_j
        Dn = (
            D[1::2][:m_o]
            - torch.einsum("mij,mkj->mik", Wl, L_left)
            - torch.einsum("mij,mjk->mik", Wr, L_right)
        )
        # new coupling (old j+2 <- old j): -L[j+1] M_{j+1} L[j]
        L_next = L[2::2][: m_o - 1]
        Ln = -torch.einsum(
            "mij,mjk->mik",
            torch.einsum("mij,mjk->mik", L_next, Mr[: m_o - 1]),
            L_right[: m_o - 1],
        )
        levels.append(
            dict(n=n, n_in=n_in, M_ev=M_ev, L_left=L_left, L_right=L_right, Wl=Wl, Wr=Wr)
        )
        D, L = Dn, Ln
    if D.shape[0] == 1:
        return dict(levels=levels, root=batched_gj_inverse(D), tail=None, k=k)
    from .pallas_tridiag import block_tridiag_factor_solve_pallas

    zero = torch.zeros((D.shape[0], k, 1), dtype=torch.float32, device=D.device)
    _, Minv, Lp32 = block_tridiag_factor_solve_pallas(D, L, zero)
    return dict(levels=levels, root=None, tail=dict(Minv=Minv, Lp32=Lp32), k=k)


def cr_resolve(fact: dict, b: Tensor) -> Tensor:
    """Solve against a stored cyclic-reduction factorization.

    b: (N, k) or (N, k, r) in any float dtype; computed in float32.
    """
    squeeze = b.dim() == 2
    b3 = b.to(torch.float32)
    if squeeze:
        b3 = b3[..., None]
    k = fact["k"]
    r = b3.shape[-1]
    dev = b3.device

    # -- reduction sweep: fold even rhs into the odd system ------------
    stack = []
    for lv in fact["levels"]:
        n = lv["n"]
        if b3.shape[0] < n:  # level was identity-padded
            pad = torch.zeros((n - b3.shape[0], k, r), dtype=torch.float32, device=dev)
            b3 = torch.cat([b3, pad], dim=0)
        m_o = (n - 1) // 2
        b_ev = b3[0::2]
        b_od = b3[1::2][:m_o]
        bn = (
            b_od
            - torch.einsum("mij,mjr->mir", lv["Wl"], b_ev[:m_o])
            - torch.einsum("mij,mjr->mir", lv["Wr"], b_ev[1 : m_o + 1])
        )
        stack.append(b_ev)
        b3 = bn

    if fact["tail"] is None:
        x = torch.einsum("mij,mjr->mir", fact["root"], b3)  # (1, k, r)
    else:
        from .pallas_tridiag import block_tridiag_resolve_pallas

        x = block_tridiag_resolve_pallas(fact["tail"]["Minv"], fact["tail"]["Lp32"], b3)

    # -- back-substitution sweep ---------------------------------------
    zero_kk = torch.zeros((1, k, k), dtype=torch.float32, device=dev)
    zero = torch.zeros((1, k, r), dtype=torch.float32, device=dev)
    for lv, b_ev in zip(reversed(fact["levels"]), reversed(stack)):
        n = lv["n"]
        x_l = torch.cat([zero, x], dim=0)  # x_{e-1} per even
        x_r = torch.cat([x, zero], dim=0)  # x_{e+1} per even
        # L into even e: L[e-1] = L_right[p-1] (front-pad), L[e] = L_left[p]
        # (end-pad); padded entries multiply the zero neighbours anyway
        Lr_pad = torch.cat([zero_kk, lv["L_right"]], dim=0)
        Ll_pad = torch.cat([lv["L_left"], zero_kk], dim=0)
        rhs_e = (
            b_ev
            - torch.einsum("pij,pjr->pir", Lr_pad, x_l)
            - torch.einsum("pji,pjr->pir", Ll_pad, x_r)
        )
        x_ev = torch.einsum("pij,pjr->pir", lv["M_ev"], rhs_e)
        # interleave evens and odds back into level ordering, dropping the
        # identity-padding row so the size matches the parent level
        xn = torch.empty((n, k, r), dtype=torch.float32, device=dev)
        xn[0::2] = x_ev
        xn[1::2] = x
        x = xn[: lv["n_in"]]

    x = x[: b.shape[0]]
    return x[..., 0] if squeeze else x


def cr_solve(D: Tensor, L: Tensor, b: Tensor) -> Tensor:
    """Factor + resolve in float32."""
    return cr_resolve(cr_factor(D, L), b)
