"""Mixed-precision block-tridiagonal solves: the streaming block-Thomas
kernels, the block-tridiagonal product, and ``block_tridiag_solve_mp``.

Port of ``sleqp_tpu/ops/pallas_tridiag.py``.  The kernels are
``_fwd_stream_kernel`` (B3) and ``_bwd_stream_kernel`` (B4) of the
reference (``kernels/csrc/thomas.cu``): one forward sweep that factors the
system into explicit float32 block inverses by Gauss-Jordan and substitutes
(or, given stored inverses, only substitutes), and one backward sweep.
``block_tridiag_factor_solve_pallas`` / ``block_tridiag_resolve_pallas``
run them; ``block_tridiag_solve_mp`` factors in float32 on one of five
backends and refines in the input dtype through the stored factorization.

Each kernel's wrapper (``thomas_fwd``, ``thomas_bwd``) has its plain
PyTorch version beside it, which runs the same arithmetic and is what the
wrapper takes for a tensor on the CPU.  For a CUDA tensor the wrapper
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, and
nothing else.  The reference's VMEM tiling of the sweeps is the TPU's and
has no counterpart: each kernel is one thread block that walks the chain.
"""

from __future__ import annotations

import torch

from ..kernels import _build
from .block_tridiag import (
    block_thomas_factor,
    block_thomas_solve,
    block_tridiag_solve,
    pad_identity,
    pad_zeros,
    schur_factor,
    schur_resolve,
)
from .cyclic_reduction import bgj_flat_plain, cr_factor, cr_resolve
from .pallas_chol_tridiag import batched_thomas_factor_pallas, batched_thomas_solve_pallas

Tensor = torch.Tensor

# Kernel launches since the counts were last cleared, by kernel name.
LAUNCHES = {"thomas_fwd": 0, "thomas_bwd": 0}

# The Gauss-Jordan inverse runs k sweeps per stage; beyond this block size
# the Cholesky scan is the better choice.
MAX_PALLAS_BLOCK = 64

BACKENDS = ("auto", "chol_pallas", "spike32", "scan32", "cr32")


# Right-hand sides one launch of a sweep takes (thomas.cu's kMaxR): the
# kernels keep k x r carries in shared memory, so a wider right-hand side is
# walked in tiles of this many columns.
RHS_TILE = 128


def pallas_supported(N: int, k: int, r: int = 1) -> bool:
    """Whether the streaming kernels take blocks of k (any N and r)."""
    return k <= MAX_PALLAS_BLOCK


def _spike_chunks(N: int) -> int:
    """Chunk count balancing interior depth (~N/P) against the sequential
    separator recursion (~P): P ~ sqrt(N), a power of two in [2, 64]."""
    p = 1
    while p * p < N + 1:
        p *= 2
    return max(2, min(p, 64))


def _check_k(k: int, name: str) -> None:
    if k > MAX_PALLAS_BLOCK:
        raise ValueError(f"{name}: k={k} exceeds {MAX_PALLAS_BLOCK} (pallas_supported)")


# ---------------------------------------------------------------------------
# B3: forward sweep
# ---------------------------------------------------------------------------


def thomas_fwd_plain(D: Tensor, Lp: Tensor, b: Tensor, factor: bool):
    """Plain version of ``thomas_fwd``.  Per stage, with factor:
    C_i = D_i - L (M_{i-1} L^T), M_i = C_i^-1 by k Gauss-Jordan sweeps,
    y_i = M_i (b_i - L y_{i-1}), L = Lp[i]; without, D holds M."""
    N, k, _ = D.shape
    M_prev = torch.zeros((k, k), dtype=D.dtype, device=D.device)
    y_prev = torch.zeros_like(b[0])
    ys, Ms = [], []
    for i in range(N):
        Li = Lp[i]
        if factor:
            M_prev = bgj_flat_plain((D[i] - Li @ (M_prev @ Li.T))[None])[0]
            Ms.append(M_prev)
            Mi = M_prev
        else:
            Mi = D[i]
        y_prev = Mi @ (b[i] - Li @ y_prev)
        ys.append(y_prev)
    return torch.stack(ys), (torch.stack(Ms) if factor else None)


def thomas_fwd(D: Tensor, Lp: Tensor, b: Tensor, factor: bool):
    """Forward block-Thomas sweep over D (N, k, k), the shifted couplings
    Lp (N, k, k) (Lp[i] = L[i-1], Lp[0] = 0) and b (N, k, r); float32,
    contiguous, on one device.  Returns (y, M): with ``factor`` M holds the
    block inverses C_i^-1; without it D must hold them and M is None.

    Kernel ``thomas_fwd`` in ``kernels/csrc/thomas.cu``.  Replaces
    ``sleqp_tpu/ops/pallas_tridiag.py::_fwd_stream_kernel`` (pallas_call at
    :258), both modes.  The recursion is one chain, so it is one thread
    block that walks the N stages: a copy warp has the copy engine (TMA)
    bring each stage's blocks into a ring of up to four shared-memory slots
    ahead of 256 compute threads, which form M_{i-1} L^T and C_i by
    register-tiled FMA products and invert C_i by Gauss-Jordan in place in
    registers (M equals ``thomas_fwd_plain``'s bit for bit where both sum
    the products in index order), then substitute by shuffled mat-vecs.  A
    b of more than ``RHS_TILE`` columns is walked in tiles, one launch each:
    the first factors, the others substitute against its inverses.  With
    factor a stage needs at least ~3 k^3 float32 operations: the coupling
    update L_{i-1} M_{i-1} L_{i-1}^T, 2 k^3 at the least (a triangular
    product with a Cholesky factor of M_{i-1}, then a symmetric product; the
    kernel forms it from the explicit inverse as two full products, 4 k^3),
    and an SPD inverse, k^3.
    At the main path's (160, 64, 1): 0.13 GFLOP against 7.9 MB moved, so
    the whole card is bound at 2.4 us by bytes, but one chain runs on one
    SM, whose bound is 0.25 ms (67/132 TFLOP/s); what sets its time is the
    k sweeps of a stage, each a barrier, a division and the FMAs (~280
    cycles on the H100 at k = 64, ``tools/thomas_probe.py``).  Without
    factor it is 4 k^2 r operations per stage and bound by the 5.3 MB it
    reads.
    """
    name = "thomas_fwd"
    _build.check_operand(D, 3, name, "(N, k, k) blocks")
    _build.check_operand(Lp, 3, name, "(N, k, k) couplings")
    _build.check_operand(b, 3, name, "(N, k, r) right-hand sides")
    _build.check_chain(name, {"D": D, "Lp": Lp}, b)
    first, *rest = _build.rhs_tiles(b, RHS_TILE)
    y, M = _thomas_fwd_tile(D, Lp, first, factor)
    inverses = M if factor else D
    ys = [y] + [_thomas_fwd_tile(inverses, Lp, t, False)[0] for t in rest]
    return _build.join_tiles(ys), M


def _thomas_fwd_tile(D: Tensor, Lp: Tensor, b: Tensor, factor: bool):
    """``thomas_fwd`` on at most ``RHS_TILE`` right-hand sides: the plain
    version for a CPU tensor, else one launch of the kernel."""
    name = "thomas_fwd"
    if not _build.runs_kernel(b, name):
        return thomas_fwd_plain(D, Lp, b, factor)
    N, k, r = b.shape
    _check_k(k, name)
    y = torch.empty_like(b)
    M = torch.empty_like(D) if factor else None
    if N == 0:
        return y, M
    lib = _build.load()
    with torch.cuda.device(b.device):
        code = lib.thomas_fwd_launch(
            _build.ptr(D), _build.ptr(Lp), _build.ptr(b), _build.ptr(y),
            _build.ptr(M) if factor else None, N, k, r, int(factor),
            _build.stream_handle(b),
        )
    _build.check_launch(code, name)
    LAUNCHES[name] += 1
    return y, M


# ---------------------------------------------------------------------------
# B4: backward sweep
# ---------------------------------------------------------------------------


def thomas_bwd_plain(M: Tensor, Lp: Tensor, y: Tensor) -> Tensor:
    """Plain version of ``thomas_bwd``: x_{N-1} = y_{N-1}, then back to
    front x_i = y_i - M_i (L_i^T x_{i+1}) with L_i = Lp[i+1]."""
    N = y.shape[0]
    x = y[N - 1]
    xs = [x]
    for i in range(N - 2, -1, -1):
        x = y[i] - M[i] @ (Lp[i + 1].T @ x)
        xs.append(x)
    return torch.stack(xs[::-1])


def thomas_bwd(M: Tensor, Lp: Tensor, y: Tensor) -> Tensor:
    """Backward block-Thomas sweep: M (N, k, k) block inverses, Lp
    (N, k, k) shifted couplings as for ``thomas_fwd``, y (N, k, r) from the
    forward sweep; float32, contiguous, on one device.  Returns x (N, k, r).

    Kernel ``thomas_bwd`` in ``kernels/csrc/thomas.cu``.  Replaces
    ``sleqp_tpu/ops/pallas_tridiag.py::_bwd_stream_kernel`` (pallas_call at
    :287).  One thread block walks the chain back to front with x_{i+1} in
    shared memory and reads L_i as Lp[i+1] (the reference builds a second
    shifted copy Ls); a copy warp brings M_i and L_i ahead through the copy
    engine, and the two mat-vecs of a stage are split over groups of lanes
    and summed by shuffles.  One launch per ``RHS_TILE`` columns of y.
    4 k^2 r operations per stage; at the main path's (160, 64, 1) it must
    read 5.3 MB, 1.6 us at 3.35 TB/s, against 2.6 MFLOP, 5 us on one SM.
    """
    name = "thomas_bwd"
    _build.check_operand(M, 3, name, "(N, k, k) inverses")
    _build.check_operand(Lp, 3, name, "(N, k, k) couplings")
    _build.check_operand(y, 3, name, "(N, k, r) right-hand sides")
    _build.check_chain(name, {"M": M, "Lp": Lp}, y)
    tiles = _build.rhs_tiles(y, RHS_TILE)
    return _build.join_tiles([_thomas_bwd_tile(M, Lp, t) for t in tiles])


def _thomas_bwd_tile(M: Tensor, Lp: Tensor, y: Tensor) -> Tensor:
    """``thomas_bwd`` on at most ``RHS_TILE`` right-hand sides: the plain
    version for a CPU tensor, else one launch of the kernel."""
    name = "thomas_bwd"
    if not _build.runs_kernel(y, name):
        return thomas_bwd_plain(M, Lp, y)
    N, k, r = y.shape
    _check_k(k, name)
    x = torch.empty_like(y)
    if N == 0:
        return x
    lib = _build.load()
    with torch.cuda.device(y.device):
        code = lib.thomas_bwd_launch(
            _build.ptr(M), _build.ptr(Lp), _build.ptr(y), _build.ptr(x),
            N, k, r, _build.stream_handle(y),
        )
    _build.check_launch(code, name)
    LAUNCHES[name] += 1
    return x


# ---------------------------------------------------------------------------
# Factor-solve / resolve on the two sweeps
# ---------------------------------------------------------------------------


def _normalize_rhs(b: Tensor):
    if b.dim() == 2:
        return b[..., None], True
    return b, False


def _pad_sub(L: Tensor, N: int, k: int) -> Tensor:
    """(N-1, k, k) couplings -> float32 (N, k, k) with Lp[0] = 0."""
    Lp = torch.zeros((N, k, k), dtype=torch.float32, device=L.device)
    Lp[1:] = L
    return Lp


def block_tridiag_factor_solve_pallas(D: Tensor, L: Tensor, b: Tensor):
    """float32 factor + solve through the streaming kernels.  Returns
    (x, Minv, Lp32), the last two for ``block_tridiag_resolve_pallas``."""
    N, k, _ = D.shape
    b3, squeeze = _normalize_rhs(b)
    Lp32 = _pad_sub(L, N, k)
    y, Minv = thomas_fwd(
        D.to(torch.float32).contiguous(), Lp32, b3.to(torch.float32).contiguous(), factor=True
    )
    x = thomas_bwd(Minv, Lp32, y)
    return (x[..., 0] if squeeze else x), Minv, Lp32


def block_tridiag_resolve_pallas(Minv: Tensor, Lp32: Tensor, b: Tensor) -> Tensor:
    """Solve a new right-hand side against a stored float32 factorization."""
    b3, squeeze = _normalize_rhs(b)
    y, _ = thomas_fwd(Minv, Lp32, b3.to(torch.float32).contiguous(), factor=False)
    x = thomas_bwd(Minv, Lp32, y)
    return x[..., 0] if squeeze else x


def block_tridiag_matvec(D: Tensor, L: Tensor, x: Tensor) -> Tensor:
    """y = A x for symmetric block-tridiagonal A (D diagonal, L
    sub-diagonal blocks); x is (N, k) or (N, k, r)."""
    squeeze = x.dim() == 2
    x3 = x[..., None] if squeeze else x
    y = torch.einsum("nij,njr->nir", D, x3)
    y[1:] += torch.einsum("nij,njr->nir", L, x3[:-1])
    y[:-1] += torch.einsum("nji,njr->nir", L, x3[1:])
    return y[..., 0] if squeeze else y


# ---------------------------------------------------------------------------
# Mixed precision: float32 factorization, refinement in the input dtype
# ---------------------------------------------------------------------------


def block_tridiag_solve_mp(
    D: Tensor,
    L: Tensor,
    b: Tensor,
    *,
    refine_iters: int = 2,
    backend: str = "auto",
) -> Tensor:
    """Solve A x = b with a float32 factorization and ``refine_iters``
    refinements: residuals in b's dtype through ``block_tridiag_matvec``,
    corrections through the stored factorization.

    Backends:
      ``"auto"``        ``"cr32"`` for k <= 64, else ``"scan32"``;
      ``"cr32"``        float32 block cyclic reduction (kernels B1/B2);
      ``"scan32"``      float32 block-Thomas Cholesky scan;
      ``"spike32"``     float32 SPIKE, identity-padded to the chunk layout;
      ``"chol_pallas"`` the batched Cholesky Thomas kernels (B5/B6), P = 1.
    A float32 b is solved by the scan in float32 with no refinement.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown block_tridiag_solve_mp backend {backend!r}; expected one of {BACKENDS}"
        )
    N, k, _ = D.shape
    b3, squeeze = _normalize_rhs(b)
    dtype = b3.dtype
    if dtype == torch.float32:
        # nothing to refine against: single precision end to end, in the
        # dtype the operands promote to (as JAX's arithmetic does)
        dt = torch.promote_types(D.dtype, dtype)
        x = block_tridiag_solve(D.to(dt), L.to(dt), b3)
        return x[..., 0] if squeeze else x
    if b3.device.type == "cuda":
        _build.require_full_fp32()

    if backend == "auto":
        backend = "cr32" if k <= MAX_PALLAS_BLOCK else "scan32"
    D32 = D.to(torch.float32)
    L32 = L.to(torch.float32)

    if backend == "cr32":
        fact = cr_factor(D32, L32)

        def resolve(rhs):
            return cr_resolve(fact, rhs)

    elif backend == "chol_pallas":
        chols, Lp32 = batched_thomas_factor_pallas(D32[None], L32[None])

        def resolve(rhs):
            return batched_thomas_solve_pallas(chols, Lp32, rhs[None])[0]

    elif backend == "spike32":
        P = _spike_chunks(N)
        c = max(-(-(N + 1) // P), 2)  # schur_factor needs c >= 2
        pad = P * c - 1 - N
        fact = schur_factor(*pad_identity(D32, L32, pad), P)

        def resolve(rhs):
            return schur_resolve(fact, pad_zeros(rhs.to(torch.float32), pad))[:N]

    else:  # scan32
        chols = block_thomas_factor(D32, L32)

        def resolve(rhs):
            return block_thomas_solve(chols, L32, rhs.to(torch.float32))

    x = resolve(b3).to(dtype)
    for _ in range(refine_iters):
        resid = b3 - block_tridiag_matvec(D, L, x)
        x = x + resolve(resid).to(dtype)
    return x[..., 0] if squeeze else x
