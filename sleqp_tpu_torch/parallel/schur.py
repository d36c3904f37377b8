"""Schur-complement block-tridiagonal KKT solve across the ranks of a mesh.

Port of ``sleqp_tpu/parallel/schur.py`` (BASELINE configs 4-5): an SPD
block-tridiagonal system is cut into one contiguous chunk of blocks a rank.
Each rank factors its chunk's interior independently, computes its (k x k)
contributions to the separator Schur system, gathers every rank's
contributions, solves the small separator system (replicated on every
rank), and back-substitutes its chunk.

The reference's ``shard_map`` over a ``jax.sharding.Mesh`` axis becomes
``torch.distributed``: ``mesh`` is a 1-D ``DeviceMesh`` whose axis
``axis_name`` spans the ranks (``parallel/ranks.py`` starts them), one rank
per chunk as the reference has one device per chunk.  Every rank calls
``sharded_schur_solve`` with the whole system and takes its own chunk; the
reference's seven ``all_gather``s are packed into one, and one more gathers
the chunks' solutions, so that every rank returns the global x (the
reference's ``out_specs`` reassemble it): two collectives a solve
(``collectives.CALLS``).
"""

from __future__ import annotations

import torch

from ..ops.block_tridiag import block_thomas_factor, block_thomas_solve, block_tridiag_solve
from ..ops.pallas_tridiag import block_tridiag_solve_mp
from .collectives import all_gather_rows, axis_group

Tensor = torch.Tensor


def chunk_layout(D: Tensor, L: Tensor, b: Tensor, num_chunks: int):
    """Split a global block-tridiagonal system into the chunked layout.

    Requires N = num_chunks * c - 1.  Returns per-chunk tensors with dummy
    (zero) couplings padded at the global boundaries:

      D_ch (P, c-1, k, k), L_ch (P, c-2, k, k), b_ch (P, c-1, k),
      E_pad (P, k, k)  separator p  <- last block of chunk p  (E[P-1]=0)
      F_pad (P, k, k)  first block of chunk p <- separator p-1 (F[0]=0)
      D_sep (P, k, k)  separator diagonals (last entry dummy identity)
      b_sep (P, k)
    and the separators' and chunks' first block indices, sep_idx (P-1,)
    and chunk_start (P,).
    """
    N, k, _ = D.shape
    Pc = num_chunks
    if (N + 1) % Pc != 0:
        raise ValueError(f"N+1={N + 1} not divisible by num_chunks={Pc}")
    c = (N + 1) // Pc
    nin = c - 1
    dev = D.device
    sep_idx = torch.arange(1, Pc, device=dev) * c - 1
    chunk_start = torch.arange(Pc, device=dev) * c
    ids = chunk_start[:, None] + torch.arange(nin, device=dev)[None, :]
    D_ch, L_ch, b_ch = D[ids], L[ids[:, :-1]], b[ids]

    zero = torch.zeros((1, k, k), dtype=D.dtype, device=dev)
    E_pad = torch.cat([L[sep_idx - 1], zero], dim=0)
    F_pad = torch.cat([zero, L[sep_idx]], dim=0)
    D_sep = torch.cat([D[sep_idx], torch.eye(k, dtype=D.dtype, device=dev)[None]], dim=0)
    b_sep = torch.cat([b[sep_idx], torch.zeros((1, k), dtype=D.dtype, device=dev)], dim=0)
    return D_ch, L_ch, b_ch, E_pad, F_pad, D_sep, b_sep, sep_idx, chunk_start


def _coupling_rhs(D_c: Tensor, E_p: Tensor, F_p: Tensor):
    """The coupling columns of a chunk: F_p on its first block, E_p^T on its
    last, zero elsewhere, (c-1, k, k) each."""
    nin, k = D_c.shape[0], D_c.shape[-1]
    rhs_left = torch.zeros((nin, k, k), dtype=D_c.dtype, device=D_c.device)
    rhs_left[0] = F_p
    rhs_right = torch.zeros_like(rhs_left)
    rhs_right[-1] = E_p.mT
    return rhs_left, rhs_right


def _contributions(u, VL, VR, E_p, F_p):
    """A chunk's contributions to the separator system (see
    ``ops/block_tridiag.schur_factor``)."""
    right_diag = E_p @ VR[-1]  # -> separator p diagonal
    left_diag = F_p.mT @ VL[0]  # -> separator p-1 diagonal
    off = E_p @ VL[-1]  # -> coupling (sep p-1, sep p)
    rhs_right_sep = E_p @ u[-1]  # -> separator p rhs
    rhs_left_sep = F_p.mT @ u[0]  # -> separator p-1 rhs
    return right_diag, left_diag, off, rhs_right_sep, rhs_left_sep


def _local_contributions(D_c, L_c, b_c, E_p, F_p):
    """A chunk's interior elimination by the block-Thomas recursion in the
    system's dtype (runs independently on each rank)."""
    chols = block_thomas_factor(D_c, L_c)
    u = block_thomas_solve(chols, L_c, b_c)
    rhs_left, rhs_right = _coupling_rhs(D_c, E_p, F_p)
    VL = block_thomas_solve(chols, L_c, rhs_left)
    VR = block_thomas_solve(chols, L_c, rhs_right)
    return u, VL, VR, _contributions(u, VL, VR, E_p, F_p)


def _local_contributions_pallas(D_c, L_c, b_c, E_p, F_p):
    """A chunk's interior elimination through ``block_tridiag_solve_mp``:
    the raw rhs and both coupling column sets as ONE stacked (1+2k)-column
    rhs against one float32 factorization, with three refinements in the
    system's dtype.  Its backend is ``"auto"``, as the reference's:
    ``cr32`` for k <= 64, whose batched inverses are the kernels B1/B2."""
    k = b_c.shape[-1]
    rhs_left, rhs_right = _coupling_rhs(D_c, E_p, F_p)
    B = torch.cat([b_c[:, :, None], rhs_left, rhs_right], dim=-1)
    X = block_tridiag_solve_mp(D_c, L_c, B, refine_iters=3)
    u, VL, VR = X[..., 0], X[..., 1 : 1 + k], X[..., 1 + k :]
    return u, VL, VR, _contributions(u, VL, VR, E_p, F_p)


def sharded_schur_solve(
    D: Tensor,
    L: Tensor,
    b: Tensor,
    mesh,
    axis_name: str = "chunks",
    tridiag_backend: str = "scan",
) -> Tensor:
    """Solve the SPD block-tridiagonal system A x = b across the ranks of
    ``mesh``'s axis ``axis_name``, one chunk a rank.

    D (N, k, k), L (N-1, k, k), b (N, k), with N + 1 divisible by the
    number of ranks; every rank passes the same system and returns the
    same x (N, k).  ``tridiag_backend="pallas"`` runs each rank's interior
    elimination through ``block_tridiag_solve_mp`` (float32 factorization,
    refined in the system's dtype); anything else the block-Thomas
    recursion.
    """
    group, Pc, p = axis_group(mesh, axis_name)
    D_ch, L_ch, b_ch, E_pad, F_pad, D_sep, b_sep, sep_idx, chunk_start = chunk_layout(
        D, L, b, Pc)
    N, k, _ = D.shape
    nin = b_ch.shape[1]
    local = _local_contributions_pallas if tridiag_backend == "pallas" else _local_contributions
    u, VL, VR, contribs = local(D_ch[p], L_ch[p], b_ch[p], E_pad[p], F_pad[p])

    # every rank's contributions and separator data, in one collective
    g_right, g_left, g_off, g_rhs_r, g_rhs_l, g_D_sep, g_b_sep = all_gather_rows(
        (*contribs, D_sep[p], b_sep[p]), group)

    # the (P-1)-block separator system (replicated)
    S_diag = g_D_sep[: Pc - 1] - g_right[: Pc - 1] - g_left[1:Pc]
    S_sub = -g_off[1 : Pc - 1]
    S_rhs = g_b_sep[: Pc - 1] - g_rhs_r[: Pc - 1] - g_rhs_l[1:Pc]
    s = block_tridiag_solve(S_diag, S_sub, S_rhs) if Pc > 1 else S_rhs  # (P-1, k)

    # local back-substitution with the neighbouring separator values
    zero = torch.zeros((k,), dtype=D.dtype, device=D.device)
    s_left = s[p - 1] if p > 0 else zero
    s_right = s[p] if p < Pc - 1 else zero
    x_local = (
        u
        - torch.einsum("nab,b->na", VL, s_left)
        - torch.einsum("nab,b->na", VR, s_right)
    )
    x_ch = all_gather_rows(x_local, group)  # (P, c-1, k)

    # the global ordering
    x = torch.zeros((N, k), dtype=D.dtype, device=D.device)
    ids = (chunk_start[:, None] + torch.arange(nin, device=D.device)[None, :]).reshape(-1)
    x[ids] = x_ch.reshape(-1, k)
    x[sep_idx] = s
    return x
