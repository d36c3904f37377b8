"""Block-tridiagonal matrix-vector product.

Only ``block_tridiag_matvec`` of ``sleqp_tpu/ops/pallas_tridiag.py`` is on
the ported path (the refinement step of the float32 OCP solve); the module
keeps the reference's name so that each file pairs with its counterpart.
The streaming Thomas kernels and ``block_tridiag_solve_mp`` of that module
are still to be ported (ROADMAP.md queue B, kernels B3/B4).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def block_tridiag_matvec(D: Tensor, L: Tensor, x: Tensor) -> Tensor:
    """y = A x for symmetric block-tridiagonal A (D diagonal, L
    sub-diagonal blocks); x is (N, k) or (N, k, r)."""
    squeeze = x.dim() == 2
    x3 = x[..., None] if squeeze else x
    y = torch.einsum("nij,njr->nir", D, x3)
    y[1:] += torch.einsum("nij,njr->nir", L, x3[:-1])
    y[:-1] += torch.einsum("nji,njr->nir", L, x3[1:])
    return y[..., 0] if squeeze else y
