"""Augmented-Jacobian (KKT) solves over a masked working set.

Port of ``sleqp_tpu/ops/kkt.py`` (reference aug_jac layer,
src/main/aug_jac/): systems with the augmented matrix ``[I A_W^T; A_W 0]``
where ``A_W`` selects the working-set rows of ``A = [I_n; J]`` (variable
bounds first, then constraints).  With Dv/Dc the active-variable and
active-constraint masks, eliminating the identity variable block leaves
the m x m constraint Schur complement

    Sc = (I - Dc) + Dc J (I - Dv) J^T Dc

whose one factorization per working-set change serves ``solve_min_norm``,
``solve_lsq`` and ``project_nullspace``.

Factorization methods (pub_types.h:190-196 SLEQP_AUG_JAC_METHOD):
  * "reduced" (default): Cholesky of Sc (``torch.linalg.cholesky_ex``; a
    lower triangle of NaNs when Sc is not positive definite, as JAX's
    ``cho_factor`` gives);
  * "direct": QR of M = [(I-Dv) J^T Dc; I-Dc] with M^T M = Sc.
"""

from __future__ import annotations

import dataclasses

import torch

from ..types import ActiveState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AugJac:
    """Factorized masked KKT system (one per working-set change)."""

    chol: Tensor  # (m, m) lower factor of Sc
    cons_jac: Tensor  # (m, n) J
    active_var: Tensor  # (n,) Dv diagonal (float 0/1)
    active_cons: Tensor  # (m,) Dc diagonal

    def to(self, dtype: torch.dtype) -> "AugJac":
        return AugJac(*(getattr(self, f.name).to(dtype) for f in dataclasses.fields(AugJac)))


def aug_jac_create(
    cons_jac: Tensor,
    var_states: Tensor,
    cons_states: Tensor,
    reg: float = 0.0,
    method: str = "reduced",
) -> AugJac:
    """Assemble and factorize (reference: standard_aug_jac.c:34-101).
    ``reg`` adds a multiple of the identity to Sc."""
    m, n = cons_jac.shape
    dtype = cons_jac.dtype
    dv = (var_states != ActiveState.INACTIVE).to(dtype)
    dc = (cons_states != ActiveState.INACTIVE).to(dtype)

    JF = cons_jac * (1.0 - dv)[None, :]  # J (I - Dv): free-variable columns
    if method == "direct":
        M = torch.cat([JF.T * dc[None, :], torch.diag(1.0 - dc)], dim=0)  # M^T M = Sc
        chol = torch.linalg.qr(M, mode="r").R.T
    else:
        Sc = torch.diag(1.0 - dc) + dc[:, None] * (JF @ cons_jac.T) * dc[None, :]
        if reg:
            Sc = Sc + reg * torch.eye(m, dtype=dtype, device=cons_jac.device)
        L, info = torch.linalg.cholesky_ex(Sc)
        chol = torch.where(info != 0, torch.nan, L).tril()
    return AugJac(chol=chol, cons_jac=cons_jac, active_var=dv, active_cons=dc)


def _solve_S(aj: AugJac, rv: Tensor, rc: Tensor):
    """S lam = (rv, rc) through the constraint Schur complement:
    lam_c = Sc^{-1} (rc - Dc J Dv rv);  lam_v = rv - Dv J^T Dc lam_c."""
    dv, dc = aj.active_var, aj.active_cons
    rhs_c = rc - dc * (aj.cons_jac @ (dv * rv))
    lam_c = torch.cholesky_solve(rhs_c[:, None], aj.chol, upper=False)[:, 0]
    lam_v = rv - dv * (aj.cons_jac.T @ (dc * lam_c))
    return lam_v, lam_c


def _B_apply(aj: AugJac, lam_v: Tensor, lam_c: Tensor) -> Tensor:
    """x = B lam = A^T D lam = Dv lam_v + J^T (Dc lam_c)."""
    return aj.active_var * lam_v + aj.cons_jac.T @ (aj.active_cons * lam_c)


def solve_min_norm(aj: AugJac, rhs: Tensor) -> Tensor:
    """Min-norm x with A_W x = rhs on the working set; rhs is (n+m,),
    inactive entries ignored (aug_jac_solve_min_norm)."""
    n = aj.cons_jac.shape[1]
    rv = -(aj.active_var * rhs[:n])
    rc = -(aj.active_cons * rhs[n:])
    lam_v, lam_c = _solve_S(aj, rv, rc)
    return -_B_apply(aj, lam_v, lam_c)


def solve_lsq(aj: AugJac, g: Tensor):
    """Least-squares duals lambda = argmin ||A_W^T lambda - g||.  Returns
    (x, lambda) with x = g - A_W^T lambda, the projection of g onto
    null(A_W) (aug_jac_solve_lsq)."""
    rv = aj.active_var * g
    rc = aj.active_cons * (aj.cons_jac @ g)
    lam_v, lam_c = _solve_S(aj, rv, rc)
    x = g - _B_apply(aj, lam_v, lam_c)
    return x, torch.cat([lam_v, lam_c])


def project_nullspace(aj: AugJac, v: Tensor) -> Tensor:
    """Project v onto null(A_W) (once per CG/Lanczos iteration)."""
    return solve_lsq(aj, v)[0]
