"""Quasi-Newton containers of the solver state.

The solver state of ``sleqp_tpu/problem_solver.py`` carries a quasi-Newton
ring buffer (``qn``) and the previous iterate's data (``qn_prev``) whatever
the Hessian mode, so the port keeps their shapes: ``QNState``, ``QNPrev``,
``qn_init`` and ``qn_prev_init`` as in ``sleqp_tpu/quasi_newton.py``.  The
BFGS/SR1 products and pushes (``hess_eval != HessEval.EXACT``) are not
ported yet (ROADMAP.md queue A item 7) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

QN_NOT_PORTED = (
    "quasi-Newton Hessians (hess_eval != HessEval.EXACT: the BFGS/SR1 "
    "products of quasi_newton.py) are not ported yet (ROADMAP.md queue A item 7)"
)


@dataclasses.dataclass(frozen=True)
class QNState:
    """Ring buffer of pairs + derived products (newest in slot W-1)."""

    S: Tensor  # (W, n) point diffs s
    Y: Tensor  # (W, n) raw gradient diffs y
    P: Tensor  # (W, n) products B_j s_j (BFGS)
    R: Tensor  # (W, n) damped grad diffs r_j (BFGS) / y - Bs (SR1)
    bidir: Tensor  # (W,) s^T B s (BFGS)
    rdot: Tensor  # (W,) s^T r
    sizing: Tensor  # (W,) per-term sizing factor
    scale: Tensor  # 0-d initial scale
    count: Tensor  # int32 number of valid pairs


@dataclasses.dataclass(frozen=True)
class QNPrev:
    """Previous-iterate data for the next pair push."""

    x: Tensor  # (n,)
    grad: Tensor  # (n,)
    jac: Tensor  # (m, n)
    pending: Tensor  # bool: a pair should be pushed next iteration


def qn_prev_init(n: int, m: int, dtype, device=None) -> QNPrev:
    return QNPrev(
        x=torch.zeros((n,), dtype=dtype, device=device),
        grad=torch.zeros((n,), dtype=dtype, device=device),
        jac=torch.zeros((m, n), dtype=dtype, device=device),
        pending=torch.zeros((), dtype=torch.bool, device=device),
    )


def qn_init(n: int, window: int, dtype, blocks: tuple | None = None, device=None):
    """Ring-buffer state; with ``blocks`` a tuple of per-block states."""
    if blocks is not None:
        return tuple(qn_init(e - s, window, dtype, device=device) for s, e in blocks)
    zeros_wn = torch.zeros((window, n), dtype=dtype, device=device)
    ones_w = torch.ones((window,), dtype=dtype, device=device)
    return QNState(
        S=zeros_wn,
        Y=zeros_wn.clone(),
        P=zeros_wn.clone(),
        R=zeros_wn.clone(),
        bidir=ones_w,
        rdot=ones_w.clone(),
        sizing=ones_w.clone(),
        scale=torch.ones((), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def qn_product(qn, d: Tensor, hess_eval, blocks: tuple | None = None) -> Tensor:
    """B d with the quasi-Newton approximation (not ported yet)."""
    raise NotImplementedError(QN_NOT_PORTED)


def qn_push(qn, s: Tensor, y: Tensor, hess_eval, sizing: bool, blocks: tuple | None = None):
    """Shift a pair into the ring buffer (not ported yet)."""
    raise NotImplementedError(QN_NOT_PORTED)
