"""Limited-memory quasi-Newton Hessian approximations.

Port of ``sleqp_tpu/quasi_newton.py`` (reference src/main/quasi_newton/):
damped limited-memory BFGS with optional centered Oren-Luenberger sizing
(bfgs.c) and limited-memory SR1 (sr1.c), both as fixed-size ring buffers
in the solver state: pairs shift through (W, n) tensors, empty slots are
masked by ``count``.

* pairs (s, y) are pushed on accepted steps with the Lagrangian gradient
  difference at the new multipliers (quasi_newton.c:140);
* BFGS: Powell damping with factor 0.2 (bfgs.c:12), the product recursion
  p <- sizing_j (p - Bs_j (Bs_j.d)/(s.Bs_j)) + r_j (r_j.d)/(s.r_j)
  (bfgs.c:300-346), the initial scale s.s/(y.s) clamped to [1e-6, 1] when
  damped (bfgs.c:349-379), centered-OL sizing clamped to [0.1, 1]
  (bfgs.c:381-430);
* SR1: rank-one terms r_j = y_j - B_j s_j with the skip rule
  |r.s| >= 1e-8 ||r|| ||s|| (sr1.c:12-40).

The window W is small (default 5), so the push is W^2 vector operations
unrolled in Python, every one on the state's device and none read back.
The push writes its rows out of place (``_set_row``, a select), so under
``torch.func.vmap`` each lane's rows land in buffers of its own.
"""

from __future__ import annotations

import dataclasses

import torch

from .types import HessEval

Tensor = torch.Tensor

DAMPING_FACTOR = 0.2  # bfgs.c:12
SIZING_CUTOFF = 0.1  # bfgs.c:13
INITIAL_SCALE_MIN = 1e-6  # bfgs.c:15
DAMPED_INITIAL_SCALE_MAX = 1.0  # bfgs.c:16
SR1_SKIP_FACTOR = 1e-8  # sr1.c skip rule


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


def qn_astype(qn, dtype):
    """The ring buffer(s) with their float tensors in ``dtype`` (the mixed
    route's float32 Hessian operator)."""
    if isinstance(qn, tuple):
        return tuple(qn_astype(q, dtype) for q in qn)

    def cast(v: Tensor) -> Tensor:
        return v.to(dtype) if v.is_floating_point() else v

    return QNState(**{f.name: cast(getattr(qn, f.name)) for f in dataclasses.fields(qn)})


def _valid_mask(count: Tensor, W: int) -> Tensor:
    return torch.arange(W, device=count.device) >= (W - count)


def _shift_in(buf: Tensor, v: Tensor) -> Tensor:
    """``jnp.roll(buf, -1, axis=0).at[-1].set(v)``."""
    return torch.cat([buf[1:], v[None]])


def _bfgs_apply(qn: QNState, d: Tensor, upto: int, valid: Tensor) -> Tensor:
    """Product with the approximation built from terms [0, upto).  Invalid
    slots are sanitized on push (P = R = 0, bidir = rdot = sizing = 1), so
    applying them changes nothing."""
    p = qn.scale * d
    for j in range(upto):
        term = (qn.sizing[j] * (p - qn.P[j] * (torch.dot(qn.P[j], d) / qn.bidir[j]))
                + qn.R[j] * (torch.dot(qn.R[j], d) / qn.rdot[j]))
        p = torch.where(valid[j], term, p)
    return p


def bfgs_product(qn: QNState, d: Tensor) -> Tensor:
    """B d using every stored term (bfgs.c:283-346)."""
    W = qn.S.shape[0]
    full = _bfgs_apply(qn, d, W, _valid_mask(qn.count, W))
    return torch.where(qn.count == 0, d, full)


def _initial_scale(s: Tensor, y: Tensor) -> Tensor:
    ys = torch.dot(y, s)
    ss = torch.dot(s, s)
    return torch.where(ys != 0.0, ss / torch.where(ys != 0.0, ys, 1.0), 1.0)


def bfgs_push(qn: QNState, s: Tensor, y: Tensor, damped: bool, sizing: bool) -> QNState:
    """Shift in a pair and recompute all derived products (bfgs.c:432-540)."""
    W = qn.S.shape[0]
    S = _shift_in(qn.S, s)
    Y = _shift_in(qn.Y, y)
    count = torch.clamp(qn.count + 1, max=W)
    valid = _valid_mask(count, W)

    # initial scale from the newest pair (bfgs.c:349-379)
    scale = torch.clamp(_initial_scale(s, y), min=INITIAL_SCALE_MIN)
    if damped:
        scale = torch.clamp(scale, max=DAMPED_INITIAL_SCALE_MAX)

    P = torch.zeros_like(S)
    R = torch.zeros_like(S)
    bidir = torch.ones((W,), dtype=s.dtype, device=s.device)
    rdot = bidir.clone()
    sizes = bidir.clone()
    one = torch.ones((), dtype=s.dtype, device=s.device)

    ys_all = (S * Y).sum(dim=1)  # y^T s per slot
    ss_all = (S * S).sum(dim=1)

    for j in range(W):
        s_j, y_j = S[j], Y[j]
        work = QNState(S=S, Y=Y, P=P, R=R, bidir=bidir, rdot=rdot, sizing=sizes,
                       scale=scale, count=count)
        Bs = _bfgs_apply(work, s_j, j, valid)
        bid = torch.dot(s_j, Bs)
        bid = torch.where(bid > 0.0, bid, 1.0)
        dot = ys_all[j]

        if damped:
            needs_damp = dot < DAMPING_FACTOR * bid
            theta = (1.0 - DAMPING_FACTOR) * bid / torch.where(needs_damp, bid - dot, 1.0)
            r_j = torch.where(needs_damp, theta * y_j + (1.0 - theta) * Bs, y_j)
            dot = torch.where(needs_damp, torch.dot(r_j, s_j), dot)
        else:
            r_j = y_j
        dot = torch.where(dot > 0.0, dot, 1.0)

        # centered Oren-Luenberger sizing (bfgs.c:381-430)
        size_j = one
        if sizing and j > 0:
            i = j - 1
            prev_valid = valid[j] & valid[i]
            ss_i = torch.where(ss_all[i] != 0.0, ss_all[i], 1.0)
            ss_j = torch.where(ss_all[j] != 0.0, ss_all[j], 1.0)
            num = 0.5 * ys_all[i] / ss_i + 0.5 * ys_all[j] / ss_j
            den = 0.5 * rdot[i] / ss_i + 0.5 * bid
            factor = torch.clamp(num / torch.where(den != 0.0, den, 1.0), SIZING_CUTOFF, 1.0)
            size_j = torch.where(prev_valid, factor, 1.0)

        P = _set_row(P, j, torch.where(valid[j], Bs, 0.0))
        R = _set_row(R, j, torch.where(valid[j], r_j, 0.0))
        bidir = _set_row(bidir, j, torch.where(valid[j], bid, 1.0))
        rdot = _set_row(rdot, j, torch.where(valid[j], dot, 1.0))
        sizes = _set_row(sizes, j, size_j)

    return QNState(S=S, Y=Y, P=P, R=R, bidir=bidir, rdot=rdot, sizing=sizes,
                   scale=scale, count=count)


def _set_row(buf: Tensor, j: int, value: Tensor) -> Tensor:
    """``buf.at[j].set(value)`` out of place: a select, so a batched
    ``value`` gives a batched buffer (an index write of a batched value
    into a buffer made inside the push is refused under ``vmap``)."""
    row = torch.arange(buf.shape[0], device=buf.device) == j
    return torch.where(row.reshape((-1,) + (1,) * (buf.ndim - 1)), value, buf)


def sr1_product(qn: QNState, d: Tensor) -> Tensor:
    """B d = scale d + sum r_j (r_j.d)/(r_j.s_j) (sr1.c).  Skipped and
    invalid slots store R = 0, rdot = 1 and add nothing."""
    p = sr1_product_upto(qn, d, qn.S.shape[0])
    return torch.where(qn.count == 0, d, p)


def sr1_product_upto(qn: QNState, d: Tensor, upto: int) -> Tensor:
    p = qn.scale * d
    for j in range(upto):
        p = p + qn.R[j] * (torch.dot(qn.R[j], d) / qn.rdot[j])
    return p


def sr1_push(qn: QNState, s: Tensor, y: Tensor) -> QNState:
    """Rank-one recompute with the SR1 skip rule (sr1.c:12-40)."""
    W = qn.S.shape[0]
    S = _shift_in(qn.S, s)
    Y = _shift_in(qn.Y, y)
    count = torch.clamp(qn.count + 1, max=W)
    valid = _valid_mask(count, W)
    scale = torch.clamp(_initial_scale(s, y).abs(), min=INITIAL_SCALE_MIN)

    R = torch.zeros_like(S)
    rdot = torch.ones((W,), dtype=s.dtype, device=s.device)
    for j in range(W):
        s_j, y_j = S[j], Y[j]
        work = dataclasses.replace(qn, S=S, Y=Y, R=R, rdot=rdot, scale=scale, count=count)
        r_j = y_j - sr1_product_upto(work, s_j, j)
        rs = torch.dot(r_j, s_j)
        keep = rs.abs() >= SR1_SKIP_FACTOR * torch.linalg.norm(r_j) * torch.linalg.norm(s_j)
        use = valid[j] & keep
        R = _set_row(R, j, torch.where(use, r_j, 0.0))
        rdot = _set_row(rdot, j, torch.where(use, rs, 1.0))
    return dataclasses.replace(qn, S=S, Y=Y, R=R, rdot=rdot, scale=scale, count=count)


def qn_product(qn, d: Tensor, hess_eval: HessEval, blocks: tuple | None = None) -> Tensor:
    """B d; with ``blocks`` (a ``Func.hess_struct``) ``qn`` is a tuple of
    per-block states and the product assembles block-wise: variables
    outside every block get zero curvature rows (bfgs.c block handling)."""
    if blocks is not None:
        # assembled out of place, zero rows between the blocks: under vmap
        # the pieces may carry the lane dimension where d does not
        pieces, at = [], 0
        for (start, end), q in zip(blocks, qn):
            pieces += [torch.zeros_like(d[at:start]), _qn_product_one(q, d[start:end], hess_eval)]
            at = end
        pieces.append(torch.zeros_like(d[at:]))
        return torch.cat(pieces)
    return _qn_product_one(qn, d, hess_eval)


def _qn_product_one(qn: QNState, d: Tensor, hess_eval: HessEval) -> Tensor:
    if hess_eval in (HessEval.SIMPLE_BFGS, HessEval.DAMPED_BFGS):
        return bfgs_product(qn, d)
    if hess_eval == HessEval.SR1:
        return sr1_product(qn, d)
    raise ValueError(f"qn_product called with {hess_eval}")


def qn_push(qn, s: Tensor, y: Tensor, hess_eval: HessEval, sizing: bool,
            blocks: tuple | None = None):
    """Shift the pair (s, y) into the ring buffer(s)."""
    if blocks is not None:
        return tuple(_qn_push_one(q, s[start:end], y[start:end], hess_eval, sizing)
                     for (start, end), q in zip(blocks, qn))
    return _qn_push_one(qn, s, y, hess_eval, sizing)


def _qn_push_one(qn: QNState, s: Tensor, y: Tensor, hess_eval: HessEval,
                 sizing: bool) -> QNState:
    if hess_eval == HessEval.SIMPLE_BFGS:
        return bfgs_push(qn, s, y, damped=False, sizing=sizing)
    if hess_eval == HessEval.DAMPED_BFGS:
        return bfgs_push(qn, s, y, damped=True, sizing=sizing)
    if hess_eval == HessEval.SR1:
        return sr1_push(qn, s, y)
    raise ValueError(f"qn_push called with {hess_eval}")
