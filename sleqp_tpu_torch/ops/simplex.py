"""Bounded-variable revised simplex with an explicit basis inverse.

Port of ``sleqp_tpu/ops/simplex.py``, the LP solver of the Cauchy step:

    min  c^T x   s.t.  A x = 0,   lb <= x <= ub

where the caller has appended the logical columns (-I) of ranged rows, so
every row is an equality and a row's basis status is that of its logical
column.  Bounds use +-1e20 as infinity (``types.INF``).

The algorithm is the reference's: the basis inverse kept explicitly with
rank-1 (eta) updates and refactorized every ``refactor_every`` pivots by
Householder QR, Devex pricing with a switch to Bland's rule after a stall,
bound flips for boxed columns, and a bounded dual simplex for warm starts
whose basis turned primal infeasible.  Each ``lax.while_loop`` of the
reference is a ``lanes.lockstep`` loop here that runs the same body and
reads one flag (is any lane still pivoting?) back from the device per
pivot, for one LP or for a batch of them under ``torch.func.vmap``; a lane
that has stopped is frozen by a select.  The pivot count is a tensor per
lane.  Indexing by a device scalar goes through ``index_select`` and
``index_put`` so that no other value is read back.  ``argmax``/``argmin``
pick the first index of a tie, and NaN as the extreme value, in both
packages.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..lanes import is_batched, lanes_any, lockstep, tree_where
from ..types import INF_THRESHOLD, BaseStat

Tensor = torch.Tensor

# Status codes of solve()
OPTIMAL = 0
ITERATION_LIMIT = 1
UNBOUNDED = 2
DUAL_STALL = 3  # dual ratio test found no entering column


class SimplexResult(NamedTuple):
    x: Tensor  # (N,) primal solution
    duals: Tensor  # (m,) row duals y (c_B^T B^-1)
    reduced_costs: Tensor  # (N,) c - A^T y
    status: Tensor  # (N,) int8 per-column BaseStat
    basis: Tensor  # (m,) int32 basic column per row
    obj: Tensor  # 0-d objective value
    state: Tensor  # int32: OPTIMAL / ITERATION_LIMIT / UNBOUNDED
    iterations: Tensor  # int32 pivot count
    condition: Tensor  # 1-norm condition estimate of the final basis


class DualStageResult(NamedTuple):
    basis: Tensor  # (m,) int32
    status: Tensor  # (N,) int8
    state: Tensor  # int32: OPTIMAL / ITERATION_LIMIT / DUAL_STALL
    iterations: Tensor  # int32 pivot count


def default_tols(dtype) -> dict:
    """Pivoting tolerances by working precision: the float32 values back
    off to ~100x machine eps, since the mixed route refines every numeric
    quantity in float64 afterwards."""
    if dtype == torch.float32:
        return dict(opt_tol=1e-5, piv_tol=1e-6, feas_tol=1e-5, degen_tol=1e-7)
    return dict(opt_tol=1e-9, piv_tol=1e-11, feas_tol=1e-9, degen_tol=1e-12)


# ---- device-scalar indexing (no host read) ---------------------------------


def take(x: Tensor, i: Tensor) -> Tensor:
    """x[i] along the first axis for a 0-d integer tensor i."""
    return x.index_select(0, i.reshape(1).long()).squeeze(0)


def put(x: Tensor, i: Tensor, v: Tensor) -> Tensor:
    """A copy of x with x[i] = v along the first axis (i a 0-d integer
    tensor, v a tensor of one entry or one row); out of place, so that it
    runs under ``vmap`` whichever of x, i and v carries the lanes."""
    v = v.to(x.dtype).reshape((1,) + tuple(x.shape[1:]))
    return x.index_put((i.reshape(1).long(),), v)


def col(A: Tensor, j: Tensor) -> Tensor:
    """A[:, j] for a 0-d integer tensor j."""
    return A.index_select(1, j.reshape(1).long()).squeeze(1)


def sign(x: Tensor) -> Tensor:
    """``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _finite(v: Tensor) -> Tensor:
    return v.abs() < INF_THRESHOLD


def _stats(device) -> Tensor:
    """The int8 statuses LOWER, UPPER, BASIC (0, 1, 2) on ``device``, made
    on the device once per solve: a copy of a host scalar to the card is a
    synchronization."""
    assert (BaseStat.LOWER, BaseStat.UPPER, BaseStat.BASIC) == (0, 1, 2)
    return torch.arange(3, dtype=torch.int8, device=device)


def _nonbasic_value(status: Tensor, lb: Tensor, ub: Tensor) -> Tensor:
    """Value each nonbasic column rests at (basic columns -> 0)."""
    at_lower = torch.where(_finite(lb), lb, 0.0)
    at_upper = torch.where(_finite(ub), ub, 0.0)
    val = torch.where(status == BaseStat.LOWER, at_lower, 0.0)
    return torch.where(status == BaseStat.UPPER, at_upper, val)


def qr_solve(B: Tensor, rhs: Tensor) -> Tensor:
    """Dense solve via Householder QR, as the reference solves; a singular
    B yields inf/nan, which callers check for."""
    q, r = torch.linalg.qr(B)
    vec = rhs.ndim == 1
    b = q.T @ (rhs[:, None] if vec else rhs)
    out = torch.linalg.solve_triangular(r, b, upper=True)
    return out[:, 0] if vec else out


def _recompute(A: Tensor, basis: Tensor, status: Tensor, lb: Tensor, ub: Tensor):
    """Refactorize: B_inv and the basic values from scratch."""
    B = A.index_select(1, basis.long())
    m = A.shape[0]
    B_inv = qr_solve(B, torch.eye(m, dtype=A.dtype, device=A.device))
    xN = _nonbasic_value(status, lb, ub)
    xB = -B_inv @ (A @ xN)
    return B_inv, xB


def _condition(A: Tensor, basis: Tensor, B_inv: Tensor) -> Tensor:
    """1-norm condition estimate of the basis (lpi basis-condition op)."""
    B = A.index_select(1, basis.long())
    return B.abs().sum(dim=0).amax() * B_inv.abs().sum(dim=0).amax()


def _refactor_due(trip: int, refactor_every: int) -> bool:
    """Whether the pivot of lockstep trip ``trip`` refactorizes.  A test on
    the host: a body that does not pivot (or flip) ends its lane, so every
    active lane has made exactly ``trip`` counted bodies before this one,
    and its count after a pivot, the reference's ``it + 1``, is
    ``trip + 1``."""
    return (trip + 1) % refactor_every == 0


def dual_start(A: Tensor, lb: Tensor, ub: Tensor, basis: Tensor, status: Tensor) -> dict:
    """The dual pass's loop state before its first pivot: the basis
    inverse and basic values of ``basis``."""
    dev = A.device
    basis = torch.as_tensor(basis, dtype=torch.int32, device=dev)
    status = torch.as_tensor(status, dtype=torch.int8, device=dev)
    B_inv, xB = _recompute(A, basis, status, lb, ub)
    return dict(B_inv=B_inv, xB=xB, basis=basis, status=status,
                stall=_i32(0, dev), state=_i32(-1, dev), it=_i32(0, dev))


def dual_body(A: Tensor, c: Tensor, lb: Tensor, ub: Tensor, feas_tol: float | None = None,
              piv_tol: float | None = None, refactor_every: int = 64, bland_after: int = 100):
    """One dual pivot, ``body(s, trip)`` of the dual pass's loop."""
    m, N = A.shape
    dtype, dev = A.dtype, A.device
    tols = default_tols(dtype)
    feas_tol = tols["feas_tol"] if feas_tol is None else feas_tol
    piv_tol = tols["piv_tol"] if piv_tol is None else piv_tol
    ptol = feas_tol * (1.0 + torch.where(_finite(lb), lb, 0.0).abs().amax()
                       + torch.where(_finite(ub), ub, 0.0).abs().amax())
    col_idx = torch.arange(N, dtype=torch.int32, device=dev)
    neg_inf = torch.full((), -torch.inf, dtype=dtype, device=dev)
    inf = torch.full((), torch.inf, dtype=dtype, device=dev)
    LOWER, UPPER, BASIC = _stats(dev)

    def body(s, trip):
        B_inv, xB, basis, status = s["B_inv"], s["xB"], s["basis"], s["status"]
        lbB, ubB = lb.index_select(0, basis.long()), ub.index_select(0, basis.long())

        # ---- leaving-row pricing: largest bound violation --------------
        viol_low = torch.where(_finite(lbB), lbB - xB, neg_inf)
        viol_up = torch.where(_finite(ubB), xB - ubB, neg_inf)
        viol = torch.maximum(viol_low, viol_up)
        use_bland = s["stall"] > bland_after
        r_most = torch.argmax(viol)
        r_bland = torch.argmin(torch.where(viol > ptol, basis, N + 1))
        row_r = torch.where(use_bland, r_bland, r_most)
        primal_feasible = take(viol, r_most) <= ptol

        below = take(viol_low, row_r) >= take(viol_up, row_r)  # leaves at LOWER
        target = torch.where(below, take(lbB, row_r), take(ubB, row_r))

        # ---- dual ratio test over the tableau row -----------------------
        y = c.index_select(0, basis.long()) @ B_inv
        red = c - y @ A
        B_row = take(B_inv, row_r)
        alpha = B_row @ A
        q_dir = torch.where(below, 1.0, -torch.ones((), dtype=dtype, device=dev))

        is_basic = status == BaseStat.BASIC
        at_lower = status == BaseStat.LOWER
        at_upper = status == BaseStat.UPPER
        free = status == BaseStat.ZERO
        can_help = (
            (at_lower & (alpha * q_dir < -piv_tol))
            | (at_upper & (alpha * q_dir > piv_tol))
            | (free & (alpha.abs() > piv_tol))
        ) & ~is_basic

        ratio = torch.where(can_help, red.abs() / alpha.abs(), inf)
        any_help = can_help.any()
        best = ratio.amin()
        near = can_help & (ratio <= best * (1.0 + 1e-9) + 1e-30)
        stab = torch.where(near, alpha.abs(), -1.0)
        e_stab = torch.argmax(stab)
        e_bland = torch.where(near, col_idx, N).amin()
        e = torch.where(use_bland, torch.clamp(e_bland, max=N - 1).long(), e_stab)

        # ---- pivot -------------------------------------------------------
        w = B_inv @ col(A, e)
        w_r = take(w, row_r)
        safe_wr = torch.where(w_r.abs() > piv_tol, w_r, 1.0)
        t_e = (take(xB, row_r) - target) / safe_wr
        e_rest = take(_nonbasic_value(status, lb, ub), e)

        xB_new = put(xB - t_e * w, row_r, e_rest + t_e)
        leaving = take(basis, row_r)
        leave_stat = torch.where(below, LOWER, UPPER)
        status_new = put(put(status, leaving, leave_stat), e, BASIC)
        basis_new = put(basis, row_r, e)

        pivot_row = B_row / safe_wr
        B_inv_new = put(B_inv - torch.outer(w, pivot_row), row_r, pivot_row)

        done = primal_feasible
        stalled = (~done) & (~any_help)
        step = (~done) & any_help

        basis_next = torch.where(step, basis_new, basis)
        status_next = torch.where(step, status_new, status)
        B_inv_next = torch.where(step, B_inv_new, B_inv)
        xB_next = torch.where(step, xB_new, xB)
        if _refactor_due(trip, refactor_every):
            B_ref, xB_ref = _recompute(A, basis_next, status_next, lb, ub)
            B_inv_next = torch.where(step, B_ref, B_inv_next)
            xB_next = torch.where(step, xB_ref, xB_next)

        degenerate = take(red, e).abs() <= piv_tol
        stall = s["stall"]
        return dict(
            B_inv=B_inv_next, xB=xB_next, basis=basis_next, status=status_next,
            stall=torch.where(step & degenerate, stall + 1, torch.where(step, 0, stall)),
            state=torch.where(done, OPTIMAL,
                              torch.where(stalled, DUAL_STALL, s["state"])).to(torch.int32),
            it=s["it"] + step.to(torch.int32))

    return body


def dual_result(s: dict) -> DualStageResult:
    """The dual pass's result from its final loop state."""
    return DualStageResult(
        basis=s["basis"],
        status=s["status"],
        state=torch.where(s["state"] < 0, ITERATION_LIMIT, s["state"]).to(torch.int32),
        iterations=s["it"],
    )


def solve_dual(
    A: Tensor,
    c: Tensor,
    lb: Tensor,
    ub: Tensor,
    basis: Tensor,
    status: Tensor,
    max_iterations: int,
    feas_tol: float | None = None,
    piv_tol: float | None = None,
    refactor_every: int = 64,
    bland_after: int = 100,
    first: Any = True,
) -> DualStageResult:
    """Bounded-variable dual simplex from a dual-feasible basis.

    Runs until primal feasible (state OPTIMAL: dual feasibility is kept, so
    the basis is then optimal), the iteration cap, or a failed dual ratio
    test (DUAL_STALL; the caller falls back to a crash basis).  ``first``
    gives the lanes that run: the others keep the starting basis, no pivot
    and ITERATION_LIMIT."""
    s = dual_start(A, lb, ub, basis, status)
    body = dual_body(A, c, lb, ub, feas_tol, piv_tol, refactor_every, bland_after)
    return dual_result(_run(body, s, max_iterations, first))


def _i32(v: int, dev) -> Tensor:
    return torch.full((), v, dtype=torch.int32, device=dev)


def running(s: dict, cap) -> Tensor:
    """Whether a pivoting loop in state ``s`` goes on: no end state yet,
    fewer than ``cap`` pivots.  A trip that does not pivot (or flip) ends
    the loop, so a loop makes at most ``cap`` trips."""
    return (s["state"] < 0) & (s["it"] < cap)


def _run(body, state: dict, max_iterations: int, first: Any) -> dict:
    """The pivoting loop: ``body`` while a lane runs (state < 0) under its
    pivot cap, which bounds its trips too.  The cap is part of the flag
    read after each trip, so one LP reads once per body, as a loop that
    reads its state after each pivot does.  A lane outside ``first``
    starts at ITERATION_LIMIT, so no trip runs it."""
    if max_iterations <= 0:
        return state
    if isinstance(first, Tensor):
        state = dict(state, state=torch.where(first, state["state"], ITERATION_LIMIT))
    return lockstep(lambda s: running(s, max_iterations), body, state,
                    max_trips=max_iterations, first=first)


def pivot_block(body, s: dict, cap: int, length: int, refactor: bool,
                refactor_every: int = 64) -> dict:
    """``length`` trips of a pivoting loop from ``s`` (a read-free block of
    the loop under ``lanes.device_resident()``, masked where it stops):
    the trips of a block that does not start the loop.  ``refactor`` says
    whether its last trip is one whose pivot refactorizes (the loop's trip
    ``refactor_every - 1`` modulo ``refactor_every``); no other trip of the
    block refactorizes, so ``length < refactor_every``."""
    assert 0 < length < refactor_every
    offset = refactor_every - length if refactor else 0
    return lockstep(lambda s: running(s, cap), lambda s, trip: body(s, trip + offset), s,
                    max_trips=length)


def primal_start(A: Tensor, lb: Tensor, ub: Tensor, basis: Tensor, status: Tensor) -> dict:
    """The primal pass's loop state before its first pivot: the basis
    inverse and basic values of ``basis``, unit Devex weights."""
    dtype, dev = A.dtype, A.device
    basis = torch.as_tensor(basis, dtype=torch.int32, device=dev)
    status = torch.as_tensor(status, dtype=torch.int8, device=dev)
    B_inv, xB = _recompute(A, basis, status, lb, ub)
    return dict(B_inv=B_inv, xB=xB, basis=basis, status=status,
                gamma=torch.ones((A.shape[1],), dtype=dtype, device=dev),  # Devex weights
                stall=_i32(0, dev), state=_i32(-1, dev), it=_i32(0, dev))


def primal_body(A: Tensor, c: Tensor, lb: Tensor, ub: Tensor, opt_tol: float | None = None,
                piv_tol: float | None = None, refactor_every: int = 64, bland_after: int = 100):
    """One primal pivot (or bound flip), ``body(s, trip)`` of the primal
    pass's loop."""
    m, N = A.shape
    dtype, dev = A.dtype, A.device
    tols = default_tols(dtype)
    opt_tol = tols["opt_tol"] if opt_tol is None else opt_tol
    piv_tol = tols["piv_tol"] if piv_tol is None else piv_tol
    degen_tol = tols["degen_tol"]
    # relative optimality tolerance: penalty objectives can be huge
    tol = opt_tol * (1.0 + c.abs().amax())

    col_idx = torch.arange(N, dtype=torch.int32, device=dev)
    inf = torch.full((), torch.inf, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    LOWER, UPPER, BASIC = _stats(dev)

    def body(s, trip):
        B_inv, xB, basis, status, gamma = s["B_inv"], s["xB"], s["basis"], s["status"], s["gamma"]
        # ---- pricing -------------------------------------------------
        y = c.index_select(0, basis.long()) @ B_inv
        r = c - y @ A

        is_basic = status == BaseStat.BASIC
        free = status == BaseStat.ZERO
        direction = torch.where(status == BaseStat.UPPER, -one, one)
        direction = torch.where(free, -sign(r), direction)
        viol = torch.where(is_basic, 0.0, direction * r)

        use_bland = s["stall"] > bland_after
        improving = viol < -tol
        # Devex: largest viol^2 / gamma; Bland: smallest improving index
        score = torch.where(improving, viol * viol / gamma, -1.0)
        q_devex = torch.argmax(score)
        q_bland = torch.where(improving, col_idx, N).amin()
        q = torch.where(use_bland, torch.clamp(q_bland, max=N - 1).long(), q_devex)
        optimal = ~improving.any()

        dir_q = take(direction, q)
        # ---- ratio test ----------------------------------------------
        w = B_inv @ col(A, q)
        delta = -dir_q * w
        lbB, ubB = lb.index_select(0, basis.long()), ub.index_select(0, basis.long())

        dec = delta < -piv_tol
        inc = delta > piv_tol
        t_dec = torch.where(dec & _finite(lbB), (xB - lbB) / torch.where(dec, -delta, 1.0), inf)
        t_inc = torch.where(inc & _finite(ubB), (ubB - xB) / torch.where(inc, delta, 1.0), inf)
        t_rows = torch.clamp(torch.where(dec, t_dec, t_inc), min=0.0)
        t_rows = torch.where(dec | inc, t_rows, inf)
        t_basic = t_rows.amin()

        # distance the entering column travels before its opposite bound,
        # from its rest value (ZERO columns rest at 0 between finite bounds)
        status_q, lb_q, ub_q = take(status, q), take(lb, q), take(ub, q)
        q_rest_val = torch.where(
            status_q == BaseStat.UPPER,
            torch.where(_finite(ub_q), ub_q, 0.0),
            torch.where((status_q == BaseStat.LOWER) & _finite(lb_q), lb_q, 0.0),
        )
        t_flip_raw = torch.where(dir_q > 0.0, ub_q - q_rest_val, q_rest_val - lb_q)
        flip_bound_finite = torch.where(dir_q > 0.0, _finite(ub_q), _finite(lb_q))
        t_flip = torch.where(flip_bound_finite, torch.clamp(t_flip_raw, min=0.0), inf)

        t = torch.minimum(t_basic, t_flip)
        unbounded = ~(t < inf)

        # leaving row: among near-minimal ratios the largest |w| (Bland:
        # the smallest basic column index)
        near = t_rows <= t_basic * (1.0 + 1e-9) + 1e-30
        r_stab = torch.argmax(torch.where(near, w.abs(), -1.0))
        r_bland = torch.argmin(torch.where(near, basis, N + 1))
        row_r = torch.where(use_bland, r_bland, r_stab)

        do_flip = t_flip <= t_basic

        # ---- apply the step ------------------------------------------
        t_safe = torch.where(unbounded, 0.0, t)
        xB_moved = xB - t_safe * dir_q * w

        # (a) bound flip: q moves to the bound in its travel direction
        flip_to = torch.where(dir_q > 0.0, UPPER, LOWER)
        status_flip = put(status, q, flip_to)

        # (b) pivot: q enters, basis[row_r] leaves
        leaving = take(basis, row_r)
        leave_stat = torch.where(take(delta, row_r) < 0.0, LOWER, UPPER)
        status_piv = put(put(status, leaving, leave_stat), q, BASIC)
        basis_piv = put(basis, row_r, q)
        xB_piv = put(xB_moved, row_r, q_rest_val + dir_q * t_safe)

        # eta update of B_inv
        w_r = take(w, row_r)
        safe_wr = torch.where(w_r.abs() > piv_tol, w_r, 1.0)
        B_row = take(B_inv, row_r)
        pivot_row = B_row / safe_wr
        B_inv_piv = put(B_inv - torch.outer(w, pivot_row), row_r, pivot_row)

        flip = do_flip & ~unbounded & ~optimal
        piv = ~do_flip & ~unbounded & ~optimal

        # Devex weight update (Forrest-Goldfarb)
        alphas = B_row @ A
        alpha_q = safe_wr
        gamma_q = take(gamma, q)
        gamma_piv = torch.maximum(gamma, (alphas / alpha_q) ** 2 * gamma_q)
        gamma_piv = put(gamma_piv, leaving, torch.clamp(gamma_q / (alpha_q * alpha_q), min=1.0))
        gamma_piv = put(gamma_piv, q, one)

        status_next = torch.where(flip, status_flip, torch.where(piv, status_piv, status))
        basis_next = torch.where(piv, basis_piv, basis)
        B_inv_next = torch.where(piv, B_inv_piv, B_inv)
        xB_next = torch.where(flip, xB_moved, torch.where(piv, xB_piv, xB))

        # ---- periodic refactorization --------------------------------
        if _refactor_due(trip, refactor_every):
            B_ref, xB_ref = _recompute(A, basis_next, status_next, lb, ub)
            B_inv_next = torch.where(piv, B_ref, B_inv_next)
            xB_next = torch.where(piv, xB_ref, xB_next)

        ends = optimal | unbounded  # a body that ends the loop does not count
        degenerate = t_safe <= degen_tol
        stall = s["stall"]
        return dict(
            B_inv=B_inv_next, xB=xB_next, basis=basis_next, status=status_next,
            gamma=torch.where(piv, gamma_piv, gamma),
            stall=torch.where(ends, stall, torch.where(degenerate, stall + 1, 0)).to(torch.int32),
            state=torch.where(optimal, OPTIMAL,
                              torch.where(unbounded, UNBOUNDED, s["state"])).to(torch.int32),
            it=s["it"] + (~ends).to(torch.int32))

    return body


def primal_result(A: Tensor, c: Tensor, lb: Tensor, ub: Tensor, s: dict) -> SimplexResult:
    """The primal pass's result from its final loop state."""
    basis, status, B_inv = s["basis"], s["status"], s["B_inv"]
    x = _nonbasic_value(status, lb, ub).index_put((basis.long(),), s["xB"])
    y = c.index_select(0, basis.long()) @ B_inv
    r = c - y @ A
    return SimplexResult(
        x=x,
        duals=y,
        reduced_costs=r,
        status=status,
        basis=basis,
        obj=torch.dot(c, x),
        state=torch.where(s["state"] < 0, ITERATION_LIMIT, s["state"]).to(torch.int32),
        iterations=s["it"],
        condition=_condition(A, basis, B_inv),
    )


def solve(
    A: Tensor,
    c: Tensor,
    lb: Tensor,
    ub: Tensor,
    basis: Tensor,
    status: Tensor,
    max_iterations: int,
    opt_tol: float | None = None,
    piv_tol: float | None = None,
    refactor_every: int = 64,
    bland_after: int = 100,
    first: Any = True,
) -> SimplexResult:
    """Run the primal simplex from a primal-feasible starting basis.

    ``basis[i]`` is the column basic in row i; ``status`` must satisfy
    ``status[basis] == BASIC`` and mark every other column LOWER/UPPER/ZERO.
    ``first`` gives the lanes that run: the others keep the starting
    basis, no pivot and ITERATION_LIMIT.
    """
    s = primal_start(A, lb, ub, basis, status)
    body = primal_body(A, c, lb, ub, opt_tol, piv_tol, refactor_every, bland_after)
    return primal_result(A, c, lb, ub, _run(body, s, max_iterations, first))


def refine_result(A: Tensor, c: Tensor, lb: Tensor, ub: Tensor,
                  res: SimplexResult) -> SimplexResult:
    """Recompute every numeric quantity of ``res`` in the dtype of ``A``
    from one QR factorization of the final basis.  A basis that is
    singular at full precision gives zeroed results and ITERATION_LIMIT,
    so the caller neither extracts a poisoned working set nor saves it."""
    basis, status = res.basis, res.status
    B_inv, xB = _recompute(A, basis, status, lb, ub)
    x = _nonbasic_value(status, lb, ub).index_put((basis.long(),), xB)
    y = c.index_select(0, basis.long()) @ B_inv
    r = c - y @ A
    condition = _condition(A, basis, B_inv)
    finite = torch.isfinite(x).all() & torch.isfinite(y).all() & torch.isfinite(r).all()
    return SimplexResult(
        x=torch.where(finite, x, 0.0),
        duals=torch.where(finite, y, 0.0),
        reduced_costs=torch.where(finite, r, 0.0),
        status=status,
        basis=basis,
        obj=torch.where(finite, torch.dot(c, x), 0.0),
        state=torch.where(finite, res.state, ITERATION_LIMIT).to(torch.int32),
        iterations=res.iterations,
        condition=torch.where(finite, condition, torch.inf),
    )


def polish_fallback(A: Tensor, c: Tensor, lb: Tensor, ub: Tensor,
                    res: SimplexResult) -> SimplexResult:
    """``polish_full_precision``'s result where its dual stage cannot
    restore feasibility: ``res`` refined, no pivot of its own."""
    out = refine_result(A, c, lb, ub, res)
    return out._replace(iterations=torch.zeros_like(out.iterations))


def polish_full_precision(A: Tensor, c: Tensor, lb: Tensor, ub: Tensor,
                          res: SimplexResult, max_iterations: int,
                          first: Any = True) -> SimplexResult:
    """Finish a low-precision solve in the dtype of ``A``: a dual-simplex
    stage restores exact primal feasibility of the float32 basis, then a
    primal pass repairs decisions that fell inside the float32 tolerances.
    Falls back to :func:`refine_result` when the dual stage cannot restore
    feasibility.  One read decides whether any lane (of those ``first``
    gives) runs the primal pass; the others take the fallback, lane by
    lane, as the reference's ``lax.cond`` does under ``vmap``."""
    dres = solve_dual(A, c, lb, ub, res.basis, res.status, max_iterations=max_iterations,
                      first=first)
    ok = dres.state == OPTIMAL

    if lanes_any(ok):
        out = solve(A, c, lb, ub, dres.basis, dres.status, max_iterations=max_iterations,
                    first=ok)
        if is_batched(ok):
            out = tree_where(ok, out, polish_fallback(A, c, lb, ub, res))
    else:
        out = polish_fallback(A, c, lb, ub, res)
    return out._replace(iterations=res.iterations + dres.iterations + out.iterations)


def write_lp(A, lb, ub, c, path, name="cauchy_lp") -> None:
    """Dump the LP ``min c^T x  s.t.  A x = 0, lb <= x <= ub`` in CPLEX LP
    text format, numbers as ``%.17g`` (the reference's lpi ``write`` op,
    lpi_types.h:100-118, a backend-native dump for offline debugging).  A
    host utility: tensors are copied to the host first."""
    A, lb, ub, c = (v.detach().cpu().numpy() if isinstance(v, Tensor) else np.asarray(v)
                    for v in (A, lb, ub, c))
    m, N = A.shape

    def var(j):
        return f"x{j}"

    lines = [f"\\ {name}: {N} columns, {m} rows", "Minimize", " obj:"]
    terms = [f" {'+' if cj >= 0 else '-'} {abs(cj):.17g} {var(j)}"
             for j, cj in enumerate(c) if cj != 0.0]
    lines[-1] += "".join(terms) if terms else " 0 x0"
    lines.append("Subject To")
    for i in range(m):
        row = "".join(f" {'+' if a >= 0 else '-'} {abs(a):.17g} {var(j)}"
                      for j, a in enumerate(A[i]) if a != 0.0)
        lines.append(f" r{i}:{row if row else ' 0 x0'} = 0")
    lines.append("Bounds")
    for j in range(N):
        lo = "-inf" if lb[j] < -INF_THRESHOLD else f"{lb[j]:.17g}"
        hi = "+inf" if ub[j] > INF_THRESHOLD else f"{ub[j]:.17g}"
        lines.append(f" {lo} <= {var(j)} <= {hi}")
    lines.append("End")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
