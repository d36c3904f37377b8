"""Cauchy (LP subproblem) layer.

Port of ``sleqp_tpu/cauchy.py`` (reference src/main/cauchy/
standard_cauchy.c): builds and solves the LP

    min  g^T d + penalty * sum(s+ + s-)
    s.t. cons_lb - c <=  J d + s+ - s-  <= cons_ub - c        (rows)
         max(var_lb - x, -radius) <= d <= min(var_ub - x, radius)
         s+, s- >= 0

then extracts the LP step, the working set from the basis statuses, the LP
duals (signs flipped to the NLP convention), the slack violation and local
infeasibility.  Column layout (N = n + 3m):

    [0, n)        d      step components
    [n, n+m)      s+     lower-violation slacks        (coeff +I)
    [n+m, n+2m)   s-     upper-violation slacks        (coeff -I)
    [n+2m, n+3m)  w      logical row columns           (coeff -I)

Warm starts keep (basis, status) across SQP iterations; a saved basis that
is primal infeasible under the new data is re-optimized by dual pivots or
repaired by re-slacking the row block.  Each ``lax.cond`` of the reference
is a Python branch on one scalar read from the device.

The first-order backend (``LPSolver.PDLP``, ``ops/pdlp.py``) has no simplex
basis: its statuses are synthesized from the PDHG solution, the saved
basis passes through untouched, and no reduced resolve runs.
"""

from __future__ import annotations

import dataclasses

import torch

from .iterate import Iterate
from .ops import lp_enum, pdlp, simplex
from .problem import ProblemData
from .types import INF, INF_THRESHOLD, ActiveState, BaseStat, LPSolver

Tensor = torch.Tensor

@dataclasses.dataclass(frozen=True)
class CauchyBasis:
    """Saved LP basis for warm starts."""

    basis: Tensor  # (m,) int32
    status: Tensor  # (N,) int8
    valid: Tensor  # 0-d bool


def empty_basis(n: int, m: int, device=None) -> CauchyBasis:
    N = n + 3 * m
    return CauchyBasis(
        basis=torch.zeros((m,), dtype=torch.int32, device=device),
        status=torch.zeros((N,), dtype=torch.int8, device=device),
        valid=torch.zeros((), dtype=torch.bool, device=device),
    )


@dataclasses.dataclass(frozen=True)
class CauchyResult:
    """Everything the trial-point layer consumes from one LP solve."""

    lp_step: Tensor  # (n,) d
    var_states: Tensor  # (n,) int8 working-set states
    cons_states: Tensor  # (m,) int8
    cons_dual: Tensor  # (m,) NLP-convention duals (trimmed to working set)
    vars_dual: Tensor  # (n,)
    lp_obj: Tensor  # LP objective value (without the f(x) offset)
    violation: Tensor  # sum of slack values (standard_cauchy.c:1445)
    locally_infeasible: Tensor  # 0-d bool
    basis: CauchyBasis  # for warm starting the next solve
    lp_state: Tensor  # simplex status code
    lp_iterations: Tensor


def _i32(v: int, like: Tensor) -> Tensor:
    return torch.full((), v, dtype=torch.int32, device=like.device)


def _lp_data(data: ProblemData, it: Iterate, trust_radius: Tensor):
    """Assemble (A, lb, ub) of the LP (standard_cauchy.c:203-430)."""
    m, n = it.cons_jac.shape
    dtype, dev = it.cons_jac.dtype, it.cons_jac.device
    eye = torch.eye(m, dtype=dtype, device=dev)
    A = torch.cat([it.cons_jac, eye, -eye, -eye], dim=1)

    big = torch.full((), INF, dtype=dtype, device=dev)
    # d bounds: box intersected with the l-inf trust region
    d_lb = torch.maximum(
        torch.where(data.var_lb < -INF_THRESHOLD, -big, data.var_lb - it.x), -trust_radius)
    d_ub = torch.minimum(
        torch.where(data.var_ub > INF_THRESHOLD, big, data.var_ub - it.x), trust_radius)
    zeros = torch.zeros((m,), dtype=dtype, device=dev)
    infs = torch.full((m,), INF, dtype=dtype, device=dev)
    w_lb = torch.where(data.cons_lb < -INF_THRESHOLD, -big, data.cons_lb - it.cons_val)
    w_ub = torch.where(data.cons_ub > INF_THRESHOLD, big, data.cons_ub - it.cons_val)
    lb = torch.cat([d_lb, zeros, zeros, w_lb])
    ub = torch.cat([d_ub, infs, infs, w_ub])
    return A, lb, ub


def _objective(it: Iterate, penalty: Tensor, feasibility_mode: bool) -> Tensor:
    """LP objective (standard_cauchy.c:398-430): [g, λ, λ, 0] or [0, λ, λ, 0]."""
    m, n = it.cons_jac.shape
    g = torch.zeros_like(it.obj_grad) if feasibility_mode else it.obj_grad
    pen = penalty.to(g.dtype).expand(2 * m)
    return torch.cat([g, pen, torch.zeros((m,), dtype=g.dtype, device=g.device)])


def _crash_from_d_statuses(A: Tensor, lb: Tensor, ub: Tensor, d_status: Tensor, n: int, m: int):
    """Slack-repair basis keeping the d-column active-set estimate
    (standard_cauchy.c:71-133, generalized to a warm d pattern): nonbasic
    d columns rest at their new bounds per the saved statuses, previously
    basic ones at ZERO, and each row re-slacks by the sign of the
    resulting activity, so the basis is diagonal and primal feasible."""
    d_status = torch.where((d_status == BaseStat.LOWER) & (lb[:n] <= -INF_THRESHOLD),
                           int(BaseStat.ZERO), d_status)
    d_status = torch.where((d_status == BaseStat.UPPER) & (ub[:n] >= INF_THRESHOLD),
                           int(BaseStat.ZERO), d_status)
    d_status = torch.where(d_status == BaseStat.BASIC, int(BaseStat.ZERO),
                           d_status).to(torch.int8)

    d_rest = torch.where(d_status == BaseStat.LOWER, lb[:n], 0.0)
    d_rest = torch.where(d_status == BaseStat.UPPER, ub[:n], d_rest)

    activity = A[:, :n] @ d_rest  # J d_rest
    w_lb = lb[n + 2 * m :]
    w_ub = ub[n + 2 * m :]
    below = activity < w_lb  # s+ basic: s+ = w_lb - activity > 0
    above = activity > w_ub  # s- basic

    rows = torch.arange(m, dtype=torch.int32, device=A.device)
    basis = torch.where(below, n + rows, torch.where(above, n + m + rows, n + 2 * m + rows))

    def full(v):
        return torch.full((m,), int(v), dtype=torch.int8, device=A.device)

    sp_status = torch.where(below, full(BaseStat.BASIC), full(BaseStat.LOWER))
    sm_status = torch.where(above, full(BaseStat.BASIC), full(BaseStat.LOWER))
    w_status = torch.where(below, full(BaseStat.LOWER),
                           torch.where(above, full(BaseStat.UPPER), full(BaseStat.BASIC)))
    status = torch.cat([d_status, sp_status, sm_status, w_status])
    return basis.to(torch.int32), status


def _try_warm_basis(A: Tensor, lb: Tensor, ub: Tensor, objective: Tensor, saved: CauchyBasis,
                    n: int, m: int, feas_tol: float | None = None, allow_dual: bool = True):
    """Validate a saved basis; repair it instead of discarding it.
    Returns ``(basis, status, use_dual)``:

    * primal feasible under the new LP data -> the primal simplex starts
      from the saved basis (use_dual False);
    * primal infeasible but structurally valid and nonsingular -> use_dual:
      the caller runs the dual simplex from the saved basis, with the
      returned repaired basis as the fallback;
    * otherwise -> the crash repair keeping the d-column statuses.
    """
    if feas_tol is None:
        feas_tol = simplex.default_tols(A.dtype)["feas_tol"]

    def repaired(valid: bool):
        # cold start: rest each d at the bound its objective coefficient
        # pushes toward
        grad_status = torch.where(
            objective[:n] > 0.0, int(BaseStat.LOWER),
            torch.where(objective[:n] < 0.0, int(BaseStat.UPPER),
                        int(BaseStat.ZERO))).to(torch.int8)
        d_status = saved.status[:n] if valid else grad_status
        return _crash_from_d_statuses(A, lb, ub, d_status, n, m)

    if not bool(saved.valid):
        basis, status = repaired(False)
        return basis, status, False

    basis, status = saved.basis, saved.status
    bl = basis.long()
    # structural consistency
    count_ok = (status == BaseStat.BASIC).sum() == m
    basis_ok = (status.index_select(0, bl) == BaseStat.BASIC).all()
    # LOWER needs a finite lb, UPPER a finite ub
    stat_ok = torch.where(status == BaseStat.LOWER, lb > -INF_THRESHOLD,
                          torch.where(status == BaseStat.UPPER, ub < INF_THRESHOLD, True)).all()
    primal = sane = False
    if bool(count_ok & basis_ok & stat_ok):
        B = A.index_select(1, bl)
        xN = simplex._nonbasic_value(status, lb, ub)
        xB = simplex.qr_solve(B, -(A @ xN))
        lbB, ubB = lb.index_select(0, bl), ub.index_select(0, bl)
        sane_t = torch.isfinite(xB).all()  # nonsingular basis matrix
        primal_t = sane_t & ((xB >= lbB - feas_tol) & (xB <= ubB + feas_tol)).all()
        primal, sane = torch.stack([primal_t, sane_t]).tolist()
    if primal:
        return basis, status, False
    b, s = repaired(True)
    return b, s, sane if allow_dual else False


def resolved_lp_solver(settings, n: int, m: int) -> LPSolver:
    """AUTO resolution of the Cauchy LP backend by LP size."""
    if settings.lp_solver == LPSolver.AUTO:
        if m > 0 and (n + 3 * m) >= settings.pdlp_threshold:
            return LPSolver.PDLP
        if lp_enum.suitable(n + 3 * m, m):
            return LPSolver.ENUM
        return LPSolver.SIMPLEX
    return settings.lp_solver


def solve_cauchy_lp(
    data: ProblemData,
    it: Iterate,
    trust_radius: Tensor,
    penalty: Tensor,
    saved_basis: CauchyBasis,
    settings_eps: float = 1e-10,
    max_iterations: int = -1,
    feasibility_mode: bool = False,
    lp_resolves: bool = True,
    dual_warm_start: bool = True,
    lp_solver: LPSolver = LPSolver.SIMPLEX,
    pdlp_tol: float = 1e-9,
    compute_dtype=None,
) -> CauchyResult:
    """One LP solve + full extraction (standard_cauchy.c:843-1462).

    With ``lp_resolves``, a degenerate optimal basis (a tight row with a
    nonzero dual whose penalty slack sits basic at zero) triggers a resolve
    of the reduced LP with the slacks frozen at their optimal values
    (standard_cauchy.c:566-788).  ``compute_dtype=torch.float32`` runs the
    pivoting loops in float32 and finishes the solve in the state dtype
    (``simplex.polish_full_precision``); the PDLP backend ignores it and
    runs in the state dtype.
    """
    m, n = it.cons_jac.shape
    trust_radius = torch.as_tensor(trust_radius, dtype=it.x.dtype, device=it.x.device)
    penalty = torch.as_tensor(penalty, dtype=it.x.dtype, device=it.x.device)
    A, lb, ub = _lp_data(data, it, trust_radius)
    c = _objective(it, penalty, feasibility_mode)
    zero_iters = _i32(0, A)

    if lp_solver == LPSolver.PDLP:
        # restarted-average PDHG: no simplex basis; the statuses are
        # synthesized and the saved basis passes through untouched
        pres = pdlp.solve(A, c, lb, ub,
                          max_iterations=max_iterations if max_iterations > 0 else 20000,
                          tol=pdlp_tol)
        res = simplex.SimplexResult(
            x=pres.x, duals=pres.duals, reduced_costs=pres.reduced_costs, status=pres.status,
            basis=saved_basis.basis, obj=pres.obj, state=pres.state,
            iterations=pres.iterations,
            condition=torch.ones((), dtype=A.dtype, device=A.device))
        return _extract(
            data, it, trust_radius, penalty, res, saved_basis, A, lb, ub, c, n, m,
            settings_eps=settings_eps, feasibility_mode=feasibility_mode,
            lp_resolves=False, max_iterations=0, dual_iters=zero_iters,
            keep_saved_basis=True)

    if lp_solver == LPSolver.ENUM:
        # every basis of the tiny LP at once; no warm start, and the
        # reduced resolve (a simplex repair) is skipped
        res = lp_enum.solve_enum(A, c, lb, ub)
        return _extract(
            data, it, trust_radius, penalty, res, saved_basis, A, lb, ub, c, n, m,
            settings_eps=settings_eps, feasibility_mode=feasibility_mode,
            lp_resolves=False, max_iterations=0, dual_iters=zero_iters)

    cd = compute_dtype if compute_dtype is not None else A.dtype
    mixed = cd != A.dtype
    if mixed:
        A_c, lb_c, ub_c, c_c = (z.to(cd) for z in (A, lb, ub, c))
    else:
        A_c, lb_c, ub_c, c_c = A, lb, ub, c

    basis0, status0, use_dual = _try_warm_basis(
        A_c, lb_c, ub_c, c_c, saved_basis, n, m, allow_dual=dual_warm_start)

    if max_iterations < 0:
        max_iterations = 20 * (n + 3 * m) + 200

    basis1, status1, dual_iters = basis0, status0, zero_iters
    if dual_warm_start and use_dual:
        # dual pivots restore primal feasibility of the saved basis; the
        # stage is capped so a cold basis in disguise cannot eat the budget
        dres = simplex.solve_dual(A_c, c_c, lb_c, ub_c, saved_basis.basis, saved_basis.status,
                                  max_iterations=min(max_iterations, 4 * m + 50))
        ok = dres.state == simplex.OPTIMAL
        basis1 = torch.where(ok, dres.basis, basis0)
        status1 = torch.where(ok, dres.status, status0)
        dual_iters = dres.iterations

    res = simplex.solve(A_c, c_c, lb_c, ub_c, basis1, status1, max_iterations=max_iterations)
    if mixed:
        res = simplex.polish_full_precision(A, c, lb, ub, res, max_iterations=max_iterations)
    return _extract(
        data, it, trust_radius, penalty, res, saved_basis, A, lb, ub, c, n, m,
        settings_eps=settings_eps, feasibility_mode=feasibility_mode,
        lp_resolves=lp_resolves, max_iterations=max_iterations, dual_iters=dual_iters,
        compute_dtype=cd)


def _extract(
    data: ProblemData,
    it: Iterate,
    trust_radius: Tensor,
    penalty: Tensor,
    res: simplex.SimplexResult,
    saved_basis: CauchyBasis,
    A: Tensor,
    lb: Tensor,
    ub: Tensor,
    c: Tensor,
    n: int,
    m: int,
    *,
    settings_eps: float,
    feasibility_mode: bool,
    lp_resolves: bool,
    max_iterations: int,
    dual_iters: Tensor,
    keep_saved_basis: bool = False,
    compute_dtype=None,
) -> CauchyResult:
    """Working set, duals and infeasibility from an LP solution
    (standard_cauchy.c:960-1462); ``keep_saved_basis`` (the PDLP backend)
    returns the caller's saved basis in place of the LP's."""
    d = res.x[:n]
    slack_sum = res.x[n : n + 2 * m].sum()

    # ---- working set from basis statuses ------------------------------
    d_status = res.status[:n]
    sp_status = res.status[n : n + m]
    sm_status = res.status[n + m : n + 2 * m]
    w_status = res.status[n + 2 * m :]

    zero_slacks = (sp_status == BaseStat.LOWER) & (sm_status == BaseStat.LOWER)
    if lp_resolves and not feasibility_mode and m > 0:
        (d, d_status, w_status_eff, zero_slacks_eff, row_duals, d_reduced_costs,
         extra_iters) = _maybe_reduced_resolve(
            it, A, lb, ub, c, res, zero_slacks, n, m, max_iterations,
            compute_dtype=compute_dtype)
    else:
        w_status_eff = w_status
        zero_slacks_eff = zero_slacks
        row_duals = res.duals
        d_reduced_costs = res.reduced_costs[:n]
        extra_iters = _i32(0, A)

    eps = settings_eps
    equal_var_bounds = _equal_bounds(data.var_lb, data.var_ub, eps)
    # a variable is active iff nonbasic at a bound that is the actual
    # variable bound rather than the trust region (standard_cauchy.c:1010-1025)
    dist_lb = it.x - data.var_lb
    dist_ub = data.var_ub - it.x
    var_lower = (d_status == BaseStat.LOWER) & (dist_lb < trust_radius)
    var_upper = (d_status == BaseStat.UPPER) & (dist_ub < trust_radius)
    var_states = _states(equal_var_bounds, var_lower, var_upper)

    equal_cons_bounds = _equal_bounds(data.cons_lb, data.cons_ub, eps)
    row_nonbasic = w_status_eff != BaseStat.BASIC
    cons_states = torch.where(
        row_nonbasic & zero_slacks_eff,
        _states(equal_cons_bounds, w_status_eff == BaseStat.LOWER,
                w_status_eff == BaseStat.UPPER),
        int(ActiveState.INACTIVE)).to(torch.int8)

    # ---- duals (signs to the NLP convention) --------------------------
    cons_dual = _trim_duals(-row_duals, cons_states)
    vars_dual = _trim_duals(-d_reduced_costs, var_states)

    # ---- local infeasibility (standard_cauchy.c:1190-1325) ------------
    tr_active = (~equal_var_bounds & (
        ((d_status == BaseStat.LOWER) & (dist_lb >= trust_radius))
        | ((d_status == BaseStat.UPPER) & (dist_ub >= trust_radius)))).any()
    feasible_direction = torch.where(w_status != BaseStat.BASIC, zero_slacks, True).all()
    locally_infeasible = ~(feasible_direction | tr_active)

    if keep_saved_basis:
        new_basis = saved_basis
    else:
        new_basis = CauchyBasis(basis=res.basis, status=res.status,
                                valid=res.state == simplex.OPTIMAL)

    lp_obj = torch.dot(c[:n], d) + penalty * slack_sum
    return CauchyResult(
        lp_step=d,
        var_states=var_states,
        cons_states=cons_states,
        cons_dual=cons_dual,
        vars_dual=vars_dual,
        lp_obj=lp_obj,
        violation=slack_sum,
        locally_infeasible=locally_infeasible,
        basis=new_basis,
        lp_state=res.state,
        lp_iterations=res.iterations + extra_iters + dual_iters,
    )


def _states(equal: Tensor, lower: Tensor, upper: Tensor) -> Tensor:
    """ACTIVE_BOTH where the bounds coincide, else ACTIVE_LOWER/UPPER/INACTIVE."""
    return torch.where(
        equal, int(ActiveState.ACTIVE_BOTH),
        torch.where(lower, int(ActiveState.ACTIVE_LOWER),
                    torch.where(upper, int(ActiveState.ACTIVE_UPPER),
                                int(ActiveState.INACTIVE)))).to(torch.int8)


def _maybe_reduced_resolve(it: Iterate, A: Tensor, lb: Tensor, ub: Tensor, c: Tensor, res,
                           zero_slack_stats: Tensor, n: int, m: int, max_iterations: int,
                           compute_dtype=None):
    """Degenerate-basis tie-breaking via the reduced LP
    (standard_cauchy.c:566-788): when the direction is feasible and some
    row classified INACTIVE is tight with a nonzero dual, freeze the
    slacks at their optimal values and re-solve over [d, w], warm-started
    with each basic slack column swapped for its row's logical column."""
    sp_vals = res.x[n : n + m]
    sm_vals = res.x[n + m : n + 2 * m]
    w_status = res.status[n + 2 * m :]
    row_nonbasic = w_status != BaseStat.BASIC

    tight = (sp_vals == 0.0) & (sm_vals == 0.0)
    inactive = ~(row_nonbasic & zero_slack_stats)
    feasible = torch.where(inactive, tight, True).all()
    needs = feasible & (inactive & tight & (res.duals != 0.0)).any()

    d_status_main = res.status[:n]
    if not bool(needs):
        return (res.x[:n], d_status_main, w_status, zero_slack_stats, res.duals,
                res.reduced_costs[:n], _i32(0, A))

    sdiff = sp_vals - sm_vals
    A_red = torch.cat([A[:, :n], -torch.eye(m, dtype=A.dtype, device=A.device)], dim=1)
    shift_lb = torch.where(lb[n + 2 * m :] > -INF_THRESHOLD, sdiff, 0.0)
    shift_ub = torch.where(ub[n + 2 * m :] < INF_THRESHOLD, sdiff, 0.0)
    lb_red = torch.cat([lb[:n], lb[n + 2 * m :] + shift_lb])
    ub_red = torch.cat([ub[:n], ub[n + 2 * m :] + shift_ub])
    c_red = torch.cat([c[:n], torch.zeros((m,), dtype=c.dtype, device=c.device)])

    # basis remap: any basic slack/logical column -> its row's logical
    basis_red = torch.where(res.basis < n, res.basis,
                            n + torch.remainder(res.basis - n, m)).to(torch.int32)
    slack_basic = ((res.status[n : n + m] == BaseStat.BASIC)
                   | (res.status[n + m : n + 2 * m] == BaseStat.BASIC)
                   | (w_status == BaseStat.BASIC))
    w_status_red = torch.where(slack_basic, int(BaseStat.BASIC), w_status).to(torch.int8)
    status_red = torch.cat([d_status_main, w_status_red])

    cd = compute_dtype if compute_dtype is not None else A_red.dtype
    red = simplex.solve(A_red.to(cd), c_red.to(cd), lb_red.to(cd), ub_red.to(cd), basis_red,
                        status_red, max_iterations=max_iterations)
    if cd != A_red.dtype:
        red = simplex.polish_full_precision(A_red, c_red, lb_red, ub_red, red,
                                            max_iterations=max_iterations)
    # the reduced working set uses slack values for tightness
    # (get_reduced_working_set, standard_cauchy.c:1086-1128)
    return (red.x[:n], red.status[:n], red.status[n:], tight, red.duals,
            red.reduced_costs[:n], red.iterations)


def _equal_bounds(lb: Tensor, ub: Tensor, eps: float) -> Tensor:
    """Eps-relative equality of finite bound pairs (cmp.c sleqp_is_eq)."""
    both_finite = (lb > -INF_THRESHOLD) & (ub < INF_THRESHOLD)
    return both_finite & ((ub - lb).abs() <= eps * (1.0 + torch.where(both_finite, lb, 0.0).abs()))


def _trim_duals(duals: Tensor, states: Tensor) -> Tensor:
    """Zero inactive or wrong-sign duals (standard_cauchy.c:1331-1386):
    ACTIVE_UPPER duals must be >= 0, ACTIVE_LOWER <= 0; ACTIVE_BOTH keeps
    either sign."""
    out = torch.where(states == ActiveState.INACTIVE, 0.0, duals)
    out = torch.where((states == ActiveState.ACTIVE_UPPER) & (out < 0.0), 0.0, out)
    return torch.where((states == ActiveState.ACTIVE_LOWER) & (out > 0.0), 0.0, out)


def criticality_bound(merit_value: Tensor, lp_obj: Tensor, obj_val: Tensor,
                      trust_radius: Tensor) -> Tensor:
    """(merit - LP objective incl. f offset) / min(radius, 1) (cauchy.c:137-150)."""
    reduction = merit_value - (lp_obj + obj_val)
    return reduction / torch.clamp(trust_radius, max=1.0)


def solve_box_cauchy(data: ProblemData, it: Iterate, trust_radius: Tensor) -> CauchyResult:
    """Box-constrained problems: the LP decouples per coordinate
    (box_constrained_cauchy.c): d_j = lower if g_j > 0, upper if g_j < 0."""
    m, n = it.cons_jac.shape
    assert m == 0
    dtype, dev = it.x.dtype, it.x.device
    trust_radius = torch.as_tensor(trust_radius, dtype=dtype, device=dev)
    big = torch.full((), INF, dtype=dtype, device=dev)
    d_lb = torch.maximum(torch.where(data.var_lb < -INF_THRESHOLD, -big, data.var_lb - it.x),
                         -trust_radius)
    d_ub = torch.minimum(torch.where(data.var_ub > INF_THRESHOLD, big, data.var_ub - it.x),
                         trust_radius)
    g = it.obj_grad
    d = torch.where(g > 0.0, d_lb, torch.where(g < 0.0, d_ub, 0.0))

    equal = _equal_bounds(data.var_lb, data.var_ub, 1e-10)
    at_lower = (g > 0.0) & (it.x - data.var_lb < trust_radius)
    at_upper = (g < 0.0) & (data.var_ub - it.x < trust_radius)
    var_states = _states(equal, at_lower, at_upper)

    return CauchyResult(
        lp_step=d,
        var_states=var_states,
        cons_states=torch.zeros((0,), dtype=torch.int8, device=dev),
        cons_dual=torch.zeros((0,), dtype=dtype, device=dev),
        vars_dual=_trim_duals(-g, var_states),
        lp_obj=torch.dot(g, d),
        violation=torch.zeros((), dtype=dtype, device=dev),
        locally_infeasible=torch.zeros((), dtype=torch.bool, device=dev),
        basis=empty_basis(n, 0, device=dev),
        lp_state=_i32(simplex.OPTIMAL, it.x),
        lp_iterations=_i32(0, it.x),
    )
