"""The SLP-EQP iteration (problem solver).

Port of ``sleqp_tpu/problem_solver.py`` (reference
src/main/problem_solver/{solve.c,iteration.c,trust_radius.c,step.c} and the
trial-point layer): one ``perform_iteration`` is

    LP (Cauchy) step -> penalty update -> working set + LSQ duals ->
    optimality test -> working step -> Newton/EQP step (GLTR or projected
    CG) -> Cauchy-Newton linesearch -> trial evaluation -> step rule ->
    optional second-order correction -> trust-radius and penalty updates.

The reference is one pure function jit-compiled into a ``lax.while_loop``
(``solve_jit``).  Here the iteration is made of parts (``_head``, ``_mid``,
``_tail`` and the loops between them) that two loops compose.
``solve_from`` is eager: every tensor of the state stays on the problem's
device, and the host reads only the scalars that steer the loops and
branches (a pivot's state, a Krylov step's stop flag, a linesearch test,
the branch of the penalty update and of the second-order correction, and
whether the iteration stops).  ``solve_jit`` runs the same parts as
read-free programs, captured as CUDA graphs on the card, with a read of a
flag after a block of a loop or a branch that guards an LP: the same
bits, fewer reads.  Where the reference computes both sides and selects
with ``where``, the port selects with ``torch.where``, which takes nothing
(NaN or inf included) from the side it does not select; a stopping
iteration of the eager loop returns its stopped state without evaluating
the trial point.

Every loop and branch reads its flags through ``lanes.py``: under
``torch.func.vmap`` (``parallel/batch.py``) a branch is taken when any lane
needs it and its result selected per lane, a loop runs its lanes in
lockstep, and a lane that stops keeps its stopped state while the others
iterate.  On one instance the same code reads the same flags as a plain
loop.  Quasi-Newton Hessians (``hess_eval != EXACT``) push their pair on
one read of ``qn_prev.pending``, and a dynamic (inexact) function
(``dyn.py``) re-evaluates the iterate on one read of ``refresh_eval``; the
parametric Cauchy sweep and the Gauss-Newton step of an ``LSQFunc`` read
one stop flag per LP re-solve or LSQR step, the simplex one a pivot and
the PDLP LP backend one a block of PDHG iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from . import graphs
from .cauchy import (
    DEFAULT_EPS,
    CauchyBasis,
    LPGraph,
    _trim_duals,
    empty_basis,
    resolved_lp_solver,
    solve_box_cauchy,
    solve_cauchy_lp,
)
from .device import resolve_device
from .dyn import DynFunc, required_error_bound
from .gauss_newton import compute_gauss_newton_step, gauss_newton_result, gauss_newton_start
from .graphs import (
    CG,
    FORWARD,
    PENALTY,
    RUNNING,
    SEARCHING,
    SWEEP,
    Programs,
    cached,
    state_key,
)
from .iterate import (
    Iterate,
    create_iterate,
    kkt_residuals,
    max0,
    max_violation,
)
from .lanes import (
    device_resident,
    is_batched,
    is_device_resident,
    lanes_any,
    lanes_where,
    lockstep,
    tree_map,
    tree_where,
)
from .linesearch import (
    MAX_TRIALS,
    cauchy_linesearch,
    cauchy_result,
    cauchy_search,
    cauchy_trial,
    trial_linesearch,
    trial_linesearch_exact,
    trial_result,
    trial_search,
    trial_trial,
)
from .measure import Measure, compute_measure, empty_measure
from .merit import make_direction, merit_func, merit_linear, merit_quadratic
from .newton import (
    _working_set_rhs,
    compute_newton_step,
    compute_working_step,
    krylov_inputs,
    newton_gradient,
    newton_result,
)
from .ops.gltr import gltr_body, gltr_result, gltr_size, gltr_start
from .ops.kkt import aug_jac_create, solve_lsq, solve_min_norm
from .ops.lsqr import lsqr_body, lsqr_running, lsqr_start
from .ops.tr_cg import cg_body, cg_result, cg_running, cg_start
from .parametric import Sweep, parametric_solve
from .penalty import (
    MAX_INCREASES,
    PENALTY_INCREASE,
    global_penalty_reset,
    penalty_keep,
    penalty_ok,
    penalty_skip,
    update_penalty,
)
from .problem import LSQFunc, Problem
from .quasi_newton import QNPrev, qn_astype, qn_init, qn_prev_init, qn_product, qn_push
from .settings import Settings
from .step_rule import StepRuleState, apply_step_rule, step_rule_init
from .types import (
    AugJacMethod,
    DualEstimationType,
    HessEval,
    InitialTRChoice,
    Linesearch,
    LPSolver,
    ParametricCauchy,
    Status,
    StepType,
    TRSolver,
)

Tensor = torch.Tensor

# problem_solver.c:10-11
PENALTY_DEFAULT = 10.0
TRUST_REGION_FACTOR = 0.8
# iteration.c:10-13
MAX_GLOBAL_RESETS = 2
NUM_RESET_STEPS = 5
SOC_SAFEGUARD_FACTOR = 10.0


def _aug_jac_method(settings: Settings) -> str:
    """AUG_JAC_METHOD to a factorization route (trial_point.c:64-130)."""
    return "direct" if settings.aug_jac_method == AugJacMethod.DIRECT else "reduced"


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Complete, fixed-shape solver state (one SQP instance); the field
    names, dtypes and shapes are those of the reference's state."""

    it: Iterate
    trust_radius: Tensor
    lp_trust_radius: Tensor
    penalty: Tensor
    basis: CauchyBasis
    iteration: Tensor  # int32
    status: Tensor  # int32 Status
    last_step_type: Tensor  # int32 StepType
    num_feasible_steps: Tensor
    num_global_resets: Tensor
    num_accepted: Tensor
    num_soc_accepted: Tensor
    num_rejected: Tensor
    num_failed_eqp: Tensor
    feas_res: Tensor
    slack_res: Tensor
    stat_res: Tensor
    min_rayleigh: Tensor
    max_rayleigh: Tensor
    lp_iterations: Tensor  # total simplex pivots
    boundary_step: Tensor  # bool
    qn: Any  # QNState, or a tuple of them per Hessian block
    qn_prev: QNPrev
    step_rule: StepRuleState
    # dynamic (inexact) function state (dyn.py); inert otherwise
    error_bound: Tensor
    error_est: Tensor
    refresh_eval: Tensor  # bool
    # per-step nonlinearity measures (measure.c:15-40)
    last_model_reduction: Tensor
    last_exact_reduction: Tensor
    last_reduction_ratio: Tensor
    measure: Measure
    # numerical-invariant violation bitmask (settings.num_asserts):
    # 1 = direction bundle inconsistent, 2 = model merit mismatch,
    # 4 = non-finite solver quantity
    num_assert_fail: Tensor  # int32


def initial_state(problem: Problem, settings: Settings, x0: Any,
                  device: Any = None) -> SolverState:
    """Initial radii and penalty (problem_solver.c:83-118).  ``device=None``
    means CUDA; the problem is moved there."""
    problem = problem.to(resolve_device(device))
    dev = problem.device
    it = create_iterate(problem, x0)
    n = problem.num_variables
    m = problem.num_cons
    dtype = problem.dtype
    sqrt_n = float(max(n, 1)) ** 0.5
    if settings.initial_tr_choice == InitialTRChoice.WIDE:
        trust_radius, lp_trust_radius = sqrt_n, TRUST_REGION_FACTOR  # Knitro default
    else:
        trust_radius, lp_trust_radius = 1.0, TRUST_REGION_FACTOR / sqrt_n  # the paper's

    def f(v):
        return torch.full((), v, dtype=dtype, device=dev)

    def i(v):
        return torch.full((), int(v), dtype=torch.int32, device=dev)

    return SolverState(
        it=it,
        trust_radius=f(trust_radius),
        lp_trust_radius=f(lp_trust_radius),
        penalty=f(PENALTY_DEFAULT),
        basis=empty_basis(n, m, device=dev),
        iteration=i(0),
        status=i(Status.RUNNING),
        last_step_type=i(StepType.NONE),
        num_feasible_steps=i(0),
        num_global_resets=i(0),
        num_accepted=i(0),
        num_soc_accepted=i(0),
        num_rejected=i(0),
        num_failed_eqp=i(0),
        feas_res=f(torch.inf),
        slack_res=f(torch.inf),
        stat_res=f(torch.inf),
        min_rayleigh=f(0.0),
        max_rayleigh=f(0.0),
        lp_iterations=i(0),
        boundary_step=torch.zeros((), dtype=torch.bool, device=dev),
        qn=(qn_init(n, settings.num_quasi_newton_iterates, dtype,
                    blocks=problem.func.hess_struct, device=dev)
            if settings.hess_eval != HessEval.EXACT else qn_init(n, 0, dtype, device=dev)),
        qn_prev=qn_prev_init(n, m, dtype, device=dev),
        step_rule=step_rule_init(settings.step_rule, dtype, device=dev),
        error_bound=f(getattr(problem.func, "initial_error_bound", 0.0)),
        error_est=f(0.0),
        refresh_eval=torch.zeros((), dtype=torch.bool, device=dev),
        last_model_reduction=f(0.0),
        last_exact_reduction=f(0.0),
        last_reduction_ratio=f(0.0),
        measure=empty_measure(dtype, device=dev),
        num_assert_fail=i(0),
    )


def _update_trust_radius(trust_radius: Tensor, ratio: Tensor, accepted: Tensor,
                         direction_norm: Tensor, eps: float) -> Tensor:
    """EQP radius update (trust_radius.c:47-84)."""
    grow7 = torch.maximum(trust_radius, 7.0 * direction_norm)
    grow2 = torch.maximum(trust_radius, 2.0 * direction_norm)
    tiny_step = direction_norm.abs() <= eps
    shrink = torch.where(tiny_step, 0.5 * trust_radius,
                         torch.minimum(0.5 * trust_radius, 0.5 * direction_norm))
    return torch.where(ratio >= 0.9, grow7,
                       torch.where(ratio >= 0.3, grow2,
                                   torch.where(accepted, trust_radius, shrink)))


def _update_lp_trust_radius(lp_trust_radius: Tensor, accepted: Tensor,
                            trial_step_infnorm: Tensor, cauchy_step_infnorm: Tensor,
                            full_cauchy_step: Tensor) -> Tensor:
    """LP radius update (trust_radius.c:5-45)."""
    factor = 1.2
    lhs = torch.maximum(torch.maximum(factor * trial_step_infnorm, factor * cauchy_step_infnorm),
                        0.1 * lp_trust_radius)
    grown = torch.where(full_cauchy_step, 7.0 * lp_trust_radius, lp_trust_radius)
    on_accept = torch.minimum(lhs, grown)
    reduced = torch.maximum(0.5 * trial_step_infnorm, 0.1 * lp_trust_radius)
    on_reject = torch.minimum(reduced, lp_trust_radius)
    return torch.where(accepted, on_accept, on_reject)


def _trial_ok(problem: Problem, x: Tensor, trial: Iterate) -> Tensor:
    """The manual (accept_point) and non-finite trial rejection
    (pub_func.h:40-44, iteration.c:416-456)."""
    return (problem.func.point_valid(x) & torch.isfinite(trial.obj_val)
            & torch.isfinite(trial.cons_val).all())


# ---- the iteration's parts ---------------------------------------------
#
# The eager ``perform_iteration`` and the programs of ``solve_jit`` are made
# of these parts, with the loops (the Cauchy LPs, the penalty increases,
# the parametric sweep, the Krylov solve, the linesearches) between them.


class _Head(NamedTuple):
    """An iteration's start: the (refreshed) iterate, feasibility and the
    penalty and merit the Cauchy LP is solved at."""

    it: Iterate
    iterate_err: Tensor
    is_feasible: Tensor
    num_feasible_steps: Tensor
    num_global_resets: Tensor
    penalty: Tensor
    merit_val: Tensor


def _compute_dtype(settings: Settings, dtype):
    """Mixed precision: the inner sequential solvers run in float32, the
    certified quantities (residuals, duals, merit) in the state dtype."""
    return (torch.float32
            if settings.compute_dtype == "float32" and dtype != torch.float32 else None)


def _head(problem: Problem, settings: Settings, state: SolverState) -> _Head:
    data = problem.data
    it = state.it
    # ---- dynamic functions: refresh the iterate at a tightened bound --
    iterate_err = state.error_est
    if isinstance(problem.func, DynFunc) and lanes_any(state.refresh_eval):
        obj, grad, cons, jac, err = problem.func.eval_all_dyn(
            it.x, state.error_bound, state.penalty)
        fresh = dataclasses.replace(it, obj_val=obj, obj_grad=grad, cons_val=cons, cons_jac=jac)
        it, iterate_err = lanes_where(state.refresh_eval, (fresh, err), (it, iterate_err))

    # ---- feasibility bookkeeping + global penalty reset ---------------
    feas_now = max_violation(data, it.cons_val)
    is_feasible = feas_now <= settings.feas_tol
    num_feasible_steps = torch.where(is_feasible, state.num_feasible_steps + 1, 0)
    allow_reset = ((num_feasible_steps >= NUM_RESET_STEPS)
                   & (state.num_global_resets < MAX_GLOBAL_RESETS)
                   & bool(settings.global_penalty_resets))
    penalty, did_reset = global_penalty_reset(it, state.penalty, allow_reset & is_feasible)
    num_global_resets = state.num_global_resets + did_reset.to(torch.int32)
    return _Head(it, iterate_err, is_feasible, num_feasible_steps, num_global_resets, penalty,
                 merit_func(data, it, penalty))


def _with_penalty(data, h: _Head, infeasible: Tensor, pen_new: Tensor, cres_new: CauchyResult,
                  pen_changed: Tensor, cres: CauchyResult):
    """(the head, the Cauchy result) after the Byrd penalty update."""
    merit_new = torch.where(pen_changed, merit_func(data, h.it, pen_new), h.merit_val)
    penalty, cres, merit_val = lanes_where(infeasible, (pen_new, cres_new, merit_new),
                                           (h.penalty, cres, h.merit_val))
    return h._replace(penalty=penalty, merit_val=merit_val), cres


class _Mid(NamedTuple):
    """The working set, duals, residuals and working step."""

    it: Iterate
    aug_jac: Any
    feas_res: Tensor
    slack_res: Tensor
    stat_res: Tensor
    optimal: Tensor
    unbounded: Tensor
    locally_infeasible: Tensor
    deadpoint: Tensor
    qn: Any
    ws: Any
    multipliers: Tensor


def _mid(problem: Problem, settings: Settings, state: SolverState, h: _Head,
         cres: CauchyResult) -> _Mid:
    data = problem.data
    n, m = problem.num_variables, problem.num_cons
    # ---- working set + duals onto the iterate -------------------------
    it = dataclasses.replace(h.it, var_states=cres.var_states, cons_states=cres.cons_states)
    aug_jac = aug_jac_create(it.cons_jac, it.var_states, it.cons_states,
                             method=_aug_jac_method(settings))
    # dual estimation: LSQ (default) from the KKT factorization with
    # wrong-sign clipping; LP straight from the LP basis; MIXED: LSQ,
    # falling back to LP per vector when clipping occurred
    _, lam = solve_lsq(aug_jac, -it.obj_grad)
    vars_lsq = _trim_duals(lam[:n], it.var_states)
    cons_lsq = _trim_duals(lam[n:], it.cons_states)
    if settings.dual_estimation_type == DualEstimationType.LP:
        vars_dual, cons_dual = cres.vars_dual, cres.cons_dual
    elif settings.dual_estimation_type == DualEstimationType.MIXED:
        vars_dual = torch.where((vars_lsq != lam[:n]).any(), cres.vars_dual, vars_lsq)
        cons_dual = torch.where((cons_lsq != lam[n:]).any(), cres.cons_dual, cons_lsq)
    else:
        vars_dual, cons_dual = vars_lsq, cons_lsq
    it = dataclasses.replace(it, vars_dual=vars_dual, cons_dual=cons_dual)

    feas_res, slack_res, stat_res = kkt_residuals(data, it)
    optimal = ((feas_res <= settings.feas_tol) & (stat_res < settings.stat_tol)
               & (slack_res < settings.slack_tol))
    unbounded = (it.obj_val <= settings.obj_lower) & (feas_res <= settings.feas_tol)
    locally_infeasible = cres.locally_infeasible & (m > 0)
    deadpoint = ((state.lp_trust_radius <= settings.deadpoint_bound)
                 | (state.trust_radius <= settings.deadpoint_bound))

    # ---- quasi-Newton pair push (accepted steps, new duals) -----------
    # pairs push on accepted steps with the Lagrangian gradient difference
    # at the new multipliers (quasi_newton.c:140); the reference's
    # lax.cond on qn_prev.pending is a branch on one host read, its push
    # selected on the lanes that have a pair pending
    qn = state.qn
    if settings.hess_eval != HessEval.EXACT and lanes_any(state.qn_prev.pending):
        prev = state.qn_prev
        grad_new = it.obj_grad + it.cons_jac.T @ it.cons_dual
        grad_old = prev.grad + prev.jac.T @ it.cons_dual
        pushed = qn_push(qn, it.x - prev.x, grad_new - grad_old, settings.hess_eval,
                         settings.bfgs_sizing != 0, blocks=problem.func.hess_struct)
        qn = lanes_where(prev.pending, pushed, qn)

    # ---- working step + EQP multipliers -------------------------------
    ws = compute_working_step(data, it, aug_jac, state.trust_radius, settings.eps)
    return _Mid(it, aug_jac, feas_res, slack_res, stat_res, optimal, unbounded,
                locally_infeasible, deadpoint, qn, ws, it.cons_dual + h.penalty * ws.violated_mult)


def _hess_prod(problem: Problem, settings: Settings, state: SolverState, h: _Head, mid: _Mid):
    """The Lagrangian Hessian's product at the working set's multipliers:
    quasi-Newton, dynamic or exact."""
    if settings.hess_eval != HessEval.EXACT:
        def hess_prod(d):
            return qn_product(mid.qn, d, settings.hess_eval, blocks=problem.func.hess_struct)
    elif isinstance(problem.func, DynFunc):
        def hess_prod(d):
            return problem.func.hess_prod_dyn(mid.it.x, d, mid.multipliers[: problem.num_general],
                                              state.error_bound, h.penalty)
    else:
        def hess_prod(d):
            return problem.hess_prod(mid.it.x, d, mid.multipliers)
    return hess_prod


def _uses_sweep(problem: Problem, settings: Settings) -> bool:
    return (problem.num_cons > 0 and settings.parametric_cauchy != ParametricCauchy.DISABLED
            and settings.use_quadratic_model)


def _after_sweep(problem: Problem, settings: Settings, state: SolverState, h: _Head, mid: _Mid,
                 cres: CauchyResult) -> _Mid:
    """The working set at the sweep's accepted radius, and the KKT
    factorization and working step on it (cauchy_step.c:205-231)."""
    it = dataclasses.replace(mid.it, var_states=cres.var_states, cons_states=cres.cons_states)
    aug_jac = aug_jac_create(it.cons_jac, it.var_states, it.cons_states,
                             method=_aug_jac_method(settings))
    ws = compute_working_step(problem.data, it, aug_jac, state.trust_radius, settings.eps)
    return mid._replace(it=it, aug_jac=aug_jac, ws=ws,
                        multipliers=it.cons_dual + h.penalty * ws.violated_mult)


class _Cauchy(NamedTuple):
    """The Cauchy step the trial step starts from."""

    cres: CauchyResult
    lp_tr_current: Tensor
    cauchy_dir: Any
    full_cauchy: Tensor
    cauchy_merit: Tensor


def _newton_route(problem: Problem, settings: Settings) -> str:
    """The EQP step's solver: "none", "gauss_newton" (LSQR, for an LSQ
    function with exact Hessians), "gltr" or "cg" (eqp.c)."""
    if not (settings.perform_newton_step and settings.use_quadratic_model):
        return "none"
    if (isinstance(problem.func, LSQFunc) and settings.hess_eval == HessEval.EXACT
            and settings.tr_solver in (TRSolver.AUTO, TRSolver.LSQR)):
        return "gauss_newton"
    # AUTO picks GLTR unless the Hessian is declared PSD (newton.c:96-106)
    use_gltr = settings.tr_solver == TRSolver.GLTR or (
        settings.tr_solver == TRSolver.AUTO and not problem.func.psd_hessian)
    return "gltr" if use_gltr else "cg"


def _hess_prod_compute(problem: Problem, settings: Settings, mid: _Mid, cdtype):
    """The Krylov loop's Hessian operator on the mixed route, or None."""
    if cdtype is None:
        return None
    if settings.hess_eval != HessEval.EXACT:
        # the ring buffer cast to float32
        qn_c = qn_astype(mid.qn, cdtype)

        def hess_prod_c(d):
            return qn_product(qn_c, d, settings.hess_eval, blocks=problem.func.hess_struct)

        return hess_prod_c
    if isinstance(problem.func, DynFunc):
        return None
    # a natively float32 Hessian operator: the callables run at the cast
    # iterate, so the Krylov loop holds no float64 operation
    x_c = mid.it.x.to(cdtype)
    problem.check_follows_dtype(x_c)
    mult_c = mid.multipliers.to(cdtype)

    def hess_prod_c(d):
        return problem.hess_prod(x_c, d, mult_c)

    return hess_prod_c


class _Trial(NamedTuple):
    """The trial step and what the iteration's end takes from the EQP."""

    trial_dir: Any
    model_trial: Tensor
    failed_eqp: Tensor
    min_ray: Tensor
    max_ray: Tensor


def _trial_from(settings: Settings, data, mid: _Mid, c: _Cauchy, newton_dir, penalty,
                min_ray, max_ray, search=None) -> _Trial:
    """The trial step on the Cauchy -> Newton segment: the EXACT rule, or
    the end of the APPROX linesearch (``search``: its start and alpha), as
    ``trial_linesearch_exact`` and ``trial_linesearch`` end."""
    if settings.linesearch == Linesearch.EXACT:
        trial_dir, alpha, model_trial = trial_linesearch_exact(
            data, mid.it, c.cauchy_dir, c.cauchy_merit, newton_dir, penalty,
            settings.linesearch_cutoff)
    else:
        ts, alpha = search
        trial_dir, alpha, model_trial = trial_result(data, mid.it, c.cauchy_dir, c.cauchy_merit,
                                                     newton_dir, penalty, ts, alpha)
    return _Trial(trial_dir, model_trial, alpha == 0.0, min_ray, max_ray)


def _no_newton(c: _Cauchy, dtype, dev) -> _Trial:
    zero = torch.zeros((), dtype=dtype, device=dev)
    return _Trial(c.cauchy_dir, c.cauchy_merit, torch.zeros((), dtype=torch.bool, device=dev),
                  zero, zero)


def _tail(problem: Problem, settings: Settings, state: SolverState, h: _Head, mid: _Mid,
          c: _Cauchy, t: _Trial, hess_prod) -> SolverState:
    """The iteration's end: the invariant checks, the stop test, the trial
    point, the step rule, the second-order correction and the updates."""
    data = problem.data
    it, cres = mid.it, c.cres
    n, m = problem.num_variables, problem.num_cons
    dtype, dev = problem.dtype, problem.device
    false = torch.zeros((), dtype=torch.bool, device=dev)
    penalty, merit_val = h.penalty, h.merit_val
    trial_dir, model_trial = t.trial_dir, t.model_trial

    # ---- numerical invariant checks (trial_point.c:620-708) -----------
    if settings.num_asserts:
        _d = trial_dir.primal

        def close(a, b):
            return ((a - b).abs()
                    <= settings.eps * (1.0 + torch.maximum(a.abs(), b.abs()))).all()

        ok_dir = (close(it.obj_grad @ _d, trial_dir.obj_dot)
                  & close(it.cons_jac @ _d, trial_dir.cons_jac_dot)
                  & close(hess_prod(_d), trial_dir.hess))
        if settings.use_quadratic_model:
            m_re = merit_quadratic(data, it, trial_dir, penalty)
        else:
            m_re = merit_linear(data, it, trial_dir, penalty)
        ok_merit = close(m_re, model_trial)
        ok_finite = (torch.isfinite(_d).all() & torch.isfinite(it.vars_dual).all()
                     & torch.isfinite(it.cons_dual).all())
        num_assert_fail = (torch.where(ok_dir, 0, 1) + torch.where(ok_merit, 0, 2)
                           + torch.where(ok_finite, 0, 4)).to(torch.int32)
    else:
        num_assert_fail = torch.zeros((), dtype=torch.int32, device=dev)

    # ---- solver-level local-infeasibility stall test ------------------
    # (trial_point.c:450-485): an infeasible iterate with (numerically)
    # zero LP and trial steps cannot move; hand over to restoration
    locally_infeasible = mid.locally_infeasible
    if m > 0:
        li_stall = ((~h.is_feasible) & (torch.linalg.norm(cres.lp_step) <= settings.eps)
                    & (torch.linalg.norm(trial_dir.primal) <= settings.eps))
        locally_infeasible = locally_infeasible | li_stall

    # ---- early termination: keep the (duals-updated) iterate ----------
    stop = mid.optimal | mid.unbounded | locally_infeasible | mid.deadpoint

    def stopped():
        stop_status = torch.where(
            mid.optimal, int(Status.OPTIMAL),
            torch.where(mid.unbounded, int(Status.UNBOUNDED),
                        torch.where(locally_infeasible, int(Status.INFEASIBLE),
                                    int(Status.ABORT_DEADPOINT)))).to(torch.int32)
        return dataclasses.replace(
            state, it=it, status=stop_status, feas_res=mid.feas_res, slack_res=mid.slack_res,
            stat_res=mid.stat_res, basis=cres.basis,
            num_assert_fail=state.num_assert_fail | num_assert_fail)

    if not lanes_any(~stop):
        return stopped()
    # lanes that stop go on through the trial point with the others and
    # take their stopped state at the end (and so does a read-free
    # iteration)
    stop_state = stopped() if is_batched(stop) or is_device_resident() else None

    # ---- trial evaluation + step rule ---------------------------------
    x_trial = problem.clip_to_bounds(it.x + trial_dir.primal)
    if isinstance(problem.func, DynFunc):
        t_obj, t_grad, t_cons, t_jac, trial_err = problem.func.eval_all_dyn(
            x_trial, state.error_bound, penalty)
        trial_it = Iterate(
            x=x_trial, obj_val=t_obj, obj_grad=t_grad, cons_val=t_cons, cons_jac=t_jac,
            cons_dual=torch.zeros((m,), dtype=dtype, device=dev),
            vars_dual=torch.zeros((n,), dtype=dtype, device=dev),
            var_states=torch.zeros((n,), dtype=torch.int8, device=dev),
            cons_states=torch.zeros((m,), dtype=torch.int8, device=dev))
    else:
        trial_it = create_iterate(problem, x_trial)
        trial_err = torch.zeros((), dtype=dtype, device=dev)
    exact_trial = merit_func(data, trial_it, penalty)
    accepted, ratio, sr_accept, sr_reject = apply_step_rule(
        settings.step_rule, state.step_rule, merit_val, exact_trial, model_trial,
        settings.accepted_reduction)
    # manual / non-finite trial rejection
    trial_valid = _trial_ok(problem, x_trial, trial_it)
    accepted = accepted & trial_valid
    ratio = torch.where(trial_valid, ratio, -1.0)

    # ---- dynamic accuracy gate (trial_point.c:797-905) ----------------
    # an insufficiently accurate evaluation cannot be trusted by the step
    # rule: reject and tighten the bound; the next iteration re-evaluates
    error_bound_next = state.error_bound
    skip_soc = false
    if isinstance(problem.func, DynFunc):
        required = required_error_bound(settings.accepted_reduction,
                                        torch.clamp(merit_val - model_trial, min=0.0))
        skip_soc = torch.maximum(h.iterate_err, trial_err) > required
        accepted = accepted & ~skip_soc
        error_bound_next = torch.where(skip_soc, torch.minimum(state.error_bound, required),
                                       state.error_bound)

    chosen_it = trial_it
    soc_accepted = false
    sr_soc = sr_reject

    # ---- second-order correction (iteration.c:484-560) ----------------
    needs_soc = ~(accepted | skip_soc)
    if m > 0 and settings.perform_soc and lanes_any(needs_soc):
        # bound residuals of the working set at the trial point
        trial_like = dataclasses.replace(it, x=trial_it.x, cons_val=trial_it.cons_val)
        soc_dir = solve_min_norm(mid.aug_jac, _working_set_rhs(data, trial_like))
        soc_primal = trial_dir.primal + soc_dir
        norm_ok = torch.linalg.norm(soc_primal) <= SOC_SAFEGUARD_FACTOR * state.trust_radius
        x_soc = problem.clip_to_bounds(it.x + soc_primal)
        soc_it = create_iterate(problem, x_soc)
        soc_exact = merit_func(data, soc_it, penalty)
        soc_ok, soc_ratio, sr_soc, _ = apply_step_rule(
            settings.step_rule, sr_reject, merit_val, soc_exact, model_trial,
            settings.accepted_reduction)
        # the SOC trial point gets its own manual/non-finite rejection
        soc_valid = _trial_ok(problem, x_soc, soc_it)
        soc_accepted = needs_soc & norm_ok & soc_ok & soc_valid
        soc_ratio = torch.where(soc_valid, soc_ratio, -1.0)
        chosen_it = tree_where(soc_accepted, soc_it, trial_it)
        ratio = torch.where(soc_accepted, soc_ratio, ratio)

    final_accept = accepted | soc_accepted
    sr_next = tree_where(accepted, sr_accept, tree_where(soc_accepted, sr_soc, sr_reject))

    # ---- trust-radius updates -----------------------------------------
    trial_step_norm = torch.linalg.norm(trial_dir.primal)
    trial_step_infnorm = max0(trial_dir.primal.abs())
    cauchy_step_infnorm = max0(c.cauchy_dir.primal.abs())
    new_trust_radius = _update_trust_radius(state.trust_radius, ratio, final_accept,
                                            trial_step_norm, settings.eps)
    new_lp_trust_radius = _update_lp_trust_radius(c.lp_tr_current, final_accept,
                                                  trial_step_infnorm, cauchy_step_infnorm,
                                                  c.full_cauchy)
    # accuracy-driven rejections refine the evaluation, not the step: the
    # radii stay
    new_trust_radius = torch.where(skip_soc, state.trust_radius, new_trust_radius)
    new_lp_trust_radius = torch.where(skip_soc, c.lp_tr_current, new_lp_trust_radius)
    boundary_step = trial_step_norm >= state.trust_radius * (1.0 - settings.eps)

    step_type = torch.where(
        final_accept,
        torch.where(soc_accepted, int(StepType.ACCEPTED_SOC),
                    torch.where(c.full_cauchy, int(StepType.ACCEPTED_FULL),
                                int(StepType.ACCEPTED))),
        int(StepType.REJECTED)).to(torch.int32)

    use_qn = settings.hess_eval != HessEval.EXACT
    out = SolverState(
        it=tree_where(final_accept, chosen_it, it),
        trust_radius=new_trust_radius,
        lp_trust_radius=new_lp_trust_radius,
        penalty=penalty,
        basis=cres.basis,
        iteration=state.iteration + 1,
        status=torch.full((), int(Status.RUNNING), dtype=torch.int32, device=dev),
        last_step_type=step_type,
        num_feasible_steps=h.num_feasible_steps.to(torch.int32),
        num_global_resets=h.num_global_resets,
        num_accepted=state.num_accepted + (final_accept & ~soc_accepted).to(torch.int32),
        num_soc_accepted=state.num_soc_accepted + soc_accepted.to(torch.int32),
        num_rejected=state.num_rejected + (~final_accept).to(torch.int32),
        num_failed_eqp=state.num_failed_eqp + t.failed_eqp.to(torch.int32),
        feas_res=mid.feas_res,
        slack_res=mid.slack_res,
        stat_res=mid.stat_res,
        min_rayleigh=t.min_ray,
        max_rayleigh=t.max_ray,
        lp_iterations=state.lp_iterations + cres.lp_iterations,
        boundary_step=boundary_step,
        # the pre-step point for the next pair, pushed next iteration once
        # the new duals are known
        qn=mid.qn,
        qn_prev=(QNPrev(x=torch.where(final_accept, it.x, state.qn_prev.x),
                        grad=torch.where(final_accept, it.obj_grad, state.qn_prev.grad),
                        jac=torch.where(final_accept, it.cons_jac, state.qn_prev.jac),
                        pending=final_accept)
                 if use_qn else state.qn_prev),
        step_rule=sr_next,
        error_bound=error_bound_next,
        error_est=torch.where(final_accept, trial_err, h.iterate_err),
        refresh_eval=skip_soc,
        last_model_reduction=merit_val - model_trial,
        last_exact_reduction=merit_val - exact_trial,
        last_reduction_ratio=ratio,
        measure=compute_measure(data, it, trial_it, trial_dir, mid.multipliers),
        num_assert_fail=state.num_assert_fail | num_assert_fail,
    )
    return out if stop_state is None else tree_where(stop, stop_state, out)


def perform_iteration(problem: Problem, settings: Settings, state: SolverState) -> SolverState:
    """One SQP iteration (problem_solver/iteration.c:350-601) on the
    problem's device, eagerly: its loops read as they go."""
    data = problem.data
    n, m = problem.num_variables, problem.num_cons
    dtype, dev = problem.dtype, problem.device
    true = torch.ones((), dtype=torch.bool, device=dev)
    cdtype = _compute_dtype(settings, dtype)
    h = _head(problem, settings, state)

    # ---- Cauchy LP step -----------------------------------------------
    if m > 0:
        lp_backend = resolved_lp_solver(settings, n, m)
        cres = solve_cauchy_lp(
            data, h.it, state.lp_trust_radius, h.penalty, state.basis,
            settings_eps=settings.eps, lp_resolves=settings.lp_resolves,
            dual_warm_start=settings.lp_dual_warm_start, lp_solver=lp_backend,
            pdlp_tol=settings.pdlp_tol, compute_dtype=cdtype)
        # Byrd penalty update when infeasible (cauchy_step.c:80-88)
        infeasible = ~h.is_feasible
        if lanes_any(infeasible):
            pen_new, cres_new, pen_changed = update_penalty(
                data, h.it, state.lp_trust_radius, h.penalty, cres, lp_solver=lp_backend,
                pdlp_tol=settings.pdlp_tol, compute_dtype=cdtype)
            h, cres = _with_penalty(data, h, infeasible, pen_new, cres_new, pen_changed, cres)
    else:
        cres = solve_box_cauchy(data, h.it, state.lp_trust_radius)

    mid = _mid(problem, settings, state, h, cres)
    hess_prod = _hess_prod(problem, settings, state, h, mid)

    # ---- Cauchy direction + linesearch (or the parametric sweep) ------
    if _uses_sweep(problem, settings):
        cres, lp_tr_current, cauchy_dir, cauchy_merit = parametric_solve(
            settings.parametric_cauchy, data, mid.it, hess_prod, h.penalty,
            state.lp_trust_radius, cres, settings.cauchy_eta, settings.eps,
            lp_solver=lp_backend, pdlp_tol=settings.pdlp_tol, compute_dtype=cdtype)
        mid = _after_sweep(problem, settings, state, h, mid, cres)
        hess_prod = _hess_prod(problem, settings, state, h, mid)
        c = _Cauchy(cres, lp_tr_current, cauchy_dir, true, cauchy_merit)
    else:
        cauchy_dir = make_direction(mid.it, cres.lp_step, hess_prod(cres.lp_step))
        if settings.use_quadratic_model:
            cauchy_dir, full_cauchy, cauchy_merit = cauchy_linesearch(
                data, mid.it, cauchy_dir, h.penalty, state.trust_radius, settings.cauchy_tau,
                settings.cauchy_eta, settings.eps)
        else:
            full_cauchy = true
            cauchy_merit = merit_linear(data, mid.it, cauchy_dir, h.penalty)
        c = _Cauchy(cres, state.lp_trust_radius, cauchy_dir, full_cauchy, cauchy_merit)

    # ---- Newton/EQP step + trial linesearch ---------------------------
    # Gauss-Newton + LSQR for an LSQ function with exact Hessians, the
    # projected Newton step otherwise (eqp.c)
    route = _newton_route(problem, settings)
    if route == "none":
        t = _no_newton(c, dtype, dev)
    else:
        if route == "gauss_newton":
            newton = compute_gauss_newton_step(problem, data, mid.it, mid.aug_jac, mid.ws,
                                               h.penalty, settings.max_newton_iterations)
        else:
            newton = compute_newton_step(
                data, mid.it, mid.aug_jac, mid.ws, hess_prod, h.penalty,
                settings.max_newton_iterations, use_gltr=route == "gltr", compute_dtype=cdtype,
                hess_prod_compute=_hess_prod_compute(problem, settings, mid, cdtype))
        if settings.linesearch == Linesearch.EXACT:
            trial_dir, alpha, model_trial = trial_linesearch_exact(
                data, mid.it, c.cauchy_dir, c.cauchy_merit, newton.direction, h.penalty,
                settings.linesearch_cutoff)
        else:
            trial_dir, alpha, model_trial = trial_linesearch(
                data, mid.it, c.cauchy_dir, c.cauchy_merit, newton.direction, h.penalty,
                settings.linesearch_tau, settings.linesearch_eta, settings.linesearch_cutoff)
        t = _Trial(trial_dir, model_trial, alpha == 0.0, newton.tr.min_rayleigh,
                   newton.tr.max_rayleigh)
    return _tail(problem, settings, state, h, mid, c, t, hess_prod)


def solve_from(problem: Problem, settings: Settings, state: SolverState,
               max_iterations: int) -> SolverState:
    """Iterate from ``state`` while the status is RUNNING and the iteration
    count is below ``max_iterations`` (solve.c:95-252), eagerly, reading as
    it goes; a solve that reaches the limit ends ABORT_ITER.  It is the
    oracle of ``solve_jit``.  Under ``vmap`` the lanes iterate in lockstep
    until every one has stopped."""

    def running(s):
        return (s.status == int(Status.RUNNING)) & (s.iteration < max_iterations)

    state = lockstep(running, lambda s, trip: perform_iteration(problem, settings, s), state)
    status = torch.where(state.status == int(Status.RUNNING), int(Status.ABORT_ITER), state.status)
    return dataclasses.replace(state, status=status.to(torch.int32))


# ---- the solve as device programs (solve_jit) -----------------------------

# A linesearch's first GRAPH_TRIALS trials run inside the program that
# starts it, the rest, while it goes on, in blocks of TRIAL_BLOCK masked
# trials, one read a block; together the linesearch's MAX_TRIALS.  A Krylov
# solve (Steihaug CG, LSQR) runs in blocks of KRYLOV_BLOCK masked steps and
# GLTR in blocks of GLTR_BLOCK Lanczos steps (a program for each block:
# the step's shapes grow with its index), the first inside the program
# that starts the solve.  Sized by the CPU's counts on chip_smoke.py's
# phase 7 and 8 problems (tools/dense_loop_counts.py): a Cauchy linesearch
# ends within 6 trials 88% of the time, a trial linesearch within 1 63%
# and at its vanishing step, 20 trials, most of the rest; GLTR within 2
# steps 99%, Steihaug CG within 1, LSQR within 29.
GRAPH_TRIALS = 6
TRIAL_BLOCK = 15
_TRIAL_BLOCKS, _LEFT = divmod(MAX_TRIALS - GRAPH_TRIALS, TRIAL_BLOCK)
assert _LEFT == 0, "the trial blocks must end at the linesearch's cap"
KRYLOV_BLOCK = 4
GLTR_BLOCK = 2


def _lp_graph(problem: Problem, settings: Settings):
    """The Cauchy LPs' programs (``cauchy.LPGraph``), or None without
    general or linear rows."""
    n, m = problem.num_variables, problem.num_cons
    if m == 0:
        return None
    return LPGraph(problem.data, n, m, problem.dtype, resolved_lp_solver(settings, n, m),
                   settings.eps, settings.pdlp_tol, _compute_dtype(settings, problem.dtype))


def _programs(problem: Problem, settings: Settings, lp) -> dict:
    """The read-free programs of one iteration, by name, on a dict of
    buffers (``state`` and ``max_it``, and what the programs write: the
    head ``H``, the Cauchy result ``cres``, the penalty loop ``pen``, the
    working set ``M``, the sweep ``par``, the Cauchy linesearch ``cl`` and
    ``cl.s``, the Cauchy step ``C``, the Krylov solve ``kr``, ``kr.aug``
    and ``kr.s``, the Newton direction ``N``, the trial linesearch ``tl``
    and ``tl.s`` or the EXACT rule's trial ``T``, the LPs' ``lp.*`` and
    ``red.*``, and ``flag``).  In order:

    * ``it.head``: the dynamic refresh (selected), feasibility, penalty
      reset and merit, and the Cauchy LP's start (the whole LP where it is
      enumerated; bit WARM_DUAL or LP), then the LP's programs;
    * ``pen.check`` (bit PENALTY: the update runs), ``pen.feas`` (the
      feasibility LP's start), ``pen.keep`` (PENALTY: the penalty rises),
      ``pen.inc``/``pen.trip`` (an increase's LP and its test, PENALTY: it
      rises again), ``pen.end``;
    * ``it.mid``: the working set, duals, residuals, the quasi-Newton push
      (selected) and the working step; then the parametric sweep's start
      (bit FORWARD) or the Cauchy linesearch's first GRAPH_TRIALS trials
      (SEARCHING); ``cl.block``, ``cl.end``; ``par.lp.fwd``/``par.fwd``,
      ``par.lp.back``/``par.back`` (a sweep trip's LP and its update, bit
      SWEEP: the sweep goes on), ``par.end``;
    * ``it.newton``: the EQP gradient and the Krylov solve's start and
      first block (bit CG); ``kr.cg``, ``kr.lsqr``, ``kr.gltr.<k>`` (the
      GLTR block from Lanczos step k);
    * ``it.trial``: the Newton direction and the trial linesearch's first
      trials (SEARCHING); ``tl.block``;
    * ``it.tail``: the invariant checks, the stop test (selected), the
      trial point, step rule, second-order correction (selected) and the
      updates (bit RUNNING)."""
    data = problem.data
    n, m = problem.num_variables, problem.num_cons
    dtype, dev = problem.dtype, problem.device
    cdtype = _compute_dtype(settings, dtype)
    route = _newton_route(problem, settings)
    sweep = _uses_sweep(problem, settings)
    exact_ls = settings.linesearch == Linesearch.EXACT
    max_newton = settings.max_newton_iterations
    K = gltr_size(n, max_newton)
    progs = lp.programs() if lp is not None else {}

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)

    def bit(b, cond):
        return b * cond.to(torch.int32)

    def head(b):
        state = b["state"]
        with device_resident():
            h = _head(problem, settings, state)
            if lp is None:
                return {"H": h, "cres": solve_box_cauchy(data, h.it, state.lp_trust_radius),
                        "flag": zero()}
            return {"H": h, **lp.setup(h.it, state.lp_trust_radius, h.penalty, state.basis,
                                       dual_warm_start=settings.lp_dual_warm_start,
                                       eps=settings.eps)}

    progs["it.head"] = head

    # ---- the Byrd penalty update (penalty.update_penalty) -------------
    def pen_check(b):
        h, cres = b["H"], b["lp.cres"]
        with device_resident():
            go = ~h.is_feasible & ~penalty_skip(cres, m)
        return {"cres": cres, "flag": bit(PENALTY, go)}

    def pen_feas(b):
        h, cres = b["H"], b["cres"]
        with device_resident():
            return lp.setup(h.it, b["state"].lp_trust_radius, h.penalty, cres.basis,
                            feasibility_mode=True)

    def pen_keep(b):
        cres = b["cres"]
        with device_resident():
            keep, achievable, inf_viol = penalty_keep(cres, b["lp.cres"], m)
        return {"pen": dict(pen=b["H"].penalty, cres=cres, keep=keep, achievable=achievable,
                            inf_viol=inf_viol),
                "flag": bit(PENALTY, ~keep)}

    def pen_inc(b):
        h, s = b["H"], b["pen"]
        with device_resident():
            return lp.setup(h.it, b["state"].lp_trust_radius, s["pen"] * PENALTY_INCREASE,
                            s["cres"].basis)

    def pen_trip(b):
        s, res = b["pen"], b["lp.cres"]
        with device_resident():
            ok = penalty_ok(b["cres"], res, s["achievable"], s["inf_viol"], m)
        return {"pen": dict(s, pen=s["pen"] * PENALTY_INCREASE, cres=res),
                "flag": bit(PENALTY, ~ok)}

    def pen_end(b):
        h, s = b["H"], b["pen"]
        with device_resident():
            h, cres = _with_penalty(data, h, ~h.is_feasible, s["pen"], s["cres"], ~s["keep"],
                                    b["cres"])
        return {"H": h, "cres": cres}

    if lp is not None:
        progs.update({"pen.check": pen_check, "pen.feas": pen_feas, "pen.keep": pen_keep,
                      "pen.inc": pen_inc, "pen.trip": pen_trip, "pen.end": pen_end})

    # ---- the working set and the Cauchy step --------------------------
    def hess_of(b, mid=None):
        return _hess_prod(problem, settings, b["state"], b["H"], b["M"] if mid is None else mid)

    def sweep_of(b):
        h, mid = b["H"], b["M"]
        return Sweep(settings.parametric_cauchy, data, mid.it, hess_of(b), h.penalty,
                     settings.cauchy_eta, settings.eps)

    def cauchy_body(b):
        h, mid = b["H"], b["M"]
        cdir, cs = b["cl"]
        return cauchy_trial(data, mid.it, cdir, h.penalty, cs, settings.cauchy_tau,
                            settings.cauchy_eta, settings.eps)

    def mid_prog(b):
        state, h, cres = b["state"], b["H"], b["cres"]
        with device_resident():
            mid = _mid(problem, settings, state, h, cres)
            hess_prod = _hess_prod(problem, settings, state, h, mid)
            if sweep:
                s0, sufficient0 = Sweep(settings.parametric_cauchy, data, mid.it, hess_prod,
                                        h.penalty, settings.cauchy_eta,
                                        settings.eps).begin(state.lp_trust_radius, cres)
                return {"M": mid, "par": dict(s0, done=~sufficient0),
                        "flag": bit(FORWARD, sufficient0)}
            cauchy_dir = make_direction(mid.it, cres.lp_step, hess_prod(cres.lp_step))
            if not settings.use_quadratic_model:
                true = torch.ones((), dtype=torch.bool, device=dev)
                return {"M": mid, "C": _Cauchy(cres, state.lp_trust_radius, cauchy_dir, true,
                                               merit_linear(data, mid.it, cauchy_dir, h.penalty)),
                        "flag": zero()}
            cs, s = cauchy_search(data, mid.it, cauchy_dir, state.trust_radius)
            body = cauchy_trial(data, mid.it, cauchy_dir, h.penalty, cs, settings.cauchy_tau,
                                settings.cauchy_eta, settings.eps)
            s = lockstep(lambda s: ~s[1], body, s, max_trips=GRAPH_TRIALS, first=True)
        return {"M": mid, "cl": (cauchy_dir, cs), "cl.s": s, "flag": bit(SEARCHING, ~s[1])}

    def cl_block(b):
        with device_resident():
            s = lockstep(lambda s: ~s[1], cauchy_body(b), b["cl.s"], max_trips=TRIAL_BLOCK)
        return {"cl.s": s, "flag": bit(SEARCHING, ~s[1])}

    def cl_end(b):
        state, h, mid = b["state"], b["H"], b["M"]
        cdir, cs = b["cl"]
        with device_resident():
            scaled, full, merit = cauchy_result(data, mid.it, cdir, h.penalty, cs, b["cl.s"][0])
        return {"C": _Cauchy(b["cres"], state.lp_trust_radius, scaled, full, merit)}

    def par_lp(grow):
        def run(b):
            h, mid, s = b["H"], b["M"], b["par"]
            with device_resident():
                sw = sweep_of(b)
                factor = sw.increase if grow else sw.decrease
                return lp.setup(mid.it, s["radius"] * factor, h.penalty, s["cres"].basis,
                                eps=settings.eps)

        return run

    def par_trip(grow):
        def run(b):
            with device_resident():
                sw = sweep_of(b)
                s = (sw.forward if grow else sw.backtrack)(b["par"], b["lp.cres"])
            return {"par": s, "flag": bit(SWEEP, ~s["done"])}

        return run

    def par_end(b):
        state, h, s = b["state"], b["H"], b["par"]
        with device_resident():
            mid = _after_sweep(problem, settings, state, h, b["M"], s["cres"])
            true = torch.ones((), dtype=torch.bool, device=dev)
        return {"M": mid, "C": _Cauchy(s["cres"], s["radius"], s["direction"], true, s["quad"])}

    progs["it.mid"] = mid_prog
    if sweep:
        progs.update({"par.lp.fwd": par_lp(True), "par.fwd": par_trip(True),
                      "par.lp.back": par_lp(False), "par.back": par_trip(False),
                      "par.end": par_end})
    elif settings.use_quadratic_model:
        progs.update({"cl.block": cl_block, "cl.end": cl_end})

    # ---- the EQP step: a Krylov solve in blocks -----------------------
    def krylov_ops(b):
        """(hess_prod, the Krylov loop's Hessian operator) from the
        buffers."""
        mid = b["M"]
        hess_prod = hess_of(b)
        hp_c = _hess_prod_compute(problem, settings, mid, cdtype)
        if hp_c is None and cdtype is not None:
            def hp_c(d):
                return hess_prod(d.to(dtype)).to(cdtype)
        return hess_prod, hp_c or hess_prod

    def krylov_block(b, s, first: int, trips: int):
        """``trips`` Krylov steps from ``s``, the first of index ``first``."""
        mid, setup = b["M"], b["kr"]
        if route == "gauss_newton":
            forward, adjoint, _ = gauss_newton_start(problem, data, mid.it, mid.aug_jac, mid.ws,
                                                     b["H"].penalty)
            s = lockstep(lambda s: lsqr_running(s, max_newton),
                         lsqr_body(forward, adjoint, setup), s, max_trips=trips)
            return s, lsqr_running(s, max_newton)
        _, hp_c = krylov_ops(b)
        aug_c = b["kr.aug"]
        if route == "cg":
            s = lockstep(lambda s: cg_running(s, max_newton), cg_body(hp_c, aug_c, setup), s,
                         max_trips=trips)
            return s, cg_running(s, max_newton)
        body = gltr_body(hp_c, aug_c, setup, K)
        s = lockstep(lambda s: ~s["done"], lambda s, trip: body(s, first + trip), s,
                     max_trips=trips)
        return s, ~s["done"]

    def newton_prog(b):
        mid, h = b["M"], b["H"]
        with device_resident():
            if route == "gauss_newton":
                _, adjoint, rhs = gauss_newton_start(problem, data, mid.it, mid.aug_jac, mid.ws,
                                                     h.penalty)
                setup, s = lsqr_start(adjoint, rhs, mid.ws.reduced_trust_radius, n)
                out, trips = {"kr": setup}, min(KRYLOV_BLOCK, max_newton)
            else:
                hess_prod, _ = krylov_ops(b)
                gradient = newton_gradient(mid.it, mid.ws, hess_prod, h.penalty)
                aug_c, grad_c, rad_c, p0 = krylov_inputs(mid.aug_jac, gradient, mid.ws,
                                                         cdtype or dtype)
                if route == "cg":
                    setup, s = cg_start(aug_c, grad_c, rad_c, p0=p0)
                    trips = min(KRYLOV_BLOCK, max_newton)
                else:
                    setup, s = gltr_start(aug_c, grad_c, rad_c, max_newton, p0=p0)
                    trips = min(GLTR_BLOCK, K)
                out = {"kr": setup, "kr.aug": aug_c}
            s, going = krylov_block(dict(b, **out), s, 0, trips)
        return {**out, "kr.s": s, "flag": bit(CG, going)}

    def kr_block(first: int, trips: int):
        def run(b):
            with device_resident():
                s, going = krylov_block(b, b["kr.s"], first, trips)
            return {"kr.s": s, "flag": bit(CG, going)}

        return run

    def trial_prog(b):
        mid, h, C, s = b["M"], b["H"], b["C"], b["kr.s"]
        with device_resident():
            if route == "gauss_newton":
                newton = gauss_newton_result(problem, mid.it, mid.aug_jac, mid.ws, s[2], s[8])
            else:
                hess_prod, _ = krylov_ops(b)
                tr = gltr_result(b["kr"], s) if route == "gltr" else cg_result(s)
                newton = newton_result(mid.it, mid.ws, tr, hess_prod)
            ray = (newton.tr.min_rayleigh, newton.tr.max_rayleigh)
            if exact_ls:
                return {"T": _trial_from(settings, data, mid, C, newton.direction, h.penalty,
                                         *ray), "flag": zero()}
            ts, s = trial_search(data, mid.it, C.cauchy_dir, newton.direction,
                                 settings.linesearch_cutoff)
            s = lockstep(lambda s: ~s[1], trial_body(b, newton.direction, ts), s,
                         max_trips=GRAPH_TRIALS)
        return {"N": (newton.direction, *ray), "tl": ts, "tl.s": s,
                "flag": bit(SEARCHING, ~s[1])}

    def trial_body(b, newton_dir, ts):
        mid, h, C = b["M"], b["H"], b["C"]
        return trial_trial(data, mid.it, C.cauchy_dir, C.cauchy_merit, newton_dir, h.penalty,
                           ts, settings.linesearch_tau, settings.linesearch_eta,
                           settings.linesearch_cutoff)

    def tl_block(b):
        with device_resident():
            s = lockstep(lambda s: ~s[1], trial_body(b, b["N"][0], b["tl"]), b["tl.s"],
                         max_trips=TRIAL_BLOCK)
        return {"tl.s": s, "flag": bit(SEARCHING, ~s[1])}

    def tail_prog(b):
        state, h, mid, C = b["state"], b["H"], b["M"], b["C"]
        with device_resident():
            if route == "none":
                t = _no_newton(C, dtype, dev)
            elif exact_ls:
                t = b["T"]
            else:
                newton_dir, min_ray, max_ray = b["N"]
                t = _trial_from(settings, data, mid, C, newton_dir, h.penalty, min_ray, max_ray,
                                (b["tl"], b["tl.s"][0]))
            out = _tail(problem, settings, state, h, mid, C, t, hess_of(b))
        return {"state": out, "flag": bit(RUNNING, graphs.running(out, b["max_it"]))}

    if route != "none":
        progs.update({"it.newton": newton_prog, "it.trial": trial_prog})
        if route == "gltr":
            progs.update({f"kr.gltr.{k}": kr_block(k, min(GLTR_BLOCK, K - k))
                          for k in range(GLTR_BLOCK, K, GLTR_BLOCK)})
        else:
            progs[f"kr.{'lsqr' if route == 'gauss_newton' else 'cg'}"] = kr_block(0, KRYLOV_BLOCK)
        if not exact_ls:
            progs["tl.block"] = tl_block
    progs["it.tail"] = tail_prog
    return progs


def _capture_hint(problem: Problem) -> str:
    func = problem.func
    fields = [(name, getattr(func, attr, None))
              for name, attr in (("obj", "_obj"), ("cons", "_cons"), ("obj_grad", "_obj_grad"),
                                 ("cons_jac", "_cons_jac"), ("hess_prod", "_hess_prod"),
                                 ("accept_point", "_accept_point"), ("residuals", "residuals"),
                                 ("eval_fn", "eval_fn"))]
    callables = ", ".join(f"{name}={getattr(f, '__qualname__', repr(f))}"
                          for name, f in fields if f is not None)
    return ("solve_jit: the iteration could not be captured as a CUDA graph; the problem's "
            f"callables ({callables}) run inside it and must neither read the card (.item(), "
            "bool(), .tolist(), .cpu()) nor copy host data to it (a tensor made from host "
            "values or moved from the CPU inside the callable)")


def solve_graphs(problem: Problem, settings: Settings, state0: SolverState,
                 max_iterations: int = 1000) -> Programs:
    """``solve_jit``'s programs for this problem, settings and the device,
    shapes and dtypes of ``state0``, made at the first call and cached on
    the problem.  On CUDA a program is captured when a solve first runs
    it (the penalty update's only once an iteration is infeasible, a
    refactorizing pivot block only once an LP reaches one)."""

    def make():
        dev = state0.it.x.device
        bufs = dict(state=tree_map(torch.clone, state0),
                    max_it=torch.full((), max_iterations, dtype=torch.int32, device=dev))
        return Programs(_programs(problem, settings, _lp_graph(problem, settings)), bufs,
                        graphs.on_graphs(dev), graphs.captured, graphs.LAUNCHES,
                        hint=_capture_hint(problem))

    return cached(problem, ("solve_jit", settings, *state_key(state0)), make)


def _lp_site(loop: Programs, lp, name: str, lp_resolves: bool, eps: float) -> None:
    """A caller's LP program, its read where the LP has a loop, and the
    LP's own programs."""
    loop.call(name)
    lp.run(loop, loop.flag() if lp.solver != LPSolver.ENUM else 0, lp_resolves, eps)


def _step(problem: Problem, settings: Settings, loop: Programs, lp) -> int:
    """One iteration on the programs; returns the last flag."""
    route = _newton_route(problem, settings)
    if lp is None:
        loop.call("it.head")
    else:
        _lp_site(loop, lp, "it.head", settings.lp_resolves, settings.eps)
        loop.call("pen.check")
        if loop.flag() & PENALTY:
            _lp_site(loop, lp, "pen.feas", False, DEFAULT_EPS)
            loop.call("pen.keep")
            if loop.flag() & PENALTY:
                for trip in range(MAX_INCREASES):
                    _lp_site(loop, lp, "pen.inc", False, DEFAULT_EPS)
                    loop.call("pen.trip")
                    # the eager loop reads no flag after its last increase
                    if trip == MAX_INCREASES - 1 or not loop.flag() & PENALTY:
                        break
                loop.call("pen.end")
    loop.call("it.mid")
    if _uses_sweep(problem, settings):
        tag = "fwd" if loop.flag() & FORWARD else "back"
        for _ in range(Sweep.resolves(settings.parametric_cauchy)):
            _lp_site(loop, lp, f"par.lp.{tag}", True, settings.eps)
            loop.call(f"par.{tag}")
            if not loop.flag() & SWEEP:
                break
        loop.call("par.end")
    elif settings.use_quadratic_model:
        if loop.flag() & SEARCHING:
            loop.repeat("cl.block", SEARCHING, _TRIAL_BLOCKS)
        loop.call("cl.end")
    if route != "none":
        loop.call("it.newton")
        if loop.flag() & CG:
            if route == "gltr":
                K = gltr_size(problem.num_variables, settings.max_newton_iterations)
                for k in range(GLTR_BLOCK, K, GLTR_BLOCK):
                    loop.call(f"kr.gltr.{k}")
                    if not loop.flag() & CG:
                        break
            else:
                name = "kr.lsqr" if route == "gauss_newton" else "kr.cg"
                loop.repeat(name, CG, -(-settings.max_newton_iterations // KRYLOV_BLOCK) - 1)
        loop.call("it.trial")
        if settings.linesearch != Linesearch.EXACT and loop.flag() & SEARCHING:
            loop.repeat("tl.block", SEARCHING, _TRIAL_BLOCKS)
    loop.call("it.tail")
    return loop.flag()


def solve_jit(problem: Problem, settings: Settings, state0: SolverState,
              max_iterations: int) -> SolverState:
    """The whole solve from ``state0`` as device programs
    (``sleqp_tpu/problem_solver.py::solve_jit``): on the card CUDA graphs
    (``solve_graphs``, cached on the problem: a second solve of the same
    problem, settings and shapes replays without a new capture), on the
    CPU the same programs eagerly.  The host reads a flag once before the
    first iteration and once after a program that ends a block of pivots,
    Krylov steps, linesearch trials or PDHG iterations, or a branch that
    guards an LP solve (the warm basis's dual stage, the polish's primal
    pass, the reduced re-solve, the penalty update, a sweep trip), or the
    iteration: no more reads than ``solve_from``, whose result it is, bit
    for bit.  A state still RUNNING at the end is ABORT_ITER.  A capture
    that fails raises."""
    loop = solve_graphs(problem, settings, state0, max_iterations)
    lp = _lp_graph(problem, settings)
    loop.load(state0, max_iterations)
    flag = loop.read(graphs.running(state0, loop.bufs["max_it"]).to(torch.int32))
    while flag & RUNNING:
        flag = _step(problem, settings, loop, lp)
    state = loop.result()
    status = torch.where(state.status == int(Status.RUNNING), int(Status.ABORT_ITER), state.status)
    return dataclasses.replace(state, status=status.to(torch.int32))


def solve(problem: Problem, settings: Settings, x0: Any, max_iterations: int = 1000,
          device: Any = None) -> SolverState:
    """The full solve from ``x0``: ``initial_state`` + ``solve_jit``, as the
    reference's ``solve``.  ``device=None`` means CUDA."""
    problem = problem.to(resolve_device(device))
    state = initial_state(problem, settings, x0, device=problem.device)
    return solve_jit(problem, settings, state, max_iterations)
