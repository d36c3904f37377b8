"""The SLP-EQP iteration (problem solver).

Port of ``sleqp_tpu/problem_solver.py`` (reference
src/main/problem_solver/{solve.c,iteration.c,trust_radius.c,step.c} and the
trial-point layer): one ``perform_iteration`` is

    LP (Cauchy) step -> penalty update -> working set + LSQ duals ->
    optimality test -> working step -> Newton/EQP step (GLTR or projected
    CG) -> Cauchy-Newton linesearch -> trial evaluation -> step rule ->
    optional second-order correction -> trust-radius and penalty updates.

The reference is one pure function jit-compiled into a ``lax.while_loop``.
Here the loop is eager: every tensor of the state stays on the problem's
device, and the host reads only the scalars that steer the loops and
branches (a pivot's state, a Krylov step's stop flag, a linesearch test,
the branch of the penalty update and of the second-order correction, and
whether the iteration stops).  Where the reference computes both sides and
selects with ``where``, the port selects with ``torch.where``, which takes
nothing (NaN or inf included) from the side it does not select; a stopping
iteration returns its stopped state without evaluating the trial point.

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
from typing import Any

import torch

from .cauchy import (
    CauchyBasis,
    _trim_duals,
    empty_basis,
    resolved_lp_solver,
    solve_box_cauchy,
    solve_cauchy_lp,
)
from .device import resolve_device
from .dyn import DynFunc, required_error_bound
from .gauss_newton import compute_gauss_newton_step
from .iterate import (
    Iterate,
    create_iterate,
    kkt_residuals,
    max0,
    max_violation,
)
from .lanes import is_batched, lanes_any, lanes_where, lockstep, tree_where
from .linesearch import cauchy_linesearch, trial_linesearch, trial_linesearch_exact
from .measure import Measure, compute_measure, empty_measure
from .merit import make_direction, merit_func, merit_linear, merit_quadratic
from .newton import _working_set_rhs, compute_newton_step, compute_working_step
from .ops.kkt import aug_jac_create, solve_lsq, solve_min_norm
from .parametric import parametric_solve
from .penalty import global_penalty_reset, update_penalty
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


def perform_iteration(problem: Problem, settings: Settings, state: SolverState) -> SolverState:
    """One SQP iteration (problem_solver/iteration.c:350-601) on the
    problem's device."""
    data = problem.data
    it = state.it
    n = problem.num_variables
    m = problem.num_cons
    dtype, dev = problem.dtype, problem.device
    true = torch.ones((), dtype=torch.bool, device=dev)
    false = ~true
    # mixed precision: the inner sequential solvers run in float32, the
    # certified quantities (residuals, duals, merit) in the state dtype
    cdtype = (torch.float32
              if settings.compute_dtype == "float32" and dtype != torch.float32 else None)

    # ---- dynamic functions: refresh the iterate at a tightened bound --
    is_dynamic = isinstance(problem.func, DynFunc)
    iterate_err = state.error_est
    if is_dynamic and lanes_any(state.refresh_eval):
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

    merit_val = merit_func(data, it, penalty)

    # ---- Cauchy LP step -----------------------------------------------
    if m > 0:
        lp_backend = resolved_lp_solver(settings, n, m)
        cres = solve_cauchy_lp(
            data, it, state.lp_trust_radius, penalty, state.basis,
            settings_eps=settings.eps, lp_resolves=settings.lp_resolves,
            dual_warm_start=settings.lp_dual_warm_start, lp_solver=lp_backend,
            pdlp_tol=settings.pdlp_tol, compute_dtype=cdtype)
        # Byrd penalty update when infeasible (cauchy_step.c:80-88)
        infeasible = ~is_feasible
        if lanes_any(infeasible):
            pen_new, cres_new, pen_changed = update_penalty(
                data, it, state.lp_trust_radius, penalty, cres, lp_solver=lp_backend,
                pdlp_tol=settings.pdlp_tol, compute_dtype=cdtype)
            merit_new = torch.where(pen_changed, merit_func(data, it, pen_new), merit_val)
            penalty, cres, merit_val = lanes_where(infeasible, (pen_new, cres_new, merit_new),
                                                   (penalty, cres, merit_val))
    else:
        cres = solve_box_cauchy(data, it, state.lp_trust_radius)

    # ---- working set + duals onto the iterate -------------------------
    it = dataclasses.replace(it, var_states=cres.var_states, cons_states=cres.cons_states)
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
    qn_blocks = problem.func.hess_struct
    use_qn = settings.hess_eval != HessEval.EXACT
    if use_qn and lanes_any(state.qn_prev.pending):
        prev = state.qn_prev
        grad_new = it.obj_grad + it.cons_jac.T @ it.cons_dual
        grad_old = prev.grad + prev.jac.T @ it.cons_dual
        pushed = qn_push(qn, it.x - prev.x, grad_new - grad_old, settings.hess_eval,
                         settings.bfgs_sizing != 0, blocks=qn_blocks)
        qn = lanes_where(prev.pending, pushed, qn)

    # ---- working step + EQP multipliers -------------------------------
    ws = compute_working_step(data, it, aug_jac, state.trust_radius, settings.eps)
    multipliers = it.cons_dual + penalty * ws.violated_mult

    if use_qn:
        def hess_prod(d):
            return qn_product(qn, d, settings.hess_eval, blocks=qn_blocks)
    elif is_dynamic:
        def hess_prod(d):
            return problem.func.hess_prod_dyn(it.x, d, multipliers[: problem.num_general],
                                              state.error_bound, penalty)
    else:
        def hess_prod(d):
            return problem.hess_prod(it.x, d, multipliers)

    # ---- Cauchy direction + linesearch (or the parametric sweep) ------
    lp_tr_current = state.lp_trust_radius
    if (m > 0 and settings.parametric_cauchy != ParametricCauchy.DISABLED
            and settings.use_quadratic_model):
        cres, lp_tr_current, cauchy_dir, cauchy_merit = parametric_solve(
            settings.parametric_cauchy, data, it, hess_prod, penalty, lp_tr_current, cres,
            settings.cauchy_eta, settings.eps, lp_solver=lp_backend,
            pdlp_tol=settings.pdlp_tol, compute_dtype=cdtype)
        # the working set at the accepted radius, and the KKT
        # factorization and working step on it (cauchy_step.c:205-231)
        it = dataclasses.replace(it, var_states=cres.var_states, cons_states=cres.cons_states)
        aug_jac = aug_jac_create(it.cons_jac, it.var_states, it.cons_states,
                                 method=_aug_jac_method(settings))
        ws = compute_working_step(data, it, aug_jac, state.trust_radius, settings.eps)
        multipliers = it.cons_dual + penalty * ws.violated_mult
        full_cauchy = true
    else:
        cauchy_dir = make_direction(it, cres.lp_step, hess_prod(cres.lp_step))
        if settings.use_quadratic_model:
            cauchy_dir, full_cauchy, cauchy_merit = cauchy_linesearch(
                data, it, cauchy_dir, penalty, state.trust_radius, settings.cauchy_tau,
                settings.cauchy_eta, settings.eps)
        else:
            full_cauchy = true
            cauchy_merit = merit_linear(data, it, cauchy_dir, penalty)

    # ---- Newton/EQP step + trial linesearch ---------------------------
    # Gauss-Newton + LSQR for an LSQ function with exact Hessians, the
    # projected Newton step otherwise (eqp.c)
    use_gauss_newton = (isinstance(problem.func, LSQFunc) and not use_qn
                        and settings.tr_solver in (TRSolver.AUTO, TRSolver.LSQR))
    if settings.perform_newton_step and settings.use_quadratic_model:
        if use_gauss_newton:
            newton = compute_gauss_newton_step(problem, data, it, aug_jac, ws, penalty,
                                               settings.max_newton_iterations)
        else:
            # AUTO picks GLTR unless the Hessian is declared PSD (newton.c:96-106)
            use_gltr = settings.tr_solver == TRSolver.GLTR or (
                settings.tr_solver == TRSolver.AUTO and not problem.func.psd_hessian)
            hess_prod_c = None
            if cdtype is not None and use_qn:
                # the ring buffer cast to float32
                qn_c = qn_astype(qn, cdtype)

                def hess_prod_c(d):
                    return qn_product(qn_c, d, settings.hess_eval, blocks=qn_blocks)
            elif cdtype is not None and not is_dynamic:
                # a natively float32 Hessian operator: the callables run at
                # the cast iterate, so the Krylov loop holds no float64
                # operation
                x_c = it.x.to(cdtype)
                problem.check_follows_dtype(x_c)
                mult_c = multipliers.to(cdtype)

                def hess_prod_c(d):
                    return problem.hess_prod(x_c, d, mult_c)

            newton = compute_newton_step(
                data, it, aug_jac, ws, hess_prod, penalty, settings.max_newton_iterations,
                use_gltr=use_gltr, compute_dtype=cdtype, hess_prod_compute=hess_prod_c)
        if settings.linesearch == Linesearch.EXACT:
            trial_dir, alpha, model_trial = trial_linesearch_exact(
                data, it, cauchy_dir, cauchy_merit, newton.direction, penalty,
                settings.linesearch_cutoff)
        else:
            trial_dir, alpha, model_trial = trial_linesearch(
                data, it, cauchy_dir, cauchy_merit, newton.direction, penalty,
                settings.linesearch_tau, settings.linesearch_eta, settings.linesearch_cutoff)
        failed_eqp = alpha == 0.0
        min_ray, max_ray = newton.tr.min_rayleigh, newton.tr.max_rayleigh
    else:
        trial_dir = cauchy_dir
        model_trial = cauchy_merit
        failed_eqp = false
        min_ray = torch.zeros((), dtype=dtype, device=dev)
        max_ray = torch.zeros((), dtype=dtype, device=dev)

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
    if m > 0:
        li_stall = ((~is_feasible) & (torch.linalg.norm(cres.lp_step) <= settings.eps)
                    & (torch.linalg.norm(trial_dir.primal) <= settings.eps))
        locally_infeasible = locally_infeasible | li_stall

    # ---- early termination: keep the (duals-updated) iterate ----------
    stop = optimal | unbounded | locally_infeasible | deadpoint

    def stopped():
        stop_status = torch.where(
            optimal, int(Status.OPTIMAL),
            torch.where(unbounded, int(Status.UNBOUNDED),
                        torch.where(locally_infeasible, int(Status.INFEASIBLE),
                                    int(Status.ABORT_DEADPOINT)))).to(torch.int32)
        return dataclasses.replace(
            state, it=it, status=stop_status, feas_res=feas_res, slack_res=slack_res,
            stat_res=stat_res, basis=cres.basis,
            num_assert_fail=state.num_assert_fail | num_assert_fail)

    if not lanes_any(~stop):
        return stopped()
    # lanes that stop go on through the trial point with the others and
    # take their stopped state at the end
    stop_state = stopped() if is_batched(stop) else None

    # ---- trial evaluation + step rule ---------------------------------
    x_trial = problem.clip_to_bounds(it.x + trial_dir.primal)
    if is_dynamic:
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
    if is_dynamic:
        required = required_error_bound(settings.accepted_reduction,
                                        torch.clamp(merit_val - model_trial, min=0.0))
        skip_soc = torch.maximum(iterate_err, trial_err) > required
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
        soc_dir = solve_min_norm(aug_jac, _working_set_rhs(data, trial_like))
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
    cauchy_step_infnorm = max0(cauchy_dir.primal.abs())
    new_trust_radius = _update_trust_radius(state.trust_radius, ratio, final_accept,
                                            trial_step_norm, settings.eps)
    new_lp_trust_radius = _update_lp_trust_radius(lp_tr_current, final_accept,
                                                  trial_step_infnorm, cauchy_step_infnorm,
                                                  full_cauchy)
    # accuracy-driven rejections refine the evaluation, not the step: the
    # radii stay
    new_trust_radius = torch.where(skip_soc, state.trust_radius, new_trust_radius)
    new_lp_trust_radius = torch.where(skip_soc, lp_tr_current, new_lp_trust_radius)
    boundary_step = trial_step_norm >= state.trust_radius * (1.0 - settings.eps)

    step_type = torch.where(
        final_accept,
        torch.where(soc_accepted, int(StepType.ACCEPTED_SOC),
                    torch.where(full_cauchy, int(StepType.ACCEPTED_FULL),
                                int(StepType.ACCEPTED))),
        int(StepType.REJECTED)).to(torch.int32)

    out = SolverState(
        it=tree_where(final_accept, chosen_it, it),
        trust_radius=new_trust_radius,
        lp_trust_radius=new_lp_trust_radius,
        penalty=penalty,
        basis=cres.basis,
        iteration=state.iteration + 1,
        status=torch.full((), int(Status.RUNNING), dtype=torch.int32, device=dev),
        last_step_type=step_type,
        num_feasible_steps=num_feasible_steps.to(torch.int32),
        num_global_resets=num_global_resets,
        num_accepted=state.num_accepted + (final_accept & ~soc_accepted).to(torch.int32),
        num_soc_accepted=state.num_soc_accepted + soc_accepted.to(torch.int32),
        num_rejected=state.num_rejected + (~final_accept).to(torch.int32),
        num_failed_eqp=state.num_failed_eqp + failed_eqp.to(torch.int32),
        feas_res=feas_res,
        slack_res=slack_res,
        stat_res=stat_res,
        min_rayleigh=min_ray,
        max_rayleigh=max_ray,
        lp_iterations=state.lp_iterations + cres.lp_iterations,
        boundary_step=boundary_step,
        # the pre-step point for the next pair, pushed next iteration once
        # the new duals are known
        qn=qn,
        qn_prev=(QNPrev(x=torch.where(final_accept, it.x, state.qn_prev.x),
                        grad=torch.where(final_accept, it.obj_grad, state.qn_prev.grad),
                        jac=torch.where(final_accept, it.cons_jac, state.qn_prev.jac),
                        pending=final_accept)
                 if use_qn else state.qn_prev),
        step_rule=sr_next,
        error_bound=error_bound_next,
        error_est=torch.where(final_accept, trial_err, iterate_err),
        refresh_eval=skip_soc,
        last_model_reduction=merit_val - model_trial,
        last_exact_reduction=merit_val - exact_trial,
        last_reduction_ratio=ratio,
        measure=compute_measure(data, it, trial_it, trial_dir, multipliers),
        num_assert_fail=state.num_assert_fail | num_assert_fail,
    )
    return out if stop_state is None else tree_where(stop, stop_state, out)


def solve_from(problem: Problem, settings: Settings, state: SolverState,
               max_iterations: int) -> SolverState:
    """Iterate from ``state`` while the status is RUNNING and the iteration
    count is below ``max_iterations`` (solve.c:95-252; the reference's
    ``solve_jit``); a solve that reaches the limit ends ABORT_ITER.  Under
    ``vmap`` the lanes iterate in lockstep until every one has stopped."""

    def running(s):
        return (s.status == int(Status.RUNNING)) & (s.iteration < max_iterations)

    state = lockstep(running, lambda s, trip: perform_iteration(problem, settings, s), state)
    status = torch.where(state.status == int(Status.RUNNING), int(Status.ABORT_ITER), state.status)
    return dataclasses.replace(state, status=status.to(torch.int32))


def solve(problem: Problem, settings: Settings, x0: Any, max_iterations: int = 1000,
          device: Any = None) -> SolverState:
    """The full solve from ``x0``: ``initial_state`` + ``solve_from``.
    ``device=None`` means CUDA."""
    problem = problem.to(resolve_device(device))
    state = initial_state(problem, settings, x0, device=problem.device)
    return solve_from(problem, settings, state, max_iterations)
