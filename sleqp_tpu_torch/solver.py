"""Top-level solver: scaling, presolve, restoration, callbacks, polishing.

Port of ``sleqp_tpu/solver.py`` (reference src/main/solver.c + solver/:
solve.c, phase.c, print.c, state.c, callback.c).  ``Solver(problem, x0,
settings).solve()`` runs on the CUDA card unless given ``device="cpu"``:

* the chain scaling -> preprocessing -> problem solver (solver.c:278),
  with the solution, duals and objective mapped back on the way out
  (solver/solve.c:270, restore.c);
* restoration-phase toggling on local infeasibility, at most
  ``MAX_PHASE_TOGGLES`` times (solver/solve.c:195-238, restoration.c);
* working-set polishing after the solve (solver/solve.c:283-287);
* the callbacks ACCEPTED_ITERATE / PERFORMED_ITERATION / FINISHED, with
  ``abort`` (pub_types.h:168-174, solver/callback.c), the time limit,
  the numerical asserts and the float-exception flags;
* the per-iteration log table and the final stats banner on the
  ``sleqp_tpu_torch`` logger at INFO (problem_solver/print.c,
  solver/print.c);
* the solution and state queries (pub_solver.h:26-100).

The reference has two loops, a fused ``lax.while_loop`` and a Python loop
for callbacks, time limits and logging, and takes the Python loop only when
one of those asks for it (``_needs_python_loop``).  So does the port: the
fused loop is ``problem_solver.solve_jit`` (on the card CUDA graphs, the
asserts and float flags checked once after it, as the reference does); the
Python loop is an eager loop with two host reads per iteration: the status
and the iteration before it, and the iteration, the step type, the assert
bitmask and the finiteness of the iterate's values after it.  The callbacks
fire at the reference's events in its order.  The restoration solves run
``solve_jit`` too.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from .device import resolve_device
from .iterate import (
    Iterate,
    create_iterate,
    max0,
    max_violation,
    slack_residual_values,
    stationarity_residuals,
    violation_values,
)
from .measure import format_measure
from .polish import polish_iterate
from .preprocessor import PreprocessingResult, preprocess
from .problem import Problem
from .problem_solver import (
    TRUST_REGION_FACTOR,
    SolverState,
    initial_state,
    perform_iteration,
    solve_from,
    solve_jit,
)
from .restoration import make_restoration_problem, restoration_initial_point, restoration_settings
from .scale import ScaledProblem, derive_scaling
from .settings import Settings
from .types import MathError, SolverPhase, Status, StepType

logger = logging.getLogger("sleqp_tpu_torch")

MAX_PHASE_TOGGLES = 10

_ACCEPTED = (StepType.ACCEPTED, StepType.ACCEPTED_FULL, StepType.ACCEPTED_SOC)


class SolverEvent(enum.IntEnum):
    """Callback events (pub_types.h:168-174)."""

    ACCEPTED_ITERATE = 0
    PERFORMED_ITERATION = 1
    FINISHED = 2


_HEADER = (
    f"{'iter':>6} {'obj':>14} {'merit':>14} {'feas':>9} {'slack':>9} "
    f"{'stat':>9} {'penalty':>9} {'lp_tr':>9} {'eqp_tr':>9} {'step':>9}"
)
_STEP_NAMES = {
    int(StepType.NONE): "-",
    int(StepType.ACCEPTED): "accepted",
    int(StepType.ACCEPTED_FULL): "full",
    int(StepType.ACCEPTED_SOC): "soc",
    int(StepType.REJECTED): "rejected",
}


def _float_flags_on(settings: Settings) -> bool:
    return settings.float_error_flags != "none" or settings.float_warning_flags != "none"


def _raise_or_warn_nonfinite(settings: Settings, state: SolverState, iteration: int) -> None:
    """Float-exception surveillance (math_error.h:33-63): non-finite
    obj/cons values at the iterate raise ``MathError`` under
    ``float_error_flags="nonfinite"`` and log a warning under
    ``float_warning_flags="nonfinite"``."""
    msg = (f"non-finite function values at iteration {iteration}: "
           f"obj={float(state.it.obj_val)!r}")
    if settings.float_error_flags == "nonfinite":
        raise MathError(msg)
    logger.warning(msg)


class Solver:
    """User-facing solver handle (reference SleqpSolver, pub_solver.h)."""

    def __init__(self, problem: Problem, x0, settings: Optional[Settings] = None, scaling=None,
                 device: Any = None):
        """``scaling`` composes power-of-two problem scaling into the
        chain: a ``scale.Scaling``, or ``"auto"`` to derive the weights
        from the derivatives at ``x0`` (scale.c:640-740).  ``device=None``
        means CUDA; the problem is moved there."""
        problem = problem.to(resolve_device(device))
        self.device = problem.device
        self.original_problem = problem
        self.settings = settings if settings is not None else Settings()
        self._preprocessed = None
        self._restored_iterate = None
        self._scaled_problem = None
        if scaling is not None:
            if isinstance(scaling, str):
                if scaling != "auto":
                    raise ValueError(f"unknown scaling mode {scaling!r}; expected a "
                                     "Scaling instance or 'auto'")
                scaling = derive_scaling(problem, x0)
            scaled = ScaledProblem(problem, scaling)
            x0 = scaled.scale_point(x0)
            problem = scaled
            self._scaled_problem = scaled
        self.scaling = scaling
        if self.settings.enable_preprocessor:
            pre = preprocess(problem)
            self._preprocessed = pre  # an INFEASIBLE result is kept: detected up front
            if pre.result == PreprocessingResult.SUCCESS:
                x0 = pre.reduce_point(x0)
                problem = pre.problem
        self.problem = problem
        self.x0 = torch.as_tensor(x0, dtype=problem.dtype, device=self.device)
        self.state: Optional[SolverState] = None
        self.status = Status.UNKNOWN
        self.phase = SolverPhase.OPTIMIZATION
        self.num_phase_toggles = 0
        self.elapsed_seconds = 0.0
        self._callbacks: dict[SolverEvent, list[Callable]] = {e: [] for e in SolverEvent}
        self._abort_requested = False
        self._restoration = None  # (problem, settings), made on first use

    # -- callbacks ------------------------------------------------------

    def add_callback(self, event: SolverEvent, fn: Callable) -> None:
        self._callbacks[SolverEvent(event)].append(fn)

    def remove_callback(self, event: SolverEvent, fn: Callable) -> None:
        self._callbacks[SolverEvent(event)].remove(fn)

    def abort(self) -> None:
        """Request termination from a callback (pub_solver.h:64)."""
        self._abort_requested = True

    # -- solve ----------------------------------------------------------

    def _needs_python_loop(self, time_limit) -> bool:
        """Whether the solve steps in the Python loop: a callback other
        than FINISHED, a time limit or INFO logging asks for it, or the
        problem's callables run on the host (``Func.runs_on_host``)."""
        return (any(self._callbacks[e] for e in SolverEvent if e != SolverEvent.FINISHED)
                or time_limit is not None or logger.isEnabledFor(logging.INFO)
                or self.original_problem.func.runs_on_host)

    def solve(self, max_iterations: int = 1000, time_limit: Optional[float] = None) -> Status:
        start = time.perf_counter()
        self._abort_requested = False
        self.num_phase_toggles = 0

        # presolve proved infeasibility (pub_types.h:176-181)
        if self._preprocessed is not None and self._preprocessed.problem is None:
            self.status = Status.INFEASIBLE
            self.state = None
            self.elapsed_seconds = time.perf_counter() - start
            for fn in self._callbacks[SolverEvent.FINISHED]:
                fn(self)
            return self.status

        state = initial_state(self.problem, self.settings, self.x0, device=self.device)
        python_loop = self._needs_python_loop(time_limit)
        while True:
            if python_loop:
                state = self._iterate(state, max_iterations, time_limit, start)
            else:
                state = self._solve_jit(state, max_iterations)
            status = Status(int(state.status))
            if (status != Status.INFEASIBLE or not self.settings.enable_restoration_phase
                    or self.problem.num_cons == 0 or self.num_phase_toggles >= MAX_PHASE_TOGGLES):
                break
            # ---- restoration phase (solver/solve.c:195-238) -----------
            state = self._run_restoration(state, max_iterations)
            self.num_phase_toggles += 1

        polished = polish_iterate(self.problem.data, state.it, self.settings.polishing_type,
                                  self.settings.eps)
        state = dataclasses.replace(state, it=polished)
        self.state = state
        self.status = Status(int(state.status))
        if self._preprocessed is not None:
            # map the reduced solution back (restore.c)
            self._restored_iterate = self._preprocessed.restore_iterate(state.it)
        self.elapsed_seconds = time.perf_counter() - start

        for fn in self._callbacks[SolverEvent.FINISHED]:
            fn(self)
        if logger.isEnabledFor(logging.INFO):
            self._print_stats()
        return self.status

    def _iterate(self, state: SolverState, max_iterations: int, time_limit, start) -> SolverState:
        """The eager loop, callbacks after each performed iteration
        (solver/callback.c)."""
        settings = self.settings
        logger.info(_HEADER)
        flags = _float_flags_on(settings)
        while True:
            status, iteration = torch.stack([state.status, state.iteration]).tolist()
            if status != Status.RUNNING:
                break
            if iteration >= max_iterations:
                state = self._with_status(state, Status.ABORT_ITER)
                break
            if time_limit is not None and time.perf_counter() - start > time_limit:
                state = self._with_status(state, Status.ABORT_TIME)
                break
            if self._abort_requested:
                state = self._with_status(state, Status.ABORT_MANUAL)
                break
            state = perform_iteration(self.problem, settings, state)
            self.state = state
            finite = (torch.isfinite(state.it.obj_val) & torch.isfinite(state.it.cons_val).all()
                      if flags else torch.ones((), dtype=torch.bool, device=self.device))
            new_iteration, step_type, assert_fail, is_finite = torch.stack([
                state.iteration, state.last_step_type, state.num_assert_fail,
                finite.to(torch.int32)]).tolist()
            if settings.num_asserts and assert_fail:
                raise MathError(assert_fail)
            if not is_finite:
                _raise_or_warn_nonfinite(settings, state, new_iteration)
            if new_iteration > iteration:
                self._log_iteration(state)
                for fn in self._callbacks[SolverEvent.PERFORMED_ITERATION]:
                    fn(self)
                if step_type in _ACCEPTED:
                    for fn in self._callbacks[SolverEvent.ACCEPTED_ITERATE]:
                        fn(self)
        return state

    def _solve_jit(self, state: SolverState, max_iterations: int) -> SolverState:
        """The fused loop (``solve_jit``), then the assert bitmask and the
        finiteness of the iterate's values, in one read."""
        settings = self.settings
        state = solve_jit(self.problem, settings, state, max_iterations)
        self.state = state
        finite = (torch.isfinite(state.it.obj_val) & torch.isfinite(state.it.cons_val).all()
                  if _float_flags_on(settings)
                  else torch.ones((), dtype=torch.bool, device=self.device))
        iteration, assert_fail, is_finite = torch.stack([
            state.iteration, state.num_assert_fail, finite.to(torch.int32)]).tolist()
        if settings.num_asserts and assert_fail:
            raise MathError(assert_fail)
        if not is_finite:
            _raise_or_warn_nonfinite(settings, state, iteration)
        return state

    @staticmethod
    def _with_status(state: SolverState, status: Status) -> SolverState:
        return dataclasses.replace(state, status=torch.full_like(state.status, int(status)))

    def _run_restoration(self, state: SolverState, max_iterations: int) -> SolverState:
        """Solve the restoration problem from the current iterate."""
        logger.info("Entering restoration phase")
        if self._restoration is None:
            self._restoration = (make_restoration_problem(self.problem),
                                 restoration_settings(self.settings))
        rest_problem, rs = self._restoration
        n = self.problem.num_variables
        z = restoration_initial_point(self.problem, state.it.x)
        # The reference leaves restoration when the original iterate is
        # feasible (solver/solve.c:214-231), not when the restoration LSQ
        # reaches its own stationarity: with tiny constraint Jacobians
        # ||J^T r|| passes stat_tol while the residual (the original
        # violation) is still large.  So the restoration tolerances tighten
        # and the solve goes on while its "optimum" leaves the original
        # infeasible.
        # the fused loop, but where the callables run on the host, which no
        # CUDA graph can call
        solve_loop = solve_from if self.original_problem.func.runs_on_host else solve_jit
        for _ in range(3):
            rest_state = solve_loop(rest_problem, rs,
                                    initial_state(rest_problem, rs, z, device=self.device),
                                    max_iterations)
            rest_status = Status(int(rest_state.status))
            x_restored = rest_state.it.x[:n]
            viol = float(max_violation(self.problem.data, self.problem.cons_val(x_restored)))
            if viol <= self.settings.feas_tol * 10 or rest_status not in (Status.OPTIMAL,
                                                                          Status.ABORT_ITER):
                break
            rs = rs.replace(stat_tol=rs.stat_tol * 1e-4, slack_tol=rs.slack_tol * 1e-4)
            z = rest_state.it.x

        if logger.isEnabledFor(logging.INFO):
            logger.info("Restoration finished with status %s (objective %.3e)",
                        rest_status.name, float(rest_state.it.obj_val))
        if viol > self.settings.feas_tol * 10:
            # the restoration converged, but the original stays infeasible
            logger.info("Restoration could not restore feasibility")
            return self._with_status(state, Status.INFEASIBLE)
        # Back to optimization (solver/phase.c:97-147): only the primal and
        # the function values are refreshed; duals, working set, LP bases
        # and the quasi-Newton memory survive the switch.  The radii start
        # afresh for the new region (problem_solver.c:83-107), and the
        # penalty grows tenfold a toggle: entering restoration means the
        # optimization stalled infeasible at this penalty, where the Byrd
        # update is blind (penalty-degenerate stalls, e.g. HS64).
        new_it = dataclasses.replace(
            create_iterate(self.problem, x_restored), cons_dual=state.it.cons_dual,
            vars_dual=state.it.vars_dual, var_states=state.it.var_states,
            cons_states=state.it.cons_states)
        dtype = self.problem.dtype
        return dataclasses.replace(
            state,
            it=new_it,
            status=torch.full_like(state.status, int(Status.RUNNING)),
            trust_radius=torch.full((), 1.0, dtype=dtype, device=self.device),
            lp_trust_radius=torch.full((), TRUST_REGION_FACTOR / float(np.sqrt(max(n, 1))),
                                       dtype=dtype, device=self.device),
            penalty=state.penalty * 10.0,
        )

    # -- logging --------------------------------------------------------

    def _log_iteration(self, state: SolverState) -> None:
        if not logger.isEnabledFor(logging.INFO):
            return
        iteration = int(state.iteration)
        if iteration % 25 == 0:
            logger.info(_HEADER)
        if logger.isEnabledFor(logging.DEBUG):
            # per-step nonlinearity measures (measure.c:15-40, 237-295)
            logger.debug("model reduction %.6e, exact reduction %.6e, ratio %.3e",
                         float(state.last_model_reduction), float(state.last_exact_reduction),
                         float(state.last_reduction_ratio))
            logger.debug("%s", format_measure(state.measure, float(state.penalty)))
        logger.info(
            "%6d %14.6e %14.6e %9.2e %9.2e %9.2e %9.2e %9.2e %9.2e %9s",
            iteration, float(state.it.obj_val), float(state.it.obj_val),
            float(state.feas_res), float(state.slack_res), float(state.stat_res),
            float(state.penalty), float(state.lp_trust_radius), float(state.trust_radius),
            _STEP_NAMES.get(int(state.last_step_type), "?"))

    def _print_stats(self) -> None:
        """Final banner (solver/print.c:10-90)."""
        s = self.state
        logger.info("%s", "-" * 60)
        logger.info("Status        : %s", self.status.name)
        logger.info("Objective     : %.10e", float(s.it.obj_val))
        logger.info("Feas residuum : %.3e", float(s.feas_res))
        logger.info("Slack residuum: %.3e", float(s.slack_res))
        logger.info("Stat residuum : %.3e", float(s.stat_res))
        logger.info("Iterations    : %d", int(s.iteration))
        logger.info("Accepted      : %d", int(s.num_accepted))
        logger.info("SOC accepted  : %d", int(s.num_soc_accepted))
        logger.info("Rejected      : %d", int(s.num_rejected))
        logger.info("LP pivots     : %d", int(s.lp_iterations))
        logger.info("Elapsed       : %.3f s", self.elapsed_seconds)

    # -- solution queries (pub_solver.h:26-100) -------------------------

    @property
    def _solution_iterate(self) -> Iterate:
        """The solution in the (scaled) space the solver worked in, with any
        preprocessor reduction undone."""
        if self._restored_iterate is not None:
            return self._restored_iterate
        return self.state.it

    @property
    def _original_iterate(self) -> Iterate:
        """The solution in the original problem's space: the preprocessor
        restore composed with the exact power-of-two unscaling
        (solver/solve.c:270, problem_scaling.c)."""
        it = self._solution_iterate
        sp = self._scaled_problem
        if sp is None:
            return it
        out = create_iterate(self.original_problem, sp.unscale_point(it.x))
        return dataclasses.replace(out, cons_dual=sp.unscale_cons_dual(it.cons_dual),
                                   vars_dual=sp.unscale_vars_dual(it.vars_dual),
                                   var_states=it.var_states, cons_states=it.cons_states)

    @property
    def solution(self) -> np.ndarray:
        return self._original_iterate.x.cpu().numpy()

    @property
    def obj_val(self) -> float:
        return float(self._original_iterate.obj_val)

    @property
    def cons_dual(self) -> np.ndarray:
        return self._original_iterate.cons_dual.cpu().numpy()

    @property
    def vars_dual(self) -> np.ndarray:
        return self._original_iterate.vars_dual.cpu().numpy()

    @property
    def iterations(self) -> int:
        return int(self.state.iteration)

    @property
    def iterate(self) -> Iterate:
        return self._original_iterate

    def residuals(self, original: bool = False) -> tuple[float, float, float]:
        """(feasibility, slackness, stationarity) residua: those the solver
        converged on (in the scaled space when scaling is active, as the
        reference accounts), or with ``original=True`` re-evaluated on the
        unscaled iterate in the original problem's space
        (problem_scaling_test.c checks optimality there)."""
        if original and self._scaled_problem is not None:
            it = self._original_iterate
            data = self.original_problem.data
            feas = max0(violation_values(it.cons_val, data.cons_lb, data.cons_ub))
            slack = torch.maximum(
                max0(slack_residual_values(it.cons_val, data.cons_lb, data.cons_ub,
                                           it.cons_dual).abs()),
                max0(slack_residual_values(it.x, data.var_lb, data.var_ub, it.vars_dual).abs()))
            stat = max0(stationarity_residuals(data, it).abs())
            return tuple(torch.stack([feas, slack, stat]).tolist())
        s = self.state
        return tuple(torch.stack([s.feas_res, s.slack_res, s.stat_res]).tolist())

    # solver state queries (pub_types.h:198-217)
    def state_real(self, name: str) -> float:
        s = self.state
        mapping = {
            "trust_radius": s.trust_radius,
            "lp_trust_radius": s.lp_trust_radius,
            "penalty_parameter": s.penalty,
            "feas_res": s.feas_res,
            "slack_res": s.slack_res,
            "stat_res": s.stat_res,
            "min_rayleigh": s.min_rayleigh,
            "max_rayleigh": s.max_rayleigh,
            # nonlinearity diagnostics of the last step (measure.c)
            "obj_nonlin": s.measure.obj_nonlin,
            "cons_nonlin": s.measure.cons_nonlin,
            "lag_nonlin": s.measure.lag_nonlin,
            "step_norm": s.measure.step_norm,
        }
        return float(mapping[name])

    def state_vec(self, name: str) -> np.ndarray:
        """Vector state queries (pub_solver.h sleqp_solver_vec_state,
        pub_types.h:218-225), on the (scaled) iterate the solver works on:
        "stat_residuals" per variable, "feas_residuals" (signed violation)
        and "cons_slack_residuals" per constraint, "var_slack_residuals"
        per variable."""
        it = self._solution_iterate
        data = self.problem.data
        if name == "stat_residuals":
            vec = stationarity_residuals(data, it)
        elif name == "feas_residuals":
            vec = violation_values(it.cons_val, data.cons_lb, data.cons_ub)
        elif name == "cons_slack_residuals":
            vec = slack_residual_values(it.cons_val, data.cons_lb, data.cons_ub, it.cons_dual)
        elif name == "var_slack_residuals":
            vec = slack_residual_values(it.x, data.var_lb, data.var_ub, it.vars_dual)
        else:
            raise KeyError(name)
        return vec.cpu().numpy()

    def state_int(self, name: str) -> int:
        s = self.state
        mapping = {
            "iteration": s.iteration,
            "last_step_type": s.last_step_type,
            "num_accepted": s.num_accepted,
            "num_soc_accepted": s.num_soc_accepted,
            "num_rejected": s.num_rejected,
            "num_failed_eqp": s.num_failed_eqp,
            "lp_iterations": s.lp_iterations,
        }
        return int(mapping[name])
