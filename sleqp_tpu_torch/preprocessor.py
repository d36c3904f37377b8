"""Presolve: fixed-variable elimination and linear-constraint reductions.

Port of ``sleqp_tpu/preprocessor.py`` (reference src/main/preprocessor/:
preprocessor.c, fixed_var_func.c, transform.c, restore.c):

* fixed variables (lb == ub) are substituted out; the reduced function
  closes over the fixed values (fixed_var_func.c);
* singleton linear rows (one nonzero coefficient) become variable bounds
  (preprocessor.c:19-60);
* forcing rows (a bound that only the extreme activity meets) fix their
  variables (preprocessor.c:372-431);
* redundant linear rows, whose implied activity range lies inside the row
  bounds, are dropped; a row whose range misses its bounds, or an empty
  implied variable interval, proves infeasibility (pub_types.h:176-181);
* ``restore_iterate`` maps the reduced solution, duals and working set
  back to the original space, with the eliminated variables' duals from
  stationarity (restore.c).

The reductions run once, on the host, over numpy copies of the problem's
bounds and linear rows; the reduced ``Problem`` lives on the original
problem's device, and its callables expand a reduced point by one gather.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from .iterate import Iterate
from .problem import Func, Problem
from .types import ActiveState

Tensor = torch.Tensor


class PreprocessingResult(enum.IntEnum):
    SUCCESS = 0
    INFEASIBLE = 1


@dataclasses.dataclass
class ForcingConstraint:
    """A linear row whose bound can only be met with every variable at a
    box bound (preprocessor.c:395-431): the row is removed and its
    variables fixed.  ``at_lower`` means the row's lower bound forces the
    maximal activity (linear_max == linear_lb)."""

    row: int
    at_lower: bool
    variables: np.ndarray  # original variable indices with nonzero coeff
    factors: np.ndarray  # the nonzero coefficients


@dataclasses.dataclass
class ConvertedBound:
    """A singleton linear row converted into a variable bound
    (preprocessor.c:110-174); on restore an active bound dual goes back to
    the row (restore.c:506-570)."""

    row: int
    variable: int
    factor: float
    tight_lower: bool  # the converted bound supplied the variable's lb
    tight_upper: bool  # ... the variable's ub


def _host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


@dataclasses.dataclass
class Preprocessed:
    """Reduced problem + everything needed to restore solutions."""

    result: PreprocessingResult
    problem: Optional[Problem]  # reduced problem (None if infeasible)
    original: Problem
    free_vars: np.ndarray  # indices of kept variables
    fixed_vars: np.ndarray  # indices of eliminated variables
    fixed_values: np.ndarray
    kept_general: np.ndarray  # general cons indices kept (always all)
    kept_linear: np.ndarray  # linear row indices kept
    removed_linear: np.ndarray  # linear rows removed (singleton/redundant/forcing)
    forcing: list = dataclasses.field(default_factory=list)
    converted_bounds: list = dataclasses.field(default_factory=list)

    def reduce_point(self, x) -> Tensor:
        orig = self.original
        x = torch.as_tensor(x, dtype=orig.dtype, device=orig.device)
        return x[torch.as_tensor(self.free_vars, dtype=torch.long, device=orig.device)]

    def restore_iterate(self, it: Iterate) -> Iterate:
        """Map a reduced-space iterate back to the original problem."""
        orig = self.original
        n, m, mg = orig.num_variables, orig.num_cons, orig.num_general
        dtype, dev = orig.dtype, orig.device

        x_np = np.zeros(n)
        x_np[self.free_vars] = _host(it.x)
        x_np[self.fixed_vars] = self.fixed_values
        x = torch.as_tensor(x_np, dtype=dtype, device=dev)
        obj_val, obj_grad, cons_val, cons_jac = orig.eval_all(x)

        kept = np.concatenate([self.kept_general, mg + self.kept_linear]).astype(np.int64)
        cons_dual_np = np.zeros(m)
        cons_states_np = np.zeros(m, dtype=np.int8)
        cons_dual_np[kept] = _host(it.cons_dual)
        cons_states_np[kept] = it.cons_states.cpu().numpy()
        vars_dual_np = np.zeros(n)
        var_states_np = np.zeros(n, dtype=np.int8)
        vars_dual_np[self.free_vars] = _host(it.vars_dual)
        var_states_np[self.free_vars] = it.var_states.cpu().numpy()

        # stationarity residuals at the eliminated variables (restore.c)
        cons_dual_t = torch.as_tensor(cons_dual_np, dtype=dtype, device=dev)
        resid = _host(obj_grad + cons_jac.T @ cons_dual_t)
        claimed = np.zeros(n, dtype=bool)
        claimed[self.free_vars] = True

        # -- forcing constraints (restore.c:384-502): the forced
        # variables' stationarity residual goes to the forcing row's dual
        # when a bound dual would otherwise have the wrong sign; the
        # absorbing variable stays inactive
        for fc in self.forcing:
            vs = [int(j) for j in fc.variables if not claimed[int(j)]]
            if not vs:
                continue
            factors = {int(j): float(a) for j, a in zip(fc.variables, fc.factors)}

            # a row held at max activity by its lower bound puts a positive
            # coefficient's variable at its upper bound
            def at_upper(j):
                return (factors[j] > 0) == fc.at_lower

            wrong = [j for j in vs if at_upper(j) != (-resid[j] >= 0.0)]
            if wrong:
                ratios = {j: -resid[j] / factors[j] for j in wrong}
                max_j = max(ratios, key=lambda j: abs(ratios[j]))
                lam = ratios[max_j]
                row = mg + int(fc.row)
                cons_dual_np[row] = lam
                cons_states_np[row] = (ActiveState.ACTIVE_LOWER if fc.at_lower
                                       else ActiveState.ACTIVE_UPPER)
                for j in vs:
                    claimed[j] = True
                    if j == max_j:
                        continue  # residual fully absorbed by the row
                    var_states_np[j] = (ActiveState.ACTIVE_UPPER if at_upper(j)
                                        else ActiveState.ACTIVE_LOWER)
                    vars_dual_np[j] = -(resid[j] + factors[j] * lam)
            else:
                for j in vs:
                    claimed[j] = True
                    var_states_np[j] = (ActiveState.ACTIVE_UPPER if at_upper(j)
                                        else ActiveState.ACTIVE_LOWER)
                    vars_dual_np[j] = -resid[j]

        # -- remaining fixed variables: nu = -(grad + J^T mu)
        for j in self.fixed_vars:
            j = int(j)
            if claimed[j]:
                continue
            vars_dual_np[j] = -resid[j]
            var_states_np[j] = ActiveState.ACTIVE_BOTH

        # -- converted singleton bounds (restore.c:506-570): an active
        # bound that came from a singleton row gives its dual to the row
        for cb in self.converted_bounds:
            j, row = int(cb.variable), mg + int(cb.row)
            state = int(var_states_np[j])
            if state == ActiveState.ACTIVE_BOTH:
                state = (ActiveState.ACTIVE_UPPER if vars_dual_np[j] >= 0
                         else ActiveState.ACTIVE_LOWER)
            from_row = ((state == ActiveState.ACTIVE_LOWER and cb.tight_lower)
                        or (state == ActiveState.ACTIVE_UPPER and cb.tight_upper))
            if state == ActiveState.INACTIVE or not from_row:
                continue
            # a negative factor swaps lower and upper on the row
            upper = state == ActiveState.ACTIVE_UPPER
            if cb.factor < 0:
                upper = not upper
            cons_dual_np[row] = vars_dual_np[j] / cb.factor
            cons_states_np[row] = ActiveState.ACTIVE_UPPER if upper else ActiveState.ACTIVE_LOWER
            vars_dual_np[j] = 0.0
            var_states_np[j] = ActiveState.INACTIVE

        return Iterate(
            x=x,
            obj_val=obj_val,
            obj_grad=obj_grad,
            cons_val=cons_val,
            cons_jac=cons_jac,
            cons_dual=torch.as_tensor(cons_dual_np, dtype=dtype, device=dev),
            vars_dual=torch.as_tensor(vars_dual_np, dtype=dtype, device=dev),
            var_states=torch.as_tensor(var_states_np, device=dev),
            cons_states=torch.as_tensor(cons_states_np, device=dev),
        )


def preprocess(problem: Problem, feas_tol: float = 1e-9) -> Preprocessed:
    """Run presolve on a problem (reference: sleqp_preprocessor_create)."""
    n = problem.num_variables
    mg = problem.num_general
    ml = problem.num_linear

    var_lb = _host(problem.data.var_lb)
    var_ub = _host(problem.data.var_ub)
    lin_lb = _host(problem.data.cons_lb[mg:])
    lin_ub = _host(problem.data.cons_ub[mg:])
    A = _host(problem.data.linear_coeffs)

    if np.any(var_lb > var_ub + feas_tol):
        return _infeasible(problem)

    removed_rows: list[int] = []
    converted_bounds: list[ConvertedBound] = []
    forcing: list[ForcingConstraint] = []

    # -- singleton rows -> variable bounds (preprocessor.c:110-174) -----
    for i in range(ml):
        nz = np.nonzero(A[i])[0]
        if len(nz) == 1:
            j = int(nz[0])
            a = A[i, j]
            lo, hi = lin_lb[i], lin_ub[i]
            if a < 0:
                lo, hi = hi, lo
            lo = lo / a if np.isfinite(lo) else -np.inf
            hi = hi / a if np.isfinite(hi) else np.inf
            tight_lower = lo > var_lb[j]
            tight_upper = hi < var_ub[j]
            var_lb[j] = max(var_lb[j], lo)
            var_ub[j] = min(var_ub[j], hi)
            removed_rows.append(i)
            if tight_lower or tight_upper:
                converted_bounds.append(ConvertedBound(i, j, float(a), tight_lower, tight_upper))
        elif len(nz) == 0:
            # an empty row is either trivially satisfied or infeasible
            if lin_lb[i] > feas_tol or lin_ub[i] < -feas_tol:
                return _infeasible(problem)
            removed_rows.append(i)

    if np.any(var_lb > var_ub + feas_tol):
        return _infeasible(problem)

    def _activity_bounds(i):
        lo = np.sum(np.where(A[i] >= 0, A[i] * var_lb, A[i] * var_ub))
        hi = np.sum(np.where(A[i] >= 0, A[i] * var_ub, A[i] * var_lb))
        return lo, hi

    # -- forcing constraints (preprocessor.c:372-431): a row whose slack
    # against the implied activity range is zero is met only with every
    # participating variable at a box bound
    for i in range(ml):
        if i in removed_rows:
            continue
        lo_act, hi_act = _activity_bounds(i)
        if np.isfinite(lin_lb[i]):
            slack = hi_act - lin_lb[i]
            if slack < -feas_tol:
                return _infeasible(problem)
            if slack <= feas_tol:
                nz = np.nonzero(A[i])[0]
                # max activity: positive coeff at ub, negative at lb
                fixed = np.where(A[i, nz] > 0, var_ub[nz], var_lb[nz])
                var_lb[nz] = var_ub[nz] = fixed
                forcing.append(ForcingConstraint(i, True, nz.astype(np.int32), A[i, nz]))
                removed_rows.append(i)
                continue
        if np.isfinite(lin_ub[i]):
            slack = lin_ub[i] - lo_act
            if slack < -feas_tol:
                return _infeasible(problem)
            if slack <= feas_tol:
                nz = np.nonzero(A[i])[0]
                # min activity: positive coeff at lb, negative at ub
                fixed = np.where(A[i, nz] > 0, var_lb[nz], var_ub[nz])
                var_lb[nz] = var_ub[nz] = fixed
                forcing.append(ForcingConstraint(i, False, nz.astype(np.int32), A[i, nz]))
                removed_rows.append(i)

    # -- redundant / infeasible rows by implied activity bounds ---------
    for i in range(ml):
        if i in removed_rows:
            continue
        lo_act, hi_act = _activity_bounds(i)
        if lo_act > lin_ub[i] + feas_tol or hi_act < lin_lb[i] - feas_tol:
            return _infeasible(problem)
        if (np.isfinite(lo_act) and np.isfinite(hi_act)
                and lo_act >= lin_lb[i] - feas_tol and hi_act <= lin_ub[i] + feas_tol):
            removed_rows.append(i)  # redundant

    # -- implied variable bounds (preprocessor.c:176-258): each row's bound
    # minus the other entries' extreme activity bounds a variable; an
    # empty implied interval proves infeasibility
    var_min = var_lb.copy()
    var_max = var_ub.copy()
    for i in range(ml):
        if i in removed_rows:
            continue
        lo_act, hi_act = _activity_bounds(i)
        for j in np.nonzero(A[i])[0]:
            a = A[i, j]
            if (np.isfinite(lin_ub[i]) and np.isfinite(lo_act)
                    and np.isfinite(var_lb[j] if a > 0 else var_ub[j])):
                if a > 0:
                    var_max[j] = min(var_max[j], (lin_ub[i] - lo_act) / a + var_lb[j])
                else:
                    var_min[j] = max(var_min[j], (lin_ub[i] - lo_act) / a + var_ub[j])
            if (np.isfinite(lin_lb[i]) and np.isfinite(hi_act)
                    and np.isfinite(var_ub[j] if a > 0 else var_lb[j])):
                if a > 0:
                    var_min[j] = max(var_min[j], (lin_lb[i] - hi_act) / a + var_ub[j])
                else:
                    var_max[j] = min(var_max[j], (lin_lb[i] - hi_act) / a + var_lb[j])
    finite_pair = np.isfinite(var_min) & np.isfinite(var_max)
    gap = np.where(finite_pair, var_max - var_min, 0.0)
    scale = 1.0 + np.abs(np.where(finite_pair, var_min, 0.0))
    if np.any(gap < -feas_tol * scale):
        return _infeasible(problem)

    kept_linear = np.array([i for i in range(ml) if i not in removed_rows], dtype=np.int32)
    removed_linear = np.array(sorted(removed_rows), dtype=np.int32)

    # -- fixed variables ------------------------------------------------
    both_finite = np.isfinite(var_lb) & np.isfinite(var_ub)
    fixed_mask = both_finite & (
        np.abs(np.where(both_finite, var_ub - var_lb, 1.0))
        <= feas_tol * (1.0 + np.abs(np.where(both_finite, var_lb, 0.0))))
    fixed_vars = np.nonzero(fixed_mask)[0].astype(np.int32)
    free_vars = np.nonzero(~fixed_mask)[0].astype(np.int32)
    fixed_values = 0.5 * (var_lb[fixed_vars] + var_ub[fixed_vars])

    reduced = _reduced_problem(problem, free_vars, fixed_vars, fixed_values, var_lb, var_ub,
                               A, lin_lb, lin_ub, kept_linear)
    return Preprocessed(
        result=PreprocessingResult.SUCCESS,
        problem=reduced,
        original=problem,
        free_vars=free_vars,
        fixed_vars=fixed_vars,
        fixed_values=fixed_values,
        kept_general=np.arange(mg, dtype=np.int32),
        kept_linear=kept_linear,
        removed_linear=removed_linear,
        forcing=forcing,
        converted_bounds=converted_bounds,
    )


def _reduced_problem(problem, free_vars, fixed_vars, fixed_values, var_lb, var_ub, A,
                     lin_lb, lin_ub, kept_linear) -> Problem:
    """The problem over the free variables: the original func at the
    expanded point (fixed_var_func.c), the kept linear rows with their
    bounds shifted by the fixed variables' contribution."""
    n, mg = problem.num_variables, problem.num_general
    dev = problem.device
    orig_func = problem.func
    nr, nf = len(free_vars), len(fixed_vars)
    # the original vector is a gather of [reduced values, fixed values]
    position = np.empty(n, dtype=np.int64)
    position[free_vars] = np.arange(nr)
    position[fixed_vars] = nr + np.arange(nf)
    gather = torch.as_tensor(position, device=dev)
    free_idx = torch.as_tensor(free_vars, dtype=torch.long, device=dev)
    fixed_vals = torch.as_tensor(fixed_values, dtype=torch.float64, device=dev)

    def expand(xr):
        return torch.cat([xr, fixed_vals.to(xr.dtype)])[gather]

    def expand_dir(dr):
        return torch.cat([dr, torch.zeros((nf,), dtype=dr.dtype, device=dr.device)])[gather]

    red_func = Func(
        obj=lambda xr: orig_func.obj_val(expand(xr)),
        num_variables=nr,
        cons=(lambda xr: orig_func.cons_val(expand(xr))) if mg else None,
        num_cons=mg,
        hess_prod=lambda xr, d, mu: orig_func.hess_prod(expand(xr), expand_dir(d), mu)[free_idx],
        psd_hessian=orig_func.psd_hessian,
    )

    lin_kept = lin_kept_lb = lin_kept_ub = None
    if len(kept_linear):
        lin_kept = A[kept_linear][:, free_vars]
        lin_kept_lb = lin_lb[kept_linear]
        lin_kept_ub = lin_ub[kept_linear]
        if nf:
            shift = A[kept_linear][:, fixed_vars] @ fixed_values
            lin_kept_lb = lin_kept_lb - shift
            lin_kept_ub = lin_kept_ub - shift
    return Problem(
        red_func,
        var_lb=var_lb[free_vars],
        var_ub=var_ub[free_vars],
        general_lb=problem.data.cons_lb[:mg],
        general_ub=problem.data.cons_ub[:mg],
        linear_coeffs=lin_kept,
        linear_lb=lin_kept_lb,
        linear_ub=lin_kept_ub,
        dtype=problem.dtype,
        device=dev,
    )


def _infeasible(problem: Problem) -> Preprocessed:
    return Preprocessed(
        result=PreprocessingResult.INFEASIBLE,
        problem=None,
        original=problem,
        free_vars=np.arange(problem.num_variables, dtype=np.int32),
        fixed_vars=np.zeros(0, dtype=np.int32),
        fixed_values=np.zeros(0),
        kept_general=np.arange(problem.num_general, dtype=np.int32),
        kept_linear=np.zeros(0, dtype=np.int32),
        removed_linear=np.zeros(0, dtype=np.int32),
    )
