"""Port parity of scaling (sleqp_tpu_torch/scale.py), the preprocessor
(preprocessor.py) and polishing (polish.py) against the JAX package.

* the cases of tests/test_scale.py, with the scaled evaluations held
  against JAX's bit for bit (every factor is a power of two) and the
  solves against JAX's (status, x to 1e-8, iterations);
* the 11 cases of tests/test_preprocessor.py, with the reductions held
  against JAX's exactly and the solves' restored solutions and duals
  against JAX's to 1e-8;
* ``polish_iterate`` under each mode against JAX's on random working sets.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.polish as jpolish
import sleqp_tpu.problem_solver as jps
import sleqp_tpu.scale as jscale
from sleqp_tpu import Func as JaxFunc
from sleqp_tpu import Problem as JaxProblem
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.iterate import Iterate as JaxIterate
from sleqp_tpu.preprocessor import preprocess as jax_preprocess
from sleqp_tpu.problem import ProblemData as JaxProblemData
from sleqp_tpu.solver import Solver as JaxSolver
from sleqp_tpu.types import Polishing as JaxPolishing
from sleqp_tpu_torch import (
    ActiveState, Func, Polishing, Problem, Scaling, Settings, Solver, Status, create_iterate,
    solve,
)
from sleqp_tpu_torch.convert import scaling_from_reference, tree_from_numpy
from sleqp_tpu_torch.iterate import Iterate
from sleqp_tpu_torch.polish import polish_iterate
from sleqp_tpu_torch.preprocessor import PreprocessingResult, preprocess
from sleqp_tpu_torch.problem import ProblemData
from sleqp_tpu_torch.scale import ScaledProblem, derive_scaling
from torch_dense import flat_jax, flat_port, hs71, jax_to_numpy, mismatches, rosenbrock
from torch_parity import no_jax_cache_writes  # noqa: F401


def _scaled_pair(obj_weight, var_nominal, cons_nominal):
    jp, tp, x0 = hs71()
    js = jscale.Scaling(4, 2, obj_weight=obj_weight)
    js.set_var_weights_from_nominal(var_nominal)
    js.set_cons_weights_from_nominal(cons_nominal)
    ts = scaling_from_reference(js)
    return jscale.ScaledProblem(jp, js), ScaledProblem(tp, ts), x0


# ---- the cases of tests/test_scale.py ---------------------------------------


def test_scaling_exactness():
    """Scale -> unscale is the identity on floats (pub_scale.h:58-61), and
    the scaled point is JAX's bit for bit."""
    _, tp, x0 = hs71()
    scaling = Scaling(4, 2)
    scaling.set_var_weights_from_nominal([3.0, 10.0, 0.25, 1.0])
    scaling.obj_weight = 4
    scaling.set_cons_weights_from_nominal([25.0, 40.0])
    sp = ScaledProblem(tp, scaling)
    xs = sp.scale_point(x0)
    np.testing.assert_array_equal(sp.unscale_point(xs).numpy(), x0)
    jsp, _, _ = _scaled_pair(4, [3.0, 10.0, 0.25, 1.0], [25.0, 40.0])
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jsp.scale_point(jnp.asarray(x0))))
    for a, b in (("var_lb", "var_lb"), ("cons_lb", "cons_lb"), ("cons_ub", "cons_ub")):
        np.testing.assert_array_equal(getattr(sp.data, a).numpy(), np.asarray(getattr(jsp.data, b)))


def test_scaled_derivative_consistency():
    """Scaled gradients and Jacobians equal AD of the scaled functions, and
    JAX's evaluations to rounding."""
    jsp, sp, x0 = _scaled_pair(2, [2.0, 4.0, 4.0, 2.0], [16.0, 32.0])
    xs = sp.scale_point(x0)
    g_direct = torch.func.grad(sp.obj_val)(xs)
    np.testing.assert_allclose(sp.obj_grad(xs).numpy(), g_direct.numpy(), rtol=1e-12)
    J_direct = torch.func.jacrev(sp.cons_val)(xs)
    np.testing.assert_allclose(sp.cons_jac(xs).numpy(), J_direct.numpy(), rtol=1e-12)
    jxs = jnp.asarray(xs.numpy())
    for name in ("obj_val", "obj_grad", "cons_val", "cons_jac"):
        np.testing.assert_allclose(getattr(sp, name)(xs).numpy(),
                                   np.asarray(getattr(jsp, name)(jxs)), rtol=1e-14, atol=0)


def test_scaled_hess_prod_consistency():
    jsp, sp, x0 = _scaled_pair(-1, [2.0, 4.0, 4.0, 2.0], [16.0, 32.0])
    xs = sp.scale_point(x0)
    mu = torch.tensor([0.5, -0.25], dtype=torch.float64)

    def lag(z):
        return sp.obj_val(z) + mu @ sp.cons_val(z)

    H = torch.func.hessian(lag)(xs)
    d = torch.tensor([1.0, -1.0, 0.5, 2.0], dtype=torch.float64)
    np.testing.assert_allclose(sp.hess_prod(xs, d, mu).numpy(), (H @ d).numpy(), rtol=1e-10)
    np.testing.assert_allclose(
        sp.hess_prod(xs, d, mu).numpy(),
        np.asarray(jsp.hess_prod(jnp.asarray(xs.numpy()), jnp.asarray(d.numpy()),
                                 jnp.asarray(mu.numpy()))), rtol=1e-13)


def test_scaled_callables_follow_float32():
    """The mixed route evaluates the scaled callables at float32 points."""
    _, sp, x0 = _scaled_pair(3, [2.0, 4.0, 4.0, 2.0], [32.0, 64.0])
    xs = sp.scale_point(x0).to(torch.float32)
    sp.check_follows_dtype(xs)
    assert sp.obj_grad(xs).dtype == sp.cons_jac(xs).dtype == torch.float32


def test_solve_scaled_hs71():
    """The scaled problem's solve, unscaled, is the solution; the duals
    unscaled satisfy the original stationarity; JAX's solve is matched."""
    jsp, sp, x0 = _scaled_pair(3, [2.0, 4.0, 4.0, 2.0], [32.0, 64.0])
    ref = jps.solve(jsp, JaxSettings(), jsp.scale_point(jnp.asarray(x0)), max_iterations=200)
    state = solve(sp, Settings(), sp.scale_point(x0), max_iterations=200, device="cpu")
    assert int(state.status) == int(ref.status) == Status.OPTIMAL
    assert int(state.iteration) == int(ref.iteration)
    np.testing.assert_allclose(state.it.x.numpy(), np.asarray(ref.it.x), atol=1e-8)
    x = sp.unscale_point(state.it.x)
    np.testing.assert_allclose(x.numpy(), [1.0, 4.742999, 3.821151, 1.379408], atol=1e-4)
    it0 = create_iterate(sp.original, x)
    mu = sp.unscale_cons_dual(state.it.cons_dual)
    nu = sp.unscale_vars_dual(state.it.vars_dual)
    resid = it0.obj_grad + it0.cons_jac.T @ mu + nu
    assert float(resid.abs().max()) < 1e-4


def test_derive_weights():
    jp, tp, x0 = rosenbrock()
    it = create_iterate(tp, torch.as_tensor(x0))
    scaling = Scaling(2, 0)
    scaling.derive_obj_weight_from_grad(it.obj_grad)
    ref = jscale.Scaling(2, 0)
    ref.derive_obj_weight_from_grad(np.asarray(jax.grad(jp.obj_val)(jnp.asarray(x0))))
    assert scaling.obj_weight == ref.obj_weight
    sp = ScaledProblem(tp, scaling)
    g = sp.obj_grad(sp.scale_point(x0)).numpy()
    assert 0.25 <= np.max(np.abs(g)) <= 2.5


def test_solver_chain_composes_scaling():
    """Solver(problem, x0, scaling=...) mirrors the chain scaling ->
    preprocessing -> problem solver (solver.c:278), with the solution,
    duals, objective and residuals unscaled."""
    jp, tp, x0 = hs71()
    f_opt = 17.0140172
    scaling = Scaling(4, 2)
    scaling.obj_weight = 3
    scaling.var_weights = np.array([1, -1, 2, 0], dtype=np.int32)
    scaling.cons_weights = np.array([-2, 1], dtype=np.int32)
    solver = Solver(tp, x0, scaling=scaling, device="cpu")
    assert solver.solve(max_iterations=100) == Status.OPTIMAL
    assert abs(solver.obj_val - f_opt) <= 1e-5 * (1.0 + abs(f_opt))
    np.testing.assert_allclose(solver.solution, [1.0, 4.742999, 3.821151, 1.379408], atol=1e-4)
    feas, slack, stat = solver.residuals(original=True)
    assert feas <= 1e-6 and slack <= 1e-6 and stat <= 1e-5
    it = solver.iterate
    r = it.obj_grad + it.cons_jac.T @ it.cons_dual + it.vars_dual
    assert float(r.abs().max()) <= 1e-5
    # JAX's solver with the same weights
    js = jscale.Scaling(4, 2, obj_weight=3, var_weights=np.array([1, -1, 2, 0], dtype=np.int32),
                        cons_weights=np.array([-2, 1], dtype=np.int32))
    ref = JaxSolver(jp, jnp.asarray(x0), scaling=js)
    assert ref.solve(max_iterations=100) == Status.OPTIMAL
    np.testing.assert_allclose(solver.solution, ref.solution, atol=1e-8)
    np.testing.assert_allclose(solver.cons_dual, ref.cons_dual, atol=1e-8)
    np.testing.assert_allclose(solver.residuals(original=True), ref.residuals(original=True),
                               atol=1e-10)
    assert solver.iterations == ref.iterations


def test_solver_chain_auto_scaling():
    """scaling='auto' derives the weights from the derivatives at x0
    (scale.c:640-740), JAX's weights, and converges on a badly scaled
    problem."""

    def obj(x):
        return 4096.0 * (x[0] - 1.0) ** 2 + (x[1] - 4096.0) ** 2 / 4096.0

    jp = JaxProblem(JaxFunc(obj, 2, cons=lambda x: jnp.array([4096.0 * x[0] + x[1] / 4096.0]),
                            num_cons=1), general_lb=jnp.array([4097.0]),
                    general_ub=jnp.array([jnp.inf]))
    tp = Problem(Func(obj, 2, cons=lambda x: (4096.0 * x[0] + x[1] / 4096.0)[None], num_cons=1),
                 general_lb=[4097.0], general_ub=[np.inf], device="cpu")
    x0 = np.array([2.0, 2000.0])
    solver = Solver(tp, x0, scaling="auto", device="cpu")
    ref = jscale.derive_scaling(jp, jnp.asarray(x0))
    assert solver.scaling.obj_weight == ref.obj_weight
    np.testing.assert_array_equal(solver.scaling.cons_weights, ref.cons_weights)
    assert int(np.max(np.abs(solver.scaling.cons_weights))) > 0
    assert solver.solve(max_iterations=200) == Status.OPTIMAL
    feas, slack, stat = solver.residuals(original=True)
    assert feas <= 1e-6 * 4097.0
    assert stat <= 1e-4
    np.testing.assert_array_equal(
        derive_scaling(tp, x0).var_weights, np.asarray(ref.var_weights))


# ---- the cases of tests/test_preprocessor.py --------------------------------


def _pair(obj, n, **kw):
    """The same problem in both packages from numpy bounds and rows."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return JaxProblem(JaxFunc(obj, n), **jkw), Problem(Func(obj, n), device="cpu", **kw)


def _same_reduction(jpre, tpre):
    assert int(tpre.result) == int(jpre.result)
    for name in ("free_vars", "fixed_vars", "fixed_values", "kept_linear", "removed_linear"):
        np.testing.assert_array_equal(getattr(tpre, name), getattr(jpre, name), err_msg=name)
    assert [dataclasses.astuple(f)[:2] for f in tpre.forcing] == \
        [dataclasses.astuple(f)[:2] for f in jpre.forcing]
    assert [dataclasses.astuple(c) for c in tpre.converted_bounds] == \
        [dataclasses.astuple(c) for c in jpre.converted_bounds]
    if tpre.problem is not None:
        for name in ("var_lb", "var_ub", "cons_lb", "cons_ub", "linear_coeffs"):
            np.testing.assert_array_equal(getattr(tpre.problem.data, name).numpy(),
                                          np.asarray(getattr(jpre.problem.data, name)))


def _solve_both(jp, tp, x0, max_iterations=100):
    ref = JaxSolver(jp, jnp.asarray(x0), JaxSettings(enable_preprocessor=True))
    solver = Solver(tp, x0, Settings(enable_preprocessor=True), device="cpu")
    status = solver.solve(max_iterations=max_iterations)
    assert status == ref.solve(max_iterations=max_iterations)
    if status == Status.OPTIMAL:
        for name in ("solution", "cons_dual", "vars_dual"):
            np.testing.assert_allclose(getattr(solver, name), getattr(ref, name), atol=1e-8,
                                       err_msg=name)
        np.testing.assert_array_equal(solver.iterate.var_states.numpy(),
                                      np.asarray(ref.iterate.var_states))
        assert solver.iterations == ref.iterations
    return solver, status


def _box_qp():
    """min (x0-1)^2 + (x1-2)^2 + (x2+3)^2 with x1 fixed at 5."""

    def obj(x):
        return (x[0] - 1.0) ** 2 + (x[1] - 2.0) ** 2 + (x[2] + 3.0) ** 2

    return _pair(obj, 3, var_lb=np.array([-10.0, 5.0, -10.0]), var_ub=np.array([10.0, 5.0, 10.0]))


def _sq(x):
    return (x * x).sum()


def test_fixed_variable_elimination():
    jp, tp = _box_qp()
    pre = preprocess(tp)
    _same_reduction(jax_preprocess(jp), pre)
    assert pre.result == PreprocessingResult.SUCCESS
    assert pre.problem.num_variables == 2
    np.testing.assert_array_equal(pre.fixed_vars, [1])
    np.testing.assert_allclose(pre.fixed_values, [5.0])
    xr = torch.tensor([1.0, -3.0], dtype=torch.float64)
    np.testing.assert_allclose(float(pre.problem.obj_val(xr)), 9.0)
    # the reduced callables' derivatives: the fixed coordinate drops out
    np.testing.assert_allclose(pre.problem.obj_grad(xr).numpy(), [0.0, 0.0])


def test_solve_with_preprocessor():
    jp, tp = _box_qp()
    solver, status = _solve_both(jp, tp, np.zeros(3))
    assert status == Status.OPTIMAL
    np.testing.assert_allclose(solver.solution, [1.0, 5.0, -3.0], atol=1e-6)
    # the fixed variable's dual from stationarity: nu_1 = -grad_1 = -6
    np.testing.assert_allclose(solver.vars_dual[1], -6.0, atol=1e-6)


def test_singleton_row_to_bound():
    jp, tp = _pair(_sq, 2, linear_coeffs=np.array([[2.0, 0.0], [1.0, 1.0]]),
                   linear_lb=np.array([4.0, -np.inf]), linear_ub=np.array([np.inf, 10.0]))
    pre = preprocess(tp)
    _same_reduction(jax_preprocess(jp), pre)
    assert pre.problem.num_linear == 1
    np.testing.assert_allclose(pre.problem.data.var_lb.numpy(), [2.0, -np.inf])


def test_redundant_row_removed():
    jp, tp = _pair(_sq, 2, var_lb=0.0, var_ub=1.0, linear_coeffs=np.array([[1.0, 1.0]]),
                   linear_lb=-10.0, linear_ub=10.0)
    pre = preprocess(tp)
    _same_reduction(jax_preprocess(jp), pre)
    assert pre.problem.num_linear == 0


def test_infeasibility_detection():
    jp, tp = _pair(_sq, 2, var_lb=0.0, var_ub=1.0, linear_coeffs=np.array([[1.0, 1.0]]),
                   linear_lb=5.0, linear_ub=np.inf)
    pre = preprocess(tp)
    _same_reduction(jax_preprocess(jp), pre)
    assert pre.result == PreprocessingResult.INFEASIBLE
    finished = []
    solver = Solver(tp, np.zeros(2), Settings(enable_preprocessor=True), device="cpu")
    solver.add_callback(2, lambda s: finished.append(s.status))
    assert solver.solve() == Status.INFEASIBLE and finished == [Status.INFEASIBLE]


def test_fixed_vars_with_constraints():
    """General constraints survive the reduction with the right Jacobian."""

    def obj(x):
        return x[0] ** 2 + x[2] ** 2

    jp = JaxProblem(JaxFunc(obj, 3, cons=lambda x: jnp.array([x[0] + x[1] * x[2]]), num_cons=1),
                    var_lb=[-5.0, 2.0, -5.0], var_ub=[5.0, 2.0, 5.0], general_lb=1.0,
                    general_ub=jnp.inf)
    tp = Problem(Func(obj, 3, cons=lambda x: (x[0] + x[1] * x[2])[None], num_cons=1),
                 var_lb=[-5.0, 2.0, -5.0], var_ub=[5.0, 2.0, 5.0], general_lb=1.0,
                 general_ub=np.inf, device="cpu")
    solver, status = _solve_both(jp, tp, np.array([1.0, 2.0, 1.0]))
    assert status == Status.OPTIMAL
    x = solver.solution
    assert x[1] == 2.0
    assert x[0] + x[1] * x[2] >= 1.0 - 1e-7


def test_forcing_constraint_fixes_variables():
    """A row whose implied max activity equals its lower bound forces every
    participating variable to its activity-maximizing bound."""
    jp, tp = _pair(_sq, 3, var_lb=np.array([0.0, 0.0, -1.0]), var_ub=np.array([1.0, 2.0, 1.0]),
                   linear_coeffs=np.array([[1.0, 0.0, -1.0]]), linear_lb=np.array([2.0]),
                   linear_ub=np.array([np.inf]))
    pre = preprocess(tp)
    _same_reduction(jax_preprocess(jp), pre)
    assert pre.result == PreprocessingResult.SUCCESS
    assert len(pre.forcing) == 1 and pre.forcing[0].at_lower
    assert pre.problem.num_linear == 0
    assert set(pre.fixed_vars.tolist()) == {0, 2}
    fv = dict(zip(pre.fixed_vars.tolist(), pre.fixed_values.tolist()))
    assert fv[0] == 1.0 and fv[2] == -1.0


def test_forcing_constraint_restore_duals():
    """The restored iterate gives the forced variables' stationarity
    residuals to the forcing row's dual with the right signs."""
    jp, tp = _pair(_sq, 3, var_lb=np.array([0.0, -1.0, -1.0]), var_ub=np.array([1.0, 1.0, 1.0]),
                   linear_coeffs=np.array([[1.0, 0.0, -1.0]]), linear_lb=np.array([2.0]),
                   linear_ub=np.array([np.inf]))
    solver, status = _solve_both(jp, tp, np.array([0.5, 0.5, 0.0]), max_iterations=50)
    assert status == Status.OPTIMAL
    np.testing.assert_allclose(solver.solution, [1.0, 0.0, -1.0], atol=1e-6)
    lam = float(solver.cons_dual[0])
    grad = np.array([2.0, 0.0, -2.0])
    A = np.array([[1.0, 0.0, -1.0]])
    np.testing.assert_allclose(grad + A.T @ [lam] + solver.vars_dual, 0.0, atol=1e-6)
    assert lam <= 1e-12
    assert solver.iterate.cons_states.numpy()[0] == ActiveState.ACTIVE_LOWER


def test_forcing_upper_bound():
    def obj(x):
        return (x[0] - 5.0) ** 2 + (x[1] + 5.0) ** 2

    jp, tp = _pair(obj, 2, var_lb=np.array([0.0, -1.0]), var_ub=np.array([1.0, 1.0]),
                   linear_coeffs=np.array([[1.0, -1.0]]), linear_lb=np.array([-np.inf]),
                   linear_ub=np.array([-1.0]))
    pre = preprocess(tp)
    _same_reduction(jax_preprocess(jp), pre)
    assert len(pre.forcing) == 1 and not pre.forcing[0].at_lower
    fv = dict(zip(pre.fixed_vars.tolist(), pre.fixed_values.tolist()))
    assert fv[0] == 0.0 and fv[1] == 1.0


def test_implied_bound_infeasibility():
    """Bound tightening proves infeasibility that single-row activity
    checks miss: x0 + x1 <= 1 and x0 - x1 >= 5 on [0, 10]^2."""
    jp, tp = _pair(_sq, 2, var_lb=np.array([0.0, 0.0]), var_ub=np.array([10.0, 10.0]),
                   linear_coeffs=np.array([[1.0, 1.0], [1.0, -1.0]]),
                   linear_lb=np.array([-np.inf, 5.0]), linear_ub=np.array([1.0, np.inf]))
    pre = preprocess(tp)
    _same_reduction(jax_preprocess(jp), pre)
    assert pre.result == PreprocessingResult.INFEASIBLE


def test_converted_bound_dual_restore():
    """An active bound that came from a singleton row gives its dual back
    to the row on restore (restore.c:506-570)."""
    jp, tp = _pair(_sq, 2, linear_coeffs=np.array([[2.0, 0.0]]), linear_lb=np.array([4.0]),
                   linear_ub=np.array([np.inf]))
    solver, status = _solve_both(jp, tp, np.array([3.0, 1.0]), max_iterations=50)
    assert status == Status.OPTIMAL
    np.testing.assert_allclose(solver.solution, [2.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(float(solver.cons_dual[0]), -2.0, atol=1e-6)
    np.testing.assert_allclose(solver.vars_dual, 0.0, atol=1e-6)


# ---- polish_iterate against the reference -----------------------------------


@pytest.mark.parametrize("mode", ["NONE", "ZERO_DUAL", "INACTIVE"])
def test_polish_iterate_matches_jax(mode):
    rng = np.random.default_rng(6)
    n, m = 12, 9
    var_lb = np.where(rng.random(n) < 0.3, -np.inf, -1.0)
    var_ub = np.where(rng.random(n) < 0.3, np.inf, 1.0)
    cons_lb = np.where(rng.random(m) < 0.3, -np.inf, -2.0)
    cons_ub = np.where(rng.random(m) < 0.3, np.inf, 2.0)
    # values at, near and away from their bounds; duals zero or not
    x = np.choose(rng.integers(0, 3, n), [np.full(n, -1.0), np.full(n, 1.0 + 1e-12),
                                          rng.uniform(-0.5, 0.5, n)])
    c = np.choose(rng.integers(0, 3, m), [np.full(m, -2.0), np.full(m, 2.0),
                                          rng.uniform(-1, 1, m)])
    arrays = dict(
        x=x, obj_val=np.float64(0.0), obj_grad=np.zeros(n), cons_val=c,
        cons_jac=rng.standard_normal((m, n)),
        cons_dual=np.where(rng.random(m) < 0.4, 0.0, rng.standard_normal(m)),
        vars_dual=np.where(rng.random(n) < 0.4, 0.0, rng.standard_normal(n)),
        var_states=rng.integers(0, 4, n).astype(np.int8),
        cons_states=rng.integers(0, 4, m).astype(np.int8))
    data = dict(var_lb=var_lb, var_ub=var_ub, cons_lb=cons_lb, cons_ub=cons_ub,
                linear_coeffs=np.zeros((0, n)))
    ref = jpolish.polish_iterate(
        JaxProblemData(**{k: jnp.asarray(v) for k, v in data.items()}),
        JaxIterate(**{k: jnp.asarray(v) for k, v in arrays.items()}), JaxPolishing[mode])
    out = polish_iterate(tree_from_numpy(ProblemData, data, device="cpu"),
                         tree_from_numpy(Iterate, arrays, device="cpu"), Polishing[mode])
    assert not mismatches(flat_port(out), flat_jax(jax_to_numpy(ref)), 0.0)
    if mode != "NONE":
        assert (out.var_states.numpy() != arrays["var_states"]).any()


def test_polishing_inactive_guards_infinite_bounds():
    """INACTIVE polishing drops an entry whose bound is infinite."""
    n = 3
    data = ProblemData(
        var_lb=torch.tensor([-np.inf, 0.0, -np.inf], dtype=torch.float64),
        var_ub=torch.tensor([np.inf, 2.0, np.inf], dtype=torch.float64),
        cons_lb=torch.zeros(0, dtype=torch.float64), cons_ub=torch.zeros(0, dtype=torch.float64),
        linear_coeffs=torch.zeros((0, n), dtype=torch.float64))
    it = create_iterate(Problem(Func(_sq, n), device="cpu"),
                        torch.tensor([5.0, 0.0, -7.0], dtype=torch.float64))
    it = dataclasses.replace(
        it, vars_dual=torch.tensor([1.0, 1.0, -1.0], dtype=torch.float64),
        var_states=torch.tensor([ActiveState.ACTIVE_LOWER, ActiveState.ACTIVE_LOWER,
                                 ActiveState.ACTIVE_UPPER], dtype=torch.int8))
    states = polish_iterate(data, it, Polishing.INACTIVE).var_states.tolist()
    assert states == [ActiveState.INACTIVE, ActiveState.ACTIVE_LOWER, ActiveState.INACTIVE]
