"""Port parity of dynamic (inexact) functions: sleqp_tpu_torch/dyn.py, the
dynamic branches of problem_solver.py and the DynFunc branch of scale.py,
against the JAX package.

* the five cases of tests/test_dyn.py, through the port, with each whole
  solve also held to JAX's (status, iterations, x to 1e-8, error bound);
* one port iteration from every JAX iterate of both dynamic problems and
  of the scaled one, to 1e-9, ``error_bound``, ``error_est`` and
  ``refresh_eval`` included;
* the scaled weights of ``test_scaled_dyn_weights`` against JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.scale as jsc
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu_torch import Problem, Settings, Status, solve
from sleqp_tpu_torch.dyn import REQUIRED_ACCURACY_FACTOR, DynFunc, required_error_bound
from sleqp_tpu_torch.scale import ScaledProblem, Scaling
from test_dyn import _dyn_constrained, _dyn_rosenbrock
from torch_dense import iteration_mismatches, jax_states
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

INF = float("inf")


def _port_rosenbrock():
    """test_dyn.py::_dyn_rosenbrock in torch."""

    def eval_fn(x, error_bound, obj_weight, cons_weights):
        err_f = 0.5 * error_bound / torch.clamp(obj_weight, min=1.0)
        true = (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
        noisy = true + err_f * torch.sin(37.0 * x[0] + 53.0 * x[1])
        return noisy, x.new_zeros(0), obj_weight * err_f

    return Problem(DynFunc(eval_fn, num_variables=2), device="cpu"), np.array([0.0, 0.0])


def _constrained_eval(floor):
    """test_dyn.py's constrained eval (denominator floor 1.0) and the one of
    test_scaled_dyn_solve_weight_magnitudes (1e-8), in torch."""

    def eval_fn(x, error_bound, obj_weight, cons_weights):
        denom = torch.clamp(obj_weight + cons_weights.sum(), min=floor)
        err = 0.4 * error_bound / denom
        obj = x[0] ** 2 + x[1] ** 2 + err * torch.cos(17.0 * x[0])
        cons = torch.stack([x[0] + x[1] + err * torch.sin(13.0 * x[1])])
        return obj, cons, (obj_weight + cons_weights.sum()) * err

    return eval_fn


def _port_constrained(floor=1.0):
    func = DynFunc(_constrained_eval(floor), num_variables=2, num_cons=1)
    return Problem(func, general_lb=1.0, general_ub=INF, device="cpu"), np.array([2.0, 2.0])


def _jax_scaled_constrained():
    """test_dyn.py::test_scaled_dyn_solve_weight_magnitudes's problem."""
    from sleqp_tpu import Problem as JaxProblem
    from sleqp_tpu.dyn import DynFunc as JaxDynFunc

    def eval_fn(x, error_bound, obj_weight, cons_weights):
        denom = jnp.maximum(obj_weight + jnp.sum(cons_weights), 1e-8)
        err = 0.4 * error_bound / denom
        obj = x[0] ** 2 + x[1] ** 2 + err * jnp.cos(17.0 * x[0])
        cons = jnp.array([x[0] + x[1] + err * jnp.sin(13.0 * x[1])])
        return obj, cons, (obj_weight + jnp.sum(cons_weights)) * err

    func = JaxDynFunc(eval_fn, num_variables=2, num_cons=1)
    problem = JaxProblem(func, general_lb=1.0, general_ub=jnp.inf)
    scaling = jsc.Scaling(2, 1, obj_weight=4)
    scaling.cons_weights = np.array([-2], dtype=np.int32)
    return jsc.ScaledProblem(problem, scaling)


def _port_scaled_constrained():
    problem, _ = _port_constrained(floor=1e-8)
    scaling = Scaling(2, 1, obj_weight=4)
    scaling.cons_weights = np.array([-2], dtype=np.int32)
    return ScaledProblem(problem, scaling)


def _pairs():
    jr, x0r = _dyn_rosenbrock()
    jc, x0c = _dyn_constrained()
    js = _jax_scaled_constrained()
    ts = _port_scaled_constrained()
    x0s = np.array(js.scale_point(jnp.array([2.0, 2.0])))
    return {
        "rosenbrock": (jr, _port_rosenbrock()[0], np.array(x0r)),
        "constrained": (jc, _port_constrained()[0], np.array(x0c)),
        "scaled": (js, ts, x0s),
    }


@pytest.fixture(scope="module")
def jax_runs():
    """Each problem's JAX states from the start to the end of its solve."""
    return {name: (jp, tp, x0, jax_states(jp, JaxSettings(), x0, limit=501))
            for name, (jp, tp, x0) in _pairs().items()}


def _check_against_jax(state, states):
    ref = states[-1]
    assert int(state.status) == int(ref.status)
    assert int(state.iteration) == int(ref.iteration)
    np.testing.assert_allclose(state.it.x.numpy(), np.asarray(ref.it.x), atol=1e-8)
    np.testing.assert_allclose(float(state.error_bound), float(ref.error_bound), rtol=1e-8)


def test_dyn_rosenbrock_solves(jax_runs):
    _, tp, x0, states = jax_runs["rosenbrock"]
    state = solve(tp, Settings(), x0, max_iterations=500, device="cpu")
    assert int(state.status) == Status.OPTIMAL, Status(int(state.status)).name
    np.testing.assert_allclose(state.it.x.numpy(), [1.0, 1.0], atol=1e-4)
    # the error bound must have been tightened below its initial value
    assert float(state.error_bound) < 1.0
    _check_against_jax(state, states)


def test_dyn_constrained_solves(jax_runs):
    _, tp, x0, states = jax_runs["constrained"]
    state = solve(tp, Settings(), x0, max_iterations=500, device="cpu")
    assert int(state.status) == Status.OPTIMAL, Status(int(state.status)).name
    np.testing.assert_allclose(state.it.x.numpy(), [0.5, 0.5], atol=1e-3)
    _check_against_jax(state, states)


def test_dyn_refinement_tightens_monotonically(jax_runs):
    _, tp, x0, states = jax_runs["rosenbrock"]
    state = solve(tp, Settings(), x0, max_iterations=40, device="cpu")
    first_bound = float(state.error_bound)
    state2 = solve(tp, Settings(), x0, max_iterations=500, device="cpu")
    assert float(state2.error_bound) <= first_bound
    # the reference's solve ends before 40 iterations: both runs stop there
    np.testing.assert_allclose(first_bound, float(states[min(40, len(states) - 1)].error_bound),
                               rtol=1e-8)


def test_scaled_dyn_weights():
    """Scaling a DynFunc scales the error weights on the way in and the
    values on the way out (problem_scaling.c:276-345, scale.c:269-340);
    the port sees JAX's weights and returns JAX's values."""
    from sleqp_tpu import Problem as JaxProblem
    from sleqp_tpu.dyn import DynFunc as JaxDynFunc

    seen = {}

    def port_eval(x, error_bound, obj_weight, cons_weights):
        seen["port"] = (obj_weight, cons_weights)
        return x[0] ** 2, torch.stack([x[0] + x[1]]), obj_weight * 0.0

    def jax_eval(x, error_bound, obj_weight, cons_weights):
        seen["jax"] = (obj_weight, cons_weights)
        return x[0] ** 2, jnp.array([x[0] + x[1]]), obj_weight * 0.0

    def scaling(cls):
        s = cls(2, 1, obj_weight=3)  # f scaled by 2^-3
        s.cons_weights = np.array([2], dtype=np.int32)  # c scaled by 2^-2
        return s

    tp = Problem(DynFunc(port_eval, num_variables=2, num_cons=1), general_lb=1.0,
                 general_ub=INF, device="cpu")
    sp = ScaledProblem(tp, scaling(Scaling))
    assert isinstance(sp.func, DynFunc)
    obj, cons, _ = sp.func.eval_at(torch.tensor([2.0, 0.0], dtype=torch.float64),
                                   torch.tensor(1e-2, dtype=torch.float64),
                                   penalty=torch.tensor(80.0, dtype=torch.float64))
    w_f, w_c = seen["port"]
    # solver-side obj weight 1 arrives as 2^-3; penalty 80 as 80 * 2^-2
    np.testing.assert_allclose(float(w_f), 0.125)
    np.testing.assert_allclose(w_c.numpy(), [20.0])
    # values scaled on the way out
    np.testing.assert_allclose(float(obj), 4.0 * 0.125)
    np.testing.assert_allclose(cons.numpy(), [0.5])

    jp = JaxProblem(JaxDynFunc(jax_eval, num_variables=2, num_cons=1), general_lb=1.0,
                    general_ub=jnp.inf)
    jsp = jsc.ScaledProblem(jp, scaling(jsc.Scaling))
    jobj, jcons, _ = jsp.func.eval_at(jnp.array([2.0, 0.0]), jnp.asarray(1e-2),
                                      penalty=jnp.asarray(80.0))
    jw_f, jw_c = seen["jax"]
    assert float(w_f) == float(jw_f) and np.array_equal(w_c.numpy(), np.asarray(jw_c))
    assert float(obj) == float(jobj) and np.array_equal(cons.numpy(), np.asarray(jcons))


def test_scaled_dyn_solve_weight_magnitudes(jax_runs):
    """End to end: a scaled dynamic solve where the constraint weights
    span orders of magnitude still converges and tightens the bound."""
    _, sp, x0s, states = jax_runs["scaled"]
    np.testing.assert_array_equal(sp.scale_point(np.array([2.0, 2.0])).numpy(), x0s)
    state = solve(sp, Settings(), x0s, max_iterations=500, device="cpu")
    assert int(state.status) == Status.OPTIMAL, Status(int(state.status)).name
    x = sp.unscale_point(state.it.x).numpy()
    np.testing.assert_allclose(x, [0.5, 0.5], atol=1e-3)
    assert float(state.error_bound) < 1.0
    _check_against_jax(state, states)


@pytest.mark.parametrize("name", ["rosenbrock", "constrained", "scaled"])
def test_iteration_from_every_jax_iterate(jax_runs, name):
    """One port iteration from each JAX state gives JAX's next state, the
    dynamic fields included; the runs refine the bound at least once."""
    _, tp, _, states = jax_runs[name]
    assert any(bool(s.refresh_eval) for s in states)
    assert float(states[-1].error_bound) < float(states[0].error_bound)
    bad = iteration_mismatches(tp, Settings(), states)
    assert not bad, bad


def test_required_error_bound_matches_jax():
    from sleqp_tpu import dyn as jdyn

    assert REQUIRED_ACCURACY_FACTOR == jdyn.REQUIRED_ACCURACY_FACTOR
    for ar, mr in ((1e-8, 0.3), (0.1, 2.5), (0.5, 0.0)):
        got = required_error_bound(ar, torch.tensor(mr, dtype=torch.float64))
        assert float(got) == float(jdyn.required_error_bound(ar, jnp.asarray(mr)))
