"""Port parity of the quasi-Newton Hessians (sleqp_tpu_torch/quasi_newton.py
against sleqp_tpu/quasi_newton.py).

* the products and pushes on random pairs, past a full ring (8 pairs into
  a window of 5), for damped and simple BFGS with and without sizing and
  for SR1, and per block of a ``hess_struct``: every field of the ring
  buffer and every product to 1e-12 (relative);
* the cases of tests/test_quasi_newton.py, each on the port and held
  against JAX's whole solve: the same status, x to 1e-8 and the same
  iteration count;
* one port iteration from every JAX iterate of HS71 under DAMPED_BFGS and
  under SR1, to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.problem_solver as jps
import sleqp_tpu.quasi_newton as jqn
from sleqp_tpu import Func as JaxFunc
from sleqp_tpu import HessEval as JaxHessEval
from sleqp_tpu import Problem as JaxProblem
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu_torch import Func, HessEval, Problem, Settings, Status, solve
from sleqp_tpu_torch import quasi_newton as tqn
from sleqp_tpu_torch.convert import tree_from_numpy
from torch_dense import (
    flat_jax, flat_port, hs71, iteration_mismatches, jax_states, jax_to_numpy, mismatches,
    rosenbrock,
)
from torch_parity import no_jax_cache_writes  # noqa: F401

# name -> (hess_eval, sizing)
PUSHES = {
    "damped_bfgs_sized": (HessEval.DAMPED_BFGS, True),
    "damped_bfgs": (HessEval.DAMPED_BFGS, False),
    "simple_bfgs_sized": (HessEval.SIMPLE_BFGS, True),
    "sr1": (HessEval.SR1, True),
}


def _pairs(n, count, seed):
    """(s, y) pairs with indefinite curvature, some of them negative."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n), rng.standard_normal(n)) for _ in range(count)]


@pytest.mark.parametrize("case", sorted(PUSHES))
def test_pushes_and_products_match_jax(case):
    hess_eval, sizing = PUSHES[case]
    n, W = 6, 5
    jq = jqn.qn_init(n, W, jnp.float64)
    tq = tqn.qn_init(n, W, torch.float64)
    probe = np.random.default_rng(99).standard_normal(n)
    for k, (s, y) in enumerate(_pairs(n, 8, seed=3)):
        jq = jqn.qn_push(jq, jnp.asarray(s), jnp.asarray(y), JaxHessEval(int(hess_eval)), sizing)
        tq = tqn.qn_push(tq, torch.as_tensor(s), torch.as_tensor(y), hess_eval, sizing)
        assert not mismatches(flat_port(tq), flat_jax(jax_to_numpy(jq)), 1e-12), k
        got = tqn.qn_product(tq, torch.as_tensor(probe), hess_eval).numpy()
        ref = np.asarray(jqn.qn_product(jq, jnp.asarray(probe), JaxHessEval(int(hess_eval))))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    assert int(tq.count) == W
    # a JAX ring buffer carried over to the port gives the same product
    carried = tree_from_numpy(tqn.QNState, jax_to_numpy(jq), device="cpu")
    np.testing.assert_allclose(
        tqn.qn_product(carried, torch.as_tensor(probe), hess_eval).numpy(),
        np.asarray(jqn.qn_product(jq, jnp.asarray(probe), JaxHessEval(int(hess_eval)))),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("hess_eval", [HessEval.DAMPED_BFGS, HessEval.SR1])
def test_block_pushes_and_products_match_jax(hess_eval):
    """Per-block ring buffers of a hess_struct, with a variable outside
    every block (zero curvature row)."""
    blocks = ((0, 2), (3, 6))
    n = 7
    jq = jqn.qn_init(n, 3, jnp.float64, blocks=blocks)
    tq = tqn.qn_init(n, 3, torch.float64, blocks=blocks)
    probe = np.random.default_rng(5).standard_normal(n)
    for s, y in _pairs(n, 4, seed=11):
        jq = jqn.qn_push(jq, jnp.asarray(s), jnp.asarray(y), JaxHessEval(int(hess_eval)), True,
                         blocks=blocks)
        tq = tqn.qn_push(tq, torch.as_tensor(s), torch.as_tensor(y), hess_eval, True,
                         blocks=blocks)
        assert isinstance(tq, tuple) and [q.S.shape for q in tq] == [(3, 2), (3, 3)]
        assert not mismatches(flat_port(tq), flat_jax(jax_to_numpy(jq)), 1e-12)
        got = tqn.qn_product(tq, torch.as_tensor(probe), hess_eval, blocks=blocks).numpy()
        ref = np.asarray(jqn.qn_product(jq, jnp.asarray(probe), JaxHessEval(int(hess_eval)),
                                        blocks=blocks))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
        assert got[2] == 0.0 and got[6] == 0.0
    carried = tree_from_numpy(tqn.QNState, jax_to_numpy(jq), device="cpu")
    assert isinstance(carried, tuple) and not mismatches(flat_port(carried),
                                                          flat_jax(jax_to_numpy(jq)), 0.0)


# ---- the cases of tests/test_quasi_newton.py --------------------------------


def _push_pairs(qn, pairs, method):
    for s, y in pairs:
        s, y = torch.as_tensor(s), torch.as_tensor(y)
        if method == "bfgs":
            qn = tqn.bfgs_push(qn, s, y, damped=True, sizing=False)
        else:
            qn = tqn.sr1_push(qn, s, y)
    return qn


def test_bfgs_secant_property():
    """After pushing (s, y) with s'y > 0, B s == y (undamped case)."""
    rng = np.random.default_rng(0)
    n = 5
    s = rng.standard_normal(n)
    y = s + 0.5 * rng.standard_normal(n)
    if float(np.dot(s, y)) < 0:
        y = -y
    qn = _push_pairs(tqn.qn_init(n, 4, torch.float64), [(s, y)], "bfgs")
    np.testing.assert_allclose(tqn.bfgs_product(qn, torch.as_tensor(s)).numpy(), y, atol=1e-10)


def test_bfgs_quadratic_reconstruction():
    """On a quadratic the newest secant pair holds exactly."""
    rng = np.random.default_rng(1)
    n = 4
    M = rng.standard_normal((n, n))
    H = M @ M.T + n * np.eye(n)
    pairs = []
    for _ in range(n):
        s = rng.standard_normal(n)
        pairs.append((s, H @ s))
    qn = _push_pairs(tqn.qn_init(n, n, torch.float64), pairs, "bfgs")
    s_last, y_last = pairs[-1]
    np.testing.assert_allclose(tqn.bfgs_product(qn, torch.as_tensor(s_last)).numpy(), y_last,
                               atol=1e-8)


def test_bfgs_positive_definite():
    rng = np.random.default_rng(2)
    n = 6
    pairs = []
    for _ in range(8):  # more than the window: the ring rolls
        s = rng.standard_normal(n)
        y = rng.standard_normal(n)
        if np.dot(s, y) < 0:
            y = -y
        pairs.append((s, y))
    qn = _push_pairs(tqn.qn_init(n, 5, torch.float64), pairs, "bfgs")
    for _ in range(10):
        d = torch.as_tensor(rng.standard_normal(n))
        assert float(d @ tqn.bfgs_product(qn, d)) > 0


def test_sr1_secant_property():
    rng = np.random.default_rng(3)
    n = 5
    s = rng.standard_normal(n)
    y = rng.standard_normal(n)
    qn = _push_pairs(tqn.qn_init(n, 4, torch.float64), [(s, y)], "sr1")
    np.testing.assert_allclose(tqn.sr1_product(qn, torch.as_tensor(s)).numpy(), y, atol=1e-10)


def _solve_both(jp, tp, x0, hess_eval, max_iterations=300):
    ref = jps.solve(jp, JaxSettings(hess_eval=JaxHessEval(int(hess_eval))), jnp.asarray(x0),
                    max_iterations=max_iterations)
    out = solve(tp, Settings(hess_eval=hess_eval), x0, max_iterations=max_iterations,
                device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL, (
        Status(int(out.status)).name, Status(int(ref.status)).name)
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=1e-8)
    assert int(out.iteration) == int(ref.iteration), (int(out.iteration), int(ref.iteration))
    return out


@pytest.mark.parametrize("hess_eval",
                         [HessEval.DAMPED_BFGS, HessEval.SR1, HessEval.SIMPLE_BFGS])
def test_solve_rosenbrock_quasi_newton(hess_eval):
    jp, tp, x0 = rosenbrock()
    out = _solve_both(jp, tp, x0, hess_eval)
    np.testing.assert_allclose(out.it.x.numpy(), [1.0, 1.0], atol=1e-5)


def test_solve_hs71_bfgs():
    jp, tp, x0 = hs71()
    out = _solve_both(jp, tp, x0, HessEval.DAMPED_BFGS)
    np.testing.assert_allclose(out.it.x.numpy(), [1.0, 4.742999, 3.821151, 1.379408], atol=1e-4)


def test_block_diagonal_hess_struct():
    """Per-block BFGS with a declared block-diagonal Hessian (reference
    SleqpHessStruct + bfgs.c blocks): two independent 2-d Rosenbrocks."""

    def obj(x):
        return ((1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[2]) ** 2
                + 10.0 * (x[3] - x[2] ** 2) ** 2)

    blocks = ((0, 2), (2, 4))
    jp = JaxProblem(JaxFunc(obj, num_variables=4, hess_struct=blocks))
    tp = Problem(Func(obj, num_variables=4, hess_struct=blocks), device="cpu")
    out = _solve_both(jp, tp, np.zeros(4), HessEval.DAMPED_BFGS)
    np.testing.assert_allclose(out.it.x.numpy(), [1.0, 1.0, 1.0, 1.0], atol=1e-5)
    # the state holds one ring buffer per block
    assert isinstance(out.qn, tuple) and len(out.qn) == 2
    assert out.qn[0].S.shape == (5, 2)


def test_invalid_hess_struct():
    with pytest.raises(ValueError):
        Func(lambda x: x @ x, num_variables=3, hess_struct=((0, 2), (1, 3)))


# ---- one port iteration from every JAX iterate -------------------------------


@pytest.mark.parametrize("hess_eval", [HessEval.DAMPED_BFGS, HessEval.SR1])
def test_every_iteration_from_jax_state_matches_jax(hess_eval):
    jp, tp, x0 = hs71()
    states = jax_states(jp, JaxSettings(hess_eval=JaxHessEval(int(hess_eval))), x0)
    assert int(states[-1].status) == Status.OPTIMAL and len(states) > 5
    # pairs were pushed along the way
    assert int(states[-1].qn.count) > 0
    assert not iteration_mismatches(tp, Settings(hess_eval=hess_eval), states)


def test_mixed_route_quasi_newton_matches_jax():
    """compute_dtype="float32": the Krylov loop runs on the ring buffer
    cast to float32, as in the reference."""
    jp, tp, x0 = hs71()
    ref = jps.solve(jp, JaxSettings(hess_eval=JaxHessEval.DAMPED_BFGS, compute_dtype="float32"),
                    jnp.asarray(x0))
    out = solve(tp, Settings(hess_eval=HessEval.DAMPED_BFGS, compute_dtype="float32"), x0,
                device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=1e-6)
    assert abs(int(out.iteration) - int(ref.iteration)) <= 3
