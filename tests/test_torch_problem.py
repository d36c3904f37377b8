"""Port parity: the problem and function model, sleqp_tpu_torch/problem.py
against sleqp_tpu/problem.py (oracles of tests/test_foundations.py).

Each problem is built in both packages from the same numpy data; every
evaluation (objective, gradient, constraints, Jacobian, Hessian product)
must agree to 1e-12 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu_torch as tx
from torch_dense import boxqp, chainineq, chainqp, hs71, linear, quadcons, wachbieg
from torch_parity import no_jax_cache_writes  # noqa: F401

PAIRS = {
    "hs71": hs71,
    "quadcons": quadcons,
    "wachbieg": wachbieg,
    "linear": linear,
    "chainineq": lambda: chainineq(8),
    "chainqp": lambda: chainqp(8),
    "boxqp": lambda: boxqp(6),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_evaluations_match_jax(name):
    jp, tp, x0 = PAIRS[name]()
    rng = np.random.default_rng(3)
    n, m = jp.num_variables, jp.num_cons
    assert (tp.num_variables, tp.num_cons, tp.num_general, tp.num_linear) == (
        n, m, jp.num_general, jp.num_linear)
    for key in ("var_lb", "var_ub", "cons_lb", "cons_ub", "linear_coeffs"):
        np.testing.assert_array_equal(getattr(tp.data, key).numpy(),
                                      np.asarray(getattr(jp.data, key)))
    for _ in range(3):
        x = np.asarray(x0) + 0.3 * rng.standard_normal(n)
        d = rng.standard_normal(n)
        mu = rng.standard_normal(m)
        jx_, tx_ = jnp.asarray(x), torch.as_tensor(x)
        ref = jp.eval_all(jx_)
        got = tp.eval_all(tx_)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            tp.hess_prod(tx_, torch.as_tensor(d), torch.as_tensor(mu)).numpy(),
            np.asarray(jp.hess_prod(jx_, jnp.asarray(d), jnp.asarray(mu))),
            rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(tp.clip_to_bounds(tx_).numpy(),
                                      np.asarray(jp.clip_to_bounds(jx_)))


def test_hess_prod_matches_dense_hessian():
    """test_foundations.py::test_hess_prod_matches_dense_hessian on the port."""
    jp, tp, x0 = hs71()
    mu = np.array([0.3, -0.7])

    def lag(x):
        return jp.obj_val(x) + jnp.vdot(jnp.asarray(mu), jp.cons_val(x))

    H = np.asarray(jax.hessian(lag)(jnp.asarray(x0)))
    d = np.array([1.0, -2.0, 0.5, 3.0])
    hd = tp.hess_prod(torch.as_tensor(x0), torch.as_tensor(d), torch.as_tensor(mu))
    np.testing.assert_allclose(hd.numpy(), H @ d, rtol=1e-12)


def test_derivative_overrides_are_used():
    calls = []

    def obj(x):
        return (x * x).sum()

    def obj_grad(x):
        calls.append("grad")
        return 2.0 * x

    def cons_jac(x):
        calls.append("jac")
        return torch.ones((1, 3), dtype=x.dtype)

    def hess_prod(x, d, mu):
        calls.append("hess")
        return 2.0 * d

    func = tx.Func(obj, 3, cons=lambda x: x.sum().reshape(1), num_cons=1, obj_grad=obj_grad,
                   cons_jac=cons_jac, hess_prod=hess_prod)
    p = tx.Problem(func, general_lb=1.0, general_ub=1.0, device="cpu")
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    np.testing.assert_array_equal(p.obj_grad(x).numpy(), [2.0, 4.0, 6.0])
    np.testing.assert_array_equal(p.cons_jac(x).numpy(), [[1.0, 1.0, 1.0]])
    np.testing.assert_array_equal(p.hess_prod(x, x, torch.ones(1, dtype=x.dtype)).numpy(),
                                  [2.0, 4.0, 6.0])
    assert calls == ["grad", "jac", "hess"]


@pytest.mark.parametrize("blocks", [((0, 2), (1, 3)), ((2, 1),), ((0, 5),)])
def test_invalid_hess_struct_raises_as_in_jax(blocks):
    import sleqp_tpu as jxp

    with pytest.raises(ValueError, match="hess_struct"):
        jxp.Func(lambda x: jnp.sum(x), 4, hess_struct=blocks)
    with pytest.raises(ValueError, match="hess_struct"):
        tx.Func(lambda x: x.sum(), 4, hess_struct=blocks)
    assert tx.Func(lambda x: x.sum(), 4, hess_struct=((0, 2), (2, 4))).hess_struct == ((0, 2), (2, 4))


def test_accept_point_bounds_shapes_and_dtypes():
    func = tx.Func(lambda x: (x * x).sum(), 2, accept_point=lambda x: x[0] < 1.0)
    p = tx.Problem(func, var_lb=[-1.0, 0.0], var_ub=2.0, device="cpu")
    assert bool(p.func.point_valid(torch.tensor([0.5, 0.0], dtype=torch.float64)))
    assert not bool(p.func.point_valid(torch.tensor([1.5, 0.0], dtype=torch.float64)))
    assert bool(tx.Func(lambda x: x.sum(), 2).point_valid(torch.zeros(2)))
    np.testing.assert_array_equal(
        p.clip_to_bounds(torch.tensor([-3.0, 5.0], dtype=torch.float64)).numpy(), [-1.0, 2.0])
    p32 = p.astype(torch.float32)
    assert p32.dtype == torch.float32 and p32.data.var_lb.dtype == torch.float32
    np.testing.assert_array_equal(p32.data.var_ub.numpy(), [2.0, 2.0])
    assert p.to("cpu") is p
    with pytest.raises(ValueError, match="var_lb"):
        tx.Problem(func, var_lb=[0.0, 0.0, 0.0], device="cpu")
    with pytest.raises(ValueError, match="linear_coeffs"):
        tx.Problem(func, linear_coeffs=np.ones((1, 3)), device="cpu")
    with pytest.raises(ValueError, match="num_cons"):
        tx.Func(lambda x: x.sum(), 2, num_cons=1)


def test_float64_closure_on_mixed_route_raises_type_error():
    """A callable that closes over a float64 tensor cannot run at the
    float32 iterate of the mixed route: TypeError with the dtype rule."""
    t = torch.tensor([0.5, -0.25], dtype=torch.float64)
    bad = tx.Problem(tx.Func(lambda x: ((x - t) ** 2).sum(), 2), device="cpu")
    with pytest.raises(TypeError, match="arguments' dtype"):
        bad.check_follows_dtype(torch.zeros(2, dtype=torch.float32))
    good = tx.Problem(tx.Func(lambda x: ((x - t.to(x)) ** 2).sum(), 2), device="cpu")
    good.check_follows_dtype(torch.zeros(2, dtype=torch.float32))
    with pytest.raises(TypeError, match="arguments' dtype"):
        tx.solve(bad, tx.Settings(compute_dtype="float32"), np.zeros(2), device="cpu")
