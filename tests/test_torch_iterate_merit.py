"""Port parity: iterates, KKT residuals and the l1 merit models,
sleqp_tpu_torch/{iterate,merit}.py against sleqp_tpu/{iterate,merit}.py
(oracles of tests/test_foundations.py), to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleqp_tpu import iterate as jit_
from sleqp_tpu import merit as jme
from sleqp_tpu_torch import iterate as tit
from sleqp_tpu_torch import merit as tme
from torch_dense import chainineq, flat_jax, flat_port, hs71, mismatches, port_iterate, quadcons, wachbieg
from torch_parity import no_jax_cache_writes  # noqa: F401

PAIRS = {"hs71": hs71, "quadcons": quadcons, "wachbieg": wachbieg,
         "chainineq": lambda: chainineq(8)}


def _states(rng, size):
    return rng.integers(0, 4, size).astype(np.int8)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_iterate_and_residuals_match_jax(name):
    jp, tp, x0 = PAIRS[name]()
    rng = np.random.default_rng(5)
    n, m = jp.num_variables, jp.num_cons
    x = np.asarray(x0) + 2.0 * rng.standard_normal(n)  # partly outside the box
    jit0 = jit_.create_iterate(jp, jnp.asarray(x))
    tit0 = tit.create_iterate(tp, x)
    assert not mismatches(flat_port(tit0), flat_jax(jit0), 1e-12)

    # duals of both signs and a working set, as a solve leaves them
    import dataclasses

    duals = dict(cons_dual=rng.standard_normal(m), vars_dual=rng.standard_normal(n),
                 var_states=_states(rng, n), cons_states=_states(rng, m))
    jit1 = dataclasses.replace(jit0, **{k: jnp.asarray(v) for k, v in duals.items()})
    tit1 = port_iterate(jit1)
    for ref, got in zip(jit_.kkt_residuals(jp.data, jit1), tit.kkt_residuals(tp.data, tit1)):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-12, atol=1e-14)
    for tol in (1e-6, 1e3):
        assert bool(tit.is_optimal(tp.data, tit1, tol, tol, tol)) == bool(
            jit_.is_optimal(jp.data, jit1, tol, tol, tol))
    np.testing.assert_array_equal(
        tit.violated_cons_multipliers(tp.data, tit1.cons_val, tit1.cons_states).numpy(),
        np.asarray(jit_.violated_cons_multipliers(jp.data, jit1.cons_val, jit1.cons_states)))
    np.testing.assert_allclose(float(tit.total_violation(tp.data, tit1.cons_val)),
                               float(jit_.total_violation(jp.data, jit1.cons_val)), rtol=1e-12)
    np.testing.assert_allclose(
        tit.slack_residual_values(tit1.x, tp.data.var_lb, tp.data.var_ub, tit1.vars_dual).numpy(),
        np.asarray(jit_.slack_residual_values(jit1.x, jp.data.var_lb, jp.data.var_ub,
                                              jit1.vars_dual)), rtol=1e-12)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_merit_models_match_jax(name):
    jp, tp, x0 = PAIRS[name]()
    rng = np.random.default_rng(7)
    n, m = jp.num_variables, jp.num_cons
    jit0 = jit_.create_iterate(jp, jnp.asarray(x0))
    tit0 = tit.create_iterate(tp, x0)
    d = rng.standard_normal(n)
    hd = rng.standard_normal(n)
    jd = jme.make_direction(jit0, jnp.asarray(d), jnp.asarray(hd))
    td = tme.make_direction(tit0, torch.as_tensor(d), torch.as_tensor(hd))
    assert not mismatches(flat_port(td), flat_jax(jd), 1e-12)
    assert not mismatches(flat_port(td.scale(torch.tensor(0.3, dtype=torch.float64))),
                          flat_jax(jd.scale(jnp.asarray(0.3))), 1e-12)
    assert not mismatches(flat_port(tme.Direction.zero_like(td)),
                          flat_jax(jme.Direction.zero_like(jd)), 0.0)
    for pen in (0.5, 10.0, 1e4):
        jpen, tpen = jnp.asarray(pen), torch.tensor(pen, dtype=torch.float64)
        for jf, tf, args in ((jme.merit_func, tme.merit_func, ()),
                             (jme.merit_linear, tme.merit_linear, (jd,)),
                             (jme.merit_quadratic, tme.merit_quadratic, (jd,))):
            targs = (td,) if args else ()
            np.testing.assert_allclose(float(tf(tp.data, tit0, *targs, tpen)),
                                       float(jf(jp.data, jit0, *args, jpen)), rtol=1e-12)
    # zero direction: the linear model is the exact merit (test_foundations)
    zero = tme.make_direction(tit0, torch.zeros(n, dtype=torch.float64),
                              torch.zeros(n, dtype=torch.float64))
    ten = torch.tensor(10.0, dtype=torch.float64)
    assert float(tme.merit_linear(tp.data, tit0, zero, ten)) == float(
        tme.merit_func(tp.data, tit0, ten))


def test_residuals_of_wachbieg_start():
    """test_foundations.py::test_iterate_and_residuals on the port."""
    _, tp, x0 = wachbieg()
    feas, slack, stat = tit.kkt_residuals(tp.data, tit.create_iterate(tp, x0))
    assert (float(feas), float(slack), float(stat)) == (3.5, 0.0, 1.0)
