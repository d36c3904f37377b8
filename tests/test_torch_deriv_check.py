"""Port parity of the derivative check (sleqp_tpu_torch/deriv_check.py)
against sleqp_tpu/deriv_check.py: tests/test_harness.py's two cases
(HS71's AD derivatives pass; a wrong gradient raises
``InvalidDerivativeError``), and a wrong override of each derivative, for
which both packages report the same findings (kind and index), their
printed numbers within 1e-6 relative."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu as jx
import sleqp_tpu_torch as tx
import torch_dense
from sleqp_tpu.deriv_check import InvalidDerivativeError as JaxInvalidDerivativeError
from sleqp_tpu.deriv_check import check_derivatives as jax_check_derivatives
from sleqp_tpu_torch.deriv_check import InvalidDerivativeError, check_derivatives
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_deriv_check_passes_on_ad():
    jp, tp, x0 = torch_dense.hs71()
    assert jax_check_derivatives(jp, jnp.asarray(x0)) == []
    assert check_derivatives(tp, x0) == []


def _wrong(kind):
    """(JAX problem, port problem, x) with one wrong derivative override:
    f = x.x, c = (x0 x1, x0 + x1^2)."""
    j_obj, t_obj = (lambda x: jnp.vdot(x, x)), (lambda x: x @ x)
    j_cons = lambda x: jnp.array([x[0] * x[1], x[0] + x[1] ** 2])  # noqa: E731
    t_cons = lambda x: torch.stack([x[0] * x[1], x[0] + x[1] ** 2])  # noqa: E731
    kw_j, kw_t = {}, {}
    if kind == "obj_grad":  # should be 2x
        kw_j["obj_grad"], kw_t["obj_grad"] = (lambda x: 3.0 * x), (lambda x: 3.0 * x)
    elif kind == "cons_jac":  # entry (1, 1) should be 2 x1
        kw_j["cons_jac"] = lambda x: jnp.array([[x[1], x[0]], [1.0, 3.0 * x[1]]])
        kw_t["cons_jac"] = lambda x: torch.stack([torch.stack([x[1], x[0]]),
                                                  torch.stack([torch.ones_like(x[1]),
                                                               3.0 * x[1]])])
    else:  # the Lagrangian Hessian product without its constraint curvature
        kw_j["hess_prod"] = kw_t["hess_prod"] = lambda x, d, mu: 2.0 * d
    jp = jx.Problem(jx.Func(j_obj, 2, cons=j_cons, num_cons=2, **kw_j))
    tp = tx.Problem(tx.Func(t_obj, 2, cons=t_cons, num_cons=2, **kw_t), device="cpu")
    return jp, tp, np.array([1.0, 2.0])


def _keys_and_values(findings):
    keys, values = [], []
    for line in findings:
        keys.append(line.split(":")[0])
        values.append([float(v) for v in re.findall(r"[-+]?\d\.\d+e[-+]\d+", line)][:2])
    return keys, values


@pytest.mark.parametrize("kind", ["obj_grad", "cons_jac", "hess_prod"])
def test_deriv_check_catches_wrong_derivative(kind):
    jp, tp, x = _wrong(kind)
    with pytest.raises(JaxInvalidDerivativeError):
        jax_check_derivatives(jp, jnp.asarray(x))
    with pytest.raises(InvalidDerivativeError):
        check_derivatives(tp, x)
    ref = jax_check_derivatives(jp, jnp.asarray(x), raise_on_failure=False)
    got = check_derivatives(tp, x, raise_on_failure=False)
    (ref_keys, ref_vals), (keys, vals) = _keys_and_values(ref), _keys_and_values(got)
    # a wrong Jacobian also moves the Lagrangian gradient of the Hessian check
    assert keys == ref_keys and keys and keys[0].startswith(kind), (got, ref)
    for v, r in zip(vals, ref_vals):
        np.testing.assert_allclose(v, r, rtol=1e-6, atol=1e-6)
