"""Port parity of the scipy-style front end: sleqp_tpu_torch.minimize
against sleqp_tpu.minimize on the 11 cases of tests/test_minimize.py.

Each case runs the same problem through both packages, written once with
torch operations for the port and once with jax.numpy for the reference
(a numpy function is the same callable for both).  The results must have
the same status, success flag and message, ``fun`` within 1e-6 and ``x``
within 1e-6 (the host path's finite differences and damped BFGS leave x
at the solve's tolerance), and the iteration counts within
``NIT_SLACK``; each also passes the reference test's own checks.  The
port's torch-traceable path is told from its host path by a probe under
``torch.func.grad``: the numpy functions take the host path in both
packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import Bounds, LinearConstraint, NonlinearConstraint

from sleqp_tpu.minimize import minimize as jax_minimize
from sleqp_tpu_torch import minimize as lazy_minimize
from sleqp_tpu_torch.minimize import _is_traceable, minimize
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NIT_SLACK = 3  # the host path's BFGS runs on finite differences in both


def rosen(xp, b=100.0):
    return lambda x: (1.0 - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2


def np_rosen10(x):
    x = np.asarray(x)
    return float((1.0 - x[0]) ** 2 + 10.0 * (x[1] - x[0] ** 2) ** 2)


def np_sq(x):
    return float(np.sum(np.asarray(x) ** 2))


def np_sq_jac(x):
    return 2.0 * np.asarray(x)


def hs71_obj(x):
    return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]


def cases():
    """name -> (JAX call, port call, the reference test's own checks)."""

    def both(fun_j, fun_t, x0, **kw):
        return (dict(fun=fun_j, x0=x0, **kw), dict(fun=fun_t, x0=x0, **kw))

    def hs71_cons(dot):
        return [{"type": "ineq", "fun": lambda x: x[0] * x[1] * x[2] * x[3] - 25.0},
                {"type": "eq", "fun": lambda x: dot(x, x) - 40.0}]

    out = {}
    out["unconstrained_rosenbrock"] = (*both(rosen(jnp), rosen(torch), np.zeros(2)),
                                       lambda r: (np.testing.assert_allclose(r.x, [1.0, 1.0],
                                                                             atol=1e-6),
                                                  r.nit > 0))
    out["unconstrained_numpy_findiff"] = (*both(np_rosen10, np_rosen10, np.zeros(2)),
                                          lambda r: np.testing.assert_allclose(r.x, [1.0, 1.0],
                                                                               atol=1e-4))
    out["numpy_with_jac"] = (*both(np_sq, np_sq, np.array([3.0, -4.0]), jac=np_sq_jac),
                             lambda r: np.testing.assert_allclose(r.x, [0.0, 0.0], atol=1e-6))
    box = lambda x: (x[0] + 1.0) ** 2 + (x[1] - 2.0) ** 2  # noqa: E731
    out["bounds_pairs"] = (*both(box, box, np.zeros(2), bounds=[(0, None), (None, 1.0)]),
                           lambda r: np.testing.assert_allclose(r.x, [0.0, 1.0], atol=1e-6))
    out["scipy_bounds_object"] = (
        *both(lambda x: jnp.vdot(x, x), lambda x: x @ x, np.array([2.0, 2.0]),
              bounds=Bounds(1.0, 3.0)),
        lambda r: (np.testing.assert_allclose(r.x, [1.0, 1.0], atol=1e-6),
                   np.all(r.mult_x <= 1e-10) or pytest.fail("bound duals' sign")))
    jax_hs71, port_hs71 = both(hs71_obj, hs71_obj, np.array([1.0, 5.0, 5.0, 1.0]),
                               bounds=[(1, 5)] * 4)
    jax_hs71["constraints"] = hs71_cons(jnp.vdot)
    port_hs71["constraints"] = hs71_cons(torch.dot)
    out["dict_constraints_hs71_style"] = (
        jax_hs71, port_hs71,
        lambda r: (np.testing.assert_allclose(r.x, [1.0, 4.742999, 3.821151, 1.379408],
                                              atol=1e-4),
                   r.maxcv <= 1e-6 or pytest.fail(f"maxcv {r.maxcv}")))
    lin = lambda x: -x[0] - 2.0 * x[1]  # noqa: E731
    out["linear_constraint"] = (
        *both(lin, lin, np.zeros(2), bounds=[(0, None), (0, None)],
              constraints=LinearConstraint(np.array([[1.0, 1.0]]), -np.inf, 1.0)),
        lambda r: np.testing.assert_allclose(r.x, [0.0, 1.0], atol=1e-8))
    sq = lambda x: x[0] ** 2 + x[1] ** 2  # noqa: E731
    out["nonlinear_constraint_object"] = (
        *both(sq, sq, np.array([2.0, 0.0]),
              constraints=NonlinearConstraint(lambda x: x[0] + x[1], 1.0, np.inf)),
        lambda r: np.testing.assert_allclose(r.x, [0.5, 0.5], atol=1e-6))
    out["maxiter_status"] = (*both(rosen(jnp), rosen(torch), np.zeros(2), maxiter=2),
                             lambda r: (not r.success and r.nit <= 2) or pytest.fail(str(r)))
    return out


CASES = cases()


@pytest.mark.parametrize("name", list(CASES))
def test_minimize_matches_jax(name):
    jax_kw, port_kw, checks = CASES[name]
    ref = jax_minimize(**jax_kw)
    res = minimize(**port_kw, device="cpu")
    checks(res)
    assert (res.status, bool(res.success), res.message) == (ref.status, bool(ref.success),
                                                          ref.message)
    np.testing.assert_allclose(res.fun, ref.fun, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.x, np.asarray(ref.x), rtol=0, atol=1e-6)
    assert abs(res.nit - ref.nit) <= NIT_SLACK, (res.nit, ref.nit)
    assert isinstance(res.x, np.ndarray) and res.jac.shape == res.x.shape


def test_callback_and_abort():
    results = {}
    for label, call, dot in (("jax", jax_minimize, jnp.vdot), ("port", minimize, torch.dot)):
        seen = []

        def cb(xk):
            seen.append(np.array(xk))
            return len(seen) >= 1  # abort at once

        kwargs = {} if label == "jax" else {"device": "cpu"}
        res = call(lambda x: dot(x, x), np.array([5.0, 5.0]), callback=cb, **kwargs)
        assert len(seen) >= 1
        results[label] = (res.status, res.nit, len(seen))
    assert results["port"] == results["jax"]


def test_unknown_option_raises():
    with pytest.raises(ValueError):
        jax_minimize(lambda x: jnp.vdot(x, x), np.zeros(2), nonsense_option=3)
    with pytest.raises(ValueError, match="nonsense_option"):
        minimize(lambda x: x @ x, np.zeros(2), nonsense_option=3, device="cpu")


def test_traceable_probe_and_default_device(monkeypatch):
    """The probe sends numpy functions (which accept a CPU tensor when
    called plainly) and functions returning Python numbers to the host
    path; ``device=None`` is the card, so without one minimize raises.
    The package exports ``minimize`` lazily, callable in every import
    order (the reference's ``from sleqp_tpu import minimize`` gives its
    module)."""
    cpu = torch.device("cpu")
    x0 = np.array([0.5, 0.2])
    assert _is_traceable(rosen(torch), x0, (), cpu)
    assert not _is_traceable(np_rosen10, x0, (), cpu)
    assert not _is_traceable(lambda x: np.sin(x[0]) + x[1], x0, (), cpu)
    assert not _is_traceable(lambda x: float(x[0] * x[1]), x0, (), cpu)
    res = lazy_minimize(rosen(torch), np.zeros(2), device="cpu")
    assert res.success and res.x.shape == (2,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        minimize(rosen(torch), np.zeros(2))
