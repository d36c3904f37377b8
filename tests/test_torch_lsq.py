"""Port parity of least squares: ``LSQFunc``, trust-region LSQR
(sleqp_tpu_torch/ops/lsqr.py) and the Gauss-Newton EQP step
(sleqp_tpu_torch/gauss_newton.py) against the JAX package.

* ``lsqr_tr`` on random systems, inside and on the trust region: the
  iterate to 1e-10 (the packages round each of up to 12 bidiagonalization
  steps differently) and the same step count;
* ``LSQFunc``'s objective, gradient and Gauss-Newton Hessian product to
  1e-12, also in float32 (the dtype rule);
* one port iteration (its Newton step is Gauss-Newton + LSQR) from every
  JAX iterate of the Rosenbrock LSQ, the constrained LSQ and broydn
  (n = 20), to 1e-9;
* the 6 cases of tests/test_lsq.py, each held against JAX's whole solve:
  the same status, x to 1e-8 and the same iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.problem_solver as jps
from sleqp_tpu import LSQFunc as JaxLSQFunc
from sleqp_tpu import Problem as JaxProblem
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu import TRSolver as JaxTRSolver
from sleqp_tpu.ops.lsqr import lsqr_tr as jax_lsqr_tr
from sleqp_tpu_torch import LSQFunc, Problem, Settings, Status, TRSolver, solve
from sleqp_tpu_torch.ops.lsqr import lsqr_tr
from torch_dense import (
    broydn, constrained_lsq, iteration_mismatches, jax_states, rosenbrock_lsq,
)
from torch_parity import no_jax_cache_writes  # noqa: F401


@pytest.mark.parametrize("radius", [1e3, 0.5])
@pytest.mark.parametrize("shape", [(8, 5), (30, 12)])
def test_lsqr_tr_matches_jax(shape, radius):
    rng = np.random.default_rng(sum(shape))
    A = rng.standard_normal(shape)
    b = 10.0 * rng.standard_normal(shape[0])
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), torch.as_tensor(A), torch.as_tensor(b)
    dj, itj = jax_lsqr_tr(lambda v: Aj @ v, lambda u: Aj.T @ u, bj, radius, shape[1], 50)
    dt, itt = lsqr_tr(lambda v: At @ v, lambda u: At.T @ u, bt, radius, shape[1], 50)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-10, atol=1e-10)
    assert int(itt) == int(itj) and itt.dtype == torch.int32
    assert np.linalg.norm(dt.numpy()) <= radius + 1e-10


def test_lsqr_tr_zero_rhs_takes_no_step():
    A = torch.eye(3, dtype=torch.float64)
    d, it = lsqr_tr(lambda v: A @ v, lambda u: A.T @ u, torch.zeros(3, dtype=torch.float64),
                    1.0, 3, 10)
    assert int(it) == 0 and not d.any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lsq_func_matches_jax(dtype):
    jp, tp, x0 = broydn(12)
    rng = np.random.default_rng(4)
    x, d = rng.standard_normal(12), rng.standard_normal(12)
    xt, dt = torch.as_tensor(x, dtype=dtype), torch.as_tensor(d, dtype=dtype)
    mult = torch.zeros(0, dtype=dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    out = [tp.obj_val(xt), tp.obj_grad(xt), tp.hess_prod(xt, dt, mult)]
    ref = [jp.obj_val(jnp.asarray(x)), jp.obj_grad(jnp.asarray(x)),
           jp.hess_prod(jnp.asarray(x), jnp.asarray(d), jnp.zeros(0))]
    for o, r in zip(out, ref):
        assert o.dtype == dtype
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=tol, atol=tol)
    assert tp.func.psd_hessian and tp.func.num_residuals == 12
    lm = Problem(LSQFunc(tp.func.residuals, 12, 12, lm_factor=0.5), device="cpu")
    np.testing.assert_allclose((lm.hess_prod(xt, dt, mult) - out[2]).numpy(), 0.5 * dt.numpy(),
                               rtol=tol, atol=tol)


PAIRS = {"rosenbrock_lsq": rosenbrock_lsq, "constrained_lsq": constrained_lsq,
         "broydn20": lambda: broydn(20)}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_every_iteration_from_jax_state_matches_jax(name):
    jp, tp, x0 = PAIRS[name]()
    states = jax_states(jp, JaxSettings(), x0)
    assert int(states[-1].status) == Status.OPTIMAL
    # the Gauss-Newton step ran: it records no Rayleigh quotients
    assert all(float(s.max_rayleigh) == 0.0 for s in states)
    assert not iteration_mismatches(tp, Settings(), states)


# ---- the cases of tests/test_lsq.py ----------------------------------------


def _solve_both(jp, tp, x0, js=JaxSettings(), ts=Settings()):
    ref = jps.solve(jp, js, jnp.asarray(x0), max_iterations=300)
    out = solve(tp, ts, x0, max_iterations=300, device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=1e-8)
    assert int(out.iteration) == int(ref.iteration), (int(out.iteration), int(ref.iteration))
    return out


def test_lsqr_solves_least_squares():
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((8, 5)))
    b = torch.as_tensor(rng.standard_normal(8))
    d, _ = lsqr_tr(lambda v: A @ v, lambda u: A.T @ u, b, radius=1e3, n=5, max_iterations=50)
    expected, *_ = np.linalg.lstsq(A.numpy(), b.numpy(), rcond=None)
    np.testing.assert_allclose(d.numpy(), expected, atol=1e-8)


def test_lsqr_respects_radius():
    rng = np.random.default_rng(1)
    A = torch.as_tensor(rng.standard_normal((6, 4)))
    b = torch.as_tensor(10.0 * rng.standard_normal(6))
    d, _ = lsqr_tr(lambda v: A @ v, lambda u: A.T @ u, b, radius=0.5, n=4, max_iterations=50)
    assert float(torch.linalg.norm(d)) <= 0.5 + 1e-10


def test_rosenbrock_lsq_gauss_newton():
    out = _solve_both(*rosenbrock_lsq())
    np.testing.assert_allclose(out.it.x.numpy(), [1.0, 1.0], atol=1e-6)


def test_linear_lsq_one_shot():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((10, 4))
    b = rng.standard_normal(10)
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), torch.as_tensor(A), torch.as_tensor(b)
    jp = JaxProblem(JaxLSQFunc(lambda x: Aj @ x - bj, num_variables=4, num_residuals=10))
    tp = Problem(LSQFunc(lambda x: At.to(x) @ x - bt.to(x), num_variables=4, num_residuals=10),
                 device="cpu")
    out = _solve_both(jp, tp, np.zeros(4))
    expected, *_ = np.linalg.lstsq(A, b, rcond=None)
    np.testing.assert_allclose(out.it.x.numpy(), expected, atol=1e-6)


def test_constrained_lsq():
    out = _solve_both(*constrained_lsq())
    x = out.it.x.numpy()
    np.testing.assert_allclose(x[0] + x[1], 1.0, atol=1e-7)


def test_lsq_with_cg_fallback():
    """tr_solver=CG takes the projected Newton step on an LSQ function."""
    out = _solve_both(*rosenbrock_lsq(), js=JaxSettings(tr_solver=JaxTRSolver.CG),
                      ts=Settings(tr_solver=TRSolver.CG))
    np.testing.assert_allclose(out.it.x.numpy(), [1.0, 1.0], atol=1e-6)
