"""Port parity: the masked KKT solves, sleqp_tpu_torch/ops/kkt.py against
sleqp_tpu/ops/kkt.py (oracles of tests/test_kkt.py), on both factorization
routes ("reduced": Cholesky of the Schur complement, "direct": QR), to
1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleqp_tpu.ops import kkt as jkkt
from sleqp_tpu_torch.ops import kkt as tkkt
from torch_parity import no_jax_cache_writes  # noqa: F401

# (n, m, active variables, active constraints)
SYSTEMS = [(6, 3, 1, 2), (8, 5, 3, 4), (5, 4, 0, 4), (4, 0, 2, 0), (7, 3, 0, 0)]


def _system(n, m, nv, nc, seed):
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((m, n))
    vs = np.zeros(n, np.int8)
    vs[rng.permutation(n)[:nv]] = rng.integers(1, 4, nv)
    cs = np.zeros(m, np.int8)
    cs[rng.permutation(m)[:nc]] = rng.integers(1, 4, nc)
    return J, vs, cs, rng


def _dense_active_rows(J, vs, cs):
    n = J.shape[1]
    A = np.vstack([np.eye(n), J])
    active = np.concatenate([vs, cs]) != 0
    return A[active], active


@pytest.mark.parametrize("method", ["reduced", "direct"])
@pytest.mark.parametrize("shape", SYSTEMS)
def test_kkt_solves_match_jax(shape, method):
    J, vs, cs, rng = _system(*shape, seed=sum(shape))
    n, m = J.shape[1], J.shape[0]
    ja = jkkt.aug_jac_create(jnp.asarray(J), jnp.asarray(vs), jnp.asarray(cs), method=method)
    ta = tkkt.aug_jac_create(torch.as_tensor(J), torch.as_tensor(vs), torch.as_tensor(cs),
                             method=method)
    # the factor itself (QR's R is unique up to row signs)
    jc, tc = np.asarray(ja.chol), ta.chol.numpy()
    if method == "direct":
        jc, tc = np.abs(jc), np.abs(tc)
    np.testing.assert_allclose(tc, jc, atol=1e-10)
    np.testing.assert_array_equal(ta.active_var.numpy(), np.asarray(ja.active_var))

    rhs = rng.standard_normal(n + m)
    g = rng.standard_normal(n)
    x_ref = np.asarray(jkkt.solve_min_norm(ja, jnp.asarray(rhs)))
    x = tkkt.solve_min_norm(ta, torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(x, x_ref, atol=1e-10)
    A_w, active = _dense_active_rows(J, vs, cs)
    np.testing.assert_allclose(A_w @ x, rhs[active], atol=1e-10)

    p_ref, lam_ref = jkkt.solve_lsq(ja, jnp.asarray(g))
    p, lam = tkkt.solve_lsq(ta, torch.as_tensor(g))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-10)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), atol=1e-10)
    np.testing.assert_allclose(tkkt.project_nullspace(ta, torch.as_tensor(g)).numpy(),
                               np.asarray(jkkt.project_nullspace(ja, jnp.asarray(g))), atol=1e-10)
    np.testing.assert_allclose(A_w @ p.numpy(), 0.0, atol=1e-10)


def test_singular_working_set_gives_nan_factor_as_in_jax():
    """Two identical active rows: Sc is singular; both packages give a
    factor of NaNs (no error), so the step turns non-finite."""
    J = np.array([[1.0, 2.0, 0.0], [1.0, 2.0, 0.0]])
    vs, cs = np.zeros(3, np.int8), np.array([1, 1], np.int8)
    ja = jkkt.aug_jac_create(jnp.asarray(J), jnp.asarray(vs), jnp.asarray(cs))
    ta = tkkt.aug_jac_create(torch.as_tensor(J), torch.as_tensor(vs), torch.as_tensor(cs))
    np.testing.assert_array_equal(torch.isnan(ta.chol).numpy(), np.isnan(np.asarray(ja.chol)))
    assert torch.isnan(ta.chol).any()
    x = tkkt.solve_min_norm(ta, torch.ones(5, dtype=torch.float64))
    assert np.array_equal(np.isfinite(x.numpy()),
                          np.isfinite(np.asarray(jkkt.solve_min_norm(ja, jnp.ones(5)))))
