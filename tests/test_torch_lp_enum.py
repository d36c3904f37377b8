"""Port parity: vertex enumeration for tiny LPs,
sleqp_tpu_torch/ops/lp_enum.py against sleqp_tpu/ops/lp_enum.py (oracles
of tests/test_lp_enum.py): the same winning basis and statuses exactly,
x, duals, reduced costs and the objective to 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleqp_tpu.ops import lp_enum as je
from sleqp_tpu_torch.ops import lp_enum as te
from test_lp_enum import _random_cauchy_like
from torch_parity import no_jax_cache_writes  # noqa: F401

# one compiled program per LP shape (eager JAX compiles op by op)
jax_solve_enum = jax.jit(je.solve_enum)


def _assert_same(jr, tr, tol=1e-10):
    np.testing.assert_array_equal(tr.basis.numpy(), np.asarray(jr.basis))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    assert (tr.status.dtype, tr.basis.dtype) == (torch.int8, torch.int32)
    assert int(tr.state) == int(jr.state) and int(tr.iterations) == int(jr.iterations) == 1
    for key in ("x", "duals", "reduced_costs", "obj", "condition"):
        np.testing.assert_allclose(getattr(tr, key).numpy(), np.asarray(getattr(jr, key)),
                                   rtol=tol, atol=tol, err_msg=key)


@pytest.mark.parametrize("seed", range(3))
def test_random_cauchy_lps_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        A, lb, ub, c = _random_cauchy_like(rng)
        jr = jax_solve_enum(*(jnp.asarray(v) for v in (A, c, lb, ub)))
        tr = te.solve_enum(*(torch.as_tensor(v) for v in (A, c, lb, ub)))
        _assert_same(jr, tr)


def test_float32_matches_jax():
    A, lb, ub, c = _random_cauchy_like(np.random.default_rng(9))
    jr = jax_solve_enum(*(jnp.asarray(v, jnp.float32) for v in (A, c, lb, ub)))
    tr = te.solve_enum(*(torch.as_tensor(v).float() for v in (A, c, lb, ub)))
    _assert_same(jr, tr, tol=1e-4)


def test_ties_pick_the_first_basis_as_in_jax():
    """Two identical columns give equal-objective vertices: the lowest
    basis index wins in both packages."""
    A = np.array([[1.0, 1.0, 1.0, -1.0, -1.0]])
    lb = np.array([-1.0, -1.0, 0.0, 0.0, -2.0])
    ub = np.array([1.0, 1.0, 1e20, 1e20, 0.5])
    c = np.array([-1.0, -1.0, 10.0, 10.0, 0.0])
    jr = jax_solve_enum(*(jnp.asarray(v) for v in (A, c, lb, ub)))
    tr = te.solve_enum(*(torch.as_tensor(v) for v in (A, c, lb, ub)))
    _assert_same(jr, tr)


def test_gate_table_and_elimination_match_jax():
    for N, m in ((10, 2), (20, 3), (14, 4), (30, 5), (200, 2)):
        assert te.suitable(N, m) == je.suitable(N, m)
        assert te.num_candidates(N, m) == je.num_candidates(N, m)
    np.testing.assert_array_equal(te._combo_table(7, 3), je._combo_table(7, 3))
    # built once per (N, m) and device
    assert te.combo_table(7, 3, "cpu") is te.combo_table(7, 3, "cpu")
    rng = np.random.default_rng(1)
    M = rng.standard_normal((5, 3, 3))
    M[2] = [[0.0, 1.0, 2.0], [0.0, 3.0, 1.0], [0.0, 1.0, 1.0]]  # singular
    b = rng.standard_normal((5, 3))
    np.testing.assert_allclose(te._ge_solve(torch.as_tensor(M), torch.as_tensor(b)).numpy(),
                               np.asarray(je._ge_solve(jnp.asarray(M), jnp.asarray(b))),
                               rtol=1e-12, equal_nan=True)
