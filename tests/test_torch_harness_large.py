"""Port parity of the suite harness, large part: sleqp_tpu_torch/harness/
large.py and the driver's banded branch against sleqp_tpu/harness.

* one case per problem and quantity: sizes, bounds, X0 and f_opt equal to
  JAX's; the objective, its gradient, the constraints and the Jacobian
  blocks at X0 and at a seeded perturbation to 1e-12 (relative);
* the driver routes the banded rows to ``banded_solve``, rejects a time
  limit, and writes the CSV schema;
* the three rows at full size on both routes, each held to its r5 CSV
  row (``slow``: minutes on the CPU).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.harness.driver as jdriver
from sleqp_tpu.harness import large as jlarge
from sleqp_tpu_torch import Settings
from sleqp_tpu_torch.banded import BandedProblem
from sleqp_tpu_torch.harness import driver as tdriver
from sleqp_tpu_torch.harness import large as tlarge
from torch_harness import check_row
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUANTITIES = ("data", "obj", "obj_grad", "cons", "jac_blocks")


def _points(name, X0, lb, ub):
    """X0 and one in-bounds perturbation of it, seeded by the name."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    X1 = X0 + 0.3 * (1.0 + np.abs(X0)) * rng.standard_normal(X0.shape)
    return [X0, np.clip(X1, lb, ub)]


def test_registry_matches_jax():
    assert tlarge.LARGE_PROBLEMS == jlarge.LARGE_PROBLEMS
    assert tlarge.LARGE_PROBLEMS == ["bandnl16k", "bandqp10k", "bandrosen10k"]


@pytest.mark.parametrize("what", QUANTITIES)
@pytest.mark.parametrize("name", jlarge.LARGE_PROBLEMS)
def test_problem_matches_jax(name, what):
    jp, jX0, jf = jlarge.get_problem(name)
    tp, tX0, tf = tlarge.get_problem(name, "cpu")
    assert isinstance(tp, BandedProblem) and tp.device.type == "cpu"
    if what == "data":
        assert (tp.N_b, tp.k, tp.q, tp.n, tp.m) == (jp.N_b, jp.k, jp.q, jp.n, jp.m)
        assert tf == jf
        assert tX0.dtype == torch.float64
        np.testing.assert_array_equal(tX0.numpy(), np.asarray(jX0))
        for key in ("var_lb", "var_ub", "cons_lb", "cons_ub"):
            np.testing.assert_array_equal(getattr(tp, key).numpy(), np.asarray(getattr(jp, key)))
        return
    for X in _points(name, np.asarray(jX0, np.float64), np.asarray(jp.var_lb),
                     np.asarray(jp.var_ub)):
        if what == "jac_blocks":
            ref = jax.jit(jp.cons_jac_blocks)(jnp.asarray(X))
            got = tp.cons_jac_blocks(torch.as_tensor(X))
        else:
            ref = (jax.jit(getattr(jp, what))(jnp.asarray(X)),)
            got = (getattr(tp, what)(torch.as_tensor(X)),)
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert g.dtype == torch.float64 and tuple(g.shape) == r.shape
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                       atol=1e-12 * max(1.0, float(np.abs(r).max())))


def test_driver_schema_and_time_limit():
    """The driver finds the banded rows, solves them with banded_solve (one
    iteration here), writes the reference's schema with the Levenberg
    regularization in the trust-radius column, and rejects a time limit as
    the reference does."""
    assert set(tlarge.LARGE_PROBLEMS) <= set(tdriver.ALL_PROBLEMS)
    problem, _, _ = tdriver.get_problem("bandqp10k", "cpu")
    assert isinstance(problem, BandedProblem)
    with pytest.raises(ValueError, match="time_limit"):
        tdriver.run_problem("bandqp10k", time_limit=10.0, device="cpu")
    with pytest.raises(ValueError, match="time_limit"):
        jdriver.run_problem("bandqp10k", time_limit=10.0)
    row, solved, obj_ok = tdriver.run_problem("bandqp10k", Settings(), max_iterations=1,
                                              device="cpu")
    fields = row.split(";")
    assert len(fields) == 14 and fields[:3] == ["bandqp10k", "10240", "2544"]
    assert fields[3] == "iter_limit" and fields[8] == "1" and not solved and obj_ok
    assert fields[10] == "false" and float(fields[12]) == float(fields[13]) == 0.0


@pytest.mark.slow
@pytest.mark.parametrize("route", ["float64", "mixed"])
@pytest.mark.parametrize("name", jlarge.LARGE_PROBLEMS)
def test_row_matches_r5(name, route):
    settings = Settings(compute_dtype="float32") if route == "mixed" else Settings()
    row, solved, obj_ok = tdriver.run_problem(name, settings, device="cpu")
    assert solved and obj_ok, row
    check_row(row, route)
