"""Port parity: the bounded-variable revised simplex,
sleqp_tpu_torch/ops/simplex.py against sleqp_tpu/ops/simplex.py (oracles
of tests/test_simplex.py).  The same basis statuses, pivot counts and
states exactly; x, duals and the objective to 1e-10.

Ties: the pricing and ratio tests rest on argmax/argmin, which in both
packages pick the first index of a tie and treat NaN as the extreme value;
a degenerate LP with exact ties and an LP whose ratio test meets NaN must
take the same pivots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_simplex as jax_simplex_tests
from sleqp_tpu.ops import simplex as js
from sleqp_tpu.types import INF, BaseStat
from sleqp_tpu_torch.ops import simplex as ts
from torch_parity import no_jax_cache_writes  # noqa: F401


def _lp(A_rows, row_lb, row_ub, col_lb, col_ub, c):
    A, lb, ub, cc = jax_simplex_tests._standard_form(A_rows, row_lb, row_ub, col_lb, col_ub, c)
    basis, status = jax_simplex_tests._slack_start(A_rows, col_lb, col_ub, row_lb, row_ub)
    lb = np.where(np.isfinite(lb), lb, np.sign(lb) * INF)
    ub = np.where(np.isfinite(ub), ub, np.sign(ub) * INF)
    return A, cc, lb, ub, basis, status


def _both(fn_name, A, c, lb, ub, basis, status, **kw):
    jr = getattr(js, fn_name)(*(jnp.asarray(v) for v in (A, c, lb, ub, basis, status)), **kw)
    tr = getattr(ts, fn_name)(*(torch.as_tensor(np.array(v)) for v in (A, c, lb, ub, basis, status)),
                              **kw)
    return jr, tr


def _assert_same(jr, tr, tol=1e-10):
    assert int(tr.state) == int(jr.state)
    assert int(tr.iterations) == int(jr.iterations)
    assert tr.iterations.dtype == torch.int32 and tr.state.dtype == torch.int32
    np.testing.assert_array_equal(tr.basis.numpy(), np.asarray(jr.basis))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    assert tr.status.dtype == torch.int8 and tr.basis.dtype == torch.int32
    if hasattr(jr, "x"):
        for key in ("x", "duals", "reduced_costs", "obj"):
            np.testing.assert_allclose(getattr(tr, key).numpy(), np.asarray(getattr(jr, key)),
                                       rtol=tol, atol=tol, err_msg=key)
        np.testing.assert_allclose(float(tr.condition), float(jr.condition), rtol=max(tol, 1e-8))


def _random_lp(seed, n=8, m=5):
    rng = np.random.default_rng(seed)
    A_rows = rng.standard_normal((m, n))
    col_lb = -rng.uniform(0.1, 2.0, n)
    col_ub = rng.uniform(0.1, 2.0, n)
    col_lb[0] = -np.inf  # a free column (ZERO status) and a one-sided one
    col_ub[0] = np.inf
    col_ub[1] = np.inf
    rest = np.where(np.abs(col_lb) <= np.abs(col_ub), col_lb, col_ub)
    rest = np.where(np.isfinite(rest), rest, 0.0)
    act = A_rows @ rest
    row_lb = np.minimum(-rng.uniform(0.5, 3.0, m), act - 0.1)
    row_ub = np.maximum(rng.uniform(0.5, 3.0, m), act + 0.1)
    row_lb[0] = -np.inf
    return A_rows, row_lb, row_ub, col_lb, col_ub, rng.standard_normal(n)


@pytest.mark.parametrize("seed", range(6))
def test_random_lps_match_jax(seed):
    jr, tr = _both("solve", *_lp(*_random_lp(seed)), max_iterations=500)
    assert int(jr.state) == js.OPTIMAL
    _assert_same(jr, tr)


@pytest.mark.parametrize("limit", [0, 1, 3])
def test_iteration_limit_matches_jax(limit):
    jr, tr = _both("solve", *_lp(*_random_lp(11)), max_iterations=limit)
    _assert_same(jr, tr)
    assert int(tr.state) == ts.ITERATION_LIMIT


def test_refactorization_schedule_matches_jax():
    """refactor_every=2: the basis inverse is rebuilt every second pivot."""
    jr, tr = _both("solve", *_lp(*_random_lp(4, n=12, m=7)), max_iterations=500, refactor_every=2)
    _assert_same(jr, tr)


def test_degenerate_lp_with_ties_matches_jax():
    """Identical columns and rows: the Devex scores and the ratio test tie
    exactly, and both packages take the first index."""
    A_rows = np.array([[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 1.0, 0.0], [0.0, 0.0, 1.0, 1.0]])
    col_lb, col_ub = np.zeros(4), np.ones(4)
    row_lb, row_ub = np.full(3, -1.0), np.array([1.0, 1.0, 1.0])
    c = np.array([-1.0, -1.0, -1.0, -1.0])
    jr, tr = _both("solve", *_lp(A_rows, row_lb, row_ub, col_lb, col_ub, c), max_iterations=100)
    assert int(jr.state) == js.OPTIMAL
    _assert_same(jr, tr)
    # Bland's rule from the start (stall counter past bland_after)
    jr, tr = _both("solve", *_lp(A_rows, row_lb, row_ub, col_lb, col_ub, c), max_iterations=100,
                   bland_after=-1)
    _assert_same(jr, tr)


def test_nan_in_ratio_test_matches_jax():
    """A NaN in a nonbasic column that rests at zero turns every basic
    value NaN, so the ratio test compares NaN: both packages must end in
    the same state with the same basis, and raise nothing."""
    A, c, lb, ub, basis, status = _lp(*_random_lp(2, n=5, m=3))
    A = A.copy()
    A[1, 2] = np.nan
    status = status.copy()
    status[2] = BaseStat.ZERO
    jr, tr = _both("solve", A, c, lb, ub, basis, status, max_iterations=50)
    assert int(tr.state) == int(jr.state)
    assert int(tr.iterations) == int(jr.iterations)
    np.testing.assert_array_equal(tr.basis.numpy(), np.asarray(jr.basis))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(np.isnan(tr.x.numpy()), np.isnan(np.asarray(jr.x)))


@pytest.mark.parametrize("values", [
    [1.0, 3.0, 3.0, 2.0], [np.nan, 1.0, np.nan], [2.0, np.nan, 5.0], [-np.inf, -np.inf, 0.0],
    [0.0, 0.0, 0.0]])
def test_argmax_argmin_tie_and_nan_rule(values):
    """The rule the pivoting rests on: the first index of a tie, NaN as
    the extreme value, in both packages."""
    v = np.array(values)
    assert int(torch.argmax(torch.as_tensor(v))) == int(jnp.argmax(jnp.asarray(v)))
    assert int(torch.argmin(torch.as_tensor(v))) == int(jnp.argmin(jnp.asarray(v)))
    np.testing.assert_array_equal(ts.sign(torch.as_tensor(v)).numpy(),
                                  np.asarray(jnp.sign(jnp.asarray(v))))


def test_dual_simplex_after_bound_shrink_matches_jax():
    """tests/test_simplex.py::test_dual_simplex_reoptimizes_after_bound_shrink
    on both packages: the dual stage and the finishing primal pass."""
    rng = np.random.default_rng(11)
    n, m = 10, 6
    A_rows = rng.standard_normal((m, n))
    c = rng.standard_normal(n)
    wide = np.abs(A_rows) @ np.ones(n) + 0.5
    A, cc, lb, ub, basis, status = _lp(A_rows, -wide, wide, -np.ones(n), np.ones(n), c)
    jr1, tr1 = _both("solve", A, cc, lb, ub, basis, status, max_iterations=500)
    _assert_same(jr1, tr1)
    shrunk_lb, shrunk_ub = lb.copy(), ub.copy()
    shrunk_lb[:n] *= 0.4  # the trust-region pattern of the Cauchy layer
    shrunk_ub[:n] *= 0.4
    shrunk_lb[n:] *= 0.1  # and rows tight enough that basic logicals leave
    shrunk_ub[n:] *= 0.1
    jd, td = _both("solve_dual", A, cc, shrunk_lb, shrunk_ub, np.asarray(jr1.basis),
                   np.asarray(jr1.status), max_iterations=500)
    _assert_same(jd, td)
    assert int(td.state) == ts.OPTIMAL and int(td.iterations) > 0
    jr2, tr2 = _both("solve", A, cc, shrunk_lb, shrunk_ub, np.asarray(jd.basis),
                     np.asarray(jd.status), max_iterations=500)
    _assert_same(jr2, tr2)
    assert int(tr2.iterations) == 0
    # the iteration cap and Bland's rule of the dual stage
    for kw in (dict(max_iterations=1), dict(max_iterations=500, bland_after=-1),
               dict(max_iterations=500, refactor_every=1)):
        jd, td = _both("solve_dual", A, cc, shrunk_lb, shrunk_ub, np.asarray(jr1.basis),
                       np.asarray(jr1.status), **kw)
        _assert_same(jd, td)


def test_float32_solve_then_full_precision_polish_matches_jax():
    """The mixed route's LP: pivots in float32, then the dual/primal
    finish in float64 (polish_full_precision) and refine_result."""
    A, c, lb, ub, basis, status = _lp(*_random_lp(6, n=10, m=6))
    f32 = [np.asarray(v, np.float32) for v in (A, c, lb, ub)]
    jr, tr = _both("solve", *f32, basis, status, max_iterations=500)
    _assert_same(jr, tr, tol=1e-4)
    jp = js.polish_full_precision(*(jnp.asarray(v) for v in (A, c, lb, ub)), jr, max_iterations=500)
    tp = ts.polish_full_precision(*(torch.as_tensor(v) for v in (A, c, lb, ub)), tr,
                                  max_iterations=500)
    _assert_same(jp, tp)
    jf = js.refine_result(*(jnp.asarray(v) for v in (A, c, lb, ub)), jr)
    tf = ts.refine_result(*(torch.as_tensor(v) for v in (A, c, lb, ub)), tr)
    _assert_same(jf, tf)


def test_singular_basis_qr_solve_and_refine_match_jax():
    B = np.array([[1.0, 2.0], [2.0, 4.0]])
    x_j = np.asarray(js.qr_solve(jnp.asarray(B), jnp.ones(2)))
    x_t = ts.qr_solve(torch.as_tensor(B), torch.ones(2, dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(np.isfinite(x_t), np.isfinite(x_j))
    # a singular final basis is zeroed and demoted to ITERATION_LIMIT
    A, c, lb, ub, basis, status = _lp(*_random_lp(1, n=4, m=2))
    A = A.copy()
    A[:, 5] = A[:, 4]  # the two logical columns (the basis) coincide
    jr, tr = _both("solve", A, c, lb, ub, basis, status, max_iterations=0)
    jf = js.refine_result(*(jnp.asarray(v) for v in (A, c, lb, ub)), jr)
    tf = ts.refine_result(*(torch.as_tensor(v) for v in (A, c, lb, ub)), tr)
    assert int(tf.state) == int(jf.state) == ts.ITERATION_LIMIT
    np.testing.assert_array_equal(tf.x.numpy(), np.asarray(jf.x))
    assert float(tf.condition) == float(jf.condition) == np.inf
