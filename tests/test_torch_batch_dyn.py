"""Port parity of the batched solve of dynamic (inexact) functions:
sleqp_tpu_torch.parallel.batch against sleqp_tpu.parallel.batch on the two
``DynFunc`` problems of tests/test_dyn.py, and ``DynFunc``'s evaluations
under ``torch.func.vmap`` against their single-lane calls.

* Rosenbrock with bound-controlled noise and the constrained quadratic
  (``chip_smoke.dyn_problems``, the user's ``eval`` written for one x) at B
  = 8, from x0 and seven starts x0 + U(-0.5, 0.5): lanes against JAX's
  and against the port's single lanes as ``torch_batch_routes`` sets out.
  The lanes refine their error bounds at different iterations (the
  refresh of the iterate and the accuracy gate are per lane).
* ``batched_solve_mp`` on a ``DynFunc`` is ``batched_solve`` bit for bit
  (the reference's fallback: float32 cannot hold the error bounds), and
  ``batched_solve_chunked`` in chunks of 4 equals the whole batch.
* ``eval_at``, ``eval_all_dyn`` and ``hess_prod_dyn`` under ``vmap`` on
  lanes with their own x, error bound, penalty and multipliers: each
  lane's values against the single-lane call to 1e-12.
* Host reads: equal at B = 8 and B = 64; one lane reads and ends as the
  single-lane solve did before the refresh ran in lanes (SEED_LANES).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_batch_routes as routes
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu_torch import Settings, Status
from sleqp_tpu_torch.lanes import vmap_lanes
from sleqp_tpu_torch.parallel import batch as pb
from test_dyn import _dyn_constrained, _dyn_rosenbrock
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAX_IT = 500  # tests/test_dyn.py's
JAX_PROBLEMS = {"rosenbrock": _dyn_rosenbrock, "constrained": _dyn_constrained}
SEEDS = {"rosenbrock": 10, "constrained": 11}


def _pair(name):
    jp, _ = JAX_PROBLEMS[name]()
    tp, x0, _, _ = chip_smoke.dyn_problems("cpu")[name]
    return jp, tp, routes.spread_starts(x0, 0.5, SEEDS[name])


@pytest.fixture(scope="module", params=sorted(JAX_PROBLEMS))
def case(request):
    jp, tp, x0b = _pair(request.param)
    return dict(routes.run_case(jp, tp, JaxSettings(), Settings(), x0b, MAX_IT),
                key=request.param)


def test_lanes_match_jax(case):
    routes.assert_lanes_match_jax(case, {})
    out = case["out"]
    assert np.all(out.status.numpy() == Status.OPTIMAL)
    np.testing.assert_allclose(out.error_bound.numpy(), case["ref"].error_bound, rtol=1e-8)
    # every lane tightened its bound, not all by the same factor
    assert bool((out.error_bound < 1.0).all()) and len(set(out.error_bound.tolist())) > 1


def test_lanes_match_single_lane(case):
    routes.assert_lanes_match_single_lane(case, {})
    bounds = np.array([float(s.error_bound) for s in case["single"]])
    # the final bounds come from model reductions at rounding level (1e-21)
    np.testing.assert_allclose(case["out"].error_bound.numpy(), bounds, rtol=1e-8)


def test_batched_solve_mp_is_batched_solve(case):
    """batched_solve_mp sends a DynFunc to batched_solve, and the chunked
    solve's chunks of 4 give the whole batch's lanes."""
    tp, x0b, out = case["tp"], case["x0b"], case["out"]
    mp = pb.batched_solve_mp(tp, Settings(), x0b, MAX_IT, device="cpu")
    for a, b in zip(pb.tree_leaves(mp), pb.tree_leaves(out)):
        assert torch.equal(a, b)
    chunked = pb.batched_solve_chunked(tp, Settings(), x0b, MAX_IT, chunk_size=4, device="cpu")
    assert torch.equal(chunked.status, out.status)
    assert torch.equal(chunked.iteration, out.iteration)
    np.testing.assert_allclose(chunked.it.x.numpy(), out.it.x.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(JAX_PROBLEMS))
def test_evaluations_under_vmap(name):
    _, tp, x0b = _pair(name)
    func = tp.func
    rng = np.random.default_rng(3)
    x = torch.as_tensor(x0b)
    bound = torch.as_tensor(10.0 ** rng.uniform(-6, 0, len(x0b)))
    penalty = torch.as_tensor(rng.uniform(1.0, 100.0, len(x0b)))
    duals = torch.as_tensor(rng.standard_normal((len(x0b), func.num_cons)))
    d = torch.as_tensor(rng.standard_normal(x.shape))

    def evaluate(x, bound, penalty, duals, d):
        return (func.eval_at(x, bound, penalty), func.eval_all_dyn(x, bound, penalty),
                func.hess_prod_dyn(x, d, duals, bound, penalty))

    lanes = vmap_lanes(evaluate, x, bound, penalty, duals, d)
    for b in range(len(x0b)):
        alone = evaluate(x[b], bound[b], penalty[b], duals[b], d[b])
        for got, ref in zip(pb.tree_leaves(pb.lane(lanes, b)), pb.tree_leaves(alone)):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(JAX_PROBLEMS))
def test_host_reads_do_not_grow_with_lanes(name):
    _, tp, x0b = _pair(name)
    routes.assert_reads_do_not_grow(tp, Settings(), x0b, MAX_IT)


@pytest.mark.parametrize("name", sorted(JAX_PROBLEMS))
def test_single_lane_keeps_seed_reads_and_bits(name):
    """tests/test_torch_dyn.py's solves from their x0."""
    tp, x0, _, _ = chip_smoke.dyn_problems("cpu")[name]
    routes.assert_seed_lane(f"dyn_{name}", tp, Settings(), x0, MAX_IT)
