"""Port parity of the batched solve with quasi-Newton Hessians:
sleqp_tpu_torch.parallel.batch against sleqp_tpu.parallel.batch, and the
ring-buffer pushes under ``torch.func.vmap`` against their single-lane
calls.

* HS71 at B = 8 (tests/test_misc.py's starts) under DAMPED_BFGS,
  SIMPLE_BFGS and SR1; tests/test_quasi_newton.py's Rosenbrock (m = 0)
  under the three, and its two block-structured Rosenbrocks
  (``hess_struct``) under DAMPED_BFGS, from x0 and seven starts x0 +
  U(-0.5, 0.5).  Lanes against JAX's and against the port's single lanes
  as ``torch_batch_routes`` sets out, the ties named in ``JAX_TIES`` and
  ``TIES``.  On HS71 the working set often pins every direction, so P g
  is rounding noise that GLTR follows (tests/test_torch_batch.py): the
  lanes' products sum in another order than one lane's, and three lanes
  of 24 part from their single-lane solves there, one from JAX's.
* ``bfgs_push`` (damped and not, with and without sizing) and
  ``sr1_push`` under ``vmap`` on lanes holding 0, 1, W and W + 3 pairs
  (one lane's pair is one the SR1 skip rule leaves out), and the block-structured
  push and product: every field of every lane against the single-lane
  push to 1e-12, and the product to 1e-12 of its rounding scale.
* ``batched_solve_mp`` with DAMPED_BFGS (test_torch_batch_mp.py's B = 8
  starts): its float32 phase 1 held as a distribution (phase-1 OPTIMAL
  counts over start sets moved by float32 ulps against JAX's) and its
  phase 2 lane by lane (``chip_smoke.phase1_mismatch``).
* ``batched_step``, ``batched_solve_chunked``, ``multistart_solve`` and
  ``sharded_solve`` (four gloo ranks of tests/torch_dist.py) on this
  route.
* Host reads: equal at B = 8 and B = 64; one lane reads and ends as the
  single-lane solve did before the push ran in lanes (SEED_LANES).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_batch_routes as routes
import torch_dense
import torch_dist
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.parallel import batch as jbatch
from sleqp_tpu.types import HessEval as JaxHessEval
from sleqp_tpu_torch import HessEval, Settings, Status
from sleqp_tpu_torch import quasi_newton as tqn
from sleqp_tpu_torch.lanes import vmap_lanes
from sleqp_tpu_torch.parallel import batch as pb
from test_torch_batch import hs71_starts
from test_torch_batch_mp import hs71_starts as mp_starts
from test_torch_batch_mp import jax_phase1
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

METHODS = ("DAMPED_BFGS", "SIMPLE_BFGS", "SR1")


def _problem(name):
    if name == "hs71":
        jp, tp, _ = torch_dense.hs71()
        return jp, tp, hs71_starts()[0], 100
    if name == "rosenbrock":
        jp, tp, x0 = torch_dense.rosenbrock()
        return jp, tp, routes.spread_starts(x0, 0.5, 2), 1000
    jp, tp, x0 = routes.two_rosenbrocks()
    return jp, tp, routes.spread_starts(x0, 0.5, 3), 1000


CASES = {f"{name}_{m}": (name, m) for name in ("hs71", "rosenbrock") for m in METHODS}
CASES["blocks_DAMPED_BFGS"] = ("blocks", "DAMPED_BFGS")

# lanes whose x parts from JAX's batched lane by more than 1e-8, or whose
# iterations differ
JAX_TIES = {"hs71_SR1": {5: "6 iterations against JAX's 7, x 7.0e-7 apart"}}
# lanes that part from the port's single-lane solve by more than 1e-12
TIES = {
    "hs71_DAMPED_BFGS": {0: "8 iterations alone, 5 in lanes (as JAX's lane and JAX alone)"},
    "hs71_SIMPLE_BFGS": {0: "x 3.7e-8 apart, 8 iterations each"},
    "hs71_SR1": {0: "9 iterations alone, 8 in lanes (as JAX's lane)",
                 5: "7 iterations alone, 6 in lanes, x 7.2e-7 apart"},
}


def _settings(method):
    return JaxSettings(hess_eval=JaxHessEval[method]), Settings(hess_eval=HessEval[method])


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name, method = CASES[request.param]
    jp, tp, x0b, max_it = _problem(name)
    js, ts = _settings(method)
    return dict(routes.run_case(jp, tp, js, ts, x0b, max_it), key=request.param)


def test_lanes_match_jax(case):
    routes.assert_lanes_match_jax(case, JAX_TIES.get(case["key"], {}))
    assert np.all(case["out"].status.numpy() == Status.OPTIMAL)
    # pairs were pushed on every lane
    qn = case["out"].qn
    counts = torch.stack([q.count for q in qn]) if isinstance(qn, tuple) else qn.count[None]
    assert bool((counts > 0).all())


def test_lanes_match_single_lane(case):
    routes.assert_lanes_match_single_lane(case, TIES.get(case["key"], {}))


# ---- the pushes in lanes ----------------------------------------------------


PUSHES = {
    "damped_bfgs_sized": (HessEval.DAMPED_BFGS, True),
    "damped_bfgs": (HessEval.DAMPED_BFGS, False),
    "simple_bfgs_sized": (HessEval.SIMPLE_BFGS, True),
    "simple_bfgs": (HessEval.SIMPLE_BFGS, False),
    "sr1": (HessEval.SR1, True),
}
N, W = 6, 5
LANE_PAIRS = (0, 1, W, W + 3)


def _pair_lists(n, seed):
    """One list of (s, y) pairs a lane: 0, 1, W and W + 3 pairs with
    indefinite curvature (some damped)."""
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(n), rng.standard_normal(n)) for _ in range(k)]
            for k in LANE_PAIRS]


def _lanes_of(states):
    return pb.tree_map(lambda *ts: torch.stack(ts), *states)


def _pushed_lanes(hess_eval, sizing, blocks=None, n=N, window=W, seed=7):
    """The lanes' ring buffers before the push, the pairs to push, the
    vmapped push and products, and the single-lane ones."""
    rng = np.random.default_rng(seed + 1)
    states = []
    for pairs in _pair_lists(n, seed):
        q = tqn.qn_init(n, window, torch.float64, blocks=blocks)
        for s, y in pairs:
            q = tqn.qn_push(q, torch.as_tensor(s), torch.as_tensor(y), hess_eval, sizing,
                            blocks=blocks)
        states.append(q)
    s_new = torch.as_tensor(rng.standard_normal((len(states), n)))
    y_new = torch.as_tensor(rng.standard_normal((len(states), n)))
    # lane 0 pushes y = s + v with v orthogonal to s: the scale is 1 and the
    # SR1 residual v is orthogonal to s, a slot the skip rule leaves empty
    v = torch.as_tensor(rng.standard_normal(n))
    y_new[0] = s_new[0] + v - (v @ s_new[0]) / (s_new[0] @ s_new[0]) * s_new[0]
    probe = torch.as_tensor(rng.standard_normal((len(states), n)))

    def push_and_apply(q, s, y, d):
        q = tqn.qn_push(q, s, y, hess_eval, sizing, blocks=blocks)
        return q, tqn.qn_product(q, d, hess_eval, blocks=blocks)

    lanes = vmap_lanes(push_and_apply, _lanes_of(states), s_new, y_new, probe)
    alone = [push_and_apply(q, s_new[b], y_new[b], probe[b]) for b, q in enumerate(states)]
    return (*lanes, probe), alone


def _product_scale(q, d):
    """The rounding scale of the product B d: each slot's dot products
    round relative to |v| |d| and are divided by s^T B s or s^T r, so the
    largest of |scale d| and |v|^2 |d| / |s^T v| over the slots' P and R
    rows (a damped ring buffer with a tiny s^T B s or s^T r cancels terms
    of 1e4 to a product of 1)."""
    dn = float(torch.linalg.norm(d))
    terms = [float(q.scale.abs()) * dn, 1.0]
    for j in range(q.S.shape[0]):
        terms.append(float(torch.linalg.norm(q.P[j]) ** 2 / q.bidir[j].abs()) * dn)
        terms.append(float(torch.linalg.norm(q.R[j]) ** 2 / q.rdot[j].abs()) * dn)
    return max(terms)


@pytest.mark.parametrize("name", sorted(PUSHES))
def test_push_lanes_match_single_lane(name):
    hess_eval, sizing = PUSHES[name]
    lanes, alone = _pushed_lanes(hess_eval, sizing)
    counts = []
    for b, single in enumerate(alone):
        got = torch_dense.flat_port(pb.lane(lanes, b)[0])
        assert not torch_dense.mismatches(got, torch_dense.flat_port(single[0]), 1e-12), (name, b)
        gap = float((lanes[1][b] - single[1]).abs().max())
        assert gap <= 1e-12 * _product_scale(single[0], lanes[2][b]), (name, b, gap)
        counts.append(int(single[0].count))
    assert counts == [1, 2, W, W]
    if hess_eval == HessEval.SR1:
        # lane 0's pair was skipped: its slot holds R = 0, rdot = 1
        assert bool((lanes[0].R[0, -1] == 0).all()) and float(lanes[0].rdot[0, -1]) == 1.0


@pytest.mark.parametrize("hess_eval", [HessEval.DAMPED_BFGS, HessEval.SR1])
def test_block_push_lanes_match_single_lane(hess_eval):
    """Per-block ring buffers with a variable outside every block: the
    vmapped push and product against the single lane's, the outside
    variable's curvature row zero on every lane."""
    blocks = ((0, 2), (3, 6))
    lanes, alone = _pushed_lanes(hess_eval, True, blocks=blocks, n=7, window=3, seed=11)
    for b, single in enumerate(alone):
        got = torch_dense.flat_port(pb.lane(lanes[:2], b))
        assert not torch_dense.mismatches(got, torch_dense.flat_port(single), 1e-12), b
    product = lanes[1]
    assert bool((product[:, 2] == 0).all() & (product[:, 6] == 0).all())


# ---- batched_solve_mp -------------------------------------------------------


MP_PERTURBATIONS = 8


def test_batched_solve_mp_damped_bfgs():
    """The two-phase batched solve with DAMPED_BFGS: the float64 result as
    JAX's (statuses, objectives to 1e-7, x to the solve's 1e-6); phase 1's
    OPTIMAL counts over MP_PERTURBATIONS start sets (test_torch_batch_mp.py's
    starts moved by 4 k float32 ulps, 8 lanes each, one batch of 64 in
    either package) with means no more than four standard errors apart,
    and phase 2 lane by lane (``chip_smoke.phase1_mismatch``)."""
    jp, tp, _ = torch_dense.hs71()
    js, ts = _settings("DAMPED_BFGS")
    x0b = mp_starts(3, 8)
    ref = torch_dense.jax_to_numpy(jbatch.batched_solve_mp(jp, js, jnp.asarray(x0b),
                                                           max_iterations=60))
    out = pb.batched_solve_mp(tp, ts, x0b, max_iterations=60, device="cpu")
    np.testing.assert_array_equal(out.status.numpy(), ref.status)
    assert np.all(out.status.numpy() == Status.OPTIMAL)
    assert out.it.x.dtype == torch.float64
    np.testing.assert_allclose(out.it.obj_val.numpy(), ref.it.obj_val, rtol=1e-7)
    np.testing.assert_allclose(out.it.x.numpy(), ref.it.x, rtol=0, atol=1e-6)

    eps = np.finfo(np.float32).eps
    sets = np.concatenate([np.clip(x0b * (1.0 + 4 * k * eps), 1.0, 5.0)
                           for k in range(MP_PERTURBATIONS)])
    p1 = pb.mp_phase1(tp, ts, sets, 20)
    ref_p1 = torch_dense.jax_to_numpy(jax_phase1(jp, js, sets))
    counts = (p1.status.numpy() == Status.OPTIMAL).reshape(MP_PERTURBATIONS, 8).sum(1)
    jax_counts = (ref_p1.status == Status.OPTIMAL).reshape(MP_PERTURBATIONS, 8).sum(1)
    sem = np.sqrt((counts.var(ddof=1) + jax_counts.var(ddof=1)) / MP_PERTURBATIONS)
    assert abs(counts.mean() - jax_counts.mean()) <= max(4 * sem, 1.0), (counts, jax_counts)
    bad, _ = chip_smoke.phase1_mismatch(pb.tree_map(lambda a: a[:8], p1), out, dict(
        phase1_status=ref_p1.status[:8], phase1_iterations=ref_p1.iteration[:8],
        iterations=ref.iteration))
    assert bad == [], bad


# ---- the other entry points -----------------------------------------------------


def test_batched_step_matches_single_lane():
    """One batched_step on SR1 lanes at every state of one lane's
    single-lane solve (HS71 lane 1, pairs pushed and pending) gives that
    solve's next state."""
    _, tp, _ = torch_dense.hs71()
    _, ts = _settings("SR1")
    states = torch_dense.single_lane_states(tp, ts, hs71_starts()[0][1], 100)
    assert any(bool(s.qn_prev.pending) for s in states) and int(states[-1].qn.count) > 0
    assert torch_dense.tie_mismatches(tp, ts, states, 8) == {}


def test_chunked_and_multistart():
    """batched_solve_chunked in chunks of 4 and multistart_solve on HS71
    under DAMPED_BFGS: each chunk's lanes as the whole batch's, and the
    multistart's best lane as the best lane of its batch."""
    _, tp, _ = torch_dense.hs71()
    _, ts = _settings("DAMPED_BFGS")
    x0b = hs71_starts()[0]
    whole = pb.batched_solve(tp, ts, x0b, 100, device="cpu")
    chunked = pb.batched_solve_chunked(tp, ts, x0b, 100, chunk_size=4, device="cpu")
    assert torch.equal(chunked.status, whole.status)
    assert torch.equal(chunked.iteration, whole.iteration)
    np.testing.assert_allclose(chunked.it.x.numpy(), whole.it.x.numpy(), rtol=0, atol=1e-12)
    best = pb.multistart_solve(tp, ts, x0b[0], num_starts=8, radius=0.5, seed=0,
                               max_iterations=100, device="cpu")
    starts = pb.multistart_starts(tp, x0b[0], num_starts=8, radius=0.5, seed=0)
    lanes = pb.batched_solve(tp, ts, starts, 100, device="cpu")
    expect = pb.lane(lanes, pb.best_lane(lanes))
    assert int(best.status) == Status.OPTIMAL
    assert torch.equal(best.it.x, expect.it.x) and int(best.iteration) == int(expect.iteration)


def test_sharded_solve_damped_bfgs(tmp_path):
    """sharded_solve with DAMPED_BFGS, two lanes a rank on four gloo
    ranks: the gathered lanes equal batched_solve's bit for bit."""
    x0b = hs71_starts()[0]
    torch_dist.run_ranks([dict(kind="sharded_solve", name="qn", x0_batch=x0b.tolist(),
                               max_iterations=100, hess_eval="DAMPED_BFGS")], tmp_path)
    ranks = torch_dist.load(tmp_path, "qn")
    for r in ranks:
        np.testing.assert_array_equal(r["x"], ranks[0]["x"])
        assert r["solved"] == 8
    r = ranks[0]
    np.testing.assert_array_equal(r["x"], r["batched_x"])
    np.testing.assert_array_equal(r["status"], r["batched_status"])
    np.testing.assert_array_equal(r["iteration"], r["batched_iteration"])


# ---- host reads -------------------------------------------------------------


@pytest.mark.parametrize("method", ["DAMPED_BFGS", "SR1"])
def test_host_reads_do_not_grow_with_lanes(method):
    _, tp, _ = torch_dense.hs71()
    routes.assert_reads_do_not_grow(tp, _settings(method)[1], hs71_starts()[0], 100)


SEED_CASES = {
    "rosenbrock_DAMPED_BFGS": ("rosenbrock", "DAMPED_BFGS"),
    "rosenbrock_SR1": ("rosenbrock", "SR1"),
    "rosenbrock_SIMPLE_BFGS": ("rosenbrock", "SIMPLE_BFGS"),
    "hs71_DAMPED_BFGS": ("hs71", "DAMPED_BFGS"),
    "hs71_SR1": ("hs71", "SR1"),
    "blocks_DAMPED_BFGS": ("blocks", "DAMPED_BFGS"),
}


@pytest.mark.parametrize("key", sorted(SEED_CASES))
def test_single_lane_keeps_seed_reads_and_bits(key):
    """tests/test_torch_quasi_newton.py's solves from their x0."""
    name, method = SEED_CASES[key]
    if name == "blocks":
        _, tp, x0 = routes.two_rosenbrocks()
    else:
        _, tp, x0 = getattr(torch_dense, name)()
    routes.assert_seed_lane(key, tp, _settings(method)[1], x0, 1000)
