"""Port parity of the batched dense solve's mixed-precision, chunked and
multistart forms against sleqp_tpu.parallel.batch, on the reference's own
cases: tests/test_mixed_precision.py's mixed vmapped batch (B = 4),
``batched_solve_mp`` (B = 8) and ``batched_solve_chunked`` (B = 11 in
chunks of 4), and tests/test_solver.py's multistart on hs33.

* Against JAX: statuses equal, iterations within 3, x within 1e-8.
  ``batched_solve_mp``: objectives within rtol 1e-7 and x within the
  solve's 1e-6; iterations within 3 but for the lanes named in
  ``MP_TIES``.  Its phase 1 runs the whole iteration in float32, where
  the reference itself calls the reduction ratio garbage near the
  solution: the model reductions fall to the float32 rounding of the merit
  and the projected Hessian's least Rayleigh quotient to ~1e-4, so one
  iteration from the same float32 state flips accept/reject and
  interior/boundary decisions between the packages, and between a lane
  and its single-lane solve.  Which iteration first meets the coarse test,
  if any before the cap of 20, is then not reproducible: starts moved by
  a few float32 ulps move JAX's count of phase-1 OPTIMAL lanes at B = 512
  over 175-243 (``artifacts/batch_hs71_jax_cpu.json``).  So phase 1 is
  held as a distribution (the port's counts over perturbed starts against
  JAX's recorded ones) and phase 2 lane by lane
  (``chip_smoke.phase1_mismatch``: phase-1 OPTIMAL residuals within the
  coarse tolerance, warm lanes' phase 2 no slower on average than JAX's
  by 0.5 and at most 5% of them over 3 iterations, lanes
  cold in both within 3 of JAX's phase-2 iterations).  Phase 2 starts from
  float32 iterates that differ at float32 rounding and stops within the
  float64 tolerances, so x agrees to those (2.5e-7 at most here), not to
  1e-8.
* Against the port's own single-lane solves: the same status and
  iterations, x within 1e-9, but for the lanes named in ``CHUNK_TIES``
  (a rounding tie as in tests/test_torch_batch.py, certified the same
  way).  ``batched_solve_mp``'s phase 2 is held lane by lane against the
  single-lane phase 2 from the same phase-1 lanes; its float32 phase 1 is
  the tie above.
* Multistart: the port's own draw (a seeded ``torch.Generator``: JAX's
  threefry draw needs JAX) finds hs33's global minimum, and on JAX's own
  starts the port's best-lane choice (``multistart_from``) is JAX's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import fixtures
import sleqp_tpu.problem_solver as jps
import torch_dense
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.harness.driver import get_problem as jax_get_problem
from sleqp_tpu.parallel import batch as jbatch
from sleqp_tpu.types import f32_compute_scope
from sleqp_tpu_torch import Settings, Status, solve
from sleqp_tpu_torch.harness.driver import get_problem
from sleqp_tpu_torch.parallel import batch as pb
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# batched_solve_mp's lanes whose iterations part from JAX's by more than 3:
# phase 1 (float32) meets the coarse test in one package and reaches its
# cap of 20 in the other (each a phase-1 tie, its phase 2 held by
# chip_smoke.phase1_mismatch)
MP_TIES = {0: "port 19, JAX 26", 4: "port 10, JAX 26", 6: "port 12, JAX 26"}
# batched_solve_chunked's lanes that part from the port's single-lane solve
# by a rounding tie: {lane: (batched iterations, single-lane iterations)}
CHUNK_TIES = {1: (7, 6)}


def hs71_starts(seed, lanes):
    """tests/test_mixed_precision.py's jittered HS71 starts."""
    _, x0, x_opt = fixtures.hs71_problem()
    rng = np.random.default_rng(seed)
    return np.clip(np.asarray(x0)[None, :] + rng.uniform(-0.05, 0.05, (lanes, 4)), 1.0, 5.0)


def assert_lanes_match(out, ref, single, ties=None, tp=None, x0b=None, settings=None):
    """Port lanes against JAX's (``ref``, numpy) and against the port's
    single-lane states; ``ties`` names the lanes that part from their
    single-lane solve, each certified by ``torch_dense.tie_mismatches``."""
    np.testing.assert_array_equal(out.status.numpy(), ref.status)
    np.testing.assert_allclose(out.iteration.numpy(), ref.iteration, atol=3)
    np.testing.assert_allclose(out.it.x.numpy(), ref.it.x, rtol=0, atol=1e-8)
    parted = {}
    for b, s in enumerate(single):
        assert int(out.status[b]) == int(s.status), b
        dx = float((out.it.x[b] - s.it.x).abs().max())
        if int(out.iteration[b]) != int(s.iteration) or dx > 1e-9:
            parted[b] = (int(out.iteration[b]), int(s.iteration))
            assert dx <= 1e-6, (b, dx)
    ties = ties or {}
    assert parted == ties, parted
    for b in ties:
        states = torch_dense.single_lane_states(tp, settings, x0b[b], 60)
        assert torch_dense.tie_mismatches(tp, settings, states, len(x0b)) == {}, b


def test_mixed_vmapped_batch():
    """test_mixed_precision.py::test_mixed_vmapped_batch: the mixed route
    (compute_dtype="float32") in lanes."""
    jp, tp, _ = torch_dense.hs71()
    x0b = hs71_starts(0, 4)
    mixed = JaxSettings(compute_dtype="float32")
    state0 = jbatch.batched_initial_state(jp, mixed, jnp.asarray(x0b))
    ref = jax.jit(jax.vmap(lambda s: jps.solve_jit(jp, mixed, s, 60)))(state0)
    ref = torch_dense.jax_to_numpy(ref)
    settings = Settings(compute_dtype="float32")
    out = pb.batched_solve(tp, settings, x0b, 60, device="cpu")
    single = [solve(tp, settings, x, 60, device="cpu") for x in x0b]
    assert np.all(out.status.numpy() == Status.OPTIMAL)
    _, _, x_opt = fixtures.hs71_problem()
    np.testing.assert_allclose(out.it.x.numpy(), np.tile(x_opt, (4, 1)), atol=1e-5)
    assert_lanes_match(out, ref, single)


def jax_phase1(jp, settings, x0b, iterations=20, coarse_tol=2e-3):
    """JAX's batched_solve_mp phase 1, as batched_solve_mp calls it."""
    settings32 = dataclasses.replace(
        settings, dtype="float32", compute_dtype="same",
        feas_tol=max(settings.feas_tol, coarse_tol), stat_tol=max(settings.stat_tol, coarse_tol),
        slack_tol=max(settings.slack_tol, coarse_tol), perform_soc=False, lp_resolves=False)
    with f32_compute_scope():
        return jbatch.batched_solve(jbatch._f32_problem(jp), settings32,
                                    jnp.asarray(x0b).astype(jnp.float32), iterations)


@pytest.fixture(scope="module")
def mp_case():
    """test_mixed_precision.py::test_batched_solve_mp_two_phase's batch
    through JAX's and the port's batched_solve_mp, and JAX's phase 1."""
    jp, tp, _ = torch_dense.hs71()
    x0b = hs71_starts(3, 8)
    ref = torch_dense.jax_to_numpy(
        jbatch.batched_solve_mp(jp, JaxSettings(), jnp.asarray(x0b), max_iterations=60))
    ref_p1 = torch_dense.jax_to_numpy(jax_phase1(jp, JaxSettings(), x0b))
    out = pb.batched_solve_mp(tp, Settings(), x0b, max_iterations=60, device="cpu")
    return tp, x0b, ref, out, ref_p1


def test_batched_solve_mp_matches_jax(mp_case):
    tp, x0b, ref, out, ref_p1 = mp_case
    np.testing.assert_array_equal(out.status.numpy(), ref.status)
    assert np.all(out.status.numpy() == Status.OPTIMAL)
    # every certified quantity comes from the float64 phase
    assert out.it.x.dtype == torch.float64
    assert float(out.feas_res.max()) <= 1e-6 and float(out.stat_res.max()) <= 1e-6
    np.testing.assert_allclose(out.it.obj_val.numpy(), ref.it.obj_val, rtol=1e-7)
    np.testing.assert_allclose(out.it.x.numpy(), ref.it.x, rtol=0, atol=1e-6)
    assert int(out.iteration.min()) >= 1
    far = {b for b in range(8) if abs(int(out.iteration[b]) - int(ref.iteration[b])) > 3}
    assert far == set(MP_TIES), (out.iteration, ref.iteration)
    # the phase-1 ties' phase 2, and phase 1's OPTIMAL lanes, lane by lane
    p1 = pb.mp_phase1(tp, Settings(), x0b, 20)
    bad, summary = chip_smoke.phase1_mismatch(p1, out, dict(
        phase1_status=ref_p1.status, phase1_iterations=ref_p1.iteration,
        iterations=ref.iteration))
    assert bad == [], bad
    assert set(MP_TIES) <= set(np.flatnonzero(summary["ties"]).tolist()), summary
    # the float64 batched solve reaches the same objectives
    f64 = pb.batched_solve(tp, Settings(), x0b, 60, device="cpu")
    np.testing.assert_allclose(out.it.obj_val.numpy(), f64.it.obj_val.numpy(), rtol=1e-7)


def test_batched_solve_mp_phase2_matches_single_lane(mp_case):
    """Phase 2 in lockstep against phase 2 lane by lane from the same
    phase-1 lanes; the two phases compose to batched_solve_mp."""
    tp, x0b, _, out, _ = mp_case
    st32 = pb.mp_phase1(tp, Settings(), x0b, 20)
    assert st32.it.x.dtype == torch.float32
    ok = st32.status == Status.OPTIMAL
    assert bool(ok.any()) and not bool(ok.all())  # both kinds of lane
    lanes = pb.mp_phase2(tp, Settings(), st32, x0b, 12)
    for a, b in zip(pb.tree_leaves(lanes), pb.tree_leaves(out)):
        assert torch.equal(a, b)
    for b in range(8):
        alone = chip_smoke.single_lane_phase2(tp, Settings(), pb.lane(st32, b), x0b[b], 12)
        assert int(alone.status) == int(lanes.status[b])
        assert int(alone.iteration) == int(lanes.iteration[b])
        np.testing.assert_allclose(lanes.it.x[b].numpy(), alone.it.x.numpy(), rtol=0, atol=1e-9)


PHASE1_PERTURBATIONS = 8


def test_phase1_optimal_count_matches_jax_distribution():
    """chip_smoke.py phase 14's batch at B = 512: the port's phase-1
    OPTIMAL counts from the starts moved by 4 k float32 ulps (k = 0..7)
    against JAX's counts over k = 0..23 (tools/batch_reference.py): each
    within phase 14's band, and the means apart by no more than four
    standard errors (a systematic gap between the packages' float32
    phases would show here; the counts of one start set part by up to ~80
    at B = 1024 in either package alone)."""
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           chip_smoke.BATCH_REF)) as fh:
        jax_counts = np.asarray(json.load(fh)["runs"]["mp_512"]["phase1_optimal_perturbed"],
                                dtype=float)
    _, tp, _ = torch_dense.hs71()
    settings = Settings(compute_dtype="float32")
    counts = []
    for k in range(PHASE1_PERTURBATIONS):
        p1 = pb.mp_phase1(tp, settings, chip_smoke.batch_starts(512, k), 20)
        ok = p1.status == Status.OPTIMAL
        assert float(p1.stat_res[ok].max()) <= 2e-3 and float(p1.feas_res[ok].max()) <= 2e-3
        counts.append(int(ok.sum()))
    lo, hi = chip_smoke.phase1_band(jax_counts)
    assert all(lo <= c <= hi for c in counts), (counts, lo, hi)
    counts = np.asarray(counts, dtype=float)
    sem = np.sqrt(counts.var(ddof=1) / len(counts) + jax_counts.var(ddof=1) / len(jax_counts))
    assert abs(counts.mean() - jax_counts.mean()) <= 4 * sem, (counts, jax_counts.mean(), sem)


def test_batched_solve_chunked():
    """test_mixed_precision.py::test_batched_solve_chunked: B = 11 in
    chunks of 4 (the last padded with copies of lane 10, dropped)."""
    jp, tp, _ = torch_dense.hs71()
    x0b = hs71_starts(5, 11)
    ref = torch_dense.jax_to_numpy(jbatch.batched_solve_chunked(
        jp, JaxSettings(), jnp.asarray(x0b), max_iterations=60, chunk_size=4))
    out = pb.batched_solve_chunked(tp, Settings(), x0b, max_iterations=60, chunk_size=4,
                                   device="cpu")
    assert out.it.x.shape == (11, 4) and out.status.shape == (11,)
    assert int((out.status == Status.OPTIMAL).sum()) == 11
    single = [solve(tp, Settings(), x, 60, device="cpu") for x in x0b]
    assert_lanes_match(out, ref, single, CHUNK_TIES, tp, x0b, Settings())


def test_multistart_hs33_own_draw():
    """test_solver.py::test_multistart_escapes_hs33_basin with the port's
    own jitter: the batch finds the global minimum f = -4.586 that the
    single start misses."""
    tp, x0, f_opt = get_problem("hs33", "cpu")
    starts = pb.multistart_starts(tp, x0, num_starts=8, radius=2.0, seed=0)
    assert starts.shape == (8, 3) and torch.equal(starts[0], torch.as_tensor(x0, dtype=starts.dtype))
    assert torch.equal(starts, tp.clip_to_bounds(starts))
    # the same seed gives the same starts
    assert torch.equal(starts, pb.multistart_starts(tp, x0, num_starts=8, radius=2.0, seed=0))
    out = pb.multistart_solve(tp, Settings(), x0, num_starts=8, radius=2.0, seed=0,
                              max_iterations=200, device="cpu")
    assert int(out.status) == Status.OPTIMAL
    assert abs(float(out.it.obj_val) - f_opt) <= 1e-4 * (1 + abs(f_opt))
    alone = solve(tp, Settings(), x0, 200, device="cpu")
    assert float(out.it.obj_val) < float(alone.it.obj_val) - 0.1


def test_multistart_best_lane_on_jax_starts():
    """JAX's multistart on its own starts, and the port's best-lane choice
    on the same starts."""
    jp, x0, _ = jax_get_problem("hs33")
    tp, _, _ = get_problem("hs33", "cpu")
    x0 = jnp.asarray(x0)
    # multistart_solve's draw (sleqp_tpu/parallel/batch.py)
    jitter = 2.0 * jax.random.uniform(jax.random.PRNGKey(0), (8, 3), minval=-1.0, maxval=1.0,
                                      dtype=x0.dtype)
    starts = jax.vmap(jp.clip_to_bounds)(jnp.concatenate([x0[None], x0[None] + jitter[1:]]))
    ref = torch_dense.jax_to_numpy(jbatch.multistart_solve(
        jp, JaxSettings(), x0, num_starts=8, radius=2.0, seed=0, max_iterations=200))
    out = pb.multistart_from(tp, Settings(), np.asarray(starts), max_iterations=200,
                             device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    np.testing.assert_allclose(out.it.x.numpy(), ref.it.x, rtol=0, atol=1e-8)
    assert abs(int(out.iteration) - int(ref.iteration)) <= 3
