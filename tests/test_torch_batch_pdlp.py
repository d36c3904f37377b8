"""Port parity of the batched dense solve on the PDLP Cauchy LP:
sleqp_tpu_torch.parallel.batch against sleqp_tpu.parallel.batch, and
``ops/pdlp.solve`` under ``torch.func.vmap`` against its single-lane call.

* hs35 with ``lp_solver=PDLP, pdlp_tol=1e-10`` at B = 8 from
  ``chip_smoke.lp_starts``: against JAX's lanes, statuses equal,
  iterations within 3, x within 1e-8; against the port's single-lane
  solves, the same status and iterations, x within 1e-9.
* ``pdlp.solve`` in lanes that stop after different numbers of
  64-iteration blocks, one of them at a cap that cuts its last block short:
  each lane's PDHG iterations equal its single-lane call's, x and the
  duals within 1e-12, the same synthesized statuses.
* Host reads: one flag a block for all lanes, so a batched hs35 solve
  reads as often at B = 4 as at B = 64, and one lane reads as the
  single-lane loop did before it ran in lanes (hs35: 42).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_dense
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.harness.hs import get_problem as jax_get_problem
from sleqp_tpu.parallel import batch as jbatch
from sleqp_tpu.types import LPSolver as JaxLPSolver
from sleqp_tpu_torch import LPSolver, Settings, Status, initial_state, solve
from sleqp_tpu_torch.harness.hs import get_problem
from sleqp_tpu_torch.ops import pdlp
from sleqp_tpu_torch.parallel import batch as pb
from sleqp_tpu_torch.problem_solver import solve_from
from test_torch_batch import HostReads
from test_torch_pdlp import _lp, _random_lp
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAX_IT = 200
SETTINGS = Settings(lp_solver=LPSolver.PDLP, pdlp_tol=1e-10)
JAX_SETTINGS = JaxSettings(lp_solver=JaxLPSolver.PDLP, pdlp_tol=1e-10)
LANE_READS = 42  # hs35 from x0, one lane, before its blocks ran in lanes


@pytest.fixture(scope="module")
def hs35():
    """JAX's and the port's batched hs35 on PDLP, and the port's single-lane
    solves of the same starts."""
    jp, tp = jax_get_problem("hs35")[0], get_problem("hs35", "cpu")[0]
    x0b = chip_smoke.lp_starts("hs35", 8)
    ref = torch_dense.jax_to_numpy(jbatch.batched_solve(jp, JAX_SETTINGS, jnp.asarray(x0b),
                                                        max_iterations=MAX_IT))
    out = pb.batched_solve(tp, SETTINGS, x0b, MAX_IT, device="cpu")
    single = [solve(tp, SETTINGS, x, MAX_IT, device="cpu") for x in x0b]
    return tp, x0b, ref, out, single


def test_lanes_match_jax(hs35):
    _, x0b, ref, out, _ = hs35
    np.testing.assert_array_equal(out.status.numpy(), ref.status)
    assert np.all(out.status.numpy() == Status.OPTIMAL)
    np.testing.assert_allclose(out.iteration.numpy(), ref.iteration, atol=3)
    np.testing.assert_allclose(out.it.x.numpy(), ref.it.x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.it.obj_val.numpy(), 1.0 / 9.0, rtol=0, atol=1e-8)
    assert len(set(out.iteration.tolist())) > 1  # the lanes stop at different iterations


def test_lanes_match_single_lane(hs35):
    _, _, _, out, single = hs35
    for b, s in enumerate(single):
        assert int(out.status[b]) == int(s.status), b
        assert int(out.iteration[b]) == int(s.iteration), b
        np.testing.assert_allclose(out.it.x[b].numpy(), s.it.x.numpy(), rtol=0, atol=1e-9)


# seeds of tests/test_torch_pdlp.py's random LP: to tol 1e-9 they take 320,
# 384, 448 and 320 PDHG iterations alone
LP_SEEDS = (2, 0, 13, 8)


@pytest.mark.parametrize("cap", [420, 5000])
def test_pdlp_lanes_match_single_lane(cap):
    """Lanes ending on different blocks; at cap 420 the third lane stops in
    its seventh block, cut to 36 iterations."""
    lps = [[torch.tensor(np.asarray(v)) for v in _lp(*_random_lp(seed))] for seed in LP_SEEDS]

    def one(A, c, lb, ub):
        return pdlp.solve(A, c, lb, ub, max_iterations=cap, tol=1e-9)

    batched = torch.func.vmap(one)(*(torch.stack(parts) for parts in zip(*lps)))
    assert isinstance(batched, pdlp.PDLPResult)
    for b, lp in enumerate(lps):
        alone = one(*lp)
        assert int(batched.iterations[b]) == int(alone.iterations), b
        assert int(batched.state[b]) == int(alone.state), b
        assert torch.equal(batched.status[b], alone.status), b
        for key in ("x", "duals", "reduced_costs"):
            np.testing.assert_allclose(getattr(batched, key)[b].numpy(),
                                       getattr(alone, key).numpy(), rtol=0, atol=1e-12)
    expected = [320, 384, 420, 320] if cap == 420 else [320, 384, 448, 320]
    assert batched.iterations.tolist() == expected
    if cap == 5000:
        assert batched.state.tolist() == [pdlp.OPTIMAL] * 4


def test_host_reads_do_not_grow_with_lanes():
    tp, _, _ = get_problem("hs35", "cpu")
    x0b = chip_smoke.lp_starts("hs35", 4)
    reads = {}
    for copies in (1, 16):
        with HostReads() as counter:
            out = pb.batched_solve(tp, SETTINGS, np.tile(x0b, (copies, 1)), MAX_IT, device="cpu")
        reads[4 * copies] = counter.count
        assert np.all(out.status.numpy() == Status.OPTIMAL)
    assert reads[4] == reads[64] > 0, reads
    # one lane's eager loop reads as the single-lane loop did; solve_jit no
    # more
    with HostReads() as counter:
        out = solve_from(tp, SETTINGS, initial_state(tp, SETTINGS, x0b[0], device="cpu"), MAX_IT)
    assert int(out.status) == Status.OPTIMAL
    assert counter.count == LANE_READS
    with HostReads() as counter:
        graph = solve(tp, SETTINGS, x0b[0], MAX_IT, device="cpu")
    assert counter.count <= LANE_READS and torch.equal(graph.it.x, out.it.x)
