"""Port parity of the ``LSQFunc`` lanes: ``batched_solve`` of a
least-squares problem (its Newton step Gauss-Newton + trust-region LSQR,
``ops/lsqr.py`` as a ``lanes.lockstep`` loop) against sleqp_tpu's
``batched_solve`` on the same route, and ``lsqr_tr`` under
``torch.func.vmap``.

* Rosenbrock as least squares, tests/test_lsq.py's constrained LSQ and
  broydn (n = 12), four starts each: every lane's status and iterations
  equal JAX's batched lane, x within 1e-8; the same status and iterations
  as the port's single-lane ``solve``, x within 1e-12.
* ``lsqr_tr`` under ``vmap`` on lanes that stop at different steps (on
  the trust region, converged, a zero right-hand side, the step cap):
  each lane's iterate and step count equal ``lsqr_tr`` on that lane alone,
  bit for bit.
* The host reads of an ``LSQFunc`` batch do not grow with B (4 and 16
  lanes), one read an LSQR step for all lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dense
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.parallel import batch as jbatch
from sleqp_tpu_torch import Settings, Status, solve
from sleqp_tpu_torch.ops.lsqr import lsqr_tr
from sleqp_tpu_torch.parallel import batch as pb
from test_torch_batch import HostReads
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _case(name):
    if name == "rosenbrock_lsq":
        jp, tp, _ = torch_dense.rosenbrock_lsq()
        return jp, tp, np.array([[0.0, 0.0], [0.9, 0.8], [-1.0, 1.0], [-1.2, 1.0]])
    if name == "constrained_lsq":
        jp, tp, _ = torch_dense.constrained_lsq()
        return jp, tp, np.array([[0.0, 0.0], [2.0, -1.0], [-0.5, 1.5], [0.3, 0.3]])
    jp, tp, x0 = torch_dense.broydn(12)
    rng = np.random.default_rng(12)
    return jp, tp, np.concatenate([x0[None, :], x0 + 0.3 * rng.standard_normal((3, 12))])


@pytest.mark.parametrize("name", ["rosenbrock_lsq", "constrained_lsq", "broydn12"])
def test_lsq_lanes_match_jax_and_single_lane(name):
    jp, tp, x0b = _case(name)
    ref = torch_dense.jax_to_numpy(jbatch.batched_solve(jp, JaxSettings(), jnp.asarray(x0b),
                                                        max_iterations=200))
    out = pb.batched_solve(tp, Settings(), x0b, 200, device="cpu")
    assert (out.status.numpy() == Status.OPTIMAL).all(), out.status
    np.testing.assert_array_equal(out.status.numpy(), ref.status)
    np.testing.assert_array_equal(out.iteration.numpy(), ref.iteration)
    np.testing.assert_allclose(out.it.x.numpy(), ref.it.x, rtol=0, atol=1e-8)
    for b in range(len(x0b)):
        alone = solve(tp, Settings(), x0b[b], 200, device="cpu")
        assert int(alone.status) == int(out.status[b])
        assert int(alone.iteration) == int(out.iteration[b])
        np.testing.assert_allclose(out.it.x[b].numpy(), alone.it.x.numpy(), rtol=0, atol=1e-12)


def test_lsqr_lanes_equal_single_lane():
    """Lane 0 reaches the step cap, lane 1 and 4 cross the trust region,
    lane 2 converges in two steps (two distinct singular values), lane 3
    has no right-hand side.  The operator is elementwise products and
    sums: a batched matrix product sums in another order than ``A @ v``
    on one lane, and bit for bit is what the lockstep loop itself owes."""
    rng = np.random.default_rng(7)
    lanes, m, n, cap = 5, 9, 6, 5
    A = torch.as_tensor(rng.standard_normal((lanes, m, n)))
    A[2] = 0.0
    A[2, :n] = torch.diag(torch.tensor([1.0, 1.0, 1.0, 3.0, 3.0, 3.0], dtype=torch.float64))
    b = torch.as_tensor(rng.standard_normal((lanes, m)))
    b[3] = 0.0
    radius = torch.tensor([1e3, 0.05, 1e3, 1e3, 0.4], dtype=torch.float64)

    def one(A, b, radius):
        return lsqr_tr(lambda v: (A * v).sum(-1), lambda u: (A * u[:, None]).sum(0), b, radius,
                       n, cap)

    d, steps = torch.func.vmap(one)(A, b, radius)
    counts = []
    for k in range(lanes):
        d1, s1 = one(A[k], b[k], radius[k])
        assert torch.equal(d[k], d1), k
        assert int(steps[k]) == int(s1) and steps.dtype == torch.int32
        counts.append(int(s1))
    assert counts[0] == cap and counts[2] == 2 and counts[3] == 0, counts
    assert torch.linalg.norm(d[1]) <= 0.05 * (1 + 1e-12) and counts[1] < cap, counts


def test_lsq_lane_reads_do_not_grow():
    _, tp, x0b = _case("rosenbrock_lsq")
    reads = {}
    for copies in (1, 4):
        with HostReads() as counter:
            out = pb.batched_solve(tp, Settings(), np.tile(x0b, (copies, 1)), 200, device="cpu")
        reads[copies] = counter.count
        assert (out.status.numpy() == Status.OPTIMAL).all()
    assert reads[1] == reads[4] > 0, reads
