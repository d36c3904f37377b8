"""Port parity of the batched dense solve on the SIMPLEX Cauchy LP, HS71:
``lp_solver=SIMPLEX`` at B = 8 from tests/test_misc.py's starts, lane by
lane against JAX's ``batched_solve`` and against the port's single-lane
solves (the gates of tests/test_torch_batch_simplex.py).

HS71's lanes part at rounding ties of the dense iteration, not of the LP:
the port's SIMPLEX lanes equal its ENUM lanes (whose ties with JAX
tests/test_torch_batch.py certifies by one batched step from JAX's
states), so lane 6 parts from its single-lane solve as on the ENUM route
(``TIES``) and lane 5 from JAX's lane (``JAX_TIES``).  JAX's SIMPLEX lanes
equal JAX's ENUM lanes but for lane 1, where JAX's batched program takes
7 iterations and JAX's own single-lane solve 6, as the port does; one
port iteration from each of JAX's single-lane states gives JAX's next.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dense
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.parallel import batch as jbatch
from sleqp_tpu_torch import Settings
from sleqp_tpu_torch.parallel import batch as pb
from test_torch_batch_simplex import (HS71, MAX_IT, assert_lanes_match_jax,
                                      assert_lanes_match_single_lane, run_case)
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def case():
    return run_case("hs71", HS71)


def test_lanes_match_jax(case):
    assert_lanes_match_jax(case)


def test_lanes_match_single_lane(case):
    assert_lanes_match_single_lane(case)


def test_jax_ties_are_the_dense_iterations(case):
    jp, tp, x0b = case["jp"], case["tp"], case["x0b"]
    port_e = pb.batched_solve(tp, Settings(), x0b, MAX_IT, device="cpu")
    assert torch.equal(case["out"].iteration, port_e.iteration)
    np.testing.assert_allclose(case["out"].it.x.numpy(), port_e.it.x.numpy(), rtol=0, atol=1e-12)
    jax_s = case["ref"]
    jax_e = torch_dense.jax_to_numpy(jbatch.batched_solve(jp, JaxSettings(), jnp.asarray(x0b),
                                                          max_iterations=MAX_IT))
    dx = np.abs(jax_s.it.x - jax_e.it.x).max(axis=1)
    assert {b for b in range(8) if dx[b] > 1e-12 or jax_s.iteration[b] != jax_e.iteration[b]} \
        == {1}, (dx, jax_s.iteration, jax_e.iteration)
    states = torch_dense.jax_states(jp, case["jax_settings"], x0b[1])
    assert int(states[-1].iteration) == int(case["out"].iteration[1]) == 6
    np.testing.assert_allclose(np.asarray(states[-1].it.x), case["out"].it.x[1].numpy(), rtol=0,
                               atol=1e-12)
    assert torch_dense.iteration_mismatches(tp, case["settings"], states) == {}
