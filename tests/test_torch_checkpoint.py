"""Port parity of checkpoint and resume (sleqp_tpu_torch/checkpoint.py)
against sleqp_tpu/checkpoint.py, on tests/test_checkpoint.py's two cases.

* After 3 iterations of HS71 the saved and loaded state equals the state
  tensor for tensor, in dtype, device and bits, as JAX's round trip does;
  the state itself agrees with JAX's after 3 iterations (x, radii and
  penalty to 1e-9, status and iteration counts equal).
* Interrupted after 4 iterations, saved, loaded and resumed, the solve
  equals the uninterrupted one bit for bit, and JAX's resumed solve in
  status, iterations and x (1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dense
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.checkpoint import load_state as jax_load_state
from sleqp_tpu.checkpoint import save_state as jax_save_state
from sleqp_tpu.problem_solver import initial_state as jax_initial_state
from sleqp_tpu.problem_solver import perform_iteration as jax_perform_iteration
from sleqp_tpu.problem_solver import solve_jit
from sleqp_tpu_torch import Settings, Status
from sleqp_tpu_torch.checkpoint import load_state, save_state
from sleqp_tpu_torch.lanes import tree_leaves
from sleqp_tpu_torch.problem_solver import initial_state, perform_iteration, solve_from
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _stepped(k):
    """HS71 after ``k`` iterations in both packages: (JAX, port) states."""
    jp, tp, x0 = torch_dense.hs71()
    js = jax_initial_state(jp, JaxSettings(), jnp.asarray(x0))
    step = jax.jit(lambda s: jax_perform_iteration(jp, JaxSettings(), s))
    ts = initial_state(tp, Settings(), x0, device="cpu")
    for _ in range(k):
        js, ts = step(js), perform_iteration(tp, Settings(), ts)
    return jp, tp, js, ts


def _assert_same_bits(a, b):
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    assert len(leaves_a) == len(leaves_b)
    for x, y in zip(leaves_a, leaves_b):
        assert (x.dtype, x.shape, x.device) == (y.dtype, y.shape, y.device)
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bool else x, y) or (
            x.is_floating_point() and torch.equal(x.nan_to_num(), y.nan_to_num())
            and torch.equal(x.isnan(), y.isnan()))


def test_save_load_roundtrip(tmp_path):
    _, _, js, state = _stepped(3)
    jpath = str(tmp_path / "jax_ckpt")
    jax_save_state(js, jpath)
    jrestored = jax_load_state(js, jpath)
    for a, b in zip(jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(jrestored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    path = str(tmp_path / "ckpt")
    save_state(state, path)
    restored = load_state(state, path)
    _assert_same_bits(state, restored)
    assert int(state.iteration) == int(js.iteration) == 3
    assert int(state.status) == int(js.status) == Status.RUNNING
    for port, ref in ((state.it.x, js.it.x), (state.penalty, js.penalty),
                      (state.trust_radius, js.trust_radius),
                      (state.lp_trust_radius, js.lp_trust_radius)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-9)


def test_resume_matches_uninterrupted(tmp_path):
    jp, tp, js, state = _stepped(4)
    _, _, x0 = torch_dense.hs71()
    full = solve_from(tp, Settings(), initial_state(tp, Settings(), x0, device="cpu"), 100)
    path = str(tmp_path / "ckpt")
    save_state(state, path + ".npz")
    final = solve_from(tp, Settings(), load_state(state, path + ".npz"), 100)
    assert int(final.status) == Status.OPTIMAL
    _assert_same_bits(final, full)

    jpath = str(tmp_path / "jax_ckpt")
    jax_save_state(js, jpath)
    ref = solve_jit(jp, JaxSettings(), jax_load_state(js, jpath), 100)
    assert int(ref.status) == int(final.status)
    assert int(ref.iteration) == int(final.iteration)
    np.testing.assert_allclose(final.it.x.numpy(), np.asarray(ref.it.x), rtol=0, atol=1e-8)
