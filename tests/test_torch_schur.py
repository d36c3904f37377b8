"""Port parity of the sharded Schur-complement solve:
sleqp_tpu_torch/parallel/schur.py on P = 4 gloo ranks (tests/torch_dist.py)
against sleqp_tpu/parallel/schur.py on a mesh of 4 of the 8 virtual
devices, on tests/test_schur_sharded.py's systems.

* ``chunk_layout`` equals the reference's array by array, and raises the
  same ``ValueError`` when N + 1 is not divisible by the chunk count.
* ``sharded_schur_solve`` gives every rank the same x, within the
  reference test's 1e-8 of the reference's sharded solve and of the
  sequential ``block_tridiag_solve``; with ``"pallas"`` interiors (cyclic
  reduction through B1's plain version on the CPU, refined in float64)
  too.  A float32 system (the mixed OCP route's S) is held to the
  reference's float32 solve at 1e-5.
* Two collectives a solve: the packed contributions and the solution.
* The launcher (``parallel/ranks.spawn``) fails the run on a rank that
  exits non-zero or is late, and kills the ranks still running.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import sys
import time

import torch_dist
from sleqp_tpu.ops.block_tridiag import block_tridiag_solve as jax_thomas
from sleqp_tpu.parallel.schur import chunk_layout as jax_chunk_layout
from sleqp_tpu.parallel.schur import sharded_schur_solve as jax_sharded
from sleqp_tpu_torch.ops.block_tridiag import block_tridiag_solve
from sleqp_tpu_torch.parallel import ranks as port_ranks
from sleqp_tpu_torch.parallel.schur import chunk_layout
from test_schur_sharded import _random_spd
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P = 4
# name: (c, k, seed, tridiag_backend, dtype); N = P c - 1.  The first three
# are tests/test_schur_sharded.py's cases, the fourth its jit case's
# system, then the pallas interiors at the OCP's block size (k = 32, the
# flat inverse's width) and a float32 system.
CASES = {
    "c4k3": (4, 3, 4, "scan", "float64"),
    "c8k4": (8, 4, 8, "scan", "float64"),
    "pallas_c4k3": (4, 3, 17, "pallas", "float64"),
    "c6k2": (6, 2, 9, "scan", "float64"),
    "pallas_c5k32": (5, 32, 3, "pallas", "float64"),
    "f32_c4k3": (4, 3, 5, "scan", "float32"),
}


def _system(name):
    c, k, seed, _, dtype = CASES[name]
    D, L, b = (np.array(a, dtype=dtype) for a in _random_spd(P * c - 1, k, seed=seed))
    return D, L, b


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One group of four ranks solves every case."""
    tmp = tmp_path_factory.mktemp("schur_ranks")
    cases = []
    for name, (_, _, _, backend, _) in CASES.items():
        path = str(tmp / f"{name}.inputs.npz")
        D, L, b = _system(name)
        np.savez(path, D=D, L=L, b=b)
        cases.append(dict(kind="schur", name=name, inputs=path, backend=backend))
    torch_dist.run_ranks(cases, tmp, world=P)
    return {name: torch_dist.load(tmp, name, world=P) for name in CASES}


@pytest.mark.parametrize("N,k,num_chunks", [(15, 3, 4), (31, 4, 8), (23, 2, 4), (7, 3, 1)])
def test_chunk_layout_matches_jax(N, k, num_chunks):
    D, L, b = (np.array(a) for a in _random_spd(N, k, seed=N))
    got = chunk_layout(torch.as_tensor(D), torch.as_tensor(L), torch.as_tensor(b), num_chunks)
    want = jax.jit(jax_chunk_layout, static_argnums=3)(D, L, b, num_chunks)
    assert len(got) == len(want) == 9
    for i, (a, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(a.shape) == w.shape, i
        np.testing.assert_array_equal(a.numpy(), w, err_msg=str(i))


def test_chunk_layout_rejects_ragged_chunks():
    D, L, b = (torch.as_tensor(np.array(a)) for a in _random_spd(14, 2, seed=0))
    with pytest.raises(ValueError, match="N\\+1=15 not divisible by num_chunks=4"):
        chunk_layout(D, L, b, 4)
    with pytest.raises(ValueError, match="not divisible"):
        jax_chunk_layout(jnp.asarray(D.numpy()), jnp.asarray(L.numpy()), jnp.asarray(b.numpy()), 4)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_schur_matches_jax(ranks, name):
    c, k, _, backend, dtype = CASES[name]
    D, L, b = _system(name)
    xs = [r["x"] for r in ranks[name]]
    for x in xs[1:]:
        np.testing.assert_array_equal(x, xs[0])  # the same x on every rank
    x = xs[0]
    assert x.shape == (P * c - 1, k) and x.dtype == np.dtype(dtype)
    mesh = Mesh(np.array(jax.devices()[:P]), axis_names=("chunks",))
    # under jit, as tests/test_schur_sharded.py::test_sharded_under_jit
    # (the eager shard_map compiles op by op, ~30x slower)
    solve = jax.jit(lambda D, L, b: jax_sharded(D, L, b, mesh, tridiag_backend=backend))
    want = np.asarray(solve(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    tol = 1e-8 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(x, want, atol=tol)
    if dtype == "float64":
        seq = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
        np.testing.assert_allclose(x, seq, atol=1e-8)
        port_seq = block_tridiag_solve(torch.as_tensor(D), torch.as_tensor(L), torch.as_tensor(b))
        np.testing.assert_allclose(x, port_seq.numpy(), atol=1e-8)


def test_two_collectives_a_solve(ranks):
    for name in CASES:
        assert [int(r["collectives"]) for r in ranks[name]] == [2] * P, name


def test_spawn_fails_on_a_failed_or_late_rank():
    ok = [sys.executable, "-c", "print('done')"]
    assert port_ranks.spawn([ok, ok], 60) == ["done\n", "done\n"]
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 3 exited with code 3:\n.*boom"):
        port_ranks.spawn([[sys.executable, "-c", "import time; time.sleep(60)"],
                          [sys.executable, "-c",
                           "import sys; print('boom', file=sys.stderr); sys.exit(3)"],
                          ok], 60)
    with pytest.raises(RuntimeError, match="rank 0 of 2 was still running after 1 s"):
        port_ranks.spawn([[sys.executable, "-c", "import time; time.sleep(60)"], ok], 1)
    assert time.monotonic() - start < 30  # the sleeping ranks were killed, not waited for
