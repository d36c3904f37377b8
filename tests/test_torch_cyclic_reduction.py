"""Port parity: batched SPD inverses and block cyclic reduction
(sleqp_tpu_torch/ops/cyclic_reduction.py against sleqp_tpu/ops/cyclic_reduction.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleqp_tpu.ops import cyclic_reduction as jcr
from sleqp_tpu.ops.block_tridiag import block_tridiag_solve as jax_thomas
from sleqp_tpu.ops.pallas_tridiag import block_tridiag_matvec as jax_matvec
from sleqp_tpu_torch.ops import cyclic_reduction as cr
from sleqp_tpu_torch.ops.pallas_tridiag import block_tridiag_matvec
from torch_parity import no_jax_cache_writes, spd_block_tridiag, spd_blocks  # noqa: F401


@pytest.mark.parametrize("B,k", [(1, 4), (13, 3), (40, 16), (9, 32), (6, 64)])
def test_batched_gj_inverse_matches_jax(B, k):
    """k = 64 takes the blocked Schur inverse, every other k the flat sweep."""
    C = spd_blocks(B, k, seed=B * 100 + k)
    M = cr.batched_gj_inverse(torch.as_tensor(C))
    assert M.dtype == torch.float32 and M.shape == (B, k, k)
    M = M.double().numpy()
    M_jax = np.asarray(jcr.batched_gj_inverse(jnp.asarray(C), interpret=True), np.float64)
    # the reference test's bar on the identity error
    assert np.abs(M @ C - np.eye(k)).max() < 1e-4
    # both are float32 inverses whose sums run in another order: per block,
    # ||M - M_jax||_F <= 1e-5 ||M_jax||_F
    rel = np.linalg.norm(M - M_jax, axis=(1, 2)) / np.linalg.norm(M_jax, axis=(1, 2))
    assert rel.max() <= 1e-5, rel.max()


def test_blocked_and_flat_plain_versions_agree():
    """The two plain versions invert the same k = 64 blocks to float32
    accuracy (the blocked one is the k = 64 route, the flat one the rest)."""
    C = torch.as_tensor(spd_blocks(5, 64, seed=7), dtype=torch.float32)
    Mb = cr.bgj_blocked64_plain(C).double()
    Mf = cr.bgj_flat_plain(C).double()
    rel = torch.linalg.matrix_norm(Mb - Mf) / torch.linalg.matrix_norm(Mf)
    assert float(rel.max()) <= 1e-5


@pytest.mark.parametrize("wrapper,plain,k", [
    (cr.bgj_flat, cr.bgj_flat_plain, 8),
    (cr.bgj_blocked64, cr.bgj_blocked64_plain, 64),
])
def test_wrapper_on_cpu_runs_plain_version_uncounted(wrapper, plain, k):
    C = torch.as_tensor(spd_blocks(3, k, seed=k), dtype=torch.float32)
    before = dict(cr.LAUNCHES)
    assert torch.equal(wrapper(C), plain(C))
    assert cr.LAUNCHES == before


@pytest.mark.parametrize("wrapper", [cr.bgj_flat, cr.bgj_blocked64])
def test_wrapper_rejects_other_devices_and_dtypes(wrapper):
    with pytest.raises(ValueError):
        wrapper(torch.empty((2, 64, 64), device="meta"))
    with pytest.raises(TypeError):
        wrapper(torch.eye(64, dtype=torch.float64)[None])


@pytest.mark.parametrize("N,k", [(12, 4), (13, 4), (36, 8), (37, 8), (1, 4)])
def test_cr_solve_matches_jax(N, k):
    """Even and odd N; f32 cyclic reduction in both packages against the
    float64 Thomas solve, at the reference test's 5e-6 relative bar."""
    D, L, b = spd_block_tridiag(max(N, 2), k, seed=N + k)
    D, L, b = D[:N], L[: N - 1], b[:N]
    ref = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    x = cr.cr_solve(torch.as_tensor(D), torch.as_tensor(L), torch.as_tensor(b))
    assert x.dtype == torch.float32 and x.shape == (N, k)
    x_jax = np.asarray(jcr.cr_solve(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), interpret=True))
    scale = np.abs(ref).max()
    assert np.abs(x.double().numpy() - ref).max() / scale < 5e-6
    assert np.abs(x.double().numpy() - x_jax).max() / scale < 5e-6


def test_cr_resolve_reuses_factor_for_multiple_rhs():
    N, k = 37, 8
    D, L, _ = spd_block_tridiag(N, k, seed=3)
    B3 = np.random.default_rng(1).standard_normal((N, k, 3))
    fact = cr.cr_factor(torch.as_tensor(D), torch.as_tensor(L))
    x = cr.cr_resolve(fact, torch.as_tensor(B3))
    assert x.shape == (N, k, 3)
    ref = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(B3)))
    assert np.abs(x.double().numpy() - ref).max() / np.abs(ref).max() < 5e-6


def test_cr_factor_tail_matches_scan():
    """The tail of cr_factor(tail_n > 1) goes through the streaming Thomas
    kernels (B3/B4): the factorization keeps their inverses of the last 4
    blocks, and cr_resolve solves through them to the float64 scan's x."""
    D, L, b = spd_block_tridiag(8, 2, seed=0)
    fact = cr.cr_factor(torch.as_tensor(D), torch.as_tensor(L), tail_n=4)
    assert fact["root"] is None and fact["tail"]["Minv"].shape == (4, 2, 2)
    x = cr.cr_resolve(fact, torch.as_tensor(b))
    ref = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    assert np.abs(x.double().numpy() - ref).max() / np.abs(ref).max() < 5e-6


@pytest.mark.parametrize("rhs_cols", [None, 3])
def test_block_tridiag_matvec_matches_jax(rhs_cols):
    N, k = 9, 5
    D, L, b = spd_block_tridiag(N, k, seed=11)
    x = b if rhs_cols is None else np.random.default_rng(2).standard_normal((N, k, rhs_cols))
    y = block_tridiag_matvec(torch.as_tensor(D), torch.as_tensor(L), torch.as_tensor(x))
    y_jax = np.asarray(jax_matvec(jnp.asarray(D), jnp.asarray(L), jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=1e-13, atol=1e-13)
