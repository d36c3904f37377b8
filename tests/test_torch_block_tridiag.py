"""Port parity: the float64 block-Thomas solve
(sleqp_tpu_torch/ops/block_tridiag.py against sleqp_tpu/ops/block_tridiag.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleqp_tpu.ops import block_tridiag as jbt
from sleqp_tpu_torch.ops import block_tridiag as bt
from torch_parity import no_jax_cache_writes, spd_block_tridiag  # noqa: F401


@pytest.mark.parametrize("rhs_cols", [None, 3])
@pytest.mark.parametrize("N,k", [(1, 3), (2, 2), (5, 2), (9, 3), (16, 8)])
def test_thomas_solve_matches_jax(N, k, rhs_cols):
    D, L, b = spd_block_tridiag(max(N, 2), k, seed=N + k)
    D, L, b = D[:N], L[: N - 1], b[:N]
    if rhs_cols is not None:
        b = np.random.default_rng(N).standard_normal((N, k, rhs_cols))
    x = bt.block_tridiag_solve(torch.as_tensor(D), torch.as_tensor(L), torch.as_tensor(b))
    assert x.dtype == torch.float64 and x.shape == b.shape
    x_jax = np.asarray(jbt.block_tridiag_solve(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=0, atol=1e-10 * np.abs(x_jax).max())


def test_thomas_factor_matches_jax():
    D, L, _ = spd_block_tridiag(7, 4, seed=5)
    chols = bt.block_thomas_factor(torch.as_tensor(D), torch.as_tensor(L)).numpy()
    chols_jax = np.asarray(jbt.block_thomas_factor(jnp.asarray(D), jnp.asarray(L)))
    # the lower triangles hold the factors (JAX leaves the upper one unspecified)
    np.testing.assert_allclose(np.tril(chols), np.tril(chols_jax), rtol=0, atol=1e-10)


def test_indefinite_block_gives_nonfinite_solution_like_jax():
    """A block that is not PD makes the factor NaN in both packages, which
    the OCP iteration reads as a failed step."""
    D, L, b = spd_block_tridiag(4, 3, seed=2)
    D[2] = -D[2]
    x = bt.block_tridiag_solve(torch.as_tensor(D), torch.as_tensor(L), torch.as_tensor(b))
    x_jax = np.asarray(jbt.block_tridiag_solve(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    assert not np.isfinite(x_jax).all()
    assert not torch.isfinite(x).all()


# ---- SPIKE (schur_factor / schur_resolve) and the LU variant ------------


def _spd_chunked(N, k, seed):
    """(D, L, b) as tests/test_block_tridiag.py::_random_spd_block_tridiag."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((N - 1, k, k)) * 0.3
    D = np.zeros((N, k, k))
    for i in range(N):
        M = rng.standard_normal((k, k))
        D[i] = M @ M.T + (2.0 + 2 * k) * np.eye(k)
    b = rng.standard_normal((N, k))
    return D, L, b


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("c", [3, 5])
def test_schur_solve_matches_jax(P, c):
    """tests/test_block_tridiag.py::test_schur_vs_dense: N = P c - 1."""
    N, k = P * c - 1, 3
    D, L, b = _spd_chunked(N, k, seed=P * 10 + c)
    x = bt.schur_block_tridiag_solve(*map(torch.as_tensor, (D, L, b)), num_chunks=P)
    x_jax = np.asarray(jbt.schur_block_tridiag_solve(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), num_chunks=P))
    A_blocks = np.zeros((N * k, N * k))
    for i in range(N):
        A_blocks[i * k:(i + 1) * k, i * k:(i + 1) * k] = D[i]
    for i in range(N - 1):
        A_blocks[(i + 1) * k:(i + 2) * k, i * k:(i + 1) * k] = L[i]
        A_blocks[i * k:(i + 1) * k, (i + 1) * k:(i + 2) * k] = L[i].T
    expected = np.linalg.solve(A_blocks, b.reshape(-1)).reshape(N, k)
    np.testing.assert_allclose(x.numpy(), expected, atol=1e-8)
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=0, atol=1e-12)


def test_schur_matches_thomas_large():
    """tests/test_block_tridiag.py::test_schur_matches_thomas_large."""
    N, k, P = 63, 4, 8
    D, L, b = map(torch.as_tensor, _spd_chunked(N, k, seed=42))
    np.testing.assert_allclose(
        bt.schur_block_tridiag_solve(D, L, b, num_chunks=P).numpy(),
        bt.block_tridiag_solve(D, L, b).numpy(), atol=1e-8,
    )


def test_schur_factor_resolve_split():
    """tests/test_block_tridiag.py::test_schur_factor_resolve_split: one
    factorization, several right-hand sides, one of them with 2 columns;
    the factors equal the reference's."""
    N, k, P = 15, 3, 4
    rng = np.random.default_rng(0)
    M = rng.standard_normal((N, k, k))
    D = np.einsum("nij,nkj->nik", M, M) + 2 * k * np.eye(k)
    L = rng.standard_normal((N - 1, k, k)) * 0.3
    fact = bt.schur_factor(torch.as_tensor(D), torch.as_tensor(L), P)
    fact_jax = jbt.schur_factor(jnp.asarray(D), jnp.asarray(L), P)
    for key in ("VL", "VR", "S_sub"):
        np.testing.assert_allclose(fact[key].numpy(), np.asarray(fact_jax[key]), rtol=0, atol=1e-12)
    assert fact["shape"] == fact_jax["shape"]
    for rhs in [np.random.default_rng(s).standard_normal((N, k)) for s in range(3)] + [
        rng.standard_normal((N, k, 2))
    ]:
        x = bt.schur_resolve(fact, torch.as_tensor(rhs))
        np.testing.assert_allclose(
            x.numpy(), np.asarray(jbt.block_tridiag_solve(jnp.asarray(D), jnp.asarray(L), jnp.asarray(rhs))),
            atol=1e-10,
        )
        np.testing.assert_allclose(x.numpy(), np.asarray(jbt.schur_resolve(fact_jax, jnp.asarray(rhs))),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("N", [18, 37])
def test_solve_mp_spike32_backend(N):
    """tests/test_block_tridiag.py::test_solve_mp_spike32_backend: float32
    SPIKE with identity padding (N + 1 not a multiple of the chunk count)
    refines to float64."""
    from sleqp_tpu_torch.ops.pallas_tridiag import block_tridiag_solve_mp

    k = 4
    rng = np.random.default_rng(N)
    M = rng.standard_normal((N, k, k))
    D = np.einsum("nij,nkj->nik", M, M) + 2 * k * np.eye(k)
    L = rng.standard_normal((N - 1, k, k)) * 0.5
    b = rng.standard_normal((N, k))
    x = block_tridiag_solve_mp(*map(torch.as_tensor, (D, L, b)), refine_iters=3, backend="spike32")
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jbt.block_tridiag_solve(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b))), atol=1e-9
    )


@pytest.mark.parametrize("N,P", [(5, 2), (30, 4), (1, 2)])
def test_spike_solve_identity_pads_like_jax(N, P):
    """spike_block_tridiag_solve pads to P c - 1 blocks with c >= 2."""
    D, L, b = spd_block_tridiag(max(N, 2), 3, seed=N + P)
    D, L, b = D[:N], L[: N - 1], b[:N]
    x = bt.spike_block_tridiag_solve(*map(torch.as_tensor, (D, L, b)), P)
    x_jax = np.asarray(jbt.spike_block_tridiag_solve(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), P))
    assert x.shape == (N, 3)
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=0, atol=1e-12)


def test_schur_rejects_bad_chunking():
    D, L, b = map(torch.as_tensor, _spd_chunked(7, 2, seed=0))
    with pytest.raises(ValueError, match="divisible"):
        bt.schur_factor(D, L, 3)
    with pytest.raises(ValueError, match="interior"):
        bt.schur_factor(D, L, 8)


@pytest.mark.parametrize("rhs_cols", [None, 2])
def test_lu_solve_matches_jax(rhs_cols):
    """The pivoted-LU block Thomas on a quasi-definite system (stage blocks
    [H + rho I, J^T; J, -delta I], indefinite, as banded.py forms them)."""
    N, n, m = 6, 3, 2
    rng = np.random.default_rng(3)
    k = n + m
    D = np.zeros((N, k, k))
    for i in range(N):
        H = rng.standard_normal((n, n))
        J = rng.standard_normal((m, n))
        D[i, :n, :n] = H @ H.T + 2.0 * np.eye(n)
        D[i, n:, :n] = J
        D[i, :n, n:] = J.T
        D[i, n:, n:] = -0.5 * np.eye(m)
    L = 0.2 * rng.standard_normal((N - 1, k, k))
    b = rng.standard_normal((N, k) if rhs_cols is None else (N, k, rhs_cols))
    x = bt.block_tridiag_solve_lu(*map(torch.as_tensor, (D, L, b)))
    x_jax = np.asarray(jbt.block_tridiag_solve_lu(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    assert x.shape == b.shape
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=0, atol=1e-10 * np.abs(x_jax).max())
    from sleqp_tpu_torch.ops.pallas_tridiag import block_tridiag_matvec
    r = b - block_tridiag_matvec(*map(torch.as_tensor, (D, L)), x).numpy()
    assert np.abs(r).max() <= 1e-10 * np.abs(b).max()
