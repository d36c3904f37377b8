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
