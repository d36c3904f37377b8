"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so that it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import importlib.util

import numpy as np
import pytest
import torch

from sleqp_tpu_torch.ops import cyclic_reduction as cr


@pytest.fixture(scope="module", autouse=True)
def no_jax_cache_writes():
    """Nothing here compiles with JAX; where JAX is present, keep its
    persistent cache closed all the same, as the other port test files do."""
    if importlib.util.find_spec("jax") is None:
        yield
        return
    import jax

    key = "jax_persistent_cache_min_entry_size_bytes"
    old = getattr(jax.config, key)
    jax.config.update(key, 2**62)
    yield
    jax.config.update(key, old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spd_blocks(B, k, seed, device):
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((B, k, k))
    C = np.einsum("bij,bkj->bik", C, C) + 2 * k * np.eye(k)
    return torch.tensor(C, dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,k", [(781, 32), (9, 32), (13, 3), (1, 4), (1561, 64)])
def test_kernel_matches_plain_version(cuda, B, k):
    """The main path's shapes. Both are float32 inverses whose identity
    error the reference test bounds by 1e-4, and
    ||K - P|| <= ||P|| ||I - C K||."""
    C = _spd_blocks(B, k, seed=B + k, device=cuda)
    wrapper, plain, name = (
        (cr.bgj_blocked64, cr.bgj_blocked64_plain, "bgj_blocked64")
        if k == cr.BLOCKED_K
        else (cr.bgj_flat, cr.bgj_flat_plain, "bgj_flat")
    )
    before = cr.LAUNCHES[name]
    K, P = wrapper(C), plain(C)
    torch.cuda.synchronize()
    assert cr.LAUNCHES[name] == before + 1
    rel = torch.linalg.matrix_norm((K - P).double()) / torch.linalg.matrix_norm(P.double())
    assert float(rel.max()) <= 1e-4
    eye = torch.eye(k, dtype=torch.float64, device=cuda)
    assert float((K.double() @ C.double() - eye).abs().max()) < 1e-4


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        cr.bgj_flat(_spd_blocks(2, 8, 0, cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="exceeds"):
        cr.bgj_flat(_spd_blocks(1, 96, 0, cuda))
    with pytest.raises(ValueError, match="k=64"):
        cr.bgj_blocked64(_spd_blocks(1, 32, 0, cuda))
