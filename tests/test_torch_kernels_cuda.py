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
@pytest.mark.parametrize("B,k", [(781, 32), (9, 32), (13, 3), (1, 4), (5, 17), (4, 33), (3, 77),
                                 (2, 96), (1561, 64), (1, 64)])
def test_kernel_matches_plain_version(cuda, B, k):
    """The main path's shapes, ragged blocks at each padded width of
    bgj_flat (32, 64, 96), its widest block, and one block of 64 (the
    root of a cyclic reduction). Both are float32 inverses whose identity
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
        cr.bgj_flat(_spd_blocks(1, 97, 0, cuda))
    with pytest.raises(ValueError, match="k=64"):
        cr.bgj_blocked64(_spd_blocks(1, 32, 0, cuda))


# ---- B3/B4: the streaming block-Thomas sweeps (ops/pallas_tridiag.py) ----
# ---- B5/B6: the batched Cholesky block Thomas (ops/pallas_chol_tridiag.py)

def _tridiag(lead, k, r, seed, device):
    """SPD diagonal blocks (C C^T + 2k I), couplings 0.3 N(0,1) shifted so
    that Lp[..., 0] = 0, and right-hand sides; float32 on ``device``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(lead + (k, k))
    D = A @ np.swapaxes(A, -1, -2) + 2 * k * np.eye(k)
    Lp = 0.3 * rng.standard_normal(lead + (k, k))
    Lp[..., 0, :, :] = 0.0
    b = rng.standard_normal(lead + (k, r))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in (D, Lp, b)]


def _rel(K, P):
    """max |K - P| / max |P|: both are float32 recursions of the same
    arithmetic whose sums run in another order; 1e-4 is the bar of the
    reference's own float32 kernels (tests/test_pallas_tridiag.py:274)."""
    return float((K - P).abs().max() / P.abs().max())


@pytest.mark.cuda
# the structured-KKT path's shape, ragged blocks of both padded widths
# (32 and 64), and the most right-hand sides one launch takes
@pytest.mark.parametrize("N,k,r", [(160, 64, 1), (13, 3, 3), (1, 4, 1), (7, 33, 5), (5, 64, 128)])
def test_thomas_kernels_match_plain_versions(cuda, N, k, r):
    from sleqp_tpu_torch.ops import pallas_tridiag as pt

    D, Lp, b = _tridiag((N,), k, r, seed=N + k, device=cuda)
    before = dict(pt.LAUNCHES)
    y, M = pt.thomas_fwd(D, Lp, b, factor=True)
    x = pt.thomas_bwd(M, Lp, y)
    y2, none = pt.thomas_fwd(M, Lp, b, factor=False)
    torch.cuda.synchronize()
    assert none is None
    assert pt.LAUNCHES == {"thomas_fwd": before["thomas_fwd"] + 2, "thomas_bwd": before["thomas_bwd"] + 1}
    y_p, M_p = pt.thomas_fwd_plain(D, Lp, b, True)
    assert _rel(M, M_p) <= 1e-4
    assert _rel(y, y_p) <= 1e-4
    assert _rel(x, pt.thomas_bwd_plain(M_p, Lp, y_p)) <= 1e-4
    assert _rel(y2, pt.thomas_fwd_plain(M_p, Lp, b, False)[0]) <= 1e-4


# The main path's shapes, then blocks and right-hand sides that fill a
# warp's 32 lanes raggedly (k, r not multiples of 32), up to the largest
# staged tile (k = 128, where a stage's copies no longer overlap the one
# before) and the most right-hand sides one launch takes (r = 128).
CHOL_CASES = [(1, 160, 64, 1), (4, 40, 64, 8), (2, 8, 128, 1)] + [
    (2, 5, k, r) for k in (3, 17, 33, 64, 128) for r in (1, 5, 33, 128)
]


@pytest.mark.cuda
@pytest.mark.parametrize("P,c,k,r", CHOL_CASES)
def test_chol_thomas_kernels_match_plain_versions(cuda, P, c, k, r):
    from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc

    D, Lp, b = _tridiag((P, c), k, r, seed=P + c + k, device=cuda)
    before = dict(pc.LAUNCHES)
    chols = pc.chol_thomas_factor(D, Lp)
    x = pc.chol_thomas_solve(chols, Lp, b)
    torch.cuda.synchronize()
    assert pc.LAUNCHES == {k_: v + 1 for k_, v in before.items()}
    chols_p = pc.chol_thomas_factor_plain(D, Lp)
    assert _rel(chols, chols_p) <= 1e-4
    assert float(chols.triu(1).abs().max()) == 0.0
    assert _rel(x, pc.chol_thomas_solve_plain(chols_p, Lp, b)) <= 1e-4


@pytest.mark.cuda
def test_thomas_kernels_reject_what_they_cannot_take(cuda):
    from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc
    from sleqp_tpu_torch.ops import pallas_tridiag as pt

    D, Lp, b = _tridiag((3,), 96, 1, seed=0, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        pt.thomas_fwd(D, Lp, b, factor=True)
    D, Lp, b = _tridiag((1, 3), 160, 1, seed=0, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        pc.chol_thomas_factor(D, Lp)
    D, Lp, b = _tridiag((3,), 8, 2, seed=0, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pt.thomas_bwd(D, Lp, b.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.cuda
def test_wide_rhs_is_walked_in_tiles_on_the_card(cuda):
    """r beyond what one launch keeps in shared memory, at the largest
    blocks: one launch per tile of RHS_TILE columns, and the plain
    versions' result."""
    from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc
    from sleqp_tpu_torch.ops import pallas_tridiag as pt

    r = 2 * pt.RHS_TILE + 44  # 300: above the shared memory of one launch
    D, Lp, b = _tridiag((6,), pt.MAX_PALLAS_BLOCK, r, seed=7, device=cuda)
    before = dict(pt.LAUNCHES)
    y, M = pt.thomas_fwd(D, Lp, b, factor=True)
    x = pt.thomas_bwd(M, Lp, y)
    torch.cuda.synchronize()
    assert pt.LAUNCHES == {"thomas_fwd": before["thomas_fwd"] + 3, "thomas_bwd": before["thomas_bwd"] + 3}
    y_p, M_p = pt.thomas_fwd_plain(D, Lp, b, True)
    assert _rel(M, M_p) <= 1e-4
    assert _rel(y, y_p) <= 1e-4
    assert _rel(x, pt.thomas_bwd_plain(M_p, Lp, y_p)) <= 1e-4

    r = 2 * pc.RHS_TILE + 44
    D, Lp, b = _tridiag((2, 4), pc.MAX_CHOL_BLOCK, r, seed=8, device=cuda)
    before = pc.LAUNCHES["chol_thomas_solve"]
    chols = pc.chol_thomas_factor(D, Lp)
    x = pc.chol_thomas_solve(chols, Lp, b)
    torch.cuda.synchronize()
    assert pc.LAUNCHES["chol_thomas_solve"] == before + 3
    assert _rel(x, pc.chol_thomas_solve_plain(chols, Lp, b)) <= 1e-4


@pytest.mark.cuda
def test_thomas_kernels_reject_operands_on_two_devices(cuda):
    from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc
    from sleqp_tpu_torch.ops import pallas_tridiag as pt

    D, Lp, b = _tridiag((3,), 8, 2, seed=0, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        pt.thomas_fwd(D.cpu(), Lp, b, factor=True)
    with pytest.raises(ValueError, match="is on"):
        pt.thomas_bwd(D, Lp.cpu(), b)
    with pytest.raises(ValueError, match="is on"):
        pc.chol_thomas_solve(D[None], Lp[None], b[None].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("values", [
    [1.0, 3.0, 3.0, 2.0], [float("nan"), 1.0, float("nan")], [2.0, float("nan"), 5.0],
    [0.0, 0.0, 0.0], [-float("inf"), -float("inf"), 0.0]])
def test_argmax_argmin_tie_and_nan_rule_on_card(cuda, values):
    """The dense solve's pivoting (ops/simplex.py, ops/lp_enum.py) rests on
    argmax/argmin picking the first index of a tie and taking NaN as the
    extreme value; on the card as on the CPU, where the JAX package's rule
    is the same (tests/test_torch_simplex.py)."""
    from sleqp_tpu_torch.ops import simplex

    v = torch.tensor(values, dtype=torch.float64)
    for fn in (torch.argmax, torch.argmin):
        assert int(fn(v.to(cuda))) == int(fn(v))
    assert torch.equal(torch.isnan(simplex.sign(v.to(cuda))).cpu(), torch.isnan(simplex.sign(v)))
    # over a long vector too, where the reduction runs in several blocks
    w = torch.zeros(100_000, dtype=torch.float64)
    w[[70_000, 90_000]] = 5.0
    for fn in (torch.argmax, torch.argmin):
        assert int(fn(w.to(cuda))) == int(fn(w))
    w[[60_000, 95_000]] = float("nan")
    assert int(torch.argmax(w.to(cuda))) == int(torch.argmax(w)) == 60_000
