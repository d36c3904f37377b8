"""Port parity: the streaming Thomas kernels (B3/B4), the batched Cholesky
Thomas kernels (B5/B6) and the mixed-precision solve
(sleqp_tpu_torch/ops/pallas_tridiag.py and pallas_chol_tridiag.py against
sleqp_tpu/ops/pallas_tridiag.py and pallas_chol_tridiag.py), the cases of
tests/test_pallas_tridiag.py.  The JAX side runs its Pallas kernels in
interpret mode; the port runs the kernels' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleqp_tpu.ops import cyclic_reduction as jcr
from sleqp_tpu.ops import pallas_chol_tridiag as jpc
from sleqp_tpu.ops import pallas_tridiag as jpt
from sleqp_tpu.ops.block_tridiag import block_thomas_factor as jax_factor
from sleqp_tpu.ops.block_tridiag import block_thomas_solve as jax_solve
from sleqp_tpu.ops.block_tridiag import block_tridiag_solve as jax_thomas
from sleqp_tpu_torch.ops import cyclic_reduction as cr
from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc
from sleqp_tpu_torch.ops import pallas_tridiag as pt
from torch_parity import no_jax_cache_writes, spd_block_tridiag  # noqa: F401

# The port's float32 recursions against the reference's on the same inputs:
# the Gauss-Jordan and Cholesky updates round alike (both are fused
# multiply-adds), the block products sum in another order, so the two
# agree to a few float32 ulps of the result's scale.
SAME_F32 = 2e-6


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _residual(D, L, b, x):
    """max |b - A x| / max(max |b|, 1), in float64."""
    r = np.asarray(jpt.block_tridiag_matvec(jnp.asarray(D), jnp.asarray(L), jnp.asarray(x)))
    return np.abs(np.asarray(b) - r).max() / max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("N,k", [(5, 2), (9, 3), (16, 8)])
def test_factor_solve_matches_jax(N, k):
    """tests/test_pallas_tridiag.py::test_factor_solve_matches_scan."""
    D, L, b = spd_block_tridiag(N, k, seed=N + k)
    x, Minv, Lp32 = pt.block_tridiag_factor_solve_pallas(*_t(D, L, b))
    assert x.dtype == torch.float32 and x.shape == (N, k)
    assert Minv.shape == (N, k, k) and Lp32.shape == (N, k, k)
    x_ref = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=2e-4, atol=2e-4)
    x_j, Minv_j, Lp_j = jpt.block_tridiag_factor_solve_pallas(
        jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), interpret=True
    )
    assert _rel(x.numpy(), x_j) <= SAME_F32
    assert _rel(Minv.numpy(), Minv_j) <= SAME_F32
    np.testing.assert_array_equal(Lp32.numpy(), np.asarray(Lp_j))


def test_resolve_reuses_factorization():
    """tests/test_pallas_tridiag.py::test_resolve_reuses_factorization."""
    N, k = 7, 3
    D, L, b = spd_block_tridiag(N, k, seed=11)
    _, Minv, Lp32 = pt.block_tridiag_factor_solve_pallas(*_t(D, L, b))
    b2 = np.random.default_rng(1).standard_normal((N, k, 2))
    x2 = pt.block_tridiag_resolve_pallas(Minv, Lp32, torch.as_tensor(b2))
    assert x2.shape == (N, k, 2)
    x2_ref = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b2)))
    np.testing.assert_allclose(x2.numpy(), x2_ref, rtol=2e-4, atol=2e-4)
    _, Minv_j, Lp_j = jpt.block_tridiag_factor_solve_pallas(
        jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), interpret=True
    )
    x2_j = jpt.block_tridiag_resolve_pallas(Minv_j, Lp_j, jnp.asarray(b2), interpret=True)
    assert _rel(x2.numpy(), x2_j) <= SAME_F32


@pytest.mark.parametrize("rhs_cols", [None, 3])
def test_mixed_precision_refinement_reaches_f64(rhs_cols):
    """tests/test_pallas_tridiag.py::test_mixed_precision_refinement_reaches_f64:
    the auto backend (cr32 here) with three refinements."""
    N, k = 12, 4
    D, L, b = spd_block_tridiag(N, k, seed=7)
    if rhs_cols is not None:
        b = np.random.default_rng(2).standard_normal((N, k, rhs_cols))
    x = pt.block_tridiag_solve_mp(*_t(D, L, b), refine_iters=3)
    assert x.dtype == torch.float64 and x.shape == b.shape
    assert _residual(D, L, b, x.numpy()) <= 1e-10
    x_j = jpt.block_tridiag_solve_mp(
        jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), refine_iters=3, interpret=True
    )
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0, atol=1e-12)


def test_fallback_when_unsupported():
    """k beyond the Gauss-Jordan limit: auto sends it to the scan
    (dispatch by shape, as the reference)."""
    N, k = 4, 96
    D, L, b = spd_block_tridiag(N, k, seed=9)
    assert not pt.pallas_supported(N, k)
    assert pt.pallas_supported(4096, 32)
    x = pt.block_tridiag_solve_mp(*_t(D, L, b))
    x_ref = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-12)
    x_j = jpt.block_tridiag_solve_mp(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-12)


def _strongly_coupled(N, k):
    """The system of tests/test_pallas_tridiag.py::test_chol_pallas_backend_matches_f64:
    couplings of 3e3 against diagonals of 1e4 (the condensed banded KKT's
    failure mode for the explicit inverses)."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((N, k, k))
    D = np.einsum("nij,nkj->nik", M, M) * 0.1 + 1e4 * np.eye(k)
    D[0] += -1e4 * np.eye(k) + 2.0 * np.eye(k)
    L = rng.standard_normal((N - 1, k, k)) * 3e3
    b = rng.standard_normal((N, k))
    return D, L, b


def test_chol_pallas_backend_matches_f64():
    """tests/test_pallas_tridiag.py::test_chol_pallas_backend_matches_f64."""
    D, L, b = _strongly_coupled(12, 8)
    x = pt.block_tridiag_solve_mp(*_t(D, L, b), refine_iters=3, backend="chol_pallas")
    ref = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), ref, atol=1e-7)
    x_j = jpt.block_tridiag_solve_mp(
        jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), refine_iters=3, backend="chol_pallas",
        interpret=True,
    )
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=1e-7)


def test_batched_thomas_matches_jax():
    """tests/test_pallas_tridiag.py::test_batched_thomas_pallas_vs_xla:
    the port's batched Cholesky Thomas against the reference's Pallas
    kernels (interpret mode) and its vmapped scan, for one and several
    right-hand sides."""
    P, c, k, r = 3, 5, 8, 4
    rng = np.random.default_rng(0)
    M = rng.standard_normal((P, c, k, k))
    D = (np.einsum("pcij,pckj->pcik", M, M) + 2 * k * np.eye(k)).astype(np.float32)
    L = (rng.standard_normal((P, c - 1, k, k)) * 0.3).astype(np.float32)
    chols, Lp = pc.batched_thomas_factor_pallas(*_t(D, L))
    ch_ref = np.asarray(jax.vmap(jax_factor)(jnp.asarray(D), jnp.asarray(L)))
    np.testing.assert_allclose(chols.numpy(), ch_ref, atol=1e-5)
    ch_j, Lp_j = jpc.batched_thomas_factor_pallas(jnp.asarray(D), jnp.asarray(L), interpret=True)
    assert _rel(chols.numpy(), ch_j) <= SAME_F32
    np.testing.assert_array_equal(Lp.numpy(), np.asarray(Lp_j))
    for shape in ((P, c, k), (P, c, k, r)):
        B = rng.standard_normal(shape).astype(np.float32)
        x = pc.batched_thomas_solve_pallas(chols, Lp, torch.as_tensor(B))
        assert x.shape == shape and x.dtype == torch.float32
        ref = np.asarray(jax.vmap(jax_solve)(jnp.asarray(ch_ref), jnp.asarray(L), jnp.asarray(B)))
        np.testing.assert_allclose(x.numpy(), ref, atol=1e-5)
        x_j = jpc.batched_thomas_solve_pallas(ch_j, Lp_j, jnp.asarray(B), interpret=True)
        assert _rel(x.numpy(), x_j) <= SAME_F32


@pytest.mark.parametrize("N,k", [(1, 3), (2, 2), (3, 4)])
def test_spike32_tiny_n_identity_pads(N, k):
    """tests/test_pallas_tridiag.py::test_spike32_tiny_n_identity_pads."""
    D, L, b = spd_block_tridiag(max(N, 2), k, seed=N * 7 + k)
    D, L, b = D[:N], L[: max(N - 1, 0)], b[:N]
    x = pt.block_tridiag_solve_mp(*_t(D, L, b), backend="spike32")
    x_ref = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-9, atol=1e-9)
    x_j = jpt.block_tridiag_solve_mp(
        jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), backend="spike32", interpret=True
    )
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-9, atol=1e-9)


def test_unknown_backend_rejected():
    D, L, b = spd_block_tridiag(5, 2, seed=3)
    with pytest.raises(ValueError, match="unknown"):
        pt.block_tridiag_solve_mp(*_t(D, L, b), backend="spike")
    with pytest.raises(ValueError, match="unknown"):
        jpt.block_tridiag_solve_mp(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), backend="spike")


def test_float32_rhs_takes_the_scan_unrefined():
    """A float32 right-hand side is solved by the scan in the dtype the
    operands promote to, with no refinement, in both packages."""
    D, L, b = spd_block_tridiag(6, 3, seed=4)
    b32 = b.astype(np.float32)
    x = pt.block_tridiag_solve_mp(*_t(D.astype(np.float32), L.astype(np.float32), b32))
    x_j = jpt.block_tridiag_solve_mp(
        jnp.asarray(D, jnp.float32), jnp.asarray(L, jnp.float32), jnp.asarray(b32)
    )
    assert x.dtype == torch.float32 and x_j.dtype == jnp.float32
    assert _rel(x.numpy(), x_j) <= SAME_F32


@pytest.mark.parametrize("N,k,tail", [(3, 2, 1), (12, 4, 1), (37, 8, 1), (50, 8, 16)])
def test_cyclic_reduction_matches_jax(N, k, tail):
    """tests/test_pallas_tridiag.py::test_cyclic_reduction_matches_scan:
    pure cyclic reduction and the hybrid with a streaming Thomas tail,
    against the float64 scan at its 5e-6 bar and against the reference."""
    D, L, b = spd_block_tridiag(max(N, 2), k, seed=N + k)
    D, L, b = D[:N], L[: max(N - 1, 0)], b[:N]
    B2 = np.random.default_rng(1).standard_normal((N, k, 3)).astype(np.float32)
    fact = cr.cr_factor(*_t(D, L), tail_n=tail)
    # pure cyclic reduction is held to the reference in
    # test_torch_cyclic_reduction.py; here the hybrid with the B3/B4 tail
    fact_j = jcr.cr_factor(jnp.asarray(D), jnp.asarray(L), interpret=True, tail_n=tail) if tail > 1 else None
    for rhs in (b, B2):
        x = cr.cr_resolve(fact, torch.as_tensor(rhs))
        ref = np.asarray(jax_thomas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(rhs, jnp.float64)))
        assert _rel(x.numpy(), ref) < 5e-6
        if fact_j is not None:
            assert _rel(x.numpy(), jcr.cr_resolve(fact_j, jnp.asarray(rhs))) <= SAME_F32


@pytest.mark.parametrize("backend", ["cr32", "auto"])
def test_cr32_mp_backend_refines_to_f64(backend):
    """tests/test_pallas_tridiag.py::test_cr32_mp_backend_refines_to_f64."""
    N, k = 24, 8
    D, L, b = spd_block_tridiag(N, k, seed=5)
    x = pt.block_tridiag_solve_mp(*_t(D, L, b), refine_iters=3, backend=backend)
    assert x.dtype == torch.float64
    assert _residual(D, L, b, x.numpy()) <= 1e-10


@pytest.mark.parametrize("backend", ["scan32", "spike32", "chol_pallas", "cr32"])
def test_each_backend_matches_jax(backend):
    """Each backend with two refinements gives the reference's float64
    answer on the same inputs."""
    N, k = 7, 4
    D, L, b = spd_block_tridiag(N, k, seed=21)
    x = pt.block_tridiag_solve_mp(*_t(D, L, b), backend=backend)
    x_j = jpt.block_tridiag_solve_mp(
        jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), backend=backend, interpret=True
    )
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0, atol=1e-12)


# ---- the wrappers on the CPU ------------------------------------------------


def _f32(*arrays):
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32) for a in arrays]


def test_wrappers_on_cpu_run_plain_versions_uncounted():
    D, L, b = spd_block_tridiag(6, 3, seed=2)
    D, b = _f32(D, b[..., None])
    Lp = pt._pad_sub(torch.as_tensor(L, dtype=torch.float32), 6, 3)
    before = dict(pt.LAUNCHES), dict(pc.LAUNCHES)
    y, M = pt.thomas_fwd(D, Lp, b, factor=True)
    y_p, M_p = pt.thomas_fwd_plain(D, Lp, b, True)
    assert torch.equal(y, y_p) and torch.equal(M, M_p)
    assert torch.equal(pt.thomas_bwd(M, Lp, y), pt.thomas_bwd_plain(M, Lp, y))
    assert pt.thomas_fwd(M, Lp, b, factor=False)[1] is None
    D4, Lp4, b4 = D[None], Lp[None], b[None]
    ch = pc.chol_thomas_factor(D4, Lp4)
    assert torch.equal(ch, pc.chol_thomas_factor_plain(D4, Lp4))
    assert torch.equal(pc.chol_thomas_solve(ch, Lp4, b4), pc.chol_thomas_solve_plain(ch, Lp4, b4))
    assert (dict(pt.LAUNCHES), dict(pc.LAUNCHES)) == before


def test_wrappers_reject_other_devices_and_dtypes():
    meta = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        pt.thomas_fwd(meta, meta, torch.empty((2, 4, 1), device="meta"), factor=True)
    with pytest.raises(ValueError, match="device"):
        pc.chol_thomas_factor(meta[None], meta[None])
    D64 = torch.eye(4, dtype=torch.float64).expand(1, 2, 4, 4).contiguous()
    with pytest.raises(TypeError):
        pc.chol_thomas_factor(D64, D64)
    with pytest.raises(TypeError):
        pt.thomas_bwd(D64[0], D64[0], torch.ones((2, 4, 1), dtype=torch.float64))



def _blocks(*shape):
    return torch.zeros(shape, dtype=torch.float32)


# Operands that do not agree: each would hand the kernel pointers to
# allocations smaller than the sizes it takes from another operand.
N_, K_, R_ = 4, 3, 2
MISMATCHED = {
    "thomas_fwd, L in place of Lp": lambda: pt.thomas_fwd(
        _blocks(N_, K_, K_), _blocks(N_ - 1, K_, K_), _blocks(N_, K_, R_), factor=True),
    "thomas_fwd, b of another k": lambda: pt.thomas_fwd(
        _blocks(N_, K_, K_), _blocks(N_, K_, K_), _blocks(N_, K_ + 1, R_), factor=False),
    "thomas_fwd, operands on two devices": lambda: pt.thomas_fwd(
        _blocks(N_, K_, K_), _blocks(N_, K_, K_).to("meta"), _blocks(N_, K_, R_), factor=True),
    "thomas_bwd, y of another N": lambda: pt.thomas_bwd(
        _blocks(N_, K_, K_), _blocks(N_, K_, K_), _blocks(N_ + 1, K_, R_)),
    "thomas_bwd, blocks not square": lambda: pt.thomas_bwd(
        _blocks(N_, K_, K_ + 1), _blocks(N_, K_, K_ + 1), _blocks(N_, K_, R_)),
    "chol_thomas_factor, L in place of Lp": lambda: pc.chol_thomas_factor(
        _blocks(2, N_, K_, K_), _blocks(2, N_ - 1, K_, K_)),
    "chol_thomas_factor, operands on two devices": lambda: pc.chol_thomas_factor(
        _blocks(2, N_, K_, K_), _blocks(2, N_, K_, K_).to("meta")),
    "chol_thomas_solve, B of another c": lambda: pc.chol_thomas_solve(
        _blocks(2, N_, K_, K_), _blocks(2, N_, K_, K_), _blocks(2, N_ - 1, K_, R_)),
    "chol_thomas_solve, Lp of another P": lambda: pc.chol_thomas_solve(
        _blocks(2, N_, K_, K_), _blocks(1, N_, K_, K_), _blocks(2, N_, K_, R_)),
}


@pytest.mark.parametrize("case", MISMATCHED)
def test_wrappers_reject_mismatched_operands(case):
    with pytest.raises(ValueError, match="expected|is on|not square"):
        MISMATCHED[case]()


def test_wide_rhs_is_walked_in_tiles():
    """More right-hand sides than one launch takes: the wrappers walk them
    in tiles (the first factors, the rest reuse its inverses) and give the
    untiled plain versions' result, to float32 rounding (the products'
    sums may be ordered differently at another width)."""
    r = 2 * pt.RHS_TILE + 7
    D, L, _ = spd_block_tridiag(5, 3, seed=4)
    b = np.random.default_rng(5).standard_normal((5, 3, r))
    D, b = _f32(D, b)
    Lp = pt._pad_sub(torch.as_tensor(L, dtype=torch.float32), 5, 3)
    y, M = pt.thomas_fwd(D, Lp, b, factor=True)
    y_p, M_p = pt.thomas_fwd_plain(D, Lp, b, True)
    assert torch.equal(M, M_p)
    assert _rel(y, y_p) <= SAME_F32
    assert _rel(pt.thomas_fwd(M, Lp, b, factor=False)[0], y_p) <= SAME_F32
    assert _rel(pt.thomas_bwd(M, Lp, y), pt.thomas_bwd_plain(M_p, Lp, y_p)) <= SAME_F32
    D4, Lp4, b4 = D[None], Lp[None], b[None]
    ch = pc.chol_thomas_factor(D4, Lp4)
    assert _rel(pc.chol_thomas_solve(ch, Lp4, b4), pc.chol_thomas_solve_plain(ch, Lp4, b4)) <= SAME_F32
