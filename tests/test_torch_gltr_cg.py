"""Port parity: the trust-region solvers of the Newton step,
sleqp_tpu_torch/ops/{gltr,tr_cg}.py against sleqp_tpu/ops/{gltr,tr_cg}.py
(oracles of tests/test_gltr.py and tests/test_kkt.py).  Steps to 1e-9 in
float64; in float32 (the mixed route's Krylov loop) to 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleqp_tpu.ops import gltr as jgltr
from sleqp_tpu.ops import kkt as jkkt
from sleqp_tpu.ops import tr_cg as jcg
from sleqp_tpu_torch.ops import gltr as tgltr
from sleqp_tpu_torch.ops import kkt as tkkt
from sleqp_tpu_torch.ops import tr_cg as tcg
from torch_parity import no_jax_cache_writes  # noqa: F401

SOLVERS = {"gltr": (jgltr.gltr, tgltr.gltr), "cg": (jcg.steihaug_cg, tcg.steihaug_cg)}


def _case(kind, n, m, seed, var_active=False):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    if kind == "convex":
        H = M @ M.T + n * np.eye(n)
    elif kind == "indefinite":
        H = 0.5 * (M + M.T)
    else:  # a hard case: g orthogonal to the most negative eigenvector
        H = np.diag(np.linspace(-2.0, 3.0, n))
    g = rng.standard_normal(n)
    if kind == "hard":
        g[0] = 0.0
    J = rng.standard_normal((m, n))
    cs = np.zeros(m, np.int8)
    cs[: m // 2 + (m > 0)] = 2
    vs = np.zeros(n, np.int8)
    if var_active:
        vs[-1] = 1
    return H, g, J, vs, cs


def _run(which, H, g, J, vs, cs, radius, dtype, max_it=50, p0=None):
    jf, tf = SOLVERS[which]
    ja = jkkt.aug_jac_create(jnp.asarray(J, dtype), jnp.asarray(vs), jnp.asarray(cs))
    ta = tkkt.aug_jac_create(torch.as_tensor(J).to(getattr(torch, dtype)), torch.as_tensor(vs),
                             torch.as_tensor(cs))
    jH, tH = jnp.asarray(H, dtype), torch.as_tensor(H).to(getattr(torch, dtype))
    jr = jf(lambda d: jH @ d, ja, jnp.asarray(g, dtype), jnp.asarray(radius, dtype),
            max_iterations=max_it, p0=None if p0 is None else jnp.asarray(p0))
    tr = tf(lambda d: tH @ d, ta, torch.as_tensor(g).to(getattr(torch, dtype)),
            torch.tensor(radius, dtype=getattr(torch, dtype)), max_iterations=max_it,
            p0=None if p0 is None else torch.as_tensor(p0))
    return jr, tr


@pytest.mark.parametrize("which", sorted(SOLVERS))
@pytest.mark.parametrize("kind", ["convex", "indefinite", "hard"])
@pytest.mark.parametrize("radius", [0.1, 1.0, 100.0])
def test_tr_solvers_match_jax(which, kind, radius):
    """Two active constraint rows, as tests/test_kkt.py's CG cases; GLTR
    also with an active variable bound."""
    H, g, J, vs, cs = _case(kind, 8, 3, seed=len(kind), var_active=which == "gltr")
    jr, tr = _run(which, H, g, J, vs, cs, radius, "float64")
    np.testing.assert_allclose(tr.step.numpy(), np.asarray(jr.step), atol=1e-9)
    assert bool(tr.on_boundary) == bool(jr.on_boundary)
    assert int(tr.iterations) == int(jr.iterations)
    assert tr.iterations.dtype == torch.int32
    np.testing.assert_allclose(float(tr.min_rayleigh), float(jr.min_rayleigh), atol=1e-9)
    np.testing.assert_allclose(float(tr.max_rayleigh), float(jr.max_rayleigh), atol=1e-9)
    # the step stays in null(A_W) and inside the region
    active = J[cs != 0]
    np.testing.assert_allclose(active @ tr.step.numpy(), 0.0, atol=1e-9)
    assert np.linalg.norm(tr.step.numpy()) <= radius * (1 + 1e-12)


@pytest.mark.parametrize("which", sorted(SOLVERS))
def test_tr_solvers_float32_match_jax(which):
    """The mixed route: the Krylov loop in float32 from a float64 p0."""
    H, g, J, vs, cs = _case("indefinite", 10, 4, seed=11)
    aj64 = tkkt.aug_jac_create(torch.as_tensor(J), torch.as_tensor(vs), torch.as_tensor(cs))
    p0 = tkkt.project_nullspace(aj64, torch.as_tensor(g)).float().numpy()
    jr, tr = _run(which, H, g, J, vs, cs, 1.0, "float32", p0=p0)
    assert tr.step.dtype == torch.float32
    np.testing.assert_allclose(tr.step.numpy(), np.asarray(jr.step), atol=1e-4)
    assert bool(tr.on_boundary) == bool(jr.on_boundary)
    assert abs(int(tr.iterations) - int(jr.iterations)) <= 1


@pytest.mark.parametrize("which", sorted(SOLVERS))
def test_zero_gradient_and_iteration_cap(which):
    H, g, J, vs, cs = _case("convex", 6, 0, seed=2)
    jr, tr = _run(which, H, np.zeros(6), J, vs, cs, 1.0, "float64")
    assert int(tr.iterations) == int(jr.iterations) == 0
    np.testing.assert_array_equal(tr.step.numpy(), 0.0)
    assert float(tr.min_rayleigh) == float(jr.min_rayleigh) == 0.0
    jr, tr = _run(which, H, g, J, vs, cs, 100.0, "float64", max_it=2)
    assert int(tr.iterations) == int(jr.iterations)
    np.testing.assert_allclose(tr.step.numpy(), np.asarray(jr.step), atol=1e-9)
