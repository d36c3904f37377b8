"""Port parity: the Cauchy LP layer, sleqp_tpu_torch/cauchy.py against
sleqp_tpu/cauchy.py (oracles of tests/test_cauchy.py and
tests/test_lp_enum.py): cold, warm-started and dual-warm-started LPs, the
reduced resolve, the mixed-precision route and the box-constrained closed
form.  Working sets, basis statuses and pivot counts exactly; steps,
duals and objectives to 1e-10."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.cauchy as jc
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.iterate import create_iterate
from sleqp_tpu.types import LPSolver
from sleqp_tpu_torch import Settings
from sleqp_tpu_torch import cauchy as tc
from sleqp_tpu_torch.convert import tree_from_numpy
from torch_dense import (
    boxqp, chainineq, flat_jax, flat_port, hs71, jax_cauchy_lp, jax_to_numpy, linear, mismatches,
    port_iterate, quadcons, wachbieg,
)
from torch_parity import no_jax_cache_writes  # noqa: F401

PAIRS = {"hs71": hs71, "quadcons": quadcons, "wachbieg": wachbieg, "linear": linear,
         "chainineq": lambda: chainineq(8)}


def _port_basis(jb):
    return tree_from_numpy(tc.CauchyBasis, jax_to_numpy(jb), device="cpu")


def _solve_both(jp, tp, jit_, radius, penalty, jbasis, tol=1e-10, **kw):
    jr = jax_cauchy_lp(jp.data, jit_, jnp.asarray(radius), jnp.asarray(penalty), jbasis, **kw)
    if "compute_dtype" in kw and kw["compute_dtype"] is not None:
        kw = dict(kw, compute_dtype=torch.float32)
    tr = tc.solve_cauchy_lp(tp.data, port_iterate(jit_), torch.tensor(radius, dtype=torch.float64),
                            torch.tensor(penalty, dtype=torch.float64), _port_basis(jbasis), **kw)
    bad = mismatches(flat_port(tr), flat_jax(jr), tol)
    assert not bad, bad
    return jr, tr


# every pair on the simplex; those small enough also by enumeration
CASES = [(name, LPSolver.SIMPLEX) for name in sorted(PAIRS)] + [
    (name, LPSolver.ENUM) for name in sorted(PAIRS) if name != "chainineq"]


@pytest.mark.parametrize("name,solver", CASES)
def test_cold_lp_matches_jax(name, solver):
    jp, tp, x0 = PAIRS[name]()
    n, m = jp.num_variables, jp.num_cons
    jit_ = create_iterate(jp, jnp.asarray(x0))
    for radius, penalty in ((0.5, 10.0), (10.0, 10.0), (0.05, 1e3)):
        for feas in (False, True):
            _solve_both(jp, tp, jit_, radius, penalty, jc.empty_basis(n, m), lp_solver=solver,
                        feasibility_mode=feas)


def test_reduced_resolve_and_lp_resolves_off_match_jax():
    """tests/test_cauchy.py::test_reduced_resolve_degenerate_tie: the
    feasible point of the Wächter-Biegler problem has a degenerate basis."""
    jp, tp, _ = wachbieg()
    jit_ = create_iterate(jp, jnp.asarray([1.0, 0.0, 0.5]))
    for resolves in (True, False):
        _, tr = _solve_both(jp, tp, jit_, 0.5, 10.0, jc.empty_basis(3, 2), lp_resolves=resolves)
        assert int(tr.cons_states[0]) != 0


@pytest.mark.parametrize("name", ["hs71", "chainineq", "quadcons"])
def test_warm_and_dual_warm_starts_match_jax(name):
    """tests/test_cauchy.py::test_warm_start_reuses_basis, and the dual
    stage (cauchy.py:183-270): the saved basis at a moved iterate, at a
    shrunk radius (primal infeasible, dual feasible), and with the dual
    warm start off."""
    jp, tp, x0 = PAIRS[name]()
    n, m = jp.num_variables, jp.num_cons
    jit_ = create_iterate(jp, jnp.asarray(x0))
    kw = dict(lp_solver=LPSolver.SIMPLEX)
    jr1, _ = _solve_both(jp, tp, jit_, 0.5, 10.0, jc.empty_basis(n, m), **kw)
    _, tr2 = _solve_both(jp, tp, jit_, 0.5, 10.0, jr1.basis, **kw)
    assert int(tr2.lp_iterations) == 0
    jit3 = create_iterate(jp, jnp.asarray(x0) + 0.01)
    _solve_both(jp, tp, jit3, 0.5, 10.0, jr1.basis, **kw)
    for dual in (True, False):
        _solve_both(jp, tp, jit_, 0.02, 10.0, jr1.basis, dual_warm_start=dual, **kw)
    # a saved basis that is flagged valid but structurally broken is repaired
    broken = dataclasses.replace(jr1.basis, status=jr1.basis.status.at[0].set(2))
    _solve_both(jp, tp, jit_, 0.5, 10.0, broken, **kw)


@pytest.mark.parametrize("name", ["hs71", "chainineq"])
def test_mixed_precision_lp_matches_jax(name):
    """compute_dtype float32: pivots in float32, extraction and duals
    refined in float64 (cauchy.py:373-440)."""
    jp, tp, x0 = PAIRS[name]()
    n, m = jp.num_variables, jp.num_cons
    jit_ = create_iterate(jp, jnp.asarray(x0))
    jr1, _ = _solve_both(jp, tp, jit_, 0.5, 10.0, jc.empty_basis(n, m), lp_solver=LPSolver.SIMPLEX,
                         compute_dtype=jnp.float32)
    _solve_both(jp, tp, jit_, 0.1, 10.0, jr1.basis, lp_solver=LPSolver.SIMPLEX,
                compute_dtype=jnp.float32)


def test_box_cauchy_matches_jax():
    jp, tp, x0 = boxqp(6)
    jit_ = create_iterate(jp, jnp.asarray(x0) + np.linspace(-0.4, 0.4, 6))
    for radius in (0.05, 0.3, 5.0):
        jr = jc.solve_box_cauchy(jp.data, jit_, jnp.asarray(radius))
        tr = tc.solve_box_cauchy(tp.data, port_iterate(jit_), torch.tensor(radius, dtype=torch.float64))
        bad = mismatches(flat_port(tr), flat_jax(jr), 1e-12)
        assert not bad, bad


def test_criticality_bound_and_backend_resolution_match_jax():
    args = [0.3, -0.2, 1.5, 0.25]
    assert float(tc.criticality_bound(*(torch.tensor(a, dtype=torch.float64) for a in args))) == \
        float(jc.criticality_bound(*(jnp.asarray(a) for a in args)))
    for n, m in ((4, 2), (20, 19), (200, 199), (3000, 2000), (10, 0)):
        for kw in ({}, {"pdlp_threshold": 50}, {"lp_solver": LPSolver.SIMPLEX}):
            assert int(tc.resolved_lp_solver(Settings(**kw), n, m)) == int(
                jc.resolved_lp_solver(JaxSettings(**kw), n, m))


def test_pdlp_backend_not_ported():
    jp, tp, x0 = hs71()
    it = port_iterate(create_iterate(jp, jnp.asarray(x0)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 6"):
        tc.solve_cauchy_lp(tp.data, it, torch.tensor(0.5, dtype=torch.float64),
                           torch.tensor(10.0, dtype=torch.float64),
                           tc.empty_basis(4, 2), lp_solver=LPSolver.PDLP)
