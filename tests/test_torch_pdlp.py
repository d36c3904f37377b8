"""Port parity of the first-order LP solver (sleqp_tpu_torch/ops/pdlp.py
against sleqp_tpu/ops/pdlp.py) and of the PDLP Cauchy backend.

* the seven cases of tests/test_pdlp.py through the port, each also held
  against JAX's ``pdlp.solve`` (or its backend) on the same inputs: the
  same state and iteration count, x and the duals to 1e-8, the same
  synthesized statuses;
* the state after a fixed number of PDHG blocks, to 1e-10 (no
  convergence test can end the run: ``tol < 0``), which holds every
  restart decision and primal-weight update on the way;
* AUTO routing to PDLP at ``pdlp_threshold`` and the parametric sweep with
  PDLP, one port iteration from every JAX iterate of HS71 to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.cauchy as jc
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu import create_iterate
from sleqp_tpu.ops import pdlp as jpdlp
from sleqp_tpu.ops import simplex as jsimplex
from sleqp_tpu.types import INF, BaseStat
from sleqp_tpu.types import LPSolver as JaxLPSolver
from sleqp_tpu.types import ParametricCauchy as JaxParametricCauchy
from sleqp_tpu_torch import LPSolver, ParametricCauchy, Settings, Solver, Status, solve
from sleqp_tpu_torch import cauchy as tc
from sleqp_tpu_torch.harness import hs as port_hs
from sleqp_tpu_torch.ops import pdlp
from test_simplex import _solve_scipy, _solve_sleqp, _standard_form
from torch_dense import (
    flat_jax, flat_port, hs71, iteration_mismatches, jax_states, mismatches, port_iterate,
)
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _both(A, c, lb, ub, **kw):
    """(JAX result, port result) of the same LP; ``x0``/``y0`` as numpy."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ref = jpdlp.solve(jnp.asarray(A), jnp.asarray(c), jnp.asarray(lb), jnp.asarray(ub), **jkw)
    out = pdlp.solve(*(torch.tensor(np.asarray(v)) for v in (A, c, lb, ub)), **tkw)
    return ref, out


def _check_same(ref, out, atol=1e-8):
    assert int(out.state) == int(ref.state)
    assert int(out.iterations) == int(ref.iterations)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=atol)
    np.testing.assert_allclose(out.duals.numpy(), np.asarray(ref.duals), atol=atol)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    assert out.status.dtype == torch.int8 and out.state.dtype == torch.int32


def _lp(A_rows, row_lb, row_ub, col_lb, col_ub, c):
    A, lb, ub, cc = _standard_form(A_rows, row_lb, row_ub, col_lb, col_ub, c)
    return A, cc, np.where(np.isfinite(lb), lb, -INF), np.where(np.isfinite(ub), ub, INF)


def _random_lp(seed):
    """tests/test_pdlp.py::test_pdlp_matches_simplex's LP."""
    rng = np.random.default_rng(seed)
    n, m = 6, 4
    A_rows = rng.standard_normal((m, n))
    col_lb = -rng.uniform(0.5, 2.0, n)
    col_ub = rng.uniform(0.5, 2.0, n)
    wide = np.abs(A_rows) @ np.maximum(np.abs(col_lb), np.abs(col_ub)) + 0.5
    c = rng.standard_normal(n)
    return A_rows, -wide, wide, col_lb, col_ub, c


def _box_lp(seed, n, m):
    """The LPs of test_pdlp_status_synthesis_matches_active_set (5, 8, 3)
    and test_pdlp_warm_start_converges_faster (8, 12, 6)."""
    rng = np.random.default_rng(seed)
    A_rows = rng.standard_normal((m, n))
    wide = np.abs(A_rows) @ np.ones(n) + 0.5
    c = rng.standard_normal(n)
    return A_rows, -wide, wide, -np.ones(n), np.ones(n), c, rng


def _cauchy_shaped(n=400, m=120):
    """test_pdlp_large_cauchy_shaped_lp's LP: J with appended +-I slack
    columns, as the Cauchy layer builds it."""
    rng = np.random.default_rng(13)
    J = rng.standard_normal((m, n)) / np.sqrt(n)
    g = rng.standard_normal(n)
    cons_val = rng.standard_normal(m) * 0.1
    radius, penalty = 0.5, 10.0
    eye = np.eye(m)
    A = np.hstack([J, eye, -eye, -eye])
    lb = np.concatenate([-radius * np.ones(n), np.zeros(2 * m), -cons_val - 0.2])
    ub = np.concatenate([radius * np.ones(n), INF * np.ones(2 * m), -cons_val + 0.2])
    c = np.concatenate([g, penalty * np.ones(2 * m), np.zeros(m)])
    return (A, c, lb, ub), (J, -cons_val - 0.2, -cons_val + 0.2, -radius * np.ones(n),
                            radius * np.ones(n), g)


@pytest.mark.parametrize("seed", range(4))
def test_pdlp_matches_simplex(seed):
    args = _random_lp(seed)
    ref, out = _both(*_lp(*args), tol=1e-9)
    _check_same(ref, out)
    simplex_ref = _solve_sleqp(*args)
    assert int(simplex_ref.state) == jsimplex.OPTIMAL
    assert int(out.state) == pdlp.OPTIMAL
    np.testing.assert_allclose(float(out.obj), float(simplex_ref.obj), atol=1e-6)
    n = args[0].shape[1]
    x = out.x[:n].numpy()
    assert np.all(x >= args[3] - 1e-7) and np.all(x <= args[4] + 1e-7)


def test_pdlp_status_synthesis_matches_active_set():
    """At a nondegenerate vertex the synthesized statuses agree with the
    simplex basis statuses on the structural columns."""
    A_rows, row_lb, row_ub, col_lb, col_ub, c, _ = _box_lp(5, 8, 3)
    ref, out = _both(*_lp(A_rows, row_lb, row_ub, col_lb, col_ub, c), tol=1e-10)
    _check_same(ref, out)
    assert int(out.state) == pdlp.OPTIMAL
    s_port = out.status[:8].numpy()
    s_ref = np.asarray(_solve_sleqp(A_rows, row_lb, row_ub, col_lb, col_ub, c).status[:8])
    at_bound = (s_ref == BaseStat.LOWER) | (s_ref == BaseStat.UPPER)
    assert at_bound.any()
    np.testing.assert_array_equal(s_port[at_bound], s_ref[at_bound])


def test_pdlp_warm_start_converges_faster():
    A_rows, row_lb, row_ub, col_lb, col_ub, c, rng = _box_lp(8, 12, 6)
    ref, cold = _both(*_lp(A_rows, row_lb, row_ub, col_lb, col_ub, c), tol=1e-9)
    _check_same(ref, cold)
    assert int(cold.state) == pdlp.OPTIMAL
    # perturb the objective slightly and restart from the solution
    c2 = c + 1e-4 * rng.standard_normal(12)
    ref_w, warm = _both(*_lp(A_rows, row_lb, row_ub, col_lb, col_ub, c2),
                        x0=cold.x.numpy(), y0=-cold.duals.numpy(), tol=1e-9)
    _check_same(ref_w, warm)
    assert int(warm.state) == pdlp.OPTIMAL
    assert int(warm.iterations) < int(cold.iterations)


def test_pdlp_large_cauchy_shaped_lp():
    """A penalty-LP-shaped instance at a size where the simplex pivot chain
    would dominate, against JAX and scipy HiGHS."""
    lp, scipy_args = _cauchy_shaped()
    ref, out = _both(*lp, tol=1e-7, max_iterations=60000)
    _check_same(ref, out)
    assert int(out.state) == pdlp.OPTIMAL
    hi = _solve_scipy(*scipy_args)
    # scipy's objective excludes the slack penalty; at a feasible optimum
    # the slacks vanish, so the objectives agree
    assert hi.status == 0
    np.testing.assert_allclose(float(out.obj), hi.fun, atol=5e-4)


@pytest.mark.parametrize("blocks", [1, 2, 7, 40])
def test_pdlp_state_after_fixed_blocks(blocks):
    """The iterate after ``blocks`` blocks of 64 PDHG iterations, each
    ended by a restart check, and after a block cut short by
    ``max_iterations``: equal to JAX's to 1e-10."""
    lp, _ = _cauchy_shaped(n=160, m=48)
    for cap in (64 * blocks, 64 * blocks + 17):
        ref, out = _both(*lp, tol=-1.0, max_iterations=cap)
        assert int(out.iterations) == int(ref.iterations) == cap
        assert int(out.state) == int(ref.state) == pdlp.ITERATION_LIMIT
        np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)
        np.testing.assert_allclose(out.duals.numpy(), np.asarray(ref.duals), rtol=0, atol=1e-10)
        np.testing.assert_allclose(out.reduced_costs.numpy(), np.asarray(ref.reduced_costs),
                                   rtol=0, atol=1e-10)


def test_pdlp_reads_the_host_once_a_block(monkeypatch):
    """One host read (``done``) per check, none inside a block."""
    reads = []
    real = torch.Tensor.__bool__

    def counted(self):
        reads.append(1)
        return real(self)

    lp, _ = _cauchy_shaped(n=40, m=12)
    args = [torch.tensor(v) for v in lp]
    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    out = pdlp.solve(*args, tol=-1.0, max_iterations=64 * 5 + 9)
    monkeypatch.undo()
    assert int(out.iterations) == 64 * 5 + 9
    assert len(reads) == 5


# ---- PDLP as the Cauchy LP backend ---------------------------------------------


def test_pdlp_cauchy_backend_matches_simplex():
    """solve_cauchy_lp(lp_solver=PDLP) reproduces the simplex backend's step
    and working set on HS71 exactly, and JAX's PDLP backend to 1e-8."""
    jp, tp, x0 = hs71()
    jit_ = create_iterate(jp, jnp.asarray(x0))
    it = port_iterate(jit_)
    radius = torch.tensor(0.5, dtype=torch.float64)
    penalty = torch.tensor(10.0, dtype=torch.float64)
    basis = tc.empty_basis(4, 2)
    ref = tc.solve_cauchy_lp(tp.data, it, radius, penalty, basis)
    res = tc.solve_cauchy_lp(tp.data, it, radius, penalty, basis, lp_solver=LPSolver.PDLP,
                             pdlp_tol=1e-10)
    assert int(res.lp_state) == pdlp.OPTIMAL
    np.testing.assert_allclose(res.lp_step.numpy(), ref.lp_step.numpy(), atol=1e-6)
    np.testing.assert_array_equal(res.var_states.numpy(), ref.var_states.numpy())
    np.testing.assert_array_equal(res.cons_states.numpy(), ref.cons_states.numpy())
    np.testing.assert_allclose(res.cons_dual.numpy(), ref.cons_dual.numpy(), atol=1e-6)
    # the saved basis passes through untouched
    assert res.basis is basis and not bool(res.basis.valid)

    jres = jc.solve_cauchy_lp(jp.data, jit_, jnp.asarray(0.5), jnp.asarray(10.0),
                              jc.empty_basis(4, 2), lp_solver=JaxLPSolver.PDLP, pdlp_tol=1e-10)
    bad = mismatches(flat_port(res), flat_jax(jres), 1e-8)
    assert not bad, bad


def test_pdlp_backend_full_solve():
    """End-to-end NLP solve with lp_solver=PDLP reaches the optimum, as
    JAX's does, iteration for iteration."""
    problem, x0, f_opt = port_hs.get_problem("hs35", "cpu")
    settings = Settings(lp_solver=LPSolver.PDLP, pdlp_tol=1e-10)
    solver = Solver(problem, x0, settings, device="cpu")
    status = solver.solve(max_iterations=100)
    assert status == Status.OPTIMAL
    assert abs(solver.obj_val - f_opt) <= 1e-5 * (1.0 + abs(f_opt))

    from sleqp_tpu.harness import hs as jax_hs

    jp, jx0, _ = jax_hs.get_problem("hs35")
    states = jax_states(jp, JaxSettings(lp_solver=JaxLPSolver.PDLP, pdlp_tol=1e-10),
                        np.array(jx0))
    assert int(states[-1].status) == Status.OPTIMAL
    assert solver.iterations == int(states[-1].iteration)
    np.testing.assert_allclose(solver.solution, np.asarray(states[-1].it.x), atol=1e-8)
    bad = iteration_mismatches(problem, settings, states)
    assert not bad, bad


def test_lp_solver_auto_threshold():
    """AUTO resolves by LP column count against pdlp_threshold, as JAX."""
    s = Settings(pdlp_threshold=100)
    assert tc.resolved_lp_solver(s, 10, 5) == LPSolver.SIMPLEX  # N = 25
    assert tc.resolved_lp_solver(s, 70, 10) == LPSolver.PDLP  # N = 100
    assert tc.resolved_lp_solver(s, 1000, 0) == LPSolver.SIMPLEX  # box-only
    s2 = Settings(lp_solver=LPSolver.SIMPLEX, pdlp_threshold=1)
    assert tc.resolved_lp_solver(s2, 1000, 1000) == LPSolver.SIMPLEX
    for n, m in ((10, 5), (70, 10), (1000, 0), (2100, 2099), (4096, 1366)):
        for kw in ({}, {"pdlp_threshold": 100}):
            assert int(tc.resolved_lp_solver(Settings(**kw), n, m)) == int(
                jc.resolved_lp_solver(JaxSettings(**kw), n, m))


def _gltr_projection_ratio(tp, settings, jax_state):
    """|P g| / |g| of the gradient GLTR receives in one port iteration from
    ``jax_state`` (P: the projection onto the working set's null space)."""
    import sleqp_tpu_torch.newton as tnewton
    from sleqp_tpu_torch import problem_solver as tps
    from sleqp_tpu_torch.ops.kkt import project_nullspace
    from torch_dense import port_state

    seen = []
    real = tnewton.gltr

    def watched(hess_prod, aug_jac, grad, radius, **kw):
        seen.append(float(torch.linalg.norm(project_nullspace(aug_jac, grad)))
                    / float(torch.linalg.norm(grad)))
        return real(hess_prod, aug_jac, grad, radius, **kw)

    tnewton.gltr = watched
    try:
        tps.perform_iteration(tp, settings, port_state(jax_state))
    finally:
        tnewton.gltr = real
    return seen[0]


# Fields that follow from the Newton step; a rounding tie of the step
# leaves every other field equal.
NEWTON_FIELDS = ("trust_radius", "num_failed_eqp", "last_model_reduction",
                 "last_exact_reduction", "last_reduction_ratio", "boundary_step", "min_rayleigh",
                 "max_rayleigh")


@pytest.mark.parametrize("mode", ["auto", "parametric"])
def test_pdlp_iterations_from_every_jax_iterate(mode, monkeypatch):
    """HS71 with AUTO routed to PDLP at pdlp_threshold = n + 3m (10), and
    with the COARSE parametric sweep over PDLP re-solves: one port
    iteration from each JAX iterate gives JAX's next state, and the whole
    solves reach the optimum in JAX's iteration count.

    One rounding tie, named: under AUTO, at JAX's iterate 4 the LP's
    working set (x0 and x1 at bounds, both constraints active) leaves no
    null space, so the projected gradient handed to GLTR is rounding noise
    (|P g| <= 1e-13 |g|, checked below) and GLTR scales it to the boundary of
    the reduced radius, a direction set by rounding in either package.
    The LP solve and every field before the Newton step agree
    (``test_pdlp_cauchy_backend_matches_simplex`` style, to 1e-9); the
    step, and the fields that follow from it, do not.  Both packages then
    reject the step and reach the same optimum."""
    jp, tp, x0 = hs71()
    if mode == "auto":
        js, ts = JaxSettings(pdlp_threshold=10), Settings(pdlp_threshold=10)
    else:
        js = JaxSettings(lp_solver=JaxLPSolver.PDLP, pdlp_tol=1e-10,
                         parametric_cauchy=JaxParametricCauchy.COARSE)
        ts = Settings(lp_solver=LPSolver.PDLP, pdlp_tol=1e-10,
                      parametric_cauchy=ParametricCauchy.COARSE)
    calls = []
    real = pdlp.solve

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(pdlp, "solve", counted)
    states = jax_states(jp, js, x0)
    assert int(states[-1].status) == Status.OPTIMAL
    bad = iteration_mismatches(tp, ts, states)
    assert len(calls) >= len(states) - 1
    ties = {4} if mode == "auto" else set()
    assert set(bad) == ties, bad
    for k in ties:
        assert set(bad[k]) - {f"measure.{f}" for f in (
            "step_norm", "obj_nonlin", "lag_nonlin", "obj_expected", "obj_actual",
            "vio_expected", "vio_actual")} <= set(NEWTON_FIELDS), bad[k]
        assert _gltr_projection_ratio(tp, ts, states[k]) <= 1e-13
    out = solve(tp, ts, x0, max_iterations=100, device="cpu")
    assert int(out.status) == Status.OPTIMAL
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(states[-1].it.x), atol=1e-6)
    if not ties:
        assert int(out.iteration) == int(states[-1].iteration)
