"""Port parity of the entry point: sleqp_tpu_torch.Solver (solver.py) and
the restoration phase (restoration.py) against the JAX package.

* the cases of tests/test_solver_class.py, with the Solver's status,
  solution, iterations and phase toggles held against JAX's Solver;
* tests/test_solver.py but ``test_multistart_escapes_hs33_basin`` (the
  batched multistart: tests/test_torch_batch_mp.py), held against
  JAX's whole solve (status, x to 1e-8, iterations);
* ``test_restoration_batched.py::test_solve_with_restoration_single``;
* the numerical-assert and float-flag cases of tests/test_num_asserts.py;
* the callbacks fire at JAX's events in JAX's order.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.problem_solver as jps
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.restoration import solve_with_restoration as jax_solve_with_restoration
from sleqp_tpu.solver import Solver as JaxSolver
from sleqp_tpu.solver import SolverEvent as JaxSolverEvent
from sleqp_tpu.types import HessEval as JaxHessEval
from sleqp_tpu.types import LPSolver as JaxLPSolver
from sleqp_tpu_torch import (
    Func, HessEval, LPSolver, MathError, Problem, Settings, Solver, SolverEvent, Status,
    initial_state, solve,
)
from sleqp_tpu_torch import problem_solver as tps
from sleqp_tpu_torch.restoration import (
    make_restoration_problem, restoration_initial_point, restoration_succeeded,
    solve_with_restoration,
)
from torch_dense import (
    hs6, hs35, hs64, hs71, iteration_mismatches, jax_states, linear, port_state, quadcons,
    quadfunc, rosenbrock, wachbieg,
)
from torch_parity import no_jax_cache_writes  # noqa: F401

HS71_OPT = [1.0, 4.742999, 3.821151, 1.379408]


def _solvers(make, settings=None, jax_settings=None, **kw):
    jp, tp, x0 = make()
    ref = JaxSolver(jp, jnp.asarray(x0), jax_settings, **kw)
    solver = Solver(tp, x0, settings, device="cpu", **kw)
    return ref, solver


def _check_wachbieg_solution(x, atol=1e-6):
    assert x[2] >= -1e-8
    np.testing.assert_allclose(x[0], x[2] + 0.5, atol=atol)
    np.testing.assert_allclose(x[1], x[0] ** 2 - 1.0, atol=atol)


# ---- the cases of tests/test_solver_class.py --------------------------------


def test_solver_basic():
    ref, solver = _solvers(hs71)
    assert solver.solve(max_iterations=100) == ref.solve(max_iterations=100) == Status.OPTIMAL
    np.testing.assert_allclose(solver.solution, HS71_OPT, atol=2e-5)
    np.testing.assert_allclose(solver.solution, ref.solution, atol=1e-8)
    assert solver.obj_val < 17.02
    feas, slack, stat = solver.residuals()
    assert feas <= 1e-6 and stat <= 1e-6 and slack <= 1e-6
    assert solver.iterations == ref.iterations > 0
    assert solver.state_real("penalty_parameter") == pytest.approx(
        ref.state_real("penalty_parameter"), rel=1e-12)
    for name in ("num_accepted", "num_rejected", "num_soc_accepted", "lp_iterations"):
        assert solver.state_int(name) == ref.state_int(name), name
    assert solver.state_int("num_accepted") > 0
    np.testing.assert_allclose(solver.cons_dual, ref.cons_dual, atol=1e-8)
    np.testing.assert_allclose(solver.vars_dual, ref.vars_dual, atol=1e-8)


def test_wachbieg_restoration():
    """The Wachter-Biegler pathology needs the restoration phase."""
    ref, solver = _solvers(wachbieg)
    status = solver.solve(max_iterations=200)
    assert status == ref.solve(max_iterations=200) == Status.OPTIMAL, (
        f"{status.name} toggles={solver.num_phase_toggles} x={solver.solution}")
    assert solver.num_phase_toggles == ref.num_phase_toggles >= 1
    _check_wachbieg_solution(solver.solution)
    np.testing.assert_allclose(solver.solution, ref.solution, atol=1e-8)
    assert solver.iterations == ref.iterations


def test_callbacks_and_abort():
    _, solver = _solvers(rosenbrock)
    seen = []

    def on_iter(s):
        seen.append(s.iterations)
        if len(seen) >= 3:
            s.abort()

    solver.add_callback(SolverEvent.PERFORMED_ITERATION, on_iter)
    assert solver.solve(max_iterations=100) == Status.ABORT_MANUAL
    assert seen == [1, 2, 3] and solver.iterations == 3


def test_callbacks_fire_at_jax_events():
    """The same events in the same order as JAX's Python-stepped loop,
    with the same iteration counts, FINISHED last."""
    ref, solver = _solvers(hs71)
    events = {"jax": [], "port": []}
    for key, s, ev in (("jax", ref, JaxSolverEvent), ("port", solver, SolverEvent)):
        for e in ev:
            s.add_callback(e, lambda x, e=e, key=key: events[key].append((int(e), x.iterations)))
    ref.solve(max_iterations=100)
    solver.solve(max_iterations=100)
    assert events["port"] == events["jax"]
    assert events["port"][-1][0] == SolverEvent.FINISHED
    assert any(e == SolverEvent.ACCEPTED_ITERATE for e, _ in events["port"])
    solver.remove_callback(SolverEvent.FINISHED, solver._callbacks[SolverEvent.FINISHED][0])


def test_finished_callback():
    _, solver = _solvers(rosenbrock)
    called = []
    solver.add_callback(SolverEvent.FINISHED, lambda s: called.append(True))
    solver.solve(max_iterations=100)
    assert called == [True]


def test_time_limit():
    _, solver = _solvers(rosenbrock)
    assert solver.solve(max_iterations=10000, time_limit=0.0) == Status.ABORT_TIME


def test_iteration_limit():
    ref, solver = _solvers(rosenbrock)
    assert solver.solve(max_iterations=3) == ref.solve(max_iterations=3) == Status.ABORT_ITER
    assert solver.iterations == 3
    np.testing.assert_allclose(solver.solution, ref.solution, atol=1e-9)


def test_polishing_zero_dual():
    """After polishing, active entries carry nonzero duals."""
    ref, solver = _solvers(hs71)
    solver.solve(max_iterations=100)
    ref.solve(max_iterations=100)
    it = solver.iterate
    vstates, vduals = it.var_states.numpy(), it.vars_dual.numpy()
    assert np.all(vduals[vstates != 0] != 0)
    np.testing.assert_array_equal(vstates, np.asarray(ref.iterate.var_states))
    np.testing.assert_array_equal(it.cons_states.numpy(), np.asarray(ref.iterate.cons_states))


def test_hs64_penalty_degenerate_stall_escape():
    """HS64 under the simplex stalls at a penalty-degenerate infeasible
    point; the solver detects the stall as local infeasibility, restores,
    and re-optimizes with an escalated penalty to the optimum.

    A named rounding tie (ROADMAP.md queue C): in the stall the model
    reduction is exactly 0 and the trial point's merit equals the
    iterate's to one ulp, so which side of 0 the exact reduction falls
    decides acceptance.  From JAX's iterate 16 the port computes one ulp
    of reduction where JAX computes 0, rejects where JAX accepts, and
    leaves the stall sooner: 32 iterations against JAX's 41, with the same
    phase toggles, status and solution.  Every iteration before the tie
    matches JAX's to 1e-9."""
    f_opt = 6299.842428
    jp, tp, x0 = hs64()
    js, ts = JaxSettings(lp_solver=JaxLPSolver.SIMPLEX), Settings(lp_solver=LPSolver.SIMPLEX)
    ref = JaxSolver(jp, jnp.asarray(x0), js)
    solver = Solver(tp, x0, ts, device="cpu")
    assert solver.solve(max_iterations=500) == ref.solve(max_iterations=500) == Status.OPTIMAL
    assert solver.num_phase_toggles == ref.num_phase_toggles >= 1
    np.testing.assert_allclose(solver.obj_val, f_opt, rtol=1e-5)
    np.testing.assert_allclose(solver.solution, ref.solution, rtol=1e-8)
    assert solver.iterations <= ref.iterations
    feas, slack, stat = solver.residuals()
    assert feas <= 1e-6 and stat <= 1e-6

    states = jax_states(jp, js, x0, limit=200)
    first = min(iteration_mismatches(tp, ts, states))
    after = tps.perform_iteration(tp, ts, port_state(states[first]))
    ref_after = states[first + 1]
    ulp = np.spacing(abs(float(ref_after.it.obj_val)) + float(ref_after.penalty)
                     * float(ref_after.feas_res))
    assert float(after.last_model_reduction) == float(ref_after.last_model_reduction) == 0.0
    assert abs(float(after.last_exact_reduction) - float(ref_after.last_exact_reduction)) <= ulp

    # enumeration (AUTO) solves it directly
    ref2, solver2 = _solvers(hs64)
    assert solver2.solve(max_iterations=500) == ref2.solve(max_iterations=500) == Status.OPTIMAL
    np.testing.assert_allclose(solver2.obj_val, f_opt, rtol=1e-5)
    assert solver2.num_phase_toggles == ref2.num_phase_toggles == 0
    assert solver2.iterations == ref2.iterations


def test_state_vec_queries():
    """The residual vectors at the solution agree with the scalar residua
    and with JAX's vectors."""
    ref, solver = _solvers(hs71)
    assert solver.solve(max_iterations=100) == Status.OPTIMAL
    ref.solve(max_iterations=100)
    feas, slack, stat = solver.residuals()
    stat_vec = solver.state_vec("stat_residuals")
    assert stat_vec.shape == (4,)
    np.testing.assert_allclose(np.max(np.abs(stat_vec)), stat, atol=1e-12)
    feas_vec = solver.state_vec("feas_residuals")
    assert feas_vec.shape == (2,)
    np.testing.assert_allclose(np.max(np.abs(feas_vec)), feas, atol=1e-12)
    cs = solver.state_vec("cons_slack_residuals")
    vs = solver.state_vec("var_slack_residuals")
    np.testing.assert_allclose(max(np.max(np.abs(cs)), np.max(np.abs(vs))), slack, atol=1e-12)
    for name in ("stat_residuals", "feas_residuals", "cons_slack_residuals",
                 "var_slack_residuals"):
        np.testing.assert_allclose(solver.state_vec(name), ref.state_vec(name), atol=1e-9)
    for name in ("trust_radius", "lp_trust_radius", "stat_res", "min_rayleigh", "step_norm"):
        assert solver.state_real(name) == pytest.approx(ref.state_real(name), rel=1e-8, abs=1e-12)
    with pytest.raises(KeyError):
        solver.state_vec("nope")


# ---- tests/test_solver.py ---------------------------------------------------

SOLVES = {"quadfunc": (quadfunc, [0.0, 0.0], 1e-6), "rosenbrock": (rosenbrock, [1.0, 1.0], 1e-6),
          "linear": (linear, [0.0, 1.0], 1e-6), "quadcons": (quadcons, [0.0, 0.0], 1e-6),
          "hs6": (hs6, [1.0, 1.0], 1e-6), "hs35": (hs35, [4.0 / 3.0, 7.0 / 9.0, 4.0 / 9.0], 1e-6),
          "hs71": (hs71, HS71_OPT, 2e-5)}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_matches_jax(name):
    make, x_opt, tol = SOLVES[name]
    jp, tp, x0 = make()
    ref = jps.solve(jp, JaxSettings(), jnp.asarray(x0), max_iterations=100)
    out = solve(tp, Settings(), x0, max_iterations=100, device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    np.testing.assert_allclose(out.it.x.numpy(), x_opt, atol=tol)
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=1e-8)
    assert int(out.iteration) == int(ref.iteration)
    if name == "hs71":
        assert (float(out.feas_res) <= 1e-6 and float(out.stat_res) <= 1e-6
                and float(out.slack_res) <= 1e-6)


def test_residuals_reported():
    _, tp, x0 = rosenbrock()
    state = solve(tp, Settings(), x0, max_iterations=100, device="cpu")
    assert float(state.stat_res) < 1e-6
    assert int(state.num_accepted) > 0


# ---- restoration -------------------------------------------------------------


def test_solve_with_restoration_single():
    """One instance, restoration branch included."""
    jp, tp, x0 = wachbieg()
    settings = Settings()
    ref = jax_solve_with_restoration(jp, JaxSettings(),
                                     jps.initial_state(jp, JaxSettings(), jnp.asarray(x0)), 200)
    out = solve_with_restoration(tp, settings, initial_state(tp, settings, x0, device="cpu"), 200)
    assert int(out.status) == int(ref.status) == Status.OPTIMAL, Status(int(out.status)).name
    _check_wachbieg_solution(out.it.x.numpy())
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=1e-8)
    assert int(out.iteration) == int(ref.iteration)


def test_restoration_problem_matches_jax():
    """The (x, s) LSQ problem and the phase transform."""
    from sleqp_tpu.restoration import make_restoration_problem as jax_make
    from sleqp_tpu.restoration import restoration_initial_point as jax_initial

    jp, tp, x0 = wachbieg()
    jr, tr = jax_make(jp), make_restoration_problem(tp)
    z = restoration_initial_point(tp, torch.as_tensor(x0))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jax_initial(jp, jnp.asarray(x0))))
    for name in ("var_lb", "var_ub"):
        np.testing.assert_array_equal(getattr(tr.data, name).numpy(),
                                      np.asarray(getattr(jr.data, name)))
    d = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64)
    for got, want in ((tr.obj_val(z), jr.obj_val(jnp.asarray(z.numpy()))),
                      (tr.obj_grad(z), jr.obj_grad(jnp.asarray(z.numpy()))),
                      (tr.hess_prod(z, d, torch.zeros(0, dtype=torch.float64)),
                       jr.hess_prod(jnp.asarray(z.numpy()), jnp.asarray(d.numpy()), jnp.zeros(0)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)
    assert restoration_succeeded(Status.UNBOUNDED) and not restoration_succeeded(Status.INFEASIBLE)


# ---- the cases of tests/test_num_asserts.py ----------------------------------


def test_num_asserts_clean_constrained():
    _, tp, x0 = hs71()
    state = solve(tp, Settings(num_asserts=True), x0, max_iterations=100, device="cpu")
    assert int(state.status) == Status.OPTIMAL
    assert int(state.num_assert_fail) == 0
    np.testing.assert_allclose(state.it.x.numpy(), HS71_OPT, atol=1e-5)


def test_num_asserts_clean_quasi_newton():
    jp, tp, x0 = rosenbrock()
    ref = jps.solve(jp, JaxSettings(num_asserts=True, hess_eval=JaxHessEval.DAMPED_BFGS),
                    jnp.asarray(x0), max_iterations=300)
    state = solve(tp, Settings(num_asserts=True, hess_eval=HessEval.DAMPED_BFGS), x0,
                  max_iterations=300, device="cpu")
    assert int(state.status) == int(ref.status) == Status.OPTIMAL
    assert int(state.num_assert_fail) == int(ref.num_assert_fail) == 0


def test_num_asserts_detect_nonfinite():
    """A gradient that is non-finite at the start poisons the duals; the
    finiteness invariant fires and the solver raises."""
    problem = Problem(Func(lambda x: torch.sqrt(x[0]) + x[1] ** 2, 2), var_lb=[0.0, -5.0],
                      var_ub=[5.0, 5.0], device="cpu")
    solver = Solver(problem, np.array([0.0, 1.0]), Settings(num_asserts=True), device="cpu")
    with pytest.raises(MathError) as exc:
        solver.solve(max_iterations=10)
    assert exc.value.bitmask & 4


def _overflowing():
    return Problem(Func(lambda x: torch.exp(x[0] * 500.0) + x @ x, 2), var_lb=-10.0,
                   var_ub=10.0, device="cpu")


def test_float_flags_error_on_nonfinite():
    solver = Solver(_overflowing(), np.array([4.0, 1.0]), Settings(float_error_flags="nonfinite"),
                    device="cpu")
    with pytest.raises(MathError):
        solver.solve(max_iterations=10)


def test_float_flags_warning_default(caplog):
    solver = Solver(_overflowing(), np.array([4.0, 1.0]), Settings(), device="cpu")
    with caplog.at_level(logging.WARNING, logger="sleqp_tpu_torch"):
        solver.solve(max_iterations=10)
    assert any("non-finite" in r.message for r in caplog.records)
    # with both flags off nothing is read or logged
    caplog.clear()
    quiet = Solver(_overflowing(), np.array([4.0, 1.0]), Settings(float_warning_flags="none"),
                   device="cpu")
    with caplog.at_level(logging.WARNING, logger="sleqp_tpu_torch"):
        quiet.solve(max_iterations=10)
    assert not any("non-finite" in r.message for r in caplog.records)


def test_log_table_and_banner(caplog):
    _, solver = _solvers(hs71)
    with caplog.at_level(logging.INFO, logger="sleqp_tpu_torch"):
        solver.solve(max_iterations=100)
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "iter" in text and "Status        : OPTIMAL" in text and "LP pivots" in text
