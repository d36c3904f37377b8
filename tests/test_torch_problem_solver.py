"""Port parity, whole solves: sleqp_tpu_torch.solve against the JAX
package's problem_solver.solve on four problems, each on the float64
route and on the mixed route (Settings(compute_dtype="float32")).

* HS71: its Cauchy LP is solved by enumeration, its Newton step by GLTR;
* chainineq (n = 20): the simplex and GLTR;
* chainqp (n = 20, linear constraints): the simplex and CG;
* boxqp (n = 50, no constraints): the box Cauchy step and CG.

The bar: the same status, x to 1e-8 in float64 and 1e-6 on the mixed
route.  The iteration counts are equal, except where the two packages
round a tie differently (ROADMAP.md queue C): on chainineq the port takes
11 iterations against JAX's 12, on boxqp 4 against 6, each an exact tie
of the reference's own arithmetic that the order of a sum decides; there
the counts are at most 3 apart, as on the mixed route.

Also here: the branches that are not ported (PDLP, dynamic functions)
raise NotImplementedError naming their ROADMAP.md item, the iteration limit, the settings reader,
and the round trip of a JAX solver state through the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.problem_solver as jps
import sleqp_tpu.settings as jst
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu_torch import Settings, SolverState, Status, initial_state, perform_iteration, solve
from sleqp_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from sleqp_tpu_torch.settings import read_settings_file, read_settings_string
from sleqp_tpu_torch.types import LPSolver, StepRule, TRSolver
from torch_dense import boxqp, chainineq, chainqp, flat_jax, hs71, jax_to_numpy, mismatches
from torch_parity import no_jax_cache_writes  # noqa: F401

PAIRS = {"hs71": hs71, "chainineq20": lambda: chainineq(20), "chainqp20": lambda: chainqp(20),
         "boxqp50": lambda: boxqp(50)}
# float64 iteration counts that an order-of-summation tie moves (queue C)
ROUNDING_TIES = {"chainineq20", "boxqp50"}


@pytest.mark.parametrize("route", ["same", "float32"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_solve_matches_jax(name, route):
    jp, tp, x0 = PAIRS[name]()
    ref = jps.solve(jp, JaxSettings(compute_dtype=route), jnp.asarray(x0))
    out = solve(tp, Settings(compute_dtype=route), x0, device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    tol = 1e-8 if route == "same" else 1e-6
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=tol)
    np.testing.assert_allclose(float(out.it.obj_val), float(ref.it.obj_val), rtol=tol, atol=tol)
    for res in ("feas_res", "slack_res", "stat_res"):
        assert float(getattr(out, res)) <= 1e-6
    gap = abs(int(out.iteration) - int(ref.iteration))
    if route == "same" and name not in ROUNDING_TIES:
        assert gap == 0, (int(out.iteration), int(ref.iteration))
    else:
        assert gap <= 3, (int(out.iteration), int(ref.iteration))
    assert out.iteration.dtype == torch.int32 and out.status.dtype == torch.int32
    # which solvers ran: enumeration takes one "pivot" per LP, the box
    # step none; the rest pivot
    if name == "boxqp50":
        assert int(out.lp_iterations) == 0


def test_iteration_limit_gives_abort_iter():
    jp, tp, x0 = hs71()
    ref = jps.solve(jp, JaxSettings(), jnp.asarray(x0), max_iterations=2)
    out = solve(tp, Settings(), x0, max_iterations=2, device="cpu")
    assert int(out.status) == int(ref.status) == Status.ABORT_ITER
    assert int(out.iteration) == int(ref.iteration) == 2
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=1e-9)


NOT_PORTED = {
    "pdlp": (dict(lp_solver=LPSolver.PDLP), "item 6"),
    "pdlp_by_auto": (dict(pdlp_threshold=10), "item 6"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_branches_not_ported_raise(case):
    kw, item = NOT_PORTED[case]
    _, tp, x0 = hs71()
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue A {item}"):
        solve(tp, Settings(**kw), x0, device="cpu")
    state = initial_state(tp, Settings(), x0, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue A {item}"):
        perform_iteration(tp, Settings(**kw), state)


def test_dynamic_function_not_ported():
    _, tp, x0 = hs71()

    class Dynamic(type(tp.func)):
        def eval_all_dyn(self, x, error_bound, penalty):
            raise AssertionError("not reached")

    tp.func.__class__ = Dynamic
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 8e"):
        solve(tp, Settings(), x0, device="cpu")


def test_enums_and_constants_match_jax():
    """Every enum of the reference's types.py with the same members and
    integer values, the LP infinities, and MathError's messages."""
    import enum

    import sleqp_tpu.types as jt
    import sleqp_tpu_torch.types as tt

    names = [n for n, v in vars(jt).items() if isinstance(v, type) and issubclass(v, enum.IntEnum)]
    assert len(names) == 17
    for name in names:
        assert {m.name: int(m) for m in getattr(tt, name)} == {
            m.name: int(m) for m in getattr(jt, name)}, name
    assert (tt.INF, tt.INF_THRESHOLD) == (jt.INF, jt.INF_THRESHOLD)
    for arg in (5, 2, "overflow"):
        assert str(tt.MathError(arg)) == str(jt.MathError(arg))
        assert tt.MathError(arg).bitmask == jt.MathError(arg).bitmask


SETTINGS_TEXT = """
# every kind of field
eps = 1e-9            ; a float
perform_soc = off
lp_resolves = TRUE
hess_eval = sr1
tr_solver = 2
step_rule = window
max_newton_iterations = 50
compute_dtype = float32
float_error_flags = nonfinite
"""


def test_read_settings_string_matches_jax(tmp_path):
    got = read_settings_string(SETTINGS_TEXT)
    ref = jst.read_settings_string(SETTINGS_TEXT)
    import dataclasses

    names = [f.name for f in dataclasses.fields(Settings)]
    assert names == [f.name for f in dataclasses.fields(JaxSettings)]
    for name in names:
        a, b = getattr(got, name), getattr(ref, name)
        assert a == b and type(a).__name__ == type(b).__name__, name
    assert got.tr_solver == TRSolver.GLTR and got.step_rule == StepRule.WINDOW
    path = tmp_path / "settings.txt"
    path.write_text(SETTINGS_TEXT)
    assert read_settings_file(str(path)) == got
    for bad in ("nokey = 1", "eps 1", "perform_soc = maybe", "hess_eval = lots"):
        with pytest.raises(ValueError):
            read_settings_string(bad)
    with pytest.raises(ValueError, match="compute_dtype"):
        Settings(compute_dtype="fp32")
    assert Settings() == Settings(eps=1e-10, linesearch_tau=0.5, linesearch_eta=1e-4,
                                  feas_tol=1e-6, stat_tol=1e-6, compute_dtype="same")


@pytest.mark.parametrize("route", ["same", "float32"])
def test_solver_state_round_trip_is_exact(route):
    """JAX SolverState -> numpy -> port -> numpy gives every field back
    unchanged (dtype, shape and value)."""
    jp, _, x0 = hs71()
    settings = JaxSettings(compute_dtype=route, step_rule=jst.StepRule.WINDOW)
    state = jps.initial_state(jp, settings, jnp.asarray(x0))
    state = jax.jit(lambda s: jps.perform_iteration(jp, settings, s))(state)
    arrays = jax_to_numpy(state)
    port = tree_from_numpy(SolverState, arrays, device="cpu")
    back = tree_from_numpy(SolverState, tree_to_numpy(port), device="cpu")
    ref = flat_jax(arrays)
    assert not mismatches({k: np.asarray(v) for k, v in flat_jax(tree_to_numpy(back)).items()},
                          ref, 0.0)
    for key, value in flat_jax(tree_to_numpy(port)).items():
        assert value.dtype == ref[key].dtype and np.array_equal(value, ref[key], equal_nan=True), key
