"""Port parity: ``solve_jit``, the dense SLP-EQP solve as device programs
(sleqp_tpu_torch/problem_solver.py against sleqp_tpu/problem_solver.py:906-930).

On the CPU ``solve_jit`` runs the read-free programs of its CUDA graphs
eagerly, with a host read before the first iteration and after each
program that ends a block of simplex pivots, Krylov steps, linesearch
trials or PDHG iterations, a branch that guards an LP solve (the warm
basis's dual stage, the float64 polish's primal pass, the reduced
re-solve, the penalty update, a parametric sweep trip) or the iteration.
It must equal ``solve_from`` (the eager loop that reads as it goes) bit
for bit on every field, with no more host reads, on every route of the
dense iteration, each on the float64 and the mixed route: the LP by
enumeration, the simplex (its dual stage, reduced re-solve, float64
polish, refactorizing pivot blocks) and PDLP; GLTR, Steihaug CG and LSQR
(an ``LSQFunc``); quasi-Newton Hessians, the parametric sweep, dynamic
functions, the EXACT linesearch, the linear model and no Newton step.
Against the JAX package's ``solve_jit`` it is held as
tests/test_torch_problem_solver.py holds ``solve``.  The card's path
(capture, replay, the lazy captures, the cache) runs on emulated graphs.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sleqp_tpu.problem_solver as jps
import sleqp_tpu_torch
import torch_dense as td
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu_torch import Settings, Solver, SolverEvent, Status, cauchy, graphs
from sleqp_tpu_torch import problem_solver as ps
from sleqp_tpu_torch import restoration
from sleqp_tpu_torch.types import (
    DualEstimationType, HessEval, Linesearch, LPSolver, ParametricCauchy, TRSolver,
)
from test_torch_batch import HostReads
from torch_graphs import ReadsForbidden, emulated_graphs  # noqa: F401
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROUTES = {"float64": "same", "mixed": "float32"}


def dyn(name):
    def make():
        problem, x0, _, _ = chip_smoke.dyn_problems("cpu")[name]
        return None, problem, x0

    return make


# name: (the pair's maker, Settings keywords, the iteration cap)
CASES = {
    "hs71": (td.hs71, {}, 200),  # ENUM LPs, GLTR, an exhausted linesearch
    "hs71_simplex": (td.hs71, dict(lp_solver=LPSolver.SIMPLEX), 200),  # the dual stage
    "chainineq20": (lambda: td.chainineq(20), {}, 200),  # dual stage, reduced re-solve
    "boxqp50": (lambda: td.boxqp(50), {}, 200),  # the box Cauchy step
    # LPs past 64 pivots: refactorizing blocks; a penalty increase
    "projqp": (lambda: td.projqp(100, 50), {}, 200),
    "hs62": (td.hs62, {}, 200),  # nine penalty increases
    "hs35_pdlp": (td.hs35, dict(lp_solver=LPSolver.PDLP), 200),
    "hs71_cg": (td.hs71, dict(tr_solver=TRSolver.CG), 200),
    "hs71_damped_bfgs": (td.hs71, dict(hess_eval=HessEval.DAMPED_BFGS), 200),
    "hs71_sr1": (td.hs71, dict(hess_eval=HessEval.SR1), 200),
    "chainineq20_coarse": (lambda: td.chainineq(20),
                           dict(parametric_cauchy=ParametricCauchy.COARSE), 200),
    "chainineq20_fine": (lambda: td.chainineq(20),
                         dict(parametric_cauchy=ParametricCauchy.FINE), 200),
    "broydn20": (lambda: td.broydn(20), {}, 200),  # LSQFunc: Gauss-Newton + LSQR
    "dyn_rosenbrock": (dyn("rosenbrock"), {}, 200),
    "dyn_constrained": (dyn("constrained"), {}, 200),
    "hs71_exact": (td.hs71, dict(linesearch=Linesearch.EXACT), 200),
    "hs71_linear_model": (td.hs71, dict(use_quadratic_model=False), 20),
    "hs71_no_newton": (td.hs71, dict(perform_newton_step=False), 200),
    "hs71_asserts_lp_duals": (td.hs71, dict(num_asserts=True,
                                            dual_estimation_type=DualEstimationType.MIXED), 200),
}


def settings_of(name, route):
    return Settings(compute_dtype=ROUTES[route], **CASES[name][1])


def start(name, route):
    """(port problem, settings, initial state, cap): a fresh problem with
    no programs cached on it."""
    make, _, cap = CASES[name]
    _, tp, x0 = make()
    settings = settings_of(name, route)
    return tp, settings, ps.initial_state(tp, settings, x0, device="cpu"), cap


def parts(a, b):
    """The fields whose bits differ between two states."""
    fa, fb = chip_smoke.flat_fields(a), chip_smoke.flat_fields(b)
    assert fa.keys() == fb.keys()
    return [k for k in fa if not (fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
                                  and fa[k].tobytes() == fb[k].tobytes())]


def solve_both(tp, settings, s0, cap):
    """(graph state, eager state, graph reads, eager reads, programs)."""
    with HostReads() as eager_reads:
        want = ps.solve_from(tp, settings, s0, cap)
    with HostReads() as graph_reads:
        got = ps.solve_jit(tp, settings, s0, cap)
    return got, want, graph_reads.count, eager_reads.count, ps.solve_graphs(tp, settings, s0, cap)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_equals_eager_loop(name, route):
    """Every field bit for bit, no more host reads than the eager loop,
    each of them a flag of the programs."""
    tp, settings, s0, cap = start(name, route)
    got, want, reads, eager_reads, loop = solve_both(tp, settings, s0, cap)
    assert parts(got, want) == []
    assert int(got.status) != Status.RUNNING
    assert reads == loop.reads <= eager_reads


# the JAX package's solve_jit from the same start; the float64 iteration
# counts that an order-of-summation tie moves (ROADMAP.md queue C): chainineq
# (n = 20) 11 against JAX's 12, boxqp (n = 50) 4 against 6
JAX_CASES = [("hs71", "float64"), ("hs71", "mixed"), ("chainineq20", "float64"),
             ("boxqp50", "float64")]
ROUNDING_TIES = {"chainineq20", "boxqp50"}


@pytest.mark.parametrize("name,route", JAX_CASES)
def test_matches_jax_solve_jit(name, route):
    """The status, x (1e-8 float64, 1e-6 mixed), objective and residuals of
    JAX's solve_jit; the same iterations but at the named ties."""
    make, _, cap = CASES[name]
    jp, tp, x0 = make()
    js = JaxSettings(compute_dtype=ROUTES[route])
    ref = jps.solve_jit(jp, js, jps.initial_state(jp, js, jnp.asarray(x0)), cap)
    settings = settings_of(name, route)
    out = ps.solve_jit(tp, settings, ps.initial_state(tp, settings, x0, device="cpu"), cap)
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    tol = 1e-8 if route == "float64" else 1e-6
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=tol)
    np.testing.assert_allclose(float(out.it.obj_val), float(ref.it.obj_val), rtol=tol, atol=tol)
    for res in ("feas_res", "slack_res", "stat_res"):
        assert float(getattr(out, res)) <= 1e-6
    gap = abs(int(out.iteration) - int(ref.iteration))
    assert gap == 0 or ((route == "mixed" or name in ROUNDING_TIES) and gap <= 3), gap


@pytest.mark.parametrize("name", ["hs71", "chainineq20"])
def test_iteration_limits_and_stopped_start(name):
    """ABORT_ITER at max_iterations = 2 and 0, as the eager loop ends them;
    a start that has stopped takes no iteration and one read."""
    tp, settings, s0, cap = start(name, "float64")
    for max_iterations in (2, 0):
        want = ps.solve_from(tp, settings, s0, max_iterations)
        got = ps.solve_jit(tp, settings, s0, max_iterations)
        assert parts(got, want) == []
        assert int(got.status) == Status.ABORT_ITER and int(got.iteration) == max_iterations
    done = ps.solve_from(tp, settings, s0, cap)
    assert int(done.status) == Status.OPTIMAL
    with HostReads() as reads:
        again = ps.solve_jit(tp, settings, done, cap)
    assert parts(again, done) == [] and reads.count == 1


def test_penalty_increases_and_exhausted_linesearch():
    """hs62 raises its penalty in increases of LP re-solves (``pen.inc``,
    ``pen.trip``), HS71's trial linesearch vanishes twice (failed EQP
    steps, alpha = 0), its Cauchy and trial linesearches outlast the
    trials inside their programs: the eager loop's bits."""
    tp, settings, s0, cap = start("hs62", "float64")
    got, want, _, _, loop = solve_both(tp, settings, s0, cap)
    assert parts(got, want) == []
    assert loop.replays["pen.trip"] > loop.replays["pen.end"] > 0
    tp, settings, s0, cap = start("hs71", "float64")
    got, want, _, _, loop = solve_both(tp, settings, s0, cap)
    assert parts(got, want) == [] and int(got.num_failed_eqp) == 2
    assert loop.replays["tl.block"] > 0 and loop.replays["cl.block"] > 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pivot_blocks_refactorize_as_the_loop(route):
    """projqp's LPs pivot past the 64th pivot, where the simplex
    refactorizes: the refactorizing block programs run and the pivots
    (282 in three iterations) and bits are the eager loop's."""
    tp, settings, s0, cap = start("projqp", route)
    got, want, _, _, loop = solve_both(tp, settings, s0, cap)
    assert parts(got, want) == []
    assert loop.replays["lp.primal.refactor"] > 0 and loop.replays["lp.dual.refactor"] > 0
    assert int(got.lp_iterations) == int(want.lp_iterations) == 282


def test_one_step_blocks_run_every_block_program(monkeypatch):
    """With blocks of one pivot, one Krylov step and one GLTR step, every
    block program runs (GLTR's from its second step, LSQR's, the polish's
    and the reduced LP's), still bit for bit."""
    monkeypatch.setattr(cauchy, "PIVOT_BLOCK", 1)
    monkeypatch.setattr(ps, "GLTR_BLOCK", 1)
    monkeypatch.setattr(ps, "KRYLOV_BLOCK", 1)
    runs = [("chainineq20", "mixed", "red.primal64"), ("broydn20", "float64", "kr.lsqr"),
            ("hs71_cg", "mixed", "kr.cg")]
    _, extrosnb, x0 = td.extrosnb(30)
    settings = Settings(compute_dtype="float32")
    s0 = ps.initial_state(extrosnb, settings, x0, device="cpu")
    got, want, reads, eager_reads, loop = solve_both(extrosnb, settings, s0, 12)
    assert parts(got, want) == [] and reads <= eager_reads
    assert loop.replays["kr.gltr.1"] > 0
    for name, route, program in runs:
        tp, settings, s0, cap = start(name, route)
        got, want, reads, eager_reads, loop = solve_both(tp, settings, s0, cap)
        assert parts(got, want) == [] and reads <= eager_reads, name
        assert loop.replays[program] > 0, (name, program)


# the programs a solve captures, in the order it first runs them
CAPTURED = {
    "hs71": ["it.head", "pen.check", "pen.feas", "pen.keep", "it.mid", "cl.end", "it.newton",
             "it.trial", "it.tail", "tl.block", "cl.block"],
    "broydn20": ["it.head", "it.mid", "cl.end", "it.newton", "it.trial", "it.tail", "kr.lsqr",
                 "cl.block"],
    "hs35_pdlp": ["it.head", "lp.pdlp.block", "lp.pdlp.end", "pen.check", "it.mid", "cl.end",
                  "it.newton", "it.trial", "it.tail"],
    "chainineq20_coarse": [
        "it.head", "lp.primal.start", "lp.primal", "lp.primal.end", "lp.needs", "lp.extract",
        "pen.check", "it.mid", "par.lp.fwd", "par.fwd", "par.end", "it.newton", "it.trial",
        "it.tail", "par.lp.back", "par.back", "tl.block", "lp.dual.start", "lp.dual",
        "lp.dual.end", "red.start", "red.primal", "red.primal.end", "lp.extract.red"],
}


@pytest.mark.parametrize("name", sorted(CAPTURED))
def test_graph_bookkeeping_on_emulated_graphs(emulated_graphs, name):
    """Every program captured read-free when a solve first runs it, cached
    on the problem for the next solve (no new capture); the reads counted
    by the programs; the state the eager loop's, bit for bit."""
    tp, settings, s0, cap = start(name, "float64")
    want = ps.solve_from(tp, settings, s0, cap)
    counted = 0
    for _ in range(2):  # the second solve replays the cached graphs
        with HostReads() as reads:
            got = ps.solve_jit(tp, settings, s0, cap)
        assert parts(got, want) == []
        loop = ps.solve_graphs(tp, settings, s0, cap)
        assert loop.cuda and len(tp._solve_graphs) == 1
        assert emulated_graphs == CAPTURED[name]
        counted += reads.count
        assert counted == loop.reads


def test_programs_read_nothing(monkeypatch):
    """On the CPU too, no program reads the host: every read of the solve
    is the host's read of a program's flag."""
    tp, settings, s0, cap = start("chainineq20_coarse", "mixed")
    real = graphs.Programs.replay

    def replay(self, name):
        with ReadsForbidden(pytest.MonkeyPatch()):
            real(self, name)

    monkeypatch.setattr(graphs.Programs, "replay", replay)
    got = ps.solve_jit(tp, settings, s0, cap)
    assert parts(got, ps.solve_from(tp, settings, s0, cap)) == []


def test_capture_of_a_reading_callable_raises(emulated_graphs):
    """A callable that reads the card makes the capture raise, naming the
    problem's callables; nothing falls back to the eager loop."""
    tp, settings, s0, cap = start("hs71", "float64")
    scale = torch.tensor(1.0, dtype=torch.float64)
    inner = tp.func._obj

    def reading_obj(x):
        return float(scale) * inner(x)

    tp.func._obj = reading_obj
    # the first program that evaluates the objective is the iteration's end
    with pytest.raises(RuntimeError, match="obj=.*reading_obj.*cons=.*capturing 'it.tail'"):
        ps.solve_jit(tp, settings, s0, cap)
    assert "it.tail" not in emulated_graphs and emulated_graphs[0] == "it.head"


class Calls:
    """Counts the calls of ``solve_jit`` and of ``Solver._iterate``."""

    def __init__(self, monkeypatch):
        self.jit, self.eager = [], []
        real_jit, real_iterate = ps.solve_jit, Solver._iterate
        monkeypatch.setattr(sleqp_tpu_torch.solver, "solve_jit",
                            lambda *a: self.jit.append(a[3]) or real_jit(*a))
        monkeypatch.setattr(sleqp_tpu_torch.restoration, "solve_jit",
                            lambda *a: self.jit.append(a[3]) or real_jit(*a))
        monkeypatch.setattr(Solver, "_iterate",
                            lambda s, *a: self.eager.append(a[1]) or real_iterate(s, *a))


@pytest.mark.parametrize("loop", ["default", "callback", "time_limit", "info_logging"])
def test_solver_takes_solve_jit_unless_the_python_loop_is_asked(monkeypatch, caplog, loop):
    """The reference's rule (sleqp_tpu/solver.py:176-181): the stepped loop
    for a callback other than FINISHED, a time limit or INFO logging, the
    fused loop otherwise; the same solve either way."""
    calls = Calls(monkeypatch)
    _, tp, x0 = td.hs71()
    solver = Solver(tp, x0, Settings(), device="cpu")
    seen = []
    solver.add_callback(SolverEvent.FINISHED, lambda s: seen.append("finished"))
    time_limit = None
    if loop == "callback":
        solver.add_callback(SolverEvent.ACCEPTED_ITERATE, lambda s: seen.append("accepted"))
    elif loop == "time_limit":
        time_limit = 1e6
    elif loop == "info_logging":
        caplog.set_level(logging.INFO, logger="sleqp_tpu_torch")
    status = solver.solve(max_iterations=100, time_limit=time_limit)
    assert status == Status.OPTIMAL and solver.iterations == 6 and seen[-1] == "finished"
    if loop == "default":
        assert calls.jit == [100] and calls.eager == []
    else:
        assert calls.jit == [] and calls.eager == [100]
    ref = Solver(td.hs71()[1], x0, Settings(), device="cpu")
    ref._iterate(ps.initial_state(ref.problem, ref.settings, ref.x0, device="cpu"), 100, None,
                 0.0)
    np.testing.assert_array_equal(solver.solution, ref.solution)


def test_host_callables_take_the_stepped_loop(monkeypatch):
    """minimize's numpy functions run on the host, which no CUDA graph can
    call: their Func says so (``runs_on_host``) and Solver steps its eager
    loop; torch functions take solve_jit."""
    from sleqp_tpu_torch.minimize import minimize

    calls = Calls(monkeypatch)

    def rosenbrock(x):
        x = np.asarray(x)
        return float((1.0 - x[0]) ** 2 + 10.0 * (x[1] - x[0] ** 2) ** 2)

    res = minimize(rosenbrock, np.zeros(2), device="cpu")
    assert res.success and calls.jit == [] and len(calls.eager) == 1
    res = minimize(lambda x: (1.0 - x[0]) ** 2 + 10.0 * (x[1] - x[0] ** 2) ** 2, np.zeros(2),
                   device="cpu")
    assert res.success and len(calls.jit) == 1 and len(calls.eager) == 1


def test_restoration_solves_run_solve_jit(monkeypatch):
    """Solver's restoration phase and solve_with_restoration on one
    instance run solve_jit (the restoration problem's and the resumed
    solve's), as the reference runs its jitted solve."""
    calls = Calls(monkeypatch)
    _, tp, x0 = td.wachbieg()
    solver = Solver(tp, x0, Settings(), device="cpu")
    assert solver.solve(max_iterations=200) == Status.OPTIMAL
    assert solver.num_phase_toggles >= 1 and len(calls.jit) >= 2 and calls.eager == []
    calls.jit.clear()
    settings = Settings()
    out = restoration.solve_with_restoration(tp, settings, ps.initial_state(tp, settings, x0,
                                                                            device="cpu"), 200)
    assert int(out.status) == Status.OPTIMAL and calls.jit == [200, 200, 200]


def test_solve_runs_solve_jit(monkeypatch):
    """``solve`` is initial_state + solve_jit, as the reference's; the
    module keeps solve_jit and solve_from, the package exports neither
    (as the reference's does not)."""
    calls = []
    real = ps.solve_jit
    monkeypatch.setattr(ps, "solve_jit", lambda *a: calls.append(a[3]) or real(*a))
    _, tp, x0 = td.hs71()
    out = sleqp_tpu_torch.solve(tp, Settings(), x0, max_iterations=7, device="cpu")
    assert calls == [7] and int(out.iteration) == 6
    assert not hasattr(sleqp_tpu_torch, "solve_jit") and callable(ps.solve_from)
