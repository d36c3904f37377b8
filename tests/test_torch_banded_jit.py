"""Port parity: ``banded_solve_jit``, the banded solve as device programs
(sleqp_tpu_torch/banded.py against sleqp_tpu/banded.py:1077-1111).

On the CPU ``banded_solve_jit`` runs the read-free programs of its CUDA
graphs eagerly, one host read before the first iteration and one after each
program.  It must equal ``banded_solve_from`` (the eager loop that reads as
it goes) bit for bit on every case of tests/test_torch_banded.py, the same
iterations under ``lanes.device_resident()``: the early stop, the
quasi-Newton push and the local-infeasibility certificate selected, the
Armijo loop's 30 trials masked.  Against the JAX package's
``banded_solve_jit`` it is held as test_torch_banded.py holds
``banded_solve``: the same status and iterations, X to 1e-6.  The card's
path (capture, replay, the phase switch, the lazy restoration capture, the
cache) runs on emulated graphs.
"""

import dataclasses

import pytest
import torch

import sleqp_tpu_torch
from sleqp_tpu import banded as jb
from sleqp_tpu_torch import Status, lanes
from sleqp_tpu_torch import banded as tb
from sleqp_tpu_torch.types import SolverPhase
from test_torch_banded import CASES, _port_settings, case_run, chain_pair, close, port_state
from test_torch_batch import HostReads
from torch_graphs import ReadsForbidden, emulated_graphs  # noqa: F401
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = tuple(f.name for f in dataclasses.fields(tb.BandedState))


def parts(a, b):
    """The fields whose bits differ between two states."""
    return [f for f in FIELDS if not (getattr(a, f).dtype == getattr(b, f).dtype
                                      and torch.equal(getattr(a, f), getattr(b, f)))]


def start(name, fresh=False):
    """(port problem, port settings, JAX's start carried over, the cap);
    ``fresh``: a new port problem, with no programs cached on it."""
    _, tp, _, ts, states = case_run(name)
    if fresh:
        _, tp = CASES[name][0]()
    return tp, ts, port_state(states[0]), CASES[name][4]


class ConsCalls:
    """Counts a problem's constraint evaluations, by the trip of the eager
    loop they belong to: an optimality iteration evaluates at X, once a
    trial and once at the step taken (one in all where it stops), a
    restoration iteration once more at the new point."""

    def __init__(self, problem):
        self.problem, self.counts, self.phases = problem, [], []

    def __enter__(self):
        inner = self.problem.cons

        def counted(X):
            self.counts[-1] += 1
            return inner(X)

        self.problem.cons = counted
        return self

    def __exit__(self, *exc):
        del self.problem.cons

    def trials(self):
        """The Armijo trials of each trip."""
        return [max(n - (3 if phase == SolverPhase.RESTORATION else 2), 0)
                for n, phase in zip(self.counts, self.phases)]


def eager_trips(tp, ts, s, max_iterations):
    """The eager loop's states and the Armijo trials of each trip."""
    states = [s]
    with ConsCalls(tp) as calls:
        while int(s.status) == Status.RUNNING and int(s.iteration) < max_iterations:
            calls.counts.append(0)
            calls.phases.append(int(s.phase))
            s = tb.banded_perform_iteration(tp, ts, s)
            states.append(s)
    return states, calls.trials()


def graph_reads(trials):
    """Host reads of banded_solve_jit's loop for an iteration whose
    linesearch took ``trials`` Armijo trials: one, and, past the
    GRAPH_TRIALS in the iteration's program, one a block of TRIAL_BLOCK more
    and one to finish."""
    if trials <= tb.GRAPH_TRIALS:
        return 1
    return 2 + -(-(trials - tb.GRAPH_TRIALS) // tb.TRIAL_BLOCK)


@pytest.mark.parametrize("name", sorted(CASES))
def test_equals_eager_loop(name):
    tp, ts, s0, cap = start(name)
    want = tb.banded_solve_from(tp, ts, s0, cap)
    got = tb.banded_solve_jit(tp, ts, s0, cap)
    assert parts(got, want) == []
    assert int(got.status) != Status.RUNNING


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_solve_jit(name):
    """From JAX's start, the same status and iterations as JAX's
    banded_solve_jit and X to 1e-6."""
    jp, tp, js, ts, states = case_run(name)
    cap = CASES[name][4]
    ref = jb.banded_solve_jit(jp, js, states[0], cap)
    got = tb.banded_solve_jit(tp, ts, port_state(states[0]), cap)
    assert int(got.status) == int(ref.status)
    assert int(got.iteration) == int(ref.iteration)
    close(got.X, ref.X, 1e-6)


@pytest.mark.parametrize("route", ["float64", "mixed"])
def test_long_linesearches_equal_eager_loop(route):
    """The locally infeasible chain, whose linesearches outlast the trials
    inside the iteration's program (30, exhausted, in both phases): the
    trial blocks and the finishing program keep the eager loop's states,
    and the iteration under device_resident equals the reading one."""
    tp, ts, s0, cap = start("infeasible")
    ts = _port_settings(route)
    states, trials = eager_trips(tp, ts, s0, cap)
    assert trials.count(tb.MAX_LINESEARCH_STEPS) >= 10
    assert {int(s.phase) for s in states} == {0, 1}
    for before, after in zip(states[:-1], states[1:]):
        with lanes.device_resident():
            got = tb._iterate(tp, ts, before, int(before.phase))
        assert parts(got, after) == [], int(before.iteration)
    assert parts(tb.banded_solve_jit(tp, ts, s0, cap), tb.banded_solve_from(tp, ts, s0, cap)) == []


@pytest.mark.parametrize("name", ["chain", "infeasible"])
def test_iteration_limit_and_stopped_start(name):
    """ABORT_ITER at max_iterations = 2 and 0, as the eager loop ends them;
    a start that has stopped takes no iteration and one read."""
    tp, ts, s0, _ = start(name)
    for max_iterations in (2, 0):
        want = tb.banded_solve_from(tp, ts, s0, max_iterations)
        got = tb.banded_solve_jit(tp, ts, s0, max_iterations)
        assert parts(got, want) == []
        assert int(got.status) == Status.ABORT_ITER and int(got.iteration) == max_iterations
    done = tb.banded_solve_from(tp, ts, s0, 300)
    assert int(done.status) != Status.RUNNING
    with HostReads() as reads:
        again = tb.banded_solve_jit(tp, ts, done, 300)
    assert parts(again, done) == [] and reads.count == 1


@pytest.mark.parametrize("name", ["chain", "restoration", "nl_mixed", "infeasible"])
def test_reads_a_trip(name):
    """One host read before the first iteration and one a trip (the stop
    found by an iteration is a trip), and, where a linesearch outlasts the
    trials inside the iteration's program, one a block of trials and one to
    finish.  The trials are counted on the eager loop."""
    tp, ts, s0, cap = start(name)
    states, trials = eager_trips(tp, ts, s0, cap)
    with HostReads() as reads:
        out = tb.banded_solve_jit(tp, ts, s0, cap)
    assert parts(out, states[-1]) == []
    assert reads.count == 1 + sum(graph_reads(n) for n in trials)
    if name == "infeasible":
        assert reads.count > len(trials) + 1  # long linesearches read more


@pytest.mark.parametrize("name", ["chain", "restoration", "damped_bfgs", "nl_mixed",
                                  "infeasible"])
def test_read_free_iteration_reads_nothing(name, monkeypatch):
    """Inside lanes.device_resident() an iteration from every state of the
    eager loop (both phases, the stop, the quasi-Newton push, the
    certificate) reads nothing from its tensors and gives the reading
    iteration's bits."""
    tp, ts, s0, cap = start(name)
    states, _ = eager_trips(tp, ts, s0, cap)
    states.append(tb.banded_perform_iteration(tp, ts, states[-1]))  # a stopped state again
    phases = [int(s.phase) for s in states[:-1]]
    with ReadsForbidden(monkeypatch), lanes.device_resident():
        got = [tb._iterate(tp, ts, s, phase) for s, phase in zip(states[:-1], phases)]
    for before, after, want in zip(states[:-1], got, states[1:]):
        assert parts(after, want) == [], int(before.iteration)


def test_exports_and_banded_solve_goes_through_jit(monkeypatch):
    assert sleqp_tpu_torch.banded_solve_jit is tb.banded_solve_jit
    assert sleqp_tpu_torch.banded_solve_from is tb.banded_solve_from
    tp, ts, s0, cap = start("chain")
    calls = []
    real = tb.banded_solve_jit
    monkeypatch.setattr(tb, "banded_solve_jit", lambda *a: calls.append(a[3]) or real(*a))
    out = tb.banded_solve(tp, ts, max_iterations=cap, state0=s0)
    assert calls == [cap]
    assert parts(out, tb.banded_solve_from(tp, ts, s0, cap)) == []


PROGRAMS = {phase: [f"{phase}.{p}" for p in ("iterate", "search", "finish")]
            for phase in ("opt", "rest")}


@pytest.mark.parametrize("name,order", [("chain", ["opt"]), ("nl_mixed", ["opt"]),
                                        ("restoration", ["rest", "opt"]),
                                        ("infeasible", ["opt", "rest"])])
def test_graph_bookkeeping_on_emulated_graphs(emulated_graphs, name, order):
    """A phase's three programs captured when a solve first runs an
    iteration of that phase (restoration's only once a solve enters it),
    cached on the problem for the next solve; the flag's phase bit picks
    the programs; one read before the loop and one after each program; the
    state the eager loop's, bit for bit."""
    tp, ts, s0, cap = start(name, fresh=True)
    want = tb.banded_solve_from(tp, ts, s0, cap)
    counted = 0
    for run in range(2):  # the second solve replays the cached graphs
        with HostReads() as reads:
            got = tb.banded_solve_jit(tp, ts, s0, cap)
        assert parts(got, want) == []
        graphs = tb.solve_graphs(tp, ts, s0)
        assert graphs.cuda and len(tp._solve_graphs) == 1
        assert emulated_graphs == [p for phase in order for p in PROGRAMS[phase]]
        counted += reads.count
        assert counted == graphs.reads
    replays = graphs.replays
    for phase in ("opt", "rest"):
        assert (replays[f"{phase}.iterate"] > 0) == (phase in order)
    assert (replays["opt.search"] > 0) == (replays["rest.search"] > 0) == (name == "infeasible")


def test_capture_of_a_reading_callable_raises(emulated_graphs):
    """A callable that reads the card makes the capture raise, naming the
    problem's callables; nothing falls back to the eager loop."""
    _, tp = chain_pair()
    scale = torch.tensor(1.0, dtype=torch.float64)
    tgt = torch.arange(tp.N_b, dtype=torch.float64)

    def reading_obj(x, t):
        return float(scale) * torch.sum((x - tgt.to(x)[t]) ** 2)

    tp.obj_block = reading_obj
    ts = tb.Settings()
    s0 = tb.banded_initial_state(tp, ts, torch.zeros((tp.N_b, tp.k), dtype=torch.float64))
    with pytest.raises(RuntimeError, match="obj_block=.*reading_obj.*cons_block="):
        tb.banded_solve_jit(tp, ts, s0, 100)
    assert emulated_graphs == []
