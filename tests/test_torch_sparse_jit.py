"""Port parity: ``sparse_solve_jit``, the matrix-free sparse solve as device
programs (sleqp_tpu_torch/sparse.py against sleqp_tpu/sparse.py:884-904).

On the CPU ``sparse_solve_jit`` runs the read-free programs of its CUDA
graphs eagerly, one host read before the first iteration and one after each
program that ends a block of CG steps or PDHG iterations, the stop test or
the iteration.  It must equal ``sparse_solve_from`` (the eager loop that
reads as it goes) bit for bit on every case of tests/test_torch_sparse.py,
with the same CG and PDHG blocks and no more host reads: the stop test and
the local-infeasibility certificate selected, the Armijo trials masked.
HS71 on PDLP is held so for its first three iterations (its whole solve,
~36 000 PDHG iterations, runs in test_torch_sparse.py's
test_solve_matches_jax, through this path).  Against the JAX package's
``sparse_solve_jit`` it is held as test_torch_sparse.py holds
``sparse_solve``: the same status and iterations, x to 1e-6.  The card's
path (capture, replay, the phase switch, the lazy captures, the cache)
runs on emulated graphs.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu_torch
from sleqp_tpu import sparse as jsp
from sleqp_tpu_torch import Settings, Status
from sleqp_tpu_torch import sparse as tsp
from sleqp_tpu_torch.ops import pdlp
from sleqp_tpu_torch.types import SolverPhase
from test_torch_batch import HostReads
from test_torch_sparse import CASES, ROUTES, close, hs71_pair, port_state
from torch_graphs import emulated_graphs  # noqa: F401
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = tuple(f.name for f in dataclasses.fields(tsp.SparseState))
# the iteration cap of each case here: HS71 on PDLP its first iterations
CAPS = {name: 3 if name == "hs71_pdlp" else CASES[name][3] for name in CASES}


def parts(a, b):
    """The fields whose bits differ between two states."""
    return [f for f in FIELDS if not (getattr(a, f).dtype == getattr(b, f).dtype
                                      and torch.equal(getattr(a, f), getattr(b, f)))]


def start(name):
    """(JAX problem, port problem, JAX settings, port settings, x0): a
    fresh pair of the case, with no programs cached on the port's."""
    make, route, x0, _ = CASES[name]
    jp, tp = make()
    x0 = np.zeros(jp.n) if x0 is None else x0()
    cd = ROUTES[route]
    return jp, tp, jsp.Settings(compute_dtype=cd), Settings(compute_dtype=cd), x0


class Blocks:
    """Counts the CG blocks (a ``_cg_running`` test after each) and the
    PDHG blocks (``pdlp.block``) while active."""

    def __init__(self, monkeypatch):
        self.monkeypatch, self.counts = monkeypatch, collections.Counter()

    def __enter__(self):
        for module, name in ((tsp, "_cg_running"), (pdlp, "block")):
            real = getattr(module, name)

            def counted(*args, real=real, name=name, **kwargs):
                self.counts[name] += 1
                return real(*args, **kwargs)

            self.monkeypatch.setattr(module, name, counted)
        return self

    def __exit__(self, *exc):
        self.monkeypatch.undo()


def solve_both(tp, ts, s0, cap, monkeypatch):
    """(graph state, eager state, graph reads, eager reads, graph blocks,
    eager blocks, the graph's programs)."""
    with Blocks(monkeypatch) as eager_blocks, HostReads() as eager_reads:
        want = tsp.sparse_solve_from(tp, ts, s0, cap)
    with Blocks(monkeypatch) as graph_blocks, HostReads() as graph_reads:
        got = tsp.sparse_solve_jit(tp, ts, s0, cap)
    return (got, want, graph_reads.count, eager_reads.count, graph_blocks.counts,
            eager_blocks.counts, tsp.solve_graphs(tp, ts, s0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_equals_eager_loop(name, monkeypatch):
    """Every field bit for bit, the same CG and PDHG blocks, no more host
    reads than the eager loop, each of them the loop's flag."""
    _, tp, _, ts, x0 = start(name)
    s0 = tsp.sparse_initial_state(tp, ts, x0)
    got, want, reads, eager_reads, blocks, eager_blocks, loop = solve_both(
        tp, ts, s0, CAPS[name], monkeypatch)
    assert parts(got, want) == []
    assert int(got.status) != Status.RUNNING
    assert blocks == eager_blocks and blocks["_cg_running"] > 0
    assert (blocks["block"] > 0) == (name == "hs71_pdlp")
    assert reads == loop.reads <= eager_reads


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_solve_jit(name):
    """From JAX's start, the same status and iterations as JAX's
    sparse_solve_jit and x to 1e-6."""
    jp, tp, js, ts, x0 = start(name)
    cap = CAPS[name]
    s0 = jsp.sparse_initial_state(jp, js, jnp.asarray(x0))
    ref = jax.jit(lambda s: jsp.sparse_solve_jit(jp, js, s, cap))(s0)
    got = tsp.sparse_solve_jit(tp, ts, port_state(s0), cap)
    assert int(got.status) == int(ref.status)
    assert int(got.iteration) == int(ref.iteration)
    close(got.x, ref.x, 1e-6)


def test_pdlp_cap_runs_the_short_last_block(monkeypatch):
    """HS71 with the Cauchy LP capped at 100 PDHG iterations: a whole block
    of 64 and a short one of 36 with no restart check, as the eager
    lockstep loop runs them (its read after the last block is skipped)."""
    _, tp = hs71_pair()
    tp.cauchy_iters = 100
    ts = Settings()
    s0 = tsp.sparse_initial_state(tp, ts, np.array([1.0, 5.0, 5.0, 1.0]))
    got, want, reads, eager_reads, blocks, eager_blocks, loop = solve_both(
        tp, ts, s0, 2, monkeypatch)
    assert tsp._lp_trips(tp) == [64, 36]
    assert parts(got, want) == []
    assert blocks == eager_blocks
    assert loop.replays["opt.lp_tail"] == 2 == loop.replays["opt.lp_start"]
    assert reads == loop.reads <= eager_reads


@pytest.mark.parametrize("name", ["scattered_float64", "infeasible"])
def test_iteration_limit_and_stopped_start(name):
    """ABORT_ITER at max_iterations = 2 and 0, as the eager loop ends them;
    a start that has stopped takes no iteration and one read."""
    _, tp, _, ts, x0 = start(name)
    s0 = tsp.sparse_initial_state(tp, ts, x0)
    for max_iterations in (2, 0):
        want = tsp.sparse_solve_from(tp, ts, s0, max_iterations)
        got = tsp.sparse_solve_jit(tp, ts, s0, max_iterations)
        assert parts(got, want) == []
        assert int(got.status) == Status.ABORT_ITER and int(got.iteration) == max_iterations
    done = tsp.sparse_solve_from(tp, ts, s0, CAPS[name])
    assert int(done.status) != Status.RUNNING
    with HostReads() as reads:
        again = tsp.sparse_solve_jit(tp, ts, done, CAPS[name])
    assert parts(again, done) == [] and reads.count == 1


def test_long_linesearches_leave_the_iteration_graph():
    """The contradictory equalities: optimality iterations whose
    linesearches spend all 25 trials, past the GRAPH_TRIALS inside
    ``opt.search``, in blocks of ``opt.trials`` and ``opt.finish``, then
    restoration; the eager loop's bits throughout."""
    _, tp, _, ts, x0 = start("infeasible")
    s0 = tsp.sparse_initial_state(tp, ts, x0)
    got = tsp.sparse_solve_jit(tp, ts, s0, CAPS["infeasible"])
    loop = tsp.solve_graphs(tp, ts, s0)
    assert parts(got, tsp.sparse_solve_from(tp, ts, s0, CAPS["infeasible"])) == []
    assert int(got.status) == Status.INFEASIBLE
    assert loop.replays["opt.trials"] == tsp._BLOCKS * loop.replays["opt.finish"] > 0
    assert loop.replays["rest.search"] > 0


def test_exports_and_sparse_solve_goes_through_jit(monkeypatch):
    assert sleqp_tpu_torch.sparse_solve_jit is tsp.sparse_solve_jit
    assert sleqp_tpu_torch.sparse_solve_from is tsp.sparse_solve_from
    _, tp, _, ts, x0 = start("scattered_float64")
    calls = []
    real = tsp.sparse_solve_jit
    monkeypatch.setattr(tsp, "sparse_solve_jit", lambda *a: calls.append(a[3]) or real(*a))
    out = tsp.sparse_solve(tp, ts, x0=x0, max_iterations=7)
    assert calls == [7]
    s0 = tsp.sparse_initial_state(tp, ts, x0)
    assert parts(out, tsp.sparse_solve_from(tp, ts, s0, 7)) == []


# the programs a solve captures, in order, by the phases it runs
OPT = {
    "float64": ["opt.head", "opt.cg", "opt.pass", "opt.search", "opt.trials", "opt.finish"],
    "mixed": ["opt.head", "opt.cg32", "opt.pass", "opt.polish", "opt.cg", "opt.search",
              "opt.trials", "opt.finish"],
}
REST = ["rest.head", "rest.cg", "rest.search", "rest.trials", "rest.finish"]
CAPTURED = {
    "unconstrained": [p for p in OPT["float64"] if p != "opt.pass"],
    # HS71's first Cauchy LP runs to its cap of 4000 PDHG iterations: the
    # short last block is captured then
    "hs71_pdlp": ["opt.lp_start", "opt.lp_block", *OPT["float64"], "opt.lp_tail"],
    "infeasible": OPT["float64"] + REST,
    "scattered_float64": OPT["float64"],
    "scattered_mixed": OPT["mixed"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_bookkeeping_on_emulated_graphs(emulated_graphs, name):
    """Every program captured read-free when a solve first runs its phase
    (restoration's only once a solve enters it, the short last PDHG block
    once a Cauchy LP reaches it), cached on the problem for
    the next solve; one read before the loop and one after each program
    that needs it; the state the eager loop's, bit for bit."""
    _, tp, _, ts, x0 = start(name)
    s0 = tsp.sparse_initial_state(tp, ts, x0)
    want = tsp.sparse_solve_from(tp, ts, s0, CAPS[name])
    counted = 0
    for run in range(2):  # the second solve replays the cached graphs
        with HostReads() as reads:
            got = tsp.sparse_solve_jit(tp, ts, s0, CAPS[name])
        assert parts(got, want) == []
        loop = tsp.solve_graphs(tp, ts, s0)
        assert loop.cuda and len(tp._solve_graphs) == 1
        assert emulated_graphs == CAPTURED[name]
        counted += reads.count
        assert counted == loop.reads
    assert (loop.replays["rest.head"] > 0) == (name == "infeasible")
    assert int(got.phase) == SolverPhase.OPTIMIZATION or name == "infeasible"


def test_capture_of_a_reading_callable_raises(emulated_graphs):
    """A callable that reads the card makes the capture raise, naming the
    problem's callables; nothing falls back to the eager loop."""
    _, tp, _, ts, x0 = start("scattered_float64")
    scale = torch.tensor(1.0, dtype=torch.float64)
    inner = tp.obj

    def reading_obj(x):
        return float(scale) * inner(x)

    tp.obj = reading_obj
    s0 = tsp.sparse_initial_state(tp, ts, x0)
    with pytest.raises(RuntimeError, match="obj=.*reading_obj.*cons="):
        tsp.sparse_solve_jit(tp, ts, s0, 10)
    assert emulated_graphs == []
