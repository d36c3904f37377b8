"""Port parity: ``ocp_solve_jit``, the OCP solve as one device program
(sleqp_tpu_torch/ocp.py against sleqp_tpu/ocp.py:738-772).

On the CPU ``ocp_solve_jit`` runs the read-free iteration of its CUDA graph
eagerly, one host read a trip.  It must equal ``ocp_solve_from`` (the eager
loop that reads as it goes) bit for bit on every route, the same iteration
under ``lanes.device_resident()``: the early stop selected per lane and the
Armijo loop's 30 trials masked.  Against the JAX package it is held at
tests/test_torch_ocp.py's tolerances, the mixed route's named tie included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.ocp import ocp_initial_state as jax_initial_state
from sleqp_tpu.ocp import ocp_solve_jit as jax_solve_jit
from sleqp_tpu_torch import (BlockStructuredProblem, Settings, Status, batched_ocp_solve, graphs,
                             lanes)
from sleqp_tpu_torch import ocp as ocp_module
from sleqp_tpu_torch.ocp import (
    MAX_LINESEARCH_STEPS,
    REG_MAX,
    ocp_initial_state,
    ocp_perform_iteration,
    ocp_solve,
    ocp_solve_from,
    ocp_solve_jit,
)
from test_torch_batch import HostReads
from torch_graphs import ReadsForbidden, emulated_graphs  # noqa: F401
from torch_parity import (  # noqa: F401
    NU,
    NX,
    X_INIT,
    dynamics,
    final_cost,
    make_ocp_pair,
    no_jax_cache_writes,
    one_torch_thread,
    stage_cost,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("X", "U", "lam", "penalty", "reg", "iteration", "status", "num_accepted",
          "num_rejected", "obj_val", "feas_res", "stat_res", "last_ratio", "last_alpha")
CASES = {
    "free": {},
    "u_active": dict(u_lb=-0.15, u_ub=0.15),  # saturated controls, exhausted linesearches
    "x_bounds": dict(x_lb=[-np.inf, -0.45]),
    "gauss_newton": dict(gauss_newton=True),
}
# (Settings.compute_dtype, tridiag_backend): every backend on both routes
# ("cr", "spike" and "scan" on the float64 route all run the scan)
ROUTES = [("same", "auto"), ("same", "pallas"), ("same", "scan"), ("float32", "auto"),
          ("float32", "cr"), ("float32", "pallas"), ("float32", "spike"), ("float32", "scan")]


def parts(a, b):
    """The fields whose bits differ between two states."""
    return [f for f in FIELDS if not (getattr(a, f).dtype == getattr(b, f).dtype
                                      and torch.equal(getattr(a, f), getattr(b, f)))]


def long_problem(T=24, **bounds):
    """tests/test_ocp.py's oscillator over T stages (SPIKE chunks of more
    than one stage)."""
    return BlockStructuredProblem(dynamics, stage_cost, T, NX, NU, x0=X_INIT,
                                  final_cost=final_cost, device="cpu", **bounds)


class MeritCalls:
    """Counts a problem's merit evaluations, by the iteration they belong to
    (one a trial and one at the step taken, in the eager loop)."""

    def __init__(self, problem):
        self.problem, self.counts = problem, []

    def __enter__(self):
        inner = self.problem.merit

        def counted(*args, **kwargs):
            self.counts[-1] += 1
            return inner(*args, **kwargs)

        self.problem.merit = counted
        return self

    def __exit__(self, *exc):
        del self.problem.merit


@pytest.mark.parametrize("route,backend", ROUTES)
@pytest.mark.parametrize("case", ["free", "u_active"])
def test_equals_eager_loop(case, route, backend):
    _, tp = make_ocp_pair(**CASES[case])
    settings = Settings(compute_dtype=route)
    s0 = ocp_initial_state(tp, settings, device="cpu")
    want = ocp_solve_from(tp, settings, s0, 80, tridiag_backend=backend)
    got = ocp_solve_jit(tp, settings, s0, 80, tridiag_backend=backend)
    assert parts(got, want) == []
    assert int(got.status) == Status.OPTIMAL


@pytest.mark.parametrize("route,backend", [("same", "auto"), ("float32", "auto"),
                                           ("float32", "spike"), ("same", "pallas")])
@pytest.mark.parametrize("case", ["free", "x_bounds", "gauss_newton"])
def test_equals_eager_loop_longer_horizon(case, route, backend):
    """T = 24: the SPIKE route's chunks hold several stages."""
    bounds = {k: v for k, v in CASES[case].items() if k != "gauss_newton"}
    tp = long_problem(**bounds, gauss_newton=case == "gauss_newton")
    settings = Settings(compute_dtype=route)
    s0 = ocp_initial_state(tp, settings, device="cpu")
    want = ocp_solve_from(tp, settings, s0, 60, tridiag_backend=backend)
    got = ocp_solve_jit(tp, settings, s0, 60, tridiag_backend=backend)
    assert parts(got, want) == []
    assert int(got.status) == Status.OPTIMAL


@pytest.mark.parametrize("route", ["same", "float32"])
def test_exhausted_linesearch_equals_eager_loop(route):
    """Saturated controls: some iterations spend all 30 Armijo trials and
    reject the step; the masked trials of the read-free loop keep the eager
    loop's state through them."""
    _, tp = make_ocp_pair(**CASES["u_active"])
    settings = Settings(compute_dtype=route)
    s = ocp_initial_state(tp, settings, device="cpu")
    exhausted = 0
    with MeritCalls(tp) as merits:
        while int(s.status) == Status.RUNNING:
            merits.counts.append(0)
            rejected = int(s.num_rejected)
            want = ocp_perform_iteration(tp, settings, s)
            exhausted += (merits.counts[-1] == MAX_LINESEARCH_STEPS + 1
                          and int(want.num_rejected) > rejected)
            with lanes.device_resident():
                got = ocp_perform_iteration(tp, settings, s)
            assert parts(got, want) == [], int(s.iteration)
            s = want
    assert int(s.status) == Status.OPTIMAL and exhausted >= 3


@pytest.mark.parametrize("route", ["same", "float32"])
def test_iteration_limit_and_dead_point(route):
    """ABORT_ITER at max_iterations = 2 (and 0), and a dead point (the
    regularization at its cap), as the eager loop ends them."""
    _, tp = make_ocp_pair(**CASES["u_active"])
    settings = Settings(compute_dtype=route)
    s0 = ocp_initial_state(tp, settings, device="cpu")
    for max_iterations in (2, 0):
        want = ocp_solve_from(tp, settings, s0, max_iterations)
        got = ocp_solve_jit(tp, settings, s0, max_iterations)
        assert parts(got, want) == []
        assert int(got.status) == Status.ABORT_ITER and int(got.iteration) == max_iterations
    dead = dataclasses.replace(s0, reg=torch.tensor(REG_MAX, dtype=torch.float64))
    want = ocp_solve_from(tp, settings, dead, 10)
    got = ocp_solve_jit(tp, settings, dead, 10)
    assert parts(got, want) == []
    assert int(got.status) == Status.ABORT_DEADPOINT and int(got.iteration) == 0


def test_mesh_raises_and_ocp_solve_goes_through_jit(monkeypatch):
    _, tp = make_ocp_pair()
    settings = Settings()
    s0 = ocp_initial_state(tp, settings, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        ocp_solve_jit(tp, settings, s0, 10, mesh=object())
    calls = []
    real = ocp_module._solve_loop
    monkeypatch.setattr(ocp_module, "_solve_loop", lambda *a: calls.append(a[-1]) or real(*a))
    out = ocp_solve(tp, settings, max_iterations=20, device="cpu")
    batched_ocp_solve(tp, settings, X_INIT[None], max_iterations=20, device="cpu")
    assert calls == [False, True]
    assert parts(out, ocp_solve_from(tp, settings, s0, 20)) == []


@pytest.mark.parametrize("route", ["same", "float32"])
@pytest.mark.parametrize("case", ["free", "u_active"])
def test_matches_jax_solve_jit(case, route):
    """Against the JAX package's ocp_solve_jit, at test_torch_ocp.py's
    tolerances: float64 the same iterations, mixed within one, U to 1e-5.
    The mixed route with saturated controls is the named tie of
    test_torch_ocp.py::test_active_bounds_solve_matches_jax[float32] (JAX
    49 iterations, the port 59): held to the reference's bar against
    float64 (iterations + 3) and the same point."""
    jp, tp = make_ocp_pair(**CASES[case])
    js = JaxSettings(compute_dtype=route)
    ref = jax_solve_jit(jp, js, jax_initial_state(jp, js), 80)
    settings = Settings(compute_dtype=route)
    out = ocp_solve_jit(tp, settings, ocp_initial_state(tp, settings, device="cpu"), 80)
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    if route == "same":
        assert int(out.iteration) == int(ref.iteration)
    elif case == "u_active":
        f64 = jax_solve_jit(jp, JaxSettings(), jax_initial_state(jp, JaxSettings()), 80)
        assert int(out.iteration) <= int(f64.iteration) + 3
    else:
        assert abs(int(out.iteration) - int(ref.iteration)) <= 1
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.X.numpy(), np.asarray(ref.X), rtol=0, atol=1e-5)


def _starts():
    """tests/test_ocp.py::test_ocp_scenario_batch's three initial states."""
    return np.stack([X_INIT, X_INIT + np.array([0.3, -0.1]), X_INIT * 0.5])


@pytest.mark.parametrize("route,backend", [("same", "auto"), ("float32", "auto"),
                                           ("same", "pallas"), ("float32", "spike")])
@pytest.mark.parametrize("case", ["free", "u_active"])
def test_batched_lanes(case, route, backend):
    """Each lane of batched_ocp_solve equals the eager loop under vmap (the
    seed's batched_ocp_solve) bit for bit, and its single-lane solve within
    the batched products' rounding."""
    _, tp = make_ocp_pair(**CASES[case])
    settings = Settings(compute_dtype=route)
    x0s = torch.as_tensor(_starts())
    out = batched_ocp_solve(tp, settings, x0s, max_iterations=80, tridiag_backend=backend,
                            device="cpu")
    seed = lanes.vmap_lanes(
        lambda x: ocp_solve_from(tp, settings, ocp_initial_state(tp, settings, x0=x, device="cpu"),
                                 80, tridiag_backend=backend), x0s)
    assert parts(out, seed) == []
    for b in range(len(x0s)):
        one = ocp_solve_jit(tp, settings, ocp_initial_state(tp, settings, x0=x0s[b], device="cpu"),
                            80, tridiag_backend=backend)
        assert int(out.status[b]) == int(one.status) == Status.OPTIMAL
        assert int(out.iteration[b]) == int(one.iteration)
        np.testing.assert_allclose(out.U[b].numpy(), one.U.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("route,backend", ROUTES)
def test_read_free_iteration_reads_nothing(route, backend, monkeypatch):
    """Inside lanes.device_resident() one iteration, alone or under vmap,
    reads nothing from its tensors, and gives the reading iteration's
    bits."""
    _, tp = make_ocp_pair(**CASES["u_active"])
    settings = Settings(compute_dtype=route)
    s0 = ocp_initial_state(tp, settings, device="cpu")
    two = lanes.tree_map(lambda a: a[None].expand(2, *a.shape).clone(), s0)

    def iteration(s):
        return ocp_perform_iteration(tp, settings, s, tridiag_backend=backend)

    want, want_lanes = iteration(s0), lanes.vmap_lanes(iteration, two)  # first-use checks too
    with ReadsForbidden(monkeypatch), lanes.device_resident():
        got = iteration(s0)
        got_lanes = lanes.vmap_lanes(iteration, two)
    assert parts(got, want) == []
    assert parts(got_lanes, want_lanes) == []


def graph_reads(trials):
    """Host reads of ocp_solve_jit's loop for an iteration whose linesearch
    took ``trials`` Armijo trials: one, and, past the GRAPH_TRIALS in the
    iteration's program, one a block of TRIAL_BLOCK more and one to
    finish."""
    if trials <= ocp_module.GRAPH_TRIALS:
        return 1
    return 2 + -(-(trials - ocp_module.GRAPH_TRIALS) // ocp_module.TRIAL_BLOCK)


@pytest.mark.parametrize("max_iterations", [80, 2])
@pytest.mark.parametrize("case", ["free", "u_active"])
def test_reads_a_trip(case, max_iterations):
    """One host read an iteration, and one more that finds the solve
    stopped (OPTIMAL or a dead point) unless the iteration limit ended it;
    an iteration whose linesearch outlasts the trials inside the
    iteration's program reads once more a block of trials and once to
    finish.  The trials are counted on the eager loop (a merit evaluation
    a trial and one at the step taken)."""
    _, tp = make_ocp_pair(**CASES[case])
    settings = Settings(compute_dtype="float32")
    s0 = ocp_initial_state(tp, settings, device="cpu")
    with MeritCalls(tp) as merits:
        s = s0
        while int(s.status) == Status.RUNNING and int(s.iteration) < max_iterations:
            merits.counts.append(0)
            s = ocp_perform_iteration(tp, settings, s)
    stopped = int(s.status) != Status.RUNNING
    want = sum(graph_reads(max(n - 1, 0)) for n in merits.counts[:len(merits.counts) - stopped])
    with HostReads() as reads:
        out = ocp_solve_jit(tp, settings, s0, max_iterations)
    assert parts(dataclasses.replace(out, status=s.status), s) == []
    assert reads.count == want + stopped
    assert stopped == (max_iterations == 80)
    if case == "u_active" and max_iterations == 80:
        assert reads.count > int(out.iteration) + 1  # long linesearches read more


@pytest.mark.parametrize("case", ["free", "u_active"])
def test_batched_reads(case):
    """A batch reads once a trip for all lanes (and once a block and once
    more to finish a long linesearch of any lane): no more than the slowest
    lane's reads, at least one a trip."""
    _, tp = make_ocp_pair(**CASES[case])
    settings = Settings(compute_dtype="float32")
    singles = []
    for x0 in _starts():
        with HostReads() as reads:
            one = ocp_solve_jit(tp, settings, ocp_initial_state(tp, settings, x0=x0,
                                                                 device="cpu"), 80)
        singles.append((int(one.iteration), reads.count))
    with HostReads() as reads:
        out = batched_ocp_solve(tp, settings, _starts(), 80, device="cpu")
    assert (out.status == Status.OPTIMAL).all()
    assert int(out.iteration.max()) + 1 <= reads.count <= sum(n for _, n in singles)
    if case == "free":
        assert reads.count == max(n for _, n in singles)


@pytest.fixture
def counted_inverses(monkeypatch):
    """On emulated graphs, the batched inverses' plain versions count a
    launch a call, as their kernels' wrappers do, in fresh counts that
    graphs.LAUNCHES holds alone."""
    from sleqp_tpu_torch.ops import cyclic_reduction as cr

    for name in ("bgj_flat", "bgj_blocked64"):
        plain = getattr(cr, f"{name}_plain")

        def counted(C, plain=plain, name=name):
            cr.LAUNCHES[name] += 1
            return plain(C)

        monkeypatch.setattr(cr, f"{name}_plain", counted)
    monkeypatch.setattr(cr, "LAUNCHES", dict.fromkeys(cr.LAUNCHES, 0))
    monkeypatch.setattr(graphs, "LAUNCHES", (cr.LAUNCHES,))


@pytest.mark.parametrize("batched", [False, True])
def test_graph_bookkeeping_on_emulated_graphs(emulated_graphs, counted_inverses, batched):
    """Three programs captured once and cached on the problem; the launches
    made during a capture taken out of LAUNCHES and added back a replay
    (the warm-up's counted as run); one read after each program; the state
    the eager loop's, bit for bit."""
    from sleqp_tpu_torch.ops import cyclic_reduction as cr

    _, tp = make_ocp_pair(**CASES["u_active"])
    settings = Settings(compute_dtype="float32")
    if batched:
        x0s = torch.as_tensor(_starts())
        state0 = lanes.vmap_lanes(lambda x: ocp_initial_state(tp, settings, x0=x, device="cpu"),
                                  x0s)
        want = lanes.vmap_lanes(lambda s: ocp_solve_from(tp, settings, s, 80), state0)
    else:
        state0 = ocp_initial_state(tp, settings, device="cpu")
        want = ocp_solve_from(tp, settings, state0, 80)
    cr.LAUNCHES.update(dict.fromkeys(cr.LAUNCHES, 0))
    counted = 0
    for run in range(2):  # the second solve replays the cached graphs
        with HostReads() as reads:
            got = ocp_module._solve_loop(tp, settings, state0, 80, "auto", batched)
        assert parts(got, want) == []
        graph = ocp_module.iteration_graph(tp, settings, state0, batched=batched)
        assert len(emulated_graphs) == 3 and graph.cuda
        counted += reads.count
        assert counted == graph.reads
        assert graph.replays["search"] > 0  # long linesearches took the second program
    per = graph.launches
    assert per["iterate"]["bgj_flat"] > 0 and not any(per["search"].values())
    for k in cr.LAUNCHES:
        assert cr.LAUNCHES[k] == sum((1 + graph.replays[name]) * per[name][k]
                                     for name in per)
