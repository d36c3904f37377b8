"""Port parity of the batched dense solve on the SIMPLEX Cauchy LP:
sleqp_tpu_torch.parallel.batch against sleqp_tpu.parallel.batch, and the
simplex and the Cauchy LP layer under ``torch.func.vmap`` against their
single-lane calls.

* hs118 (AUTO resolves its LP to the simplex) at B = 8 from
  ``chip_smoke.lp_starts`` on three routes: ``batched_solve`` with
  ``Settings()``, with ``compute_dtype="float32"`` (float32 pivots, the
  float64 polish) and ``batched_solve_mp``.  Against JAX's lanes:
  statuses equal, iterations within 3, x within 1e-8; against the port's
  single-lane solves: the same status and iterations, x within 1e-9.
  The exceptions are rounding ties, named in ``TIES`` and ``JAX_TIES`` and
  held to the status, iterations within 3 and x within the solve's 1e-6
  (HS71 on the simplex has them: tests/test_torch_batch_simplex_hs71.py).
* ``simplex.solve``, ``solve_dual`` and ``polish_full_precision`` under
  ``vmap`` on LP lanes that take different pivot counts, cross
  refactorizations (``refactor_every=4``), switch to Bland's rule, end
  UNBOUNDED or DUAL_STALL, fall back to ``refine_result``, or stop at the
  cap: the same basis, statuses, state and pivots as the single-lane call,
  x and duals within 1e-12.
* ``cauchy.solve_cauchy_lp`` under ``vmap`` on hs118's Cauchy LPs, with
  lanes on every branch of the warm start (no saved basis, a
  primal-feasible one, the dual-stage repair, the dual stage cut by its
  cap and the crash fallback, a singular saved basis) and on both sides of
  the reduced re-solve, on both compute dtypes.  With finite data the
  Cauchy LP's dual stage cannot end DUAL_STALL (each row's slack pair
  always offers an entering column), so its fallback is driven by the cap
  here and DUAL_STALL by an infeasible LP at the simplex level.
* Host reads: the reads of a batched hs118 solve do not grow with B, and
  one lane reads as the single-lane loop did before it ran in lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_dense
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.harness.hs import get_problem as jax_get_problem
from sleqp_tpu.parallel import batch as jbatch
from sleqp_tpu.types import LPSolver as JaxLPSolver
from sleqp_tpu_torch import LPSolver, Settings, Status, initial_state, perform_iteration, solve
from sleqp_tpu_torch import cauchy
from sleqp_tpu_torch.cauchy import CauchyBasis, empty_basis
from sleqp_tpu_torch.harness.hs import get_problem
from sleqp_tpu_torch.lanes import vmap_lanes
from sleqp_tpu_torch.ops import simplex as ts
from sleqp_tpu_torch.parallel import batch as pb
from sleqp_tpu_torch.problem_solver import solve_from
from sleqp_tpu_torch.types import BaseStat
from test_torch_batch import HostReads
from test_torch_simplex import _lp, _random_lp
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAX_IT = 200
# lanes that part from the port's single-lane solve by a rounding tie
# (certified by torch_dense.tie_mismatches)
TIES = {"hs71": {6: "6 iterations alone, 7 in the batch, as on the ENUM route"}}
# lanes whose x parts from JAX's batched lane by more than 1e-8
JAX_TIES = {"hs71": {1: "JAX's batch 7 iterations, its single lane and the port 6",
                     5: "x 3.2e-8 apart, the ENUM route's tie"}}
# the single-lane reads of a solve before its loops ran in lanes
LANE_READS = {"hs118": 165, "hs71": 166}


def hs71_starts():
    """tests/test_misc.py::test_batched_independent_solves's starts."""
    rng = np.random.default_rng(0)
    x0 = np.array([1.0, 5.0, 5.0, 1.0])
    return np.clip(x0[None, :] + rng.uniform(-0.1, 0.1, (8, 4)), 1.0, 5.0)


CASES = {
    # name: (problem, port settings, JAX settings, batched_solve_mp?)
    "hs118": ("hs118", Settings(), JaxSettings(), False),
    "hs118_f32": ("hs118", Settings(compute_dtype="float32"),
                  JaxSettings(compute_dtype="float32"), False),
    "hs118_mp": ("hs118", Settings(), JaxSettings(), True),
}
HS71 = ("hs71", Settings(lp_solver=LPSolver.SIMPLEX), JaxSettings(lp_solver=JaxLPSolver.SIMPLEX),
        False)


def _problems(name):
    if name == "hs71":
        jp, tp, _ = torch_dense.hs71()
        return jp, tp, hs71_starts()
    return jax_get_problem(name)[0], get_problem(name, "cpu")[0], chip_smoke.lp_starts(name, 8)


def run_case(key, spec):
    """One compiled JAX batched solve, and the port's batched and
    single-lane solves of the same starts."""
    name, settings, jax_settings, mp = spec
    jp, tp, x0b = _problems(name)
    jax_solve = jbatch.batched_solve_mp if mp else jbatch.batched_solve
    ref = torch_dense.jax_to_numpy(jax_solve(jp, jax_settings, jnp.asarray(x0b),
                                             max_iterations=MAX_IT))
    port_solve = pb.batched_solve_mp if mp else pb.batched_solve
    out = port_solve(tp, settings, x0b, MAX_IT, device="cpu")
    if mp:
        single = [chip_smoke.single_lane_mp(tp, settings, x, MAX_IT) for x in x0b]
    else:
        single = [solve(tp, settings, x, MAX_IT, device="cpu") for x in x0b]
    return dict(key=key, name=name, jp=jp, tp=tp, settings=settings, jax_settings=jax_settings,
                x0b=x0b, ref=ref, out=out, single=single)


def assert_lanes_match_jax(case):
    ref, out = case["ref"], case["out"]
    np.testing.assert_array_equal(out.status.numpy(), ref.status)
    assert np.all(out.status.numpy() == Status.OPTIMAL)
    np.testing.assert_allclose(out.iteration.numpy(), ref.iteration, atol=3)
    ties = JAX_TIES.get(case["key"], {})
    dx = np.abs(out.it.x.numpy() - ref.it.x).max(axis=1)
    assert {b for b in range(len(dx)) if dx[b] > 1e-8} == set(ties), dx
    assert np.all(dx <= 1e-6), dx
    if case["name"] == "hs118":
        np.testing.assert_allclose(out.it.obj_val.numpy(), 664.82045, rtol=1e-7)
        assert out.it.x.dtype == torch.float64


def assert_lanes_match_single_lane(case):
    out, ties = case["out"], TIES.get(case["key"], {})
    parted = {}
    for b, s in enumerate(case["single"]):
        assert int(out.status[b]) == int(s.status), b
        dx = float((out.it.x[b] - s.it.x).abs().max())
        if int(out.iteration[b]) != int(s.iteration) or dx > 1e-9:
            parted[b] = (int(out.iteration[b]), int(s.iteration), dx)
    assert set(parted) == set(ties), parted
    for b in ties:
        it_batch, it_single, dx = parted[b]
        assert abs(it_batch - it_single) <= 3 and dx <= 1e-6, parted[b]
        states = torch_dense.single_lane_states(case["tp"], case["settings"], case["x0b"][b],
                                                MAX_IT)
        assert torch_dense.tie_mismatches(case["tp"], case["settings"], states,
                                          len(case["x0b"])) == {}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return run_case(request.param, CASES[request.param])


def test_lanes_match_jax(case):
    assert_lanes_match_jax(case)


def test_lanes_match_single_lane(case):
    assert_lanes_match_single_lane(case)


# ---- the simplex in lanes ---------------------------------------------------


def _t(v):
    return torch.as_tensor(np.array(v))


def _stack(lanes):
    return [torch.stack([_t(lane[k]) for lane in lanes]) for k in range(len(lanes[0]))]


def _primal_lane(seed, kind, n=12, m=7):
    """tests/test_torch_simplex.py's random LP with n structural columns
    and m rows: "degenerate" pins rows 1-3 at their starting activity (each
    pivot through them moves nothing, so the stall count passes
    bland_after), "unbounded" frees every row."""
    A_rows, row_lb, row_ub, col_lb, col_ub, c = _random_lp(seed, n=n, m=m)
    if kind == "degenerate":
        rest = np.where(np.abs(col_lb) <= np.abs(col_ub), col_lb, col_ub)
        act = A_rows @ np.where(np.isfinite(rest), rest, 0.0)
        row_lb[1:4] = row_ub[1:4] = act[1:4]
    elif kind == "unbounded":
        row_lb[:], row_ub[:] = -np.inf, np.inf
    return _lp(A_rows, row_lb, row_ub, col_lb, col_ub, c)


PRIMAL_LANES = ((1, "random"), (7, "random"), (2, "random"), (1, "degenerate"),
                (6, "degenerate"), (3, "unbounded"))
PRIMAL_KW = dict(max_iterations=13, refactor_every=4, bland_after=2)
# lanes whose pivots part from the single-lane call at a rounding tie: in a
# degenerate ratio test several rows sit at t = 0 to within the last bit of
# xB, which the lanes' products round otherwise (certified by _degenerate_tie)
PRIMAL_TIES = {4: "pivot 2 leaves another of the rows pinned at t = 0"}


def _assert_lane(lanes, b, alone, tol=1e-12):
    for key in ("state", "iterations", "basis", "status"):
        assert torch.equal(getattr(lanes, key)[b], getattr(alone, key)), (b, key)
    for key in ("x", "duals", "reduced_costs", "obj"):
        if hasattr(alone, key):
            np.testing.assert_allclose(getattr(lanes, key)[b].numpy(), getattr(alone, key).numpy(),
                                       rtol=0, atol=tol, err_msg=f"lane {b} {key}")


def _degenerate_tie(lanes, b, kw):
    """Certify that lane ``b`` parts from its single-lane call at a
    degenerate pivot: at the first pivot cap k where the bases part, both
    sides' pivot k moved nothing (x and the objective as after k - 1
    pivots, to 1e-12), both end in the same state with the same pivot
    count, and without the cap both reach the same optimal objective."""
    def both(**extra):
        args = dict(kw, **extra)
        batched = torch.func.vmap(lambda *a: ts.solve(*a, **args))(*_stack(lanes))
        return pb.lane(batched, b), ts.solve(*(_t(v) for v in lanes[b]), **args)

    k = next(k for k in range(1, kw["max_iterations"] + 1)
             if not torch.equal(*(r.basis for r in both(max_iterations=k))))
    before = both(max_iterations=k - 1)[1]
    for side in both(max_iterations=k):
        assert float((side.x - before.x).abs().max()) <= 1e-12, k
        assert abs(float(side.obj - before.obj)) <= 1e-12, k
    capped = both()
    assert int(capped[0].state) == int(capped[1].state)
    assert int(capped[0].iterations) == int(capped[1].iterations)
    free = both(max_iterations=500)
    assert [int(r.state) for r in free] == [ts.OPTIMAL] * 2
    assert abs(float(free[0].obj - free[1].obj)) <= 1e-9
    return k


def test_simplex_solve_lanes_match_single_lane():
    lanes = [_primal_lane(seed, kind) for seed, kind in PRIMAL_LANES]
    batched = torch.func.vmap(lambda *a: ts.solve(*a, **PRIMAL_KW))(*_stack(lanes))
    for b, lane in enumerate(lanes):
        if b in PRIMAL_TIES:
            assert _degenerate_tie(lanes, b, PRIMAL_KW) == 2
            continue
        alone = ts.solve(*(_t(v) for v in lane), **PRIMAL_KW)
        _assert_lane(batched, b, alone)
    iters, states = batched.iterations.tolist(), batched.state.tolist()
    assert len(set(iters)) >= 4 and max(iters) > 2 * PRIMAL_KW["refactor_every"], iters
    assert states.count(ts.ITERATION_LIMIT) >= 1 and states.count(ts.OPTIMAL) >= 3, states
    assert states[-1] == ts.UNBOUNDED, states
    # the degenerate lanes run under Bland's rule: without it they pivot otherwise
    for b in (3, 4):
        devex = ts.solve(*(_t(v) for v in lanes[b]), **dict(PRIMAL_KW, bland_after=100))
        assert not (torch.equal(devex.basis, batched.basis[b])
                    and int(devex.iterations) == iters[b]), b


def _dual_lane(seed, shrink, infeasible=False, n=10, m=6):
    """tests/test_torch_simplex.py's dual-stage LP: the optimal basis of a
    random LP, then its columns' bounds times ``shrink`` and its rows' times
    0.1; ``infeasible`` pins row 0 beyond the reach of the columns (the
    dual ratio test then runs out of entering columns: DUAL_STALL)."""
    rng = np.random.default_rng(seed)
    A_rows = rng.standard_normal((m, n))
    c = rng.standard_normal(n)
    wide = np.abs(A_rows) @ np.ones(n) + 0.5
    A, cc, lb, ub, basis, status = _lp(A_rows, -wide, wide, -np.ones(n), np.ones(n), c)
    opt = ts.solve(*(_t(v) for v in (A, cc, lb, ub, basis, status)), max_iterations=500)
    lb, ub = lb.copy(), ub.copy()
    lb[:n] *= shrink
    ub[:n] *= shrink
    lb[n:] *= 0.1
    ub[n:] *= 0.1
    if infeasible:
        lb[n] = ub[n] = 3.0 * np.abs(A_rows[0]).sum()
    return A, cc, lb, ub, opt.basis.numpy(), opt.status.numpy()


DUAL_LANES = ((11, 0.4, False), (18, 0.4, False), (13, 0.4, False), (12, 0.1, False),
              (12, 0.4, True), (11, 0.4, True))
DUAL_KW = dict(max_iterations=8, refactor_every=4, bland_after=1)


def test_solve_dual_lanes_match_single_lane():
    lanes = [_dual_lane(*spec) for spec in DUAL_LANES]
    batched = torch.func.vmap(lambda *a: ts.solve_dual(*a, **DUAL_KW))(*_stack(lanes))
    for b, lane in enumerate(lanes):
        _assert_lane(batched, b, ts.solve_dual(*(_t(v) for v in lane), **DUAL_KW))
    iters, states = batched.iterations.tolist(), batched.state.tolist()
    assert len(set(iters)) >= 4 and max(iters) > DUAL_KW["refactor_every"], iters
    assert {ts.OPTIMAL, ts.DUAL_STALL, ts.ITERATION_LIMIT} <= set(states), states


def test_polish_full_precision_lanes_match_single_lane():
    """float32 pivots on each lane, then the float64 finish in lanes; in the
    last lane's float64 data a basic column of the float32 basis is NaN, so
    its dual stage ends DUAL_STALL and the lane takes refine_result's
    zeroed ITERATION_LIMIT."""
    lanes = [_primal_lane(seed, kind) for seed, kind in PRIMAL_LANES[:5]]
    res32 = [ts.solve(*(_t(np.asarray(v, np.float32)) for v in lane[:4]), _t(lane[4]),
                      _t(lane[5]), max_iterations=500) for lane in lanes]
    data64 = [list(lane[:4]) for lane in lanes]
    A = data64[-1][0] = data64[-1][0].copy()
    A[:, int(res32[-1].basis[1])] = np.nan
    res32_lanes = ts.SimplexResult(*(torch.stack(f) for f in zip(*res32)))

    def polish(A, c, lb, ub, res):
        return ts.polish_full_precision(A, c, lb, ub, res, max_iterations=500)

    batched = vmap_lanes(polish, *_stack(data64), res32_lanes)
    assert isinstance(batched, ts.SimplexResult)
    for b in range(len(lanes)):
        _assert_lane(batched, b, polish(*(_t(v) for v in data64[b]), res32[b]))
    dual = [int(ts.solve_dual(*(_t(v) for v in data64[b]), res32[b].basis, res32[b].status,
                              max_iterations=500).state) for b in range(len(lanes))]
    assert dual == [ts.OPTIMAL] * (len(lanes) - 1) + [ts.DUAL_STALL], dual
    assert batched.state.tolist() == [ts.OPTIMAL] * (len(lanes) - 1) + [ts.ITERATION_LIMIT]


@pytest.mark.parametrize("fn", ["solve", "solve_dual"])
def test_lanes_outside_first_do_not_pivot(fn):
    """A lane left out of ``first`` keeps its starting basis, makes no pivot
    and ends ITERATION_LIMIT, though it would pivot; the lanes in it run as
    a batch of them alone does, field for field and trip for trip."""
    if fn == "solve":
        lanes, kw = [_primal_lane(seed, kind) for seed, kind in PRIMAL_LANES], PRIMAL_KW
    else:
        lanes, kw = [_dual_lane(*spec) for spec in DUAL_LANES], DUAL_KW
    call = getattr(ts, fn)
    first = np.array([True, True, False, True, False, True])
    full = torch.func.vmap(lambda *a: call(*a, **kw))(*_stack(lanes))
    with chip_smoke.LpTrips() as alone:
        kept = torch.func.vmap(lambda *a: call(*a, **kw))(
            *_stack([lane for lane, f in zip(lanes, first) if f]))
    with chip_smoke.LpTrips() as trips:
        batched = torch.func.vmap(lambda f, *a: call(*a, first=f, **kw))(
            torch.as_tensor(first), *_stack(lanes))
    assert (trips.loops, trips.trips) == (alone.loops, alone.trips), (trips.trips, alone.trips)
    for k, b in enumerate(np.flatnonzero(first).tolist()):
        for key in kept._fields:
            assert torch.equal(getattr(batched, key)[b], getattr(kept, key)[k]), (b, key)
    for b in np.flatnonzero(~first).tolist():
        assert int(full.iterations[b]) > 0, b  # it would pivot
        assert int(batched.iterations[b]) == 0 and int(batched.state[b]) == ts.ITERATION_LIMIT
        assert torch.equal(batched.basis[b], _t(lanes[b][4]).to(torch.int32)), b
        assert torch.equal(batched.status[b], _t(lanes[b][5]).to(torch.int8)), b


# ---- the Cauchy LP layer in lanes ---------------------------------------------


def _hs118_lp_lanes():
    """Cauchy LPs of hs118's single-lane solve, as (iterate, radius,
    penalty, saved basis) per lane: the states after iterations 0, 1, 2,
    3, 4 and 6 (no saved basis; a primal-feasible one; the dual stage; the
    dual stage and the reduced re-solve; six dual pivots, cut by a cap of
    2; the reduced re-solve alone), and state 3 with a structurally valid
    but singular saved basis (the slack s+ and the logical w of row 0, both
    basic: +e_0 and -e_0)."""
    tp, x0, _ = get_problem("hs118", "cpu")
    states = [initial_state(tp, Settings(), x0, device="cpu")]
    for _ in range(6):
        states.append(perform_iteration(tp, Settings(), states[-1]))
    picked = [states[k] for k in (0, 1, 2, 3, 4, 6)]
    lanes = [(s.it, s.lp_trust_radius, s.penalty, s.basis) for s in picked]
    n, m = tp.num_variables, tp.num_cons
    N = n + 3 * m
    basis = n + torch.arange(m, dtype=torch.int32)
    basis[1] = n + 2 * m  # w_0 beside s+_0
    status = torch.full((N,), int(BaseStat.LOWER), dtype=torch.int8)
    status[basis.long()] = int(BaseStat.BASIC)
    singular = CauchyBasis(basis=basis, status=status, valid=torch.ones((), dtype=torch.bool))
    s3 = states[3]
    lanes.append((s3.it, s3.lp_trust_radius, s3.penalty, singular))
    assert not bool(states[0].basis.valid)
    assert torch.equal(empty_basis(n, m).status, states[0].basis.status)
    return tp, lanes


class Branches:
    """Records, on a single-lane call, which sides of the Cauchy LP's
    branches ran: the dual stage's state, whether the reduced re-solve
    ran, and the warm start's basis."""

    def __init__(self, monkeypatch, columns):
        self.log, self.columns = {}, columns
        real_dual, real_solve, real_warm = (ts.solve_dual, ts.solve, cauchy._try_warm_basis)

        def dual(*a, **k):
            out = real_dual(*a, **k)
            self.log.setdefault("dual", int(out.state))  # the warm start's, not the polish's
            return out

        def primal(*a, **k):
            if a[0].shape[1] != self.columns:  # the reduced LP: [d, w]
                self.log["reduced"] = True
            return real_solve(*a, **k)

        def warm(*a, **k):
            out = real_warm(*a, **k)
            self.log["warm"] = out
            return out

        monkeypatch.setattr(ts, "solve_dual", dual)
        monkeypatch.setattr(ts, "solve", primal)
        monkeypatch.setattr(cauchy, "_try_warm_basis", warm)


@pytest.mark.parametrize("compute_dtype", [None, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("max_iterations", [-1, 2], ids=["uncapped", "cap2"])
def test_cauchy_lp_lanes_match_single_lane(compute_dtype, max_iterations, monkeypatch):
    tp, lanes = _hs118_lp_lanes()

    def one(it, radius, penalty, saved):
        return cauchy.solve_cauchy_lp(tp.data, it, radius, penalty, saved,
                                      max_iterations=max_iterations, compute_dtype=compute_dtype)

    stacked = [pb.stack_lanes([pb.tree_map(lambda a: a[None], lane[k]) for lane in lanes])
               for k in range(4)]
    batched = vmap_lanes(one, *stacked)
    branches = Branches(monkeypatch, tp.num_variables + 3 * tp.num_cons)
    seen = []
    for b, lane in enumerate(lanes):
        branches.log = {}
        alone = one(*lane)
        seen.append(dict(branches.log))
        got, want = chip_smoke.flat_fields(pb.lane(batched, b)), chip_smoke.flat_fields(alone)
        assert torch_dense.mismatches(got, want, 1e-12) == {}, b
    monkeypatch.undo()
    # every branch of the warm start, and both sides of the reduced re-solve
    valid = [bool(lane[3].valid) for lane in lanes]
    assert not valid[0] and all(valid[1:])
    use_dual = [log["warm"][2] is not False and bool(log["warm"][2]) for log in seen]
    kept = [torch.equal(log["warm"][0], lane[3].basis) for log, lane in zip(seen, lanes)]
    assert kept[1] and not use_dual[1]  # primal feasible: the saved basis as it is
    assert use_dual[2] and use_dual[3] and use_dual[4]
    assert not use_dual[-1] and not kept[-1]  # singular: the crash repair
    duals = [log.get("dual") for log in seen]
    assert duals[2] == ts.OPTIMAL  # one dual pivot
    if max_iterations == 2:
        assert duals[4] == ts.ITERATION_LIMIT  # six pivots capped at 2: the crash fallback
    else:
        assert duals[3] == duals[4] == ts.OPTIMAL
    reduced = [log.get("reduced", False) for log in seen]
    if compute_dtype is None and max_iterations < 0:
        assert reduced[3] and reduced[5] and not reduced[2] and not reduced[0], reduced


def test_host_reads_do_not_grow_with_lanes():
    """hs118's first four lanes alone and sixteen times over read equally
    often; one lane's eager loop (``solve_from``) reads as the single-lane
    loop did (LANE_READS), and so does HS71 on the simplex; ``solve``
    (``solve_jit``) no more."""
    tp, _, _ = get_problem("hs118", "cpu")
    x0b = chip_smoke.lp_starts("hs118", 4)
    reads = {}
    for copies in (1, 16):
        with HostReads() as counter:
            out = pb.batched_solve(tp, Settings(), np.tile(x0b, (copies, 1)), MAX_IT, device="cpu")
        reads[4 * copies] = counter.count
        assert np.all(out.status.numpy() == Status.OPTIMAL)
    assert reads[4] == reads[64] > 0, reads
    for name, (problem, settings, x0) in {
            "hs118": (tp, Settings(), x0b[0]),
            "hs71": (torch_dense.hs71()[1], HS71[1], np.array([1.0, 5.0, 5.0, 1.0])),
    }.items():
        with HostReads() as counter:
            out = solve_from(problem, settings, initial_state(problem, settings, x0, device="cpu"),
                             MAX_IT)
        assert int(out.status) == Status.OPTIMAL
        assert counter.count == LANE_READS[name], (name, counter.count)
        with HostReads() as counter:
            graph = solve(problem, settings, x0, MAX_IT, device="cpu")
        assert counter.count <= LANE_READS[name] and torch.equal(graph.it.x, out.it.x), name
