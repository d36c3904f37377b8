"""Port parity of the batched solve with the parametric Cauchy sweep:
sleqp_tpu_torch.parallel.batch against sleqp_tpu.parallel.batch, and the
sweep under ``torch.func.vmap`` against its single-lane call.

* COARSE on hs118 (m = 17: the simplex re-solves the LP) from
  ``chip_smoke.lp_starts`` and FINE on HS71 (m = 2: enumeration) from
  tests/test_misc.py's starts, at B = 8: lanes against JAX's and against
  the port's single lanes as ``torch_batch_routes`` sets out.
* ``parametric_solve`` under ``vmap`` on hs118's first Cauchy LP, lanes
  of their own LP radius and curvature (the Hessian product a lane's
  multiple of the identity): lanes that go forward and stop at the cap
  (radius x 2^5 COARSE, x sqrt(2)^10 FINE), forward and stop short of it,
  forward with no gain, backtrack, and backtrack to the cap.  Each lane's
  result against the single-lane call: the radius exactly, the LP's
  result, the direction and the quadratic merit to 1e-12.
* ``multistart_solve`` and ``batched_step`` on this route.
* Host reads: equal at B = 8 and B = 64; one lane reads and ends as the
  single-lane solve did before the sweep ran in lanes (SEED_LANES: the
  cases of tests/test_torch_parametric.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_batch_routes as routes
import torch_dense
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.harness.hs import get_problem as jax_get_problem
from sleqp_tpu.types import ParametricCauchy as JaxParametricCauchy
from sleqp_tpu_torch import ParametricCauchy, Settings, Status, initial_state
from sleqp_tpu_torch.cauchy import solve_cauchy_lp
from sleqp_tpu_torch.harness.hs import get_problem
from sleqp_tpu_torch.lanes import vmap_lanes
from sleqp_tpu_torch.parallel import batch as pb
from sleqp_tpu_torch.parametric import parametric_solve
from test_torch_batch import hs71_starts
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {"hs118_COARSE": ("hs118", "COARSE", 200), "hs71_FINE": ("hs71", "FINE", 100)}


def _settings(mode):
    return (JaxSettings(parametric_cauchy=JaxParametricCauchy[mode]),
            Settings(parametric_cauchy=ParametricCauchy[mode]))


def _problem(name):
    if name == "hs71":
        jp, tp, _ = torch_dense.hs71()
        return jp, tp, hs71_starts()[0]
    return jax_get_problem(name)[0], get_problem(name, "cpu")[0], chip_smoke.lp_starts(name, 8)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name, mode, max_it = CASES[request.param]
    jp, tp, x0b = _problem(name)
    js, ts = _settings(mode)
    return dict(routes.run_case(jp, tp, js, ts, x0b, max_it), key=request.param)


def test_lanes_match_jax(case):
    routes.assert_lanes_match_jax(case, {})
    assert np.all(case["out"].status.numpy() == Status.OPTIMAL)


def test_lanes_match_single_lane(case):
    routes.assert_lanes_match_single_lane(case, {})


# ---- the sweep in lanes --------------------------------------------------------


# (LP radius, Hessian multiple of the identity) -> what the sweep does from
# hs118's start at penalty 10: the radius ratio COARSE, FINE
SWEEP_LANES = {
    (0.01, 0.0): ("forward to the cap", 32.0, 32.0),
    (1.0, 1.0): ("forward", 2.0, None),
    (3.0, 1.0): ("forward, no gain", 1.0, None),
    (0.5, 10.0): ("backtrack", 0.5, None),
    (0.5, 1e5): ("backtrack to the cap", 1 / 32, 1 / 32),
}


@pytest.mark.parametrize("mode", ["COARSE", "FINE"])
def test_sweep_lanes_match_single_lane(mode):
    tp, x0, _ = get_problem("hs118", "cpu")
    state = initial_state(tp, Settings(), x0, device="cpu")
    it, basis = state.it, state.basis
    penalty = torch.tensor(10.0, dtype=torch.float64)
    radii = torch.tensor([r for r, _ in SWEEP_LANES], dtype=torch.float64)
    curvature = torch.tensor([c for _, c in SWEEP_LANES], dtype=torch.float64)

    def sweep(radius, c):
        cres = solve_cauchy_lp(tp.data, it, radius, penalty, basis)
        return parametric_solve(ParametricCauchy[mode], tp.data, it, lambda d: c * d, penalty,
                                radius, cres, 0.1, 1e-10)

    lanes = vmap_lanes(sweep, radii, curvature)
    ratios = []
    for b, (key, (what, coarse, fine)) in enumerate(SWEEP_LANES.items()):
        alone = sweep(radii[b], curvature[b])
        got = torch_dense.flat_fields(pb.lane(lanes, b))
        assert not torch_dense.mismatches(got, torch_dense.flat_fields(alone), 1e-12), (key, what)
        assert float(lanes[1][b]) == float(alone[1]), (key, what)
        ratios.append(float(alone[1]) / key[0])
        expect = coarse if mode == "COARSE" else fine
        if expect is not None:
            assert ratios[-1] == pytest.approx(expect, rel=1e-12), (key, what, ratios[-1])
    # forward and backtracking lanes both ran
    assert max(ratios) > 1.0 and min(ratios) < 1.0, ratios


# ---- the other entry points ------------------------------------------------------


def test_multistart_and_batched_step():
    """multistart_solve on HS71 under FINE returns the best lane of its
    batch, and one batched_step from each state of a lane's single-lane
    solve gives the next."""
    _, tp, _ = torch_dense.hs71()
    _, ts = _settings("FINE")
    x0 = hs71_starts()[0][0]
    best = pb.multistart_solve(tp, ts, x0, num_starts=8, radius=0.5, seed=1,
                               max_iterations=100, device="cpu")
    starts = pb.multistart_starts(tp, x0, num_starts=8, radius=0.5, seed=1)
    lanes = pb.batched_solve(tp, ts, starts, 100, device="cpu")
    expect = pb.lane(lanes, pb.best_lane(lanes))
    assert int(best.status) == Status.OPTIMAL
    assert torch.equal(best.it.x, expect.it.x) and int(best.iteration) == int(expect.iteration)
    states = torch_dense.single_lane_states(tp, ts, x0, 100)
    assert torch_dense.tie_mismatches(tp, ts, states, 8) == {}


# ---- host reads -------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(CASES))
def test_host_reads_do_not_grow_with_lanes(key):
    name, mode, max_it = CASES[key]
    _, tp, x0b = _problem(name)
    routes.assert_reads_do_not_grow(tp, _settings(mode)[1], x0b, max_it)


SEED_PAIRS = {"quadcons": torch_dense.quadcons, "hs71": torch_dense.hs71,
              "chainineq": lambda: torch_dense.chainineq(20)}


@pytest.mark.parametrize("mode", ["COARSE", "FINE"])
@pytest.mark.parametrize("name", sorted(SEED_PAIRS))
def test_single_lane_keeps_seed_reads_and_bits(name, mode):
    """tests/test_torch_parametric.py's solves from their x0."""
    _, tp, x0 = SEED_PAIRS[name]()
    routes.assert_seed_lane(f"{name}_{mode}", tp, _settings(mode)[1], x0, 200)
