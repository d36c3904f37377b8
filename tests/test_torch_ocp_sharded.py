"""Port parity of the sharded and batched structured paths: ``ocp_solve(mesh=)``
and ``parallel/batch.py::sharded_solve`` on 4 gloo ranks
(tests/torch_dist.py), and ``batched_ocp_solve`` with the batched inverses'
``register_vmap`` rule, against sleqp_tpu.

* ``ocp_solve(mesh=)`` at T = 19 (S padded to the chunk layout),
  tests/test_ocp.py's problem: the reference's sharded and unsharded
  solves reach OPTIMAL in as many iterations as the port's sharded solve,
  U within 1e-8 (tests/test_ocp.py::test_ocp_sharded_schur_matches_single_device).
  The ``"pallas"`` interiors (float64) and the mixed route (float32 S,
  the stage-Hessian inverses by the batched kernel) match the reference's
  sharded solve of the same route in iterations, U within 1e-8 and 1e-6;
  the ``"pallas"`` interiors also hold the port's unsharded ``"pallas"``
  solve to 1e-8, and the mixed route the port's unsharded mixed solve to
  OPTIMAL, the objective within 1e-6 relative and the iterations within
  3.  The dry run's swing-up instance (``__graft_entry__.py``, 2P + 3
  stages, u in [-0.6, 0.6]) equals the port's unsharded solve to 1e-12 in
  as many iterations (>= 5).
* The ranks' states agree bit for bit after every iteration (the loop's
  reads are replicated), and the step-by-step loop ends where
  ``ocp_solve(mesh=)`` does; two collectives a KKT solve.
* ``sharded_solve``: HS71 at 2 lanes a rank (``__graft_entry__.py``'s
  dry run) against the port's ``batched_solve`` (x within 1e-12, statuses
  and iterations equal) and the reference's ``sharded_solve`` on 4
  devices (statuses and the solved count equal, x within 1e-12 and the
  same iterations but on the lane named in ``SHARDED_TIES``); the
  ``psum``'d count equals the gathered one.
* ``batched_ocp_solve`` on tests/test_ocp.py::test_ocp_scenario_batch's
  three lanes, both routes: statuses and iterations as the reference's
  lanes, U within 1e-10 (float64) or 1e-6 (mixed); lane 0 equal to the
  port's single solve to 1e-10; the lanes differ.  Lanes that are copies
  of one start read the host and call the batched inverse as often as
  the single lane.
* The ``register_vmap`` rule of B1 and B2: the vmapped operator equals a
  loop of the plain version over the lanes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import fixtures
import test_ocp as jax_ocp_tests
import torch_dist
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.ocp import BlockStructuredProblem as JaxProblem
from sleqp_tpu.ocp import batched_ocp_solve as jax_batched_ocp_solve
from sleqp_tpu.ocp import ocp_solve as jax_ocp_solve
from sleqp_tpu.parallel.batch import sharded_solve as jax_sharded_solve
from sleqp_tpu_torch import Settings, Status, batched_ocp_solve, ocp_solve
from sleqp_tpu_torch.ops import cyclic_reduction as cr
from test_torch_batch import HostReads
from torch_parity import X_INIT, make_ocp_pair, no_jax_cache_writes, one_torch_thread  # noqa: F401
from torch_parity import spd_blocks

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P = 4
T19 = 19  # tests/test_ocp.py::test_ocp_sharded_schur_matches_single_device
CONSTS = dict(H_STEP=float(jax_ocp_tests.H_STEP), X_GOAL=np.asarray(jax_ocp_tests.X_GOAL).tolist(),
              X_INIT=np.asarray(jax_ocp_tests.X_INIT).tolist())
OCP_CASES = {
    "f64_auto": dict(problem="oscillator", num_stages=T19, route="same", backend="auto"),
    "f64_pallas": dict(problem="oscillator", num_stages=T19, route="same", backend="pallas"),
    "mixed_auto": dict(problem="oscillator", num_stages=T19, route="float32", backend="auto"),
    "swing_up": dict(problem="swing_up", num_stages=2 * P + 3, route="same", backend="auto"),
}
MAX_IT = {"oscillator": 50, "swing_up": 150}
SHARDED_BATCH = 2 * P
# lanes where the port's solve parts from the reference's by a rounding tie
# (the reference without jit takes the same 7 iterations), held to the
# solve's 1e-6; the port's batched lane is its single-lane solve
SHARDED_TIES = {4: "6 iterations in the port, 7 in the reference; x 2.9e-8 apart"}


def _hs71_batch():
    """__graft_entry__.py's dry-run batch: HS71's x0 jittered by 0.01 b."""
    _, x0, _ = fixtures.hs71_problem()
    return np.tile(np.asarray(x0)[None, :], (SHARDED_BATCH, 1)) + 0.01 * np.arange(
        SHARDED_BATCH)[:, None]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One group of four ranks runs every sharded case."""
    tmp = tmp_path_factory.mktemp("ocp_ranks")
    cases = [dict(kind="ocp", name=name, consts=CONSTS, max_iterations=MAX_IT[c["problem"]], **c)
             for name, c in OCP_CASES.items()]
    cases.append(dict(kind="sharded_solve", name="hs71", x0_batch=_hs71_batch().tolist(),
                      max_iterations=50))
    torch_dist.run_ranks(cases, tmp, world=P)
    return {c["name"]: torch_dist.load(tmp, c["name"], world=P) for c in cases}


def _fields(result, prefix):
    return {k[len(prefix) + 1:]: v for k, v in result.items() if k.startswith(prefix + ".")}


@pytest.mark.parametrize("name", list(OCP_CASES))
def test_ranks_agree(ranks, name):
    """Every rank ends with the same bits, and the loop stepped by hand
    (the ranks' states compared after every iteration) ends where
    ``ocp_solve(mesh=)`` does."""
    sharded = _fields(ranks[name][0], "sharded")
    for r in ranks[name]:
        for key, value in _fields(r, "sharded").items():
            np.testing.assert_array_equal(value, sharded[key], err_msg=key)
        for key, value in _fields(r, "stepped").items():
            np.testing.assert_array_equal(value, sharded[key], err_msg=key)
        assert float(r["collectives_per_kkt"]) == 2.0


def _jax_oscillator():
    return JaxProblem(jax_ocp_tests._dynamics, jax_ocp_tests._stage_cost, num_stages=T19,
                      num_states=2, num_controls=1, x0=jax_ocp_tests.X_INIT,
                      final_cost=jax_ocp_tests._final_cost)


def test_sharded_ocp_matches_jax(ranks):
    """The float64 route on T = 19 (S padded from 19 to 23 blocks):
    the reference's sharded and unsharded solves."""
    out = _fields(ranks["f64_auto"][0], "sharded")
    problem = _jax_oscillator()
    mesh = Mesh(np.array(jax.devices()[:P]), axis_names=("stages",))
    ref_sharded = jax_ocp_solve(problem, max_iterations=MAX_IT["oscillator"], mesh=mesh)
    ref = jax_ocp_solve(problem, max_iterations=MAX_IT["oscillator"])
    assert int(out["status"]) == int(ref.status) == int(ref_sharded.status) == Status.OPTIMAL
    assert int(out["iteration"]) == int(ref.iteration) == int(ref_sharded.iteration)
    np.testing.assert_allclose(out["U"], np.asarray(ref_sharded.U), atol=1e-8)
    np.testing.assert_allclose(out["U"], np.asarray(ref.U), atol=1e-8)


@pytest.mark.parametrize("name", ["f64_auto", "f64_pallas", "swing_up"])
def test_sharded_float64_matches_unsharded(ranks, name):
    out = _fields(ranks[name][0], "sharded")
    alone = _fields(ranks[name][0], "alone")
    assert int(out["status"]) == int(alone["status"]) == Status.OPTIMAL
    assert int(out["iteration"]) == int(alone["iteration"])
    tol = 1e-12 if name == "swing_up" else 1e-8
    np.testing.assert_allclose(out["U"], alone["U"], rtol=tol, atol=tol)
    if name == "swing_up":
        assert int(out["iteration"]) >= 5
        np.testing.assert_allclose(out["X"], alone["X"], rtol=tol, atol=tol)


def test_sharded_mixed_route_matches_unsharded(ranks):
    out = _fields(ranks["mixed_auto"][0], "sharded")
    alone = _fields(ranks["mixed_auto"][0], "alone")
    assert int(out["status"]) == int(alone["status"]) == Status.OPTIMAL
    assert float(out["feas_res"]) <= 1e-6 and float(out["stat_res"]) <= 1e-6
    assert abs(int(out["iteration"]) - int(alone["iteration"])) <= 3
    assert float(out["obj_val"]) == pytest.approx(float(alone["obj_val"]), rel=1e-6)


@pytest.mark.parametrize("name", ["f64_pallas", "mixed_auto"])
def test_sharded_routes_match_jax(ranks, name):
    """The ``"pallas"`` interiors and the mixed route on T = 19 against the
    reference's sharded solve of the same route on 4 devices (its Pallas
    kernels in interpret mode): OPTIMAL in as many iterations, U within
    1e-8 (float64) or 1e-6 (float32 S)."""
    case = OCP_CASES[name]
    out = _fields(ranks[name][0], "sharded")
    mesh = Mesh(np.array(jax.devices()[:P]), axis_names=("stages",))
    ref = jax_ocp_solve(_jax_oscillator(), JaxSettings(compute_dtype=case["route"]),
                        max_iterations=MAX_IT["oscillator"], mesh=mesh,
                        tridiag_backend=case["backend"])
    assert int(out["status"]) == int(ref.status) == Status.OPTIMAL
    assert int(out["iteration"]) == int(ref.iteration)
    tol = 1e-8 if case["route"] == "same" else 1e-6
    np.testing.assert_allclose(out["U"], np.asarray(ref.U), atol=tol)


def test_sharded_solve_matches_jax(ranks):
    results = ranks["hs71"]
    x0b = _hs71_batch()
    problem, _, _ = fixtures.hs71_problem()
    mesh = Mesh(np.array(jax.devices()[:P]), axis_names=("batch",))
    states, solved = jax.jit(lambda xb: jax_sharded_solve(problem, JaxSettings(), xb, mesh,
                                                          max_iterations=50))(jnp.asarray(x0b))
    per = SHARDED_BATCH // P
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["shard_x"], res["x"][r * per:(r + 1) * per])
        np.testing.assert_array_equal(res["x"], results[0]["x"])
        assert int(res["solved"]) == int(solved) == SHARDED_BATCH
        assert int(res["solved"]) == int((res["status"] == Status.OPTIMAL).sum())
    res = results[0]
    assert (res["status"] == np.asarray(states.status)).all()
    for b in range(SHARDED_BATCH):
        x, x_jax = res["x"][b], np.asarray(states.it.x)[b]
        if b in SHARDED_TIES:
            np.testing.assert_allclose(x, x_jax, atol=1e-6)
            assert abs(int(res["iteration"][b]) - int(states.iteration[b])) <= 1
        else:
            np.testing.assert_allclose(x, x_jax, rtol=1e-12, atol=1e-12)
            assert int(res["iteration"][b]) == int(states.iteration[b])
    np.testing.assert_allclose(res["x"], res["batched_x"], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(res["status"], res["batched_status"])
    np.testing.assert_array_equal(res["iteration"], res["batched_iteration"])


def _scenario_starts():
    """tests/test_ocp.py::test_ocp_scenario_batch's three initial states."""
    return np.stack([X_INIT, X_INIT + np.array([0.3, -0.1]), X_INIT * 0.5])


@pytest.mark.parametrize("route", ["same", "float32"])
def test_batched_ocp_solve_matches_jax(route):
    jp, tp = make_ocp_pair()
    x0s = _scenario_starts()
    out = batched_ocp_solve(tp, Settings(compute_dtype=route), x0s, max_iterations=60,
                            device="cpu")
    ref = jax_batched_ocp_solve(jp, JaxSettings(compute_dtype=route), jnp.asarray(x0s),
                                max_iterations=60)
    assert out.U.shape == (3, jax_ocp_tests.T, jax_ocp_tests.NU)
    assert (out.status == Status.OPTIMAL).all()
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(out.iteration.numpy(), np.asarray(ref.iteration))
    tol = 1e-10 if route == "same" else 1e-6
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U), atol=tol)
    single = ocp_solve(tp, Settings(compute_dtype=route), max_iterations=60, device="cpu")
    np.testing.assert_allclose(out.U[0].numpy(), single.U.numpy(), atol=1e-10)
    assert int(out.iteration[0]) == int(single.iteration)
    assert float((out.U[1] - out.U[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("route", ["same", "float32"])
def test_batched_ocp_reads_and_inverses_do_not_grow(route, monkeypatch):
    """Copies of one start: each lane is the single solve, and the batch
    reads the host and calls the batched inverse as often as one lane."""
    _, tp = make_ocp_pair(u_lb=-0.15, u_ub=0.15)  # saturated controls: Armijo trials
    settings = Settings(compute_dtype=route)
    calls = []
    plain = cr.bgj_flat_plain
    monkeypatch.setattr(cr, "bgj_flat_plain", lambda C: calls.append(C.shape[0]) or plain(C))
    counts = {}
    for lanes in (1, 5):
        calls.clear()
        with HostReads() as reads:
            if lanes == 1:
                out = ocp_solve(tp, settings, max_iterations=100, device="cpu")
            else:
                out = batched_ocp_solve(tp, settings, np.tile(X_INIT, (lanes, 1)),
                                        max_iterations=100, device="cpu")
        counts[lanes] = (reads.count, len(calls), sum(calls), out)
    single, batch = counts[1][3], counts[5][3]
    assert int(single.status) == Status.OPTIMAL and int(single.iteration) >= 3
    assert int(single.num_rejected) > 0  # iterations whose Armijo trials all failed
    assert (batch.iteration == single.iteration).all()
    np.testing.assert_allclose(batch.U.numpy(), single.U[None].expand(5, -1, -1).numpy(),
                               atol=1e-12)
    assert counts[5][0] == counts[1][0] > 0  # host reads
    assert counts[5][1] == counts[1][1]  # batched-inverse calls
    if route == "float32":
        assert counts[5][1] > 0 and counts[5][2] == 5 * counts[1][2]  # every lane's blocks


@pytest.mark.parametrize("wrapper,plain,k", [
    (cr.bgj_flat, cr.bgj_flat_plain, 3),
    (cr.bgj_flat, cr.bgj_flat_plain, 32),
    (cr.bgj_blocked64, cr.bgj_blocked64_plain, 64),
])
@pytest.mark.parametrize("lane_dim", [0, 1])
def test_vmap_rule_matches_plain_loop(wrapper, plain, k, lane_dim):
    lanes = torch.stack([torch.as_tensor(spd_blocks(5, k, seed=k + b), dtype=torch.float32)
                         for b in range(3)])
    got = torch.func.vmap(wrapper, in_dims=lane_dim, out_dims=lane_dim)(
        lanes.movedim(0, lane_dim).contiguous())
    want = torch.stack([plain(lanes[b]) for b in range(3)])
    assert torch.equal(got.movedim(lane_dim, 0), want)
    # nested: a batch of batches of lanes
    nested = torch.func.vmap(torch.func.vmap(wrapper))(lanes[None].expand(2, -1, -1, -1, -1))
    assert torch.equal(nested, want[None].expand(2, -1, -1, -1, -1))


def test_sharded_restoration_lanes_not_ported():
    """``sharded_solve(restoration=True)`` on a constrained problem raises
    naming ROADMAP.md item 11b, before it touches the mesh."""
    from sleqp_tpu_torch.parallel.batch import sharded_solve

    with pytest.raises(NotImplementedError, match="item 11b"):
        sharded_solve(torch_dist.hs71(), Settings(), _hs71_batch(), None, restoration=True,
                      device="cpu")


def test_dataclass_of_batched_state_has_lanes_first():
    _, tp = make_ocp_pair()
    out = batched_ocp_solve(tp, Settings(), _scenario_starts()[:2], max_iterations=5, device="cpu")
    for f in dataclasses.fields(out):
        assert getattr(out, f.name).shape[0] == 2, f.name
    with pytest.raises(ValueError, match="x0_batch"):
        batched_ocp_solve(tp, Settings(), X_INIT, device="cpu")
