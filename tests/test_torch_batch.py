"""Port parity of the batched dense solve: sleqp_tpu_torch.parallel.batch
against sleqp_tpu.parallel.batch on tests/test_misc.py's batched solves
(HS71 with B = 8, Rosenbrock with 4 lanes of mixed difficulty), lane by
lane, and each lane against the port's own single-lane solve.

* Against JAX: statuses equal, iterations within 3, x within 1e-8.
* Against the port's single-lane ``solve``: the same status and
  iterations and x within 1e-9, but for the lanes named in ``TIES``: the
  batched products sum in another order than the single lane's
  (``x @ x`` of HS71's second constraint differs by 7e-15 at the start),
  and on a tie lane such a rounding flips a decision.  A tie is told from
  a fault as in the other parity tests: one batched iteration from each
  state of the single-lane solve gives its next state to 1e-9
  (``torch_dense.step_mismatches``); the tie lane then ends with the same
  status within 3 iterations, x within the solve's 1e-6.  HS71's lane 6
  is such a tie: the port's single lane takes 6 iterations, its batched
  lane 7, as JAX's batched lane does.
* One ``batched_step`` from JAX's batched states equals JAX's
  ``batched_step`` to 1e-9 on every lane but the (iteration, lane) pairs
  named in ``STEP_TIES``, each checked as the kind of tie it names; on
  the "noise" pairs x, status and penalty still equal JAX's to 1e-9 and
  the trust radius stays within the gap recorded beside the pair.
* The host reads of a batched solve do not grow with B (B = 4 and 64).
* The lockstep helper (``lanes.py``) and the GLTR and CG lanes directly:
  each lane of a vmapped Krylov solve, stopping at its own Lanczos or CG
  step, against the single-lane solve of the same data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import sleqp_tpu.problem_solver as jps
import torch_dense
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.parallel import batch as jbatch
from sleqp_tpu_torch import Settings, Status, solve
from sleqp_tpu_torch.convert import tree_from_numpy
from sleqp_tpu_torch.lanes import lanes_any, lockstep
from sleqp_tpu_torch.ops.gltr import gltr
from sleqp_tpu_torch.ops.kkt import aug_jac_create
from sleqp_tpu_torch.ops.tr_cg import steihaug_cg
from sleqp_tpu_torch.parallel import batch as pb
from sleqp_tpu_torch.problem_solver import SolverState, perform_iteration
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# lanes that part from the port's single-lane solve by a rounding tie
TIES = {"hs71": {6: "6 iterations alone, 7 in the batch (JAX's batched lane: 7)"},
        "rosenbrock": {}}
# lanes whose x parts from JAX's batched lane by more than 1e-8 (held to the
# solve's 1e-6): JAX's jitted iteration parts from JAX without jit, which
# the port follows (test_batched_step_matches_jax)
JAX_TIES = {"hs71": {5: "x 3.2e-8 apart", 6: "x 4.3e-9 apart; jitted JAX fails the EQP "
                     "step of its first iteration"}, "rosenbrock": {}}
# (iteration, lane) of JAX's HS71 B = 8 solve where the port's batched_step
# parts from JAX's, and the kind of tie:
# * "jit": jitted JAX parts from JAX's own iteration without jit, which the
#   port's lane equals;
# * "port": the port's lane equals the port's single-lane iteration, which
#   parts from JAX's (a tie of the dense iteration itself);
# * "noise": null(A_W) is (nearly) {0}, so P g is rounding noise that GLTR
#   follows to another length; the step is rejected in both packages, so
#   x, status and penalty equal JAX's to 1e-9, and only what the step's
#   length moves parts: the failed-step count, the reductions and their
#   ratio, the step's measures, and the trust radius (half the rejected
#   step's norm), held to the gap from JAX's recorded in NOISE_RADIUS_GAP.
STEP_TIES = {(0, 6): "jit", (1, 3): "noise", (1, 5): "port", (1, 6): "port", (4, 7): "noise",
             (5, 6): "noise"}
NOISE_FIELDS = ("num_failed_eqp", "trust_radius", "last_model_reduction",
                "last_exact_reduction", "last_reduction_ratio", "measure.")
# |trust_radius - JAX's| after each "noise" pair (measured: 0, 2.512e-5 of
# 0.02659, 9.520e-5 of 0.01331)
NOISE_RADIUS_GAP = {(1, 3): 0.0, (4, 7): 2.52e-5, (5, 6): 9.53e-5}


def hs71_starts():
    """tests/test_misc.py::test_batched_independent_solves's starts."""
    _, x0, x_opt = fixtures.hs71_problem()
    rng = np.random.default_rng(0)
    return np.clip(np.asarray(x0)[None, :] + rng.uniform(-0.1, 0.1, (8, 4)), 1.0, 5.0), x_opt


ROSENBROCK_STARTS = np.array([[0.0, 0.0], [0.9, 0.8], [-1.0, 1.0], [1.0, 1.0]])


def _case(name):
    if name == "hs71":
        jp, tp, _ = torch_dense.hs71()
        x0b, _ = hs71_starts()
        return jp, tp, x0b, 100
    jp, tp, _ = torch_dense.rosenbrock()
    return jp, tp, ROSENBROCK_STARTS, 200


@pytest.fixture(scope="module", params=["hs71", "rosenbrock"])
def case(request):
    """One compiled JAX batched solve per case, and the port's batched and
    single-lane solves of the same starts."""
    name = request.param
    jp, tp, x0b, max_it = _case(name)
    ref = torch_dense.jax_to_numpy(jbatch.batched_solve(jp, JaxSettings(), jnp.asarray(x0b),
                                                        max_iterations=max_it))
    out = pb.batched_solve(tp, Settings(), x0b, max_it, device="cpu")
    single = [solve(tp, Settings(), x0b[b], max_it, device="cpu") for b in range(len(x0b))]
    return dict(name=name, tp=tp, x0b=x0b, max_it=max_it, ref=ref, out=out, single=single)


def test_lanes_match_jax(case):
    ref, out = case["ref"], case["out"]
    np.testing.assert_array_equal(out.status.numpy(), ref.status)
    assert np.all(out.status.numpy() == Status.OPTIMAL)
    np.testing.assert_allclose(out.iteration.numpy(), ref.iteration, atol=3)
    ties = JAX_TIES[case["name"]]
    dx = np.abs(out.it.x.numpy() - ref.it.x).max(axis=1)
    assert {b for b in range(len(dx)) if dx[b] > 1e-8} <= set(ties), dx
    assert np.all(dx <= 1e-6), dx
    assert out.it.x.shape == (len(case["x0b"]), case["tp"].num_variables)
    if case["name"] == "rosenbrock":
        # started at the optimum vs far away (tests/test_misc.py)
        assert int(out.iteration[3]) < int(out.iteration[0])
    else:
        _, x_opt = hs71_starts()
        np.testing.assert_allclose(out.it.x.numpy(), np.tile(x_opt, (8, 1)), atol=1e-4)


def test_lanes_match_single_lane(case):
    out, ties = case["out"], TIES[case["name"]]
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
        states = torch_dense.single_lane_states(case["tp"], Settings(), case["x0b"][b], case["max_it"])
        assert torch_dense.tie_mismatches(case["tp"], Settings(), states, len(case["x0b"])) == {}


def test_batched_step_matches_jax():
    """One batched_step from each of JAX's batched states (its HS71 B = 8
    solve) against JAX's batched_step."""
    jp, tp, _ = torch_dense.hs71()
    x0b, _ = hs71_starts()
    settings = JaxSettings()
    step = jax.jit(lambda s: jbatch.batched_step(jp, settings, s))
    states = [jbatch.batched_initial_state(jp, settings, jnp.asarray(x0b))]
    for _ in range(7):
        states.append(step(states[-1]))
    parted = set()
    for k, (before, after) in enumerate(zip(states[:-1], states[1:])):
        port = tree_from_numpy(SolverState, torch_dense.jax_to_numpy(before), device="cpu",
                               lanes=8)
        got = pb.batched_step(tp, Settings(), port, device="cpu")
        for b in range(8):
            ref = jax.tree_util.tree_map(lambda a: np.asarray(a)[b], after)
            got_b = torch_dense.flat_port(pb.lane(got, b))
            if not torch_dense.step_mismatches(got_b, torch_dense.flat_jax(ref)):
                continue
            parted.add((k, b))
            kind = STEP_TIES.get((k, b))
            if kind == "noise":
                other = torch_dense.flat_jax(ref)
                gap = abs(float(got_b["trust_radius"]) - float(other["trust_radius"]))
                assert gap <= NOISE_RADIUS_GAP[(k, b)] + 1e-9, (k, b, gap)
            elif kind == "jit":
                with jax.disable_jit():
                    other = torch_dense.flat_jax(jps.perform_iteration(
                        jp, settings, jax.tree_util.tree_map(lambda a: a[b], before)))
            else:
                other = torch_dense.flat_port(perform_iteration(tp, Settings(),
                                                                pb.lane(port, b)))
            diff = torch_dense.step_mismatches(got_b, other)
            allowed = NOISE_FIELDS if kind == "noise" else ()
            assert all(key.startswith(allowed) for key in diff), (k, b, kind, diff)
    assert parted == set(STEP_TIES), parted


class HostReads:
    """Counts the host reads of tensors (truth values, items, lists,
    Python numbers) while active."""

    NAMES = ("__bool__", "item", "tolist", "__int__", "__float__")

    def __enter__(self):
        self.count = 0
        self._saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def counted(fn):
            def read(t, *args, **kwargs):
                self.count += 1
                return fn(t, *args, **kwargs)
            return read

        for n, fn in self._saved.items():
            setattr(torch.Tensor, n, counted(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(torch.Tensor, n, fn)


def test_host_reads_do_not_grow_with_lanes():
    """The same four lanes, alone and sixteen times over: one read a
    lockstep trip for all lanes, so the reads of the solve are equal."""
    _, tp, _ = torch_dense.hs71()
    x0b, _ = hs71_starts()
    reads = {}
    for copies in (1, 16):
        x = np.tile(x0b[:4], (copies, 1))
        with HostReads() as counter:
            out = pb.batched_solve(tp, Settings(), x, 100, device="cpu")
        reads[len(x)] = counter.count
        assert np.all(out.status.numpy() == Status.OPTIMAL)
    assert reads[4] == reads[64] and reads[4] > 0, reads


def test_lockstep_helper():
    """Lanes of different trip counts: each lane's result is the
    single-lane loop's, a frozen lane keeps its state although the body
    would give it NaN (0 * inf: the select takes nothing from the side it
    drops), and the reads are one a trip for all lanes."""
    limit = 5.0

    def run(x):
        def body(s, trip):
            # at x == limit (a finished lane) 1 / (limit - x) is inf
            return s + 1.0 + 0.0 * (1.0 / (limit - s))

        return lockstep(lambda s: s < limit, body, x, max_trips=100)

    x0 = torch.tensor([0.0, 3.0, 5.0, 4.5, 7.0], dtype=torch.float64)
    with HostReads() as counter:
        lanes = torch.func.vmap(run)(x0)
    np.testing.assert_array_equal(lanes.numpy(), [5.0, 5.0, 5.0, 5.5, 7.0])
    assert counter.count == 6  # five trips of the slowest lane, one final read
    for b in range(len(x0)):
        with HostReads() as one:
            alone = run(x0[b])
        assert float(alone) == float(lanes[b])
        assert one.count == max(int(np.ceil(limit - float(x0[b]))), 0) + 1
    # max_trips ends the loop without a read; first=True skips the first read
    with HostReads() as counter:
        capped = torch.func.vmap(
            lambda x: lockstep(lambda s: s < limit, lambda s, t: s + 1.0, x, max_trips=2,
                               first=True))(x0)
    # trip 0 on every lane, trip 1 on the lanes still below the limit
    np.testing.assert_array_equal(capped.numpy(), [2.0, 5.0, 6.0, 5.5, 8.0])
    assert counter.count == 1
    assert lanes_any(torch.func.vmap(lambda x: x > 6.0)(x0).any()) is True


def _krylov_lanes(seed, n=6, m=2, lanes=5):
    """Per-lane Krylov data: symmetric (some indefinite) Hessians, a
    working set, gradients (lane 0's zero: GLTR's trivial case) and radii."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((lanes, n, n))
    H = 0.5 * (H + np.swapaxes(H, 1, 2)) + np.array([4, 4, 0, -1, 6])[:, None, None] * np.eye(n)
    J = rng.standard_normal((lanes, m, n))
    g = rng.standard_normal((lanes, n))
    g[0] = 0.0
    var_states = np.zeros((lanes, n), np.int8)
    var_states[:, 1] = 1
    cons_states = np.zeros((lanes, m), np.int8)
    cons_states[1::2, 0] = 3
    radius = np.array([1.0, 0.3, 5.0, 2.0, 0.05])
    return [torch.as_tensor(a) for a in (H, J, g, var_states, cons_states, radius)]


@pytest.mark.parametrize("solver", [gltr, steihaug_cg], ids=["gltr", "cg"])
def test_krylov_lanes_match_single_lane(solver):
    data = _krylov_lanes(11)

    def one(H, J, g, vs, cs, radius):
        aj = aug_jac_create(J, vs, cs)
        res = solver(lambda d: H @ d, aj, g, radius, max_iterations=20)
        return res.step, res.iterations, res.on_boundary, res.min_rayleigh, res.max_rayleigh

    lanes = torch.func.vmap(one)(*data)
    iters = lanes[1].tolist()
    assert len(set(iters)) > 1, iters  # the lanes stop at different steps
    for b in range(len(iters)):
        alone = one(*(a[b] for a in data))
        assert int(alone[1]) == iters[b] and bool(alone[2]) == bool(lanes[2][b])
        for k in (0, 3, 4):
            np.testing.assert_allclose(lanes[k][b].numpy(), alone[k].numpy(), rtol=0,
                                       atol=1e-12)
        assert torch.isfinite(lanes[0][b]).all()


def test_other_routes_raise():
    """Routes the batched solve does not run raise NotImplementedError
    naming their ROADMAP.md item."""
    from sleqp_tpu_torch import HessEval, LPSolver, ParametricCauchy
    from sleqp_tpu_torch.dyn import DynFunc
    from sleqp_tpu_torch.problem import Problem

    _, tp, _ = torch_dense.hs71()
    x0b, _ = hs71_starts()
    for settings in (Settings(lp_solver=LPSolver.SIMPLEX), Settings(lp_solver=LPSolver.PDLP),
                     Settings(hess_eval=HessEval.DAMPED_BFGS),
                     Settings(parametric_cauchy=ParametricCauchy.COARSE)):
        with pytest.raises(NotImplementedError, match="item 11c"):
            pb.batched_solve(tp, settings, x0b, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11b"):
        pb.batched_solve(tp, Settings(), x0b, restoration=True, device="cpu")
    _, lsq, _ = torch_dense.rosenbrock_lsq()
    with pytest.raises(NotImplementedError, match="item 11b"):
        pb.batched_solve(lsq, Settings(), np.zeros((2, 2)), device="cpu")
    dyn = DynFunc(lambda x, bound, w_f, w_c: ((x * x).sum(), x.new_zeros(0), bound * 0.0), 2)
    with pytest.raises(NotImplementedError, match="item 11c"):
        pb.batched_solve_mp(Problem(dyn, device="cpu"), Settings(), np.ones((2, 2)),
                            device="cpu")
    with pytest.raises(ValueError, match="x0_batch"):
        pb.batched_solve(tp, Settings(), x0b[0], device="cpu")
