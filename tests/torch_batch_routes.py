"""Shared pieces of the parity tests of the batched quasi-Newton, dynamic
and parametric routes (tests/test_torch_batch_{qn,dyn,parametric}.py).

A case is one batch of starts through JAX's
``sleqp_tpu.parallel.batch.batched_solve``, the port's ``batched_solve``
and the port's single-lane ``solve`` of every start:

* against JAX's lanes: the same status, iterations within 3, x within
  1e-8, but for the lanes a test names as JAX ties (held to the solve's
  1e-6);
* against the port's single lanes: the same status and iterations and x
  within 1e-12, but for the lanes a test names as single-lane ties (held
  to iterations within 3 and x within 1e-6).

A tie is certified on the trajectory it parts from (JAX's single-lane
states, or the port's): one batched iteration from each state gives the
next state until the first state where it parts, and there the parting
is a rounding decision (``chip_smoke.parting_kind``): the projected gradient P g of
the EQP step is rounding noise (``NOISE``, relative to g: the working
set pins every direction, and GLTR follows the noise), or the batched
and single-lane Newton steps agree to rounding and a test further
on (a linesearch against a bound the step's last bit decides) parts.
The lanes' products sum in another order than one lane's, which is where
the last bits come from.

The single-lane solves must also keep the bits and host reads they had
before their loops ran in lanes (``SEED_LANES``: the reads counted by
``test_torch_batch.HostReads``, the iterations and a digest of x's bytes).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import torch

import torch_dense
from sleqp_tpu.parallel import batch as jbatch
from chip_smoke import certified_tie
from sleqp_tpu_torch import Func, Problem, initial_state, solve
from sleqp_tpu_torch.parallel import batch as pb
from sleqp_tpu_torch.problem_solver import solve_from
from test_torch_batch import HostReads

# The single-lane solves of tests/test_torch_{quasi_newton,dyn,parametric}.py
# before the batched routes: (host reads, iterations, x's digest, ``digest``).
SEED_LANES = {
    "rosenbrock_DAMPED_BFGS": (405, 31, "b8d154aa89b690d4"),
    "rosenbrock_SR1": (501, 40, "26a9ad17b7a97c2e"),
    "rosenbrock_SIMPLE_BFGS": (405, 31, "4736abd7bbe46793"),
    "hs71_DAMPED_BFGS": (170, 8, "324e36fa61e523a5"),
    "hs71_SR1": (145, 8, "5def29969065147a"),
    "blocks_DAMPED_BFGS": (731, 51, "baf2c53e49446c5f"),
    "dyn_rosenbrock": (439, 29, "c1ef776d379f02bb"),
    "dyn_constrained": (66, 3, "253fcd2f69953b6b"),
    "quadcons_COARSE": (18, 1, "374708fff7719dd5"),
    "hs71_COARSE": (97, 5, "8cf20b2508f417f7"),
    "chainineq_COARSE": (596, 12, "3439a7dad014c62a"),
    "quadcons_FINE": (18, 1, "374708fff7719dd5"),
    "hs71_FINE": (106, 5, "8cf20b2508f417f7"),
    "chainineq_FINE": (732, 11, "02f34d0edab09e91"),
}


def spread_starts(x0, spread, seed, lanes=8):
    """x0 and x0 + U(-spread, spread) per coordinate from default_rng(seed),
    lane 0 at x0."""
    x0 = np.asarray(x0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    starts = x0[None, :] + rng.uniform(-spread, spread, (lanes, len(x0)))
    starts[0] = x0
    return starts


def two_rosenbrocks():
    """tests/test_quasi_newton.py's block-structured case: two independent
    2-d Rosenbrocks with a declared block-diagonal Hessian."""
    from sleqp_tpu import Func as JaxFunc
    from sleqp_tpu import Problem as JaxProblem

    def obj(x):
        return ((1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[2]) ** 2
                + 10.0 * (x[3] - x[2] ** 2) ** 2)

    blocks = ((0, 2), (2, 4))
    return (JaxProblem(JaxFunc(obj, num_variables=4, hess_struct=blocks)),
            Problem(Func(obj, num_variables=4, hess_struct=blocks), device="cpu"), np.zeros(4))


def run_case(jp, tp, jax_settings, settings, x0b, max_it):
    """JAX's batched solve, the port's batched solve and the port's
    single-lane solves of the rows of ``x0b``."""
    ref = torch_dense.jax_to_numpy(jbatch.batched_solve(jp, jax_settings, jnp.asarray(x0b),
                                                        max_iterations=max_it))
    out = pb.batched_solve(tp, settings, x0b, max_it, device="cpu")
    single = [solve(tp, settings, x, max_it, device="cpu") for x in x0b]
    return dict(jp=jp, tp=tp, jax_settings=jax_settings, settings=settings, x0b=x0b,
                max_it=max_it, ref=ref, out=out, single=single)


def assert_lanes_match_jax(case, jax_ties):
    ref, out = case["ref"], case["out"]
    np.testing.assert_array_equal(out.status.numpy(), ref.status)
    np.testing.assert_allclose(out.iteration.numpy(), ref.iteration, atol=3)
    dx = np.abs(out.it.x.numpy() - ref.it.x).max(axis=1)
    parted = {b for b in range(len(dx))
              if dx[b] > 1e-8 or int(out.iteration[b]) != int(ref.iteration[b])}
    assert parted == set(jax_ties), (dx, out.iteration, ref.iteration)
    assert np.all(dx <= 1e-6), dx
    for b in jax_ties:
        states = torch_dense.jax_states(case["jp"], case["jax_settings"], case["x0b"][b],
                                        limit=case["max_it"] + 1)
        states = [torch_dense.port_state(st) for st in states]
        assert certified_tie(case["tp"], case["settings"], states, len(case["x0b"])), b


def assert_lanes_match_single_lane(case, ties):
    out = case["out"]
    parted = {}
    for b, s in enumerate(case["single"]):
        assert int(out.status[b]) == int(s.status), b
        dx = float((out.it.x[b] - s.it.x).abs().max())
        if int(out.iteration[b]) != int(s.iteration) or dx > 1e-12:
            parted[b] = (int(out.iteration[b]), int(s.iteration), dx)
    assert set(parted) == set(ties), parted
    for b in ties:
        it_batch, it_single, dx = parted[b]
        assert abs(it_batch - it_single) <= 3 and dx <= 1e-6, parted[b]
        states = torch_dense.single_lane_states(case["tp"], case["settings"], case["x0b"][b],
                                                case["max_it"])
        assert certified_tie(case["tp"], case["settings"], states, len(case["x0b"])), b


def reads_of(fn):
    with HostReads() as counter:
        out = fn()
    return counter.count, out


def assert_reads_do_not_grow(tp, settings, x0b, max_it, solver=pb.batched_solve):
    """The host reads of a batched solve of ``x0b`` (B = 8) equal those of
    the same starts eight times over (B = 64), and every lane of the
    larger batch ends as its copy in the smaller one."""
    small, out8 = reads_of(lambda: solver(tp, settings, x0b, max_it, device="cpu"))
    large, out64 = reads_of(lambda: solver(tp, settings, np.tile(x0b, (8, 1)), max_it,
                                           device="cpu"))
    assert small == large and small > 0, (small, large)
    assert torch.equal(out64.status, out8.status.repeat(8))
    assert torch.equal(out64.iteration, out8.iteration.repeat(8))


def assert_seed_lane(key, tp, settings, x0, max_it):
    """One lane's eager loop (``solve_from``) keeps the seed's host reads
    and bits (SEED_LANES); ``solve`` (``solve_jit``) its bits, with no more
    reads."""
    s0 = initial_state(tp, settings, x0, device="cpu")
    reads, out = reads_of(lambda: solve_from(tp, settings, s0, max_it))
    seed_reads, seed_iterations, seed_x = SEED_LANES[key]
    assert (reads, int(out.iteration)) == (seed_reads, seed_iterations), (key, reads,
                                                                         int(out.iteration))
    assert digest(out.it.x) == seed_x, key
    graph_reads, graph = reads_of(lambda: solve(tp, settings, x0, max_it, device="cpu"))
    assert graph_reads <= seed_reads and int(graph.iteration) == seed_iterations, key
    assert digest(graph.it.x) == seed_x, key


def digest(x):
    """The first 16 hex digits of the SHA-256 of a float64 tensor's bytes."""
    return hashlib.sha256(x.to(torch.float64).numpy().tobytes()).hexdigest()[:16]
