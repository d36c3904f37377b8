"""Port parity of the banded structured path: sleqp_tpu_torch/banded.py
against sleqp_tpu/banded.py on the CPU.

* the evaluations (obj, gradient, constraints, Jacobian and Hessian blocks,
  J^T lam) at N_b = 5, k = 4, q = 2 on both routes, to 1e-12 (float64) and
  1e-6 (float32 assembly);
* ``BandedCauchyOp`` against JAX's and against the dense [J, I, -I, -I];
  ``banded_cauchy``: the same PDLP iterations, step and working set;
* ``_kkt_solve`` on both routes and ``_block_bfgs_push``;
* one port iteration from every JAX iterate, optimality and restoration:
  every integer and boolean field of ``BandedState`` exactly, every float
  to ITER_TOL;
* the whole solves of tests/test_banded.py's tier-1 cases: status and
  iterations equal to JAX's, X to 1e-6.

Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_banded as jtests
from sleqp_tpu import Settings as JSettings
from sleqp_tpu import banded as jb
from sleqp_tpu.types import HessEval as JHessEval
from sleqp_tpu_torch import Func, Problem, Settings, Solver, Status
from sleqp_tpu_torch import banded as tb
from sleqp_tpu_torch.convert import tree_from_numpy
from sleqp_tpu_torch.ops import pdlp as tpdlp
from sleqp_tpu_torch.types import HessEval, SolverPhase
from torch_dense import flat_jax, flat_port, jax_to_numpy, mismatches
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROUTES = {"float64": "same", "mixed": "float32"}
TOL = {"float64": 1e-12, "mixed": 1e-6}
# The float64 route condenses with DELTA = 1e-8: K carries 1/delta = 1e8
# beside O(1) Hessian entries, so two correct solves that round in another
# order part by ~eps/delta = 2.2e-8 relative in d and dlam = (J d - t)/delta
# (measured: 5e-9 in d, 2e-8 in dlam; the mixed route's DELTA_MIXED = 1e-4
# with refinement agrees to 5e-13).  The mixed route assembles J and H in
# float32, where JAX's forward mode and the port's reverse mode differ by a
# float32 rounding.  An iteration is held to 1e-7, relative to max(1, |x|):
# twice the largest difference measured (5.2e-8 in lam).
KKT_TOL = {"float64": 1e-7, "mixed": 1e-8}
ITER_TOL = 1e-7


# ---- the problems of tests/test_banded.py in both packages ------------------


def chain_pair(N_b=6, k=2):
    """tests/test_banded.py::_chain_problem: (JAX problem, port problem)."""
    tgt = torch.arange(N_b, dtype=torch.float64)

    def obj(x, t):
        return torch.sum((x - tgt.to(x)[t]) ** 2)

    def cons(a, b, t):
        return b - a

    tp = tb.BandedProblem(obj, N_b, k, cons_block=cons, cons_per_block=k, var_lb=0.0,
                          var_ub=3.0, cons_lb=-0.5, cons_ub=0.5, device="cpu")
    return jtests._chain_problem(N_b, k), tp


def nl_pair(N, k, q, seed=0):
    """The nonlinear banded problem of bench.py and
    test_banded_mixed_precision_matches_f64 (quadratic + cosine ripple,
    quadratic couplings) at (N, k, q)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((N, k)) * 0.5
    S = rng.standard_normal((N - 1, q, k)) * 0.3
    jW, jS, tW, tS = jnp.asarray(W), jnp.asarray(S), torch.as_tensor(W), torch.as_tensor(S)

    def jobj(x, t):
        return jnp.sum((x - jW[t]) ** 2) + 0.1 * jnp.sum(jnp.cos(x))

    def jcons(a, b, t):
        return jS[t] @ (b - a) + 0.05 * (jS[t] @ a) ** 2

    def tobj(x, t):
        return torch.sum((x - tW.to(x)[t]) ** 2) + 0.1 * torch.sum(torch.cos(x))

    def tcons(a, b, t):
        St = tS.to(a)[t]
        return St @ (b - a) + 0.05 * (St @ a) ** 2

    bounds = dict(var_lb=-2.0, var_ub=2.0, cons_lb=-0.3, cons_ub=0.3)
    jp = jb.BandedProblem(jobj, N, k, cons_block=jcons, cons_per_block=q, **bounds)
    tp = tb.BandedProblem(tobj, N, k, cons_block=tcons, cons_per_block=q, device="cpu", **bounds)
    return jp, tp


W_DENSE = np.array([[0.8, -0.3], [1.4, 0.2], [-0.5, 0.9], [0.1, 1.2]])


def dense_match_pair():
    """test_banded_matches_dense_path's problem (N_b = 4, k = 2, q = 1)."""
    jw, tw = jnp.asarray(W_DENSE), torch.as_tensor(W_DENSE)
    bounds = dict(var_lb=-2.0, var_ub=2.0, cons_lb=-0.5, cons_ub=0.5)
    jp = jb.BandedProblem(lambda x, t: jnp.sum((x - jw[t]) ** 2), 4, 2,
                          cons_block=lambda a, b, t: jnp.array([jnp.vdot(a, a) - b[0]]),
                          cons_per_block=1, **bounds)
    tp = tb.BandedProblem(lambda x, t: torch.sum((x - tw.to(x)[t]) ** 2), 4, 2,
                          cons_block=lambda a, b, t: torch.stack([torch.dot(a, a) - b[0]]),
                          cons_per_block=1, device="cpu", **bounds)
    return jp, tp


def infeasible_pair():
    """test_banded_locally_infeasible_certificate's problem."""
    bounds = dict(var_lb=0.0, var_ub=1.0, cons_lb=0.5, cons_ub=0.5)
    jp = jb.BandedProblem(lambda x, t: jnp.sum(x**2), 4, 1, cons_block=lambda a, b, t: b - a,
                          cons_per_block=1, **bounds)
    tp = tb.BandedProblem(lambda x, t: torch.sum(x**2), 4, 1, cons_block=lambda a, b, t: b - a,
                          cons_per_block=1, device="cpu", **bounds)
    return jp, tp


def port_state(jax_state):
    return tree_from_numpy(tb.BandedState, jax_to_numpy(jax_state), device="cpu")


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(a, b, tol):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0.0, atol=tol * max(1.0, float(np.abs(b).max(initial=0.0))))


# ---- evaluations ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def eval_case():
    jp, tp = nl_pair(5, 4, 2, seed=4)
    rng = np.random.default_rng(5)
    X = rng.uniform(-1.5, 1.5, (5, 4))
    lam = rng.standard_normal((4, 2))
    return jp, tp, X, lam


QUANTITIES = ("obj", "obj_grad", "cons", "jac_blocks", "cons_jtvp", "lag_hess_blocks")


def _evaluate(p, X, lam, what, route, jax_side):
    cd = None
    if route == "mixed":
        cd = jnp.float32 if jax_side else torch.float32
    if what == "jac_blocks":
        return p.cons_jac_blocks(X, compute_dtype=cd)
    if what == "lag_hess_blocks":
        return p.lag_hess_blocks(X, lam, compute_dtype=cd)
    if what == "cons_jtvp":
        return (p.cons_jtvp(X, lam),)
    return (getattr(p, what)(X),)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("what", QUANTITIES)
def test_evaluations_match_jax(what, route):
    """The mixed route changes the Jacobian and Hessian blocks only (float32
    assembly, returned in float64); the rest stays float64 on both."""
    jp, tp, X, lam = eval_case()
    ref = jax.jit(lambda X, lam: _evaluate(jp, X, lam, what, route, True))(
        jnp.asarray(X), jnp.asarray(lam))
    got = _evaluate(tp, torch.as_tensor(X), torch.as_tensor(lam), what, route, False)
    assembled = what in ("jac_blocks", "lag_hess_blocks")
    tol = TOL[route] if assembled else TOL["float64"]
    for r, g in zip(ref, got):
        assert g.dtype == torch.float64
        close(g, r, tol)


def test_mixed_assembly_needs_callables_that_follow_dtype():
    W = torch.ones((3, 2), dtype=torch.float64)
    tp = tb.BandedProblem(lambda x, t: torch.sum((x - W[t]) ** 2), 3, 2, device="cpu")
    with pytest.raises(TypeError, match="follow|dtype"):
        tp.lag_hess_blocks(torch.zeros((3, 2), dtype=torch.float64),
                           torch.zeros((2, 0), dtype=torch.float64), compute_dtype=torch.float32)


# ---- the matrix-free Cauchy LP ----------------------------------------------


def _dense_cauchy_matrix(Jl, Jr):
    """[J, I, -I, -I] assembled from the blocks."""
    Nc, q, k = Jl.shape
    m, n = Nc * q, (Nc + 1) * k
    J = np.zeros((m, n))
    for t in range(Nc):
        J[t * q:(t + 1) * q, t * k:(t + 1) * k] = Jl[t]
        J[t * q:(t + 1) * q, (t + 1) * k:(t + 2) * k] = Jr[t]
    eye = np.eye(m)
    return np.hstack([J, eye, -eye, -eye])


@pytest.mark.parametrize("method", ["mv", "rmv", "scaled_row_max", "scaled_col_max"])
def test_cauchy_op_matches_jax_and_dense(method):
    rng = np.random.default_rng(11)
    Nc, q, k = 4, 3, 5
    Jl, Jr = rng.standard_normal((Nc, q, k)), rng.standard_normal((Nc, q, k))
    jop = jb.BandedCauchyOp(jnp.asarray(Jl), jnp.asarray(Jr))
    top = tb.BandedCauchyOp(torch.as_tensor(Jl), torch.as_tensor(Jr))
    dense = tpdlp.DenseOp(torch.as_tensor(_dense_cauchy_matrix(Jl, Jr)))
    assert top.shape == jop.shape == dense.shape and top.device.type == "cpu"
    m, N = top.shape
    size = N if method in ("mv", "scaled_row_max") else m
    v = rng.uniform(0.1, 2.0, size) if method.startswith("scaled") else rng.standard_normal(size)
    got = getattr(top, method)(torch.as_tensor(v))
    close(got, getattr(jop, method)(jnp.asarray(v)), 1e-13)
    close(got, getattr(dense, method)(torch.as_tensor(v)), 1e-13)


def test_banded_cauchy_matches_jax():
    """test_banded_cauchy_extraction_large's formula at N_b = 12, k = 8,
    q = 4: PDLP OPTIMAL in JAX's iterations, the step to 1e-8, the same
    working set."""
    N_b, k, q = 12, 8, 4
    W = np.random.default_rng(1).standard_normal((N_b, k)) * 2.0
    jW, tW = jnp.asarray(W), torch.as_tensor(W)
    bounds = dict(var_lb=-1.0, var_ub=1.0, cons_lb=-0.1, cons_ub=0.1)
    jp = jb.BandedProblem(lambda x, t: jnp.sum((x - jW[t]) ** 2), N_b, k,
                          cons_block=lambda a, b, t: (b - a)[:q], cons_per_block=q, **bounds)
    tp = tb.BandedProblem(lambda x, t: torch.sum((x - tW.to(x)[t]) ** 2), N_b, k,
                          cons_block=lambda a, b, t: (b - a)[:q], cons_per_block=q,
                          device="cpu", **bounds)
    X = np.zeros((N_b, k))
    jd, jvs, jcs, jres = jax.jit(lambda X: jb.banded_cauchy(
        jp, X, jnp.asarray(0.5), jnp.asarray(100.0), tol=1e-7))(jnp.asarray(X))
    td, tvs, tcs, tres = tb.banded_cauchy(tp, torch.as_tensor(X), 0.5, 100.0, tol=1e-7)
    assert int(tres.state) == int(jres.state) == 0
    assert int(tres.iterations) == int(jres.iterations)
    close(td, jd, 1e-8)
    np.testing.assert_array_equal(np_(tvs), np.asarray(jvs))
    np.testing.assert_array_equal(np_(tcs), np.asarray(jcs))
    assert (np_(tcs) != 0).sum() > 0


# ---- the condensed KKT solve and the block BFGS update -----------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kkt_solve_matches_jax(route):
    rng = np.random.default_rng(21)
    N_b, k, q = 6, 4, 2
    jp, tp = nl_pair(N_b, k, q, seed=2)
    Hd = rng.standard_normal((N_b, k, k))
    Hd = Hd @ np.swapaxes(Hd, 1, 2) + np.eye(k)
    Hs = 0.2 * rng.standard_normal((N_b - 1, k, k))
    Jl, Jr = rng.standard_normal((N_b - 1, q, k)), rng.standard_normal((N_b - 1, q, k))
    act = rng.random((N_b - 1, q)) < 0.6
    target = 0.1 * rng.standard_normal((N_b - 1, q))
    g = rng.standard_normal((N_b, k))
    frozen = rng.random((N_b, k)) < 0.2
    args = (Hd, Hs, Jl, Jr, act, target, g, frozen, 1e-6)
    mixed = route == "mixed"
    jd, jdl = jax.jit(lambda *a: jb._kkt_solve(jp, *a, mixed=mixed))(*(jnp.asarray(a) for a in args))
    td, tdl = tb._kkt_solve(tp, *(torch.as_tensor(a) for a in args), mixed=mixed)
    close(td, jd, KKT_TOL[route])
    close(tdl, jdl, KKT_TOL[route])


def test_block_bfgs_push_matches_jax():
    """Blocks that update, that are damped (s^T y < 0.2 s^T B s) and that
    are skipped (s = 0)."""
    rng = np.random.default_rng(31)
    N_b, k = 5, 3
    B = rng.standard_normal((N_b, k, k))
    B = B @ np.swapaxes(B, 1, 2) + np.eye(k)
    s = rng.standard_normal((N_b, k))
    y = rng.standard_normal((N_b, k))
    y[1] = -s[1]  # negative curvature: damped
    s[2] = 0.0  # skipped
    ref = jb._block_bfgs_push(jnp.asarray(B), jnp.asarray(s), jnp.asarray(y))
    got = tb._block_bfgs_push(torch.as_tensor(B), torch.as_tensor(s), torch.as_tensor(y))
    close(got, ref, 1e-13)
    np.testing.assert_array_equal(np_(got)[2], B[2])


# ---- one port iteration from every JAX iterate -------------------------------


def _jax_settings(route="float64", **kw):
    return JSettings(compute_dtype=ROUTES[route], **kw)


def _port_settings(route="float64", **kw):
    return Settings(compute_dtype=ROUTES[route], **kw)


def _chain_restoration_start(jp):
    X0 = jnp.tile(jnp.array([[0.0], [3.0]]), (3, 2)).reshape(6, 2)
    s0 = jb.banded_initial_state(jp, JSettings(), X0)
    return dataclasses.replace(s0, phase=jnp.asarray(int(SolverPhase.RESTORATION), jnp.int32))


def _chain_release_start(jp):
    s0 = jb.banded_initial_state(jp, JSettings(), jnp.zeros((jp.N_b, jp.k)))
    return dataclasses.replace(s0, act_up=jnp.ones_like(s0.act_up), lam=jnp.full_like(s0.lam, -1.0))


def _start(jp, settings, start):
    if start == "seeded":
        return jax.jit(lambda X: jb.banded_initial_state(jp, settings, X, seed_working_set=True))(
            jnp.zeros((jp.N_b, jp.k)))
    if start == "restoration":
        return _chain_restoration_start(jp)
    if start == "release":
        return _chain_release_start(jp)
    return jb.banded_initial_state(jp, settings, jnp.zeros((jp.N_b, jp.k)))


# name -> (problem pair, route, extra settings, start, iteration cap)
CASES = {
    "chain": (chain_pair, "float64", {}, "zeros", 100),
    "seeded": (chain_pair, "float64", {}, "seeded", 100),
    "release": (chain_pair, "float64", {}, "release", 100),
    "restoration": (chain_pair, "float64", {}, "restoration", 200),
    "damped_bfgs": (chain_pair, "float64", {"hess_eval": "DAMPED_BFGS"}, "zeros", 300),
    "nl_float64": (functools.partial(nl_pair, 20, 8, 4), "float64", {}, "zeros", 100),
    "nl_mixed": (functools.partial(nl_pair, 20, 8, 4), "mixed", {}, "zeros", 100),
    "dense_match": (dense_match_pair, "float64", {}, "zeros", 100),
    "infeasible": (infeasible_pair, "float64", {}, "zeros", 300),
}


@functools.lru_cache(maxsize=None)
def case_run(name):
    """(port problem, port settings, JAX states from the start to the end
    of JAX's iteration, one jitted banded_perform_iteration a step)."""
    make, route, extra, start, cap = CASES[name]
    jp, tp = make()
    jextra = {k: getattr(JHessEval, v) for k, v in extra.items()}
    textra = {k: getattr(HessEval, v) for k, v in extra.items()}
    js, ts = _jax_settings(route, **jextra), _port_settings(route, **textra)
    step = jax.jit(lambda s: jb.banded_perform_iteration(jp, js, s))
    states = [_start(jp, js, start)]
    while int(states[-1].status) == Status.RUNNING and int(states[-1].iteration) < cap:
        states.append(step(states[-1]))
    return jp, tp, js, ts, states


@pytest.mark.parametrize("name", sorted(CASES))
def test_iteration_from_every_jax_iterate(name):
    """Each port iteration from a JAX state lands on JAX's next state: every
    integer and boolean field (status, phase, working set, counters) exactly,
    every float field to ITER_TOL."""
    _, tp, _, ts, states = case_run(name)
    assert len(states) >= 2
    phases = set()
    bad = {}
    for k, (before, ref_after) in enumerate(zip(states[:-1], states[1:])):
        phases.add(int(before.phase))
        after = tb.banded_perform_iteration(tp, ts, port_state(before))
        diff = mismatches(flat_port(after), flat_jax(ref_after), ITER_TOL)
        if diff:
            bad[k] = diff
    assert not bad, bad
    if name in ("restoration", "infeasible"):
        assert int(SolverPhase.RESTORATION) in phases


# ---- whole solves (tests/test_banded.py's tier-1 cases) ---------------------


def _jax_solve(name):
    jp, _, js, _, states = case_run(name)
    cap = CASES[name][4]
    start = states[0]
    return jb.banded_solve_jit(jp, js, start, cap)


def _port_solve(name):
    _, tp, _, ts, states = case_run(name)
    cap = CASES[name][4]
    if CASES[name][3] in ("restoration", "release"):
        return tb.banded_solve(tp, ts, max_iterations=cap, state0=port_state(states[0]))
    return tb.banded_solve(tp, ts, max_iterations=cap,
                           seed_working_set=CASES[name][3] == "seeded")


def _same_solve(name):
    ref, got = _jax_solve(name), _port_solve(name)
    assert int(got.status) == int(ref.status)
    assert int(got.iteration) == int(ref.iteration)
    close(got.X, ref.X, 1e-6)
    return ref, got


@pytest.mark.parametrize("name", ["chain", "seeded", "release", "restoration"])
def test_chain_solves_match_jax(name):
    """The chain problem from zeros, from the PDLP-seeded working set, from
    a wrong working set that must be released, and from a start forced into
    restoration: OPTIMAL at test_banded.py's profile."""
    _, got = _same_solve(name)
    assert int(got.status) == Status.OPTIMAL
    assert float(got.feas_res) <= 1e-6
    expect = np.array([1.0, 1.5, 2.0, 2.5, 3.0, 3.0])
    np.testing.assert_allclose(np_(got.X)[:, 0], expect, atol=1e-5)


def test_mixed_matches_float64():
    ref64, f64 = _same_solve("nl_float64")
    refmx, mixed = _same_solve("nl_mixed")
    assert int(mixed.status) == Status.OPTIMAL
    assert float(mixed.feas_res) <= 1e-6 and float(mixed.stat_res) <= 1e-6
    assert int(mixed.iteration) <= int(f64.iteration) + 3
    _, tp = nl_pair(20, 8, 4)
    assert float(tp.obj(mixed.X)) == pytest.approx(float(tp.obj(f64.X)), rel=1e-8)


def test_damped_bfgs_matches_jax():
    _, got = _same_solve("damped_bfgs")
    assert int(got.status) == Status.OPTIMAL
    assert float(got.stat_res) <= 1e-6
    exact = _port_solve("chain")
    np.testing.assert_allclose(float(got.obj_val), float(exact.obj_val), rtol=1e-6)


def test_infeasible_certificate_matches_jax():
    _, got = _same_solve("infeasible")
    assert int(got.status) in (Status.INFEASIBLE, Status.ABORT_DEADPOINT)
    assert float(got.feas_res) > 1e-6


def test_dense_match_against_port_solver():
    """test_banded_matches_dense_path: the banded solve and the port's dense
    Solver on the same NLP."""
    _, got = _same_solve("dense_match")
    assert int(got.status) == Status.OPTIMAL
    N_b, k = 4, 2
    tw = torch.as_tensor(W_DENSE)

    def obj(x):
        return torch.sum((x.reshape(N_b, k) - tw.to(x)) ** 2)

    def cons(x):
        X = x.reshape(N_b, k)
        return (X[:-1] * X[:-1]).sum(dim=1) - X[1:, 0]

    problem = Problem(Func(obj, num_variables=N_b * k, cons=cons, num_cons=N_b - 1),
                      var_lb=-2.0, var_ub=2.0, general_lb=-0.5, general_ub=0.5, device="cpu")
    solver = Solver(problem, np.zeros(N_b * k), Settings(), device="cpu")
    assert solver.solve(max_iterations=200) == Status.OPTIMAL
    np.testing.assert_allclose(float(got.obj_val), solver.obj_val, rtol=1e-5)
    np.testing.assert_allclose(np_(got.X).reshape(-1), solver.solution, atol=1e-4)


def test_state_carries_across_and_entry_points_default_to_cuda(monkeypatch):
    """convert.tree_from_numpy keeps every field's dtype and shape; without
    a card the problem's default device raises."""
    jp, tp, js, ts, states = case_run("damped_bfgs")
    got = flat_port(port_state(states[-1]))
    assert not mismatches(got, flat_jax(states[-1]), 0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.BandedProblem(lambda x, t: torch.sum(x**2), 3, 2)
