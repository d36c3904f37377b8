"""Port parity of the matrix-free sparse path: sleqp_tpu_torch/sparse.py
against sleqp_tpu/sparse.py on the CPU.

* the products J v, J^T u and the Lagrangian Hessian product against JAX's
  jvp, vjp and jvp-of-gradient;
* ``_cg``: the iterate and the count equal to JAX's, for a converged solve,
  one cut at the cap, one stopped by negative curvature, a warm start and
  a float32 solve; one host read a block of ``CG_BLOCK`` steps;
* ``_kkt_solve_cg`` on both routes; ``sparse_cauchy`` warm-started;
* one port iteration from every JAX iterate, optimality and restoration;
* the whole solves of tests/test_sparse.py's tier-1 cases: status and
  iterations equal to JAX's, x to 1e-6; the n = 5e4 case is ``slow``.

Inputs are made with numpy from a seed and handed to both packages.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import hs71_problem
from sleqp_tpu import Settings as JSettings
from sleqp_tpu import sparse as jsp
from sleqp_tpu_torch import Settings, SparseProblem, Status, sparse_solve
from sleqp_tpu_torch import sparse as tsp
from sleqp_tpu_torch.convert import tree_from_numpy
from sleqp_tpu_torch.types import SolverPhase
from torch_dense import flat_jax, flat_port, jax_to_numpy, mismatches
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROUTES = {"float64": "same", "mixed": "float32"}
# CG stops where its residual crosses 1e-10 of the right-hand side, and two
# runs that round in another order can cross one step apart: each inner
# solve of an EQP (AL_ITERS passes, and the float64 polish on the mixed
# route) may take one step more or fewer than JAX's.  The step then differs
# within the CG tolerance, and dlam = (J d - t) / DELTA carries that by
# 1/DELTA = 1e3 into the multipliers and the penalty (measured: 1.6e-9
# relative in the penalty of HS71's first iterate).  The mixed route's
# float32 CG bulk is held to the float32 rounding it runs in (measured
# 2.9e-7 in x: its float64 polish of at most 50 steps does not reach 1e-10
# on the scattered problem).  Floats are relative to max(1, |x|); the
# reduction ratio, a quotient of two differences of merit values, to an
# absolute ~1e-5 (measured 1.6e-6); every other field exactly.
CG_SLACK = {"float64": tsp.AL_ITERS, "mixed": tsp.AL_ITERS + 1}
ITER_TOL = {"float64": 1e-8, "mixed": 1e-6}
RATIO_TOL = 1e-5


# ---- the problems of tests/test_sparse.py in both packages -------------------


def unconstrained_pair(n=100):
    tgt = np.arange(n, dtype=np.float64) / n
    jt, tt = jnp.asarray(tgt), torch.as_tensor(tgt)
    jp = jsp.SparseProblem(lambda x: jnp.sum((x - jt) ** 2), num_variables=n)
    tp = SparseProblem(lambda x: torch.sum((x - tt.to(x)) ** 2), num_variables=n, device="cpu")
    return jp, tp


def hs71_pair():
    """test_sparse_matches_dense_path_hs71's problem (cauchy="pdlp")."""
    kw = dict(num_variables=4, num_cons=2, var_lb=1.0, var_ub=5.0, cauchy="pdlp")

    def obj(x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    jp = jsp.SparseProblem(obj, cons=lambda x: jnp.array([x[0] * x[1] * x[2] * x[3], jnp.vdot(x, x)]),
                           cons_lb=jnp.array([25.0, 40.0]), cons_ub=jnp.array([jnp.inf, 40.0]), **kw)
    tp = SparseProblem(obj, cons=lambda x: torch.stack([x[0] * x[1] * x[2] * x[3], torch.dot(x, x)]),
                       cons_lb=np.array([25.0, 40.0]), cons_ub=np.array([np.inf, 40.0]),
                       device="cpu", **kw)
    return jp, tp


def infeasible_pair():
    """test_sparse_infeasible_detection's contradictory equalities."""
    kw = dict(num_variables=2, num_cons=2, cons_lb=np.array([0.0, 1.0]),
              cons_ub=np.array([0.0, 1.0]))
    jp = jsp.SparseProblem(lambda x: jnp.sum(x**2), cons=lambda x: jnp.array([x[0], x[0]]), **kw)
    tp = SparseProblem(lambda x: torch.sum(x**2), cons=lambda x: torch.stack([x[0], x[0]]),
                       device="cpu", **kw)
    return jp, tp


def scattered_pair(n, seed=3):
    """tests/test_sparse.py::_scattered_problem: a convex separable objective
    and scattered long-range difference rows x[i] - x[j] in [-0.5, 0.5]."""
    m = n // 10
    rng = np.random.default_rng(seed)
    i_idx, j_idx = rng.integers(0, n, m), rng.integers(0, n, m)
    w, tgt = rng.uniform(0.5, 1.5, n), rng.uniform(-2.0, 2.0, n)
    kw = dict(num_variables=n, num_cons=m, var_lb=-3.0, var_ub=3.0, cons_lb=-0.5, cons_ub=0.5)
    ji, jj, jw, jt = (jnp.asarray(a) for a in (i_idx, j_idx, w, tgt))
    ti, tj, tw, tt = (torch.as_tensor(a) for a in (i_idx, j_idx, w, tgt))
    jp = jsp.SparseProblem(lambda x: 0.5 * jnp.sum(jw * (x - jt) ** 2),
                           cons=lambda x: x[ji] - x[jj], **kw)
    tp = SparseProblem(lambda x: 0.5 * torch.sum(tw.to(x) * (x - tt.to(x)) ** 2),
                       cons=lambda x: x[ti] - x[tj], device="cpu", **kw)
    return jp, tp


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(a, b, tol):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0.0, atol=tol * max(1.0, float(np.abs(b).max(initial=0.0))))


def count_bool_reads(fn):
    """(reads of a tensor's truth value while ``fn()`` runs, its result)."""
    reads = []
    real = torch.Tensor.__bool__

    def counted(self):
        reads.append(1)
        return real(self)

    torch.Tensor.__bool__ = counted
    try:
        out = fn()
    finally:
        torch.Tensor.__bool__ = real
    return len(reads), out


# ---- the products -------------------------------------------------------------


@pytest.mark.parametrize("case", ["hs71", "scattered"])
@pytest.mark.parametrize("product", ["jvp", "vjp", "lag_hess_prod"])
def test_products_match_jax(product, case):
    jp, tp = hs71_pair() if case == "hs71" else scattered_pair(200)
    rng = np.random.default_rng(7)
    x = rng.uniform(1.0, 3.0, jp.n)
    v, u, lam = rng.standard_normal(jp.n), rng.standard_normal(jp.m), rng.standard_normal(jp.m)
    args = {"jvp": (x, v), "vjp": (x, u), "lag_hess_prod": (x, lam, v)}[product]
    ref = getattr(jp, product)(*(jnp.asarray(a) for a in args))
    got = getattr(tp, product)(*(torch.as_tensor(a) for a in args))
    close(got, ref, 1e-13)


# ---- conjugate gradients --------------------------------------------------------


def _cg_system(kind, n=40):
    rng = np.random.default_rng(13)
    M = rng.standard_normal((n, n))
    A = M @ M.T / n + np.diag(np.linspace(0.05, 2.0, n))
    if kind == "negative":
        A = np.diag(np.linspace(-1.0, 2.0, n)) + 0.01 * (M + M.T)
    return A, rng.standard_normal(n), rng.standard_normal(n)


CG_CASES = {
    "converged": dict(kind="spd", max_iters=200, warm=False),
    "cap": dict(kind="spd", max_iters=7, warm=False),
    "negative": dict(kind="negative", max_iters=200, warm=False),
    "warm": dict(kind="spd", max_iters=200, warm=True),
    "float32": dict(kind="spd", max_iters=200, warm=False, dtype="float32"),
}


@pytest.mark.parametrize("name", sorted(CG_CASES))
def test_cg_matches_jax(name):
    """The same iterate and count as JAX's while_loop, with one host read
    a block of CG_BLOCK steps."""
    case = CG_CASES[name]
    A, b, x0 = _cg_system(case["kind"])
    f32 = case.get("dtype") == "float32"
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.float64, torch.float64)
    tol = 1e-7 if f32 else 1e-10
    jA, tA = jnp.asarray(A, jdt), torch.as_tensor(A, dtype=tdt)
    jx0 = jnp.asarray(x0, jdt) if case["warm"] else None
    tx0 = torch.as_tensor(x0, dtype=tdt) if case["warm"] else None
    jx, jit = jax.jit(lambda b, x0: jsp._cg(lambda v: jA @ v, b, jnp.asarray(tol, jdt),
                                            case["max_iters"], jdt, x0=x0))(jnp.asarray(b, jdt), jx0)
    reads, (tx, tit) = count_bool_reads(lambda: tsp._cg(
        lambda v: tA @ v, torch.as_tensor(b, dtype=tdt), tol, case["max_iters"], tdt, x0=tx0))
    assert int(tit) == int(jit)
    assert tx.dtype == tdt
    close(tx, jx, 1e-5 if f32 else 1e-10)
    assert reads == max(1, math.ceil(int(tit) / tsp.CG_BLOCK))
    if name == "cap":
        assert int(tit) == 7
    if name == "negative":
        assert int(tit) < 200


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kkt_solve_cg_matches_jax(route):
    jp, tp = scattered_pair(300)
    rng = np.random.default_rng(17)
    x = rng.uniform(-1.0, 1.0, jp.n)
    act = rng.random(jp.m) < 0.5
    lam_act = rng.standard_normal(jp.m) * act
    target = 0.1 * rng.standard_normal(jp.m)
    g = rng.standard_normal(jp.n)
    frozen = rng.random(jp.n) < 0.1
    args = (x, lam_act, act, target, g, frozen, 1e-6)
    mixed = route == "mixed"
    jd, jdl, jit = jax.jit(lambda *a: jsp._kkt_solve_cg(jp, *a, jnp.asarray(1e-10), mixed=mixed))(
        *(jnp.asarray(a) for a in args))
    td, tdl, tit = tsp._kkt_solve_cg(tp, *(torch.as_tensor(a) for a in args), 1e-10, mixed=mixed)
    assert abs(int(tit) - int(jit)) <= CG_SLACK[route]
    close(td, jd, ITER_TOL[route])
    close(tdl, jdl, ITER_TOL[route])


def test_sparse_cauchy_warm_started():
    """The Cauchy LP at HS71's start, cold and then warm-started from its own
    solution: JAX's iterations, step and working set."""
    jp, tp = hs71_pair()
    _, x0, _ = hs71_problem()
    x = np.asarray(x0)
    jrun = jax.jit(lambda x, lx, ly: jsp.sparse_cauchy(jp, x, jnp.asarray(0.5), jnp.asarray(10.0),
                                                       lp_x=lx, lp_y=ly))
    ref0 = jrun(jnp.asarray(x), jnp.zeros(jp.n + 3 * jp.m), jnp.zeros(jp.m))
    got0 = tsp.sparse_cauchy(tp, torch.as_tensor(x), 0.5, 10.0, lp_x=torch.zeros(tp.n + 3 * tp.m,
                             dtype=torch.float64), lp_y=torch.zeros(tp.m, dtype=torch.float64))
    x1 = x + 0.1
    ref = jrun(jnp.asarray(x1), ref0[3].x, ref0[3].duals)
    got = tsp.sparse_cauchy(tp, torch.as_tensor(x1), 0.5, 10.0, lp_x=torch.as_tensor(np.asarray(
        ref0[3].x)), lp_y=torch.as_tensor(np.asarray(ref0[3].duals)))
    for r, g in ((ref0, got0), (ref, got)):
        assert int(g[3].iterations) == int(r[3].iterations)
        assert int(g[3].state) == int(r[3].state)
        close(g[0], r[0], 1e-8)
        np.testing.assert_array_equal(np_(g[1]), np.asarray(r[1]))
        np.testing.assert_array_equal(np_(g[2]), np.asarray(r[2]))
    assert int(got[3].iterations) < int(got0[3].iterations)


# ---- one port iteration from every JAX iterate ----------------------------------


def _hs71_x0():
    return np.asarray(hs71_problem()[1])


# name -> (problem pair, route, x0, iteration cap)
CASES = {
    "unconstrained": (unconstrained_pair, "float64", None, 50),
    "hs71_pdlp": (hs71_pair, "float64", _hs71_x0, 100),
    "infeasible": (infeasible_pair, "float64", None, 200),
    "scattered_float64": (functools.partial(scattered_pair, 2000), "float64", None, 100),
    "scattered_mixed": (functools.partial(scattered_pair, 2000), "mixed", None, 100),
}


@functools.lru_cache(maxsize=None)
def case_run(name):
    """(port problem, port settings, x0, JAX states from the start to the
    end of JAX's iteration, one jitted sparse_perform_iteration a step)."""
    make, route, x0, cap = CASES[name]
    jp, tp = make()
    x0 = np.zeros(jp.n) if x0 is None else x0()
    js, ts = JSettings(compute_dtype=ROUTES[route]), Settings(compute_dtype=ROUTES[route])
    step = jax.jit(lambda s: jsp.sparse_perform_iteration(jp, js, s))
    states = [jsp.sparse_initial_state(jp, js, jnp.asarray(x0))]
    while int(states[-1].status) == Status.RUNNING and int(states[-1].iteration) < cap:
        states.append(step(states[-1]))
    return jp, tp, js, ts, x0, states


def port_state(jax_state):
    return tree_from_numpy(tsp.SparseState, jax_to_numpy(jax_state), device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_iteration_from_every_jax_iterate(name):
    """Each port iteration from a JAX state lands on JAX's next state: every
    integer and boolean field (status, phase, working set, CG counts)
    exactly, every float to ITER_TOL."""
    _, tp, _, ts, _, states = case_run(name)
    route = CASES[name][1]
    assert len(states) >= 2
    phases, bad = set(), {}
    for k, (before, ref_after) in enumerate(zip(states[:-1], states[1:])):
        phases.add(int(before.phase))
        after = tsp.sparse_perform_iteration(tp, ts, port_state(before))
        got, ref = flat_port(after), flat_jax(ref_after)
        diff = mismatches(got, ref, ITER_TOL[route], skip=("cg_iterations", "last_ratio"))
        steps = [int(s["cg_iterations"]) - int(before.cg_iterations) for s in (got, ref)]
        if abs(steps[0] - steps[1]) > CG_SLACK[route]:
            diff["cg_iterations"] = steps
        if not abs(float(got["last_ratio"]) - float(ref["last_ratio"])) <= RATIO_TOL:
            diff["last_ratio"] = float(got["last_ratio"]) - float(ref["last_ratio"])
        if diff:
            bad[k] = diff
    assert not bad, bad
    if name == "infeasible":
        assert int(SolverPhase.RESTORATION) in phases


# ---- whole solves (tests/test_sparse.py's tier-1 cases) -------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_jax(name):
    jp, tp, js, ts, x0, states = case_run(name)
    cap = CASES[name][3]
    ref = jsp.sparse_solve(jp, js, x0=jnp.asarray(x0), max_iterations=cap)
    got = sparse_solve(tp, ts, x0=x0, max_iterations=cap)
    assert int(got.status) == int(ref.status)
    assert int(got.iteration) == int(ref.iteration)
    close(got.x, ref.x, 1e-6)
    expect = Status.INFEASIBLE if name == "infeasible" else Status.OPTIMAL
    assert int(got.status) == expect
    if expect == Status.OPTIMAL:
        assert float(got.feas_res) <= 1e-6 and float(got.stat_res) <= 1e-6
    if name == "hs71_pdlp":
        np.testing.assert_allclose(np_(got.x), hs71_problem()[2], atol=1e-5)


def test_mixed_needs_callables_that_follow_dtype():
    w = torch.ones(4, dtype=torch.float64)
    tp = SparseProblem(lambda x: torch.sum(w * x**2), num_variables=4, device="cpu")
    with pytest.raises(TypeError, match="dtype"):
        sparse_solve(tp, Settings(compute_dtype="float32"), x0=np.ones(4))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SparseProblem(lambda x: torch.sum(x**2), num_variables=3)


@pytest.mark.slow
def test_sparse_scattered_50k():
    """test_sparse_scattered_50k through the port: OPTIMAL to 1e-6 with zero
    duals on inactive rows, the iterations JAX's."""
    jp, tp = scattered_pair(50_000)
    ref = jsp.sparse_solve(jp, JSettings(), max_iterations=100)
    got = sparse_solve(tp, Settings(), max_iterations=100)
    assert int(got.status) == int(ref.status) == Status.OPTIMAL
    assert int(got.iteration) == int(ref.iteration)
    assert float(got.feas_res) <= 1e-6 and float(got.stat_res) <= 1e-6
    lam, act = np_(got.lam), np_(got.act_low | got.act_up)
    assert np.all(lam[~act] == 0.0)
    close(got.x, ref.x, 1e-6)
