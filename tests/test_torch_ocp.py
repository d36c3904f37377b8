"""Port parity: the structured (OCP) solve, sleqp_tpu_torch/ocp.py against
sleqp_tpu/ocp.py, on the tests/test_ocp.py problem.

The float64 route must match the reference to rounding; the mixed route
(Settings(compute_dtype="float32")) runs its KKT solve in float32, where the
two packages round differently, so it must reach the same float64 KKT point
in the same iterations give or take one."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.ocp import (
    ocp_initial_state as jax_initial_state,
    ocp_perform_iteration as jax_perform_iteration,
    ocp_solve as jax_solve,
)
from sleqp_tpu_torch import (
    BlockStructuredProblem,
    Settings,
    Status,
    ocp_initial_state,
    ocp_perform_iteration,
    ocp_solve,
)
from sleqp_tpu_torch.convert import state_from_numpy, state_to_numpy
from torch_parity import NU, NX, T, make_bench_pair, make_ocp_pair, no_jax_cache_writes  # noqa: F401

CASES = {
    "free": {},
    # the bounds of tests/test_ocp.py::test_ocp_mixed_precision_matches_f64
    "u_bounds": dict(u_lb=-2.0, u_ub=2.0),
    # tight enough that early controls saturate (tests/test_ocp.py)
    "u_active": dict(u_lb=-0.15, u_ub=0.15),
    "x_bounds": dict(x_lb=[-np.inf, -0.45]),
    "gauss_newton": dict(gauss_newton=True),
}
ROUTES = ["same", "float32"]


def _jax_state_arrays(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


@pytest.mark.parametrize("route", ROUTES)
def test_linearize_matches_jax(route):
    jp, tp = make_ocp_pair()
    rng = np.random.default_rng(0)
    U = 0.3 * rng.standard_normal((T, NU))
    lam = rng.standard_normal((T, NX))
    X = tp.rollout(torch.as_tensor(U))
    X_jax = np.asarray(jax.jit(jp.rollout)(jnp.asarray(U)))
    np.testing.assert_allclose(X.numpy(), X_jax, rtol=1e-14, atol=1e-14)

    mixed = route == "float32"
    got = tp.linearize(X, torch.as_tensor(U), torch.as_tensor(lam),
                       compute_dtype=torch.float32 if mixed else None)
    linearize = jax.jit(partial(jp.linearize, compute_dtype=jnp.float32 if mixed else None))
    want = linearize(jnp.asarray(X_jax), jnp.asarray(U), jnp.asarray(lam))
    for name, a, b in zip(("c", "g", "G", "H"), got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        # float64 results agree to rounding; float32 G and H are evaluated
        # by two AD systems in float32, so to a few float32 ulps
        tol = 1e-6 if b.dtype == np.float32 else 1e-12
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol * np.abs(b).max(), err_msg=name)

    Jt_lam = tp.constraint_vjp(X, torch.as_tensor(U), torch.as_tensor(lam))
    Jt_lam_jax = np.asarray(jax.jit(jp.constraint_vjp)(jnp.asarray(X_jax), jnp.asarray(U), jnp.asarray(lam)))
    np.testing.assert_allclose(Jt_lam.numpy(), Jt_lam_jax, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["free", "u_active"])
def test_one_iteration_matches_jax(case, route, start):
    """One iteration from the same state, handed to both packages through
    numpy: the JAX initial state, or the state after one JAX iteration
    (nonzero multipliers)."""
    jp, tp = make_ocp_pair(**CASES[case])
    js = JaxSettings(compute_dtype=route)
    step = jax.jit(lambda s: jax_perform_iteration(jp, js, s))
    s = jax_initial_state(jp, js)
    for _ in range(start):
        s = step(s)
    want = _jax_state_arrays(step(s))
    got = state_to_numpy(
        ocp_perform_iteration(tp, Settings(compute_dtype=route), state_from_numpy(_jax_state_arrays(s), device="cpu"))
    )
    assert set(got) == set(want)
    # float64: rounding; mixed: the float32 KKT solve rounds differently,
    # and the reduction ratio divides two merit differences whose
    # cancellation magnifies that rounding (measured 1.9e-4 relative)
    tol = 1e-10 if route == "same" else 1e-5
    for name, b in want.items():
        a = got[name]
        assert a.dtype == b.dtype, name
        if b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            t = 1e-3 if name == "last_ratio" and route == "float32" else tol
            np.testing.assert_allclose(a, b, rtol=t, atol=t, err_msg=name)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["free", "u_bounds"])
def test_solve_matches_jax(case, route):
    jp, tp = make_ocp_pair(**CASES[case])
    ref = jax_solve(jp, JaxSettings(compute_dtype=route), max_iterations=80)
    out = ocp_solve(tp, Settings(compute_dtype=route), max_iterations=80, device="cpu")
    assert int(ref.status) == Status.OPTIMAL
    assert int(out.status) == Status.OPTIMAL
    assert float(out.feas_res) <= 1e-6 and float(out.stat_res) <= 1e-6
    if route == "same":
        assert int(out.iteration) == int(ref.iteration)
    else:
        assert abs(int(out.iteration) - int(ref.iteration)) <= 1
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_active_bounds_solve_matches_jax(route):
    """Saturated controls: the freeze moves the active set over ~50
    iterations, and on the mixed route float32 rounding decides where it
    moves when, so the two packages' counts differ there (49
    against 59); the mixed route is held to the reference's own bar
    against float64 (tests/test_ocp.py:278) and to the same point."""
    jp, tp = make_ocp_pair(**CASES["u_active"])
    ref = jax_solve(jp, JaxSettings(compute_dtype=route), max_iterations=80)
    out = ocp_solve(tp, Settings(compute_dtype=route), max_iterations=80, device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    if route == "same":
        assert int(out.iteration) == int(ref.iteration)
    else:
        f64 = jax_solve(jp, JaxSettings(), max_iterations=80)
        assert int(out.iteration) <= int(f64.iteration) + 3
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-5)
    assert (out.U.abs() >= 0.15 - 1e-8).any()  # some bound is active


@pytest.mark.parametrize("route", ROUTES)
def test_bench_widths_solve_matches_jax(route):
    """bench.py's problem at its widths (nz = 64: the blocked inverse; Schur
    blocks of 32: the flat one), cut to T = 40 stages."""
    jp, tp = make_bench_pair(40)
    ref = jax_solve(jp, JaxSettings(compute_dtype=route), max_iterations=50)
    out = ocp_solve(tp, Settings(compute_dtype=route), max_iterations=50, device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    if route == "same":
        assert int(out.iteration) == int(ref.iteration)
    else:
        assert abs(int(out.iteration) - int(ref.iteration)) <= 1
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["x_bounds", "gauss_newton"])
def test_solve_variants_match_jax(case):
    """State bounds (reduced-gradient freeze on x_1..x_T) and Gauss-Newton
    Hessians, on the float64 route."""
    jp, tp = make_ocp_pair(**CASES[case])
    ref = jax_solve(jp, JaxSettings(), max_iterations=120)
    out = ocp_solve(tp, Settings(), max_iterations=120, device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    assert int(out.iteration) == int(ref.iteration)
    np.testing.assert_allclose(out.X.numpy(), np.asarray(ref.X), rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-8)


def test_mixed_route_reaches_f64_point():
    """tests/test_ocp.py::test_ocp_mixed_precision_matches_f64, on the port."""
    _, tp = make_ocp_pair(u_lb=-2.0, u_ub=2.0)
    ref = ocp_solve(tp, Settings(), max_iterations=50, device="cpu")
    out = ocp_solve(tp, Settings(compute_dtype="float32"), max_iterations=50, device="cpu")
    assert int(ref.status) == Status.OPTIMAL and int(out.status) == Status.OPTIMAL
    assert float(out.feas_res) <= 1e-6 and float(out.stat_res) <= 1e-6
    assert int(out.iteration) <= int(ref.iteration) + 3
    assert float(out.obj_val) == pytest.approx(float(ref.obj_val), rel=1e-6, abs=1e-8)
    np.testing.assert_allclose(out.U.numpy(), ref.U.numpy(), atol=1e-5)


def test_iteration_limit_reports_abort_iter():
    _, tp = make_ocp_pair()
    out = ocp_solve(tp, Settings(), max_iterations=1, device="cpu")
    assert int(out.status) == Status.ABORT_ITER and int(out.iteration) == 1


A64 = torch.tensor([[1.0, 0.1], [0.0, 0.9]], dtype=torch.float64)
B64 = torch.tensor([0.0, 0.1], dtype=torch.float64)


@pytest.mark.parametrize("dynamics", [
    lambda x, u, t: A64 @ x + B64 * u[0],  # a product of mixed dtypes fails
    lambda x, u, t: 0.9 * x + B64 * u[0],  # elementwise ops promote silently
], ids=["matmul", "elementwise"])
def test_mixed_route_rejects_float64_callable(dynamics):
    """The port has no counterpart of f32_compute_scope: a callable that
    closes over a float64 tensor raises in the mixed route and is never run
    in float64 there; the same callable solves on the float64 route."""
    def cost(x, u, t):
        return x @ x + u @ u

    problem = BlockStructuredProblem(dynamics, cost, 4, 2, 1, x0=[1.0, 0.0], device="cpu")
    with pytest.raises(TypeError, match="dtype"):
        ocp_solve(problem, Settings(compute_dtype="float32"), device="cpu")
    assert int(ocp_solve(problem, Settings(), device="cpu").status) == Status.OPTIMAL


def test_mixed_route_passes_other_callable_errors_through():
    """Only a dtype mismatch becomes the dtype TypeError; any other error of
    a callable reaches the caller unchanged."""
    def dynamics(x, u, t):
        if x.dtype == torch.float32:
            raise RuntimeError("the callable's own fault")
        return 0.9 * x + u[0]

    def cost(x, u, t):
        return x @ x + u @ u

    problem = BlockStructuredProblem(dynamics, cost, 4, 2, 1, x0=[1.0, 0.0], device="cpu")
    with pytest.raises(RuntimeError, match="the callable's own fault"):
        ocp_solve(problem, Settings(compute_dtype="float32"), device="cpu")


def test_readme_example_runs_on_cpu():
    """The README's example, with device="cpu" given to the problem and the
    solve, reaches OPTIMAL on the mixed route."""
    import pathlib
    import re

    readme = (pathlib.Path(__file__).parent.parent / "README.md").read_text()
    block = next(
        b for b in re.findall(r"```python\n(.*?)```", readme, re.DOTALL)
        if "sleqp_tpu_torch" in b
    )
    for old, new in [
        ("x0=[1.0, 0.0])", 'x0=[1.0, 0.0], device="cpu")'),
        ('Settings(compute_dtype="float32"))', 'Settings(compute_dtype="float32"), device="cpu")'),
    ]:
        assert old in block, old
        block = block.replace(old, new)
    scope = {}
    exec(compile(block, "README.md", "exec"), scope)
    assert int(scope["out"].status) == Status.OPTIMAL


def test_state_numpy_round_trip():
    _, tp = make_ocp_pair(u_lb=-0.15, u_ub=0.15)
    s0 = ocp_initial_state(tp, Settings(), device="cpu")
    back = state_from_numpy(state_to_numpy(s0), device="cpu")
    for f in dataclasses.fields(s0):
        a, b = getattr(s0, f.name), getattr(back, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_settings_validation():
    with pytest.raises(ValueError):
        Settings(compute_dtype="fp32")
    assert Settings().compute_dtype == "same"
    assert JaxSettings().feas_tol == Settings().feas_tol
    assert JaxSettings().linesearch_eta == Settings().linesearch_eta


@pytest.mark.parametrize("route,backend", [
    ("same", "pallas"),  # float64 S through block_tridiag_solve_mp (cr32 + 2 refinements)
    ("float32", "spike"),  # float32 S through SPIKE, stage Hessians by Cholesky
    ("float32", "scan"),  # any other value: the block-Thomas scan
    ("float32", "pallas"),  # float32 S: block_tridiag_solve_mp's unrefined scan
])
def test_tridiag_backend_matches_jax(route, backend):
    """ocp_solve(..., tridiag_backend=) on the tests/test_ocp.py problem,
    with the reference's routing; each route reaches the reference's KKT
    point (tests/test_pallas_tridiag.py::test_ocp_pallas_backend_matches_scan:
    feas, stat <= 1e-6, U to 1e-6)."""
    jp, tp = make_ocp_pair(**CASES["u_bounds"])
    ref = jax_solve(jp, JaxSettings(compute_dtype=route), max_iterations=50, tridiag_backend=backend)
    out = ocp_solve(tp, Settings(compute_dtype=route), max_iterations=50, tridiag_backend=backend,
                    device="cpu")
    scan = ocp_solve(tp, Settings(), max_iterations=50, device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    assert float(out.feas_res) <= 1e-6 and float(out.stat_res) <= 1e-6
    if route == "same":
        assert int(out.iteration) == int(ref.iteration)
    else:
        assert abs(int(out.iteration) - int(ref.iteration)) <= 1
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.U.numpy(), scan.U.numpy(), rtol=1e-5, atol=1e-6)


def test_tridiag_backend_routes_through_kernels(monkeypatch):
    """The routing of _structured_kkt_core, read off the kernels' plain
    versions: "auto" on the float32 route inverts the stage Hessians and
    runs cyclic reduction; "pallas" on the float64 route runs cyclic
    reduction on S only; "spike" and "scan" run no batched inverse."""
    from sleqp_tpu_torch.ops import cyclic_reduction as cr

    calls = []
    plain = cr.bgj_flat_plain
    monkeypatch.setattr(cr, "bgj_flat_plain", lambda C: calls.append(tuple(C.shape)) or plain(C))
    _, tp = make_ocp_pair()
    runs = {}
    for route, backend in (("float32", "auto"), ("same", "pallas"), ("float32", "spike"), ("float32", "scan")):
        calls.clear()
        ocp_perform_iteration(tp, Settings(compute_dtype=route), ocp_initial_state(tp, Settings(), device="cpu"),
                              tridiag_backend=backend)
        runs[route, backend] = list(calls)
    nz = NX + NU
    assert (T + 1, nz, nz) in runs["float32", "auto"]  # stage Hessians
    assert runs["same", "pallas"] and all(s[1] == NX for s in runs["same", "pallas"])
    assert runs["float32", "spike"] == [] and runs["float32", "scan"] == []


def test_every_iteration_from_jax_state_matches_jax():
    """The mixed route with saturated controls, where the two packages'
    iteration counts differ (49 against 59): from each of the reference's
    iterates, one port iteration gives the reference's next iterate.  The
    same controls end at their bounds, the same steps are accepted with the
    same step length and regularization, and the states agree to the
    float32 KKT solve's rounding (the largest differences measured are
    7.3e-7 in U, 1.9e-7 in X and 6.7e-6 in lam over the 50 iterations);
    the counts part through that rounding, accumulated over the ~50
    iterations in which the active set moves one control at a time."""
    jp, tp = make_ocp_pair(**CASES["u_active"])
    js = JaxSettings(compute_dtype="float32")
    step = jax.jit(lambda s: jax_perform_iteration(jp, js, s))
    s = jax_initial_state(jp, js)
    iterations = 0
    largest = dict.fromkeys(("X", "U", "lam"), 0.0)
    while int(s.status) == Status.RUNNING:
        want = _jax_state_arrays(step(s))
        got = state_to_numpy(ocp_perform_iteration(
            tp, Settings(compute_dtype="float32"), state_from_numpy(_jax_state_arrays(s), device="cpu")
        ))
        for name in ("status", "num_accepted", "num_rejected", "iteration"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        for name in ("X", "U", "lam", "reg", "last_alpha", "penalty"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5, err_msg=name)
        for name in largest:
            largest[name] = max(largest[name], float(np.abs(got[name] - want[name]).max()))
        at_bound = np.abs(np.abs(want["U"]) - 0.15) < 1e-12
        np.testing.assert_array_equal(np.abs(np.abs(got["U"]) - 0.15) < 1e-12, at_bound)
        s = step(s)
        iterations += 1
    assert int(s.status) == Status.OPTIMAL and iterations >= 40
    port = ocp_solve(tp, Settings(compute_dtype="float32"), max_iterations=80, device="cpu")
    # shown with -s: the numbers ROADMAP.md quotes
    print(f"iterations JAX {int(s.iteration)}, port {int(port.iteration)}; largest per-iteration "
          + ", ".join(f"|d{name}| {v:.2e}" for name, v in largest.items()))


def test_bench_widths_pallas_route_matches_jax():
    """bench.py's problem at its widths, cut to T = 40, on the float64
    route with tridiag_backend="pallas": here the two float64 refinements
    of the float32 Schur solve leave one step inexact, and both packages
    take the same detour (7 iterations against the scan's 2)."""
    jp, tp = make_bench_pair(40)
    X0 = np.zeros((41, 32))
    X0[0] = 1.0
    ref = jax_solve(jp, JaxSettings(), X0=jnp.asarray(X0), max_iterations=50, tridiag_backend="pallas")
    out = ocp_solve(tp, Settings(), X0=X0, max_iterations=50, tridiag_backend="pallas", device="cpu")
    scan = ocp_solve(tp, Settings(), X0=X0, max_iterations=50, device="cpu")
    assert int(out.status) == int(ref.status) == int(scan.status) == Status.OPTIMAL
    assert int(out.iteration) == int(ref.iteration) == 7 and int(scan.iteration) == 2
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-8)
