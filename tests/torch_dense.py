"""Shared pieces of the dense SLP-EQP parity tests (tests/test_torch_*.py):
the same problems in both packages, and the carrying of iterates and
solver states between them.

Each pair is (JAX problem, port problem on the CPU, x0 as numpy), built
from the same numpy data.  HS71 and the small fixtures follow
tests/fixtures.py; ``chainineq``, ``chainqp`` and ``boxqp`` follow
sleqp_tpu/harness/medium.py (same seeds) at a size given by the caller.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import (  # noqa: F401  (the field comparisons, shared with chip_smoke.py)
    NONLIN,
    field_mismatches as mismatches,
    flat_fields,
    single_lane_states,
    step_mismatches,
    tie_mismatches,
)
import fixtures
import sleqp_tpu as jx
import sleqp_tpu.cauchy as jc
import sleqp_tpu.penalty as jpn
import sleqp_tpu_torch as tx
from sleqp_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from sleqp_tpu_torch.iterate import Iterate
from sleqp_tpu_torch.problem_solver import SolverState


def hs71():
    def obj(x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def cons(x):
        return torch.stack([x[0] * x[1] * x[2] * x[3], x @ x])

    jp, x0, _ = fixtures.hs71_problem()
    tp = tx.Problem(tx.Func(obj, 4, cons=cons, num_cons=2), var_lb=1.0, var_ub=5.0,
                    general_lb=np.array([25.0, 40.0]), general_ub=np.array([np.inf, 40.0]),
                    device="cpu")
    return jp, tp, np.array(x0)


def wachbieg():
    def obj(x):
        return x[0]

    def cons(x):
        return torch.stack([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5])

    jp, x0, _ = fixtures.wachbieg_problem()
    tp = tx.Problem(tx.Func(obj, 3, cons=cons, num_cons=2),
                    var_lb=np.array([-np.inf, 0.0, 0.0]), var_ub=np.inf,
                    general_lb=0.0, general_ub=0.0, device="cpu")
    return jp, tp, np.array(x0)


def quadcons():
    def obj(x):
        return x[0] ** 2 + x[1] ** 2

    def cons(x):
        return torch.stack([x[0] ** 2 + x[1] ** 2, x[1] ** 2 + x[0]])

    jp, x0, _ = fixtures.quadcons_problem()
    tp = tx.Problem(tx.Func(obj, 2, cons=cons, num_cons=2), var_lb=0.0, var_ub=1.0,
                    general_lb=-np.inf, general_ub=1.0, device="cpu")
    return jp, tp, np.array(x0)


def linear():
    def obj(x):
        return -x[0] - 2.0 * x[1]

    jp, x0, _ = fixtures.linear_problem()
    d = jp.data
    tp = tx.Problem(tx.Func(obj, 2), var_lb=np.array(d.var_lb), var_ub=np.array(d.var_ub),
                    linear_coeffs=np.array(d.linear_coeffs), linear_lb=np.array(d.cons_lb),
                    linear_ub=np.array(d.cons_ub), device="cpu")
    return jp, tp, np.array(x0)


def chainineq(n):
    """harness/medium.py::chainineq200 at size n: min 1/2||x - t||^2
    s.t. |x_{i+1} - x_i| <= 0.05."""
    rng = np.random.default_rng(41)
    t = np.cumsum(rng.standard_normal(n)) * 0.2
    tj, tt = jnp.asarray(t), torch.as_tensor(t)
    jp = jx.Problem(jx.Func(lambda x: 0.5 * jnp.sum((x - tj) ** 2), n,
                            cons=lambda x: x[1:] - x[:-1], num_cons=n - 1),
                    general_lb=-0.05, general_ub=0.05)
    tp = tx.Problem(tx.Func(lambda x: 0.5 * ((x - tt.to(x)) ** 2).sum(), n,
                            cons=lambda x: x[1:] - x[:-1], num_cons=n - 1),
                    general_lb=-0.05, general_ub=0.05, device="cpu")
    return jp, tp, np.zeros(n)


def chainqp(n):
    """harness/medium.py::chainqp200 at size n: min sum (x_i - t_i)^2 with
    the chain as linear constraints |x_{i+1} - x_i| <= 0.006, PSD."""
    t = np.linspace(0.0, 1.0, n)
    tj, tt = jnp.asarray(t), torch.as_tensor(t)
    A = np.zeros((n - 1, n))
    for i in range(n - 1):
        A[i, i], A[i, i + 1] = -1.0, 1.0
    jp = jx.Problem(jx.Func(lambda x: jnp.sum((x - tj) ** 2), n, psd_hessian=True),
                    linear_coeffs=jnp.asarray(A), linear_lb=-0.006, linear_ub=0.006)
    tp = tx.Problem(tx.Func(lambda x: ((x - tt.to(x)) ** 2).sum(), n, psd_hessian=True),
                    linear_coeffs=A, linear_lb=-0.006, linear_ub=0.006, device="cpu")
    return jp, tp, np.zeros(n)


def boxqp(n):
    """harness/medium.py::boxqp1000 at size n: min sum (x_i - c_i)^2 over
    [0, 1]^n, PSD, no constraints."""
    rng = np.random.default_rng(7)
    c = rng.uniform(-0.5, 1.5, n)
    cj, ct = jnp.asarray(c), torch.as_tensor(c)
    jp = jx.Problem(jx.Func(lambda x: jnp.sum((x - cj) ** 2), n, psd_hessian=True),
                    var_lb=0.0, var_ub=1.0)
    tp = tx.Problem(tx.Func(lambda x: ((x - ct.to(x)) ** 2).sum(), n, psd_hessian=True),
                    var_lb=0.0, var_ub=1.0, device="cpu")
    return jp, tp, np.full(n, 0.5)


# one compiled program per static configuration: the JAX package's
# while_loops, called eagerly, compile again at every call
jax_cauchy_lp = jax.jit(jc.solve_cauchy_lp, static_argnames=(
    "settings_eps", "max_iterations", "feasibility_mode", "lp_resolves", "dual_warm_start",
    "lp_solver", "pdlp_tol", "compute_dtype"))
jax_update_penalty = jax.jit(jpn.update_penalty, static_argnames=(
    "lp_solver", "pdlp_tol", "compute_dtype"))


# ---- states between the packages ------------------------------------------


def jax_to_numpy(obj):
    """A JAX pytree (dataclasses of arrays) with numpy leaves."""
    return jax.tree_util.tree_map(np.asarray, obj)


def port_state(jax_state):
    """The port's SolverState (CPU) from a JAX SolverState."""
    return tree_from_numpy(SolverState, jax_to_numpy(jax_state), device="cpu")


def port_iterate(jax_it):
    return tree_from_numpy(Iterate, jax_to_numpy(jax_it), device="cpu")


def flat_jax(obj):
    """{dotted field name: numpy array} of a JAX dataclass tree."""
    return flat_fields(obj)


def flat_port(obj):
    """{dotted field name: numpy array} of a port dataclass tree."""
    return flat_fields(tree_to_numpy(obj))


# ---- the problems of tests/fixtures.py and the suite, as port problems ----


def rosenbrock():
    def obj(x):
        return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    jp, x0, _ = fixtures.rosenbrock_problem()
    return jp, tx.Problem(tx.Func(obj, 2), device="cpu"), np.array(x0)


def quadfunc():
    jp, x0, _ = fixtures.quadfunc_problem()
    tp = tx.Problem(tx.Func(lambda x: x @ x, 2), var_lb=-10.0, var_ub=10.0, device="cpu")
    return jp, tp, np.array(x0)


def hs6():
    jp, x0, _ = fixtures.hs6_problem()
    tp = tx.Problem(tx.Func(lambda x: (1.0 - x[0]) ** 2, 2,
                            cons=lambda x: (10.0 * (x[1] - x[0] ** 2))[None], num_cons=1),
                    general_lb=0.0, general_ub=0.0, device="cpu")
    return jp, tp, np.array(x0)


def hs35():
    def obj(x):
        return (9.0 - 8.0 * x[0] - 6.0 * x[1] - 4.0 * x[2] + 2.0 * x[0] ** 2 + 2.0 * x[1] ** 2
                + x[2] ** 2 + 2.0 * x[0] * x[1] + 2.0 * x[0] * x[2])

    jp, x0, _ = fixtures.hs35_problem()
    tp = tx.Problem(tx.Func(obj, 3, psd_hessian=True), var_lb=0.0, var_ub=np.inf,
                    linear_coeffs=np.array([[1.0, 1.0, 2.0]]), linear_lb=-np.inf, linear_ub=3.0,
                    device="cpu")
    return jp, tp, np.array(x0)


def rosenbrock_lsq():
    jp, x0, _ = fixtures.rosenbrock_lsq_problem()
    func = tx.LSQFunc(lambda x: torch.stack([1.0 - x[0], 10.0 * (x[1] - x[0] ** 2)]), 2, 2)
    return jp, tx.Problem(func, device="cpu"), np.array(x0)


def constrained_lsq():
    """tests/test_lsq.py::test_constrained_lsq's problem."""
    jfunc = jx.LSQFunc(lambda x: jnp.array([x[0] - 1.0, 10.0 * (x[1] - x[0] ** 2)]), 2, 2,
                       cons=lambda x: jnp.array([x[0] + x[1]]), num_cons=1)
    tfunc = tx.LSQFunc(lambda x: torch.stack([x[0] - 1.0, 10.0 * (x[1] - x[0] ** 2)]), 2, 2,
                       cons=lambda x: (x[0] + x[1])[None], num_cons=1)
    jp = jx.Problem(jfunc, general_lb=1.0, general_ub=1.0)
    tp = tx.Problem(tfunc, general_lb=1.0, general_ub=1.0, device="cpu")
    return jp, tp, np.zeros(2)


def broydn(n):
    """harness/medium.py::broydn100 at size n: the Broyden tridiagonal
    system as least squares (LSQFunc), f* = 0."""

    def jres(x):
        xm = jnp.concatenate([jnp.zeros(1), x[:-1]])
        xp = jnp.concatenate([x[1:], jnp.zeros(1)])
        return (3.0 - 2.0 * x) * x - xm - 2.0 * xp + 1.0

    def tres(x):
        z = torch.zeros(1, dtype=x.dtype, device=x.device)
        return (3.0 - 2.0 * x) * x - torch.cat([z, x[:-1]]) - 2.0 * torch.cat([x[1:], z]) + 1.0

    jp = jx.Problem(jx.LSQFunc(jres, n, n))
    tp = tx.Problem(tx.LSQFunc(tres, n, n), device="cpu")
    return jp, tp, np.full(n, -1.0)


def extrosnb(n):
    """harness/medium.py::extrosnb100 at size n (extended Rosenbrock)."""

    def jobj(x):
        return jnp.sum(100.0 * (x[1::2] - x[0::2] ** 2) ** 2 + (1.0 - x[0::2]) ** 2)

    def tobj(x):
        return (100.0 * (x[1::2] - x[0::2] ** 2) ** 2 + (1.0 - x[0::2]) ** 2).sum()

    return (jx.Problem(jx.Func(jobj, n)), tx.Problem(tx.Func(tobj, n), device="cpu"),
            np.tile([-1.2, 1.0], n // 2))


def projqp(n, m):
    """harness/medium.py::projqp500 at size (n, m): min 1/2||x - t||^2 s.t.
    A x = b (default_rng(17))."""
    rng = np.random.default_rng(17)
    A = rng.standard_normal((m, n))
    t = rng.standard_normal(n)
    b = rng.standard_normal(m)
    tj, tt = jnp.asarray(t), torch.as_tensor(t)
    jp = jx.Problem(jx.Func(lambda x: 0.5 * jnp.sum((x - tj) ** 2), n),
                    linear_coeffs=jnp.asarray(A), linear_lb=jnp.asarray(b), linear_ub=jnp.asarray(b))
    tp = tx.Problem(tx.Func(lambda x: 0.5 * ((x - tt.to(x)) ** 2).sum(), n), linear_coeffs=A,
                    linear_lb=b, linear_ub=b, device="cpu")
    return jp, tp, np.zeros(n)


def hs64():
    """harness/hs.py::hs64."""
    from sleqp_tpu.harness.hs import get_problem

    def obj(x):
        return (5.0 * x[0] + 50000.0 / x[0] + 20.0 * x[1] + 72000.0 / x[1] + 10.0 * x[2]
                + 144000.0 / x[2])

    def cons(x):
        return (1.0 - 4.0 / x[0] - 32.0 / x[1] - 120.0 / x[2])[None]

    jp, x0, _ = get_problem("hs64")
    tp = tx.Problem(tx.Func(obj, 3, cons=cons, num_cons=1), var_lb=1e-5, general_lb=0.0,
                    general_ub=np.inf, device="cpu")
    return jp, tp, np.array(x0)


def hs62():
    """harness/hs.py::hs62 (the suite solves it with scaling="auto")."""
    from sleqp_tpu.harness.hs import get_problem

    def obj(x):
        s1 = (x[0] + x[1] + x[2] + 0.03) / (0.09 * x[0] + x[1] + x[2] + 0.03)
        s2 = (x[1] + x[2] + 0.03) / (0.07 * x[1] + x[2] + 0.03)
        s3 = (x[2] + 0.03) / (0.13 * x[2] + 0.03)
        return -32.174 * (255.0 * torch.log(s1) + 280.0 * torch.log(s2)
                          + 290.0 * torch.log(s3))

    jp, x0, _ = get_problem("hs62")
    tp = tx.Problem(tx.Func(obj, 3, cons=lambda x: (x.sum() - 1.0)[None], num_cons=1),
                    var_lb=0.0, var_ub=1.0, general_lb=0.0, general_ub=0.0, device="cpu")
    return jp, tp, np.array(x0)


def hs42_linear():
    """harness/hs.py::hs42 with its linear constraint x0 = 2 stated as a
    linear row (the suite states it as a general constraint), so that the
    preprocessor turns the row into a bound and fixes x0."""

    def jobj(x):
        return (x[0] - 1.0) ** 2 + (x[1] - 2.0) ** 2 + (x[2] - 3.0) ** 2 + (x[3] - 4.0) ** 2

    row = np.array([[1.0, 0.0, 0.0, 0.0]])
    jp = jx.Problem(jx.Func(jobj, 4, cons=lambda x: jnp.array([x[2] ** 2 + x[3] ** 2 - 2.0]),
                            num_cons=1),
                    general_lb=0.0, general_ub=0.0, linear_coeffs=jnp.asarray(row),
                    linear_lb=2.0, linear_ub=2.0)
    tp = tx.Problem(tx.Func(jobj, 4, cons=lambda x: (x[2] ** 2 + x[3] ** 2 - 2.0)[None],
                            num_cons=1),
                    general_lb=0.0, general_ub=0.0, linear_coeffs=row, linear_lb=2.0,
                    linear_ub=2.0, device="cpu")
    return jp, tp, np.ones(4)


# ---- one port iteration from every JAX iterate ------------------------------


def jax_states(jp, settings, x0, limit=100):
    """JAX's states from the start to the end of its solve (one jitted
    perform_iteration)."""
    import sleqp_tpu.problem_solver as jps

    step = jax.jit(lambda s: jps.perform_iteration(jp, settings, s))
    states = [jps.initial_state(jp, settings, jnp.asarray(x0))]
    while int(states[-1].status) == tx.Status.RUNNING and len(states) < limit:
        states.append(step(states[-1]))
    return states


def iteration_mismatches(tp, settings, states, tol=1e-9):
    """{k: mismatching fields} of one port perform_iteration from each JAX
    state against JAX's next state (``step_mismatches``)."""
    from sleqp_tpu_torch import problem_solver as tps

    bad = {}
    for k, (before, ref_after) in enumerate(zip(states[:-1], states[1:])):
        after = tps.perform_iteration(tp, settings, port_state(before))
        diff = step_mismatches(flat_port(after), flat_jax(ref_after), tol)
        if diff:
            bad[k] = diff
    return bad
