"""Medium-scale (n ~ 100-1000) benchmark problems with known optima.

Port of ``sleqp_tpu/harness/medium.py``: scalable classics of the
Moré-Garbow-Hillstrom test set and of standard CUTEst families, and
constrained QPs whose optima follow from a projection, with the same
formulas, starting points, bounds, optima and numpy seeds, written in
torch operations.  Data a formula closes over is made once on the device
in float64 and follows the argument's dtype inside the formula.

Each entry takes a device and returns (Problem, x0, f_opt), as in hs.py.
``MEDIUM_PROBLEMS`` is built in two parts, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..problem import Func, LSQFunc, Problem

_REGISTRY: dict[str, Callable] = {}


def _register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_problem(name: str, device: Any = None):
    """(Problem, x0, f_opt) of ``name`` on ``device`` (None means CUDA)."""
    problem, x0, f_opt = _REGISTRY[name](resolve_device(device))
    return problem, torch.as_tensor(x0, dtype=torch.float64, device=problem.device), f_opt


def _on(a, device):
    return torch.as_tensor(a, dtype=torch.float64, device=device)


@_register("extrosnb100")
def extrosnb100(device):
    """Extended Rosenbrock, n=100 (MGH21 / CUTEst SROSENBR): f* = 0."""
    n = 100

    def obj(x):
        return torch.sum(100.0 * (x[1::2] - x[0::2] ** 2) ** 2 + (1.0 - x[0::2]) ** 2)

    func = Func(obj, num_variables=n)
    return Problem(func, device=device), np.tile([-1.2, 1.0], n // 2), 0.0


@_register("powellsg100")
def powellsg100(device):
    """Extended Powell singular, n=100 (MGH13 / CUTEst POWELLSG): f* = 0."""
    n = 100

    def obj(x):
        a, b, c, d = x[0::4], x[1::4], x[2::4], x[3::4]
        return torch.sum((a + 10.0 * b) ** 2 + 5.0 * (c - d) ** 2 + (b - 2.0 * c) ** 4
                         + 10.0 * (a - d) ** 4)

    func = Func(obj, num_variables=n)
    return Problem(func, device=device), np.tile([3.0, -1.0, 0.0, 1.0], n // 4), 0.0


@_register("dqrtic100")
def dqrtic100(device):
    """DQRTIC, n=100: min sum (x_i - i)^4, f* = 0."""
    n = 100
    tgt = _on(np.arange(1.0, n + 1.0), device)

    def obj(x):
        return torch.sum((x - tgt.to(x)) ** 4)

    func = Func(obj, num_variables=n)
    return Problem(func, device=device), np.full((n,), 2.0), 0.0


@_register("broydn100")
def broydn100(device):
    """Broyden tridiagonal system as LSQ, n=100 (MGH30 / CUTEst
    BROYDN3DLS): the system has a root, so f* = 0."""
    n = 100

    def residuals(x):
        z = torch.zeros(1, dtype=x.dtype, device=x.device)
        xm = torch.cat([z, x[:-1]])
        xp = torch.cat([x[1:], z])
        return (3.0 - 2.0 * x) * x - xm - 2.0 * xp + 1.0

    func = LSQFunc(residuals, num_variables=n, num_residuals=n)
    return Problem(func, device=device), np.full((n,), -1.0), 0.0


@_register("normsum500")
def normsum500(device):
    """Quadratic over the simplex-like plane, n=500:
    min ||x||^2 s.t. sum x = 1, x >= 0 -> x* = 1/n, f* = 1/n."""
    n = 500

    def obj(x):
        return torch.dot(x, x)

    func = Func(obj, num_variables=n, psd_hessian=True)
    problem = Problem(func, var_lb=0.0, var_ub=np.inf, linear_coeffs=np.ones((1, n)),
                      linear_lb=[1.0], linear_ub=[1.0], device=device)
    return problem, np.full((n,), 2.0 / n), 1.0 / n


@_register("boxqp1000")
def boxqp1000(device):
    """Separable box QP, n=1000: min sum (x_i - c_i)^2, 0 <= x <= 1;
    f* = sum dist(c_i, [0,1])^2 (closed form)."""
    n = 1000
    rng = np.random.default_rng(7)
    c = rng.uniform(-0.5, 1.5, n)
    f_opt = float(np.sum(np.clip(c - 1.0, 0.0, None) ** 2 + np.clip(-c, 0.0, None) ** 2))
    ct = _on(c, device)

    def obj(x):
        return torch.sum((x - ct.to(x)) ** 2)

    func = Func(obj, num_variables=n, psd_hessian=True)
    problem = Problem(func, var_lb=0.0, var_ub=1.0, device=device)
    return problem, np.full((n,), 0.5), f_opt


@_register("chainqp200")
def chainqp200(device):
    """Chained inequality QP, n=200: min sum (x_i - t_i)^2 s.t.
    |x_{i+1} - x_i| <= 0.006 with t_i = i/(n-1); the chain constraint
    is inactive at x = t (slope 1/(n-1) < 0.006), so f* = 0."""
    n = 200
    # jnp.linspace(0, 1, n) of the reference: the same float64 values
    t = _on(np.linspace(0.0, 1.0, n), device)

    def obj(x):
        return torch.sum((x - t.to(x)) ** 2)

    A = np.zeros((n - 1, n))
    for i in range(n - 1):
        A[i, i] = -1.0
        A[i, i + 1] = 1.0

    func = Func(obj, num_variables=n, psd_hessian=True)
    problem = Problem(func, linear_coeffs=A, linear_lb=-0.006, linear_ub=0.006, device=device)
    return problem, np.zeros((n,)), 0.0


MEDIUM_PROBLEMS = sorted(_REGISTRY.keys())


# ---------------------------------------------------------------------------
# later additions (suite breadth: MGH/CUTEst families + constrained QPs
# with projection-analytic optima + LSQ coverage at n ~ 10^2-10^3)
# ---------------------------------------------------------------------------


@_register("woodext100")
def woodext100(device):
    """Extended Wood, n=100 (MGH14 / CUTEst WOODS): f* = 0 at x = 1."""
    n = 100

    def obj(x):
        x1, x2, x3, x4 = x[0::4], x[1::4], x[2::4], x[3::4]
        return torch.sum(
            100.0 * (x2 - x1**2) ** 2
            + (1.0 - x1) ** 2
            + 90.0 * (x4 - x3**2) ** 2
            + (1.0 - x3) ** 2
            + 10.1 * ((x2 - 1.0) ** 2 + (x4 - 1.0) ** 2)
            + 19.8 * (x2 - 1.0) * (x4 - 1.0)
        )

    func = Func(obj, num_variables=n)
    return Problem(func, device=device), np.tile([-3.0, -1.0, -3.0, -1.0], n // 4), 0.0


@_register("arwhead100")
def arwhead100(device):
    """CUTEst ARWHEAD, n=100: f* = 0 at x_i = 1 (i < n), x_n = 0."""
    n = 100

    def obj(x):
        return torch.sum((x[:-1] ** 2 + x[-1] ** 2) ** 2 - 4.0 * x[:-1] + 3.0)

    func = Func(obj, num_variables=n)
    return Problem(func, device=device), np.ones((n,)), 0.0


@_register("nondia100")
def nondia100(device):
    """CUTEst NONDIA, n=100: f* = 0 at x = 1."""
    n = 100

    def obj(x):
        return (x[0] - 1.0) ** 2 + torch.sum(100.0 * (x[0] - x[:-1] ** 2) ** 2)

    func = Func(obj, num_variables=n)
    return Problem(func, device=device), np.full((n,), -1.0), 0.0


@_register("liarwhd100")
def liarwhd100(device):
    """CUTEst LIARWHD, n=100: f* = 0 at x = 1."""
    n = 100

    def obj(x):
        return torch.sum(4.0 * (x**2 - x[0]) ** 2 + (x - 1.0) ** 2)

    func = Func(obj, num_variables=n)
    return Problem(func, device=device), np.full((n,), 4.0), 0.0


@_register("extbeale100")
def extbeale100(device):
    """Extended Beale, n=100 (pairs of the MGH5 Beale function):
    f* = 0 at (3, 0.5) per pair."""
    n = 100

    def obj(x):
        a, b = x[0::2], x[1::2]
        return torch.sum(
            (1.5 - a * (1.0 - b)) ** 2
            + (2.25 - a * (1.0 - b**2)) ** 2
            + (2.625 - a * (1.0 - b**3)) ** 2
        )

    func = Func(obj, num_variables=n)
    return Problem(func, device=device), np.tile([1.0, 1.0], n // 2), 0.0


@_register("projqp500")
def projqp500(device):
    """Equality-constrained QP, n=500, m=20: min 1/2||x - t||^2 s.t.
    A x = b.  The optimum is the affine projection x* = t - A^T
    (A A^T)^-1 (A t - b); f* computed from it at build time."""
    n, m = 500, 20
    rng = np.random.default_rng(17)
    A = rng.standard_normal((m, n))
    t = rng.standard_normal(n)
    b = rng.standard_normal(m)
    corr = np.linalg.solve(A @ A.T, A @ t - b)
    x_star = t - A.T @ corr
    f_opt = 0.5 * float(np.sum((x_star - t) ** 2))
    tt = _on(t, device)

    def obj(x):
        return 0.5 * torch.sum((x - tt.to(x)) ** 2)

    func = Func(obj, num_variables=n)
    problem = Problem(func, linear_coeffs=A, linear_lb=b, linear_ub=b, device=device)
    return problem, np.zeros((n,)), f_opt


@_register("boundqp300")
def boundqp300(device):
    """Bound-constrained QP, n=300: min 1/2||x - t||^2 s.t. x >= 0 —
    x* = max(t, 0), f* = 1/2||min(t, 0)||^2 (half the targets are
    negative, so ~150 bounds are active)."""
    n = 300
    rng = np.random.default_rng(23)
    t = rng.standard_normal(n)
    f_opt = 0.5 * float(np.sum(np.minimum(t, 0.0) ** 2))
    tt = _on(t, device)

    def obj(x):
        return 0.5 * torch.sum((x - tt.to(x)) ** 2)

    func = Func(obj, num_variables=n)
    return Problem(func, var_lb=0.0, device=device), np.ones((n,)), f_opt


@_register("degenqp100")
def degenqp100(device):
    """Degenerate constraints, n=100: the same equality row repeated
    three times (rank-1 constraint block); x* = projection of t onto
    {sum x = 1}."""
    n = 100
    rng = np.random.default_rng(5)
    t = rng.standard_normal(n)
    x_star = t + (1.0 - t.sum()) / n
    f_opt = 0.5 * float(np.sum((x_star - t) ** 2))
    tt = _on(t, device)

    def obj(x):
        return 0.5 * torch.sum((x - tt.to(x)) ** 2)

    func = Func(obj, num_variables=n)
    problem = Problem(func, linear_coeffs=np.ones((3, n)), linear_lb=1.0, linear_ub=1.0,
                      device=device)
    return problem, np.zeros((n,)), f_opt


@_register("linlsq300")
def linlsq300(device):
    """Linear least squares through the LSQ/Gauss-Newton path, n=300,
    200 residuals: f* from the normal equations at build time."""
    n, m = 300, 200
    rng = np.random.default_rng(31)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    b = rng.standard_normal(m)
    x_star, *_ = np.linalg.lstsq(A, b, rcond=None)
    f_opt = 0.5 * float(np.sum((A @ x_star - b) ** 2))
    At, bt = _on(A, device), _on(b, device)

    def residuals(x):
        return At.to(x) @ x - bt.to(x)

    func = LSQFunc(residuals, num_variables=n, num_residuals=m)
    return Problem(func, device=device), np.zeros((n,)), f_opt


@_register("chainineq200")
def chainineq200(device):
    """Inequality-chained convex QP, n=200: min 1/2||x - t||^2 s.t.
    |x_{i+1} - x_i| <= 0.05; a long active chain forms.  f_opt is not
    known analytically (None); the contract is the KKT residuals."""
    n = 200
    rng = np.random.default_rng(41)
    tt = _on(np.cumsum(rng.standard_normal(n)) * 0.2, device)

    def obj(x):
        return 0.5 * torch.sum((x - tt.to(x)) ** 2)

    def cons(x):
        return x[1:] - x[:-1]

    func = Func(obj, num_variables=n, cons=cons, num_cons=n - 1)
    return Problem(func, general_lb=-0.05, general_ub=0.05, device=device), np.zeros((n,)), None


MEDIUM_PROBLEMS = sorted(_REGISTRY.keys())
