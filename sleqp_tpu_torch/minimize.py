"""scipy-style ``minimize`` front end.

Port of ``sleqp_tpu/minimize.py`` (reference Python binding,
bindings/python/src/sleqp/minimize.py): a drop-in for
:func:`scipy.optimize.minimize` that returns a scipy ``OptimizeResult``.

Two function paths:

* **torch-traceable** callables, told apart by a probe under
  ``torch.func.grad`` (a function that calls numpy on its argument, or
  returns a Python number, fails it): wrapped directly, derivatives from
  ``torch.func`` AD unless given.
* **Host (numpy) callables**: called on the iterate copied to the host as
  a float64 numpy array, their result sent back to the problem's device;
  derivatives from the given ``jac`` and constraint Jacobians or forward
  finite differences (the reference's findiff fallback,
  bindings/python/src/sleqp/_derivative.py), Hessians by damped BFGS
  unless ``hessp`` is given.  The reference needs ``jax.pure_callback``
  for this inside its compiled loop; the port's loop is eager.

``device=None`` runs the solve on CUDA, as every entry point of the port.
"""

from __future__ import annotations

import dataclasses
import sys
import types
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from .device import resolve_device
from .problem import Func, Problem
from .settings import Settings
from .solver import Solver, SolverEvent
from .types import HessEval, Status

Tensor = torch.Tensor

try:  # scipy is expected; degrade gracefully without it
    from scipy.optimize import Bounds as ScipyBounds
    from scipy.optimize import LinearConstraint, NonlinearConstraint, OptimizeResult
except ImportError:  # pragma: no cover
    ScipyBounds = LinearConstraint = NonlinearConstraint = None

    class OptimizeResult(dict):
        def __getattr__(self, name):
            return self[name]


_STATUS_MESSAGES = {
    Status.OPTIMAL: "Optimal solution found",
    Status.INFEASIBLE: "Problem is locally infeasible",
    Status.UNBOUNDED: "Problem appears unbounded",
    Status.ABORT_ITER: "Iteration limit reached",
    Status.ABORT_TIME: "Time limit reached",
    Status.ABORT_MANUAL: "Aborted by callback",
    Status.ABORT_DEADPOINT: "Stalled at a dead point",
    Status.UNKNOWN: "Unknown",
    Status.RUNNING: "Running",
}


def _is_traceable(fn: Callable, x0: np.ndarray, args: tuple, device: torch.device) -> bool:
    """Whether ``fn(x, *args)`` returns a tensor that ``torch.func.grad``
    can differentiate, at x0 on ``device``."""

    def probe(x):
        out = fn(x, *args)
        if not isinstance(out, Tensor):
            raise TypeError("not a tensor")
        return out.reshape(-1).sum()

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.func.grad(probe)(torch.as_tensor(x0, dtype=torch.float64, device=device))
        return True
    except Exception:
        return False


def _to_host(x: Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def _host_fn(fn: Callable, args: tuple, out_dim: tuple):
    """``fn`` (numpy in, numpy out) as a function of a tensor x: called on
    x's float64 host copy, its result reshaped to ``out_dim`` and returned
    on x's device in x's dtype."""

    def wrapped(x: Tensor) -> Tensor:
        out = np.reshape(np.asarray(fn(_to_host(x), *args), dtype=np.float64), out_dim)
        return torch.as_tensor(out, dtype=x.dtype, device=x.device)

    return wrapped


def _findiff_grad(fn: Callable, args: tuple, n: int, h: float):
    """Forward-difference gradient on the host (reference _derivative.py)."""

    def grad(xv, *_):
        xv = np.asarray(xv, dtype=np.float64)
        f0 = float(fn(xv, *args))
        out = np.zeros(n)
        for i in range(n):
            xp = xv.copy()
            xp[i] += h
            out[i] = (float(fn(xp, *args)) - f0) / h
        return out

    return grad


def _findiff_jac(fn: Callable, args: tuple, n: int, m: int, h: float):
    def jac(xv, *_):
        xv = np.asarray(xv, dtype=np.float64)
        f0 = np.asarray(fn(xv, *args), dtype=np.float64).reshape(m)
        out = np.zeros((m, n))
        for i in range(n):
            xp = xv.copy()
            xp[i] += h
            out[:, i] = (np.asarray(fn(xp, *args), dtype=np.float64).reshape(m) - f0) / h
        return out

    return jac


def _parse_bounds(bounds, n: int):
    if bounds is None:
        return None, None
    if ScipyBounds is not None and isinstance(bounds, ScipyBounds):
        return (np.array(np.broadcast_to(bounds.lb, (n,)), dtype=np.float64),
                np.array(np.broadcast_to(bounds.ub, (n,)), dtype=np.float64))
    lb = np.full(n, -np.inf)
    ub = np.full(n, np.inf)
    for i, pair in enumerate(bounds):
        lo, hi = pair
        lb[i] = -np.inf if lo is None else lo
        ub[i] = np.inf if hi is None else hi
    return lb, ub


@dataclasses.dataclass
class _ConsBlock:
    fun: Callable
    jac: Optional[Callable]
    lb: np.ndarray
    ub: np.ndarray
    dim: int


def _probe_dim(fn: Callable, x0: np.ndarray, args: tuple, device: torch.device) -> int:
    """The length of ``fn``'s value at x0: called on a tensor on
    ``device``, and on a numpy array where that fails."""
    try:
        out = fn(torch.as_tensor(x0, device=device), *args)
        out = out.detach().cpu() if isinstance(out, Tensor) else out
        return int(np.atleast_1d(np.asarray(out)).shape[0])
    except Exception:
        return int(np.atleast_1d(np.asarray(fn(np.asarray(x0), *args))).shape[0])


def _parse_constraints(constraints, x0, args, device) -> tuple[list[_ConsBlock], list]:
    """Split into general (nonlinear) blocks and linear blocks."""
    if constraints is None:
        return [], []
    if isinstance(constraints, dict) or (
        NonlinearConstraint is not None
        and isinstance(constraints, (NonlinearConstraint, LinearConstraint))
    ):
        constraints = [constraints]
    general: list[_ConsBlock] = []
    linear = []
    for con in constraints:
        if LinearConstraint is not None and isinstance(con, LinearConstraint):
            A = np.atleast_2d(np.asarray(con.A, dtype=np.float64))
            rows = A.shape[0]
            linear.append((A, np.broadcast_to(np.asarray(con.lb, dtype=np.float64), (rows,)),
                           np.broadcast_to(np.asarray(con.ub, dtype=np.float64), (rows,))))
            continue
        if NonlinearConstraint is not None and isinstance(con, NonlinearConstraint):
            dim = _probe_dim(con.fun, x0, (), device)
            jac = con.jac if callable(con.jac) else None
            general.append(_ConsBlock(
                fun=lambda x, *a, f=con.fun: f(x),
                jac=(lambda x, *a, j=jac: j(x)) if jac else None,
                lb=np.broadcast_to(np.asarray(con.lb, dtype=np.float64), (dim,)),
                ub=np.broadcast_to(np.asarray(con.ub, dtype=np.float64), (dim,)),
                dim=dim))
            continue
        if isinstance(con, dict):
            kind = con["type"]
            fn = con["fun"]
            jac = con.get("jac")
            cargs = tuple(con.get("args", ()))
            dim = _probe_dim(fn, x0, cargs, device)
            if kind == "eq":
                lb, ub = np.zeros(dim), np.zeros(dim)
            elif kind == "ineq":  # scipy convention: fun(x) >= 0
                lb, ub = np.zeros(dim), np.full(dim, np.inf)
            else:
                raise ValueError(f"unknown constraint type {kind!r}")
            general.append(_ConsBlock(
                fun=lambda x, *a, f=fn, ca=cargs: f(x, *ca),
                jac=(lambda x, *a, j=jac, ca=cargs: j(x, *ca)) if callable(jac) else None,
                lb=lb, ub=ub, dim=dim))
            continue
        raise ValueError(f"unsupported constraint spec: {con!r}")
    return general, linear


def _as_rows(v: Any, like: Tensor, shape: tuple) -> Tensor:
    """A traceable callable's value as a tensor of ``shape`` on ``like``'s
    device (a tensor, a number, or a sequence of 0-d tensors)."""
    if isinstance(v, (list, tuple)):
        v = torch.stack([torch.as_tensor(e, dtype=like.dtype, device=like.device) for e in v])
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(shape)


def minimize(
    fun: Callable,
    x0,
    args: tuple = (),
    jac: Optional[Callable] = None,
    hess: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    bounds=None,
    constraints=None,
    callback: Optional[Callable] = None,
    device: Any = None,
    **options: Any,
) -> OptimizeResult:
    """Drop-in for scipy.optimize.minimize (reference minimize.py:165-).
    ``options`` are ``max_iterations`` (or ``maxiter``), ``time_limit``,
    ``verbose`` and any ``Settings`` field.  ``device=None`` means CUDA."""
    if not isinstance(args, tuple):
        args = (args,)
    device = resolve_device(device)
    x0 = np.atleast_1d(np.asarray(x0, dtype=np.float64))
    n = x0.shape[0]

    max_iterations = options.pop("max_iterations", options.pop("maxiter", 1000))
    time_limit = options.pop("time_limit", None)
    options.pop("verbose", False)

    settings = Settings()
    if options:
        valid = {f.name for f in dataclasses.fields(Settings)}
        unknown = set(options) - valid
        if unknown:
            raise ValueError(f"unknown options: {sorted(unknown)}")
        settings = settings.replace(**options)

    general, linear = _parse_constraints(constraints, x0, args, device)

    traceable = _is_traceable(fun, x0, args, device) and all(
        _is_traceable(b.fun, x0, (), device) for b in general)

    h = settings.deriv_perturbation
    num_general = sum(b.dim for b in general)
    cons = cons_jac = hess_prod = None

    if traceable:
        def obj(x):
            return fun(x, *args)

        obj_grad = (lambda x: _as_rows(jac(x, *args), x, (n,))) if callable(jac) else None
        if general:
            blocks = list(general)

            def cons(x):
                return torch.cat([_as_rows(b.fun(x), x, (b.dim,)) for b in blocks])

            if all(b.jac is not None for b in blocks):
                def cons_jac(x):
                    return torch.cat([_as_rows(b.jac(x), x, (b.dim, n)) for b in blocks])
        if callable(hessp):
            def hess_prod(x, d, mu):
                return _as_rows(hessp(x, d, *args), x, (n,))
        elif callable(hess):
            def hess_prod(x, d, mu):
                return _as_rows(hess(x, *args), x, (n, n)) @ d
    else:
        # host path: numpy calls on the iterate's host copy, findiff fallbacks
        obj = _host_fn(fun, args, ())
        obj_grad = _host_fn(jac if callable(jac) else _findiff_grad(fun, args, n, h), (), (n,))
        if general:
            blocks = list(general)

            def host_cons(xv):
                return np.concatenate([
                    np.reshape(np.asarray(b.fun(xv), dtype=np.float64), (b.dim,))
                    for b in blocks])

            def host_jac(xv):
                rows = []
                for b in blocks:
                    if b.jac is not None:
                        rows.append(np.reshape(np.asarray(b.jac(xv), dtype=np.float64),
                                               (b.dim, n)))
                    else:
                        rows.append(_findiff_jac(b.fun, (), n, b.dim, h)(xv))
                return np.concatenate(rows, axis=0)

            cons = _host_fn(host_cons, (), (num_general,))
            cons_jac = _host_fn(host_jac, (), (num_general, n))
        if callable(hessp):
            def hess_prod(x, d, mu):
                return _host_fn(lambda xv: hessp(xv, _to_host(d), *args), (), (n,))(x)
        # no exact Hessians on the host path otherwise: quasi-Newton
        if hess_prod is None and settings.hess_eval == HessEval.EXACT:
            settings = settings.replace(hess_eval=HessEval.DAMPED_BFGS)

    var_lb, var_ub = _parse_bounds(bounds, n)
    general_lb = np.concatenate([b.lb for b in general]) if general else None
    general_ub = np.concatenate([b.ub for b in general]) if general else None
    lin_A = np.concatenate([A for A, _, _ in linear]) if linear else None
    lin_lb = np.concatenate([lb for _, lb, _ in linear]) if linear else None
    lin_ub = np.concatenate([ub for _, _, ub in linear]) if linear else None

    func = Func(obj, num_variables=n, cons=cons, num_cons=num_general, obj_grad=obj_grad,
                cons_jac=cons_jac, hess_prod=hess_prod)
    func.runs_on_host = not traceable
    problem = Problem(func, var_lb=var_lb, var_ub=var_ub, general_lb=general_lb,
                      general_ub=general_ub, linear_coeffs=lin_A, linear_lb=lin_lb,
                      linear_ub=lin_ub, device=device)

    solver = Solver(problem, x0, settings, device=device)
    if callback is not None:
        def on_accept(s):
            if callback(s.solution) is True:
                s.abort()

        solver.add_callback(SolverEvent.ACCEPTED_ITERATE, on_accept)

    status = solver.solve(max_iterations=max_iterations, time_limit=time_limit)

    result = OptimizeResult()
    result["x"] = solver.solution
    result["fun"] = solver.obj_val
    result["jac"] = _to_host(solver.iterate.obj_grad)
    result["mult_g"] = solver.cons_dual
    result["mult_x"] = solver.vars_dual
    result["success"] = status == Status.OPTIMAL
    result["status"] = int(status)
    result["message"] = _STATUS_MESSAGES.get(status, status.name)
    result["nit"] = solver.iterations
    result["maxcv"] = solver.residuals()[0]
    return result


class _CallableModule(types.ModuleType):
    """Importing this module makes it the package's ``minimize``
    attribute (Python binds a submodule to its parent), so
    ``from sleqp_tpu_torch import minimize`` gives the module: calling it
    calls the function."""

    def __call__(self, *args, **kwargs):
        return minimize(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
