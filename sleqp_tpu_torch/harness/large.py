"""Large-scale (n >= 10^4) banded suite problems.

Port of ``sleqp_tpu/harness/large.py``: the reference's CUTEst sweep
reaches n ~ 10^4-10^5 through sparse factorizations; these entries route
such NLPs through the block-banded structured path (``banded.py``) and the
same CSV driver as the tiny and medium sets.  Same formulas, shapes,
bounds, starting points, optima and numpy seeds, written in torch
operations.  Data a formula closes over is made once on the device in
float64 and follows the argument's dtype inside the formula (``W.to(x)``),
so that the mixed route assembles in float32.

Each entry takes a device and returns (BandedProblem, X0, f_opt); the
driver detects the BandedProblem type and solves through
``banded_solve``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..banded import BandedProblem
from ..device import resolve_device

_REGISTRY: dict[str, Callable] = {}


def _register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_problem(name: str, device: Any = None):
    """(BandedProblem, X0, f_opt) of ``name`` on ``device`` (None means
    CUDA)."""
    return _REGISTRY[name](resolve_device(device))


def _on(a, device):
    return torch.as_tensor(a, dtype=torch.float64, device=device)


@_register("bandqp10k")
def bandqp10k(device):
    """Convex banded QP, n = 10240: separable quadratic pulled against
    linear coupling rows |S (x_{t+1} - x_t)| <= 0.2 and the box |x| <= 1.5.
    The target profile is infeasible for the couplings, so a substantial
    active set forms.  f_opt unknown analytically (None)."""
    N, k, q = 160, 64, 16
    rng = np.random.default_rng(7)
    W = _on(rng.standard_normal((N, k)), device)
    S = _on(rng.standard_normal((N - 1, q, k)) * 0.4, device)

    def obj(x, t):
        return torch.sum((x - W.to(x)[t]) ** 2)

    def cons(a, b, t):
        return S.to(a)[t] @ (b - a)

    p = BandedProblem(obj, N, k, cons_block=cons, cons_per_block=q, var_lb=-1.5, var_ub=1.5,
                      cons_lb=-0.2, cons_ub=0.2, device=device)
    return p, torch.zeros((N, k), dtype=torch.float64, device=device), None


@_register("bandrosen10k")
def bandrosen10k(device):
    """Chained-Rosenbrock banded NLP, n = 10240 (nonconvex; CUTEst CHNROSNB
    family): Rosenbrock valleys inside each block plus nonlinear coupling
    constraints between adjacent blocks, inactive at the optimum x = 1,
    f* = 0."""
    N, k, q = 160, 64, 8
    rng = np.random.default_rng(11)
    S = _on(rng.standard_normal((N - 1, q, k)) * 0.1, device)

    def obj(x, t):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    def cons(a, b, t):
        # zero at a == b == 1 (both couplings vanish), inside the bounds there
        St = S.to(a)[t]
        return St @ (b - a) + 0.01 * (St @ (a - b)) ** 2

    p = BandedProblem(obj, N, k, cons_block=cons, cons_per_block=q, var_lb=-5.0, var_ub=5.0,
                      cons_lb=-1.0, cons_ub=1.0, device=device)
    return p, torch.full((N, k), -1.2, dtype=torch.float64, device=device), 0.0


@_register("bandnl16k")
def bandnl16k(device):
    """Nonlinear banded NLP, n = 16384: nonconvex objective (quadratic +
    cosine ripple) with quadratic coupling constraints, the bench.py
    configuration scaled up 1.6x."""
    N, k, q = 256, 64, 16
    rng = np.random.default_rng(3)
    W = _on(rng.standard_normal((N, k)) * 0.5, device)
    S = _on(rng.standard_normal((N - 1, q, k)) * 0.3, device)

    def obj(x, t):
        return torch.sum((x - W.to(x)[t]) ** 2) + 0.1 * torch.sum(torch.cos(x))

    def cons(a, b, t):
        St = S.to(a)[t]
        return St @ (b - a) + 0.05 * (St @ a) ** 2

    p = BandedProblem(obj, N, k, cons_block=cons, cons_per_block=q, var_lb=-2.0, var_ub=2.0,
                      cons_lb=-0.3, cons_ub=0.3, device=device)
    return p, torch.zeros((N, k), dtype=torch.float64, device=device), None


LARGE_PROBLEMS = sorted(_REGISTRY.keys())
