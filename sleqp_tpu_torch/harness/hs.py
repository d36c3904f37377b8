"""Hock-Schittkowski test problems as NLPs of the port.

Port of ``sleqp_tpu/harness/hs.py``: the same problems, transcribed from
the published statements (W. Hock, K. Schittkowski, "Test Examples for
Nonlinear Programming Codes", 1981), with the same formulas, starting
points, bounds and published optima, written in torch operations.  A
vector of scalar expressions (``jnp.array([...])`` in the reference) is
stacked with ``_vec``; constants a formula closes over follow the
argument's dtype and device, so the float32 Hessian product of the mixed
route runs them in float32.

Each entry takes a device and returns (Problem, x0, f_opt) with f_opt the
published optimal objective value (None when only feasibility matters).
``HS_PROBLEMS`` is built in two parts, as in the reference: the original
set, then the later additions.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..problem import Func, Problem

Tensor = torch.Tensor

INF = math.inf

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


def _vec(items) -> Tensor:
    """A vector of scalar expressions; constants among them follow the
    dtype and device of the tensors (filled there: a copy from the host
    would synchronize, which a CUDA graph of the iteration cannot
    capture)."""
    like = next(v for v in items if isinstance(v, Tensor))
    return torch.stack([v if isinstance(v, Tensor)
                        else torch.full((), float(v), dtype=like.dtype, device=like.device)
                        for v in items])


def _make(
    device,
    obj,
    n,
    x0,
    cons=None,
    m=0,
    var_lb=None,
    var_ub=None,
    cons_lb=None,
    cons_ub=None,
):
    func = Func(obj, num_variables=n, cons=cons, num_cons=m)
    problem = Problem(
        func,
        var_lb=var_lb,
        var_ub=var_ub,
        general_lb=cons_lb,
        general_ub=cons_ub,
        device=device,
    )
    return problem, torch.as_tensor(x0, dtype=torch.float64, device=device)


# ---------------------------------------------------------------------------
# unconstrained / box-constrained
# ---------------------------------------------------------------------------


@_register("hs1")
def hs1(device):
    obj = lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
    p, x0 = _make(device, obj, 2, [-2.0, 1.0], var_lb=[-INF, -1.5])
    return p, x0, 0.0


@_register("hs3")
def hs3(device):
    obj = lambda x: x[1] + 1e-5 * (x[1] - x[0]) ** 2
    p, x0 = _make(device, obj, 2, [10.0, 1.0], var_lb=[-INF, 0.0])
    return p, x0, 0.0


@_register("hs4")
def hs4(device):
    obj = lambda x: (x[0] + 1.0) ** 3 / 3.0 + x[1]
    p, x0 = _make(device, obj, 2, [1.125, 0.125], var_lb=[1.0, 0.0])
    return p, x0, 8.0 / 3.0


@_register("hs5")
def hs5(device):
    obj = lambda x: (
        torch.sin(x[0] + x[1])
        + (x[0] - x[1]) ** 2
        - 1.5 * x[0]
        + 2.5 * x[1]
        + 1.0
    )
    p, x0 = _make(
        device,
        obj, 2, [0.0, 0.0], var_lb=[-1.5, -3.0], var_ub=[4.0, 3.0]
    )
    return p, x0, -(math.sqrt(3.0) / 2.0 + math.pi / 3.0)


@_register("hs38")
def hs38(device):
    def obj(x):
        return (
            100.0 * (x[1] - x[0] ** 2) ** 2
            + (1.0 - x[0]) ** 2
            + 90.0 * (x[3] - x[2] ** 2) ** 2
            + (1.0 - x[2]) ** 2
            + 10.1 * ((x[1] - 1.0) ** 2 + (x[3] - 1.0) ** 2)
            + 19.8 * (x[1] - 1.0) * (x[3] - 1.0)
        )

    p, x0 = _make(
        device,
        obj, 4, [-3.0, -1.0, -3.0, -1.0], var_lb=-10.0, var_ub=10.0
    )
    return p, x0, 0.0


@_register("hs45")
def hs45(device):
    obj = lambda x: 2.0 - x[0] * x[1] * x[2] * x[3] * x[4] / 120.0
    p, x0 = _make(
        device,
        obj,
        5,
        [2.0] * 5,
        var_lb=0.0,
        var_ub=np.arange(1.0, 6.0),
    )
    return p, x0, 1.0


# ---------------------------------------------------------------------------
# equality constrained
# ---------------------------------------------------------------------------


@_register("hs6")
def hs6(device):
    obj = lambda x: (1.0 - x[0]) ** 2
    cons = lambda x: _vec([10.0 * (x[1] - x[0] ** 2)])
    p, x0 = _make(
        device,
        obj, 2, [-1.2, 1.0], cons=cons, m=1, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, 0.0


@_register("hs7")
def hs7(device):
    obj = lambda x: torch.log(1.0 + x[0] ** 2) - x[1]
    cons = lambda x: _vec([(1.0 + x[0] ** 2) ** 2 + x[1] ** 2 - 4.0])
    p, x0 = _make(
        device,
        obj, 2, [2.0, 2.0], cons=cons, m=1, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, -math.sqrt(3.0)


@_register("hs8")
def hs8(device):
    obj = lambda x: -1.0 + 0.0 * x[0]
    cons = lambda x: _vec(
        [x[0] ** 2 + x[1] ** 2 - 25.0, x[0] * x[1] - 9.0]
    )
    p, x0 = _make(
        device,
        obj, 2, [2.0, 1.0], cons=cons, m=2, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, -1.0


@_register("hs9")
def hs9(device):
    obj = lambda x: torch.sin(math.pi * x[0] / 12.0) * torch.cos(
        math.pi * x[1] / 16.0
    )
    cons = lambda x: _vec([4.0 * x[0] - 3.0 * x[1]])
    p, x0 = _make(
        device,
        obj, 2, [0.0, 0.0], cons=cons, m=1, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, -0.5


@_register("hs26")
def hs26(device):
    obj = lambda x: (x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 4
    cons = lambda x: _vec([(1.0 + x[1] ** 2) * x[0] + x[2] ** 4 - 3.0])
    p, x0 = _make(
        device,
        obj, 3, [-2.6, 2.0, 2.0], cons=cons, m=1, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, 0.0


@_register("hs27")
def hs27(device):
    obj = lambda x: 0.01 * (x[0] - 1.0) ** 2 + (x[1] - x[0] ** 2) ** 2
    cons = lambda x: _vec([x[0] + x[2] ** 2 + 1.0])
    p, x0 = _make(
        device,
        obj, 3, [2.0, 2.0, 2.0], cons=cons, m=1, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, 0.04


@_register("hs28")
def hs28(device):
    obj = lambda x: (x[0] + x[1]) ** 2 + (x[1] + x[2]) ** 2
    p, x0 = _make(
        device,
        lambda x: (x[0] + x[1]) ** 2 + (x[1] + x[2]) ** 2,
        3,
        [-4.0, 1.0, 1.0],
    )
    # linear constraint x1 + 2 x2 + 3 x3 = 1
    func = Func(obj, num_variables=3)
    problem = Problem(
        func,
        device=device,
        linear_coeffs=np.array([[1.0, 2.0, 3.0]]),
        linear_lb=1.0,
        linear_ub=1.0,
    )
    return problem, x0, 0.0


@_register("hs39")
def hs39(device):
    obj = lambda x: -x[0]
    cons = lambda x: _vec(
        [x[1] - x[0] ** 3 - x[2] ** 2, x[0] ** 2 - x[1] - x[3] ** 2]
    )
    p, x0 = _make(
        device,
        obj, 4, [2.0, 2.0, 2.0, 2.0], cons=cons, m=2, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, -1.0


@_register("hs40")
def hs40(device):
    obj = lambda x: -x[0] * x[1] * x[2] * x[3]
    cons = lambda x: _vec(
        [
            x[0] ** 3 + x[1] ** 2 - 1.0,
            x[0] ** 2 * x[3] - x[2],
            x[3] ** 2 - x[1],
        ]
    )
    p, x0 = _make(
        device,
        obj, 4, [0.8, 0.8, 0.8, 0.8], cons=cons, m=3, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, -0.25


@_register("hs42")
def hs42(device):
    obj = lambda x: (
        (x[0] - 1.0) ** 2
        + (x[1] - 2.0) ** 2
        + (x[2] - 3.0) ** 2
        + (x[3] - 4.0) ** 2
    )
    cons = lambda x: _vec([x[0] - 2.0, x[2] ** 2 + x[3] ** 2 - 2.0])
    p, x0 = _make(
        device,
        obj, 4, [1.0, 1.0, 1.0, 1.0], cons=cons, m=2, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, 28.0 - 10.0 * math.sqrt(2.0)


@_register("hs48")
def hs48(device):
    obj = lambda x: (x[0] - 1.0) ** 2 + (x[1] - x[2]) ** 2 + (x[3] - x[4]) ** 2
    func = Func(obj, num_variables=5)
    problem = Problem(
        func,
        device=device,
        linear_coeffs=np.array(
            [[1.0, 1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 1.0, -2.0, -2.0]]
        ),
        linear_lb=np.array([5.0, -3.0]),
        linear_ub=np.array([5.0, -3.0]),
    )
    return problem, np.array([3.0, 5.0, -3.0, 2.0, -2.0]), 0.0


@_register("hs51")
def hs51(device):
    obj = lambda x: (
        (x[0] - x[1]) ** 2
        + (x[1] + x[2] - 2.0) ** 2
        + (x[3] - 1.0) ** 2
        + (x[4] - 1.0) ** 2
    )
    func = Func(obj, num_variables=5)
    problem = Problem(
        func,
        device=device,
        linear_coeffs=np.array(
            [
                [1.0, 3.0, 0.0, 0.0, 0.0],
                [0.0, 0.0, 1.0, 1.0, -2.0],
                [0.0, 1.0, 0.0, 0.0, -1.0],
            ]
        ),
        linear_lb=np.array([4.0, 0.0, 0.0]),
        linear_ub=np.array([4.0, 0.0, 0.0]),
    )
    return problem, np.array([2.5, 0.5, 2.0, -1.0, 0.5]), 0.0


@_register("hs52")
def hs52(device):
    obj = lambda x: (
        (4.0 * x[0] - x[1]) ** 2
        + (x[1] + x[2] - 2.0) ** 2
        + (x[3] - 1.0) ** 2
        + (x[4] - 1.0) ** 2
    )
    func = Func(obj, num_variables=5)
    problem = Problem(
        func,
        device=device,
        linear_coeffs=np.array(
            [
                [1.0, 3.0, 0.0, 0.0, 0.0],
                [0.0, 0.0, 1.0, 1.0, -2.0],
                [0.0, 1.0, 0.0, 0.0, -1.0],
            ]
        ),
        linear_lb=np.array([0.0, 0.0, 0.0]),
        linear_ub=np.array([0.0, 0.0, 0.0]),
    )
    return problem, np.array([2.0, 2.0, 2.0, 2.0, 2.0]), 1859.0 / 349.0


# ---------------------------------------------------------------------------
# inequality constrained
# ---------------------------------------------------------------------------


@_register("hs10")
def hs10(device):
    obj = lambda x: x[0] - x[1]
    cons = lambda x: _vec(
        [-3.0 * x[0] ** 2 + 2.0 * x[0] * x[1] - x[1] ** 2 + 1.0]
    )
    p, x0 = _make(
        device,
        obj, 2, [-10.0, 10.0], cons=cons, m=1, cons_lb=0.0, cons_ub=INF
    )
    return p, x0, -1.0


@_register("hs11")
def hs11(device):
    obj = lambda x: (x[0] - 5.0) ** 2 + x[1] ** 2 - 25.0
    cons = lambda x: _vec([-(x[0] ** 2) + x[1]])
    p, x0 = _make(
        device,
        obj, 2, [4.9, 0.1], cons=cons, m=1, cons_lb=0.0, cons_ub=INF
    )
    return p, x0, -8.498464223


@_register("hs12")
def hs12(device):
    obj = lambda x: (
        0.5 * x[0] ** 2 + x[1] ** 2 - x[0] * x[1] - 7.0 * x[0] - 7.0 * x[1]
    )
    cons = lambda x: _vec([25.0 - 4.0 * x[0] ** 2 - x[1] ** 2])
    p, x0 = _make(
        device,
        obj, 2, [0.0, 0.0], cons=cons, m=1, cons_lb=0.0, cons_ub=INF
    )
    return p, x0, -30.0


@_register("hs14")
def hs14(device):
    obj = lambda x: (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2
    cons = lambda x: _vec(
        [
            x[0] - 2.0 * x[1] + 1.0,
            -0.25 * x[0] ** 2 - x[1] ** 2 + 1.0,
        ]
    )
    p, x0 = _make(
        device,
        obj,
        2,
        [2.0, 2.0],
        cons=cons,
        m=2,
        cons_lb=np.array([0.0, 0.0]),
        cons_ub=np.array([0.0, INF]),
    )
    return p, x0, 9.0 - 2.875 * math.sqrt(7.0)


@_register("hs15")
def hs15(device):
    obj = lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
    cons = lambda x: _vec([x[0] * x[1] - 1.0, x[0] + x[1] ** 2])
    p, x0 = _make(
        device,
        obj,
        2,
        [-2.0, 1.0],
        cons=cons,
        m=2,
        var_ub=[0.5, INF],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 306.5


@_register("hs18")
def hs18(device):
    obj = lambda x: 0.01 * x[0] ** 2 + x[1] ** 2
    cons = lambda x: _vec(
        [x[0] * x[1] - 25.0, x[0] ** 2 + x[1] ** 2 - 25.0]
    )
    p, x0 = _make(
        device,
        obj,
        2,
        [2.0, 2.0],
        cons=cons,
        m=2,
        var_lb=[2.0, 0.0],
        var_ub=[50.0, 50.0],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 5.0


@_register("hs21")
def hs21(device):
    obj = lambda x: 0.01 * x[0] ** 2 + x[1] ** 2 - 100.0
    func = Func(obj, num_variables=2)
    problem = Problem(
        func,
        device=device,
        var_lb=np.array([2.0, -50.0]),
        var_ub=np.array([50.0, 50.0]),
        linear_coeffs=np.array([[10.0, -1.0]]),
        linear_lb=10.0,
        linear_ub=INF,
    )
    return problem, np.array([-1.0, -1.0]), -99.96


@_register("hs22")
def hs22(device):
    obj = lambda x: (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2
    cons = lambda x: _vec([-x[0] - x[1] + 2.0, -(x[0] ** 2) + x[1]])
    p, x0 = _make(
        device,
        obj, 2, [2.0, 2.0], cons=cons, m=2, cons_lb=0.0, cons_ub=INF
    )
    return p, x0, 1.0


@_register("hs23")
def hs23(device):
    obj = lambda x: x[0] ** 2 + x[1] ** 2
    cons = lambda x: _vec(
        [
            x[0] + x[1] - 1.0,
            x[0] ** 2 + x[1] ** 2 - 1.0,
            9.0 * x[0] ** 2 + x[1] ** 2 - 9.0,
            x[0] ** 2 - x[1],
            x[1] ** 2 - x[0],
        ]
    )
    p, x0 = _make(
        device,
        obj,
        2,
        [3.0, 1.0],
        cons=cons,
        m=5,
        var_lb=-50.0,
        var_ub=50.0,
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 2.0


@_register("hs29")
def hs29(device):
    obj = lambda x: -x[0] * x[1] * x[2]
    cons = lambda x: _vec(
        [-(x[0] ** 2) - 2.0 * x[1] ** 2 - 4.0 * x[2] ** 2 + 48.0]
    )
    p, x0 = _make(
        device,
        obj, 3, [1.0, 1.0, 1.0], cons=cons, m=1, cons_lb=0.0, cons_ub=INF
    )
    return p, x0, -16.0 * math.sqrt(2.0)


@_register("hs30")
def hs30(device):
    obj = lambda x: x[0] ** 2 + x[1] ** 2 + x[2] ** 2
    cons = lambda x: _vec([x[0] ** 2 + x[1] ** 2 - 1.0])
    p, x0 = _make(
        device,
        obj,
        3,
        [1.0, 1.0, 1.0],
        cons=cons,
        m=1,
        var_lb=[1.0, -10.0, -10.0],
        var_ub=10.0,
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 1.0


@_register("hs31")
def hs31(device):
    obj = lambda x: 9.0 * x[0] ** 2 + x[1] ** 2 + 9.0 * x[2] ** 2
    cons = lambda x: _vec([x[0] * x[1] - 1.0])
    p, x0 = _make(
        device,
        obj,
        3,
        [1.0, 1.0, 1.0],
        cons=cons,
        m=1,
        var_lb=[-10.0, 1.0, -10.0],
        var_ub=[10.0, 10.0, 1.0],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 6.0


@_register("hs32")
def hs32(device):
    obj = lambda x: (x[0] + 3.0 * x[1] + x[2]) ** 2 + 4.0 * (x[0] - x[1]) ** 2
    cons = lambda x: _vec(
        [
            1.0 - x[0] - x[1] - x[2],
            6.0 * x[1] + 4.0 * x[2] - x[0] ** 3 - 3.0,
        ]
    )
    p, x0 = _make(
        device,
        obj,
        3,
        [0.1, 0.7, 0.2],
        cons=cons,
        m=2,
        var_lb=0.0,
        cons_lb=np.array([0.0, 0.0]),
        cons_ub=np.array([0.0, INF]),
    )
    return p, x0, 1.0


@_register("hs33")
def hs33(device):
    obj = lambda x: (x[0] - 1.0) * (x[0] - 2.0) * (x[0] - 3.0) + x[2]
    cons = lambda x: _vec(
        [
            x[2] ** 2 - x[1] ** 2 - x[0] ** 2,
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 4.0,
        ]
    )
    p, x0 = _make(
        device,
        obj,
        3,
        [0.0, 0.0, 3.0],
        cons=cons,
        m=2,
        var_lb=0.0,
        var_ub=[INF, INF, 5.0],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, math.sqrt(2.0) - 6.0


@_register("hs35")
def hs35(device):
    obj = lambda x: (
        9.0
        - 8.0 * x[0]
        - 6.0 * x[1]
        - 4.0 * x[2]
        + 2.0 * x[0] ** 2
        + 2.0 * x[1] ** 2
        + x[2] ** 2
        + 2.0 * x[0] * x[1]
        + 2.0 * x[0] * x[2]
    )
    func = Func(obj, num_variables=3)
    problem = Problem(
        func,
        device=device,
        var_lb=0.0,
        linear_coeffs=np.array([[1.0, 1.0, 2.0]]),
        linear_lb=-INF,
        linear_ub=3.0,
    )
    return problem, np.array([0.5, 0.5, 0.5]), 1.0 / 9.0


@_register("hs36")
def hs36(device):
    obj = lambda x: -x[0] * x[1] * x[2]
    func = Func(obj, num_variables=3)
    problem = Problem(
        func,
        device=device,
        var_lb=0.0,
        var_ub=np.array([20.0, 11.0, 42.0]),
        linear_coeffs=np.array([[1.0, 2.0, 2.0]]),
        linear_lb=-INF,
        linear_ub=72.0,
    )
    return problem, np.array([10.0, 10.0, 10.0]), -3300.0


@_register("hs37")
def hs37(device):
    obj = lambda x: -x[0] * x[1] * x[2]
    func = Func(obj, num_variables=3)
    problem = Problem(
        func,
        device=device,
        var_lb=0.0,
        var_ub=42.0,
        linear_coeffs=np.array([[1.0, 2.0, 2.0]]),
        linear_lb=0.0,
        linear_ub=72.0,
    )
    return problem, np.array([10.0, 10.0, 10.0]), -3456.0


@_register("hs43")
def hs43(device):
    obj = lambda x: (
        x[0] ** 2
        + x[1] ** 2
        + 2.0 * x[2] ** 2
        + x[3] ** 2
        - 5.0 * x[0]
        - 5.0 * x[1]
        - 21.0 * x[2]
        + 7.0 * x[3]
    )
    cons = lambda x: _vec(
        [
            8.0
            - x[0] ** 2
            - x[1] ** 2
            - x[2] ** 2
            - x[3] ** 2
            - x[0]
            + x[1]
            - x[2]
            + x[3],
            10.0
            - x[0] ** 2
            - 2.0 * x[1] ** 2
            - x[2] ** 2
            - 2.0 * x[3] ** 2
            + x[0]
            + x[3],
            5.0
            - 2.0 * x[0] ** 2
            - x[1] ** 2
            - x[2] ** 2
            - 2.0 * x[0]
            + x[1]
            + x[3],
        ]
    )
    p, x0 = _make(
        device,
        obj, 4, [0.0, 0.0, 0.0, 0.0], cons=cons, m=3, cons_lb=0.0, cons_ub=INF
    )
    return p, x0, -44.0


@_register("hs71")
def hs71(device):
    obj = lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]
    cons = lambda x: _vec([x[0] * x[1] * x[2] * x[3], torch.dot(x, x)])
    p, x0 = _make(
        device,
        obj,
        4,
        [1.0, 5.0, 5.0, 1.0],
        cons=cons,
        m=2,
        var_lb=1.0,
        var_ub=5.0,
        cons_lb=np.array([25.0, 40.0]),
        cons_ub=np.array([INF, 40.0]),
    )
    return p, x0, 17.0140173


@_register("hs100")
def hs100(device):
    obj = lambda x: (
        (x[0] - 10.0) ** 2
        + 5.0 * (x[1] - 12.0) ** 2
        + x[2] ** 4
        + 3.0 * (x[3] - 11.0) ** 2
        + 10.0 * x[4] ** 6
        + 7.0 * x[5] ** 2
        + x[6] ** 4
        - 4.0 * x[5] * x[6]
        - 10.0 * x[5]
        - 8.0 * x[6]
    )
    cons = lambda x: _vec(
        [
            127.0
            - 2.0 * x[0] ** 2
            - 3.0 * x[1] ** 4
            - x[2]
            - 4.0 * x[3] ** 2
            - 5.0 * x[4],
            282.0 - 7.0 * x[0] - 3.0 * x[1] - 10.0 * x[2] ** 2 - x[3] + x[4],
            196.0 - 23.0 * x[0] - x[1] ** 2 - 6.0 * x[5] ** 2 + 8.0 * x[6],
            -4.0 * x[0] ** 2
            - x[1] ** 2
            + 3.0 * x[0] * x[1]
            - 2.0 * x[2] ** 2
            - 5.0 * x[5]
            + 11.0 * x[6],
        ]
    )
    p, x0 = _make(
        device,
        obj,
        7,
        [1.0, 2.0, 0.0, 4.0, 0.0, 1.0, 1.0],
        cons=cons,
        m=4,
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 680.6300573



@_register("hs16")
def hs16(device):
    obj = lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
    cons = lambda x: _vec([x[0] + x[1] ** 2, x[0] ** 2 + x[1]])
    p, x0 = _make(
        device,
        obj,
        2,
        [-2.0, 1.0],
        cons=cons,
        m=2,
        var_lb=[-0.5, -INF],
        var_ub=[0.5, 1.0],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 0.25


@_register("hs19")
def hs19(device):
    obj = lambda x: (x[0] - 10.0) ** 3 + (x[1] - 20.0) ** 3
    cons = lambda x: _vec(
        [
            (x[0] - 5.0) ** 2 + (x[1] - 5.0) ** 2 - 100.0,
            82.81 - (x[1] - 5.0) ** 2 - (x[0] - 6.0) ** 2,
        ]
    )
    p, x0 = _make(
        device,
        obj,
        2,
        [20.1, 5.84],
        cons=cons,
        m=2,
        var_lb=[13.0, 0.0],
        var_ub=[100.0, 100.0],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, -6961.81388


@_register("hs24")
def hs24(device):
    s3 = math.sqrt(3.0)
    obj = lambda x: ((x[0] - 3.0) ** 2 - 9.0) * x[1] ** 3 / (27.0 * s3)
    func = Func(obj, num_variables=2)
    problem = Problem(
        func,
        device=device,
        var_lb=0.0,
        linear_coeffs=np.array(
            [[1.0 / s3, -1.0], [1.0, s3], [-1.0, -s3]]
        ),
        linear_lb=np.array([0.0, 0.0, -6.0]),
        linear_ub=np.array([INF, INF, INF]),
    )
    return problem, np.array([1.0, 0.5]), -1.0


@_register("hs34")
def hs34(device):
    obj = lambda x: -x[0]
    cons = lambda x: _vec([x[1] - torch.exp(x[0]), x[2] - torch.exp(x[1])])
    p, x0 = _make(
        device,
        obj,
        3,
        [0.0, 1.05, 2.9],
        cons=cons,
        m=2,
        var_lb=0.0,
        var_ub=[100.0, 100.0, 10.0],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, -math.log(math.log(10.0))


@_register("hs41")
def hs41(device):
    obj = lambda x: 2.0 - x[0] * x[1] * x[2]
    func = Func(obj, num_variables=4)
    problem = Problem(
        func,
        device=device,
        var_lb=0.0,
        var_ub=np.array([1.0, 1.0, 1.0, 2.0]),
        linear_coeffs=np.array([[1.0, 2.0, 2.0, -1.0]]),
        linear_lb=0.0,
        linear_ub=0.0,
    )
    return problem, np.array([1.0, 1.0, 1.0, 1.0]), 52.0 / 27.0


@_register("hs44")
def hs44(device):
    obj = lambda x: (
        x[0]
        - x[1]
        - x[2]
        - x[0] * x[2]
        + x[0] * x[3]
        + x[1] * x[2]
        - x[1] * x[3]
    )
    func = Func(obj, num_variables=4)
    problem = Problem(
        func,
        device=device,
        var_lb=0.0,
        linear_coeffs=np.array(
            [
                [1.0, 2.0, 0.0, 0.0],
                [4.0, 1.0, 0.0, 0.0],
                [3.0, 4.0, 0.0, 0.0],
                [0.0, 0.0, 2.0, 1.0],
                [0.0, 0.0, 1.0, 2.0],
                [0.0, 0.0, 1.0, 1.0],
            ]
        ),
        linear_lb=-INF,
        linear_ub=np.array([8.0, 12.0, 12.0, 8.0, 8.0, 5.0]),
    )
    return problem, np.zeros(4), -15.0


@_register("hs49")
def hs49(device):
    obj = lambda x: (
        (x[0] - x[1]) ** 2
        + (x[2] - 1.0) ** 2
        + (x[3] - 1.0) ** 4
        + (x[4] - 1.0) ** 6
    )
    func = Func(obj, num_variables=5)
    problem = Problem(
        func,
        device=device,
        linear_coeffs=np.array(
            [[1.0, 1.0, 1.0, 4.0, 0.0], [0.0, 0.0, 1.0, 0.0, 5.0]]
        ),
        linear_lb=np.array([7.0, 6.0]),
        linear_ub=np.array([7.0, 6.0]),
    )
    return problem, np.array([10.0, 7.0, 2.0, -3.0, 0.8]), 0.0


@_register("hs50")
def hs50(device):
    obj = lambda x: (
        (x[0] - x[1]) ** 2
        + (x[1] - x[2]) ** 2
        + (x[2] - x[3]) ** 4
        + (x[3] - x[4]) ** 2
    )
    func = Func(obj, num_variables=5)
    problem = Problem(
        func,
        device=device,
        linear_coeffs=np.array(
            [
                [1.0, 2.0, 3.0, 0.0, 0.0],
                [0.0, 1.0, 2.0, 3.0, 0.0],
                [0.0, 0.0, 1.0, 2.0, 3.0],
            ]
        ),
        linear_lb=6.0,
        linear_ub=6.0,
    )
    return problem, np.array([35.0, -31.0, 11.0, 5.0, -5.0]), 0.0


@_register("hs53")
def hs53(device):
    obj = lambda x: (
        (x[0] - x[1]) ** 2
        + (x[1] + x[2] - 2.0) ** 2
        + (x[3] - 1.0) ** 2
        + (x[4] - 1.0) ** 2
    )
    func = Func(obj, num_variables=5)
    problem = Problem(
        func,
        device=device,
        var_lb=-10.0,
        var_ub=10.0,
        linear_coeffs=np.array(
            [
                [1.0, 3.0, 0.0, 0.0, 0.0],
                [0.0, 0.0, 1.0, 1.0, -2.0],
                [0.0, 1.0, 0.0, 0.0, -1.0],
            ]
        ),
        linear_lb=0.0,
        linear_ub=0.0,
    )
    return problem, np.array([2.0, 2.0, 2.0, 2.0, 2.0]), 176.0 / 43.0


@_register("hs60")
def hs60(device):
    obj = lambda x: (
        (x[0] - 1.0) ** 2 + (x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 4
    )
    cons = lambda x: _vec(
        [x[0] * (1.0 + x[1] ** 2) + x[2] ** 4 - 4.0 - 3.0 * math.sqrt(2.0)]
    )
    p, x0 = _make(
        device,
        obj,
        3,
        [2.0, 2.0, 2.0],
        cons=cons,
        m=1,
        var_lb=-10.0,
        var_ub=10.0,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, 0.03256820025


@_register("hs63")
def hs63(device):
    obj = lambda x: (
        1000.0
        - x[0] ** 2
        - 2.0 * x[1] ** 2
        - x[2] ** 2
        - x[0] * x[1]
        - x[0] * x[2]
    )
    cons = lambda x: _vec(
        [
            8.0 * x[0] + 14.0 * x[1] + 7.0 * x[2] - 56.0,
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 25.0,
        ]
    )
    p, x0 = _make(
        device,
        obj,
        3,
        [2.0, 2.0, 2.0],
        cons=cons,
        m=2,
        var_lb=0.0,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, 961.7151721


@_register("hs64")
def hs64(device):
    obj = lambda x: (
        5.0 * x[0]
        + 50000.0 / x[0]
        + 20.0 * x[1]
        + 72000.0 / x[1]
        + 10.0 * x[2]
        + 144000.0 / x[2]
    )
    cons = lambda x: _vec(
        [1.0 - 4.0 / x[0] - 32.0 / x[1] - 120.0 / x[2]]
    )
    p, x0 = _make(
        device,
        obj,
        3,
        [1.0, 1.0, 1.0],
        cons=cons,
        m=1,
        var_lb=1e-5,
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 6299.842428


@_register("hs65")
def hs65(device):
    obj = lambda x: (
        (x[0] - x[1]) ** 2
        + (x[0] + x[1] - 10.0) ** 2 / 9.0
        + (x[2] - 5.0) ** 2
    )
    cons = lambda x: _vec(
        [48.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2]
    )
    p, x0 = _make(
        device,
        obj,
        3,
        [-5.0, 5.0, 0.0],
        cons=cons,
        m=1,
        var_lb=[-4.5, -4.5, -5.0],
        var_ub=[4.5, 4.5, 5.0],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 0.9535288567


@_register("hs76")
def hs76(device):
    obj = lambda x: (
        x[0] ** 2
        + 0.5 * x[1] ** 2
        + x[2] ** 2
        + 0.5 * x[3] ** 2
        - x[0] * x[2]
        + x[2] * x[3]
        - x[0]
        - 3.0 * x[1]
        + x[2]
        - x[3]
    )
    func = Func(obj, num_variables=4)
    problem = Problem(
        func,
        device=device,
        var_lb=0.0,
        linear_coeffs=np.array(
            [
                [1.0, 2.0, 1.0, 1.0],
                [3.0, 1.0, 2.0, -1.0],
                [0.0, -1.0, -4.0, 0.0],
            ]
        ),
        linear_lb=np.array([-INF, -INF, -INF]),
        linear_ub=np.array([5.0, 4.0, -1.5]),
    )
    return problem, np.array([0.5, 0.5, 0.5, 0.5]), -4.681818181


@_register("hs77")
def hs77(device):
    obj = lambda x: (
        (x[0] - 1.0) ** 2
        + (x[0] - x[1]) ** 2
        + (x[2] - 1.0) ** 2
        + (x[3] - 1.0) ** 4
        + (x[4] - 1.0) ** 6
    )
    cons = lambda x: _vec(
        [
            x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 2.0 * math.sqrt(2.0),
            x[1] + x[2] ** 4 * x[3] ** 2 - 8.0 - math.sqrt(2.0),
        ]
    )
    p, x0 = _make(
        device,
        obj,
        5,
        [2.0] * 5,
        cons=cons,
        m=2,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, 0.24150513


@_register("hs78")
def hs78(device):
    obj = lambda x: x[0] * x[1] * x[2] * x[3] * x[4]
    cons = lambda x: _vec(
        [
            torch.dot(x, x) - 10.0,
            x[1] * x[2] - 5.0 * x[3] * x[4],
            x[0] ** 3 + x[1] ** 3 + 1.0,
        ]
    )
    p, x0 = _make(
        device,
        obj,
        5,
        [-2.0, 1.5, 2.0, -1.0, -1.0],
        cons=cons,
        m=3,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, -2.91970041


@_register("hs79")
def hs79(device):
    obj = lambda x: (
        (x[0] - 1.0) ** 2
        + (x[0] - x[1]) ** 2
        + (x[1] - x[2]) ** 2
        + (x[2] - x[3]) ** 4
        + (x[3] - x[4]) ** 4
    )
    cons = lambda x: _vec(
        [
            x[0] + x[1] ** 2 + x[2] ** 3 - 2.0 - 3.0 * math.sqrt(2.0),
            x[1] - x[2] ** 2 + x[3] + 2.0 - 2.0 * math.sqrt(2.0),
            x[0] * x[4] - 2.0,
        ]
    )
    p, x0 = _make(
        device,
        obj,
        5,
        [2.0] * 5,
        cons=cons,
        m=3,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, 0.0787768209


@_register("hs80")
def hs80(device):
    obj = lambda x: torch.exp(x[0] * x[1] * x[2] * x[3] * x[4])
    cons = lambda x: _vec(
        [
            torch.dot(x, x) - 10.0,
            x[1] * x[2] - 5.0 * x[3] * x[4],
            x[0] ** 3 + x[1] ** 3 + 1.0,
        ]
    )
    p, x0 = _make(
        device,
        obj,
        5,
        [-2.0, 2.0, 2.0, -1.0, -1.0],
        cons=cons,
        m=3,
        var_lb=[-2.3, -2.3, -3.2, -3.2, -3.2],
        var_ub=[2.3, 2.3, 3.2, 3.2, 3.2],
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, 0.0539498478


@_register("hs110")
def hs110(device):
    def obj(x):
        terms = torch.log(x - 2.0) ** 2 + torch.log(10.0 - x) ** 2
        # the product of the entries as a chain of products: torch.prod's
        # derivative tests its input for zeros on the card, a host read
        # that a CUDA graph of the iteration cannot capture
        prod = x[0]
        for v in x[1:]:
            prod = prod * v
        return torch.sum(terms) - prod ** 0.2

    p, x0 = _make(device, obj, 10, [9.0] * 10, var_lb=2.001, var_ub=9.999)
    return p, x0, -45.77846971


@_register("hs113")
def hs113(device):
    def obj(x):
        return (
            x[0] ** 2
            + x[1] ** 2
            + x[0] * x[1]
            - 14.0 * x[0]
            - 16.0 * x[1]
            + (x[2] - 10.0) ** 2
            + 4.0 * (x[3] - 5.0) ** 2
            + (x[4] - 3.0) ** 2
            + 2.0 * (x[5] - 1.0) ** 2
            + 5.0 * x[6] ** 2
            + 7.0 * (x[7] - 11.0) ** 2
            + 2.0 * (x[8] - 10.0) ** 2
            + (x[9] - 7.0) ** 2
            + 45.0
        )

    def cons(x):
        return _vec(
            [
                105.0 - 4.0 * x[0] - 5.0 * x[1] + 3.0 * x[6] - 9.0 * x[7],
                -10.0 * x[0] + 8.0 * x[1] + 17.0 * x[6] - 2.0 * x[7],
                8.0 * x[0] - 2.0 * x[1] - 5.0 * x[8] + 2.0 * x[9] + 12.0,
                -3.0 * (x[0] - 2.0) ** 2
                - 4.0 * (x[1] - 3.0) ** 2
                - 2.0 * x[2] ** 2
                + 7.0 * x[3]
                + 120.0,
                -5.0 * x[0] ** 2
                - 8.0 * x[1]
                - (x[2] - 6.0) ** 2
                + 2.0 * x[3]
                + 40.0,
                -x[0] ** 2
                - 2.0 * (x[1] - 2.0) ** 2
                + 2.0 * x[0] * x[1]
                - 14.0 * x[4]
                + 6.0 * x[5],
                -0.5 * (x[0] - 8.0) ** 2
                - 2.0 * (x[1] - 4.0) ** 2
                - 3.0 * x[4] ** 2
                + x[5]
                + 30.0,
                3.0 * x[0]
                - 6.0 * x[1]
                - 12.0 * (x[8] - 8.0) ** 2
                + 7.0 * x[9],
            ]
        )

    p, x0 = _make(
        device,
        obj,
        10,
        [2.0, 3.0, 5.0, 5.0, 1.0, 2.0, 7.0, 3.0, 6.0, 10.0],
        cons=cons,
        m=8,
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 24.30620907

HS_PROBLEMS = sorted(_REGISTRY.keys(), key=lambda s: int(s[2:]))


# ---------------------------------------------------------------------------
# round-5 additions (suite breadth toward the CUTEst-scale target)
# ---------------------------------------------------------------------------


@_register("hs2")
def hs2(device):
    obj = lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
    p, x0 = _make(device, obj, 2, [-2.0, 1.0], var_lb=[-INF, 1.5])
    return p, x0, 0.0504261879


@_register("hs17")
def hs17(device):
    obj = lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    def cons(x):
        return _vec([x[1] ** 2 - x[0], x[0] ** 2 - x[1]])

    p, x0 = _make(
        device,
        obj,
        2,
        [-2.0, 1.0],
        cons=cons,
        m=2,
        var_lb=[-0.5, -INF],
        var_ub=[0.5, 1.0],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 1.0


@_register("hs20")
def hs20(device):
    obj = lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    def cons(x):
        return _vec(
            [
                x[0] + x[1] ** 2,
                x[0] ** 2 + x[1],
                x[0] ** 2 + x[1] ** 2 - 1.0,
            ]
        )

    p, x0 = _make(
        device,
        obj,
        2,
        [-2.0, 1.0],
        cons=cons,
        m=3,
        var_lb=[-0.5, -INF],
        var_ub=[0.5, INF],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 81.5 - 25.0 * math.sqrt(3.0)


@_register("hs25")
def hs25(device):
    i = torch.arange(1.0, 100.0, dtype=torch.float64, device=device)
    u = 25.0 + (-50.0 * torch.log(0.01 * i)) ** (2.0 / 3.0)

    def obj(x):
        # |u - x2| guard: u_i - x2 >= 0.03 on the feasible box, but
        # intermediate iterates may graze it
        base = torch.clamp(u.to(x) - x[1], min=1e-12)
        f = -0.01 * i.to(x) + torch.exp(-(base ** x[2]) / x[0])
        return torch.sum(f * f)

    p, x0 = _make(
        device,
        obj,
        3,
        [100.0, 12.5, 3.0],
        var_lb=[0.1, 0.0, 0.0],
        var_ub=[100.0, 25.6, 5.0],
    )
    return p, x0, 0.0


@_register("hs46")
def hs46(device):
    def obj(x):
        return (
            (x[0] - x[1]) ** 2
            + (x[2] - 1.0) ** 2
            + (x[3] - 1.0) ** 4
            + (x[4] - 1.0) ** 6
        )

    def cons(x):
        return _vec(
            [
                x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 1.0,
                x[1] + x[2] ** 4 * x[3] ** 2 - 2.0,
            ]
        )

    p, x0 = _make(
        device,
        obj,
        5,
        [math.sqrt(2.0) / 2.0, 1.75, 0.5, 2.0, 2.0],
        cons=cons,
        m=2,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, 0.0


@_register("hs47")
def hs47(device):
    def obj(x):
        return (
            (x[0] - x[1]) ** 2
            + (x[1] - x[2]) ** 3
            + (x[2] - x[3]) ** 4
            + (x[3] - x[4]) ** 4
        )

    def cons(x):
        return _vec(
            [
                x[0] + x[1] ** 2 + x[2] ** 3 - 3.0,
                x[1] - x[2] ** 2 + x[3] - 1.0,
                x[0] * x[4] - 1.0,
            ]
        )

    p, x0 = _make(
        device,
        obj,
        5,
        [2.0, math.sqrt(2.0), -1.0, 2.0 - math.sqrt(2.0), 0.5],
        cons=cons,
        m=3,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, 0.0


@_register("hs55")
def hs55(device):
    def obj(x):
        return x[0] + 2.0 * x[1] + 4.0 * x[4] + torch.exp(x[0] * x[3])

    def cons(x):
        return _vec(
            [
                x[0] + 2.0 * x[1] + 5.0 * x[4] - 6.0,
                x[0] + x[1] + x[2] - 3.0,
                x[3] + x[4] + x[5] - 2.0,
                x[0] + x[3] - 1.0,
                x[1] + x[4] - 2.0,
                x[2] + x[5] - 2.0,
            ]
        )

    p, x0 = _make(
        device,
        obj,
        6,
        [1.0, 2.0, 0.0, 0.0, 0.0, 2.0],
        cons=cons,
        m=6,
        var_lb=0.0,
        var_ub=[1.0, INF, INF, 1.0, INF, INF],
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, 19.0 / 3.0


@_register("hs56")
def hs56(device):
    def obj(x):
        return -x[0] * x[1] * x[2]

    def cons(x):
        return _vec(
            [
                x[0] - 4.2 * torch.sin(x[3]) ** 2,
                x[1] - 4.2 * torch.sin(x[4]) ** 2,
                x[2] - 4.2 * torch.sin(x[5]) ** 2,
                x[0]
                + 2.0 * x[1]
                + 2.0 * x[2]
                - 7.2 * torch.sin(x[6]) ** 2,
            ]
        )

    a = math.asin(math.sqrt(1.0 / 4.2))
    b = math.asin(math.sqrt(5.0 / 7.2))
    p, x0 = _make(
        device,
        obj,
        7,
        [1.0, 1.0, 1.0, a, a, a, b],
        cons=cons,
        m=4,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, -3.456


@_register("hs61")
def hs61(device):
    def obj(x):
        return (
            4.0 * x[0] ** 2
            + 2.0 * x[1] ** 2
            + 2.0 * x[2] ** 2
            - 33.0 * x[0]
            + 16.0 * x[1]
            - 24.0 * x[2]
        )

    def cons(x):
        return _vec(
            [
                3.0 * x[0] - 2.0 * x[1] ** 2 - 7.0,
                4.0 * x[0] - x[2] ** 2 - 11.0,
            ]
        )

    p, x0 = _make(
        device,
        obj, 3, [0.0, 0.0, 0.0], cons=cons, m=2, cons_lb=0.0, cons_ub=0.0
    )
    return p, x0, -143.6461422


@_register("hs62")
def hs62(device):
    def obj(x):
        s1 = (x[0] + x[1] + x[2] + 0.03) / (
            0.09 * x[0] + x[1] + x[2] + 0.03
        )
        s2 = (x[1] + x[2] + 0.03) / (0.07 * x[1] + x[2] + 0.03)
        s3 = (x[2] + 0.03) / (0.13 * x[2] + 0.03)
        return -32.174 * (
            255.0 * torch.log(s1) + 280.0 * torch.log(s2) + 290.0 * torch.log(s3)
        )

    def cons(x):
        return _vec([x[0] + x[1] + x[2] - 1.0])

    p, x0 = _make(
        device,
        obj,
        3,
        [0.7, 0.2, 0.1],
        cons=cons,
        m=1,
        var_lb=0.0,
        var_ub=1.0,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, -26272.51448


@_register("hs66")
def hs66(device):
    obj = lambda x: 0.2 * x[2] - 0.8 * x[0]

    def cons(x):
        return _vec(
            [x[1] - torch.exp(x[0]), x[2] - torch.exp(x[1])]
        )

    p, x0 = _make(
        device,
        obj,
        3,
        [0.0, 1.05, 2.9],
        cons=cons,
        m=2,
        var_lb=0.0,
        var_ub=[100.0, 100.0, 10.0],
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 0.5181632741


@_register("hs72")
def hs72(device):
    obj = lambda x: 1.0 + x[0] + x[1] + x[2] + x[3]

    def cons(x):
        return _vec(
            [
                4.0 / x[0] + 2.25 / x[1] + 1.0 / x[2] + 0.25 / x[3],
                0.16 / x[0] + 0.36 / x[1] + 0.64 / x[2] + 0.64 / x[3],
            ]
        )

    p, x0 = _make(
        device,
        obj,
        4,
        [1.0, 1.0, 1.0, 1.0],
        cons=cons,
        m=2,
        var_lb=0.001,
        var_ub=[4.0e5, 3.0e5, 2.0e5, 1.0e5],
        cons_lb=-INF,
        cons_ub=[0.0401, 0.010085],
    )
    return p, x0, 727.67937


@_register("hs73")
def hs73(device):
    obj = lambda x: (
        24.55 * x[0] + 26.75 * x[1] + 39.0 * x[2] + 40.50 * x[3]
    )

    def cons(x):
        quad = (
            0.28 * x[0] ** 2
            + 0.19 * x[1] ** 2
            + 20.5 * x[2] ** 2
            + 0.62 * x[3] ** 2
        )
        return _vec(
            [
                2.3 * x[0] + 5.6 * x[1] + 11.1 * x[2] + 1.3 * x[3] - 5.0,
                12.0 * x[0]
                + 11.9 * x[1]
                + 41.8 * x[2]
                + 52.1 * x[3]
                - 21.0
                - 1.645 * torch.sqrt(quad),
                x[0] + x[1] + x[2] + x[3] - 1.0,
            ]
        )

    p, x0 = _make(
        device,
        obj,
        4,
        [1.0, 1.0, 1.0, 1.0],
        cons=cons,
        m=3,
        var_lb=0.0,
        cons_lb=[0.0, 0.0, 0.0],
        cons_ub=[INF, INF, 0.0],
    )
    return p, x0, 29.894378


def _hs74_75(a, f_opt):
    def factory(device):
        def obj(x):
            return (
                3.0 * x[0]
                + 1.0e-6 * x[0] ** 3
                + 2.0 * x[1]
                + (2.0e-6 / 3.0) * x[1] ** 3
            )

        def cons(x):
            return _vec(
                [
                    x[3] - x[2] + a,
                    x[2] - x[3] + a,
                    1000.0 * torch.sin(-x[2] - 0.25)
                    + 1000.0 * torch.sin(-x[3] - 0.25)
                    + 894.8
                    - x[0],
                    1000.0 * torch.sin(x[2] - 0.25)
                    + 1000.0 * torch.sin(x[2] - x[3] - 0.25)
                    + 894.8
                    - x[1],
                    1000.0 * torch.sin(x[3] - 0.25)
                    + 1000.0 * torch.sin(x[3] - x[2] - 0.25)
                    + 1294.8,
                ]
            )

        p, x0 = _make(
            device,
            obj,
            4,
            [0.0, 0.0, 0.0, 0.0],
            cons=cons,
            m=5,
            var_lb=[0.0, 0.0, -a, -a],
            var_ub=[1200.0, 1200.0, a, a],
            cons_lb=[0.0, 0.0, 0.0, 0.0, 0.0],
            cons_ub=[INF, INF, 0.0, 0.0, 0.0],
        )
        return p, x0, f_opt

    return factory


_REGISTRY["hs74"] = _hs74_75(0.55, 5126.4981)
_REGISTRY["hs75"] = _hs74_75(0.48, 5174.4127)


@_register("hs81")
def hs81(device):
    def obj(x):
        return torch.exp(x[0] * x[1] * x[2] * x[3] * x[4]) - 0.5 * (
            x[0] ** 3 + x[1] ** 3 + 1.0
        ) ** 2

    def cons(x):
        return _vec(
            [
                torch.dot(x, x) - 10.0,
                x[1] * x[2] - 5.0 * x[3] * x[4],
                x[0] ** 3 + x[1] ** 3 + 1.0,
            ]
        )

    p, x0 = _make(
        device,
        obj,
        5,
        [-2.0, 2.0, 2.0, -1.0, -1.0],
        cons=cons,
        m=3,
        var_lb=[-2.3, -2.3, -3.2, -3.2, -3.2],
        var_ub=[2.3, 2.3, 3.2, 3.2, 3.2],
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, 0.0539498478


@_register("hs83")
def hs83(device):
    def obj(x):
        return (
            5.3578547 * x[2] ** 2
            + 0.8356891 * x[0] * x[4]
            + 37.293239 * x[0]
            - 40792.141
        )

    def cons(x):
        return _vec(
            [
                85.334407
                + 0.0056858 * x[1] * x[4]
                + 0.0006262 * x[0] * x[3]
                - 0.0022053 * x[2] * x[4],
                80.51249
                + 0.0071317 * x[1] * x[4]
                + 0.0029955 * x[0] * x[1]
                + 0.0021813 * x[2] ** 2,
                9.300961
                + 0.0047026 * x[2] * x[4]
                + 0.0012547 * x[0] * x[2]
                + 0.0019085 * x[2] * x[3],
            ]
        )

    p, x0 = _make(
        device,
        obj,
        5,
        [78.0, 33.0, 27.0, 27.0, 27.0],
        cons=cons,
        m=3,
        var_lb=[78.0, 33.0, 27.0, 27.0, 27.0],
        var_ub=[102.0, 45.0, 45.0, 45.0, 45.0],
        cons_lb=[0.0, 90.0, 20.0],
        cons_ub=[92.0, 110.0, 25.0],
    )
    return p, x0, -30665.53867


@_register("hs93")
def hs93(device):
    def obj(x):
        return (
            0.0204 * x[0] * x[3] * (x[0] + x[1] + x[2])
            + 0.0187 * x[1] * x[2] * (x[0] + 1.57 * x[1] + x[3])
            + 0.0607
            * x[0]
            * x[3]
            * x[4] ** 2
            * (x[0] + x[1] + x[2])
            + 0.0437
            * x[1]
            * x[2]
            * x[5] ** 2
            * (x[0] + 1.57 * x[1] + x[3])
        )

    def cons(x):
        return _vec(
            [
                0.001 * x[0] * x[1] * x[2] * x[3] * x[4] * x[5] - 2.07,
                1.0
                - 0.00062
                * x[0]
                * x[3]
                * x[4] ** 2
                * (x[0] + x[1] + x[2])
                - 0.00058
                * x[1]
                * x[2]
                * x[5] ** 2
                * (x[0] + 1.57 * x[1] + x[3]),
            ]
        )

    p, x0 = _make(
        device,
        obj,
        6,
        [5.54, 4.4, 12.02, 11.82, 0.702, 0.852],
        cons=cons,
        m=2,
        var_lb=0.0,
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 135.075961


@_register("hs104")
def hs104(device):
    def _f(x):
        return (
            0.4 * x[0] ** 0.67 * x[6] ** (-0.67)
            + 0.4 * x[1] ** 0.67 * x[7] ** (-0.67)
            + 10.0
            - x[0]
            - x[1]
        )

    def cons(x):
        return _vec(
            [
                1.0 - 0.0588 * x[4] * x[6] - 0.1 * x[0],
                1.0 - 0.0588 * x[5] * x[7] - 0.1 * x[0] - 0.1 * x[1],
                1.0
                - 4.0 * x[2] / x[4]
                - 2.0 * x[2] ** (-0.71) / x[4]
                - 0.0588 * x[2] ** (-1.3) * x[6],
                1.0
                - 4.0 * x[3] / x[5]
                - 2.0 * x[3] ** (-0.71) / x[5]
                - 0.0588 * x[3] ** (-1.3) * x[7],
                _f(x),
            ]
        )

    p, x0 = _make(
        device,
        _f,
        8,
        [6.0, 3.0, 0.4, 0.2, 6.0, 6.0, 1.0, 0.5],
        cons=cons,
        m=5,
        var_lb=0.1,
        var_ub=10.0,
        cons_lb=[0.0, 0.0, 0.0, 0.0, 1.0],
        cons_ub=[INF, INF, INF, INF, 4.2],
    )
    return p, x0, 3.9511634396


@_register("hs106")
def hs106(device):
    obj = lambda x: x[0] + x[1] + x[2]

    def cons(x):
        return _vec(
            [
                1.0 - 0.0025 * (x[3] + x[5]),
                1.0 - 0.0025 * (x[4] + x[6] - x[3]),
                1.0 - 0.01 * (x[7] - x[4]),
                x[0] * x[5]
                - 833.33252 * x[3]
                - 100.0 * x[0]
                + 83333.333,
                x[1] * x[6] - 1250.0 * x[4] - x[1] * x[3] + 1250.0 * x[3],
                x[2] * x[7] - 1250000.0 - x[2] * x[4] + 2500.0 * x[4],
            ]
        )

    p, x0 = _make(
        device,
        obj,
        8,
        [5000.0, 5000.0, 5000.0, 200.0, 350.0, 150.0, 225.0, 425.0],
        cons=cons,
        m=6,
        var_lb=[100.0, 1000.0, 1000.0, 10.0, 10.0, 10.0, 10.0, 10.0],
        var_ub=[10000.0] * 3 + [1000.0] * 5,
        cons_lb=0.0,
        cons_ub=INF,
    )
    return p, x0, 7049.248021


@_register("hs111")
def hs111(device):
    c = torch.tensor(
        [
            -6.089,
            -17.164,
            -34.054,
            -5.914,
            -24.721,
            -14.986,
            -24.1,
            -10.708,
            -26.662,
            -22.179,
        ],
        dtype=torch.float64,
        device=device,
    )

    def obj(x):
        ex = torch.exp(x)
        return torch.sum(ex * (c.to(x) + x - torch.log(torch.sum(ex))))

    def cons(x):
        e = torch.exp(x)
        return _vec(
            [
                e[0] + 2.0 * e[1] + 2.0 * e[2] + e[5] + e[9] - 2.0,
                e[3] + 2.0 * e[4] + e[5] + e[6] - 1.0,
                e[2] + e[6] + e[7] + 2.0 * e[8] + e[9] - 1.0,
            ]
        )

    p, x0 = _make(
        device,
        obj,
        10,
        [-2.3] * 10,
        cons=cons,
        m=3,
        var_lb=-100.0,
        var_ub=100.0,
        cons_lb=0.0,
        cons_ub=0.0,
    )
    return p, x0, -47.76109026


@_register("hs118")
def hs118(device):
    def obj(x):
        k = torch.arange(5, device=x.device)
        x1 = x[3 * k]
        x2 = x[3 * k + 1]
        x3 = x[3 * k + 2]
        return torch.sum(
            2.3 * x1
            + 0.0001 * x1 ** 2
            + 1.7 * x2
            + 0.0001 * x2 ** 2
            + 2.2 * x3
            + 0.00015 * x3 ** 2
        )

    def cons(x):
        rows = []
        for kk in range(1, 5):
            rows.append(x[3 * kk] - x[3 * kk - 3] + 7.0)
            rows.append(x[3 * kk + 1] - x[3 * kk - 2] + 7.0)
            rows.append(x[3 * kk + 2] - x[3 * kk - 1] + 7.0)
        rows.append(x[0] + x[1] + x[2])
        rows.append(x[3] + x[4] + x[5])
        rows.append(x[6] + x[7] + x[8])
        rows.append(x[9] + x[10] + x[11])
        rows.append(x[12] + x[13] + x[14])
        return torch.stack(rows)

    lo = [0.0, 0.0, 0.0] * 4 + [60.0, 50.0, 70.0, 85.0, 100.0]
    hi = [13.0, 14.0, 13.0] * 4 + [INF] * 5
    p, x0 = _make(
        device,
        obj,
        15,
        [20.0, 55.0, 15.0, 20.0, 60.0, 20.0, 20.0, 60.0, 20.0, 20.0,
         60.0, 20.0, 20.0, 60.0, 20.0],
        cons=cons,
        m=17,
        var_lb=[8.0, 43.0, 3.0] + [0.0] * 12,
        var_ub=[21.0, 57.0, 16.0]
        + [90.0, 120.0, 60.0] * 4,
        cons_lb=lo,
        cons_ub=hi,
    )
    return p, x0, 664.82045


HS_PROBLEMS = sorted(_REGISTRY.keys(), key=lambda s: int(s[2:]))
