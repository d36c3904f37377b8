"""l1 exact-penalty merit function.

Port of ``sleqp_tpu/merit.py`` (reference src/main/merit.c): φ(x) = f(x)
+ λ·v(x) with v the total l1 violation of the combined constraints, plus
the linear and quadratic directional models the linesearches use.  A
``Direction`` bundles (d, ∇f·d, H·d, J·d) like the reference
``SleqpDirection`` (src/main/direction.c).
"""

from __future__ import annotations

import dataclasses

import torch

from .iterate import Iterate, total_violation
from .problem import ProblemData

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Direction:
    """Step bundle kept consistent for merit math (direction.c:284)."""

    primal: Tensor  # (n,) step d
    obj_dot: Tensor  # 0-d ∇f·d
    hess: Tensor  # (n,) H·d (Hessian of the Lagrangian)
    cons_jac_dot: Tensor  # (m,) J·d

    def scale(self, factor: Tensor) -> "Direction":
        return Direction(
            primal=self.primal * factor,
            obj_dot=self.obj_dot * factor,
            hess=self.hess * factor,
            cons_jac_dot=self.cons_jac_dot * factor,
        )

    @staticmethod
    def zero_like(other: "Direction") -> "Direction":
        return Direction(*(torch.zeros_like(getattr(other, f.name))
                           for f in dataclasses.fields(Direction)))


def blend(a: Direction, b: Direction, alpha: Tensor) -> Direction:
    """(1 - alpha) a + alpha b, field by field."""
    return Direction(*((1.0 - alpha) * getattr(a, f.name) + alpha * getattr(b, f.name)
                       for f in dataclasses.fields(Direction)))


def make_direction(it: Iterate, primal: Tensor, hess_prod: Tensor) -> Direction:
    """A consistent Direction from a primal step and its H·d product."""
    return Direction(
        primal=primal,
        obj_dot=torch.dot(it.obj_grad, primal),
        hess=hess_prod,
        cons_jac_dot=it.cons_jac @ primal,
    )


def merit_func(data: ProblemData, it: Iterate, penalty: Tensor) -> Tensor:
    """Exact merit φ(x) = f + λ·v(x) (merit.c:60-80)."""
    return it.obj_val + penalty * total_violation(data, it.cons_val)


def merit_linear(data: ProblemData, it: Iterate, direction: Direction,
                 penalty: Tensor) -> Tensor:
    """Linear model f + ∇f·d + λ·v(c + J·d) (merit.c:83-110)."""
    combined = it.cons_val + direction.cons_jac_dot
    return it.obj_val + direction.obj_dot + penalty * total_violation(data, combined)


def merit_quadratic(data: ProblemData, it: Iterate, direction: Direction,
                    penalty: Tensor) -> Tensor:
    """Quadratic model: linear + 0.5 d^T H d (merit.c:113-135)."""
    bilinear = torch.dot(direction.primal, direction.hess)
    return merit_linear(data, it, direction, penalty) + 0.5 * bilinear
