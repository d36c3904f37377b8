"""Per-step nonlinearity diagnostics.

Port of ``sleqp_tpu/measure.py`` (reference src/main/measure.c): after each
trial evaluation, split the merit change into objective and violation,
compare the model ("expected") values with the actual ones, and estimate

    obj_nonlin  = 2 (f(x) + g·d - f(x+d)) / ||d||^2        (measure.c:73-89)
    cons_nonlin = 2 ||c(x) + J d - c(x+d)||_inf / ||d||^2  (measure.c:107-148)
    lag_nonlin  = obj_nonlin + mu·cons_nonlin_vec          (measure.c:92-104)
"""

from __future__ import annotations

import dataclasses

import torch

from .iterate import Iterate, max0, total_violation
from .merit import Direction
from .problem import ProblemData

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Measure:
    """Scalar nonlinearity/reduction diagnostics of the last trial step."""

    step_norm: Tensor
    obj_nonlin: Tensor
    cons_nonlin: Tensor  # inf-norm of the per-constraint nonlinearity
    lag_nonlin: Tensor
    # objective: current / model ("expected", incl. 0.5 d'Hd) / actual
    obj_current: Tensor
    obj_expected: Tensor
    obj_actual: Tensor
    # total l1 violation: current / linearized / actual
    vio_current: Tensor
    vio_expected: Tensor
    vio_actual: Tensor


def empty_measure(dtype, device=None) -> Measure:
    return Measure(*(torch.zeros((), dtype=dtype, device=device)
                     for _ in dataclasses.fields(Measure)))


def compute_measure(data: ProblemData, it: Iterate, trial_it: Iterate, direction: Direction,
                    multipliers: Tensor) -> Measure:
    """All diagnostics of one trial step (measure.c:152-171)."""
    d = direction.primal
    norm_sq = torch.dot(d, d)
    safe_norm_sq = torch.where(norm_sq > 0.0, norm_sq, 1.0)
    hess_dot = torch.dot(d, direction.hess)

    obj_linear = it.obj_val + direction.obj_dot
    obj_nonlin = torch.where(norm_sq > 0.0,
                             (obj_linear - trial_it.obj_val) * (2.0 / safe_norm_sq), 0.0)

    expected_cons = it.cons_val + direction.cons_jac_dot
    cons_nonlin_vec = torch.where(norm_sq > 0.0,
                                  (expected_cons - trial_it.cons_val) * (2.0 / safe_norm_sq),
                                  torch.zeros_like(expected_cons))
    return Measure(
        step_norm=torch.sqrt(norm_sq),
        obj_nonlin=obj_nonlin,
        cons_nonlin=max0(cons_nonlin_vec.abs()),
        lag_nonlin=obj_nonlin + torch.dot(cons_nonlin_vec, multipliers),
        obj_current=it.obj_val,
        obj_expected=obj_linear + 0.5 * hess_dot,
        obj_actual=trial_it.obj_val,
        vio_current=total_violation(data, it.cons_val),
        vio_expected=total_violation(data, expected_cons),
        vio_actual=total_violation(data, trial_it.cons_val),
    )


def _percent_reduction(current: float, trial: float) -> float:
    """measure.c:222-234."""
    if current == 0.0:
        return 0.0
    value = 100.0 * (current - trial) / current
    return -value if current < 0.0 else value


def format_measure(m: Measure, penalty: float) -> str:
    """Debug-level report (measure.c:237-295)."""
    oc, oe, oa = float(m.obj_current), float(m.obj_expected), float(m.obj_actual)
    vc, ve, va = float(m.vio_current), float(m.vio_expected), float(m.vio_actual)
    lines = [
        (
            f"Objective: current: {oc:14e}, expected: {oe:14e}, "
            f"actual: {oa:14e}, predicted reduction: "
            f"{_percent_reduction(oc, oe):9.4f}%, actual reduction: "
            f"{_percent_reduction(oc, oa):9.4f}%"
        ),
        (
            f"Violation: current: {vc:14e}, expected: {ve:14e}, "
            f"actual: {va:14e}, predicted reduction: "
            f"{_percent_reduction(vc, ve):9.4f}%, actual reduction: "
            f"{_percent_reduction(vc, va):9.4f}%"
        ),
        (
            f"Objective nonlinearity: {float(m.obj_nonlin):g}, "
            f"maximal constraint nonlinearity: {float(m.cons_nonlin):g}, "
            f"Lagrangean nonlinearity: {float(m.lag_nonlin):g} "
            f"(step norm: {float(m.step_norm):g})"
        ),
    ]
    return "\n".join(lines)
