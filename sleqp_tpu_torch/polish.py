"""Post-solve working-set polishing.

Port of ``sleqp_tpu/polish.py`` (reference src/main/polish.c): after the
solve, drop working-set entries that carry no information:

* ZERO_DUAL (default): active entries with a zero dual become INACTIVE
  (polish.c:129-236);
* INACTIVE: also drop entries whose primal value is not at the bound they
  claim (polish.c:43-127).
"""

from __future__ import annotations

import dataclasses

import torch

from .iterate import Iterate
from .problem import ProblemData
from .types import ActiveState, Polishing

Tensor = torch.Tensor


def _polish_zero_dual(states: Tensor, dual: Tensor) -> Tensor:
    drop = (states != ActiveState.INACTIVE) & (dual == 0.0)
    return torch.where(drop, int(ActiveState.INACTIVE), states).to(torch.int8)


def _polish_inactive(states: Tensor, value: Tensor, lb: Tensor, ub: Tensor,
                     eps: float) -> Tensor:
    # an infinite bound is never reached: |v - (-inf)| <= eps (1 + inf)
    # would read inf <= inf and keep the entry
    at_lower = torch.isfinite(lb) & ((value - lb).abs() <= eps * (1.0 + lb.abs()))
    at_upper = torch.isfinite(ub) & ((value - ub).abs() <= eps * (1.0 + ub.abs()))
    keep = torch.where(
        states == ActiveState.ACTIVE_LOWER, at_lower,
        torch.where(states == ActiveState.ACTIVE_UPPER, at_upper,
                    (states == ActiveState.ACTIVE_BOTH) & (at_lower | at_upper)))
    return torch.where(keep, states, int(ActiveState.INACTIVE)).to(torch.int8)


def polish_iterate(data: ProblemData, it: Iterate, polishing: Polishing,
                   eps: float = 1e-10) -> Iterate:
    """Apply the selected polishing to the working set (polish.c:238-268)."""
    if polishing == Polishing.NONE:
        return it
    var_states = _polish_zero_dual(it.var_states, it.vars_dual)
    cons_states = _polish_zero_dual(it.cons_states, it.cons_dual)
    if polishing == Polishing.INACTIVE:
        var_states = _polish_inactive(var_states, it.x, data.var_lb, data.var_ub, eps)
        cons_states = _polish_inactive(cons_states, it.cons_val, data.cons_lb, data.cons_ub, eps)
    return dataclasses.replace(it, var_states=var_states, cons_states=cons_states)
