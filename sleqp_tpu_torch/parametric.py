"""Parametric Cauchy: the in-iteration sweep of the LP trust radius.

Port of ``sleqp_tpu/parametric.py`` (reference src/main/parametric.c):
from the LP step at the current radius, either search forward (radius x2
COARSE / x sqrt(2) FINE while the quadratic merit keeps strictly
decreasing, parametric.c:153-245) or backtrack (shrink until the Cauchy
sufficient-decrease condition holds, parametric.c:248-330), re-solving
the warm-started LP each time.  The accepted direction replaces the
Cauchy linesearch (full step), and the LP trust radius is updated.

The reference's ``lax.cond`` between the two sweeps is a branch on one
host read; each of its ``lax.while_loop``s is a Python loop that reads
one stop flag a step, with the reference's caps (5 resolves COARSE, 10
FINE).
"""

from __future__ import annotations

from typing import Callable

import torch

from .cauchy import CauchyResult, solve_cauchy_lp
from .iterate import Iterate, total_violation
from .lanes import tree_where
from .merit import Direction, make_direction
from .problem import ProblemData
from .types import LPSolver, ParametricCauchy

Tensor = torch.Tensor

# parametric.c:78-88: (increase, decrease, max resolves)
_PARAMS = {
    ParametricCauchy.COARSE: (2.0, 0.5, 5),
    ParametricCauchy.FINE: (2.0**0.5, 0.5**0.5, 10),
}


def parametric_solve(
    mode: ParametricCauchy,
    data: ProblemData,
    it: Iterate,
    hess_prod: Callable[[Tensor], Tensor],
    penalty: Tensor,
    lp_trust_radius: Tensor,
    cres: CauchyResult,
    cauchy_eta: float,
    settings_eps: float,
    lp_solver: LPSolver = LPSolver.SIMPLEX,
    pdlp_tol: float = 1e-9,
    compute_dtype=None,
):
    """Returns (cres, lp_trust_radius, direction, quad_merit)."""
    increase, decrease, max_resolves = _PARAMS[mode]
    exact_violation = total_violation(data, it.cons_val)

    def direction_of(step: Tensor) -> Direction:
        return make_direction(it, step, hess_prod(step))

    def merit_and_decrease(d: Direction):
        lin_viol = total_violation(data, it.cons_val + d.cons_jac_dot)
        hess_dot = torch.dot(d.primal, d.hess)
        quad = it.obj_val + d.obj_dot + penalty * lin_viol + 0.5 * hess_dot
        sufficient = ((penalty * (exact_violation - lin_viol) - d.obj_dot) * (1.0 - cauchy_eta)
                      >= 0.5 * hess_dot)
        return quad, sufficient

    def resolve(radius: Tensor, prev: CauchyResult) -> CauchyResult:
        return solve_cauchy_lp(data, it, radius, penalty, prev.basis, settings_eps=settings_eps,
                               lp_solver=lp_solver, pdlp_tol=pdlp_tol,
                               compute_dtype=compute_dtype)

    direction = direction_of(cres.lp_step)
    quad, sufficient0 = merit_and_decrease(direction)
    radius = lp_trust_radius
    count = 0
    if bool(sufficient0):
        # forward: the radius grows while the quadratic merit strictly improves
        while True:
            trial_radius = radius * increase
            res = resolve(trial_radius, cres)
            d = direction_of(res.lp_step)
            q, _ = merit_and_decrease(d)
            improved = q < quad - settings_eps * (1.0 + quad.abs())
            count += 1
            radius = torch.where(improved, trial_radius, radius)
            cres = tree_where(improved, res, cres)
            direction = tree_where(improved, d, direction)
            quad = torch.where(improved, q, quad)
            if not (bool(improved) and count < max_resolves):
                break
    else:
        # backtrack: the radius shrinks until sufficient decrease holds
        while True:
            radius = radius * decrease
            cres = resolve(radius, cres)
            direction = direction_of(cres.lp_step)
            quad, sufficient = merit_and_decrease(direction)
            count += 1
            if bool(sufficient) or count >= max_resolves:
                break
    return cres, radius, direction, quad
