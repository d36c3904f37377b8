"""Parametric Cauchy: the in-iteration sweep of the LP trust radius.

Port of ``sleqp_tpu/parametric.py`` (reference src/main/parametric.c):
from the LP step at the current radius, either search forward (radius x2
COARSE / x sqrt(2) FINE while the quadratic merit keeps strictly
decreasing, parametric.c:153-245) or backtrack (shrink until the Cauchy
sufficient-decrease condition holds, parametric.c:248-330), re-solving
the warm-started LP each time.  The accepted direction replaces the
Cauchy linesearch (full step), and the LP trust radius is updated.

The reference's ``lax.cond`` between the two sweeps is a branch on one
host read; each of its ``lax.while_loop``s is a ``lanes.lockstep`` loop
whose state holds a per-lane resolve count and ``done`` flag, the
reference's cap (5 resolves COARSE, 10 FINE) inside the flag, so one
instance reads one stop flag a resolve, as a plain loop.  Under ``vmap``
each sweep runs when any lane takes it, on the lanes that take it, and
the two results are selected per lane, as the reference's ``lax.cond``
under ``vmap`` selects them.  A lane that is done still runs the trip's
LP re-solve (its result is not kept), as in the reference's
``while_loop`` under ``vmap``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .cauchy import CauchyResult, solve_cauchy_lp
from .iterate import Iterate, total_violation
from .lanes import is_batched, lanes_any, lanes_where, lockstep, tree_where
from .merit import Direction, make_direction
from .problem import ProblemData
from .types import LPSolver, ParametricCauchy

Tensor = torch.Tensor

# parametric.c:78-88: (increase, decrease, max resolves)
_PARAMS = {
    ParametricCauchy.COARSE: (2.0, 0.5, 5),
    ParametricCauchy.FINE: (2.0**0.5, 0.5**0.5, 10),
}


class Sweep:
    """One sweep's radius steps and the quadratic merit of an LP step:
    its state is a dict (radius, the LP result, direction, merit, the
    resolve count, done); a trip re-solves the LP at the next radius from
    the last result's basis and takes the result (``forward``,
    ``backtrack``)."""

    def __init__(self, mode: ParametricCauchy, data: ProblemData, it: Iterate,
                 hess_prod: Callable[[Tensor], Tensor], penalty: Tensor, cauchy_eta: float,
                 settings_eps: float):
        self.increase, self.decrease, self.max_resolves = _PARAMS[mode]
        self.data, self.it, self.hess_prod, self.penalty = data, it, hess_prod, penalty
        self.eta, self.eps = cauchy_eta, settings_eps
        self.exact_violation = total_violation(data, it.cons_val)

    @staticmethod
    def resolves(mode: ParametricCauchy) -> int:
        """A sweep's LP re-solves at most."""
        return _PARAMS[mode][2]

    def direction_of(self, step: Tensor) -> Direction:
        return make_direction(self.it, step, self.hess_prod(step))

    def merit_and_decrease(self, d: Direction):
        lin_viol = total_violation(self.data, self.it.cons_val + d.cons_jac_dot)
        hess_dot = torch.dot(d.primal, d.hess)
        quad = self.it.obj_val + d.obj_dot + self.penalty * lin_viol + 0.5 * hess_dot
        sufficient = ((self.penalty * (self.exact_violation - lin_viol) - d.obj_dot)
                      * (1.0 - self.eta) >= 0.5 * hess_dot)
        return quad, sufficient

    def begin(self, lp_trust_radius: Tensor, cres: CauchyResult):
        """(the sweep's state without ``done``, whether the LP step at the
        current radius decreases the model enough: the forward sweep)."""
        d0 = self.direction_of(cres.lp_step)
        quad0, sufficient0 = self.merit_and_decrease(d0)
        return dict(radius=lp_trust_radius, cres=cres, direction=d0, quad=quad0,
                    count=torch.zeros((), dtype=torch.int32, device=quad0.device)), sufficient0

    def forward(self, s: dict, res: CauchyResult) -> dict:
        """A forward trip: the radius grows while the quadratic merit
        strictly improves; ``res`` is the LP at ``s``'s radius x increase."""
        radius = s["radius"] * self.increase
        d = self.direction_of(res.lp_step)
        q, _ = self.merit_and_decrease(d)
        improved = q < s["quad"] - self.eps * (1.0 + s["quad"].abs())
        count = s["count"] + 1
        return dict(radius=torch.where(improved, radius, s["radius"]),
                    cres=tree_where(improved, res, s["cres"]),
                    direction=tree_where(improved, d, s["direction"]),
                    quad=torch.where(improved, q, s["quad"]),
                    count=count, done=~(improved & (count < self.max_resolves)))

    def backtrack(self, s: dict, res: CauchyResult) -> dict:
        """A backtracking trip: the radius shrinks until sufficient
        decrease holds; ``res`` is the LP at ``s``'s radius x decrease."""
        radius = s["radius"] * self.decrease
        d = self.direction_of(res.lp_step)
        q, sufficient = self.merit_and_decrease(d)
        count = s["count"] + 1
        return dict(radius=radius, cres=res, direction=d, quad=q, count=count,
                    done=sufficient | (count >= self.max_resolves))


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
    sweep = Sweep(mode, data, it, hess_prod, penalty, cauchy_eta, settings_eps)

    def resolve(radius: Tensor, prev: CauchyResult) -> CauchyResult:
        return solve_cauchy_lp(data, it, radius, penalty, prev.basis, settings_eps=settings_eps,
                               lp_solver=lp_solver, pdlp_tol=pdlp_tol,
                               compute_dtype=compute_dtype)

    s0, sufficient0 = sweep.begin(lp_trust_radius, cres)

    def not_done(s: dict) -> Tensor:
        return ~s["done"]

    def forward_body(s: dict, trip: int) -> dict:
        return sweep.forward(s, resolve(s["radius"] * sweep.increase, s["cres"]))

    def backtrack_body(s: dict, trip: int) -> dict:
        return sweep.backtrack(s, resolve(s["radius"] * sweep.decrease, s["cres"]))

    # lanes outside a sweep start it done; the first trip's lanes are known.
    # ``done`` holds after max_resolves trips, so the loop ends by then; its
    # cap leaves room for the read that sees it done, as the loop reads one
    # flag a resolve
    cap = sweep.max_resolves + 1
    run_forward = lanes_any(sufficient0)
    run_backtrack = lanes_any(~sufficient0) if is_batched(sufficient0) else not run_forward
    out = None
    if run_forward:
        out = lockstep(not_done, forward_body, dict(s0, done=~sufficient0), max_trips=cap,
                       first=sufficient0)
    if run_backtrack:
        back = lockstep(not_done, backtrack_body, dict(s0, done=sufficient0), max_trips=cap,
                        first=~sufficient0)
        out = back if out is None else lanes_where(sufficient0, out, back)
    return out["cres"], out["radius"], out["direction"], out["quad"]
