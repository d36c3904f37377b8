"""Linesearches on the piecewise-linear penalty model.

Port of ``sleqp_tpu/linesearch.py`` (reference src/main/linesearch.c):

* ``cauchy_linesearch`` (linesearch.c:153-315) backtracks the LP step
  against the quadratic penalty model;
* ``trial_linesearch`` (linesearch.c:318-640, APPROX) finds the blending
  ``alpha`` of the Cauchy->Newton segment by Armijo backtracking on the
  quadratic merit;
* ``trial_linesearch_exact`` (EXACT) minimizes the piecewise quadratic
  merit over a fixed candidate set on the segment.

Model values come from cached direction products; each backtracking
``lax.while_loop`` of the reference is a ``lanes.lockstep`` loop that
reads one flag per step for all lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .iterate import Iterate, total_violation, violated_cons_multipliers
from .lanes import lockstep
from .merit import Direction, blend
from .problem import ProblemData
from .types import INF_THRESHOLD

Tensor = torch.Tensor

_MAX_IT = 200  # delta/alpha shrink past 1e-60 with tau=.5; 200 is ample
MAX_TRIALS = _MAX_IT + 1  # a linesearch's trials


class CauchySearch(NamedTuple):
    """What the Cauchy linesearch's trials take from its start."""

    exact_violation: Tensor
    hess_bilinear: Tensor
    delta0: Tensor


def cauchy_search(data: ProblemData, it: Iterate, direction: Direction,
                  trust_radius: Tensor):
    """(``CauchySearch``, the loop state before the first trial)."""
    exact_violation = total_violation(data, it.cons_val)
    hess_bilinear = torch.dot(direction.primal, direction.hess)

    norm = torch.linalg.norm(direction.primal)
    delta0 = torch.clamp(trust_radius / torch.where(norm > 0.0, norm, 1.0), max=1.0)
    not_done = torch.zeros_like(delta0, dtype=torch.bool)
    return CauchySearch(exact_violation, hess_bilinear, delta0), (delta0, not_done)


def cauchy_trial(data: ProblemData, it: Iterate, direction: Direction, penalty: Tensor,
                 cs: CauchySearch, tau: float, eta: float, eps: float):
    """One trial of the Cauchy linesearch, ``body(s, trip)``."""

    def body(s, trip):
        delta = s[0]
        lin_viol = total_violation(data, it.cons_val + delta * direction.cons_jac_dot)
        lhs = (penalty * (cs.exact_violation - lin_viol) - delta * direction.obj_dot) * (1.0 - eta)
        ok = lhs >= 0.5 * delta * delta * cs.hess_bilinear
        delta_next = torch.where(ok, delta, delta * tau)
        vanished = delta_next <= eps
        return torch.where(vanished, 0.0, delta_next), ok | vanished

    return body


def cauchy_result(data: ProblemData, it: Iterate, direction: Direction, penalty: Tensor,
                  cs: CauchySearch, delta: Tensor):
    """(the scaled direction, whether the step is full, its quadratic
    merit) at the linesearch's end."""
    scaled = direction.scale(delta)
    lin_viol = total_violation(data, it.cons_val + scaled.cons_jac_dot)
    quad_merit = (it.obj_val + scaled.obj_dot + penalty * lin_viol
                  + 0.5 * torch.dot(scaled.primal, scaled.hess))
    return scaled, delta >= cs.delta0, quad_merit


def cauchy_linesearch(data: ProblemData, it: Iterate, direction: Direction, penalty: Tensor,
                      trust_radius: Tensor, tau: float, eta: float, eps: float):
    """Scale the Cauchy direction; returns (direction, full_step, quad_merit)."""
    cs, s0 = cauchy_search(data, it, direction, trust_radius)
    body = cauchy_trial(data, it, direction, penalty, cs, tau, eta, eps)
    delta, _ = lockstep(lambda s: ~s[1], body, s0, max_trips=MAX_TRIALS, first=True)
    return cauchy_result(data, it, direction, penalty, cs, delta)


def max_step_length(point: Tensor, direction: Tensor, lb: Tensor, ub: Tensor) -> Tensor:
    """Largest alpha in [0,1] with point + alpha*direction in [lb,ub]
    (util.c:127-239 sleqp_max_step_length)."""
    pos = direction > 0.0
    neg = direction < 0.0
    safe_dir = torch.where(direction != 0.0, direction, 1.0)
    t_up = torch.where(pos & (ub < INF_THRESHOLD), (ub - point) / safe_dir, torch.inf)
    t_low = torch.where(neg & (lb > -INF_THRESHOLD), (lb - point) / safe_dir, torch.inf)
    inf = torch.full((), torch.inf, dtype=point.dtype, device=point.device)
    t = torch.minimum(torch.cat([t_up, inf[None]]).amin(), torch.cat([t_low, inf[None]]).amin())
    return torch.clamp(t, 0.0, 1.0)


def _segment_products(cauchy_dir: Direction, newton_dir: Direction):
    cc = torch.dot(cauchy_dir.primal, cauchy_dir.hess)
    cn = torch.dot(cauchy_dir.primal, newton_dir.hess)
    nn = torch.dot(newton_dir.primal, newton_dir.hess)
    return cc, cn, nn


class TrialSearch(NamedTuple):
    """What the trial linesearch's trials take from its start."""

    cc: Tensor
    cn: Tensor
    nn: Tensor
    merit_grad_product: Tensor


def trial_search(data: ProblemData, it: Iterate, cauchy_dir: Direction,
                 newton_dir: Direction, cutoff: float):
    """(``TrialSearch``, the loop state before the first trial)."""
    cc, cn, nn = _segment_products(cauchy_dir, newton_dir)

    cauchy_newton = newton_dir.primal - cauchy_dir.primal
    cauchy_point = it.x + cauchy_dir.primal
    alpha0 = max_step_length(cauchy_point, cauchy_newton, data.var_lb, data.var_ub)

    # directional derivative of the quadratic merit along Cauchy->Newton
    viol_mult = violated_cons_multipliers(data, it.cons_val + cauchy_dir.cons_jac_dot)
    grad_cauchy = cauchy_dir.obj_dot + torch.dot(viol_mult, cauchy_dir.cons_jac_dot) + cc
    grad_newton = newton_dir.obj_dot + torch.dot(viol_mult, newton_dir.cons_jac_dot) + cn
    start_vanished = alpha0 <= cutoff
    return (TrialSearch(cc, cn, nn, grad_newton - grad_cauchy),
            (torch.where(start_vanished, 0.0, alpha0), start_vanished))


def _trial_quad_merit(data: ProblemData, it: Iterate, cauchy_dir: Direction,
                      newton_dir: Direction, penalty: Tensor, ts: TrialSearch, alpha: Tensor):
    lin = it.obj_val + (1.0 - alpha) * cauchy_dir.obj_dot + alpha * newton_dir.obj_dot
    combined = (it.cons_val + (1.0 - alpha) * cauchy_dir.cons_jac_dot
                + alpha * newton_dir.cons_jac_dot)
    lin = lin + penalty * total_violation(data, combined)
    quad_term = (0.5 * (1.0 - alpha) ** 2 * ts.cc
                 + alpha * ((1.0 - alpha) * ts.cn + 0.5 * alpha * ts.nn))
    return lin + quad_term


def trial_trial(data: ProblemData, it: Iterate, cauchy_dir: Direction,
                cauchy_quad_merit: Tensor, newton_dir: Direction, penalty: Tensor,
                ts: TrialSearch, tau: float, eta: float, cutoff: float):
    """One trial of the trial linesearch, ``body(s, trip)``."""

    def body(s, trip):
        alpha = s[0]
        ok = (_trial_quad_merit(data, it, cauchy_dir, newton_dir, penalty, ts, alpha)
              <= cauchy_quad_merit + eta * alpha * ts.merit_grad_product)
        alpha_next = torch.where(ok, alpha, alpha * tau)
        vanished = alpha_next <= cutoff
        return torch.where(vanished, 0.0, alpha_next), ok | vanished

    return body


def trial_result(data: ProblemData, it: Iterate, cauchy_dir: Direction,
                 cauchy_quad_merit: Tensor, newton_dir: Direction, penalty: Tensor,
                 ts: TrialSearch, alpha: Tensor):
    """(the trial direction, alpha, the trial quadratic merit) at the
    linesearch's end."""
    trial = blend(cauchy_dir, newton_dir, alpha)
    trial_merit = torch.where(
        alpha > 0.0, _trial_quad_merit(data, it, cauchy_dir, newton_dir, penalty, ts, alpha),
        cauchy_quad_merit)
    return trial, alpha, trial_merit


def trial_linesearch(data: ProblemData, it: Iterate, cauchy_dir: Direction,
                     cauchy_quad_merit: Tensor, newton_dir: Direction, penalty: Tensor,
                     tau: float, eta: float, cutoff: float):
    """Blend Cauchy -> Newton (APPROX rule).  Returns (trial_direction,
    step length alpha, trial quadratic merit); alpha = 0 reproduces the
    Cauchy direction."""
    ts, s0 = trial_search(data, it, cauchy_dir, newton_dir, cutoff)
    body = trial_trial(data, it, cauchy_dir, cauchy_quad_merit, newton_dir, penalty, ts, tau,
                       eta, cutoff)
    alpha, _ = lockstep(lambda s: ~s[1], body, s0, max_trips=MAX_TRIALS)
    return trial_result(data, it, cauchy_dir, cauchy_quad_merit, newton_dir, penalty, ts, alpha)


def trial_linesearch_exact(data: ProblemData, it: Iterate, cauchy_dir: Direction,
                           cauchy_quad_merit: Tensor, newton_dir: Direction, penalty: Tensor,
                           cutoff: float):
    """EXACT variant (linesearch.c:794-): the global minimizer of the
    piecewise quadratic merit phi(alpha) on the Cauchy->Newton segment,
    taken over all bound-crossing breakpoints plus the per-segment
    stationary points clipped into [0, alpha_max]."""
    cc, cn, nn = _segment_products(cauchy_dir, newton_dir)

    cauchy_newton = newton_dir.primal - cauchy_dir.primal
    alpha_max = max_step_length(it.x + cauchy_dir.primal, cauchy_newton, data.var_lb,
                                data.var_ub)

    # linearized constraint values v(alpha) = a + alpha * b
    a = it.cons_val + cauchy_dir.cons_jac_dot
    b = newton_dir.cons_jac_dot - cauchy_dir.cons_jac_dot

    # quadratic part q(alpha) with q'(alpha) = q1 + q2*alpha
    q1 = (newton_dir.obj_dot - cauchy_dir.obj_dot) - cc + cn
    q2 = cc - 2.0 * cn + nn

    safe_b = torch.where(b != 0.0, b, 1.0)
    cross_ub = torch.where((b != 0.0) & (data.cons_ub < INF_THRESHOLD),
                           (data.cons_ub - a) / safe_b, -1.0)
    cross_lb = torch.where((b != 0.0) & (data.cons_lb > -INF_THRESHOLD),
                           (data.cons_lb - a) / safe_b, -1.0)
    zero = torch.zeros((1,), dtype=a.dtype, device=a.device)
    breaks = torch.cat([zero, alpha_max.reshape(1), cross_ub, cross_lb])
    breaks = torch.minimum(torch.maximum(breaks, zero), alpha_max)
    breaks = torch.sort(breaks).values

    # per-segment stationary candidates: the midpoints give the active
    # penalty-slope regime; solve q1 + q2*alpha + pen_slope = 0 there
    lo, hi = breaks[:-1], breaks[1:]
    mids = 0.5 * (lo + hi)
    v = a[None, :] + mids[:, None] * b[None, :]
    slopes = penalty * (torch.where(v > data.cons_ub, b, 0.0)
                        - torch.where(v < data.cons_lb, b, 0.0)).sum(dim=1)
    safe_q2 = torch.where(q2 != 0.0, q2, 1.0)
    stationary = torch.where(q2 > 0.0, -(q1 + slopes) / safe_q2, mids)
    stationary = torch.minimum(torch.maximum(stationary, lo), hi)

    alphas = torch.cat([breaks, stationary])
    lin = it.obj_val + (1.0 - alphas) * cauchy_dir.obj_dot + alphas * newton_dir.obj_dot
    v = a[None, :] + alphas[:, None] * b[None, :]
    viol = (torch.clamp(v - data.cons_ub, min=0.0) + torch.clamp(data.cons_lb - v, min=0.0)).sum(dim=1)
    quad = 0.5 * (1.0 - alphas) ** 2 * cc + alphas * ((1.0 - alphas) * cn + 0.5 * alphas * nn)
    values = lin + penalty * viol + quad
    best = torch.argmin(values).reshape(1)
    alpha = alphas.index_select(0, best)[0]
    best_value = values.index_select(0, best)[0]

    # keep the Cauchy point when no candidate improves on it
    use_cauchy = (best_value >= cauchy_quad_merit) | (alpha <= cutoff)
    alpha = torch.where(use_cauchy, 0.0, alpha)

    trial = blend(cauchy_dir, newton_dir, alpha)
    return trial, alpha, torch.where(use_cauchy, cauchy_quad_merit, best_value)
