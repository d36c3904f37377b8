"""The step-taking pieces that the banded and the sparse SQP loops share.

Both loops take an EQP step ``d`` from the iterate ``X`` and globalize it
the same way: a backtracking Armijo linesearch on a merit (the l1 merit in
the optimality phase, the l1 violation in restoration) and a Levenberg
update of the Hessian regularization on the reference's trust_radius.c
thresholds.  The linesearch is a ``lanes.lockstep`` loop, so it reads one
flag a trial when run eagerly and runs its trials masked, reading nothing,
under ``lanes.device_resident()`` (the form a CUDA graph captures).
"""

from __future__ import annotations

import torch

from .lanes import lockstep
from .settings import Settings

Tensor = torch.Tensor

REG_MIN = 1e-10


def scalar(value, dtype, device) -> Tensor:
    # a fill, not a copy from the host: no synchronization on the card
    return torch.full((), value, dtype=dtype, device=device)


def mixed_route(settings: Settings, dtype) -> bool:
    """Whether ``settings`` asks for float32 compute on a float64 problem."""
    return settings.compute_dtype == "float32" and dtype == torch.float64


def levenberg(reg: Tensor, ratio: Tensor, accepted: Tensor, reg_fail: float,
              reg_max: float) -> Tensor:
    """The Levenberg update on the trust_radius.c:47-84 thresholds
    (``accepted``: a 0-d bool tensor)."""
    up = torch.where(
        ratio >= 0.9, torch.clamp(reg / 7.0, min=REG_MIN),
        torch.where(ratio >= 0.3, torch.clamp(reg / 2.0, min=REG_MIN), reg))
    return torch.where(accepted, up, torch.clamp(torch.clamp(10.0 * reg, min=reg_fail),
                                                 max=reg_max))


def trial_point(problem, s, alpha: Tensor) -> Tensor:
    """The point at step length alpha along ``s.d`` from ``s.X``, clipped to
    the variable bounds."""
    return problem.clip(s.X + alpha * s.d)


def armijo_start(s):
    """(alpha, accepted) before the first Armijo trial."""
    return torch.ones_like(s.base), torch.zeros_like(s.has_descent)


def armijo(problem, settings: Settings, trial, s, carry, trips: int, first=None):
    """Up to ``trips`` backtracking trials of the Armijo rule from ``carry``
    (``lockstep``: one read a trial, or ``trips`` masked trials under
    device_resident); ``trial(problem, s, alpha)`` is the merit (or
    violation) at alpha, ``s.base`` its value at alpha = 0 and ``s.descent``
    its predicted decrease."""

    def step(carry, trip):
        alpha, _ = carry
        ok = trial(problem, s, alpha) <= s.base - settings.linesearch_eta * alpha * s.descent
        return torch.where(ok, alpha, settings.linesearch_tau * alpha), ok

    return lockstep(lambda c: s.has_descent & ~c[1], step, carry, max_trips=trips, first=first)
