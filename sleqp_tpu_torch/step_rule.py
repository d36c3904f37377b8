"""Step acceptance rules: direct, window, minstep.

Port of ``sleqp_tpu/step_rule.py`` (reference src/main/step/): the
nonmonotone rules keep fixed-shape state on the solver state.

* WINDOW (window 25): ring buffer of accepted (exact merit, model
  reduction); historic ratio (max windowed merit - trial) / (sum of model
  reductions since that max + current) (step_rule_window.c:78-117)
* MINSTEP (step count 2): watermark rule with reference/max merits and
  model-decrease sums (step_rule_minstep.c)

The final ratio is max(current, historic); accept if >= accepted_reduction.
"""

from __future__ import annotations

import dataclasses

import torch

from .types import StepRule

Tensor = torch.Tensor

WINDOW_SIZE = 25  # step_rule.c:13
MINSTEP_COUNT = 2  # step_rule.c:14


@dataclasses.dataclass(frozen=True)
class StepRuleState:
    """Union state for all rules (unused parts stay at defaults)."""

    # window rule ring buffer (newest entry last)
    merits: Tensor  # (W,)
    reductions: Tensor  # (W,)
    length: Tensor  # int32 valid entries
    # minstep watermarks
    init: Tensor  # bool
    min_merit: Tensor
    ref_merit: Tensor
    max_merit: Tensor
    decrease_sum_ref: Tensor
    decrease_sum_max: Tensor
    step_count: Tensor  # int32


def step_rule_init(rule: StepRule, dtype, device=None) -> StepRuleState:
    W = WINDOW_SIZE if rule == StepRule.WINDOW else 0

    def zero():
        return torch.zeros((), dtype=dtype, device=device)

    return StepRuleState(
        merits=torch.full((W,), -torch.inf, dtype=dtype, device=device),
        reductions=torch.zeros((W,), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
        init=torch.zeros((), dtype=torch.bool, device=device),
        min_merit=zero(),
        ref_merit=zero(),
        max_merit=zero(),
        decrease_sum_ref=zero(),
        decrease_sum_max=zero(),
        step_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def reduction_ratio(exact_reduction: Tensor, model_reduction: Tensor) -> Tensor:
    """util.c:245-261 sleqp_reduction_ratio."""
    eps = 10.0 * torch.finfo(exact_reduction.dtype).eps
    ce = exact_reduction - eps
    cm = model_reduction - eps
    tiny = (cm.abs() <= eps) & (ce.abs() <= eps)
    return torch.where(tiny, 1.0, ce / torch.where(tiny, 1.0, cm))


def _ratio(exact_reduction: Tensor, model_reduction: Tensor) -> Tensor:
    same = exact_reduction == model_reduction
    return torch.where(same, 1.0, exact_reduction / torch.where(same, 1.0, model_reduction))


def apply_step_rule(rule: StepRule, state: StepRuleState, iterate_merit: Tensor,
                    trial_exact_merit: Tensor, trial_model_merit: Tensor,
                    accepted_reduction: float):
    """Returns (accept, reduction_ratio, state_for_accept, state_for_reject);
    the caller picks the post state from the final accept decision (which
    may involve a second-order correction with another trial merit)."""
    exact_reduction = iterate_merit - trial_exact_merit
    model_reduction = iterate_merit - trial_model_merit
    current = _ratio(exact_reduction, model_reduction)

    if rule == StepRule.DIRECT:
        ratio = reduction_ratio(exact_reduction, model_reduction)
        return ratio >= accepted_reduction, ratio, state, state

    if rule == StepRule.WINDOW:
        W = WINDOW_SIZE
        # historic ratio: reference index = argmax of the windowed merits
        has_hist = state.length > 0
        ref_idx = torch.argmax(state.merits)
        ref_merit = state.merits.index_select(0, ref_idx.reshape(1))[0]
        idx = torch.arange(W, device=state.merits.device)
        # sum of model reductions from ref_idx (inclusive) to the end
        tail_sum = torch.where(idx >= ref_idx, state.reductions, 0.0).sum()
        hist = (ref_merit - trial_exact_merit) / (tail_sum + model_reduction)
        use_hist = has_hist & (ref_merit >= trial_exact_merit)
        ratio = torch.where(use_hist, torch.maximum(current, hist), current)
        accept = ratio >= accepted_reduction

        new_merits = torch.roll(state.merits, -1)
        new_merits[-1] = iterate_merit
        new_reds = torch.roll(state.reductions, -1)
        new_reds[-1] = torch.clamp(model_reduction, min=0.0)
        accept_state = dataclasses.replace(state, merits=new_merits, reductions=new_reds,
                                           length=torch.clamp(state.length + 1, max=W))
        return accept, ratio, accept_state, state

    assert rule == StepRule.MINSTEP
    # lazily initialize the watermarks at the current merit
    ref = torch.where(state.init, state.ref_merit, iterate_merit)
    mn = torch.where(state.init, state.min_merit, iterate_merit)
    mx = torch.where(state.init, state.max_merit, iterate_merit)
    dec_ref = torch.where(state.init, state.decrease_sum_ref, 0.0)
    dec_max = torch.where(state.init, state.decrease_sum_max, 0.0)
    count = torch.where(state.init, state.step_count, 0)

    hist = (ref - trial_exact_merit) / (dec_ref + model_reduction)
    ratio = torch.maximum(current, hist)
    accept = ratio >= accepted_reduction

    # accepted bookkeeping (step_rule_minstep.c:118-168)
    dec_ref_acc = dec_ref + model_reduction
    dec_max_acc = dec_max + model_reduction
    new_min = iterate_merit < mn
    mn_acc = torch.where(new_min, iterate_merit, mn)
    mx_acc = torch.where(new_min, iterate_merit, mx)
    dec_ref_acc = torch.where(new_min, 0.0, dec_ref_acc)
    dec_max_acc = torch.where(new_min, 0.0, dec_max_acc)
    count_acc = torch.where(new_min, 0, count + 1)

    new_max = (~new_min) & (iterate_merit > mx_acc)
    mx_acc = torch.where(new_max, iterate_merit, mx_acc)
    dec_max_acc = torch.where(new_max, 0.0, dec_max_acc)

    hit_limit = count_acc == MINSTEP_COUNT
    ref_acc = torch.where(hit_limit, mx_acc, ref)
    dec_ref_acc = torch.where(hit_limit, dec_max_acc, dec_ref_acc)

    true = torch.ones((), dtype=torch.bool, device=state.init.device)
    accept_state = StepRuleState(
        merits=state.merits,
        reductions=state.reductions,
        length=state.length,
        init=true,
        min_merit=mn_acc,
        ref_merit=ref_acc,
        max_merit=mx_acc,
        decrease_sum_ref=dec_ref_acc,
        decrease_sum_max=dec_max_acc,
        step_count=count_acc.to(torch.int32),
    )
    reject_state = dataclasses.replace(
        state, init=true, min_merit=mn, ref_merit=ref, max_merit=mx,
        decrease_sum_ref=dec_ref, decrease_sum_max=dec_max, step_count=count.to(torch.int32))
    return accept, ratio, accept_state, reject_state
