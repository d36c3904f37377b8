"""Port parity: the Byrd penalty update, the global penalty reset and the
step acceptance rules, sleqp_tpu_torch/{penalty,step_rule}.py against
sleqp_tpu/{penalty,step_rule}.py, to 1e-10; every StepRule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.cauchy as jc
import sleqp_tpu.penalty as jpn
import sleqp_tpu.step_rule as jsr
from sleqp_tpu.iterate import create_iterate
from sleqp_tpu.problem_solver import _reduction_ratio
from sleqp_tpu.types import StepRule
from sleqp_tpu_torch import penalty as tpn
from sleqp_tpu_torch import step_rule as tsr
from sleqp_tpu_torch.convert import tree_from_numpy
from torch_dense import (
    chainineq, flat_jax, flat_port, hs71, jax_cauchy_lp, jax_to_numpy, jax_update_penalty, mismatches,
    port_iterate, wachbieg,
)

import dataclasses
from torch_parity import no_jax_cache_writes  # noqa: F401

PAIRS = {"wachbieg": wachbieg, "hs71": hs71, "chainineq": lambda: chainineq(8)}


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("penalty", [1e-3, 10.0])
def test_update_penalty_matches_jax(name, penalty):
    """From the (infeasible) start: the FEAS re-solve and the x10
    increases, each LP warm-started from the last basis."""
    jp, tp, x0 = PAIRS[name]()
    n, m = jp.num_variables, jp.num_cons
    it = create_iterate(jp, jnp.asarray(x0) + 0.3)
    radius = jnp.asarray(0.5)
    cur = jax_cauchy_lp(jp.data, it, radius, jnp.asarray(penalty), jc.empty_basis(n, m))
    jnew, jres, jchg = jax_update_penalty(jp.data, it, radius, jnp.asarray(penalty), cur)
    tcur = _port_cauchy(cur)
    tnew, tres, tchg = tpn.update_penalty(tp.data, port_iterate(it), torch.tensor(0.5, dtype=torch.float64),
                                          torch.tensor(penalty, dtype=torch.float64), tcur)
    assert bool(tchg) == bool(jchg)
    np.testing.assert_allclose(float(tnew), float(jnew), rtol=1e-12)
    bad = mismatches(flat_port(tres), flat_jax(jres), 1e-10)
    assert not bad, bad


def _port_cauchy(cur):
    from sleqp_tpu_torch.cauchy import CauchyBasis, CauchyResult

    arrays = jax_to_numpy(cur)
    fields = {f: getattr(arrays, f) for f in CauchyResult.__dataclass_fields__ if f != "basis"}
    basis = tree_from_numpy(CauchyBasis, arrays.basis, device="cpu")
    return CauchyResult(basis=basis, **{k: torch.as_tensor(np.array(v)) for k, v in fields.items()})


def test_global_penalty_reset_matches_jax():
    jp, tp, x0 = hs71()
    it = create_iterate(jp, jnp.asarray(x0))
    it = dataclasses.replace(it, cons_dual=jnp.asarray([0.5, -2.0]), vars_dual=jnp.asarray([0.1, 0, 0, -3.0]))
    tit = port_iterate(it)
    for pen in (5.0, 1e5):
        for allow in (True, False):
            jnew, jdid = jpn.global_penalty_reset(it, jnp.asarray(pen), jnp.asarray(allow))
            tnew, tdid = tpn.global_penalty_reset(tit, torch.tensor(pen, dtype=torch.float64),
                                                  torch.tensor(allow))
            assert float(tnew) == float(jnew) and bool(tdid) == bool(jdid)


@pytest.mark.parametrize("rule", list(StepRule))
def test_step_rules_match_jax(rule):
    """A sequence of merits through each rule, choosing the accept or the
    reject state as the solver does; every state and ratio must agree."""
    rng = np.random.default_rng(int(rule))
    js = jsr.step_rule_init(rule, jnp.float64)
    ts = tsr.step_rule_init(rule, torch.float64)
    assert not mismatches(flat_port(ts), flat_jax(js), 0.0)
    merit = 10.0
    for k in range(40):
        trial = merit - rng.uniform(-0.5, 1.0)
        model = merit - rng.uniform(0.0, 1.0) * (k % 7 != 3)
        out_j = jsr.apply_step_rule(rule, js, jnp.asarray(merit), jnp.asarray(trial),
                                    jnp.asarray(model), 1e-8)
        out_t = tsr.apply_step_rule(rule, ts, *(torch.tensor(v, dtype=torch.float64)
                                                for v in (merit, trial, model)), 1e-8)
        assert bool(out_t[0]) == bool(out_j[0])
        np.testing.assert_allclose(float(out_t[1]), float(out_j[1]), rtol=1e-10)
        for a, b in zip(out_t[2:], out_j[2:]):
            bad = mismatches(flat_port(a), flat_jax(b), 1e-10)
            assert not bad, bad
        js, ts = (out_j[2], out_t[2]) if bool(out_j[0]) else (out_j[3], out_t[3])
        if bool(out_j[0]):
            merit = trial
    for exact, model in ((0.0, 0.0), (1e-16, 1e-16), (1.0, 2.0), (-1.0, 1e-20)):
        np.testing.assert_allclose(
            float(tsr.reduction_ratio(*(torch.tensor(v, dtype=torch.float64) for v in (exact, model)))),
            float(_reduction_ratio(jnp.asarray(exact), jnp.asarray(model))), rtol=1e-14)
