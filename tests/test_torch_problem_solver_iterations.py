"""Port parity, one iteration at a time: from every iterate the JAX
package takes on HS71 and on chainineq (n = 20), one port
``perform_iteration`` must give JAX's next state.

The bar: x, the trust radius, the LP trust radius, the penalty and the
residuals (every float of the state) to 1e-9; the status, the step type,
the working set and every counter exactly.  The saved LP basis must be
JAX's, or, at a degenerate vertex where the ratio test ties to rounding
(the two packages sum matrix-vector products in another order), another
optimal basis of the same LP at the same point: then the pivot count may
differ too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.problem_solver as jps
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu_torch import Settings, Status
from sleqp_tpu_torch import cauchy as tc
from sleqp_tpu_torch import problem_solver as tps
from sleqp_tpu_torch.ops import simplex as ts
from sleqp_tpu_torch.types import BaseStat
from torch_dense import chainineq, flat_jax, flat_port, hs71, mismatches, port_state
from torch_parity import no_jax_cache_writes  # noqa: F401

PAIRS = {"hs71": hs71, "chainineq20": lambda: chainineq(20)}
NONLIN = ("measure.obj_nonlin", "measure.cons_nonlin", "measure.lag_nonlin")


@pytest.fixture(scope="module", params=sorted(PAIRS))
def trajectory(request):
    """JAX's states from the start to the end of its solve (one jitted
    perform_iteration per problem)."""
    jp, tp, x0 = PAIRS[request.param]()
    settings = JaxSettings()
    step = jax.jit(lambda s: jps.perform_iteration(jp, settings, s))
    states = [jps.initial_state(jp, settings, jnp.asarray(x0))]
    while int(states[-1].status) == Status.RUNNING and len(states) < 100:
        states.append(step(states[-1]))
    assert int(states[-1].status) == Status.OPTIMAL
    return request.param, tp, states


def _lp_vertex(tp, before, penalty, basis, status):
    """x and reduced costs of the LP of this iteration at a given basis."""
    A, lb, ub = tc._lp_data(tp.data, before.it, before.lp_trust_radius)
    c = tc._objective(before.it, penalty, False)
    zero = torch.zeros((), dtype=torch.int32)
    res = ts.SimplexResult(None, None, None, status, basis, None, zero, zero, None)
    out = ts.refine_result(A, c, lb, ub, res)
    return out.x, out.reduced_costs, c


def _check_alternative_basis(tp, before, after, ref_after):
    """The port's basis is another optimal basis of the same LP vertex."""
    penalty = after.penalty
    if int(after.status) != Status.RUNNING:
        penalty = tps.global_penalty_reset(before.it, before.penalty, torch.tensor(True))[0]
    x_ref, _, _ = _lp_vertex(tp, before, penalty, torch.as_tensor(np.array(ref_after.basis.basis)),
                             torch.as_tensor(np.array(ref_after.basis.status)))
    x, r, c = _lp_vertex(tp, before, penalty, after.basis.basis, after.basis.status)
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), atol=1e-9)
    tol = 1e-9 * (1.0 + float(c.abs().max()))
    s, r = after.basis.status.numpy(), r.numpy()
    assert np.all(r[s == BaseStat.LOWER] >= -tol) and np.all(r[s == BaseStat.UPPER] <= tol)
    assert np.all(np.abs(r[(s == BaseStat.BASIC) | (s == BaseStat.ZERO)]) <= tol)
    assert bool(after.basis.valid) and bool(ref_after.basis.valid)


def test_every_iteration_from_jax_state_matches_jax(trajectory):
    name, tp, states = trajectory
    settings = Settings()
    alternative = []
    for k, (before, ref_after) in enumerate(zip(states[:-1], states[1:])):
        tbefore = port_state(before)
        after = tps.perform_iteration(tp, settings, tbefore)
        got, ref = flat_port(after), flat_jax(ref_after)
        bad = mismatches(got, ref, 1e-9, skip=("basis.", "lp_iterations") + NONLIN)
        assert not bad, (k, bad)
        # the nonlinearity measures divide model errors by ||d||^2: a
        # rounding of the objective or constraint values moves them by
        # ~eps (1 + |f| + |c|) / ||d||^2
        d2 = float(ref["measure.step_norm"]) ** 2
        scale = 1.0 + abs(float(ref["it.obj_val"])) + np.abs(ref["it.cons_val"]).sum()
        for key in NONLIN:
            if d2 > 0:
                assert abs(float(got[key]) - float(ref[key])) <= 1e-13 * scale / d2 + 1e-9, (k, key)
        same_basis = np.array_equal(after.basis.status.numpy(), np.asarray(ref_after.basis.status)) \
            and np.array_equal(after.basis.basis.numpy(), np.asarray(ref_after.basis.basis))
        if same_basis:
            assert int(after.lp_iterations) == int(ref_after.lp_iterations), k
        else:
            _check_alternative_basis(tp, tbefore, after, ref_after)
            alternative.append(k)
    # the port's state is on the problem's device with the reference dtypes
    assert after.it.var_states.dtype == torch.int8 and after.iteration.dtype == torch.int32
    # HS71's LPs are solved by enumeration and take JAX's basis every time
    if name == "hs71":
        assert not alternative
    assert len(alternative) <= len(states) // 2, alternative
