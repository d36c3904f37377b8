"""Port parity of the parametric Cauchy step (sleqp_tpu_torch/parametric.py
against sleqp_tpu/parametric.py).

* the cases of tests/test_variants.py::test_parametric_cauchy (COARSE and
  FINE on quadcons and HS71), each held against JAX's whole solve: the
  same status, x to 1e-8 and the same iteration count;
* one port iteration from every JAX iterate of HS71 and quadcons under
  each mode, to 1e-9 (their LPs are solved by enumeration);
* chainineq (n = 20) under each mode, whose LPs the simplex solves.  At a
  degenerate vertex the two packages' ratio tests tie and keep other
  optimal bases of the same LP vertex (ROADMAP.md queue C): the LP
  re-solves of the sweep agree in radius, objective and step, but the
  working sets read from the bases differ, and so do the Newton steps.
  The solves are held to the same status, x to 1e-8 and at most 3
  iterations apart (FINE: the port takes 9 against JAX's 11).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sleqp_tpu.problem_solver as jps
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.types import ParametricCauchy as JaxParametricCauchy
from sleqp_tpu_torch import ParametricCauchy, Settings, Status, solve
from torch_dense import chainineq, hs71, iteration_mismatches, jax_states, quadcons
from torch_parity import no_jax_cache_writes  # noqa: F401

PAIRS = {"quadcons": quadcons, "hs71": hs71}
X_OPT = {"quadcons": [0.0, 0.0], "hs71": [1.0, 4.742999, 3.821151, 1.379408]}


def _settings(mode):
    return (JaxSettings(parametric_cauchy=JaxParametricCauchy[mode]),
            Settings(parametric_cauchy=ParametricCauchy[mode]))


@pytest.mark.parametrize("mode", ["COARSE", "FINE"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_parametric_cauchy(mode, name):
    jp, tp, x0 = PAIRS[name]()
    js, ts = _settings(mode)
    ref = jps.solve(jp, js, jnp.asarray(x0), max_iterations=200)
    out = solve(tp, ts, x0, max_iterations=200, device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    np.testing.assert_allclose(out.it.x.numpy(), X_OPT[name], atol=2e-5)
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=1e-8)
    assert int(out.iteration) == int(ref.iteration)


@pytest.mark.parametrize("mode", ["COARSE", "FINE"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_every_iteration_from_jax_state_matches_jax(mode, name):
    jp, tp, x0 = PAIRS[name]()
    js, ts = _settings(mode)
    states = jax_states(jp, js, x0)
    assert int(states[-1].status) == Status.OPTIMAL
    assert not iteration_mismatches(tp, ts, states)


@pytest.mark.parametrize("mode", ["COARSE", "FINE"])
def test_chainineq_rounding_tie(mode):
    jp, tp, x0 = chainineq(20)
    js, ts = _settings(mode)
    ref = jps.solve(jp, js, jnp.asarray(x0), max_iterations=200)
    out = solve(tp, ts, x0, max_iterations=200, device="cpu")
    assert int(out.status) == int(ref.status) == Status.OPTIMAL
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=1e-8)
    assert abs(int(out.iteration) - int(ref.iteration)) <= 3, (int(out.iteration),
                                                                int(ref.iteration))
