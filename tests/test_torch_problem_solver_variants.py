"""Port parity: the options of the dense iteration on HS71 (the exact
linesearch, the nonmonotone step rules, the QR factorization route, the
dual estimates, the initial radius, the CG route, SOC and the Newton step
switched off, the linear model, the numerical invariant checks), and the
manual and non-finite trial rejection of tests/test_trial_rejection.py.
Each must reach JAX's status with x to 1e-8, in JAX's iterations with
JAX's counts of accepted, rejected and SOC steps and failed EQP steps.

Where the reference's own arithmetic decides a step by rounding noise,
the two packages (which sum products in another order) take another path
to the same solution, and only the status, x and an iteration count at
most 3 apart are held (ROADMAP.md queue C): a Krylov step on a
numerically empty null space (GLTR normalizes a projected gradient of
~1e-15 into a unit Lanczos vector; CG continues while r.Pr sits at its
rounding floor above its tolerance), and a trial point that lands
exactly on the boundary of log's domain in one package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu as jx
import sleqp_tpu.problem_solver as jps
import sleqp_tpu_torch as tx
from sleqp_tpu_torch import Status
from sleqp_tpu_torch.types import (
    AugJacMethod, DualEstimationType, InitialTRChoice, Linesearch, StepRule, TRSolver,
)
from torch_dense import hs71
from torch_parity import no_jax_cache_writes  # noqa: F401

VARIANTS = {
    "exact_linesearch": dict(linesearch=Linesearch.EXACT),
    "window": dict(step_rule=StepRule.WINDOW),
    "minstep": dict(step_rule=StepRule.MINSTEP),
    "direct_aug_jac": dict(aug_jac_method=AugJacMethod.DIRECT),
    "lp_duals": dict(dual_estimation_type=DualEstimationType.LP),
    "mixed_duals": dict(dual_estimation_type=DualEstimationType.MIXED),
    "wide_radius_cg": dict(initial_tr_choice=InitialTRChoice.WIDE, tr_solver=TRSolver.CG),
    "no_soc_no_resets": dict(perform_soc=False, global_penalty_resets=False),
    "no_newton": dict(perform_newton_step=False),
    "linear_model": dict(use_quadratic_model=False),
    "num_asserts": dict(num_asserts=True),
}


# the variants whose path a rounding tie of the reference decides
ROUNDING_NOISE = {"no_soc_no_resets", "wide_radius_cg"}


def _compare(jp, tp, x0, kw, max_iterations=200, same_path=True):
    ref = jps.solve(jp, jx.Settings(**kw), jnp.asarray(x0), max_iterations=max_iterations)
    out = tx.solve(tp, tx.Settings(**kw), x0, max_iterations=max_iterations, device="cpu")
    assert int(out.status) == int(ref.status)
    np.testing.assert_allclose(out.it.x.numpy(), np.asarray(ref.it.x), atol=1e-8)
    assert int(out.num_assert_fail) == int(ref.num_assert_fail)
    if not same_path:
        assert abs(int(out.iteration) - int(ref.iteration)) <= 3
        return out, ref
    assert int(out.iteration) == int(ref.iteration)
    for key in ("num_accepted", "num_soc_accepted", "num_rejected", "num_failed_eqp",
                "num_global_resets"):
        assert int(getattr(out, key)) == int(getattr(ref, key)), key
    return out, ref


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hs71_variant_matches_jax(variant):
    jp, tp, x0 = hs71()
    out, ref = _compare(jp, tp, x0, VARIANTS[variant], same_path=variant not in ROUNDING_NOISE)
    if variant != "linear_model":
        assert int(out.status) == Status.OPTIMAL


def test_accept_point_rejection_matches_jax():
    """tests/test_trial_rejection.py::test_accept_point_rejects_region:
    the vetoed region x0 > 0.5 is never entered."""
    jp = jx.Problem(jx.Func(lambda x: (x[0] - 0.4) ** 2 + x[1] ** 2, 2,
                            accept_point=lambda x: x[0] <= 0.5), var_lb=-10.0, var_ub=10.0)
    tp = tx.Problem(tx.Func(lambda x: (x[0] - 0.4) ** 2 + x[1] ** 2, 2,
                            accept_point=lambda x: x[0] <= 0.5), var_lb=-10.0, var_ub=10.0,
                    device="cpu")
    out, _ = _compare(jp, tp, np.array([0.0, 3.0]), {})
    np.testing.assert_allclose(out.it.x.numpy(), [0.4, 0.0], atol=1e-6)


def test_nonfinite_trials_rejected_as_in_jax():
    """tests/test_trial_rejection.py: NaN objective and constraint values
    at trial points are rejected, never taken, and raise nothing."""
    jp = jx.Problem(jx.Func(lambda x: jnp.sqrt(x[0]) + (x[0] - 1.0) ** 2 + x[1] ** 2, 2),
                    var_lb=jnp.array([-5.0, -5.0]), var_ub=5.0)
    tp = tx.Problem(tx.Func(lambda x: torch.sqrt(x[0]) + (x[0] - 1.0) ** 2 + x[1] ** 2, 2),
                    var_lb=np.array([-5.0, -5.0]), var_ub=5.0, device="cpu")
    out, _ = _compare(jp, tp, np.array([4.0, 1.0]), {}, max_iterations=100)
    assert bool(torch.isfinite(out.it.obj_val))

    jp = jx.Problem(jx.Func(lambda x: jnp.vdot(x, x), 2,
                            cons=lambda x: jnp.array([jnp.log(x[0] + x[1])]), num_cons=1),
                    general_lb=jnp.array([-1.0]), general_ub=jnp.array([jnp.inf]))
    tp = tx.Problem(tx.Func(lambda x: x @ x, 2, cons=lambda x: torch.log(x[0] + x[1]).reshape(1),
                            num_cons=1), general_lb=np.array([-1.0]),
                    general_ub=np.array([np.inf]), device="cpu")
    # a trial lands on x0 + x1 = 0 (log = -inf) in one package only
    out, _ = _compare(jp, tp, np.array([2.0, 2.0]), {}, max_iterations=100, same_path=False)
    assert int(out.status) == Status.OPTIMAL
