"""Port parity of the suite harness, medium part:
sleqp_tpu_torch/harness/medium.py against sleqp_tpu/harness/medium.py.

* one case per medium problem: names, x0, bounds, f_opt equal to JAX's
  (the same numpy seeds); f, grad f, c and J at x0 and at a seeded
  perturbation to 1e-12;
* tests/test_harness.py::test_medium_problem_solves through the port's
  driver, each row held to its r5 CSV row.
"""

import pytest

from sleqp_tpu.harness import medium as jmedium
from sleqp_tpu_torch.harness import driver as tdriver
from sleqp_tpu_torch.harness import medium as tmedium
from torch_harness import check_problem, check_row
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_medium_registry_matches_jax():
    assert tmedium.MEDIUM_PROBLEMS == jmedium.MEDIUM_PROBLEMS
    assert len(tmedium.MEDIUM_PROBLEMS) == 17
    assert set(tmedium.MEDIUM_PROBLEMS) <= set(tdriver.ALL_PROBLEMS)


@pytest.mark.parametrize("name", jmedium.MEDIUM_PROBLEMS)
def test_medium_problem_matches_jax(name):
    check_problem(name, jmedium.get_problem, tmedium.get_problem)


@pytest.mark.parametrize("name", ["extrosnb100", "dqrtic100", "broydn100", "chainqp200"])
def test_medium_problem_solves(name):
    """Medium-scale suite problems solve to the published optimum through
    the same driver accounting as the HS sweep, as the r5 sweep did."""
    row, solved, obj_ok = tdriver.run_problem(name, max_iterations=500, device="cpu")
    assert solved, row
    assert obj_ok, row
    check_row(row)
