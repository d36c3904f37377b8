"""Port parity of the suite harness, HS part: sleqp_tpu_torch/harness/hs.py
and harness/driver.py against sleqp_tpu/harness.

* one case per HS problem: names, x0, bounds, f_opt equal to JAX's; f,
  grad f, c and J at x0 and at a seeded perturbation to 1e-12, NaN
  pattern included (JAX's derivatives taken eagerly);
* the driver's schema, names (the 101 rows of the r5 sweep), options and
  status names;
* tests/test_harness.py::test_suite_subset_all_solved through the port's
  driver, each row held to its r5 CSV row.
"""

import pytest
import torch

import sleqp_tpu.harness.driver as jdriver
from sleqp_tpu.harness import hs as jhs
from sleqp_tpu.harness.large import LARGE_PROBLEMS
from sleqp_tpu_torch.harness import ALL_PROBLEMS, CSV_HEADER, run_suite
from sleqp_tpu_torch.harness import driver as tdriver
from sleqp_tpu_torch.harness import hs as ths
from torch_harness import check_problem, check_row
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SUBSET = ["hs4", "hs9", "hs14", "hs35", "hs43", "hs71"]


def test_hs_registry_matches_jax():
    assert ths.HS_PROBLEMS == jhs.HS_PROBLEMS
    assert len(ths.HS_PROBLEMS) == 81


@pytest.mark.parametrize("name", jhs.HS_PROBLEMS)
def test_hs_problem_matches_jax(name):
    check_problem(name, jhs.get_problem, ths.get_problem)


def test_driver_schema_and_options_match_jax():
    assert CSV_HEADER == jdriver.CSV_HEADER and len(CSV_HEADER.split(";")) == 14
    assert tdriver._PROBLEM_OPTIONS == jdriver._PROBLEM_OPTIONS
    assert {int(k): v for k, v in tdriver._STATUS_NAMES.items()} == {
        int(k): v for k, v in jdriver._STATUS_NAMES.items()}
    assert set(LARGE_PROBLEMS) <= set(ALL_PROBLEMS)
    assert ALL_PROBLEMS == jdriver.ALL_PROBLEMS
    assert len(ALL_PROBLEMS) == 101


def test_driver_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tdriver.get_problem("hs35"), lambda: ths.get_problem("hs35"),
                 lambda: tdriver.run_problem("hs35"), lambda: run_suite(["hs35"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_suite_subset_all_solved():
    result = run_suite(SUBSET, max_iterations=300, device="cpu")
    assert result.solved == len(SUBSET), result.rows
    assert not result.wrong_objective
    assert result.total == len(SUBSET) and result.solved_fraction == 1.0
    for row in result.rows:
        check_row(row)


def test_problem_options_apply_over_explicit_settings():
    """hs111's SIMPLEX option overrides an explicit lp_solver, as the
    reference's driver does (driver.py:178-184)."""
    from sleqp_tpu_torch import LPSolver, Settings
    from sleqp_tpu_torch import solver as tsolver

    seen = []
    real = tsolver.Solver.__init__

    def spy(self, problem, x0, settings=None, scaling=None, device=None):
        seen.append((settings.lp_solver if settings else None, scaling))
        real(self, problem, x0, settings, scaling=scaling, device=device)

    tsolver.Solver.__init__ = spy
    try:
        tdriver.run_problem("hs111", Settings(lp_solver=LPSolver.ENUM), max_iterations=1,
                            device="cpu")
        tdriver.run_problem("hs62", Settings(), max_iterations=1, device="cpu")
    finally:
        tsolver.Solver.__init__ = real
    assert seen == [(LPSolver.SIMPLEX, None), (LPSolver.AUTO, "auto")]
