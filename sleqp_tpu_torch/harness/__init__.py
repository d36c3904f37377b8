"""Benchmark harness of the port: the Hock-Schittkowski and medium suites
and the CSV driver (``sleqp_tpu/harness``), on a device of the caller's
choice."""

from .driver import ALL_PROBLEMS, BANDED_PROBLEMS, CSV_HEADER, run_problem, run_suite  # noqa: F401
from .hs import HS_PROBLEMS, get_problem  # noqa: F401
