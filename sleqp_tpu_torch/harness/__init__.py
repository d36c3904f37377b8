"""Benchmark harness of the port: the Hock-Schittkowski, medium and large
banded suites and the CSV driver (``sleqp_tpu/harness``), on a device of
the caller's choice."""

from .driver import ALL_PROBLEMS, CSV_HEADER, run_problem, run_suite  # noqa: F401
from .hs import HS_PROBLEMS, get_problem  # noqa: F401
from .large import LARGE_PROBLEMS  # noqa: F401
