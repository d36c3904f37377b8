"""The end gate of the port's suite sweep (tools/torch_suite.py) on the
CPU: the 101 rows of the r5 sweep on the float64 and the mixed
route, each row's status and objective held to the r5 CSV, the solved
counts no lower, the named ties of ``TIES`` excepted.  It takes ~5-25
minutes a route on one CPU thread, so tier-1 leaves it out (``slow``)."""

import importlib.util
from pathlib import Path

import pytest

from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOOL = Path(__file__).resolve().parents[1] / "tools" / "torch_suite.py"


def _tool():
    spec = importlib.util.spec_from_file_location("torch_suite", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.slow
@pytest.mark.parametrize("route", ["float64", "mixed"])
def test_suite_end_gate(route, tmp_path):
    tool = _tool()
    rows, result, _ = tool.run(route, "cpu", out=str(tmp_path / "suite.csv"), verbose=False)
    assert len(rows) == 101
    assert result["ok"], result
    # the named ties are the only rows whose status may differ
    assert all((route, r.split(":")[0]) in tool.TIES for r in result["ties"])


def test_suite_gate_logic():
    """The gate on hand-made rows: a status change fails, an objective
    1e-6 off fails, a named tie passes and leaves the solved counts."""
    tool = _tool()
    oracle = tool.read_rows(tool.ORACLES["mixed"])
    f_opts = {"hs35": 1.0 / 9.0, "extrosnb100": 0.0}
    rows = {n: list(oracle[n]) for n in f_opts}
    ok = tool.gate(rows, oracle, f_opts, "mixed")
    assert ok["ok"] and ok["solved"] == ok["solved_r5"] == 2 and not ok["ties"]
    tie = {n: list(r) for n, r in rows.items()}
    tie["extrosnb100"][3], tie["extrosnb100"][8] = "iter_limit", "1000"
    res = tool.gate(tie, oracle, f_opts, "mixed")
    assert res["ok"] and res["ties"] and res["solved"] == res["solved_r5"] == 1
    assert not tool.gate(tie, oracle, f_opts, "float64")["ok"]
    off = {n: list(r) for n, r in rows.items()}
    off["hs35"][4] = repr(float(oracle["hs35"][4]) * (1 + 2e-6) + 2e-6)
    assert not tool.gate(off, oracle, f_opts, "mixed")["ok"]
