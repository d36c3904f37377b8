"""Port parity of the command line (``python -m sleqp_tpu_torch``,
sleqp_tpu_torch/__main__.py) against sleqp_tpu's CLI.

The port's CLI runs as a subprocess with ``--device cpu``; the reference's
``main`` runs in this process on the CPU.  On ``--hs hs71``, on a problem
``.py`` file written to ``tmp_path`` (``make()`` in each package's
callables) and on HS71 with ``--settings FILE`` and ``--set k=v``, the
``--json`` outputs agree: status and iterations equal, the objective and
x within 1e-8, the duals within 1e-6.  Without a card, the default device
is refused: the CLI exits 2 and prints no result.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sleqp_tpu.__main__ import main as jax_main
from torch_parity import no_jax_cache_writes  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

JAX_PROBLEM = """
import jax.numpy as jnp
from sleqp_tpu import Func, Problem


def make():
    func = Func(lambda x: (x[0] - 1.0) ** 2 + 4.0 * (x[1] - x[0] ** 2) ** 2, 2,
                cons=lambda x: jnp.array([x[0] + x[1]]), num_cons=1)
    return Problem(func, var_lb=-2.0, var_ub=2.0, general_ub=1.5), jnp.array([-1.0, 0.5])
"""

PORT_PROBLEM = """
import torch
from sleqp_tpu_torch import Func, Problem


def make():
    func = Func(lambda x: (x[0] - 1.0) ** 2 + 4.0 * (x[1] - x[0] ** 2) ** 2, 2,
                cons=lambda x: (x[0] + x[1])[None], num_cons=1)
    return (Problem(func, var_lb=-2.0, var_ub=2.0, general_ub=1.5, device="cpu"),
            torch.tensor([-1.0, 0.5], dtype=torch.float64))
"""

SETTINGS = "# settings file\nfeas_tol = 1e-8\nmax_newton_iterations = 20\n"


def port_cli(args, **env):
    environ = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    environ.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **env)
    return subprocess.run([sys.executable, "-m", "sleqp_tpu_torch", *args], cwd=REPO,
                          env=environ, capture_output=True, text=True, timeout=300)


def _args(case, tmp_path, package):
    if case == "hs71":
        return ["--hs", "hs71"]
    if case == "problem_file":
        path = tmp_path / f"{package}_problem.py"
        path.write_text(JAX_PROBLEM if package == "jax" else PORT_PROBLEM)
        return [str(path)]
    path = tmp_path / "settings.txt"
    path.write_text(SETTINGS)
    return ["--hs", "hs71", "--settings", str(path), "--set", "stat_tol=1e-8"]


@pytest.mark.parametrize("case", ["hs71", "problem_file", "settings"])
def test_cli_json_matches_jax(case, tmp_path, capsys):
    assert jax_main([*_args(case, tmp_path, "jax"), "--json"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    proc = port_cli([*_args(case, tmp_path, "port"), "--json", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["status"] == ref["status"] == "OPTIMAL"
    assert out["iterations"] == ref["iterations"] and out["device"] == "cpu"
    assert set(out) >= set(ref)
    np.testing.assert_allclose(out["objective"], ref["objective"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=1e-8)
    for key in ("cons_dual", "vars_dual"):
        np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=1e-6)
    for key in ("feas_res", "slack_res", "stat_res"):
        assert out[key] <= 1e-6


def test_cli_without_card_fails():
    proc = port_cli(["--hs", "hs71", "--json"], CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 2
    assert "CUDA" in proc.stderr and "--device cpu" in proc.stderr
    assert '"status"' not in proc.stdout
