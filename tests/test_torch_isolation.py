"""The port stands alone: sleqp_tpu_torch and chip_smoke.py import nothing
of JAX or of sleqp_tpu (the GPU machine has no JAX), chip_smoke.py exits
non-zero without a card or without the repository, and the entry points run
on CUDA unless asked for the CPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sleqp_tpu_torch import BlockStructuredProblem, Settings, ocp_initial_state, ocp_solve
from sleqp_tpu_torch.convert import problem_arrays_from_numpy, state_from_numpy
from sleqp_tpu_torch.kernels import _build
from torch_parity import dynamics, no_jax_cache_writes, stage_cost  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "sleqp_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
before = set(sys.modules)
import sleqp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sleqp_tpu_torch.__path__, "sleqp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(n for n in set(sys.modules) - before if n.split(".")[0] in BLOCKED)
assert not bad, bad
print("imported", len(names) + 2)
"""


def _run(args, cwd, **env):
    environ = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    environ.update(env)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=environ,
        capture_output=True, text=True, timeout=300,
    )


def test_port_and_chip_smoke_import_no_jax():
    proc = _run(["-c", IMPORT_ALL], REPO, PYTHONPATH=str(REPO))
    assert proc.returncode == 0, proc.stderr
    # every module of the package: __init__, types, settings, convert, ocp,
    # kernels (+ _build), ops (+ four modules), and chip_smoke
    assert int(proc.stdout.split()[-1]) >= 13, proc.stdout


def test_chip_smoke_without_card_prints_no_result():
    proc = _run(["chip_smoke.py"], REPO, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = BlockStructuredProblem(dynamics, stage_cost, 3, 2, 1, x0=[1.0, 0.0], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ocp_solve(problem, Settings())
    with pytest.raises(RuntimeError, match="CUDA"):
        ocp_initial_state(problem, Settings())
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockStructuredProblem(dynamics, stage_cost, 3, 2, 1, x0=[1.0, 0.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        problem_arrays_from_numpy({"x0": np.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy({})
    # asked for the CPU, the same solve runs
    assert int(ocp_solve(problem, Settings(), device="cpu").iteration) >= 1


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the build raises before it writes anything."""
    if _build.library_path().is_file():
        pytest.skip("a built library is present")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("nvcc is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not _build.BUILD_DIR.exists() or not any(_build.BUILD_DIR.iterdir())
