"""The port stands alone: sleqp_tpu_torch, chip_smoke.py and the ranks'
program of the sharded tests (tests/torch_dist.py) import nothing of JAX
or of sleqp_tpu (the GPU machine has no JAX), chip_smoke.py exits
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

import sleqp_tpu_torch as tx
from sleqp_tpu_torch import BlockStructuredProblem, Settings, ocp_initial_state, ocp_solve
from sleqp_tpu_torch.convert import problem_arrays_from_numpy, state_from_numpy, tree_from_numpy
from sleqp_tpu_torch.problem import ProblemData
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
assert {"sleqp_tpu_torch.parallel", "sleqp_tpu_torch.parallel.batch",
        "sleqp_tpu_torch.parallel.schur", "sleqp_tpu_torch.parallel.collectives",
        "sleqp_tpu_torch.parallel.ranks", "sleqp_tpu_torch.checkpoint",
        "sleqp_tpu_torch.deriv_check", "sleqp_tpu_torch.profile", "sleqp_tpu_torch.minimize",
        "sleqp_tpu_torch.harness.ampl", "sleqp_tpu_torch.__main__"} <= set(names), names
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "tests")
import torch_dist  # the ranks' program of the sharded parity tests
bad = sorted(n for n in set(sys.modules) - before if n.split(".")[0] in BLOCKED)
assert not bad, bad
print("imported", len(names) + 3)
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
    # device, kernels (+ _build), ops (+ block_tridiag, cyclic_reduction,
    # pallas_tridiag, pallas_chol_tridiag, kkt, simplex, lp_enum, tr_cg,
    # gltr, lsqr), the dense solve (problem, iterate, merit, cauchy, newton,
    # linesearch, penalty, step_rule, measure, quasi_newton, parametric,
    # gauss_newton, problem_solver), the entry point (solver, restoration,
    # polish, scale, preprocessor), dyn, ops.pdlp, the harness (+ hs,
    # medium, driver), lanes, the batched solve (parallel, parallel.batch),
    # the sharded paths (parallel.schur, parallel.collectives,
    # parallel.ranks), the front ends (checkpoint, deriv_check, profile,
    # minimize, harness.ampl, __main__), chip_smoke and the ranks' program
    # tests/torch_dist.py
    assert int(proc.stdout.split()[-1]) >= 57, proc.stdout


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
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.batched_ocp_solve(problem, Settings(), np.ones((2, 2)))
    # asked for the CPU, the same solve runs
    assert int(ocp_solve(problem, Settings(), device="cpu").iteration) >= 1
    assert tx.batched_ocp_solve(problem, Settings(), np.ones((2, 2)), device="cpu").U.shape[0] == 2

    # the dense SLP-EQP solve
    func = tx.Func(lambda x: (x * x).sum(), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.Problem(func)
    dense = tx.Problem(func, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.solve(dense, Settings(), np.ones(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.initial_state(dense, Settings(), np.ones(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tree_from_numpy(ProblemData, {})
    out = tx.solve(dense, Settings(), np.ones(2), device="cpu")
    assert int(out.status) == tx.Status.OPTIMAL and out.it.x.device.type == "cpu"

    # the entry point, with scaling and presolve
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.Solver(dense, np.ones(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.Solver(dense, np.ones(2), Settings(enable_preprocessor=True), scaling="auto")
    solver = tx.Solver(dense, np.ones(2), Settings(enable_preprocessor=True), scaling="auto",
                       device="cpu")
    assert solver.solve() == tx.Status.OPTIMAL
    assert solver.iterate.x.device.type == "cpu" and solver.solution.shape == (2,)

    # the PDLP backend, dynamic functions and the suite driver
    from sleqp_tpu_torch.dyn import DynFunc
    from sleqp_tpu_torch.harness import run_problem, run_suite

    with pytest.raises(RuntimeError, match="CUDA"):
        tx.Solver(dense, np.ones(2), Settings(lp_solver=tx.LPSolver.PDLP))
    dyn = DynFunc(lambda x, bound, w_f, w_c: ((x * x).sum(), x.new_zeros(0), bound * 0.0), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.Problem(dyn)
    out = tx.solve(tx.Problem(dyn, device="cpu"), Settings(), np.ones(2), device="cpu")
    assert int(out.status) == tx.Status.OPTIMAL
    with pytest.raises(RuntimeError, match="CUDA"):
        run_problem("hs35")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_suite(["hs35"])
    assert run_problem("hs35", device="cpu")[1]

    # the batched solve (parallel/batch.py)
    from sleqp_tpu_torch.parallel import (batched_initial_state, batched_solve,
                                          batched_solve_chunked, batched_solve_mp,
                                          multistart_solve)

    x0b = np.ones((3, 2))
    for entry in (batched_solve, batched_solve_mp, batched_solve_chunked):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(dense, Settings(), x0b)
    with pytest.raises(RuntimeError, match="CUDA"):
        batched_initial_state(dense, Settings(), x0b)
    with pytest.raises(RuntimeError, match="CUDA"):
        multistart_solve(dense, Settings(), np.ones(2))
    out = batched_solve(dense, Settings(), x0b, device="cpu")
    assert out.it.x.shape == (3, 2) and out.it.x.device.type == "cpu"
    assert bool((out.status == tx.Status.OPTIMAL).all())


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
