"""Shared pieces of the parity tests between sleqp_tpu (JAX, the reference)
and its PyTorch port sleqp_tpu_torch (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs on the CPU as its own tests do (Pallas in interpret mode);
the port runs on the CPU through its kernels' plain versions.
"""

import importlib.util
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

import test_ocp as jax_ocp_tests
from sleqp_tpu_torch import BlockStructuredProblem
from sleqp_tpu_torch.convert import problem_arrays_from_numpy


@pytest.fixture(scope="module", autouse=True)
def no_jax_cache_writes():
    """Keep these modules' compilations out of the persistent cache in the
    repository (tests/conftest.py points it there): JAX reads the size
    threshold at every write, and no executable reaches 2**62 bytes.  At
    the end of the module its compiled programs are dropped: XLA's CPU
    compiler crashes once one process holds too many of them (see
    tests/conftest.py), and a test worker runs many modules in turn."""
    key = "jax_persistent_cache_min_entry_size_bytes"
    old = getattr(jax.config, key)
    jax.config.update(key, 2**62)
    yield
    jax.config.update(key, old)
    jax.clear_caches()


@pytest.fixture(scope="module")
def one_torch_thread():
    """One CPU thread of torch for the module: its solves run small
    products, where torch's thread pool costs more than it gains, and the
    other test workers keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _load_emulation_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "emulate_thomas.py")
    spec = importlib.util.spec_from_file_location("emulate_thomas", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# tools/emulate_thomas.py: the port's CUDA sources compiled with g++ and run
# on the CPU, one std::thread per CUDA thread
emulation = _load_emulation_tool()


def emulated_kernels(kind, tmp_path_factory):
    """The emulation of one kernel source (``emulation.SOURCES``), built
    once for a module: (executable, work dir).  Skips where g++ or its
    C++20 std::barrier is missing."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = str(tmp_path_factory.mktemp(f"{kind}_emu"))
    probe = os.path.join(tmp, "probe.cpp")
    with open(probe, "w") as fh:
        fh.write("#include <barrier>\nint main() { std::barrier<> b(1); b.arrive_and_wait(); }\n")
    if subprocess.run(["g++", "-std=c++20", "-pthread", probe, "-o", probe + ".out"],
                      capture_output=True).returncode != 0:
        pytest.skip("g++ has no C++20 std::barrier")
    return emulation.build(kind, tmp), tmp


def spd_blocks(B, k, seed):
    """SPD blocks as tests/test_pallas_tridiag.py builds them."""
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((B, k, k))
    return np.einsum("bij,bkj->bik", C, C) + 2 * k * np.eye(k)


def spd_block_tridiag(N, k, seed):
    """(D, L, b) as tests/test_pallas_tridiag.py::_random_spd_block_tridiag."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((N, k, k))
    D = D @ np.swapaxes(D, 1, 2) + (k + 2.0) * np.eye(k)
    L = 0.3 * rng.standard_normal((N - 1, k, k))
    b = rng.standard_normal((N, k))
    return D, L, b


# ---- the tests/test_ocp.py problem, as torch callables ----------------

T, NX, NU = jax_ocp_tests.T, jax_ocp_tests.NX, jax_ocp_tests.NU
H_STEP = jax_ocp_tests.H_STEP
X_INIT = np.array(jax_ocp_tests.X_INIT)
X_GOAL = np.array(jax_ocp_tests.X_GOAL)


def dynamics(x, u, t):
    """Damped nonlinear oscillator with control on velocity."""
    pos, vel = x[0], x[1]
    acc = -torch.sin(pos) - 0.1 * vel + u[0]
    return torch.stack([pos + H_STEP * vel, vel + H_STEP * acc])


def stage_cost(x, u, t):
    dx = x - torch.as_tensor(X_GOAL, dtype=x.dtype, device=x.device)
    return 0.5 * (dx @ dx + 0.1 * (u @ u))


def final_cost(x):
    dx = x - torch.as_tensor(X_GOAL, dtype=x.dtype, device=x.device)
    return 5.0 * (dx @ dx)


def make_ocp_pair(**kwargs):
    """The same OCP in both packages: (JAX problem, port problem on CPU).
    Bounds are passed through numpy to both."""
    bounds = {k: np.asarray(v, np.float64) for k, v in kwargs.items() if k != "gauss_newton"}
    flags = {k: v for k, v in kwargs.items() if k == "gauss_newton"}
    jax_problem = jax_ocp_tests._make_ocp(**bounds, **flags)
    arrays = problem_arrays_from_numpy(dict(x0=X_INIT, **bounds), device="cpu")
    torch_problem = BlockStructuredProblem(
        dynamics, stage_cost, T, NX, NU,
        final_cost=final_cost, device="cpu", **arrays, **flags,
    )
    return jax_problem, torch_problem


# ---- bench.py's multistage problem at its widths (nx = nu = 32) --------


def make_bench_pair(num_stages):
    """bench.py's problem (A, B from default_rng(0)) with T = num_stages,
    in both packages: (JAX problem, port problem on CPU)."""
    import jax.numpy as jnp
    from sleqp_tpu.ocp import BlockStructuredProblem as JaxProblem

    nx = nu = 32
    rng = np.random.default_rng(0)
    A = np.eye(nx) + 0.02 * rng.standard_normal((nx, nx))
    B = 0.1 * rng.standard_normal((nx, nu))
    jA, jB, tA, tB = jnp.asarray(A), jnp.asarray(B), torch.as_tensor(A), torch.as_tensor(B)

    def jax_dyn(x, u, t):
        return jA @ x + jB @ u + 0.01 * jnp.tanh(x)

    def jax_cost(x, u, t):
        return 0.5 * (jnp.vdot(x, x) + 0.1 * jnp.vdot(u, u))

    def dyn(x, u, t):
        return tA.to(x.dtype) @ x + tB.to(x.dtype) @ u + 0.01 * torch.tanh(x)

    def cost(x, u, t):
        return 0.5 * (x @ x + 0.1 * (u @ u))

    jax_problem = JaxProblem(jax_dyn, jax_cost, num_stages, nx, nu, x0=jnp.ones((nx,)))
    torch_problem = BlockStructuredProblem(dyn, cost, num_stages, nx, nu, x0=np.ones(nx), device="cpu")
    return jax_problem, torch_problem
