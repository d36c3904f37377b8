"""Drive the PyTorch/CUDA port (``sleqp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

run from a checkout of the repository, on a machine with a CUDA device and
``nvcc``.  The phases, each reported on one line with its elapsed seconds:

0. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
1. build the CUDA kernels from ``sleqp_tpu_torch/kernels/csrc`` (one nvcc
   call for the three sources);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, and time the kernel, the plain version
   and a library call on the same inputs as a yardstick, never called by
   the port (``torch.linalg.inv`` for the batched inverses; for the
   Thomas kernels the dense Cholesky factorization, triangular solve or
   Cholesky solve of the same system, assembled); then time the batched
   inverses at every batch the main paths launch them on (one
   cyclic-reduction factorization at T = 1560 and at N = 160), with the
   sums per mixed OCP iteration and per ``cr32`` factorization;
3. the mixed-precision OCP solve: ``ocp_solve`` with
   ``Settings(compute_dtype="float32")`` on the multistage problem of
   ``bench.py`` (T = 1560, nx = nu = 32, n = 99 840), with the kernels'
   launch counts read around the solve, and the time of one iteration;
4. the float64 route on the same problem as the oracle for phases 3 and 6;
5. ``bench.py``'s structured-KKT system (N = 160 blocks of k = 64,
   n = 10 240) through ``block_tridiag_solve_mp`` on four backends, the
   streaming Thomas factor-solve and resolve, and cyclic reduction with a
   streaming tail (each timed in ms per solve), against the float64
   block-Thomas solve; and the dense float64 Cholesky solve of the
   assembled system as the library yardstick;
6. the float64 OCP solve with ``tridiag_backend="pallas"`` (float32 cyclic
   reduction with float64 refinement) on the problem of phase 3;
7. the dense SLP-EQP solve (``solve``: the Cauchy LP by enumeration or the
   simplex, the GLTR/CG Newton step, linesearches, penalty and trust-region
   updates) on HS71 (``bench.py``), ``chainineq200`` and ``boxqp1000``
   (``sleqp_tpu/harness/medium.py``, same seeds), each on the float64 and
   the mixed route, on the card and through the port on the CPU: status,
   objective against ``artifacts/suite_all_f64_r5.csv``, residuals, x
   against the CPU run, the state on the card; iterations, simplex pivots,
   ms per iteration and host reads (synchronizations) per iteration.  It
   launches none of the six kernels;
8. the entry point ``Solver(problem, x0, settings).solve()`` on the card and
   on the CPU: default settings on both routes on HS71, chainineq200,
   boxqp1000, projqp500 and broydn100 (an ``LSQFunc``: Gauss-Newton +
   LSQR), hs62 with ``scaling="auto"``, the Waechter-Biegler problem
   (restoration), DAMPED_BFGS and SR1 on extrosnb100 and DAMPED_BFGS on
   HS71, the parametric Cauchy step (COARSE, FINE) on chainineq200, and the
   preprocessor on hs42 with its linear constraint as a linear row; each
   against the r5 CSV or a constant measured with the JAX package, with
   seconds per solve, ms per iteration and host reads per iteration.  It
   launches none of the six kernels;
9. one JSON line describing each kernel, then the result line.

Phases 3, 5 and 6 are the main paths of the kernels: the launch counts are
cleared just before each and read just after, and the kernels line reports
their sum.  Phases 7 and 8 are read the same way and must launch none of
them.

Any failed check raises, so the script exits non-zero and prints no result
line.  Without a CUDA device it exits with code 2 before any phase; outside
a checkout of the repository the package import fails.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sleqp_tpu_torch import (  # noqa: E402
    BlockStructuredProblem,
    Func,
    HessEval,
    LSQFunc,
    ParametricCauchy,
    Problem,
    Settings,
    Solver,
    Status,
    ocp_initial_state,
    ocp_perform_iteration,
    ocp_solve,
    solve,
)
from sleqp_tpu_torch import gauss_newton  # noqa: E402
from sleqp_tpu_torch.kernels import _build  # noqa: E402
from sleqp_tpu_torch.ops import cyclic_reduction as cr  # noqa: E402
from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc  # noqa: E402
from sleqp_tpu_torch.ops import pallas_tridiag as pt  # noqa: E402
from sleqp_tpu_torch.ops.block_tridiag import block_tridiag_solve  # noqa: E402

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet): HBM bandwidth, and float32 outside the tensor cores, of the whole
# card and of one of its 132 SMs (a sequential chain runs on one).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SM_FP32_FLOPS_PER_S = FP32_FLOPS_PER_S / 132

# kernel vs plain version, per block: ||K - P||_F <= KERNEL_RTOL ||P||_F.
# Both are float32 inverses whose identity error the reference test bounds
# by 1e-4 (tests/test_pallas_tridiag.py:274), and ||K - P|| <= ||P|| ||I - C K||.
KERNEL_RTOL = 1e-4

KERNELS = {
    "bgj_flat": dict(
        fn=cr.bgj_flat,
        plain=cr.bgj_flat_plain,
        replaces="sleqp_tpu/ops/cyclic_reduction.py:42",
        # the main path's largest batch, ragged k at each padded width
        # (32, 64, 96) and the widest k
        shapes=[(781, 32), (9, 32), (13, 3), (1, 4), (5, 17), (4, 33), (3, 77), (2, 96)],
    ),
    "bgj_blocked64": dict(
        fn=cr.bgj_blocked64,
        plain=cr.bgj_blocked64_plain,
        replaces="sleqp_tpu/ops/cyclic_reduction.py:143",
        shapes=[(1561, 64), (1, 64)],
    ),
}
SOURCE = "sleqp_tpu_torch/kernels/csrc/bgj.cu"
COUNTS = (cr.LAUNCHES, pt.LAUNCHES, pc.LAUNCHES)

# The block-Thomas kernels against their plain versions:
# max |K - P| / max |P| <= TRIDIAG_RTOL, as float32 recursions of the same
# arithmetic summed in another order (the reference holds its float32
# Thomas kernel to 2e-4 of the float64 scan, tests/test_pallas_tridiag.py:41).
TRIDIAG_RTOL = 1e-4
# (N, k, r): the structured-KKT path's shape, ragged blocks of both padded
# widths (32 and 64), and the most right-hand sides one launch takes
THOMAS_SHAPES = [(160, 64, 1), (13, 3, 3), (1, 4, 1), (7, 33, 5), (5, 64, 128)]
THOMAS_LONG = (1560, 32, 1)  # the OCP's dual Schur complement, timed only
# (P, c, k, r); the fourth fills warps raggedly (k, r not multiples of 32)
CHOL_SHAPES = [(1, 160, 64, 1), (4, 40, 64, 8), (2, 8, 128, 1), (3, 7, 17, 33)]
TRIDIAG_KERNELS = {
    "thomas_fwd": ("sleqp_tpu_torch/kernels/csrc/thomas.cu", "sleqp_tpu/ops/pallas_tridiag.py:115"),
    "thomas_bwd": ("sleqp_tpu_torch/kernels/csrc/thomas.cu", "sleqp_tpu/ops/pallas_tridiag.py:155"),
    "chol_thomas_factor": ("sleqp_tpu_torch/kernels/csrc/chol_thomas.cu",
                           "sleqp_tpu/ops/pallas_chol_tridiag.py:160"),
    "chol_thomas_solve": ("sleqp_tpu_torch/kernels/csrc/chol_thomas.cu",
                          "sleqp_tpu/ops/pallas_chol_tridiag.py:187"),
}
KKT_BACKENDS = ("cr32", "scan32", "spike32", "chol_pallas")

T_STAGES, NX, NU = 1560, 32, 32


class Log:
    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self, phase, msg):
        print(f"[{time.perf_counter() - self.t0:8.2f}s] phase {phase}: {msg}", flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def spd_blocks(B, k, seed):
    """SPD float32 blocks as the reference test builds them (C C^T + 2k I)."""
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((B, k, k))
    C = np.einsum("bij,bkj->bik", C, C) + 2 * k * np.eye(k)
    return torch.tensor(C, dtype=torch.float32, device="cuda")


def identity_error(M, C):
    k = C.shape[-1]
    eye = torch.eye(k, dtype=torch.float64, device=C.device)
    return float((M.double() @ C.double() - eye).abs().max())


def rel_fro_diff(K, P):
    num = torch.linalg.matrix_norm((K - P).double())
    den = torch.linalg.matrix_norm(P.double())
    return float((num / den).max())


def time_call(fn, reps=20, warm=True):
    """Device time of fn() by CUDA events over ``reps`` back-to-back calls,
    after one warm-up call unless ``warm`` is False."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Device time of one fn() by CUDA events around a CUDA graph of
    ``reps`` calls, after a warm-up call: the kernel's own time, which
    back-to-back launches from the host hide once a kernel takes less than
    the wrapper's ~10-20 us of Python."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps=5):
    """Median wall time of fn() ending in a synchronize, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[len(times) // 2]


def clear_counts():
    for counts in COUNTS:
        for key in counts:
            counts[key] = 0


def read_counts():
    return {key: n for counts in COUNTS for key, n in counts.items()}


def spd_inverse_flops(k):
    """The least arithmetic of the inverse of an SPD k x k block: its
    Cholesky factor G, G^-1 and the symmetric product G^-T G^-1, k^3 / 3
    float32 operations each."""
    return k**3


def bound(name, B, k):
    bytes_moved = 2 * B * k * k * 4
    flops = B * spd_inverse_flops(k)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tridiag_flops(name, lead, k, r):
    """Float32 operations one call needs at the least, from its shapes:
    (whole work, work of one chain).  Stage 0 has no coupling (Lp[0] = 0).
    A product whose result is symmetric counts half.

    Thomas (B3 with factor), per later stage: C_i = D_i - Z Z^T with
    Z = L_{i-1} G_{i-1}^-T (a triangular product, k^3, where G_{i-1} is the
    Cholesky factor behind M_{i-1}), Z Z^T (symmetric, k^3), the
    subtraction, the SPD inverse (k^3), and y_i = M_i (b_i - L_{i-1} y_{i-1})
    (4 k^2 r).  Cholesky Thomas (B5), per later stage: Z = L_i G_{i-1}^-T by
    one triangular solve (k^3), Z Z^T (k^3), the subtraction and the
    Cholesky (k^3 / 3).  The substitutions: each k x k block meets each
    right-hand side once per sweep (2 k^2 r), and B6's two triangular solves
    per block and sweep cost one such product."""
    chains = lead[0] if len(lead) == 2 else 1
    n = lead[-1]
    chol = k**3 / 3
    sub = 2 * k * k * r + k * r  # b - L y, for one stage's coupling
    per = {
        "thomas_fwd": spd_inverse_flops(k) + 2 * k * k * r
        + (n - 1) * (2 * k**3 + k * k + spd_inverse_flops(k) + sub + 2 * k * k * r),
        "thomas_fwd_resolve": 2 * k * k * r + (n - 1) * (sub + 2 * k * k * r),
        "thomas_bwd": (n - 1) * (sub + 2 * k * k * r),
        "chol_thomas_factor": chol + (n - 1) * (2 * k**3 + k * k + chol),
        "chol_thomas_solve": 2 * k * k * r + (n - 1) * (2 * sub + 4 * k * k * r),
    }[name]
    return chains * per, per


def tridiag_bytes(name, lead, k, r):
    """Bytes that must move: each input read once, each output written once."""
    blocks, vecs = int(np.prod(lead)) * k * k, int(np.prod(lead)) * k * r
    return 4 * {
        "thomas_fwd": 3 * blocks + 2 * vecs,  # D, Lp, b -> M, y
        "thomas_fwd_resolve": 2 * blocks + 2 * vecs,  # M, Lp, b -> y
        "thomas_bwd": 2 * blocks + 2 * vecs,  # M, Lp, y -> x
        "chol_thomas_factor": 3 * blocks,  # D, Lp -> chols
        "chol_thomas_solve": 2 * blocks + 2 * vecs,  # chols, Lp, b -> x
    }[name]


def tridiag_bound(name, lead, k, r):
    """(bound ms, what bounds it, one-SM bound ms of one chain)."""
    flops, chain_flops = tridiag_flops(name, lead, k, r)
    t_bytes = tridiag_bytes(name, lead, k, r) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    one_sm = chain_flops / SM_FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes", one_sm) if t_bytes >= t_ops else (t_ops, "operations", one_sm)


def tridiag_inputs(lead, k, r, seed):
    """SPD diagonal blocks (C C^T + 2k I), couplings 0.3 N(0,1) shifted so
    that Lp[..., 0] = 0 (Lp[i] = L[i-1]), right-hand sides; float32."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(lead + (k, k))
    D = A @ np.swapaxes(A, -1, -2) + 2 * k * np.eye(k)
    Lp = 0.3 * rng.standard_normal(lead + (k, k))
    Lp[..., 0, :, :] = 0.0
    b = rng.standard_normal(lead + (k, r))
    return [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (D, Lp, b)]


def assemble(D, L):
    """The dense symmetric matrix of diagonal blocks D (N, k, k) and
    sub-diagonal blocks L (N-1, k, k), for the library yardsticks (the port
    never assembles it)."""
    N, k, _ = D.shape
    A = torch.zeros((N, k, N, k), dtype=D.dtype, device=D.device)
    i = torch.arange(N, device=D.device)
    A[i, :, i, :] = D
    A[i[1:], :, i[:-1], :] = L
    A[i[:-1], :, i[1:], :] = L.transpose(1, 2)
    return A.reshape(N * k, N * k)


def rel_max(K, P):
    return float((K - P).abs().max() / P.abs().max())


def cr_batches(n):
    """The batches of the batched inverses of one cyclic-reduction
    factorization of n blocks (``cr.cr_factor``): one per level, the even
    blocks of the level identity-padded to odd, and the root (781, 391, ...,
    1 at n = 1560: 11 launches)."""
    batches = []
    while n > 1:
        n += 1 - n % 2
        batches.append((n + 1) // 2)
        n = (n - 1) // 2
    return batches + [1]


def bench_problem():
    """bench.py's multistage problem, as torch callables on the card, and
    its multiple-shooting start (x_0 fixed, later states zero).  The
    dynamics are unstable (spectral radius of A 1.106), so the rollout
    start that bench.py times iterations from grows to ~1e67 by t = 1560
    and no solve converges from it."""
    rng = np.random.default_rng(0)
    A = torch.tensor(np.eye(NX) + 0.02 * rng.standard_normal((NX, NX)), device="cuda")
    B = torch.tensor(0.1 * rng.standard_normal((NX, NU)), device="cuda")

    def dyn(x, u, t):
        return A.to(x.dtype) @ x + B.to(x.dtype) @ u + 0.01 * torch.tanh(x)

    def cost(x, u, t):
        return 0.5 * (x @ x + 0.1 * (u @ u))

    ocp = BlockStructuredProblem(dyn, cost, T_STAGES, NX, NU, x0=torch.ones(NX), device="cuda")
    X0 = torch.zeros((T_STAGES + 1, NX), dtype=torch.float64, device="cuda")
    X0[0] = ocp.x0
    return ocp, X0


def solve_summary(out):
    return (
        f"status={Status(int(out.status)).name} iterations={int(out.iteration)} "
        f"feas={float(out.feas_res):.3e} stat={float(out.stat_res):.3e} "
        f"obj={float(out.obj_val):.12g}"
    )


# The dense solve's problems at the sizes the repository's medium suite runs
# them, with the reference's objective and iteration counts from
# artifacts/suite_all_{f64,mixed}_r5.csv (float64 route, mixed route).
DENSE_REF = {
    "hs71": (17.014017157, 6, 6),
    "chainineq200": (8.0110686546, 24, 24),
    "boxqp1000": (41.215701999, 4, 11),
}


def dense_problem(name, device):
    """(Problem, x0) of bench.py's HS71, or of harness/medium.py's
    chainineq200 (default_rng(41)) or boxqp1000 (default_rng(7))."""
    if name == "hs71":
        def obj(x):
            return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

        def cons(x):
            return torch.stack([x[0] * x[1] * x[2] * x[3], x @ x])

        problem = Problem(Func(obj, 4, cons=cons, num_cons=2), var_lb=1.0, var_ub=5.0,
                          general_lb=[25.0, 40.0], general_ub=[float("inf"), 40.0], device=device)
        return problem, np.array([1.0, 5.0, 5.0, 1.0])
    if name == "chainineq200":
        n = 200
        t = torch.tensor(np.cumsum(np.random.default_rng(41).standard_normal(n)) * 0.2, device=device)
        func = Func(lambda x: 0.5 * ((x - t.to(x)) ** 2).sum(), n,
                    cons=lambda x: x[1:] - x[:-1], num_cons=n - 1)
        return Problem(func, general_lb=-0.05, general_ub=0.05, device=device), np.zeros(n)
    n = 1000
    c = torch.tensor(np.random.default_rng(7).uniform(-0.5, 1.5, n), device=device)
    func = Func(lambda x: ((x - c.to(x)) ** 2).sum(), n, psd_hessian=True)
    return Problem(func, var_lb=0.0, var_ub=1.0, device=device), np.full(n, 0.5)


def tensors_of(obj):
    """Every tensor of a (nested) dataclass state."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple):
        return [t for v in obj for t in tensors_of(v)]
    return [t for f in dataclasses.fields(obj) for t in tensors_of(getattr(obj, f.name))]


def timed_solve(problem, settings, x0, device):
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = solve(problem, settings, x0, max_iterations=200, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t


def count_host_reads(fn):
    """(synchronizations of the host with the card while ``fn()`` runs, as
    torch.cuda.set_sync_debug_mode counts them, its result)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught), out


def host_reads(problem, settings, x0):
    """Host reads over one dense solve."""
    return count_host_reads(
        lambda: solve(problem, settings, x0, max_iterations=200, device="cuda"))


def dense_phase(log):
    """Phase 7: the dense SLP-EQP solve on the card and on the CPU."""
    # the rule the pivoting rests on, on the card: argmax/argmin pick the
    # first index of a tie and take NaN as the extreme value, as on the CPU
    for values in ([1.0, 3.0, 3.0, 2.0], [float("nan"), 1.0, float("nan")],
                   [2.0, float("nan"), 5.0], [0.0, 0.0, 0.0]):
        v = torch.tensor(values, dtype=torch.float64)
        for fn in (torch.argmax, torch.argmin):
            check(int(fn(v.cuda())) == int(fn(v)), f"{fn.__name__} of {values} differs on the card")
    # set-up on first use (cuSOLVER/cuBLAS handles), uncounted
    warm, wx0 = dense_problem("hs71", "cuda")
    solve(warm, Settings(), wx0, device="cuda")
    for name, (f_ref, it64, itmix) in DENSE_REF.items():
        gpu_problem, x0 = dense_problem(name, "cuda")
        cpu_problem, _ = dense_problem(name, "cpu")
        reads, _ = host_reads(gpu_problem, Settings(), x0)
        for route, it_ref in (("same", it64), ("float32", itmix)):
            settings = Settings(compute_dtype=route)
            out, gpu_s = timed_solve(gpu_problem, settings, x0, "cuda")
            ref, cpu_s = timed_solve(cpu_problem, settings, x0, "cpu")
            iters, cpu_iters = int(out.iteration), int(ref.iteration)
            obj = float(out.it.obj_val)
            dx = float((out.it.x.cpu() - ref.it.x).abs().max())
            line = (f"dense {name} ({'float64' if route == 'same' else 'mixed'}): "
                    f"status={Status(int(out.status)).name} obj={obj:.11g} "
                    f"(r5 CSV {f_ref}); feas={float(out.feas_res):.3e} "
                    f"slack={float(out.slack_res):.3e} stat={float(out.stat_res):.3e}; "
                    f"iterations card {iters}, CPU {cpu_iters}, CSV {it_ref}; "
                    f"simplex pivots {int(out.lp_iterations)}; card {gpu_s:.3f} s per solve, "
                    f"{1e3 * gpu_s / max(iters, 1):.2f} ms per iteration; CPU {cpu_s:.3f} s, "
                    f"{1e3 * cpu_s / max(cpu_iters, 1):.2f} ms per iteration; "
                    f"max |x_card - x_cpu| {dx:.3e}")
            if route == "same":
                line += f"; host reads {reads} ({reads / max(iters, 1):.1f} per iteration)"
            log(7, line)
            check(int(out.status) == Status.OPTIMAL, f"dense {name} {route}: not OPTIMAL")
            check(abs(obj - f_ref) <= 1e-6 * abs(f_ref),
                  f"dense {name} {route}: objective {obj} against {f_ref}")
            s = Settings()
            check(float(out.feas_res) <= s.feas_tol and float(out.slack_res) < s.slack_tol
                  and float(out.stat_res) < s.stat_tol, f"dense {name} {route}: residuals")
            check(int(ref.status) == int(out.status), f"dense {name} {route}: CPU status differs")
            if route == "same":
                check(dx <= 1e-6, f"dense {name}: x differs from the CPU run by {dx:.3e}")
            check(all(t.device.type == "cuda" for t in tensors_of(out)),
                  f"dense {name} {route}: a tensor of the final state is not on the card")


# Phase 8: the entry point, Solver(problem, x0, settings).solve().  The
# problems at the sizes of the repository's medium suite
# (sleqp_tpu/harness/medium.py and hs.py, same seeds).  Each run: (label,
# problem, settings, scaling, reference objective, {route: reference
# iterations}, the iterations a named rounding tie may add on the float64
# route, the reference's source).  The mixed route may take 3 iterations
# more or fewer, as the parity tests allow it (float32 pivots and Krylov
# steps round differently).  Objectives are held to 1e-6 relative (absolute
# below 1: broydn100's and extrosnb100's optima are 0).  CSV rows are
# artifacts/suite_all_{f64,mixed}_r5.csv; JAX constants were measured with
# the JAX package's Solver on the CPU, float64.  hs42 is the suite's hs42
# with its linear constraint x0 = 2 stated as a linear row, which the
# preprocessor turns into a bound (objective: its CSV row; iterations: JAX).
CSV = "r5 CSV"
JAX = "JAX Solver"
SOLVER_RUNS = [
    # default settings, both routes (chainineq200: the standing tie of
    # ROADMAP.md queue C, 25 / 26 against 24)
    ("hs71", "hs71", {}, None, 17.014017157, {"same": 6, "float32": 6}, 0, CSV),
    ("chainineq200", "chainineq200", {}, None, 8.0110686546, {"same": 24, "float32": 24}, 3, CSV),
    ("boxqp1000", "boxqp1000", {}, None, 41.215701999, {"same": 4, "float32": 11}, 0, CSV),
    ("projqp500", "projqp500", {}, None, 8.5076360667, {"same": 3, "float32": 4}, 0, CSV),
    ("broydn100", "broydn100", {}, None, 1.4003911791e-24, {"same": 5, "float32": 5}, 0, CSV),
    ("hs62 scaling=auto", "hs62", {}, "auto", -26272.514487, {"same": 6}, 0, CSV),
    ("wachbieg (restoration)", "wachbieg", {}, None, 1.0000000000001286, {"same": 3}, 0, JAX),
    ("hs71 DAMPED_BFGS", "hs71", dict(hess_eval=HessEval.DAMPED_BFGS), None,
     17.014017289155834, {"same": 8}, 0, JAX),
    ("extrosnb100 DAMPED_BFGS", "extrosnb100", dict(hess_eval=HessEval.DAMPED_BFGS), None,
     3.805463645728005e-16, {"same": 60}, 0, JAX),
    ("extrosnb100 SR1", "extrosnb100", dict(hess_eval=HessEval.SR1), None,
     8.706600365114965e-14, {"same": 102}, 0, JAX),
    # the LP's degenerate vertices tie as in the default solve (ROADMAP.md
    # queue C): the port takes 17 / 20 on the CPU against 16 / 22
    ("chainineq200 COARSE", "chainineq200", dict(parametric_cauchy=ParametricCauchy.COARSE), None,
     8.011068654610282, {"same": 16}, 3, JAX),
    ("chainineq200 FINE", "chainineq200", dict(parametric_cauchy=ParametricCauchy.FINE), None,
     8.01106865461028, {"same": 22}, 3, JAX),
    ("hs42 presolve", "hs42_linear", dict(enable_preprocessor=True), None, 13.857864376,
     {"same": 3}, 0, "r5 CSV (objective), JAX Solver (iterations)"),
]


def solver_problem(name, device):
    """(Problem, x0) of a phase 8 run."""
    if name in DENSE_REF:
        return dense_problem(name, device)
    inf = float("inf")
    if name == "projqp500":
        n, m = 500, 20
        rng = np.random.default_rng(17)
        A, t, b = rng.standard_normal((m, n)), rng.standard_normal(n), rng.standard_normal(m)
        tt = torch.tensor(t, device=device)
        func = Func(lambda x: 0.5 * ((x - tt.to(x)) ** 2).sum(), n)
        return Problem(func, linear_coeffs=A, linear_lb=b, linear_ub=b, device=device), np.zeros(n)
    if name == "broydn100":
        n = 100

        def residuals(x):
            z = torch.zeros(1, dtype=x.dtype, device=x.device)
            return (3.0 - 2.0 * x) * x - torch.cat([z, x[:-1]]) - 2.0 * torch.cat([x[1:], z]) + 1.0

        return Problem(LSQFunc(residuals, n, n), device=device), np.full(n, -1.0)
    if name == "extrosnb100":
        n = 100
        func = Func(lambda x: (100.0 * (x[1::2] - x[0::2] ** 2) ** 2
                               + (1.0 - x[0::2]) ** 2).sum(), n)
        return Problem(func, device=device), np.tile([-1.2, 1.0], n // 2)
    if name == "hs62":
        def obj(x):
            s1 = (x[0] + x[1] + x[2] + 0.03) / (0.09 * x[0] + x[1] + x[2] + 0.03)
            s2 = (x[1] + x[2] + 0.03) / (0.07 * x[1] + x[2] + 0.03)
            s3 = (x[2] + 0.03) / (0.13 * x[2] + 0.03)
            return -32.174 * (255.0 * torch.log(s1) + 280.0 * torch.log(s2)
                              + 290.0 * torch.log(s3))

        func = Func(obj, 3, cons=lambda x: (x.sum() - 1.0)[None], num_cons=1)
        return (Problem(func, var_lb=0.0, var_ub=1.0, general_lb=0.0, general_ub=0.0,
                        device=device), np.array([0.7, 0.2, 0.1]))
    if name == "wachbieg":
        func = Func(lambda x: x[0], 3, num_cons=2,
                    cons=lambda x: torch.stack([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5]))
        return (Problem(func, var_lb=[-inf, 0.0, 0.0], var_ub=inf, general_lb=0.0,
                        general_ub=0.0, device=device), np.array([-2.0, 1.0, 1.0]))
    # hs42 with its linear constraint x0 = 2 as a linear row
    func = Func(lambda x: ((x - torch.arange(1.0, 5.0, dtype=x.dtype, device=x.device)) ** 2).sum(),
                4, cons=lambda x: (x[2] ** 2 + x[3] ** 2 - 2.0)[None], num_cons=1)
    return (Problem(func, general_lb=0.0, general_ub=0.0, linear_coeffs=[[1.0, 0.0, 0.0, 0.0]],
                    linear_lb=2.0, linear_ub=2.0, device=device), np.ones(4))


class LsqrSteps:
    """Counts the LSQR solves and their steps of the Gauss-Newton step
    (the steps are summed on the device and read once, after the solve)."""

    def __init__(self):
        self.calls, self.steps = 0, []
        self._inner = gauss_newton.lsqr_tr

    def __enter__(self):
        def counted(*args, **kwargs):
            d, steps = self._inner(*args, **kwargs)
            self.calls += 1
            self.steps.append(steps)
            return d, steps

        gauss_newton.lsqr_tr = counted
        return self

    def __exit__(self, *exc):
        gauss_newton.lsqr_tr = self._inner

    def total(self):
        return int(torch.stack(self.steps).sum()) if self.steps else 0


def timed_solver(name, settings, scaling, device):
    problem, x0 = solver_problem(name, device)
    solver = Solver(problem, x0, settings, scaling=scaling, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    status = solver.solve(max_iterations=1000)
    if device == "cuda":
        torch.cuda.synchronize()
    return solver, status, time.perf_counter() - t


def solver_phase(log):
    """Phase 8: Solver(problem, x0, settings).solve() on the card and on the
    CPU."""
    base = Settings()
    for label, name, kw, scaling, f_ref, it_refs, tie, source in SOLVER_RUNS:
        for route, it_ref in it_refs.items():
            settings = Settings(compute_dtype=route, **kw)
            with LsqrSteps() as lsqr:
                solver, status, gpu_s = timed_solver(name, settings, scaling, "cuda")
            ref, ref_status, cpu_s = timed_solver(name, settings, scaling, "cpu")
            iters, cpu_iters = solver.iterations, ref.iterations
            obj = solver.obj_val
            feas, slack, stat = solver.residuals()
            dx = float(np.abs(solver.solution - ref.solution).max())
            line = (f"{label} ({'float64' if route == 'same' else 'mixed'}): {status.name} "
                    f"obj={obj:.11g} (reference {f_ref}, {source}); feas={feas:.3e} "
                    f"slack={slack:.3e} stat={stat:.3e}; iterations card {iters}, CPU "
                    f"{cpu_iters}, reference {it_ref}; restoration phases "
                    f"{solver.num_phase_toggles}; card {gpu_s:.3f} s per solve, "
                    f"{1e3 * gpu_s / max(iters, 1):.2f} ms per iteration; CPU {cpu_s:.3f} s, "
                    f"{1e3 * cpu_s / max(cpu_iters, 1):.2f} ms per iteration; "
                    f"max |x_card - x_cpu| {dx:.3e}")
            if lsqr.calls:
                line += f"; Gauss-Newton steps {lsqr.calls}, LSQR steps {lsqr.total()}"
            if route == "same":
                reads, _ = count_host_reads(
                    lambda: timed_solver(name, settings, scaling, "cuda"))
                line += f"; host reads {reads} ({reads / max(iters, 1):.1f} per iteration)"
            pre = solver._preprocessed
            if pre is not None:
                line += (f"; presolve fixed variables {pre.fixed_vars.tolist()} at "
                         f"{pre.fixed_values.tolist()}, removed linear rows "
                         f"{pre.removed_linear.tolist()}, {len(pre.converted_bounds)} row(s) "
                         f"made bounds")
            log(8, line)
            check(status == Status.OPTIMAL, f"{label} {route}: {status.name}, not OPTIMAL")
            check(ref_status == status, f"{label} {route}: CPU status {ref_status.name}")
            check(abs(obj - f_ref) <= 1e-6 * max(1.0, abs(f_ref)),
                  f"{label} {route}: objective {obj} against {f_ref}")
            check(feas <= base.feas_tol and slack < base.slack_tol and stat < base.stat_tol,
                  f"{label} {route}: residuals")
            slack = tie if route == "same" else max(tie, 3)
            check(abs(iters - it_ref) <= slack,
                  f"{label} {route}: {iters} iterations against {it_ref}")
            if route == "same":
                check(dx <= 1e-6, f"{label}: x differs from the CPU run by {dx:.3e}")
            state_tensors = tensors_of(solver.state) + tensors_of(solver.iterate)
            check(all(t.device.type == "cuda" for t in state_tensors),
                  f"{label} {route}: a tensor of the final state is not on the card")
            if name == "wachbieg":
                check(solver.num_phase_toggles >= 1, "wachbieg: restoration was not entered")
            if name == "broydn100":
                check(lsqr.calls >= iters, "broydn100: the Gauss-Newton step was not taken")
            if pre is not None:
                check(len(pre.fixed_vars) > 0 and len(pre.removed_linear) > 0,
                      f"{label}: the preprocessor removed nothing")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    log = Log()

    # -- phase 0: the card ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(0, f"card '{card}'; torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.device_count()} device(s), {torch.cuda.get_device_name(0)}")

    # -- phase 1: build ---------------------------------------------------
    t = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    ptxas = [
        ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
        if "registers" in ln or "spill" in ln
    ]
    log(1, f"built {lib_path.name} in {time.perf_counter() - t:.2f}s; "
           + " | ".join(ptxas))

    # -- phase 2: each kernel against its plain version -------------------
    results = {}
    for name, spec in KERNELS.items():
        for i, (B, k) in enumerate(spec["shapes"]):
            C = spd_blocks(B, k, seed=B + k)
            K = spec["fn"](C)
            P = spec["plain"](C)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(K).all()), f"{name} {B}x{k}: non-finite output")
            ident_k, ident_p = identity_error(K, C), identity_error(P, C)
            rel = rel_fro_diff(K, P)
            max_abs = float((K - P).abs().max())
            line = (f"{name} ({B},{k},{k}): identity error kernel {ident_k:.3e} "
                    f"plain {ident_p:.3e}; kernel-plain max abs {max_abs:.3e}, "
                    f"rel fro {rel:.3e}")
            if i == 0:  # the main path's largest shape: time it
                ms = graph_ms(lambda: spec["fn"](C))
                host_launched = time_call(lambda: spec["fn"](C))
                plain_ms = time_call(lambda: spec["plain"](C), reps=5)
                lib_ms = time_call(lambda: torch.linalg.inv(C))
                bound_ms, bound_by = bound(name, B, k)
                results[name] = dict(
                    name=name, route="cuda", source=SOURCE, replaces=spec["replaces"],
                    max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_ms,
                )
                line += (f"; kernel {ms:.4f} ms (CUDA graph), {host_launched:.4f} ms launched "
                         f"from the host, plain {plain_ms:.4f} ms, torch.linalg.inv "
                         f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            log(2, line)
            check(rel <= KERNEL_RTOL, f"{name} ({B},{k}) disagrees with its plain version: {rel:.3e}")
            check(ident_k < 1e-4, f"{name} ({B},{k}) identity error {ident_k:.3e} >= 1e-4")

    # each batch the main paths launch the inverses on: B1 at the levels of
    # the OCP's dual Schur complement (T = 1560, k = 32), eleven a mixed
    # iteration; B2 on the stage Hessians (T + 1 blocks of 64), once a mixed
    # iteration, and at the levels of cr32 on the structured KKT (N = 160)
    for name, k, batches, per in (
        ("bgj_flat", NX, cr_batches(T_STAGES), "mixed OCP iteration"),
        ("bgj_blocked64", NX + NU, [T_STAGES + 1], "mixed OCP iteration"),
        ("bgj_blocked64", 64, cr_batches(160), "cr32 factorization at N = 160"),
    ):
        times = {}
        for B in batches:
            C = spd_blocks(B, k, seed=B + k)
            times[B] = graph_ms(lambda: KERNELS[name]["fn"](C))
        log(2, f"{name} at k={k}, ms by batch (CUDA graph): "
               + ", ".join(f"{B}: {t:.4f}" for B, t in times.items())
               + f"; sum per {per} ({len(batches)} launches) {sum(times.values()):.4f} ms")

    # -- phase 2, continued: the block-Thomas kernels ----------------------
    for i, (N, k, r) in enumerate(THOMAS_SHAPES):
        D, Lp, b = tridiag_inputs((N,), k, r, seed=N + k)
        y, M = pt.thomas_fwd(D, Lp, b, factor=True)
        x = pt.thomas_bwd(M, Lp, y)
        y2, _ = pt.thomas_fwd(M, Lp, b, factor=False)
        torch.cuda.synchronize()
        y_p, M_p = pt.thomas_fwd_plain(D, Lp, b, True)
        x_p = pt.thomas_bwd_plain(M_p, Lp, y_p)
        y2_p, _ = pt.thomas_fwd_plain(M_p, Lp, b, False)
        pairs = {"M": (M, M_p), "y": (y, y_p), "y resolve": (y2, y2_p), "x": (x, x_p)}
        rels = {key: rel_max(K, P) for key, (K, P) in pairs.items()}
        abs_fwd = max(float((K - P).abs().max()) for key, (K, P) in pairs.items() if key != "x")
        abs_bwd = float((x - x_p).abs().max())
        # the kernel's Gauss-Jordan repeats the plain version's arithmetic
        # entry by entry, so M differs only through the coupling products' sums
        abs_m = float((M - M_p).abs().max())
        line = (f"thomas_fwd/bwd ({N},{k},{r}): kernel-plain max abs M {abs_m:.3e}, fwd "
                f"{abs_fwd:.3e}, bwd {abs_bwd:.3e}; rel "
                + ", ".join(f"{key} {v:.3e}" for key, v in rels.items()))
        if i == 0:  # the structured-KKT path's shape: time it
            ms = time_call(lambda: pt.thomas_fwd(D, Lp, b, True), reps=5)
            plain_ms = time_call(lambda: pt.thomas_fwd_plain(D, Lp, b, True), reps=1, warm=False)
            res_ms = time_call(lambda: pt.thomas_fwd(M, Lp, b, False))
            res_plain_ms = time_call(lambda: pt.thomas_fwd_plain(M, Lp, b, False), reps=1, warm=False)
            bwd_ms = time_call(lambda: pt.thomas_bwd(M, Lp, y))
            bwd_plain_ms = time_call(lambda: pt.thomas_bwd_plain(M, Lp, y), reps=1, warm=False)
            # library yardsticks on the same system, assembled dense: the
            # Cholesky factorization (thomas_fwd factors and substitutes),
            # and the back substitution with its factor (thomas_bwd)
            A = assemble(D, Lp[1:])
            G = torch.linalg.cholesky_ex(A).L
            lib_fwd = time_call(lambda: torch.linalg.cholesky_ex(A), reps=5)
            lib_bwd = time_call(lambda: torch.linalg.solve_triangular(
                G.mT, y.reshape(N * k, r), upper=True))
            del A, G
            b_fwd = tridiag_bound("thomas_fwd", (N,), k, r)
            b_res = tridiag_bound("thomas_fwd_resolve", (N,), k, r)
            b_bwd = tridiag_bound("thomas_bwd", (N,), k, r)
            for name, t, tp, bnd, err, lib in (
                ("thomas_fwd", ms, plain_ms, b_fwd, abs_fwd, lib_fwd),
                ("thomas_bwd", bwd_ms, bwd_plain_ms, b_bwd, abs_bwd, lib_bwd),
            ):
                results[name] = dict(
                    name=name, route="cuda", source=TRIDIAG_KERNELS[name][0],
                    replaces=TRIDIAG_KERNELS[name][1], max_abs_err=err, ms=t, plain_ms=tp,
                    bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib,
                )
            line += (f"; fwd (factor) {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_fwd[0]:.5f} ms "
                     f"({b_fwd[1]}), one-SM bound {b_fwd[2]:.4f} ms; fwd (resolve) {res_ms:.4f} ms, "
                     f"plain {res_plain_ms:.4f} ms, bound {b_res[0]:.5f} ms ({b_res[1]}), one-SM "
                     f"bound {b_res[2]:.5f} ms; bwd {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms, "
                     f"bound {b_bwd[0]:.5f} ms ({b_bwd[1]}), one-SM bound {b_bwd[2]:.5f} ms; "
                     f"dense n={N * k} torch.linalg.cholesky_ex {lib_fwd:.4f} ms, "
                     f"solve_triangular {lib_bwd:.4f} ms")
        log(2, line)
        check(max(rels.values()) <= TRIDIAG_RTOL,
              f"thomas kernels ({N},{k},{r}) disagree with their plain versions: {rels}")

    # the OCP's Schur size: the plain versions take ~10^5 launches there,
    # so the kernels alone, checked by their residual in float64
    N, k, r = THOMAS_LONG
    D, Lp, b = tridiag_inputs((N,), k, r, seed=N + k)
    ms = time_call(lambda: pt.thomas_fwd(D, Lp, b, True), reps=3)
    y, M = pt.thomas_fwd(D, Lp, b, True)
    res_ms = time_call(lambda: pt.thomas_fwd(M, Lp, b, False))
    bwd_ms = time_call(lambda: pt.thomas_bwd(M, Lp, y))
    x = pt.thomas_bwd(M, Lp, y)
    resid = pt.block_tridiag_matvec(D.double(), Lp[1:].double(), x.double()) - b.double()
    resid = float(resid.abs().max() / b.abs().max())
    b_fwd = tridiag_bound("thomas_fwd", (N,), k, r)
    b_res = tridiag_bound("thomas_fwd_resolve", (N,), k, r)
    b_bwd = tridiag_bound("thomas_bwd", (N,), k, r)
    log(2, f"thomas_fwd/bwd ({N},{k},{r}), kernels only: relative residual {resid:.3e}; fwd "
           f"(factor) {ms:.4f} ms, bound {b_fwd[0]:.5f} ms ({b_fwd[1]}), one-SM bound "
           f"{b_fwd[2]:.4f} ms; fwd (resolve) {res_ms:.4f} ms, bound {b_res[0]:.5f} ms, one-SM "
           f"bound {b_res[2]:.5f} ms; bwd {bwd_ms:.4f} ms, bound {b_bwd[0]:.5f} ms, one-SM bound "
           f"{b_bwd[2]:.5f} ms")
    check(resid <= TRIDIAG_RTOL, f"thomas kernels ({N},{k},{r}): residual {resid:.3e}")

    for i, (P, c, k, r) in enumerate(CHOL_SHAPES):
        D, Lp, b = tridiag_inputs((P, c), k, r, seed=P + c + k)
        ch = pc.chol_thomas_factor(D, Lp)
        x = pc.chol_thomas_solve(ch, Lp, b)
        torch.cuda.synchronize()
        ch_p = pc.chol_thomas_factor_plain(D, Lp)
        x_p = pc.chol_thomas_solve_plain(ch_p, Lp, b)
        rels = {"chols": rel_max(ch, ch_p), "x": rel_max(x, x_p)}
        abs_f = float((ch - ch_p).abs().max())
        abs_s = float((x - x_p).abs().max())
        line = (f"chol_thomas_factor/solve ({P},{c},{k},{r}): kernel-plain max abs factor "
                f"{abs_f:.3e} solve {abs_s:.3e}; rel chols {rels['chols']:.3e}, x {rels['x']:.3e}")
        if i == 0:  # the chol_pallas backend's shape on the structured KKT
            f_ms = time_call(lambda: pc.chol_thomas_factor(D, Lp), reps=5)
            f_plain = time_call(lambda: pc.chol_thomas_factor_plain(D, Lp), reps=1, warm=False)
            s_ms = time_call(lambda: pc.chol_thomas_solve(ch, Lp, b), reps=10)
            s_plain = time_call(lambda: pc.chol_thomas_solve_plain(ch, Lp, b), reps=1, warm=False)
            # library yardsticks on the same system (P = 1), assembled
            # dense: its Cholesky factorization and the solve with it
            A = assemble(D[0], Lp[0, 1:])
            G = torch.linalg.cholesky_ex(A).L
            lib_f = time_call(lambda: torch.linalg.cholesky_ex(A), reps=5)
            lib_s = time_call(lambda: torch.cholesky_solve(b[0].reshape(c * k, r), G))
            del A, G
            b_f = tridiag_bound("chol_thomas_factor", (P, c), k, r)
            b_s = tridiag_bound("chol_thomas_solve", (P, c), k, r)
            for name, t, tp, bnd, err, lib in (
                ("chol_thomas_factor", f_ms, f_plain, b_f, abs_f, lib_f),
                ("chol_thomas_solve", s_ms, s_plain, b_s, abs_s, lib_s),
            ):
                results[name] = dict(
                    name=name, route="cuda", source=TRIDIAG_KERNELS[name][0],
                    replaces=TRIDIAG_KERNELS[name][1], max_abs_err=err, ms=t, plain_ms=tp,
                    bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib,
                )
            line += (f"; factor {f_ms:.4f} ms, plain {f_plain:.4f} ms, bound {b_f[0]:.5f} ms "
                     f"({b_f[1]}), one-SM bound {b_f[2]:.4f} ms; solve {s_ms:.4f} ms, plain "
                     f"{s_plain:.4f} ms, bound {b_s[0]:.5f} ms ({b_s[1]}), one-SM bound "
                     f"{b_s[2]:.5f} ms; dense n={c * k} torch.linalg.cholesky_ex "
                     f"{lib_f:.4f} ms, cholesky_solve {lib_s:.4f} ms")
        log(2, line)
        check(max(rels.values()) <= TRIDIAG_RTOL,
              f"chol_thomas kernels ({P},{c},{k},{r}) disagree with their plain versions: {rels}")
        check(float(ch.triu(1).abs().max()) == 0.0, "chol_thomas_factor: nonzero upper triangle")

    # -- phase 3: the mixed-precision OCP solve ------------------------------
    mixed = Settings(compute_dtype="float32")
    ocp, X0 = bench_problem()
    # first iterations from the start, uncounted: set-up on first use
    # (cuBLAS handles, allocator growth), then the time of one iteration
    s0 = ocp_initial_state(ocp, mixed, X0=X0)
    it_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ocp_perform_iteration(ocp, mixed, s0)
        torch.cuda.synchronize()
        it_ms.append(1e3 * (time.perf_counter() - t))
    it_ms = sorted(it_ms[1:])[1]  # median of the three after the first
    clear_counts()
    t = time.perf_counter()
    out = ocp_solve(ocp, mixed, X0=X0, max_iterations=50)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    launches = read_counts()
    iters = int(out.iteration)
    log(3, f"mixed OCP n={T_STAGES * (NX + NU)}: {solve_summary(out)}; "
           f"solve {solve_s:.3f}s; one iteration {it_ms:.2f} ms; launches {launches}")
    check(out.U.shape == (T_STAGES, NU) and out.X.shape == (T_STAGES + 1, NX), "solution shape")
    check(bool(torch.isfinite(out.U).all() & torch.isfinite(out.X).all()), "non-finite solution")
    check(launches["bgj_blocked64"] >= iters, "bgj_blocked64 not launched once per iteration")
    per_solve = len(cr_batches(T_STAGES))
    check(launches["bgj_flat"] >= per_solve * iters,
          f"bgj_flat not launched {per_solve} times per iteration")
    check(all(launches[n] > 0 for n in KERNELS), f"a kernel was not launched: {launches}")

    # -- phase 4: the float64 route as the oracle --------------------------
    t = time.perf_counter()
    ref = ocp_solve(ocp, Settings(), X0=X0, max_iterations=50)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t
    u_err = float((out.U - ref.U).abs().max())
    f64 = Settings()
    s0_64 = ocp_initial_state(ocp, f64, X0=X0)
    ref_it_ms = host_ms(lambda: ocp_perform_iteration(ocp, f64, s0_64), reps=3)
    log(4, f"float64 OCP: {solve_summary(ref)}; solve {ref_s:.3f}s; one iteration "
           f"{ref_it_ms:.2f} ms; max |U - U_f64| {u_err:.3e}")
    check(int(ref.status) == Status.OPTIMAL, "float64 route not OPTIMAL")
    check(int(out.status) == Status.OPTIMAL, "mixed route not OPTIMAL")
    check(float(out.feas_res) <= 1e-6 and float(out.stat_res) <= 1e-6, "mixed residuals above 1e-6")
    check(iters <= int(ref.iteration) + 3, "mixed route needs more than 3 extra iterations")
    check(u_err <= 1e-5, f"mixed U differs from float64 U by {u_err:.3e}")

    # -- phase 5: bench.py's structured-KKT system ---------------------------
    rng = np.random.default_rng(0)
    N, k = 160, 64  # n = 10 240 (bench.py, BASELINE config 3)
    Mr = rng.standard_normal((N, k, k)) * 0.2
    D = torch.tensor(np.einsum("nij,nkj->nik", Mr, Mr) + 2 * k * np.eye(k), device="cuda")
    L = torch.tensor(rng.standard_normal((N - 1, k, k)) * 0.1, device="cuda")
    b = torch.tensor(rng.standard_normal((N, k)), device="cuda")
    x64 = block_tridiag_solve(D, L, b)
    b_scale = max(float(b.abs().max()), 1.0)
    x_scale = float(x64.abs().max())

    def solve(backend):
        return pt.block_tridiag_solve_mp(D, L, b, refine_iters=2, backend=backend)

    # one pass of each solve between the counts; the timing repeats follow
    clear_counts()
    xs = {backend: solve(backend) for backend in KKT_BACKENDS}
    x_fs, Minv, Lp32 = pt.block_tridiag_factor_solve_pallas(D, L, b)
    x_rs = pt.block_tridiag_resolve_pallas(Minv, Lp32, b)
    x_cr = cr.cr_resolve(cr.cr_factor(D, L, tail_n=16), b)
    torch.cuda.synchronize()
    launches_kkt = read_counts()
    for backend, x in xs.items():
        ms = host_ms(functools.partial(solve, backend), reps=5)
        resid = float((b - pt.block_tridiag_matvec(D, L, x)).abs().max()) / b_scale
        err = float((x - x64).abs().max())
        log(5, f"structured KKT n={N * k}, block_tridiag_solve_mp({backend}, refine_iters=2): "
               f"{ms:.3f} ms per solve (median of 5); relative residual {resid:.3e}; "
               f"max |x - x_f64| {err:.3e}")
        check(resid <= 1e-10, f"{backend}: relative residual {resid:.3e} above 1e-10")
    # the library yardstick, never called by the port: the same float64
    # system assembled dense, factored and solved by torch.linalg
    A = assemble(D, L)

    def dense_solve():
        G = torch.linalg.cholesky_ex(A).L
        return torch.cholesky_solve(b.reshape(N * k, 1), G).reshape(N, k)

    dense_ms = host_ms(dense_solve, reps=5)
    x = dense_solve()
    resid = float((b - pt.block_tridiag_matvec(D, L, x)).abs().max()) / b_scale
    err = float((x - x64).abs().max())
    del A
    log(5, f"structured KKT n={N * k}, dense float64 torch.linalg.cholesky_ex + "
           f"torch.cholesky_solve (yardstick): {dense_ms:.3f} ms per solve (median of 5); "
           f"relative residual {resid:.3e}; max |x - x_f64| {err:.3e}")
    check(resid <= 1e-10, f"dense yardstick: relative residual {resid:.3e} above 1e-10")
    # the float32 solves on B3/B4, ms per solve (median of 5)
    f32_ms = {
        "factor_solve": host_ms(lambda: pt.block_tridiag_factor_solve_pallas(D, L, b)),
        "resolve": host_ms(lambda: pt.block_tridiag_resolve_pallas(Minv, Lp32, b)),
        "cr tail 16": host_ms(lambda: cr.cr_resolve(cr.cr_factor(D, L, tail_n=16), b)),
    }
    errs = {name: float((xx.double() - x64).abs().max()) / x_scale
            for name, xx in (("factor_solve", x_fs), ("resolve", x_rs), ("cr tail 16", x_cr))}
    log(5, "float32 against x_f64 (max abs / max |x_f64|): "
           + ", ".join(f"{name} {e:.3e} ({f32_ms[name]:.3f} ms per solve)"
                       for name, e in errs.items())
           + f"; launches {launches_kkt}")
    check(max(errs.values()) < 5e-6, f"float32 structured-KKT solves off by {errs}")
    path_kernels = ("bgj_blocked64", *TRIDIAG_KERNELS)
    check(all(launches_kkt[n] > 0 for n in path_kernels),
          f"a kernel of the structured-KKT path was not launched: {launches_kkt}")

    # -- phase 6: the float64 OCP on float32 kernels ("pallas") -------------
    clear_counts()
    t = time.perf_counter()
    pal = ocp_solve(ocp, f64, X0=X0, max_iterations=50, tridiag_backend="pallas")
    torch.cuda.synchronize()
    pal_s = time.perf_counter() - t
    launches_pal = read_counts()
    pal_iters = int(pal.iteration)
    pal_it_ms = host_ms(lambda: ocp_perform_iteration(ocp, f64, s0_64, tridiag_backend="pallas"), reps=3)
    u_err_pal = float((pal.U - ref.U).abs().max())
    log(6, f"float64 OCP, tridiag_backend='pallas': {solve_summary(pal)}; solve {pal_s:.3f}s "
           f"(float64 scan {ref_s:.3f}s); one iteration {pal_it_ms:.2f} ms (float64 scan "
           f"{ref_it_ms:.2f} ms); max |U - U_f64| {u_err_pal:.3e}; launches {launches_pal}")
    check(int(pal.status) == Status.OPTIMAL, "pallas route not OPTIMAL")
    check(pal_iters <= int(ref.iteration), "pallas route needs more iterations than the scan")
    check(u_err_pal <= 1e-6, f"pallas U differs from float64 U by {u_err_pal:.3e}")
    check(launches_pal["bgj_flat"] >= per_solve * pal_iters,
          f"bgj_flat not launched {per_solve} times per iteration on the pallas route")

    # -- phase 7: the dense SLP-EQP solve (no kernel of B1-B6) --------------
    clear_counts()
    dense_phase(log)
    launches_dense = read_counts()
    check(not any(launches_dense.values()),
          f"the dense solve launched a kernel of B1-B6: {launches_dense}")

    # -- phase 8: the entry point, Solver (no kernel of B1-B6) -----------
    clear_counts()
    solver_phase(log)
    launches_solver = read_counts()
    check(not any(launches_solver.values()),
          f"the Solver phase launched a kernel of B1-B6: {launches_solver}")

    # -- phase 9: report ---------------------------------------------------
    kernels = [
        dict(rec, launches=launches[name] + launches_kkt[name] + launches_pal[name])
        for name, rec in results.items()
    ]
    check(len(kernels) == 6 and all(r["launches"] > 0 for r in kernels),
          f"a kernel was not launched on the main paths: {kernels}")
    log(9, "all checks passed")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
