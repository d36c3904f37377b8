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
   Cholesky solve of the same system, assembled); then hold against their
   plain versions and time the batched inverses at every batch the main
   paths launch them on (one cyclic-reduction factorization at T = 1560,
   at N = 160 and on a rank's interior in phase 15; the lanes of phase 16
   folded), with the sums per mixed OCP iteration and per ``cr32``
   factorization, and under ``torch.func.vmap`` on eight lanes, one
   launch each, every lane against the plain version;
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
9. the PDLP Cauchy LP: ``solve_cauchy_lp`` on the LP of chainineq
   (``harness/medium.py``'s formula and seed) at n = 2100 (N = n + 3m =
   8397 columns, so ``LPSolver.AUTO`` routes it to PDLP), on the card and
   on the CPU, each held to scipy HiGHS's objective of the same LP, the
   card to the CPU's iterations and step; ms per PDHG iteration and per
   LP, and host reads per LP; then ``Solver`` on hs35 with
   ``lp_solver=PDLP``;
10. dynamic functions: ``tests/test_dyn.py``'s Rosenbrock and constrained
    problems through ``Solver`` on the card and the CPU (OPTIMAL, x, the
    error bound tightened);
11. the suite sweep (``tools/torch_suite.py``) on the card: the 101 rows
    of the r5 sweep on the float64 route and 87 of its 97 optimal rows on
    the mixed route (``MIXED_LEFT_OUT`` names the other ten), each through
    the end gate against
    ``artifacts/suite_all_{f64,mixed}_r5.csv``;
12. the banded structured path (``banded.py``): ``bench.py``'s banded
    problem (n = 10 240) on both routes on the card and on the CPU, held to
    the JAX package's iterations; the suite's three banded rows from phase
    11's sweep, held to their r5 rows; the PDLP Cauchy LP on the banded
    operator (N_b = 160, k = 64, q = 8) on the card and on the CPU; ms per
    iteration, host reads per iteration and ms per KKT solve;
13. the matrix-free sparse path (``sparse.py``): the scattered problem of
    ``tests/test_sparse.py`` at n = 5e4 on both routes on the card and on
    the float64 route on the CPU, and HS71 with the PDLP Cauchy step; ms per
    iteration, host reads per iteration, CG steps and ms per EQP solve;
14. the batched dense solve (``parallel/batch.py``) at ``bench.py``'s
    width: HS71 from ``bench.py``'s starts through ``batched_solve_mp``
    (``Settings(compute_dtype="float32")``) at B = 512 and 1024 and
    ``batched_solve`` (``Settings()``) at B = 1024, on the card (a warm-up
    and three timed runs) and on the CPU (one), each lane held to the JAX
    package's lane (``artifacts/batch_hs71_jax_cpu.json``, written by
    ``tools/batch_reference.py``); solves per second, instance-iterations
    per second, ms per lockstep trip by phase, host reads and kernels per
    trip; eight lanes against the port's single-lane ``solve`` on the card;
15. the sharded paths on four ranks sharing the card (gloo, subprocesses
    of this script with a file rendezvous and a deadline; correctness, not
    scaling): ``sharded_schur_solve`` at N = 1559, k = 32 on both interior
    routes against ``block_tridiag_solve`` (1e-8); ``ocp_solve(mesh=)`` on
    phase 3's problem on the float64 (``"auto"``), float64 ``"pallas"``
    and mixed routes against phases 4, 6 and 3; ``sharded_solve`` of
    phase 14's HS71 starts at B = 1024 through phase 14's gate; every rank
    ending with the same bits; ms per iteration, s per run, collectives per
    KKT solve, launches of B1/B2 over the ranks;
16. ``batched_ocp_solve``: eight scenarios of ``bench.py``'s problem with A
    scaled to spectral radius 0.95 (x0 = 1 + 0.05 b) on both routes, and
    with controls bounded to [-0.3, 0.3] on the mixed route (lanes that
    stop on different trips and backtrack apart), each lane against the
    port's single-lane solve on the card; host reads, merit evaluations
    and bgj_blocked64 launches against the single lanes';
17. one JSON line describing each kernel, then the result line.

Phases 3, 5, 6, 15 and 16 are the main paths of the kernels: the launch
counts are cleared just before each and read just after (phase 15: in each
rank, summed), and the kernels line reports their sum.  Phases 7 to 14 are
read the same way and must launch none of them.

Any failed check raises, so the script exits non-zero and prints no result
line.  Without a CUDA device it exits with code 2 before any phase; outside
a checkout of the repository the package import fails.
"""

import collections
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sleqp_tpu_torch import (  # noqa: E402
    BandedProblem,
    BlockStructuredProblem,
    Func,
    HessEval,
    LPSolver,
    ParametricCauchy,
    Problem,
    Settings,
    Solver,
    SparseProblem,
    Status,
    banded_solve,
    create_iterate,
    ocp_initial_state,
    ocp_perform_iteration,
    ocp_solve,
    solve,
    sparse_solve,
)
from sleqp_tpu_torch import banded, cauchy, gauss_newton, problem_solver, sparse  # noqa: E402
from sleqp_tpu_torch import ocp as ocp_module  # noqa: E402
from sleqp_tpu_torch.lanes import vmap_lanes  # noqa: E402
from sleqp_tpu_torch.ocp import batched_ocp_solve, ocp_solve_from  # noqa: E402
from sleqp_tpu_torch.parallel import batch as pb  # noqa: E402
from sleqp_tpu_torch.parallel import collectives, ranks  # noqa: E402
from sleqp_tpu_torch.parallel.schur import sharded_schur_solve  # noqa: E402
from sleqp_tpu_torch.dyn import DynFunc  # noqa: E402
from sleqp_tpu_torch.kernels import _build  # noqa: E402
from sleqp_tpu_torch.ops import cyclic_reduction as cr  # noqa: E402
from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc  # noqa: E402
from sleqp_tpu_torch.ops import pallas_tridiag as pt  # noqa: E402
from sleqp_tpu_torch.harness.driver import ALL_PROBLEMS  # noqa: E402
from sleqp_tpu_torch.harness.driver import get_problem as harness_problem  # noqa: E402
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


def bench_matrices(radius=None):
    """bench.py's A (spectral radius 1.106) and B, from ``default_rng(0)``;
    ``radius`` scales A to that spectral radius."""
    rng = np.random.default_rng(0)
    A = np.eye(NX) + 0.02 * rng.standard_normal((NX, NX))
    if radius is not None:
        A = A * (radius / np.abs(np.linalg.eigvals(A)).max())
    return A, 0.1 * rng.standard_normal((NX, NU))


def bench_problem(radius=None, device="cuda", u_bound=None):
    """bench.py's multistage problem, as torch callables on the card, and
    its multiple-shooting start (x_0 fixed, later states zero).  The
    dynamics are unstable (spectral radius of A 1.106), so the rollout
    start that bench.py times iterations from grows to ~1e67 by t = 1560
    and no solve converges from it.  ``radius`` scales A to that spectral
    radius (``bench_matrices``); ``u_bound`` bounds every control to
    [-u_bound, u_bound]."""
    A, B = (torch.tensor(m, device=device) for m in bench_matrices(radius))
    bounds = {} if u_bound is None else dict(u_lb=-u_bound, u_ub=u_bound)

    def dyn(x, u, t):
        return A.to(x.dtype) @ x + B.to(x.dtype) @ u + 0.01 * torch.tanh(x)

    def cost(x, u, t):
        return 0.5 * (x @ x + 0.1 * (u @ u))

    ocp = BlockStructuredProblem(dyn, cost, T_STAGES, NX, NU, x0=torch.ones(NX), device=device,
                                 **bounds)
    X0 = torch.zeros((T_STAGES + 1, NX), dtype=torch.float64, device=device)
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
    """(Problem, x0) of bench.py's HS71, or of the port's suite harness
    (``sleqp_tpu_torch/harness``: chainineq200, boxqp1000 and the others
    with the reference's data and seeds)."""
    if name == "hs71":
        def obj(x):
            return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

        def cons(x):
            return torch.stack([x[0] * x[1] * x[2] * x[3], x @ x])

        problem = Problem(Func(obj, 4, cons=cons, num_cons=2), var_lb=1.0, var_ub=5.0,
                          general_lb=[25.0, 40.0], general_ub=[float("inf"), 40.0], device=device)
        return problem, np.array([1.0, 5.0, 5.0, 1.0])
    problem, x0, _ = harness_problem(name, device)
    return problem, x0


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


def host_read_sites(fn):
    """(the synchronizations of the host with the card while ``fn()`` runs,
    as torch.cuda.set_sync_debug_mode reports them, counted by the Python
    line that made each: a Counter of "file:line"; its result)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                               if "synchroniz" in str(w.message)), out


def count_host_reads(fn):
    """(synchronizations of the host with the card while ``fn()`` runs, as
    torch.cuda.set_sync_debug_mode counts them, its result)."""
    sites, out = host_read_sites(fn)
    return sum(sites.values()), out


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
    """(Problem, x0) of a phase 8 run: HS71 from bench.py, the suite's
    problems from the port's harness, and by hand the two the harness
    lacks (Waechter-Biegler, hs42 with a linear row)."""
    inf = float("inf")
    if name not in ("wachbieg", "hs42_linear"):
        return dense_problem(name, device)
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


# Phase 9: the PDLP Cauchy LP.  chainineq's family (harness/medium.py's
# chainineq200 formula and seed, default_rng(41)) at n = 2100: m = 2099,
# N = n + 3m = 8397 LP columns, over Settings().pdlp_threshold (8192), so
# AUTO routes its Cauchy LP to PDLP.  The LP at x0 = 0 with the initial LP
# radius 0.8/sqrt(n) and penalty 10.  HiGHS (scipy) solves the same LP as
# the reference objective, held to tests/test_pdlp.py's bar at its
# tolerance (5e-4 at 1e-7; the LP is solved to Settings().pdlp_tol).
PDLP_N = 2100
PDLP_OBJ_ATOL = 5e-4


def pdlp_lp(device):
    """(problem, iterate, radius, penalty) of the phase 9 LP on ``device``."""
    n = PDLP_N
    t = torch.tensor(np.cumsum(np.random.default_rng(41).standard_normal(n)) * 0.2, device=device)
    func = Func(lambda x: 0.5 * ((x - t.to(x)) ** 2).sum(), n, cons=lambda x: x[1:] - x[:-1],
                num_cons=n - 1)
    problem = Problem(func, general_lb=-0.05, general_ub=0.05, device=device)
    it = create_iterate(problem, np.zeros(n))
    f = functools.partial(torch.tensor, dtype=torch.float64, device=device)
    return problem, it, f(0.8 / np.sqrt(n)), f(10.0)


def highs_objective(problem, it, radius, penalty):
    """The optimal objective of the same LP by scipy's HiGHS."""
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix

    A, lb, ub = cauchy._lp_data(problem.data, it, radius)
    c = cauchy._objective(it, penalty, False)
    A, lb, ub, c = (v.cpu().numpy() for v in (A, lb, ub, c))
    inf = cauchy.INF_THRESHOLD
    bounds = list(zip(np.where(lb <= -inf, None, lb), np.where(ub >= inf, None, ub)))
    res = linprog(c, A_eq=csr_matrix(A), b_eq=np.zeros(A.shape[0]), bounds=bounds,
                  method="highs")
    check(res.status == 0, f"HiGHS did not solve the PDLP LP: {res.message}")
    return float(res.fun)


def count_bool_reads(fn):
    """(reads of a 0-d tensor's truth value while ``fn()`` runs on the CPU,
    its result): the flags PDLP reads, one a block of PDHG iterations."""
    reads = []
    real = torch.Tensor.__bool__

    def counted(self):
        reads.append(1)
        return real(self)

    torch.Tensor.__bool__ = counted
    try:
        out = fn()
    finally:
        torch.Tensor.__bool__ = real
    return len(reads), out


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def pdlp_phase(log, card="cuda"):
    """Phase 9: the PDLP Cauchy LP on the card and on the CPU, and a whole
    Solver solve with lp_solver=PDLP.  ``card="cpu"`` rehearses the phase
    without a card (its host-read count then fails)."""
    settings = Settings()
    lps = [pdlp_lp(card), pdlp_lp("cpu")]
    problem, it, radius, penalty = lps[0]
    n, m = problem.num_variables, problem.num_cons
    backend = cauchy.resolved_lp_solver(settings, n, m)
    check(backend == LPSolver.PDLP, f"AUTO routes the LP (N = {n + 3 * m}) to {backend.name}")

    def run(k):
        p, i, r, pen = lps[k]
        return cauchy.solve_cauchy_lp(p.data, i, r, pen,
                                      cauchy.empty_basis(n, m, device=p.device),
                                      lp_solver=backend, pdlp_tol=settings.pdlp_tol)

    run(0)  # set-up on first use, uncounted
    times = []
    for k, dev in enumerate((card, "cpu")):
        synchronize(dev)
        t = time.perf_counter()
        res = run(k)
        synchronize(dev)
        times.append((time.perf_counter() - t, res))
    reads_card, _ = count_host_reads(lambda: run(0))
    reads_cpu, _ = count_bool_reads(lambda: run(1))
    (gpu_s, out), (cpu_s, ref) = times
    iters, cpu_iters = int(out.lp_iterations), int(ref.lp_iterations)
    f_highs = highs_objective(*lps[1])
    obj, cpu_obj = float(out.lp_obj), float(ref.lp_obj)
    dx = float((out.lp_step.cpu() - ref.lp_step).abs().max())
    a_bytes = m * (n + 3 * m) * 8
    log(9, f"PDLP Cauchy LP (chainineq, n = {n}, m = {m}, N = {n + 3 * m}, A {a_bytes / 1e6:.1f} "
           f"MB float64): state card {int(out.lp_state)}, CPU {int(ref.lp_state)}; PDHG iterations "
           f"card {iters}, CPU {cpu_iters}; objective card {obj:.12g}, CPU {cpu_obj:.12g}, HiGHS "
           f"{f_highs:.12g}; max |d_card - d_cpu| {dx:.3e}; card {1e3 * gpu_s:.2f} ms per LP, "
           f"{1e3 * gpu_s / max(iters, 1):.4f} ms per PDHG iteration, host reads {reads_card} "
           f"per LP; CPU {1e3 * cpu_s:.2f} ms per LP, {1e3 * cpu_s / max(cpu_iters, 1):.4f} ms "
           f"per PDHG iteration, flag reads {reads_cpu} per LP")
    check(int(out.lp_state) == 0 and int(ref.lp_state) == 0, "the PDLP LP is not OPTIMAL")
    check(iters == cpu_iters, f"PDLP iterations differ: card {iters}, CPU {cpu_iters}")
    check(dx <= 1e-8, f"the PDLP step differs from the CPU's by {dx:.3e}")
    for what, value in (("card", obj), ("CPU", cpu_obj)):
        check(abs(value - f_highs) <= PDLP_OBJ_ATOL,
              f"PDLP objective ({what}) {value} against HiGHS {f_highs}")
    check(torch.equal(out.var_states.cpu(), ref.var_states)
          and torch.equal(out.cons_states.cpu(), ref.cons_states),
          "the PDLP working set differs between the card and the CPU")

    # a whole solve on PDLP (tests/test_pdlp.py::test_pdlp_backend_full_solve)
    pdlp_settings = Settings(lp_solver=LPSolver.PDLP, pdlp_tol=1e-10)
    results = []
    for dev in (card, "cpu"):
        hs35, x0, f_opt = harness_problem("hs35", dev)
        solver = Solver(hs35, x0, pdlp_settings, device=dev)
        t = time.perf_counter()
        status = solver.solve(max_iterations=100)
        results.append((solver, status, time.perf_counter() - t))
    (solver, status, gpu_s), (ref_solver, ref_status, cpu_s) = results
    log(9, f"hs35 Solver on PDLP (pdlp_tol 1e-10): {status.name} obj={solver.obj_val:.11g} "
           f"(published {f_opt:.11g}); iterations card {solver.iterations}, CPU "
           f"{ref_solver.iterations}; card {gpu_s:.3f} s, CPU {cpu_s:.3f} s")
    check(status == Status.OPTIMAL and ref_status == Status.OPTIMAL, "hs35 on PDLP: not OPTIMAL")
    check(abs(solver.obj_val - f_opt) <= 1e-5 * (1.0 + abs(f_opt)),
          f"hs35 on PDLP: objective {solver.obj_val} against {f_opt}")
    check(solver.iterations == ref_solver.iterations, "hs35 on PDLP: iterations differ")


# Phase 10: dynamic functions, tests/test_dyn.py's two problems through
# Solver, each held as that test holds it (x to 1e-4 and 1e-3).
def dyn_problems(device):
    def rosenbrock(x, error_bound, obj_weight, cons_weights):
        err_f = 0.5 * error_bound / torch.clamp(obj_weight, min=1.0)
        true = (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
        return true + err_f * torch.sin(37.0 * x[0] + 53.0 * x[1]), x.new_zeros(0), obj_weight * err_f

    def constrained(x, error_bound, obj_weight, cons_weights):
        denom = torch.clamp(obj_weight + cons_weights.sum(), min=1.0)
        err = 0.4 * error_bound / denom
        obj = x[0] ** 2 + x[1] ** 2 + err * torch.cos(17.0 * x[0])
        cons = torch.stack([x[0] + x[1] + err * torch.sin(13.0 * x[1])])
        return obj, cons, (obj_weight + cons_weights.sum()) * err

    return {
        "rosenbrock": (Problem(DynFunc(rosenbrock, 2), device=device), np.zeros(2),
                       [1.0, 1.0], 1e-4),
        "constrained": (Problem(DynFunc(constrained, 2, num_cons=1), general_lb=1.0,
                                general_ub=float("inf"), device=device),
                        np.array([2.0, 2.0]), [0.5, 0.5], 1e-3),
    }


def dyn_phase(log, card="cuda"):
    """Phase 10: the two dynamic problems through Solver on the card and on
    the CPU."""
    cpu = dyn_problems("cpu")
    for name, (problem, x0, x_ref, atol) in dyn_problems(card).items():
        runs = []
        for dev, p in ((card, problem), ("cpu", cpu[name][0])):
            solver = Solver(p, x0, Settings(), device=dev)
            synchronize(dev)
            t = time.perf_counter()
            status = solver.solve(max_iterations=500)
            synchronize(dev)
            runs.append((solver, status, time.perf_counter() - t))
        (solver, status, gpu_s), (ref, ref_status, cpu_s) = runs
        bound = float(solver.state.error_bound)
        x = solver.solution
        log(10, f"dynamic {name}: {status.name} x={np.array2string(x, precision=8)}; error bound "
                f"1 -> {bound:.3e}; iterations card {solver.iterations}, CPU {ref.iterations}; "
                f"card {gpu_s:.3f} s, {1e3 * gpu_s / max(solver.iterations, 1):.2f} ms per "
                f"iteration; CPU {cpu_s:.3f} s")
        check(status == Status.OPTIMAL and ref_status == Status.OPTIMAL,
              f"dynamic {name}: not OPTIMAL")
        check(np.abs(x - np.array(x_ref)).max() <= atol, f"dynamic {name}: x = {x}")
        check(bound < 1.0, f"dynamic {name}: the error bound was not tightened")
        check(solver.iterations == ref.iterations, f"dynamic {name}: iterations differ")


# Phase 11: the suite sweep (tools/torch_suite.py) on the card, held to the
# r5 CSVs: all 101 rows on the float64 route; on the mixed route the rows
# whose r5 row is optimal (its four iter_limit rows, 1000 iterations each,
# run in the CPU sweep only) but for MIXED_LEFT_OUT: the ten rows that took
# longest in the card's mixed sweep of tools/torch_suite.py in PR 12 (78 of
# its 118 s), left out to keep the script under 600 s.  They run in the
# CPU sweep (tests/test_torch_suite_gate.py), and chainineq200, projqp500
# and extrosnb100 in phases 7 and 8 on both routes.
MIXED_LEFT_OUT = ("hs49", "dqrtic100", "powellsg100", "chainqp200", "chainineq200",
                  "liarwhd100", "hs38", "projqp500", "extrosnb100", "hs74")


def load_suite_tool():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "torch_suite.py")
    spec = importlib.util.spec_from_file_location("torch_suite", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def suite_phase(log, card="cuda", names=None):
    """Phase 11: the suite sweep on the card (``names``: a subset, to
    rehearse it); returns {route: {name: CSV fields}}."""
    tool = load_suite_tool()
    swept = {}
    for route in ("float64", "mixed"):
        oracle = tool.read_rows(tool.ORACLES[route])
        rows_of = [n for n in oracle if n in ALL_PROBLEMS and n in (names or ALL_PROBLEMS)
                   and (route == "float64"
                        or (oracle[n][3] == "optimal" and n not in MIXED_LEFT_OUT))]
        rows, result, seconds = tool.run(route, card, rows_of, verbose=False)
        log(11, f"suite {route} on the card: {len(rows)} rows in {seconds:.1f} s, "
                f"{result['iterations']} iterations (r5 {result['iterations_r5']}), "
                f"{1e3 * seconds / max(result['iterations'], 1):.1f} ms per iteration; solved "
                f"{result['solved']} (r5 {result['solved_r5']}); status differs "
                f"{result['status']}; objective differs {result['objective']}; named ties "
                f"{result['ties']}; more than "
                f"{tool.ITER_SLACK} iterations from r5 {result['iterations_far']}")
        slowest = sorted(rows.values(), key=lambda f: -float(f[9]))[:6]
        log(11, f"suite {route}: slowest rows " + ", ".join(
            f"{f[0]} {float(f[9]):.1f} s ({f[8]} iterations)" for f in slowest))
        check(result["ok"], f"the {route} suite on the card fails the end gate")
        swept[route] = rows
    return swept



# Phase 12: the banded structured path (banded.py).  bench.py's banded
# problem (bench.py:441-460) on both routes, on the card and on the CPU,
# its iterations held to the JAX package's on the CPU
# (tools/large_reference.py banded: OPTIMAL in 9 on both routes; the TPU
# run of r5 took 9, BENCH_r05.json); the suite's three banded rows from
# phase 11's sweep, held to the r5 CSVs; and the PDLP Cauchy LP of
# tests/test_banded.py::test_banded_cauchy_extraction_large on the card
# and on the CPU.
BANDED_JAX_ITERATIONS = {"float64": 9, "mixed": 9}
LARGE_ROWS = ("bandnl16k", "bandqp10k", "bandrosen10k")
ROUTE_SETTINGS = {"float64": "same", "mixed": "float32"}


def banded_bench_problem(device, N=160, k=64, q=16):
    """bench.py's banded problem (n = 10 240), as torch callables."""
    rng = np.random.default_rng(0)
    W = torch.tensor(rng.standard_normal((N, k)) * 0.5, device=device)
    S = torch.tensor(rng.standard_normal((N - 1, q, k)) * 0.3, device=device)

    def obj(x, t):
        return torch.sum((x - W.to(x)[t]) ** 2) + 0.1 * torch.sum(torch.cos(x))

    def cons(a, b, t):
        St = S.to(a)[t]
        return St @ (b - a) + 0.05 * (St @ a) ** 2

    return BandedProblem(obj, N, k, cons_block=cons, cons_per_block=q, var_lb=-2.0, var_ub=2.0,
                         cons_lb=-0.3, cons_ub=0.3, device=device)


def cauchy_extraction_problem(device, N=160, k=64, q=8):
    """test_banded_cauchy_extraction_large's problem (linear couplings)."""
    W = torch.tensor(np.random.default_rng(1).standard_normal((N, k)) * 2.0, device=device)
    return BandedProblem(lambda x, t: torch.sum((x - W.to(x)[t]) ** 2), N, k,
                         cons_block=lambda a, b, t: (b - a)[:q], cons_per_block=q, var_lb=-1.0,
                         var_ub=1.0, cons_lb=-0.1, cons_ub=0.1, device=device)


class timed_calls:
    """Within the block, every call of ``module.name`` is timed between two
    synchronizations of ``device``; ``seconds`` lists them."""

    def __init__(self, module, name, device):
        self.module, self.name, self.device = module, name, device
        self.seconds = []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            synchronize(self.device)
            t = time.perf_counter()
            out = self.real(*args, **kwargs)
            synchronize(self.device)
            self.seconds.append(time.perf_counter() - t)
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def measured_solve(run, device, module, kkt_name):
    """(state, seconds, host reads, [KKT seconds]) of ``run()`` on
    ``device``: a timed solve, a counted one and one with the KKT solves
    timed (on the card after a warm-up solve; on the CPU the timed solve
    only, and the truth-value reads of tensors counted)."""
    if torch.device(device).type == "cuda":
        run()
    synchronize(device)
    t = time.perf_counter()
    out = run()
    synchronize(device)
    seconds = time.perf_counter() - t
    if torch.device(device).type != "cuda":
        reads, _ = count_bool_reads(run)
        return out, seconds, reads, None
    reads, _ = count_host_reads(run)
    with timed_calls(module, kkt_name, device) as kkt:
        run()
    return out, seconds, reads, kkt.seconds


def banded_phase(log, card="cuda", swept=None):
    """Phase 12 (``card="cpu"`` rehearses it; ``swept``: phase 11's rows)."""
    for route, cd in ROUTE_SETTINGS.items():
        settings = Settings(compute_dtype=cd)
        runs = {}
        for where, dev in (("card", card), ("cpu", "cpu")):
            problem = banded_bench_problem(dev)
            runs[where] = measured_solve(
                lambda: banded_solve(problem, settings, max_iterations=100), dev, banded,
                "_kkt_solve")
        (out, gpu_s, reads, kkt), (ref, cpu_s, cpu_reads, _) = runs["card"], runs["cpu"]
        iters, cpu_iters = int(out.iteration), int(ref.iteration)
        dx = float((out.X.cpu() - ref.X).abs().max())
        kkt_ms = 1e3 * sum(kkt) / max(len(kkt), 1) if kkt else float("nan")
        log(12, f"banded bench.py n = 10240 ({route}): {solve_summary(out)}; iterations card "
                f"{iters}, CPU {cpu_iters}, JAX {BANDED_JAX_ITERATIONS[route]}; card "
                f"{gpu_s:.3f} s, {1e3 * gpu_s / max(iters, 1):.2f} ms per iteration, host reads "
                f"{reads} ({reads / max(iters, 1):.1f} per iteration), KKT {kkt_ms:.2f} ms per "
                f"solve ({len(kkt or [])} solves); CPU {cpu_s:.3f} s, "
                f"{1e3 * cpu_s / max(cpu_iters, 1):.2f} ms per iteration, flag reads {cpu_reads}; "
                f"max |X_card - X_cpu| {dx:.3e}")
        for what, st in (("card", out), ("CPU", ref)):
            check(int(st.status) == Status.OPTIMAL, f"banded bench {route} ({what}): not OPTIMAL")
            check(float(st.feas_res) <= 1e-6 and float(st.stat_res) <= 1e-6,
                  f"banded bench {route} ({what}): residuals")
            check(int(st.iteration) == BANDED_JAX_ITERATIONS[route],
                  f"banded bench {route} ({what}): {int(st.iteration)} iterations, JAX "
                  f"{BANDED_JAX_ITERATIONS[route]}")
        if route == "float64":
            check(dx <= 1e-8, f"banded bench float64: X differs from the CPU's by {dx:.3e}")
        check(out.X.device.type == torch.device(card).type, "the banded state left the card")

    # the suite's banded rows, as phase 11 swept them through run_problem
    tool = load_suite_tool()
    for route in ROUTE_SETTINGS:
        oracle = tool.read_rows(tool.ORACLES[route])
        for name in LARGE_ROWS:
            fields, ref = (swept or {}).get(route, {}).get(name), oracle[name]
            check(fields is not None, f"phase 11 did not sweep {name} on the {route} route")
            f, f_ref = float(fields[4]), float(ref[4])
            its, its_ref = int(fields[8]), int(ref[8])
            log(12, f"{name} ({route}): {fields[3]} obj={f!r} (r5 {f_ref!r}); iterations {its} "
                    f"(r5 {its_ref}); feas {fields[5]} stat {fields[7]}; {fields[9]} s, "
                    f"{1e3 * float(fields[9]) / max(its, 1):.2f} ms per iteration")
            check(fields[3] == ref[3], f"{name} {route}: status {fields[3]}, r5 {ref[3]}")
            check(abs(f - f_ref) <= 1e-6 * max(1.0, abs(f_ref)),
                  f"{name} {route}: objective {f}, r5 {f_ref}")
            check(abs(its - its_ref) <= 3, f"{name} {route}: {its} iterations, r5 {its_ref}")

    # the PDLP Cauchy LP on the banded operator
    res = {}
    for where, dev in (("card", card), ("CPU", "cpu")):
        p = cauchy_extraction_problem(dev)
        X = torch.zeros((p.N_b, p.k), dtype=torch.float64, device=dev)
        run = functools.partial(banded.banded_cauchy, p, X, 0.5, 100.0, tol=1e-7)
        if dev != "cpu":
            run()
        synchronize(dev)
        t = time.perf_counter()
        d, _, cs, lp = run()
        synchronize(dev)
        res[where] = (p, X, d, cs, lp, time.perf_counter() - t)
    for where, (p, X, d, cs, lp, seconds) in res.items():
        iters = int(lp.iterations)
        cs = cs.cpu()
        C1 = p.cons(X + d.reshape(p.N_b, p.k)).reshape(-1).cpu()
        lo, up = cs == 1, cs == 2
        off = float(torch.cat([(C1[lo] + 0.1).abs(), (C1[up] - 0.1).abs(),
                               torch.zeros(1, dtype=C1.dtype)]).max())
        log(12, f"banded_cauchy N_b = 160, k = 64, q = 8 ({where}): state {int(lp.state)}, "
                f"{iters} PDHG iterations, {1e3 * seconds:.1f} ms "
                f"({1e3 * seconds / max(iters, 1):.4f} ms per iteration); active rows "
                f"{int(lo.sum() + up.sum())}, max distance from the bound {off:.3e}")
        check(int(lp.state) == 0, f"banded_cauchy ({where}) is not OPTIMAL")
        check(int(lo.sum() + up.sum()) > 500, f"banded_cauchy ({where}): too few active rows")
        check(off <= 1e-4, f"banded_cauchy ({where}): an active row is {off:.3e} off its bound")
    check(int(res["card"][4].iterations) == int(res["CPU"][4].iterations),
          "banded_cauchy: PDHG iterations differ between the card and the CPU")


# Phase 13: the matrix-free sparse path (sparse.py).
# tests/test_sparse.py::_scattered_problem at n = 5e4 (m = 5000, seed 3)
# on both routes on the card, and once on the CPU on the float64 route;
# HS71 with cauchy="pdlp" (tests/test_sparse.py:32) on the card.
HS71_X_OPT = np.array([1.0, 4.742999, 3.821151, 1.379408])  # tests/fixtures.py


def scattered_problem(n, device, seed=3):
    """tests/test_sparse.py::_scattered_problem as torch callables."""
    m = n // 10
    rng = np.random.default_rng(seed)
    i_idx = torch.tensor(rng.integers(0, n, m), device=device)
    j_idx = torch.tensor(rng.integers(0, n, m), device=device)
    w = torch.tensor(rng.uniform(0.5, 1.5, n), device=device)
    tgt = torch.tensor(rng.uniform(-2.0, 2.0, n), device=device)
    return SparseProblem(lambda x: 0.5 * torch.sum(w.to(x) * (x - tgt.to(x)) ** 2),
                         num_variables=n, cons=lambda x: x[i_idx] - x[j_idx], num_cons=m,
                         var_lb=-3.0, var_ub=3.0, cons_lb=-0.5, cons_ub=0.5, device=device)


def hs71_sparse(device):
    return SparseProblem(lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2], num_variables=4,
                         cons=lambda x: torch.stack([x[0] * x[1] * x[2] * x[3], x @ x]),
                         num_cons=2, var_lb=1.0, var_ub=5.0, cons_lb=[25.0, 40.0],
                         cons_ub=[float("inf"), 40.0], cauchy="pdlp", device=device)


def sparse_phase(log, card="cuda"):
    """Phase 13 (``card="cpu"`` rehearses it)."""
    n = 50_000
    problem = scattered_problem(n, card)
    for route, cd in ROUTE_SETTINGS.items():
        settings = Settings(compute_dtype=cd)
        out, seconds, reads, kkt = measured_solve(
            lambda: sparse_solve(problem, settings, max_iterations=100), card, sparse,
            "_kkt_solve_cg")
        iters, cg = int(out.iteration), int(out.cg_iterations)
        kkt_ms = 1e3 * sum(kkt) / max(len(kkt), 1) if kkt else float("nan")
        lam, act = out.lam, out.act_low | out.act_up
        log(13, f"sparse scattered n = {n}, m = {n // 10} ({route}): {solve_summary(out)}; "
                f"CG steps {cg} ({cg / max(len(kkt or [iters]), 1):.1f} per EQP solve); card "
                f"{seconds:.3f} s, {1e3 * seconds / max(iters, 1):.2f} ms per iteration, host "
                f"reads {reads} ({reads / max(iters, 1):.1f} per iteration), CG {kkt_ms:.2f} ms "
                f"per EQP solve ({1e3 * sum(kkt or [0.0]) / max(cg, 1):.3f} ms per CG step); "
                f"active rows {int(act.sum())}")
        check(int(out.status) == Status.OPTIMAL, f"sparse scattered {route}: not OPTIMAL")
        check(float(out.feas_res) <= 1e-6 and float(out.stat_res) <= 1e-6,
              f"sparse scattered {route}: residuals")
        check(bool((lam[~act] == 0.0).all()), f"sparse scattered {route}: an inactive row's dual "
                                               "is not 0")
        check(out.x.device.type == torch.device(card).type, "the sparse state left the card")
        if route == "float64":
            cpu = scattered_problem(n, "cpu")
            t = time.perf_counter()
            ref = sparse_solve(cpu, settings, max_iterations=100)
            cpu_s = time.perf_counter() - t
            dx = float((out.x.cpu() - ref.x).abs().max())
            log(13, f"sparse scattered n = {n} (float64) on the CPU: {solve_summary(ref)}; CG "
                    f"steps {int(ref.cg_iterations)}; {cpu_s:.3f} s, "
                    f"{1e3 * cpu_s / max(int(ref.iteration), 1):.2f} ms per iteration; max "
                    f"|x_card - x_cpu| {dx:.3e}; card / CPU time {seconds / cpu_s:.3f}")
            check(int(ref.status) == Status.OPTIMAL and int(ref.iteration) == iters,
                  "sparse scattered float64: the CPU solve differs from the card's")
            check(dx <= 1e-6, f"sparse scattered float64: x differs from the CPU's by {dx:.3e}")

    hs71 = hs71_sparse(card)
    x0 = np.array([1.0, 5.0, 5.0, 1.0])
    synchronize(card)
    t = time.perf_counter()
    reads, out = count_host_reads(lambda: sparse_solve(hs71, Settings(), x0=x0,
                                                       max_iterations=100))
    synchronize(card)
    seconds = time.perf_counter() - t
    iters = int(out.iteration)
    dx = float(np.abs(out.x.cpu().numpy() - HS71_X_OPT).max())
    log(13, f"sparse HS71 (cauchy='pdlp'): {solve_summary(out)}; CG steps "
            f"{int(out.cg_iterations)}; card {seconds:.3f} s with the reads counted, "
            f"{1e3 * seconds / max(iters, 1):.2f} ms per iteration, host reads {reads} "
            f"({reads / max(iters, 1):.1f} per iteration); max |x - x_opt| {dx:.3e}")
    check(int(out.status) == Status.OPTIMAL, "sparse HS71: not OPTIMAL")
    check(dx <= 1e-5, f"sparse HS71: x is {dx:.3e} from x_opt")

# Phase 14: the batched dense solve (parallel/batch.py) at bench.py's width:
# HS71 from bench.py's starts (default_rng(0), jitter +-0.05, clipped to
# [1, 5]), MAX_ITERATIONS 60, batched_solve_mp with
# Settings(compute_dtype="float32") at B = 512 and 1024 and batched_solve
# with Settings() at B = 1024, each lane held to the JAX package's lane from
# artifacts/batch_hs71_jax_cpu.json (tools/batch_reference.py, JAX on the
# CPU).  batched_solve_mp's float32 phase 1 is chaotic in both packages:
# near HS71's solution its model reductions fall to the float32 rounding of
# the merit and the projected Hessian's least Rayleigh quotient to ~1e-4,
# so which lanes meet the coarse test before the cap is not reproducible:
# starts moved by 4-92 float32 ulps (batch_starts' ``perturb``) move the
# count of phase-1 OPTIMAL lanes at B = 1024 over 361-460 in JAX and
# 371-474 in the port (tools/batch_reference.py).  So phase 1 is held as a
# distribution: its OPTIMAL count within JAX's recorded band (mean +-
# BAND_SIGMAS standard deviations over the perturbed runs), every
# phase-1 OPTIMAL lane's float32 residuals within the coarse tolerance, and
# phase 2: lanes warm-started from phase 1 take on average no more than
# WARM_MEAN iterations more than JAX's, and no more than WARM_SLOW_SHARE of
# them more than WARM_FAST iterations (where phase 1 ends decides how long
# the polish takes: from the port's phase-1 states JAX's phase 2 takes the
# port's iterations on 3366 of 3391 warm lanes, tools/batch_reference.py
# --from-port, and over its recorded start sets JAX's warm lanes reach 7);
# a lane cold in both packages (restarted from x0) takes JAX's phase-2
# iterations within 3.  A lane whose phase 1
# ends as JAX's (the same status and iterations) is held to JAX's total
# iterations within 3 as every plain lane is.
BATCH_REF = "artifacts/batch_hs71_jax_cpu.json"
BATCH_SIZES = (512, 1024)
BATCH_MAX_IT = 60
HS71_OPT = 17.0140173
BATCH_SAMPLES = 8  # lanes held to the port's own single-lane solve on the card
COARSE_TOL = 2e-3  # batched_solve_mp's default coarse_tol
BAND_SIGMAS = 4.0
WARM_MEAN = 0.5
WARM_FAST = 3
WARM_SLOW_SHARE = 0.05  # JAX: at most 1.54% a start set (phase2_warm_perturbed)


def batch_starts(batch, perturb=0):
    """bench.py's _x0_batch as numpy; ``perturb`` k scales the starts by
    1 + 4 k float32 ulps (clipped to the box again)."""
    rng = np.random.default_rng(0)
    x = np.clip(np.array([1.0, 5.0, 5.0, 1.0])[None, :]
                + rng.uniform(-0.05, 0.05, (batch, 4)), 1.0, 5.0)
    return np.clip(x * (1.0 + 4 * perturb * np.finfo(np.float32).eps), 1.0, 5.0)


def phase1_band(counts):
    """The band for a run's phase-1 OPTIMAL count from JAX's counts over
    the perturbed starts: mean +- BAND_SIGMAS standard deviations."""
    counts = np.asarray(counts, dtype=float)
    half = BAND_SIGMAS * counts.std(ddof=1)
    return counts.mean() - half, counts.mean() + half


def phase1_mismatch(p1, out, ref):
    """What fails in ``batched_solve_mp``'s phases, lane by lane, against
    JAX's (``ref``: per-lane ``phase1_status``, ``phase1_iterations`` and
    ``iterations``), given the port's phase-1 state ``p1`` and final state
    ``out``.  Returns (list of failures, summary dict); phase-1 ties are
    the lanes whose phase 1 ends otherwise than JAX's."""
    bad = []
    p1_status = p1.status.cpu().numpy()
    p1_iters = p1.iteration.cpu().numpy()
    p2 = out.iteration.cpu().numpy() - p1_iters
    ref_p1_status = np.asarray(ref["phase1_status"])
    ref_p1_iters = np.asarray(ref["phase1_iterations"])
    ref_p2 = np.asarray(ref["iterations"]) - ref_p1_iters
    warm, ref_warm = p1_status == int(Status.OPTIMAL), ref_p1_status == int(Status.OPTIMAL)
    count = int(warm.sum())
    res = {name: float(getattr(p1, name)[torch.as_tensor(warm)].max()) if count else 0.0
           for name in ("feas_res", "stat_res", "slack_res")}
    if max(res.values()) > COARSE_TOL:
        bad.append(f"phase-1 OPTIMAL residuals {res} above {COARSE_TOL}")
    slow = np.flatnonzero(warm & (p2 > WARM_FAST))
    if slow.size > WARM_SLOW_SHARE * count:
        bad.append(f"{slow.size} of {count} warm lanes ({slow.tolist()[:10]}) take more than "
                   f"{WARM_FAST} phase-2 iterations ({p2[slow][:10].tolist()})")
    mean = float(p2[warm].mean()) if count else 0.0
    ref_mean = float(ref_p2[ref_warm].mean()) if ref_warm.any() else 0.0
    if count and mean > ref_mean + WARM_MEAN:
        bad.append(f"warm lanes take {mean:.2f} phase-2 iterations on average, JAX's {ref_mean:.2f}")
    cold = ~warm & ~ref_warm
    far = np.flatnonzero(cold & (np.abs(p2 - ref_p2) > 3))
    if far.size:
        bad.append(f"lanes {far.tolist()[:10]}, cold in both, take {p2[far][:10].tolist()} "
                   f"phase-2 iterations, JAX {ref_p2[far][:10].tolist()}")
    cold_max = int(ref_p2[~ref_warm].max(initial=0)) + 3
    late = np.flatnonzero(~warm & ref_warm & (p2 > cold_max))
    if late.size:
        bad.append(f"lanes {late.tolist()[:10]}, cold in the port only, take "
                   f"{p2[late][:10].tolist()} phase-2 iterations, more than {cold_max}")
    ties = (p1_status != ref_p1_status) | (p1_iters != ref_p1_iters)
    summary = dict(count=count, jax_count=int(ref_warm.sum()), res=res,
                   warm_mean=mean, jax_warm_mean=ref_mean, warm_max=int(p2[warm].max(initial=0)),
                   jax_warm_max=int(ref_p2[ref_warm].max(initial=0)), warm_slow=int(slow.size),
                   cold=int(cold.sum()),
                   cold_diff=int(np.abs(p2 - ref_p2)[cold].max(initial=0)), ties=ties,
                   p1_iter_diff=int(np.abs(p1_iters - ref_p1_iters).max()),
                   p1_status_diff=int((p1_status != ref_p1_status).sum()))
    return bad, summary


class Trips:
    """Counts the lockstep trips (calls of perform_iteration on all lanes)
    while active."""

    def __enter__(self):
        self.count = 0
        self._inner = problem_solver.perform_iteration

        def counted(*args, **kwargs):
            self.count += 1
            return self._inner(*args, **kwargs)

        problem_solver.perform_iteration = counted
        return self

    def __exit__(self, *exc):
        problem_solver.perform_iteration = self._inner


def batch_run(name, batch, device):
    """One phase 14 run: ``name`` "mp" (batched_solve_mp's two phases,
    each timed) or "plain" (batched_solve) on ``device``.  Returns the
    final state, the phase-1 state (mp), and seconds and lockstep trips
    per phase."""
    problem, _ = dense_problem("hs71", device)
    starts = batch_starts(batch)
    runs, seconds, trips = [], [], []
    if name == "mp":
        settings = Settings(compute_dtype="float32")
        runs = [lambda: pb.mp_phase1(problem, settings, starts, min(20, BATCH_MAX_IT)),
                lambda p1: pb.mp_phase2(problem, settings, p1, starts, min(12, BATCH_MAX_IT))]
    else:
        runs = [lambda: pb.batched_solve(problem, Settings(), starts, BATCH_MAX_IT,
                                         device=device)]
    out, p1 = None, None
    for i, run in enumerate(runs):
        synchronize(device)
        with Trips() as counter:
            t = time.perf_counter()
            out = run() if i == 0 else run(p1)
            synchronize(device)
            seconds.append(time.perf_counter() - t)
        trips.append(counter.count)
        if i == 0:
            p1 = out
    return dict(out=out, p1=p1 if name == "mp" else None, seconds=seconds, trips=trips)


def batch_gate(key, got, ref):
    """Hold one run's lanes to JAX's (``ref``: a run of BATCH_REF); returns
    a summary.  Raises on a failed check."""
    out = got["out"]
    status = out.status.cpu().numpy()
    iters = out.iteration.cpu().numpy()
    obj = out.it.obj_val.cpu().numpy()
    ref_status = np.array(ref["status"])
    ref_iters = np.array(ref["iterations"])
    ref_obj = np.array(ref["objective"])
    check(len(status) == len(ref_status), f"{key}: {len(status)} lanes, JAX {len(ref_status)}")
    bad = np.flatnonzero(status != ref_status)
    check(bad.size == 0, f"{key}: lanes {bad.tolist()[:10]} end {status[bad][:10].tolist()}, "
                         f"JAX {ref_status[bad][:10].tolist()}")
    ok = status == int(Status.OPTIMAL)
    err = np.abs(obj - HS71_OPT)[ok].max(initial=0.0)
    err_jax = np.abs(obj - ref_obj)[ok].max(initial=0.0)
    check(err <= 1e-6 and err_jax <= 1e-6,
          f"{key}: OPTIMAL objectives {err:.3e} from HS71's, {err_jax:.3e} from JAX's")
    ties = np.zeros(len(status), dtype=bool)
    phase1 = ""
    if got["p1"] is not None:
        feas, stat = float(out.feas_res.max()), float(out.stat_res.max())
        check(feas <= 1e-6 and stat <= 1e-6, f"{key}: certified residuals {feas:.3e}, {stat:.3e}")
        bad, p = phase1_mismatch(got["p1"], out, ref)
        lo, hi = phase1_band(ref["phase1_optimal_perturbed"])
        if not lo <= p["count"] <= hi:
            bad.append(f"{p['count']} phase-1 OPTIMAL lanes, outside JAX's band "
                       f"[{lo:.1f}, {hi:.1f}]")
        check(not bad, f"{key}: " + "; ".join(bad))
        # phase 2 starts from phase 1's iterate: a lane whose phase 1 parts
        # from JAX's starts its float64 phase elsewhere (held above)
        ties = p["ties"]
        phase1 = (f"; phase 1: {p['count']} lanes OPTIMAL (JAX {p['jax_count']}, band "
                  f"{lo:.1f}-{hi:.1f}), residuals <= "
                  f"{max(p['res'].values()):.2e}; warm lanes' phase 2 {p['warm_mean']:.2f} "
                  f"iterations on average, at most {p['warm_max']}, {p['warm_slow']} "
                  f"more than {WARM_FAST} (JAX {p['jax_warm_mean']:.2f}, {p['jax_warm_max']}); "
                  f"{p['cold']} lanes cold in both, phase 2 within "
                  f"{p['cold_diff']} of JAX's; {int(ties.sum())} phase-1 ties (phase 1 up to "
                  f"{p['p1_iter_diff']} iterations from JAX's, {p['p1_status_diff']} lanes of "
                  f"another phase-1 status)")
    far = np.flatnonzero((np.abs(iters - ref_iters) > 3) & ~ties)
    check(far.size == 0, f"{key}: lanes {far.tolist()[:10]} take {iters[far][:10].tolist()} "
                         f"iterations, JAX {ref_iters[far][:10].tolist()}")
    return (f"solved {int(ok.sum())}/{len(status)} (JAX {int((ref_status == 2).sum())}), "
            f"statuses {({int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))})}; "
            f"iterations "
            f"{int(iters.min())}-{int(iters.max())} (JAX {int(ref_iters.min())}-"
            f"{int(ref_iters.max())}), max |iterations - JAX's| "
            f"{int(np.abs(iters - ref_iters)[~ties].max(initial=0))} off the ties"
            + phase1 + f"; max |f - f*| {err:.2e}, |f - f_JAX| {err_jax:.2e}")


# ---- ties between a batched lane and its single-lane solve ----------------
# (tests/torch_dense.py holds the port against the JAX package with the
# same field comparisons)

NONLIN = ("measure.obj_nonlin", "measure.cons_nonlin", "measure.lag_nonlin")


def flat_fields(obj, prefix=""):
    """{dotted field name: numpy array} of a state: dataclasses, tuples and
    mappings down to tensors or arrays."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(flat_fields(v, f"{prefix}{k}."))
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            out.update(flat_fields(v, f"{prefix}{i}."))
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(flat_fields(getattr(obj, f.name), f"{prefix}{f.name}."))
    elif isinstance(obj, torch.Tensor):
        out[prefix[:-1]] = obj.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(obj)
    return out


def field_mismatches(got, ref, tol, skip=()):
    """Fields of two flattened states that differ: floats by more than
    ``tol`` (absolute, scaled by max(1, |ref|)), everything else exactly;
    dtypes and shapes must agree."""
    assert set(got) >= set(ref), sorted(set(ref) - set(got))
    bad = {}
    for key, b in ref.items():
        if any(key.startswith(s) for s in skip):
            continue
        a = got[key]
        if a.dtype != b.dtype or a.shape != b.shape:
            bad[key] = f"{a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        elif a.dtype.kind == "f":
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                bad[key] = "NaN pattern"
                continue
            fin = ~np.isnan(a)
            with np.errstate(invalid="ignore"):  # inf - inf where both are inf
                err = np.abs(a[fin] - b[fin])
            scale = np.maximum(1.0, np.abs(np.where(np.isinf(b[fin]), 0.0, b[fin])))
            same_inf = np.isinf(b[fin]) & (a[fin] == b[fin])
            if np.any((err > tol * scale) & ~same_inf):
                bad[key] = float(np.max(np.where(same_inf, 0.0, err)))
        elif not np.array_equal(a, b):
            bad[key] = (a.tolist() if a.size <= 8 else "differs", b.tolist() if b.size <= 8 else "")
    return bad


def step_mismatches(got, ref, tol=1e-9):
    """Mismatching fields of a state after one iteration (``got``,
    flattened by ``flat_fields``) against another (``ref``): every float to
    ``tol``, everything else exactly.  Two kinds of field divide a rounding
    of the merit's terms, ~1e-13 (1 + |f| + |c|_1), by a small quantity,
    and are held to that bound: the nonlinearity measures (by ||d||^2) and
    the reduction ratio (by the model reduction)."""
    ratio = "last_reduction_ratio"
    diff = field_mismatches(got, ref, tol, skip=NONLIN + (ratio,))
    rounding = 1e-13 * (1.0 + abs(float(ref["it.obj_val"])) + np.abs(ref["it.cons_val"]).sum())
    d2 = float(ref["measure.step_norm"]) ** 2
    for key in NONLIN:
        if d2 > 0 and abs(float(got[key]) - float(ref[key])) > rounding / d2 + tol:
            diff[key] = float(got[key]) - float(ref[key])
    model = abs(float(ref["last_model_reduction"]))
    ratio_tol = tol * max(1.0, abs(float(ref[ratio])))
    if model > 0:
        ratio_tol += rounding * (1.0 + abs(float(ref[ratio]))) / model
    if not abs(float(got[ratio]) - float(ref[ratio])) <= ratio_tol:
        diff[ratio] = float(got[ratio]) - float(ref[ratio])
    return diff


def single_lane_states(problem, settings, x0, max_it):
    """The port's single-lane states from x0 to the end of its solve."""
    from sleqp_tpu_torch import initial_state, perform_iteration

    states = [initial_state(problem, settings, x0, device=problem.device)]
    while int(states[-1].status) == Status.RUNNING and len(states) <= max_it:
        states.append(perform_iteration(problem, settings, states[-1]))
    return states


def tie_mismatches(problem, settings, states, lanes):
    """{k: fields} where one batched iteration (``lanes`` copies of state
    k, lane ``lanes // 2`` read) parts from the single-lane state k + 1:
    empty on a rounding tie between a batched lane and its single-lane
    solve."""
    bad = {}
    for k, (before, after) in enumerate(zip(states[:-1], states[1:])):
        batch = pb.tree_map(lambda a: a[None].expand(lanes, *a.shape).clone(), before)
        got = pb.lane(pb.batched_step(problem, settings, batch, device=problem.device),
                      lanes // 2)
        diff = step_mismatches(flat_fields(got), flat_fields(after))
        if diff:
            bad[k] = diff
    return bad


def batch_phase(log, card="cuda"):
    """Phase 14 (``card="cpu"`` rehearses it)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), BATCH_REF)) as fh:
        ref = json.load(fh)["runs"]
    problem, _ = dense_problem("hs71", card)
    # set-up on first use, uncounted
    pb.batched_solve_mp(problem, Settings(compute_dtype="float32"), batch_starts(8),
                        max_iterations=BATCH_MAX_IT, device=card)
    summary = {}
    for device in (card, "cpu"):
        for name, batch in (("mp", 512), ("mp", 1024), ("plain", 1024)):
            if device == "cpu" and batch != 1024:
                continue
            key = f"{name}_{batch}"
            on_card = device == card
            if name == "mp" and on_card:
                # the entry point, as a user calls it (the warm-up run) ...
                entry = pb.batched_solve_mp(problem, Settings(compute_dtype="float32"),
                                            batch_starts(batch), max_iterations=BATCH_MAX_IT,
                                            device=device)
            timed = [batch_run(name, batch, device) for _ in range(3 if on_card else 1)]
            got = timed[-1]
            if name == "mp" and on_card:
                # ... and its two phases, timed one by one, give its lanes
                check(torch.equal(entry.status, got["out"].status)
                      and torch.equal(entry.iteration, got["out"].iteration),
                      f"{key} on {device}: the timed phases part from batched_solve_mp")
            report = batch_gate(f"{key} on {device}", got, ref[key])
            seconds = [sum(r["seconds"]) for r in timed]
            trips = got["trips"]
            best = min(seconds)
            iters = int(got["out"].iteration.sum())
            per_phase = ", ".join(
                f"phase {i + 1} {1e3 * s / max(n, 1):.2f} ms/trip over {n} trips"
                for i, (s, n) in enumerate(zip(timed[seconds.index(best)]["seconds"], trips)))
            summary[(device, key)] = dict(solves_per_s=batch / best,
                                          inst_it_per_s=iters / best,
                                          ms_per_trip=1e3 * best / max(sum(trips), 1))
            log(14, f"{name} B={batch} on {'card' if on_card else 'CPU'}: {report}; "
                    f"{best:.3f} s per solve (runs {', '.join(f'{s:.3f}' for s in seconds)}), "
                    f"{batch / best:.1f} solves/s, {iters / best:.1f} instance-iterations/s, "
                    f"{1e3 * best / max(sum(trips), 1):.2f} ms per lockstep trip ({per_phase})")
    # reads per lockstep trip on both, kernels per trip on the card, at B = 1024
    reads, got = count_bool_reads(lambda: batch_run("mp", 1024, "cpu"))
    log(14, f"mp B=1024 on the CPU: flag reads {reads} over {sum(got['trips'])} trips "
            f"({reads / sum(got['trips']):.2f} per trip)")
    if card == "cuda":
        reads, got = count_host_reads(lambda: batch_run("mp", 1024, card))
        trips = sum(got["trips"])
        line = (f"mp B=1024 on the card: host reads {reads} over {trips} trips "
                f"({reads / trips:.2f} per trip)")
        p32 = problem.astype(torch.float32)
        s32 = pb.mp_settings(Settings(compute_dtype="float32"))
        for label, prob, settings, x in (
                ("phase 1", p32, s32, torch.as_tensor(batch_starts(1024), dtype=torch.float32)),
                ("phase 2", problem, Settings(compute_dtype="float32"), batch_starts(1024))):
            states = pb.batched_initial_state(prob, settings, x, device=card)
            pb.batched_step(prob, settings, states, device=card)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t = time.perf_counter()
                pb.batched_step(prob, settings, states, device=card)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t)
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.time_range.end > e.time_range.start]
            spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
            busy, end = 0.0, -float("inf")
            for s, e in spans:
                busy += max(0.0, e - max(s, end))
                end = max(end, e)
            busy /= 1e3
            line += (f"; {label} first trip traced: {len(kernels)} kernels, wall {wall:.2f} ms, "
                     f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}")
        log(14, line)
    # sampled lanes against the port's own single-lane solve on the card
    x0b = batch_starts(1024)
    lanes = pb.batched_solve(problem, Settings(), x0b, BATCH_MAX_IT, device=card)
    samples = np.linspace(0, 1023, BATCH_SAMPLES).astype(int).tolist()
    named = []
    for b in samples:
        alone = solve(problem, Settings(), x0b[b], BATCH_MAX_IT, device=card)
        check(int(alone.status) == int(lanes.status[b]),
              f"lane {b}: status {int(lanes.status[b])}, single-lane {int(alone.status)}")
        dx = float((alone.it.x - lanes.it.x[b]).abs().max())
        if int(alone.iteration) != int(lanes.iteration[b]) or dx > 1e-9:
            states = single_lane_states(problem, Settings(), x0b[b], BATCH_MAX_IT)
            check(dx <= 1e-6 and not tie_mismatches(problem, Settings(), states, 8),
                  f"lane {b} parts from its single-lane solve (iterations "
                  f"{int(lanes.iteration[b])} against {int(alone.iteration)}, x {dx:.3e}) and "
                  f"is no rounding tie")
            named.append(b)
    log(14, f"lanes {samples} against their single-lane solve on the "
            f"{'card' if card == 'cuda' else 'CPU'}: same status, x within 1e-9"
            + (f" but the certified rounding ties {named}" if named else ""))
    return summary


# ---- phase 15: the sharded paths, four ranks on the one card ------------------
# Four ranks share the card over gloo (NCCL refuses two ranks on one GPU),
# so the phase measures correctness, not scaling: the ranks run the whole
# OCP iteration replicated and split only the Schur solve.

RANKS = 4
RANK_DEADLINE_S = 600.0  # the four ranks, start-up included
RANK_TIMEOUT_S = 300.0  # one collective
SCHUR_C, SCHUR_K = 390, 32  # N = 4 * 390 - 1 = 1559 blocks of the OCP's k
# name, compute_dtype, tridiag_backend
SHARDED_ROUTES = (("float64", "same", "auto"), ("pallas", "same", "pallas"),
                  ("mixed", "float32", "auto"))


def schur_system(N, k, seed=0):
    """tests/test_schur_sharded.py's SPD block-tridiagonal system, on the
    card."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((N - 1, k, k)) * 0.3
    M = rng.standard_normal((N, k, k))
    D = np.einsum("nij,nkj->nik", M, M) + (2.0 + 2 * k) * np.eye(k)
    b = rng.standard_normal((N, k))
    return tuple(torch.tensor(a, device="cuda") for a in (D, L, b))


def timed(fn, device="cuda"):
    """(fn(), seconds), between two synchronizations of ``device``."""
    synchronize(device)
    t = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t


def to_cpu(state):
    return pb.tree_map(lambda a: a.cpu(), state)


def same_bits(a, b):
    """Whether two tensors hold the same bits (NaN included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def rank_main(rank, world, folder):
    """One rank of phase 15 (``chip_smoke.py --rank R WORLD FOLDER``):
    the sharded Schur solve on both interior routes, ``ocp_solve(mesh=)``
    on three routes and ``sharded_solve``; states go to FOLDER, and the
    last line of standard output is the rank's report (times, launches of
    B1/B2 and collectives per run)."""
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    ranks.init("file://" + os.path.join(folder, "rendezvous"), rank, world, backend="gloo",
               timeout_s=RANK_TIMEOUT_S)
    try:
        meshes = {axis: ranks.device_mesh("cuda", axis) for axis in ("chunks", "stages", "batch")}
        report = {}

        def save(obj, name):
            torch.save(obj, os.path.join(folder, f"{name}.rank{rank}.pt"))

        def run(key, fn):
            clear_counts()
            collectives.CALLS.update(all_gather_rows=0, psum=0)
            out, seconds = timed(fn)
            report[key] = dict(seconds=seconds, launches=read_counts(), **collectives.CALLS)
            return out

        D, L, b = schur_system(RANKS * SCHUR_C - 1, SCHUR_K)
        for backend in ("scan", "pallas"):
            def schur():
                return sharded_schur_solve(D, L, b, meshes["chunks"], tridiag_backend=backend)
            schur()  # set-up on first use, uncounted
            save(run(f"schur_{backend}", schur).cpu(), f"schur_{backend}")

        ocp, X0 = bench_problem()
        for name, route, backend in SHARDED_ROUTES:
            settings = Settings(compute_dtype=route)
            ocp_perform_iteration(ocp, settings, ocp_initial_state(ocp, settings, X0=X0),
                                  mesh=meshes["stages"], tridiag_backend=backend)  # set-up
            out = run(name, lambda: ocp_solve(ocp, settings, X0=X0, max_iterations=50,
                                              mesh=meshes["stages"], tridiag_backend=backend))
            report[name]["iterations"] = int(out.iteration)
            save(to_cpu(out), f"ocp_{name}")

        problem, _ = dense_problem("hs71", "cuda")
        pb.sharded_solve(problem, Settings(), batch_starts(2 * RANKS), meshes["batch"],
                         max_iterations=BATCH_MAX_IT)  # set-up
        out, solved = run("sharded_solve", lambda: pb.sharded_solve(
            problem, Settings(), batch_starts(1024), meshes["batch"], max_iterations=BATCH_MAX_IT))
        report["sharded_solve"]["solved"] = int(solved)
        save(to_cpu(pb.gather_shards(out, meshes["batch"])), "sharded_solve")
        print(json.dumps(report), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def sharded_phase(log, refs):
    """Phase 15.  ``refs``: the unsharded OCP states of phases 4, 6 and 3
    on the card, by route name.  Returns the launches of B1-B6 summed over
    the ranks and runs."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), BATCH_REF)) as fh:
        batch_ref = json.load(fh)["runs"]["plain_1024"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as folder:
        outs, wall = timed(lambda: ranks.spawn(
            [[sys.executable, os.path.abspath(__file__), "--rank", str(r), str(RANKS), folder]
             for r in range(RANKS)], RANK_DEADLINE_S))
        reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]

        def load(name):
            got = [torch.load(os.path.join(folder, f"{name}.rank{r}.pt"), weights_only=False)
                   for r in range(RANKS)]
            for r in range(1, RANKS):
                check(all(same_bits(a, b) for a, b in zip(pb.tree_leaves(got[r]),
                                                          pb.tree_leaves(got[0]))),
                      f"{name}: rank {r} ends with other bits than rank 0")
            return got[0]

        def summed(key):
            return {n: sum(rep[key]["launches"][n] for rep in reports) for n in KERNELS}

        log(15, f"{RANKS} ranks on one card over gloo (four ranks sharing one card measure "
                f"correctness, not scaling); ranks started and joined in {wall:.1f} s")
        launches = {n: 0 for n in read_counts()}
        D, L, b = schur_system(RANKS * SCHUR_C - 1, SCHUR_K)
        x_seq = block_tridiag_solve(D, L, b).cpu()
        for backend in ("scan", "pallas"):
            key = f"schur_{backend}"
            err = float((load(key) - x_seq).abs().max())
            ms = 1e3 * max(rep[key]["seconds"] for rep in reports)
            calls = reports[0][key]["all_gather_rows"]
            sums = summed(key)
            log(15, f"sharded_schur_solve N={RANKS * SCHUR_C - 1}, k={SCHUR_K}, "
                    f"tridiag_backend='{backend}': max |x - x_thomas| {err:.3e}; {ms:.2f} ms per "
                    f"solve (slowest rank); {calls} collectives per solve; launches over the "
                    f"ranks {sums}")
            check(err <= 1e-8, f"{key}: x differs from block_tridiag_solve by {err:.3e}")
            check(calls == 2, f"{key}: {calls} collectives per solve")
            if backend == "pallas":
                check(sums["bgj_flat"] > 0, f"{key}: bgj_flat was not launched")
            for n, v in sums.items():
                launches[n] += v

        for name, _, backend in SHARDED_ROUTES:
            st, ref = load(f"ocp_{name}"), refs[name]
            iters = int(st.iteration)
            seconds = max(rep[name]["seconds"] for rep in reports)
            kkt_calls = reports[0][name]["all_gather_rows"] / max(iters, 1)
            sums = summed(name)
            u_err = float((st.U - ref.U.cpu()).abs().max())
            rel_obj = abs(float(st.obj_val) - float(ref.obj_val)) / abs(float(ref.obj_val))
            log(15, f"ocp_solve(mesh=) {name} ('{backend}') n={T_STAGES * (NX + NU)}: "
                    f"{solve_summary(st)}; unsharded {int(ref.iteration)} iterations; "
                    f"max |U - U_unsharded| {u_err:.3e}, objective {rel_obj:.3e} relative; "
                    f"{seconds:.3f} s per run, {1e3 * seconds / max(iters, 1):.2f} ms per "
                    f"iteration (slowest rank); {kkt_calls:.2f} collectives per KKT solve; "
                    f"launches over the ranks {sums}")
            check(int(st.status) == int(ref.status) == Status.OPTIMAL,
                  f"sharded {name}: status {int(st.status)}, unsharded {int(ref.status)}")
            check(kkt_calls == 2, f"sharded {name}: {kkt_calls} collectives per KKT solve")
            if name == "mixed":
                check(rel_obj <= 1e-6 and abs(iters - int(ref.iteration)) <= 3,
                      f"sharded mixed: objective {rel_obj:.3e} relative, iterations {iters} "
                      f"against {int(ref.iteration)}")
                check(sums["bgj_blocked64"] > 0, "sharded mixed: bgj_blocked64 was not launched")
            else:
                check(iters == int(ref.iteration) and u_err <= 1e-8,
                      f"sharded {name}: iterations {iters} against {int(ref.iteration)}, "
                      f"U {u_err:.3e}")
            if name == "pallas":
                check(sums["bgj_flat"] > 0, "sharded pallas: bgj_flat was not launched")
            for n, v in sums.items():
                launches[n] += v

        whole = load("sharded_solve")
        gate = batch_gate("sharded_solve B=1024", dict(out=whole, p1=None), batch_ref)
        gathered = int((whole.status == int(Status.OPTIMAL)).sum())
        solved = [rep["sharded_solve"]["solved"] for rep in reports]
        seconds = max(rep["sharded_solve"]["seconds"] for rep in reports)
        log(15, f"sharded_solve HS71 B=1024 ({1024 // RANKS} lanes a rank): {gate}; psum'd "
                f"count {solved[0]} on every rank, gathered {gathered}; {seconds:.3f} s per "
                f"solve (slowest rank), {1024 / seconds:.1f} solves/s; collectives: "
                f"{reports[0]['sharded_solve']['psum']} psum")
        check(solved == [gathered] * RANKS, f"sharded_solve: psum'd {solved}, gathered {gathered}")
        for n, v in summed("sharded_solve").items():
            check(v == 0, f"sharded_solve launched {n}")
    return launches


# ---- phase 16: the scenario batch of the OCP (batched_ocp_solve) -------------

SCENARIOS = 8
SCENARIO_RADIUS = 0.95  # bench.py's A scaled: the rollout start stays bounded


class OCPTrips:
    """Counts the trips of the OCP solve loop (calls of
    ``ocp_perform_iteration``, on all lanes) while active."""

    def __enter__(self):
        self.count = 0
        self._inner = ocp_module.ocp_perform_iteration

        def counted(*args, **kwargs):
            self.count += 1
            return self._inner(*args, **kwargs)

        ocp_module.ocp_perform_iteration = counted
        return self

    def __exit__(self, *exc):
        ocp_module.ocp_perform_iteration = self._inner


def ocp_lane_tie(problem, settings, state, lanes):
    """Certify a lane that parts from its single-lane solve: from each
    state of the single-lane solve from ``state``, one batched iteration
    of ``lanes`` copies gives its next state (U, X, lam, status and
    iteration within the float32 KKT solve's rounding, 1e-6).  Returns the
    first iteration where it does not, or None."""
    while int(state.status) == Status.RUNNING:
        after = ocp_perform_iteration(problem, settings, state)
        copies = pb.tree_map(lambda a: a[None].expand(lanes, *a.shape).clone(), state)
        got = pb.lane(vmap_lanes(lambda s: ocp_perform_iteration(problem, settings, s), copies),
                      lanes // 2)
        same = (int(got.status) == int(after.status) and int(got.iteration) == int(after.iteration)
                and all(float((getattr(got, f) - getattr(after, f)).abs().max()) <= 1e-6
                        for f in ("U", "X", "lam")))
        if not same:
            return int(state.iteration)
        state = after
    return None


class MeritCalls:
    """Counts the evaluations of ``problem.merit`` (one an Armijo trial,
    one more at the step taken; one call for all lanes under ``vmap``)
    while active."""

    def __init__(self, problem):
        self.problem = problem

    def __enter__(self):
        self.count = 0
        inner = self.problem.merit

        def counted(*args, **kwargs):
            self.count += 1
            return inner(*args, **kwargs)

        self.problem.merit = counted
        return self

    def __exit__(self, *exc):
        del self.problem.merit  # the class's method again


# (scenario set, control bound, route): controls free, where the lanes
# move together, on both routes; controls bounded to [-0.3, 0.3], where
# the lanes saturate different controls, backtrack apart and stop on
# different trips, on the mixed route, which folds B1/B2 (the float64
# route's lanes take the same trips there; the set costs it ~130 s)
U_BOUND = 0.3
SCENARIO_RUNS = (("free", None, "float64"), ("free", None, "mixed"), ("bounded", U_BOUND, "mixed"))


def batched_ocp_phase(log, card="cuda"):
    """Phase 16 (``card="cpu"`` rehearses it, host reads counted as truth
    values read): B = 8 scenarios at bench.py's widths (T = 1560, nx = nu
    = 32) through ``batched_ocp_solve`` on both routes and both scenario
    sets (the bounded one on the mixed route), each lane held to the
    port's single-lane solve from its initial state.  With free controls the lanes move together, and the host reads
    per loop trip (counted from the initial states on) and bgj_blocked64
    launches per trip must equal the single lane's.  With bounded controls
    the lanes must stop on different trips and backtrack apart (the per-lane
    freeze and the masked Armijo trials on the card); bgj_blocked64 is
    launched as often as for the slowest lane, and a read or a merit
    evaluation of the batch serves all lanes (no more than the single lanes'
    sum, no fewer than the slowest one's).  Returns the launches of B1-B6
    in the batched solves."""
    A, _ = bench_matrices(SCENARIO_RADIUS)
    x0s = torch.ones((SCENARIOS, NX), dtype=torch.float64, device=card) + 0.05 * torch.arange(
        SCENARIOS, dtype=torch.float64, device=card)[:, None]
    log(16, f"bench.py's problem with A scaled to spectral radius "
            f"{np.abs(np.linalg.eigvals(A)).max():.6f}; lane b from x0 = 1 + 0.05 b, "
            f"B={SCENARIOS}, T={T_STAGES}, n={T_STAGES * (NX + NU)} a lane; controls free, "
            f"and bounded to [-{U_BOUND}, {U_BOUND}]")

    def sites(fn):
        if card == "cuda":
            return host_read_sites(fn)
        n, out = count_bool_reads(fn)
        return collections.Counter(truth_values=n), out

    launches = {n: 0 for n in read_counts()}
    for kind, u_bound, route in SCENARIO_RUNS:
        settings = Settings(compute_dtype=ROUTE_SETTINGS[route])
        ocp, _ = bench_problem(SCENARIO_RADIUS, device=card, u_bound=u_bound)
        tag = f"batched {route} {kind}"

        def solve_from(state):
            return ocp_solve_from(ocp, settings, state, 50)

        singles = []
        for b in range(SCENARIOS):
            state0 = ocp_initial_state(ocp, settings, x0=x0s[b], device=card)
            clear_counts()
            with OCPTrips() as trips, MeritCalls(ocp) as merits:
                reads, (st, seconds) = sites(lambda: timed(lambda: solve_from(state0), card))
            singles.append(dict(state=st, state0=state0, reads=reads, trips=trips.count,
                                merits=merits.count, seconds=seconds,
                                b2=read_counts()["bgj_blocked64"]))
        # the entry point, as a user calls it: its launches and time
        clear_counts()
        with OCPTrips() as trips:
            out, seconds = timed(lambda: batched_ocp_solve(ocp, settings, x0s, max_iterations=50,
                                                           device=card), card)
        counts = read_counts()
        for n, v in counts.items():
            launches[n] += v
        # the same loop from the batched initial states: its host reads,
        # merit evaluations and time a trip, as the single lanes' above
        states0 = vmap_lanes(lambda x: ocp_initial_state(ocp, settings, x0=x, device=card), x0s)
        with MeritCalls(ocp) as merits:
            reads, (again, loop_s) = sites(lambda: timed(lambda: vmap_lanes(solve_from, states0),
                                                         card))
        check(torch.equal(again.U, out.U), f"{tag}: the loop from the batched initial states "
                                           f"parts from batched_ocp_solve")
        check(out.U.shape == (SCENARIOS, T_STAGES, NU) and bool(torch.isfinite(out.U).all()),
              f"{tag}: U of shape {tuple(out.U.shape)} or not finite")
        ties = []
        for b, one in enumerate(singles):
            st = one["state"]
            check(int(out.status[b]) == int(st.status) == Status.OPTIMAL,
                  f"{tag} lane {b}: status {int(out.status[b])}, single {int(st.status)}")
            u_err = float((out.U[b] - st.U).abs().max())
            same_it = int(out.iteration[b]) == int(st.iteration)
            if route == "float64":
                check(same_it and u_err <= 1e-10, f"{tag} lane {b}: iterations "
                      f"{int(out.iteration[b])} against {int(st.iteration)}, U {u_err:.3e}")
            elif not (same_it and u_err <= 1e-6):
                at = ocp_lane_tie(ocp, settings, one["state0"], SCENARIOS)
                check(at is None, f"{tag} lane {b} parts from its single-lane solve "
                                  f"(U {u_err:.3e}) and one batched iteration from the single "
                                  f"lane's state {at} parts from its next")
                ties.append(b)
        u_max = max(float((out.U[b] - one["state"].U).abs().max()) for b, one in enumerate(singles))
        spread = float((out.U[1:] - out.U[:1]).abs().amax(dim=(1, 2)).min())
        check(spread > 1e-3, f"{tag}: lanes differ by only {spread:.3e}")
        # the single lane that iterates longest makes as many loop trips
        slow = max(singles, key=lambda one: one["trips"])
        n_reads, n_slow = sum(reads.values()), sum(slow["reads"].values())
        lane_reads = [sum(one["reads"].values()) for one in singles]
        lane_merits = [one["merits"] for one in singles]
        # merit evaluations beyond the one trial and the one at the step of
        # an iteration: the Armijo backtracks of the lane
        backtracks = [one["merits"] - 2 * int(one["state"].iteration) for one in singles]
        log(16, f"{tag} on the {'card' if card == 'cuda' else 'CPU'}: "
                f"{SCENARIOS}/{SCENARIOS} OPTIMAL, iterations {out.iteration.tolist()} as the "
                f"single lanes'" + (f" but the certified ties {ties}" if ties else "")
                + f"; rejected steps {out.num_rejected.tolist()}; max |U - U_single| "
                f"{u_max:.3e}; lanes differ by >= {spread:.3e}; {seconds:.3f} s per batch (the "
                f"rollouts included), {1e3 * loop_s / trips.count:.2f} ms per lockstep trip "
                f"({trips.count} trips); single lanes {sum(o['seconds'] for o in singles):.3f} s "
                f"in all, {1e3 * slow['seconds'] / slow['trips']:.2f} ms per trip; host reads "
                f"per trip {n_reads / trips.count:.2f} (single lanes "
                + ", ".join(f"{r / one['trips']:.2f}" for r, one in zip(lane_reads, singles))
                + f"), merit evaluations {merits.count} (single lanes {lane_merits}; Armijo "
                f"backtracks {backtracks}), bgj_blocked64 per trip "
                f"{counts['bgj_blocked64'] / trips.count:.2f} (single lane "
                f"{slow['b2'] / slow['trips']:.2f}); launches {counts}")
        check(trips.count == slow["trips"], f"{tag}: {trips.count} trips, the slowest "
                                            f"single lane {slow['trips']}")
        check(counts["bgj_blocked64"] == slow["b2"],
              f"{tag}: bgj_blocked64 launches {counts['bgj_blocked64']} over the batch, the "
              f"slowest single lane {slow['b2']}")
        if kind == "free":
            check(n_reads == n_slow, f"{tag}: host reads {n_reads} over the batch, the single "
                  f"lane {n_slow}; reads by site, batch minus single lane: "
                  f"{dict(reads - slow['reads'])}, single lane minus batch: "
                  f"{dict(slow['reads'] - reads)}")
        else:
            check(len(set(out.iteration.tolist())) > 1 and len(set(backtracks)) > 1
                  and max(backtracks) > 0,
                  f"{tag}: the lanes do not part (iterations {out.iteration.tolist()}, "
                  f"backtracks {backtracks})")
            check(max(lane_reads) <= n_reads <= sum(lane_reads)
                  and max(lane_merits) <= merits.count <= sum(lane_merits),
                  f"{tag}: host reads {n_reads} (single lanes {lane_reads}) or merit "
                  f"evaluations {merits.count} (single lanes {lane_merits}) of the batch outside "
                  f"[the slowest lane's, the lanes' sum]")
        if route == "mixed":
            check(counts["bgj_blocked64"] > 0 or card != "cuda",
                  f"{tag}: bgj_blocked64 was not launched")
    return launches


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

    # each batch the main paths launch the inverses on, each held to its
    # plain version as the shapes above: B1 at the levels of the OCP's dual
    # Schur complement (T = 1560, k = 32), eleven a mixed iteration, and at
    # the levels of cr32 on a rank's interior in phase 15 (the sharded Schur
    # solve's 389 blocks, the sharded OCP's 390); B2 on the stage Hessians
    # (T + 1 blocks of 64), once a mixed iteration, and at the levels of
    # cr32 on the structured KKT (N = 160); and, with the lanes folded into
    # one launch, a lockstep trip of phase 16's eight mixed scenarios
    for name, k, batches, per in (
        ("bgj_flat", NX, cr_batches(T_STAGES), "mixed OCP iteration"),
        ("bgj_blocked64", NX + NU, [T_STAGES + 1], "mixed OCP iteration"),
        ("bgj_blocked64", 64, cr_batches(160), "cr32 factorization at N = 160"),
        ("bgj_flat", SCHUR_K, cr_batches(SCHUR_C - 1),
         f"cr32 factorization of a rank's {SCHUR_C - 1}-block interior"),
        ("bgj_flat", NX, cr_batches(-(-(T_STAGES + 1) // RANKS) - 1),
         "cr32 factorization of a rank's interior of the sharded OCP"),
        ("bgj_flat", NX, [SCENARIOS * n for n in cr_batches(T_STAGES)],
         f"trip of {SCENARIOS} mixed scenarios"),
        ("bgj_blocked64", NX + NU, [SCENARIOS * (T_STAGES + 1)],
         f"trip of {SCENARIOS} mixed scenarios"),
    ):
        times, rels, idents = {}, [], []
        for B in batches:
            C = spd_blocks(B, k, seed=B + k)
            K, P = KERNELS[name]["fn"](C), KERNELS[name]["plain"](C)
            check(bool(torch.isfinite(K).all()), f"{name} ({B},{k}): non-finite output")
            rels.append(rel_fro_diff(K, P))
            idents.append(identity_error(K, C))
            check(rels[-1] <= KERNEL_RTOL,
                  f"{name} ({B},{k}) disagrees with its plain version: {rels[-1]:.3e}")
            check(idents[-1] < 1e-4, f"{name} ({B},{k}) identity error {idents[-1]:.3e} >= 1e-4")
            times[B] = graph_ms(lambda: KERNELS[name]["fn"](C))
        log(2, f"{name} at k={k}, ms by batch (CUDA graph): "
               + ", ".join(f"{B}: {t:.4f}" for B, t in times.items())
               + f"; sum per {per} ({len(batches)} launches) {sum(times.values()):.4f} ms; "
               f"against the plain version at every batch: rel fro <= {max(rels):.3e}, "
               f"identity error <= {max(idents):.3e}")

    # the operators under torch.func.vmap, as batched_ocp_solve calls them:
    # the lanes of the main path's largest batch in one launch, each lane
    # held to the plain version of its own blocks
    for name, (B, k) in ((n, spec["shapes"][0]) for n, spec in KERNELS.items()):
        lanes = torch.stack([spd_blocks(B, k, seed=B + k + b) for b in range(SCENARIOS)])
        before = read_counts()[name]
        K = torch.func.vmap(KERNELS[name]["fn"])(lanes)
        torch.cuda.synchronize()
        calls = read_counts()[name] - before
        rels = [rel_fro_diff(K[b], KERNELS[name]["plain"](lanes[b])) for b in range(SCENARIOS)]
        idents = [identity_error(K[b], lanes[b]) for b in range(SCENARIOS)]
        log(2, f"torch.func.vmap({name}) on ({SCENARIOS}, {B}, {k}, {k}): {calls} launch(es); "
               f"each lane against the plain version: rel fro <= {max(rels):.3e}, identity "
               f"error <= {max(idents):.3e}")
        check(calls == 1, f"vmap({name}): {calls} launches for {SCENARIOS} lanes")
        check(bool(torch.isfinite(K).all()) and max(rels) <= KERNEL_RTOL and max(idents) < 1e-4,
              f"vmap({name}) disagrees with its plain version lane by lane: rel {max(rels):.3e}, "
              f"identity error {max(idents):.3e}")
    del lanes, K

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

    # -- phase 9: the PDLP Cauchy LP (no kernel of B1-B6) ---------------
    clear_counts()
    pdlp_phase(log)
    launches_pdlp = read_counts()
    check(not any(launches_pdlp.values()),
          f"the PDLP phase launched a kernel of B1-B6: {launches_pdlp}")

    # -- phase 10: dynamic functions (no kernel of B1-B6) ---------------
    clear_counts()
    dyn_phase(log)
    launches_dyn = read_counts()
    check(not any(launches_dyn.values()),
          f"the dynamic-function phase launched a kernel of B1-B6: {launches_dyn}")

    # -- phase 11: the suite sweep on both routes (no kernel of B1-B6) ----
    clear_counts()
    swept = suite_phase(log)
    launches_suite = read_counts()
    check(not any(launches_suite.values()),
          f"the suite phase launched a kernel of B1-B6: {launches_suite}")

    # -- phase 12: the banded structured path (no kernel of B1-B6) ---------
    clear_counts()
    banded_phase(log, swept=swept)
    launches_banded = read_counts()
    log(12, f"launches of B1-B6: {launches_banded}")
    check(not any(launches_banded.values()),
          f"the banded phase launched a kernel of B1-B6: {launches_banded}")

    # -- phase 13: the matrix-free sparse path (no kernel of B1-B6) -------
    clear_counts()
    sparse_phase(log)
    launches_sparse = read_counts()
    log(13, f"launches of B1-B6: {launches_sparse}")
    check(not any(launches_sparse.values()),
          f"the sparse phase launched a kernel of B1-B6: {launches_sparse}")

    # -- phase 14: the batched dense solve (no kernel of B1-B6) -----------
    clear_counts()
    batch_phase(log)
    launches_batch = read_counts()
    log(14, f"launches of B1-B6: {launches_batch}")
    check(not any(launches_batch.values()),
          f"the batched phase launched a kernel of B1-B6: {launches_batch}")

    # -- phase 15: the sharded paths, four ranks on the card -----------------
    launches_sharded = sharded_phase(log, dict(float64=ref, pallas=pal, mixed=out))
    log(15, f"launches of B1-B6 over the ranks: {launches_sharded}")

    # -- phase 16: the scenario batch of the OCP ------------------------------
    launches_scen = batched_ocp_phase(log)
    log(16, f"launches of B1-B6 in the batched solves: {launches_scen}")

    # -- phase 17: report --------------------------------------------------
    kernels = [
        dict(rec, launches=launches[name] + launches_kkt[name] + launches_pal[name]
             + launches_sharded[name] + launches_scen[name])
        for name, rec in results.items()
    ]
    check(len(kernels) == 6 and all(r["launches"] > 0 for r in kernels),
          f"a kernel was not launched on the main paths: {kernels}")
    log(17, f"all checks passed on '{card}'")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
