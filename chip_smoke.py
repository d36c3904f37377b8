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
   Cholesky solve of the same system, assembled);
3. the mixed-precision OCP solve: ``ocp_solve`` with
   ``Settings(compute_dtype="float32")`` on the multistage problem of
   ``bench.py`` (T = 1560, nx = nu = 32, n = 99 840), with the kernels'
   launch counts read around the solve, and the time of one iteration;
4. the float64 route on the same problem as the oracle for phases 3 and 6;
5. ``bench.py``'s structured-KKT system (N = 160 blocks of k = 64,
   n = 10 240) through ``block_tridiag_solve_mp`` on four backends, the
   streaming Thomas factor-solve and resolve, and cyclic reduction with a
   streaming tail, against the float64 block-Thomas solve; and the dense
   float64 Cholesky solve of the assembled system as the library yardstick;
6. the float64 OCP solve with ``tridiag_backend="pallas"`` (float32 cyclic
   reduction with float64 refinement) on the problem of phase 3;
7. one JSON line describing each kernel, then the result line.

Phases 3, 5 and 6 are the main paths: the launch counts are cleared just
before each and read just after, and the kernels line reports their sum.

Any failed check raises, so the script exits non-zero and prints no result
line.  Without a CUDA device it exits with code 2 before any phase; outside
a checkout of the repository the package import fails.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sleqp_tpu_torch import (  # noqa: E402
    BlockStructuredProblem,
    Settings,
    Status,
    ocp_initial_state,
    ocp_perform_iteration,
    ocp_solve,
)
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
        shapes=[(781, 32), (9, 32), (13, 3), (1, 4)],
    ),
    "bgj_blocked64": dict(
        fn=cr.bgj_blocked64,
        plain=cr.bgj_blocked64_plain,
        replaces="sleqp_tpu/ops/cyclic_reduction.py:143",
        shapes=[(1561, 64)],
    ),
}
SOURCE = "sleqp_tpu_torch/kernels/csrc/bgj.cu"
COUNTS = (cr.LAUNCHES, pt.LAUNCHES, pc.LAUNCHES)

# The block-Thomas kernels against their plain versions:
# max |K - P| / max |P| <= TRIDIAG_RTOL, as float32 recursions of the same
# arithmetic summed in another order (the reference holds its float32
# Thomas kernel to 2e-4 of the float64 scan, tests/test_pallas_tridiag.py:41).
TRIDIAG_RTOL = 1e-4
THOMAS_SHAPES = [(160, 64, 1), (13, 3, 3), (1, 4, 1)]  # (N, k, r)
THOMAS_LONG = (1560, 32, 1)  # the OCP's dual Schur complement, timed only
CHOL_SHAPES = [(1, 160, 64, 1), (4, 40, 64, 8), (2, 8, 128, 1)]  # (P, c, k, r)
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


def flat_inverses_per_solve(n):
    """bgj_flat launches of one cyclic-reduction factorization of n blocks
    of 32: one per level, one for the root (11 at n = 1560)."""
    count = 1
    while n > 1:
        n += 1 - n % 2  # identity-padded to odd
        n = (n - 1) // 2
        count += 1
    return count


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
                ms = time_call(lambda: spec["fn"](C))
                plain_ms = time_call(lambda: spec["plain"](C), reps=5)
                lib_ms = time_call(lambda: torch.linalg.inv(C))
                bound_ms, bound_by = bound(name, B, k)
                results[name] = dict(
                    name=name, route="cuda", source=SOURCE, replaces=spec["replaces"],
                    max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_ms,
                )
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"torch.linalg.inv {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by})")
            log(2, line)
            check(rel <= KERNEL_RTOL, f"{name} ({B},{k}) disagrees with its plain version: {rel:.3e}")
            check(ident_k < 1e-4, f"{name} ({B},{k}) identity error {ident_k:.3e} >= 1e-4")

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
        line = (f"thomas_fwd/bwd ({N},{k},{r}): kernel-plain max abs fwd {abs_fwd:.3e} "
                f"bwd {abs_bwd:.3e}; rel " + ", ".join(f"{key} {v:.3e}" for key, v in rels.items()))
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
    per_solve = flat_inverses_per_solve(T_STAGES)
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
    clear_counts()
    for backend in KKT_BACKENDS:
        def solve(backend=backend):
            return pt.block_tridiag_solve_mp(D, L, b, refine_iters=2, backend=backend)

        ms = host_ms(solve, reps=5)
        x = solve()
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
    x_fs, Minv, Lp32 = pt.block_tridiag_factor_solve_pallas(D, L, b)
    x_rs = pt.block_tridiag_resolve_pallas(Minv, Lp32, b)
    x_cr = cr.cr_resolve(cr.cr_factor(D, L, tail_n=16), b)
    torch.cuda.synchronize()
    launches_kkt = read_counts()
    errs = {name: float((xx.double() - x64).abs().max()) / x_scale
            for name, xx in (("factor_solve", x_fs), ("resolve", x_rs), ("cr tail 16", x_cr))}
    log(5, "float32 against x_f64 (max abs / max |x_f64|): "
           + ", ".join(f"{name} {e:.3e}" for name, e in errs.items())
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

    # -- phase 7: report ---------------------------------------------------
    kernels = [
        dict(rec, launches=launches[name] + launches_kkt[name] + launches_pal[name])
        for name, rec in results.items()
    ]
    check(len(kernels) == 6 and all(r["launches"] > 0 for r in kernels),
          f"a kernel was not launched on the main paths: {kernels}")
    log(7, "all checks passed")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
