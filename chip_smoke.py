"""Drive the PyTorch/CUDA port (``sleqp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

run from a checkout of the repository, on a machine with a CUDA device and
``nvcc``.  The phases, each reported on one line with its elapsed seconds:

0. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
1. build the CUDA kernels from ``sleqp_tpu_torch/kernels/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time the kernel, the plain version,
   and ``torch.linalg.inv`` as a yardstick (never called by the port);
3. the main path: ``ocp_solve`` with ``Settings(compute_dtype="float32")``
   on the multistage problem of ``bench.py`` (T = 1560, nx = nu = 32,
   n = 99 840), with the kernels' launch counts read around the solve, and
   the time of one iteration;
4. the float64 route on the same problem as the oracle for phase 3;
5. one JSON line describing each kernel, then the result line.

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

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet): HBM bandwidth, and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

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


def time_ms(fn, x, reps=20):
    fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flat_flops(k):
    # k sweeps: k subtractions for f, 2k divisions for the pivot row, and
    # a k x 2k multiply-subtract update
    return k * (4 * k * k + 3 * k)


def blocked_flops(k):
    # per Schur level of half h: two half inverses, six h^3 products, and
    # the two h^2 additions (S = D - ..., Ai + ...)
    if k == 16:
        return flat_flops(16)
    h = k // 2
    return 2 * blocked_flops(h) + 12 * h**3 + 2 * h * h


def bound(name, B, k):
    bytes_moved = 2 * B * k * k * 4
    flops = B * (flat_flops(k) if name == "bgj_flat" else blocked_flops(k))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
                ms = time_ms(spec["fn"], C)
                plain_ms = time_ms(spec["plain"], C, reps=5)
                lib_ms = time_ms(torch.linalg.inv, C)
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

    # -- phase 3: the main path -------------------------------------------
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
    for key in cr.LAUNCHES:
        cr.LAUNCHES[key] = 0
    t = time.perf_counter()
    out = ocp_solve(ocp, mixed, X0=X0, max_iterations=50)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    launches = dict(cr.LAUNCHES)
    iters = int(out.iteration)
    log(3, f"mixed OCP n={T_STAGES * (NX + NU)}: {solve_summary(out)}; "
           f"solve {solve_s:.3f}s; one iteration {it_ms:.2f} ms; launches {launches}")
    check(out.U.shape == (T_STAGES, NU) and out.X.shape == (T_STAGES + 1, NX), "solution shape")
    check(bool(torch.isfinite(out.U).all() & torch.isfinite(out.X).all()), "non-finite solution")
    check(launches["bgj_blocked64"] >= iters, "bgj_blocked64 not launched once per iteration")
    per_solve = flat_inverses_per_solve(T_STAGES)
    check(launches["bgj_flat"] >= per_solve * iters,
          f"bgj_flat not launched {per_solve} times per iteration")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    # -- phase 4: the float64 route as the oracle --------------------------
    t = time.perf_counter()
    ref = ocp_solve(ocp, Settings(), X0=X0, max_iterations=50)
    torch.cuda.synchronize()
    u_err = float((out.U - ref.U).abs().max())
    log(4, f"float64 OCP: {solve_summary(ref)}; solve {time.perf_counter() - t:.3f}s; "
           f"max |U - U_f64| {u_err:.3e}")
    check(int(ref.status) == Status.OPTIMAL, "float64 route not OPTIMAL")
    check(int(out.status) == Status.OPTIMAL, "mixed route not OPTIMAL")
    check(float(out.feas_res) <= 1e-6 and float(out.stat_res) <= 1e-6, "mixed residuals above 1e-6")
    check(iters <= int(ref.iteration) + 3, "mixed route needs more than 3 extra iterations")
    check(u_err <= 1e-5, f"mixed U differs from float64 U by {u_err:.3e}")

    # -- phase 5: report ---------------------------------------------------
    kernels = [dict(rec, launches=launches[name]) for name, rec in results.items()]
    log(5, "all checks passed")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
