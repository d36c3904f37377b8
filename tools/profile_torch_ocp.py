"""Where one mixed-precision OCP iteration of the PyTorch port spends its
time on the GPU.

    python3 tools/profile_torch_ocp.py

Builds chip_smoke.py's problem (bench.py's OCP, nx = nu = 32) on CUDA and
times, each as the median of five runs with a synchronize on both sides:
the whole ``ocp_perform_iteration``, its derivative assembly
(``linearize`` + ``constraint_vjp``), and its KKT step
(``_structured_kkt_step``). Then it traces one iteration with
``torch.profiler`` and prints the device's busy time (the union of kernel
intervals) against the wall time of the traced iteration, the number of
kernels launched, and the kernels with the most device time. Needs a CUDA
device; exits 2 without one.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sleqp_tpu_torch import Settings, ocp_initial_state, ocp_perform_iteration  # noqa: E402
from sleqp_tpu_torch.ocp import _stationarity, _structured_kkt_step  # noqa: E402


def timed_ms(fn, reps=5):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
    return statistics.median(out)


def busy_ms(intervals):
    """Length of the union of [start, end) intervals, in ms (input in us)."""
    total, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e3


def main():
    if not torch.cuda.is_available():
        print("profile_torch_ocp: no CUDA device", file=sys.stderr)
        return 2
    ocp, X0 = chip_smoke.bench_problem()
    mixed = Settings(compute_dtype="float32")
    s0 = ocp_initial_state(ocp, mixed, X0=X0)
    ocp_perform_iteration(ocp, mixed, s0)  # set-up on first use

    def derivatives():
        c, g, G, H = ocp.linearize(s0.X, s0.U, s0.lam, compute_dtype=torch.float32)
        return c, g, G, H, ocp.constraint_vjp(s0.X, s0.U, s0.lam)

    c, g, G, H, Jt_lam = derivatives()
    _, _, _, r = _stationarity(ocp, s0.X, s0.U, g, Jt_lam, s0.lam)
    frozen = torch.zeros((ocp.T + 1, ocp.nz), dtype=torch.bool, device=H.device)
    frozen[0, : ocp.nx] = True
    frozen[ocp.T, ocp.nx :] = True
    parts = {
        "iteration": lambda: ocp_perform_iteration(ocp, mixed, s0),
        "derivatives": derivatives,
        "kkt_step": lambda: _structured_kkt_step(ocp, c, r, G, H, frozen, s0.reg),
    }
    card = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; T={ocp.T} nx={ocp.nx} nu={ocp.nu}", flush=True)
    for name, fn in parts.items():
        print(f"{name}: {timed_ms(fn):.3f} ms (median of 5)", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ocp_perform_iteration(ocp, mixed, s0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start
    ]
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    print(f"traced iteration: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall_ms:.3f}, {len(kernels)} kernels", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
