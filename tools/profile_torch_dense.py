"""Where one dense SLP-EQP iteration of the PyTorch port spends its time
on the GPU.

    python3 tools/profile_torch_dense.py

Builds chip_smoke.py's dense problems (HS71, chainineq200, boxqp1000) on
CUDA, takes each to its third iterate on the float64 route, and traces the
next ``perform_iteration`` with ``torch.profiler``: the wall time of the
traced iteration, the device's busy time (the union of kernel intervals),
the idle share, the kernels launched and the host reads (synchronizations
counted by ``torch.cuda.set_sync_debug_mode``).  Needs a CUDA device;
exits 2 without one.
"""

import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from profile_torch_ocp import busy_ms  # noqa: E402
from sleqp_tpu_torch import Settings, initial_state, perform_iteration  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("profile_torch_dense: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    settings = Settings()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name in chip_smoke.DENSE_REF:
        problem, x0 = chip_smoke.dense_problem(name, "cuda")
        state = initial_state(problem, settings, x0, device="cuda")
        for _ in range(3):
            state = perform_iteration(problem, settings, state)
        perform_iteration(problem, settings, state)  # set-up on first use
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            perform_iteration(problem, settings, state)
            torch.cuda.set_sync_debug_mode("default")
        reads = sum("synchroniz" in str(w.message) for w in caught)
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            perform_iteration(problem, settings, state)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t)
        kernels = [
            e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.time_range.end > e.time_range.start
        ]
        busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
        print(f"{name}: traced iteration wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
              f"idle share {1 - busy / wall_ms:.3f}, {len(kernels)} kernels, "
              f"{reads} host reads", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
