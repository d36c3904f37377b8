"""Where one dense SLP-EQP iteration of the PyTorch port spends its time
on the GPU, and what a whole single-lane solve costs an iteration.

    python3 tools/profile_torch_dense.py [--root CHECKOUT]

Builds chip_smoke.py's dense problems (HS71, chainineq200, boxqp1000) and a
few rows of the suite (``ROWS``) on CUDA.  For each problem and route
(float64, and the mixed route ``compute_dtype="float32"``) it times
``solve`` ``REPEAT`` times after one warm-up solve, each ending on a
synchronize, and prints the best ms per iteration; on the float64 route it
also takes the problem to its third iterate and traces the next
``perform_iteration`` with ``torch.profiler``: the wall time of the traced
iteration, the device's busy time (the union of kernel intervals), the idle
share, the kernels launched and the host reads (synchronizations counted
by ``torch.cuda.set_sync_debug_mode``).  ``--root`` runs the port and
``chip_smoke.py`` of another checkout (a ``git archive`` of a parent commit,
say) with this file's timing code, so that two commits are compared by one
program on one card.  Needs a CUDA device; exits 2 without one.
"""

import argparse
import os
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = ("hs6", "hs43", "hs46", "hs56", "hs100")  # phase 11's rows, a sample of shapes
REPEAT = 2


def parse():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(HERE),
                        help="the checkout whose sleqp_tpu_torch and chip_smoke.py run")
    return parser.parse_args()


def main():
    args = parse()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke
    import sleqp_tpu_torch
    from sleqp_tpu_torch import Settings, initial_state, perform_iteration, solve
    from sleqp_tpu_torch.harness.driver import get_problem

    sys.path.append(HERE)
    from profile_torch_ocp import busy_ms

    if not torch.cuda.is_available():
        print("profile_torch_dense: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; package {os.path.dirname(sleqp_tpu_torch.__file__)}", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    problems = [(name, *chip_smoke.dense_problem(name, "cuda")) for name in chip_smoke.DENSE_REF]
    problems += [(name, *get_problem(name, "cuda")[:2]) for name in ROWS]
    warm, wx0 = chip_smoke.dense_problem("hs71", "cuda")
    solve(warm, Settings(), wx0, device="cuda")  # set-up on first use
    for name, problem, x0 in problems:
        line = name
        for route in ("same", "float32"):
            settings = Settings(compute_dtype=route)
            solve(problem, settings, x0, device="cuda")
            best = float("inf")
            for _ in range(REPEAT):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = solve(problem, settings, x0, device="cuda")
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t)
            iters = int(out.iteration)
            line += (f"; {'float64' if route == 'same' else 'mixed'} {iters} iterations, "
                     f"{1e3 * best / max(iters, 1):.2f} ms an iteration")
        settings = Settings()
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
        print(f"{line}; float64 traced iteration wall {wall_ms:.3f} ms, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}, {len(kernels)} kernels, "
              f"{reads} host reads", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
