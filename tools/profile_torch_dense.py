"""Where one dense SLP-EQP iteration of the PyTorch port spends its time
on the GPU, and what a whole single-lane solve costs an iteration.

    python3 tools/profile_torch_dense.py [--root CHECKOUT]

Builds chip_smoke.py's dense problems (HS71, chainineq200, boxqp1000,
projqp500) and a few rows of the suite (``ROWS``) on CUDA.  For each
problem and route (float64, and the mixed route ``compute_dtype="float32"``)
it times ``solve`` (``solve_jit``: CUDA graphs) and the eager loop
``solve_from`` ``REPEAT`` times after one warm-up solve, each ending on a
synchronize, and prints the best ms per iteration of each; on the float64
route it also takes the problem to its third iterate and traces the next
eager ``perform_iteration`` with ``torch.profiler``: the wall time of the
traced iteration, the device's busy time (the union of kernel intervals),
the idle share, the kernels launched and the host reads (synchronizations
counted by ``torch.cuda.set_sync_debug_mode``); and it traces one replay of
each program of ``solve_jit`` the solve ran (``--programs``, on by
default): its kernels, busy and wall ms and idle share, and the programs'
share of a solve's kernels (replays x kernels).  ``--root`` runs the port and
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
    parser.add_argument("--no-programs", dest="programs", action="store_false",
                        help="skip the replays of solve_jit's programs")
    parser.add_argument("names", nargs="*", help="problems (default: phase 7's and ROWS)")
    return parser.parse_args()


def best_ms_an_iteration(torch, run):
    """(best ms an iteration over REPEAT runs after a warm-up, the state)."""
    run()
    best = float("inf")
    for _ in range(REPEAT):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    return 1e3 * best / max(int(out.iteration), 1), out


def traced_replay(torch, busy_ms, loop, name):
    """(kernels, busy ms, wall ms) of one traced replay of ``name``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    loop.replay(name)
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loop.replay(name)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.end > e.time_range.start]
    return len(kernels), busy_ms([(e.time_range.start, e.time_range.end) for e in kernels]), wall


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
    names = args.names or [*chip_smoke.DENSE_REF, *ROWS]
    problems = [(name, *(chip_smoke.dense_problem(name, "cuda") if name in chip_smoke.DENSE_REF
                         else get_problem(name, "cuda")[:2])) for name in names]
    warm, wx0 = chip_smoke.dense_problem("hs71", "cuda")
    solve(warm, Settings(), wx0, device="cuda")  # set-up on first use
    ps = sleqp_tpu_torch.problem_solver
    graphs = hasattr(ps, "solve_jit")
    for name, problem, x0 in problems:
        line = name
        for route in ("same", "float32"):
            settings = Settings(compute_dtype=route)
            tag = "float64" if route == "same" else "mixed"
            graph_ms, out = best_ms_an_iteration(
                torch, lambda: solve(problem, settings, x0, device="cuda"))
            line += f"; {tag} {int(out.iteration)} iterations, {graph_ms:.2f} ms an iteration"
            if graphs:
                state0 = initial_state(problem, settings, x0, device="cuda")
                eager_ms, _ = best_ms_an_iteration(
                    torch, lambda: ps.solve_from(problem, settings, state0, 1000))
                line += f" by graph, {eager_ms:.2f} eager"
            if graphs and args.programs and route == "same":
                loop = ps.solve_graphs(problem, settings, state0, 1000)
                replays = dict(loop.replays)
                ps.solve_jit(problem, settings, state0, 1000)
                runs = {k: loop.replays[k] - replays[k] for k in replays
                        if loop.replays[k] > replays[k]}
                rows = {k: traced_replay(torch, busy_ms, loop, k) for k in runs}
                total = sum(runs[k] * rows[k][0] for k in rows)
                print(f"{name} float64 programs (replays a solve, kernels, busy ms, wall ms, "
                      f"idle share, share of the solve's kernels): " + ", ".join(
                          f"{k} x{runs[k]} {kn} {bz:.3f} {wl:.3f} {1 - bz / wl:.3f} "
                          f"{runs[k] * kn / max(total, 1):.3f}"
                          for k, (kn, bz, wl) in sorted(rows.items(),
                                                        key=lambda kv: -runs[kv[0]] * kv[1][0])),
                      flush=True)
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
