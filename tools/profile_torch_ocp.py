"""Where one OCP iteration of the PyTorch port spends its time on the GPU,
launched from the host and replayed as a CUDA graph.

    python3 tools/profile_torch_ocp.py [ROUTE ...]

Builds chip_smoke.py's problem (bench.py's OCP, T = 1560, nx = nu = 32) on
CUDA.  For each route (default all: ``mixed``, ``float64``, ``pallas``,
``spike``) it times, each as the median of five runs with a synchronize on
both sides, the eager ``ocp_perform_iteration``, its derivative assembly
(``linearize`` + ``constraint_vjp``) and its KKT step
(``_structured_kkt_step``).  Then it captures ``ocp_solve_jit``'s loop
(``ocp.iteration_graph``) and prints, for one eager iteration and for one
replay of the iteration's graph under ``torch.profiler``, the wall time,
the device's busy time (the union of kernel intervals), the idle share
and the number of kernels; the replay's time by CUDA events (median of
5); the time of a block of Armijo trials (the loop's second graph) and
the share of the trials inside the iteration's graph; and whether the
replay's state equals the eager iteration's bit for bit.  The kernels
with the most device time in the replay close each route.  Needs a CUDA
device; exits 2 without one, and 1 if a route fails.
"""

import os
import statistics
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sleqp_tpu_torch import Settings, ocp_initial_state, ocp_perform_iteration  # noqa: E402
from sleqp_tpu_torch import ocp as ocp_module  # noqa: E402
from sleqp_tpu_torch.ocp import _stationarity, _structured_kkt_step  # noqa: E402

# route -> (Settings.compute_dtype, tridiag_backend)
ROUTES = {
    "mixed": ("float32", "auto"),
    "float64": ("same", "auto"),
    "pallas": ("same", "pallas"),
    "spike": ("float32", "spike"),
}


def timed_ms(fn, reps=5):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
    return statistics.median(out)


def profile_route(ocp, X0, name):
    compute_dtype, backend = ROUTES[name]
    settings = Settings(compute_dtype=compute_dtype)
    cd = torch.float32 if compute_dtype == "float32" else None
    s0 = ocp_initial_state(ocp, settings, X0=X0)
    ocp_perform_iteration(ocp, settings, s0, tridiag_backend=backend)  # set-up on first use

    def derivatives():
        c, g, G, H = ocp.linearize(s0.X, s0.U, s0.lam, compute_dtype=cd)
        return c, g, G, H, ocp.constraint_vjp(s0.X, s0.U, s0.lam)

    c, g, G, H, Jt_lam = derivatives()
    _, _, _, r = _stationarity(ocp, s0.X, s0.U, g, Jt_lam, s0.lam)
    frozen = torch.zeros((ocp.T + 1, ocp.nz), dtype=torch.bool, device=H.device)
    frozen[0, : ocp.nx] = True
    frozen[ocp.T, ocp.nx :] = True

    def iteration():
        return ocp_perform_iteration(ocp, settings, s0, tridiag_backend=backend)

    parts = {
        "iteration": iteration,
        "derivatives": derivatives,
        "kkt_step": lambda: _structured_kkt_step(ocp, c, r, G, H, frozen, s0.reg,
                                                 tridiag_backend=backend),
    }
    print(f"route {name} (compute_dtype={compute_dtype!r}, tridiag_backend={backend!r}): "
          + ", ".join(f"{part} {timed_ms(fn):.3f} ms" for part, fn in parts.items())
          + " (eager, median of 5)", flush=True)

    graph = ocp_module.iteration_graph(ocp, settings, s0, tridiag_backend=backend)
    graph.load(s0, 50)
    graph.replay("iterate")
    parts = chip_smoke.state_parts(graph.bufs["state"], iteration())
    graph.load(s0, 50)
    replay_ms = chip_smoke.event_ms(lambda: graph.replay("iterate"))
    search_ms = chip_smoke.event_ms(lambda: graph.replay("search"))
    graph.load(s0, 50)
    rows = {"eager iteration": chip_smoke.traced(iteration),
            "graph replay": chip_smoke.traced(lambda: graph.replay("iterate"))}
    for label, (kernels, wall, busy) in rows.items():
        print(f"  {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}, {kernels} kernels", flush=True)
    trial_ms = search_ms / ocp_module.TRIAL_BLOCK
    print(f"  graphs: warm-up {graph.warmup_s:.3f} s, capture and instantiation "
          f"{graph.capture_s:.3f} s, memory reserved by the captures "
          f"{graph.reserved_bytes / 2**20:.1f} MiB; iteration replay {replay_ms:.3f} ms (CUDA "
          f"events, median of 5; idle share {1 - rows['graph replay'][2] / replay_ms:.3f} "
          f"against its device busy time), a block of {ocp_module.TRIAL_BLOCK} Armijo trials "
          f"{search_ms:.3f} ms: the {ocp_module.GRAPH_TRIALS} trials inside the iteration's "
          f"graph {ocp_module.GRAPH_TRIALS * trial_ms / replay_ms:.3f} of its replay; launches "
          f"an iteration replay {graph.launches['iterate']}; replay against the eager "
          f"iteration: " + ("bit for bit" if not parts else f"fields part {parts}"), flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    graph.load(s0, 50)
    with torch.profiler.profile(activities=acts) as prof:
        graph.replay("iterate")
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12), flush=True)
    return not parts


def main(names):
    if not torch.cuda.is_available():
        print("profile_torch_ocp: no CUDA device", file=sys.stderr)
        return 2
    unknown = [n for n in names if n not in ROUTES]
    if unknown:
        print(f"profile_torch_ocp: unknown routes {unknown}; choose from {list(ROUTES)}",
              file=sys.stderr)
        return 2
    ocp, X0 = chip_smoke.bench_problem()
    print(f"card: {chip_smoke.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"T={ocp.T} nx={ocp.nx} nu={ocp.nu}", flush=True)
    failed = []
    for name in names or list(ROUTES):
        try:
            if not profile_route(ocp, X0, name):
                failed.append(name)
        except Exception:  # report the route and go on with the others
            traceback.print_exc()
            failed.append(name)
    if failed:
        print(f"profile_torch_ocp: failed routes {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
