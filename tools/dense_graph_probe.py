"""Phases 7-11 of chip_smoke.py on the card, and phase 11 once more with
``Solver`` stepping in its eager loop, timed each.

    python3 tools/dense_graph_probe.py [7] [8] [9] [10] [11] [--rows N]

Phase 7 runs the dense problems through ``solve_jit`` (CUDA graphs) held
to ``solve_from`` on the card; phase 8 the ``Solver`` runs the same way;
phases 9 and 10 the PDLP LP and ``Solver`` on PDLP and on dynamic
functions, as ``chip_smoke.py`` runs them;
phase 11 the suite sweep on both routes, through ``solve_jit`` (what
``Solver`` runs by default: each row's problem captures its programs on its
first solve) and then through the eager loop (``chip_smoke.eager_loops``),
with the seconds of each and the device memory the process holds after
each sweep and after a garbage collection (the rows' captured graphs are
freed with their problems).  ``--rows N`` sweeps the first N rows of each
route only.  ``--scan`` first solves every suite row on both routes
through ``solve_jit`` for two iterations (captures of every program that
runs a problem's callables) and prints the rows whose capture fails.
Needs a CUDA device; prints the card's name and power limit.
"""

import argparse
import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def memory(tag, log):
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    gc.collect()
    torch.cuda.empty_cache()
    log(11, f"{tag}: device memory allocated {allocated / 2**20:.1f} MiB, reserved "
            f"{reserved / 2**20:.1f} MiB; after a garbage collection "
            f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB, reserved "
            f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB")


def scan(log):
    """Two iterations of every suite row on both routes through Solver
    (solve_jit); the rows whose capture fails."""
    from sleqp_tpu_torch import Settings
    from sleqp_tpu_torch.harness.driver import ALL_PROBLEMS, BandedProblem, get_problem

    failed = []
    for route in ("same", "float32"):
        for name in sorted(ALL_PROBLEMS):
            problem, x0, _ = get_problem(name, "cuda")
            if isinstance(problem, BandedProblem):
                continue
            try:
                cs.Solver(problem, x0, Settings(compute_dtype=route), device="cuda").solve(
                    max_iterations=2)
            except RuntimeError as exc:
                failed.append((name, route))
                log(11, f"capture scan: {name} ({route}) failed: {str(exc)[-300:]}")
    log(11, f"capture scan: {len(failed)} of the rows failed: {failed}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("phases", nargs="*", type=int, default=[7, 8, 9, 10, 11])
    parser.add_argument("--rows", type=int, default=None)
    parser.add_argument("--scan", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("dense_graph_probe: no CUDA device", file=sys.stderr)
        return 2
    log = cs.Log()
    log(0, f"card '{cs.card_line()}', torch {torch.__version__}")
    if args.scan:
        scan(log)
    for phase, run in ((7, cs.dense_phase), (8, cs.solver_phase), (9, cs.pdlp_phase),
                       (10, cs.dyn_phase)):
        if phase in args.phases:
            t = time.perf_counter()
            cs.clear_counts()
            run(log)
            log(phase, f"phase {phase} took {time.perf_counter() - t:.1f} s; launches of B1-B6 "
                       f"{cs.read_counts()}")
    if 11 in args.phases:
        names = None
        if args.rows:
            tool = cs.load_suite_tool()
            names = [n for n in tool.read_rows(tool.ORACLES["float64"]) if n in cs.ALL_PROBLEMS]
            names = names[:args.rows]
        memory("before the sweeps", log)
        for tag in ("solve_jit", "eager loop"):
            t = time.perf_counter()
            if tag == "solve_jit":
                cs.suite_phase(log, names=names)
            else:
                with cs.eager_loops():
                    cs.suite_phase(log, names=names)
            log(11, f"phase 11 through {tag} took {time.perf_counter() - t:.1f} s")
            memory(f"after the sweep through {tag}", log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
