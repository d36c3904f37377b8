"""Command-line solver driver.

Port of ``sleqp_tpu/__main__.py``, the counterpart of the reference AMPL
driver (bindings/ampl/ampl_main.c: read a problem file, apply keyword
settings, solve, write the solution).  Problems are Python modules that
expose either ``problem, x0 = make()`` or module-level ``problem`` and
``x0``; settings come from ``key = value`` files (the settings.c:743-800
reader) or ``--set k=v``.  The solve runs on the CUDA card unless
``--device cpu`` is given; without a card it fails, it does not fall back
to the CPU.

    python -m sleqp_tpu_torch PROBLEM.py [--settings FILE] [--set k=v ...]
                              [--max-iterations N] [--time-limit S] [-v]
                              [--device cuda|cpu]
    python -m sleqp_tpu_torch --hs hs71            # a built-in suite problem
    python -m sleqp_tpu_torch --suite              # the HS sweep, CSV output
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import sys


def _load_problem(path: str):
    spec = importlib.util.spec_from_file_location("user_problem", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if hasattr(module, "make"):
        return module.make()
    return module.problem, module.x0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sleqp_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("problem", nargs="?", help="python problem file")
    parser.add_argument("--hs", help="built-in suite problem name (e.g. hs71)")
    parser.add_argument("--suite", action="store_true", help="run the HS sweep (CSV)")
    parser.add_argument(
        "--suite-set",
        choices=("hs", "medium", "large", "all"),
        default="hs",
        help="which problem set --suite runs: the 59 HS problems (default), the "
        "medium-scale (n ~ 100-1000) set, the large banded set (n >= 10^4, "
        "structured path), or everything",
    )
    parser.add_argument("--settings", help="key = value settings file")
    parser.add_argument("--set", action="append", default=[], metavar="K=V",
                        help="override one setting")
    parser.add_argument("--max-iterations", type=int, default=1000)
    parser.add_argument("--time-limit", type=float, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device to solve on (default: the CUDA card; 'cpu')")
    parser.add_argument("--json", action="store_true", help="JSON output")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    if args.verbose:
        logging.basicConfig(level=logging.INFO, format="%(message)s")
        logging.getLogger("sleqp_tpu_torch").setLevel(logging.INFO)

    from .device import resolve_device
    from .settings import Settings, read_settings_file, read_settings_string

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(f"{exc} (on the command line: --device cpu)")

    # settings stays None unless the user configured any: run_problem
    # applies its per-problem option table only for default settings
    settings = None
    if args.settings or args.set:
        settings = Settings()
        if args.settings:
            settings = read_settings_file(args.settings, settings)
        if args.set:
            settings = read_settings_string("\n".join(args.set), settings)

    if args.suite:
        from .harness import CSV_HEADER, run_suite

        names = None
        if args.suite_set != "hs":
            from .harness.driver import ALL_PROBLEMS
            from .harness.large import LARGE_PROBLEMS
            from .harness.medium import MEDIUM_PROBLEMS

            names = {"medium": MEDIUM_PROBLEMS, "large": LARGE_PROBLEMS,
                     "all": ALL_PROBLEMS}[args.suite_set]
        print(CSV_HEADER)
        result = run_suite(names, settings=settings, max_iterations=args.max_iterations,
                           verbose=True, device=device)
        print(f"# solved {result.solved}/{result.total} "
              f"({100.0 * result.solved_fraction:.1f}%)")
        return 0 if result.solved == result.total else 1

    if args.hs:
        from .harness.driver import get_problem

        problem, x0, _ = get_problem(args.hs, device=device)
    elif args.problem:
        problem, x0 = _load_problem(args.problem)
    else:
        parser.error("provide a problem file, --hs NAME, or --suite")

    from .solver import Solver
    from .types import Status

    solver = Solver(problem, x0, settings, device=device)
    status = solver.solve(max_iterations=args.max_iterations, time_limit=args.time_limit)

    feas, slack, stat = solver.residuals()
    if args.json:
        print(json.dumps({
            "status": status.name,
            "objective": solver.obj_val,
            "x": solver.solution.tolist(),
            "cons_dual": solver.cons_dual.tolist(),
            "vars_dual": solver.vars_dual.tolist(),
            "iterations": solver.iterations,
            "feas_res": feas,
            "slack_res": slack,
            "stat_res": stat,
            "seconds": solver.elapsed_seconds,
            "device": str(device),
        }))
    else:
        print(f"Status     : {status.name}")
        print(f"Objective  : {solver.obj_val:.10e}")
        print(f"Solution   : {solver.solution}")
        print(f"Iterations : {solver.iterations}")
        print(f"Residuals  : feas {feas:.3e}  slack {slack:.3e}  stat {stat:.3e}")
        print(f"Elapsed    : {solver.elapsed_seconds:.3f} s")
        print(f"Device     : {device}")
    return 0 if status == Status.OPTIMAL else 1


if __name__ == "__main__":
    sys.exit(main())
