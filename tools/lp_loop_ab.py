"""Times the single-lane simplex and PDLP loops of two checkouts in one
process on one card: the change's ``ops/simplex.py`` and ``ops/pdlp.py``
against a parent's copies of the same files, loaded beside them (both
import only modules the two checkouts share).

The simplex LPs are those of ``chip_smoke.py`` phase 7's chainineq200
solve (the dense SLP-EQP solve from the problem's x0, each route): every
primal and dual pass the solve makes is recorded with its arguments, then
replayed through each side's ``solve``/``solve_dual``, sides alternating
(A, B, B, A, ...), each pass timed whole with the card synchronized.  The
PDLP LP is phase 9's.  Both sides must give the same pivots, PDHG
iterations and bases.

Usage, from the repository root on a machine with a card:

    python3 tools/lp_loop_ab.py [--parent .parent_checkout] [--rounds 4]

(``--parent`` holds a checkout of the parent commit, e.g. ``git archive``
unpacked into a directory that ``.gitignore`` lists; ``--device cpu``
rehearses the script without a card.)  Prints the card's name and power
limit, then for each set of LPs the median ms of a pass on each side, the
pivots (or PDHG iterations) of a pass, the time a pivot the change adds or
saves, and each side's kernels a pass (torch.profiler, on the card).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sleqp_tpu_torch import Settings, cauchy  # noqa: E402
from sleqp_tpu_torch.ops import pdlp, simplex  # noqa: E402


def load_parent(root: str, name: str):
    """The parent's ``sleqp_tpu_torch/<name>.py`` as a module of the
    change's package (its relative imports resolve there)."""
    path = os.path.join(root, "sleqp_tpu_torch", *name.split(".")) + ".py"
    modname = f"sleqp_tpu_torch.{name}_parent"
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[modname] = module
    spec.loader.exec_module(module)
    return module


DEVICE = "cuda"


def synchronize():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def recorded_lps(name: str, route: str):
    """Every primal and dual simplex pass of phase 7's solve of ``name`` on
    ``route``: (function name, args, keywords), ``first`` dropped."""
    calls = []
    real = {fn: getattr(simplex, fn) for fn in ("solve", "solve_dual")}

    def recorder(fn):
        def call(*args, **kwargs):
            kwargs.pop("first", None)
            calls.append((fn, args, dict(kwargs)))
            return real[fn](*args, **kwargs)
        return call

    for fn in real:
        setattr(simplex, fn, recorder(fn))
    try:
        problem, x0 = cs.dense_problem(name, DEVICE)
        cs.solve(problem, Settings(compute_dtype=route), x0, max_iterations=200, device=DEVICE)
    finally:
        for fn, f in real.items():
            setattr(simplex, fn, f)
    return calls


def timed_pass(fn):
    synchronize()
    t = time.perf_counter()
    out = fn()
    synchronize()
    return 1e3 * (time.perf_counter() - t), out


def kernels(fn):
    """The kernels ``fn()`` launches on the card (None on the CPU)."""
    if DEVICE != "cuda":
        return None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def compare(label, sides, run, rounds, work):
    """Alternate ``run(module)`` over ``sides`` (A, B, B, A per round);
    print the medians and the change per unit of ``work(out)``."""
    order = [0, 1, 1, 0] * rounds
    ms = {0: [], 1: []}
    outs = {}
    run(sides[0])  # warm-up of both sides' shapes
    run(sides[1])
    for k in order:
        t, outs[k] = timed_pass(lambda: run(sides[k]))
        ms[k].append(t)
    units = work(outs[0])
    cs.check(units == work(outs[1]), f"{label}: the two sides do different work")
    a, b = statistics.median(ms[0]), statistics.median(ms[1])
    print(f"{label}: {units} units a pass; kernels a pass parent {kernels(lambda: run(sides[0]))}, "
          f"change {kernels(lambda: run(sides[1]))}; parent {a:.2f} ms (runs "
          f"{', '.join(f'{v:.2f}' for v in ms[0])}), change {b:.2f} ms (runs "
          f"{', '.join(f'{v:.2f}' for v in ms[1])}); change - parent {b - a:+.2f} ms a pass, "
          f"{1e3 * (b - a) / max(units, 1):+.2f} us a unit ({100 * (b - a) / a:+.2f}%)",
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default=os.path.join(REPO, ".parent_checkout"))
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    global DEVICE
    DEVICE = args.device
    if DEVICE == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    simplex_sides = (load_parent(args.parent, "ops.simplex"), simplex)
    for name in ("chainineq200",):  # phase 7's only row on the simplex
        for route in ("same", "float32"):
            calls = recorded_lps(name, route)

            def run(module, calls=calls):
                return [getattr(module, fn)(*a, **kw) for fn, a, kw in calls]

            def pivots(outs):
                return sum(int(o.iterations) for o in outs)

            outs = [run(side) for side in simplex_sides]
            for p, c in zip(*outs):
                cs.check(torch.equal(p.basis, c.basis) and int(p.state) == int(c.state),
                         f"{name} {route}: the parent's and the change's bases differ")
            compare(f"{name} {route}: {len(calls)} simplex passes of phase 7's solve (pivots)",
                    simplex_sides, run, args.rounds, pivots)
    pdlp_sides = (load_parent(args.parent, "ops.pdlp"), pdlp)
    problem, it, radius, penalty = cs.pdlp_lp(DEVICE)
    A, lb, ub = cauchy._lp_data(problem.data, it, radius)
    c = cauchy._objective(it, penalty, False)

    def run_pdlp(module):
        return module.solve(A, c, lb, ub, max_iterations=20000, tol=Settings().pdlp_tol)

    compare("phase 9's PDLP LP (PDHG iterations)", pdlp_sides, run_pdlp, args.rounds,
            lambda out: int(out.iterations))


if __name__ == "__main__":
    main()
