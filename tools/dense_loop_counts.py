"""How many trips the dense iteration's loops make: the counts that size
``solve_jit``'s blocks (``problem_solver.GRAPH_TRIALS``, ``TRIAL_BLOCK``,
``KRYLOV_BLOCK``, ``GLTR_BLOCK``, ``cauchy.PIVOT_BLOCK``).

    python3 tools/dense_loop_counts.py [--phase 7] [--phase 8]

Runs chip_smoke.py's phase 7 problems (``solve_from`` on both routes) and
phase 8's ``Solver`` runs, eagerly on the CPU, and counts the trips of each
loop of every iteration: the Cauchy and trial linesearches' trials, GLTR's
Lanczos steps, Steihaug CG's and LSQR's steps, and the simplex's pivots
per pass (primal and dual).  Prints, for each loop, the number of loops,
the mean and largest trip count and the share of loops that end within
1, 2, 4, 5, 8, 14 and 19 trips.  One thread; ~2-4 min.
"""

import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sleqp_tpu_torch import Settings, Solver, initial_state, lanes, linesearch  # noqa: E402
from sleqp_tpu_torch import problem_solver  # noqa: E402
from sleqp_tpu_torch.ops import gltr, lsqr, simplex, tr_cg  # noqa: E402

# the loops by module, and by the body's maker where a module has two
MODULES = {linesearch: "", problem_solver: "", gltr: "GLTR", tr_cg: "Steihaug CG", lsqr: "LSQR",
           simplex: ""}
BODIES = {"cauchy_trial": "Cauchy linesearch", "trial_trial": "trial linesearch",
          "primal_body": "simplex primal pass", "dual_body": "simplex dual pass",
          "solve_from": "solve"}
EDGES = (1, 2, 4, 5, 8, 14, 19)


def counting(trips, label):
    """A ``lockstep`` that adds each loop's trip count to ``trips``, under
    ``label`` or the name of the function that made its body."""

    def lockstep(cond, body, state, max_trips=None, first=None):
        name = label or BODIES[body.__qualname__.split(".")[0]]
        count = [0]

        def counted(s, trip):
            count[0] += 1
            return body(s, trip)

        out = lanes.lockstep(cond, counted, state, max_trips, first)
        trips[name].append(count[0])
        return out

    return lockstep


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", type=int, action="append", default=None)
    args = parser.parse_args()
    phases = args.phase or [7, 8]
    torch.set_num_threads(1)
    trips = collections.defaultdict(list)
    for module, label in MODULES.items():
        module.lockstep = counting(trips, label)
    if 7 in phases:
        for name in cs.DENSE_REF:
            problem, x0 = cs.dense_problem(name, "cpu")
            for route in ("same", "float32"):
                settings = Settings(compute_dtype=route)
                problem_solver.solve_from(problem, settings,
                                          initial_state(problem, settings, x0, device="cpu"), 200)
    if 8 in phases:
        with cs.eager_loops():  # the eager loop, the restoration solves too
            for label, name, kw, scaling, *_rest in cs.SOLVER_RUNS:
                for route in _rest[1]:
                    problem, x0 = cs.solver_problem(name, "cpu")
                    Solver(problem, x0, Settings(compute_dtype=route, **kw), scaling=scaling,
                           device="cpu").solve(max_iterations=1000)
    trips.pop("solve", None)
    for name, counts in sorted(trips.items()):
        c = np.asarray(counts)
        shares = ", ".join(f"<= {e}: {np.mean(c <= e):.3f}" for e in EDGES)
        print(f"{name}: {len(c)} loops, mean {c.mean():.2f} trips, largest {c.max()}; {shares}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
