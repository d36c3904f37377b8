"""Where the port's solve on the card parts from the same solve on the CPU.

For each suite row (``sleqp_tpu_torch.harness``), on one route:

1. the port's own trajectory on the CPU and on the card (iterations,
   status);
2. one card iteration from every CPU state of the CPU's trajectory: how
   many take the CPU's decisions (step type, failed EQP, accepted counts,
   status), and the largest difference of x from the CPU's next state;
   the first iteration whose decisions differ is printed with the step
   type, the failed-EQP count and the reduction ratio of both.

No JAX: it runs on the card's machine.  Usage, from the repository root:

    python3 tools/card_parity.py --route float64 chainqp200
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from sleqp_tpu_torch import Settings  # noqa: E402
from sleqp_tpu_torch import problem_solver as tps  # noqa: E402
from sleqp_tpu_torch.convert import tree_from_numpy, tree_to_numpy  # noqa: E402
from sleqp_tpu_torch.harness.driver import get_problem  # noqa: E402
from sleqp_tpu_torch.problem_solver import SolverState  # noqa: E402

DECISIONS = ("last_step_type", "num_failed_eqp", "num_accepted", "num_soc_accepted", "status")


def decisions(state):
    return tuple(int(getattr(state, k)) for k in DECISIONS)


def trajectory(problem, settings, x0, device, limit):
    states = [tps.initial_state(problem, settings, x0, device=device)]
    while int(states[-1].status) == 1 and len(states) <= limit:
        states.append(tps.perform_iteration(problem, settings, states[-1]))
    return states


def check(route: str, name: str, card: str = "cuda", limit: int = 1000) -> None:
    settings = Settings(compute_dtype="float32") if route == "mixed" else Settings()
    cpu_problem, x0, _ = get_problem(name, "cpu")
    card_problem, _, _ = get_problem(name, card)
    cpu = trajectory(cpu_problem, settings, x0, "cpu", limit)
    own = trajectory(card_problem, settings, x0, card, limit)
    same, first, dx_max = 0, None, 0.0
    for k in range(len(cpu) - 1):
        moved = tree_from_numpy(SolverState, tree_to_numpy(cpu[k]), device=card)
        nxt = tps.perform_iteration(card_problem, settings, moved)
        dx_max = max(dx_max, float((nxt.it.x.cpu() - cpu[k + 1].it.x).abs().max()))
        if decisions(nxt) == decisions(cpu[k + 1]):
            same += 1
        elif first is None:
            first = (k, decisions(nxt), decisions(cpu[k + 1]),
                     float(nxt.last_reduction_ratio), float(cpu[k + 1].last_reduction_ratio))
    print(f"{name} ({route}): iterations CPU {len(cpu) - 1} (status {int(cpu[-1].status)}), "
          f"card {len(own) - 1} (status {int(own[-1].status)}); from the CPU's states the card "
          f"takes the CPU's decisions at {same} of {len(cpu) - 1}, max |x| difference "
          f"{dx_max:.3e}", flush=True)
    if first is not None:
        k, got, ref, r_got, r_ref = first
        print(f"  first differing decision at iteration {k}: card {dict(zip(DECISIONS, got))} "
              f"ratio {r_got!r}; CPU {dict(zip(DECISIONS, ref))} ratio {r_ref!r}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--route", choices=("float64", "mixed"), default="float64")
    ap.add_argument("--device", default="cuda", help="the card (cpu: rehearse without one)")
    ap.add_argument("names", nargs="+")
    args = ap.parse_args(argv)
    for name in args.names:
        check(args.route, name, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
