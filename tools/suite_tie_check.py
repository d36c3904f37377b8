"""Tell a rounding tie from a fault on a suite row where the port's sweep
parts from the r5 CSV (tools/torch_suite.py).

For each row, on one route, with the JAX package as the reference (CPU):

1. one port iteration from every JAX iterate of JAX's solve
   (``problem_solver``): how many take JAX's decisions (step type, failed
   EQP, accepted counts, status), and, on the float64 route, how many
   match JAX's next state to 1e-9 (``torch_dense.iteration_mismatches``);
   where a decision differs, JAX run without jit from the same state
   tells whether the reference itself flips with the order XLA sums in;
2. one JAX iteration (jitted) from every state of the port's own solve:
   how many take the port's decisions.

A row whose port iterations take JAX's decisions from JAX's states, and
whose JAX iterations take the port's decisions from the port's states, is
a rounding tie: the two trajectories part where a decision sits within
rounding, and each package follows the other's path from the other's
states.  A fault shows as a decision the port takes differently from
JAX's own states.  Usage (from the repository root):

    python3 tools/suite_tie_check.py --route mixed extrosnb100 powellsg100
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)

import conftest  # noqa: E402,F401  (JAX on the CPU, float64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import sleqp_tpu.problem_solver as jps  # noqa: E402
from sleqp_tpu import Settings as JaxSettings  # noqa: E402
from sleqp_tpu.harness.driver import _PROBLEM_OPTIONS  # noqa: E402
from sleqp_tpu.harness.driver import get_problem as jax_problem  # noqa: E402
from sleqp_tpu.types import LPSolver as JaxLPSolver  # noqa: E402
from sleqp_tpu_torch import LPSolver, Settings  # noqa: E402
from sleqp_tpu_torch import problem_solver as tps  # noqa: E402
from sleqp_tpu_torch.harness.driver import get_problem as port_problem  # noqa: E402
from torch_dense import flat_jax, flat_port, iteration_mismatches, port_state  # noqa: E402

DECISIONS = ("last_step_type", "num_failed_eqp", "num_accepted", "num_soc_accepted", "status")


def _to_jax(template, port):
    """A JAX state with the port state's values."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _to_jax(getattr(template, f.name), getattr(port, f.name))
            for f in dataclasses.fields(template)})
    if isinstance(template, tuple):
        return type(template)(*(_to_jax(a, b) for a, b in zip(template, port)))
    return jnp.asarray(port.detach().cpu().numpy(), dtype=template.dtype)


def _settings(route, name):
    kw = {"compute_dtype": "float32"} if route == "mixed" else {}
    js, ts = JaxSettings(**kw), Settings(**kw)
    if "lp_solver" in _PROBLEM_OPTIONS.get(name, {}):
        js = js.replace(lp_solver=JaxLPSolver.SIMPLEX)
        ts = ts.replace(lp_solver=LPSolver.SIMPLEX)
    return js, ts


def check(route: str, name: str, limit: int = 1000) -> dict:
    if "scaling" in _PROBLEM_OPTIONS.get(name, {}):
        raise SystemExit(f"{name}: scaled rows are not handled")
    js, ts = _settings(route, name)
    jp, jx0, _ = jax_problem(name)
    tp, tx0, _ = port_problem(name, "cpu")
    step = jax.jit(lambda s: jps.perform_iteration(jp, js, s))

    def decisions(flat):
        return tuple(int(flat[k]) for k in DECISIONS)

    # 1. the port from JAX's states; where the decisions differ, JAX run
    # eagerly (no jit) from the same state: does the reference itself flip?
    states = [jps.initial_state(jp, js, jnp.asarray(jx0))]
    while int(states[-1].status) == 1 and len(states) <= limit:
        states.append(step(states[-1]))
    bad = iteration_mismatches(tp, ts, states) if route == "float64" else {}
    differ = eager_flips = 0
    for k in range(len(states) - 1):
        got = decisions(flat_port(tps.perform_iteration(tp, ts, port_state(states[k]))))
        if got != decisions(flat_jax(states[k + 1])):
            differ += 1
            with jax.disable_jit():
                eager = decisions(flat_jax(jps.perform_iteration(jp, js, states[k])))
            eager_flips += eager == got
    # 2. JAX from the port's states
    template = states[0]
    pstate = tps.initial_state(tp, ts, tx0, device="cpu")
    from_port = port_iters = 0
    while int(pstate.status) == 1 and port_iters < limit:
        nxt = tps.perform_iteration(tp, ts, pstate)
        from_port += decisions(flat_port(nxt)) == decisions(flat_jax(step(_to_jax(template,
                                                                                 pstate))))
        pstate, port_iters = nxt, port_iters + 1
    n = len(states) - 1
    return dict(name=name, route=route, jax_iterations=n, port_iterations=port_iters,
                port_from_jax=n - differ, eager_flips=eager_flips,
                exact_from_jax=n - len(bad) if route == "float64" else None,
                jax_from_port=from_port)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--route", choices=("float64", "mixed"), default="float64")
    ap.add_argument("--limit", type=int, default=1000)
    ap.add_argument("names", nargs="+")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for name in args.names:
        r = check(args.route, name, args.limit)
        exact = (f"; {r['exact_from_jax']} match JAX's next state to 1e-9"
                 if r["exact_from_jax"] is not None else "")
        differ = r["jax_iterations"] - r["port_from_jax"]
        print(f"{name} ({args.route}): problem_solver iterations JAX {r['jax_iterations']}, "
              f"port {r['port_iterations']}; the port takes JAX's decisions from "
              f"{r['port_from_jax']} of JAX's {r['jax_iterations']} states{exact}; of the "
              f"{differ} that differ, JAX run without jit takes the port's decision at "
              f"{r['eager_flips']}; JAX takes the port's decisions from {r['jax_from_port']} of "
              f"the port's {r['port_iterations']} states", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
