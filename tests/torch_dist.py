"""Rank program of the sharded parity tests, and their launcher.

``run_ranks(cases, tmp, world)`` (tests/test_torch_schur.py,
tests/test_torch_ocp_sharded.py) writes the cases to a JSON spec in
``tmp`` and starts ``world`` ranks of this file as subprocesses
(``sleqp_tpu_torch.parallel.ranks.spawn``): gloo on the CPU with a
``file://`` rendezvous in ``tmp``, so no network port is opened (test
workers would share it), one torch thread a rank, a deadline on the ranks
and a timeout on every collective.  One group of ranks runs all the cases
of a test module.  Every rank runs every case and saves what it computed
to ``tmp/<case>.rank<r>.npz`` (``load``).

The sharded paths run the whole iteration replicated on every rank, so the
ranks' host reads must agree: the OCP cases gather a digest of the state
from every rank after each iteration and fail unless all ranks hold the
same bits.

Imports torch, numpy and the port only: the ranks run no JAX.

    python tests/torch_dist.py SPEC RANK WORLD
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sleqp_tpu_torch import (  # noqa: E402
    BlockStructuredProblem,
    Func,
    Problem,
    Settings,
    Status,
    ocp_initial_state,
    ocp_perform_iteration,
    ocp_solve,
)
from sleqp_tpu_torch.convert import state_to_numpy  # noqa: E402
from sleqp_tpu_torch.parallel import collectives, ranks  # noqa: E402
from sleqp_tpu_torch.parallel.batch import batched_solve, gather_shards, sharded_solve  # noqa: E402
from sleqp_tpu_torch.parallel.schur import sharded_schur_solve  # noqa: E402

DEADLINE_S = 120.0  # the ranks of one test module, start-up included
TIMEOUT_S = 60.0  # one collective


def run_ranks(cases, tmp, world=4):
    """Run ``cases`` (a list of dicts with "kind" and "name") on ``world``
    ranks; raises if a rank fails or is late."""
    spec = os.path.join(str(tmp), "spec.json")
    with open(spec, "w") as fh:
        json.dump({"init": "file://" + os.path.join(str(tmp), "rendezvous"), "out": str(tmp),
                   "cases": cases}, fh)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    ranks.spawn([[sys.executable, os.path.abspath(__file__), spec, str(r), str(world)]
                 for r in range(world)], DEADLINE_S, env=env)


def load(tmp, name, world=4):
    """Every rank's results of case ``name``, in rank order."""
    return [dict(np.load(os.path.join(str(tmp), f"{name}.rank{r}.npz"))) for r in range(world)]


# ---- problems (the port's callables) ---------------------------------------


def oscillator(consts, num_stages, **bounds):
    """tests/test_ocp.py's damped oscillator (constants from the spec)."""
    h = consts["H_STEP"]
    goal = torch.tensor(consts["X_GOAL"], dtype=torch.float64)

    def dynamics(x, u, t):
        pos, vel = x[0], x[1]
        acc = -torch.sin(pos) - 0.1 * vel + u[0]
        return torch.stack([pos + h * vel, vel + h * acc])

    def stage_cost(x, u, t):
        dx = x - goal.to(x)
        return 0.5 * (dx @ dx + 0.1 * (u @ u))

    def final_cost(x):
        dx = x - goal.to(x)
        return 5.0 * (dx @ dx)

    return BlockStructuredProblem(dynamics, stage_cost, num_stages, 2, 1, x0=consts["X_INIT"],
                                  final_cost=final_cost, device="cpu", **bounds)


def swing_up(num_stages):
    """The dry run's swing-up instance (``__graft_entry__.py``): bounded
    controls, a start far from the origin."""

    def dynamics(x, u, t):
        return torch.stack([x[0] + 0.1 * x[1], x[1] + 0.1 * (-torch.sin(x[0]) + u[0])])

    def cost(x, u, t):
        return 0.5 * (x @ x + 0.1 * (u @ u))

    return BlockStructuredProblem(dynamics, cost, num_stages, 2, 1, x0=[2.6, 1.5], u_lb=[-0.6],
                                  u_ub=[0.6], device="cpu")


def hs71():
    """Hock-Schittkowski 71 (tests/fixtures.py::hs71_problem)."""

    def obj(x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def cons(x):
        return torch.stack([x[0] * x[1] * x[2] * x[3], x @ x])

    return Problem(Func(obj, 4, cons=cons, num_cons=2), var_lb=1.0, var_ub=5.0,
                   general_lb=np.array([25.0, 40.0]), general_ub=np.array([np.inf, 40.0]),
                   device="cpu")


# ---- cases -----------------------------------------------------------------


def schur_case(case, meshes):
    data = np.load(case["inputs"])
    D, L, b = (torch.as_tensor(data[key]) for key in ("D", "L", "b"))
    collectives.CALLS["all_gather_rows"] = 0
    x = sharded_schur_solve(D, L, b, meshes["chunks"], tridiag_backend=case["backend"])
    return dict(x=x.numpy(), collectives=collectives.CALLS["all_gather_rows"])


def assert_ranks_agree(state, group):
    """Fail unless every rank holds the same bits of ``state``."""
    digest = torch.cat([torch.as_tensor(v, dtype=torch.float64).reshape(-1)
                        for v in state_to_numpy(state).values()])
    bits = collectives.all_gather_rows(digest, group).view(torch.int64)
    if not bool((bits == bits[:1]).all()):
        raise AssertionError(f"the ranks' states part at iteration {int(state.iteration)}")


def ocp_case(case, meshes):
    if case["problem"] == "swing_up":
        problem = swing_up(case["num_stages"])
    else:
        problem = oscillator(case["consts"], case["num_stages"], **case.get("bounds", {}))
    settings = Settings(compute_dtype=case["route"])
    mesh, backend, max_it = meshes["stages"], case["backend"], case["max_iterations"]
    group = mesh.get_group("stages")
    # the loop of ocp_solve_from, step by step, with the ranks held together
    state = ocp_initial_state(problem, settings, device="cpu")
    kkt_calls = 0
    while int(state.status) == Status.RUNNING and int(state.iteration) < max_it:
        before = collectives.CALLS["all_gather_rows"]
        state = ocp_perform_iteration(problem, settings, state, mesh=mesh, tridiag_backend=backend)
        kkt_calls += collectives.CALLS["all_gather_rows"] - before
        assert_ranks_agree(state, group)
    # the entry point, as a user calls it
    out = ocp_solve(problem, settings, max_iterations=max_it, mesh=mesh, tridiag_backend=backend,
                    device="cpu")
    assert_ranks_agree(out, group)
    alone = ocp_solve(problem, settings, max_iterations=max_it, tridiag_backend=backend,
                      device="cpu")
    result = {f"sharded.{k}": v for k, v in state_to_numpy(out).items()}
    result.update({f"stepped.{k}": v for k, v in state_to_numpy(state).items()})
    result.update({f"alone.{k}": v for k, v in state_to_numpy(alone).items()})
    # an iteration that steps solves one KKT system; the last one stops
    result["collectives_per_kkt"] = kkt_calls / max(int(state.iteration), 1)
    return result


def sharded_solve_case(case, meshes):
    problem, settings = hs71(), Settings()
    x0b = np.asarray(case["x0_batch"])
    mesh = meshes["batch"]
    out, solved = sharded_solve(problem, settings, x0b, mesh, max_iterations=case["max_iterations"],
                                device="cpu")
    whole = gather_shards(out, mesh)
    ref = batched_solve(problem, settings, x0b, case["max_iterations"], device="cpu")
    return dict(shard_x=out.it.x.numpy(), x=whole.it.x.numpy(), status=whole.status.numpy(),
                iteration=whole.iteration.numpy(), solved=int(solved),
                batched_x=ref.it.x.numpy(), batched_status=ref.status.numpy(),
                batched_iteration=ref.iteration.numpy())


CASES = {"schur": schur_case, "ocp": ocp_case, "sharded_solve": sharded_solve_case}


def main(spec_path, rank, world):
    torch.set_num_threads(1)
    with open(spec_path) as fh:
        spec = json.load(fh)
    ranks.init(spec["init"], rank, world, backend="gloo", timeout_s=TIMEOUT_S)
    try:
        meshes = {axis: ranks.device_mesh("cpu", axis) for axis in ("chunks", "stages", "batch")}
        for case in spec["cases"]:
            result = CASES[case["kind"]](case, meshes)
            np.savez(os.path.join(spec["out"], f"{case['name']}.rank{rank}.npz"), **result)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
