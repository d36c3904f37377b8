"""The batched quasi-Newton, dynamic and parametric solves of
``chip_smoke.py`` phase 14 through the JAX package on the CPU, written as
the phase's reference.

The runs are ``chip_smoke.ROUTE_RUNS`` at B = 1024: HS71 (``bench.py``'s
problem and starts) under DAMPED_BFGS and SR1 through
``sleqp_tpu.parallel.batch.batched_solve`` and under DAMPED_BFGS through
``batched_solve_mp``; COARSE on hs118 from ``chip_smoke.lp_starts``; FINE on
HS71; tests/test_dyn.py's two dynamic problems from
``chip_smoke.route_starts`` (x0 + U(-0.5, 0.5), lane 0 at x0).  The starts
are made with numpy and stored beside the lanes, so that the card, which
has no JAX, runs the same rows.  Writes every lane's status, iterations, x
and objective (of ``batched_solve_mp`` also its phase-1 status and
iterations, and the phase-1 OPTIMAL counts over ``PERTURBATIONS`` start
sets moved by 4 k float32 ulps, ``chip_smoke.batch_starts``) to
``artifacts/batch_routes_jax_cpu.json``.  ``--port`` also runs the same
calls through the port on the CPU and prints how its lanes compare
(phase 14's gate, ``chip_smoke.route_gate``).

Usage, from the repository root (~5 min, most of it JAX's B = 1024 solves;
``--port`` adds a few minutes on 8 threads):

    python3 tools/batch_routes_reference.py [--port] [--keep] [RUN ...]

(``--keep`` reads the JSON already written instead of running JAX; RUN
names limit ``--port`` to some of the runs.)

    python3 tools/batch_routes_reference.py --keep --from-states FILE

runs JAX's phase 2 of ``batched_solve_mp`` from the port's phase-1 states
of the ``hs71_dbfgs_mp`` run saved in FILE (``torch.save`` of
``dict(p1=..., out=...)``, ``chip_smoke.route_run``'s phase-1 and final
states moved to the CPU, e.g. from a run on the card) and prints where its
lanes end against the port's: a lane whose phase 1 parted from JAX's
then starts its polish where the port's did.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from sleqp_tpu import Settings  # noqa: E402
from sleqp_tpu.harness.hs import get_problem  # noqa: E402
from sleqp_tpu.parallel import batch as jbatch  # noqa: E402
from sleqp_tpu.types import HessEval, ParametricCauchy, f32_compute_scope  # noqa: E402
from test_dyn import _dyn_constrained, _dyn_rosenbrock  # noqa: E402

OUT = os.path.join(REPO, chip_smoke.BATCH_ROUTES_REF)
PERTURBATIONS = 8


def jax_settings(key):
    enums = {"hess_eval": HessEval, "parametric_cauchy": ParametricCauchy}
    return Settings(**{k: enums[k][v] for k, v in chip_smoke.ROUTE_RUNS[key][1].items()})


def jax_problem(name):
    if name == "hs71":
        return bench._make_problem()[0]
    if name == "dyn_rosenbrock":
        return _dyn_rosenbrock()[0]
    if name == "dyn_constrained":
        return _dyn_constrained()[0]
    return get_problem(name)[0]


def jax_phase1(problem, settings, x0b, coarse_tol=2e-3):
    """batched_solve_mp's float32 phase, as batched_solve_mp calls it."""
    settings32 = dataclasses.replace(
        settings, dtype="float32", compute_dtype="same",
        feas_tol=max(settings.feas_tol, coarse_tol), stat_tol=max(settings.stat_tol, coarse_tol),
        slack_tol=max(settings.slack_tol, coarse_tol), perform_soc=False, lp_resolves=False)
    with f32_compute_scope():
        return jbatch.batched_solve(jbatch._f32_problem(problem), settings32,
                                    jnp.asarray(x0b).astype(jnp.float32), 20)


def reference():
    out = dict(
        source="tools/batch_routes_reference.py: the JAX package on the CPU, jax "
               + jax.__version__,
        batch=chip_smoke.ROUTES_BATCH,
        starts_rule=("chip_smoke.route_starts: HS71 bench._x0_batch; hs118 chip_smoke.lp_starts; "
                     f"the dynamic problems x0 + U(-{chip_smoke.DYN_SPREAD}, "
                     f"{chip_smoke.DYN_SPREAD}) from default_rng({chip_smoke.DYN_SEEDS}), "
                     "lane 0 at x0"),
        perturbation=(f"phase1_optimal_perturbed[k]: starts * (1 + 4 k eps_float32), clipped to "
                      f"[1, 5], k = 0..{PERTURBATIONS - 1} (chip_smoke.batch_starts)"),
        starts={}, runs={},
    )
    batch = chip_smoke.ROUTES_BATCH
    for key, (name, kw, mp, max_it) in chip_smoke.ROUTE_RUNS.items():
        problem = jax_problem(name)
        starts = chip_smoke.route_starts(name, batch)
        out["starts"].setdefault(name, starts.tolist())
        settings = jax_settings(key)
        solve = jbatch.batched_solve_mp if mp else jbatch.batched_solve
        t = time.perf_counter()
        st = solve(problem, settings, jnp.asarray(starts), max_iterations=max_it)
        status = np.asarray(st.status)
        seconds = time.perf_counter() - t
        run = dict(problem=name, settings=kw, batched_solve_mp=mp, max_iterations=max_it,
                   status=status.tolist(), iterations=np.asarray(st.iteration).tolist(),
                   x=np.asarray(st.it.x).tolist(),
                   objective=[float(v) for v in np.asarray(st.it.obj_val)])
        if mp:
            p1 = jax_phase1(problem, settings, starts)
            run["phase1_status"] = np.asarray(p1.status).tolist()
            run["phase1_iterations"] = np.asarray(p1.iteration).tolist()
            run["phase1_optimal_perturbed"] = [
                int((np.asarray(jax_phase1(problem, settings,
                                           chip_smoke.batch_starts(batch, k)).status) == 2).sum())
                for k in range(PERTURBATIONS)]
        out["runs"][key] = run
        print(f"JAX {key} B={batch}: solved {int((status == 2).sum())}/{batch}, iterations "
              f"{int(np.min(st.iteration))}-{int(np.max(st.iteration))}, {seconds:.1f} s "
              f"(compilation included)", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh)
    print("wrote", OUT)
    return out


def compare_port(ref, keys):
    """The phase 14 route calls through the port on the CPU, against ``ref``."""
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for key in keys:
        got = chip_smoke.route_run(key, "cpu")
        if chip_smoke.ROUTE_RUNS[key][2]:
            got["p1_counts"] = chip_smoke.mp_phase1_counts(key, "cpu", got["p1"])
        report = chip_smoke.route_gate(key, got, ref, "cpu")
        print(f"port {key} (CPU, {got['seconds']:.1f} s, {got['trips']} lockstep trips): "
              f"{report}", flush=True)


def from_states(path):
    """JAX's phase 2 from the port's phase-1 states in ``path``, against
    the port's final states."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from batch_reference import _to_jax

    saved = torch.load(path, weights_only=False)
    p1, out = saved["p1"], saved["out"]
    starts = chip_smoke.route_starts("hs71", chip_smoke.ROUTES_BATCH)
    problem, settings = jax_problem("hs71"), jax_settings("hs71_dbfgs_mp")
    s32 = _to_jax(jax_phase1(problem, settings, starts), p1)
    got = jbatch._mp_phase2_fn(problem, settings, chip_smoke.MP_POLISH)(
        s32.status == 2, s32, jnp.asarray(starts))
    status, iters = np.asarray(got.status), np.asarray(got.iteration)
    port_status, port_iters = out.status.numpy(), out.iteration.numpy()
    odd = np.flatnonzero(port_status != 2)
    print(f"JAX's phase 2 from the port's phase-1 states: statuses "
          f"{dict(zip(*np.unique(status, return_counts=True)))} (the port's "
          f"{dict(zip(*np.unique(port_status, return_counts=True)))}), the same status on "
          f"{int((status == port_status).sum())} lanes and the same iterations on "
          f"{int((iters == port_iters).sum())}; lanes the port ends otherwise than OPTIMAL "
          f"(lane, port status and iterations, JAX's): "
          f"{[(int(b), int(port_status[b]), int(port_iters[b]), int(status[b]), int(iters[b])) for b in odd]}",
          flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", action="store_true",
                        help="also run the port on the CPU against the reference")
    parser.add_argument("--keep", action="store_true",
                        help="read the reference already written instead of running JAX")
    parser.add_argument("--from-states", metavar="FILE",
                        help="JAX's phase 2 from the port's saved phase-1 states")
    parser.add_argument("runs", nargs="*", help="the runs --port compares (default: all)")
    args = parser.parse_args()
    if args.keep:
        with open(OUT) as fh:
            ref = json.load(fh)
    else:
        ref = reference()
    if args.port:
        compare_port(ref, args.runs or list(chip_smoke.ROUTE_RUNS))
    if args.from_states:
        from_states(args.from_states)


if __name__ == "__main__":
    main()
