"""The batched HS71 solves of ``chip_smoke.py`` phase 14 through the JAX
package on the CPU, written as the phase's reference.

``bench.py``'s batched configuration (``bench.py:37-80``): HS71 from
``bench.py``'s starts (``default_rng(0)``, jitter +-0.05, clipped to
[1, 5]) at B = 512 and 1024, ``MAX_ITERATIONS = 60``, through
``sleqp_tpu.parallel.batch.batched_solve_mp`` with
``Settings(compute_dtype="float32")`` and ``batched_solve`` with
``Settings()``.  For ``batched_solve_mp`` the float32 phase is also run
alone (the same call that ``batched_solve_mp`` makes), so that each lane's
phase-1 status and iterations are known, and again from the starts moved
by 4 k float32 ulps for k = 0 .. PERTURBATIONS - 1
(``chip_smoke.batch_starts``), whose phase-1 OPTIMAL counts give the band
that phase 14 holds the port's count to (the float32 phase is chaotic near
HS71's solution: which lanes meet its coarse test is not reproducible).
Writes every lane's status, iterations and objective, and those counts, to
``artifacts/batch_hs71_jax_cpu.json``.  ``--port`` also runs the same
calls through the port on the CPU and prints how its lanes compare (the
gate of phase 14, on the CPU); ``--spread`` prints the port's phase-1
OPTIMAL counts over the same perturbed starts beside JAX's;
``--from-port K [K ...]`` runs JAX's phase 2 from the port's phase-1
states of those start sets at B = 1024 and prints how the two packages'
phase-2 iterations compare lane by lane; ``--steps N``
takes the first N lanes of B = 1024 through JAX's float32 phase 1 one
lane at a time, runs one port iteration from each of JAX's states, and
sorts the decisions that part from JAX's next state (step accepted or
rejected, working set, the step on the boundary) by the regime they
occur in.

Usage, from the repository root (~2 min, most of it JAX's compilation;
``--spread`` ~3 s a run of the port at B = 1024 on 8 threads):

    python3 tools/batch_reference.py [--port] [--spread] [--from-port K ...] [--steps N] [--keep]

(``--keep`` reads the JSON already written instead of running JAX.)
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
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from sleqp_tpu import Settings  # noqa: E402
from sleqp_tpu.parallel import batch as jbatch  # noqa: E402
from sleqp_tpu.types import f32_compute_scope  # noqa: E402

OUT = os.path.join(REPO, "artifacts", "batch_hs71_jax_cpu.json")
PERTURBATIONS = 24


def lanes(state):
    return dict(status=np.asarray(state.status).tolist(),
                iterations=np.asarray(state.iteration).tolist(),
                objective=[float(v) for v in np.asarray(state.it.obj_val)])


def jax_phase1(problem, settings, x0b, max_iterations):
    """batched_solve_mp's float32 phase, as batched_solve_mp calls it."""
    with f32_compute_scope():
        return jbatch.batched_solve(jbatch._f32_problem(problem), phase1_settings(settings),
                                    x0b.astype(jnp.float32), min(20, max_iterations))


def phase1_settings(settings, coarse_tol=2e-3):
    """batched_solve_mp's float32 settings (sleqp_tpu/parallel/batch.py)."""
    return dataclasses.replace(
        settings, dtype="float32", compute_dtype="same",
        feas_tol=max(settings.feas_tol, coarse_tol), stat_tol=max(settings.stat_tol, coarse_tol),
        slack_tol=max(settings.slack_tol, coarse_tol), perform_soc=False, lp_resolves=False)


def reference():
    import chip_smoke

    problem, x0 = bench._make_problem()
    out = dict(
        source="tools/batch_reference.py: the JAX package on the CPU, jax " + jax.__version__,
        problem="HS71 (bench.py:42-63), starts bench._x0_batch (default_rng(0), +-0.05)",
        max_iterations=bench.MAX_ITERATIONS,
        perturbation=(f"phase1_optimal_perturbed[k], phase2_warm_perturbed[k]: starts * (1 + 4 k "
                      f"eps_float32), clipped to [1, 5], k = 0..{PERTURBATIONS - 1} "
                      f"(chip_smoke.batch_starts)"),
        runs={},
    )
    for batch in bench.BATCH_SIZES:
        x0b = bench._x0_batch(x0, batch)
        for name, settings in (("mp", bench._accel_settings()), ("plain", Settings())):
            t = time.perf_counter()
            if name == "mp":
                st = jbatch.batched_solve_mp(problem, settings, x0b,
                                             max_iterations=bench.MAX_ITERATIONS)
                p1 = jax_phase1(problem, settings, x0b, bench.MAX_ITERATIONS)
            else:
                st = jbatch.batched_solve(problem, settings, x0b,
                                          max_iterations=bench.MAX_ITERATIONS)
            run = lanes(st)
            if name == "mp":
                run["phase1_status"] = np.asarray(p1.status).tolist()
                run["phase1_iterations"] = np.asarray(p1.iteration).tolist()
                assert np.array_equal(np.asarray(x0b), chip_smoke.batch_starts(batch))
                run["phase1_optimal_perturbed"], run["phase2_warm_perturbed"] = [], []
                for k in range(PERTURBATIONS):
                    starts = jnp.asarray(chip_smoke.batch_starts(batch, k))
                    q1 = jax_phase1(problem, settings, starts, bench.MAX_ITERATIONS)
                    q = jbatch.batched_solve_mp(problem, settings, starts,
                                                max_iterations=bench.MAX_ITERATIONS)
                    warm = np.asarray(q1.status) == 2
                    p2 = (np.asarray(q.iteration) - np.asarray(q1.iteration))[warm]
                    run["phase1_optimal_perturbed"].append(int(warm.sum()))
                    # [warm lanes, their mean phase-2 iterations, lanes taking more than 3]
                    run["phase2_warm_perturbed"].append(
                        [int(warm.sum()), float(p2.mean()), int((p2 > 3).sum())])
            seconds = time.perf_counter() - t
            out["runs"][f"{name}_{batch}"] = run
            solved = sum(s == 2 for s in run["status"])
            print(f"JAX {name} B={batch}: solved {solved}/{batch}, iterations "
                  f"{min(run['iterations'])}-{max(run['iterations'])}, {seconds:.1f} s "
                  f"(compilation included)", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh)
    print("wrote", OUT)
    return out


def compare_port(ref):
    """The phase 14 calls through the port on the CPU, against ``ref``."""
    import torch

    import chip_smoke

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for key, run in ref["runs"].items():
        name, batch = key.split("_")
        t = time.perf_counter()
        got = chip_smoke.batch_run(name, int(batch), "cpu")
        seconds = time.perf_counter() - t
        report = chip_smoke.batch_gate(key, got, run)
        print(f"port {key} (CPU, {seconds:.1f} s): {report}", flush=True)


def spread(ref):
    """The port's phase-1 OPTIMAL counts on the CPU over the perturbed
    starts, beside JAX's."""
    import torch

    import chip_smoke
    from sleqp_tpu_torch import Settings as TorchSettings
    from sleqp_tpu_torch.parallel import batch as pb

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    problem, _ = chip_smoke.dense_problem("hs71", "cpu")
    for key, run in ref["runs"].items():
        if "phase1_optimal_perturbed" not in run:
            continue
        batch = int(key.split("_")[1])
        jax_counts = run["phase1_optimal_perturbed"]
        port = [int((pb.mp_phase1(problem, TorchSettings(compute_dtype="float32"),
                                  chip_smoke.batch_starts(batch, k), 20).status == 2).sum())
                for k in range(len(jax_counts))]
        lo, hi = chip_smoke.phase1_band(jax_counts)
        print(f"{key} phase-1 OPTIMAL over {len(port)} perturbed starts: JAX {jax_counts} "
              f"(mean {np.mean(jax_counts):.1f}, sd {np.std(jax_counts, ddof=1):.1f}); "
              f"port {port} (mean {np.mean(port):.1f}, sd {np.std(port, ddof=1):.1f}); "
              f"band {lo:.1f}-{hi:.1f}", flush=True)


def _to_jax(template, port):
    """A JAX state with the port state's values (the dtypes of
    ``template``)."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _to_jax(getattr(template, f.name), getattr(port, f.name))
            for f in dataclasses.fields(template)})
    if isinstance(template, tuple):
        return type(template)(*(_to_jax(a, b) for a, b in zip(template, port)))
    return jnp.asarray(port.detach().cpu().numpy(), dtype=template.dtype)


def from_port(start_sets):
    """JAX's phase 2 (``_mp_phase2_fn``) from the port's phase-1 states of
    the perturbed start sets ``start_sets`` at B = 1024, against the
    port's phase 2: how many warm lanes take how many more phase-2
    iterations in the port, and the port's slowest warm lanes."""
    import collections

    import torch

    import chip_smoke
    from sleqp_tpu_torch import Settings as TorchSettings
    from sleqp_tpu_torch.parallel import batch as pb

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    problem, _ = bench._make_problem()
    settings = bench._accel_settings()
    phase2 = jbatch._mp_phase2_fn(problem, settings, 12)
    port, _ = chip_smoke.dense_problem("hs71", "cpu")
    port_settings = TorchSettings(compute_dtype="float32")
    diffs, slow = collections.Counter(), []
    for k in start_sets:
        starts = chip_smoke.batch_starts(1024, k)
        q1 = pb.mp_phase1(port, port_settings, starts, 20)
        q = pb.mp_phase2(port, port_settings, q1, starts, 12)
        s32 = _to_jax(jax_phase1(problem, settings, jnp.asarray(starts), 60), q1)
        out = phase2(s32.status == 2, s32, jnp.asarray(starts))
        warm = (q1.status == 2).numpy()
        p2_port = (q.iteration - q1.iteration).numpy()
        p2_jax = np.asarray(out.iteration) - np.asarray(s32.iteration)
        diffs.update((p2_port - p2_jax)[warm].tolist())
        slow += [(k, int(b), int(p2_port[b]), int(p2_jax[b]))
                 for b in np.flatnonzero(warm & (p2_port > 5))]
        assert np.array_equal(np.asarray(out.status), q.status.numpy()), k
    print(f"start sets {list(start_sets)}: port minus JAX phase-2 iterations over the warm "
          f"lanes, from the port's phase-1 states: {sorted(diffs.items())}; warm lanes taking "
          f"more than 5 in the port (set, lane, port, JAX): {slow}", flush=True)


def steps(lanes):
    """One port float32 iteration from each of JAX's single-lane phase-1
    states (the first ``lanes`` lanes of B = 1024) against JAX's next
    state: the decisions that part, by regime.  A decision parts "at the
    radius" when either package's step norm is within 1e-5 of the radius
    it was given (the boundary flag is then a rounding), "at the floor"
    when either package's model reduction is below 1e-4 (the float32
    rounding of the merit, ~17 eps_float32 = 2e-6, is then over 2% of
    it), "near-singular" when either package's least Rayleigh quotient
    of the projected Hessian is below 1e-2 of its largest, "other"
    otherwise."""
    import collections

    import torch

    import chip_smoke
    from sleqp_tpu import problem_solver as jps
    from sleqp_tpu_torch import Settings as TorchSettings
    from sleqp_tpu_torch.convert import tree_from_numpy, tree_to_numpy
    from sleqp_tpu_torch.parallel import batch as pb
    from sleqp_tpu_torch.problem_solver import SolverState, initial_state, perform_iteration

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    problem, _ = bench._make_problem()
    problem32 = jbatch._f32_problem(problem)
    settings32 = phase1_settings(bench._accel_settings())
    port32 = chip_smoke.dense_problem("hs71", "cpu")[0].astype(torch.float32)
    port_settings = pb.mp_settings(TorchSettings(compute_dtype="float32"))
    like = initial_state(port32, port_settings, torch.ones(4), device="cpu")
    flat = chip_smoke.flat_fields
    decisions = ("num_accepted", "it.var_states", "it.cons_states", "boundary_step")
    counts, regimes = collections.Counter(), collections.Counter()
    n_steps = 0
    with f32_compute_scope():
        step = jax.jit(lambda s: jps.perform_iteration(problem32, settings32, s))
        init = jax.jit(lambda x: jps.initial_state(problem32, settings32, x))
        for b, x0 in enumerate(chip_smoke.batch_starts(1024)[:lanes]):
            states = [init(jnp.asarray(x0, jnp.float32))]
            while int(states[-1].status) == 1 and int(states[-1].iteration) < 20:
                states.append(step(states[-1]))
            for before, after in zip(states[:-1], states[1:]):
                n_steps += 1
                src = tree_from_numpy(SolverState, jax.tree_util.tree_map(np.asarray, before),
                                      device="cpu")
                src = pb.tree_map(lambda a, r: a.to(r.dtype), src, like)
                got = flat(tree_to_numpy(perform_iteration(port32, port_settings, src)))
                ref, pre = flat(after), flat(before)
                parted = [k for k in decisions
                          if not np.array_equal(np.asarray(got[k], np.int64),
                                                np.asarray(ref[k], np.int64))]
                if not parted:
                    continue
                counts.update(parted)
                radius = float(pre["trust_radius"])
                if any(abs(float(d["measure.step_norm"]) - radius) <= 1e-5 * radius
                       for d in (got, ref)):
                    regimes["at the radius"] += 1
                elif min(abs(float(d["last_model_reduction"])) for d in (got, ref)) < 1e-4:
                    regimes["at the floor"] += 1
                elif any(abs(float(d["min_rayleigh"])) < 1e-2 * abs(float(d["max_rayleigh"]))
                         for d in (got, ref)):
                    regimes["near-singular"] += 1
                else:
                    regimes["other"] += 1
    print(f"{n_steps} float32 steps of {lanes} lanes: {sum(regimes.values())} part in a "
          f"decision ({dict(counts)}); by regime {dict(regimes)}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", action="store_true",
                        help="also run the port on the CPU against the reference")
    parser.add_argument("--spread", action="store_true",
                        help="the port's phase-1 OPTIMAL counts over the perturbed starts")
    parser.add_argument("--from-port", type=int, nargs="+", default=[], metavar="K",
                        help="JAX's phase 2 from the port's phase-1 states of start sets K")
    parser.add_argument("--steps", type=int, default=0, metavar="N",
                        help="one port iteration from JAX's float32 states of N lanes")
    parser.add_argument("--keep", action="store_true",
                        help="read the reference already written instead of running JAX")
    args = parser.parse_args()
    if args.keep:
        with open(OUT) as fh:
            ref = json.load(fh)
    else:
        ref = reference()
    if args.port:
        compare_port(ref)
    if args.spread:
        spread(ref)
    if args.from_port:
        from_port(args.from_port)
    if args.steps:
        steps(args.steps)


if __name__ == "__main__":
    main()
