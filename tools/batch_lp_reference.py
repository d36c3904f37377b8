"""The batched SIMPLEX and PDLP Cauchy LP solves of ``chip_smoke.py`` phase
14 through the JAX package on the CPU, written as the phase's reference.

The runs are ``chip_smoke.LP_RUNS``: hs118 (AUTO resolves its Cauchy LP to
the simplex: n = 15, m = 17, 66 columns) at B = 1024 through
``sleqp_tpu.parallel.batch.batched_solve`` with ``Settings()`` and with
``Settings(compute_dtype="float32")`` and through ``batched_solve_mp``;
hs35 with ``lp_solver=PDLP, pdlp_tol=1e-10`` at B = 64.  The starts are
``chip_smoke.lp_starts`` (x0 + U(-0.3, 0.3) from ``default_rng(118)`` or
``default_rng(35)``, clipped to the box, lane 0 at x0), made with numpy
and stored beside the lanes, so that the card, which has no JAX, runs the
same rows.  Writes every lane's status, iterations, x and objective (and, of
``batched_solve_mp``, its phase-1 iterations) to
``artifacts/batch_lp_jax_cpu.json``.  ``--port`` also runs the same calls
through the port on the CPU and prints how its lanes compare (phase 14's
gate, ``chip_smoke.lp_gate``).

Usage, from the repository root (a few minutes, most of it JAX's
compilation and the B = 1024 solves; ``--port`` adds ~1-2 min on 8
threads):

    python3 tools/batch_lp_reference.py [--port] [--keep]

(``--keep`` reads the JSON already written instead of running JAX.)
"""

from __future__ import annotations

import argparse
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

import chip_smoke  # noqa: E402
from sleqp_tpu import Settings  # noqa: E402
from sleqp_tpu.harness.hs import get_problem  # noqa: E402
from sleqp_tpu.parallel import batch as jbatch  # noqa: E402
from sleqp_tpu.types import LPSolver  # noqa: E402

OUT = os.path.join(REPO, chip_smoke.BATCH_LP_REF)


def jax_settings(key):
    kw = dict(chip_smoke.LP_RUNS[key][2])
    if "lp_solver" in kw:
        kw["lp_solver"] = LPSolver[kw["lp_solver"]]
    return Settings(**kw)


def reference():
    out = dict(
        source="tools/batch_lp_reference.py: the JAX package on the CPU, jax " + jax.__version__,
        max_iterations=chip_smoke.LP_MAX_IT,
        starts_rule=(f"chip_smoke.lp_starts: x0 + U(-{chip_smoke.LP_SPREAD}, "
                     f"{chip_smoke.LP_SPREAD}) from default_rng(k), k = 118 or 35, clipped to "
                     f"the box, lane 0 at x0"),
        starts={}, runs={},
    )
    for key, (name, batch, kw, mp) in chip_smoke.LP_RUNS.items():
        problem = get_problem(name)[0]
        starts = chip_smoke.lp_starts(name, batch)
        out["starts"].setdefault(name, starts.tolist())
        assert np.array_equal(np.asarray(out["starts"][name])[:batch], starts)
        solve = jbatch.batched_solve_mp if mp else jbatch.batched_solve
        t = time.perf_counter()
        st = solve(problem, jax_settings(key), jnp.asarray(starts),
                   max_iterations=chip_smoke.LP_MAX_IT)
        status = np.asarray(st.status)
        seconds = time.perf_counter() - t
        out["runs"][key] = dict(
            problem=name, batch=batch, settings=kw, batched_solve_mp=mp,
            status=status.tolist(), iterations=np.asarray(st.iteration).tolist(),
            x=np.asarray(st.it.x).tolist(),
            objective=[float(v) for v in np.asarray(st.it.obj_val)])
        if mp:
            # phase 1 alone: no phase-2 iteration leaves each lane's count
            # at its phase-1 iterations
            st1 = solve(problem, jax_settings(key), jnp.asarray(starts),
                        max_iterations=chip_smoke.LP_MAX_IT, polish_iterations=0)
            out["runs"][key]["phase1_iterations"] = np.asarray(st1.iteration).tolist()
        print(f"JAX {key} B={batch}: solved {int((status == 2).sum())}/{batch}, iterations "
              f"{int(np.min(st.iteration))}-{int(np.max(st.iteration))}, {seconds:.1f} s "
              f"(compilation included)", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh)
    print("wrote", OUT)
    return out


def compare_port(ref):
    """The phase 14 LP calls through the port on the CPU, against ``ref``."""
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for key in chip_smoke.LP_RUNS:
        got = chip_smoke.lp_run(key, "cpu")
        report = chip_smoke.lp_gate(key, got, ref, "cpu")
        print(f"port {key} (CPU, {got['seconds']:.1f} s, {got['trips']} lockstep trips): "
              f"{report}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", action="store_true",
                        help="also run the port on the CPU against the reference")
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


if __name__ == "__main__":
    main()
