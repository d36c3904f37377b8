"""Which pieces of the dense SLP-EQP iteration a CUDA graph can capture,
and what a masked trip of each loop costs inside one.

    python3 tools/probe_dense_capture.py [hs71 chainineq200 ...]

On the card: each piece is run once eagerly on a side stream, captured
under ``torch.cuda.set_sync_debug_mode("error")`` and replayed; the replay
is held to the eager result and timed by CUDA events (median of 5).  One
JSON line a piece: its name, whether it captured (else the error), the
replay's ms and the largest difference from the eager run.  The loops run
masked under ``lanes.device_resident()``: GLTR and Steihaug CG their
``max_newton_iterations`` trips, the linesearches 201, the simplex eight
pivots (a block), so ms a trip = ms / trips.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from sleqp_tpu_torch import Settings, lanes  # noqa: E402
from sleqp_tpu_torch import cauchy, linesearch, newton, problem_solver as ps  # noqa: E402
from sleqp_tpu_torch.iterate import create_iterate  # noqa: E402
from sleqp_tpu_torch.merit import make_direction  # noqa: E402
from sleqp_tpu_torch.ops import kkt, lp_enum, simplex  # noqa: E402


def capture(fn):
    """(graph, its output tensors, the eager output) or raises."""
    dev = torch.device("cuda")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        eager = fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    held = {}
    with torch.cuda.graph(graph):
        torch.cuda.set_sync_debug_mode("error")
        try:
            held["out"] = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return graph, held["out"], eager


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in leaves(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for k in x.__dataclass_fields__ for t in leaves(getattr(x, k))]
    return []


def probe(name, fn):
    row = {"piece": name}
    try:
        graph, out, eager = capture(fn)
        graph.replay()
        torch.cuda.synchronize()
        diff = 0.0
        for a, b in zip(leaves(out), leaves(eager)):
            if a.is_floating_point():
                d = (a.double() - b.double()).abs()
                d = d[torch.isfinite(d)]
                diff = max(diff, float(d.max()) if d.numel() else 0.0)
            elif not torch.equal(a, b):
                diff = float("inf")
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        row.update(ok=True, ms=statistics.median(times), max_diff=diff)
    except Exception as exc:  # noqa: BLE001 - the probe reports every failure
        row.update(ok=False, error=f"{type(exc).__name__}: {str(exc)[:300]}")
    print(json.dumps(row), flush=True)


def pieces(name):
    problem, x0 = cs.dense_problem(name, "cuda")
    settings = Settings()
    state = ps.initial_state(problem, settings, x0, device="cuda")
    for _ in range(2):
        state = ps.perform_iteration(problem, settings, state)
    data, it = problem.data, state.it
    n, m = problem.num_variables, problem.num_cons
    mult = it.cons_dual
    probe(f"{name}: create_iterate", lambda: create_iterate(problem, it.x))
    d = torch.ones_like(it.x) * 1e-3
    probe(f"{name}: hess_prod (torch.func)", lambda: problem.hess_prod(it.x, d, mult))
    A, lb, ub = cauchy._lp_data(data, it, state.lp_trust_radius)
    c = cauchy._objective(it, state.penalty, False)
    B = A.index_select(1, state.basis.basis.long())
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    probe(f"{name}: simplex.qr_solve (linalg.qr, m = {m})", lambda: simplex.qr_solve(B, eye))
    if lp_enum.suitable(n + 3 * m, m):
        probe(f"{name}: lp_enum.solve_enum", lambda: lp_enum.solve_enum(A, c, lb, ub))
    aug = kkt.aug_jac_create(it.cons_jac, it.var_states, it.cons_states)
    probe(f"{name}: aug_jac_create (cholesky_ex)",
          lambda: kkt.aug_jac_create(it.cons_jac, it.var_states, it.cons_states))
    probe(f"{name}: aug_jac_create direct (linalg.qr mode r)",
          lambda: kkt.aug_jac_create(it.cons_jac, it.var_states, it.cons_states,
                                     method="direct"))
    probe(f"{name}: solve_lsq (cholesky_solve)", lambda: kkt.solve_lsq(aug, -it.obj_grad))
    ws = newton.compute_working_step(data, it, aug, state.trust_radius)

    def hp(v):
        return problem.hess_prod(it.x, v, mult)

    K = settings.max_newton_iterations
    for use_gltr in (True, False):
        def eqp(use_gltr=use_gltr):
            with lanes.device_resident():
                return newton.compute_newton_step(data, it, aug, ws, hp, state.penalty, K,
                                                  use_gltr=use_gltr)
        probe(f"{name}: {'GLTR' if use_gltr else 'Steihaug CG'}, {min(K, n + 1)} masked trips",
              eqp)
    lp = cres = None
    if m > 0:
        cres = cauchy.solve_cauchy_lp(data, it, state.lp_trust_radius, state.penalty,
                                      state.basis)
        lp = cres.lp_step
    else:
        lp = cauchy.solve_box_cauchy(data, it, state.lp_trust_radius).lp_step
    cdir = make_direction(it, lp, hp(lp))

    def cls():
        with lanes.device_resident():
            return linesearch.cauchy_linesearch(data, it, cdir, state.penalty,
                                                state.trust_radius, 0.5, 0.1, 1e-10)
    probe(f"{name}: cauchy_linesearch, 201 masked trials", cls)
    ndir = newton.compute_newton_step(data, it, aug, ws, hp, state.penalty, K).direction
    cdir2, _, cmerit = linesearch.cauchy_linesearch(data, it, cdir, state.penalty,
                                                    state.trust_radius, 0.5, 0.1, 1e-10)

    def tls():
        with lanes.device_resident():
            return linesearch.trial_linesearch(data, it, cdir2, cmerit, ndir, state.penalty,
                                               0.5, 0.1, 1e-6)
    probe(f"{name}: trial_linesearch, 201 masked trials", tls)
    probe(f"{name}: trial_linesearch_exact (sort)",
          lambda: linesearch.trial_linesearch_exact(data, it, cdir2, cmerit, ndir,
                                                    state.penalty, 1e-6))
    if m > 0 and not lp_enum.suitable(n + 3 * m, m):
        real_run = simplex._run

        def block_run(body, s, max_iterations, first):
            return lanes.lockstep(lambda s: (s["state"] < 0) & (s["it"] < max_iterations),
                                  body, s, max_trips=8)

        simplex._run = block_run
        try:
            basis, status = state.basis.basis, state.basis.status
            for tag, fn in (("primal", simplex.solve), ("dual", simplex.solve_dual)):
                def pivots(fn=fn):
                    with lanes.device_resident():
                        return fn(A, c, lb, ub, basis, status, 20 * (n + 3 * m) + 200)
                probe(f"{name}: simplex.{'solve' if tag == 'primal' else 'solve_dual'}, "
                      f"8 masked pivots", pivots)
        finally:
            simplex._run = real_run
    probe(f"{name}: torch.tensor on the card (expected to fail)",
          lambda: torch.tensor([1.0, 2.0], device="cuda") * 2)


def main(names):
    print(cs.card_line() if hasattr(cs, "card_line") else "", flush=True)
    torch.cuda.init()
    for name in names or ("hs71", "chainineq200", "boxqp1000"):
        pieces(name)


if __name__ == "__main__":
    main(sys.argv[1:])
