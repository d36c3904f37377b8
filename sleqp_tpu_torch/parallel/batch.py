"""Batched dense solves: B instances of one problem in lockstep lanes.

Port of ``sleqp_tpu/parallel/batch.py`` (the reference's replacement for
process-level parallelism, src/test/thread_test.c and
sleqp_cutest_main.c:186-229): a batch of instances of one problem shape is
solved together, ``vmap`` of ``lax.while_loop`` in the reference.

Here the single-lane iteration (``problem_solver.perform_iteration``) runs
under ``torch.func.vmap``: every lane does the single lane's arithmetic,
and the user's callables, written for one x, are vmapped with it.  The
data-dependent loops and branches of the iteration read their flags
through ``lanes.py``: one host read a loop trip or a branch for all lanes,
never one per lane, so the host reads of an iteration do not grow with B.
A lane that has stopped is frozen by a select while the others go on, as
under ``vmap`` of ``while_loop``.

Every route of the single-lane solve batches: the dense iteration with
exact Hessians, limited-memory quasi-Newton Hessians (DAMPED_BFGS,
SIMPLE_BFGS and SR1, block-structured by a ``hess_struct`` too) or a
dynamic (inexact) function's (``DynFunc``); the Cauchy LP by every backend
(vertex enumeration, the bounded simplex with its dual warm start, reduced
re-solve and float64 polish, or PDLP; the box step when there are no
constraints), with or without the parametric sweep of its radius; and the
GLTR, CG or Gauss-Newton/LSQR Newton step (an ``LSQFunc``), on both
``compute_dtype`` routes; with ``restoration=True`` the lanes that end
LOCALLY_INFEASIBLE get one restoration attempt
(``restoration.solve_with_restoration``).  The simplex reads one flag a
pivot, PDLP one a block of PDHG iterations and the parametric sweep one a
re-solve, for all lanes; the pair push of a quasi-Newton Hessian and the
re-evaluation of a dynamic function read one flag an iteration.

``sharded_solve`` splits a batch over the ranks of a mesh axis
(``parallel/ranks.py``): each rank solves its shard as above, and one
``psum`` counts the OPTIMAL lanes of all ranks (``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import resolve_device
from ..dyn import DynFunc
from ..lanes import tree_leaves, tree_map, tree_unflatten, tree_where, vmap_lanes
from ..problem import Problem
from ..problem_solver import SolverState, initial_state, perform_iteration, solve_from
from ..settings import Settings
from ..restoration import make_restoration_problem, solve_with_restoration
from ..types import Status
from .collectives import all_gather_rows, axis_group, psum

Tensor = torch.Tensor

MIN_RADIUS = 1e-4  # phase 2 of batched_solve_mp never inherits a smaller radius


# ---- states with a lane dimension ------------------------------------------


def lane(tree: Any, index: Any) -> Any:
    """Lane ``index`` (an int or a 0-d tensor, read by no host) of a
    batched state."""
    idx = torch.as_tensor(index).reshape(1)
    return tree_map(lambda a: a.index_select(0, idx.to(a.device))[0], tree)


def stack_lanes(trees) -> Any:
    """Batched states joined along their lanes into one."""
    return tree_map(lambda *ts: torch.cat(ts, dim=0), *trees)


# ---- the entry points ------------------------------------------------------


def _lanes_x0(problem: Problem, x0_batch: Any) -> Tensor:
    x0 = torch.as_tensor(x0_batch, dtype=problem.dtype, device=problem.device)
    if x0.ndim != 2 or x0.shape[1] != problem.num_variables:
        raise ValueError(f"x0_batch must be (B, {problem.num_variables}), "
                         f"got {tuple(x0.shape)}")
    return x0


def batched_initial_state(problem: Problem, settings: Settings, x0_batch: Any,
                          device: Any = None) -> SolverState:
    """``initial_state`` on a (B, n) batch of starting points: every tensor
    of the state has the lane dimension first.  ``device=None`` means
    CUDA."""
    problem = problem.to(resolve_device(device))
    x0 = _lanes_x0(problem, x0_batch)
    return vmap_lanes(lambda x: initial_state(problem, settings, x, device=problem.device), x0)


def batched_step(problem: Problem, settings: Settings, states: SolverState,
                 device: Any = None) -> SolverState:
    """One synchronized iteration on every lane of ``states`` (for
    benchmarking and parity), stopped lanes included, as the reference's
    ``vmap`` of ``perform_iteration``."""
    problem = problem.to(resolve_device(device))
    return vmap_lanes(lambda s: perform_iteration(problem, settings, s), states)


def _lane_solver(problem: Problem, settings: Settings, max_iterations: int,
                 restoration: bool):
    """The single-lane solve that ``vmap`` runs on every lane: with
    ``restoration`` (and constraints), one restoration attempt for a lane
    that ends LOCALLY_INFEASIBLE."""
    if restoration and problem.num_cons > 0:
        rest_problem = make_restoration_problem(problem)
        return lambda s: solve_with_restoration(problem, settings, s, max_iterations,
                                                rest_problem)
    return lambda s: solve_from(problem, settings, s, max_iterations)


def batched_solve(problem: Problem, settings: Settings, x0_batch: Any,
                  max_iterations: int = 1000, restoration: bool = False,
                  device: Any = None) -> SolverState:
    """Solve B instances of one problem from the rows of ``x0_batch``.
    Each lane iterates until it stops; all lanes advance together, a
    finished lane frozen while the others go on (the reference's ``vmap``
    of ``while_loop``).  With ``restoration``, the lanes that end
    LOCALLY_INFEASIBLE get one restoration attempt and resume; when no
    lane does, the result equals ``restoration=False`` bit for bit, at the
    cost of one read.  ``device=None`` means CUDA."""
    problem = problem.to(resolve_device(device))
    states = batched_initial_state(problem, settings, x0_batch, device=problem.device)
    return vmap_lanes(_lane_solver(problem, settings, max_iterations, restoration), states)


def mp_settings(settings: Settings, coarse_tol: float = 2e-3) -> Settings:
    """Phase 1's settings in ``batched_solve_mp``: float32 throughout, the
    tolerances no tighter than ``coarse_tol``, no second-order correction
    and no reduced LP re-solve (the reference strips them: under ``vmap``
    both sides of a select are paid)."""
    return dataclasses.replace(
        settings,
        dtype="float32",
        compute_dtype="same",
        feas_tol=max(settings.feas_tol, coarse_tol),
        stat_tol=max(settings.stat_tol, coarse_tol),
        slack_tol=max(settings.slack_tol, coarse_tol),
        perform_soc=False,
        lp_resolves=False,
    )


def mp_phase1(problem: Problem, settings: Settings, x0_batch: Any, iterations: int,
              coarse_tol: float = 2e-3) -> SolverState:
    """Phase 1 of ``batched_solve_mp``: the float32 clone of ``problem``
    (``Problem.astype``; the callables follow their arguments' dtype)
    solved under ``mp_settings`` for at most ``iterations``."""
    problem32 = problem.astype(torch.float32)
    x0 = torch.as_tensor(x0_batch, device=problem.device).to(torch.float32)
    return batched_solve(problem32, mp_settings(settings, coarse_tol), x0, iterations,
                         device=problem.device)


def mp_phase2(problem: Problem, settings: Settings, st32: SolverState, x0_batch: Any,
              iterations: int) -> SolverState:
    """Phase 2 of ``batched_solve_mp``: each lane solved in the problem's
    dtype for at most ``iterations``, warm-started from its phase-1
    iterate, penalty, radii (at least ``MIN_RADIUS``) and LP basis where
    phase 1 ended OPTIMAL, else from its x0; ``iteration`` counts both
    phases."""
    dtype = problem.dtype
    x0 = _lanes_x0(problem, x0_batch)
    ok = st32.status == int(Status.OPTIMAL)

    def warm_one(ok, s32, x0):
        x = problem.clip_to_bounds(s32.it.x.to(dtype))
        fresh = initial_state(problem, settings, torch.where(ok, x, x0), device=problem.device)
        warm = dataclasses.replace(
            fresh,
            penalty=s32.penalty.to(dtype),
            trust_radius=torch.clamp(s32.trust_radius.to(dtype), min=MIN_RADIUS),
            lp_trust_radius=torch.clamp(s32.lp_trust_radius.to(dtype), min=MIN_RADIUS),
            basis=s32.basis,  # integer statuses: dtype-independent
        )
        out = solve_from(problem, settings, tree_where(ok, warm, fresh), iterations)
        return dataclasses.replace(out, iteration=out.iteration + s32.iteration)

    return vmap_lanes(warm_one, ok, st32, x0)


def batched_solve_mp(problem: Problem, settings: Settings, x0_batch: Any,
                     max_iterations: int = 1000, coarse_tol: float = 2e-3,
                     coarse_iterations: int = 20, polish_iterations: int = 12,
                     device: Any = None) -> SolverState:
    """Two-phase mixed-precision batched solve (the reference's fast path
    for BASELINE config 2): phase 1 (``mp_phase1``) solves every lane in
    float32 to ``coarse_tol`` for at most ``coarse_iterations``; phase 2
    (``mp_phase2``) re-solves in the problem's dtype for at most
    ``polish_iterations``, so that every certified quantity (residuals,
    duals, the optimality test) comes from the problem's dtype.  A float32
    problem has no second phase, and a dynamic function certifies against
    error bounds that float32 cannot hold: both go to ``batched_solve``.
    ``device=None`` means CUDA."""
    problem = problem.to(resolve_device(device))
    if isinstance(problem.func, DynFunc) or problem.dtype == torch.float32:
        return batched_solve(problem, settings, x0_batch, max_iterations, device=problem.device)
    x0 = _lanes_x0(problem, x0_batch)
    st32 = mp_phase1(problem, settings, x0, min(coarse_iterations, max_iterations), coarse_tol)
    return mp_phase2(problem, settings, st32, x0, min(polish_iterations, max_iterations))


def batched_solve_chunked(problem: Problem, settings: Settings, x0_batch: Any,
                          max_iterations: int = 1000, chunk_size: int = 1024, mp: bool = False,
                          device: Any = None) -> SolverState:
    """Solve a batch of any size in chunks of at most ``chunk_size`` lanes,
    one after another; the last chunk is padded with copies of the last
    lane to the same size, and the padded lanes are dropped.  ``mp=True``
    solves each chunk by ``batched_solve_mp``.  ``device=None`` means
    CUDA."""
    problem = problem.to(resolve_device(device))
    x0 = _lanes_x0(problem, x0_batch)
    solve = batched_solve_mp if mp else batched_solve
    B = x0.shape[0]
    if B <= chunk_size:
        return solve(problem, settings, x0, max_iterations, device=problem.device)
    pad = (-B) % chunk_size
    if pad:
        x0 = torch.cat([x0, x0[-1:].expand(pad, -1)], dim=0)
    outs = [solve(problem, settings, x0[i : i + chunk_size], max_iterations,
                  device=problem.device)
            for i in range(0, B + pad, chunk_size)]
    return tree_map(lambda a: a[:B], stack_lanes(outs))


def best_lane(out: SolverState) -> Tensor:
    """The index of the best lane (a 0-d tensor, not read): the lowest
    objective among OPTIMAL lanes, else the lowest ``feas_res``."""
    ok = out.status == int(Status.OPTIMAL)
    best_ok = torch.argmin(torch.where(ok, out.it.obj_val, torch.inf))
    return torch.where(ok.any(), best_ok, torch.argmin(out.feas_res))


def multistart_from(problem: Problem, settings: Settings, starts: Any,
                    max_iterations: int = 1000, device: Any = None) -> SolverState:
    """``batched_solve`` from the rows of ``starts``, and the state of the
    best lane (``best_lane``)."""
    problem = problem.to(resolve_device(device))
    out = batched_solve(problem, settings, starts, max_iterations, device=problem.device)
    return lane(out, best_lane(out))


def multistart_starts(problem: Problem, x0: Any, num_starts: int = 8, radius: float = 0.5,
                      seed: int = 0) -> Tensor:
    """``x0`` and ``num_starts - 1`` copies jittered uniformly within
    ``radius`` per coordinate, clipped to the variable box.  The jitter is
    drawn on the CPU by a ``torch.Generator`` seeded with ``seed`` (the
    reference's threefry draw needs JAX), so the starts are the same on
    every device."""
    x0 = torch.as_tensor(x0, dtype=problem.dtype, device=problem.device)
    gen = torch.Generator().manual_seed(int(seed))
    unit = torch.rand((num_starts, problem.num_variables), generator=gen, dtype=problem.dtype)
    jitter = (radius * (2.0 * unit - 1.0)).to(problem.device)
    starts = torch.cat([x0[None, :], x0[None, :] + jitter[1:]], dim=0)
    return problem.clip_to_bounds(starts)


def multistart_solve(problem: Problem, settings: Settings, x0: Any, num_starts: int = 8,
                     radius: float = 0.5, seed: int = 0, max_iterations: int = 1000,
                     device: Any = None) -> SolverState:
    """Batched multistart: solve from ``num_starts`` jittered copies of
    ``x0`` (``multistart_starts``) in one batch and return the best lane,
    the lowest objective among OPTIMAL lanes or the lowest violation when
    none converged.  ``device=None`` means CUDA."""
    problem = problem.to(resolve_device(device))
    starts = multistart_starts(problem, x0, num_starts, radius, seed)
    return multistart_from(problem, settings, starts, max_iterations, device=problem.device)


def sharded_solve(problem: Problem, settings: Settings, x0_batch: Any, mesh,
                  axis_name: str = "batch", max_iterations: int = 1000,
                  restoration: bool = False, device: Any = None):
    """Scenario-batched solve across the ranks of ``mesh``'s axis
    ``axis_name`` (the reference's ``shard_map`` over a device mesh; BASELINE
    config 5).  Every rank passes the whole (B, n) batch, B divisible by the
    number of ranks; rank p solves lanes [p B/P, (p+1) B/P) by
    ``batched_solve`` on ``device`` (``None`` means CUDA).  Returns this
    rank's solved states and the number of OPTIMAL lanes over all ranks, a
    0-d int32 tensor summed by one ``psum``; ``gather_shards`` joins the
    states.  ``restoration`` is ``batched_solve``'s, on each shard."""
    problem = problem.to(resolve_device(device))
    x0 = _lanes_x0(problem, x0_batch)
    group, size, rank = axis_group(mesh, axis_name)
    batch = x0.shape[0]
    if batch % size != 0:
        raise ValueError(f"batch {batch} not divisible by mesh size {size}")
    per = batch // size
    out = batched_solve(problem, settings, x0[rank * per:(rank + 1) * per], max_iterations,
                        restoration, device=problem.device)
    solved_local = (out.status == int(Status.OPTIMAL)).sum(dtype=torch.int32)
    return out, psum(solved_local, group)


def gather_shards(states: Any, mesh, axis_name: str = "batch") -> Any:
    """The states of every rank's shard (``sharded_solve``), joined along
    their lanes in rank order, on every rank.  The tensors travel as their
    bytes, packed into one collective."""
    group, size, _ = axis_group(mesh, axis_name)
    leaves = tree_leaves(states)
    rows = all_gather_rows([t.contiguous().reshape(-1).view(torch.uint8) for t in leaves], group)
    joined = [r.reshape(-1).clone().view(t.dtype).reshape((size * t.shape[0],) + t.shape[1:])
              for t, r in zip(leaves, rows)]
    return tree_unflatten(states, iter(joined))
