"""A solve's loop as read-free programs, replayed as CUDA graphs.

The reference compiles each structured solve into one device program, a
``lax.while_loop`` (``ocp_solve_jit``, ``banded_solve_jit``).  Its
counterpart here splits the loop's body into a few programs that read
nothing from the card (their loops and branches run under
``lanes.device_resident()``) and drives them from the host, with one read
of a 0-d ``flag`` buffer after each.  A program is a function of a dict of
buffers that returns the buffers it writes; ``Programs`` holds them for one
device.  On the card each is captured as a ``torch.cuda.CUDAGraph`` over
static buffers and replayed; on the CPU the same function runs eagerly and
its results replace the buffers, with the same reads.

An iteration whose Armijo linesearch outlasts the trials inside the
iteration's own program is finished by two more: one that runs a block of
trials while a lane still searches (bit ``SEARCHING`` of the flag) and one
that takes the step (``Programs.step``).  A loop inside an iteration that is
too long to run masked in one graph (the sparse solve's CG and PDHG, the
dense solve's simplex pivots, Krylov steps and linesearch trials) is a
program of one block, run again while its bit of the flag is set
(``Programs.repeat``); a branch that guards such a loop (the dense solve's
LP re-solves) is a read of its bit.  A program is captured when a solve
first runs it (``Programs.call``).
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Optional

import torch

from .lanes import tree_leaves, tree_map
from .ops import cyclic_reduction, pallas_chol_tridiag, pallas_tridiag
from .types import SolverPhase, Status

# flag bits: a lane still runs; a lane's linesearch goes on; the next
# iteration restores; a Krylov solve (CG, GLTR's Lanczos, LSQR) goes on; a
# PDHG solve goes on; and the dense solve's (problem_solver.solve_jit): the
# Cauchy LP's saved basis takes the dual stage; a simplex pivoting loop
# goes on; the float64 polish's primal pass runs; the reduced LP
# re-solves; the penalty update goes on (its feasibility LP, another
# increase); the parametric Cauchy sweep goes on; the sweep goes forward
RUNNING = 1
SEARCHING = 2
RESTORING = 4
CG = 8
LP = 16
WARM_DUAL = 32
PIVOT = 64
POLISH = 128
RESOLVE = 256
PENALTY = 512
SWEEP = 1024
FORWARD = 2048

# the kernels' launch counts (by kernel name), which a capture corrects
LAUNCHES = (cyclic_reduction.LAUNCHES, pallas_tridiag.LAUNCHES, pallas_chol_tridiag.LAUNCHES)


def on_graphs(device: torch.device) -> bool:
    """Whether a solve's programs run as CUDA graphs on ``device``."""
    return device.type == "cuda"


def captured(record: Callable[[], None]) -> "torch.cuda.CUDAGraph":
    """``record()`` captured as a CUDA graph.  Python's cyclic garbage
    collector waits until the capture ends: a collection during it could
    destroy an unreachable graph of an earlier solve, which a capture does
    not permit."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            record()
    finally:
        if collecting:
            gc.enable()
    return graph


class Programs:
    """Read-free programs (``bodies``, by name) on the buffers ``bufs`` of
    one device, which hold at least ``state`` and ``max_it``.

    ``prepare`` makes programs runnable.  On CUDA (``cuda``) each runs once
    eagerly on a side stream, which builds the kernels at their first
    launch, creates the cuBLAS and cuSOLVER handles and grows the
    allocator, and gives each buffer it writes that does not exist yet its
    shape; then it is captured (by ``capture``: ``captured``, but in tests)
    under ``torch.cuda.set_sync_debug_mode("error")``, so that a host
    synchronization inside it raises, and ends by copying what it writes
    into the buffers.  A capture that fails raises, with ``hint`` first in
    its message where given; nothing falls back to an eager loop.  Kernel
    wrappers count launches when they are called, so the launches counted
    during a capture are taken out of ``counts`` (dicts by kernel name) and
    added back once a replay.

    ``warmup_s``, ``capture_s`` (capture and instantiation),
    ``reserved_bytes`` (device memory the allocator reserved during the
    captures: the graphs' pools), ``launches`` (a replay's, by program and
    kernel), ``replays`` (by program) and ``reads`` (over every run)
    describe it.
    """

    def __init__(self, bodies: dict, bufs: dict, cuda: bool, capture: Callable, counts: tuple,
                 hint: Optional[str] = None):
        self.bodies, self.bufs, self.cuda = bodies, bufs, cuda
        self.device = bufs["max_it"].device
        self._capture_with, self._counts, self._hint = capture, counts, hint
        self.programs: dict = {}
        self.replays = dict.fromkeys(bodies, 0)
        self.reads = 0
        self.warmup_s = self.capture_s = 0.0
        self.reserved_bytes = 0
        self.launches = dict.fromkeys(bodies, None)

    def prepare(self, *names: str) -> None:
        """Make the programs ``names`` runnable (warmed up and captured on
        CUDA, in this order), those that are not yet."""
        names = [name for name in names if name not in self.programs]
        if not names:
            return
        if not self.cuda:
            self.programs.update((name, self.bodies[name]) for name in names)
            return
        dev = self.device
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        t = time.perf_counter()
        with torch.cuda.stream(side):
            for name in names:
                for key, value in self.bodies[name](self.bufs).items():
                    if key not in self.bufs:
                        self.bufs[key] = tree_map(torch.clone, value)
        stream.wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_s += time.perf_counter() - t
        torch.cuda.empty_cache()  # as a capture does first: the pools' growth remains
        reserved = torch.cuda.memory_reserved(dev)
        t = time.perf_counter()
        for name in names:
            self.programs[name] = self._capture(name)
        torch.cuda.synchronize(dev)
        self.capture_s += time.perf_counter() - t
        self.reserved_bytes += torch.cuda.memory_reserved(dev) - reserved

    def _capture(self, name: str):
        body = self.bodies[name]

        def record():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for buf, value in body(self.bufs).items():
                    for dst, src in zip(tree_leaves(self.bufs[buf]), tree_leaves(value)):
                        dst.copy_(src)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        before = [dict(counts) for counts in self._counts]
        try:
            graph = self._capture_with(record)
        except RuntimeError as exc:
            if self._hint is None:
                raise
            raise RuntimeError(f"{self._hint} (capturing {name!r}): {exc}") from exc
        finally:
            launches = {}
            for counts, was in zip(self._counts, before):
                launches.update({k: counts[k] - was[k] for k in counts})
                counts.update(was)
        self.launches[name] = launches
        return graph

    def load(self, state0: Any, max_iterations: int) -> None:
        """Set the state buffers to ``state0`` and the iteration limit."""
        if self.cuda:
            for dst, src in zip(tree_leaves(self.bufs["state"]), tree_leaves(state0)):
                dst.copy_(src)
            self.bufs["max_it"].fill_(max_iterations)
        else:
            self.bufs["state"] = state0
            self.bufs["max_it"] = torch.full((), max_iterations, dtype=torch.int32,
                                             device=self.device)

    def call(self, name: str) -> None:
        """``name`` made runnable where it is not yet, then replayed."""
        if name not in self.programs:
            self.prepare(name)
        self.replay(name)

    def replay(self, name: str) -> None:
        """One run of a program on the buffers, its launches counted."""
        self.replays[name] += 1
        if not self.cuda:
            self.bufs.update(self.programs[name](self.bufs))
            return
        self.programs[name].replay()
        for counts in self._counts:
            for k in counts:
                counts[k] += self.launches[name][k]

    def read(self, flag: torch.Tensor) -> int:
        """A host read of a 0-d flag, counted in ``reads``."""
        self.reads += 1
        return int(flag)

    def flag(self) -> int:
        """The one host read after a program."""
        return self.read(self.bufs["flag"])

    def repeat(self, name: str, bit: int, runs: int) -> int:
        """At most ``runs`` runs of ``name`` (made runnable first where it
        is not yet), a read after each, while the flag has ``bit``.
        Returns the last flag."""
        flag = bit
        for _ in range(runs):
            self.call(name)
            flag = self.flag()
            if not flag & bit:
                break
        return flag

    def step(self, iterate: str, search: str, finish: str, blocks: int) -> int:
        """One iteration: ``iterate`` and a read; while its flag says a
        linesearch goes on, at most ``blocks`` runs of ``search`` (a read
        each), then ``finish`` and a read.  Returns the last flag."""
        self.replay(iterate)
        flag = self.flag()
        if flag & SEARCHING:
            self.repeat(search, SEARCHING, blocks)
            self.replay(finish)
            flag = self.flag()
        return flag

    def result(self) -> Any:
        """The state buffers (a copy on CUDA, where the next run overwrites
        them)."""
        state = self.bufs["state"]
        return tree_map(torch.clone, state) if self.cuda else state


def running(state: Any, max_iterations: torch.Tensor) -> torch.Tensor:
    """Whether a solve's state still iterates (RUNNING, below the limit)."""
    return (state.status == int(Status.RUNNING)) & (state.iteration < max_iterations)


def loop_flag(state: Any, max_iterations: torch.Tensor, searching=None) -> torch.Tensor:
    """The flag of a two-phase loop after an iteration: RUNNING, RESTORING
    when the next iteration restores, and SEARCHING where given."""
    bits = (running(state, max_iterations).to(torch.int32)
            + RESTORING * (state.phase == int(SolverPhase.RESTORATION)).to(torch.int32))
    return bits if searching is None else bits + SEARCHING * searching.to(torch.int32)


def cached(problem: Any, key: tuple, make: Callable[[], Programs]) -> Programs:
    """The programs of ``problem`` under ``key``, made by ``make()`` at the
    first call and kept on the problem."""
    graphs = problem.__dict__.setdefault("_solve_graphs", {})
    if key not in graphs:
        graphs[key] = make()
    return graphs[key]


def state_key(state0: Any) -> tuple:
    """The device, shapes and dtypes of a state: what a capture fixes."""
    leaves = tree_leaves(state0)
    return (leaves[0].device, tuple((tuple(t.shape), t.dtype) for t in leaves))
