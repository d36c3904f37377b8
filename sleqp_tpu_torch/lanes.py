"""Lanes in lockstep: the loops and branches of the dense iteration for one
instance or for a batch of them.

The reference batches instances with ``vmap`` of ``lax.while_loop``: every
lane advances together and a finished lane is frozen by a select while the
others go on.  The port runs the same single-lane code under
``torch.func.vmap`` (``parallel/batch.py``), where a tensor's truth value
cannot be read, so each data-dependent loop is a ``cond``/``body`` pair
with no host read inside, run by ``lockstep``:

    while (active := cond(state)).any():
        state = where(active, body(state, trip), state)

one host read a trip for all lanes.  A branch on one read becomes
``lanes_any(flag)`` (does any lane need the costly side?) and a per-lane
select of its result.  Outside ``vmap`` (one instance) ``lanes_any`` is
``bool(flag)`` and a trip's body replaces the state outright, so the
single-lane path runs the same bodies with the same reads as a plain loop.

Inside ``device_resident()`` nothing is read: ``lanes_any`` answers
``True`` without looking, so the costly side of a branch always runs and a
per-lane select keeps what each lane needs, and ``lockstep`` runs exactly
``max_trips`` masked trips.  ``torch.where`` takes nothing from the side it
does not select, so the results are the reading loop's bits.  This is the
form a CUDA graph can capture (``ocp.ocp_solve_jit``): no host read inside
the body, one read of a flag after it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
from torch._C import _functorch

Tensor = torch.Tensor

_resident = False  # inside device_resident()


@contextlib.contextmanager
def device_resident():
    """Run the lanes' loops and branches without a host read while active:
    ``lanes_any`` is ``True`` unread, ``lanes_where`` selects per lane,
    ``lockstep`` runs its ``max_trips`` trips masked (an uncapped loop
    raises)."""
    global _resident
    saved, _resident = _resident, True
    try:
        yield
    finally:
        _resident = saved


def is_device_resident() -> bool:
    """Whether ``device_resident()`` is active."""
    return _resident


def is_batched(t: Any) -> bool:
    """Whether ``t`` is a tensor with a lane dimension under ``vmap``."""
    return isinstance(t, Tensor) and _functorch.is_batchedtensor(t)


def lanes_any(flag: Any) -> bool:
    """One host read: whether ``flag`` holds on any lane.  Under ``vmap``
    the read is of the lanes' underlying tensor, outside it of ``flag``
    (a 0-d flag is read as it is, without a reduction to launch).  Inside
    ``device_resident()`` a tensor flag is not read and the answer is
    ``True``."""
    if not isinstance(flag, Tensor):
        return bool(flag)
    if _resident:
        return True
    return read_flag(flag)


def read_flag(flag: Tensor) -> bool:
    """The host read of ``lanes_any``."""
    while _functorch.is_batchedtensor(flag):
        flag = _functorch.get_unwrapped(flag)
    return bool(flag if flag.ndim == 0 else flag.any())


def tree_leaves(tree: Any) -> list:
    """The tensors of a state (tensors, and tuples, dicts and dataclasses of
    them), in field order."""
    if isinstance(tree, Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for v in tree for t in tree_leaves(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [t for f in dataclasses.fields(tree) for t in tree_leaves(getattr(tree, f.name))]


def _same_tuple(like: tuple, values: list) -> tuple:
    """``values`` as a tuple of ``like``'s type (a NamedTuple keeps its
    fields)."""
    return type(like)(*values) if hasattr(like, "_fields") else tuple(values)


def tree_unflatten(like: Any, leaves) -> Any:
    """A state shaped as ``like`` with ``leaves`` (an iterator) in its
    tensors' places."""
    if isinstance(like, Tensor):
        return next(leaves)
    if isinstance(like, tuple):
        return _same_tuple(like, [tree_unflatten(v, leaves) for v in like])
    if isinstance(like, dict):
        return {k: tree_unflatten(v, leaves) for k, v in like.items()}
    return type(like)(**{f.name: tree_unflatten(getattr(like, f.name), leaves)
                         for f in dataclasses.fields(like)})


def tree_map(fn: Callable[..., Tensor], tree: Any, *rest: Any) -> Any:
    """``fn`` on each tensor of ``tree`` (and the same tensors of ``rest``)."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, iter([fn(*ts) for ts in zip(*leaves)]))


def tree_where(pred: Tensor, a, b):
    """Field-by-field ``torch.where`` over two states of one type
    (tensors, and tuples, NamedTuples, dicts and dataclasses of them)."""
    if isinstance(a, Tensor):
        return torch.where(pred, a, b)
    if isinstance(a, tuple):
        return _same_tuple(a, [tree_where(pred, x, y) for x, y in zip(a, b)])
    if isinstance(a, dict):
        return {k: tree_where(pred, a[k], b[k]) for k in a}
    return type(a)(**{f.name: tree_where(pred, getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


def vmap_lanes(fn: Callable[..., Any], *trees: Any) -> Any:
    """``torch.func.vmap(fn)`` over states: every tensor of ``trees`` has
    the lane dimension first, and so has every tensor of the result."""
    flat = [tree_leaves(t) for t in trees]
    out_like = []

    def inner(*leaves):
        it = iter(leaves)
        out = fn(*(tree_unflatten(t, it) for t in trees))
        out_like.append(out)
        return tuple(tree_leaves(out))

    outs = torch.func.vmap(inner)(*(t for leaves in flat for t in leaves))
    return tree_unflatten(out_like[0], iter(outs))


def lanes_where(pred: Any, a, b):
    """``tree_where(pred, a, b)`` after a branch entered on
    ``lanes_any(pred)``: outside ``vmap`` ``pred`` held, so ``a`` is taken
    as it is, unless ``device_resident()`` entered the branch unread."""
    if is_batched(pred) or (_resident and isinstance(pred, Tensor)):
        return tree_where(pred, a, b)
    return a


def lockstep(cond: Callable[[Any], Tensor], body: Callable[[Any, int], Any], state: Any,
             max_trips: int | None = None, first: Any = None):
    """Run ``body(state, trip)`` while ``cond(state)`` holds on any lane,
    at most ``max_trips`` times; lanes where it fails keep their state
    (``torch.where``, which takes nothing, NaN included, from the side it
    does not select).  ``first`` gives the lanes active on the first trip
    when the caller knows them (``True``: all), which saves that trip's
    read.  ``trip`` counts from 0 and is the same on every active lane.

    Inside ``device_resident()`` every one of the ``max_trips`` trips runs,
    on one lane as on many: ``state = where(active, body(state, trip),
    state)`` with ``active`` the first trip's ``first`` or else
    ``cond(state)``.  A trip after the reading loop would have stopped
    selects nothing, so the state is the reading loop's.  Without
    ``max_trips`` it raises, since only a read could end the loop."""
    if _resident:
        if max_trips is None:
            raise ValueError("lockstep: an uncapped loop cannot run without a host read "
                             "(device_resident() needs max_trips)")
        for trip in range(max_trips):
            active = first if trip == 0 and first is not None else cond(state)
            if isinstance(active, Tensor):
                state = tree_where(active, body(state, trip), state)
            elif active:
                state = body(state, trip)
        return state
    trip = 0
    active = first
    while max_trips is None or trip < max_trips:
        if active is None:
            active = cond(state)
            if not lanes_any(active):
                break
        new = body(state, trip)
        state = tree_where(active, new, state) if is_batched(active) else new
        active = None
        trip += 1
    return state
