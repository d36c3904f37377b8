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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch._C import _functorch

Tensor = torch.Tensor


def is_batched(t: Any) -> bool:
    """Whether ``t`` is a tensor with a lane dimension under ``vmap``."""
    return isinstance(t, Tensor) and _functorch.is_batchedtensor(t)


def lanes_any(flag: Any) -> bool:
    """One host read: whether ``flag`` holds on any lane.  Under ``vmap``
    the read is of the lanes' underlying tensor, outside it of ``flag``."""
    if not isinstance(flag, Tensor):
        return bool(flag)
    while _functorch.is_batchedtensor(flag):
        flag = _functorch.get_unwrapped(flag)
    return bool(flag.any())


def tree_leaves(tree: Any) -> list:
    """The tensors of a state (tensors, tuples and dataclasses of them), in
    field order."""
    if isinstance(tree, Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for v in tree for t in tree_leaves(v)]
    return [t for f in dataclasses.fields(tree) for t in tree_leaves(getattr(tree, f.name))]


def tree_unflatten(like: Any, leaves) -> Any:
    """A state shaped as ``like`` with ``leaves`` (an iterator) in its
    tensors' places."""
    if isinstance(like, Tensor):
        return next(leaves)
    if isinstance(like, tuple):
        return tuple(tree_unflatten(v, leaves) for v in like)
    return type(like)(**{f.name: tree_unflatten(getattr(like, f.name), leaves)
                         for f in dataclasses.fields(like)})


def tree_map(fn: Callable[..., Tensor], tree: Any, *rest: Any) -> Any:
    """``fn`` on each tensor of ``tree`` (and the same tensors of ``rest``)."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, iter([fn(*ts) for ts in zip(*leaves)]))


def tree_where(pred: Tensor, a, b):
    """Field-by-field ``torch.where`` over two states of one type
    (tensors, and tuples, dicts and dataclasses of them)."""
    if isinstance(a, Tensor):
        return torch.where(pred, a, b)
    if isinstance(a, tuple):
        return tuple(tree_where(pred, x, y) for x, y in zip(a, b))
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
    as it is."""
    return tree_where(pred, a, b) if is_batched(pred) else a


def lockstep(cond: Callable[[Any], Tensor], body: Callable[[Any, int], Any], state: Any,
             max_trips: int | None = None, first: Any = None):
    """Run ``body(state, trip)`` while ``cond(state)`` holds on any lane,
    at most ``max_trips`` times; lanes where it fails keep their state
    (``torch.where``, which takes nothing, NaN included, from the side it
    does not select).  ``first`` gives the lanes active on the first trip
    when the caller knows them (``True``: all), which saves that trip's
    read.  ``trip`` counts from 0 and is the same on every active lane."""
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
