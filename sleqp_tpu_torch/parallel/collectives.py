"""The collectives of the sharded paths, over ``torch.distributed``.

Port of what the reference's ``shard_map`` bodies call:
``jax.lax.all_gather(x, axis, axis=0, tiled=True)`` of one row a device
(``all_gather_rows``) and ``jax.lax.psum`` (``psum``).  A mesh axis is a
``DeviceMesh`` dimension; its collectives run on ``mesh.get_group(axis)``
(``axis_group``), one rank per device of the reference.

The transport follows the group's backend, chosen by whoever made the group
(``parallel/ranks.py``), never by trying one and falling back:

* ``"gloo"`` (ranks on the CPU, or several ranks sharing one card): gloo
  moves host memory, so a tensor on the card is staged through a host copy
  by design, and the result goes back to the input's device.
* ``"nccl"`` (one GPU a rank): the tensors stay on the card.

``CALLS`` counts the collectives since it was last cleared.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# Collectives since the counts were last cleared, by name.
CALLS = {"all_gather_rows": 0, "psum": 0}


def axis_group(mesh, axis_name: str):
    """(group, size, rank) of ``mesh``'s axis ``axis_name``: the process
    group of its collectives, the number of ranks along it, and this
    process's index along it (the reference's ``axis_index``)."""
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _staged(group) -> bool:
    backend = dist.get_backend(group)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unsupported process group backend {backend!r}")
    return backend == "gloo"


def all_gather_rows(tensors: Union[Tensor, Sequence[Tensor]], group):
    """Every rank's ``tensors`` stacked along a new leading axis, in rank
    order: x (...) -> (P, ...), on every rank.  A sequence of tensors of
    one dtype is packed into one buffer and gathered in one collective;
    the result is then the list of the stacked tensors."""
    many = not isinstance(tensors, Tensor)
    parts = list(tensors) if many else [tensors]
    device = parts[0].device
    flat = torch.cat([t.reshape(-1) for t in parts])
    if _staged(group):
        flat = flat.cpu()
    size = dist.get_world_size(group)
    rows = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(rows, flat.contiguous(), group=group)
    CALLS["all_gather_rows"] += 1
    gathered = torch.stack(rows).to(device)
    out, start = [], 0
    for t in parts:
        out.append(gathered[:, start:start + t.numel()].reshape((size,) + tuple(t.shape)))
        start += t.numel()
    return out if many else out[0]


def psum(x: Tensor, group) -> Tensor:
    """The sum of ``x`` over the ranks of ``group``, on every rank."""
    buf = x.detach().to("cpu" if _staged(group) else x.device, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    CALLS["psum"] += 1
    return buf.to(x.device)
