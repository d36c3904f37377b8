"""Start the ranks of a sharded solve on one host, and join their group.

``torch.distributed`` runs one program on every rank (SPMD), where the
reference's ``shard_map`` runs one program over the devices of a mesh.
A sharded path (``parallel/schur.py``, ``ocp_solve(mesh=)``,
``parallel/batch.py::sharded_solve``) takes a 1-D
``torch.distributed.device_mesh.DeviceMesh`` whose named axis spans the
ranks; the ranks are processes, and nothing on the machine tells them of
each other, so they are given the rendezvous, their rank and the world
size:

* ``spawn``: start one subprocess per rank and wait for all of them, with a
  deadline; a rank that fails or is late fails the run, and every rank is
  killed.
* ``init``: join the default group with a finite timeout, so that a rank
  whose collectives part from the others' fails instead of hanging.
* ``device_mesh``: the 1-D mesh over every rank of the default group.

The transport is the group's backend, named by the caller: ``"gloo"`` for
ranks on the CPU and for several ranks sharing one card (NCCL refuses two
ranks on one GPU), ``"nccl"`` where each rank has a GPU of its own
(``init`` then makes GPU ``rank`` the rank's device).  A file rendezvous
(``file://`` and a path that no rank has used) needs no network port.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import subprocess
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BACKENDS = ("gloo", "nccl")


def init(init_method: str, rank: int, world_size: int, backend: str = "gloo",
         timeout_s: float = 120.0) -> None:
    """Join the default process group as ``rank`` of ``world_size``.
    Every collective of the group fails after ``timeout_s`` seconds."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def device_mesh(device_type: str, axis_name: str) -> DeviceMesh:
    """A 1-D mesh over every rank of the default group, its axis named
    ``axis_name``.  Built over the group that ``init`` joined (with gloo
    for ranks sharing one card, which ``init_device_mesh`` would not
    choose)."""
    return DeviceMesh(device_type, list(range(dist.get_world_size())),
                      mesh_dim_names=(axis_name,))


def spawn(argvs: Sequence[Sequence[str]], deadline_s: float, env: Optional[dict] = None,
          cwd: Optional[str] = None) -> list[str]:
    """Run one subprocess per rank (``argvs[r]``), all started together,
    and return their standard outputs in rank order.  Raises
    ``RuntimeError`` with the failing rank's standard error when a rank
    exits non-zero or the ranks are not all done within ``deadline_s``
    seconds; every rank still running is killed first."""
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as files:
        def opened(name):
            return files.enter_context(open(os.path.join(tmp, name), "w+"))

        outs = [opened(f"{r}.out") for r in range(len(argvs))]
        errs = [opened(f"{r}.err") for r in range(len(argvs))]
        procs = [subprocess.Popen(list(a), stdout=o, stderr=e, env=env, cwd=cwd)
                 for a, o, e in zip(argvs, outs, errs)]
        end = time.monotonic() + deadline_s
        try:
            while time.monotonic() <= end:
                codes = [p.poll() for p in procs]  # every rank, each time
                if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                    break
                time.sleep(0.05)
        finally:
            late = [r for r, p in enumerate(procs) if p.poll() is None]
            for r in late:
                procs[r].kill()
            for p in procs:
                p.wait()

        def read(f):
            f.seek(0)
            return f.read()

        failed = [r for r, p in enumerate(procs) if r not in late and p.returncode != 0]
        if failed or late:
            r = (failed or late)[0]
            why = (f"exited with code {procs[r].returncode}" if failed
                   else f"was still running after {deadline_s:.0f} s")
            raise RuntimeError(f"rank {r} of {len(procs)} {why}:\n{read(errs[r])[-4000:]}")
        return [read(o) for o in outs]
