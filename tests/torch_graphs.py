"""The card's path of a solve's graph loop (``graphs.Programs``), emulated
on the CPU, for the port's ``*_solve_jit`` tests.

``emulated_graphs`` makes ``graphs.Programs`` take the CUDA branch: each
program is warmed up, "captured" and replayed.  A capture runs its program
with the tensor copies that would write the static buffers made no-ops
(a capture records, it writes nothing) and with every host read raising, as
under ``torch.cuda.set_sync_debug_mode("error")``; a replay runs the
program into the buffers.  A replay calls no kernel wrapper on the card,
so the launch counts of ``graphs.LAUNCHES`` are restored after it (the
programs' launches are added back by ``Programs.replay``).
"""

import contextlib

import pytest
import torch

from sleqp_tpu_torch import graphs, lanes
from test_torch_batch import HostReads


class FakeStream:
    def wait_stream(self, other):
        pass


class ReadsForbidden:
    """Every host read of a tensor raises while active: truth values,
    items, lists, Python numbers and the read of ``lanes.lanes_any``."""

    NAMES = HostReads.NAMES

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch

    def __enter__(self):
        def refuse(*args, **kwargs):
            raise AssertionError("a host read inside the read-free iteration")

        for name in self.NAMES:
            self.monkeypatch.setattr(torch.Tensor, name, refuse)
        self.monkeypatch.setattr(lanes, "read_flag", refuse)
        return self

    def __exit__(self, *exc):
        self.monkeypatch.undo()


def _refuse(*args, **kwargs):
    raise RuntimeError("a host synchronization while capturing (emulated)")


@pytest.fixture
def emulated_graphs(monkeypatch):
    """The card's path of the graph loops on the CPU (the module's
    docstring).  Returns the names of the programs captured, in order."""
    captured = []

    class Graph:
        def __init__(self, record):
            self.record = record
            saved = {n: getattr(torch.Tensor, n) for n in ("copy_", *HostReads.NAMES)}
            try:
                torch.Tensor.copy_ = lambda dst, src, non_blocking=False: dst
                for n in HostReads.NAMES:
                    setattr(torch.Tensor, n, _refuse)
                record()
            finally:
                for n, fn in saved.items():
                    setattr(torch.Tensor, n, fn)

        def replay(self):
            counts = [dict(c) for c in graphs.LAUNCHES]
            self.record()
            for c, was in zip(graphs.LAUNCHES, counts):
                c.update(was)

    real_capture = graphs.Programs._capture

    def capture(self, name):
        graph = real_capture(self, name)
        captured.append(name)
        return graph

    monkeypatch.setattr(graphs, "on_graphs", lambda device: True)
    monkeypatch.setattr(graphs, "captured", Graph)
    monkeypatch.setattr(graphs.Programs, "_capture", capture)
    for name, value in (("current_stream", lambda device=None: FakeStream()),
                        ("Stream", lambda device=None: FakeStream()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("synchronize", lambda device=None: None),
                        ("memory_reserved", lambda device=None: 0),
                        ("empty_cache", lambda: None),
                        ("get_sync_debug_mode", lambda: 0),
                        ("set_sync_debug_mode", lambda mode: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    return captured
