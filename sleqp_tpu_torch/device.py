"""Where the port's entry points run.

Every entry point takes ``device=None``, which means the CUDA card; without
a CUDA device it raises.  The tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.
    Raises when CUDA is asked for and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
