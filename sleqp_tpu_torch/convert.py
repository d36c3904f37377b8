"""Carry problems and solver states between numpy and the port.

The parity tests build one problem and one starting state from numpy
arrays and hand them to both the JAX package and this one; these helpers
are the port's side of that exchange.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .ocp import OCPState, resolve_device

_PROBLEM_ARRAYS = ("x0", "u_lb", "u_ub", "x_lb", "x_ub")


def problem_arrays_from_numpy(
    arrays: Mapping[str, Any], device: Any = None
) -> dict[str, torch.Tensor]:
    """``x0`` and the bounds as float64 tensors, keyed as
    ``BlockStructuredProblem`` takes them
    (``BlockStructuredProblem(..., **problem_arrays_from_numpy(a))``).
    ``device=None`` means CUDA."""
    unknown = set(arrays) - set(_PROBLEM_ARRAYS)
    if unknown:
        raise ValueError(f"not problem arrays: {sorted(unknown)}; expected {_PROBLEM_ARRAYS}")
    dev = resolve_device(device)
    return {
        name: torch.as_tensor(np.array(a), dtype=torch.float64, device=dev)
        for name, a in arrays.items()
    }


def state_to_numpy(state: OCPState) -> dict[str, np.ndarray]:
    """Every field of an ``OCPState`` as a numpy array, by field name."""
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(OCPState)
    }


def state_from_numpy(arrays: Mapping[str, Any], device: Any = None) -> OCPState:
    """An ``OCPState`` from numpy arrays keyed by field name (as
    ``state_to_numpy`` gives, or the fields of the JAX package's
    ``OCPState``), keeping their dtypes.  ``device=None`` means CUDA."""
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(OCPState)]
    missing = set(names) - set(arrays)
    if missing:
        raise ValueError(f"missing OCPState fields: {sorted(missing)}")
    return OCPState(
        **{n: torch.as_tensor(np.array(arrays[n]), device=dev) for n in names}
    )
