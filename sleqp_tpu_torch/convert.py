"""Carry problems and solver states between numpy and the port.

The parity tests build one problem and one starting state from numpy
arrays and hand them to both the JAX package and this one; these helpers
are the port's side of that exchange: for the structured (OCP) solve its
problem arrays and ``OCPState``, for the dense SLP-EQP solve its
``ProblemData``, ``Iterate`` and ``SolverState`` (with the quasi-Newton
ring buffers, one per Hessian block where there are blocks), the
``Scaling`` weights of ``Solver``, and the states of the large-n paths,
``BandedState`` and ``SparseState``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .cauchy import CauchyBasis
from .device import resolve_device
from .iterate import Iterate
from .measure import Measure
from .ocp import OCPState
from .problem_solver import SolverState
from .quasi_newton import QNPrev, QNState
from .scale import Scaling
from .step_rule import StepRuleState

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


# ---- the dense SLP-EQP solve's problem data, iterates and states ------------

# the dataclass type of each nested field, by the class that holds it
_NESTED = {
    SolverState: {"it": Iterate, "basis": CauchyBasis, "qn": QNState, "qn_prev": QNPrev,
                  "step_rule": StepRuleState, "measure": Measure},
}


def _field(src: Any, name: str):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _from_tree(cls, src: Any, dev: torch.device):
    nested = _NESTED.get(cls, {})
    out = {}
    for f in dataclasses.fields(cls):
        value = _field(src, f.name)
        sub = nested.get(f.name)
        if sub is None:
            out[f.name] = torch.as_tensor(np.array(value), device=dev)
        elif isinstance(value, (tuple, list)):  # per-Hessian-block QN states
            out[f.name] = tuple(_from_tree(sub, v, dev) for v in value)
        else:
            out[f.name] = _from_tree(sub, value, dev)
    return cls(**out)


def tree_from_numpy(cls, src: Any, device: Any = None):
    """One of the port's ``ProblemData``, ``Iterate``, ``SolverState``,
    ``QNState``, ``QNPrev``, ``BandedState`` or ``SparseState`` (``cls``)
    from numpy arrays: ``src`` is the
    JAX package's object of the same name with its leaves turned into
    numpy (``jax.tree_util.tree_map(np.asarray, state)``), or a nested
    mapping keyed by field name as ``tree_to_numpy`` gives; a tuple of them
    (per-block ring buffers) gives a tuple.  Dtypes and shapes are kept.
    ``device=None`` means CUDA."""
    dev = resolve_device(device)
    if isinstance(src, (tuple, list)):
        return tuple(_from_tree(cls, v, dev) for v in src)
    return _from_tree(cls, src, dev)


def scaling_from_reference(src: Any) -> Scaling:
    """The port's ``Scaling`` from the JAX package's (or a mapping of its
    fields): the integer weights, copied, stay on the host."""
    return Scaling(
        num_variables=int(_field(src, "num_variables")),
        num_cons=int(_field(src, "num_cons")),
        obj_weight=int(_field(src, "obj_weight")),
        var_weights=np.array(_field(src, "var_weights"), dtype=np.int32),
        cons_weights=np.array(_field(src, "cons_weights"), dtype=np.int32),
    )


def tree_to_numpy(obj: Any):
    """Every field of a port dataclass (nested ones included) as numpy
    arrays, in nested dicts keyed by field name; a tuple of states stays a
    tuple."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple):
        return tuple(tree_to_numpy(v) for v in obj)
    return {f.name: tree_to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
