"""Status codes of the PyTorch port, and the dtype rule for user callables.

``Status`` keeps the values of ``sleqp_tpu/types.py`` so that a status read
from either package compares equal as an integer.

Callables and dtypes.  In the mixed configuration
(``Settings(compute_dtype="float32")`` on a float64 problem) the stage
Jacobians and Hessians are assembled by calling the user's ``dynamics``,
``stage_cost`` and ``final_cost`` on float32 tensors.  The JAX package
demotes float64 constants that those callables close over while it traces
them; PyTorch runs eagerly and has no such scope, and its matrix products
refuse operands of different dtypes.  So a callable must follow its
arguments' dtype (and device), for example ``A.to(x) @ x``.  A callable that
computes in float64 on float32 arguments is reported with a ``TypeError``
by ``BlockStructuredProblem.linearize``; it is never run in float64
silently.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Solver status (reference: pub_types.h SLEQP_STATUS)."""

    UNKNOWN = 0
    RUNNING = 1
    OPTIMAL = 2
    INFEASIBLE = 3
    UNBOUNDED = 4
    ABORT_DEADPOINT = 5
    ABORT_ITER = 6
    ABORT_MANUAL = 7
    ABORT_TIME = 8
