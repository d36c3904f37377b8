"""Enums, status codes and the dtype rule for user callables.

Every enum keeps the integer values of ``sleqp_tpu/types.py``, so that a
status, step type or basis status read from either package compares equal
as an integer.

Callables and dtypes.  In the mixed configuration
(``Settings(compute_dtype="float32")`` on a float64 problem) the solver
calls the user's callables on float32 tensors: the OCP's ``dynamics``,
``stage_cost`` and ``final_cost`` when it assembles its stage Jacobians and
Hessians, and a dense ``Func``'s Hessian product (``obj``, ``cons`` through
AD) inside the Krylov loop of the Newton step.  The JAX package demotes
float64 constants that those callables close over while it traces them
(its ``f32_compute_scope``); PyTorch runs eagerly and has no such scope,
and its matrix products refuse operands of different dtypes.  So a callable
must follow its arguments' dtype (and device), for example
``A.to(x) @ x``.  A callable that computes in float64 on float32 arguments
is reported with a ``TypeError``; it is never run in float64 silently.
"""

from __future__ import annotations

import enum
import re


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


class ActiveState(enum.IntEnum):
    """Active-set state per variable/constraint (pub_types.h:42-53), kept
    as int8 tensors of length n (variables) and m (constraints)."""

    INACTIVE = 0
    ACTIVE_LOWER = 1
    ACTIVE_UPPER = 2
    ACTIVE_BOTH = 3


class BaseStat(enum.IntEnum):
    """LP basis status per column (reference: lp/lpi_types.h:12-18)."""

    LOWER = 0
    UPPER = 1
    BASIC = 2
    ZERO = 3  # nonbasic free variable at zero


class CauchyObjective(enum.IntEnum):
    """LP objective type (reference: cauchy/cauchy_types.h:8-14)."""

    DEFAULT = 0
    FEAS = 1
    MIXED = 2


class StepType(enum.IntEnum):
    """Last step classification (pub_types.h SLEQP_STEPTYPE)."""

    NONE = 0
    ACCEPTED = 1
    ACCEPTED_FULL = 2
    ACCEPTED_SOC = 3
    REJECTED = 4


class DualEstimationType(enum.IntEnum):
    """How duals are estimated (pub_types.h:127-132)."""

    LP = 0
    LSQ = 1
    MIXED = 2


class StepRule(enum.IntEnum):
    """Step acceptance rules (pub_types.h SLEQP_STEP_RULE)."""

    DIRECT = 0
    WINDOW = 1
    MINSTEP = 2


class Linesearch(enum.IntEnum):
    """Trial-point linesearch flavor (pub_types.h:162-166)."""

    APPROX = 0
    EXACT = 1


class HessEval(enum.IntEnum):
    """Hessian evaluation mode (pub_types.h:104-110)."""

    EXACT = 0
    SIMPLE_BFGS = 1
    DAMPED_BFGS = 2
    SR1 = 3


class BfgsSizing(enum.IntEnum):
    """BFGS initial-scaling strategy (pub_types.h:112-116)."""

    NONE = 0
    CENTERED_OL = 1


class TRSolver(enum.IntEnum):
    """Trust-region subproblem solver (tr/tr_types.h)."""

    AUTO = 0
    CG = 1  # Steihaug projected CG
    GLTR = 2  # Lanczos / GLTR (trlib equivalent)
    LSQR = 3


class LPSolver(enum.IntEnum):
    """Cauchy LP backend.  AUTO picks vertex enumeration for tiny LPs
    (``ops/lp_enum.py``), the revised simplex below ``pdlp_threshold`` LP
    columns and the first-order PDLP solver above it."""

    AUTO = 0
    SIMPLEX = 1
    PDLP = 2
    ENUM = 3


class Polishing(enum.IntEnum):
    """Post-solve working set polishing (pub_types.h:142-147)."""

    NONE = 0
    ZERO_DUAL = 1
    INACTIVE = 2


class ParametricCauchy(enum.IntEnum):
    """Parametric Cauchy mode (pub_types.h:149-154)."""

    DISABLED = 0
    COARSE = 1
    FINE = 2


class AugJacMethod(enum.IntEnum):
    """How augmented-Jacobian systems are solved (pub_types.h:190-196)."""

    AUTO = 0
    STANDARD = 1
    REDUCED = 2
    DIRECT = 3


class InitialTRChoice(enum.IntEnum):
    """Initial trust-region radius choice (pub_types.h:156-160): NARROW as
    in the original SLP-EQP paper, WIDE the Knitro default."""

    NARROW = 0
    WIDE = 1


class SolverPhase(enum.IntEnum):
    """Top-level solver phase (reference: solver/phase.c)."""

    OPTIMIZATION = 0
    RESTORATION = 1


# Numeric "infinity" of the LP bound arithmetic; magnitudes >= INF_THRESHOLD
# count as infinite (sleqp_infinity() = 1e20 semantics, src/main/cmp.c).
INF = 1e20
INF_THRESHOLD = 1e19

# what PyTorch's kernels say when their operands' dtypes differ
DTYPE_MISMATCH = re.compile(r"dtype|scalar type", re.IGNORECASE)


class MathError(ArithmeticError):
    """A numerical invariant failed (SLEQP_MATH_ERROR analogue): raised
    when ``settings.num_asserts`` detects an inconsistency; the bitmask
    names which check fired (``SolverState.num_assert_fail``)."""

    BITS = {
        1: "direction bundle inconsistent (direction.c check)",
        2: "model merit mismatch (trial_point.c:760-790)",
        4: "non-finite solver quantity",
    }

    def __init__(self, bitmask):
        if isinstance(bitmask, str):
            # float-exception surveillance: a message, not a bitmask
            self.bitmask = 4
            super().__init__(bitmask)
            return
        self.bitmask = int(bitmask)
        parts = [msg for bit, msg in self.BITS.items() if self.bitmask & bit]
        super().__init__(
            f"numerical assert failed (mask {self.bitmask}): " + "; ".join(parts)
        )
