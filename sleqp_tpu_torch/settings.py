"""The solver settings that the structured (OCP) solve reads.

The fields, defaults and validation are those of ``sleqp_tpu/settings.py``;
the settings that only the general SLP-EQP solve reads come with that slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Settings:
    """OCP solver settings with reference defaults (settings.c:20-66)."""

    eps: float = 1e-10
    linesearch_tau: float = 0.5
    linesearch_eta: float = 1e-4
    feas_tol: float = 1e-6
    stat_tol: float = 1e-6
    # "same" keeps the problem dtype; "float32" assembles the stage
    # Jacobians/Hessians and solves the KKT system in float32 while the
    # state, merit and residuals stay in the problem dtype.
    compute_dtype: str = "same"

    def __post_init__(self) -> None:
        # a typo ("fp32") silently resolving to the full-precision path
        # would defeat the point of the setting
        if self.compute_dtype not in ("same", "float32"):
            raise ValueError(
                f"compute_dtype must be 'same' or 'float32', "
                f"got {self.compute_dtype!r}"
            )
