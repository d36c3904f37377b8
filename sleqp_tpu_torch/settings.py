"""Solver settings.

Port of ``sleqp_tpu/settings.py``: every field with the reference's
default, the same validation, and the ``key = value`` settings-file reader
(settings.c:743-800).  The structured (OCP) solve reads six of the fields
(``eps``, ``linesearch_tau``, ``linesearch_eta``, ``feas_tol``,
``stat_tol``, ``compute_dtype``); the general SLP-EQP solve reads the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .types import (
    AugJacMethod,
    BfgsSizing,
    DualEstimationType,
    HessEval,
    InitialTRChoice,
    Linesearch,
    LPSolver,
    ParametricCauchy,
    Polishing,
    StepRule,
    TRSolver,
)


@dataclasses.dataclass(frozen=True)
class Settings:
    """All solver settings with reference defaults (settings.c:20-66)."""

    # --- real settings (pub_settings.h, settings.c:20-35) ---
    zero_eps: float = 1e-20
    eps: float = 1e-10
    obj_lower: float = -1e20
    deriv_perturbation: float = 1e-8
    deriv_tol: float = 1e-4
    cauchy_tau: float = 0.5
    cauchy_eta: float = 0.1
    linesearch_tau: float = 0.5
    linesearch_eta: float = 1e-4
    linesearch_cutoff: float = 1e-6
    feas_tol: float = 1e-6
    slack_tol: float = 1e-6
    stat_tol: float = 1e-6
    accepted_reduction: float = 1e-8
    deadpoint_bound: float = 1e-12

    # --- bool settings (settings.c:37-45) ---
    perform_newton_step: bool = True
    global_penalty_resets: bool = True
    perform_soc: bool = True
    use_quadratic_model: bool = True
    always_warm_start_lp: bool = True
    enable_restoration_phase: bool = True
    enable_preprocessor: bool = False
    lp_resolves: bool = True

    # --- enum settings (settings.c:47-61) ---
    deriv_check: bool = False  # SLEQP_DERIV_CHECK_SKIP default
    hess_eval: HessEval = HessEval.EXACT
    dual_estimation_type: DualEstimationType = DualEstimationType.LSQ
    bfgs_sizing: BfgsSizing = BfgsSizing.CENTERED_OL
    tr_solver: TRSolver = TRSolver.AUTO
    polishing_type: Polishing = Polishing.ZERO_DUAL
    step_rule: StepRule = StepRule.DIRECT
    linesearch: Linesearch = Linesearch.APPROX
    parametric_cauchy: ParametricCauchy = ParametricCauchy.DISABLED
    aug_jac_method: AugJacMethod = AugJacMethod.AUTO
    initial_tr_choice: InitialTRChoice = InitialTRChoice.NARROW

    # --- int settings (settings.c:63-65) ---
    num_quasi_newton_iterates: int = 5
    max_newton_iterations: int = 100
    num_threads: int = -1  # SLEQP_NONE

    # --- additions without a reference equivalent ---
    # Dual-simplex warm starts: when a saved basis is primal infeasible
    # (trust radius changed) but still dual feasible, re-optimize with
    # dual pivots instead of crash-repairing the basis.
    lp_dual_warm_start: bool = True
    # Hard cap on simplex pivots per LP solve; -1 = auto (scales with size).
    max_lp_iterations: int = -1
    # Refactorize the simplex basis inverse every this many pivots.
    lp_refactor_every: int = 64
    # Cauchy LP backend: AUTO = simplex below pdlp_threshold LP columns
    # (n + 3m), first-order PDLP kernel above it.
    lp_solver: LPSolver = LPSolver.AUTO
    pdlp_threshold: int = 8192
    # KKT tolerance of the PDLP backend (needs to be well below stat_tol
    # for reliable working-set extraction from near-optimal iterates).
    pdlp_tol: float = 1e-9
    # dtype for all numerics ("float64" or "float32").
    dtype: str = "float64"
    # Working precision of the sequential inner solvers (simplex pivoting,
    # Krylov/GLTR trust-region loop): "same" keeps the state dtype;
    # "float32" runs them in single precision with float64 refinement of
    # every certified quantity (duals, residuals, LP extraction).
    compute_dtype: str = "same"
    # Numerical invariant checks (SLEQP_ENABLE_NUM_ASSERTS analogue,
    # trial_point.c:620-708): re-derive the trial direction bundle, the
    # model merit value, and dual/step finiteness every iteration and
    # record violations in SolverState.num_assert_fail; host loops raise.
    num_asserts: bool = False

    # Float-exception surveillance (pub_settings.h FLOAT_WARNING_FLAGS /
    # FLOAT_ERROR_FLAGS, math_error.h:33-63): "nonfinite" checks the
    # iterate's obj/cons values after each host-visible step.  Reference defaults: warn on all FP
    # exceptions (settings.c:50) and *error* on overflow/divbyzero/
    # invalid (settings.c:51).  Defaulting float_error_flags="none" here
    # is a deliberate deviation: nonfinite trial values are routine in
    # SLP globalization (the merit rejects them), and the in-graph check
    # cannot distinguish a benign rejected trial from a real fault.
    float_warning_flags: str = "nonfinite"
    float_error_flags: str = "none"

    def __post_init__(self) -> None:
        # Validate eagerly: a typo ("fp32") silently resolving to the
        # full-precision path would defeat the point of the setting.
        if self.compute_dtype not in ("same", "float32"):
            raise ValueError(
                f"compute_dtype must be 'same' or 'float32', "
                f"got {self.compute_dtype!r}"
            )
        if self.dtype not in ("float64", "float32"):
            raise ValueError(
                f"dtype must be 'float64' or 'float32', got {self.dtype!r}"
            )
        for name in ("float_warning_flags", "float_error_flags"):
            if getattr(self, name) not in ("none", "nonfinite"):
                raise ValueError(
                    f"{name} must be 'none' or 'nonfinite', "
                    f"got {getattr(self, name)!r}"
                )

    def replace(self, **kwargs: Any) -> "Settings":
        return dataclasses.replace(self, **kwargs)


_ENUM_FIELDS = {
    "hess_eval": HessEval,
    "dual_estimation_type": DualEstimationType,
    "bfgs_sizing": BfgsSizing,
    "tr_solver": TRSolver,
    "polishing_type": Polishing,
    "step_rule": StepRule,
    "linesearch": Linesearch,
    "parametric_cauchy": ParametricCauchy,
    "aug_jac_method": AugJacMethod,
    "initial_tr_choice": InitialTRChoice,
    "lp_solver": LPSolver,
}

_TRUE_STRINGS = {"true", "1", "yes", "on"}
_FALSE_STRINGS = {"false", "0", "no", "off"}


def _parse_value(name: str, raw: str, field_type: type) -> Any:
    raw = raw.strip()
    if name in _ENUM_FIELDS:
        enum_cls = _ENUM_FIELDS[name]
        key = raw.upper()
        if key in enum_cls.__members__:
            return enum_cls[key]
        try:
            return enum_cls(int(raw))
        except ValueError:
            raise ValueError(f"invalid value {raw!r} for enum setting {name!r}")
    if field_type is bool:
        low = raw.lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        raise ValueError(f"invalid boolean {raw!r} for setting {name!r}")
    if field_type is int:
        return int(raw)
    if field_type is float:
        return float(raw)
    return raw


def read_settings_string(text: str, base: Settings | None = None) -> Settings:
    """Parse ``key = value`` lines into a Settings instance.

    Mirrors the reference settings-file reader (settings.c:743-800):
    ``#``/``;`` start comments, blank lines are skipped, unknown keys raise.
    """
    settings = base if base is not None else Settings()
    fields = {f.name: f for f in dataclasses.fields(Settings)}
    updates: dict[str, Any] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.split("#", 1)[0].split(";", 1)[0].strip()
        if not stripped:
            continue
        if "=" not in stripped:
            raise ValueError(f"line {lineno}: expected 'key = value', got {line!r}")
        key, _, raw = stripped.partition("=")
        key = key.strip()
        if key not in fields:
            raise ValueError(f"line {lineno}: unknown setting {key!r}")
        field_type = type(getattr(settings, key))
        updates[key] = _parse_value(key, raw, field_type)
    return settings.replace(**updates)


def read_settings_file(path: str, base: Settings | None = None) -> Settings:
    """Read settings from a file (reference: sleqp_settings_read_file)."""
    with open(path, "r", encoding="utf-8") as handle:
        return read_settings_string(handle.read(), base)
