"""sleqp_tpu_torch: the PyTorch/CUDA port of sleqp_tpu.

It holds four solves.  The general dense SLP-EQP solve runs the
reference's iteration (``problem_solver.py``): a Cauchy LP by vertex
enumeration or the revised simplex (or the parametric sweep of its
radius), a GLTR, projected-CG or Gauss-Newton/LSQR Newton step on exact or
quasi-Newton Hessians, linesearches, and penalty and trust-region updates,
on ``torch.linalg`` factorizations.  Its entry point is
``Solver(problem, x0, settings).solve()`` (``solver.py``), which adds
scaling, presolve, restoration, polishing and callbacks.  The structured
(OCP) solve runs its float32 route through hand-written CUDA kernels
(``kernels/csrc/bgj.cu``), and the mixed-precision block-tridiagonal solve
layer (``ops/``) runs the streaming block Thomas
(``kernels/csrc/thomas.cu``) and the Cholesky block Thomas
(``kernels/csrc/chol_thomas.cu``).  The large-n paths solve banded NLPs
(``banded.py``: a block-tridiagonal condensed KKT solve per iteration,
float64 block Thomas or the float32 scan with refinement; like the OCP
solve, its loop runs as CUDA graphs with one host read an iteration,
``graphs.py``) and general
sparse NLPs matrix-free (``sparse.py``: reverse-mode products and
conjugate gradients, its loop as CUDA graphs with one read a block of CG
steps or PDHG iterations), with the PDLP Cauchy LP on operators that never
materialize the Jacobian.  The front ends are the scipy-style
``minimize`` (``minimize.py``), the AMPL ``.nl`` reader
(``harness/ampl.py``), checkpoints of a solver state (``checkpoint.py``),
the derivative check (``deriv_check.py``), the per-component profile of
an iteration (``profile.py``) and the command line,
``python -m sleqp_tpu_torch`` (``__main__.py``).  The package imports
``torch`` and ``numpy`` and nothing of JAX or of ``sleqp_tpu``.  Entry
points run on CUDA unless given ``device="cpu"``.
"""

from .banded import BandedProblem, banded_solve, banded_solve_from, banded_solve_jit
from .ocp import (
    BlockStructuredProblem,
    OCPState,
    batched_ocp_solve,
    ocp_initial_state,
    ocp_perform_iteration,
    ocp_solve,
)
from .iterate import Iterate, create_iterate, kkt_residuals
from .merit import Direction, merit_func, merit_linear, merit_quadratic
from .problem import Func, LSQFunc, Problem
from .problem_solver import SolverState, initial_state, perform_iteration, solve
from .scale import ScaledProblem, Scaling, derive_scaling
from .settings import Settings, read_settings_file, read_settings_string
from .solver import Solver, SolverEvent
from .sparse import SparseProblem, sparse_solve, sparse_solve_from, sparse_solve_jit
from .types import (
    ActiveState,
    AugJacMethod,
    BfgsSizing,
    CauchyObjective,
    DualEstimationType,
    HessEval,
    InitialTRChoice,
    Linesearch,
    LPSolver,
    MathError,
    ParametricCauchy,
    Polishing,
    SolverPhase,
    Status,
    StepRule,
    StepType,
    TRSolver,
)

__all__ = [
    "ActiveState",
    "AugJacMethod",
    "BandedProblem",
    "BfgsSizing",
    "BlockStructuredProblem",
    "CauchyObjective",
    "Direction",
    "DualEstimationType",
    "Func",
    "HessEval",
    "InitialTRChoice",
    "Iterate",
    "LPSolver",
    "LSQFunc",
    "Linesearch",
    "MathError",
    "OCPState",
    "ParametricCauchy",
    "Polishing",
    "Problem",
    "ScaledProblem",
    "Scaling",
    "Settings",
    "Solver",
    "SolverEvent",
    "SolverPhase",
    "SolverState",
    "SparseProblem",
    "Status",
    "StepRule",
    "StepType",
    "TRSolver",
    "banded_solve",
    "banded_solve_from",
    "banded_solve_jit",
    "batched_ocp_solve",
    "create_iterate",
    "derive_scaling",
    "initial_state",
    "kkt_residuals",
    "merit_func",
    "merit_linear",
    "merit_quadratic",
    "minimize",
    "ocp_initial_state",
    "ocp_perform_iteration",
    "ocp_solve",
    "perform_iteration",
    "read_settings_file",
    "read_settings_string",
    "solve",
    "sparse_solve",
    "sparse_solve_from",
    "sparse_solve_jit",
]


def __getattr__(name: str):
    # minimize imports scipy: loaded on first use
    if name == "minimize":
        from .minimize import minimize as _minimize

        return _minimize
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
