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
float64 block Thomas or the float32 scan with refinement) and general
sparse NLPs matrix-free (``sparse.py``: reverse-mode products and
conjugate gradients), with the PDLP Cauchy LP on operators that never
materialize the Jacobian.  The package imports ``torch`` and
``numpy`` and nothing of JAX or of ``sleqp_tpu``.  Entry points run on
CUDA unless given ``device="cpu"``.
"""

from .banded import BandedProblem, banded_solve
from .ocp import (
    BlockStructuredProblem,
    OCPState,
    batched_ocp_solve,
    ocp_initial_state,
    ocp_perform_iteration,
    ocp_solve,
)
from .iterate import create_iterate
from .problem import Func, LSQFunc, Problem
from .problem_solver import SolverState, initial_state, perform_iteration, solve
from .scale import Scaling
from .settings import Settings, read_settings_file, read_settings_string
from .solver import Solver, SolverEvent
from .sparse import SparseProblem, sparse_solve
from .types import (
    ActiveState,
    AugJacMethod,
    BfgsSizing,
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
    "DualEstimationType",
    "Func",
    "HessEval",
    "InitialTRChoice",
    "LPSolver",
    "LSQFunc",
    "Linesearch",
    "MathError",
    "OCPState",
    "ParametricCauchy",
    "Polishing",
    "Problem",
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
    "batched_ocp_solve",
    "create_iterate",
    "initial_state",
    "ocp_initial_state",
    "ocp_perform_iteration",
    "ocp_solve",
    "perform_iteration",
    "read_settings_file",
    "read_settings_string",
    "solve",
    "sparse_solve",
]
