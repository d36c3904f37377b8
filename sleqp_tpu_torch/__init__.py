"""sleqp_tpu_torch: the PyTorch/CUDA port of sleqp_tpu.

It holds two solves.  The general dense SLP-EQP solve (``Func``,
``Problem``, ``solve``; ``problem_solver.py``) runs the reference's
iteration: a Cauchy LP by vertex enumeration or the revised simplex, a
GLTR or projected-CG Newton step, linesearches, and penalty and
trust-region updates, on ``torch.linalg`` factorizations.  The structured
(OCP) solve runs its float32 route through hand-written CUDA kernels
(``kernels/csrc/bgj.cu``), and the mixed-precision block-tridiagonal solve
layer (``ops/``) runs the streaming block Thomas
(``kernels/csrc/thomas.cu``) and the Cholesky block Thomas
(``kernels/csrc/chol_thomas.cu``).  The package imports ``torch`` and
``numpy`` and nothing of JAX or of ``sleqp_tpu``.  Entry points run on
CUDA unless given ``device="cpu"``.
"""

from .ocp import (
    BlockStructuredProblem,
    OCPState,
    ocp_initial_state,
    ocp_perform_iteration,
    ocp_solve,
)
from .problem import Func, Problem
from .problem_solver import SolverState, initial_state, perform_iteration, solve
from .settings import Settings, read_settings_file, read_settings_string
from .types import Status

__all__ = [
    "BlockStructuredProblem",
    "Func",
    "OCPState",
    "Problem",
    "Settings",
    "SolverState",
    "Status",
    "initial_state",
    "ocp_initial_state",
    "ocp_perform_iteration",
    "ocp_solve",
    "perform_iteration",
    "read_settings_file",
    "read_settings_string",
    "solve",
]
