"""sleqp_tpu_torch: the PyTorch/CUDA port of sleqp_tpu.

It holds the structured (OCP) solve and the mixed-precision
block-tridiagonal solve layer (``ops/``).  The OCP's float32 route runs the
stage-Hessian and cyclic-reduction inverses through hand-written CUDA
kernels (``kernels/csrc/bgj.cu``); its float64 route is the oracle.  The
block-tridiagonal backends run the streaming block Thomas
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
from .settings import Settings
from .types import Status

__all__ = [
    "BlockStructuredProblem",
    "OCPState",
    "Settings",
    "Status",
    "ocp_initial_state",
    "ocp_perform_iteration",
    "ocp_solve",
]
