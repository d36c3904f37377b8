"""First-order LP solver (restarted average PDHG, after PDLP).

Port of ``sleqp_tpu/ops/pdlp.py``: the fallback for large Cauchy LPs.  For

    min c^T x   s.t.  A x = 0,   lb <= x <= ub

(the form of ``ops/simplex.py``, +-1e20 as infinity) primal-dual hybrid
gradient alternates

    x_{k+1} = proj_box(x_k - tau (c + A^T y_k))
    y_{k+1} = y_k + sigma A (2 x_{k+1} - x_k)

with tau sigma ||A||_2^2 < 1 (||A|| by power iteration), Ruiz
equilibration, restart to the better of the current iterate and the
running average when the KKT error has decayed enough, and an adaptive
primal weight (Applegate et al., "Practical large-scale linear programming
using primal-dual hybrid gradient", NeurIPS 2021).  Basis statuses are
synthesized from bound proximity and reduced-cost signs; there is no
simplex basis.

The reference runs one ``lax.while_loop`` whose body checks the restart
criterion every ``check_every`` iterations.  Here the iterations run in
blocks of ``check_every`` with no host read inside a block, as the trips of
a ``lanes.lockstep`` loop; each check decides the restart on the device
(``torch.where``) and the host reads one flag a block, for one LP or for a
batch of them under ``torch.func.vmap`` (a lane that is done is frozen by a
select).  The iteration numbering is the reference's: checks fire at
multiples of ``check_every``, and ``max_iterations`` cuts the last block
short.  The products ``A @ x`` and ``y @ A`` are plain matrix products in
the state dtype, never in TF32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..iterate import max0
from ..kernels._build import require_full_fp32
from ..lanes import lockstep
from ..types import INF_THRESHOLD, BaseStat

Tensor = torch.Tensor

OPTIMAL = 0
ITERATION_LIMIT = 1


class PDLPResult(NamedTuple):
    x: Tensor  # (N,) primal solution
    duals: Tensor  # (m,) row duals y (sign convention of simplex.solve)
    reduced_costs: Tensor  # (N,) c - A^T y
    status: Tensor  # (N,) int8 synthesized BaseStat per column
    obj: Tensor
    state: Tensor  # int32 OPTIMAL / ITERATION_LIMIT
    iterations: Tensor  # int32 PDHG iterations
    primal_res: Tensor  # ||A x||_inf
    dual_res: Tensor  # ||proj of reduced costs||_inf


class DenseOp:
    """Operator view of a dense constraint matrix.

    PDHG touches A only through matrix-vector products and |A| row and
    column maxima, so the solver runs on any operator with this protocol
    (``mv``, ``rmv``, ``scaled_row_max``, ``scaled_col_max``, ``shape``,
    ``dtype``), such as a banded Jacobian stored as diagonals.
    """

    def __init__(self, A: Tensor):
        self.A = A
        self.shape = tuple(A.shape)
        self.dtype = A.dtype
        self.device = A.device

    def mv(self, x: Tensor) -> Tensor:  # A @ x
        return self.A @ x

    def rmv(self, y: Tensor) -> Tensor:  # A^T y
        return y @ self.A

    def scaled_row_max(self, d_c: Tensor) -> Tensor:  # max_j |A_ij| d_c[j]
        return (self.A.abs() * d_c[None, :]).amax(dim=1)

    def scaled_col_max(self, d_r: Tensor) -> Tensor:  # max_i |A_ij| d_r[i]
        return (self.A.abs() * d_r[:, None]).amax(dim=0)


def _as_op(A):
    # a tensor has an ``mv`` method of its own: test for the tensor
    return DenseOp(A) if isinstance(A, Tensor) else A


def _ruiz_equilibrate(op, iters: int = 10):
    """Ruiz row/column inf-norm equilibration: (d_r, d_c) with
    D_r A D_c well scaled."""
    m, N = op.shape
    d_r = torch.ones((m,), dtype=op.dtype, device=op.device)
    d_c = torch.ones((N,), dtype=op.dtype, device=op.device)
    for _ in range(iters):
        row = torch.sqrt(torch.clamp(d_r * op.scaled_row_max(d_c), min=1e-30))
        col = torch.sqrt(torch.clamp(d_c * op.scaled_col_max(d_r), min=1e-30))
        d_r, d_c = d_r / row, d_c / col
    return d_r, d_c


def _norm_estimate(op, d_r: Tensor, d_c: Tensor, iters: int = 30) -> Tensor:
    """Power iteration for ||D_r A D_c||_2 (deterministic start)."""
    m, N = op.shape
    v = torch.full((N,), 1.0 / math.sqrt(N), dtype=op.dtype, device=op.device)
    for _ in range(iters):
        w = d_r * op.mv(d_c * v)
        u = d_c * op.rmv(d_r * w)
        v = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-30)
    return torch.linalg.vector_norm(d_r * op.mv(d_c * v)) + 1e-12


def _proj(x: Tensor, lb: Tensor, ub: Tensor) -> Tensor:
    return torch.minimum(torch.maximum(x, lb), ub)


def _kkt_residuals(op, c, lb, ub, x, y):
    """(||Ax||_inf, max(dual infeasibility, relative duality gap)) for the
    box LP in the simplex dual sign convention, r = c - A^T y."""
    r = c - op.rmv(y)
    finite_lb = lb > -INF_THRESHOLD
    finite_ub = ub < INF_THRESHOLD
    r_pos = torch.clamp(r, min=0.0)
    r_neg = torch.clamp(r, max=0.0)
    dinf = torch.where(finite_lb, 0.0, r_pos) - torch.where(finite_ub, 0.0, r_neg)
    dres = max0(dinf)
    dual_obj = (torch.where(finite_lb, lb, 0.0) * r_pos
                + torch.where(finite_ub, ub, 0.0) * r_neg).sum()
    pobj = torch.dot(c, x)
    gap = (pobj - dual_obj).abs() / (1.0 + pobj.abs() + dual_obj.abs())
    pres = max0(op.mv(x).abs())
    return pres, torch.maximum(dres, gap)


# the PDHG iterations between two restart checks (``solve``'s default)
CHECK_EVERY = 64


class Setup(NamedTuple):
    """What a PDLP solve's blocks and finish take from its start: the LP
    (bounds clamped to +-1e18), the Ruiz scaling vectors, the scaled
    objective and bounds, the estimate of ||D_r A D_c||_2 and the tolerance
    scaled by the objective."""

    c: Tensor
    lb: Tensor
    ub: Tensor
    d_r: Tensor
    d_c: Tensor
    cb: Tensor
    lbb: Tensor
    ubb: Tensor
    Anorm: Tensor
    rtol: Tensor


def start(op, c: Tensor, lb: Tensor, ub: Tensor, x0: Tensor | None = None,
          y0: Tensor | None = None, tol: float = 1e-8):
    """The start of a solve on the operator ``op``: (``Setup``, the loop
    state before the first block)."""
    m, N = op.shape
    dtype, dev = op.dtype, op.device
    # clamp infinities so the projection arithmetic stays finite
    big = torch.full((), 1e18, dtype=dtype, device=dev)
    lb = torch.maximum(lb, -big)
    ub = torch.minimum(ub, big)

    # Ruiz scaling kept as vectors: D_r A D_c applied on the fly
    d_r, d_c = _ruiz_equilibrate(op)
    cb = c * d_c
    lbb = lb / d_c
    ubb = ub / d_c

    x = _proj(torch.zeros((N,), dtype=dtype, device=dev) if x0 is None else x0 / d_c, lbb, ubb)
    y = torch.zeros((m,), dtype=dtype, device=dev) if y0 is None else y0 / d_r

    Anorm = _norm_estimate(op, d_r, d_c)
    rtol = tol * (1.0 + c.abs().amax())
    setup = Setup(c=c, lb=lb, ub=ub, d_r=d_r, d_c=d_c, cb=cb, lbb=lbb, ubb=ubb, Anorm=Anorm,
                  rtol=rtol)
    loop = dict(
        x=x, y=y, x_sum=torch.zeros_like(x), y_sum=torch.zeros_like(y),
        navg=torch.zeros((), dtype=dtype, device=dev),
        x_anchor=x, y_anchor=y,
        omega=torch.ones((), dtype=dtype, device=dev),  # primal weight
        e_last=torch.full((), math.inf, dtype=dtype, device=dev),  # KKT error at the last restart
        since=torch.zeros((), dtype=torch.int32, device=dev),  # iterations since the last restart
        it=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
    )
    return setup, loop


def block_length(trip: int, max_iterations: int, check_every: int = CHECK_EVERY) -> int:
    """The PDHG iterations of block ``trip``: ``check_every``, fewer where
    ``max_iterations`` cuts the last block short."""
    return min(check_every, max_iterations - trip * check_every)


def running(s: dict, max_iterations: int) -> Tensor:
    """Whether the loop state ``s`` goes on: not done, below the cap."""
    return ~s["done"] & (s["it"] < max_iterations)


def block(op, setup: Setup, s: dict, length: int, check_every: int = CHECK_EVERY,
          adaptive_weight: bool = True) -> dict:
    """``length`` PDHG iterations from the loop state ``s`` with no host
    read, then, for a whole block of ``check_every``, the restart check."""
    cb, lbb, ubb = setup.cb, setup.lbb, setup.ubb
    d_r, d_c, Anorm = setup.d_r, setup.d_c, setup.Anorm
    x, y, x_sum, y_sum = s["x"], s["y"], s["x_sum"], s["y_sum"]
    omega = s["omega"]
    # primal weight omega tracks ||dy||/||dx||: tau = eta/omega,
    # sigma = eta*omega (tau*sigma*||A||^2 < 1 for any omega)
    tau = 0.9 / (omega * Anorm)
    sigma = 0.9 * omega / Anorm
    for _ in range(length):
        x_new = _proj(x - tau * (cb + d_c * op.rmv(d_r * y)), lbb, ubb)
        y = y + sigma * (d_r * op.mv(d_c * (2.0 * x_new - x)))
        x = x_new
        x_sum = x_sum + x
        y_sum = y_sum + y
    out = dict(s, x=x, y=y, x_sum=x_sum, y_sum=y_sum, navg=s["navg"] + length,
               since=s["since"] + length, it=s["it"] + length)
    if length < check_every:
        return out  # max_iterations cut the block short: no check

    def orig_residuals(xb, yb):
        """KKT residuals in the original space (simplex sign convention)."""
        return _kkt_residuals(op, setup.c, setup.lb, setup.ub, d_c * xb, -(d_r * yb))

    # ---- candidate evaluation + adaptive restart ----------------------
    # restart to the better of {current, average} when the KKT error
    # decayed enough since the last restart (beta = 0.2) or the period
    # grew too long
    navg, since = out["navg"], out["since"]
    x_avg = _proj(x_sum / torch.clamp(navg, min=1.0), lbb, ubb)
    y_avg = y_sum / torch.clamp(navg, min=1.0)
    pc, dc_ = orig_residuals(x, y)
    pa, da = orig_residuals(x_avg, y_avg)
    e_cur = pc + dc_
    e_avg = pa + da
    take_avg = e_avg < e_cur
    xr = torch.where(take_avg, x_avg, x)
    yr = torch.where(take_avg, y_avg, y)
    e_best = torch.minimum(e_avg, e_cur)
    rtol = setup.rtol
    done = torch.where(take_avg, (pa <= rtol) & (da <= rtol), (pc <= rtol) & (dc_ <= rtol))
    restart = done | (e_best <= 0.2 * s["e_last"]) | (since >= 4096)

    if adaptive_weight:
        dx = torch.linalg.vector_norm(xr - s["x_anchor"])
        dy = torch.linalg.vector_norm(yr - s["y_anchor"])
        valid = (dx > 1e-12) & (dy > 1e-12)
        omega_r = torch.where(valid, torch.exp(0.5 * torch.log(dy / dx) + 0.5 * torch.log(omega)),
                              omega)
        omega_r = torch.clamp(omega_r, 1e-4, 1e4)
    else:
        omega_r = omega

    return dict(
        out,
        x=torch.where(restart, xr, x),
        y=torch.where(restart, yr, y),
        x_sum=torch.where(restart, 0.0, x_sum),
        y_sum=torch.where(restart, 0.0, y_sum),
        navg=torch.where(restart, 0.0 * navg, navg),
        x_anchor=torch.where(restart, xr, s["x_anchor"]),
        y_anchor=torch.where(restart, yr, s["y_anchor"]),
        omega=torch.where(restart, omega_r, omega),
        e_last=torch.where(restart, e_best, s["e_last"]),
        since=torch.where(restart, 0, since).to(torch.int32),
        done=done,
    )


def finish(op, setup: Setup, loop: dict) -> PDLPResult:
    """The result of a solve whose loop ended in the state ``loop``: the
    unscaled primal and duals, the residuals and synthesized statuses."""
    c, lb, ub = setup.c, setup.lb, setup.ub
    x, y = setup.d_c * loop["x"], setup.d_r * loop["y"]
    # the simplex dual sign convention: reduced costs r = c - y A with y
    # such that r >= 0 at lower bounds at optimality
    y_out = -y
    r = c - op.rmv(y_out)
    pres, dres = _kkt_residuals(op, c, lb, ub, x, y_out)

    # ---- synthesized basis statuses -----------------------------------
    eps = 1e-7
    at_lb = (lb > -INF_THRESHOLD) & (x <= lb + eps * (1.0 + lb.abs()))
    at_ub = (ub < INF_THRESHOLD) & (x >= ub - eps * (1.0 + ub.abs()))
    status = torch.where(at_lb & (r > 0.0), int(BaseStat.LOWER),
                         torch.where(at_ub & (r < 0.0), int(BaseStat.UPPER),
                                     int(BaseStat.BASIC))).to(torch.int8)
    rtol = setup.rtol
    state = torch.where((pres <= rtol) & (dres <= rtol), OPTIMAL, ITERATION_LIMIT).to(torch.int32)
    return PDLPResult(
        x=x,
        duals=y_out,
        reduced_costs=r,
        status=status,
        obj=torch.dot(c, x),
        state=state,
        iterations=loop["it"],
        primal_res=pres,
        dual_res=dres,
    )


def solve(
    A,
    c: Tensor,
    lb: Tensor,
    ub: Tensor,
    x0: Tensor | None = None,
    y0: Tensor | None = None,
    max_iterations: int = 20000,
    tol: float = 1e-8,
    check_every: int = CHECK_EVERY,
    adaptive_weight: bool = True,
) -> PDLPResult:
    """Restarted-average PDHG with Ruiz equilibration and adaptive primal
    weight, to KKT tolerance ``tol`` (scaled, measured in the original
    problem space).  ``A`` is a dense (m, N) tensor or an operator with the
    ``DenseOp`` protocol.  Runs where ``A`` lives; the host reads one flag
    every ``check_every`` iterations: ``start``, a ``lockstep`` loop of
    ``block``s and ``finish``."""
    op = _as_op(A)
    if op.device.type == "cuda":
        require_full_fp32()
    setup, loop = start(op, c, lb, ub, x0=x0, y0=y0, tol=tol)

    def trip_block(s, trip):
        # every active lane has run ``trip`` whole blocks, so the block's
        # length is the same on all of them
        return block(op, setup, s, block_length(trip, max_iterations, check_every), check_every,
                     adaptive_weight)

    # the flag is read after each whole block (the cap is part of it), never
    # after a block that max_iterations cut short: max_trips ends the loop
    # there
    loop = lockstep(lambda s: running(s, max_iterations), trip_block, loop,
                    max_trips=max_iterations // check_every + 1, first=True)
    return finish(op, setup, loop)
