"""Banded general-inequality NLPs through a structured SQP loop.

Port of ``sleqp_tpu/banded.py`` (SURVEY.md §5.7, BASELINE config 3).
Variables are grouped into N_b blocks of size k, and each constraint block
couples two adjacent variable blocks:

    min  sum_t f_t(x_t)
    s.t. clb_t <= c_t(x_t, x_{t+1}) <= cub_t      t = 0..N_b-2
         lb <= x <= ub

All data stays O(N_b (k^2 + q k)), never the dense (m, n) Jacobian:

* the Jacobian as two (q, k) blocks per row block, the Lagrangian Hessian
  as block-tridiagonal (k, k) blocks, both by reverse-mode AD
  (``torch.func``) batched over the blocks;
* the working set: epsilon-active rows with wrong-sign duals dropped,
  optionally seeded by a matrix-free PDLP solve of the reference Cauchy LP
  (``banded_cauchy``), whose operator never materializes [J, I, -I, -I];
* the EQP step: the active-set KKT system condensed to the SPD
  block-tridiagonal K = H + rho I + (1/delta) J_W^T J_W, in delta form,
  solved by the float64 block Thomas (``ops/block_tridiag.py``) or, on the
  mixed route, by the float32 Cholesky block-Thomas scan with three
  float64 refinements (``block_tridiag_solve_mp(backend="scan32")``);
* l1 exact-penalty merit, backtracking Armijo linesearch, Levenberg
  regularization on the reference's 0.9/0.3 thresholds, the penalty kept
  above the multiplier scale, and a Gauss-Newton restoration phase.

Derivatives.  The reference takes ``vmap(jacfwd)`` and ``vmap(hessian)``
over the blocks.  Here the transform is outside and the batching over
blocks inside: the Jacobian blocks are the vjps of the batched constraint
function with each unit cotangent set on every block at once, and the
Hessian blocks the same vjps of the batched gradient.  The blocks are
independent, so this gives each block's derivative alone.  The order
matters because a callable indexes its data by the block index ``t``
(``W[t]``): under ``torch.func.vmap`` with ``grad`` or ``jacrev`` inside,
indexing by a batched 0-d tensor fails, and with ``vmap`` inside it works.
Reverse mode only: PyTorch's forward mode gives the tangent of a 0-d
float32 tensor times a Python float in float64.

The mixed configuration (``Settings(compute_dtype="float32")`` on a float64
problem) calls the callables on float32 tensors to assemble the Jacobian
and Hessian blocks, which come back in the problem dtype; feasibility, the
stationarity residual and the merit stay float64.  A callable must follow
its arguments' dtype (``types.py``), for example ``W.to(x)[t]``.

The reference's ``lax.while_loop``s and ``lax.cond``s become host
decisions: the iteration loop is one eager loop that reads the status and
the phase together, an iteration reads its stop flags once, and the Armijo
loop one flag a trial.  ``banded_solve_jit`` has no counterpart.  Entry
points run where the problem lives: ``BandedProblem(device=None)`` means
CUDA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch.func import grad, vjp, vmap

from .device import resolve_device
from .iterate import max0
from .kernels._build import require_full_fp32
from .ops import pdlp
from .ops.block_tridiag import block_tridiag_solve
from .ops.pallas_tridiag import block_tridiag_solve_mp
from .settings import Settings
from .types import DTYPE_MISMATCH, INF_THRESHOLD, ActiveState, HessEval, SolverPhase, Status

Tensor = torch.Tensor

REG_MIN = 1e-10
REG_MAX = 1e10
REG_FAIL = 1e-4
MAX_LINESEARCH_STEPS = 30
DELTA = 1e-8  # augmented-Lagrangian condensation regularization (float64 route)
# Mixed-precision condensation regularization: 1/delta sets the K
# conditioning the float32 factorization must survive; the delta-form
# constraint error O(delta * ||dlam||) vanishes as SQP converges.
DELTA_MIXED = 1e-4
# Consecutive infeasible rejections before the optimality loop hands over
# to the restoration phase (solver/phase.c analogue).
RESTORATION_TRIGGER = 4

_MIXED_DTYPE_HINT = (
    "with Settings(compute_dtype='float32') the block callables are called on "
    "float32 tensors and must compute in their arguments' dtype and device (for "
    "example W.to(x)[t]); a callable that closes over a float64 tensor computes "
    "in float64 or fails, and the float32 route never runs it in float64"
)


def _shift_add(base: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """``base.at[:-1].add(lo).at[1:].add(hi)`` on a fresh tensor: lo adds to
    the blocks 0..N-2, hi to the blocks 1..N-1, in that order."""
    z = torch.zeros_like(lo[:1])
    return base + torch.cat([lo, z]) + torch.cat([z, hi])


def _unit_cotangents(width: int, blocks: int, dtype, device) -> Tensor:
    """(width, blocks, width): the i-th slice sets e_i on every block."""
    eye = torch.eye(width, dtype=dtype, device=device)
    return eye[:, None, :].expand(width, blocks, width)


def _scalar(value, dtype, device) -> Tensor:
    # a fill, not a copy from the host: no synchronization on the card
    return torch.full((), value, dtype=dtype, device=device)


class BandedProblem:
    """Block-banded NLP front end.

    obj_block(x_t, t) -> scalar (summed over t = 0..N_b-1)
    cons_block(x_t, x_next, t) -> (q,) for t = 0..N_b-2

    The bounds broadcast to (N_b, k) and (N_b-1, q).  The problem lives on
    ``device`` (``None`` means CUDA).
    """

    def __init__(
        self,
        obj_block: Callable,
        num_blocks: int,
        block_size: int,
        cons_block: Optional[Callable] = None,
        cons_per_block: int = 0,
        var_lb: Any = -math.inf,
        var_ub: Any = math.inf,
        cons_lb: Any = None,
        cons_ub: Any = None,
        dtype: torch.dtype = torch.float64,
        device: Any = None,
    ):
        self.obj_block = obj_block
        self.cons_block = cons_block
        self.N_b = int(num_blocks)
        self.k = int(block_size)
        self.q = int(cons_per_block)
        if self.N_b < 2:
            raise ValueError("BandedProblem needs at least 2 blocks")
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n = self.N_b * self.k
        self.m = (self.N_b - 1) * self.q

        def expand(v, shape, default):
            if v is None:
                v = default
            v = torch.as_tensor(v, dtype=self.dtype, device=self.device)
            return v.expand(shape).clone()

        self.var_lb = expand(var_lb, (self.N_b, self.k), -math.inf)
        self.var_ub = expand(var_ub, (self.N_b, self.k), math.inf)
        if self.q:
            self.cons_lb = expand(cons_lb, (self.N_b - 1, self.q), -math.inf)
            self.cons_ub = expand(cons_ub, (self.N_b - 1, self.q), math.inf)
        else:
            self.cons_lb = torch.zeros((0, 0), dtype=self.dtype, device=self.device)
            self.cons_ub = torch.zeros((0, 0), dtype=self.dtype, device=self.device)
        self.ts = torch.arange(self.N_b, device=self.device)
        self._follows_dtype_checked = False

    # -- evaluations batched over the blocks (O(N_b * block work)) --------

    def _obj_sum(self, X: Tensor) -> Tensor:
        return vmap(self.obj_block)(X, self.ts).sum()

    def _cons_blocks(self, Xa: Tensor, Xb: Tensor) -> Tensor:
        return vmap(self.cons_block)(Xa, Xb, self.ts[:-1])

    def obj(self, X: Tensor) -> Tensor:
        return self._obj_sum(X)

    def obj_grad(self, X: Tensor) -> Tensor:
        return grad(self._obj_sum)(X)

    def cons(self, X: Tensor) -> Tensor:
        """(N_b-1, q) constraint values."""
        return self._cons_blocks(X[:-1], X[1:])

    def _mixed(self, compute_dtype) -> bool:
        return compute_dtype == torch.float32 and self.dtype == torch.float64

    def _check_follows_dtype(self, X32: Tensor) -> None:
        """Raise ``TypeError`` unless the callables compute in the dtype of
        their float32 arguments; any other error of a callable propagates
        unchanged.  Run once per problem."""
        if self._follows_dtype_checked:
            return
        t = self.ts[0]
        try:
            outs = [self.obj_block(X32[0], t)]
            if self.q:
                outs.append(self.cons_block(X32[0], X32[1], t))
        except RuntimeError as exc:
            if not DTYPE_MISMATCH.search(str(exc)):
                raise
            raise TypeError(_MIXED_DTYPE_HINT) from exc
        if any(torch.as_tensor(o).dtype != X32.dtype for o in outs):
            raise TypeError(_MIXED_DTYPE_HINT)
        self._follows_dtype_checked = True

    def _in_compute_dtype(self, X: Tensor, compute_dtype) -> Tensor:
        if not self._mixed(compute_dtype):
            return X
        X32 = X.to(torch.float32)
        self._check_follows_dtype(X32)
        return X32

    def cons_jac_blocks(self, X: Tensor, compute_dtype=None):
        """Jl, Jr: (N_b-1, q, k) left/right Jacobian blocks, by q reverse
        passes batched over the blocks.

        ``compute_dtype=torch.float32`` calls the callables on float32
        tensors and returns the blocks in the problem dtype, with float32
        accuracy: a backward perturbation of the EQP, while feasibility and
        the stationarity residual stay exact (``cons_jtvp``)."""
        Xc = self._in_compute_dtype(X, compute_dtype)
        Nc = self.N_b - 1
        _, pull = vjp(self._cons_blocks, Xc[:-1], Xc[1:])
        Jl, Jr = vmap(pull)(_unit_cotangents(self.q, Nc, Xc.dtype, Xc.device))
        return Jl.transpose(0, 1).to(self.dtype), Jr.transpose(0, 1).to(self.dtype)

    def cons_jtvp(self, X: Tensor, lam: Tensor) -> Tensor:
        """J^T lam accumulated per variable block, (N_b, k), by one reverse
        pass: exact in the problem dtype whatever dtype the materialized
        Jacobian blocks were assembled in."""
        if not self.q:
            return torch.zeros((self.N_b, self.k), dtype=self.dtype, device=X.device)
        _, pull = vjp(self._cons_blocks, X[:-1], X[1:])
        da, db = pull(lam)
        return _shift_add(torch.zeros_like(X), da, db)

    @staticmethod
    def _hess_blocks(f: Callable, Z: Tensor) -> Tensor:
        """(B, w, w) Hessian blocks of a sum f(Z) = sum_b f_b(Z[b]) of
        independent blocks: w vjps of its gradient, each batched over the
        blocks."""
        B, w = Z.shape
        _, pull = vjp(grad(f), Z)
        (H,) = vmap(pull)(_unit_cotangents(w, B, Z.dtype, Z.device))
        return H.transpose(0, 1)

    def lag_hess_blocks(self, X: Tensor, lam: Tensor, compute_dtype=None):
        """Block-tridiagonal Lagrangian Hessian: Hd (N_b, k, k) diagonals,
        Hs (N_b-1, k, k) sub-diagonals (rows t+1, cols t).
        ``compute_dtype=torch.float32``: the float32 assembly of
        ``cons_jac_blocks``."""
        Xc = self._in_compute_dtype(X, compute_dtype)
        lamc = lam.to(Xc.dtype)
        k = self.k
        Hd = self._hess_blocks(self._obj_sum, Xc)
        if not self.q:
            Hs = torch.zeros((self.N_b - 1, k, k), dtype=Hd.dtype, device=Hd.device)
            return Hd.to(self.dtype), Hs.to(self.dtype)

        def pair_lag(z, lam_t, t):
            return torch.dot(lam_t, self.cons_block(z[:k], z[k:], t))

        def lag_sum(Z):
            return vmap(pair_lag)(Z, lamc, self.ts[:-1]).sum()

        M = self._hess_blocks(lag_sum, torch.cat([Xc[:-1], Xc[1:]], dim=1))
        A = M[:, :k, :k]  # d2/da2
        B = M[:, :k, k:]  # d2/da db
        C = M[:, k:, k:]  # d2/db2
        Hd = _shift_add(Hd, A, C)
        Hs = B.transpose(1, 2)  # rows x_{t+1}, cols x_t
        return Hd.to(self.dtype), Hs.to(self.dtype)

    def clip(self, X: Tensor) -> Tensor:
        return torch.minimum(torch.maximum(X, self.var_lb), self.var_ub)


# ---------------------------------------------------------------------------
# Matrix-free Cauchy LP (reference standard_cauchy.c LP, PDLP backend)
# ---------------------------------------------------------------------------


class BandedCauchyOp:
    """Operator view of the Cauchy LP matrix A = [J, I, -I, -I] for a
    block-bidiagonal J, with ``ops/pdlp.py``'s ``DenseOp`` protocol.
    Columns: d (n), s+ (m), s- (m), w (m); rows: J d + s+ - s- - w = 0
    (cauchy.py layout, standard_cauchy.c:203-244), never materialized."""

    def __init__(self, Jl: Tensor, Jr: Tensor):
        self.Jl, self.Jr = Jl, Jr
        self.Nc, self.q, self.k = Jl.shape
        self.N_b = self.Nc + 1
        n, m = self.N_b * self.k, self.Nc * self.q
        self.n, self.m_rows = n, m
        self.shape = (m, n + 3 * m)
        self.dtype = Jl.dtype
        self.device = Jl.device

    def _split(self, x: Tensor):
        n, m = self.n, self.m_rows
        return x[:n], x[n : n + m], x[n + m : n + 2 * m], x[n + 2 * m :]

    def _jmv(self, d: Tensor) -> Tensor:
        D = d.reshape(self.N_b, self.k)
        out = torch.einsum("tqk,tk->tq", self.Jl, D[:-1])
        out = out + torch.einsum("tqk,tk->tq", self.Jr, D[1:])
        return out.reshape(-1)

    def _jtmv(self, y: Tensor) -> Tensor:
        Y = y.reshape(self.Nc, self.q)
        out = torch.zeros((self.N_b, self.k), dtype=self.dtype, device=self.device)
        out = _shift_add(out, torch.einsum("tqk,tq->tk", self.Jl, Y),
                         torch.einsum("tqk,tq->tk", self.Jr, Y))
        return out.reshape(-1)

    def mv(self, x: Tensor) -> Tensor:
        d, sp, sm, w = self._split(x)
        return self._jmv(d) + sp - sm - w

    def rmv(self, y: Tensor) -> Tensor:
        return torch.cat([self._jtmv(y), y, -y, -y])

    def scaled_row_max(self, d_c: Tensor) -> Tensor:
        d, sp, sm, w = self._split(d_c)
        D = d.reshape(self.N_b, self.k)
        jmax = torch.maximum(
            (self.Jl.abs() * D[:-1, None, :]).amax(dim=2),
            (self.Jr.abs() * D[1:, None, :]).amax(dim=2),
        ).reshape(-1)
        return torch.maximum(jmax, torch.maximum(sp, torch.maximum(sm, w)))

    def scaled_col_max(self, d_r: Tensor) -> Tensor:
        Y = d_r.reshape(self.Nc, self.q)
        lo = (self.Jl.abs() * Y[:, :, None]).amax(dim=1)
        hi = (self.Jr.abs() * Y[:, :, None]).amax(dim=1)
        z = torch.zeros_like(lo[:1])
        # the reference's .at[:-1].max / .at[1:].max on zeros
        col = torch.zeros((self.N_b, self.k), dtype=self.dtype, device=self.device)
        col = torch.maximum(torch.maximum(col, torch.cat([lo, z])), torch.cat([z, hi]))
        return torch.cat([col.reshape(-1), d_r, d_r, d_r])


def banded_cauchy(
    problem: BandedProblem,
    X: Tensor,
    trust_radius: Any,
    penalty: Any,
    tol: float = 1e-7,
    max_iterations: int = 20000,
):
    """Reference Cauchy LP on the banded problem via matrix-free PDLP.

    Returns (d, var_states, cons_states, pdlp_result): the l-inf
    trust-region LP step and the working-set estimate extracted from bound
    proximity and reduced-cost signs (the information the reference reads
    off the LP basis, standard_cauchy.c:843-1005).  Runs where ``X`` lives.
    """
    dtype, dev = problem.dtype, X.device
    trust_radius = torch.as_tensor(trust_radius, dtype=dtype, device=dev)
    penalty = torch.as_tensor(penalty, dtype=dtype, device=dev)
    Jl, Jr = problem.cons_jac_blocks(X)
    C = problem.cons(X).reshape(-1)
    g = problem.obj_grad(X).reshape(-1)
    op = BandedCauchyOp(Jl, Jr)
    n, m = op.n, op.m_rows

    big = _scalar(1e20, dtype, dev)
    x_flat = X.reshape(-1)
    vlb = problem.var_lb.reshape(-1)
    vub = problem.var_ub.reshape(-1)
    d_lb = torch.maximum(torch.where(vlb < -INF_THRESHOLD, -big, vlb - x_flat), -trust_radius)
    d_ub = torch.minimum(torch.where(vub > INF_THRESHOLD, big, vub - x_flat), trust_radius)
    clb = problem.cons_lb.reshape(-1)
    cub = problem.cons_ub.reshape(-1)
    w_lb = torch.where(clb < -INF_THRESHOLD, -big, clb - C)
    w_ub = torch.where(cub > INF_THRESHOLD, big, cub - C)
    zeros = torch.zeros((m,), dtype=dtype, device=dev)
    infs = torch.full((m,), 1e20, dtype=dtype, device=dev)
    lb = torch.cat([d_lb, zeros, zeros, w_lb])
    ub = torch.cat([d_ub, infs, infs, w_ub])
    c_obj = torch.cat([g, penalty.expand(2 * m), zeros])

    res = pdlp.solve(op, c_obj, lb, ub, tol=tol, max_iterations=max_iterations)
    d = res.x[:n]

    # -- working-set extraction (cauchy.py semantics): a variable is active
    # only at a *true* bound (not the trust-region wall); a row is active
    # when its logical column sits at a bound.
    eps = 1e-6
    x_new = x_flat + d
    at_vlb = (vlb > -INF_THRESHOLD) & (x_new <= vlb + eps * (1.0 + vlb.abs()))
    at_vub = (vub < INF_THRESHOLD) & (x_new >= vub - eps * (1.0 + vub.abs()))
    rc = res.reduced_costs[:n]
    var_states = torch.where(
        at_vlb & (rc >= 0.0), int(ActiveState.ACTIVE_LOWER),
        torch.where(at_vub & (rc <= 0.0), int(ActiveState.ACTIVE_UPPER), 0),
    ).to(torch.int8)

    # a row is active only when its logical column sits at the bound AND
    # the (first-order, hence noisy) dual does not contradict the side
    w = res.x[n + 2 * m :]
    duals = res.duals
    prox = torch.clamp(10.0 * res.primal_res, min=eps)
    at_wlb = (clb > -INF_THRESHOLD) & (w <= w_lb + prox * (1.0 + w_lb.abs()))
    at_wub = (cub < INF_THRESHOLD) & (w >= w_ub - prox * (1.0 + w_ub.abs()))
    # LP row duals carry the opposite sign of the NLP multipliers (a
    # lower-active row has LP dual >= 0, NLP lambda <= 0)
    cons_states = torch.where(
        at_wlb & (duals >= -eps), int(ActiveState.ACTIVE_LOWER),
        torch.where(at_wub & (duals <= eps), int(ActiveState.ACTIVE_UPPER), 0),
    )
    # equalities are always active
    is_eq = (cub - clb).abs() <= 1e-12 * (1.0 + clb.abs())
    cons_states = torch.where(is_eq, int(ActiveState.ACTIVE_LOWER), cons_states).to(torch.int8)
    return d, var_states, cons_states, res


# ---------------------------------------------------------------------------
# Structured SQP loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandedState:
    """State of the banded SQP loop (0-d tensors for the scalars, on the
    problem's device); the fields of the reference's ``BandedState``."""

    X: Tensor  # (N_b, k)
    lam: Tensor  # (N_b-1, q) constraint duals
    act_low: Tensor  # (N_b-1, q) bool: active at lower
    act_up: Tensor  # (N_b-1, q) bool
    penalty: Tensor
    reg: Tensor
    iteration: Tensor  # int32
    status: Tensor  # int32 Status
    num_accepted: Tensor
    num_rejected: Tensor
    obj_val: Tensor
    feas_res: Tensor
    stat_res: Tensor
    last_ratio: Tensor
    last_alpha: Tensor
    phase: Tensor  # int32 SolverPhase: OPTIMIZATION or RESTORATION
    bad_steps: Tensor  # int32: consecutive infeasible rejections
    # block-diagonal quasi-Newton Hessian (settings.hess_eval != EXACT),
    # (N_b, k, k), or (0,) when exact
    qn_B: Tensor
    qn_prev_X: Tensor  # (N_b, k) or (0,)
    qn_prev_g: Tensor  # (N_b, k) objective gradient at the previous point
    qn_prev_Jl: Tensor  # (N_b-1, q, k) or (0,)
    qn_prev_Jr: Tensor
    qn_pending: Tensor  # bool: a pair is ready to push


def banded_initial_state(
    problem: BandedProblem,
    settings: Settings,
    X0: Any,
    seed_working_set: bool = False,
) -> BandedState:
    """The starting state at ``X0`` clipped into the box; with
    ``seed_working_set`` the working set and duals come from the PDLP
    Cauchy LP at radius 1 and penalty 10."""
    dtype, dev = problem.dtype, problem.device
    X = problem.clip(torch.as_tensor(X0, dtype=dtype, device=dev))
    Nc, q, k = problem.N_b - 1, problem.q, problem.k
    act_low = torch.zeros((Nc, q), dtype=torch.bool, device=dev)
    act_up = torch.zeros((Nc, q), dtype=torch.bool, device=dev)
    lam = torch.zeros((Nc, q), dtype=dtype, device=dev)
    if seed_working_set and q:
        _, _, cons_states, res = banded_cauchy(problem, X, 1.0, 10.0)
        cs = cons_states.reshape(Nc, q)
        act_low = cs == int(ActiveState.ACTIVE_LOWER)
        act_up = cs == int(ActiveState.ACTIVE_UPPER)
        # LP duals -> NLP multiplier sign convention
        lam = -res.duals.reshape(Nc, q).to(dtype) * (cs != 0)
    use_qn = settings.hess_eval != HessEval.EXACT
    empty = torch.zeros((0,), dtype=dtype, device=dev)

    def qn(shape):
        return torch.zeros(shape, dtype=dtype, device=dev) if use_qn else empty

    return BandedState(
        X=X,
        lam=lam,
        act_low=act_low,
        act_up=act_up,
        penalty=_scalar(10.0, dtype, dev),
        reg=_scalar(1e-8, dtype, dev),
        iteration=_scalar(0, torch.int32, dev),
        status=_scalar(int(Status.RUNNING), torch.int32, dev),
        num_accepted=_scalar(0, torch.int32, dev),
        num_rejected=_scalar(0, torch.int32, dev),
        obj_val=problem.obj(X),
        feas_res=_scalar(math.inf, dtype, dev),
        stat_res=_scalar(math.inf, dtype, dev),
        last_ratio=_scalar(0.0, dtype, dev),
        last_alpha=_scalar(0.0, dtype, dev),
        phase=_scalar(int(SolverPhase.OPTIMIZATION), torch.int32, dev),
        bad_steps=_scalar(0, torch.int32, dev),
        qn_B=(torch.eye(k, dtype=dtype, device=dev).expand(problem.N_b, k, k).clone()
              if use_qn else empty),
        qn_prev_X=qn((problem.N_b, k)),
        qn_prev_g=qn((problem.N_b, k)),
        qn_prev_Jl=qn((Nc, q, k)),
        qn_prev_Jr=qn((Nc, q, k)),
        qn_pending=torch.zeros((), dtype=torch.bool, device=dev),
    )


def _violation(problem, C: Tensor) -> Tensor:
    lo = torch.clamp(problem.cons_lb - C, min=0.0)
    lo = torch.where(problem.cons_lb < -INF_THRESHOLD, 0.0, lo)
    hi = torch.clamp(C - problem.cons_ub, min=0.0)
    hi = torch.where(problem.cons_ub > INF_THRESHOLD, 0.0, hi)
    return lo + hi


def _kkt_solve(problem, Hd, Hs, Jl, Jr, act, target, g_eff, frozen, reg, mixed=False):
    """Condensed SPD block-tridiagonal EQP solve, in *delta form*.

    minimize 1/2 d^T (H + reg I) d + g_eff^T d
        s.t. J_W d = target (active rows), d_frozen = 0

    via the exact augmented Lagrangian K = H + reg I + (1/delta) J_W^T J_W
    (SPD, block-tridiagonal).  ``g_eff`` is the stationarity residual
    r = g + J^T lam_act, so the returned ``dlam = (J_W d - target) / delta``
    is the multiplier INCREMENT: callers form lam_qp = lam_act + dlam; the
    condensation error is then O(delta * ||dlam||), which vanishes as SQP
    converges.

    ``mixed=True``: delta = DELTA_MIXED, the block-Thomas factorization in
    float32 (the Cholesky scan, ``backend="scan32"``) with three float64
    refinements against K (``block_tridiag_solve_mp``).  K itself is
    assembled in float64 so the Hessian is not rounded away under the
    1/delta-scaled J^T J term.  The explicit-inverse backends diverge on
    this K and are not used.
    """
    k = problem.k
    dtype = problem.dtype
    free = ~frozen  # (N_b, k)
    eye = torch.eye(k, dtype=dtype, device=Hd.device)

    # masked Jacobian blocks: inactive rows and frozen columns drop out
    aw = act[:, :, None].to(dtype)
    Jlm = Jl * aw * free[:-1, None, :]
    Jrm = Jr * aw * free[1:, None, :]

    # masked Hessian: zero frozen rows/cols, unit diagonal
    ff_outer = (free[:, :, None] & free[:, None, :]).to(dtype)
    Hdm = Hd * ff_outer + eye * (1.0 - ff_outer) * eye
    Hdm = Hdm + eye * reg
    Hsm = Hs * (free[1:, :, None] & free[:-1, None, :])

    delta = DELTA_MIXED if mixed else DELTA
    inv_delta = 1.0 / delta
    Kd = _shift_add(Hdm, inv_delta * torch.einsum("tqi,tqj->tij", Jlm, Jlm),
                    inv_delta * torch.einsum("tqi,tqj->tij", Jrm, Jrm))
    Ks = Hsm + inv_delta * torch.einsum("tqi,tqj->tij", Jrm, Jlm)

    tgt = target * act.to(dtype)
    rhs = _shift_add(-(g_eff * free), inv_delta * torch.einsum("tqk,tq->tk", Jlm, tgt),
                     inv_delta * torch.einsum("tqk,tq->tk", Jrm, tgt))

    if mixed:
        d = block_tridiag_solve_mp(Kd, Ks, rhs, refine_iters=3, backend="scan32")
    else:
        d = block_tridiag_solve(Kd, Ks, rhs)
    d = d * free

    Jd = torch.einsum("tqk,tk->tq", Jlm, d[:-1]) + torch.einsum("tqk,tk->tq", Jrm, d[1:])
    dlam = (Jd - tgt) * inv_delta * act.to(dtype)
    return d, dlam


def _block_bfgs_push(B: Tensor, s: Tensor, y: Tensor) -> Tensor:
    """Damped-BFGS update of the block-diagonal Hessian approximation,
    batched over blocks (Powell damping per quasi_newton.c / bfgs.c).

    B: (N_b, k, k) SPD approximations; s, y: (N_b, k) pair per block.
    Blocks with a negligible step are skipped (their update is identity).
    """
    Bs = torch.einsum("tij,tj->ti", B, s)
    sBs = torch.einsum("ti,ti->t", s, Bs)
    sy = torch.einsum("ti,ti->t", s, y)
    # Powell damping: keep s^T y_eff >= 0.2 s^T B s
    theta = torch.where(sy >= 0.2 * sBs, 1.0,
                        0.8 * sBs / torch.where(sBs - sy == 0.0, 1.0, sBs - sy))
    y_eff = theta[:, None] * y + (1.0 - theta)[:, None] * Bs
    sy_eff = torch.einsum("ti,ti->t", s, y_eff)
    tiny = torch.finfo(B.dtype).eps
    ok = (sBs > tiny) & (sy_eff > tiny) & (torch.einsum("ti,ti->t", s, s) > tiny)
    upd = (
        B
        - Bs[:, :, None] * Bs[:, None, :] / torch.where(ok, sBs, 1.0)[:, None, None]
        + y_eff[:, :, None] * y_eff[:, None, :] / torch.where(ok, sy_eff, 1.0)[:, None, None]
    )
    return torch.where(ok[:, None, None], upd, B)


def _prev_jtvp(problem, Jl: Tensor, Jr: Tensor, lam: Tensor) -> Tensor:
    """J^T lam from MATERIALIZED blocks (the stored previous-iterate
    Jacobian of the QN pair push), (N_b, k)."""
    out = torch.zeros((problem.N_b, problem.k), dtype=Jl.dtype, device=Jl.device)
    return _shift_add(out, torch.einsum("tqk,tq->tk", Jl, lam),
                      torch.einsum("tqk,tq->tk", Jr, lam))


def _mixed_route(settings: Settings, dtype) -> bool:
    return settings.compute_dtype == "float32" and dtype == torch.float64


def _levenberg(reg: Tensor, ratio: Tensor, accepted: bool, reg_fail: float = REG_FAIL,
               reg_max: float = REG_MAX) -> Tensor:
    """The Levenberg update on the trust_radius.c:47-84 thresholds."""
    if accepted:
        return torch.where(
            ratio >= 0.9, torch.clamp(reg / 7.0, min=REG_MIN),
            torch.where(ratio >= 0.3, torch.clamp(reg / 2.0, min=REG_MIN), reg))
    return torch.clamp(torch.clamp(10.0 * reg, min=reg_fail), max=reg_max)


def _armijo(value, base: Tensor, descent: Tensor, settings: Settings, dtype, dev,
            max_steps: int = MAX_LINESEARCH_STEPS):
    """The reference's backtracking loop: (alpha, accepted), one host read
    a trial; ``value(alpha)`` is the merit (or violation) at alpha."""
    alpha = _scalar(1.0, dtype, dev)
    for _ in range(max_steps):
        if bool(value(alpha) <= base - settings.linesearch_eta * alpha * descent):
            return alpha, True
        alpha = settings.linesearch_tau * alpha
    return _scalar(0.0, dtype, dev), False


def _optimality_iteration(problem: BandedProblem, settings: Settings,
                          state: BandedState) -> BandedState:
    """One structured SQP iteration on the banded problem
    (problem_solver/iteration.c:350 with the subproblem layers specialized
    to block-banded structure).  Reads the stop flags once, the descent
    flag once and one flag a linesearch trial."""
    dtype, dev = problem.dtype, state.X.device
    X = state.X
    N_b, k, q = problem.N_b, problem.k, problem.q

    # mixed configuration: float32 derivative assembly, float64 solve,
    # merit and residuals
    mixed = _mixed_route(settings, dtype)
    cd = torch.float32 if mixed else None
    g = problem.obj_grad(X)
    C = problem.cons(X)
    Jl, Jr = problem.cons_jac_blocks(X, compute_dtype=cd)
    viol = _violation(problem, C)
    feas_res = max0(viol)

    # ---- working-set update: epsilon-active + wrong-sign dual drop ----
    tol_act = settings.eps * 1e4
    scale_lo = 1.0 + problem.cons_lb.abs()
    scale_hi = 1.0 + problem.cons_ub.abs()
    is_eq = (problem.cons_ub - problem.cons_lb).abs() <= 1e-12 * scale_lo
    near_lo = (problem.cons_lb > -INF_THRESHOLD) & (C <= problem.cons_lb + tol_act * scale_lo)
    near_up = (problem.cons_ub < INF_THRESHOLD) & (C >= problem.cons_ub - tol_act * scale_hi)
    # drop rows whose multiplier has the wrong sign (lower-active needs
    # lam <= 0, upper-active lam >= 0); a just-released row must NOT be
    # re-added by bound proximity, or the EQP would pin it right back
    wrong_lo = state.act_low & ~is_eq & (state.lam > tol_act)
    wrong_up = state.act_up & (state.lam < -tol_act)
    keep_lo = state.act_low & ~wrong_lo
    keep_up = state.act_up & ~wrong_up
    act_low = is_eq | (near_lo & ~wrong_lo) | keep_lo
    act_up = (~is_eq) & ((near_up & ~wrong_up) | keep_up) & ~act_low
    act = act_low | act_up

    # EQP target: step onto the active bound (c + J d = bound)
    target = torch.where(act_low, problem.cons_lb - C,
                         torch.where(act_up, problem.cons_ub - C, 0.0))

    # ---- variable-bound freeze via reduced gradient --------------------
    # multiplier base of the delta-form EQP: rows in the working set keep
    # their duals, dropped rows are zeroed; J^T lam by a float64 reverse
    # pass, exact whatever the assembly dtype
    lam_act = state.lam * act.to(dtype)
    r = g + problem.cons_jtvp(X, lam_act) if q else g
    at_lb = (problem.var_lb > -INF_THRESHOLD) & (
        X <= problem.var_lb + settings.eps * (1.0 + problem.var_lb.abs()))
    at_ub = (problem.var_ub < INF_THRESHOLD) & (
        X >= problem.var_ub - settings.eps * (1.0 + problem.var_ub.abs()))
    frozen = (at_lb & (r > 0.0)) | (at_ub & (r < 0.0))

    # ---- stationarity (free variables; frozen have bound duals) --------
    stat_res = max0(torch.where(frozen, 0.0, r).abs())
    # active-set sign optimality: no kept row with a wrong-signed dual
    sign_ok = torch.where(
        state.act_low & ~is_eq, state.lam <= tol_act,
        torch.where(state.act_up, state.lam >= -tol_act, True)).all()
    optimal_t = (feas_res <= settings.feas_tol) & (stat_res <= settings.stat_tol) & sign_ok
    # a feasible stall with the regularization maxed out is a deadpoint
    # abort; an INFEASIBLE stall hands over to the restoration phase
    infeasible_now = feas_res > settings.feas_tol
    deadpoint_t = (state.reg >= REG_MAX) & ~infeasible_now
    optimal, deadpoint, qn_pending = torch.stack(
        [optimal_t, deadpoint_t, state.qn_pending]).tolist()
    if optimal or deadpoint:
        status = Status.OPTIMAL if optimal else Status.ABORT_DEADPOINT
        return dataclasses.replace(state, status=_scalar(int(status), torch.int32, dev),
                                   feas_res=feas_res, stat_res=stat_res)

    # ---- EQP step on the working set -----------------------------------
    use_qn = settings.hess_eval != HessEval.EXACT
    if use_qn:
        qn_B = state.qn_B
        if qn_pending:
            # push the pending pair at the NEW multipliers (quasi_newton.c:140
            # convention: y = gradL(x_new, lam_new) - gradL(x_old, lam_new),
            # the old Lagrangian gradient rebuilt from the stored blocks)
            glag_old = state.qn_prev_g + _prev_jtvp(
                problem, state.qn_prev_Jl, state.qn_prev_Jr, lam_act)
            qn_B = _block_bfgs_push(state.qn_B, X - state.qn_prev_X, r - glag_old)
        Hd = qn_B
        Hs = torch.zeros((N_b - 1, k, k), dtype=dtype, device=dev)
    else:
        qn_B = state.qn_B
        Hd, Hs = problem.lag_hess_blocks(X, lam_act, compute_dtype=cd)
    # delta form: gradient = the float64 stationarity residual r, unknowns
    # (d, dlam), lam_qp = lam_act + dlam
    d, dlam = _kkt_solve(problem, Hd, Hs, Jl, Jr, act, target, r, frozen, state.reg,
                         mixed=mixed)
    lam_qp = lam_act + dlam
    step_ok = torch.isfinite(d).all() & torch.isfinite(lam_qp).all()
    d = torch.where(step_ok, d, 0.0)
    lam_qp = torch.where(step_ok, lam_qp, state.lam)

    # ---- penalty above multiplier scale (penalty.c:5-50) ---------------
    lam_norm = max0(lam_qp.abs())
    penalty = torch.where(state.penalty >= 1.5 * lam_norm, state.penalty,
                          torch.maximum(10.0 * state.penalty, 2.0 * lam_norm))

    # ---- l1 merit + backtracking linesearch ----------------------------
    gd = (g * d).sum()
    dHd = torch.einsum("ti,tij,tj->", d, Hd, d) + 2.0 * torch.einsum(
        "ti,tij,tj->", d[1:], Hs, d[:-1])
    viol0 = viol.sum()
    merit0 = state.obj_val + penalty * viol0

    def trial_point(alpha):
        return problem.clip(X + alpha * d)

    def trial_merit(alpha):
        Xa = trial_point(alpha)
        return problem.obj(Xa) + penalty * _violation(problem, problem.cons(Xa)).sum()

    descent = penalty * viol0 - gd
    has_descent = bool((descent > 0.0) & step_ok)
    accepted = False
    alpha = _scalar(0.0, dtype, dev)
    if has_descent:
        alpha, accepted = _armijo(trial_merit, merit0, descent, settings, dtype, dev)

    merit_trial = trial_merit(alpha)
    X_new = trial_point(alpha)
    pred = alpha * descent - 0.5 * alpha**2 * dHd
    actual = merit0 - merit_trial
    eps10 = 10.0 * torch.finfo(dtype).eps * (1.0 + merit0.abs())
    tiny = (pred.abs() <= eps10) & (actual.abs() <= eps10)
    ratio = torch.where(tiny, 1.0, actual / torch.where(pred == 0.0, 1.0, pred))

    reg_new = _levenberg(state.reg, ratio, accepted)
    X_next = X_new if accepted else X
    # delta form: the multiplier estimate moves with the iterate; a
    # rejected step keeps the old duals
    lam_next = lam_qp if accepted else state.lam

    # ---- restoration-phase trigger (solver/phase.c analogue) -----------
    bad = infeasible_now & (not accepted)
    bad_steps = torch.where(bad, state.bad_steps + 1, 0).to(torch.int32)
    enter_rest = infeasible_now & ((bad_steps >= RESTORATION_TRIGGER) | (state.reg >= REG_MAX))
    phase_next = torch.where(enter_rest, int(SolverPhase.RESTORATION),
                             int(SolverPhase.OPTIMIZATION)).to(torch.int32)
    reg_next = torch.where(enter_rest, 1e-6, reg_new)
    bad_steps = torch.where(enter_rest, 0, bad_steps).to(torch.int32)

    if use_qn and accepted:
        # record the pre-step point; the pair pushes next iteration once
        # the new duals are available (quasi_newton.c)
        qn_prev = dict(qn_prev_X=X, qn_prev_g=g, qn_prev_Jl=Jl, qn_prev_Jr=Jr)
    else:
        qn_prev = dict(qn_prev_X=state.qn_prev_X, qn_prev_g=state.qn_prev_g,
                       qn_prev_Jl=state.qn_prev_Jl, qn_prev_Jr=state.qn_prev_Jr)
    pending = (torch.full((), accepted, dtype=torch.bool, device=dev) if use_qn
               else state.qn_pending)

    return BandedState(
        X=X_next,
        lam=lam_next,
        act_low=act_low,
        act_up=act_up,
        penalty=penalty,
        reg=reg_next,
        iteration=state.iteration + 1,
        status=_scalar(int(Status.RUNNING), torch.int32, dev),
        num_accepted=state.num_accepted + int(accepted),
        num_rejected=state.num_rejected + int(not accepted),
        obj_val=problem.obj(X_next),
        feas_res=feas_res,
        stat_res=stat_res,
        last_ratio=ratio,
        last_alpha=alpha,
        phase=phase_next,
        bad_steps=bad_steps,
        qn_B=qn_B,
        qn_pending=pending,
        **qn_prev,
    )


def _restoration_iteration(problem: BandedProblem, settings: Settings,
                           state: BandedState) -> BandedState:
    """Feasibility restoration on the banded path.

    The structured analogue of the dense restoration phase
    (solver/phase.c:97-147, restoration.c): Levenberg-regularized
    Gauss-Newton steps on the constraint violation through the SAME
    condensed block-tridiagonal solve, with an identity prox metric and the
    violated rows as working set.  Returns to OPTIMIZATION once feasible
    (duals kept, penalty x10); a maxed-out regularization while still
    infeasible is a local-infeasibility certificate (Status.INFEASIBLE).
    Reads the descent flag, one flag a trial and the certificate flag.
    """
    dtype, dev = problem.dtype, state.X.device
    X = state.X
    N_b, k = problem.N_b, problem.k
    mixed = _mixed_route(settings, dtype)
    cd = torch.float32 if mixed else None
    C = problem.cons(X)
    viol = _violation(problem, C)
    phi0 = viol.sum()
    feas_res = max0(viol)
    Jl, Jr = problem.cons_jac_blocks(X, compute_dtype=cd)

    below = (problem.cons_lb > -INF_THRESHOLD) & (C < problem.cons_lb)
    above = (problem.cons_ub < INF_THRESHOLD) & (C > problem.cons_ub)
    act = below | above
    target = torch.where(below, problem.cons_lb - C,
                         torch.where(above, problem.cons_ub - C, 0.0))

    frozen = torch.zeros((N_b, k), dtype=torch.bool, device=dev)
    Hd = torch.eye(k, dtype=dtype, device=dev).expand(N_b, k, k)
    Hs = torch.zeros((N_b - 1, k, k), dtype=dtype, device=dev)
    zeros_g = torch.zeros((N_b, k), dtype=dtype, device=dev)
    d, _ = _kkt_solve(problem, Hd, Hs, Jl, Jr, act, target, zeros_g, frozen, state.reg,
                      mixed=mixed)
    step_ok = torch.isfinite(d).all()
    d = torch.where(step_ok, d, 0.0)

    # predicted violation drop of the FULL linearized step
    Jd = torch.einsum("tqk,tk->tq", Jl, d[:-1]) + torch.einsum("tqk,tk->tq", Jr, d[1:])
    descent = phi0 - _violation(problem, C + Jd).sum()

    def trial_point(alpha):
        return problem.clip(X + alpha * d)

    def trial(alpha):
        return _violation(problem, problem.cons(trial_point(alpha))).sum()

    has_descent = bool((descent > 0.0) & step_ok)
    accepted = False
    alpha = _scalar(0.0, dtype, dev)
    if has_descent:
        alpha, accepted = _armijo(trial, phi0, descent, settings, dtype, dev)
    phi_new = trial(alpha)
    X_new = trial_point(alpha)

    pred = alpha * descent
    eps10 = 10.0 * torch.finfo(dtype).eps * (1.0 + phi0.abs())
    tiny = (pred.abs() <= eps10) & ((phi0 - phi_new).abs() <= eps10)
    ratio = torch.where(tiny, 1.0, (phi0 - phi_new) / torch.where(pred == 0.0, 1.0, pred))
    reg_new = _levenberg(state.reg, ratio, accepted)

    X_next = X_new if accepted else X
    feas_new = max0(_violation(problem, problem.cons(X_next)))
    restored = feas_new <= settings.feas_tol
    # local-infeasibility certificate: GN on the violation cannot move
    if bool((~restored) & (state.reg >= REG_MAX)):
        return dataclasses.replace(state, status=_scalar(int(Status.INFEASIBLE), torch.int32, dev),
                                   feas_res=feas_res)
    return dataclasses.replace(
        state,
        X=X_next,
        penalty=torch.where(restored, 10.0 * state.penalty, state.penalty),
        reg=torch.where(restored, 1e-8, reg_new),
        iteration=state.iteration + 1,
        status=_scalar(int(Status.RUNNING), torch.int32, dev),
        num_accepted=state.num_accepted + int(accepted),
        num_rejected=state.num_rejected + int(not accepted),
        obj_val=problem.obj(X_next),
        feas_res=feas_new,
        last_ratio=ratio,
        last_alpha=alpha,
        phase=torch.where(restored, int(SolverPhase.OPTIMIZATION),
                          int(SolverPhase.RESTORATION)).to(torch.int32),
        bad_steps=_scalar(0, torch.int32, dev),
        qn_pending=torch.zeros((), dtype=torch.bool, device=dev),  # the pair straddles a phase jump
    )


def _iterate(problem, settings, state, phase: int):
    if phase == SolverPhase.RESTORATION:
        return _restoration_iteration(problem, settings, state)
    return _optimality_iteration(problem, settings, state)


def banded_perform_iteration(problem: BandedProblem, settings: Settings,
                             state: BandedState) -> BandedState:
    """One banded iteration: dispatch on the top-level phase
    (solver/phase.c), the optimality SQP loop or the feasibility
    restoration loop; one host read of the phase."""
    if state.X.device.type == "cuda":
        require_full_fp32()
    return _iterate(problem, settings, state, int(state.phase))


def banded_solve(
    problem: BandedProblem,
    settings: Optional[Settings] = None,
    X0: Any = None,
    max_iterations: int = 200,
    seed_working_set: bool = False,
    state0: Optional[BandedState] = None,
) -> BandedState:
    """Solve a banded NLP where the problem lives; returns the final
    BandedState.  Iterates from ``state0`` when given (then ``X0`` and
    ``seed_working_set`` are unused), else from ``banded_initial_state``.
    The loop reads the status and the phase together once an iteration;
    a state still RUNNING after ``max_iterations`` ends as ABORT_ITER."""
    settings = settings or Settings()
    dev = problem.device
    if dev.type == "cuda":
        require_full_fp32()
    if state0 is None:
        if X0 is None:
            X0 = torch.zeros((problem.N_b, problem.k), dtype=problem.dtype, device=dev)
        state0 = banded_initial_state(problem, settings, X0, seed_working_set=seed_working_set)
    state = state0
    iteration = int(state.iteration)
    status, phase = torch.stack([state.status, state.phase]).tolist()
    while status == Status.RUNNING and iteration < max_iterations:
        state = _iterate(problem, settings, state, phase)
        iteration += 1
        status, phase = torch.stack([state.status, state.phase]).tolist()
    if status == Status.RUNNING:
        state = dataclasses.replace(state, status=_scalar(int(Status.ABORT_ITER), torch.int32, dev))
    return state
