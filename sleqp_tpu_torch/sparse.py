"""Large-scale general sparse NLPs, matrix-free (no Jacobian assembly).

Port of ``sleqp_tpu/sparse.py``.  The reference's C solver assembles the
augmented Jacobian in CSC and factors it with a sparse direct backend
(aug_jac/standard_aug_jac.c:34-101); this path keeps the Jacobian
implicit: every product J v / J^T u is a reverse-mode pass through the
user's constraint function (cost proportional to the function's own
sparsity, no O(m n) storage), and the working-set EQP is solved by
conjugate gradients on the delta-form condensed operator that the banded
path factors directly (``banded.py::_kkt_solve``):

    K = H_lag + reg I + (1/delta) J_W^T J_W   restricted to free variables

Derivatives are reverse mode only (PyTorch's forward mode gives the
tangent of a 0-d float32 tensor times a Python float in float64): J^T u is
one vjp; J v, which the reference takes by ``jax.jvp``, is the vjp of the
map u -> J^T u, linear in u and hence exact; the Lagrangian Hessian product
is the vjp of the Lagrangian gradient (the Hessian is symmetric).

Globalization follows the structured paths: eps-active working set with
wrong-sign dual drops (or the reference Cauchy LP by matrix-free PDLP,
``cauchy="pdlp"``), reduced-gradient bound freezing, l1 merit with
backtracking linesearch, Levenberg regularization on trust_radius.c
thresholds, the penalty kept above the multiplier scale (penalty.c:5-50),
and a Gauss-Newton feasibility-restoration phase on infeasible stalls.

The mixed configuration (``Settings(compute_dtype="float32")`` on a float64
problem) runs the bulk CG iterations on the callables called with float32
tensors, then a float64 CG polish warm-started from that solution; a
callable must follow its arguments' dtype (``types.py``).

The reference's solve is one ``jit``-compiled ``lax.while_loop``
(``sparse_solve_jit``) whose body is a ``lax.cond`` on the phase, with the
CG solves, the PDHG solve of the Cauchy LP and the Armijo loop as inner
``while_loop``s.  Its counterpart here runs the iteration as read-free
programs (``graphs.Programs``) under ``lanes.device_resident()``, captured
as CUDA graphs on the card and replayed with one read of a flag after each.
CG is too long to run all its masked steps in one graph (up to
``cg_iters`` steps a pass, three augmented-Lagrangian passes), and so is
PDHG (up to ``cauchy_iters`` iterations), so each is a program of one block
(``CG_BLOCK`` steps, each frozen by ``torch.where`` once the exit condition
holds; 64 PDHG iterations and the restart check), replayed while the flag
says the loop goes on: the same read a block as the eager loop.  The
iteration around them is split at the blocks (the working set and the EQP
start; a pass's multiplier update; the penalty, merit and the first Armijo
trials; blocks of further trials; the step), its stop test and its
local-infeasibility certificate selects.  On the CPU the same programs run
eagerly, with the same reads.  ``sparse_solve_from`` keeps the eager loop
that reads as it goes: it is the graphs' oracle.  Entry points run where
the problem lives: ``SparseProblem(device=None)`` means CUDA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad, vjp

from . import graphs
from .device import resolve_device
from .graphs import CG, LP, RESTORING, RUNNING, SEARCHING, Programs, cached, loop_flag, state_key
from .iterate import max0
from .kernels._build import require_full_fp32
from .lanes import device_resident, lanes_any, tree_map, tree_where
from .ops import pdlp
from .settings import Settings
from .sqp_steps import armijo, armijo_start, levenberg, mixed_route, scalar, trial_point
from .types import DTYPE_MISMATCH, INF_THRESHOLD, SolverPhase, Status

Tensor = torch.Tensor

# Augmented-Lagrangian condensation regularization.  The structured paths
# factor K directly, so they run delta ~ 1e-8; a CG solve pays cond(K) ~
# 1/delta in iterations, so the matrix-free path uses a moderate delta and
# recovers constraint accuracy through AL_ITERS multiplier-refinement
# passes (error contracts ~ delta per pass).
DELTA = 1e-3
AL_ITERS = 3
REG_MIN = 1e-10
REG_FAIL = 1e-6
REG_MAX = 1e8
MAX_LINESEARCH_STEPS = 25
RESTORATION_TRIGGER = 3
# CG steps between two host reads of the exit flag
CG_BLOCK = 16
CG_TOL = 1e-10
CAUCHY_TOL = 1e-7

_MIXED_DTYPE_HINT = (
    "with Settings(compute_dtype='float32') obj and cons are called on float32 "
    "tensors and must compute in their arguments' dtype and device (for example "
    "w.to(x) * x); a callable that closes over a float64 tensor computes in "
    "float64 or fails, and the float32 route never runs it in float64"
)


class SparseProblem:
    """General NLP consumed matrix-free.

    Parameters
    ----------
    obj:      x -> scalar
    cons:     x -> (m,) constraint values (optional); its Jacobian is never
              materialized, only products through reverse-mode passes
    var_lb, var_ub, cons_lb, cons_ub: bounds (scalars broadcast)
    cg_iters: CG cap per EQP solve (the loop exits early on residual
              convergence)
    cauchy:   working-set discovery.  ``"eps"`` (default) tracks
              epsilon-active rows with wrong-sign dual drops; ``"pdlp"``
              solves the reference Cauchy LP (standard_cauchy.c:155-244)
              each iteration with matrix-free PDLP, warm-started across
              iterations, and reads the working set off its solution.
    cauchy_iters: PDLP iteration cap per Cauchy solve.
    device:   where the problem lives (``None`` means CUDA).
    """

    def __init__(
        self,
        obj: Callable[[Tensor], Tensor],
        num_variables: int,
        cons: Optional[Callable[[Tensor], Tensor]] = None,
        num_cons: int = 0,
        var_lb: Any = None,
        var_ub: Any = None,
        cons_lb: Any = None,
        cons_ub: Any = None,
        cg_iters: int = 200,
        cauchy: str = "eps",
        cauchy_iters: int = 4000,
        dtype: torch.dtype = torch.float64,
        device: Any = None,
    ):
        if cauchy not in ("eps", "pdlp"):
            raise ValueError(f"unknown cauchy strategy {cauchy!r}")
        self.obj = obj
        self.n = int(num_variables)
        self.cons = cons if cons is not None else (lambda x: x.new_zeros((0,)))
        self.m = int(num_cons)
        self.cg_iters = int(cg_iters)
        self.cauchy = cauchy if num_cons else "eps"
        self.cauchy_iters = int(cauchy_iters)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._follows_dtype_checked = False

        def bound(v, default, shape):
            if v is None:
                v = default
            v = torch.as_tensor(v, dtype=dtype, device=self.device)
            return v.expand(shape).clone()

        self.var_lb = bound(var_lb, -math.inf, (self.n,))
        self.var_ub = bound(var_ub, math.inf, (self.n,))
        self.cons_lb = bound(cons_lb, -math.inf, (self.m,))
        self.cons_ub = bound(cons_ub, math.inf, (self.m,))

    # -- matrix-free products ---------------------------------------------

    def obj_grad(self, x: Tensor) -> Tensor:
        return grad(self.obj)(x)

    def jacobian_products(self, x: Tensor):
        """(v -> J(x) v, u -> J(x)^T u), with the constraint function
        evaluated once at x for all products: J^T u is one reverse pass, J v
        the reverse pass of the linear map u -> J^T u."""
        _, pull = vjp(self.cons, x)

        def jt(u):
            return pull(u)[0]

        _, pull_t = vjp(jt, torch.zeros((self.m,), dtype=x.dtype, device=x.device))
        return (lambda v: pull_t(v)[0]), jt

    def hessian_product(self, x: Tensor, lam: Tensor):
        """v -> Hessian-of-Lagrangian product at (x, lam): the reverse pass
        of the Lagrangian gradient (exact AD; the Hessian is symmetric),
        with the gradient evaluated once for all products."""

        def lag(z):
            f = self.obj(z)
            if self.m:
                f = f + torch.dot(lam, self.cons(z))
            return f

        _, pull = vjp(grad(lag), x)
        return lambda v: pull(v)[0]

    def vjp(self, x: Tensor, u: Tensor) -> Tensor:
        """J(x)^T u by one reverse pass."""
        _, pull = vjp(self.cons, x)
        return pull(u)[0]

    def jvp(self, x: Tensor, v: Tensor) -> Tensor:
        """J(x) v (``jacobian_products``)."""
        return self.jacobian_products(x)[0](v)

    def lag_hess_prod(self, x: Tensor, lam: Tensor, v: Tensor) -> Tensor:
        """Hessian-of-Lagrangian product (``hessian_product``)."""
        return self.hessian_product(x, lam)(v)

    def clip(self, x: Tensor) -> Tensor:
        return torch.minimum(torch.maximum(x, self.var_lb), self.var_ub)

    def check_follows_dtype(self, x32: Tensor) -> None:
        """Raise ``TypeError`` unless obj and cons compute in the dtype of
        their float32 argument; any other error of a callable propagates
        unchanged.  Run once per problem."""
        if self._follows_dtype_checked:
            return
        try:
            outs = [self.obj(x32), self.cons(x32)]
        except RuntimeError as exc:
            if not DTYPE_MISMATCH.search(str(exc)):
                raise
            raise TypeError(_MIXED_DTYPE_HINT) from exc
        if any(torch.as_tensor(o).dtype != x32.dtype for o in outs):
            raise TypeError(_MIXED_DTYPE_HINT)
        self._follows_dtype_checked = True


@dataclasses.dataclass(frozen=True)
class SparseState:
    """State of the matrix-free SQP loop (0-d tensors for the scalars, on
    the problem's device); the fields of the reference's ``SparseState``."""

    x: Tensor  # (n,)
    lam: Tensor  # (m,) constraint duals
    act_low: Tensor  # (m,) bool
    act_up: Tensor  # (m,) bool
    penalty: Tensor
    reg: Tensor
    iteration: Tensor
    status: Tensor
    num_accepted: Tensor
    num_rejected: Tensor
    obj_val: Tensor
    feas_res: Tensor
    stat_res: Tensor
    last_ratio: Tensor
    last_alpha: Tensor
    phase: Tensor
    bad_steps: Tensor
    cg_iterations: Tensor  # cumulative CG iterations (diagnostics)
    feas_steps: Tensor  # consecutive feasible iterations (penalty reset)
    penalty_resets: Tensor  # global resets used (capped at 2)
    # Cauchy-LP warm starts + l-inf LP trust radius (cauchy="pdlp";
    # shape-(0,) placeholders otherwise)
    lp_x: Tensor  # (n + 3m,) PDLP primal
    lp_y: Tensor  # (m,) PDLP dual
    lp_tr: Tensor  # scalar


def _sign_probes(size: int, dtype, device) -> Tensor:
    """(3, size): the two bit patterns of (i % 4) as +-1, and ones."""
    bits = torch.arange(size, device=device) % 4
    rows = [torch.where((bits // (1 << b)) % 2 == 0, 1.0, -1.0) for b in range(2)]
    rows.append(torch.ones((size,), device=device))
    return torch.stack(rows).to(dtype)


class _MatrixFreeCauchyOp:
    """PDLP operator for the Cauchy LP columns [d, s+, s-, w]: rows
    J d + s+ - s- - w = 0 (standard_cauchy.c:203-244), with J applied
    through the problem's products at the current iterate.

    The Ruiz-equilibration hooks need |A|-weighted maxes, which a
    matrix-free J cannot give exactly; deterministic sign probes
    |J (s .* v)| lower-bound them, which only softens the scaling."""

    def __init__(self, problem: SparseProblem, x: Tensor):
        self.problem = problem
        self.x = x
        n, m = problem.n, problem.m
        self.n, self.m_rows = n, m
        self.shape = (m, n + 3 * m)
        self.dtype = problem.dtype
        self.device = x.device
        self.jv, self.jtv = problem.jacobian_products(x)

    def _split(self, v: Tensor):
        n, m = self.n, self.m_rows
        return v[:n], v[n : n + m], v[n + m : n + 2 * m], v[n + 2 * m :]

    def mv(self, v: Tensor) -> Tensor:
        d, sp, sm, w = self._split(v)
        return self.jv(d) + sp - sm - w

    def rmv(self, y: Tensor) -> Tensor:
        return torch.cat([self.jtv(y), y, -y, -y])

    def scaled_row_max(self, d_c: Tensor) -> Tensor:
        d, sp, sm, w = self._split(d_c)
        est = torch.zeros((self.m_rows,), dtype=self.dtype, device=self.device)
        for s in _sign_probes(self.n, self.dtype, self.device):
            est = torch.maximum(est, self.jv(s * d).abs())
        return torch.maximum(est, torch.maximum(sp, torch.maximum(sm, w)))

    def scaled_col_max(self, d_r: Tensor) -> Tensor:
        est = torch.zeros((self.n,), dtype=self.dtype, device=self.device)
        for s in _sign_probes(self.m_rows, self.dtype, self.device):
            est = torch.maximum(est, self.jtv(s * d_r).abs())
        return torch.cat([est, d_r, d_r, d_r])


def _violation(problem: SparseProblem, C: Tensor) -> Tensor:
    lo = torch.clamp(problem.cons_lb - C, min=0.0)
    lo = torch.where(problem.cons_lb < -INF_THRESHOLD, 0.0, lo)
    hi = torch.clamp(C - problem.cons_ub, min=0.0)
    hi = torch.where(problem.cons_ub > INF_THRESHOLD, 0.0, hi)
    return lo + hi


def _cauchy_lp(problem: SparseProblem, x: Tensor, trust_radius: Tensor, penalty: Tensor):
    """The reference Cauchy LP at x on the columns [d, s+, s-, w]: (the
    operator, objective, lower and upper bounds, and the bounds of w)."""
    m = problem.m
    dtype, dev = problem.dtype, x.device
    C = problem.cons(x)
    g = problem.obj_grad(x)
    op = _MatrixFreeCauchyOp(problem, x)

    big = scalar(1e20, dtype, dev)
    vlb, vub = problem.var_lb, problem.var_ub
    d_lb = torch.maximum(torch.where(vlb < -INF_THRESHOLD, -big, vlb - x), -trust_radius)
    d_ub = torch.minimum(torch.where(vub > INF_THRESHOLD, big, vub - x), trust_radius)
    clb, cub = problem.cons_lb, problem.cons_ub
    w_lb = torch.where(clb < -INF_THRESHOLD, -big, clb - C)
    w_ub = torch.where(cub > INF_THRESHOLD, big, cub - C)
    zeros = torch.zeros((m,), dtype=dtype, device=dev)
    infs = torch.full((m,), 1e20, dtype=dtype, device=dev)
    lb = torch.cat([d_lb, zeros, zeros, w_lb])
    ub = torch.cat([d_ub, infs, infs, w_ub])
    c_obj = torch.cat([g, penalty.expand(2 * m), zeros])
    return op, c_obj, lb, ub, w_lb, w_ub


def _working_set(problem: SparseProblem, res: pdlp.PDLPResult, w_lb: Tensor, w_ub: Tensor):
    """(act_low, act_up) read off the Cauchy LP's solution
    (standard_cauchy.c:843-1005 semantics via the first-order solution:
    logical column at bound + non-contradicting dual; equalities always
    active)."""
    n, m = problem.n, problem.m
    clb, cub = problem.cons_lb, problem.cons_ub
    eps = 1e-6
    w = res.x[n + 2 * m :]
    duals = res.duals
    prox = torch.clamp(10.0 * res.primal_res, min=eps)
    at_wlb = (clb > -INF_THRESHOLD) & (w <= w_lb + prox * (1.0 + w_lb.abs()))
    at_wub = (cub < INF_THRESHOLD) & (w >= w_ub - prox * (1.0 + w_ub.abs()))
    is_eq = (cub - clb).abs() <= 1e-12 * (1.0 + clb.abs())
    act_low = is_eq | (at_wlb & (duals >= -eps))
    act_up = (~is_eq) & (at_wub & (duals <= eps)) & ~act_low
    return act_low, act_up


def sparse_cauchy(
    problem: SparseProblem,
    x: Tensor,
    trust_radius: Any,
    penalty: Any,
    lp_x: Optional[Tensor] = None,
    lp_y: Optional[Tensor] = None,
    tol: float = CAUCHY_TOL,
):
    """Reference Cauchy LP, matrix-free (``banded.banded_cauchy`` with the
    problem's products as operator), warm-started from ``lp_x``/``lp_y``.
    Returns (d, act_low, act_up, res)."""
    dtype, dev = problem.dtype, x.device
    trust_radius = torch.as_tensor(trust_radius, dtype=dtype, device=dev)
    penalty = torch.as_tensor(penalty, dtype=dtype, device=dev)
    op, c_obj, lb, ub, w_lb, w_ub = _cauchy_lp(problem, x, trust_radius, penalty)
    res = pdlp.solve(op, c_obj, lb, ub, x0=lp_x, y0=lp_y, tol=tol,
                     max_iterations=problem.cauchy_iters)
    act_low, act_up = _working_set(problem, res, w_lb, w_ub)
    return res.x[: problem.n], act_low, act_up, res


def sparse_initial_state(problem: SparseProblem, settings: Settings, x0: Any) -> SparseState:
    dtype, dev = problem.dtype, problem.device
    x = problem.clip(torch.as_tensor(x0, dtype=dtype, device=dev))
    m = problem.m
    lp_size = (problem.n + 3 * m, m) if problem.cauchy == "pdlp" else (0, 0)
    zero = scalar(0.0, dtype, dev)
    izero = scalar(0, torch.int32, dev)
    return SparseState(
        x=x,
        lam=torch.zeros((m,), dtype=dtype, device=dev),
        act_low=torch.zeros((m,), dtype=torch.bool, device=dev),
        act_up=torch.zeros((m,), dtype=torch.bool, device=dev),
        penalty=scalar(10.0, dtype, dev),
        reg=scalar(1e-8, dtype, dev),
        iteration=izero,
        status=scalar(int(Status.RUNNING), torch.int32, dev),
        num_accepted=izero,
        num_rejected=izero,
        obj_val=problem.obj(x),
        feas_res=zero,
        stat_res=zero,
        last_ratio=zero,
        last_alpha=zero,
        phase=scalar(int(SolverPhase.OPTIMIZATION), torch.int32, dev),
        bad_steps=izero,
        cg_iterations=izero,
        feas_steps=izero,
        penalty_resets=izero,
        lp_x=torch.zeros((lp_size[0],), dtype=dtype, device=dev),
        lp_y=torch.zeros((lp_size[1],), dtype=dtype, device=dev),
        lp_tr=scalar(1.0, dtype, dev),
    )


# ---- conjugate gradients ------------------------------------------------


class _CG(NamedTuple):
    """The state of a CG solve between two blocks of steps."""

    x: Tensor
    r: Tensor
    p: Tensor
    rs: Tensor
    it: Tensor  # int32 steps taken
    neg: Tensor  # stopped at negative curvature
    tol2: Tensor  # the squared residual at which it stops


def _cg_start(matvec, b: Tensor, tol: Any, dtype, x0: Optional[Tensor] = None) -> _CG:
    """A CG solve of matvec(x) = b from x0 (zeros where None) before its
    first step."""
    dev = b.device
    tol = tol.to(dtype) if isinstance(tol, Tensor) else scalar(tol, dtype, dev)
    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    bnorm2 = (b * b).sum()
    tol2 = (tol * tol) * torch.maximum(bnorm2, scalar(1e-300, dtype, dev))
    return _CG(x=x0, r=r0, p=r0, rs=(r0 * r0).sum(), it=scalar(0, torch.int32, dev),
               neg=torch.zeros((), dtype=torch.bool, device=dev), tol2=tol2)


def _cg_running(cg: _CG, max_iters: int) -> Tensor:
    """Whether the solve takes another step: its residual above the
    tolerance, below the cap, no negative curvature met."""
    return (cg.rs > cg.tol2) & (cg.it < max_iters) & ~cg.neg


def _cg_block(matvec, cg: _CG, max_iters: int, steps: int = CG_BLOCK) -> _CG:
    """``steps`` CG steps with no host read, each applied only while
    ``_cg_running`` holds (``torch.where``), so the iterate and the count
    are those of the reference's ``while_loop`` however many steps run."""
    x, r, p, rs, it, neg = cg.x, cg.r, cg.p, cg.rs, cg.it, cg.neg
    for _ in range(steps):
        go = (rs > cg.tol2) & (it < max_iters) & ~neg
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        # negative curvature: stop with the current (descent) iterate,
        # truncated CG; the caller's Levenberg loop convexifies next round
        neg_step = pAp <= 0.0
        alpha = torch.where(neg_step, 0.0, rs / torch.where(neg_step, 1.0, pAp))
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        rs_new = (r_new * r_new).sum()
        p_new = r_new + (rs_new / rs) * p
        x = torch.where(go, x_new, x)
        r = torch.where(go, r_new, r)
        p = torch.where(go, p_new, p)
        rs = torch.where(go, rs_new, rs)
        it = it + go.to(torch.int32)
        neg = torch.where(go, neg_step, neg)
    return _CG(x=x, r=r, p=p, rs=rs, it=it, neg=neg, tol2=cg.tol2)


def _cg_blocks(matvec, cg: _CG, max_iters: int) -> _CG:
    """Blocks of CG_BLOCK steps (the last cut at the cap), one host read
    after each, until the solve stops."""
    steps = 0
    while steps < max_iters:
        block = min(CG_BLOCK, max_iters - steps)
        cg = _cg_block(matvec, cg, max_iters, block)
        steps += block
        if not bool(_cg_running(cg, max_iters)):
            break
    return cg


def _cg(matvec, b: Tensor, tol: Any, max_iters: int, dtype, x0: Optional[Tensor] = None):
    """Plain CG with an iteration cap, residual early exit and a stop at
    negative curvature.  Returns (x, iterations).  The host reads the exit
    condition once a block of ``CG_BLOCK`` steps."""
    cg = _cg_blocks(matvec, _cg_start(matvec, b, tol, dtype, x0=x0), max_iters)
    return cg.x, cg.it


# ---- the EQP step (delta form) --------------------------------------------


class _EQP(NamedTuple):
    """A working-set EQP between its CG solves: the operator's inputs, and
    the step, multiplier increment and CG steps so far."""

    x: Tensor
    lam_act: Tensor
    reg: Tensor
    free: Tensor  # 1.0 on the free variables
    actf: Tensor  # 1.0 on the working set's rows
    target: Tensor
    g_eff: Tensor
    d: Tensor
    dlam: Tensor
    it_total: Tensor
    rhs: Tensor  # the current pass's right-hand side
    it_bulk: Tensor  # the mixed route's float32 steps of the last pass


def _eqp(problem: SparseProblem, x, lam_act, act, target, g_eff, frozen, reg) -> _EQP:
    """An EQP before its first pass."""
    dtype, dev = problem.dtype, x.device
    return _EQP(x=x, lam_act=lam_act, reg=reg, free=(~frozen).to(dtype), actf=act.to(dtype),
                target=target, g_eff=g_eff, d=torch.zeros((problem.n,), dtype=dtype, device=dev),
                dlam=torch.zeros((problem.m,), dtype=dtype, device=dev),
                it_total=scalar(0, torch.int32, dev), rhs=torch.zeros_like(x),
                it_bulk=scalar(0, torch.int32, dev))


def _operator(problem: SparseProblem, e: _EQP, dtype=None):
    """(K, jv, jtv) of the condensed operator

        K v = (H + reg I) v_f + (1/delta) J_W^T J_W v_f,  v_f = v on the free variables

    with the callables run in ``dtype`` (the problem's where None; float32
    for the mixed route's bulk CG)."""
    if dtype is None or dtype == problem.dtype:
        xc, lamc, freec, actc, regc = e.x, e.lam_act, e.free, e.actf, e.reg
        dtype = problem.dtype
    else:
        xc = e.x.to(dtype)
        problem.check_follows_dtype(xc)
        lamc, freec, actc, regc = (t.to(dtype) for t in (e.lam_act, e.free, e.actf, e.reg))
    invd = scalar(1.0 / DELTA, dtype, e.x.device)
    hv = problem.hessian_product(xc, lamc)
    jv, jtv = problem.jacobian_products(xc)

    def K(v):
        vf = v * freec
        out = hv(vf) + regc * vf
        if problem.m:
            out = out + invd * jtv(jv(vf) * actc)
        return out * freec

    return K, jv, jtv


def _passes(problem: SparseProblem) -> int:
    """The EQP's passes: AL_ITERS multiplier refinements, one without rows."""
    return AL_ITERS if problem.m else 1


def _pass_begin(problem: SparseProblem, e: _EQP, jtv) -> _EQP:
    """A pass's right-hand side; each pass solves the moderately
    regularized K and tightens J_W d = target by ~delta."""
    rhs = -(e.g_eff * e.free)
    if problem.m:
        inv_delta = scalar(1.0 / DELTA, problem.dtype, e.x.device)
        rhs = rhs + jtv((inv_delta * e.target - e.dlam) * e.actf) * e.free
    return e._replace(rhs=rhs)


def _pass_end(problem: SparseProblem, e: _EQP, d: Tensor, it: Tensor, jv) -> _EQP:
    """A pass after its CG solve (d, it): the multiplier increment."""
    d = d * e.free
    if not problem.m:
        return e._replace(d=d, it_total=it)
    inv_delta = scalar(1.0 / DELTA, problem.dtype, e.x.device)
    dlam = e.dlam + (jv(d) - e.target) * inv_delta * e.actf
    return e._replace(d=d, dlam=dlam, it_total=e.it_total + it)


def _bulk_start(problem: SparseProblem, e: _EQP, K, mixed: bool, cg_tol: Any) -> _CG:
    """The CG solve of a pass from its last step: in the problem's dtype to
    ``cg_tol``, or the mixed route's float32 bulk (to 1e-7) on its K32."""
    if not mixed:
        return _cg_start(K, e.rhs, cg_tol, problem.dtype, x0=e.d)
    f32 = torch.float32
    return _cg_start(K, e.rhs.to(f32), scalar(1e-7, f32, e.x.device), f32, x0=e.d.to(f32))


def _polish_start(problem: SparseProblem, e: _EQP, K, bulk: _CG, cg_tol: Any):
    """The mixed route's float64 polish of the last pass, warm-started from
    its float32 solution: (the EQP, the polish's CG)."""
    d = bulk.x.to(problem.dtype)
    return e._replace(it_bulk=bulk.it), _cg_start(K, e.rhs, cg_tol, problem.dtype, x0=d)


def _polish_cap(problem: SparseProblem) -> int:
    return max(problem.cg_iters // 4, 25)


def _kkt_solve_cg(
    problem: SparseProblem,
    x: Tensor,
    lam_act: Tensor,
    act: Tensor,
    target: Tensor,
    g_eff: Tensor,
    frozen: Tensor,
    reg: Tensor,
    cg_tol: Any,
    mixed: bool = False,
):
    """Delta-form condensed EQP via matrix-free CG.

    minimize 1/2 d^T (H + reg I) d + g_eff^T d
        s.t. J_W d = target (active rows), d_frozen = 0

    through K = H + reg I + (1/delta) J_W^T J_W (SPD on the free subspace);
    returns (d, dlam, cg_iters) with dlam the multiplier INCREMENT (callers
    form lam_qp = lam_act + dlam), the banded path's formulation.  Without
    rows one pass, else AL_ITERS multiplier-refinement passes, each warm
    started from the last; one host read a block of CG steps.

    ``mixed=True`` runs the bulk CG iterations through the operator with
    the callables called on float32 tensors and finishes the last pass with
    a float64 CG polish warm-started from that solution, so the returned
    step carries float64 accuracy.
    """
    dtype = problem.dtype
    e = _eqp(problem, x, lam_act, act, target, g_eff, frozen, reg)
    K, jv, jtv = _operator(problem, e)
    K_bulk = _operator(problem, e, torch.float32)[0] if mixed else K
    passes = _passes(problem)
    for k in range(passes):
        e = _pass_begin(problem, e, jtv)
        cg = _cg_blocks(K_bulk, _bulk_start(problem, e, K_bulk, mixed, cg_tol), problem.cg_iters)
        d, it = cg.x.to(dtype), cg.it
        if mixed and k == passes - 1:
            e, polish = _polish_start(problem, e, K, cg, cg_tol)
            polish = _cg_blocks(K, polish, _polish_cap(problem))
            d, it = polish.x, e.it_bulk + polish.it
        e = _pass_end(problem, e, d, it, jv)
    return e.d, e.dlam, e.it_total


# ---- the optimality iteration, in parts ------------------------------------


class _OptHead(NamedTuple):
    """An optimality iteration's derivatives, working set, bound freeze and
    stop test."""

    g: Tensor
    viol: Tensor
    feas_res: Tensor
    act_low: Tensor
    act_up: Tensor
    act: Tensor
    target: Tensor
    lam_act: Tensor
    r: Tensor  # the reduced gradient, the EQP's g_eff
    frozen: Tensor
    stat_res: Tensor
    optimal: Tensor
    infeasible: Tensor
    stop: Tensor
    lp_x: Tensor
    lp_y: Tensor


class _OptSearch(NamedTuple):
    """What an optimality iteration's linesearch and update take from its
    EQP step."""

    X: Tensor
    d: Tensor
    lam_qp: Tensor
    penalty: Tensor
    base: Tensor  # the l1 merit at X
    descent: Tensor
    has_descent: Tensor
    dHd: Tensor
    feas_steps: Tensor
    penalty_resets: Tensor
    cg_it: Tensor


def _opt_head(problem: SparseProblem, settings: Settings, state: SparseState,
              lp=None) -> _OptHead:
    """An optimality iteration (problem_solver/iteration.c:350 with the
    subproblem layers replaced by reverse-mode products and CG) up to its
    EQP; ``lp``: (act_low, act_up, lp_x, lp_y) of the Cauchy LP where
    ``cauchy="pdlp"``."""
    dtype = problem.dtype
    x = state.x
    m = problem.m

    g = problem.obj_grad(x)
    C = problem.cons(x)
    viol = _violation(problem, C)
    feas_res = max0(viol)

    # ---- working set ----------------------------------------------------
    tol_act = settings.eps * 1e4
    scale_lo = 1.0 + problem.cons_lb.abs()
    is_eq = (problem.cons_ub - problem.cons_lb).abs() <= 1e-12 * scale_lo
    if lp is not None:
        # the reference architecture: the Cauchy LP discovers the working
        # set each iteration (warm-started matrix-free PDLP)
        act_low, act_up, lp_x, lp_y = lp
    else:
        # eps-active + wrong-sign dual drop (cheap local discovery)
        scale_hi = 1.0 + problem.cons_ub.abs()
        near_lo = (problem.cons_lb > -INF_THRESHOLD) & (C <= problem.cons_lb + tol_act * scale_lo)
        near_up = (problem.cons_ub < INF_THRESHOLD) & (C >= problem.cons_ub - tol_act * scale_hi)
        wrong_lo = state.act_low & ~is_eq & (state.lam > tol_act)
        wrong_up = state.act_up & (state.lam < -tol_act)
        act_low = is_eq | (near_lo & ~wrong_lo) | (state.act_low & ~wrong_lo)
        act_up = (~is_eq) & ((near_up & ~wrong_up) | (state.act_up & ~wrong_up)) & ~act_low
        lp_x, lp_y = state.lp_x, state.lp_y
    act = act_low | act_up

    target = torch.where(act_low, problem.cons_lb - C,
                         torch.where(act_up, problem.cons_ub - C, 0.0))

    # ---- bound freeze via reduced gradient ------------------------------
    lam_act = state.lam * act.to(dtype)
    r = g + problem.vjp(x, lam_act) if m else g
    at_lb = (problem.var_lb > -INF_THRESHOLD) & (
        x <= problem.var_lb + settings.eps * (1.0 + problem.var_lb.abs()))
    at_ub = (problem.var_ub < INF_THRESHOLD) & (
        x >= problem.var_ub - settings.eps * (1.0 + problem.var_ub.abs()))
    frozen = (at_lb & (r > 0.0)) | (at_ub & (r < 0.0))

    stat_res = max0(torch.where(frozen, 0.0, r).abs())
    sign_ok = torch.where(
        state.act_low & ~is_eq, state.lam <= tol_act,
        torch.where(state.act_up, state.lam >= -tol_act, True)).all()
    optimal = (feas_res <= settings.feas_tol) & (stat_res <= settings.stat_tol) & sign_ok
    infeasible = feas_res > settings.feas_tol
    stop = optimal | ((state.reg >= REG_MAX) & ~infeasible)
    return _OptHead(g=g, viol=viol, feas_res=feas_res, act_low=act_low, act_up=act_up, act=act,
                    target=target, lam_act=lam_act, r=r, frozen=frozen, stat_res=stat_res,
                    optimal=optimal, infeasible=infeasible, stop=stop, lp_x=lp_x, lp_y=lp_y)


def _stopped(state: SparseState, h: _OptHead) -> SparseState:
    """The state of a solve that stops here: OPTIMAL or a dead point."""
    status = torch.where(h.optimal, int(Status.OPTIMAL), int(Status.ABORT_DEADPOINT))
    return dataclasses.replace(state, status=status.to(torch.int32), feas_res=h.feas_res,
                               stat_res=h.stat_res)


def _opt_search(problem: SparseProblem, settings: Settings, state: SparseState, h: _OptHead,
                d: Tensor, dlam: Tensor, cg_it: Tensor) -> _OptSearch:
    """The EQP step's multipliers, the penalty and what the l1-merit
    backtracking linesearch needs."""
    x = state.x
    lam_qp = h.lam_act + dlam
    step_ok = torch.isfinite(d).all() & torch.isfinite(lam_qp).all()
    d = torch.where(step_ok, d, 0.0)
    lam_qp = torch.where(step_ok, lam_qp, state.lam)

    # ---- penalty above multiplier scale (penalty.c:5-50) ----------------
    lam_norm = max0(lam_qp.abs())
    penalty = torch.where(state.penalty >= 1.5 * lam_norm, state.penalty,
                          torch.maximum(10.0 * state.penalty, 2.0 * lam_norm))
    # global penalty reset after 5 consecutive feasible iterations, at most
    # twice (trial_point/cauchy_step.c:33-95, iteration.c:10-11)
    feas_steps = torch.where(h.feas_res <= settings.feas_tol, state.feas_steps + 1,
                             0).to(torch.int32)
    fresh = torch.clamp(1.5 * lam_norm, min=10.0)
    can_reset = (feas_steps >= 5) & (state.penalty_resets < 2) & (penalty > 10.0 * fresh)
    penalty = torch.where(can_reset, fresh, penalty)
    penalty_resets = state.penalty_resets + can_reset.to(torch.int32)
    feas_steps = torch.where(can_reset, 0, feas_steps).to(torch.int32)

    # ---- l1 merit + backtracking linesearch -----------------------------
    gd = (h.g * d).sum()
    dHd = (d * problem.lag_hess_prod(x, h.lam_act, d)).sum()
    viol0 = h.viol.sum()
    descent = penalty * viol0 - gd
    return _OptSearch(X=x, d=d, lam_qp=lam_qp, penalty=penalty,
                      base=state.obj_val + penalty * viol0, descent=descent,
                      has_descent=(descent > 0.0) & step_ok, dHd=dHd, feas_steps=feas_steps,
                      penalty_resets=penalty_resets, cg_it=cg_it)


def _opt_trial(problem: SparseProblem, s: _OptSearch, alpha: Tensor) -> Tensor:
    """The l1 merit at the trial point of step length alpha."""
    xa = trial_point(problem, s, alpha)
    return problem.obj(xa) + s.penalty * _violation(problem, problem.cons(xa)).sum()


def _opt_finish(problem: SparseProblem, settings: Settings, state: SparseState, h: _OptHead,
                s: _OptSearch, carry) -> SparseState:
    """An optimality iteration after its linesearch: the step taken, the
    reduction ratio, the Levenberg update, the restoration trigger and the
    Cauchy LP's radius."""
    dtype, dev = problem.dtype, state.x.device
    accepted = carry[1] & s.has_descent
    alpha = torch.where(accepted, carry[0], 0.0)

    merit_trial = _opt_trial(problem, s, alpha)
    x_new = trial_point(problem, s, alpha)
    pred = alpha * s.descent - 0.5 * alpha**2 * s.dHd
    actual = s.base - merit_trial
    eps10 = 10.0 * torch.finfo(dtype).eps * (1.0 + s.base.abs())
    tiny = (pred.abs() <= eps10) & (actual.abs() <= eps10)
    ratio = torch.where(tiny, 1.0, actual / torch.where(pred == 0.0, 1.0, pred))

    reg_new = levenberg(state.reg, ratio, accepted, REG_FAIL, REG_MAX)
    x_next = torch.where(accepted, x_new, s.X)
    lam_next = torch.where(accepted, s.lam_qp, state.lam)

    bad = h.infeasible & ~accepted
    bad_steps = torch.where(bad, state.bad_steps + 1, 0).to(torch.int32)
    enter_rest = h.infeasible & ((bad_steps >= RESTORATION_TRIGGER) | (state.reg >= REG_MAX))
    phase_next = torch.where(enter_rest, int(SolverPhase.RESTORATION),
                             int(SolverPhase.OPTIMIZATION)).to(torch.int32)
    reg_next = torch.where(enter_rest, 1e-6, reg_new)
    bad_steps = torch.where(enter_rest, 0, bad_steps).to(torch.int32)

    # l-inf LP radius by step quality (trust_radius.c:5-45 shape)
    step_norm = max0(s.d.abs())
    lp_tr = torch.where(accepted, torch.where(ratio >= 0.9,
                                              torch.maximum(state.lp_tr, 2.0 * step_norm),
                                              state.lp_tr),
                        0.5 * state.lp_tr)
    lp_tr_next = torch.clamp(lp_tr, 1e-10, 1e10)

    return SparseState(
        x=x_next,
        lam=lam_next,
        act_low=h.act_low,
        act_up=h.act_up,
        penalty=s.penalty,
        reg=reg_next,
        iteration=state.iteration + 1,
        status=scalar(int(Status.RUNNING), torch.int32, dev),
        num_accepted=state.num_accepted + accepted.to(torch.int32),
        num_rejected=state.num_rejected + (~accepted).to(torch.int32),
        obj_val=problem.obj(x_next),
        feas_res=h.feas_res,
        stat_res=h.stat_res,
        last_ratio=ratio,
        last_alpha=alpha,
        phase=phase_next,
        bad_steps=bad_steps,
        cg_iterations=state.cg_iterations + s.cg_it,
        feas_steps=s.feas_steps,
        penalty_resets=s.penalty_resets,
        lp_x=h.lp_x,
        lp_y=h.lp_y,
        lp_tr=lp_tr_next,
    )


def _linesearch(problem, settings: Settings, trial, s):
    """The eager Armijo loop: one read of the descent flag, one a trial."""
    carry = armijo_start(s)
    if lanes_any(s.has_descent):
        carry = armijo(problem, settings, trial, s, carry, MAX_LINESEARCH_STEPS,
                       first=s.has_descent)
    return carry


def _optimality_iteration(problem: SparseProblem, settings: Settings,
                          state: SparseState) -> SparseState:
    """One matrix-free SQP iteration, eagerly.  Reads the stop flag once,
    the descent flag once, one flag a linesearch trial, a CG block and a
    PDLP block."""
    dtype, dev = problem.dtype, state.x.device
    lp = None
    if problem.cauchy == "pdlp":
        _, act_low, act_up, res = sparse_cauchy(problem, state.x, state.lp_tr, state.penalty,
                                                lp_x=state.lp_x, lp_y=state.lp_y)
        lp = (act_low, act_up, res.x, res.duals)
    h = _opt_head(problem, settings, state, lp)
    if not lanes_any(~h.stop):
        return _stopped(state, h)
    d, dlam, cg_it = _kkt_solve_cg(problem, state.x, h.lam_act, h.act, h.target, h.r, h.frozen,
                                   state.reg, scalar(CG_TOL, dtype, dev),
                                   mixed=mixed_route(settings, dtype))
    s = _opt_search(problem, settings, state, h, d, dlam, cg_it)
    return _opt_finish(problem, settings, state, h, s, _linesearch(problem, settings,
                                                                      _opt_trial, s))


# ---- the restoration iteration, in parts ------------------------------------


class _RestHead(NamedTuple):
    """A restoration iteration's violated rows and their targets."""

    viol_sum: Tensor  # the l1 violation at x
    C: Tensor
    actf: Tensor
    target: Tensor


class _RestSearch(NamedTuple):
    """What a restoration iteration's linesearch and update take from its
    Gauss-Newton step."""

    X: Tensor
    d: Tensor
    base: Tensor  # the l1 violation at X
    descent: Tensor
    has_descent: Tensor
    cg_it: Tensor


def _rest_head(problem: SparseProblem, state: SparseState) -> _RestHead:
    """Matrix-free Gauss-Newton feasibility restoration (restoration.c
    analogue; identity prox metric, violated rows as working set)."""
    C = problem.cons(state.x)
    below = (problem.cons_lb > -INF_THRESHOLD) & (C < problem.cons_lb)
    above = (problem.cons_ub < INF_THRESHOLD) & (C > problem.cons_ub)
    target = torch.where(below, problem.cons_lb - C,
                         torch.where(above, problem.cons_ub - C, 0.0))
    return _RestHead(viol_sum=_violation(problem, C).sum(), C=C,
                     actf=(below | above).to(problem.dtype), target=target)


def _rest_operator(problem: SparseProblem, state: SparseState, h: _RestHead):
    """(K, jv, jtv) of the Gauss-Newton step: K v = (1 + reg) v + (1/delta)
    J_W^T J_W v on the violated rows."""
    inv_delta = scalar(1.0 / DELTA, problem.dtype, state.x.device)
    jv, jtv = problem.jacobian_products(state.x)

    def K(v):
        return v * (1.0 + state.reg) + inv_delta * jtv(jv(v) * h.actf)

    return K, jv, jtv


def _rest_start(problem: SparseProblem, state: SparseState, h: _RestHead, K, jtv) -> _CG:
    """The restoration step's CG solve before its first step."""
    dtype, dev = problem.dtype, state.x.device
    rhs = scalar(1.0 / DELTA, dtype, dev) * jtv(h.target * h.actf)
    return _cg_start(K, rhs, scalar(CG_TOL, dtype, dev), dtype)


def _rest_search(problem: SparseProblem, state: SparseState, h: _RestHead, cg: _CG,
                 jv) -> _RestSearch:
    """The Gauss-Newton step and the predicted violation drop of the full
    linearized step."""
    step_ok = torch.isfinite(cg.x).all()
    d = torch.where(step_ok, cg.x, 0.0)
    descent = h.viol_sum - _violation(problem, h.C + jv(d)).sum()
    return _RestSearch(X=state.x, d=d, base=h.viol_sum, descent=descent,
                       has_descent=(descent > 0.0) & step_ok, cg_it=cg.it)


def _rest_trial(problem: SparseProblem, s: _RestSearch, alpha: Tensor) -> Tensor:
    """The l1 violation at the trial point of step length alpha."""
    return _violation(problem, problem.cons(trial_point(problem, s, alpha))).sum()


def _rest_finish(problem: SparseProblem, settings: Settings, state: SparseState,
                 s: _RestSearch, carry) -> SparseState:
    """A restoration iteration after its linesearch.  Returns to
    OPTIMIZATION once feasible (penalty x10); a maxed-out regularization
    while still infeasible is a local-infeasibility certificate
    (Status.INFEASIBLE), selected, not read."""
    dev = state.x.device
    accepted = carry[1] & s.has_descent
    alpha = torch.where(accepted, carry[0], 0.0)
    x_next = torch.where(accepted, trial_point(problem, s, alpha), s.X)
    reg_new = torch.where(accepted, torch.clamp(state.reg / 7.0, min=REG_MIN),
                          torch.clamp(torch.clamp(10.0 * state.reg, min=REG_FAIL), max=REG_MAX))

    feas_new = max0(_violation(problem, problem.cons(x_next)))
    restored = feas_new <= settings.feas_tol
    running = dataclasses.replace(
        state,
        x=x_next,
        iteration=state.iteration + 1,
        num_accepted=state.num_accepted + accepted.to(torch.int32),
        num_rejected=state.num_rejected + (~accepted).to(torch.int32),
        obj_val=problem.obj(x_next),
        feas_res=feas_new,
        phase=torch.where(restored, int(SolverPhase.OPTIMIZATION),
                          int(SolverPhase.RESTORATION)).to(torch.int32),
        penalty=torch.where(restored, state.penalty * 10.0, state.penalty),
        reg=torch.where(restored, 1e-8, reg_new),
        cg_iterations=state.cg_iterations + s.cg_it,
    )
    certified = (state.reg >= REG_MAX) & ~restored  # locally infeasible
    stopped = dataclasses.replace(state, status=scalar(int(Status.INFEASIBLE), torch.int32, dev),
                                  feas_res=feas_new)
    return tree_where(certified, stopped, running)


def _restoration_iteration(problem: SparseProblem, settings: Settings,
                           state: SparseState) -> SparseState:
    """One restoration iteration, eagerly.  Reads a CG block, the descent
    flag and one flag a trial."""
    h = _rest_head(problem, state)
    K, jv, jtv = _rest_operator(problem, state, h)
    cg = _cg_blocks(K, _rest_start(problem, state, h, K, jtv), problem.cg_iters)
    s = _rest_search(problem, state, h, cg, jv)
    return _rest_finish(problem, settings, state, s, _linesearch(problem, settings, _rest_trial, s))


def _iterate(problem, settings, state, phase: int):
    if phase == SolverPhase.RESTORATION:
        return _restoration_iteration(problem, settings, state)
    return _optimality_iteration(problem, settings, state)


def sparse_perform_iteration(problem: SparseProblem, settings: Settings,
                             state: SparseState) -> SparseState:
    """Phase-dispatched iteration, SparseState -> SparseState; one host
    read of the phase."""
    if state.x.device.type == "cuda":
        require_full_fp32()
    return _iterate(problem, settings, state, int(state.phase))


def sparse_solve_from(problem: SparseProblem, settings: Settings, state0: SparseState,
                      max_iterations: int = 200) -> SparseState:
    """Iterate from ``state0`` until OPTIMAL, INFEASIBLE, a dead point or
    ``max_iterations`` (then ABORT_ITER), eagerly, reading as it goes: the
    status, phase and iteration together before the first trip and the
    status and phase after each, and inside an iteration the stop test, a
    flag a CG block, a PDHG block, the descent flag and each Armijo trial.
    It is the oracle of ``sparse_solve_jit``: the same iterations, the same
    bits."""
    if state0.x.device.type == "cuda":
        require_full_fp32()
    state = state0
    status, phase, iteration = torch.stack([state.status, state.phase, state.iteration]).tolist()
    while status == Status.RUNNING and iteration < max_iterations:
        state = _iterate(problem, settings, state, phase)
        iteration += 1
        status, phase = torch.stack([state.status, state.phase]).tolist()
    if status == Status.RUNNING:
        state = dataclasses.replace(state, status=scalar(int(Status.ABORT_ITER), torch.int32,
                                                         state.x.device))
    return state


# ---- the solve as device programs (sparse_solve_jit) ----------------------

# The Armijo trials of sparse_solve_jit's iteration: the first few inside
# the program that takes the EQP step, the rest, while the linesearch goes
# on, in blocks of masked trials, one read a block.  Together
# MAX_LINESEARCH_STEPS.  A trial is one evaluation of obj and cons.
GRAPH_TRIALS = 4
TRIAL_BLOCK = 7
_BLOCKS, _LEFT = divmod(MAX_LINESEARCH_STEPS - GRAPH_TRIALS, TRIAL_BLOCK)
assert _LEFT == 0, "the trial blocks must end at the linesearch's cap"


def _lp_trips(problem: SparseProblem) -> list:
    """The PDHG iterations of each block the Cauchy LP may run."""
    cap = problem.cauchy_iters
    return [pdlp.block_length(t, cap) for t in range(cap // pdlp.CHECK_EVERY + 1)]


def _cg_runs(cap: int) -> int:
    """The CG blocks that reach the cap."""
    return -(-cap // CG_BLOCK)


def _opt_programs(problem: SparseProblem, settings: Settings) -> dict:
    """The read-free programs of an optimality iteration, by name, on a
    dict of buffers (``state``, ``max_it``; what the programs write:
    ``lp.setup``, ``lp.loop``, ``opt.h``, ``eqp``, ``cg``, ``cg32``,
    ``opt.s``, ``opt.carry``, ``flag``).  In order:

    * ``opt.lp_start`` (``cauchy="pdlp"``): the Cauchy LP, the start of its
      PDLP solve and the first block of PDHG iterations; ``opt.lp_block``,
      ``opt.lp_tail``: a whole block and the short last one (flag bit LP:
      the solve goes on);
    * ``opt.head``: the working set, bound freeze and stop test, where the
      state stops (no RUNNING bit), and the start of the EQP's first pass;
    * ``opt.cg``, ``opt.cg32``: CG_BLOCK steps of the float64 and of the
      mixed route's float32 CG (bit CG: it goes on), each rebuilding its
      operator from the buffers;
    * ``opt.pass``: a pass's multiplier update and the next pass's start;
      ``opt.polish``: the mixed route's float64 polish of the last pass;
    * ``opt.search``: the step, penalty and merit, GRAPH_TRIALS Armijo
      trials and, unless the linesearch goes on (bit SEARCHING), the
      update; ``opt.trials`` (TRIAL_BLOCK more) and ``opt.finish`` end a
      long linesearch.  Their flags say RUNNING and RESTORING."""
    dtype = problem.dtype
    mixed = mixed_route(settings, dtype)
    bulk = "cg32" if mixed else "cg"
    cap = problem.cg_iters
    cap64 = _polish_cap(problem)
    f32 = torch.float32 if mixed else None
    trips = _lp_trips(problem)

    def eqp_ops(e):
        K, jv, jtv = _operator(problem, e)
        return K, jv, jtv, _operator(problem, e, f32)[0] if mixed else K

    def cg_tol(e):
        return scalar(CG_TOL, dtype, e.x.device)

    def lp_op(state):
        return _cauchy_lp(problem, state.x, state.lp_tr, state.penalty)

    def lp_start(b):
        state = b["state"]
        with device_resident():
            op, c_obj, lb, ub, _, _ = lp_op(state)
            setup, loop = pdlp.start(op, c_obj, lb, ub, x0=state.lp_x, y0=state.lp_y,
                                     tol=CAUCHY_TOL)
            loop = pdlp.block(op, setup, loop, trips[0])
        return {"lp.setup": setup, "lp.loop": loop, "flag": lp_flag(loop)}

    def lp_flag(loop):
        return LP * pdlp.running(loop, problem.cauchy_iters).to(torch.int32)

    def lp_block(length):
        def run(b):
            with device_resident():
                op = lp_op(b["state"])[0]
                loop = pdlp.block(op, b["lp.setup"], b["lp.loop"], length)
            return {"lp.loop": loop, "flag": lp_flag(loop)}

        return run

    def head(b):
        state = b["state"]
        with device_resident():
            lp = None
            if problem.cauchy == "pdlp":
                op, _, _, _, w_lb, w_ub = lp_op(state)
                res = pdlp.finish(op, b["lp.setup"], b["lp.loop"])
                lp = (*_working_set(problem, res, w_lb, w_ub), res.x, res.duals)
            h = _opt_head(problem, settings, state, lp)
            e = _eqp(problem, state.x, h.lam_act, h.act, h.target, h.r, h.frozen, state.reg)
            _, _, jtv, K_bulk = eqp_ops(e)
            e = _pass_begin(problem, e, jtv)
            cg = _bulk_start(problem, e, K_bulk, mixed, cg_tol(e))
        out = tree_where(h.stop, _stopped(state, h), state)
        return {"state": out, "opt.h": h, "eqp": e, bulk: cg,
                "flag": loop_flag(out, b["max_it"])}

    def cg_block(buf, cg_dtype, cap):
        def run(b):
            with device_resident():
                K = _operator(problem, b["eqp"], cg_dtype)[0]
                cg = _cg_block(K, b[buf], cap)
            return {buf: cg, "flag": CG * _cg_running(cg, cap).to(torch.int32)}

        return run

    def bulk_result(b):
        cg = b[bulk]
        return cg.x.to(dtype), cg.it

    def next_pass(b):
        with device_resident():
            e = b["eqp"]
            _, jv, jtv, K_bulk = eqp_ops(e)
            e = _pass_begin(problem, _pass_end(problem, e, *bulk_result(b), jv), jtv)
            cg = _bulk_start(problem, e, K_bulk, mixed, cg_tol(e))
        return {"eqp": e, bulk: cg}

    def polish(b):
        with device_resident():
            e = b["eqp"]
            e, cg = _polish_start(problem, e, _operator(problem, e)[0], b["cg32"], cg_tol(e))
        return {"eqp": e, "cg": cg}

    def search(b):
        state, h = b["state"], b["opt.h"]
        with device_resident():
            e = b["eqp"]
            jv = _operator(problem, e)[1]
            if mixed:
                d, it = b["cg"].x, e.it_bulk + b["cg"].it
            else:
                d, it = bulk_result(b)
            e = _pass_end(problem, e, d, it, jv)
            s = _opt_search(problem, settings, state, h, e.d, e.dlam, e.it_total)
            carry = armijo(problem, settings, _opt_trial, s, armijo_start(s), GRAPH_TRIALS,
                           first=s.has_descent)
            out = _opt_finish(problem, settings, state, h, s, carry)
        searching = s.has_descent & ~carry[1]
        # a state whose linesearch goes on stays
        out = tree_where(searching, state, out)
        return {"state": out, "opt.s": s, "opt.carry": carry,
                "flag": loop_flag(out, b["max_it"], searching)}

    def trials(b):
        s = b["opt.s"]
        with device_resident():
            carry = armijo(problem, settings, _opt_trial, s, b["opt.carry"], TRIAL_BLOCK)
        return {"opt.carry": carry,
                "flag": SEARCHING * (s.has_descent & ~carry[1]).to(torch.int32)}

    def finish(b):
        with device_resident():
            out = _opt_finish(problem, settings, b["state"], b["opt.h"], b["opt.s"],
                              b["opt.carry"])
        return {"state": out, "flag": loop_flag(out, b["max_it"])}

    programs = {}
    if problem.cauchy == "pdlp":
        programs.update({"opt.lp_start": lp_start, "opt.lp_block": lp_block(pdlp.CHECK_EVERY),
                         "opt.lp_tail": lp_block(trips[-1])})
    programs["opt.head"] = head
    programs[f"opt.{bulk}"] = cg_block(bulk, f32, cap)
    if _passes(problem) > 1:
        programs["opt.pass"] = next_pass
    if mixed:
        programs.update({"opt.polish": polish, "opt.cg": cg_block("cg", None, cap64)})
    programs.update({"opt.search": search, "opt.trials": trials, "opt.finish": finish})
    return programs


def _rest_programs(problem: SparseProblem, settings: Settings) -> dict:
    """The read-free programs of a restoration iteration: ``rest.head``
    (the violated rows and the start of the float64 CG solve), ``rest.cg``
    (CG_BLOCK steps; bit CG), ``rest.search`` (the step, GRAPH_TRIALS
    trials and the update, the certificate selected), ``rest.trials`` and
    ``rest.finish``."""
    cap = problem.cg_iters

    def head(b):
        state = b["state"]
        with device_resident():
            h = _rest_head(problem, state)
            K, _, jtv = _rest_operator(problem, state, h)
            cg = _rest_start(problem, state, h, K, jtv)
        return {"rest.h": h, "cg": cg}

    def cg_block(b):
        with device_resident():
            K = _rest_operator(problem, b["state"], b["rest.h"])[0]
            cg = _cg_block(K, b["cg"], cap)
        return {"cg": cg, "flag": CG * _cg_running(cg, cap).to(torch.int32)}

    def search(b):
        state = b["state"]
        with device_resident():
            jv = _rest_operator(problem, state, b["rest.h"])[1]
            s = _rest_search(problem, state, b["rest.h"], b["cg"], jv)
            carry = armijo(problem, settings, _rest_trial, s, armijo_start(s), GRAPH_TRIALS,
                           first=s.has_descent)
            out = _rest_finish(problem, settings, state, s, carry)
        searching = s.has_descent & ~carry[1]
        out = tree_where(searching, state, out)
        return {"state": out, "rest.s": s, "rest.carry": carry,
                "flag": loop_flag(out, b["max_it"], searching)}

    def trials(b):
        s = b["rest.s"]
        with device_resident():
            carry = armijo(problem, settings, _rest_trial, s, b["rest.carry"], TRIAL_BLOCK)
        return {"rest.carry": carry,
                "flag": SEARCHING * (s.has_descent & ~carry[1]).to(torch.int32)}

    def finish(b):
        with device_resident():
            out = _rest_finish(problem, settings, b["state"], b["rest.s"], b["rest.carry"])
        return {"state": out, "flag": loop_flag(out, b["max_it"])}

    return {"rest.head": head, "rest.cg": cg_block, "rest.search": search,
            "rest.trials": trials, "rest.finish": finish}


def _capture_hint(problem: SparseProblem) -> str:
    callables = ", ".join(f"{field}={getattr(f, '__qualname__', repr(f))}"
                          for field, f in (("obj", problem.obj), ("cons", problem.cons)))
    return ("sparse_solve_jit: the iteration could not be captured as a CUDA graph; the "
            f"problem's callables ({callables}) run inside it and must neither read the card "
            "(.item(), bool(), .tolist(), .cpu()) nor copy host data to it (a tensor made from "
            "host values or moved from the CPU inside the callable)")


def solve_graphs(problem: SparseProblem, settings: Settings, state0: SparseState,
                 max_iterations: int = 200) -> Programs:
    """``sparse_solve_jit``'s programs for this problem, settings and the
    device, shapes and dtypes of ``state0``, made at the first call and
    cached on the problem.  On CUDA a phase's programs are captured when a
    solve first runs an iteration of that phase (the restoration programs
    only once a solve enters restoration, the short last PDHG block only
    once a Cauchy LP reaches it)."""

    def make():
        dev = state0.x.device
        bodies = {**_opt_programs(problem, settings), **_rest_programs(problem, settings)}
        bufs = dict(state=tree_map(torch.clone, state0),
                    max_it=torch.full((), max_iterations, dtype=torch.int32, device=dev))
        return Programs(bodies, bufs, graphs.on_graphs(dev), graphs.captured, graphs.LAUNCHES,
                        hint=_capture_hint(problem))

    return cached(problem, (settings, *state_key(state0)), make)


def _opt_step(problem: SparseProblem, settings: Settings, loop: Programs) -> int:
    """One optimality iteration on the programs; returns the last flag."""
    mixed = mixed_route(settings, problem.dtype)
    loop.prepare(*(name for name in _opt_programs(problem, settings) if name != "opt.lp_tail"))
    if problem.cauchy == "pdlp":
        # the eager loop's reads: one before each block after the first,
        # none after the last block the cap allows
        trips = _lp_trips(problem)
        loop.replay("opt.lp_start")
        for length in trips[1:]:
            if not loop.flag() & LP:
                break
            name = "opt.lp_block" if length == pdlp.CHECK_EVERY else "opt.lp_tail"
            loop.prepare(name)
            loop.replay(name)
    loop.replay("opt.head")
    flag = loop.flag()
    if not flag & RUNNING:
        return flag  # the iteration stopped the solve
    bulk = "opt.cg32" if mixed else "opt.cg"
    for k in range(_passes(problem)):
        if k:
            loop.replay("opt.pass")
        loop.repeat(bulk, CG, _cg_runs(problem.cg_iters))
    if mixed:
        loop.replay("opt.polish")
        loop.repeat("opt.cg", CG, _cg_runs(_polish_cap(problem)))
    return loop.step("opt.search", "opt.trials", "opt.finish", _BLOCKS)


def _rest_step(problem: SparseProblem, settings: Settings, loop: Programs) -> int:
    """One restoration iteration on the programs; returns the last flag."""
    names = ("rest.head", "rest.cg", "rest.search", "rest.trials", "rest.finish")
    loop.prepare(*names)
    loop.replay("rest.head")
    loop.repeat("rest.cg", CG, _cg_runs(problem.cg_iters))
    return loop.step("rest.search", "rest.trials", "rest.finish", _BLOCKS)


def sparse_solve_jit(problem: SparseProblem, settings: Settings, state0: SparseState,
                     max_iterations: int) -> SparseState:
    """The whole solve from ``state0`` as device programs
    (``sleqp_tpu/sparse.py::sparse_solve_jit``): on the card CUDA graphs
    (``solve_graphs``, cached on the problem: a second solve of the same
    problem, settings and shapes replays without a new capture), on the
    CPU the same programs eagerly.  The host reads the flag the programs
    leave once before the first iteration and once after a program that
    ends a block of CG steps or PDHG iterations, the stop test, or the
    iteration: no more reads than ``sparse_solve_from``, whose result it
    is, bit for bit.  The flag's phase bit picks the next iteration's
    programs (the reference's ``lax.cond``).  A state still RUNNING at the
    end is ABORT_ITER.  A capture that fails raises."""
    if state0.x.device.type == "cuda":
        require_full_fp32()
    loop = solve_graphs(problem, settings, state0, max_iterations)
    loop.load(state0, max_iterations)
    flag = loop.read(loop_flag(state0, loop.bufs["max_it"]))
    while flag & RUNNING:
        step = _rest_step if flag & RESTORING else _opt_step
        flag = step(problem, settings, loop)
    state = loop.result()
    status = torch.where(state.status == int(Status.RUNNING), int(Status.ABORT_ITER), state.status)
    return dataclasses.replace(state, status=status.to(torch.int32))


def sparse_solve(
    problem: SparseProblem,
    settings: Optional[Settings] = None,
    x0: Any = None,
    max_iterations: int = 200,
) -> SparseState:
    """Solve a general sparse NLP matrix-free where the problem lives;
    returns the final state, through ``sparse_solve_jit`` (on the card,
    CUDA graphs)."""
    settings = settings or Settings()
    dev = problem.device
    if dev.type == "cuda":
        require_full_fp32()
    if x0 is None:
        x0 = torch.zeros((problem.n,), dtype=problem.dtype, device=dev)
    state0 = sparse_initial_state(problem, settings, x0)
    return sparse_solve_jit(problem, settings, state0, max_iterations)
