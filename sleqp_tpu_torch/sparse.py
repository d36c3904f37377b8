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

The reference's ``lax.while_loop``s become host decisions: CG runs in
blocks of ``CG_BLOCK`` steps, each step frozen by ``torch.where`` once the
exit condition holds, and the host reads one flag a block; the iteration,
the Armijo loop and the phase dispatch read one flag each, as in
``banded.py``.  Entry points run where the problem lives:
``SparseProblem(device=None)`` means CUDA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch.func import grad, vjp

from .banded import _levenberg, _mixed_route, _scalar, _violation
from .device import resolve_device
from .iterate import max0
from .kernels._build import require_full_fp32
from .ops import pdlp
from .settings import Settings
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
        self.signs = _sign_probes(n, problem.dtype, x.device)  # (3, n)
        self.rsigns = _sign_probes(m, problem.dtype, x.device)  # (3, m)

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
        for s in self.signs:
            est = torch.maximum(est, self.jv(s * d).abs())
        return torch.maximum(est, torch.maximum(sp, torch.maximum(sm, w)))

    def scaled_col_max(self, d_r: Tensor) -> Tensor:
        est = torch.zeros((self.n,), dtype=self.dtype, device=self.device)
        for s in self.rsigns:
            est = torch.maximum(est, self.jtv(s * d_r).abs())
        return torch.cat([est, d_r, d_r, d_r])


def sparse_cauchy(
    problem: SparseProblem,
    x: Tensor,
    trust_radius: Any,
    penalty: Any,
    lp_x: Optional[Tensor] = None,
    lp_y: Optional[Tensor] = None,
    tol: float = 1e-7,
):
    """Reference Cauchy LP, matrix-free (``banded.banded_cauchy`` with the
    problem's products as operator), warm-started from ``lp_x``/``lp_y``.
    Returns (d, act_low, act_up, res)."""
    n, m = problem.n, problem.m
    dtype, dev = problem.dtype, x.device
    trust_radius = torch.as_tensor(trust_radius, dtype=dtype, device=dev)
    penalty = torch.as_tensor(penalty, dtype=dtype, device=dev)
    C = problem.cons(x)
    g = problem.obj_grad(x)
    op = _MatrixFreeCauchyOp(problem, x)

    big = _scalar(1e20, dtype, dev)
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

    res = pdlp.solve(op, c_obj, lb, ub, x0=lp_x, y0=lp_y, tol=tol,
                     max_iterations=problem.cauchy_iters)
    d = res.x[:n]

    # working-set extraction (standard_cauchy.c:843-1005 semantics via the
    # first-order solution: logical column at bound + non-contradicting
    # dual; equalities always active)
    eps = 1e-6
    w = res.x[n + 2 * m :]
    duals = res.duals
    prox = torch.clamp(10.0 * res.primal_res, min=eps)
    at_wlb = (clb > -INF_THRESHOLD) & (w <= w_lb + prox * (1.0 + w_lb.abs()))
    at_wub = (cub < INF_THRESHOLD) & (w >= w_ub - prox * (1.0 + w_ub.abs()))
    is_eq = (cub - clb).abs() <= 1e-12 * (1.0 + clb.abs())
    act_low = is_eq | (at_wlb & (duals >= -eps))
    act_up = (~is_eq) & (at_wub & (duals <= eps)) & ~act_low
    return d, act_low, act_up, res


def sparse_initial_state(problem: SparseProblem, settings: Settings, x0: Any) -> SparseState:
    dtype, dev = problem.dtype, problem.device
    x = problem.clip(torch.as_tensor(x0, dtype=dtype, device=dev))
    m = problem.m
    lp_size = (problem.n + 3 * m, m) if problem.cauchy == "pdlp" else (0, 0)
    zero = _scalar(0.0, dtype, dev)
    izero = _scalar(0, torch.int32, dev)
    return SparseState(
        x=x,
        lam=torch.zeros((m,), dtype=dtype, device=dev),
        act_low=torch.zeros((m,), dtype=torch.bool, device=dev),
        act_up=torch.zeros((m,), dtype=torch.bool, device=dev),
        penalty=_scalar(10.0, dtype, dev),
        reg=_scalar(1e-8, dtype, dev),
        iteration=izero,
        status=_scalar(int(Status.RUNNING), torch.int32, dev),
        num_accepted=izero,
        num_rejected=izero,
        obj_val=problem.obj(x),
        feas_res=zero,
        stat_res=zero,
        last_ratio=zero,
        last_alpha=zero,
        phase=_scalar(int(SolverPhase.OPTIMIZATION), torch.int32, dev),
        bad_steps=izero,
        cg_iterations=izero,
        feas_steps=izero,
        penalty_resets=izero,
        lp_x=torch.zeros((lp_size[0],), dtype=dtype, device=dev),
        lp_y=torch.zeros((lp_size[1],), dtype=dtype, device=dev),
        lp_tr=_scalar(1.0, dtype, dev),
    )


def _cg(matvec, b: Tensor, tol: Any, max_iters: int, dtype, x0: Optional[Tensor] = None):
    """Plain CG with an iteration cap, residual early exit and a stop at
    negative curvature.  Returns (x, iterations).

    The steps run in blocks of ``CG_BLOCK`` without a host read; each step
    is applied only while the exit condition does not hold (``torch.where``),
    so the iterate and the count are those of the reference's
    ``while_loop``.  The host reads the condition once a block."""
    dev = b.device
    tol = torch.as_tensor(tol, dtype=dtype, device=dev)
    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    bnorm2 = (b * b).sum()
    tol2 = (tol * tol) * torch.maximum(bnorm2, _scalar(1e-300, dtype, dev))

    x, r, p, rs = x0, r0, r0, (r0 * r0).sum()
    it = _scalar(0, torch.int32, dev)
    neg = torch.zeros((), dtype=torch.bool, device=dev)

    def running():
        return (rs > tol2) & (it < max_iters) & ~neg

    steps = 0
    while steps < max_iters:
        block = min(CG_BLOCK, max_iters - steps)
        for _ in range(block):
            go = running()
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
        steps += block
        if not bool(running()):
            break
    return x, it


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
    form lam_qp = lam_act + dlam), the banded path's formulation.

    ``mixed=True`` runs the bulk CG iterations through the operator with
    the callables called on float32 tensors and finishes with a float64 CG
    polish warm-started from that solution, so the returned step carries
    float64 accuracy.
    """
    dtype = problem.dtype
    free = (~frozen).to(dtype)
    actf = act.to(dtype)
    inv_delta = _scalar(1.0 / DELTA, dtype, x.device)

    def operator(xc, lamc, freec, actc, regc, invd):
        hv = problem.hessian_product(xc, lamc)
        jv, jtv = problem.jacobian_products(xc)

        def K(v):
            vf = v * freec
            out = hv(vf) + regc * vf
            if problem.m:
                out = out + invd * jtv(jv(vf) * actc)
            return out * freec

        return K, jv, jtv

    K, jv, jtv = operator(x, lam_act, free, actf, reg, inv_delta)
    if mixed:
        f32 = torch.float32
        x32 = x.to(f32)
        problem.check_follows_dtype(x32)
        K32, _, _ = operator(x32, lam_act.to(f32), free.to(f32), actf.to(f32), reg.to(f32),
                       _scalar(1.0 / DELTA, f32, x.device))

    def solve_K(rhs, x0, final: bool):
        """One inner solve: float32 bulk + (on the final AL pass) float64 polish."""
        if not mixed:
            return _cg(K, rhs, cg_tol, problem.cg_iters, dtype, x0=x0)
        d32, it = _cg(K32, rhs.to(torch.float32), _scalar(1e-7, torch.float32, x.device),
                      problem.cg_iters, torch.float32, x0=x0.to(torch.float32))
        d = d32.to(dtype)
        if final:
            d2, it2 = _cg(K, rhs, cg_tol, max(problem.cg_iters // 4, 25), dtype, x0=d)
            return d2, it + it2
        return d, it

    if not problem.m:
        d, it = solve_K(-(g_eff * free), torch.zeros((problem.n,), dtype=dtype, device=x.device),
                        final=True)
        return d * free, torch.zeros((0,), dtype=dtype, device=x.device), it

    # AL multiplier refinement: each pass solves the moderately regularized
    # K and tightens J_W d = target by ~delta
    dlam = torch.zeros((problem.m,), dtype=dtype, device=x.device)
    d = torch.zeros((problem.n,), dtype=dtype, device=x.device)
    it_total = _scalar(0, torch.int32, x.device)
    for k_al in range(AL_ITERS):
        rhs = -(g_eff * free) + jtv((inv_delta * target - dlam) * actf) * free
        d, it = solve_K(rhs, d, final=k_al == AL_ITERS - 1)
        d = d * free
        Jd = jv(d)
        dlam = dlam + (Jd - target) * inv_delta * actf
        it_total = it_total + it
    return d, dlam, it_total


def _armijo(value, base: Tensor, descent: Tensor, settings: Settings, dtype, dev,
            max_steps: int):
    """The reference's backtracking loop: (alpha, accepted), one host read
    a trial; ``value(alpha)`` is the merit (or violation) at alpha."""
    alpha = _scalar(1.0, dtype, dev)
    for _ in range(max_steps):
        if bool(value(alpha) <= base - settings.linesearch_eta * alpha * descent):
            return alpha, True
        alpha = settings.linesearch_tau * alpha
    return _scalar(0.0, dtype, dev), False


def _optimality_iteration(problem: SparseProblem, settings: Settings,
                          state: SparseState) -> SparseState:
    """One matrix-free SQP iteration (problem_solver/iteration.c:350 with
    the subproblem layers replaced by reverse-mode products and CG).  Reads
    the stop flags once, the descent flag once, one flag a linesearch trial,
    a CG block and a PDLP block."""
    dtype, dev = problem.dtype, state.x.device
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
    if problem.cauchy == "pdlp":
        # the reference architecture: the Cauchy LP discovers the working
        # set each iteration (warm-started matrix-free PDLP)
        _, act_low, act_up, lp_res = sparse_cauchy(
            problem, x, state.lp_tr, state.penalty, lp_x=state.lp_x, lp_y=state.lp_y)
        lp_x_next, lp_y_next = lp_res.x, lp_res.duals
    else:
        # eps-active + wrong-sign dual drop (cheap local discovery)
        scale_hi = 1.0 + problem.cons_ub.abs()
        near_lo = (problem.cons_lb > -INF_THRESHOLD) & (C <= problem.cons_lb + tol_act * scale_lo)
        near_up = (problem.cons_ub < INF_THRESHOLD) & (C >= problem.cons_ub - tol_act * scale_hi)
        wrong_lo = state.act_low & ~is_eq & (state.lam > tol_act)
        wrong_up = state.act_up & (state.lam < -tol_act)
        act_low = is_eq | (near_lo & ~wrong_lo) | (state.act_low & ~wrong_lo)
        act_up = (~is_eq) & ((near_up & ~wrong_up) | (state.act_up & ~wrong_up)) & ~act_low
        lp_x_next, lp_y_next = state.lp_x, state.lp_y
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
    optimal_t = (feas_res <= settings.feas_tol) & (stat_res <= settings.stat_tol) & sign_ok
    infeasible_now = feas_res > settings.feas_tol
    deadpoint_t = (state.reg >= REG_MAX) & ~infeasible_now
    optimal, deadpoint = torch.stack([optimal_t, deadpoint_t]).tolist()
    if optimal or deadpoint:
        status = Status.OPTIMAL if optimal else Status.ABORT_DEADPOINT
        return dataclasses.replace(state, status=_scalar(int(status), torch.int32, dev),
                                   feas_res=feas_res, stat_res=stat_res)

    # ---- EQP step via CG ------------------------------------------------
    cg_tol = _scalar(1e-10, dtype, dev)
    d, dlam, cg_it = _kkt_solve_cg(problem, x, lam_act, act, target, r, frozen, state.reg,
                                   cg_tol, mixed=_mixed_route(settings, dtype))
    lam_qp = lam_act + dlam
    step_ok = torch.isfinite(d).all() & torch.isfinite(lam_qp).all()
    d = torch.where(step_ok, d, 0.0)
    lam_qp = torch.where(step_ok, lam_qp, state.lam)

    # ---- penalty above multiplier scale (penalty.c:5-50) ----------------
    lam_norm = max0(lam_qp.abs())
    penalty = torch.where(state.penalty >= 1.5 * lam_norm, state.penalty,
                          torch.maximum(10.0 * state.penalty, 2.0 * lam_norm))
    # global penalty reset after 5 consecutive feasible iterations, at most
    # twice (trial_point/cauchy_step.c:33-95, iteration.c:10-11)
    feas_steps = torch.where(feas_res <= settings.feas_tol, state.feas_steps + 1, 0).to(torch.int32)
    fresh = torch.clamp(1.5 * lam_norm, min=10.0)
    can_reset = (feas_steps >= 5) & (state.penalty_resets < 2) & (penalty > 10.0 * fresh)
    penalty = torch.where(can_reset, fresh, penalty)
    penalty_resets = state.penalty_resets + can_reset.to(torch.int32)
    feas_steps = torch.where(can_reset, 0, feas_steps).to(torch.int32)

    # ---- l1 merit + backtracking linesearch -----------------------------
    gd = (g * d).sum()
    dHd = (d * problem.lag_hess_prod(x, lam_act, d)).sum()
    viol0 = viol.sum()
    merit0 = state.obj_val + penalty * viol0

    def trial_point(alpha):
        return problem.clip(x + alpha * d)

    def trial_merit(alpha):
        xa = trial_point(alpha)
        return problem.obj(xa) + penalty * _violation(problem, problem.cons(xa)).sum()

    descent = penalty * viol0 - gd
    has_descent = bool((descent > 0.0) & step_ok)
    accepted = False
    alpha = _scalar(0.0, dtype, dev)
    if has_descent:
        alpha, accepted = _armijo(trial_merit, merit0, descent, settings, dtype, dev,
                                  MAX_LINESEARCH_STEPS)

    merit_trial = trial_merit(alpha)
    x_new = trial_point(alpha)
    pred = alpha * descent - 0.5 * alpha**2 * dHd
    actual = merit0 - merit_trial
    eps10 = 10.0 * torch.finfo(dtype).eps * (1.0 + merit0.abs())
    tiny = (pred.abs() <= eps10) & (actual.abs() <= eps10)
    ratio = torch.where(tiny, 1.0, actual / torch.where(pred == 0.0, 1.0, pred))

    reg_new = _levenberg(state.reg, ratio, _scalar(accepted, torch.bool, dev), REG_FAIL, REG_MAX)
    x_next = x_new if accepted else x
    lam_next = lam_qp if accepted else state.lam

    bad = infeasible_now & (not accepted)
    bad_steps = torch.where(bad, state.bad_steps + 1, 0).to(torch.int32)
    enter_rest = infeasible_now & ((bad_steps >= RESTORATION_TRIGGER) | (state.reg >= REG_MAX))
    phase_next = torch.where(enter_rest, int(SolverPhase.RESTORATION),
                             int(SolverPhase.OPTIMIZATION)).to(torch.int32)
    reg_next = torch.where(enter_rest, 1e-6, reg_new)
    bad_steps = torch.where(enter_rest, 0, bad_steps).to(torch.int32)

    # l-inf LP radius by step quality (trust_radius.c:5-45 shape)
    if accepted:
        step_norm = max0(d.abs())
        lp_tr = torch.where(ratio >= 0.9, torch.maximum(state.lp_tr, 2.0 * step_norm), state.lp_tr)
    else:
        lp_tr = 0.5 * state.lp_tr
    lp_tr_next = torch.clamp(lp_tr, 1e-10, 1e10)

    return SparseState(
        x=x_next,
        lam=lam_next,
        act_low=act_low,
        act_up=act_up,
        penalty=penalty,
        reg=reg_next,
        iteration=state.iteration + 1,
        status=_scalar(int(Status.RUNNING), torch.int32, dev),
        num_accepted=state.num_accepted + int(accepted),
        num_rejected=state.num_rejected + int(not accepted),
        obj_val=problem.obj(x_next),
        feas_res=feas_res,
        stat_res=stat_res,
        last_ratio=ratio,
        last_alpha=alpha,
        phase=phase_next,
        bad_steps=bad_steps,
        cg_iterations=state.cg_iterations + cg_it,
        feas_steps=feas_steps,
        penalty_resets=penalty_resets,
        lp_x=lp_x_next,
        lp_y=lp_y_next,
        lp_tr=lp_tr_next,
    )


def _restoration_iteration(problem: SparseProblem, settings: Settings,
                           state: SparseState) -> SparseState:
    """Matrix-free Gauss-Newton feasibility restoration (restoration.c
    analogue; identity prox metric, violated rows as working set).  Reads
    the descent flag, one flag a trial and a CG block, and the certificate
    flag."""
    dtype, dev = problem.dtype, state.x.device
    x = state.x
    C = problem.cons(x)
    viol = _violation(problem, C)
    phi0 = viol.sum()

    below = (problem.cons_lb > -INF_THRESHOLD) & (C < problem.cons_lb)
    above = (problem.cons_ub < INF_THRESHOLD) & (C > problem.cons_ub)
    act = below | above
    target = torch.where(below, problem.cons_lb - C,
                         torch.where(above, problem.cons_ub - C, 0.0))
    actf = act.to(dtype)
    inv_delta = _scalar(1.0 / DELTA, dtype, dev)

    jv, jtv = problem.jacobian_products(x)

    def K(v):
        return v * (1.0 + state.reg) + inv_delta * jtv(jv(v) * actf)

    rhs = inv_delta * jtv(target * actf)
    d, cg_it = _cg(K, rhs, _scalar(1e-10, dtype, dev), problem.cg_iters, dtype)
    step_ok = torch.isfinite(d).all()
    d = torch.where(step_ok, d, 0.0)

    Jd = jv(d)
    descent = phi0 - _violation(problem, C + Jd).sum()
    has_descent = bool((descent > 0.0) & step_ok)

    def trial_point(alpha):
        return problem.clip(x + alpha * d)

    def trial(alpha):
        return _violation(problem, problem.cons(trial_point(alpha))).sum()

    accepted = False
    alpha = _scalar(0.0, dtype, dev)
    if has_descent:
        alpha, accepted = _armijo(trial, phi0, descent, settings, dtype, dev,
                                  MAX_LINESEARCH_STEPS)
    x_next = trial_point(alpha) if accepted else x
    if accepted:
        reg_new = torch.clamp(state.reg / 7.0, min=REG_MIN)
    else:
        reg_new = torch.clamp(torch.clamp(10.0 * state.reg, min=REG_FAIL), max=REG_MAX)

    feas_new = max0(_violation(problem, problem.cons(x_next)))
    restored = feas_new <= settings.feas_tol
    if bool((state.reg >= REG_MAX) & ~restored):  # locally infeasible
        return dataclasses.replace(state, status=_scalar(int(Status.INFEASIBLE), torch.int32, dev),
                                   feas_res=feas_new)
    return dataclasses.replace(
        state,
        x=x_next,
        iteration=state.iteration + 1,
        num_accepted=state.num_accepted + int(accepted),
        num_rejected=state.num_rejected + int(not accepted),
        obj_val=problem.obj(x_next),
        feas_res=feas_new,
        phase=torch.where(restored, int(SolverPhase.OPTIMIZATION),
                          int(SolverPhase.RESTORATION)).to(torch.int32),
        penalty=torch.where(restored, state.penalty * 10.0, state.penalty),
        reg=torch.where(restored, 1e-8, reg_new),
        cg_iterations=state.cg_iterations + cg_it,
    )


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


def sparse_solve(
    problem: SparseProblem,
    settings: Optional[Settings] = None,
    x0: Any = None,
    max_iterations: int = 200,
) -> SparseState:
    """Solve a general sparse NLP matrix-free where the problem lives;
    returns the final state.  The loop reads the status and the phase
    together once an iteration; a state still RUNNING after
    ``max_iterations`` ends as ABORT_ITER."""
    settings = settings or Settings()
    dev = problem.device
    if dev.type == "cuda":
        require_full_fp32()
    if x0 is None:
        x0 = torch.zeros((problem.n,), dtype=problem.dtype, device=dev)
    state = sparse_initial_state(problem, settings, x0)
    iteration = 0
    status, phase = int(Status.RUNNING), int(SolverPhase.OPTIMIZATION)
    while status == Status.RUNNING and iteration < max_iterations:
        state = _iterate(problem, settings, state, phase)
        iteration += 1
        status, phase = torch.stack([state.status, state.phase]).tolist()
    if status == Status.RUNNING:
        state = dataclasses.replace(state, status=_scalar(int(Status.ABORT_ITER), torch.int32, dev))
    return state
