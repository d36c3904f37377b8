"""Block-structured (multistage / OCP) problems through the SQP loop.

Port of ``sleqp_tpu/ocp.py``.  A discrete-time optimal control problem

    min  sum_t l_t(x_t, u_t) + l_f(x_T)
    s.t. x_{t+1} = f_t(x_t, u_t),   x_0 fixed,   u_lb <= u_t <= u_ub

has a block-diagonal Lagrangian Hessian (one (nx+nu)^2 block per stage) and
a block-bidiagonal constraint Jacobian, so the dual Schur complement
``S = J H^-1 J^T`` is block-tridiagonal SPD with (nx x nx) blocks.  Each
iteration builds the stage derivatives batched over stages
(``torch.func.vmap``), solves the equality-constrained QP in delta form
through that Schur complement, and globalizes with an l1-merit Armijo
linesearch and a Levenberg update of the Hessian regularization.

Two routes solve the KKT system.  In float64 every stage Hessian gets a
Cholesky factor and S is solved by the block-Thomas recursion.  In the
mixed configuration (``Settings(compute_dtype="float32")`` on a float64
problem) the stage Jacobians/Hessians are float32, their inverses come from
the batched-inverse kernels, and S is solved by cyclic reduction with one
float32 refinement; the state, merit and residuals stay float64.
``tridiag_backend`` (``ocp_solve``) swaps the solve of S for another:
``"pallas"`` puts the float64 route on float32 cyclic reduction with
float64 refinement (``ops/pallas_tridiag.block_tridiag_solve_mp``).

Precision: the float32 products here run in full float32 on the card (TF32
is switched off, ``kernels/_build.require_full_fp32``).  The TPU ran the
KKT einsums as bf16 multiplies at the MXU default, so the port is more
exact there than the reference; the delta-form iteration converges to the
same float64 tolerances either way.

The JAX package's ``jit``/``while_loop`` become eager PyTorch and Python
loops: the solve loop, the linesearch and the forward rollout run on the
host and read a few scalars back from the card each iteration.

Entry points run on the card: ``device=None`` means ``"cuda"``, and without
a CUDA device they raise; pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import grad, jacrev, vjp, vmap

from .kernels._build import require_full_fp32
from .ops.block_tridiag import block_tridiag_solve, cholesky_or_nan, spike_block_tridiag_solve
from .ops.cyclic_reduction import batched_gj_inverse, cr_factor, cr_resolve
from .ops.pallas_tridiag import _spike_chunks, block_tridiag_matvec, block_tridiag_solve_mp
from .device import resolve_device
from .settings import Settings
from .types import DTYPE_MISMATCH, Status

Tensor = torch.Tensor

# Levenberg regularization bounds (the structured analogue of the
# trust-radius interval; factors follow trust_radius.c:47-84).
REG_MIN = 1e-10
REG_MAX = 1e10
REG_FAIL = 1e-4  # floor after a failed (non-SPD) factorization
MAX_LINESEARCH_STEPS = 30

_MIXED_DTYPE_HINT = (
    "with Settings(compute_dtype='float32') the dynamics and cost callables "
    "are called on float32 tensors and must compute in their arguments' "
    "dtype and device (for example A.to(x) @ x); a callable that closes over a "
    "float64 tensor computes in float64 or fails, and the float32 route "
    "never runs it in float64"
)


def _zero_cost(x: Tensor) -> Tensor:
    """The default final cost, 0 (a tensor, so that AD can take it)."""
    return (x * 0.0).sum()


def _max0(t: Tensor) -> Tensor:
    """max(0, max(t)), 0 for an empty t (``jnp.max(t, initial=0.0)``)."""
    if t.numel() == 0:
        return torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.clamp(t.amax(), min=0.0)


class BlockStructuredProblem:
    """Multistage NLP front end (discrete-time optimal control).

    Parameters
    ----------
    dynamics:    (x, u, t) -> x_next, shape (nx,)
    stage_cost:  (x, u, t) -> scalar
    final_cost:  x -> scalar (optional, default 0)
    x0:          fixed initial state, shape (nx,)
    u_lb, u_ub:  optional control bounds (scalar or (nu,))
    x_lb, x_ub:  optional state bounds (scalar or (nx,)), applied to
                 x_1..x_T (x_0 is fixed)
    device:      where the problem's tensors live; ``None`` means CUDA

    The callables take tensors (``t`` a 0-d integer tensor) and must follow
    their arguments' dtype and device, e.g. ``A.to(x) @ x``
    (``sleqp_tpu_torch/types.py``).  ``gauss_newton=True`` builds stage
    Hessians from the costs only, skipping the dynamics curvature.
    """

    def __init__(
        self,
        dynamics: Callable[[Tensor, Tensor, Tensor], Tensor],
        stage_cost: Callable[[Tensor, Tensor, Tensor], Tensor],
        num_stages: int,
        num_states: int,
        num_controls: int,
        x0: Any,
        final_cost: Optional[Callable[[Tensor], Tensor]] = None,
        u_lb: Any = None,
        u_ub: Any = None,
        x_lb: Any = None,
        x_ub: Any = None,
        gauss_newton: bool = False,
        dtype: torch.dtype = torch.float64,
        device: Any = None,
    ):
        self.dynamics = dynamics
        self.stage_cost = stage_cost
        self.final_cost = final_cost if final_cost is not None else _zero_cost
        self.T = int(num_stages)
        self.nx = int(num_states)
        self.nu = int(num_controls)
        self.nz = self.nx + self.nu
        self.dtype = dtype
        self.gauss_newton = bool(gauss_newton)
        self.device = resolve_device(device)

        def as_vector(v, fill, dim):
            if v is None:
                v = fill
            v = torch.as_tensor(v, dtype=dtype, device=self.device)
            return torch.broadcast_to(v, (dim,)).clone()

        self.x0 = torch.as_tensor(x0, dtype=dtype, device=self.device).reshape(self.nx)
        self.u_lb = as_vector(u_lb, -torch.inf, self.nu)
        self.u_ub = as_vector(u_ub, torch.inf, self.nu)
        self.x_lb = as_vector(x_lb, -torch.inf, self.nx)
        self.x_ub = as_vector(x_ub, torch.inf, self.nx)
        self.has_bounds = bool(
            torch.isfinite(self.u_lb).any() | torch.isfinite(self.u_ub).any()
        )
        self.has_state_bounds = bool(
            torch.isfinite(self.x_lb).any() | torch.isfinite(self.x_ub).any()
        )
        self._follows_dtype_checked = False

    def to(self, device: Any) -> "BlockStructuredProblem":
        """The same problem with its tensors on ``device`` (self if they
        are there already)."""
        device = torch.device(device)
        if device == self.device:
            return self
        other = copy.copy(self)
        for name in ("x0", "u_lb", "u_ub", "x_lb", "x_ub"):
            setattr(other, name, getattr(self, name).to(device))
        other.device = device
        return other

    @property
    def num_variables(self) -> int:
        return self.T * (self.nx + self.nu)  # x_1..x_T + u_0..u_{T-1}

    def _ts(self, device) -> Tensor:
        return torch.arange(self.T, device=device)

    # ---- stage evaluations ---------------------------------------------

    def rollout(self, U: Tensor, x0: Optional[Tensor] = None) -> Tensor:
        """Forward simulation: X (T+1, nx) with X[0] = x0 (default the
        problem's initial state)."""
        x = self.x0 if x0 is None else x0
        ts = self._ts(U.device)
        xs = [x]
        for t in range(self.T):
            x = self.dynamics(x, U[t], ts[t])
            xs.append(x)
        return torch.stack(xs)

    def residuals(self, X: Tensor, U: Tensor) -> Tensor:
        """Dynamics defects c_t = f_t(x_t,u_t) - x_{t+1}, shape (T, nx)."""
        f = vmap(self.dynamics)(X[:-1], U, self._ts(X.device))
        return f - X[1:]

    def total_cost(self, X: Tensor, U: Tensor) -> Tensor:
        stage = vmap(self.stage_cost)(X[:-1], U, self._ts(X.device))
        return stage.sum() + self.final_cost(X[-1])

    def merit(self, X: Tensor, U: Tensor, penalty: Tensor) -> Tensor:
        """l1 exact-penalty merit (reference merit.c:60)."""
        c = self.residuals(X, U)
        return self.total_cost(X, U) + penalty * c.abs().sum()

    def linearize(self, X: Tensor, U: Tensor, lam: Tensor, compute_dtype=None):
        """Stage-wise derivatives, batched over t.

        Returns (c (T,nx), g (T+1,nz), G (T,nx,nz), H (T+1,nz,nz)) in the
        uniform padded layout: block t < T is z_t = (x_t, u_t); block T is
        (x_T, u_dummy) with identity Hessian / zero gradient on the dummy
        control part.

        ``compute_dtype=torch.float32`` on a float64 problem assembles the
        second-order objects G and H in float32 (they carry that dtype);
        c and g stay in the problem dtype so feasibility and stationarity
        checks remain exact.  The callables then see float32 tensors, and a
        result that is not float32 raises ``TypeError``.
        """
        nx, nu, nz, T = self.nx, self.nu, self.nz, self.T
        ts = self._ts(X.device)

        def stage_f(z, t):
            return self.dynamics(z[:nx], z[nx:], t)

        def stage_l(z, t):
            return self.stage_cost(z[:nx], z[nx:], t)

        def stage_lag(z, lam_t, t):
            if self.gauss_newton:
                return stage_l(z, t)
            return stage_l(z, t) + lam_t @ stage_f(z, t)

        Z = torch.cat([X[:-1], U], dim=1)  # (T, nz)
        c = vmap(stage_f)(Z, ts) - X[1:]
        g_stage = vmap(grad(stage_l))(Z, ts)
        xT = X[-1]
        gf = grad(self.final_cost)(xT)

        mixed = compute_dtype == torch.float32 and self.dtype == torch.float64
        hdtype = torch.float32 if mixed else self.dtype
        Zc, lamc, xTc = Z.to(hdtype), lam.to(hdtype), xT.to(hdtype)
        if mixed and not self._follows_dtype_checked:
            self._check_follows_dtype(Zc[0], ts[0])
            self._follows_dtype_checked = True
        # reverse mode throughout: PyTorch's forward mode gives the tangent
        # of a 0-d float32 tensor times a Python float in float64
        G = vmap(jacrev(stage_f))(Zc, ts)  # (T, nx, nz)
        H_stage = vmap(jacrev(grad(stage_lag)))(Zc, lamc, ts)
        Hf = jacrev(grad(self.final_cost))(xTc)

        # terminal block, padded to nz with an identity control part
        g_term = torch.cat([gf, torch.zeros(nu, dtype=gf.dtype, device=gf.device)])
        H_term = torch.zeros((nz, nz), dtype=hdtype, device=X.device)
        H_term[:nx, :nx] = Hf
        H_term[nx:, nx:] = torch.eye(nu, dtype=hdtype, device=X.device)

        g = torch.cat([g_stage, g_term[None]], dim=0)
        H = torch.cat([H_stage, H_term[None]], dim=0)
        return c, g, G, H

    def _check_follows_dtype(self, z: Tensor, t: Tensor) -> None:
        """Raise ``TypeError`` unless the callables compute in the dtype of
        their (float32) arguments.  They have just run in the problem dtype,
        so a dtype mismatch here, or a result in another dtype, comes from a
        callable that closes over a tensor of the problem dtype.  Any other
        error of a callable propagates unchanged.  Run once per problem."""
        x, u = z[: self.nx], z[self.nx :]
        try:
            outs = [self.dynamics(x, u, t), self.stage_cost(x, u, t), self.final_cost(x)]
        except RuntimeError as exc:
            if not DTYPE_MISMATCH.search(str(exc)):
                raise
            raise TypeError(_MIXED_DTYPE_HINT) from exc
        if any(torch.as_tensor(o).dtype != z.dtype for o in outs):
            raise TypeError(_MIXED_DTYPE_HINT)

    def constraint_vjp(self, X: Tensor, U: Tensor, lam: Tensor) -> Tensor:
        """G^T lam in the padded (T, nz) layout via one reverse pass per
        stage, exact in the problem dtype whatever dtype G was assembled
        in (the stationarity residual must stay float64-accurate)."""
        nx = self.nx

        def pull(z, lam_t, t):
            _, vjp_fn = vjp(lambda zz: self.dynamics(zz[:nx], zz[nx:], t), z)
            return vjp_fn(lam_t)[0]

        Z = torch.cat([X[:-1], U], dim=1)
        return vmap(pull)(Z, lam, self._ts(X.device))  # (T, nz)


@dataclasses.dataclass(frozen=True)
class OCPState:
    """Solver state for the block-structured SQP loop (0-d tensors for the
    scalars, on the problem's device)."""

    X: Tensor  # (T+1, nx)
    U: Tensor  # (T, nu)
    lam: Tensor  # (T, nx) dynamics multipliers
    penalty: Tensor
    reg: Tensor  # Levenberg regularization (structured trust region)
    iteration: Tensor  # int32
    status: Tensor  # int32 Status
    num_accepted: Tensor
    num_rejected: Tensor
    obj_val: Tensor
    feas_res: Tensor
    stat_res: Tensor
    last_ratio: Tensor
    last_alpha: Tensor


def ocp_initial_state(
    problem: BlockStructuredProblem,
    settings: Settings,
    U0: Optional[Any] = None,
    X0: Optional[Any] = None,
    x0: Optional[Any] = None,
    device: Any = None,
) -> OCPState:
    """Initialize from a control guess (default zeros, clipped to bounds)
    with a dynamics rollout, a feasible multiple-shooting start.  ``x0``
    overrides the problem's initial state.  Runs on ``device`` (``None``
    means CUDA)."""
    problem = problem.to(resolve_device(device))
    T, nx, nu = problem.T, problem.nx, problem.nu
    dtype, dev = problem.dtype, problem.device

    def as_tensor(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    if U0 is None:
        U0 = torch.zeros((T, nu), dtype=dtype, device=dev)
    U0 = torch.clamp(as_tensor(U0).reshape(T, nu), problem.u_lb, problem.u_ub)
    if X0 is None:
        X = problem.rollout(U0, x0=None if x0 is None else as_tensor(x0))
    else:
        X = as_tensor(X0)
    if problem.has_state_bounds:
        # clip the rolled-out trajectory into the state box (x_0 stays
        # fixed); the merit handles the induced dynamics defects
        X = torch.cat([X[:1], torch.clamp(X[1:], problem.x_lb, problem.x_ub)], dim=0)

    def scalar(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=dev)

    return OCPState(
        X=X,
        U=U0,
        lam=torch.zeros((T, nx), dtype=dtype, device=dev),
        penalty=scalar(10.0),
        reg=scalar(1e-6),
        iteration=scalar(0, torch.int32),
        status=scalar(int(Status.RUNNING), torch.int32),
        num_accepted=scalar(0, torch.int32),
        num_rejected=scalar(0, torch.int32),
        obj_val=problem.total_cost(X, U0),
        feas_res=scalar(torch.inf),
        stat_res=scalar(torch.inf),
        last_ratio=scalar(0.0),
        last_alpha=scalar(0.0),
    )


def _structured_kkt_step(problem, c, g, G, H, frozen, reg, mesh=None, tridiag_backend="auto"):
    """Solve the equality-constrained QP via the dual Schur complement.

        min 1/2 d^T H d + g^T d   s.t.  J d = -c,  d[frozen] = 0

    J row t applies G_t to block t and -P (state selector) to block t+1.
    S = J H^-1 J^T is block-tridiagonal SPD.

    Returns (d (T+1, nz), lam (T, nx)) in H's dtype: the solve runs in the
    dtype the quadratic model was assembled in (float32 under the mixed
    configuration; callers cast the step back to the problem dtype).
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded Schur solve (mesh=..., parallel/schur.py) is not "
            "ported yet (ROADMAP.md queue A item 11b)"
        )
    dtype = H.dtype
    free = (~frozen).to(dtype)  # (T+1, nz)
    return _structured_kkt_core(
        problem, c.to(dtype), g.to(dtype), G, H, free, reg.to(dtype), tridiag_backend
    )


def _structured_kkt_core(problem, c, g, G, H, free, reg, tridiag_backend="auto"):
    T, nx, nz = problem.T, problem.nx, problem.nz
    dtype = H.dtype

    # masked, regularized Hessian blocks: identity on frozen coordinates
    Hm = H * free[:, :, None] * free[:, None, :]
    diag_fix = (1.0 - free) + free * reg
    Hm = Hm + torch.diag_embed(diag_fix)
    gm = g * free
    Gm = G * free[:T, None, :]  # zero frozen columns

    # float32 with tridiag_backend "auto" or "cr": one batched inverse of
    # all stage Hessians (the blocked kernel at nz = 64), after which every
    # "solve" is a batched product.  Otherwise a Cholesky factor per stage.
    use_bgj = dtype == torch.float32 and tridiag_backend in ("auto", "cr")
    if use_bgj:
        Hinv = batched_gj_inverse(Hm)

        def solve_with(idx, B):
            return torch.bmm(Hinv[idx], B)

    else:
        chols = cholesky_or_nan(Hm)

        def solve_with(idx, B):
            return torch.cholesky_solve(B, chols[idx])

    hg = solve_with(slice(None), gm[:, :, None])[:, :, 0]  # H^-1 g
    M = solve_with(slice(None, T), Gm.transpose(1, 2))  # H^-1 G^T
    # masked state selector: J row t applies -P_t to block t+1, with the
    # columns of frozen (bound-active) state coordinates zeroed
    free_x = free[1:, :nx]  # (T, nx)
    Pt = torch.zeros((nz, nx), dtype=dtype, device=H.device)
    Pt[:nx, :] = torch.eye(nx, dtype=dtype, device=H.device)
    Pm = Pt[None, :, :] * free_x[:, None, :]  # (T, nz, nx) = P_f^T per stage
    Xx = solve_with(slice(1, None), Pm)  # H_{t+1}^-1 P_f^T

    # S_tt = G_t H_t^-1 G_t^T + P_f H_{t+1}^-1 P_f^T
    S_diag = torch.einsum("tij,tjk->tik", Gm, M) + Xx[:, :nx, :] * free_x[:, :, None]
    # S_{t+1,t} = -G_{t+1} H_{t+1}^-1 P_f^T
    S_sub = -torch.einsum("tij,tjk->tik", Gm[1:], Xx[:-1])
    # rhs = c - J H^-1 g
    rhs = c - (torch.einsum("tij,tj->ti", Gm, hg[:T]) - hg[1:, :nx] * free_x)

    if use_bgj:
        # float32 block cyclic reduction with one float32 self-refinement,
        # which restores backward-stable residuals over the explicit
        # inverses of the levels
        fact = cr_factor(S_diag, S_sub)
        lam = cr_resolve(fact, rhs)
        resid = rhs - block_tridiag_matvec(S_diag, S_sub, lam)
        lam = lam + cr_resolve(fact, resid)
    elif tridiag_backend == "pallas":
        # float32 factorization with refinement in S's dtype: for float64 S
        # cyclic reduction (B1) and two refinements, for float32 the scan
        lam = block_tridiag_solve_mp(S_diag, S_sub, rhs)
    elif tridiag_backend == "spike" and dtype == torch.float32:
        # SPIKE: sequential depth ~sqrt(T) instead of T
        lam = spike_block_tridiag_solve(S_diag, S_sub, rhs, _spike_chunks(T))
    else:
        lam = block_tridiag_solve(S_diag, S_sub, rhs)

    # d = -H^-1 (g + J^T lam)
    jtl = torch.zeros((T + 1, nz), dtype=dtype, device=H.device)
    jtl[:T] += torch.einsum("tij,ti->tj", Gm, lam)
    jtl[1:, :nx] += -lam * free_x
    d = -solve_with(slice(None), (gm + jtl)[:, :, None])[:, :, 0]
    return d, lam


def _bound_active_set(V: Tensor, lb: Tensor, ub: Tensor, r: Tensor, eps: float) -> Tensor:
    """Bound-active variables to freeze, from the reduced gradient at the
    current duals (the structured stand-in for the reference's LP-basis
    working-set extraction, standard_cauchy.c:843).  At the lower bound a
    variable stays frozen while its reduced gradient (= bound multiplier)
    is nonnegative."""
    tol_lb = torch.where(torch.isfinite(lb), eps * (1.0 + lb.abs()), -torch.inf)
    tol_ub = torch.where(torch.isfinite(ub), eps * (1.0 + ub.abs()), -torch.inf)
    at_lb = torch.isfinite(lb) & (V <= lb + tol_lb)
    at_ub = torch.isfinite(ub) & (V >= ub - tol_ub)
    return (at_lb & (r >= 0.0)) | (at_ub & (r <= 0.0))


def _bound_stationarity(V: Tensor, lb: Tensor, ub: Tensor, r: Tensor) -> Tensor:
    """Per-entry stationarity measure under simple bounds: at a lower bound
    the multiplier (= r) must be >= 0, at an upper <= 0; free entries need
    r == 0 (iterate.c:499 sign conventions)."""
    eps_scale = 1e-8
    at_lb = torch.isfinite(lb) & (V <= lb + eps_scale * (1.0 + lb.abs()))
    at_ub = torch.isfinite(ub) & (V >= ub - eps_scale * (1.0 + ub.abs()))
    return torch.where(
        at_lb,
        torch.clamp(-r, min=0.0),
        torch.where(at_ub, torch.clamp(r, min=0.0), r.abs()),
    )


def _stationarity(problem, X, U, g, Jt_lam, lam):
    """KKT stationarity residual + reduced gradients.

    r = g + J^T lam on all true variables; bound-active controls/states
    contribute only their complementarity violation (iterate.c:499).
    ``Jt_lam``: G^T lam per stage, (T, nz), in the problem dtype."""
    T, nx = problem.T, problem.nx
    r = torch.zeros_like(g)
    r[:T] += Jt_lam
    r[1:, :nx] += -lam
    r = r + g
    r_u = r[:T, nx:]  # (T, nu) reduced gradient on controls
    r_x = r[1:, :nx]  # (T, nx) reduced gradient on states x_1..x_T
    stat_u = _bound_stationarity(U, problem.u_lb, problem.u_ub, r_u)
    # x_0 fixed, dummy u_T ignored
    stat_x = _bound_stationarity(X[1:], problem.x_lb, problem.x_ub, r_x)
    stat = torch.maximum(_max0(stat_x), _max0(stat_u))
    return stat, r_u, r_x, r


def ocp_perform_iteration(
    problem: BlockStructuredProblem,
    settings: Settings,
    state: OCPState,
    mesh=None,
    tridiag_backend: str = "auto",
) -> OCPState:
    """One structured SQP iteration (problem_solver/iteration.c:350
    specialized to the block-structured subproblem layers).  Runs where
    ``state`` lives; ``tridiag_backend`` as for ``ocp_solve``."""
    problem = problem.to(state.X.device)
    T, nx, nz = problem.T, problem.nx, problem.nz
    dtype, dev = problem.dtype, problem.device
    X, U = state.X, state.U
    if dev.type == "cuda":
        require_full_fp32()

    # mixed configuration: float32 second-order assembly + KKT solve,
    # float64 state/merit/residuals
    mixed = settings.compute_dtype == "float32" and dtype == torch.float64
    cd = torch.float32 if mixed else None
    c, g, G, H = problem.linearize(X, U, state.lam, compute_dtype=cd)
    feas_res = _max0(c.abs())
    if cd is None:
        # G is already in the problem dtype, so the contraction is exact;
        # the extra reverse pass is only needed when G carries float32
        Jt_lam = torch.einsum("tij,ti->tj", G, state.lam)
    else:
        Jt_lam = problem.constraint_vjp(X, U, state.lam)
    stat_res, r_u, r_x, r_stat = _stationarity(problem, X, U, g, Jt_lam, state.lam)

    optimal = bool((feas_res <= settings.feas_tol) & (stat_res <= settings.stat_tol))
    deadpoint = bool(state.reg >= REG_MAX)
    if optimal or deadpoint:
        status = Status.OPTIMAL if optimal else Status.ABORT_DEADPOINT
        return dataclasses.replace(
            state,
            status=torch.tensor(int(status), dtype=torch.int32, device=dev),
            feas_res=feas_res,
            stat_res=stat_res,
        )

    # ---- active-set freeze + structured KKT step -----------------------
    frozen = torch.zeros((T + 1, nz), dtype=torch.bool, device=dev)
    frozen[0, :nx] = True  # x_0 fixed
    frozen[T, nx:] = True  # dummy terminal control
    if problem.has_bounds:
        frozen[:T, nx:] = _bound_active_set(U, problem.u_lb, problem.u_ub, r_u, settings.eps)
    if problem.has_state_bounds:
        frozen[1:, :nx] = _bound_active_set(
            X[1:], problem.x_lb, problem.x_ub, r_x, settings.eps
        )

    # The QP is solved in delta form around the current multiplier:
    # gradient = the float64 stationarity residual r = g + J^T lam (small
    # near convergence), unknowns (d, dlam), lam_qp = lam + dlam.  The dual
    # rhs then subtracts O(residual) quantities instead of O(1) ones, which
    # lets the float32 solve converge to float64 tolerances.
    d, dlam = _structured_kkt_step(
        problem, c, r_stat, G, H, frozen, state.reg, mesh=mesh, tridiag_backend=tridiag_backend
    )
    d = d.to(dtype)
    lam_qp = state.lam + dlam.to(dtype)
    step_ok = bool(torch.isfinite(d).all() & torch.isfinite(lam_qp).all())
    if not step_ok:
        d = torch.zeros_like(d)
        lam_qp = state.lam

    # ---- penalty kept above the multiplier scale (penalty.c:5-50) ------
    lam_norm = _max0(lam_qp.abs())
    penalty = torch.where(
        state.penalty >= 1.5 * lam_norm,
        state.penalty,
        torch.maximum(10.0 * state.penalty, 2.0 * lam_norm),
    )

    # ---- backtracking linesearch on the l1 merit ------------------------
    dX = d[:, :nx]  # (T+1, nx); dX[0] == 0
    dU = d[:T, nx:]
    gd = (g * d).sum()
    dHd = torch.einsum("ti,tij,tj->", d, H.to(dtype), d)
    viol0 = c.abs().sum()
    merit0 = problem.total_cost(X, U) + penalty * viol0
    # directional derivative of the merit: g.d - penalty * ||c||_1
    descent = penalty * viol0 - gd

    def trial_point(alpha):
        Xa = X + alpha * dX
        if problem.has_state_bounds:
            # clip x_1..x_T into the box; the l1 merit absorbs the
            # resulting dynamics defects (same treatment as controls)
            Xa = torch.cat([Xa[:1], torch.clamp(Xa[1:], problem.x_lb, problem.x_ub)], dim=0)
        Ua = torch.clamp(U + alpha * dU, problem.u_lb, problem.u_ub)
        return Xa, Ua

    has_descent = bool(descent > 0.0) and step_ok
    alpha = 1.0
    accepted = False
    if has_descent:
        for _ in range(MAX_LINESEARCH_STEPS):
            merit_a = problem.merit(*trial_point(alpha), penalty)
            if bool(merit_a <= merit0 - settings.linesearch_eta * alpha * descent):
                accepted = True
                break
            alpha = settings.linesearch_tau * alpha
    if not accepted:
        alpha = 0.0

    X_new, U_new = trial_point(alpha)
    merit_trial = problem.merit(X_new, U_new, penalty)
    # quadratic-model reduction at alpha (merit.c sleqp_merit_quadratic)
    pred = alpha * (penalty * viol0 - gd) - 0.5 * alpha**2 * dHd
    actual = merit0 - merit_trial
    eps10 = 10.0 * torch.finfo(dtype).eps
    tiny = (pred.abs() <= eps10) & (actual.abs() <= eps10)
    ratio = torch.where(tiny, 1.0, actual / torch.where(pred == 0.0, 1.0, pred))

    # ---- Levenberg update with the trust_radius.c:47-84 thresholds -----
    if accepted:
        reg_new = torch.where(
            ratio >= 0.9,
            torch.clamp(state.reg / 7.0, min=REG_MIN),
            torch.where(ratio >= 0.3, torch.clamp(state.reg / 2.0, min=REG_MIN), state.reg),
        )
    else:
        reg_new = torch.clamp(torch.clamp(10.0 * state.reg, min=REG_FAIL), max=REG_MAX)
    X_next, U_next = (X_new, U_new) if accepted else (X, U)

    return OCPState(
        X=X_next,
        U=U_next,
        lam=lam_qp,
        penalty=penalty,
        reg=reg_new,
        iteration=state.iteration + 1,
        status=torch.tensor(int(Status.RUNNING), dtype=torch.int32, device=dev),
        num_accepted=state.num_accepted + int(accepted),
        num_rejected=state.num_rejected + int(not accepted),
        obj_val=problem.total_cost(X_next, U_next),
        feas_res=feas_res,
        stat_res=stat_res,
        last_ratio=ratio,
        last_alpha=torch.tensor(alpha, dtype=dtype, device=dev),
    )


def ocp_solve(
    problem: BlockStructuredProblem,
    settings: Optional[Settings] = None,
    U0: Optional[Any] = None,
    X0: Optional[Any] = None,
    max_iterations: int = 100,
    mesh=None,
    tridiag_backend: str = "auto",
    device: Any = None,
) -> OCPState:
    """Initialize and iterate until OPTIMAL, a dead point or
    ``max_iterations`` (then ABORT_ITER), as ``ocp_solve_jit``'s
    ``while_loop`` does (solve.c:95-252).  Runs on ``device``: ``None``
    means CUDA, which raises when no CUDA device is present.

    ``tridiag_backend`` picks the solve of the dual Schur complement S:
    ``"auto"``/``"cr"`` as above; ``"pallas"`` ``block_tridiag_solve_mp``
    (float32 factorization with refinement in S's dtype: cyclic reduction
    for float64, the scan for float32); ``"spike"`` the SPIKE solve on the
    float32 route; anything else the block-Thomas scan.  Every value other
    than ``"auto"``/``"cr"`` factors the stage Hessians by Cholesky."""
    if settings is None:
        settings = Settings()
    problem = problem.to(resolve_device(device))
    state = ocp_initial_state(problem, settings, U0=U0, X0=X0, device=problem.device)
    while int(state.status) == Status.RUNNING and int(state.iteration) < max_iterations:
        state = ocp_perform_iteration(
            problem, settings, state, mesh=mesh, tridiag_backend=tridiag_backend
        )
    if int(state.status) == Status.RUNNING:
        state = dataclasses.replace(
            state,
            status=torch.tensor(int(Status.ABORT_ITER), dtype=torch.int32, device=problem.device),
        )
    return state
