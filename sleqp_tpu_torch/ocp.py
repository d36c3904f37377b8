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
``mesh=`` (a 1-D ``DeviceMesh``, ``parallel/ranks.py``) solves S across the
ranks of its axis ``mesh_axis`` (``parallel/schur.py``): every rank runs the
whole iteration on the same data, replicated, and only the Schur solve is
split by chunks, so the ranks' host reads agree bit for bit.

Precision: the float32 products here run in full float32 on the card (TF32
is switched off, ``kernels/_build.require_full_fp32``).  The TPU ran the
KKT einsums as bf16 multiplies at the MXU default, so the port is more
exact there than the reference; the delta-form iteration converges to the
same float64 tolerances either way.

The reference's solve is one ``jit``-compiled ``lax.while_loop``
(``ocp_solve_jit``).  Its counterpart here captures one iteration as a CUDA
graph and replays it, reading one flag a replay: the iteration runs under
``lanes.device_resident()``, where the early stop and the linesearch's
branches are per-lane selects and the Armijo loop runs its 30 masked
trials, so nothing inside it reads the card.  On the CPU the same read-free
iteration runs eagerly, with the same one read an iteration.
``ocp_solve_from`` keeps the eager loop that reads as it goes (the loop's
flag, the early stop, the descent flag and one Armijo flag a trial): it is
the oracle of the graph, and the path of ``mesh=``, whose collectives
cannot be captured.  The loops are ``lanes.lockstep`` bodies and the
branches ``lanes.lanes_any`` reads with lane selects, so
``batched_ocp_solve`` runs the same iteration under ``torch.func.vmap``
over a batch of initial states (the reference's ``vmap`` of
``ocp_solve_jit``), with one host read a loop trip or a branch for all
lanes.

Entry points run on the card: ``device=None`` means ``"cuda"``, and without
a CUDA device they raise; pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad, jacrev, vjp, vmap
from torch.nn.functional import pad

from . import graphs
from .kernels._build import require_full_fp32
from .graphs import RUNNING, Programs, cached, state_key
from .lanes import (device_resident, is_batched, is_device_resident, lanes_any, lockstep,
                    tree_map, tree_where, vmap_lanes)
from .ops.block_tridiag import (block_tridiag_solve, cho_solve, cholesky_or_nan, pad_identity,
                                pad_zeros, spike_block_tridiag_solve)
from .ops.cyclic_reduction import batched_gj_inverse, cr_factor, cr_resolve
from .ops.pallas_tridiag import _spike_chunks, block_tridiag_matvec, block_tridiag_solve_mp
from .device import resolve_device
from .parallel.collectives import axis_group
from .parallel.schur import sharded_schur_solve
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
        other.__dict__.pop("_solve_graphs", None)  # graphs are per device
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
        zeros = torch.zeros((nx, nu), dtype=hdtype, device=X.device)
        H_term = torch.cat([torch.cat([Hf, zeros], dim=1),
                            torch.cat([zeros.mT, torch.eye(nu, dtype=hdtype, device=X.device)],
                                      dim=1)], dim=0)

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


def _pad_tridiag(S_diag: Tensor, S_sub: Tensor, rhs: Tensor, num_chunks: int):
    """Pad a block-tridiagonal system with identity blocks so that N + 1 is
    divisible by num_chunks (the sharded layout's requirement); returns the
    padded system and the true N."""
    N, k, _ = S_diag.shape
    c = max(-(-(N + 1) // num_chunks), 2)  # ceil, at least one interior block
    pad = num_chunks * c - 1 - N
    if pad == 0:
        return S_diag, S_sub, rhs, N
    D, L = pad_identity(S_diag, S_sub, pad)
    return D, L, pad_zeros(rhs, pad), N


def _structured_kkt_step(problem, c, g, G, H, frozen, reg, mesh=None, mesh_axis="stages",
                         tridiag_backend="auto"):
    """Solve the equality-constrained QP via the dual Schur complement.

        min 1/2 d^T H d + g^T d   s.t.  J d = -c,  d[frozen] = 0

    J row t applies G_t to block t and -P (state selector) to block t+1.
    S = J H^-1 J^T is block-tridiagonal SPD; it is solved on this rank, or
    across the ranks of ``mesh``'s axis ``mesh_axis`` (``parallel/schur.py``).

    Returns (d (T+1, nz), lam (T, nx)) in H's dtype: the solve runs in the
    dtype the quadratic model was assembled in (float32 under the mixed
    configuration; callers cast the step back to the problem dtype).
    """
    dtype = H.dtype
    free = (~frozen).to(dtype)  # (T+1, nz)
    return _structured_kkt_core(
        problem, c.to(dtype), g.to(dtype), G, H, free, reg.to(dtype), mesh, mesh_axis,
        tridiag_backend,
    )


def _structured_kkt_core(problem, c, g, G, H, free, reg, mesh=None, mesh_axis="stages",
                         tridiag_backend="auto"):
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
            return cho_solve(B, chols[idx])

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

    if mesh is not None:
        _, num_chunks, _ = axis_group(mesh, mesh_axis)
        Sd, Ss, r, n_true = _pad_tridiag(S_diag, S_sub, rhs, num_chunks)
        lam = sharded_schur_solve(
            Sd, Ss, r, mesh, axis_name=mesh_axis, tridiag_backend=tridiag_backend
        )[:n_true]
    elif use_bgj:
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

    # d = -H^-1 (g + J^T lam), J^T lam assembled by padding (no index write
    # into a buffer, which vmap would refuse for a lane's values)
    jtl = pad(torch.einsum("tij,ti->tj", Gm, lam), (0, 0, 0, 1)) + pad(
        -lam * free_x, (0, nz - nx, 1, 0))
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


class _Search(NamedTuple):
    """What an iteration's linesearch and update take from its first part
    (derivatives, stop test, KKT step, penalty)."""

    X: Tensor
    U: Tensor
    dX: Tensor
    dU: Tensor
    lam_qp: Tensor
    penalty: Tensor
    merit0: Tensor
    descent: Tensor
    has_descent: Tensor
    gd: Tensor
    dHd: Tensor
    viol0: Tensor
    feas_res: Tensor
    stat_res: Tensor
    optimal: Tensor
    stop: Tensor


def _stopped(state: OCPState, optimal, feas_res, stat_res) -> OCPState:
    """The state of a solve that stops here: OPTIMAL or a dead point."""
    status = torch.where(optimal, int(Status.OPTIMAL), int(Status.ABORT_DEADPOINT))
    return dataclasses.replace(state, status=status.to(torch.int32), feas_res=feas_res,
                               stat_res=stat_res)


def _search(problem, settings, state, mesh, mesh_axis, tridiag_backend):
    """An iteration up to its linesearch: a ``_Search``, or the stopped
    state when every lane stops (one read; none under device_resident)."""
    T, nx, nu = problem.T, problem.nx, problem.nu
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

    optimal = (feas_res <= settings.feas_tol) & (stat_res <= settings.stat_tol)
    deadpoint = state.reg >= REG_MAX
    stop = optimal | deadpoint
    if not lanes_any(~stop):
        return _stopped(state, optimal, feas_res, stat_res)

    # ---- active-set freeze + structured KKT step -----------------------
    # x_0 fixed, the dummy terminal control frozen; bound-active controls
    # and states x_1..x_T from the reduced gradient
    fixed_x = torch.ones((1, nx), dtype=torch.bool, device=dev)
    fixed_u = torch.ones((1, nu), dtype=torch.bool, device=dev)
    frozen_u = torch.zeros((T, nu), dtype=torch.bool, device=dev)
    frozen_x = torch.zeros((T, nx), dtype=torch.bool, device=dev)
    if problem.has_bounds:
        frozen_u = _bound_active_set(U, problem.u_lb, problem.u_ub, r_u, settings.eps)
    if problem.has_state_bounds:
        frozen_x = _bound_active_set(X[1:], problem.x_lb, problem.x_ub, r_x, settings.eps)
    frozen = torch.cat([torch.cat([fixed_x, frozen_x], dim=0),
                        torch.cat([frozen_u, fixed_u], dim=0)], dim=1)

    # The QP is solved in delta form around the current multiplier:
    # gradient = the float64 stationarity residual r = g + J^T lam (small
    # near convergence), unknowns (d, dlam), lam_qp = lam + dlam.  The dual
    # rhs then subtracts O(residual) quantities instead of O(1) ones, which
    # lets the float32 solve converge to float64 tolerances.
    d, dlam = _structured_kkt_step(
        problem, c, r_stat, G, H, frozen, state.reg, mesh=mesh, mesh_axis=mesh_axis,
        tridiag_backend=tridiag_backend,
    )
    d = d.to(dtype)
    lam_qp = state.lam + dlam.to(dtype)
    step_ok = torch.isfinite(d).all() & torch.isfinite(lam_qp).all()
    d = torch.where(step_ok, d, 0.0)
    lam_qp = torch.where(step_ok, lam_qp, state.lam)

    # ---- penalty kept above the multiplier scale (penalty.c:5-50) ------
    lam_norm = _max0(lam_qp.abs())
    penalty = torch.where(
        state.penalty >= 1.5 * lam_norm,
        state.penalty,
        torch.maximum(10.0 * state.penalty, 2.0 * lam_norm),
    )

    # ---- what the backtracking linesearch on the l1 merit needs ---------
    viol0 = c.abs().sum()
    gd = (g * d).sum()
    # directional derivative of the merit: g.d - penalty * ||c||_1
    descent = penalty * viol0 - gd
    return _Search(
        X=X, U=U, dX=d[:, :nx], dU=d[:T, nx:], lam_qp=lam_qp, penalty=penalty,
        merit0=problem.total_cost(X, U) + penalty * viol0, descent=descent,
        has_descent=(descent > 0.0) & step_ok, gd=gd,
        dHd=torch.einsum("ti,tij,tj->", d, H.to(dtype), d), viol0=viol0, feas_res=feas_res,
        stat_res=stat_res, optimal=optimal, stop=stop,
    )


def _trial_point(problem, s: _Search, alpha):
    Xa = s.X + alpha * s.dX  # dX[0] == 0
    if problem.has_state_bounds:
        # clip x_1..x_T into the box; the l1 merit absorbs the resulting
        # dynamics defects (same treatment as controls)
        Xa = torch.cat([Xa[:1], torch.clamp(Xa[1:], problem.x_lb, problem.x_ub)], dim=0)
    Ua = torch.clamp(s.U + alpha * s.dU, problem.u_lb, problem.u_ub)
    return Xa, Ua


def _armijo_start(s: _Search):
    """(alpha, accepted) before the first Armijo trial."""
    return (torch.ones_like(s.merit0), torch.zeros_like(s.has_descent))


def _armijo(problem, settings, s: _Search, carry, trips: int, first=None):
    """Up to ``trips`` backtracking trials of the Armijo rule from
    ``carry`` (``lockstep``: one read a trial, or ``trips`` masked trials
    under device_resident)."""

    def trial(carry, trip):
        alpha, _ = carry
        merit_a = problem.merit(*_trial_point(problem, s, alpha), s.penalty)
        armijo = merit_a <= s.merit0 - settings.linesearch_eta * alpha * s.descent
        return torch.where(armijo, alpha, settings.linesearch_tau * alpha), armijo

    return lockstep(lambda c: s.has_descent & ~c[1], trial, carry, max_trips=trips, first=first)


def _finish(problem, settings, state: OCPState, s: _Search, carry) -> OCPState:
    """An iteration after its linesearch: the step taken, the reduction
    ratio and the Levenberg update.  A lane that stops (a single lane only
    under device_resident, where the stop was not read) takes its stopped
    state."""
    dtype = problem.dtype
    accepted = carry[1] & s.has_descent
    alpha = torch.where(accepted, carry[0], 0.0)

    X_new, U_new = _trial_point(problem, s, alpha)
    merit_trial = problem.merit(X_new, U_new, s.penalty)
    # quadratic-model reduction at alpha (merit.c sleqp_merit_quadratic)
    pred = alpha * (s.penalty * s.viol0 - s.gd) - 0.5 * alpha**2 * s.dHd
    actual = s.merit0 - merit_trial
    eps10 = 10.0 * torch.finfo(dtype).eps
    tiny = (pred.abs() <= eps10) & (actual.abs() <= eps10)
    ratio = torch.where(tiny, 1.0, actual / torch.where(pred == 0.0, 1.0, pred))

    # ---- Levenberg update with the trust_radius.c:47-84 thresholds -----
    reg_accept = torch.where(
        ratio >= 0.9,
        torch.clamp(state.reg / 7.0, min=REG_MIN),
        torch.where(ratio >= 0.3, torch.clamp(state.reg / 2.0, min=REG_MIN), state.reg),
    )
    reg_reject = torch.clamp(torch.clamp(10.0 * state.reg, min=REG_FAIL), max=REG_MAX)
    X_next = torch.where(accepted, X_new, s.X)
    U_next = torch.where(accepted, U_new, s.U)

    out = OCPState(
        X=X_next,
        U=U_next,
        lam=s.lam_qp,
        penalty=s.penalty,
        reg=torch.where(accepted, reg_accept, reg_reject),
        iteration=state.iteration + 1,
        status=torch.full((), int(Status.RUNNING), dtype=torch.int32, device=problem.device),
        num_accepted=state.num_accepted + accepted.to(torch.int32),
        num_rejected=state.num_rejected + (~accepted).to(torch.int32),
        obj_val=problem.total_cost(X_next, U_next),
        feas_res=s.feas_res,
        stat_res=s.stat_res,
        last_ratio=ratio,
        last_alpha=alpha,
    )
    if not (is_batched(s.stop) or is_device_resident()):
        return out  # a single lane that read its stop flag runs on
    # lanes that stop go on with the others and take their stopped state
    return tree_where(s.stop, _stopped(state, s.optimal, s.feas_res, s.stat_res), out)


def ocp_perform_iteration(
    problem: BlockStructuredProblem,
    settings: Settings,
    state: OCPState,
    mesh=None,
    mesh_axis: str = "stages",
    tridiag_backend: str = "auto",
) -> OCPState:
    """One structured SQP iteration (problem_solver/iteration.c:350
    specialized to the block-structured subproblem layers).  Runs where
    ``state`` lives; ``mesh``, ``mesh_axis`` and ``tridiag_backend`` as for
    ``ocp_solve``.  Under ``vmap`` (``batched_ocp_solve``) a lane that
    stops takes its stopped state while the others step."""
    problem = problem.to(state.X.device)
    s = _search(problem, settings, state, mesh, mesh_axis, tridiag_backend)
    if isinstance(s, OCPState):
        return s
    carry = _armijo_start(s)
    if lanes_any(s.has_descent):
        carry = _armijo(problem, settings, s, carry, MAX_LINESEARCH_STEPS, first=s.has_descent)
    return _finish(problem, settings, state, s, carry)


def ocp_solve_from(
    problem: BlockStructuredProblem,
    settings: Settings,
    state: OCPState,
    max_iterations: int = 100,
    mesh=None,
    mesh_axis: str = "stages",
    tridiag_backend: str = "auto",
) -> OCPState:
    """Iterate from ``state`` until OPTIMAL, a dead point or
    ``max_iterations`` (then ABORT_ITER), eagerly, reading as it goes: the
    loop's flag a trip, and the early stop, the descent flag and each
    Armijo trial's flag inside an iteration.  It is the oracle of
    ``ocp_solve_jit`` (the same iteration, the same bits) and the loop of
    ``mesh=``.  Under ``vmap`` the lanes iterate in lockstep until every one
    has stopped."""

    def running(s):
        return (s.status == int(Status.RUNNING)) & (s.iteration < max_iterations)

    def step(s, trip):
        return ocp_perform_iteration(problem, settings, s, mesh=mesh, mesh_axis=mesh_axis,
                                     tridiag_backend=tridiag_backend)

    state = lockstep(running, step, state)
    status = torch.where(state.status == int(Status.RUNNING), int(Status.ABORT_ITER), state.status)
    return dataclasses.replace(state, status=status.to(torch.int32))


# ---- the solve as one device program (ocp_solve_jit) ---------------------


def _running(state: OCPState, max_iterations: Tensor) -> Tensor:
    return (state.status == int(Status.RUNNING)) & (state.iteration < max_iterations)


# The Armijo trials of ocp_solve_jit's iteration: the first few inside the
# iteration's graph, the rest, while a lane still searches, in blocks of
# masked trials, one read a block.  Together at most MAX_LINESEARCH_STEPS.
GRAPH_TRIALS = 4
TRIAL_BLOCK = 13
_BLOCKS, _LEFT = divmod(MAX_LINESEARCH_STEPS - GRAPH_TRIALS, TRIAL_BLOCK)
assert _LEFT == 0, "the trial blocks must end at the linesearch's cap"


def _programs(problem, settings, tridiag_backend, batched):
    """The three read-free bodies of ``ocp_solve_jit``'s loop, on a dict of
    buffers (``state``, ``max_it``; ``search``, ``carry`` and ``run`` of an
    iteration whose linesearch goes on; ``flag``): each returns the buffers
    it writes.  ``iterate``: one iteration with its first GRAPH_TRIALS
    Armijo trials, for every lane that runs; flag bit 0: a lane still runs,
    bit 1: a lane that does not stop here still searches, and then the
    state is left as it was and the iteration is finished by ``search``
    (TRIAL_BLOCK more trials; bit 1 as before) and ``finish`` (bit 0 as
    before).  With ``batched`` the buffers have a lane dimension first and
    the bodies run under vmap."""

    def lanes(fn, *trees):
        return vmap_lanes(fn, *trees) if batched else fn(*trees)

    def start(state):
        with device_resident():
            s = _search(problem, settings, state, None, "stages", tridiag_backend)
            return s, _armijo(problem, settings, s, _armijo_start(s), GRAPH_TRIALS,
                              first=s.has_descent)

    def finish_lane(state, s, carry, run):
        with device_resident():
            out = _finish(problem, settings, state, s, carry)
        return tree_where(run, out, state)

    def flags(running=None, searching=None):
        bits = [f.any().to(torch.int32) * w for f, w in ((running, 1), (searching, 2))
                if f is not None]
        return bits[0] if len(bits) == 1 else bits[0] + bits[1]

    def iterate(b):
        state, max_it = b["state"], b["max_it"]
        run = _running(state, max_it)
        s, carry = lanes(start, state)
        out = lanes(finish_lane, state, s, carry, run)
        searching = run & ~s.stop & s.has_descent & ~carry[1]
        # an iteration whose linesearch goes on keeps every lane's state
        out = tree_where(searching.any(), state, out)
        return dict(state=out, search=s, carry=carry, run=run,
                    flag=flags(_running(out, max_it), searching))

    def search(b):
        s, run = b["search"], b["run"]
        with device_resident():
            carry = lanes(lambda s, c: _armijo(problem, settings, s, c, TRIAL_BLOCK), s,
                          b["carry"])
        return dict(carry=carry, flag=flags(searching=run & ~s.stop & s.has_descent & ~carry[1]))

    def finish(b):
        out = lanes(finish_lane, b["state"], b["search"], b["carry"], b["run"])
        return dict(state=out, flag=flags(running=_running(out, b["max_it"])))

    return iterate, search, finish


class IterationGraph(Programs):
    """``ocp_solve_jit``'s loop on one device: the three read-free programs
    of ``_programs`` (``graphs.Programs``), replayed as CUDA graphs on the
    card and run eagerly on the CPU, reading the 0-d ``flag`` buffer once
    after each.  An iteration is one ``iterate`` and one read, unless a
    lane's linesearch outlasts GRAPH_TRIALS trials: then ``search`` (a read
    a block of TRIAL_BLOCK trials) and ``finish`` (a read) end it.  The
    three are warmed up and captured when it is made."""

    def __init__(self, problem, settings, tridiag_backend, batched, state0, max_iterations):
        dev = state0.X.device
        names = ("iterate", "search", "finish")
        bodies = dict(zip(names, _programs(problem, settings, tridiag_backend, batched)))
        bufs = dict(state=tree_map(torch.clone, state0),
                    max_it=torch.full((), max_iterations, dtype=torch.int32, device=dev))
        super().__init__(bodies, bufs, graphs.on_graphs(dev), graphs.captured, graphs.LAUNCHES)
        self.prepare(*names)

    def run(self, state0: Any, max_iterations: int) -> Any:
        """Iterate from ``state0`` while a lane runs; returns the final
        state (a copy of the buffers on CUDA)."""
        self.load(state0, max_iterations)
        while self.step("iterate", "search", "finish", _BLOCKS) & RUNNING:
            pass
        return self.result()


def iteration_graph(problem: BlockStructuredProblem, settings: Settings, state0: Any,
                    max_iterations: int = 100, tridiag_backend: str = "auto",
                    batched: bool = False) -> IterationGraph:
    """The ``IterationGraph`` of ``ocp_solve_jit`` for this problem,
    settings, backend and the shapes, dtypes and device of ``state0`` (with
    ``batched`` a lane dimension first), made (on CUDA captured from
    ``state0``) at the first call and cached on the problem."""
    problem = problem.to(state0.X.device)
    return cached(problem, (settings, tridiag_backend, batched, *state_key(state0)),
                  lambda: IterationGraph(problem, settings, tridiag_backend, batched, state0,
                                         max_iterations))


def _solve_loop(problem, settings, state0, max_iterations, tridiag_backend, batched):
    """``ocp_solve_jit``'s loop, then the reference's ABORT_ITER rule."""
    state = iteration_graph(problem, settings, state0, max_iterations, tridiag_backend,
                            batched).run(state0, max_iterations)
    status = torch.where(state.status == int(Status.RUNNING), int(Status.ABORT_ITER), state.status)
    return dataclasses.replace(state, status=status.to(torch.int32))


def ocp_solve_jit(
    problem: BlockStructuredProblem,
    settings: Settings,
    state0: OCPState,
    max_iterations: int,
    mesh=None,
    mesh_axis: str = "stages",
    tridiag_backend: str = "auto",
) -> OCPState:
    """The whole solve from ``state0`` as one device program
    (``sleqp_tpu/ocp.py::ocp_solve_jit``, solve.c:95-252): on CUDA a CUDA
    graph of one read-free iteration (``IterationGraph``, cached on the
    problem: a second solve of the same problem, settings, backend and
    shapes replays without a new capture), replayed while the flag it
    leaves, read once a replay, says the solve runs; on the CPU the same
    iteration eagerly, with the same one read an iteration.  The result is
    ``ocp_solve_from``'s, bit for bit.  A capture that fails raises.

    ``mesh`` raises: the collectives of ``parallel/collectives.py`` stage
    through host memory and cannot be captured (``ocp_solve(mesh=)`` runs
    ``ocp_solve_from``).  ``mesh_axis`` is kept for the reference's
    signature."""
    if mesh is not None:
        raise ValueError("ocp_solve_jit: mesh= is not capturable (the collectives stage "
                         "through host memory); ocp_solve(mesh=) runs ocp_solve_from")
    return _solve_loop(problem, settings, state0, max_iterations, tridiag_backend, False)


def ocp_solve(
    problem: BlockStructuredProblem,
    settings: Optional[Settings] = None,
    U0: Optional[Any] = None,
    X0: Optional[Any] = None,
    max_iterations: int = 100,
    mesh=None,
    mesh_axis: str = "stages",
    tridiag_backend: str = "auto",
    device: Any = None,
) -> OCPState:
    """Initialize (``ocp_initial_state``) and iterate: ``ocp_solve_jit``
    without ``mesh``, as the reference does, and ``ocp_solve_from`` with
    it.  Runs on ``device``: ``None`` means CUDA, which raises when no CUDA
    device is present.

    ``tridiag_backend`` picks the solve of the dual Schur complement S:
    ``"auto"``/``"cr"`` as above; ``"pallas"`` ``block_tridiag_solve_mp``
    (float32 factorization with refinement in S's dtype: cyclic reduction
    for float64, the scan for float32); ``"spike"`` the SPIKE solve on the
    float32 route; anything else the block-Thomas scan.  Every value other
    than ``"auto"``/``"cr"`` factors the stage Hessians by Cholesky.

    ``mesh`` (a 1-D ``DeviceMesh``) solves S across the ranks of its axis
    ``mesh_axis`` by ``parallel/schur.sharded_schur_solve`` instead, S
    padded with identity blocks to the chunk layout; ``tridiag_backend=
    "pallas"`` then eliminates each rank's interior by
    ``block_tridiag_solve_mp``, any other value by the block-Thomas
    recursion, and the float32 route still inverts the stage Hessians by
    the batched kernels.  Every rank of the axis calls ``ocp_solve`` with
    the same arguments and returns the same state."""
    if settings is None:
        settings = Settings()
    problem = problem.to(resolve_device(device))
    state = ocp_initial_state(problem, settings, U0=U0, X0=X0, device=problem.device)
    if mesh is None:
        return ocp_solve_jit(problem, settings, state, max_iterations,
                             tridiag_backend=tridiag_backend)
    return ocp_solve_from(problem, settings, state, max_iterations, mesh, mesh_axis,
                          tridiag_backend)


def batched_ocp_solve(
    problem: BlockStructuredProblem,
    settings: Settings,
    x0_batch: Any,
    max_iterations: int = 100,
    tridiag_backend: str = "auto",
    device: Any = None,
) -> OCPState:
    """Scenario batch (BASELINE config 5 on the block-structured path): B
    independent solves from the rows of ``x0_batch`` (B, nx), each from the
    rollout of zero controls from its initial state, as ``ocp_solve``
    from ``ocp_initial_state(x0=...)``.  Returns an ``OCPState`` with the
    lane dimension first in every tensor.

    The single-lane iteration runs under ``torch.func.vmap`` inside
    ``ocp_solve_jit``'s loop (a CUDA graph of the vmapped iteration on the
    card): all lanes advance together, a stopped lane frozen while the
    others go on, with one host read a trip for all lanes.  The batched
    inverses of the float32 route take every lane's blocks in one launch
    (``ops/cyclic_reduction.py``).  ``device=None`` means CUDA."""
    problem = problem.to(resolve_device(device))
    x0 = torch.as_tensor(x0_batch, dtype=problem.dtype, device=problem.device)
    if x0.ndim != 2 or x0.shape[1] != problem.nx:
        raise ValueError(f"x0_batch must be (B, {problem.nx}), got {tuple(x0.shape)}")
    states0 = vmap_lanes(
        lambda x: ocp_initial_state(problem, settings, x0=x, device=problem.device), x0)
    return _solve_loop(problem, settings, states0, max_iterations, tridiag_backend, True)
