"""Problem and function model.

Port of ``sleqp_tpu/problem.py``:

* ``Func`` wraps user callables ``obj(x)`` and ``cons(x)``.  Derivatives
  default to ``torch.func`` AD: the gradient by ``grad``, the constraint
  Jacobian by ``jacrev`` (reverse mode for every m: PyTorch's forward mode
  gives the tangent of a 0-d float32 tensor times a Python float in
  float64), and the Hessian-of-the-Lagrangian product by reverse over
  reverse (the ``vjp`` of the Lagrangian gradient; the reference runs
  forward over reverse).  Each may be overridden as in the reference.
* ``LSQFunc`` is a ``Func`` of residuals, 0.5 ||r(x)||^2, with the
  Gauss-Newton Hessian product.
* ``Problem`` combines a ``Func`` with variable bounds, general constraint
  bounds and separately stored linear constraints appended after the
  general ones (reference: problem.c:28-49,199-213), as dense tensors on
  one device.

The callables receive tensors and must follow their arguments' dtype and
device (``sleqp_tpu_torch/types.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import grad, jacrev, vjp

from .device import resolve_device
from .types import DTYPE_MISMATCH

Tensor = torch.Tensor

_MIXED_DTYPE_HINT = (
    "with Settings(compute_dtype='float32') the Hessian product is evaluated "
    "at a float32 iterate, so obj, cons and their derivative overrides must "
    "compute in their arguments' dtype and device (for example A.to(x) @ x); "
    "a callable that closes over a float64 tensor computes in float64 or "
    "fails, and the float32 route never runs it in float64"
)


def _as_tensor(v: Any, like: Tensor) -> Tensor:
    if isinstance(v, Tensor):
        return v
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _as_1d(x: Any, dim: int, dtype, device, name: str, fill: float) -> Tensor:
    if x is None:
        return torch.full((dim,), fill, dtype=dtype, device=device)
    arr = torch.as_tensor(x, dtype=dtype, device=device)
    if arr.ndim == 0:
        arr = torch.full((dim,), float(arr), dtype=dtype, device=device)
    if tuple(arr.shape) != (dim,):
        raise ValueError(f"{name}: expected shape ({dim},), got {tuple(arr.shape)}")
    return arr.clone()


class Func:
    """NLP function model: objective + general constraints with AD defaults.

    * ``obj``:   x -> scalar objective
    * ``cons``:  x -> (num_cons,) general constraint values (or None)
    * ``obj_grad``:  optional override, x -> (n,)
    * ``cons_jac``:  optional override, x -> (num_cons, n) dense Jacobian
    * ``hess_prod``: optional override, (x, direction, cons_dual) -> (n,),
      the product of the Hessian of the Lagrangian f + mu.c with
      ``direction`` (pub_func.h:75-87)
    * ``psd_hessian``: declares the Hessian positive semidefinite, which
      selects the CG trust-region solver under ``TRSolver.AUTO``
    * ``hess_struct``: optional sorted, disjoint (start, end) blocks of a
      block-diagonal Lagrangian Hessian (pub_hess_struct.h:8-40)
    * ``accept_point``: optional x -> bool predicate; False rejects a
      trial point (the step is discarded and the trust radius shrinks).
      Non-finite objective or constraint values are rejected always.

    ``runs_on_host`` says that the callables call host code (numpy, as
    ``minimize``'s host path does): no CUDA graph can call them, so
    ``Solver`` steps its eager loop (the reference calls them through
    ``jax.pure_callback`` inside its compiled loop).
    """

    runs_on_host = False

    def __init__(
        self,
        obj: Callable[[Tensor], Tensor],
        num_variables: int,
        cons: Optional[Callable[[Tensor], Tensor]] = None,
        num_cons: int = 0,
        obj_grad: Optional[Callable[[Tensor], Tensor]] = None,
        cons_jac: Optional[Callable[[Tensor], Tensor]] = None,
        hess_prod: Optional[Callable[[Tensor, Tensor, Tensor], Tensor]] = None,
        psd_hessian: bool = False,
        hess_struct: Optional[tuple] = None,
        accept_point: Optional[Callable[[Tensor], Any]] = None,
    ):
        self.num_variables = int(num_variables)
        self.num_cons = int(num_cons)
        if hess_struct is not None:
            blocks = tuple((int(s), int(e)) for s, e in hess_struct)
            prev = 0
            for s, e in blocks:
                if not (prev <= s < e <= num_variables):
                    raise ValueError(
                        f"invalid hess_struct block ({s}, {e}); blocks must "
                        "be sorted, disjoint, and within the variable range"
                    )
                prev = e
            self.hess_struct = blocks
        else:
            self.hess_struct = None
        self._obj = obj
        self._cons = cons
        if cons is None and num_cons > 0:
            raise ValueError("num_cons > 0 requires a cons callable")
        self._obj_grad = obj_grad if obj_grad is not None else grad(obj)
        if cons_jac is not None:
            self._cons_jac = cons_jac
        elif cons is not None:
            self._cons_jac = jacrev(cons)
        else:
            self._cons_jac = None
        self._hess_prod = hess_prod
        self._accept_point = accept_point
        self.psd_hessian = bool(psd_hessian)

    def point_valid(self, x: Tensor) -> Tensor:
        """The user's acceptance predicate as a 0-d bool tensor (True when
        none is installed)."""
        if self._accept_point is None:
            return torch.ones((), dtype=torch.bool, device=x.device)
        v = self._accept_point(x)
        return torch.as_tensor(v, device=x.device).reshape(()).to(torch.bool)

    def obj_val(self, x: Tensor) -> Tensor:
        return _as_tensor(self._obj(x), x)

    def obj_grad(self, x: Tensor) -> Tensor:
        return _as_tensor(self._obj_grad(x), x)

    def cons_val(self, x: Tensor) -> Tensor:
        if self._cons is None:
            return torch.zeros((0,), dtype=x.dtype, device=x.device)
        return _as_tensor(self._cons(x), x).reshape(self.num_cons)

    def cons_jac(self, x: Tensor) -> Tensor:
        if self._cons_jac is None:
            return torch.zeros((0, self.num_variables), dtype=x.dtype, device=x.device)
        return _as_tensor(self._cons_jac(x), x).reshape(self.num_cons, self.num_variables)

    def hess_prod(self, x: Tensor, direction: Tensor, cons_dual: Tensor) -> Tensor:
        """(∇²f + Σ μ_i ∇²c_i) @ direction.  Default: the vjp of the
        Lagrangian gradient (reverse over reverse; the Hessian is
        symmetric), no Hessian materialized."""
        if self._hess_prod is not None:
            return _as_tensor(self._hess_prod(x, direction, cons_dual), x)
        m = self.num_cons

        def lag_grad(z: Tensor) -> Tensor:
            g = self._obj_grad(z)
            if self._cons is not None and m > 0:
                _, pull = vjp(lambda y: self._cons(y).reshape(m), z)
                g = g + pull(cons_dual)[0]
            return g

        _, pull = vjp(lag_grad, x)
        return pull(direction)[0]


def linearize(fn: Callable[[Tensor], Tensor], x: Tensor):
    """(fn(x), the Jacobian-vector product d -> J d, the vector-Jacobian
    product u -> J^T u) of ``fn`` at ``x``, both by reverse mode: J d is
    the vjp of the linear map u -> J^T u (the reference uses ``jax.jvp``;
    forward mode in torch gives the tangent of a 0-d float32 tensor times a
    Python float in float64)."""
    value, pull = vjp(fn, x)

    def vjp_fn(u: Tensor) -> Tensor:
        return pull(u)[0]

    _, pull_t = vjp(vjp_fn, torch.zeros_like(value))

    def jvp_fn(d: Tensor) -> Tensor:
        return pull_t(d)[0]

    return value, jvp_fn, vjp_fn


class LSQFunc(Func):
    """Least-squares function model (reference ``LSQFunc``, src/main/lsq.c).

    Wraps a residual callable into a ``Func`` whose objective is
    ``0.5 ||r(x)||^2`` and whose Hessian product is the Gauss-Newton
    approximation ``J_r^T J_r d (+ lm_factor d)`` (lsq.c:21,238-244); the
    constraint part behaves as in ``Func``.  ``residuals`` follows its
    argument's dtype and device, as every callable does.
    """

    def __init__(
        self,
        residuals: Callable[[Tensor], Tensor],
        num_variables: int,
        num_residuals: int,
        cons: Optional[Callable[[Tensor], Tensor]] = None,
        num_cons: int = 0,
        lm_factor: float = 0.0,
    ):
        self.residuals = residuals
        self.num_residuals = int(num_residuals)
        self.lm_factor = float(lm_factor)

        def obj(x: Tensor) -> Tensor:
            r = residuals(x)
            return 0.5 * torch.dot(r, r)

        def hess_prod(x: Tensor, direction: Tensor, cons_dual: Tensor) -> Tensor:
            # Gauss-Newton: J_r^T (J_r d); the constraints' curvature is
            # left out (lsq.c:238-244)
            _, jvp_fn, vjp_fn = linearize(residuals, x)
            out = vjp_fn(jvp_fn(direction))
            if self.lm_factor != 0.0:
                out = out + self.lm_factor * direction
            return out

        super().__init__(obj=obj, num_variables=num_variables, cons=cons, num_cons=num_cons,
                         hess_prod=hess_prod, psd_hessian=True)


@dataclasses.dataclass(frozen=True)
class ProblemData:
    """The numeric part of a Problem (bounds + linear rows)."""

    var_lb: Tensor
    var_ub: Tensor
    cons_lb: Tensor  # combined: general then linear (problem.c:199-213)
    cons_ub: Tensor
    linear_coeffs: Tensor  # (num_linear, n); empty if no linear constraints


class Problem:
    """NLP problem: min f(x) s.t. cons_lb <= c(x) <= cons_ub,
    var_lb <= x <= var_ub, with linear constraints appended after the
    general ones (problem.c:274-301).  ``device=None`` means CUDA."""

    def __init__(
        self,
        func: Func,
        var_lb: Any = None,
        var_ub: Any = None,
        general_lb: Any = None,
        general_ub: Any = None,
        linear_coeffs: Any = None,
        linear_lb: Any = None,
        linear_ub: Any = None,
        dtype: torch.dtype = torch.float64,
        device: Any = None,
    ):
        self.func = func
        self.dtype = dtype
        self.device = resolve_device(device)
        dev = self.device
        n = func.num_variables
        mg = func.num_cons
        self.num_variables = n
        self.num_general = mg

        var_lb = _as_1d(var_lb, n, dtype, dev, "var_lb", -torch.inf)
        var_ub = _as_1d(var_ub, n, dtype, dev, "var_ub", torch.inf)
        general_lb = _as_1d(general_lb, mg, dtype, dev, "general_lb", -torch.inf)
        general_ub = _as_1d(general_ub, mg, dtype, dev, "general_ub", torch.inf)

        if linear_coeffs is not None:
            lin = torch.as_tensor(linear_coeffs, dtype=dtype, device=dev).clone()
            if lin.ndim != 2 or lin.shape[1] != n:
                raise ValueError(f"linear_coeffs must be (num_linear, {n})")
            ml = lin.shape[0]
        else:
            lin = torch.zeros((0, n), dtype=dtype, device=dev)
            ml = 0
        self.num_linear = ml
        linear_lb = _as_1d(linear_lb, ml, dtype, dev, "linear_lb", -torch.inf)
        linear_ub = _as_1d(linear_ub, ml, dtype, dev, "linear_ub", torch.inf)

        self.num_cons = mg + ml
        self.data = ProblemData(
            var_lb=var_lb,
            var_ub=var_ub,
            cons_lb=torch.cat([general_lb, linear_lb]),
            cons_ub=torch.cat([general_ub, linear_ub]),
            linear_coeffs=lin,
        )
        self._follows_dtype_checked = False

    # -- combined evaluations (reference: problem.c sleqp_problem_eval) -----

    def obj_val(self, x: Tensor) -> Tensor:
        return self.func.obj_val(x)

    def obj_grad(self, x: Tensor) -> Tensor:
        return self.func.obj_grad(x)

    def cons_val(self, x: Tensor) -> Tensor:
        """General constraint values with linear rows appended."""
        parts = []
        if self.num_general:
            parts.append(self.func.cons_val(x))
        if self.num_linear:
            parts.append(self.data.linear_coeffs.to(x.dtype) @ x)
        if not parts:
            return torch.zeros((0,), dtype=x.dtype, device=x.device)
        return torch.cat(parts)

    def cons_jac(self, x: Tensor) -> Tensor:
        parts = []
        if self.num_general:
            parts.append(self.func.cons_jac(x))
        if self.num_linear:
            parts.append(self.data.linear_coeffs)
        if not parts:
            return torch.zeros((0, self.num_variables), dtype=x.dtype, device=x.device)
        return torch.cat(parts, dim=0)

    def hess_prod(self, x: Tensor, direction: Tensor, cons_dual: Tensor) -> Tensor:
        """Lagrangian Hessian product; linear rows contribute nothing."""
        return self.func.hess_prod(x, direction, cons_dual[: self.num_general])

    def eval_all(self, x: Tensor):
        """One-shot (f, grad, c, J) evaluation (reference: util.c:13)."""
        return self.obj_val(x), self.obj_grad(x), self.cons_val(x), self.cons_jac(x)

    def clip_to_bounds(self, x: Tensor) -> Tensor:
        """Clip a point into the variable box (solver/solve.c:57-93)."""
        return torch.minimum(torch.maximum(x, self.data.var_lb), self.data.var_ub)

    def check_follows_dtype(self, x: Tensor) -> None:
        """Raise ``TypeError`` unless the callables compute in the dtype of
        ``x`` (float32 on the mixed route).  A dtype mismatch inside a
        callable, or a result in another dtype, comes from a callable that
        closes over a tensor of the problem dtype; any other error
        propagates unchanged.  Run once per problem."""
        if self._follows_dtype_checked:
            return
        d = torch.zeros_like(x)
        mult = torch.zeros((self.num_cons,), dtype=x.dtype, device=x.device)
        try:
            outs = [self.func.obj_val(x), self.func.cons_val(x), self.hess_prod(x, d, mult)]
        except RuntimeError as exc:
            if not DTYPE_MISMATCH.search(str(exc)):
                raise
            raise TypeError(_MIXED_DTYPE_HINT) from exc
        if any(o.dtype != x.dtype for o in outs):
            raise TypeError(_MIXED_DTYPE_HINT)
        self._follows_dtype_checked = True

    def _rebuilt(self, dtype, device) -> "Problem":
        d = self.data
        g = self.num_general
        lin = self.num_linear > 0
        return Problem(
            self.func,
            var_lb=d.var_lb.to(device, dtype),
            var_ub=d.var_ub.to(device, dtype),
            general_lb=d.cons_lb[:g].to(device, dtype),
            general_ub=d.cons_ub[:g].to(device, dtype),
            linear_coeffs=d.linear_coeffs.to(device, dtype) if lin else None,
            linear_lb=d.cons_lb[g:].to(device, dtype) if lin else None,
            linear_ub=d.cons_ub[g:].to(device, dtype) if lin else None,
            dtype=dtype,
            device=device,
        )

    def astype(self, dtype: torch.dtype) -> "Problem":
        """This problem with bounds and linear data in ``dtype``; the
        callables follow their arguments' dtype."""
        return self._rebuilt(dtype, self.device)

    def to(self, device: Any) -> "Problem":
        """The same problem with its tensors on ``device`` (self if they
        are there already)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return self._rebuilt(self.dtype, device)
