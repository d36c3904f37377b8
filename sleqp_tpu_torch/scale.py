"""Power-of-two problem scaling.

Port of ``sleqp_tpu/scale.py`` (reference src/main/scale.c +
problem_scaling.c): the scaled NLP (pub_scale.h:14-60)

    f'(x') = 2^{-lam} f(x),   c' = 2^{-alpha} . c,   x' = 2^{-beta} . x

with integer weights (lam, alpha, beta).  Every factor is a power of two,
so scaling and unscaling are exact on floats (apart from over- and
underflow), as the reference's ``ldexp`` (scale.c:35-69).  Here the
factors 2^w are made once on the host by ``numpy.ldexp`` (exact) and
multiply on the device; a power of two is exact in float32 too, so the
mixed route's float32 callables stay exact.  Functions are evaluated in
the original space; scaling is applied outside (problem_scaling.c).

Derivative transforms:
    grad' = 2^{beta - lam} . grad
    J'_{ij} = 2^{-alpha_i + beta_j} J_{ij}
    cons duals: mu = 2^{lam - alpha} . mu'   (unscale)
    var  duals: nu = 2^{lam - beta}  . nu'
    Hessian product: H' d = 2^{beta - lam} . H(2^{beta} . d), the
    constraint multipliers unscaled first.

A dynamic function (``dyn.py``) stays dynamic under scaling
(problem_scaling.c:276-345): its values are scaled on the way out and the
solver's error weights on the way in, by the same exact powers of two.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .dyn import DynFunc
from .problem import Func, Problem

Tensor = torch.Tensor

def _frexp_weight(value: float) -> int:
    """Exponent e with value = m 2^e, 0.5 <= |m| < 1 (scale.c:165)."""
    if value == 0 or not math.isfinite(value):
        return 0
    return math.frexp(value)[1]


@dataclasses.dataclass
class Scaling:
    """Integer scaling weights (reference SleqpScaling), held on the host."""

    num_variables: int
    num_cons: int
    obj_weight: int = 0
    var_weights: Optional[np.ndarray] = None
    cons_weights: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.var_weights is None:
            self.var_weights = np.zeros(self.num_variables, dtype=np.int32)
        if self.cons_weights is None:
            self.cons_weights = np.zeros(self.num_cons, dtype=np.int32)

    # -- nominal-value APIs (pub_scale.h, scale.c:160-250) --------------

    def set_obj_weight_from_nominal(self, nominal: float) -> None:
        self.obj_weight = _frexp_weight(nominal)

    def set_var_weights_from_nominal(self, nominal) -> None:
        self.var_weights = np.array([_frexp_weight(v) for v in np.asarray(nominal)],
                                    dtype=np.int32)

    def set_cons_weights_from_nominal(self, nominal) -> None:
        self.cons_weights = np.array([_frexp_weight(v) for v in np.asarray(nominal)],
                                     dtype=np.int32)

    # -- derived from derivatives (scale.c:640-740) ---------------------

    def derive_obj_weight_from_grad(self, grad) -> None:
        """Weight making max |grad'| ~ 1 (scale.c:657 frexp(1/max))."""
        max_val = float(np.max(np.abs(_host(grad)), initial=0.0))
        self.obj_weight = -_frexp_weight(1.0 / max_val) if max_val > 0 else 0

    def derive_cons_weights_from_jac(self, cons_jac) -> None:
        J = _host(cons_jac)
        for i in range(J.shape[0]):
            max_val = float(np.max(np.abs(J[i]), initial=0.0))
            self.cons_weights[i] = -_frexp_weight(1.0 / max_val) if max_val > 0 else 0


def _host(v) -> np.ndarray:
    if isinstance(v, Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _pow2(weights, device) -> Tensor:
    """2^weights as exact float64 powers of two on ``device``."""
    return torch.as_tensor(np.ldexp(1.0, np.asarray(weights, dtype=np.int64)),
                           dtype=torch.float64, device=device)


def _ldexp(x: Tensor, factor: Tensor) -> Tensor:
    """x 2^w, given the power of two ``factor`` = 2^w (exact)."""
    return x * factor.to(x.dtype)


def derive_scaling(problem: Problem, x) -> Scaling:
    """Scaling weights from first derivatives at ``x``, so that
    max |grad'| ~ 1 and max |J'_i| ~ 1 per row (scale.c:640-740,
    sleqp_scaling_from_gradient / sleqp_scaling_from_cons_jac)."""
    x = problem.clip_to_bounds(torch.as_tensor(x, dtype=problem.dtype, device=problem.device))
    scaling = Scaling(problem.num_variables, problem.num_cons)
    scaling.derive_obj_weight_from_grad(problem.obj_grad(x))
    if problem.num_cons:
        scaling.derive_cons_weights_from_jac(problem.cons_jac(x))
    return scaling


class ScaledProblem(Problem):
    """A Problem evaluating the scaled NLP over the original func, on the
    original problem's device."""

    def __init__(self, problem: Problem, scaling: Scaling):
        if (scaling.num_variables != problem.num_variables
                or scaling.num_cons != problem.num_cons):
            raise ValueError("scaling dimensions do not match problem")
        self.original = problem
        self.scaling = scaling
        dev = problem.device

        lam = int(scaling.obj_weight)
        beta = np.asarray(scaling.var_weights, dtype=np.int64)
        alpha = np.asarray(scaling.cons_weights, dtype=np.int64)
        mg = problem.num_general
        alpha_general = alpha[:mg]

        up_x = _pow2(beta, dev)  # 2^beta: x = 2^beta x'
        down_obj = math.ldexp(1.0, -lam)
        down_c = _pow2(-alpha_general, dev)
        grad_f = _pow2(beta - lam, dev)
        jac_f = _pow2(-alpha_general[:, None] + beta[None, :], dev)
        mu_f = _pow2(lam - alpha_general, dev)
        self._down_x = _pow2(-beta, dev)
        self._up_x = up_x
        self._obj_up = math.ldexp(1.0, lam)
        self._cons_dual_f = _pow2(lam - alpha, dev)
        self._vars_dual_f = _pow2(lam - beta, dev)

        def obj(xs):
            return problem.obj_val(_ldexp(xs, up_x)) * down_obj

        def cons(xs):
            # the general part only; linear rows are scaled coefficients
            return _ldexp(problem.func.cons_val(_ldexp(xs, up_x)), down_c)

        def obj_grad(xs):
            return _ldexp(problem.obj_grad(_ldexp(xs, up_x)), grad_f)

        def cons_jac(xs):
            return _ldexp(problem.func.cons_jac(_ldexp(xs, up_x)), jac_f)

        def hess_prod(xs, d, mu_scaled):
            hd = problem.func.hess_prod(_ldexp(xs, up_x), _ldexp(d, up_x), _ldexp(mu_scaled, mu_f))
            return _ldexp(hd, grad_f)

        if isinstance(problem.func, DynFunc):
            # the solver's error weights are scaled on the way in
            # (scaled_dyn_func_set_obj_weight / _set_cons_weights:
            # ldexp(w, -exponent)), so that the weighted-error contract
            # refers to the scaled merit the solver measures
            inner = problem.func

            def dyn_eval(xs, error_bound, obj_weight, cons_weights):
                obj_v, cons_v, err = inner.eval_fn(
                    _ldexp(xs, up_x), error_bound, obj_weight * down_obj,
                    _ldexp(cons_weights, down_c))
                return obj_v * down_obj, _ldexp(cons_v, down_c), err

            func = DynFunc(dyn_eval, num_variables=problem.num_variables, num_cons=mg,
                           psd_hessian=problem.func.psd_hessian)
            func.initial_error_bound = inner.initial_error_bound
        else:
            func = Func(obj, num_variables=problem.num_variables, cons=cons if mg else None,
                        num_cons=mg, obj_grad=obj_grad, cons_jac=cons_jac if mg else None,
                        hess_prod=hess_prod, psd_hessian=problem.func.psd_hessian)

        d = problem.data
        ml = problem.num_linear
        lin_coeffs = lin_lb = lin_ub = None
        if ml:
            alpha_linear = alpha[mg:]
            lin_coeffs = _ldexp(d.linear_coeffs, _pow2(-alpha_linear[:, None] + beta[None, :], dev))
            lin_lb = _ldexp(d.cons_lb[mg:], _pow2(-alpha_linear, dev))
            lin_ub = _ldexp(d.cons_ub[mg:], _pow2(-alpha_linear, dev))
        super().__init__(
            func,
            var_lb=_ldexp(d.var_lb, self._down_x),
            var_ub=_ldexp(d.var_ub, self._down_x),
            general_lb=_ldexp(d.cons_lb[:mg], down_c),
            general_ub=_ldexp(d.cons_ub[:mg], down_c),
            linear_coeffs=lin_coeffs,
            linear_lb=lin_lb,
            linear_ub=lin_ub,
            dtype=problem.dtype,
            device=dev,
        )

    # -- point / value transforms (problem_scaling.c, scale.c) ----------

    def scale_point(self, x) -> Tensor:
        return _ldexp(torch.as_tensor(x, dtype=self.dtype, device=self.device), self._down_x)

    def unscale_point(self, xs: Tensor) -> Tensor:
        return _ldexp(xs, self._up_x)

    def unscale_obj(self, obj_scaled: Tensor) -> Tensor:
        return obj_scaled * self._obj_up

    def unscale_cons_dual(self, mu_scaled: Tensor) -> Tensor:
        return _ldexp(mu_scaled, self._cons_dual_f)

    def unscale_vars_dual(self, nu_scaled: Tensor) -> Tensor:
        return _ldexp(nu_scaled, self._vars_dual_f)
