"""Dynamic (inexact, adaptive-accuracy) function model.

Port of ``sleqp_tpu/dyn.py`` (reference src/main/dyn.c and the trial-point
refinement loop, trial_point.c:791-933): a ``DynFunc`` evaluates the
objective and constraints inexactly.  The user callable receives the
current error bound and weights and returns the values with an error
estimate:

    eval(x, error_bound, obj_weight, cons_weights)
        -> (obj, cons_vals, error_estimate)

The solver requires the weighted error ``obj_weight * err_f +
sum(cons_weights * err_c)`` to stay below ``error_bound``; the constraint
weights equal the penalty parameter (dyn.c:396-420) and the objective
weight is 1.

Refinement: an insufficiently accurate step is rejected, the error bound
tightens to the required value, and the iterate is re-evaluated at the
start of the next iteration (``problem_solver.py``).  Derivatives go
through ``eval`` at the same accuracy by reverse-mode AD: the gradient by
``grad``, the Jacobian by ``jacrev`` and the Hessian product by the ``vjp``
of the Lagrangian gradient (the reference uses ``jacfwd`` and ``jvp``).
``eval`` follows its arguments' dtype and device, as every callable does.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.func import grad, jacrev, vjp

from .problem import Func

Tensor = torch.Tensor

# trial_point.c:806: required accuracy = .4 * accepted_reduction * reduction
REQUIRED_ACCURACY_FACTOR = 0.4


class DynFunc(Func):
    """Inexact function model (reference sleqp_dyn_func_create, pub_dyn.h).

    The solver calls the ``*_dyn`` methods with the current error bound;
    ``obj_val``, ``cons_val`` and their derivatives evaluate at
    ``initial_error_bound`` with unit weights.
    """

    def __init__(
        self,
        eval_fn: Callable,
        num_variables: int,
        num_cons: int = 0,
        psd_hessian: bool = False,
    ):
        self.eval_fn = eval_fn
        self.initial_error_bound = 1.0

        def bound(x: Tensor) -> Tensor:
            return torch.full((), self.initial_error_bound, dtype=x.dtype, device=x.device)

        super().__init__(
            obj=lambda x: self.eval_at(x, bound(x))[0],
            num_variables=num_variables,
            cons=(lambda x: self.eval_at(x, bound(x))[1]) if num_cons else None,
            num_cons=num_cons,
            psd_hessian=psd_hessian,
        )

    # -- dynamic evaluations -------------------------------------------

    def eval_at(self, x: Tensor, error_bound: Tensor, penalty: Any = 1.0):
        """(obj, cons, error estimate) at the accuracy ``error_bound``, with
        objective weight 1 and constraint weights ``penalty``."""
        obj_weight = torch.ones((), dtype=x.dtype, device=x.device)
        cons_weights = torch.as_tensor(penalty, dtype=x.dtype, device=x.device).expand(
            self.num_cons)
        obj, cons, err = self.eval_fn(x, error_bound, obj_weight, cons_weights)
        return (
            torch.as_tensor(obj, dtype=x.dtype, device=x.device).reshape(()),
            torch.as_tensor(cons, dtype=x.dtype, device=x.device).reshape(self.num_cons),
            torch.as_tensor(err, dtype=x.dtype, device=x.device).reshape(()),
        )

    def obj_val_dyn(self, x: Tensor, error_bound: Tensor, penalty: Any = 1.0):
        obj, _, err = self.eval_at(x, error_bound, penalty)
        return obj, err

    def hess_prod_dyn(self, x: Tensor, direction: Tensor, cons_dual: Tensor,
                      error_bound: Tensor, penalty: Tensor) -> Tensor:
        """Lagrangian Hessian product through the current-accuracy eval:
        the vjp of the Lagrangian gradient (the Hessian is symmetric)."""

        def lag(w: Tensor) -> Tensor:
            obj, cons, _ = self.eval_at(w, error_bound, penalty)
            if self.num_cons:
                return obj + torch.dot(cons_dual, cons)
            return obj

        _, pull = vjp(grad(lag), x)
        return pull(direction)[0]

    def eval_all_dyn(self, x: Tensor, error_bound: Tensor, penalty: Tensor):
        """(obj, grad, cons, jac, error) at the given accuracy."""
        obj, cons, err = self.eval_at(x, error_bound, penalty)
        g = grad(lambda z: self.eval_at(z, error_bound, penalty)[0])(x)
        if self.num_cons:
            jac = jacrev(lambda z: self.eval_at(z, error_bound, penalty)[1])(x)
        else:
            jac = torch.zeros((0, self.num_variables), dtype=x.dtype, device=x.device)
        return obj, g, cons, jac, err


def required_error_bound(accepted_reduction: float, model_reduction: Tensor) -> Tensor:
    """trial_point.c:797-810 compute_required_error_bound."""
    return REQUIRED_ACCURACY_FACTOR * accepted_reduction * model_reduction
