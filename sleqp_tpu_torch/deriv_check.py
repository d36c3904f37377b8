"""Finite-difference derivative validation.

Port of ``sleqp_tpu/deriv_check.py`` (reference src/main/deriv_check.c):
the objective gradient (first order, deriv_check.c:297-331), the
constraint Jacobian and Hessian products (second order,
deriv_check.c:377-533) are held against forward finite differences, and
``InvalidDerivativeError`` is raised when a mismatch exceeds ``deriv_tol``
(the reference's SLEQP_INVALID_DERIV).  The functions run on the
problem's device; the comparisons on the host, in numpy.

With AD defaults this mostly guards user-provided overrides, as in the
reference, where every derivative is user code.
"""

from __future__ import annotations

import numpy as np
import torch

from .problem import Problem
from .settings import Settings


class InvalidDerivativeError(RuntimeError):
    """Raised when a derivative check fails (SLEQP_INVALID_DERIV)."""


def _report(kind, index, expected, actual, tol):
    return (f"{kind}[{index}]: finite difference {expected:.8e} vs "
            f"provided {actual:.8e} (tol {tol:.1e})")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def check_derivatives(problem: Problem, x, settings: Settings | None = None,
                      check_second_order: bool = True,
                      raise_on_failure: bool = True) -> list[str]:
    """Run the checks at x; returns a list of human-readable findings."""
    settings = settings or Settings()
    h = settings.deriv_perturbation
    tol = settings.deriv_tol
    dev, dtype = problem.device, problem.dtype

    def on_device(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    xt = problem.clip_to_bounds(on_device(x))
    x = _host(xt)
    n = problem.num_variables
    m = problem.num_cons
    findings: list[str] = []

    f0 = float(problem.obj_val(xt))
    g = _host(problem.obj_grad(xt))
    c0 = _host(problem.cons_val(xt))
    J = _host(problem.cons_jac(xt))

    # all n coordinate perturbations as one vmapped batch
    perturbed = xt[None, :] + h * torch.eye(n, dtype=dtype, device=dev)
    f_all = _host(torch.func.vmap(problem.obj_val)(perturbed))
    fd_g = (f_all - f0) / h
    bad_g = np.abs(fd_g - g) > tol * (1.0 + np.abs(fd_g))
    for j in np.nonzero(bad_g)[0]:
        findings.append(_report("obj_grad", int(j), fd_g[j], g[j], tol))

    if m:
        c_all = _host(torch.func.vmap(problem.cons_val)(perturbed))  # (n, m)
        fd_J = (c_all - c0[None, :]) / h  # fd_J[j, i] = dc_i/dx_j
        bad = np.abs(fd_J.T - J) > tol * (1.0 + np.abs(fd_J.T))
        for i, j in zip(*np.nonzero(bad)):
            findings.append(_report(f"cons_jac[{int(i)},", int(j), fd_J[j, i], J[i, j], tol))

    if check_second_order:
        rng = np.random.default_rng(0)
        mu = rng.standard_normal(m) if m else np.zeros((0,))

        def lag_grad(z):
            zt = on_device(z)
            gg = _host(problem.obj_grad(zt))
            if m:
                gg = gg + _host(problem.cons_jac(zt)).T @ mu
            return gg

        g0 = lag_grad(x)
        for trial in range(2):
            d = rng.standard_normal(n)
            d /= np.linalg.norm(d)
            hd = _host(problem.hess_prod(xt, on_device(d), on_device(mu)))
            fd = (lag_grad(x + h * d) - g0) / h
            err = np.max(np.abs(fd - hd)) / (1.0 + np.max(np.abs(fd)))
            if err > tol:
                findings.append(f"hess_prod(dir {trial}): max deviation {err:.3e} "
                                f"exceeds tol {tol:.1e}")

    if findings and raise_on_failure:
        raise InvalidDerivativeError("\n".join(findings))
    return findings
