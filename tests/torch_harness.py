"""Shared pieces of the harness parity tests
(tests/test_torch_harness_{hs,medium}.py): the problem data of the port's
registries held against the JAX package's, and suite rows held against
the r5 sweep's CSVs."""

import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
R5 = {"float64": REPO / "artifacts" / "suite_all_f64_r5.csv",
      "mixed": REPO / "artifacts" / "suite_all_mixed_r5.csv"}


def r5_rows(route="float64"):
    """name -> fields of the r5 CSV of ``route``."""
    rows = {}
    for line in R5[route].read_text().splitlines():
        if line and not line.startswith(("#", "name;")):
            rows[line.split(";")[0]] = line.split(";")
    return rows


def _data(problem):
    d = problem.data
    return {k: np.asarray(getattr(d, k)) for k in ("var_lb", "var_ub", "cons_lb", "cons_ub",
                                                  "linear_coeffs")}


def _points(name, x0, lb, ub):
    """x0 and one in-bounds perturbation of it, seeded by the name."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x1 = x0 + 0.1 * (1.0 + np.abs(x0)) * rng.standard_normal(x0.shape)
    return [x0, np.clip(x1, lb, ub)]


def check_problem(name, jax_get, port_get, tol=1e-12):
    """The port's entry ``name`` equals JAX's: sizes, x0, bounds, linear
    rows and f_opt exactly; f, grad f, c and J at x0 and at a seeded
    perturbation to ``tol`` (relative, absolute near zero), NaN pattern
    included."""
    jp, jx0, jf = jax_get(name)
    tp, tx0, tf = port_get(name, "cpu")
    assert tp.device.type == "cpu" and tx0.dtype == torch.float64
    assert (tp.num_variables, tp.num_general, tp.num_linear) == (
        jp.num_variables, jp.num_general, jp.num_linear)
    assert tf == jf
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))
    jd, td = _data(jp), _data(tp)
    for key in jd:
        np.testing.assert_array_equal(td[key], jd[key], err_msg=key)
    assert type(tp.func).__name__ == type(jp.func).__name__
    assert tp.func.psd_hessian == jp.func.psd_hessian
    for x in _points(name, np.asarray(jx0), jd["var_lb"], jd["var_ub"]):
        xj, xt = jnp.asarray(x), torch.tensor(x)
        pairs = [(tp.obj_val(xt), jp.obj_val(xj)), (tp.obj_grad(xt), jp.obj_grad(xj)),
                 (tp.cons_val(xt), jp.cons_val(xj)), (tp.cons_jac(xt), jp.cons_jac(xj))]
        for what, (got, ref) in zip(("f", "grad", "c", "J"), pairs):
            ref = np.asarray(ref)
            assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape, what
            np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol, err_msg=what)


def check_row(row, route="float64", iter_slack=3):
    """A port suite row against the r5 row of its problem: the status, the
    objective to 1e-6 (relative, absolute where |f| < 1) on an optimal row,
    and the iterations within ``iter_slack``."""
    fields = row.split(";")
    assert len(fields) == 14
    ref = r5_rows(route)[fields[0]]
    assert fields[3] == ref[3], (row, ref)
    if ref[3] == "optimal":
        f, f_ref = float(fields[4]), float(ref[4])
        assert abs(f - f_ref) <= 1e-6 * max(1.0, abs(f_ref)), (row, ref)
    assert abs(int(fields[8]) - int(ref[8])) <= iter_slack, (row, ref)
    assert fields[1:3] == ref[1:3]
