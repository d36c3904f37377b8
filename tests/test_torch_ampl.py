"""Port parity of the AMPL ``.nl`` front end (sleqp_tpu_torch/harness/ampl.py)
against sleqp_tpu/harness/ampl.py, on tests/test_ampl.py's five cases and
its inline ``.nl`` texts (HS71, and a maximizing LP).

* ``read_nl``: the same sizes, sense, x0 and bounds, and the objective,
  constraints and their derivatives at x0 within 1e-12 of the reference's.
* ``solve_nl``: the status, objective (1e-8) and x (1e-8) of the
  reference's solve, and the ``.sol`` files line for line (numbers within
  1e-8 relative).
* The rejected features raise ``NLFormatError`` in both packages.
* ``write_sol`` writes the reference's bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleqp_tpu.harness import ampl as jampl
from sleqp_tpu_torch.harness.ampl import NLFormatError, read_nl, solve_nl, write_sol
from test_ampl import HS71_NL, LP_NL
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NL = {"hs71": HS71_NL, "lp": LP_NL}


def _sol_numbers(text):
    """The numbers of a .sol file below its message line."""
    out = []
    for token in " ".join(text.splitlines()[1:]).split():
        try:
            out.append(float(token))
        except ValueError:
            pass
    return out


def test_read_nl_hs71():
    jp, jx0, jsense = jampl.read_nl(HS71_NL)
    problem, x0, sense = read_nl(HS71_NL, device="cpu")
    assert (problem.num_variables, problem.num_cons, sense) == (4, 2, 1.0) == (
        jp.num_variables, jp.num_cons, jsense)
    np.testing.assert_allclose(x0.numpy(), [1.0, 5.0, 5.0, 1.0])
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    x = torch.tensor([1.0, 5.0, 5.0, 1.0], dtype=torch.float64)
    assert float(problem.obj_val(x)) == pytest.approx(16.0)
    np.testing.assert_allclose(problem.cons_val(x).numpy(), [25.0, 52.0])
    np.testing.assert_allclose(problem.data.cons_lb.numpy(), [25.0, 40.0])
    np.testing.assert_allclose(problem.data.cons_ub.numpy(), [np.inf, 40.0])
    for field in ("var_lb", "var_ub", "cons_lb", "cons_ub"):
        np.testing.assert_array_equal(getattr(problem.data, field).numpy(),
                                      np.asarray(getattr(jp.data, field)))
    xj = jnp.asarray(x.numpy())
    mult = np.array([0.3, -0.7])
    pairs = [(problem.obj_grad(x), jp.obj_grad(xj)), (problem.cons_jac(x), jp.cons_jac(xj)),
             (problem.hess_prod(x, x, torch.as_tensor(mult)),
              jp.hess_prod(xj, xj, jnp.asarray(mult)))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["hs71", "lp"])
def test_solve_nl_matches_jax(name, tmp_path):
    """tests/test_ampl.py::test_solve_nl_hs71 and ::test_solve_nl_lp_maximize."""
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / f"{name}.nl").write_text(NL[name])
    rs, rstatus, robj = jampl.solve_nl(str(tmp_path / "jax" / f"{name}.nl"), max_iterations=100)
    solver, status, obj_val = solve_nl(str(tmp_path / "port" / f"{name}.nl"), max_iterations=100,
                                       device="cpu")
    if name == "hs71":
        assert obj_val == pytest.approx(17.0140173, abs=1e-4)
        sol = (tmp_path / "port" / "hs71.sol").read_text()
        assert "OPTIMAL" in sol and "objno 0 0" in sol
    else:  # maximization: the objective in the original sense
        assert obj_val == pytest.approx(34.0, abs=1e-6)
        np.testing.assert_allclose(solver.solution, [6.0, 4.0], atol=1e-6)
    assert int(status) == int(rstatus)
    assert obj_val == pytest.approx(robj, abs=1e-8)
    np.testing.assert_allclose(solver.solution, np.asarray(rs.solution), rtol=0, atol=1e-8)
    got = (tmp_path / "port" / f"{name}.sol").read_text()
    ref = (tmp_path / "jax" / f"{name}.sol").read_text()
    assert got.splitlines()[0].split(",")[0] == ref.splitlines()[0].split(",")[0]
    assert len(got.splitlines()) == len(ref.splitlines())
    assert len(_sol_numbers(got)) >= 8 + len(solver.solution)
    np.testing.assert_allclose(_sol_numbers(got), _sol_numbers(ref), rtol=1e-8, atol=1e-8)


def test_unsupported_features_rejected():
    for reader, error in ((jampl.read_nl, jampl.NLFormatError),
                          (lambda t: read_nl(t, device="cpu"), NLFormatError)):
        with pytest.raises(error, match="text"):
            reader("b3 0 1 0\n 1 0 1 0 0\n")
        bad = HS71_NL.replace("C0\no2", "C0\no99")
        with pytest.raises(error, match="opcode"):
            p, x0, _ = reader(bad)
            p.cons_val(x0)
        with pytest.raises(error, match="segment"):
            reader(HS71_NL + "V0 0 0\n")


def test_write_sol_roundtrip(tmp_path):
    write_sol(str(tmp_path / "out.sol"), "test message", torch.tensor([1.0, 2.5]),
              torch.tensor([0.5]), solve_result=0)
    jampl.write_sol(str(tmp_path / "ref.sol"), "test message", [1.0, 2.5], [0.5], solve_result=0)
    text = (tmp_path / "out.sol").read_text()
    assert "test message" in text and "2.5" in text
    assert text == (tmp_path / "ref.sol").read_text()
