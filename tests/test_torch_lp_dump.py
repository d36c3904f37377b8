"""Port parity of the CPLEX LP dumps: ``ops/simplex.write_lp`` and
``cauchy.dump_cauchy_lp`` against the JAX package's.

* ``write_lp`` on the same numpy LP writes JAX's file byte for byte
  (``%.17g`` numbers, infinite bounds as ``-inf``/``+inf``, zero
  coefficients left out, an all-zero objective or row as ``0 x0``), also
  when handed torch tensors.
* ``dump_cauchy_lp`` on HS71's first Cauchy LP, from JAX's initial state
  carried across, parses to JAX's A, bounds and c within 1e-12, and to the
  LP the port's solver assembles.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.cauchy as jc
import sleqp_tpu.problem_solver as jps
import torch_dense
from sleqp_tpu import Settings as JaxSettings
from sleqp_tpu.ops import simplex as js
from sleqp_tpu.types import INF
from sleqp_tpu_torch import cauchy as tc
from sleqp_tpu_torch.ops import simplex as ts
from torch_parity import no_jax_cache_writes  # noqa: F401


def _lp(seed, m=4, N=9):
    """A random LP with zero coefficients, a zero row, an all-zero column
    in c, and infinite, one-sided and fixed bounds."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.uniform(size=(m, N)) < 0.3, 0.0, rng.standard_normal((m, N)))
    A[2] = 0.0
    c = np.where(rng.uniform(size=N) < 0.3, 0.0, rng.standard_normal(N) * 1e3)
    lb = -rng.uniform(0.0, 3.0, N)
    ub = rng.uniform(0.0, 3.0, N)
    lb[0], ub[1] = -INF, INF
    lb[2] = ub[2] = 0.25
    return A, lb, ub, c


def parse_lp(path):
    """(A, lb, ub, c) of a file written by write_lp."""
    text = open(path).read().splitlines()
    m, N = (int(v) for v in re.match(r"\\ \S+: (\d+) columns, (\d+) rows", text[0]).groups()[::-1])
    A, c = np.zeros((m, N)), np.zeros(N)
    lb, ub = np.zeros(N), np.zeros(N)

    def terms(s, into):
        for sign, value, j in re.findall(r"([+-]) (\S+) x(\d+)", s):
            into[int(j)] += float(value) * (1.0 if sign == "+" else -1.0)

    terms(text[2], c)
    i = text.index("Subject To") + 1
    for k in range(m):
        terms(text[i + k].split(":", 1)[1], A[k])
    i = text.index("Bounds") + 1
    for j in range(N):
        lo, var, hi = re.match(r" (\S+) <= x(\d+) <= (\S+)", text[i + j]).groups()
        assert int(var) == j
        lb[j] = -INF if lo == "-inf" else float(lo)
        ub[j] = INF if hi == "+inf" else float(hi)
    assert text[i + N] == "End"
    return A, lb, ub, c


@pytest.mark.parametrize("seed", range(3))
def test_write_lp_matches_jax_byte_for_byte(seed, tmp_path):
    A, lb, ub, c = _lp(seed)
    if seed == 2:
        c = np.zeros_like(c)  # an all-zero objective
    js.write_lp(A, lb, ub, c, tmp_path / "jax.lp", name="lp")
    ts.write_lp(A, lb, ub, c, tmp_path / "port.lp", name="lp")
    ts.write_lp(*(torch.as_tensor(v) for v in (A, lb, ub, c)), tmp_path / "tensors.lp", name="lp")
    ref = (tmp_path / "jax.lp").read_bytes()
    assert (tmp_path / "port.lp").read_bytes() == ref
    assert (tmp_path / "tensors.lp").read_bytes() == ref
    got = parse_lp(tmp_path / "port.lp")
    for a, b in zip(got, (A, lb, ub, c)):
        np.testing.assert_array_equal(a, np.where(np.abs(b) >= INF, np.sign(b) * INF, b))


def test_dump_cauchy_lp_matches_jax(tmp_path):
    jp, tp, x0 = torch_dense.hs71()
    state = jps.initial_state(jp, JaxSettings(), jnp.asarray(x0))
    port = torch_dense.port_state(state)
    jc.dump_cauchy_lp(jp.data, state.it, state.lp_trust_radius, state.penalty, tmp_path / "jax.lp")
    tc.dump_cauchy_lp(tp.data, port.it, port.lp_trust_radius, port.penalty, tmp_path / "port.lp")
    tc.dump_cauchy_lp(tp.data, port.it, float(port.lp_trust_radius), float(port.penalty),
                      tmp_path / "floats.lp")
    ref = parse_lp(tmp_path / "jax.lp")
    n, m = tp.num_variables, tp.num_cons
    assert ref[0].shape == (m, n + 3 * m)
    for path in ("port.lp", "floats.lp"):
        for a, b in zip(parse_lp(tmp_path / path), ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    # the LP the port's Cauchy step solves
    A, lb, ub = tc._lp_data(tp.data, port.it, port.lp_trust_radius)
    c = tc._objective(port.it, port.penalty, False)
    for a, b in zip(parse_lp(tmp_path / "port.lp"), (A, lb, ub, c)):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-12)
