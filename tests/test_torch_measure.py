"""Port parity: the per-step nonlinearity diagnostics,
sleqp_tpu_torch/measure.py against sleqp_tpu/measure.py, to 1e-12, and
the text of format_measure."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.measure as jms
import sleqp_tpu.merit as jme
from sleqp_tpu.iterate import create_iterate
from sleqp_tpu_torch import measure as tms
from sleqp_tpu_torch import merit as tme
from torch_dense import chainineq, flat_jax, flat_port, hs71, mismatches, port_iterate, wachbieg
from torch_parity import no_jax_cache_writes  # noqa: F401

PAIRS = {"hs71": hs71, "wachbieg": wachbieg, "chainineq": lambda: chainineq(8)}


@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.5])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_measure_matches_jax(name, scale):
    jp, tp, x0 = PAIRS[name]()
    rng = np.random.default_rng(4)
    n, m = jp.num_variables, jp.num_cons
    it = create_iterate(jp, jnp.asarray(x0))
    d = scale * rng.standard_normal(n)
    trial = create_iterate(jp, it.x + d)
    mult = rng.standard_normal(m)
    hd = jp.hess_prod(it.x, jnp.asarray(d), jnp.asarray(mult))
    jdir = jme.make_direction(it, jnp.asarray(d), hd)
    tit, ttrial = port_iterate(it), port_iterate(trial)
    tdir = tme.make_direction(tit, torch.as_tensor(d), torch.as_tensor(np.asarray(hd)))
    jm = jms.compute_measure(jp.data, it, trial, jdir, jnp.asarray(mult))
    tm = tms.compute_measure(tp.data, tit, ttrial, tdir, torch.as_tensor(mult))
    bad = mismatches(flat_port(tm), flat_jax(jm), 1e-12)
    assert not bad, bad
    assert tms.format_measure(tm, 10.0) == jms.format_measure(jm, 10.0)
    assert not mismatches(flat_port(tms.empty_measure(torch.float64)),
                          flat_jax(jms.empty_measure(jnp.float64)), 0.0)
