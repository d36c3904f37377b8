"""Port parity: the working step, the EQP (Newton) step on both of its
trust-region routes and in mixed precision, and the linesearches:
sleqp_tpu_torch/{newton,linesearch}.py against sleqp_tpu/{newton,
linesearch}.py.  Inputs are the iterate, working set and duals the JAX
package forms at the start of an iteration, handed to both packages.
Steps to 1e-9 (float32 Krylov loop: 1e-4), linesearch alpha to 1e-12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleqp_tpu.cauchy as jc
import sleqp_tpu.linesearch as jls
import sleqp_tpu.merit as jme
import sleqp_tpu.newton as jnw
from sleqp_tpu.iterate import create_iterate
from sleqp_tpu.ops import kkt as jkkt
from sleqp_tpu_torch import linesearch as tls
from sleqp_tpu_torch import merit as tme
from sleqp_tpu_torch import newton as tnw
from sleqp_tpu_torch.ops import kkt as tkkt
from torch_dense import (
    chainineq, flat_jax, flat_port, hs71, jax_cauchy_lp, mismatches, port_iterate, quadcons,
)
from torch_parity import no_jax_cache_writes  # noqa: F401

PAIRS = {"hs71": hs71, "chainineq": lambda: chainineq(8), "quadcons": quadcons}
RADII = (0.05, 1.0)


def _start(name, shift, lp_radius=0.5, penalty=10.0):
    """The iterate with the LP's working set and LSQ duals, as
    perform_iteration forms it, in both packages."""
    jp, tp, x0 = PAIRS[name]()
    n, m = jp.num_variables, jp.num_cons
    it = create_iterate(jp, jnp.asarray(x0) + shift)
    cres = jax_cauchy_lp(jp.data, it, jnp.asarray(lp_radius), jnp.asarray(penalty),
                         jc.empty_basis(n, m))
    it = dataclasses.replace(it, var_states=cres.var_states, cons_states=cres.cons_states)
    aug = jkkt.aug_jac_create(it.cons_jac, it.var_states, it.cons_states)
    _, lam = jkkt.solve_lsq(aug, -it.obj_grad)
    it = dataclasses.replace(it, vars_dual=jc._trim_duals(lam[:n], it.var_states),
                             cons_dual=jc._trim_duals(lam[n:], it.cons_states))
    tit = port_iterate(it)
    taug = tkkt.aug_jac_create(tit.cons_jac, tit.var_states, tit.cons_states)
    return jp, tp, it, tit, aug, taug, cres


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_working_step_matches_jax(name, radius):
    jp, tp, it, tit, aug, taug, _ = _start(name, 0.1)
    jws = jnw.compute_working_step(jp.data, it, aug, jnp.asarray(radius))
    tws = tnw.compute_working_step(tp.data, tit, taug, torch.tensor(radius, dtype=torch.float64))
    bad = mismatches(flat_port(tws), flat_jax(jws), 1e-10)
    assert not bad, bad
    rhs_j = np.asarray(jnw._working_set_rhs(jp.data, it))
    np.testing.assert_allclose(tnw._working_set_rhs(tp.data, tit).numpy(), rhs_j, atol=1e-12)


@pytest.mark.parametrize("route", ["gltr", "cg", "gltr_f32", "cg_f32"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_newton_step_matches_jax(name, route):
    jp, tp, it, tit, aug, taug, _ = _start(name, 0.1)
    penalty = 10.0
    jws = jnw.compute_working_step(jp.data, it, aug, jnp.asarray(1.0))
    tws = tnw.compute_working_step(tp.data, tit, taug, torch.tensor(1.0, dtype=torch.float64))
    jmult = it.cons_dual + penalty * jws.violated_mult
    tmult = tit.cons_dual + penalty * tws.violated_mult
    mixed = route.endswith("f32")
    kw = dict(use_gltr=route.startswith("gltr"))
    jkw, tkw = dict(kw), dict(kw)
    if mixed:
        xc, mc = it.x.astype(jnp.float32), jmult.astype(jnp.float32)
        txc, tmc = tit.x.float(), tmult.float()
        jkw.update(compute_dtype=jnp.float32, hess_prod_compute=lambda d: jp.hess_prod(xc, d, mc))
        tkw.update(compute_dtype=torch.float32,
                   hess_prod_compute=lambda d: tp.hess_prod(txc, d, tmc))
    jn = jnw.compute_newton_step(jp.data, it, aug, jws, lambda d: jp.hess_prod(it.x, d, jmult),
                                 jnp.asarray(penalty), 100, **jkw)
    tn = tnw.compute_newton_step(tp.data, tit, taug, tws, lambda d: tp.hess_prod(tit.x, d, tmult),
                                 torch.tensor(penalty, dtype=torch.float64), 100, **tkw)
    bad = mismatches(flat_port(tn), flat_jax(jn), 1e-4 if mixed else 1e-9,
                     skip=("tr.iterations",) if mixed else ())
    assert not bad, bad
    if mixed:
        assert abs(int(tn.tr.iterations) - int(jn.tr.iterations)) <= 1


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_linesearches_match_jax(name, radius):
    jp, tp, it, tit, aug, taug, cres = _start(name, 0.1)
    penalty = 10.0
    jpen, tpen = jnp.asarray(penalty), torch.tensor(penalty, dtype=torch.float64)
    mult = np.array(it.cons_dual)
    jhp = lambda d: jp.hess_prod(it.x, d, jnp.asarray(mult))  # noqa: E731
    thp = lambda d: tp.hess_prod(tit.x, d, torch.as_tensor(mult))  # noqa: E731
    step = cres.lp_step
    jd = jme.make_direction(it, step, jhp(step))
    tstep = torch.as_tensor(np.array(step))
    td = tme.make_direction(tit, tstep, thp(tstep))
    jcd, jfull, jcm = jls.cauchy_linesearch(jp.data, it, jd, jpen, jnp.asarray(radius), 0.5, 0.1, 1e-10)
    tcd, tfull, tcm = tls.cauchy_linesearch(tp.data, tit, td, tpen,
                                            torch.tensor(radius, dtype=torch.float64), 0.5, 0.1, 1e-10)
    assert bool(tfull) == bool(jfull)
    np.testing.assert_allclose(float(tcm), float(jcm), rtol=1e-12)
    assert not mismatches(flat_port(tcd), flat_jax(jcd), 1e-12)

    # a Newton-like direction: the working step plus a projected descent step
    jws = jnw.compute_working_step(jp.data, it, aug, jnp.asarray(radius))
    nstep = np.asarray(jws.step) - 0.5 * radius * np.asarray(jkkt.project_nullspace(aug, it.obj_grad))
    jn = jme.make_direction(it, jnp.asarray(nstep), jhp(jnp.asarray(nstep)))
    tn = tme.make_direction(tit, torch.as_tensor(nstep), thp(torch.as_tensor(nstep)))
    for cutoff in (1e-6, 0.9):
        jt, ja, jm = jls.trial_linesearch(jp.data, it, jcd, jcm, jn, jpen, 0.5, 1e-4, cutoff)
        tt, ta, tm = tls.trial_linesearch(tp.data, tit, tcd, tcm, tn, tpen, 0.5, 1e-4, cutoff)
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(tm), float(jm), rtol=1e-12)
        assert not mismatches(flat_port(tt), flat_jax(jt), 1e-12)
        jt, ja, jm = jls.trial_linesearch_exact(jp.data, it, jcd, jcm, jn, jpen, cutoff)
        tt, ta, tm = tls.trial_linesearch_exact(tp.data, tit, tcd, tcm, tn, tpen, cutoff)
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(tm), float(jm), rtol=1e-12)
    lb, ub = tp.data.var_lb, tp.data.var_ub
    np.testing.assert_allclose(
        float(tls.max_step_length(tit.x, torch.as_tensor(nstep), lb, ub)),
        float(jls.max_step_length(it.x, jnp.asarray(nstep), jp.data.var_lb, jp.data.var_ub)),
        rtol=1e-14)
