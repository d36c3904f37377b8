"""The PDLP Cauchy LPs that ``chip_smoke.py`` phase 9 considered, through
the JAX package and the port on the CPU.

* ``chain``: chainineq's formula and seed (``harness/medium.py``,
  ``default_rng(41)``) at n = 2100 (m = 2099, N = 8397), the LP at x0 = 0,
  LP radius 0.8/sqrt(n), penalty 10 (phase 9's LP);
* ``dense``: ``tests/test_pdlp.py::test_pdlp_large_cauchy_shaped_lp``'s
  family at n = 4096, m = 1366 (N = 8194), as a problem with linear
  objective g.x and constraints J x + c, radius 0.5, penalty 10.

Each through ``solve_cauchy_lp`` under default settings (AUTO routes both
to PDLP), twice for JAX (the first run compiles).  Prints the LP state,
the PDHG iterations and the seconds of each run.  Usage, from the
repository root:

    python3 tools/pdlp_reference.py chain dense
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)

import conftest  # noqa: E402,F401  (JAX on the CPU, float64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import sleqp_tpu as jx  # noqa: E402
import sleqp_tpu.cauchy as jc  # noqa: E402
import sleqp_tpu_torch as tx  # noqa: E402
from sleqp_tpu_torch import cauchy as tc  # noqa: E402


def _data(which):
    """(n, m, obj(x, xp), cons(x, xp), cons bounds, radius): ``xp`` is jnp or
    torch."""
    if which == "chain":
        n = 2100
        t = np.cumsum(np.random.default_rng(41).standard_normal(n)) * 0.2

        def obj(x, lib):
            return 0.5 * lib.sum((x - lib.asarray(t)) ** 2)

        def cons(x, lib):
            return x[1:] - x[:-1]

        return n, n - 1, obj, cons, (-0.05, 0.05), 0.8 / np.sqrt(n)
    n, m = 4096, 1366
    rng = np.random.default_rng(13)
    J = rng.standard_normal((m, n)) / np.sqrt(n)
    g = rng.standard_normal(n)
    cv = rng.standard_normal(m) * 0.1

    def obj(x, lib):
        return lib.asarray(g) @ x

    def cons(x, lib):
        return lib.asarray(J) @ x + lib.asarray(cv)

    return n, m, obj, cons, (-0.2, 0.2), 0.5


def run(which: str) -> None:
    n, m, obj, cons, (lo, hi), radius = _data(which)
    print(f"{which}: n = {n}, m = {m}, N = {n + 3 * m}", flush=True)
    jp = jx.Problem(jx.Func(lambda x: obj(x, jnp), num_variables=n,
                            cons=lambda x: cons(x, jnp), num_cons=m),
                    general_lb=lo, general_ub=hi)
    jit_ = jx.create_iterate(jp, jnp.zeros(n))
    backend = jc.resolved_lp_solver(jx.Settings(), n, m)
    for rep in range(2):
        t = time.perf_counter()
        r = jc.solve_cauchy_lp(jp.data, jit_, jnp.asarray(radius), jnp.asarray(10.0),
                               jc.empty_basis(n, m), lp_solver=backend,
                               pdlp_tol=jx.Settings().pdlp_tol)
        jax.block_until_ready(r.lp_step)
        print(f"  JAX run {rep}: state {int(r.lp_state)}, iterations {int(r.lp_iterations)}, "
              f"{time.perf_counter() - t:.2f} s", flush=True)

    def as_t(v):
        return torch.as_tensor(np.asarray(v), dtype=torch.float64)

    tp = tx.Problem(tx.Func(lambda x: obj(x, _TorchLib(x)), n,
                            cons=lambda x: cons(x, _TorchLib(x)), num_cons=m),
                    general_lb=lo, general_ub=hi, device="cpu")
    it = tx.create_iterate(tp, np.zeros(n))
    t = time.perf_counter()
    r = tc.solve_cauchy_lp(tp.data, it, as_t(radius), as_t(10.0), tc.empty_basis(n, m),
                           lp_solver=tc.resolved_lp_solver(tx.Settings(), n, m),
                           pdlp_tol=tx.Settings().pdlp_tol)
    print(f"  port: state {int(r.lp_state)}, iterations {int(r.lp_iterations)}, "
          f"{time.perf_counter() - t:.2f} s ({torch.get_num_threads()} threads)", flush=True)


class _TorchLib:
    """``sum`` and ``asarray`` in torch, following ``like``'s dtype."""

    def __init__(self, like):
        self.like = like

    def sum(self, v):
        return torch.sum(v)

    def asarray(self, a):
        return torch.as_tensor(a).to(self.like)


if __name__ == "__main__":
    for which in sys.argv[1:] or ["chain"]:
        run(which)
