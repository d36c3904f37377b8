"""The large-n problems of ``chip_smoke.py`` phases 12 and 13, through the
JAX package and the port on the CPU.

* ``banded``: ``bench.py``'s banded problem (``bench.py:441-460``: N = 160
  blocks of k = 64, q = 16, ``default_rng(0)``, n = 10 240) through
  ``banded_solve`` on the float64 and the mixed route;
* ``cauchy``: ``tests/test_banded.py::test_banded_cauchy_extraction_large``'s
  problem (N_b = 160, k = 64, q = 8, ``default_rng(1)``) through
  ``banded_cauchy`` at X = 0, radius 0.5, penalty 100;
* ``sparse``: ``tests/test_sparse.py::_scattered_problem`` at n = 5e4
  (m = 5000, seed 3) through ``sparse_solve`` on both routes.

Prints one line per package and case: status, iterations (PDHG iterations
for ``cauchy``), residuals and seconds (JAX's include its compilation).
Usage, from the repository root:

    python3 tools/large_reference.py banded cauchy sparse
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import sleqp_tpu as jx  # noqa: E402
import sleqp_tpu_torch as tx  # noqa: E402
from sleqp_tpu import banded as jb  # noqa: E402
from sleqp_tpu import sparse as jsp  # noqa: E402
from sleqp_tpu_torch import banded as tb  # noqa: E402

ROUTES = {"float64": "same", "mixed": "float32"}


def banded_pair(N=160, k=64, q=16):
    rng = np.random.default_rng(0)
    W = rng.standard_normal((N, k)) * 0.5
    S = rng.standard_normal((N - 1, q, k)) * 0.3
    jW, jS, tW, tS = jnp.asarray(W), jnp.asarray(S), torch.as_tensor(W), torch.as_tensor(S)
    bounds = dict(var_lb=-2.0, var_ub=2.0, cons_lb=-0.3, cons_ub=0.3)
    jp = jb.BandedProblem(lambda x, t: jnp.sum((x - jW[t]) ** 2) + 0.1 * jnp.sum(jnp.cos(x)), N, k,
                          cons_block=lambda a, b, t: jS[t] @ (b - a) + 0.05 * (jS[t] @ a) ** 2,
                          cons_per_block=q, **bounds)

    def tcons(a, b, t):
        St = tS.to(a)[t]
        return St @ (b - a) + 0.05 * (St @ a) ** 2

    tp = tb.BandedProblem(lambda x, t: torch.sum((x - tW.to(x)[t]) ** 2)
                          + 0.1 * torch.sum(torch.cos(x)), N, k, cons_block=tcons,
                          cons_per_block=q, device="cpu", **bounds)
    return jp, tp


def cauchy_pair(N=160, k=64, q=8):
    W = np.random.default_rng(1).standard_normal((N, k)) * 2.0
    jW, tW = jnp.asarray(W), torch.as_tensor(W)
    bounds = dict(var_lb=-1.0, var_ub=1.0, cons_lb=-0.1, cons_ub=0.1)
    jp = jb.BandedProblem(lambda x, t: jnp.sum((x - jW[t]) ** 2), N, k,
                          cons_block=lambda a, b, t: (b - a)[:q], cons_per_block=q, **bounds)
    tp = tb.BandedProblem(lambda x, t: torch.sum((x - tW.to(x)[t]) ** 2), N, k,
                          cons_block=lambda a, b, t: (b - a)[:q], cons_per_block=q,
                          device="cpu", **bounds)
    return jp, tp


def scattered_pair(n=50_000, seed=3):
    m = n // 10
    rng = np.random.default_rng(seed)
    i_idx, j_idx = rng.integers(0, n, m), rng.integers(0, n, m)
    w, tgt = rng.uniform(0.5, 1.5, n), rng.uniform(-2.0, 2.0, n)
    kw = dict(num_variables=n, num_cons=m, var_lb=-3.0, var_ub=3.0, cons_lb=-0.5, cons_ub=0.5)
    ji, jj, jw, jt = (jnp.asarray(a) for a in (i_idx, j_idx, w, tgt))
    ti, tj, tw, tt = (torch.as_tensor(a) for a in (i_idx, j_idx, w, tgt))
    jp = jsp.SparseProblem(lambda x: 0.5 * jnp.sum(jw * (x - jt) ** 2),
                           cons=lambda x: x[ji] - x[jj], **kw)
    tp = tx.SparseProblem(lambda x: 0.5 * torch.sum(tw.to(x) * (x - tt.to(x)) ** 2),
                          cons=lambda x: x[ti] - x[tj], device="cpu", **kw)
    return jp, tp


def timed(fn):
    """(fn()'s state, seconds), reading the objective to wait for the work."""
    t = time.perf_counter()
    out = fn()
    float(out.obj_val)
    return out, time.perf_counter() - t


def line(case, who, st, seconds):
    extra = f" cg {int(st.cg_iterations)}" if hasattr(st, "cg_iterations") else ""
    print(f"{case} {who}: status {jx.Status(int(st.status)).name} iterations "
          f"{int(st.iteration)}{extra} obj {float(st.obj_val)!r} feas {float(st.feas_res):.3e} "
          f"stat {float(st.stat_res):.3e}; {seconds:.2f} s", flush=True)


def run_banded():
    jp, tp = banded_pair()
    for route, cd in ROUTES.items():
        ref, js = timed(lambda: jb.banded_solve(jp, jx.Settings(compute_dtype=cd),
                                                max_iterations=100))
        line(f"banded {route}", "JAX", ref, js)
        got, ts = timed(lambda: tb.banded_solve(tp, tx.Settings(compute_dtype=cd),
                                                max_iterations=100))
        line(f"banded {route}", "port", got, ts)
        print(f"banded {route}: max |X_port - X_jax| "
              f"{np.abs(got.X.numpy() - np.asarray(ref.X)).max():.3e}", flush=True)


def run_cauchy():
    jp, tp = cauchy_pair()
    X = np.zeros((jp.N_b, jp.k))
    for who, fn in (("JAX", lambda: jb.banded_cauchy(jp, jnp.asarray(X), jnp.asarray(0.5),
                                                     jnp.asarray(100.0), tol=1e-7)),
                    ("port", lambda: tb.banded_cauchy(tp, torch.as_tensor(X), 0.5, 100.0,
                                                      tol=1e-7))):
        t = time.perf_counter()
        d, _, cs, res = fn()
        seconds = time.perf_counter() - t
        print(f"cauchy {who}: state {int(res.state)} iterations {int(res.iterations)} "
              f"active rows {int((np.asarray(cs) != 0).sum())}; {seconds:.2f} s", flush=True)


def run_sparse():
    jp, tp = scattered_pair()
    for route, cd in ROUTES.items():
        ref, js = timed(lambda: jsp.sparse_solve(jp, jx.Settings(compute_dtype=cd),
                                                 max_iterations=100))
        line(f"sparse {route}", "JAX", ref, js)
        got, ts = timed(lambda: tx.sparse_solve(tp, tx.Settings(compute_dtype=cd),
                                                max_iterations=100))
        line(f"sparse {route}", "port", got, ts)


def main(argv):
    runs = {"banded": run_banded, "cauchy": run_cauchy, "sparse": run_sparse}
    for name in argv or list(runs):
        runs[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
