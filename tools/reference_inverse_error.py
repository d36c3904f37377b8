"""Identity error of the reference's float32 batched inverses on the inputs
that chip_smoke.py and tests/test_torch_cyclic_reduction.py give the port's
blocked 64 x 64 inverse.

    python3 tools/reference_inverse_error.py

Runs on the CPU, with sleqp_tpu's Pallas kernels in interpret mode (the
reference arithmetic). For each input set (SPD blocks C C^T + 2k I made
from numpy's default_rng(seed), as chip_smoke.spd_blocks and the test build
them; the inverses take them in float32) it prints the max-abs identity
error max |M C - I|, computed in float64 against C as the script or test
that uses the set holds it (chip_smoke.py: C in float32; the test: C in
float64), of:

- ``blocked``: ``batched_gj_inverse`` at k = 64, the two-level Schur
  kernel (``_bgj_blocked_kernel``) that the port's ``bgj_blocked64`` keeps;
- ``flat``: the flat Gauss-Jordan sweep (``_bgj_kernel``) on the same blocks;
- ``rounded``: the float64 inverse of the float32 blocks, rounded to
  float32 (the floor of any float32-stored inverse).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (label, B, k, seed, dtype of C in the identity error): chip_smoke.py
# phase 2 seeds with B + k, the port's parity test with B * 100 + k
INPUTS = [
    ("chip_smoke.py phase 2", 1561, 64, 1561 + 64, np.float32),
    ("test_batched_gj_inverse_matches_jax[6-64]", 6, 64, 6 * 100 + 64, np.float64),
]


def spd_blocks(B, k, seed):
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((B, k, k))
    return np.einsum("bij,bkj->bik", C, C) + 2 * k * np.eye(k)


def identity_error(M, C):
    k = C.shape[-1]
    return float(np.abs(M.astype(np.float64) @ C.astype(np.float64) - np.eye(k)).max())


def main():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from sleqp_tpu.ops import cyclic_reduction as jcr

    jax.config.update("jax_platforms", "cpu")

    def flat(C):
        return pl.pallas_call(
            jcr._bgj_kernel,
            out_shape=jax.ShapeDtypeStruct(C.shape, jnp.float32),
            interpret=True,
        )(C)

    for label, B, k, seed, held in INPUTS:
        C = spd_blocks(B, k, seed).astype(held)
        C32 = jnp.asarray(C, jnp.float32)
        errs = {
            "blocked": identity_error(
                np.asarray(jcr.batched_gj_inverse(C32, interpret=True)), C
            ),
            "flat": identity_error(np.asarray(flat(C32)), C),
            "rounded": identity_error(
                np.linalg.inv(np.asarray(C32, np.float64)).astype(np.float32), C
            ),
        }
        print(
            f"{label} ({B},{k},{k}) seed {seed}: "
            + ", ".join(f"{name} {err:.3e}" for name, err in errs.items()),
            flush=True,
        )


if __name__ == "__main__":
    main()
