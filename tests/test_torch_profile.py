"""Port parity of the iteration profile (sleqp_tpu_torch/profile.py)
against sleqp_tpu/profile.py on tests/test_profile.py's two cases: the
same component keys as the reference's, each a non-negative time, the
full iteration a positive one; no Cauchy LP without constraints.  A CUDA
device is the default, so without one the profile raises."""

import jax.numpy as jnp
import pytest
import torch

import torch_dense
from sleqp_tpu.profile import profile_iteration as jax_profile_iteration
from sleqp_tpu_torch.profile import print_profile, profile_iteration
from torch_parity import no_jax_cache_writes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEYS = {"func_eval(all)", "cauchy_lp", "kkt_factorization", "kkt_substitution",
        "working_step", "eqp_solve", "full_iteration"}


@pytest.mark.parametrize("name", ["hs71", "rosenbrock"])
def test_profile_matches_jax_keys(name, capsys, monkeypatch):
    jp, tp, x0 = getattr(torch_dense, name)()
    ref = jax_profile_iteration(jp, jnp.asarray(x0), reps=1)
    results = profile_iteration(tp, x0, reps=1, device="cpu")
    assert list(results) == list(ref)
    if name == "hs71":
        assert set(results) >= KEYS
    else:
        assert "cauchy_lp" not in results and set(results) == KEYS - {"cauchy_lp"}
    assert all(v >= 0.0 for v in results.values()) and results["full_iteration"] > 0.0
    print_profile(results)
    assert "full_iteration" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_iteration(tp, x0, reps=1)
