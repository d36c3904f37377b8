"""The batched-inverse CUDA kernels (``kernels/csrc/bgj.cu``) run on the CPU
through ``tools/emulate_thomas.py`` and held against their plain versions.

The emulation compiles the kernels' device code with g++ (C++20,
AddressSanitizer) and runs each CUDA thread as a ``std::thread``, with
shared memory filled with NaN and warp and named barriers as real barriers:
it is the one check of ``bgj.cu`` that runs without a card, so an index
error, a read of shared memory nothing wrote or a missing barrier shows
here (``bgj_blocked64``'s leaves also take the Gauss-Jordan's warp-held
path, whose pivot row comes by shuffles). Each kernel's inverses must equal, bit for bit, the tool's
index-order reference: ``bgj_flat_plain``'s sweeps with each update one
correctly rounded FMA (``ordered_flat_inverses``), and
``bgj_blocked64_plain``'s two Schur levels with each product one FMA chain
in index order over such leaves (``ordered_blocked64``), which no host's
BLAS decides. Both agree with the plain versions to 1e-6 relative (their
products may sum in another order). Skips where g++ lacks C++20.
"""

import pytest

from torch_parity import emulated_kernels, no_jax_cache_writes  # noqa: F401
from torch_parity import emulation as emu


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    """The emulation of bgj.cu, built once: (executable, work dir)."""
    return emulated_kernels("bgj", tmp_path_factory)


# tiny, ragged and full blocks at the padded width 32 (the main path's
# k = 32), and a ragged block at the padded width 96
@pytest.mark.parametrize("B,k", [(3, 3), (2, 17), (3, 32), (1, 77)])
def test_bgj_flat_matches_plain_version_in_emulation(emulator, B, k):
    exe, tmp = emulator
    same, err = emu.bgj_case(exe, tmp, B, k)
    assert same
    assert err <= emu.TOL


def test_bgj_blocked64_matches_plain_version_in_emulation(emulator):
    exe, tmp = emulator
    same, err = emu.bgj_case(exe, tmp, 2, 64, blocked=1)
    assert same
    assert err <= emu.TOL
