"""The streaming block-Thomas CUDA kernels (``kernels/csrc/thomas.cu``) run on
the CPU through ``tools/emulate_thomas.py`` and held against their plain
versions.

The emulation compiles the kernels' device code with g++ (C++20,
AddressSanitizer), runs each CUDA thread as a ``std::thread`` with shared
memory filled with NaN, and treats ``cp.async`` as a plain copy. It is the
one check of the CUDA source that runs without a card: an index error, a read
of shared memory nothing wrote, or a missing barrier shows here. Each kernel
gets the plain versions' inputs: the inverses M must equal, bit for bit, the
tool's ``ordered_inverses``, ``thomas_fwd_plain``'s arithmetic with each
coupling product one FMA chain in index order and each update one
correctly rounded FMA (the kernel's Gauss-Jordan and products repeat it),
which no host's BLAS decides; M, y and x agree
with the plain versions to 1e-6 relative (their sums may run in another
order). Skips where g++ lacks C++20.
"""

import pytest

from torch_parity import emulated_kernels, no_jax_cache_writes  # noqa: F401
from torch_parity import emulation as emu


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    """The emulation of thomas.cu, built once: (executable, work dir)."""
    return emulated_kernels("thomas", tmp_path_factory)


# (N, k, r, stage slots; 0: as many as the launcher takes): a padded width
# of 32 with tiny blocks, ragged blocks and right-hand sides (copied by
# cp.async) through a ring of two slots, the full width of 64, and the copy
# engine's path through a ring of two slots that wraps
@pytest.mark.parametrize("N,k,r,nb", [(3, 3, 1, 0), (4, 17, 5, 2), (2, 64, 1, 0), (3, 64, 1, 2)])
def test_thomas_kernels_match_plain_versions_in_emulation(emulator, N, k, r, nb):
    exe, tmp = emulator
    same_m, e_m, e_y, e_resolve, e_x = emu.thomas_case(exe, tmp, N, k, r, nb)
    assert same_m
    assert e_m <= emu.TOL
    assert e_y <= emu.TOL
    assert e_resolve <= emu.TOL
    assert e_x <= emu.TOL
