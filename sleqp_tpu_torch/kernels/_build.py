"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  They are compiled by
one ``nvcc`` call into one shared library, which is loaded with ``ctypes``: no
PyTorch headers, so the build takes seconds.  The library goes into
``_build/`` beside this file, named by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is not.  The build runs at
the first launch of a kernel, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
SOURCES = tuple(_HERE / "csrc" / name for name in ("bgj.cu", "thomas.cu", "chol_thomas.cu"))
HEADERS = tuple(_HERE / "csrc" / name for name in ("gj.cuh", "staging.cuh"))
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C signatures of the launchers in csrc/*.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bgj_flat_max_k": ([], _I),
    "bgj_flat_launch": ([_P, _P, _I, _I, _P], _I),
    "bgj_blocked64_launch": ([_P, _P, _I, _P], _I),
    "bgj_error_string": ([_I], ctypes.c_char_p),
    "thomas_fwd_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "thomas_bwd_launch": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "chol_thomas_factor_launch": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "chol_thomas_solve_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).is_file():
        raise RuntimeError(
            "nvcc not found (looked in CUDA_HOME, CUDA_PATH, PATH and "
            "/usr/local/cuda/bin); the CUDA kernels cannot be built"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsleqp_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its
    path.  Raises ``RuntimeError`` with nvcc's output when nvcc fails.
    nvcc's output (``-Xptxas -v``: registers and shared memory per kernel)
    is kept beside the library as ``.log``."""
    lib = library_path()
    if lib.is_file():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile under a temporary name and rename, so that a concurrent build
    # or an interrupted one never leaves a half-written library behind
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}{proc.stdout}"
            )
        lib.with_suffix(".log").write_text(proc.stderr + proc.stdout)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C signatures set."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check_launch(code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = load().bgj_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")


def require_full_fp32() -> None:
    """Float32 products in full float32: no TF32 in cuBLAS or cuDNN.

    The Schur-level products of the blocked inverse and the cyclic-reduction
    refinement need true float32 (the reference forces
    ``Precision.HIGHEST`` there)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError("TF32 is still enabled; float32 products must be full float32")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw cudaStream_t."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_operand(t: torch.Tensor, dims: int, name: str, what: str) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``dims`` axes."""
    if t.dim() != dims:
        raise ValueError(f"{name}: expected {what}, got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def check_chain(name: str, blocks: dict, rhs: torch.Tensor | None = None) -> None:
    """Raise unless a recursion's operands agree: every block operand
    (label -> (..., k, k) tensor) has the first one's shape, square blocks,
    and the right-hand sides ``rhs`` (..., k, r) the same leading dimensions
    and k; all on one device.  A kernel takes raw pointers and sizes from
    one operand, so a mismatch would read past another's allocation."""
    (first, ref), *rest = blocks.items()
    shape = tuple(ref.shape)
    if shape[-1] != shape[-2]:
        raise ValueError(f"{name}: {first} blocks are not square: {shape}")
    operands = [(label, t, shape) for label, t in rest]
    if rhs is not None:
        operands.append(("the right-hand sides", rhs, shape[:-1] + (rhs.shape[-1],)))
    for label, t, want in operands:
        if tuple(t.shape) != want:
            raise ValueError(
                f"{name}: {label} is {tuple(t.shape)}, expected {want} to match {first} {shape}"
            )
        if t.device != ref.device:
            raise ValueError(f"{name}: {label} is on {t.device}, {first} on {ref.device}")


def rhs_tiles(b: torch.Tensor, cols: int) -> list:
    """b (..., k, r) as contiguous tiles of at most ``cols`` columns, for a
    kernel that keeps its right-hand sides in shared memory."""
    return [t.contiguous() for t in torch.split(b, cols, dim=-1)]


def join_tiles(tiles: list) -> torch.Tensor:
    """The tiles of ``rhs_tiles`` side by side again."""
    return tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim=-1)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """A tensor's device address, for a launcher's pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def runs_kernel(t: torch.Tensor, name: str) -> bool:
    """Where a wrapper sends ``t``: False for a CPU tensor (the kernel's
    plain version), True for a CUDA tensor (the kernel, with TF32 off).
    Raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    require_full_fp32()
    return True
