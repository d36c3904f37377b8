"""Where the block-Thomas kernels spend one stage, in cycles.

    python3 tools/thomas_probe.py

Needs a CUDA device and nvcc; exits 2 without a device. Builds
``sleqp_tpu_torch/kernels/csrc/thomas.cu`` and ``chol_thomas.cu`` with their
``KERNEL_PROBE`` marks defined, so that thread 0 of block 0 records
``clock64()`` at the phase boundaries of one stage, runs each kernel once at
chip_smoke.py's shapes, checks it against its plain version, and prints one
JSON object: the kernels' times by CUDA events, the cycles of each phase, and
the latency of a few dependent instruction chains of one warp (FFMA, SHFL,
LDS, MUFU.RSQ, division) and of a barrier of eight warps, measured the same
way.

- thomas.cu at (N, k, r) = (160, 64, 1) and (1560, 32, 1): stage 50 of
  ``thomas_fwd`` with factor (and the Gauss-Jordan cycles per sweep) and
  without, and step 50 of ``thomas_bwd``;
- chol_thomas.cu at (P, c, k, r) = (1, 160, 64, 1): stage 50 of the
  factorization; step 50, a forward stage, and step 200, a backward stage,
  of the solve.

The builds live in a temporary directory; the repository is not written.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sleqp_tpu_torch.kernels import _build  # noqa: E402
from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc  # noqa: E402
from sleqp_tpu_torch.ops import pallas_tridiag as pt  # noqa: E402

CSRC = os.path.join(ROOT, "sleqp_tpu_torch", "kernels", "csrc")
STAGE = 50  # the probed stage of thomas.cu and of the Cholesky factorization
# the factorization records at SOLVE_STEPS[0] as well
FACTOR_STAGE, SOLVE_STEPS = STAGE, (STAGE, 200)
THOMAS_SHAPES = ((160, 64, 1), (1560, 32, 1))

LATENCY_CU = r"""
#include <cuda_runtime.h>
__global__ void chain(float* out, long long* cyc, int n, int kind) {
  __shared__ float s[1024];
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 1024; i += 32) s[i] = __int_as_float((i * 33 + 7) & 1023);
  __syncthreads();
  float v = out[lane] + 1.0f;
  int idx = lane;
  const long long t0 = clock64();
  if (kind == 0) {
#pragma unroll 16
    for (int i = 0; i < n; ++i) v = fmaf(v, 1.0001f, 0.5f);
  } else if (kind == 1) {
#pragma unroll 16
    for (int i = 0; i < n; ++i) v = __shfl_sync(0xffffffffu, v, (lane + 1) & 31);
  } else if (kind == 2) {
#pragma unroll 16
    for (int i = 0; i < n; ++i) idx = __float_as_int(s[idx]);
  } else if (kind == 3) {
#pragma unroll 16
    for (int i = 0; i < n; ++i) v = rsqrtf(v) + 1.0f;
  } else if (kind == 4) {
#pragma unroll 16
    for (int i = 0; i < n; ++i) v = 1.0f / (v + 1.0f);
  } else {  // a named barrier of 8 warps, as the thomas.cu compute threads use
#pragma unroll 16
    for (int i = 0; i < n; ++i) asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
  const long long t1 = clock64();
  if (threadIdx.x < 32) out[lane] = v + idx;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}
extern "C" int chain_launch(float* out, long long* cyc, int n, int kind) {
  chain<<<1, kind == 5 ? 256 : 32>>>(out, cyc, n, kind);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
# cycles of one dependent step, less the FADD (4.5 cycles) where the chain needs one
LATENCY_KINDS = (("FFMA", 0.0), ("SHFL", 0.0), ("LDS", 0.0), ("MUFU.RSQ", 4.5), ("division", 4.5),
                 ("bar.sync of 8 warps", 0.0))


def probed(name: str, steps) -> str:
    """A source that includes csrc/<name> with its KERNEL_PROBE marks
    defined: thread 0 of block 0 writes clock64() to g_probe[mark] at stage
    steps[0] and to g_probe[32 + mark] at stage steps[1], and probe_read
    copies g_probe out.  The marks are the kernels' own (thomas.cu:
    thomas_fwd mark + 0 with factor, + 10 without: 0 after the top barrier,
    2 v = b - L y, 3 M L^T, 4 C, 5 Gauss-Jordan, 6 barrier, 7 y = M v;
    thomas_bwd 20 after the top barrier, 22 t = L^T x and a barrier, 23
    x = y - M t.  chol_thomas.cu: the factorization 0 top barrier, 1 Z,
    2 Z Z^T, 3 Cholesky, 4 writing the factor out; the solve 10 copies
    waited for, 11 top barrier, 12 issue, 13 coupling product, 14 forward
    substitution, 15 backward substitution, 16 writing x)."""
    return f"""#include <cuda_runtime.h>
__device__ long long g_probe[64];
__device__ __forceinline__ void probe_mark(int step, int mark) {{
  if (threadIdx.x == 0 && blockIdx.x == 0) {{
    if (step == {steps[0]}) g_probe[mark] = clock64();
    if (step == {steps[1]}) g_probe[32 + mark] = clock64();
  }}
}}
#define KERNEL_PROBE(step, mark) probe_mark(step, mark)
#include "{os.path.join(CSRC, name)}"
extern "C" int probe_read(long long* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));
}}
"""


def build(src: str, tmp: str, name: str) -> ctypes.CDLL:
    cu, so = os.path.join(tmp, name + ".cu"), os.path.join(tmp, name + ".so")
    with open(cu, "w") as fh:
        fh.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build._nvcc(), *flags, "-o", so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return ctypes.CDLL(so)


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def inputs(lead, k, r):
    """chip_smoke.py's tridiag_inputs for this shape (its seed)."""
    rng = np.random.default_rng(sum(lead) + k)
    A = rng.standard_normal(lead + (k, k))
    D = A @ np.swapaxes(A, -1, -2) + 2 * k * np.eye(k)
    Lp = 0.3 * rng.standard_normal(lead + (k, k))
    Lp[..., 0, :, :] = 0.0
    b = rng.standard_normal(lead + (k, r))
    return [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (D, Lp, b)]


def read_probes(lib):
    t = (ctypes.c_longlong * 64)()
    lib.probe_read.argtypes = [ctypes.c_void_p]
    _build.check_launch(lib.probe_read(ctypes.addressof(t)), "probe read")
    return t


def probe_thomas(lib, out):
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.thomas_fwd_launch.argtypes = [P_, P_, P_, P_, P_, I_, I_, I_, I_, P_]
    lib.thomas_bwd_launch.argtypes = [P_, P_, P_, P_, I_, I_, I_, P_]
    stream = torch.cuda.current_stream().cuda_stream
    fwd_names = ("v = b - L y", "M L^T", "C = D - L T1", "Gauss-Jordan", "barrier", "y = M v",
                 "next stage's wait")
    for N, k, r in THOMAS_SHAPES:
        D, Lp, b = inputs((N,), k, r)
        y, M, y2, x = (torch.empty_like(b), torch.empty_like(D), torch.empty_like(b),
                       torch.empty_like(b))

        def fwd(A, out_y, factor):
            _build.check_launch(lib.thomas_fwd_launch(
                A.data_ptr(), Lp.data_ptr(), b.data_ptr(), out_y.data_ptr(),
                M.data_ptr() if factor else None, N, k, r, int(factor), stream), "probe fwd")

        def bwd():
            _build.check_launch(lib.thomas_bwd_launch(
                M.data_ptr(), Lp.data_ptr(), y.data_ptr(), x.data_ptr(), N, k, r, stream),
                "probe bwd")

        rec = {"factor_ms": event_ms(lambda: fwd(D, y, True), 5)}
        t = read_probes(lib)
        cyc = [t[2] - t[0]] + [t[j + 1] - t[j] for j in range(2, 7)] + [t[32] - t[7]]
        rec[f"factor_stage_{STAGE}_cycles"] = dict(zip(fwd_names, cyc))
        rec["gauss_jordan_cycles_per_sweep"] = cyc[3] / k
        rec["resolve_ms"] = event_ms(lambda: fwd(M, y2, False), 20)
        t = read_probes(lib)
        rec[f"resolve_stage_{STAGE}_cycles"] = {
            "v = b - L y": t[12] - t[10], "barrier": t[16] - t[12], "y = M v": t[17] - t[16],
            "next stage's wait": t[42] - t[17]}
        rec["bwd_ms"] = event_ms(bwd, 20)
        t = read_probes(lib)
        rec[f"bwd_step_{STAGE}_cycles"] = {
            "t = L^T x, barrier": t[22] - t[20], "x = y - M t": t[23] - t[22],
            "next step's wait": t[52] - t[23]}
        if N <= 160:  # the plain versions take ~10^5 launches at N = 1560
            y_p, M_p = pt.thomas_fwd_plain(D, Lp, b, True)
            pairs = ((M, M_p), (y, y_p), (y2, pt.thomas_fwd_plain(M_p, Lp, b, False)[0]),
                     (x, pt.thomas_bwd_plain(M_p, Lp, y_p)))
            rec["rel_err"] = [float((u - v).abs().max() / v.abs().max()) for u, v in pairs]
            if max(rec["rel_err"]) > 1e-4:
                raise RuntimeError(f"probed thomas kernels disagree with their plain versions: {rec}")
        out[f"thomas {(N, k, r)}"] = rec


def probe_chol(lib, out):
    P, c, k, r = 1, 160, 64, 1
    D, Lp, b = inputs((P, c), k, r)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.chol_thomas_factor_launch.argtypes = [P_, P_, P_, I_, I_, I_, P_]
    lib.chol_thomas_solve_launch.argtypes = [P_, P_, P_, P_, I_, I_, I_, I_, P_]
    stream = torch.cuda.current_stream().cuda_stream
    ch, x = torch.empty_like(D), torch.empty_like(b)

    def factor():
        _build.check_launch(lib.chol_thomas_factor_launch(
            D.data_ptr(), Lp.data_ptr(), ch.data_ptr(), P, c, k, stream), "probe factor")

    def solve():
        _build.check_launch(lib.chol_thomas_solve_launch(
            ch.data_ptr(), Lp.data_ptr(), b.data_ptr(), x.data_ptr(), P, c, k, r, stream),
            "probe solve")

    out["factor_ms"], out["solve_ms"] = event_ms(factor, 5), event_ms(solve, 10)
    ch_p = pc.chol_thomas_factor_plain(D, Lp)
    x_p = pc.chol_thomas_solve_plain(ch_p, Lp, b)
    out["rel_err"] = [float((u - v).abs().max() / v.abs().max()) for u, v in ((ch, ch_p), (x, x_p))]
    if max(out["rel_err"]) > 1e-4:
        raise RuntimeError(f"probed kernels disagree with their plain versions: {out['rel_err']}")
    t = read_probes(lib)
    out[f"factor_stage_{FACTOR_STAGE}_cycles"] = dict(zip(
        ("Z", "Z Z^T", "Cholesky", "write factor"), [t[j + 1] - t[j] for j in range(4)]))
    names = ("barrier", "issue copies", "coupling product", "forward subst", "backward subst",
             "write x")
    for base, step in zip((10, 42), SOLVE_STEPS):
        out[f"solve_step_{step}_cycles"] = dict(zip(names, [t[base + j + 1] - t[base + j] for j in range(6)]))


def main():
    if not torch.cuda.is_available():
        print("thomas_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}
    with tempfile.TemporaryDirectory() as tmp:
        probe_thomas(build(probed("thomas.cu", (STAGE, STAGE + 1)), tmp, "thomas_probe"), out)
        out["chol_thomas (1, 160, 64, 1)"] = chol = {}
        probe_chol(build(probed("chol_thomas.cu", SOLVE_STEPS), tmp, "chol_probe"), chol)
        lat = build(LATENCY_CU, tmp, "latency")
        o = torch.zeros(32, device="cuda")
        cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
        n = 4096
        out["latency_cycles"] = {}
        for kind, (name, fadd) in enumerate(LATENCY_KINDS):
            for _ in range(2):  # the second run is warm
                _build.check_launch(lat.chain_launch(ctypes.c_void_p(o.data_ptr()),
                                                     ctypes.c_void_p(cyc.data_ptr()), n, kind), name)
            out["latency_cycles"][name] = int(cyc.item()) / n - fadd
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
