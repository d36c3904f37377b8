"""Where the Cholesky block-Thomas kernels spend one stage, in cycles.

    python3 tools/chol_thomas_probe.py

Needs a CUDA device and nvcc; exits 2 without a device. Builds a copy of
``sleqp_tpu_torch/kernels/csrc/chol_thomas.cu`` in which thread 0 of block 0
records ``clock64()`` at the phase boundaries of one stage (stage 50 of the
factorization; step 50, a forward stage, and step 200, a backward stage, of
the solve), runs both kernels once at the structured-KKT shape
(P, c, k, r) = (1, 160, 64, 1), checks them against their plain versions,
and prints one JSON object: the kernels' times by CUDA events, the cycles
of each phase, and the latency of a few dependent instruction chains of one
warp (FFMA, SHFL, LDS, MUFU.RSQ, division), measured the same way. The
copy lives in a temporary directory; the repository is not written.
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

CSRC = os.path.join(ROOT, "sleqp_tpu_torch", "kernels", "csrc")
FACTOR_STAGE, SOLVE_STEPS = 50, (50, 200)

LATENCY_CU = r"""
#include <cuda_runtime.h>
__global__ void chain(float* out, long long* cyc, int n, int kind) {
  __shared__ float s[1024];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) s[i] = __int_as_float((i * 33 + 7) & 1023);
  __syncwarp();
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
  } else {
#pragma unroll 16
    for (int i = 0; i < n; ++i) v = 1.0f / (v + 1.0f);
  }
  const long long t1 = clock64();
  out[lane] = v + idx;
  if (lane == 0) *cyc = t1 - t0;
}
extern "C" int chain_launch(float* out, long long* cyc, int n, int kind) {
  chain<<<1, 32>>>(out, cyc, n, kind);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
# cycles of one dependent step, less the FADD (4.5 cycles) where the chain needs one
LATENCY_KINDS = (("FFMA", 0.0), ("SHFL", 0.0), ("LDS", 0.0), ("MUFU.RSQ", 4.5), ("division", 4.5))


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"probe: expected {count} of {old!r} in chol_thomas.cu")
    return src.replace(old, new)


def probed_source() -> str:
    """chol_thomas.cu with clock64() probes; raises if the source no
    longer has the lines the probes go beside."""
    s = open(os.path.join(CSRC, "chol_thomas.cu")).read()
    s = _sub(s, "namespace {\n", "__device__ long long g_probe[64];\n"
             "#define PROBE(cond, idx) if (threadIdx.x == 0 && blockIdx.x == 0 && (cond)) "
             "g_probe[idx] = clock64();\nnamespace {\n")
    # factorization, stage FACTOR_STAGE: 0 top barrier, 1 Z, 2 Z Z^T,
    # 3 Cholesky, 4 writing the factor out
    f = f"i == {FACTOR_STAGE}"
    s = _sub(s, "    copy_async_wait();\n    __syncthreads();\n    // with prefetch",
             f"    copy_async_wait();\n    __syncthreads();\n    PROBE({f}, 0);\n    // with prefetch")
    s = _sub(s, "      // C_i = D_i - Z Z^T", f"      PROBE({f}, 1);\n      // C_i = D_i - Z Z^T")
    s = _sub(s, "    cholesky_blocked<NT>(C, ld, k, lane, warp);",
             f"    PROBE({f}, 2);\n    cholesky_blocked<NT>(C, ld, k, lane, warp);\n    PROBE({f}, 3);")
    wrote = "        if (b == a) Rs[(i % nd) * kMaxK + a] = 1.0f / v;\n      }\n    }\n"
    s = _sub(s, wrote, wrote + f"    PROBE({f}, 4);\n")
    # solve, steps SOLVE_STEPS: 0 top barrier, 1 issue, 2 coupling product,
    # 3 forward substitution, 4 backward substitution, 5 writing x
    a, b = SOLVE_STEPS

    def probe(j):
        return f"PROBE(n == {a} || n == {b}, (n == {a} ? 10 : 20) + {j});"

    s = _sub(s, "    copy_async_wait();\n    __syncthreads();\n    // the other slot",
             f"    copy_async_wait();\n    {probe(0)}\n    __syncthreads();\n    {probe(1)}\n"
             "    // the other slot")
    s = _sub(s, "    const float* G = smem + sl * slot;", f"    {probe(2)}\n    const float* G = smem + sl * slot;")
    s = _sub(s, "      forward_subst<NT>(y, G, ld, lane, rinv);\n      backward_subst<NT>(y, G, ld, lane, rinv);",
             f"      {probe(3)}\n      forward_subst<NT>(y, G, ld, lane, rinv);\n      {probe(4)}\n"
             f"      backward_subst<NT>(y, G, ld, lane, rinv);\n      {probe(5)}")
    s = _sub(s, "    if (nbuf == 1) __syncthreads();  // every warp",
             f"    {probe(6)}\n    if (nbuf == 1) __syncthreads();  // every warp")
    s = _sub(s, 'extern "C" {\n', 'extern "C" {\nint probe_read(long long* out) {\n'
             "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));\n}\n")
    return _sub(s, '#include "gj.cuh"', f'#include "{os.path.join(CSRC, "gj.cuh")}"')


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


def main():
    if not torch.cuda.is_available():
        print("chol_thomas_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    P, c, k, r = 1, 160, 64, 1
    rng = np.random.default_rng(P + c + k)  # chip_smoke.py's inputs for this shape
    A = rng.standard_normal((P, c, k, k))
    D = A @ np.swapaxes(A, -1, -2) + 2 * k * np.eye(k)
    Lp = 0.3 * rng.standard_normal((P, c, k, k))
    Lp[:, 0] = 0.0
    b = rng.standard_normal((P, c, k, r))
    D, Lp, b = (torch.tensor(x, dtype=torch.float32, device="cuda") for x in (D, Lp, b))
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(probed_source(), tmp, "chol_probe")
        P_, I_ = ctypes.c_void_p, ctypes.c_int
        lib.chol_thomas_factor_launch.argtypes = [P_, P_, P_, I_, I_, I_, P_]
        lib.chol_thomas_solve_launch.argtypes = [P_, P_, P_, P_, I_, I_, I_, I_, P_]
        lib.probe_read.argtypes = [P_]
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
        t = (ctypes.c_longlong * 64)()
        _build.check_launch(lib.probe_read(ctypes.addressof(t)), "probe read")
        out[f"factor_stage_{FACTOR_STAGE}_cycles"] = dict(zip(
            ("Z", "Z Z^T", "Cholesky", "write factor"), [t[j + 1] - t[j] for j in range(4)]))
        names = ("barrier", "issue copies", "coupling product", "forward subst", "backward subst",
                 "write x")
        for base, step in zip((10, 20), SOLVE_STEPS):
            out[f"solve_step_{step}_cycles"] = dict(zip(names, [t[base + j + 1] - t[base + j] for j in range(6)]))

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
