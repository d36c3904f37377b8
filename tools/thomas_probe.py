"""Where the port's kernels spend their time, in cycles.

    python3 tools/thomas_probe.py [bgj] [thomas] [chol] [times] [--root DIR]

Needs a CUDA device and nvcc; exits 2 without a device. Builds
``sleqp_tpu_torch/kernels/csrc/bgj.cu``, ``thomas.cu`` and ``chol_thomas.cu``
(those named, all by default) with their ``KERNEL_PROBE`` marks defined, so
that thread 0 of block 0 records ``clock64()`` at the phase boundaries of one
stage (of one matrix for bgj.cu), runs each kernel at chip_smoke.py's
shapes, checks it against its plain version, and prints one JSON object:
the kernels' times by CUDA events, the cycles of each phase, the latency of
a few dependent instruction chains of one warp (FFMA, SHFL, LDS, MUFU.RSQ,
division) and of a barrier of eight warps, measured the same way, and the
SM's rate of 16-byte shared loads by the distinct addresses a quarter warp
reads (bgj_blocked64's products are loads and FMAs).

- bgj.cu: ``bgj_flat`` at (B, k) = (781, 32) and (1, 32) in the launcher's
  layout (four warps a matrix) and, for comparison, in two layouts this tool
  defines over the same Gauss-Jordan (``gj.cuh``): one and two warps a
  matrix; cycles per Gauss-Jordan sweep; and
  ``bgj_blocked64`` at (1561, 64) and (1, 64), cycles per phase of block 0's
  matrix. Times by CUDA events around a CUDA graph of 50 launches, so the
  host's launch rate does not hide a kernel of a few microseconds;
- thomas.cu at (N, k, r) = (160, 64, 1) and (1560, 32, 1): stage 50 of
  ``thomas_fwd`` with factor (and the Gauss-Jordan cycles per sweep) and
  without, and step 50 of ``thomas_bwd``;
- chol_thomas.cu at (P, c, k, r) = (1, 160, 64, 1): stage 50 of the
  factorization; step 50, a forward stage, and step 200, a backward stage,
  of the solve.

``times`` (only when named) times ``bgj_flat`` and ``bgj_blocked64`` through
the package's wrappers at every batch the main paths launch them on (as
chip_smoke.py: B1 at the 11 levels of one cyclic reduction at n = 1560,
k = 32; B2 at (1561, 64) and at cr32's 8 levels at N = 160) by two timers:
CUDA events around a CUDA graph of 20 calls (the kernel's own time), and
around 20 calls launched back to back from the host (the wrapper's Python
included where it is longer than the kernel). ``--root DIR`` takes the
package and the sources from the checkout DIR instead of this one, so that
one call can time a parent commit's kernels by the same code:

    python3 tools/thomas_probe.py times --root .parent_checkout

The builds live in a temporary directory (``times``: the package's own
build directory); the repository is not written otherwise.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch



def _root(argv):
    """The checkout probed: ``--root DIR`` (taken out of argv), else this one."""
    if "--root" in argv:
        i = argv.index("--root")
        root = os.path.abspath(argv[i + 1])
        del argv[i:i + 2]
        return root
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


ROOT = _root(sys.argv)
sys.path.insert(0, ROOT)

from sleqp_tpu_torch.kernels import _build  # noqa: E402
from sleqp_tpu_torch.ops import cyclic_reduction as cr  # noqa: E402
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
// the rate of 16-byte shared loads: one 1024-thread block an SM, each lane
// at offset lane_off[lane] (16-byte units) of one of eight rows
__global__ void lds_rate(const int* lane_off, float* out, long long* cyc, int n) {
  __shared__ float4 s[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s[i] = make_float4(i, 1, 2, 3);
  __syncthreads();
  const int idx = lane_off[threadIdx.x & 31];
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(s));
  float4 acc = make_float4(0, 0, 0, 0);
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    float4 v;
    const unsigned a = base + 16u * ((idx + (i & 7) * 72) & 1023);
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
    acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
  }
  __syncthreads();
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
}
extern "C" int lds_rate_launch(const int* lane_off, float* out, long long* cyc, int n) {
  lds_rate<<<132, 1024>>>(lane_off, out, cyc, n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
# lane -> 16-byte offset of the LDS.128 rate patterns: d distinct addresses
# a quarter warp, rows 9 pieces apart (a leading dimension of 36 floats, as
# bgj.cu's outer views)
LDS_PATTERNS = {f"{d} distinct a quarter warp": [9 * (lane % d) for lane in range(32)]
                for d in (8, 4, 2)}
LDS_PATTERNS["1 distinct a quarter warp"] = [lane // 8 for lane in range(32)]
# cycles of one dependent step, less the FADD (4.5 cycles) where the chain needs one
LATENCY_KINDS = (("FFMA", 0.0), ("SHFL", 0.0), ("LDS", 0.0), ("MUFU.RSQ", 4.5), ("division", 4.5),
                 ("bar.sync of 8 warps", 0.0))


# bgj_flat at kp = 32 in each layout, `rows` rows of one column a thread:
# 8 is the launcher's (four warps a matrix); 16 and 32 are bgj_flat_kernel's
# body at two warps and one warp a matrix (one warp syncs by __syncwarp)
BGJ_LAYOUT_CU = r"""
template <int G>
__global__ void __launch_bounds__(G * 32)
flat_layout_kernel(const float* __restrict__ C, float* __restrict__ M, int k) {
  constexpr int RPT = 32 / G;
  float* R = reinterpret_cast<float*>(dynamic_smem());
  float* F = R + 64;
  const int c = threadIdx.x % 32, r0 = RPT * (threadIdx.x / 32);
  const size_t off = static_cast<size_t>(blockIdx.x) * k * k;
  float w[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int a = r0 + u;
    w[u] = a < k && c < k ? C[off + a * k + c] : (a == c ? 1.0f : 0.0f);
  }
  KERNEL_PROBE(0, 0);
  if constexpr (G == 1) {
    gauss_jordan<32, RPT>(w, k, R, F, c, r0, WarpSync{});
  } else {
    gauss_jordan<32, RPT>(w, k, R, F, c, r0, BlockSync{});
  }
  KERNEL_PROBE(0, 1);
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int a = r0 + u;
    if (a < k && c < k) M[off + a * k + c] = w[u];
  }
}
extern "C" int bgj_flat_rows_launch(const float* C, float* M, int batch, int k, int rows,
                                    cudaStream_t stream) {
  const size_t smem = 4 * 32 * sizeof(float);
  if (rows == 8) return bgj_flat_launch(C, M, batch, k, stream);
  if (rows == 16) flat_layout_kernel<2><<<batch, 64, smem, stream>>>(C, M, k);
  if (rows == 32) flat_layout_kernel<1><<<batch, 32, smem, stream>>>(C, M, k);
  return static_cast<int>(cudaGetLastError());
}
"""
BGJ_FLAT_ROWS = {32: "one warp a matrix", 16: "two warps a matrix", 8: "four warps a matrix"}
BGJ_FLAT_SHAPES = ((781, 32), (1, 32))
BGJ_BLOCKED_SHAPES = ((1561, 64), (1, 64))
# bgj_blocked64's marks (bgj.cu): 0 start, 1 input loaded, 2-7 and 10-15 the
# phases of inverse32 (leaf, W' V', S', leaf, V'Si' and Si'W', TL'), 8 W and
# V, 9 S, 16 V Si, Si W and the copy of Si, 17 Ai + (V Si) W
BGJ_INNER = ("leaf A'", "W' V'", "S'", "leaf S'", "V'Si' Si'W'", "Ai' + V'Si'W'")
BGJ_PHASES = (("load input", 0, 1),) + tuple(
    (f"inverse32(A) {n}", 1 + i, 2 + i) for i, n in enumerate(BGJ_INNER)) + (
    ("W = Bm^T Ai, V = Ai Bm", 7, 8), ("S = D - W Bm", 8, 9)) + tuple(
    (f"inverse32(S) {n}", 9 + i, 10 + i) for i, n in enumerate(BGJ_INNER)) + (
    ("V Si, Si W, copy Si", 15, 16), ("Ai + (V Si) W", 16, 17))


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


def graph_ms(fn, reps=50):
    """Device time of one fn() by CUDA events around a CUDA graph of
    ``reps`` calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def spd_blocks(B, k):
    """chip_smoke.py's spd_blocks for this shape (its seed)."""
    rng = np.random.default_rng(B + k)
    C = rng.standard_normal((B, k, k))
    C = np.einsum("bij,bkj->bik", C, C) + 2 * k * np.eye(k)
    return torch.tensor(C, dtype=torch.float32, device="cuda")


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


def probe_bgj(lib, out):
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.bgj_flat_rows_launch.argtypes = [P_, P_, I_, I_, I_, P_]
    lib.bgj_blocked64_launch.argtypes = [P_, P_, I_, P_]

    def check(M, plain, what):
        err = float((M - plain).abs().max() / plain.abs().max())
        if err > 1e-4:
            raise RuntimeError(f"probed {what} disagrees with its plain version: {err:.3e}")
        return err

    for B, k in BGJ_FLAT_SHAPES:
        C = spd_blocks(B, k)
        M = torch.empty_like(C)
        plain = cr.bgj_flat_plain(C)
        for rows, layout in BGJ_FLAT_ROWS.items():
            def run(rows=rows):
                stream = torch.cuda.current_stream().cuda_stream
                _build.check_launch(lib.bgj_flat_rows_launch(C.data_ptr(), M.data_ptr(), B, k, rows,
                                                             stream), "probe flat")

            ms = graph_ms(run)
            t = read_probes(lib)
            out[f"bgj_flat {(B, k, k)} {layout}"] = {
                "ms": ms, "gauss_jordan_cycles_per_sweep": (t[1] - t[0]) / k,
                "rel_err": check(M, plain, "bgj_flat")}
    for B, k in BGJ_BLOCKED_SHAPES:
        C = spd_blocks(B, k)
        M = torch.empty_like(C)

        def run():
            stream = torch.cuda.current_stream().cuda_stream
            _build.check_launch(lib.bgj_blocked64_launch(C.data_ptr(), M.data_ptr(), B, stream),
                                "probe blocked")

        ms = graph_ms(run)
        t = read_probes(lib)
        out[f"bgj_blocked64 {(B, k, k)}"] = {
            "ms": ms, "cycles": t[17] - t[0],
            "cycles_per_phase": {name: t[b] - t[a] for name, a, b in BGJ_PHASES},
            "rel_err": check(M, cr.bgj_blocked64_plain(C), "bgj_blocked64")}


def cr_batches(n):
    """chip_smoke.py's cr_batches: the batches of the inverses of one
    cyclic-reduction factorization of n blocks."""
    batches = []
    while n > 1:
        n += 1 - n % 2
        batches.append((n + 1) // 2)
        n = (n - 1) // 2
    return batches + [1]


# (kernel, k, batches, what one pass of the batches is)
BGJ_TIMED = (("bgj_flat", 32, cr_batches(1560), "mixed OCP iteration"),
             ("bgj_blocked64", 64, [1561], "mixed OCP iteration"),
             ("bgj_blocked64", 64, cr_batches(160), "cr32 factorization at N = 160"))


def time_bgj(out):
    """The ``times`` section: each batch's ms by both timers, their sums,
    and each batch's rel Fro difference from the plain version."""
    for name, k, batches, per in BGJ_TIMED:
        fn, plain = getattr(cr, name), getattr(cr, name + "_plain")
        rows = {}
        for B in batches:
            C = spd_blocks(B, k)
            K, P = fn(C), plain(C)
            rel = float(torch.linalg.matrix_norm((K - P).double()).max()
                        / torch.linalg.matrix_norm(P.double()).max())
            if rel > 1e-4:
                raise RuntimeError(f"{name} ({B}, {k}) disagrees with its plain version: {rel:.3e}")
            rows[B] = {"graph_ms": graph_ms(lambda: fn(C), 20),
                       "host_ms": event_ms(lambda: fn(C), 20), "rel_fro": rel}
        out[f"{name} k={k}, {per}"] = {
            "by_batch": rows,
            "sum_graph_ms": sum(r["graph_ms"] for r in rows.values()),
            "sum_host_ms": sum(r["host_ms"] for r in rows.values())}


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


def main(argv):
    if not torch.cuda.is_available():
        print("thomas_probe: no CUDA device", file=sys.stderr)
        return 2
    sections = argv or ["bgj", "thomas", "chol"]
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), "root": ROOT}
    if "times" in sections:
        time_bgj(out)
        sections = [s for s in sections if s != "times"]
    if not sections:
        print(json.dumps(out))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        if "bgj" in sections:
            probe_bgj(build(probed("bgj.cu", (0, -1)) + BGJ_LAYOUT_CU, tmp, "bgj_probe"), out)
        if "thomas" in sections:
            probe_thomas(build(probed("thomas.cu", (STAGE, STAGE + 1)), tmp, "thomas_probe"), out)
        if "chol" in sections:
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
        out["lds128_cycles_an_sm_per_warp_instruction"] = {}
        big = torch.zeros(132 * 1024, device="cuda")
        for name, offsets in LDS_PATTERNS.items():
            off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
            for _ in range(2):
                _build.check_launch(lat.lds_rate_launch(
                    ctypes.c_void_p(off.data_ptr()), ctypes.c_void_p(big.data_ptr()),
                    ctypes.c_void_p(cyc.data_ptr()), n), name)
            out["lds128_cycles_an_sm_per_warp_instruction"][name] = int(cyc.item()) / (n * 32)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
