"""Run the Cholesky block-Thomas CUDA kernels on the CPU, one thread per CUDA
thread, and hold them against their plain versions.

    python3 tools/emulate_chol_thomas.py [P,c,k,r ...]

Needs g++ with C++20 (std::barrier); no GPU, no nvcc. Turns
``sleqp_tpu_torch/kernels/csrc/chol_thomas.cu`` into C++: each CUDA thread is
a ``std::thread``, ``__syncthreads`` a block-wide ``std::barrier``,
``__syncwarp`` a per-warp one, ``__shfl_sync`` an exchange slot per lane
between two waits of the warp's barrier, ``cp.async`` a plain copy.
Shared memory is a heap buffer of exactly the launchers' size filled with
NaN, and the build uses AddressSanitizer, so an overrun or a read of memory
nothing wrote shows. Each case runs with 32, 96 and 512 threads (the
launchers use 512): the results must not depend on the count, since a race
would make them, and must match ``chol_thomas_factor_plain`` and
``chol_thomas_solve_plain``. Prints one line per case and thread count and
exits 1 if any check fails. The build lives in a temporary directory.
"""

import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc  # noqa: E402

SOURCE = os.path.join(ROOT, "sleqp_tpu_torch", "kernels", "csrc", "chol_thomas.cu")
THREADS = (32, 96, 512)
# ragged and full warp tiles, the largest block, the most right-hand sides
CASES = [(1, 3, 3, 1), (2, 4, 17, 5), (3, 7, 17, 33), (2, 3, 33, 8), (1, 6, 64, 1),
         (1, 3, 64, 128), (1, 3, 128, 2), (1, 3, 128, 128)]
TOL = 1e-6  # kernel against plain version, max |K - P| / max |P|

PRELUDE = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__
#define __restrict__
#define __launch_bounds__(...)
using std::min;
struct Dim { unsigned x; };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
thread_local Dim threadIdx, blockIdx;
Dim blockDim;
float* g_smem;
std::barrier<>* g_block;
std::vector<std::unique_ptr<std::barrier<>>> g_warp;
float g_slot[32][32];
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __syncwarp() { g_warp[threadIdx.x >> 5]->arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  g_slot[w][lane] = v;
  g_warp[w]->arrive_and_wait();
  const float r = g_slot[w][src];
  g_warp[w]->arrive_and_wait();
  return r;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
"""

MAIN = r"""
template <class F> void launch(int blocks, int threads, size_t bytes, F f) {
  blockDim.x = threads;
  for (int bl = 0; bl < blocks; ++bl) {
    const size_t n = bytes / sizeof(float);
    float* smem = new float[n];  // exactly the launcher's size
    std::fill(smem, smem + n, NAN);
    g_smem = smem;
    std::barrier<> block(threads);
    g_block = &block;
    g_warp.clear();
    for (int w = 0; w < threads / 32; ++w) g_warp.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([&, t] { threadIdx.x = t; blockIdx.x = bl; f(); });
    }
    for (auto& t : ts) t.join();
    delete[] smem;
  }
}
std::vector<float> readf(const char* path, size_t n) {
  std::vector<float> v(n);
  FILE* f = fopen(path, "rb");
  if (!f || fread(v.data(), 4, n, f) != n) { fprintf(stderr, "cannot read %s\n", path); exit(1); }
  fclose(f);
  return v;
}
void writef(const char* path, const std::vector<float>& v) {
  FILE* f = fopen(path, "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}
template <int NT> void run(bool factor, int p, int c, int k, int r, int th, char** files) {
  const size_t nm = (size_t)p * c * k * k, nv = (size_t)p * c * k * r, kp = 32 * NT;
  const size_t tile = kp * (kp + 4);
  if (factor) {
    auto D = readf(files[0], nm), Lp = readf(files[1], nm);
    std::vector<float> out(nm, NAN);
    const int nd = 5 * tile * 4 + kRinv <= kMaxSmem ? 3 : 2, nl = nd == 3 ? 2 : 1;
    launch(p, th, (nd + nl) * tile * 4 + kRinv, [&] {
      chol_thomas_factor_kernel<NT>(D.data(), Lp.data(), out.data(), c, k, nd, nl);
    });
    writef(files[2], out);
  } else {
    auto G = readf(files[0], nm), Lp = readf(files[1], nm), b = readf(files[2], nv);
    std::vector<float> x(nv, NAN);
    const int nbuf = solve_floats(kp, k, r, 2) * 4 + kRinv <= kMaxSmem ? 2 : 1;
    launch(p, th, solve_floats(kp, k, r, nbuf) * 4 + kRinv, [&] {
      chol_thomas_solve_kernel<NT>(G.data(), Lp.data(), b.data(), x.data(), c, k, r, nbuf);
    });
    writef(files[3], x);
  }
}
int main(int argc, char** argv) {  // factor|solve P c k r threads inputs... output
  const bool factor = !strcmp(argv[1], "factor");
  const int p = atoi(argv[2]), c = atoi(argv[3]), k = atoi(argv[4]), r = atoi(argv[5]);
  const int th = atoi(argv[6]);
  switch ((k + 31) / 32) {
    case 1: run<1>(factor, p, c, k, r, th, argv + 7); break;
    case 2: run<2>(factor, p, c, k, r, th, argv + 7); break;
    case 3: run<3>(factor, p, c, k, r, th, argv + 7); break;
    default: run<4>(factor, p, c, k, r, th, argv + 7);
  }
  return 0;
}
"""


def emulated_source() -> str:
    """The device code of chol_thomas.cu (up to the launchers) as plain C++,
    with the launchers' shared-memory helper solve_floats kept."""
    src = open(SOURCE).read()
    body = src[src.index("namespace {"): src.index("template <int NT>\nint factor_launch")]
    helper = re.search(r"size_t solve_floats\(.*?\n\}\n", src, flags=re.S)
    copy = re.compile(r"__device__ __forceinline__ void copy_async\(float\* dst, const float\* src, "
                      r"bool wide\) \{.*?\n\}\n", re.S)
    wait = re.compile(r"__device__ __forceinline__ void copy_async_wait\(\) \{.*?\n\}\n", re.S)
    if not (copy.search(body) and wait.search(body) and helper):
        raise RuntimeError("emulate: chol_thomas.cu no longer has copy_async, copy_async_wait "
                           "or solve_floats as this script expects")
    body = copy.sub("void copy_async(float* dst, const float* src, bool wide) {\n"
                    "  for (int i = 0; i < (wide ? 4 : 1); ++i) dst[i] = src[i];\n}\n", body)
    body = wait.sub("void copy_async_wait() {}\n", body)
    body = body.replace("extern __shared__ float4 smem4[];",
                        "float4* smem4 = reinterpret_cast<float4*>(g_smem);")
    if "asm" in body or "__shared__" in body:
        raise RuntimeError("emulate: device code the emulation does not know remains")
    return PRELUDE + body + helper.group(0) + "}  // namespace\n" + MAIN


def inputs(P, c, k, r, seed):
    """chip_smoke.py's tridiag_inputs, on the CPU."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((P, c, k, k))
    D = A @ np.swapaxes(A, -1, -2) + 2 * k * np.eye(k)
    Lp = 0.3 * rng.standard_normal((P, c, k, k))
    Lp[:, 0] = 0.0
    b = rng.standard_normal((P, c, k, r))
    return [torch.tensor(a, dtype=torch.float32) for a in (D, Lp, b)]


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def main(argv):
    cases = [tuple(int(v) for v in a.split(",")) for a in argv] or CASES
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        cpp, exe = os.path.join(tmp, "chol_emu.cpp"), os.path.join(tmp, "chol_emu")
        with open(cpp, "w") as fh:
            fh.write(emulated_source())
        subprocess.run(["g++", "-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
                        "-pthread", cpp, "-o", exe], check=True)

        def emulate(mode, shape, th, arrays):
            files = [os.path.join(tmp, f"in{i}.bin") for i in range(len(arrays))]
            for f, a in zip(files, arrays):
                a.numpy().tofile(f)
            out = os.path.join(tmp, "out.bin")
            subprocess.run([exe, mode, *map(str, shape), str(th), *files, out], check=True)
            P, c, k, r = shape
            return torch.from_numpy(np.fromfile(out, dtype=np.float32)).reshape(
                P, c, k, k if mode == "factor" else r)

        for shape in cases:
            D, Lp, b = inputs(*shape, seed=sum(shape[:3]))
            ch_p = pc.chol_thomas_factor_plain(D, Lp)
            x_p = pc.chol_thomas_solve_plain(ch_p, Lp, b)
            first = None
            for th in THREADS:
                ch = emulate("factor", shape, th, [D, Lp])
                x = emulate("solve", shape, th, [ch_p, Lp, b])
                same = first is None or (torch.equal(ch, first[0]) and torch.equal(x, first[1]))
                first = first or (ch, x)
                upper = float(torch.triu(ch, 1).abs().max())
                e_f, e_s = rel(ch, ch_p), rel(x, x_p)
                good = same and upper == 0.0 and e_f <= TOL and e_s <= TOL
                ok &= good
                print(f"{shape} threads {th}: factor {e_f:.3e}, solve {e_s:.3e} against the plain "
                      f"versions; upper triangle {upper}; equal to {THREADS[0]} threads: {same}"
                      + ("" if good else "  FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
