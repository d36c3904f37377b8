"""Run the port's CUDA kernels on the CPU, one thread per CUDA thread, and hold
them against their plain versions.

    python3 tools/emulate_thomas.py [thomas|chol|bgj] [N,k,r[,nb] | P,c,k,r | B,k[,1] ...]

``thomas`` runs ``sleqp_tpu_torch/kernels/csrc/thomas.cu`` (``thomas_fwd`` in
both modes and ``thomas_bwd``; ``nb`` forces the number of stage slots),
``chol`` runs ``chol_thomas.cu``, ``bgj`` runs ``bgj.cu`` (``bgj_flat`` on B
blocks of k, or ``bgj_blocked64`` on B blocks of 64 where a third value is 1);
with no shapes, each runs its default cases, and with no arguments all do.
Needs g++ with C++20 (std::barrier); no GPU, no nvcc.

The source is compiled as it stands, with KERNEL_EMULATION defined: that
leaves out its CUDA headers, ``staging.cuh`` and its launchers, and the
prelude here gives C++ counterparts of what ``staging.cuh`` gives the
kernels. Each CUDA thread is a ``std::thread``, ``__syncthreads`` a
block-wide ``std::barrier``, ``__syncwarp`` a per-warp one, a named barrier
one per id, a shuffle an exchange slot per lane between two waits of the
warp's barrier. ``cp.async`` and the copy engine's copies are plain copies (a
tensor map's box written with the 128-byte swizzle and zero fill); mbarriers
are real: one arrival and the announced bytes complete a phase, waits go by
parity, so the copy warp and the compute threads race as on the card. Shared
memory is a heap buffer of exactly the launchers' size filled with NaN, and
the build uses AddressSanitizer, so an overrun or a read of memory nothing
wrote shows.

``thomas.cu`` runs at its launchers' 288 threads, which its layouts assume.
Each kernel gets the plain versions' inputs. The inverses must equal, bit for
bit, ``ordered_inverses``: ``thomas_fwd_plain``'s arithmetic with each
coupling product summed in index order as the kernel sums it (a CPU matrix
product may sum in another order) and each update one ``fma32``, and agree
with ``thomas_fwd_plain`` to ``TOL``, as the substitutions must. ``bgj.cu``
runs at its launchers' thread counts; its inverses must equal, bit for bit,
``ordered_flat_inverses`` (``bgj_flat_plain``'s sweeps, each update one
``fma32``) or ``ordered_blocked64`` (``bgj_blocked64_plain``'s two Schur
levels with each product an FMA chain in index order), and agree with the
plain versions to ``TOL``. ``chol_thomas.cu`` runs with 32, 96 and
512 threads (its kernels take the warp count from blockDim): the results must
not depend on the count, since a race would make them, and must match
``chol_thomas_factor_plain`` and ``chol_thomas_solve_plain``. Prints one line
per case and exits 1 if any check fails. The build lives in a temporary
directory.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sleqp_tpu_torch.ops import pallas_chol_tridiag as pc  # noqa: E402
from sleqp_tpu_torch.ops import cyclic_reduction as cr  # noqa: E402
from sleqp_tpu_torch.ops import pallas_tridiag as pt  # noqa: E402

CSRC = os.path.join(ROOT, "sleqp_tpu_torch", "kernels", "csrc")
CHOL_THREADS = (32, 96, 512)
# (N, k, r[, nb]): both padded widths, ragged blocks and right-hand sides,
# the most right-hand sides, and two, three and four stage slots
THOMAS_CASES = [(3, 3, 1), (4, 17, 5, 2), (2, 64, 1), (6, 33, 5, 3), (7, 64, 1), (3, 32, 33),
                (3, 64, 128), (5, 20, 1, 2)]
# (P, c, k, r): ragged and full warp tiles, the largest block, the most
# right-hand sides
CHOL_CASES = [(1, 3, 3, 1), (2, 4, 17, 5), (3, 7, 17, 33), (2, 3, 33, 8), (1, 6, 64, 1),
              (1, 3, 64, 128), (1, 3, 128, 2), (1, 3, 128, 128)]
# (B, k, blocked): bgj_flat at the padded widths 32, 64 and 96 with ragged
# k, the widest k; bgj_blocked64
BGJ_CASES = [(3, 3, 0), (2, 17, 0), (3, 32, 0), (2, 33, 0), (1, 77, 0), (1, 96, 0), (2, 64, 1)]
TOL = 1e-6  # kernel against plain version, max |K - P| / max |P|

PRELUDE = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
#define KERNEL_EMULATION
#define KERNEL_PROBE(step, mark)
using std::min;
// what the emulated copy engine needs of a tensor map: the array and its box
struct CUtensorMap { const float* src; int cols, rows; };
inline size_t __cvta_generic_to_shared(const void* p) { return reinterpret_cast<size_t>(p); }
struct Dim { unsigned x; };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
thread_local Dim threadIdx, blockIdx;
Dim blockDim;
float* g_smem;
std::barrier<>* g_block;
std::vector<std::unique_ptr<std::barrier<>>> g_warp;
float g_slot[32][32];
float4* dynamic_smem() { return reinterpret_cast<float4*>(g_smem); }
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
inline float __shfl_xor_sync(unsigned mask, float v, int m) {
  return __shfl_sync(mask, v, (threadIdx.x & 31) ^ m);
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
// the copies and their mbarriers: a copy is done when it returns; an
// mbarrier completes a phase when its one arrival and its bytes are in
struct EmuBar { int pending = 1; long long tx = 0; unsigned phase = 0; };
std::mutex g_bar_mu;
std::condition_variable g_bar_cv;
std::map<const void*, EmuBar> g_bars;
std::map<int, std::unique_ptr<std::barrier<>>> g_named;  // bar.sync id, count
void bar_update(const void* bar, int arrive, long long tx) {
  std::lock_guard<std::mutex> lock(g_bar_mu);
  EmuBar& b = g_bars.at(bar);
  b.pending -= arrive;
  b.tx += tx;
  if (b.pending == 0 && b.tx == 0) {
    b.phase++;
    b.pending = 1;
    g_bar_cv.notify_all();
  }
}
void copy_async(float* dst, const float* src, bool wide = false) {
  for (int i = 0; i < (wide ? 4 : 1); ++i) dst[i] = src[i];
}
void copy_async_wait() {}
void copy_async_fence() {}
void copy_async_bar_init(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(g_bar_mu);
  g_bars[bar] = EmuBar{};
}
void copy_async_bar_expect(uint64_t* bar, unsigned bytes) { bar_update(bar, 1, bytes); }
void copy_async_bar_arrive(uint64_t* bar) { bar_update(bar, 1, 0); }
void copy_async_bar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> lock(g_bar_mu);
  g_bar_cv.wait(lock, [&] { return (g_bars.at(bar).phase & 1) != parity; });
}
void copy_async_bulk(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
  for (unsigned i = 0; i < bytes / 4; ++i) dst[i] = src[i];
  bar_update(bar, 0, -static_cast<long long>(bytes));
}
// a box of 32 columns and map->rows rows, zero beyond map->cols, written
// with the 128-byte swizzle
void copy_async_tile(float* dst, const CUtensorMap* map, int c0, int r0, uint64_t* bar) {
  for (int a = 0; a < map->rows; ++a) {
    for (int c = 0; c < 32; ++c) {
      dst[a * 32 + ((((c >> 2) ^ a) & 7) << 2) + (c & 3)] =
          c0 + c < map->cols ? map->src[(size_t)(r0 + a) * map->cols + c0 + c] : 0.0f;
    }
  }
  bar_update(bar, 0, -32LL * 4 * map->rows);
}
void sync_threads(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(g_bar_mu);
    auto& slot = g_named[id];
    if (!slot) slot.reset(new std::barrier<>(count));
    b = slot.get();
  }
  b->arrive_and_wait();
}
"""

HELPERS = r"""
template <class F> void launch(int blocks, int threads, size_t bytes, F f) {
  blockDim.x = threads;
  for (int bl = 0; bl < blocks; ++bl) {
    const size_t n = bytes / sizeof(float);
    float* smem = new float[n];  // exactly the launcher's size
    std::fill(smem, smem + n, NAN);
    g_smem = smem;
    std::barrier<> block(threads);
    g_block = &block;
    g_bars.clear();
    g_named.clear();
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
"""

CHOL_MAIN = r"""
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

THOMAS_MAIN = r"""
template <int KP> void run(const char* mode, int n, int k, int r, int nb, char** files) {
  const size_t nm = (size_t)n * k * k, nv = (size_t)n * k * r;
  const bool bwd = !strcmp(mode, "bwd"), factor = !strcmp(mode, "fwd");
  const Layout lay = layout(KP, r, !bwd);
  Layout sized = lay;
  sized.nb = nb > 0 ? nb : lay.nb;
  const int depth = sized.nb;
  const size_t bytes = sized.bytes();
  auto A = readf(files[0], nm), Lp = readf(files[1], nm), v = readf(files[2], nv);
  std::vector<float> out(nv, NAN), M(nm, NAN);
  // the copy engine takes rows of 16-byte multiples, as the launchers decide
  const int tma = k % 4 == 0;
  const CUtensorMap mapA{A.data(), k, k}, mapL{Lp.data(), k, k};
  launch(1, kBlock, bytes, [&] {
    if (bwd) {
      thomas_bwd_kernel<KP>(mapA, mapL, A.data(), Lp.data(), v.data(), out.data(), n, k, r,
                            depth, tma);
    } else {
      thomas_fwd_kernel<KP>(mapA, mapL, A.data(), Lp.data(), v.data(), out.data(), M.data(), n,
                            k, r, factor, depth, tma);
    }
  });
  writef(files[3], out);
  if (factor) writef(files[4], M);
}
int main(int argc, char** argv) {  // fwd|resolve|bwd N k r nb inputs... outputs...
  const int n = atoi(argv[2]), k = atoi(argv[3]), r = atoi(argv[4]), nb = atoi(argv[5]);
  if (k <= 32) {
    run<32>(argv[1], n, k, r, nb, argv + 6);
  } else {
    run<64>(argv[1], n, k, r, nb, argv + 6);
  }
  return 0;
}
"""

BGJ_MAIN = r"""
template <int KP> void flat(int batch, int k, char** files) {
  auto C = readf(files[0], (size_t)batch * k * k);
  std::vector<float> M(C.size(), NAN);
  launch(batch, kFlatGroups * KP, 4 * KP * sizeof(float),
         [&] { bgj_flat_kernel<KP>(C.data(), M.data(), k); });
  writef(files[1], M);
}
int main(int argc, char** argv) {  // flat B k | blocked B 64, then input, output
  const int batch = atoi(argv[2]), k = atoi(argv[3]);
  if (!strcmp(argv[1], "flat")) {
    if (k <= 32) flat<32>(batch, k, argv + 4);
    else if (k <= 64) flat<64>(batch, k, argv + 4);
    else flat<96>(batch, k, argv + 4);
    return 0;
  }
  auto C = readf(argv[4], (size_t)batch * k * k);
  std::vector<float> M(C.size(), NAN);
  launch(batch, kBlockedThreads, sizeof(BlockedSmem), [&] { bgj_blocked64_kernel(C.data(), M.data()); });
  writef(argv[5], M);
  return 0;
}
"""

SOURCES = {"thomas": ("thomas.cu", THOMAS_MAIN), "chol": ("chol_thomas.cu", CHOL_MAIN),
           "bgj": ("bgj.cu", BGJ_MAIN)}


def emulated_source(kind: str) -> str:
    """thomas.cu, chol_thomas.cu or bgj.cu as plain C++: the prelude's
    counterparts of what ``staging.cuh`` gives the kernels, the source
    itself (its launchers are host code it leaves out when
    KERNEL_EMULATION is defined), and a main that runs its kernels on
    files."""
    name, main = SOURCES[kind]
    return PRELUDE + f'#include "{os.path.join(CSRC, name)}"\n' + HELPERS + main


def build(kind: str, tmp: str) -> str:
    """Compile the emulation of one source; returns the executable."""
    cpp, exe = os.path.join(tmp, f"{kind}_emu.cpp"), os.path.join(tmp, f"{kind}_emu")
    with open(cpp, "w") as fh:
        fh.write(emulated_source(kind))
    subprocess.run(["g++", "-std=c++20", "-O0", "-g", "-fsanitize=address,undefined",
                    "-pthread", cpp, "-o", exe], check=True)
    return exe


def inputs(lead, k, r, seed):
    """chip_smoke.py's tridiag_inputs, on the CPU."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(lead + (k, k))
    D = A @ np.swapaxes(A, -1, -2) + 2 * k * np.eye(k)
    Lp = 0.3 * rng.standard_normal(lead + (k, k))
    Lp[..., 0, :, :] = 0.0
    b = rng.standard_normal(lead + (k, r))
    return [torch.tensor(a, dtype=torch.float32) for a in (D, Lp, b)]


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _call(exe, tmp, args, arrays, outs):
    """Run the emulation with ``arrays`` as input files; returns its output
    files as flat float32 tensors."""
    files = [os.path.join(tmp, f"in{i}.bin") for i in range(len(arrays))]
    for f, a in zip(files, arrays):
        a.numpy().tofile(f)
    out = [os.path.join(tmp, f"out{i}.bin") for i in range(outs)]
    subprocess.run([exe, *map(str, args), *files, *out], check=True)
    return [torch.from_numpy(np.fromfile(f, dtype=np.float32)) for f in out]


def fma32(a, b, c):
    """a * b + c for float32 tensors, rounded once to float32, as a fused
    multiply-add rounds it.  The product is exact in float64; where the
    float64 sum lands on a midpoint of two float32 values, its exact error
    (TwoSum) decides the side."""
    p, c64 = a.double() * b.double(), c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    half = s - r.double()
    other = torch.nextafter(r, torch.where(half > 0, torch.inf, -torch.inf).float())
    midpoint = (half != 0) & (other.double() - r.double() == 2 * half)
    return torch.where(midpoint & (err * half > 0), other, r)


def chain_product(X, Y):
    """X @ Y in float32 for (..., n, l) X and (..., l, m) Y, each entry one
    FMA chain over l in index order from 0, as the kernels' products sum
    it."""
    P = torch.zeros(X.shape[:-1] + Y.shape[-1:])
    for m in range(X.shape[-1]):
        P = fma32(X[..., :, m:m + 1], Y[..., m:m + 1, :], P)
    return P


def ordered_flat_inverses(C):
    """``bgj_flat_plain``'s tableau sweeps on (B, k, k) C with each update
    one ``fma32``: what the kernels' Gauss-Jordan (gj.cuh) computes, on any
    host."""
    B, k, _ = C.shape
    eye = torch.eye(k)
    A, Binv = C, eye.expand(B, k, k)
    for j in range(k):
        col = A[:, :, j]
        piv = col[:, j:j + 1]
        rA, rB = A[:, j, :] / piv, Binv[:, j, :] / piv
        f = -(col - eye[j])[:, :, None]
        A, Binv = fma32(f, rA[:, None, :], A), fma32(f, rB[:, None, :], Binv)
    return Binv


def ordered_schur(C, inv_half):
    """``cyclic_reduction._schur_inverse`` with each product summed by
    ``chain_product``."""
    h = C.shape[1] // 2
    A, Bm, D = C[:, :h, :h], C[:, :h, h:], C[:, h:, h:]
    Ai = inv_half(A)
    W = chain_product(Bm.transpose(1, 2), Ai)
    S = D - chain_product(W, Bm)
    Si = inv_half(S)
    V = chain_product(Ai, Bm)
    VSi = chain_product(V, Si)
    top = torch.cat([Ai + chain_product(VSi, W), -VSi], dim=2)
    return torch.cat([top, torch.cat([-chain_product(Si, W), Si], dim=2)], dim=1)


def ordered_blocked64(C):
    """``bgj_blocked64_plain`` with each product an FMA chain in index order
    and its leaves ``ordered_flat_inverses``: what bgj_blocked64 computes."""
    return ordered_schur(C, lambda A: ordered_schur(A, ordered_flat_inverses))


def ordered_inverses(D, Lp):
    """``thomas_fwd_plain``'s inverses M_i, C_i = D_i - L (M_{i-1} L^T), with
    both coupling products summed by ``chain_product`` and the inverses
    ``ordered_flat_inverses``: what thomas.cu computes, on any host."""
    N, k, _ = D.shape
    M, Ms = torch.zeros(k, k), []
    for i in range(N):
        T1 = chain_product(M, Lp[i].T)
        M = ordered_flat_inverses((D[i] - chain_product(Lp[i], T1))[None])[0]
        Ms.append(M)
    return torch.stack(Ms)


def thomas_case(exe, tmp, N, k, r, nb=0):
    """Both thomas.cu kernels on one shape, each fed the plain versions'
    inputs: (M equal to ``ordered_inverses`` bit for bit, and the rel errors
    of M, y, the resolve's y and x against the plain versions)."""
    D, Lp, b = inputs((N,), k, r, seed=N + k)
    y_p, M_p = pt.thomas_fwd_plain(D, Lp, b, True)
    x_p = pt.thomas_bwd_plain(M_p, Lp, y_p)
    y2_p, _ = pt.thomas_fwd_plain(M_p, Lp, b, False)
    y, M = _call(exe, tmp, ("fwd", N, k, r, nb), [D, Lp, b], 2)
    (y2,) = _call(exe, tmp, ("resolve", N, k, r, nb), [M_p, Lp, b], 1)
    (x,) = _call(exe, tmp, ("bwd", N, k, r, nb), [M_p, Lp, y_p], 1)
    M = M.reshape(M_p.shape)
    return (torch.equal(M, ordered_inverses(D, Lp)), rel(M, M_p), rel(y.reshape(y_p.shape), y_p),
            rel(y2.reshape(y2_p.shape), y2_p), rel(x.reshape(x_p.shape), x_p))


def spd_blocks(B, k, seed):
    """chip_smoke.py's spd_blocks, on the CPU."""
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((B, k, k))
    return torch.tensor(np.einsum("bij,bkj->bik", C, C) + 2 * k * np.eye(k), dtype=torch.float32)


def bgj_case(exe, tmp, B, k, blocked=0):
    """bgj_flat (or, if blocked, bgj_blocked64) on B SPD blocks of k: (the
    inverses equal to their index-order reference bit for bit, their rel
    error against the plain version)."""
    C = spd_blocks(B, k, seed=B + k)
    (K,) = _call(exe, tmp, ("blocked" if blocked else "flat", B, k), [C], 1)
    K = K.reshape(C.shape)
    if blocked:
        return torch.equal(K, ordered_blocked64(C)), rel(K, cr.bgj_blocked64_plain(C))
    return torch.equal(K, ordered_flat_inverses(C)), rel(K, cr.bgj_flat_plain(C))


def run_bgj(cases, tmp):
    exe, ok = build("bgj", tmp), True
    for case in cases:
        same, err = bgj_case(exe, tmp, *case)
        good = same and err <= TOL
        ok &= good
        name = "bgj_blocked64" if len(case) > 2 and case[2] else "bgj_flat"
        print(f"{name} {case[:2]}: equal to the index-order reference: {same}; against the plain "
              f"version {err:.3e}" + ("" if good else "  FAILED"), flush=True)
    return ok


def run_thomas(cases, tmp):
    exe, ok = build("thomas", tmp), True
    for case in cases:
        same, *errs = thomas_case(exe, tmp, *case)
        good = same and max(errs) <= TOL
        ok &= good
        print(f"thomas {case}: M equal to the index-order reference: {same}; against the "
              "plain versions: M {:.3e}, y {:.3e}, resolve {:.3e}, x {:.3e}".format(*errs)
              + ("" if good else "  FAILED"), flush=True)
    return ok


def run_chol(cases, tmp):
    exe, ok = build("chol", tmp), True
    for shape in cases:
        P, c, k, r = shape
        D, Lp, b = inputs((P, c), k, r, seed=P + c + k)
        ch_p = pc.chol_thomas_factor_plain(D, Lp)
        x_p = pc.chol_thomas_solve_plain(ch_p, Lp, b)
        first = None
        for th in CHOL_THREADS:
            (ch,) = _call(exe, tmp, ("factor", *shape, th), [D, Lp], 1)
            (x,) = _call(exe, tmp, ("solve", *shape, th), [ch_p, Lp, b], 1)
            ch, x = ch.reshape(ch_p.shape), x.reshape(x_p.shape)
            same = first is None or (torch.equal(ch, first[0]) and torch.equal(x, first[1]))
            first = first or (ch, x)
            upper = float(torch.triu(ch, 1).abs().max())
            e_f, e_s = rel(ch, ch_p), rel(x, x_p)
            good = same and upper == 0.0 and e_f <= TOL and e_s <= TOL
            ok &= good
            print(f"chol {shape} threads {th}: factor {e_f:.3e}, solve {e_s:.3e} against the "
                  f"plain versions; upper triangle {upper}; equal to {CHOL_THREADS[0]} threads: "
                  f"{same}" + ("" if good else "  FAILED"), flush=True)
    return ok


def main(argv):
    kinds = [argv[0]] if argv and argv[0] in SOURCES else list(SOURCES)
    shapes = [tuple(int(v) for v in a.split(",")) for a in argv[1:]] if len(kinds) == 1 else []
    runs = {"thomas": (run_thomas, THOMAS_CASES), "chol": (run_chol, CHOL_CASES),
            "bgj": (run_bgj, BGJ_CASES)}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for kind in kinds:
            run, cases = runs[kind]
            ok &= run(shapes or cases, tmp)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
