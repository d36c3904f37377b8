// Batched inverses of SPD float32 blocks for the cyclic-reduction layer
// (sleqp_tpu_torch/ops/cyclic_reduction.py).
//
//   bgj_flat       replaces sleqp_tpu/ops/cyclic_reduction.py::_bgj_kernel:
//                  k unpivoted Gauss-Jordan sweeps in registers (gj.cuh),
//                  bit for bit bgj_flat_plain's tableau arithmetic.
//   bgj_blocked64  replaces ::_bgj_blocked_kernel: two 2x2 block-Schur
//                  levels (64 -> 32 -> 16) over 16 x 16 Gauss-Jordan leaves
//                  (gj.cuh), the six products of each level float32 FMA
//                  chains in index order (never TF32).
//
// Both read each input block once and write each output block once, so
// device memory moves 2 B k^2 * 4 bytes, which bounds both on this card
// (1.9 us for B1 at (781, 32, 32), 15 us for B2 at (1561, 64, 64)).  What
// sets their time is elsewhere (PERF.md, tools/thomas_probe.py):
//   - bgj_flat: each matrix is a chain of k sweeps, each a barrier, a
//     shared load, an IEEE division and the FMAs.  A matrix lies in the
//     registers of one block of 4 kp threads (kp / 4 rows of one column a
//     thread), so a sweep is a few instructions a warp on four schedulers,
//     and 781 matrices are in flight at once over the 132 SMs.  Loads and
//     stores are rows of the block, 128 bytes a warp at k = 32; the
//     padding (k < kp) is identity and never leaves the registers.
//   - bgj_blocked64: ~262k FMAs a matrix.  Each product gives a thread a
//     4 x 4, 2 x 4, 2 x 2 or 1 x 2 tile of outputs from 16- or 8-byte
//     loads of both operands (no transposed copy: Bm^T Ai reads Bm along
//     its rows), two independent products share a phase, the leaves run
//     on one warp, and the level's quadrants go to device memory straight
//     from registers: 16 barriers a matrix.  The lower-left quadrant
//     (Bm^T) is never read.  27 KB of shared memory a block.  Its rate at
//     1561 matrices is bound by the SM's shared-memory loads (PERF.md).
// No pivoting: the blocks are SPD, and every leading principal block of an
// SPD matrix is PD.
//
// Plain C interface, built with plain nvcc and loaded through ctypes
// (sleqp_tpu_torch/kernels/_build.py).  Each launcher takes raw device
// pointers, sizes and a cudaStream_t and returns cudaGetLastError().

#include <cstddef>

#ifndef KERNEL_EMULATION  // tools/emulate_thomas.py brings its own
#include <cuda_runtime.h>

#include "staging.cuh"
#endif

#include "gj.cuh"

namespace {

// ---------------------------------------------------------------------------
// B1: bgj_flat
// ---------------------------------------------------------------------------

constexpr int kFlatMaxK = 96;  // the widest padded width

// A matrix at padded width kp lies in the 4 kp threads of one block, kp / 4
// rows of one column a thread, synced by __syncthreads.  At kp = 32 this
// beat one and two warps a matrix at 781 matrices and at one
// (tools/thomas_probe.py).  One matrix a block: a named barrier with a
// computed id, which several matrices a block would need, makes ptxas
// reserve all 16 barriers a block, which caps the blocks an SM holds (781
// matrices then took two waves).
constexpr int kFlatGroups = 4;

struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};

// Dynamic shared memory: the pivot slots R and F, 4 kp floats.
template <int KP>
__global__ void __launch_bounds__(kFlatGroups * KP)
bgj_flat_kernel(const float* __restrict__ C, float* __restrict__ M, int k) {
  constexpr int RPT = KP / kFlatGroups;
  float* R = reinterpret_cast<float*>(dynamic_smem());
  float* F = R + 2 * KP;
  const int c = threadIdx.x % KP, r0 = RPT * (threadIdx.x / KP);
  const size_t off = static_cast<size_t>(blockIdx.x) * k * k;
  float w[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int a = r0 + u;
    w[u] = a < k && c < k ? C[off + a * k + c] : (a == c ? 1.0f : 0.0f);
  }
  KERNEL_PROBE(0, 0);
  gauss_jordan<KP, RPT>(w, k, R, F, c, r0, BlockSync{});
  KERNEL_PROBE(0, 1);
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int a = r0 + u;
    if (a < k && c < k) M[off + a * k + c] = w[u];
  }
}

// ---------------------------------------------------------------------------
// B2: bgj_blocked64
// ---------------------------------------------------------------------------

constexpr int kBlockedThreads = 128;
constexpr int kBlocked = 64, kHalf = 32, kLeaf = 16;
// padded leading dimensions: 16-byte pieces of 8 consecutive rows at one
// column fall in distinct banks (36 / 4 = 9 and 20 / 4 = 5 are odd)
constexpr int kLdO = kHalf + 4, kLdI = kLeaf + 4;

// One block's shared memory: six 32 x 32 views of the outer level (A, then
// S; Bm, then V Si; D, then Si; Ai; W; V).  The inner level's scratch (W,
// V, S then V Si, each 16 x 16, and the leaves' pivot slots) lies in a view
// the outer level is not using at the time: V's before V is formed, Bm's
// once S is.
struct BlockedSmem {
  float outer[6][kHalf * kLdO];
};
constexpr int kInner = kLeaf * kLdI;  // one inner scratch view

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The N x N product P = X Y of row-major views (leading dimensions ldx,
// ldy), or P = X^T Y when XT (X then is the left factor's transpose), by
// (N/TM)(N/TN) threads, t below that.  Thread t takes the TM x TN tile of
// columns c0 + v, c0 = TN (t / (N/TM)), and rows rb + (N/TM) u, rb =
// t % (N/TM), so that a warp's rows of X read distinct banks; with XT rows
// TM rb + u, a vector along a row of X^T.  Each entry is one FMA chain over
// m = 0..N-1 in index order from 0.  out(a, c0, p) takes row a's TN entries.
template <int N, int TM, int TN, bool XT, class Out>
__device__ __forceinline__ void product(const float* X, int ldx, const float* Y, int ldy, int t,
                                        const Out& out) {
  constexpr int NR = N / TM;
  const int rb = t % NR, c0 = TN * (t / NR);
  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u) {
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < N; m += 4) {
    float x[4][TM], y[4][TN];
    if constexpr (XT) {
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) load_vec<TM>(X + (m + mm) * ldx + TM * rb, x[mm]);
    } else {
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        float xr[4];
        load_vec<4>(X + (rb + NR * u) * ldx + m, xr);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) x[mm][u] = xr[mm];
      }
    }
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) load_vec<TN>(Y + (m + mm) * ldy + c0, y[mm]);
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
#pragma unroll
      for (int u = 0; u < TM; ++u) {
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(x[mm][u], y[mm][v], acc[u][v]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < TM; ++u) out(XT ? TM * rb + u : rb + NR * u, c0, acc[u]);
}

// A product's output rows: stored to dst (leading dimension ld) as they
// are (sign 1) or negated, and to dst2 as they are unless it is null.
template <int TN>
struct Store {
  float* dst;
  int ld;
  float sign;
  float* dst2 = nullptr;
  int ld2 = 0;
  __device__ void operator()(int a, int c0, const float (&p)[TN]) const {
    float s[TN];
#pragma unroll
    for (int v = 0; v < TN; ++v) s[v] = sign * p[v];
    store_vec<TN>(dst + a * ld + c0, s);
    if (dst2) store_vec<TN>(dst2 + a * ld2 + c0, p);
  }
};

// dst = base + sign P, entry by entry (D - W Bm, Ai + (V Si) W).
template <int TN>
struct StoreSum {
  float* dst;
  int ld;
  const float* base;
  int ldb;
  float sign;
  __device__ void operator()(int a, int c0, const float (&p)[TN]) const {
    float b[TN], s[TN];
    load_vec<TN>(base + a * ldb + c0, b);
#pragma unroll
    for (int v = 0; v < TN; ++v) s[v] = b[v] + sign * p[v];
    store_vec<TN>(dst + a * ld + c0, s);
  }
};

// The 16 x 16 view X (leading dimension ldx) inverted into Xi by the
// block's first warp: lane l holds rows 8 (l / 16) + u of column l % 16.
__device__ __forceinline__ void leaf(const float* X, int ldx, float* Xi, int ldi, float* gj) {
  if (threadIdx.x >= 32) return;
  const int c = threadIdx.x % kLeaf, r0 = 8 * (threadIdx.x / kLeaf);
  float w[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) w[u] = X[(r0 + u) * ldx + c];
  gauss_jordan<kLeaf, 8>(w, kLeaf, gj, gj + 2 * kLeaf, c, r0, WarpSync{});
#pragma unroll
  for (int u = 0; u < 8; ++u) Xi[(r0 + u) * ldi + c] = w[u];
}

// Xi = X^-1 for the 32 x 32 SPD view X (both leading dimension kLdO) by
// one Schur level over 16 x 16 leaves, the arithmetic of
// _schur_quadrants:
//   Ai = inv(A), W = Bm^T Ai, S = D - W Bm, Si = inv(S), V = Ai Bm,
//   Xi = [[Ai + (V Si) W, -(V Si)], [-(Si W), Si]].
// Ai goes into Xi's top-left quadrant, where Ai + (V Si) W replaces it
// entry by entry, Si into the bottom-right; W, V, S and V Si (in S's place)
// and the leaves' pivot slots into `scratch` (3 kInner + 4 kLeaf floats).
// Six phases, each ending in a barrier; probe marks `mark` + 0..5.
__device__ __forceinline__ void inverse32(const float* X, float* Xi, float* scratch, int t,
                                          int mark) {
  const float* A = X;
  const float* Bm = X + kLeaf;
  const float* D = X + kLeaf * kLdO + kLeaf;
  float* Ai = Xi;
  float* BL = Xi + kLeaf * kLdO;
  float* BR = BL + kLeaf;
  float* W = scratch;
  float* V = W + kInner;
  float* S = V + kInner;
  float* VSi = S;
  float* gj = S + kInner;
  leaf(A, kLdO, Ai, kLdO, gj);
  __syncthreads();
  KERNEL_PROBE(0, mark);
  if (t < 64) {
    product<kLeaf, 2, 2, true>(Bm, kLdO, Ai, kLdO, t, Store<2>{W, kLdI, 1.0f});
  } else {
    product<kLeaf, 2, 2, false>(Ai, kLdO, Bm, kLdO, t - 64, Store<2>{V, kLdI, 1.0f});
  }
  __syncthreads();
  KERNEL_PROBE(0, mark + 1);
  product<kLeaf, 1, 2, false>(W, kLdI, Bm, kLdO, t, StoreSum<2>{S, kLdI, D, kLdO, -1.0f});
  __syncthreads();
  KERNEL_PROBE(0, mark + 2);
  leaf(S, kLdI, BR, kLdO, gj);
  __syncthreads();
  KERNEL_PROBE(0, mark + 3);
  if (t < 64) {
    product<kLeaf, 2, 2, false>(V, kLdI, BR, kLdO, t, Store<2>{Xi + kLeaf, kLdO, -1.0f, VSi, kLdI});
  } else {
    product<kLeaf, 2, 2, false>(BR, kLdO, W, kLdI, t - 64, Store<2>{BL, kLdO, -1.0f});
  }
  __syncthreads();
  KERNEL_PROBE(0, mark + 4);
  product<kLeaf, 1, 2, false>(VSi, kLdI, W, kLdI, t, StoreSum<2>{Xi, kLdO, Ai, kLdO, 1.0f});
  __syncthreads();
  KERNEL_PROBE(0, mark + 5);
}

// One 64 x 64 block a thread block: the outer Schur level with
// inverse32 for its halves, the quadrants of the result written to M from
// the products' registers.  Probe marks (tools/thomas_probe.py): 0 start,
// 1 input loaded, 2-7 inverse32(A), 8 W and V, 9 S, 10-15 inverse32(S),
// 16 V Si, Si W and the copy of Si, 17 Ai + (V Si) W.
__global__ void __launch_bounds__(kBlockedThreads)
bgj_blocked64_kernel(const float* __restrict__ C, float* __restrict__ M) {
  BlockedSmem& s = *reinterpret_cast<BlockedSmem*>(dynamic_smem());
  const int t = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * kBlocked * kBlocked;
  const float* Cb = C + off;
  float* Mb = M + off;
  float* A = s.outer[0];  // then S
  float* Bm = s.outer[1];  // then V Si
  float* D = s.outer[2];  // then Si
  float* Ai = s.outer[3];
  float* W = s.outer[4];
  float* V = s.outer[5];
  KERNEL_PROBE(0, 0);
  // A, Bm and D in 16-byte pieces, a warp reading four rows of 128 bytes
  constexpr int pieces = kHalf * kHalf / 4;
  for (int e = t; e < 3 * pieces; e += kBlockedThreads) {
    const int q = e / pieces, a = (e % pieces) / (kHalf / 4), c = 4 * (e % (kHalf / 4));
    const float* src = Cb + (q == 2 ? kHalf + a : a) * kBlocked + (q == 0 ? c : kHalf + c);
    *reinterpret_cast<float4*>(s.outer[q] + a * kLdO + c) = *reinterpret_cast<const float4*>(src);
  }
  __syncthreads();
  KERNEL_PROBE(0, 1);
  inverse32(A, Ai, V, t, 2);
  if (t < 64) {
    product<kHalf, 4, 4, true>(Bm, kLdO, Ai, kLdO, t, Store<4>{W, kLdO, 1.0f});
  } else {
    product<kHalf, 4, 4, false>(Ai, kLdO, Bm, kLdO, t - 64, Store<4>{V, kLdO, 1.0f});
  }
  __syncthreads();
  KERNEL_PROBE(0, 8);
  float* S = A;
  product<kHalf, 2, 4, false>(W, kLdO, Bm, kLdO, t, StoreSum<4>{S, kLdO, D, kLdO, -1.0f});
  __syncthreads();
  KERNEL_PROBE(0, 9);
  float* Si = D;
  inverse32(S, Si, Bm, t, 10);
  float* VSi = Bm;
  if (t < 64) {
    product<kHalf, 4, 4, false>(V, kLdO, Si, kLdO, t, Store<4>{Mb + kHalf, kBlocked, -1.0f, VSi, kLdO});
  } else {
    product<kHalf, 4, 4, false>(Si, kLdO, W, kLdO, t - 64, Store<4>{Mb + kHalf * kBlocked, kBlocked, -1.0f});
  }
  for (int e = t; e < pieces; e += kBlockedThreads) {
    const int a = e / (kHalf / 4), c = 4 * (e % (kHalf / 4));
    *reinterpret_cast<float4*>(Mb + (kHalf + a) * kBlocked + kHalf + c) =
        *reinterpret_cast<const float4*>(Si + a * kLdO + c);
  }
  __syncthreads();
  KERNEL_PROBE(0, 16);
  product<kHalf, 2, 4, false>(VSi, kLdO, W, kLdO, t, StoreSum<4>{Mb, kBlocked, Ai, kLdO, 1.0f});
  KERNEL_PROBE(0, 17);
}

}  // namespace

// The launchers: host code, which the CPU emulation of the kernels
// (tools/emulate_thomas.py) leaves out.
#ifndef KERNEL_EMULATION
namespace {

template <int KP>
int flat_launch(const float* C, float* M, int batch, int k, cudaStream_t stream) {
  bgj_flat_kernel<KP><<<batch, kFlatGroups * KP, 4 * KP * sizeof(float), stream>>>(C, M, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bgj_flat_max_k() { return kFlatMaxK; }

int bgj_flat_launch(const float* C, float* M, int batch, int k,
                    cudaStream_t stream) {
  if (batch <= 0 || k <= 0 || k > kFlatMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return k <= 32 ? flat_launch<32>(C, M, batch, k, stream)
                 : k <= 64 ? flat_launch<64>(C, M, batch, k, stream)
                           : flat_launch<96>(C, M, batch, k, stream);
}

int bgj_blocked64_launch(const float* C, float* M, int batch,
                         cudaStream_t stream) {
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bgj_blocked64_kernel<<<batch, kBlockedThreads, sizeof(BlockedSmem), stream>>>(C, M);
  return static_cast<int>(cudaGetLastError());
}

const char* bgj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif  // KERNEL_EMULATION
