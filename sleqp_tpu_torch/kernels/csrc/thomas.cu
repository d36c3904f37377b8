// Streaming block Thomas for SPD block-tridiagonal systems, in float32,
// for the explicit-inverse solve of sleqp_tpu_torch/ops/pallas_tridiag.py.
//
//   thomas_fwd  replaces sleqp_tpu/ops/pallas_tridiag.py::_fwd_stream_kernel.
//               With factor = 1, per stage i = 0..N-1:
//                 C_i = D_i - L_{i-1} (M_{i-1} L_{i-1}^T),
//                 M_i = C_i^-1 (k Gauss-Jordan sweeps),
//                 y_i = M_i (b_i - L_{i-1} y_{i-1}),
//               writing M and y.  With factor = 0, D holds stored inverses
//               M and only the substitution runs.
//   thomas_bwd  replaces ::_bwd_stream_kernel: back to front,
//               x_i = y_i - M_i (L_i^T x_{i+1}), x_{N-1} = y_{N-1}.
//
// Both take Lp with Lp[i] = L[i-1] and Lp[0] = 0 (the reference's shifted
// couplings); thomas_bwd reads L_i as Lp[i+1], so it needs no second
// shifted copy.  The recursion is one chain, so each kernel is ONE thread
// block that walks all N stages: 256 compute threads and a copy warp.
// Blocks are padded to kp = 32 or 64 rows and columns (zeros, and identity
// on the diagonal blocks' padding), so no inner loop has a ragged edge.
//
// What bounds them on this card is one SM's dependent chain, not the
// card's bytes or operations (PERF.md, tools/thomas_probe.py):
//   - Operands: the copy warp has the copy engine (TMA) move each stage's
//     k x k blocks, a 2D box of 32 columns and k rows per 32 columns with
//     the 128-byte swizzle and zero fill beyond k, into a ring of up to
//     four stage slots, while the compute threads work on earlier stages;
//     mbarriers hand the slots over (full: copies landed; empty: last
//     reader done), so no copy sits on the chain.  The swizzle (`at`)
//     keeps rows, columns and 16-byte pieces of 4 or 8 rows free of bank
//     conflicts.  Blocks whose rows are not 16-byte multiples go by
//     cp.async, a float at a time, into the same layout.
//   - With factor, the coupling products are register-tiled, kp/16 x kp/16
//     outputs a thread, 16-byte loads along m; M_{i-1} L^T is stored
//     transposed so both products read rows.  Each output is one FMA chain
//     over m in index order, as a CPU matrix product sums it.
//   - The inverse is Gauss-Jordan in place on a kp x kp array held in the
//     registers of 4 kp threads (gj.cuh): the tableau [A | I]'s
//     arithmetic on the entries that are not trivially 0 or 1, so M equals
//     the plain version's bit for bit with half the tableau's FMAs.  Each
//     sweep is a barrier, a load, a division and the FMAs: ~280 cycles at
//     kp = 64, most of a stage.
//   - The substitutions (all of the resolve mode and thomas_bwd) are
//     mat-vecs whose matrices are known ahead: a group of 256 / kp lanes
//     per (row, right-hand side), summed by shuffles.
// Every product is a float32 FMA (never TF32).
//
// Plain C interface, built with plain nvcc and loaded through ctypes
// (sleqp_tpu_torch/kernels/_build.py); each launcher returns
// cudaGetLastError().

#include <cstdint>

#ifndef KERNEL_EMULATION  // tools/emulate_thomas.py brings its own
#include <cuda.h>
#include <cuda_runtime.h>

#include "staging.cuh"
#endif

#include "gj.cuh"

namespace {

constexpr int kMaxK = 64;  // pallas_tridiag.MAX_PALLAS_BLOCK
// right-hand sides per launch (pallas_tridiag.RHS_TILE)
constexpr int kMaxR = 128;
constexpr int kMaxRing = 4;             // stage slots in shared memory
constexpr int kThreads = 256;           // compute threads: 8 warps
constexpr int kBlock = kThreads + 32;   // and the copy warp
constexpr size_t kMaxSmem = 232448;     // what one block may take on sm_90
constexpr size_t kAlign = 1024;         // the swizzled boxes' alignment
constexpr unsigned kFull = 0xffffffffu;

// The warp waits for bar's phase of this parity: lane 0 polls, the others
// wait at the warp's barrier, which also shows them what the phase brought.
__device__ __forceinline__ void wait_warp(uint64_t* bar, unsigned parity) {
  if ((threadIdx.x & 31) == 0) copy_async_bar_wait(bar, parity);
  __syncwarp();
}

// A barrier of the compute threads alone (the copy warp runs on).
__device__ __forceinline__ void sync_compute() { sync_threads(1, kThreads); }

// The Gauss-Jordan inverse at padded width kp runs on the first 4 kp
// threads, kp/4 rows of one column each (on the H100, tools/thomas_probe.py:
// 16 rows a thread at kp = 64 beat 32, and 8 at kp = 32 beat 4; PERF.md).
template <int KP>
constexpr int kGJThreads = 4 * KP;

// A barrier of the threads that invert.
template <int KP>
struct SyncGJ {
  __device__ void operator()() const { sync_threads(2, kGJThreads<KP>); }
};

// The offset of entry (a, c) of a kp x kp tile in shared memory, as the
// copy engine lays out its boxes with the 128-byte swizzle: box c / 32
// holds kp rows of 128 bytes, and the 16-byte piece c / 4 of row a sits at
// piece (c / 4) ^ (a % 8).
template <int KP>
__device__ __forceinline__ int at(int a, int c) {
  return (c >> 5) * (KP * 32) + a * 32 + ((((c >> 2) & 7) ^ (a & 7)) << 2) + (c & 3);
}

// The copy warp's part of a stage: the k x k blocks A and, unless L is
// null, L (rows rA and rL of the maps) into the tiles At and Lt, and the
// k x r right-hand sides v into r rows of V (leading dimension ld).  With
// tma, lane 0 has the copy engine move the blocks' boxes, and v if vbulk
// (r = 1); the rest the warp copies a float at a time (cp.async) and waits
// for.  Lane 0 then arrives on full, announcing the copy engine's bytes.
template <int KP>
__device__ void copy_stage(float* At, float* Lt, float* V, int ld, const CUtensorMap* mapA,
                           const CUtensorMap* mapL, int rA, int rL, const float* A,
                           const float* L, const float* v, int k, int r, bool tma, bool vbulk,
                           uint64_t* full) {
  const int lane = threadIdx.x & 31;
  if (!tma) {
    for (int e = lane; e < k * k; e += 32) {
      const int a = e / k, o = at<KP>(a, e - a * k);
      copy_async(At + o, A + e);
      if (L) copy_async(Lt + o, L + e);
    }
  }
  if (!vbulk) {
    for (int e = lane; e < k * r; e += 32) {
      const int a = e / r;
      copy_async(V + (e - a * r) * ld + a, v + e);
    }
  }
  copy_async_wait();
  __syncwarp();
  if (lane == 0) {
    const unsigned box = 32 * 4 * k;  // bytes of a box, its zero fill included
    copy_async_bar_expect(full, (tma ? (L ? 2 : 1) * (KP / 32) * box : 0) + (vbulk ? 4 * k : 0));
    for (int b = 0; tma && b < KP / 32; ++b) {
      copy_async_tile(At + b * KP * 32, mapA, 32 * b, rA, full);
      if (L) copy_async_tile(Lt + b * KP * 32, mapL, 32 * b, rL, full);
    }
    if (vbulk) copy_async_bulk(V, v, 4 * k, full);
  }
}

// A group of kThreads / kp lanes (l its lane) forms sum_m A[a][m] v[m] over
// the kp entries of row a of a tile A and a vector v: lane l takes the
// 16-byte pieces l + LPR h (h in an order that lets two rows in a quarter
// warp read 8 distinct pieces), in four partial sums, and the group adds
// its lanes by shuffles.  The offsets are the thread's for the whole
// kernel, so they are formed once.
template <int KP>
struct RowDot {
  static constexpr int LPR = kThreads / KP, H = KP / (4 * LPR);
  int tile[H], vec[H];

  __device__ RowDot(int a, int l) {
    const int flip = LPR == 4 ? (a & 1) : 0;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      vec[h] = 4 * (l + LPR * (h ^ flip));
      tile[h] = at<KP>(a, vec[h]);
    }
  }

  __device__ float operator()(const float* A, const float* v) const {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(A + tile[h]);
      const float4 y = *reinterpret_cast<const float4*>(v + vec[h]);
      acc.x = fmaf(x.x, y.x, acc.x);
      acc.y = fmaf(x.y, y.y, acc.y);
      acc.z = fmaf(x.z, y.z, acc.z);
      acc.w = fmaf(x.w, y.w, acc.w);
    }
    float s = (acc.x + acc.y) + (acc.z + acc.w);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    return s;
  }
};

// The same over column m of a tile A: sum_a A[a][m] x[a], lane l taking
// a = l + LPR s (s in an order that lets the warp's columns read 32
// distinct banks).
template <int KP>
struct ColDot {
  static constexpr int LPR = kThreads / KP, S = KP / LPR;
  int tile[S], vec[S];

  __device__ ColDot(int m, int l) {
    const int flip = LPR == 4 ? (m >> 2) & 1 : 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      vec[s] = l + LPR * (s ^ flip);
      tile[s] = at<KP>(vec[s], m);
    }
  }

  __device__ float operator()(const float* A, const float* x) const {
    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
    for (int s = 0; s < S; s += 2) {
      acc0 = fmaf(A[tile[s]], x[vec[s]], acc0);
      acc1 = fmaf(A[tile[s + 1]], x[vec[s + 1]], acc1);
    }
    float t = acc0 + acc1;
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
    return t;
  }
};

// The kp x kp product P[a][c] = sum_m A[a][m] B[c][m] of two tiles, each
// entry one FMA chain over m in order.  A warp takes 4 kp/16 rows and
// 8 kp/16 columns, a thread rows a0 + 4u and columns c0 + 8v (u, v <
// kp/16); with transpose it stores out[c][a] = P[a][c], else
// out[a][c] -= P[a][c].
template <int KP, bool kTranspose>
__device__ __forceinline__ void product(const float* A, const float* B, float* out) {
  constexpr int RT = KP / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a0 = 4 * RT * (warp >> 1) + (lane >> 3);
  const int c0 = 8 * RT * (warp & 1) + (lane & 7);
  float acc[RT][RT];
#pragma unroll
  for (int u = 0; u < RT; ++u) {
#pragma unroll
    for (int v = 0; v < RT; ++v) acc[u][v] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < KP; m += 4) {
    float4 av[RT], bv[RT];
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      av[u] = *reinterpret_cast<const float4*>(A + at<KP>(a0 + 4 * u, m));
      bv[u] = *reinterpret_cast<const float4*>(B + at<KP>(c0 + 8 * u, m));
    }
#pragma unroll
    for (int u = 0; u < RT; ++u) {
#pragma unroll
      for (int v = 0; v < RT; ++v) {
        acc[u][v] = fmaf(av[u].x, bv[v].x, acc[u][v]);
        acc[u][v] = fmaf(av[u].y, bv[v].y, acc[u][v]);
        acc[u][v] = fmaf(av[u].z, bv[v].z, acc[u][v]);
        acc[u][v] = fmaf(av[u].w, bv[v].w, acc[u][v]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < RT; ++u) {
#pragma unroll
    for (int v = 0; v < RT; ++v) {
      const int a = a0 + 4 * u, c = c0 + 8 * v;
      if (kTranspose) {
        out[at<KP>(c, a)] = acc[u][v];
      } else {
        out[at<KP>(a, c)] -= acc[u][v];
      }
    }
  }
}

// M = C^-1 for the SPD tile C (identity beyond k) by gj.cuh's in-register
// Gauss-Jordan, on the first kGJThreads threads: thread t holds rows
// r0 + u (u < kp/4, r0 = kp/4 (t / kp)) of column c = t % kp.  R and F
// (2 kp floats each) are its pivot slots.  Writes M into the tile Ms and
// the k x k block Mout.  A sweep is one barrier, a division and a few
// loads on the chain.
template <int KP>
__device__ __forceinline__ void invert_stage(const float* C, int k, float* R, float* F, float* Ms,
                                             float* Mout) {
  constexpr int RPT = KP / 4;
  const int c = threadIdx.x % KP, r0 = RPT * (threadIdx.x / KP);
  float w[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) w[u] = C[at<KP>(r0 + u, c)];
  gauss_jordan<KP, RPT>(w, k, R, F, c, r0, SyncGJ<KP>{});
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int a = r0 + u;
    Ms[at<KP>(a, c)] = w[u];
    if (a < k && c < k) Mout[a * k + c] = w[u];
  }
}

// A position in the ring of nb stage slots: the slot and the parity of
// its mbarriers' phase (how often the ring has wrapped, mod 2).
struct Ring {
  int slot = 0;
  unsigned parity = 0;
  __device__ void next(int nb) {
    if (++slot == nb) slot = 0, parity ^= 1;
  }
};

// The block's shared memory, from its first kAlign boundary on.
__device__ __forceinline__ float* aligned_smem(float4* smem4) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem4));
  return reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + (kAlign - s % kAlign) % kAlign);
}

template <int KP>
__global__ void __launch_bounds__(kBlock, 1)
thomas_fwd_kernel(const __grid_constant__ CUtensorMap mapD, const __grid_constant__ CUtensorMap mapL,
                  const float* __restrict__ D, const float* __restrict__ Lp,
                  const float* __restrict__ b, float* __restrict__ y,
                  float* __restrict__ M, int n, int k, int r, int factor, int nb, int tma) {
  float* smem = aligned_smem(dynamic_smem());
  constexpr int ld = KP + 4, tile = KP * KP, LPR = kThreads / KP;
  const int vec = r * ld;
  float* Ms = smem;                  // M_{i-1}, then M_i
  float* T1t = Ms + tile;            // (M_{i-1} L^T)^T
  float* ring = T1t + tile;          // nb slots of two tiles: D_i (or M_i), L_{i-1}
  float* yT = ring + 2 * nb * tile;  // y_{i-1}, then y_i: r rows of ld
  float* bT = yT + vec;              // nb slots of b_i (r rows of ld)
  float* R = bT + nb * vec;          // the sweeps' slots: R, F (2 kp each)
  float* F = R + 2 * KP;
  uint64_t* full = reinterpret_cast<uint64_t*>(F + 2 * KP);  // a slot's copies landed
  uint64_t* empty = full + nb;                          // a slot's last reader is done
  const size_t kk = static_cast<size_t>(k) * k, kr = static_cast<size_t>(k) * r;
  // zeros, and identity on the diagonal of the D tiles' padding; copies
  // write only the k x k (k x r) blocks, so the padding stays
  for (int e = threadIdx.x; e < (2 + 2 * nb) * tile + (nb + 1) * vec + 4 * KP; e += blockDim.x) {
    smem[e] = 0.0f;
  }
  __syncthreads();
  for (int e = k + threadIdx.x; e < KP; e += blockDim.x) {
    for (int s = 0; s < nb; ++s) ring[2 * s * tile + at<KP>(e, e)] = 1.0f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * nb; ++s) copy_async_bar_init(full + s);
  }
  copy_async_fence();
  __syncthreads();
  if (threadIdx.x >= kThreads) {  // the copy warp: stage i once stage i - nb is done
    const bool vbulk = tma && r == 1;
    Ring pos;
    for (int i = 0; i < n; ++i, pos.next(nb)) {
      const int s = pos.slot;
      if (i >= nb) wait_warp(empty + s, pos.parity ^ 1);
      copy_stage<KP>(ring + 2 * s * tile, ring + (2 * s + 1) * tile, bT + s * vec, ld, &mapD,
                     &mapL, i * k, i * k, D + i * kk, Lp + i * kk, b + i * kr, k, r, tma, vbulk,
                     full + s);
    }
    return;
  }
  const int l = threadIdx.x % LPR, grp = threadIdx.x / LPR;  // grp < kp
  const RowDot<KP> dot(grp, l);
  Ring pos;
  for (int i = 0, prev = 0; i < n; ++i, prev = pos.slot, pos.next(nb)) {
    const int s = pos.slot;
    wait_warp(full + s, pos.parity);
    sync_compute();
    KERNEL_PROBE(i, factor ? 0 : 10);
    // every compute thread is done with stage i-1: its slot may be refilled
    if (threadIdx.x == 0 && i > 0) copy_async_bar_arrive(empty + prev);
    float* Ds = ring + 2 * s * tile;
    const float* Ls = Ds + tile;
    float* vT = bT + s * vec;
    // v = b_i - L y_{i-1}, in place of b_i
    for (int q = 0; q < r; ++q) {
      const float t = dot(Ls, yT + q * ld);
      if (l == 0) vT[q * ld + grp] -= t;
    }
    KERNEL_PROBE(i, (factor ? 0 : 10) + 2);
    const float* Mi = Ds;
    if (factor) {
      product<KP, true>(Ms, Ls, T1t);
      sync_compute();
      KERNEL_PROBE(i, 3);
      product<KP, false>(Ls, T1t, Ds);  // C_i = D_i - L T1, in place
      sync_compute();
      KERNEL_PROBE(i, 4);
      if (threadIdx.x < kGJThreads<KP>) invert_stage<KP>(Ds, k, R, F, Ms, M + i * kk);
      KERNEL_PROBE(i, 5);
      Mi = Ms;
    }
    sync_compute();
    KERNEL_PROBE(i, (factor ? 0 : 10) + 6);
    // y_i = M_i v
    for (int q = 0; q < r; ++q) {
      const float t = dot(Mi, vT + q * ld);
      if (l == 0 && grp < k) {
        yT[q * ld + grp] = t;
        y[i * kr + grp * r + q] = t;
      }
    }
    KERNEL_PROBE(i, (factor ? 0 : 10) + 7);
    // v and C went into the slot, which the copy engine refills
    copy_async_fence();
  }
}

template <int KP>
__global__ void __launch_bounds__(kBlock, 1)
thomas_bwd_kernel(const __grid_constant__ CUtensorMap mapM, const __grid_constant__ CUtensorMap mapL,
                  const float* __restrict__ M, const float* __restrict__ Lp,
                  const float* __restrict__ y, float* __restrict__ x, int n, int k, int r, int nb,
                  int tma) {
  float* smem = aligned_smem(dynamic_smem());
  constexpr int ld = KP + 4, tile = KP * KP, LPR = kThreads / KP;
  const int vec = r * ld;
  float* ring = smem;                // nb slots of two tiles: M_i, L_i
  float* xT = ring + 2 * nb * tile;  // x_{i+1}, then x_i: r rows of ld
  float* tT = xT + vec;              // L_i^T x_{i+1}
  float* yT = tT + vec;              // nb slots of y_i (r rows of ld)
  uint64_t* full = reinterpret_cast<uint64_t*>(yT + nb * vec);
  uint64_t* empty = full + nb;
  const size_t kk = static_cast<size_t>(k) * k, kr = static_cast<size_t>(k) * r;
  for (int e = threadIdx.x; e < 2 * nb * tile + (nb + 2) * vec; e += blockDim.x) smem[e] = 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * nb; ++s) copy_async_bar_init(full + s);
  }
  copy_async_fence();
  __syncthreads();
  // step s is stage n-1-s; the last stage has no coupling, and its slot's
  // coupling tile stays 0 (as does x_{i+1})
  if (threadIdx.x >= kThreads) {
    const bool vbulk = tma && r == 1;
    Ring pos;
    for (int s = 0; s < n; ++s, pos.next(nb)) {
      const int i = n - 1 - s, sl = pos.slot;
      if (s >= nb) wait_warp(empty + sl, pos.parity ^ 1);
      copy_stage<KP>(ring + 2 * sl * tile, ring + (2 * sl + 1) * tile, yT + sl * vec, ld, &mapM,
                     &mapL, i * k, (i + 1) * k, M + i * kk,
                     i + 1 < n ? Lp + (i + 1) * kk : nullptr, y + i * kr, k, r, tma, vbulk,
                     full + sl);
    }
    return;
  }
  const int l = threadIdx.x % LPR, grp = threadIdx.x / LPR;
  const RowDot<KP> dot(grp, l);
  const ColDot<KP> tdot(grp, l);
  Ring pos;
  for (int s = 0, prev = 0; s < n; ++s, prev = pos.slot, pos.next(nb)) {
    const int sl = pos.slot, i = n - 1 - s;
    wait_warp(full + sl, pos.parity);
    sync_compute();
    KERNEL_PROBE(s, 20);
    if (threadIdx.x == 0 && s > 0) copy_async_bar_arrive(empty + prev);
    const float* Ms = ring + 2 * sl * tile;
    const float* Ls = Ms + tile;
    const float* yi = yT + sl * vec;
    // t = L_i^T x_{i+1}
    for (int q = 0; q < r; ++q) {
      const float t = tdot(Ls, xT + q * ld);
      if (l == 0) tT[q * ld + grp] = t;
    }
    sync_compute();
    KERNEL_PROBE(s, 22);
    // x_i = y_i - M_i t
    for (int q = 0; q < r; ++q) {
      const float v = yi[q * ld + grp] - dot(Ms, tT + q * ld);
      if (l == 0 && grp < k) {
        xT[q * ld + grp] = v;
        x[i * kr + grp * r + q] = v;
      }
    }
    KERNEL_PROBE(s, 23);
  }
}

// Shared memory of a launch: a fixed part and nb ring slots of one
// stage's operands (two tiles and r rows of kp + 4), as many as fit, at
// most kMaxRing (nb < 2 if not even two fit); two mbarriers per slot and
// the alignment of the tiles on top.
struct Layout {
  size_t fixed, slot;  // floats
  int nb;
  size_t bytes() const {
    return (fixed + nb * slot) * sizeof(float) + 2 * nb * sizeof(uint64_t) + kAlign;
  }
};

Layout layout(int kp, int r, bool fwd) {
  const size_t tile = kp * kp, vec = r * (kp + 4);
  // fwd: M, T1t, y and the sweeps' slots; bwd: x and t
  const size_t fixed = fwd ? 2 * tile + vec + 4 * kp : 2 * vec;
  const size_t slot = 2 * tile + vec;
  const size_t room = (kMaxSmem - kAlign) / sizeof(float) - fixed;
  const size_t fit = room / (slot + 4);
  return {fixed, slot, static_cast<int>(fit < kMaxRing ? fit : kMaxRing)};
}

}  // namespace

// The launchers: host code, which the CPU emulation of the kernels
// (tools/emulate_thomas.py) leaves out.
#ifndef KERNEL_EMULATION
namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (so the library needs no link to libcuda); null if it is missing.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Whether the copy engine takes n k x k blocks at base: rows of 16-byte
// multiples, 16-byte aligned.
bool tma_takes(const float* base, int k) {
  return k % 4 == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
}

// map describes the n k x k blocks at base as an (n k) x k array read in
// boxes of 32 columns and k rows, 128-byte swizzle, zero fill beyond k
// columns.  Returns a CUDA error code, 0 on success.
int tile_map(CUtensorMap* map, const float* base, int n, int k) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n) * k};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * sizeof(float)};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(k)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                              dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Maps of A and B when the copy engine takes both (tma = 1), else tma = 0
// and the kernel copies by cp.async.
int maps(CUtensorMap* mapA, CUtensorMap* mapB, const float* A, const float* B, int n, int k,
         int* tma) {
  *mapA = CUtensorMap{};
  *mapB = CUtensorMap{};
  *tma = tma_takes(A, k) && tma_takes(B, k);
  if (!*tma) return 0;
  const int err = tile_map(mapA, A, n, k);
  return err != 0 ? err : tile_map(mapB, B, n, k);
}

template <int KP>
int fwd_launch(const float* D, const float* Lp, const float* b, float* y, float* M, int n,
               int k, int r, int factor, cudaStream_t stream) {
  const Layout lay = layout(KP, r, true);
  if (lay.nb < 2) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mapD, mapL;
  int tma;
  int err = maps(&mapD, &mapL, D, Lp, n, k, &tma);
  if (err != 0) return err;
  // the right-hand sides' bulk copy (r = 1) needs b aligned as well
  tma = tma && (r > 1 || (reinterpret_cast<uintptr_t>(b) & 15) == 0);
  err = set_smem(reinterpret_cast<const void*>(thomas_fwd_kernel<KP>), lay.bytes());
  if (err != 0) return err;
  thomas_fwd_kernel<KP><<<1, kBlock, lay.bytes(), stream>>>(mapD, mapL, D, Lp, b, y, M, n, k, r,
                                                             factor, lay.nb, tma);
  return static_cast<int>(cudaGetLastError());
}

template <int KP>
int bwd_launch(const float* M, const float* Lp, const float* y, float* x, int n, int k, int r,
               cudaStream_t stream) {
  const Layout lay = layout(KP, r, false);
  if (lay.nb < 2) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mapM, mapL;
  int tma;
  int err = maps(&mapM, &mapL, M, Lp, n, k, &tma);
  if (err != 0) return err;
  tma = tma && (r > 1 || (reinterpret_cast<uintptr_t>(y) & 15) == 0);
  err = set_smem(reinterpret_cast<const void*>(thomas_bwd_kernel<KP>), lay.bytes());
  if (err != 0) return err;
  thomas_bwd_kernel<KP><<<1, kBlock, lay.bytes(), stream>>>(mapM, mapL, M, Lp, y, x, n, k, r,
                                                             lay.nb, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int thomas_fwd_launch(const float* D, const float* Lp, const float* b,
                      float* y, float* M, int n, int k, int r, int factor,
                      cudaStream_t stream) {
  if (n <= 0 || k <= 0 || k > kMaxK || r <= 0 || r > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return k <= 32 ? fwd_launch<32>(D, Lp, b, y, M, n, k, r, factor, stream)
                 : fwd_launch<64>(D, Lp, b, y, M, n, k, r, factor, stream);
}

int thomas_bwd_launch(const float* M, const float* Lp, const float* y,
                      float* x, int n, int k, int r, cudaStream_t stream) {
  if (n <= 0 || k <= 0 || k > kMaxK || r <= 0 || r > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return k <= 32 ? bwd_launch<32>(M, Lp, y, x, n, k, r, stream)
                 : bwd_launch<64>(M, Lp, y, x, n, k, r, stream);
}

}  // extern "C"
#endif  // KERNEL_EMULATION
