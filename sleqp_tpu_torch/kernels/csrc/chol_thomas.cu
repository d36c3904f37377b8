// Batched Cholesky block Thomas for SPD block-tridiagonal systems, in
// float32, for sleqp_tpu_torch/ops/pallas_chol_tridiag.py.  P independent
// chains (SPIKE chunks) of c stages; one thread block of 16 warps per chain.
//
//   chol_thomas_factor  replaces
//       sleqp_tpu/ops/pallas_chol_tridiag.py::_factor_kernel.  Per stage
//       i >= 1: Z = L_i G_{i-1}^-T by one blocked forward substitution
//       (kSub columns at a time: the block forms every (row, column) sum
//       over the earlier columns, then a thread per row solves the
//       columns' kSub x kSub triangle), C_i = D_i - Z Z^T on the lower
//       triangle (L_i C_{i-1}^-1 L_i^T, which the reference forms with two
//       solves and a full product), then a blocked right-looking Cholesky
//       of C_i: one warp factors each panel of 16 columns in registers with
//       shuffles, the block applies the panel to the trailing lower
//       triangle; two barriers per panel.  Z and the Cholesky go through
//       the same FMAs in the same order as the plain version's column-by-
//       column forms.  The factors go to a fresh output tensor, zero above
//       the diagonal (the reference aliases D).
//   chol_thomas_solve   replaces ::_solve_kernel: the forward sweep
//       s_i = C_i^-1 (b_i - L_i s_{i-1}) and the backward sweep
//       x_i = s_i - C_i^-1 L_{i+1}^T x_{i+1} against the stored factors
//       (lower, zero above the diagonal, as chol_thomas_factor writes
//       them).  A warp per right-hand side (rows spread over the warps),
//       the row in registers, k/32 entries a lane; one barrier a stage,
//       which hands over the staged operands.
//
// The solve's substitutions are column-oriented and go kSub entries at a
// time: every lane gathers the next kSub entries from their owners by
// shuffles, solves their kSub x kSub diagonal block itself, the owners
// keep them, and every lane takes them from its own later entries.
// Entries are multiplied by 1/G_jj, which the factorization keeps as it
// writes each factor and the solve's copying warps take from device
// memory, off the chain.  The inner loops are free of branches: tiles are
// padded with zeros to kp = 32 ceil(k/32) rows and columns and factors are
// zero above the diagonal, so a product with a padding or upper entry
// changes nothing.
//
// What bounds both kernels on this card is not bytes or operations but
// one warp's dependent chain: per kSub entries of a substitution a round
// of shuffles and ~2 kSub dependent multiply-adds, behind ~20 shared-
// memory loads that share the shuffles' pipe (4k entries a stage in the
// solve); in the factorization the 16-column panels (a shuffle, a
// reciprocal square root and two multiply-adds per column) and the
// k/4 + k/8 + 2 barriers of a stage (26 at k = 64).
//
// Operands are staged into shared memory with cp.async, rows of kp + 4
// floats (so a lane's 4-column vector load and a warp's column read are
// free of bank conflicts, and rows stay 16-byte aligned).  Where the next
// stage's tiles fit beside the current ones they are copied while the
// current stage computes, in the solve by the warps that have no
// right-hand side; otherwise each stage waits for its copies.  The
// factorization keeps 3 D/C/factor tiles and 2 L/Z tiles (89 KB at
// k = 64), or 2 + 1 without overlap from k = 97 (204 KB at k = 128).  The
// solve keeps factor, coupling and right-hand sides of two stages and the
// carry of r rows (169 KB at k = 64, r = 128), or factor and coupling of
// one stage, the right-hand sides read from device memory, where two do
// not fit (202 KB at k = 128, r = 128).  Every product is a float32 FMA
// loop, never TF32.  Lp[i] = L[i-1] with Lp[0] = 0, as the reference; the
// right-hand sides come in its public (P, c, k, r) layout.
//
// Plain C interface, built with plain nvcc and loaded through ctypes
// (sleqp_tpu_torch/kernels/_build.py); each launcher returns
// cudaGetLastError().

#include <cstdint>

#ifndef KERNEL_EMULATION  // tools/emulate_thomas.py brings its own
#include <cuda_runtime.h>

#include "staging.cuh"
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 128;  // pallas_chol_tridiag.MAX_CHOL_BLOCK
// right-hand sides per launch (pallas_chol_tridiag.RHS_TILE)
constexpr int kMaxR = 128;
constexpr int kProdRows = 4; // rows of Z Z^T one warp forms at once
constexpr int kPanel = 16;   // columns of a Cholesky panel
constexpr int kSub = 8;      // entries a substitution solves per shuffle round
constexpr size_t kMaxSmem = 232448;  // what one block may take on sm_90
constexpr unsigned kFull = 0xffffffffu;
// the reciprocal diagonal 1/G_jj of up to three factors (0 from k up)
constexpr size_t kRinv = 3 * kMaxK * sizeof(float);

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The rows x cols block src (row-major) into dst (leading dimension ld),
// by nw warps from warp w0 on.
__device__ void stage_rows(float* dst, int ld, const float* src, int rows, int cols, int w0,
                           int nw) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0;
  const bool wide = cols % 4 == 0 && aligned16(src);
  const int step = wide ? 4 : 1;
  for (int a = warp; a < rows; a += nw) {
    for (int b = lane * step; b < cols; b += 32 * step) {
      copy_async(dst + a * ld + b, src + a * cols + b, wide);
    }
  }
}

// The strictly lower kSub x kSub diagonal block of G at (j0, j0), gd[a][b]
// = G[j0 + a][j0 + b] for b < a, and rinv[j0, j0 + kSub): 16-byte loads
// that every lane of the warp makes alike.
__device__ __forceinline__ void load_block(float (&gd)[kSub][kSub], float (&rv)[kSub],
                                           const float* G, int ld, const float* rinv,
                                           int j0) {
#pragma unroll
  for (int a = 1; a < kSub; ++a) {
#pragma unroll
    for (int b = 0; b < a; b += 4) {
      const float4 v = *reinterpret_cast<const float4*>(G + (j0 + a) * ld + j0 + b);
      gd[a][b] = v.x, gd[a][b + 1] = v.y, gd[a][b + 2] = v.z, gd[a][b + 3] = v.w;
    }
  }
#pragma unroll
  for (int a = 0; a < kSub; a += 4) {
    const float4 v = *reinterpret_cast<const float4*>(rinv + j0 + a);
    rv[a] = v.x, rv[a + 1] = v.y, rv[a + 2] = v.z, rv[a + 3] = v.w;
  }
}

// The block's entry that lane l0 + a owns, z[a], for the lanes of the
// block (a select per entry, so z stays in registers).
__device__ __forceinline__ float own_entry(const float (&z)[kSub], int lane, int l0) {
  float v = z[0];
#pragma unroll
  for (int a = 1; a < kSub; ++a) v = lane == l0 + a ? z[a] : v;
  return v;
}

// y[t] for the runtime t: a select per register, so y stays in registers.
template <int NT>
__device__ __forceinline__ float pick(const float (&y)[NT], int t) {
  float v = y[0];
#pragma unroll
  for (int u = 1; u < NT; ++u) v = t == u ? y[u] : v;
  return v;
}

// A warp's row y (entry j = 32 t + lane in y[t], 0 from k up) becomes z
// with z G^T = y, G lower triangular with zeros above in shared memory:
// z_j = y_j * rinv_j after y_j has lost G_jm z_m for every m < j, in order
// of m.  One loop trip per kSub entries; its loads are issued first, so
// their latency hides behind the shuffles.
template <int NT>
__device__ __forceinline__ void forward_subst(float (&y)[NT], const float* G, int ld,
                                              int lane, const float* rinv) {
#pragma unroll 1
  for (int j0 = 0; j0 < 32 * NT; j0 += kSub) {
    const int t = j0 >> 5, l0 = j0 & 31;
    float gd[kSub][kSub], rv[kSub], gl[NT][kSub];
    load_block(gd, rv, G, ld, rinv, j0);
#pragma unroll
    for (int t2 = 0; t2 < NT; ++t2) {
#pragma unroll
      for (int a = 0; a < kSub; a += 4) {
        const float4 v = *reinterpret_cast<const float4*>(G + (32 * t2 + lane) * ld + j0 + a);
        gl[t2][a] = v.x, gl[t2][a + 1] = v.y, gl[t2][a + 2] = v.z, gl[t2][a + 3] = v.w;
      }
    }
    float z[kSub];
    const float cur = pick(y, t);
#pragma unroll
    for (int a = 0; a < kSub; ++a) z[a] = __shfl_sync(kFull, cur, l0 + a);
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
#pragma unroll
      for (int b = 0; b < a; ++b) z[a] = fmaf(-gd[a][b], z[b], z[a]);
      z[a] *= rv[a];
    }
    // entry l loses G_la z_a (0 where l < j0 + a: above the diagonal), and
    // the block's own entries take their z
    const bool in_block = lane >= l0 && lane < l0 + kSub;
    const float mine = own_entry(z, lane, l0);
#pragma unroll
    for (int t2 = 0; t2 < NT; ++t2) {
      float v = y[t2];
#pragma unroll
      for (int a = 0; a < kSub; ++a) v = fmaf(-gl[t2][a], z[a], v);
      y[t2] = t2 == t && in_block ? mine : v;
    }
  }
}

// The row z becomes x with x G = z: from the last entry back,
// x_j = z_j * rinv_j after z_j has lost G_mj x_m for every m > j, in
// descending order of m.
template <int NT>
__device__ __forceinline__ void backward_subst(float (&y)[NT], const float* G, int ld,
                                               int lane, const float* rinv) {
#pragma unroll 1
  for (int j0 = 32 * NT - kSub; j0 >= 0; j0 -= kSub) {
    const int t = j0 >> 5, l0 = j0 & 31;
    float gd[kSub][kSub], rv[kSub], gl[NT][kSub];
    load_block(gd, rv, G, ld, rinv, j0);
#pragma unroll
    for (int t2 = 0; t2 < NT; ++t2) {
#pragma unroll
      for (int a = 0; a < kSub; ++a) gl[t2][a] = G[(j0 + a) * ld + 32 * t2 + lane];
    }
    float x[kSub];
    const float cur = pick(y, t);
#pragma unroll
    for (int a = 0; a < kSub; ++a) x[a] = __shfl_sync(kFull, cur, l0 + a);
#pragma unroll
    for (int a = kSub - 1; a >= 0; --a) {
#pragma unroll
      for (int b = kSub - 1; b > a; --b) x[a] = fmaf(-gd[b][a], x[b], x[a]);
      x[a] *= rv[a];
    }
    // entry l loses G_al x_a (0 where l > j0 + a), and the block's own
    // entries take their x
    const bool in_block = lane >= l0 && lane < l0 + kSub;
    const float mine = own_entry(x, lane, l0);
#pragma unroll
    for (int t2 = 0; t2 < NT; ++t2) {
      float v = y[t2];
#pragma unroll
      for (int a = kSub - 1; a >= 0; --a) v = fmaf(-gl[t2][a], x[a], v);
      y[t2] = t2 == t && in_block ? mine : v;
    }
  }
}

// Columns [j0, j0 + nb) of the right-looking Cholesky of C, by one warp:
// row j0 + 32 t + lane in p[t].  Column j: col = A[:, j] * rsqrt(A[j][j]),
// then the panel's later columns lose col col^T; every lane gathers the
// column's diagonal block unscaled and scales it itself.
template <int NT, bool kFull16>
__device__ __forceinline__ void factor_panel(float (&p)[NT][kPanel], int nb, int lane) {
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (kFull16 || j < nb) {
      float a[kPanel];
#pragma unroll
      for (int cc = j; cc < kPanel; ++cc) a[cc] = __shfl_sync(kFull, p[0][j], cc);
      const float d = rsqrtf(a[j]);
#pragma unroll
      for (int t = 0; t < NT; ++t) p[t][j] *= d;
#pragma unroll
      for (int cc = j + 1; cc < kPanel; ++cc) {
        if (kFull16 || cc < nb) {
          const float colc = a[cc] * d;
          const float upd = fmaf(-p[0][j], colc, p[0][cc]);
          p[0][cc] = lane >= cc ? upd : p[0][cc];
#pragma unroll
          for (int t = 1; t < NT; ++t) p[t][cc] = fmaf(-p[t][j], colc, p[t][cc]);
        }
      }
    }
  }
}

// Right-looking Cholesky of the SPD k x k C in shared memory (leading
// dimension ld), in place on the lower triangle, panel by panel: warp 0
// factors the panel, the block takes it from the trailing lower triangle,
// each entry's FMAs in column order.  Ends with a barrier.
template <int NT>
__device__ void cholesky_blocked(float* C, int ld, int k, int lane, int warp) {
  constexpr int kp = 32 * NT;
  const int nw = blockDim.x >> 5;
  for (int j0 = 0; j0 < k; j0 += kPanel) {
    const int nb = min(kPanel, k - j0);
    if (warp == 0) {
      float p[NT][kPanel];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // a row past the tile would be past k: its p is never written back
        const float* row = C + min(j0 + 32 * t + lane, kp - 1) * ld + j0;
#pragma unroll
        for (int cc = 0; cc < kPanel; cc += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + cc);
          p[t][cc] = v.x, p[t][cc + 1] = v.y, p[t][cc + 2] = v.z, p[t][cc + 3] = v.w;
        }
      }
      if (nb == kPanel) {
        factor_panel<NT, true>(p, nb, lane);
      } else {
        factor_panel<NT, false>(p, nb, lane);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int rr = 32 * t + lane, row = j0 + rr;
#pragma unroll
        for (int cc = 0; cc < kPanel; ++cc) {
          if (cc < nb && row < k && rr >= cc) C[row * ld + j0 + cc] = p[t][cc];
        }
      }
    }
    __syncthreads();
    // trailing update: warp per row a, lane per column b <= a
    const int j1 = j0 + nb;
    for (int a = j1 + warp; a < k; a += nw) {
      float la[kPanel];
#pragma unroll
      for (int j = 0; j < kPanel; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(C + a * ld + j0 + j);
        la[j] = v.x, la[j + 1] = v.y, la[j + 2] = v.z, la[j + 3] = v.w;
      }
      for (int b0 = j1; b0 <= a; b0 += 32) {
        const int b = min(b0 + lane, kp - 1);  // written only where b0 + lane <= a
        const float* Lb = C + b * ld + j0;
        float acc = C[a * ld + b];
#pragma unroll
        for (int j = 0; j < kPanel; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(Lb + j);
          acc = fmaf(-la[j], v.x, acc);
          acc = fmaf(-la[j + 1], v.y, acc);
          acc = fmaf(-la[j + 2], v.z, acc);
          acc = fmaf(-la[j + 3], v.w, acc);
        }
        if (b0 + lane <= a) C[a * ld + b] = acc;
      }
    }
    __syncthreads();
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
chol_thomas_factor_kernel(const float* __restrict__ D, const float* __restrict__ Lp,
                          float* __restrict__ chol, int c, int k, int nd, int nl) {
  float* smem = reinterpret_cast<float*>(dynamic_smem());
  constexpr int kp = 32 * NT;
  const int ld = kp + 4, tile = kp * ld, kk = k * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float* Ds = smem;              // nd tiles: D_i, then C_i, then its factor
  float* Ls = smem + nd * tile;  // nl tiles: L_i, then Z
  float* Rs = Ls + nl * tile;     // nd vectors: 1/G_jj of the factor in Ds
  const bool prefetch = nd == 3;
  const size_t base = static_cast<size_t>(blockIdx.x) * c * kk;
  // the padding stays 0: copies and writes touch only the k x k blocks
  for (int e = threadIdx.x; e < (nd + nl) * tile + nd * kMaxK; e += blockDim.x) smem[e] = 0.0f;
  __syncthreads();
  auto issue = [&](int i) {
    stage_rows(Ds + (i % nd) * tile, ld, D + base + static_cast<size_t>(i) * kk, k, k, 0, nw);
    if (i > 0) {
      stage_rows(Ls + (i % nl) * tile, ld, Lp + base + static_cast<size_t>(i) * kk, k, k, 0, nw);
    }
  };
  if (prefetch) issue(0);
  for (int i = 0; i < c; ++i) {
    // without prefetch, stage i's slots held stage i-2's factor and stage
    // i-1's Z, both last read before stage i-1's closing barriers
    if (!prefetch) issue(i);
    copy_async_wait();
    __syncthreads();
    KERNEL_PROBE(i, 0);
    // with prefetch, slot (i+1) % 3 held stage i-2's factor, last read
    // (as the previous factor, and to write it out) in stage i-1
    if (prefetch && i + 1 < c) issue(i + 1);
    float* C = Ds + (i % nd) * tile;
    if (i > 0) {
      const float* prev = Ds + ((i - 1) % nd) * tile;
      float* Z = Ls + (i % nl) * tile;
      const float* rinv = Rs + ((i - 1) % nd) * kMaxK;
      // Z = L_i G_{i-1}^-T, kSub columns at a time: z_j = (l_j - sum_{m<j}
      // G_jm z_m) * rinv_j.  The block takes each (row, column) pair's sum
      // over the earlier columns, then a thread per row solves the
      // columns' kSub x kSub triangle, continuing the same sum in order.
      for (int j0 = 0; j0 < k; j0 += kSub) {
        for (int e = threadIdx.x; e < k * kSub; e += blockDim.x) {
          const int a = e / kSub, cc = e % kSub;
          const float* Gj = prev + (j0 + cc) * ld;
          float* Za = Z + a * ld;
          float acc = Za[j0 + cc];
#pragma unroll 4
          for (int m = 0; m < j0; m += 4) {
            const float4 g = *reinterpret_cast<const float4*>(Gj + m);
            const float4 z = *reinterpret_cast<const float4*>(Za + m);
            acc = fmaf(-g.x, z.x, acc);
            acc = fmaf(-g.y, z.y, acc);
            acc = fmaf(-g.z, z.z, acc);
            acc = fmaf(-g.w, z.w, acc);
          }
          Za[j0 + cc] = acc;
        }
        __syncthreads();
        for (int a = threadIdx.x; a < k; a += blockDim.x) {
          float* Za = Z + a * ld + j0;
          float gd[kSub][kSub], rv[kSub], z[kSub];
          load_block(gd, rv, prev, ld, rinv, j0);
#pragma unroll
          for (int c4 = 0; c4 < kSub; c4 += 4) {
            const float4 v = *reinterpret_cast<const float4*>(Za + c4);
            z[c4] = v.x, z[c4 + 1] = v.y, z[c4 + 2] = v.z, z[c4 + 3] = v.w;
          }
#pragma unroll
          for (int c = 0; c < kSub; ++c) {
#pragma unroll
            for (int m = 0; m < c; ++m) z[c] = fmaf(-gd[c][m], z[m], z[c]);
            z[c] *= rv[c];
          }
#pragma unroll
          for (int c4 = 0; c4 < kSub; c4 += 4) {
            *reinterpret_cast<float4*>(Za + c4) = make_float4(z[c4], z[c4 + 1], z[c4 + 2], z[c4 + 3]);
          }
        }
        __syncthreads();
      }
      KERNEL_PROBE(i, 1);
      // C_i = D_i - Z Z^T on the lower triangle: rows a0 + nw g of this
      // warp, lane per column b
      for (int a0 = warp; a0 < k; a0 += nw * kProdRows) {
        float acc[kProdRows][NT];
        int a[kProdRows];
#pragma unroll
        for (int g = 0; g < kProdRows; ++g) {
          a[g] = min(a0 + nw * g, kp - 1);
#pragma unroll
          for (int t = 0; t < NT; ++t) acc[g][t] = 0.0f;
        }
#pragma unroll 2
        for (int m = 0; m < kp; m += 4) {
          float4 zb[NT];
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            zb[t] = *reinterpret_cast<const float4*>(Z + (32 * t + lane) * ld + m);
          }
#pragma unroll
          for (int g = 0; g < kProdRows; ++g) {
            const float4 za = *reinterpret_cast<const float4*>(Z + a[g] * ld + m);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              acc[g][t] = fmaf(za.x, zb[t].x, acc[g][t]);
              acc[g][t] = fmaf(za.y, zb[t].y, acc[g][t]);
              acc[g][t] = fmaf(za.z, zb[t].z, acc[g][t]);
              acc[g][t] = fmaf(za.w, zb[t].w, acc[g][t]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kProdRows; ++g) {
          const int ag = a0 + nw * g;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const int b = 32 * t + lane;
            if (ag < k && b <= ag) C[ag * ld + b] -= acc[g][t];
          }
        }
      }
      __syncthreads();
    }
    KERNEL_PROBE(i, 2);
    cholesky_blocked<NT>(C, ld, k, lane, warp);
    KERNEL_PROBE(i, 3);
    // write G_i out, zero its upper triangle in C and keep 1/G_jj: the
    // next stage substitutes against it
    float* out = chol + base + static_cast<size_t>(i) * kk;
    for (int a = warp; a < k; a += nw) {
      for (int b = lane; b < k; b += 32) {
        const float v = b <= a ? C[a * ld + b] : 0.0f;
        out[a * k + b] = v;
        C[a * ld + b] = v;
        if (b == a) Rs[(i % nd) * kMaxK + a] = 1.0f / v;
      }
    }
    KERNEL_PROBE(i, 4);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
chol_thomas_solve_kernel(const float* __restrict__ chol, const float* __restrict__ Lp,
                         const float* __restrict__ b, float* __restrict__ x, int c,
                         int k, int r, int nbuf) {
  float* smem = reinterpret_cast<float*>(dynamic_smem());
  constexpr int kp = 32 * NT;
  const int ld = kp + 4, tile = kp * ld, kk = k * k, kr = k * r;
  // a slot: factor, coupling and, with two slots, the right-hand sides
  const int slot = 2 * tile + (nbuf == 2 ? kr + (-kr & 3) : 0);
  float* carry = smem + nbuf * slot;  // r rows of kp: s_{i-1} or x_{i+1}
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float* Rs = carry + r * kp;         // nbuf vectors: 1/G_jj of each slot's factor
  const size_t mbase = static_cast<size_t>(blockIdx.x) * c * kk;
  const size_t vbase = static_cast<size_t>(blockIdx.x) * c * kr;
  // warps without a row do the copies, where there are any
  const int w0 = r < nw ? r : 0;
  // step n < c is forward stage n, step n >= c backward stage 2c - 2 - n
  const int steps = 2 * c - 1;
  for (int e = threadIdx.x; e < nbuf * slot + r * kp + nbuf * kMaxK; e += blockDim.x) {
    smem[e] = 0.0f;
  }
  __syncthreads();
  // copy step n's operands into its slot, and take 1/G_jj of its factor
  // from device memory (the reciprocals stay off the substitution chain)
  auto issue = [&](int n) {
    if (warp < w0) return;
    const int sl = nbuf == 2 ? n & 1 : 0;
    float* s = smem + sl * slot;
    const bool fwd = n < c;
    const int i = fwd ? n : 2 * c - 2 - n;
    const float* Gi = chol + mbase + static_cast<size_t>(i) * kk;
    stage_rows(s, ld, Gi, k, k, w0, nw - w0);
    if (!fwd || i > 0) {
      const int li = fwd ? i : i + 1;  // Lp[i] = L_{i-1}; Lp[i+1] = L_i
      stage_rows(s + tile, ld, Lp + mbase + static_cast<size_t>(li) * kk, k, k, w0, nw - w0);
    }
    if (fwd && nbuf == 2) {
      stage_rows(s + 2 * tile, kr, b + vbase + static_cast<size_t>(i) * kr, 1, kr, w0, nw - w0);
    }
    for (int j = threadIdx.x - 32 * w0; j < k; j += blockDim.x - 32 * w0) {
      Rs[sl * kMaxK + j] = 1.0f / Gi[j * k + j];
    }
  };
  if (nbuf == 2) issue(0);
  for (int n = 0; n < steps; ++n) {
    if (nbuf == 1) issue(n);
    copy_async_wait();
    KERNEL_PROBE(n, 10);
    __syncthreads();
    KERNEL_PROBE(n, 11);
    // the other slot was last read in step n-1, before the barrier
    if (nbuf == 2 && n + 1 < steps) issue(n + 1);
    const int sl = nbuf == 2 ? n & 1 : 0;
    KERNEL_PROBE(n, 12);
    const float* G = smem + sl * slot;
    const float* L = G + tile;
    const float* rinv = Rs + sl * kMaxK;
    const bool fwd = n < c;
    const int i = fwd ? n : 2 * c - 2 - n;
    const float* bi = nbuf == 2 ? G + 2 * tile : b + vbase + static_cast<size_t>(i) * kr;
    float* xi = x + vbase + static_cast<size_t>(i) * kr;
    for (int q = warp; q < r; q += nw) {
      float* cq = carry + q * kp;
      float y[NT], s[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int a = 32 * t + lane;
        y[t] = 0.0f;
        // backward: s_i, written by this thread in the forward sweep
        s[t] = !fwd && a < k ? xi[a * r + q] : 0.0f;
      }
      if (fwd) {  // y = b_i - L_{i-1} s_{i-1}: y_a = b_a - sum_m L[a][m] s_m
        // four partial sums over m mod 4, for four independent FMA chains
        float4 acc[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i > 0) {
#pragma unroll 4
          for (int m = 0; m < kp; m += 4) {
            const float4 sv = *reinterpret_cast<const float4*>(cq + m);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              const float4 lv = *reinterpret_cast<const float4*>(L + (32 * t + lane) * ld + m);
              acc[t].x = fmaf(lv.x, sv.x, acc[t].x);
              acc[t].y = fmaf(lv.y, sv.y, acc[t].y);
              acc[t].z = fmaf(lv.z, sv.z, acc[t].z);
              acc[t].w = fmaf(lv.w, sv.w, acc[t].w);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int a = 32 * t + lane;
          if (a < k) y[t] = bi[a * r + q] - ((acc[t].x + acc[t].y) + (acc[t].z + acc[t].w));
        }
      } else {  // y = L_i^T x_{i+1}: y_a = sum_j x_j L[j][a], in four sums
        float4 acc[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
        for (int j = 0; j < kp; j += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(cq + j);
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const float* La = L + j * ld + 32 * t + lane;
            acc[t].x = fmaf(xv.x, La[0], acc[t].x);
            acc[t].y = fmaf(xv.y, La[ld], acc[t].y);
            acc[t].z = fmaf(xv.z, La[2 * ld], acc[t].z);
            acc[t].w = fmaf(xv.w, La[3 * ld], acc[t].w);
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) y[t] = (acc[t].x + acc[t].y) + (acc[t].z + acc[t].w);
      }
      KERNEL_PROBE(n, 13);
      forward_subst<NT>(y, G, ld, lane, rinv);
      KERNEL_PROBE(n, 14);
      backward_subst<NT>(y, G, ld, lane, rinv);
      KERNEL_PROBE(n, 15);
      __syncwarp();  // every lane has read the carry
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int a = 32 * t + lane;
        const float v = fwd ? y[t] : s[t] - y[t];
        if (a < k) {
          cq[a] = v;
          xi[a * r + q] = v;
        }
      }
      __syncwarp();  // the carry is whole before the next stage reads it
    }
    KERNEL_PROBE(n, 16);
    if (nbuf == 1) __syncthreads();  // every warp is done with the slot
  }
}

// Floats of the solve's shared memory before kRinv: nbuf slots and the
// carry (r rows of kp).
size_t solve_floats(int kp, int k, int r, int nbuf) {
  const size_t tile = static_cast<size_t>(kp) * (kp + 4);
  const size_t kr = static_cast<size_t>(k) * r;
  const size_t slot = 2 * tile + (nbuf == 2 ? kr + (-kr & 3) : 0);
  return nbuf * slot + static_cast<size_t>(r) * kp;
}

}  // namespace

// The launchers: host code, which the CPU emulation of the kernels
// (tools/emulate_thomas.py) leaves out.
#ifndef KERNEL_EMULATION
namespace {

template <int NT>
int factor_launch(const float* D, const float* Lp, float* chol, int p, int c, int k,
                  cudaStream_t stream) {
  // 3 + 2 tiles when they fit, else 2 + 1; and kRinv
  const size_t tile = static_cast<size_t>(32 * NT) * (32 * NT + 4) * sizeof(float);
  const int nd = 5 * tile + kRinv <= kMaxSmem ? 3 : 2;
  const int nl = nd == 3 ? 2 : 1;
  const size_t smem = (nd + nl) * tile + kRinv;
  int err = set_smem(reinterpret_cast<const void*>(chol_thomas_factor_kernel<NT>), smem);
  if (err != 0) return err;
  chol_thomas_factor_kernel<NT><<<p, kThreads, smem, stream>>>(D, Lp, chol, c, k, nd, nl);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int solve_launch(const float* chol, const float* Lp, const float* b, float* x, int p,
                 int c, int k, int r, cudaStream_t stream) {
  // two slots with the right-hand sides when they fit, else one without
  const int nbuf = solve_floats(32 * NT, k, r, 2) * sizeof(float) + kRinv <= kMaxSmem ? 2 : 1;
  const size_t smem = solve_floats(32 * NT, k, r, nbuf) * sizeof(float) + kRinv;
  int err = set_smem(reinterpret_cast<const void*>(chol_thomas_solve_kernel<NT>), smem);
  if (err != 0) return err;
  chol_thomas_solve_kernel<NT><<<p, kThreads, smem, stream>>>(chol, Lp, b, x, c, k, r, nbuf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int chol_thomas_factor_launch(const float* D, const float* Lp, float* chol,
                              int p, int c, int k, cudaStream_t stream) {
  if (p <= 0 || c <= 0 || k <= 0 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch ((k + 31) / 32) {
    case 1: return factor_launch<1>(D, Lp, chol, p, c, k, stream);
    case 2: return factor_launch<2>(D, Lp, chol, p, c, k, stream);
    case 3: return factor_launch<3>(D, Lp, chol, p, c, k, stream);
    default: return factor_launch<4>(D, Lp, chol, p, c, k, stream);
  }
}

int chol_thomas_solve_launch(const float* chol, const float* Lp,
                             const float* b, float* x, int p, int c, int k,
                             int r, cudaStream_t stream) {
  if (p <= 0 || c <= 0 || k <= 0 || k > kMaxK || r <= 0 || r > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch ((k + 31) / 32) {
    case 1: return solve_launch<1>(chol, Lp, b, x, p, c, k, r, stream);
    case 2: return solve_launch<2>(chol, Lp, b, x, p, c, k, r, stream);
    case 3: return solve_launch<3>(chol, Lp, b, x, p, c, k, r, stream);
    default: return solve_launch<4>(chol, Lp, b, x, p, c, k, r, stream);
  }
}

}  // extern "C"
#endif  // KERNEL_EMULATION
