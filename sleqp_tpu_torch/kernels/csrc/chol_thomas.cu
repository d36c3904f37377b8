// Batched Cholesky block Thomas for SPD block-tridiagonal systems, in
// float32, for sleqp_tpu_torch/ops/pallas_chol_tridiag.py.  P independent
// chains (SPIKE chunks) of c stages; one thread block per chain.
//
//   chol_thomas_factor  replaces
//       sleqp_tpu/ops/pallas_chol_tridiag.py::_factor_kernel.  Per stage
//       i >= 1: W = L_i C_{i-1}^-1 by two triangular solves against the
//       previous factor (one thread per row of L_i), C_i = D_i - W L_i^T,
//       then a right-looking Cholesky of C_i (k rank-1 downdates).  The
//       factors go to a fresh output tensor (the reference aliases D).
//   chol_thomas_solve   replaces ::_solve_kernel: the forward sweep
//       s_i = C_i^-1 (b_i - L_i s_{i-1}) and the backward sweep
//       x_i = s_i - C_i^-1 L_{i+1}^T x_{i+1} against the stored factors,
//       one thread per right-hand side in the triangular solves.
//
// Lp[i] = L[i-1] with Lp[0] = 0, as the reference.  Shared memory holds at
// most three k x k tiles of the factorization (64 KB each at k = 128, the
// largest block taken); L_i, D_i and, in the solve, the factors are read
// from device memory (L2).  The right-hand sides come in the reference's
// public (P, c, k, r) layout; the kernel keeps them as rows (r x k) in
// shared memory.  Every product is a float32 FMA loop, never TF32.
//
// Plain C interface, built with plain nvcc and loaded through ctypes
// (sleqp_tpu_torch/kernels/_build.py); each launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "gj.cuh"

namespace {

constexpr int kFactorThreads = 512;
constexpr int kSolveThreads = 256;
constexpr int kMaxK = 128;  // pallas_chol_tridiag.MAX_CHOL_BLOCK
// right-hand sides per launch (pallas_chol_tridiag.RHS_TILE): the solve
// keeps 2 k r floats in shared memory, 128 KB at k = 128
constexpr int kMaxR = 128;

// Rows y of Y (n x k, row-major, in place) become y C^-1 with C = G G^T and
// G lower triangular (leading dimension k): first solve z G^T = y
// (z_j = (y_j - sum_{l<j} G[j][l] z_l) / G[j][j]), then x G = z
// (x_j = (z_j - sum_{l>j} G[l][j] x_l) / G[j][j]).  One thread per row.
__device__ void cho_solve_rows(const float* G, float* Y, int n, int k) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    float* y = Y + q * k;
    for (int j = 0; j < k; ++j) {
      float acc = 0.0f;
      for (int l = 0; l < j; ++l) acc = fmaf(G[j * k + l], y[l], acc);
      y[j] = (y[j] - acc) / G[j * k + j];
    }
    for (int j = k - 1; j >= 0; --j) {
      float acc = 0.0f;
      for (int l = j + 1; l < k; ++l) acc = fmaf(G[l * k + j], y[l], acc);
      y[j] = (y[j] - acc) / G[j * k + j];
    }
  }
}

// Right-looking Cholesky of the SPD k x k A in shared memory, in place on
// the lower triangle: column j = A[:, j] / sqrt(A[j][j]), then the trailing
// lower triangle loses col col^T.  col (k) is scratch.  Ends with a barrier.
__device__ void cholesky_inplace(float* A, float* col, int k) {
  for (int j = 0; j < k; ++j) {
    const float d = rsqrtf(A[j * k + j]);
    for (int i = j + threadIdx.x; i < k; i += blockDim.x) col[i] = A[i * k + j] * d;
    __syncthreads();
    for (int e = threadIdx.x; e < k * k; e += blockDim.x) {
      const int a = e / k, c = e - a * k;
      if (c == j && a >= j) {
        A[e] = col[a];
      } else if (c > j && c <= a) {
        A[e] -= col[a] * col[c];
      }
    }
    __syncthreads();
  }
}

__global__ void chol_thomas_factor_kernel(const float* __restrict__ D,
                                          const float* __restrict__ Lp,
                                          float* __restrict__ chol, int c,
                                          int k) {
  extern __shared__ float smem[];
  const int kk = k * k;
  float* prev = smem;       // factor of stage i-1
  float* W = prev + kk;     // L_i, then L_i C_{i-1}^-1
  float* C = W + kk;        // C_i, then its factor
  float* col = C + kk;      // k
  const size_t base = static_cast<size_t>(blockIdx.x) * c * kk;
  for (int i = 0; i < c; ++i) {
    const float* Di = D + base + static_cast<size_t>(i) * kk;
    const float* Li = Lp + base + static_cast<size_t>(i) * kk;
    if (i == 0) {
      for (int e = threadIdx.x; e < kk; e += blockDim.x) C[e] = Di[e];
    } else {
      for (int e = threadIdx.x; e < kk; e += blockDim.x) W[e] = Li[e];
      __syncthreads();
      cho_solve_rows(prev, W, k, k);
      __syncthreads();
      // C = D_i - W L_i^T
      for (int e = threadIdx.x; e < kk; e += blockDim.x) {
        const int a = e / k, b = e - a * k;
        float acc = 0.0f;
        for (int m = 0; m < k; ++m) acc = fmaf(W[a * k + m], Li[b * k + m], acc);
        C[e] = Di[e] - acc;
      }
    }
    __syncthreads();
    cholesky_inplace(C, col, k);
    float* out = chol + base + static_cast<size_t>(i) * kk;
    for (int e = threadIdx.x; e < kk; e += blockDim.x) {
      const int a = e / k, b = e - a * k;
      out[e] = b <= a ? C[e] : 0.0f;
    }
    // C becomes the previous factor; the next stage writes the new C only
    // after the barrier that follows its solve (or its load, at i = 0)
    float* swap = prev;
    prev = C;
    C = swap;
  }
}

__global__ void chol_thomas_solve_kernel(const float* __restrict__ chol,
                                         const float* __restrict__ Lp,
                                         const float* __restrict__ b,
                                         float* __restrict__ x, int c, int k,
                                         int r) {
  extern __shared__ float smem[];
  const int kk = k * k, kr = k * r;
  float* s = smem;     // r x k rows: the carry
  float* y = s + kr;   // r x k rows: the stage's work
  const size_t mbase = static_cast<size_t>(blockIdx.x) * c * kk;
  const size_t vbase = static_cast<size_t>(blockIdx.x) * c * kr;
  // forward: y = b_i - s L_i^T (rows), s_i = y C_i^-1
  for (int i = 0; i < c; ++i) {
    const float* Li = Lp + mbase + static_cast<size_t>(i) * kk;
    const float* bi = b + vbase + static_cast<size_t>(i) * kr;
    for (int e = threadIdx.x; e < kr; e += blockDim.x) {
      const int q = e / k, a = e - q * k;
      float acc = 0.0f;
      if (i > 0) {
        for (int m = 0; m < k; ++m) acc = fmaf(s[q * k + m], Li[a * k + m], acc);
      }
      y[e] = bi[a * r + q] - acc;
    }
    __syncthreads();
    cho_solve_rows(chol + mbase + static_cast<size_t>(i) * kk, y, r, k);
    __syncthreads();
    float* xi = x + vbase + static_cast<size_t>(i) * kr;
    for (int e = threadIdx.x; e < kr; e += blockDim.x) {
      const int q = e / k, a = e - q * k;
      xi[a * r + q] = y[e];
    }
    float* swap = s;
    s = y;
    y = swap;
  }
  // backward: y = x_{i+1} L_{i+1} (rows), x_i = s_i - y C_i^-1, with s the
  // carry x_{i+1}
  for (int i = c - 2; i >= 0; --i) {
    const float* Lnext = Lp + mbase + static_cast<size_t>(i + 1) * kk;
    for (int e = threadIdx.x; e < kr; e += blockDim.x) {
      const int q = e / k, m = e - q * k;
      float acc = 0.0f;
      for (int j = 0; j < k; ++j) acc = fmaf(s[q * k + j], Lnext[j * k + m], acc);
      y[e] = acc;
    }
    __syncthreads();
    cho_solve_rows(chol + mbase + static_cast<size_t>(i) * kk, y, r, k);
    __syncthreads();
    float* xi = x + vbase + static_cast<size_t>(i) * kr;
    for (int e = threadIdx.x; e < kr; e += blockDim.x) {
      const int q = e / k, a = e - q * k;
      const float v = xi[a * r + q] - y[e];
      xi[a * r + q] = v;
      y[e] = v;
    }
    __syncthreads();  // the next stage reads every row of the new carry
    float* swap = s;
    s = y;
    y = swap;
  }
}

}  // namespace

extern "C" {

int chol_thomas_factor_launch(const float* D, const float* Lp, float* chol,
                              int p, int c, int k, cudaStream_t stream) {
  if (p <= 0 || c <= 0 || k <= 0 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // three k x k tiles: 192.5 KB at k = 128, above the default 48 KB
  const size_t smem = (3 * k * k + k) * sizeof(float);
  int err = set_smem(reinterpret_cast<const void*>(chol_thomas_factor_kernel), smem);
  if (err != 0) return err;
  chol_thomas_factor_kernel<<<p, kFactorThreads, smem, stream>>>(D, Lp, chol, c, k);
  return static_cast<int>(cudaGetLastError());
}

int chol_thomas_solve_launch(const float* chol, const float* Lp,
                             const float* b, float* x, int p, int c, int k,
                             int r, cudaStream_t stream) {
  if (p <= 0 || c <= 0 || k <= 0 || k > kMaxK || r <= 0 || r > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * k * r * sizeof(float);
  int err = set_smem(reinterpret_cast<const void*>(chol_thomas_solve_kernel), smem);
  if (err != 0) return err;
  chol_thomas_solve_kernel<<<p, kSolveThreads, smem, stream>>>(chol, Lp, b, x, c, k, r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
