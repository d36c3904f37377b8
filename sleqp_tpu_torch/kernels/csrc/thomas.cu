// Streaming block Thomas for SPD block-tridiagonal systems, in float32,
// for the explicit-inverse solve of sleqp_tpu_torch/ops/pallas_tridiag.py.
//
//   thomas_fwd  replaces sleqp_tpu/ops/pallas_tridiag.py::_fwd_stream_kernel.
//               With factor = 1, per stage i = 0..N-1:
//                 C_i = D_i - L_{i-1} (M_{i-1} L_{i-1}^T),
//                 M_i = C_i^-1 (k Gauss-Jordan sweeps, gj.cuh),
//                 y_i = M_i (b_i - L_{i-1} y_{i-1}),
//               writing M and y.  With factor = 0, D holds stored inverses
//               M and only the substitution runs.
//   thomas_bwd  replaces ::_bwd_stream_kernel: back to front,
//               x_i = y_i - M_i (L_i^T x_{i+1}), x_{N-1} = y_{N-1}.
//
// Both take Lp with Lp[i] = L[i-1] and Lp[0] = 0 (the reference's shifted
// couplings); thomas_bwd reads L_i as Lp[i+1], so it needs no second
// shifted copy.  The recursion is one chain, so each kernel is ONE thread
// block that walks all N stages, with the carry (M_{i-1} as the right half
// of the Gauss-Jordan tableau, y_{i-1} or x_{i+1}) in shared memory.  Every
// product is a float32 FMA loop (never TF32), summed in index order.
//
// Plain C interface, built with plain nvcc and loaded through ctypes
// (sleqp_tpu_torch/kernels/_build.py); each launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "gj.cuh"

namespace {

constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;
constexpr int kMaxK = 64;  // pallas_tridiag.MAX_PALLAS_BLOCK
// right-hand sides per launch (pallas_tridiag.RHS_TILE): thomas_fwd keeps
// 4k^2 + 3k + 2kr floats in shared memory, 130 KB at k = 64
constexpr int kMaxR = 128;

// out[a][q] = base[a][q] - sum_m A[a][m] v[m][q] for a k x k A (leading
// dimension lda) and k x r v, out; base may alias nothing that is read.
__device__ void sub_matvec(const float* base, const float* A, int lda,
                           const float* v, float* out, int k, int r) {
  for (int e = threadIdx.x; e < k * r; e += blockDim.x) {
    const int a = e / r, q = e - a * r;
    float acc = 0.0f;
    for (int m = 0; m < k; ++m) acc = fmaf(A[a * lda + m], v[m * r + q], acc);
    out[e] = base[e] - acc;
  }
}

__global__ void thomas_fwd_kernel(const float* __restrict__ D,
                                  const float* __restrict__ Lp,
                                  const float* __restrict__ b,
                                  float* __restrict__ y,
                                  float* __restrict__ M, int n, int k, int r,
                                  int factor) {
  extern __shared__ float smem[];
  const int w = 2 * k, kk = k * k;
  float* t = smem;           // k x 2k tableau; right half = M_{i-1}, M_i
  float* Ls = t + k * w;     // L_{i-1}
  float* T1 = Ls + kk;       // M_{i-1} L_{i-1}^T
  float* f = T1 + kk;        // k
  float* row = f + k;        // 2k
  float* yprev = row + w;    // k x r carry
  float* v = yprev + k * r;  // k x r
  for (int e = threadIdx.x; e < k * w; e += blockDim.x) t[e] = 0.0f;
  for (int e = threadIdx.x; e < k * r; e += blockDim.x) yprev[e] = 0.0f;
  // no first-stage branch: Lp[0] = 0 makes every carry term vanish
  for (int i = 0; i < n; ++i) {
    const size_t mo = static_cast<size_t>(i) * kk;
    const size_t vo = static_cast<size_t>(i) * k * r;
    for (int e = threadIdx.x; e < kk; e += blockDim.x) Ls[e] = Lp[mo + e];
    __syncthreads();
    const float* Mi;
    int ldm;
    if (factor) {
      // T1[a][c] = sum_m M_{i-1}[a][m] L[c][m]
      for (int e = threadIdx.x; e < kk; e += blockDim.x) {
        const int a = e / k, c = e - a * k;
        float acc = 0.0f;
        for (int m = 0; m < k; ++m) acc = fmaf(t[a * w + k + m], Ls[c * k + m], acc);
        T1[e] = acc;
      }
      __syncthreads();
      // tableau [C_i | I], C_i = D_i - L T1
      for (int e = threadIdx.x; e < k * w; e += blockDim.x) {
        const int a = e / w, c = e - a * w;
        if (c < k) {
          float acc = 0.0f;
          for (int m = 0; m < k; ++m) acc = fmaf(Ls[a * k + m], T1[m * k + c], acc);
          t[e] = D[mo + a * k + c] - acc;
        } else {
          t[e] = (c - k == a) ? 1.0f : 0.0f;
        }
      }
      __syncthreads();
      gj_sweeps(t, k, f, row);
      for (int e = threadIdx.x; e < kk; e += blockDim.x) {
        const int a = e / k, c = e - a * k;
        M[mo + e] = t[a * w + k + c];
      }
      Mi = t + k;
      ldm = w;
    } else {
      Mi = D + mo;
      ldm = k;
    }
    // v = b_i - L y_{i-1}; y_i = M_i v
    sub_matvec(b + vo, Ls, k, yprev, v, k, r);
    __syncthreads();
    for (int e = threadIdx.x; e < k * r; e += blockDim.x) {
      const int a = e / r, q = e - a * r;
      float acc = 0.0f;
      for (int m = 0; m < k; ++m) acc = fmaf(Mi[a * ldm + m], v[m * r + q], acc);
      yprev[e] = acc;
      y[vo + e] = acc;
    }
    // the next stage overwrites Ls and, with factor, t only after its
    // first barrier; yprev is read after its second
  }
}

__global__ void thomas_bwd_kernel(const float* __restrict__ M,
                                  const float* __restrict__ Lp,
                                  const float* __restrict__ y,
                                  float* __restrict__ x, int n, int k, int r) {
  extern __shared__ float smem[];
  const int kk = k * k;
  float* xnext = smem;          // k x r carry
  float* tmp = xnext + k * r;   // L_i^T x_{i+1}
  for (int i = n - 1; i >= 0; --i) {
    const size_t mo = static_cast<size_t>(i) * kk;
    const size_t vo = static_cast<size_t>(i) * k * r;
    // tmp[m][q] = sum_a L_i[a][m] xnext[a][q] with L_i = Lp[i+1]; the
    // last stage has no coupling, so tmp = 0 and x_{N-1} = y_{N-1}
    const float* Li = Lp + mo + kk;
    for (int e = threadIdx.x; e < k * r; e += blockDim.x) {
      const int m = e / r, q = e - m * r;
      float acc = 0.0f;
      if (i + 1 < n) {
        for (int a = 0; a < k; ++a) acc = fmaf(Li[a * k + m], xnext[a * r + q], acc);
      }
      tmp[e] = acc;
    }
    __syncthreads();
    sub_matvec(y + vo, M + mo, k, tmp, xnext, k, r);
    __syncthreads();
    for (int e = threadIdx.x; e < k * r; e += blockDim.x) x[vo + e] = xnext[e];
  }
}

}  // namespace

extern "C" {

int thomas_fwd_launch(const float* D, const float* Lp, const float* b,
                      float* y, float* M, int n, int k, int r, int factor,
                      cudaStream_t stream) {
  if (n <= 0 || k <= 0 || k > kMaxK || r <= 0 || r > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (4 * k * k + 3 * k + 2 * k * r) * sizeof(float);
  // above the 48 KB a launch gets without asking from k = 55 on
  int err = set_smem(reinterpret_cast<const void*>(thomas_fwd_kernel), smem);
  if (err != 0) return err;
  thomas_fwd_kernel<<<1, kFwdThreads, smem, stream>>>(D, Lp, b, y, M, n, k,
                                                       r, factor);
  return static_cast<int>(cudaGetLastError());
}

int thomas_bwd_launch(const float* M, const float* Lp, const float* y,
                      float* x, int n, int k, int r, cudaStream_t stream) {
  if (n <= 0 || k <= 0 || k > kMaxK || r <= 0 || r > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * k * r * sizeof(float);
  int err = set_smem(reinterpret_cast<const void*>(thomas_bwd_kernel), smem);
  if (err != 0) return err;
  thomas_bwd_kernel<<<1, kBwdThreads, smem, stream>>>(M, Lp, y, x, n, k, r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
