// Batched inverses of SPD float32 blocks for the cyclic-reduction layer
// (sleqp_tpu_torch/ops/cyclic_reduction.py), one thread block per matrix.
//
//   bgj_flat       replaces sleqp_tpu/ops/cyclic_reduction.py::_bgj_kernel:
//                  k unpivoted Gauss-Jordan sweeps (gj.cuh), each a rank-1
//                  update of the tableau [A | A^-1] held in shared memory.
//   bgj_blocked64  replaces ::_bgj_blocked_kernel: two 2x2 block-Schur
//                  levels (64 -> 32 -> 16) with 16x16 Gauss-Jordan leaves
//                  and the six Schur products per level as float32 FMA
//                  loops in shared memory (never TF32).
//
// Both read each input block once and write each output block once, so
// device memory traffic is 2 * B * k^2 * 4 bytes; the sweeps and products
// run out of shared memory.  No pivoting: the blocks are SPD, and every
// leading principal block of an SPD matrix is PD.
//
// Plain C interface, built with plain nvcc and loaded through ctypes
// (sleqp_tpu_torch/kernels/_build.py).  Each launcher takes raw device
// pointers, sizes and a cudaStream_t and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "gj.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLeaf = 16;

__global__ void bgj_flat_kernel(const float* __restrict__ C,
                                float* __restrict__ M, int k) {
  extern __shared__ float smem[];
  float* t = smem;            // k x 2k tableau
  float* f = t + 2 * k * k;   // k
  float* row = f + k;         // 2k
  const int w = 2 * k;
  const size_t off = static_cast<size_t>(blockIdx.x) * k * k;
  for (int e = threadIdx.x; e < k * w; e += blockDim.x) {
    const int i = e / w, c = e - i * w;
    t[e] = c < k ? C[off + i * k + c] : (c - k == i ? 1.0f : 0.0f);
  }
  __syncthreads();
  gj_sweeps(t, k, f, row);
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) {
    const int i = e / k, c = e - i * k;
    M[off + e] = t[i * w + k + c];
  }
}

// out = base + sign * op(a) b for n x n row-major views with leading
// dimensions; op(a) = a^T when trans_a.  base may be null (zero).  The sum
// runs in float32 FMAs in order l = 0..n-1.
template <int N>
__device__ void mm(const float* a, int lda, bool trans_a, const float* b,
                   int ldb, const float* base, int ldbase, float sign,
                   float* out, int ldo) {
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int i = e / N, j = e - i * N;
    float acc = 0.0f;
#pragma unroll 8
    for (int l = 0; l < N; ++l) {
      const float av = trans_a ? a[l * lda + i] : a[i * lda + l];
      acc = fmaf(av, b[l * ldb + j], acc);
    }
    out[i * ldo + j] = (base ? base[i * ldbase + j] : 0.0f) + sign * acc;
  }
  __syncthreads();
}

template <int N>
__device__ void scaled_copy(const float* src, int lds, float sign, float* dst,
                            int ldd) {
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int i = e / N, j = e - i * N;
    dst[i * ldd + j] = sign * src[i * lds + j];
  }
  __syncthreads();
}

// Gauss-Jordan inverse of a kLeaf x kLeaf view; t, f, row are scratch.
struct LeafInverse {
  float* t;
  float* f;
  float* row;
  __device__ void operator()(const float* A, int lda, float* out,
                             int ldo) const {
    constexpr int w = 2 * kLeaf;
    for (int e = threadIdx.x; e < kLeaf * w; e += blockDim.x) {
      const int i = e / w, c = e - i * w;
      t[e] = c < kLeaf ? A[i * lda + c] : (c - kLeaf == i ? 1.0f : 0.0f);
    }
    __syncthreads();
    gj_sweeps(t, kLeaf, f, row);
    for (int e = threadIdx.x; e < kLeaf * kLeaf; e += blockDim.x) {
      const int i = e / kLeaf, c = e - i * kLeaf;
      out[i * ldo + c] = t[i * w + kLeaf + c];
    }
    __syncthreads();
  }
};

// One 2x2 block-Schur level on a 2H x 2H SPD view C (the arithmetic of
// _schur_quadrants):
//   Ai = inv(A), W = Bm^T Ai, S = D - W Bm, Si = inv(S), V = Ai Bm,
//   inv(C) = [[Ai + (V Si) W, -(V Si)], [-(Si W), Si]].
// buf holds six H x H scratch matrices.
template <int H, class InvHalf>
__device__ void schur_level(const float* C, int ldc, float* out, int ldo,
                            float* buf, const InvHalf& inv_half) {
  float* Ai = buf;
  float* W = Ai + H * H;
  float* S = W + H * H;
  float* Si = S + H * H;
  float* V = Si + H * H;
  float* VSi = V + H * H;
  const float* A = C;
  const float* Bm = C + H;
  const float* D = C + H * ldc + H;
  inv_half(A, ldc, Ai, H);
  mm<H>(Bm, ldc, true, Ai, H, nullptr, 0, 1.0f, W, H);
  mm<H>(W, H, false, Bm, ldc, D, ldc, -1.0f, S, H);
  inv_half(S, H, Si, H);
  mm<H>(Ai, H, false, Bm, ldc, nullptr, 0, 1.0f, V, H);
  mm<H>(V, H, false, Si, H, nullptr, 0, 1.0f, VSi, H);
  mm<H>(VSi, H, false, W, H, Ai, H, 1.0f, out, ldo);
  scaled_copy<H>(VSi, H, -1.0f, out + H, ldo);
  mm<H>(Si, H, false, W, H, nullptr, 0, -1.0f, out + H * ldo, ldo);
  scaled_copy<H>(Si, H, 1.0f, out + H * ldo + H, ldo);
}

// Inverse of a 32 x 32 view: one Schur level over 16 x 16 leaves.
struct Inverse32 {
  float* buf;
  LeafInverse leaf;
  __device__ void operator()(const float* A, int lda, float* out,
                             int ldo) const {
    schur_level<kLeaf>(A, lda, out, ldo, buf, leaf);
  }
};

constexpr int kBlocked = 4 * kLeaf;
constexpr int kBlockedSmemFloats =
    kBlocked * kBlocked                  // the input block
    + 6 * (kBlocked / 2) * (kBlocked / 2)  // outer level scratch
    + 6 * kLeaf * kLeaf                  // inner level scratch
    + 2 * kLeaf * kLeaf                  // leaf tableau
    + 3 * kLeaf;                         // leaf f and row

__global__ void bgj_blocked64_kernel(const float* __restrict__ C,
                                     float* __restrict__ M) {
  extern __shared__ float smem[];
  float* c = smem;
  float* outer = c + kBlocked * kBlocked;
  float* inner = outer + 6 * (kBlocked / 2) * (kBlocked / 2);
  float* t = inner + 6 * kLeaf * kLeaf;
  float* f = t + 2 * kLeaf * kLeaf;
  float* row = f + kLeaf;
  const size_t off = static_cast<size_t>(blockIdx.x) * kBlocked * kBlocked;
  for (int e = threadIdx.x; e < kBlocked * kBlocked; e += blockDim.x) {
    c[e] = C[off + e];
  }
  __syncthreads();
  const Inverse32 inv32{inner, LeafInverse{t, f, row}};
  // the outer level writes its quadrants straight to device memory
  schur_level<kBlocked / 2>(c, kBlocked, M + off, kBlocked, outer, inv32);
}

}  // namespace

extern "C" {

int bgj_flat_max_k() {
  // largest k whose tableau and scratch fit the default 48 KB of dynamic
  // shared memory: (2k^2 + 3k) * 4 bytes
  int k = 1;
  while ((2 * (k + 1) * (k + 1) + 3 * (k + 1)) * 4 <= 48 * 1024) ++k;
  return k;
}

int bgj_flat_launch(const float* C, float* M, int batch, int k,
                    cudaStream_t stream) {
  if (batch <= 0 || k <= 0 || k > bgj_flat_max_k()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (2 * k * k + 3 * k) * sizeof(float);
  bgj_flat_kernel<<<batch, kThreads, smem, stream>>>(C, M, k);
  return static_cast<int>(cudaGetLastError());
}

int bgj_blocked64_launch(const float* C, float* M, int batch,
                         cudaStream_t stream) {
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kBlockedSmemFloats * sizeof(float);
  // just above the 48 KB a launch gets without asking
  int err = set_smem(reinterpret_cast<const void*>(bgj_blocked64_kernel), smem);
  if (err != 0) return err;
  bgj_blocked64_kernel<<<batch, kThreads, smem, stream>>>(C, M);
  return static_cast<int>(cudaGetLastError());
}

const char* bgj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
