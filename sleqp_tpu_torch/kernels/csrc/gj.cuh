// Code shared by the kernels of bgj.cu, thomas.cu and chol_thomas.cu.
#pragma once

#include <cuda_runtime.h>

// Let `kernel` take `bytes` of dynamic shared memory (a launch gets 48 KB
// without asking); returns the cudaError_t as an int, 0 on success.
inline int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// k Gauss-Jordan sweeps over the tableau t = [A | I] (k x 2k, row-major)
// in shared memory, leaving [I | A^-1].  f (k) and row (2k) are scratch.
// Sweep j: f = column j - e_j, row = row j / pivot, t -= f row^T.  No
// pivoting: A is SPD, and every leading principal block of an SPD matrix
// is PD.  Ends with a barrier, so t is ready to read.
__device__ inline void gj_sweeps(float* t, int k, float* f, float* row) {
  const int w = 2 * k;
  for (int j = 0; j < k; ++j) {
    const float piv = t[j * w + j];
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      f[i] = t[i * w + j] - (i == j ? 1.0f : 0.0f);
    }
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      row[c] = t[j * w + c] / piv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < k * w; e += blockDim.x) {
      const int i = e / w;
      t[e] -= f[i] * row[e - i * w];
    }
    __syncthreads();
  }
}
