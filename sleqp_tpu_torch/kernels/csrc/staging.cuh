// What the kernels of bgj.cu, thomas.cu and chol_thomas.cu use of the card
// beyond plain C++: asynchronous copies into shared memory, the mbarriers
// that hand them over, named barriers, the block's dynamic shared memory,
// and a probe mark; and the launchers' shared-memory attribute.  Each is a
// seam: tools/emulate_thomas.py compiles the kernels with KERNEL_EMULATION
// defined, which leaves this header out, and gives each device function a
// C++ counterpart; tools/thomas_probe.py defines KERNEL_PROBE to record
// clock64() at the marks.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

// Let `kernel` take `bytes` of dynamic shared memory (a launch gets 48 KB
// without asking); returns the cudaError_t as an int, 0 on success.
inline int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// A mark at a phase boundary of stage `step`: nothing unless the build
// defines it (tools/thomas_probe.py).
#ifndef KERNEL_PROBE
#define KERNEL_PROBE(step, mark)
#endif

// The block's dynamic shared memory.
__device__ __forceinline__ float4* dynamic_smem() {
  extern __shared__ float4 smem4[];
  return smem4;
}

// Device memory to shared memory, asynchronously: 16 bytes where both
// ends allow it (wide), else 4.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool wide = false) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (wide) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

// Wait for this thread's cp.async copies; a barrier then shows them to the
// block.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// An mbarrier that completes a phase when one thread has arrived and the
// bytes it announced have landed (the copy engine reports to it).
__device__ __forceinline__ void copy_async_bar_init(uint64_t* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on bar, announcing `bytes` of copies (0: a plain arrival).
__device__ __forceinline__ void copy_async_bar_expect(uint64_t* bar, unsigned bytes) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
}

// Arrive on bar.
__device__ __forceinline__ void copy_async_bar_arrive(uint64_t* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b) : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// to shared memory by the copy engine, reported to bar.
__device__ __forceinline__ void copy_async_bulk(float* dst, const float* src, unsigned bytes,
                                                uint64_t* bar) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// The box of map at (column c0, row r0) into dst (1024-byte aligned) by
// the copy engine, reported to bar.
__device__ __forceinline__ void copy_async_tile(float* dst, const CUtensorMap* map, int c0, int r0,
                                                uint64_t* bar) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(d), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(b) : "memory");
}

// Wait until bar's phase of this parity has completed, suspended (not
// polling, which would take the scheduler's issue slots and shared-memory
// pipe from the compute warps); trap (a launch failure the wrapper
// reports) if it has not after ~10 s, rather than hang.  One lane of a
// warp waits (see wait_warp).
__device__ __forceinline__ void copy_async_bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(b), "r"(parity), "r"(1000000u) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// Order this thread's earlier writes to shared memory before later copies
// of the copy engine into the same places (a barrier must follow).
__device__ __forceinline__ void copy_async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` of the first `count` threads (a multiple of 32).
__device__ __forceinline__ void sync_threads(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
