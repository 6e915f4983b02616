// Hopper (sm_90a) helpers that the wgmma kernels share: cp.async groups,
// the generic-to-async proxy fence, wgmma's fence / commit / wait, and the
// 128-byte swizzled shared-memory layout with its matrix descriptors.
// Included by csrc/ffn.cu (K1) and csrc/prefill_attention.cu (K4).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// shared-memory writes of the generic proxy (cp.async) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of registers that an in-flight
// wgmma writes across the wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Operand tiles in shared memory use wgmma's 128-byte swizzle: rows of 64
// bf16 (128 bytes), 16-byte chunk c of row r stored at chunk c ^ (r % 8),
// in atoms of 8 rows (1024 bytes, 1024-aligned). A wider tile is a column
// of such 64-wide blocks.
//  K-major operand (ROWS x K, K contiguous): block kb = k / 64 holds
//    element (m, k) at kb*ROWS*128 + m*128 + swizzled chunk (k % 64) / 8.
//    Descriptor: sbo = 1024 (8-row groups); a k16 step advances the start
//    by 32 bytes inside the 128-byte row, a 64-wide block by ROWS*128.
//  MN-major operand (KR x N, N contiguous): block nb = n / 64 holds
//    element (k, n) at nb*KR*128 + k*128 + swizzled chunk (n % 64) / 8.
//    Descriptor: lbo = KR*128 (between 64-wide N blocks), sbo = 1024
//    (8-row K groups); a k16 step advances the start by 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row % 8)) * 16);
}
// 1024-aligned base of the dynamic shared memory (the swizzle atoms need
// it); kernels ask for 1 KB more than their tiles
__device__ __forceinline__ uint32_t smem_base(const void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

}  // namespace
