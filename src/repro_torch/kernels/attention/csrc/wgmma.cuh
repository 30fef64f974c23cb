// Hopper warpgroup-MMA helpers shared by K9's tensor-core kernels
// (flash_wgmma.cu, bfloat16; flash_tf32.cu, float32 as split TF32): the
// shared-memory matrix descriptor, the wgmma fence / commit / wait and
// cp.async group calls in PTX, the accumulator pin, and the operand lists
// of 16, 32 and 64 accumulators.
//
// Operand tiles are K-major in the 128-byte swizzled layout: a row of 128
// bytes (64 bf16 or 32 f32 values) is 8 chunks of 16 bytes, chunk c of
// row r stored at chunk c ^ (r % 8); 8-row groups 1024 bytes apart, each
// sub-tile 1024-byte aligned.
#pragma once

#include <stdint.h>

namespace wgmma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  auto enc = [](uint32_t x) { return (uint64_t)((x & 0x3FFFF) >> 4); };
  return enc(addr) | (enc(lbo) << 16) | (enc(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The generic-proxy shared-memory stores of this thread become visible to
// wgmma (the async proxy); a barrier then makes every thread's visible.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins an accumulator register at this point of the program: the
// compiler may not move its reads or writes across a wgmma wait or fence.
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

}  // namespace wgmma

#define WG_D8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16(d) WG_D8(d, 0), WG_D8(d, 8)
#define WG_D32(d) WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16), WG_D8(d, 24)
#define WG_D64(d) \
  WG_D32(d), WG_D8(d, 32), WG_D8(d, 40), WG_D8(d, 48), WG_D8(d, 56)
