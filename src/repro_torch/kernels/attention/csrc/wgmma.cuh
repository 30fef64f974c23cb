// Hopper warpgroup-MMA helpers shared by K9's tensor-core kernels
// (flash_wgmma.cu, bfloat16; flash_tf32.cu, float32 as split TF32) and
// K10's (gla/csrc/gla.cu): the shared-memory matrix descriptor, the wgmma
// fence / commit / wait and cp.async group calls in PTX, the accumulator
// pin, the mbarrier and named-barrier calls of the warp-specialized
// kernels, the TMA load and its host-side tensor map, the register
// hand-over (setmaxnreg), and the operand lists of 16, 32 and 64
// accumulators.
//
// Operand tiles are K-major in the 128-byte swizzled layout: a row of 128
// bytes (64 bf16 or 32 f32 values) is 8 chunks of 16 bytes, chunk c of
// row r stored at chunk c ^ (r % 8); 8-row groups 1024 bytes apart, each
// sub-tile 1024-byte aligned.
#pragma once

#include <cuda.h>  // CUtensorMap; the driver's encoder is fetched at run
                   // time (cudaGetDriverEntryPoint), so no -lcuda
#include <cuda_runtime.h>
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
// Waits until at most N of this warpgroup's committed wgmma groups are
// pending: the older groups are done, the newest N may still run.
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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
// The same for an A-operand register of a wgmma fed from registers.
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// mbarriers in shared memory: init with the arrival count of a phase,
// arrive, test and wait on the parity of a phase.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_test(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits until the phase of `bar` with this parity has completed; traps
// after ~2^22 tries (seconds): a fault, never a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  int tries = 0;
  while (!mbar_test(bar, parity))
    if (++tries > (1 << 22)) __trap();
}
__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Arrives on `bar` and adds `bytes` to the transaction count its phase
// waits for (the bytes of the TMA copies that complete on it).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// TMA: the box at coordinates (c0, c1, c2) of the tensor map at `map` (a
// __grid_constant__ kernel parameter) into shared memory at dst, its
// bytes completing on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Hands registers between the warpgroups of a warp-specialized block
// (sm_90a): every warp of a warpgroup lowers or raises its own limit to N
// a thread, N a multiple of 8.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (null when the
// driver does not give it).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (e == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The row-major tensor [n, rows, cols] of `elem`-byte elements at p
// (cols * elem a multiple of 16, p 16-byte aligned) as boxes of
// box_cols x box_rows (box_cols * elem = 128 bytes) in the 128-byte
// swizzle, zero past every edge.
inline bool tile_map(CUtensorMap* map, const void* p, CUtensorMapDataType type,
                     int elem, int cols, int rows, int n, int box_cols,
                     int box_rows) {
  const EncodeTiled f = encode_tiled();
  if (!f) return false;
  const cuuint64_t dim[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                             (cuuint64_t)n};
  const cuuint64_t stride[2] = {(cuuint64_t)cols * elem,
                                (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return f(map, type, 3, const_cast<void*>(p), dim, stride, box, step,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgmma

#define WG_D8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16(d) WG_D8(d, 0), WG_D8(d, 8)
#define WG_D32(d) WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16), WG_D8(d, 24)
#define WG_D64(d) \
  WG_D32(d), WG_D8(d, 32), WG_D8(d, 40), WG_D8(d, 48), WG_D8(d, 56)
