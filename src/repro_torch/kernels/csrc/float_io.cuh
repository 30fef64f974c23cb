// Shared by the attention kernels, K9 (attention/csrc/flash_tf32.cu and
// flash_wgmma.cu) and K10 (gla/csrc/gla.cu): loads of float32 or bfloat16
// inputs as float32, stores of float32 results rounded to nearest even
// into the output's dtype, the choice of a kernel's head-dim
// instantiation, and a launch that opts in to more than 48 KB of dynamic
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace float_io {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// f(std::integral_constant<int, D>{}) for the least D of 32, 64, 128 that
// is >= d (the larger of a kernel's two head dims); cudaErrorInvalidValue
// for d over 128.
template <typename F>
int dispatch_head_dim(int d, F f) {
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 128) return f(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

// Launch kernel(args...) on `blocks` blocks of `threads` with `smem` bytes
// of dynamic shared memory on `stream`. Returns the CUDA error of the
// attribute call or of the launch, 0 on success.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), int blocks, int threads, size_t smem,
           cudaStream_t stream, A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace float_io
