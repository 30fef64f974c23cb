// K8: batched IIR filtering, direct form II transposed, from the zero
// state: y[b, :] = lfilter(bc, ac, x[b, :]) for every series b of x [B, T].
//
// K8 replaces repro/kernels/iir/kernel.py::_iir_kernel (entry
// iir_kernel_call), the Pallas TPU kernel reached through
// repro/kernels/iir/ops.py::lfilter_batched: the paper's order-6
// Chebyshev de-noise over every profiled series of a reference DB. There
// the lanes of a [128, T] tile hold 128 series and time is a fori_loop;
// here a thread holds one series, its filter state in registers, and time
// is its loop. Per sample, with a[0] = 1,
//
//   y   = fma(b0, x, z0)
//   z_i = fma(b_{i+1}, x, -(a_{i+1} * y)) + z_{i+1}      (z_order = 0)
//
// exactly the two fused steps of the plain version (kernel.py::df2t) and
// every other step rounded on its own (-fmad=false, _rn intrinsics): the
// order-6 filter is ill-conditioned in float32, one rounding moves the
// output by ~1e-3. The plain version forms each fma in float64 and rounds
// once more to float32; the two differ only where that double rounding
// lands on a float32 halfway point. So the arithmetic is fixed: one lane
// filters one series in time order, with no split of time, no state-space
// or associative-scan form and no reordering of a sample's operations;
// any of them changes the rounding, and the full-width check that
// witnesses every differing series as a double rounding would fail.
//
// Design: what changes is how x comes in and y goes out. A block is one
// warp and 32 series (8192 series are 256 warps, about two an SM). Time
// runs in tiles of [32 series x 64 samples] through a ring of kStages
// tiles in shared memory, filled kStages - 1 tiles ahead of the filter
// loop by cp.async: 16-byte copies when T is a multiple of 4 and x and y
// are 16-byte aligned (two tile rows an instruction, coalesced, each
// lane's addresses computed once a tile), else 4-byte copies, still
// asynchronous (T = 70 or 257, x one element into its storage). With three
// tiles ahead each warp keeps 24 KB of loads in flight, ~6 MB over the
// card, where the first version kept one 8 KB tile per warp and waited on
// it. Tile rows are kStride = 68 floats apart: 68 is 4 mod 32, so the 8
// lanes of each phase of a warp's float4 reads (lane l reads its own row)
// cover all 32 banks. A lane reads its row four samples at a time as a
// float4 and filters them, kUnroll float4s an iteration: the next read
// leaves the dependence chain, and the loop stays small in the
// instruction cache (a whole unrolled tile was slower on the card). It
// writes y over x in place; the warp then stores the tile row by row with
// coalesced 16-byte stores, fire-and-forget from registers, and the slot
// is refilled once every lane has read it (__syncwarp). The kernel is
// templated on the order (1 to 8), so the state is a register array.
//
// Bound on this card: bytes. At full width (B = 8192 series x T = 3600
// samples) it reads and writes 235.9 MB, 0.070 ms at 3.35 TB/s; its
// 26 f32 operations a sample (order 6) take 0.011 ms at 67 TFLOP/s. Each
// sample's update is a chain of four dependent operations (fma, mul, fma,
// add: ~16 cycles) and a warp issues ~22 instructions a sample, so a
// series takes ~80,000 cycles (~0.04 ms) whatever the memory does: below
// the byte bound, so memory-level parallelism, which the ring supplies,
// is what the first version lacked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;           // series a block: one warp, a lane each
constexpr int kTile = 64;           // samples a tile row
constexpr int kStages = 4;          // ring slots; kStages - 1 tiles ahead
constexpr int kStride = 68;         // floats between tile rows (4 mod 32)
constexpr int kChunks = kTile / 4;  // 16-byte chunks a tile row
constexpr int kUnroll = 2;          // float4 steps an iteration of the filter
constexpr int kSlot = kRows * kStride;  // floats a ring slot
constexpr int kRowsPer = 32 / kChunks;  // rows a 16-byte copy instruction

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_tiles() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy samples [t0, t0 + kTile) of the block's nrows series (row-major
// at xb, T samples a row) into ring slot `dst`, and commit them as one
// group (an empty one past the last tile, so the groups count tiles).
// vec: 16-byte copies, copy q = lane + 32 i is chunk q % kChunks of row
// q / kChunks (kRowsPer rows an instruction, the lane's first copy at
// src + t0 and dst, each next one kRowsPer rows on); else 4-byte copies,
// copy q is sample q % kTile of row q / kTile. Nothing past nrows or T is
// copied.
__device__ __forceinline__ void load_tile(float* dst, const float* xb,
                                          int nrows, int T, int t0,
                                          bool vec, int lane) {
  if (vec) {
    const int r0 = lane / kChunks, c = 4 * (lane % kChunks);
    if (t0 + c < T) {
      const float* src = xb + (long long)r0 * T + t0 + c;
      const uint32_t d = smem_u32(dst + r0 * kStride + c);
      const long long step = (long long)kRowsPer * T;
#pragma unroll
      for (int i = 0; i < kRows / kRowsPer; ++i)
        if (r0 + kRowsPer * i < nrows)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           d + i * kRowsPer * kStride * 4),
                       "l"(src + i * step)
                       : "memory");
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kRows * kTile / 32; ++i) {
      const int q = lane + 32 * i, r = q / kTile, c = q % kTile;
      if (r < nrows && t0 + c < T)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         smem_u32(dst + r * kStride + c)),
                     "l"(xb + (long long)r * T + t0 + c)
                     : "memory");
    }
  }
  commit();
}

// Store the filtered tile in slot `src` to samples [t0, t0 + kTile) of
// the block's rows of y, with the copies' lane map.
__device__ __forceinline__ void store_tile(const float* src, float* yb,
                                           int nrows, int T, int t0,
                                           bool vec, int lane) {
  if (vec) {
    const int r0 = lane / kChunks, c = 4 * (lane % kChunks);
    if (t0 + c < T) {
      float* out = yb + (long long)r0 * T + t0 + c;
      const float* in = src + r0 * kStride + c;
      const long long step = (long long)kRowsPer * T;
#pragma unroll
      for (int i = 0; i < kRows / kRowsPer; ++i)
        if (r0 + kRowsPer * i < nrows)
          *reinterpret_cast<float4*>(out + i * step) =
              *reinterpret_cast<const float4*>(in + i * kRowsPer * kStride);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kRows * kTile / 32; ++i) {
      const int q = lane + 32 * i, r = q / kTile, c = q % kTile;
      if (r < nrows && t0 + c < T)
        yb[(long long)r * T + t0 + c] = src[r * kStride + c];
    }
  }
}

// One sample of the recurrence: y out, the state z advanced.
template <int ORDER>
__device__ __forceinline__ float step(const float (&bc)[ORDER + 1],
                                      const float (&ac)[ORDER + 1],
                                      float (&z)[ORDER], float xt) {
  const float yt = __fmaf_rn(bc[0], xt, z[0]);
#pragma unroll
  for (int i = 0; i < ORDER; ++i) {
    const float nz = i + 1 < ORDER ? z[i + 1] : 0.f;
    z[i] = __fadd_rn(
        __fmaf_rn(bc[i + 1], xt, -__fmul_rn(ac[i + 1], yt)), nz);
  }
  return yt;
}

template <int ORDER>
__device__ __forceinline__ float4 step4(const float (&bc)[ORDER + 1],
                                        const float (&ac)[ORDER + 1],
                                        float (&z)[ORDER], float4 xv) {
  float4 yv;
  yv.x = step<ORDER>(bc, ac, z, xv.x);
  yv.y = step<ORDER>(bc, ac, z, xv.y);
  yv.z = step<ORDER>(bc, ac, z, xv.z);
  yv.w = step<ORDER>(bc, ac, z, xv.w);
  return yv;
}

template <int ORDER>
__global__ void __launch_bounds__(kRows)
    iir_kernel(const float* __restrict__ b, const float* __restrict__ a,
               const float* __restrict__ x, float* __restrict__ y, int B,
               int T, bool vec) {
  extern __shared__ __align__(16) float ring[];  // kStages slots
  const int lane = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int nrows = B - r0 < kRows ? (int)(B - r0) : kRows;
  float bc[ORDER + 1], ac[ORDER + 1], z[ORDER];
#pragma unroll
  for (int i = 0; i <= ORDER; ++i) {
    bc[i] = b[i];
    ac[i] = a[i];
  }
#pragma unroll
  for (int i = 0; i < ORDER; ++i) z[i] = 0.f;
  const float* xb = x + r0 * T;
  float* yb = y + r0 * T;
  const int ntiles = (T + kTile - 1) / kTile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles)
      load_tile(ring + s * kSlot, xb, nrows, T, s * kTile, vec, lane);
    else
      commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    // tile k + kStages - 1 goes to the slot tile k - 1 left
    const int ahead = k + kStages - 1;
    if (ahead < ntiles)
      load_tile(ring + (ahead % kStages) * kSlot, xb, nrows, T,
                ahead * kTile, vec, lane);
    else
      commit();
    wait_tiles<kStages - 1>();  // this lane's copies of tile k are in
    __syncwarp();               // and every lane's
    const int t0 = k * kTile;
    const int nt = T - t0 < kTile ? T - t0 : kTile;
    float* slot = ring + (k % kStages) * kSlot;
    float* row = slot + lane * kStride;
    if (lane < nrows) {
      if (nt == kTile) {
#pragma unroll 1
        for (int c = 0; c < kTile; c += 4 * kUnroll) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            float4* p = reinterpret_cast<float4*>(row + c + 4 * u);
            *p = step4<ORDER>(bc, ac, z, *p);
          }
        }
      } else {
        int c = 0;
        for (; c + 4 <= nt; c += 4) {
          float4* p = reinterpret_cast<float4*>(row + c);
          *p = step4<ORDER>(bc, ac, z, *p);
        }
        for (; c < nt; ++c) row[c] = step<ORDER>(bc, ac, z, row[c]);
      }
    }
    __syncwarp();  // the tile is filtered
    store_tile(slot, yb, nrows, T, t0, vec, lane);
    __syncwarp();  // every lane has read the slot: it may be refilled
  }
}

template <int ORDER>
int launch(const float* b, const float* a, const float* x, float* y, int B,
           int T, bool vec, cudaStream_t stream) {
  constexpr int smem = kStages * kSlot * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      iir_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  iir_kernel<ORDER><<<(B + kRows - 1) / kRows, kRows, smem, stream>>>(
      b, a, x, y, B, T, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// K8. b, a [order + 1] float32 with a[0] = 1; x, y [B, T] float32,
// row-major (any 4-byte alignment). Returns the CUDA error of the
// shared-memory attribute call or cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for an order outside 1..8.
extern "C" int iir_filter(const float* b, const float* a, const float* x,
                          float* y, int B, int T, int order, void* stream) {
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = T % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  switch (order) {
    case 1: return launch<1>(b, a, x, y, B, T, vec, s);
    case 2: return launch<2>(b, a, x, y, B, T, vec, s);
    case 3: return launch<3>(b, a, x, y, B, T, vec, s);
    case 4: return launch<4>(b, a, x, y, B, T, vec, s);
    case 5: return launch<5>(b, a, x, y, B, T, vec, s);
    case 6: return launch<6>(b, a, x, y, B, T, vec, s);
    case 7: return launch<7>(b, a, x, y, B, T, vec, s);
    case 8: return launch<8>(b, a, x, y, B, T, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
