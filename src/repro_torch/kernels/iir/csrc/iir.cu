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
// lands on a float32 halfway point.
//
// Design: a block is one warp and 32 series. A thread per series reading
// x[b, t] at stride T would not coalesce, so the warp stages a [32, 64]
// time tile through shared memory: lanes load row by row (64 consecutive
// floats a row), each thread then filters its row of the tile in place,
// and the warp stores the tile row by row. The next tile's 64 loads a lane
// are issued into registers before the current tile is filtered, so they
// are in flight during the filtering. The filter state stays in registers
// across tiles. The kernel is templated on the order (1 to 8), so the
// state is a register array.
//
// Bound on this card: bytes. At full width (B = 8192 series x T = 3600
// samples) it reads and writes 235.9 MB, 0.070 ms at 3.35 TB/s; its
// 26 f32 operations a sample (order 6) take 0.011 ms at 67 TFLOP/s. Each
// sample's update is a chain of four dependent operations (fma, mul, fma,
// add: ~16 cycles), so a series takes ~57,600 cycles whatever the memory
// does. 8192 series are only 256 warps, about two an SM: even with the
// next tile in flight they keep too few loads outstanding to reach the
// memory rate, so latency, not bandwidth, bounds this version.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;   // series per block: one warp, a series a lane
constexpr int kTile = 64;   // time samples per shared-memory tile

template <int ORDER>
__global__ void __launch_bounds__(kRows)
    iir_kernel(const float* __restrict__ b, const float* __restrict__ a,
               const float* __restrict__ x, float* __restrict__ y, int B,
               int T) {
  constexpr int kPer = kTile / 32;  // columns of a tile row per lane
  __shared__ float tile[kRows][kTile + 1];
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
  // this lane's share of the next tile, loaded while the warp filters
  // the current one
  float next[kRows * kPer];
  auto load = [&](int t0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cc = 0; cc < kPer; ++cc) {
        const int c = lane + 32 * cc;
        next[r * kPer + cc] = (r < nrows && t0 + c < T)
                                  ? xb[(long long)r * T + t0 + c]
                                  : 0.f;
      }
  };
  load(0);
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = T - t0 < kTile ? T - t0 : kTile;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cc = 0; cc < kPer; ++cc)
        tile[r][lane + 32 * cc] = next[r * kPer + cc];
    __syncwarp();
    if (t0 + kTile < T) load(t0 + kTile);
    if (lane < nrows) {
      for (int c = 0; c < nt; ++c) {
        const float xt = tile[lane][c];
        const float yt = __fmaf_rn(bc[0], xt, z[0]);
#pragma unroll
        for (int i = 0; i < ORDER; ++i) {
          const float nz = i + 1 < ORDER ? z[i + 1] : 0.f;
          z[i] = __fadd_rn(
              __fmaf_rn(bc[i + 1], xt, -__fmul_rn(ac[i + 1], yt)), nz);
        }
        tile[lane][c] = yt;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cc = 0; cc < kPer; ++cc) {
        const int c = lane + 32 * cc;
        if (r < nrows && c < nt) yb[(long long)r * T + t0 + c] = tile[r][c];
      }
    __syncwarp();
  }
}

template <int ORDER>
void launch(const float* b, const float* a, const float* x, float* y, int B,
            int T, cudaStream_t stream) {
  iir_kernel<ORDER><<<(B + kRows - 1) / kRows, kRows, 0, stream>>>(
      b, a, x, y, B, T);
}

}  // namespace

// K8. b, a [order + 1] float32 with a[0] = 1; x, y [B, T] float32,
// row-major. Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for an order outside 1..8.
extern "C" int iir_filter(const float* b, const float* a, const float* x,
                          float* y, int B, int T, int order, void* stream) {
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 1: launch<1>(b, a, x, y, B, T, s); break;
    case 2: launch<2>(b, a, x, y, B, T, s); break;
    case 3: launch<3>(b, a, x, y, B, T, s); break;
    case 4: launch<4>(b, a, x, y, B, T, s); break;
    case 5: launch<5>(b, a, x, y, B, T, s); break;
    case 6: launch<6>(b, a, x, y, B, T, s); break;
    case 7: launch<7>(b, a, x, y, B, T, s); break;
    case 8: launch<8>(b, a, x, y, B, T, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
