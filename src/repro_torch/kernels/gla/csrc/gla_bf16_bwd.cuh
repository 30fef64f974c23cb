// Pieces shared by K10's two bfloat16 backwards: gla_bf16_bwd.cu (dk, dv
// <= 128) and gla_wide_bwd.cu (heads of any width, taken whole). Both
// compute the gradients of the chunked scan (gla.cu; g the within-chunk
// cumsum of log a, L the chunk, S_c the state after chunk c, dS_c its
// gradient)
//
//   dq_t = sum_{s <= t} (do_t . v_s) e^{g_t - g_s} k_s + e^{g_t} do_t S_{c-1}^T
//   dk_s = sum_{t >= s} (do_t . v_s) e^{g_t - g_s} q_t + e^{g_L - g_s} v_s dS_c^T
//   dv_s = sum_{t >= s} (q_t . k_s) e^{g_t - g_s} do_t + e^{g_L - g_s} k_s dS_c
//   dg_t = q_t . dq_t - k_t . dk_t   (+ <dS_c, S_c> at the chunk's last row)
//   dS_{c-1} = e^{g_L} dS_c + U_c,   U_c = sum_t e^{g_t} q_t^T do_t
//
// for q, k, v and do in bfloat16, g, the chunk states and dS in float32; dq,
// dk and dv come out in bfloat16, each rounded once from its float32 sum,
// dg in float32.
//
// Numerics. A product of two bf16 inputs (K Q^T, V dO^T, D V^T) is one bf16
// product on the tensor cores, exact, summed in float32. A float32 operand
// (a masked, decayed score tile, q e^g, S_{c-1}, dS_c) enters its product as
// two bf16 parts, x_hi = bf16(x) and x_lo = bf16(x - x_hi), the small part
// first: one part alone keeps 8 bits and its emulation leaves the card's
// bound (one bf16 rounding of the plain gradient plus 1e-4 of its largest
// element) 6-20 times over; two parts keep the float32 error ~2^-17 of each
// term, and the emulation of every product at zamba2's and mLSTM's dims
// stays inside it (tests/test_torch_gla_bf16_bwd.py). Masks and the e^g
// factors are applied on the CUDA cores to a score tile's float32 product
// before its split, as gla_bwd.cu does.
//
// Every kernel here is one warpgroup (128 threads), so no wgmma sits on a
// branch of the warpgroup; loop trip counts depend on the block's indices
// alone. Tiles are bf16 in shared memory in wgmma.cuh's 128-byte swizzled
// layout: 64-column sub-tiles of R rows (a row 128 bytes, 16-byte chunk c
// of row r at chunk c ^ (r % 8)), R * 128 bytes apart, each 1024-aligned.
// One tile serves as a K-major operand (its rows M or N, its columns K) or
// as an MN-major one (its rows K), so dS_c's parts, stored once as they
// lie, are both dS_c^T (K-major) and dS_c (MN-major).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "../../attention/csrc/bf16_tile.cuh"
#include "../../attention/csrc/wgmma.cuh"
#include "../../csrc/float_io.cuh"

namespace gla_bf16_bwd {

constexpr int kThreads = 128;         // one warpgroup a block
constexpr int kTile = 64;             // rows of a tile
constexpr int kParts = 2;             // bf16 parts of a float32 operand
constexpr uint32_t kAtom = 64 * 128;  // a 64-row x 64-column sub-tile

using wgmma::smem_u32;

// ---- wgmma ----------------------------------------------------------------

// d[64 x N] (+)= A[64 x 16] B[16 x N], both in shared memory, A K-major
// (TA = 0) or MN-major (TA = 1), B K-major (TB = 0) or MN-major (TB = 1);
// scale_d = 0 overwrites d.
template <int N, int TB, int TA>
struct SS;
template <int TB, int TA>
struct SS<64, TB, TA> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %36, %35;\n}\n"
        : WG_D32(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
  }
};
template <int TB, int TA>
struct SS<128, TB, TA> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %68, %67;\n}\n"
        : WG_D64(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

// d[64 x N] += A[64 x 16] B[16 x N], A from registers (the A fragments of a
// k16 step, four bf16x2 a thread), B MN-major in shared memory.
template <int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t db) {
  bf16_tile::WgmmaRS<N>::run(d, a, db, 1);
}

template <int N>
__device__ __forceinline__ void pin_all(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) wgmma::pin(d[i]);
}
template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// K-major descriptor of k16 step kk of a tile whose rows are M or N and
// whose columns are K, its 64-column sub-tiles `sub` bytes apart.
__device__ __forceinline__ uint64_t kdesc(uint32_t t, int kk, uint32_t sub) {
  return wgmma::desc(t + (kk / 4) * sub + (kk % 4) * 32, 16, 1024);
}
// MN-major descriptor of rows [16 kk, 16 kk + 16) (K) of a tile whose
// columns are M or N, its 64-column sub-tiles `sub` bytes apart.
__device__ __forceinline__ uint64_t mndesc(uint32_t t, int kk, uint32_t sub) {
  return wgmma::desc(t + kk * 2048, sub, 1024);
}

// ---- staging ----------------------------------------------------------------

// Byte offset of 16-byte chunk c (columns 8 c .. 8 c + 7) of row r in a
// swizzled tile of R rows.
__device__ __forceinline__ uint32_t swz(int r, int c, int R) {
  return (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// Rows [row0, row0 + R) and columns [col0, col0 + D) of the row-major bf16
// matrix src (row stride ld) into the swizzled R-row tile at dst, zero past
// nrows rows and ncols columns. vec (ld and col0 multiples of 8, src
// 16-byte aligned): whole 16-byte chunks by cp.async (the caller commits);
// else element by element.
template <int D, int R>
__device__ __forceinline__ void load_bf16(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, long long ld, int col0,
                                          int ncols, bool vec, int tid) {
  constexpr int CH = D / 8;
  static_assert(R * CH % kThreads == 0, "whole passes");
#pragma unroll
  for (int n = 0; n < R * CH / kThreads; ++n) {
    const int e = tid + n * kThreads;
    const int r = e / CH, c = e % CH, c0 = col0 + 8 * c, row = row0 + r;
    const uint32_t d = dst + swz(r, c, R);
    const bool live = row < nrows && c0 < ncols;
    const __nv_bfloat16* s = src + (long long)row * ld + c0;
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(live ? s : src), "r"(live ? 16 : 0)
                   : "memory");
    } else {
      const unsigned short* p = reinterpret_cast<const unsigned short*>(s);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = c0 + 2 * i;
        const uint32_t lo = live && a < ncols ? p[2 * i] : 0u;
        const uint32_t hi = live && a + 1 < ncols ? p[2 * i + 1] : 0u;
        w[i] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return bf16_tile::pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Eight consecutive values as one 16-byte chunk of each of the kParts bf16
// parts, stored at dst + i * part (shared addresses): each part the bf16
// of what the parts before it leave, every difference exact.
__device__ __forceinline__ void store_parts(uint32_t dst, uint32_t part,
                                            float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const __nv_bfloat16 a = __float2bfloat16_rn(x[2 * u]);
      const __nv_bfloat16 b = __float2bfloat16_rn(x[2 * u + 1]);
      w[u] = bf16_tile::pack(a, b);
      x[2 * u] = __fsub_rn(x[2 * u], __bfloat162float(a));
      x[2 * u + 1] = __fsub_rn(x[2 * u + 1], __bfloat162float(b));
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + i * part),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// Eight values of row `row` of a row-major matrix (float32 or bf16, row
// stride ld), columns [c0, c0 + 8), zero past nrows and ncols: two 16-byte
// (float32) or one (bf16) load when vec and all eight are live.
__device__ __forceinline__ void load8(const float* src, int row, int nrows,
                                      long long ld, int c0, int ncols,
                                      bool vec, float (&x)[8]) {
  const float* p = src + (long long)row * ld + c0;
  if (vec && row < nrows && c0 + 8 <= ncols) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = row < nrows && c0 + u < ncols ? p[u] : 0.f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, int row,
                                      int nrows, long long ld, int c0,
                                      int ncols, bool vec, float (&x)[8]) {
  const __nv_bfloat16* p = src + (long long)row * ld + c0;
  if (vec && row < nrows && c0 + 8 <= ncols) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[2 * u] = __uint_as_float(w[u] << 16);
      x[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = row < nrows && c0 + u < ncols ? __bfloat162float(p[u]) : 0.f;
  }
}

// Rows [row0, row0 + R) and columns [col0, col0 + D) of the row-major
// matrix src (float32 or bf16, row stride ld), each row r times scale[r]
// (shared float32, or none: 1), as the kParts bf16 parts of the swizzled
// R-row tile at dst, `part` bytes apart, zero past nrows and ncols.
template <int D, int R, typename T>
__device__ __forceinline__ void load_split(uint32_t dst, uint32_t part,
                                           const T* src, int row0, int nrows,
                                           long long ld, int col0, int ncols,
                                           bool vec, const float* scale,
                                           int tid) {
  constexpr int CH = D / 8;
  for (int e = tid; e < R * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    float x[8];
    load8(src, row0 + r, nrows, ld, col0 + 8 * c, ncols, vec, x);
    if (scale != nullptr) {
      const float f = scale[r];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = __fmul_rn(x[u], f);
    }
    store_parts(dst + swz(r, c, R), part, x);
  }
}

// ---- a score tile in registers ---------------------------------------------

// The wgmma accumulator layout of m64nN (f32) for thread t of the
// warpgroup: warp w = t / 32, g = (t % 32) / 4, qd = t % 4; register
// 4 j + 2 h + e holds row 16 w + g + 8 h, column 8 j + 2 qd + e.
//
// x[row, col] of a 64 x 64 score tile whose rows are `rows` (g of its
// row 16 w + g + 8 h in gr[h]) and whose columns the tile's other side
// (g of its column col in gc[col]): kept, times e^{g_t - g_s}, where the
// causal order holds (s <= t < L, with t the query and s the key index of
// the pair, row0 / col0 the tile's first index), else 0. rows_are_t: the
// rows are queries.
__device__ __forceinline__ void mask_decay(float (&x)[32], const float* gc,
                                           const float (&gr)[2], int row0,
                                           int col0, int L, bool rows_are_t,
                                           int warp, int gq, int qd) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = 8 * j + 2 * qd + e, col = col0 + cl;
      const float gcol = gc[cl];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * warp + gq + 8 * h;
        const int t = rows_are_t ? row : col, s = rows_are_t ? col : row;
        const float gt = rows_are_t ? gr[h] : gcol;
        const float gs = rows_are_t ? gcol : gr[h];
        const int i = 4 * j + 2 * h + e;
        x[i] = s <= t && t < L ? __fmul_rn(x[i], expf(__fsub_rn(gt, gs)))
                               : 0.f;
      }
    }
}

// Rows of an m64nN accumulator times f[h] (the factor of this thread's row
// 16 w + g + 8 h).
template <int N>
__device__ __forceinline__ void scale_rows(float (&acc)[N / 2],
                                           const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = __fmul_rn(acc[i], f[(i / 2) % 2]);
}

// Adds an accumulator of the same layout: acc += x.
template <int N>
__device__ __forceinline__ void add(float (&acc)[N / 2],
                                    const float (&x)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = __fadd_rn(acc[i], x[i]);
}

// acc[64 x N] += X[64 x 64] C, X a score tile in registers (its two parts
// the A fragments of the four k16 steps, the small part first) and C the
// [64, N] tile at c, MN-major (its rows K), sub-tiles `sub` bytes apart.
template <int N>
__device__ __forceinline__ void score_product(float (&acc)[N / 2],
                                              const float (&x)[32],
                                              uint32_t c, uint32_t sub) {
  uint32_t hi[4][4], lo[4][4];
  bf16_tile::split_fragments(x, hi, lo);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      wgmma::pin(hi[kk][r]);
      wgmma::pin(lo[kk][r]);
    }
  pin_all(acc);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    rs<N>(acc, lo[kk], mndesc(c, kk, sub));
    rs<N>(acc, hi[kk], mndesc(c, kk, sub));
  }
  wgmma::commit();
  wgmma::wait();
  pin_all(acc);
}

// x[64 x 64] += A B^T over K = 16 KS columns: A and B 64-row tiles,
// K-major, one bf16 product (exact) a k16 step.
template <int KS>
__device__ __forceinline__ void scores(float (&x)[32], uint32_t a,
                                       uint32_t b) {
  pin_all(x);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    SS<64, 0, 0>::run(x, kdesc(a, kk, kAtom), kdesc(b, kk, kAtom), 1);
  wgmma::commit();
  wgmma::wait();
  pin_all(x);
}

// sum over this thread's columns c (below ncols) of row `row` (its rows
// 16 w + g + 8 h) of x[row, col0 + c] acc[row, c], over the quad's four
// threads; x a row-major bf16 matrix (row stride ld), zero past nrows.
template <int N>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* x,
                                         const float (&acc)[N / 2], int row,
                                         int nrows, long long ld, int col0,
                                         int ncols, int h, int qd) {
  float p = 0.f;
  if (row < nrows)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * qd + e;
        if (col0 + col < ncols)
          p = __fmaf_rn(
              __bfloat162float(x[(long long)row * ld + col0 + col]),
              acc[4 * j + 2 * h + e], p);
      }
  p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
  return __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
}

// The accumulator acc[64 x N] (rows row0 + 16 w + g + 8 h, columns col0 +
// 8 j + 2 qd + e) rounded to bf16 into the row-major out (row stride ld),
// rows below nrows and columns below ncols.
template <int N>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* out,
                                           const float (&acc)[N / 2],
                                           int row0, int nrows, long long ld,
                                           int col0, int ncols, int warp,
                                           int gq, int qd) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * warp + gq + 8 * h;
    if (row >= nrows) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + 2 * qd + e;
        if (col < ncols)
          out[(long long)row * ld + col] =
              __float2bfloat16_rn(acc[4 * j + 2 * h + e]);
      }
  }
}

// g of rows [r0, r0 + 64) of a chunk into dst (shared), zero past L, by
// cp.async (threads tid < 64; the caller commits).
__device__ __forceinline__ void stage_g(uint32_t dst, const float* g, int r0,
                                        int L, int tid) {
  if (tid >= kTile) return;
  const bool live = r0 + tid < L;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst + 4 * tid),
               "l"(live ? g + r0 + tid : g), "r"(live ? 4 : 0)
               : "memory");
}

// kernel<<<grid, kThreads, smem, stream>>>(args...) with `smem` bytes of
// dynamic shared memory opted in: the CUDA error of the attribute call or
// of the launch, 0 on success.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, size_t smem, cudaStream_t stream,
           A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---- the dS chain -----------------------------------------------------------

// Shared memory of gla_bf16_bwd_ds_kernel<NV>, byte offsets from a
// 1024-aligned base: the parts of a 64-row step of q e^g (64 dk columns),
// the step's do tile (NV columns), e^g of its rows, the warps' partial sums.
template <int NV>
struct DsSmem {
  static constexpr uint32_t kA = 0;                       // kParts tiles
  static constexpr uint32_t kB = kA + kParts * kAtom;     // do
  static constexpr uint32_t kE = kB + (NV / 64) * kAtom;  // e^g, 64
  static constexpr uint32_t kRed = kE + kTile * 4;        // 4 warps
  static constexpr uint32_t kBytes = kRed + 4 * 4 + 1024;
};

// dS_c for every chunk, last first, in the registers of block (bh, 64-row
// dk tile r0, NV-column dv tile c0) of grid BH x ceil(dk / 64) x
// ceil(dv / NV): dS_{nc-1} the final state's gradient (zero when dstate is
// null), then dS_{c-1} = e^{g_L} dS_c + U_c, U_c's tile taken on the tensor
// cores over the chunk's 64-row steps as (q e^g)^T do, q e^g in two parts
// (A MN-major, its rows the steps' rows) against do (B MN-major). Each
// dS_c goes to ds [BH, nc, dk, ld]; <dS_c, S_c> over the tile to red[(bh
// nc + c) ntiles + tile], summed in a fixed order (the four warps' sums in
// warp order). do, states and ds have row stride ld (>= dv), dstate dv.
template <int NV>
__global__ void __launch_bounds__(kThreads)
    gla_bf16_bwd_ds_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ dO,
                           const float* __restrict__ g,
                           const float* __restrict__ states,
                           const float* __restrict__ dstate,
                           float* __restrict__ ds, float* __restrict__ red,
                           int S, int L, int dk, int dv, int ld, bool vec_q,
                           bool vec_o) {
  using M = DsSmem<NV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  float* eg = reinterpret_cast<float*>(sm + M::kE);
  float* wred = reinterpret_cast<float*>(sm + M::kRed);
  const int tid = threadIdx.x, warp = tid / 32, gq = (tid % 32) / 4,
            qd = tid % 4;
  const int bh = blockIdx.x, r0 = 64 * blockIdx.y, c0 = NV * blockIdx.z;
  const int ntiles = gridDim.y * gridDim.z,
            tile = blockIdx.y * gridDim.z + blockIdx.z;
  const int nc = S / L;
  const long long dkv = (long long)dk * ld;
  float x[NV / 2];
#pragma unroll
  for (int j = 0; j < NV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + 16 * warp + gq + 8 * h,
                  col = c0 + 8 * j + 2 * qd + e;
        x[4 * j + 2 * h + e] =
            dstate != nullptr && row < dk && col < dv
                ? dstate[((long long)bh * dk + row) * dv + col]
                : 0.f;
      }
  for (int c = nc - 1; c >= 0; --c) {
    const long long slot = ((long long)bh * nc + c) * dkv;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < NV / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + 16 * warp + gq + 8 * h,
                    col = c0 + 8 * j + 2 * qd + e;
          if (row < dk && col < dv) {
            const long long at = slot + (long long)row * ld + col;
            const float y = x[4 * j + 2 * h + e];
            ds[at] = y;
            part = __fmaf_rn(y, states[at], part);
          }
        }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    if (tid % 32 == 0) wred[warp] = part;
    __syncthreads();
    if (tid == 0)
      red[((long long)bh * nc + c) * ntiles + tile] =
          __fadd_rn(__fadd_rn(wred[0], wred[1]), __fadd_rn(wred[2], wred[3]));
    if (c == 0) break;
    // U_c's tile
    const long long row0 = (long long)bh * S + (long long)c * L;
    float u[NV / 2];
    zero(u);
    for (int t0 = 0; t0 < L; t0 += kTile) {
      __syncthreads();  // the step before is done with every buffer
      load_bf16<NV, kTile>(base + M::kB, dO + row0 * ld, t0, L, ld, c0, dv,
                           vec_o, tid);
      wgmma::cp_async_commit();
      if (tid < kTile)
        eg[tid] = t0 + tid < L ? expf(g[row0 + t0 + tid]) : 0.f;
      __syncthreads();
      load_split<64, kTile>(base + M::kA, kAtom, q + row0 * dk, t0, L, dk,
                            r0, dk, vec_q, eg, tid);
      wgmma::cp_async_wait<0>();
      wgmma::fence_proxy_async();
      __syncthreads();
      pin_all(u);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = kParts - 1; p >= 0; --p)
          SS<NV, 1, 1>::run(u, mndesc(base + M::kA + p * kAtom, kk, kAtom),
                            mndesc(base + M::kB, kk, kAtom), 1);
      wgmma::commit();
      wgmma::wait();
      pin_all(u);
    }
    const float a = expf(g[row0 + L - 1]);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i)
      x[i] = __fadd_rn(__fmul_rn(a, x[i]), u[i]);
  }
}

}  // namespace gla_bf16_bwd
