// bfloat16 tiles on Hopper's tensor cores, shared by K9's bf16 forward
// (flash_wgmma.cu) and its backward (flash_bf16_bwd.cuh): the loader of a
// 64-row tile into the 128-byte swizzled layout, and the two bf16 wgmma
// forms the kernels use, both operands from shared memory (K-major) and A
// from registers with B MN-major.
//
// A tile is stored as 64-column sub-tiles in the 128-byte swizzled layout
// (16-byte chunk c of row r at chunk c ^ (r % 8), each sub-tile 1024-byte
// aligned), zero past the matrix's rows and columns: a zero column adds
// exact zeros to every product, so padding a head dim changes nothing.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace bf16_tile {

constexpr int kRows = 64;             // rows of a tile
constexpr uint32_t kAtom = 64 * 128;  // a 64-row x 64-column sub-tile

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (D / 64) * kAtom;
}

// Rows [row0, row0 + 64) and columns [col0, col0 + D) (D 64 or 128) of
// the row-major [nrows, cols] bf16 matrix src into the swizzled sub-tiles
// at dst, zero past nrows and cols, by NT threads (tid < NT). Thread tid
// moves chunk tid % CH of rows tid / CH + i * RP: RP is a multiple of 8,
// so a thread's swizzle and columns are the same in every pass. vec:
// cols % 8 == 0 and src 16-byte aligned, so whole 16-byte chunks go by
// cp.async; otherwise element by element.
template <int D, int NT>
__device__ __forceinline__ void load_part(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, int cols, int col0,
                                          bool vec, int tid) {
  constexpr int CH = D / 8;    // 16-byte chunks a row
  constexpr int RP = NT / CH;  // rows a pass
  static_assert(RP % 8 == 0 && kRows % RP == 0, "tile passes");
  const int c = tid % CH, r = tid / CH, c0 = col0 + c * 8;
  const uint32_t d0 =
      dst + (c / 8) * kAtom + r * 128 + ((uint32_t)((c % 8) ^ (r & 7)) << 4);
  const bool col_live = c0 < cols;
  const long long g0 = (long long)(row0 + r) * cols + c0;
#pragma unroll
  for (int i = 0; i < kRows / RP; ++i) {
    const bool live = col_live && row0 + r + i * RP < nrows;
    const uint32_t d = d0 + i * RP * 128;
    const long long gi = g0 + (long long)i * RP * cols;
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(live ? src + gi : src), "r"(live ? 16 : 0)
                   : "memory");
    } else {
      const unsigned short* p =
          reinterpret_cast<const unsigned short*>(src) + gi;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = c0 + 2 * e;
        const uint32_t lo = live && a < cols ? p[2 * e] : 0u;
        const uint32_t hi = live && a + 1 < cols ? p[2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// Rows [row0, row0 + 64) and columns [0, D) of src into the D / 64
// sub-tiles at dst (load_part); a tile wider than 128 columns goes as a
// 128-column part and the rest.
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, int cols, bool vec,
                                          int tid) {
  if constexpr (D > 128) {
    load_part<128, NT>(dst, src, row0, nrows, cols, 0, vec, tid);
    load_part<D - 128, NT>(dst + 2 * kAtom, src, row0, nrows, cols, 128,
                           vec, tid);
  } else {
    load_part<D, NT>(dst, src, row0, nrows, cols, 0, vec, tid);
  }
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, A and B K-major in shared
// memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], A from registers (four bf16x2 a
// thread), B MN-major in shared memory (transpose bit set); scale_d = 0
// overwrites d.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo,
                                         __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// A score tile's float32 registers (the m64n64 accumulator layout:
// register 4 j + 2 h + e holds row 16 w + g + 8 h, column 8 j + 2 qd + e)
// as the A fragments of the four k16 steps over its 64 columns, split into
// two bf16 parts, x_hi = bf16(x) and x_lo = bf16(x - x_hi): register r of
// step kk packs columns 8 kk + 2 r and 8 kk + 2 r + 1 of the thread's
// registers.
__device__ __forceinline__ void split_fragments(const float (&x)[32],
                                                uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p0 = x[8 * kk + 2 * r], p1 = x[8 * kk + 2 * r + 1];
      const __nv_bfloat16 h0 = __float2bfloat16_rn(p0);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(p1);
      hi[kk][r] = pack(h0, h1);
      lo[kk][r] =
          pack(__float2bfloat16_rn(__fsub_rn(p0, __bfloat162float(h0))),
               __float2bfloat16_rn(__fsub_rn(p1, __bfloat162float(h1))));
    }
}

}  // namespace bf16_tile
