// Split-TF32 pieces shared by the float32 backward kernels on Hopper's
// tensor cores: K9's (flash_f32_bwd.cu, flash_f32_bwd_mla.cu) and K10's
// (gla/csrc/gla_bwd.cu).
//
// Every operand of a product splits into two TF32 parts, a_hi =
// tf32_rna(a) and a_lo = tf32_rna(a - a_hi), and the product is taken as
// a_hi b_lo + a_lo b_hi + a_hi b_hi, the small products first, each exact
// in the tensor core, which sums in float32. Operand tiles in shared
// memory are K-major in wgmma.cuh's 128-byte swizzle. A product whose A
// operand is a score tile takes it from registers: the tile's float32
// accumulator, split, as the TF32 A fragments (fragments below); its B
// operand then lies transposed, with its K rows permuted by sigma to match.
// A step's product is taken on the tensor cores into fresh registers and
// added to the float32 sums on CUDA cores (accumulate below): the tensor
// cores' float32 sums truncate, and a sum over thousands of rows drifted
// past the kernels' 1e-4 check.
#pragma once

#include <stdint.h>

#include "wgmma.cuh"

namespace split_tf32 {

// Byte offset of 16-byte chunk c4 (columns 4 c4 .. 4 c4 + 3) of row r in
// a swizzled tile of R rows in 32-column sub-tiles (wgmma.cuh).
__device__ __forceinline__ uint32_t swz(int r, int c4, int R) {
  return (c4 / 8) * (R * 128) + r * 128 + (((c4 % 8) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}
// The two TF32 parts of a: a = hi + lo to ~2^-22 of a.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(__fsub_rn(a, __uint_as_float(hi)));
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}
__device__ __forceinline__ void sts128(uint32_t addr, float4 x) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}
__device__ __forceinline__ float lds32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// exp's argument where the mask drops a score: exp(-inf) = 0 exactly,
// without a branch.
__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

__device__ __forceinline__ float4 mul4(float4 x, float a) {
  return make_float4(__fmul_rn(x.x, a), __fmul_rn(x.y, a), __fmul_rn(x.z, a),
                     __fmul_rn(x.w, a));
}

// The parts of (x.x .. x.w) times `scale` to shared memory at hi and lo
// (times 1 is exact: an operand goes through it unchanged).
__device__ __forceinline__ void store_split(uint32_t hi, uint32_t lo,
                                            float4 x, float scale) {
  x = mul4(x, scale);
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  sts128(hi, h);
  sts128(lo, l);
}

// Columns [c0, c0 + 4) of row `row` of the row-major [nrows, cols] matrix
// src, zero past nrows and cols: one 16-byte load when vec.
__device__ __forceinline__ float4 load4(const float* src, int row, int nrows,
                                        int c0, int cols, bool vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= nrows || c0 >= cols) return x;
  const float* p = src + (long long)row * cols + c0;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  x.x = p[0];
  if (c0 + 1 < cols) x.y = p[1];
  if (c0 + 2 < cols) x.z = p[2];
  if (c0 + 3 < cols) x.w = p[3];
  return x;
}

// Chunk c4 of row r of the [nrows, cols] matrix src into the swizzled tile
// at dst (R rows), zero past the edges: by cp.async when vec (cols % 4 ==
// 0, src 16-byte aligned; the caller commits the group; a chunk past an
// edge copies 0 bytes from a valid address, so there is no branch), else
// element by element.
__device__ __forceinline__ void fill_chunk(uint32_t dst, const float* src,
                                           int row, int nrows, int c4,
                                           int cols, bool vec) {
  if (vec) {
    const bool live = row < nrows && 4 * c4 < cols;
    const float* p = src + (long long)(live ? row : 0) * cols +
                     (live ? 4 * c4 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(p), "r"(live ? 16 : 0)
                 : "memory");
    return;
  }
  sts128(dst, load4(src, row, nrows, 4 * c4, cols, false));
}

// Entries [r0, r0 + n) of a [nrows] vector into dst[n] by cp.async, zero
// past nrows (threads tid < n).
__device__ __forceinline__ void fill_vec(uint32_t dst, const float* src,
                                         int r0, int nrows, int n, int tid) {
  if (tid >= n) return;
  const bool live = r0 + tid < nrows;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst + 4 * tid),
               "l"(live ? src + r0 + tid : src), "r"(live ? 4 : 0)
               : "memory");
}

// The descriptor of a tile at shared-memory address a (wgmma::desc, 16 /
// 1024), made opaque to the compiler so that it is formed where it is used
// rather than hoisted out of a step loop and kept in registers; a
// product's k8 steps add their byte offset / 16 to it (the 14-bit start
// field does not carry: shared addresses are below 2^18).
__device__ __forceinline__ uint64_t tile_desc(uint32_t a) {
  uint64_t d = wgmma::desc(a, 16, 1024);
  asm volatile("" : "+l"(d));
  return d;
}

// d[64 x N] (+)= A[64 x 8] B[N x 8]^T, TF32, B K-major in shared memory;
// ss: A K-major in shared memory, rs: A from registers (four a thread);
// scale_d = 0 overwrites d.
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        : WG_D8(d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : WG_D8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : WG_D16(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : WG_D16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : WG_D32(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WG_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Mma<96> {
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1;\n}\n"
        : WG_D32(d), WG_D8(d, 32), WG_D8(d, 40)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : WG_D32(d), WG_D8(d, 32), WG_D8(d, 40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : WG_D64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : WG_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};


// Accumulator layout of wgmma m64nN (f32) for thread t of a warpgroup:
// warp w = t / 32, g = (t % 32) / 4, qd = t % 4; register 4 j + 2 h + e
// holds row 16 w + g + 8 h, column 8 j + 2 qd + e. The TF32 A fragment of
// m64k8: register r holds row 16 w + g + 8 (r % 2), column qd + 4 (r / 2).
// A score tile's registers [64 x 8 KS] become the A fragments of KS k8
// steps: A's columns c = qd + 4 (r / 2) of step j hold the tile's column
// 8 j + sigma(c), sigma(c) = 2 (c % 4) + c / 4: accumulator 4 j + 2 (r %
// 2) + r / 2 (the transposed staging puts row 8 j + sigma(c) at position
// 8 j + c to match).
template <int KS>
__device__ __forceinline__ void fragments(const float (&x)[4 * KS],
                                          uint32_t (&hi)[KS][4],
                                          uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split(x[4 * j + 2 * (r % 2) + r / 2], hi[j][r], lo[j][r]);
}

// acc[64 x W] += X Bt^T over a step's 8 KS rows, X's parts as the A
// fragments of KS k8 steps from registers, W rows of Bt as its parts (k8
// step j of each at bhi + 32 j, blo + 32 j bytes): X_hi Bt_lo + X_lo Bt_hi
// + X_hi Bt_hi on the tensor cores into fresh registers (one m64nW
// chain), then added to acc on CUDA cores.
template <int W, int KS>
__device__ __forceinline__ void accumulate(float (&acc)[W / 2],
                                           const uint32_t (&xhi)[KS][4],
                                           const uint32_t (&xlo)[KS][4],
                                           uint32_t bhi, uint32_t blo) {
  float part[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) part[i] = 0.f;
  const uint64_t dhi = tile_desc(bhi), dlo = tile_desc(blo);
  wgmma::fence();
#pragma unroll
  for (int prod = 0; prod < 3; ++prod)  // hi lo, lo hi, hi hi
#pragma unroll
    for (int j = 0; j < KS; ++j)
      Mma<W>::rs(part, prod == 1 ? xlo[j] : xhi[j],
                 (prod == 0 ? dlo : dhi) + ((j * 32) >> 4), prod > 0 || j > 0);
  wgmma::commit();
  wgmma::wait();
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    wgmma::pin(part[i]);
    acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// Rows r0 + 16 w + g + 8 h (those below nrows) of the [64 x W]
// accumulator of warpgroup thread wt, times `scale`, to columns c0 .. of
// the [nrows, cols] matrix dst, columns past cols dropped.
template <int W>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[W / 2],
                                          int r0, int nrows, int c0,
                                          int cols, float scale, int wt) {
  const int w = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * w + g + 8 * h;
    if (row >= nrows) continue;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * qd + e;
        if (col < cols)
          dst[(long long)row * cols + col] =
              __fmul_rn(acc[4 * j + 2 * h + e], scale);
      }
  }
}


// Blocks of two warpgroups over resident [64, D] tiles and 32-row steps
// (flash_f32_bwd.cu's kernels and gla_bwd.cu's): the step's tiles and
// their staging, D up to 128.
namespace rows32 {

constexpr int kBM = 64;        // rows of a resident tile (the wgmma M)
constexpr int kBN = 32;        // rows of a step's tile
constexpr int kWG = 128;       // threads of a warpgroup
constexpr int kThreads = 256;  // a block: two warpgroups

// Rows [r0, r0 + 64) of the [nrows, cols] matrix src, times `scale`, as
// the parts of a resident [64, D] tile, zero past the edges, by the
// block's threads.
template <int D>
__device__ __forceinline__ void stage_resident(uint32_t hi, uint32_t lo,
                                               const float* src, int r0,
                                               int nrows, int cols, bool vec,
                                               float scale, int tid) {
  constexpr int C4 = D / 4;
#pragma unroll 4
  for (int n = 0; n < kBM * C4 / kThreads; ++n) {
    const int u = tid + n * kThreads, r = u / C4, c4 = u % C4;
    const uint32_t off = swz(r, c4, kBM);
    store_split(hi + off, lo + off,
                load4(src, r0 + r, nrows, 4 * c4, cols, vec), scale);
  }
}

// Rows [r0, r0 + 32) of the [nrows, cols] matrix src into the raw tile at
// dst (swizzled as a [32, D] operand tile), zero past the edges, by the
// block's threads, each one 16-byte chunk of every 256 / (D / 4)-th row:
// by cp.async when vec (cols % 4 == 0, src 16-byte aligned; the caller
// commits the group; a chunk past an edge copies 0 bytes from a valid
// address, so the loop has no branch), else element by element.
template <int D>
__device__ __forceinline__ void fill_raw(uint32_t dst, const float* src,
                                         int r0, int nrows, int cols,
                                         bool vec, int tid) {
  constexpr int C4 = D / 4;
  constexpr int RP = kThreads / C4;  // rows a pass
  static_assert(kThreads % C4 == 0 && kBN % RP == 0, "raw tile passes");
  const int c4 = tid % C4, rt = tid / C4;
  if (vec) {
    const bool col_live = 4 * c4 < cols;
#pragma unroll
    for (int n = 0; n < kBN / RP; ++n) {
      const int r = rt + n * RP, row = r0 + r;
      const bool live = col_live && row < nrows;
      const float* p = src + (long long)(live ? row : 0) * cols +
                       (col_live ? 4 * c4 : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst + swz(r, c4, kBN)),
                   "l"(p), "r"(live ? 16 : 0)
                   : "memory");
    }
    return;
  }
#pragma unroll
  for (int n = 0; n < kBN / RP; ++n) {
    const int r = rt + n * RP;
    const float4 x = load4(src, r0 + r, nrows, 4 * c4, cols, false);
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + swz(r, c4, kBN)),
                 "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
                 : "memory");
  }
}

// A step's raw tile [32, D] as its two parts stacked into the [64, D]
// operand tile at dst, by the block's threads: row r's lo part at row r,
// its hi part at row 32 + r (so one n64 product takes A_hi against both,
// and an n32 one A_lo against the hi rows); with Halves, rows 0-15 then
// rows 16-31 each as lo then hi (row r at 32 (r / 16) + r % 16 and 16
// more: half the step is an n32 and an n16 product). Rows times `scale`,
// or times e^{g[r]} (g the step's 32 at sg) when sg is not 0.
template <int D, bool Halves = false>
__device__ __forceinline__ void stage_rows(uint32_t dst, uint32_t raw,
                                           float scale, uint32_t sg,
                                           int tid) {
  constexpr int C4 = D / 4;
#pragma unroll
  for (int n = 0; n < kBN * C4 / kThreads; ++n) {
    const int u = tid + n * kThreads, r = u / C4, c4 = u % C4;
    const int lo = Halves ? 32 * (r / 16) + r % 16 : r;
    const int hi = Halves ? lo + 16 : r + kBN;
    const float f = sg ? expf(lds32(sg + 4 * r)) : scale;
    store_split(dst + swz(hi, c4, kBM), dst + swz(lo, c4, kBM),
                lds128(raw + swz(r, c4, kBN)), f);
  }
}

// The transpose [D, 32] of a step's tile, in place: its parts as
// stage_rows stacked them at `tile` become the transpose's parts (hi at
// tile, lo D 128 bytes on; a row of 32 floats is one 128-byte swizzled
// row), by the block's threads over the 2 D units, one a thread. Unit u
// in phases of 8 lanes P = u / 8 (A = D / 32, a = P % A, b = P / A % 2, c
// = P / 2 A) with lane l = u % 8 takes ch = l ^ 2 c and nv = 8 a + 2 (l /
// 2) + b, and moves columns 4 nv .. 4 nv + 3 of the rows 8 (ch / 2) + ch %
// 2 + 2 m (m = 0..3) to positions 4 ch .. 4 ch + 3 of rows 4 nv + e, where
// sigma puts those rows: every (ch, nv) once, and in each phase the 8
// lanes' reads (chunk (nv % 8) ^ (row % 8)) and writes (chunk ch ^ (4 (nv
// % 2) + e)) fall in 8 different 16-byte bank groups. Every thread reads
// its unit, the block waits, then every thread writes.
template <int D>
__device__ __forceinline__ void stage_cols_unit(uint32_t tile, int u,
                                                bool live) {
  constexpr int A = D / 32;
  const int P = u / 8, l = u % 8;
  const int ch = l ^ (2 * (P / (2 * A)));
  const int nv = 8 * (P % A) + 2 * (l / 2) + (P / A) % 2;
  float4 c[2][4];  // [lo, hi][m]
  if (live) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = 8 * (ch / 2) + ch % 2 + 2 * m;
      c[0][m] = lds128(tile + swz(r, nv, kBM));
      c[1][m] = lds128(tile + swz(r + kBN, nv, kBM));
    }
  }
  __syncthreads();  // every read of the tile is done
  if (!live) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = 4 * nv + e;
    const uint32_t off = row * 128 + ((ch ^ (row & 7)) << 4);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const float4* x = c[part];
      const float4 col =
          e == 0 ? make_float4(x[0].x, x[1].x, x[2].x, x[3].x)
          : e == 1 ? make_float4(x[0].y, x[1].y, x[2].y, x[3].y)
          : e == 2 ? make_float4(x[0].z, x[1].z, x[2].z, x[3].z)
                   : make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
      sts128(tile + (part == 0 ? D * 128 : 0) + off, col);
    }
  }
}

template <int D>
__device__ __forceinline__ void stage_cols(uint32_t tile, int tid) {
  static_assert(2 * D <= kThreads, "a unit a thread");
  stage_cols_unit<D>(tile, tid, tid < 2 * D);
}

// stage_cols of two step tiles: in one pass, a unit a thread, where the
// block's threads cover both (D 64), else one after the other.
template <int D>
__device__ __forceinline__ void stage_cols2(uint32_t a, uint32_t b,
                                            int tid) {
  if constexpr (4 * D <= kThreads) {
    stage_cols_unit<D>(tid < 2 * D ? a : b, tid % (2 * D), true);
  } else {
    stage_cols<D>(a, tid);
    stage_cols<D>(b, tid);
  }
}

// A score tile, d[64 x N / 2] = A B^T over D columns, A [64, D] as its
// parts, B N / 2 rows of a stacked step tile at b as their parts (lo rows,
// then hi rows N / 2 on), in two independent accumulator chains: w = A_hi
// [B_lo; B_hi]^T (one nN product a k8 step) and x = A_lo B_hi^T (n N /
// 2); then d = (w's first half + x) + w's second half on CUDA cores, the
// small products first. N = 64 (a 32-row step) or 32 (half of one).
template <int D, int N>
__device__ __forceinline__ void scores(float (&d)[N / 4], uint32_t ahi,
                                       uint32_t alo, uint32_t b) {
  float w[N / 2], x[N / 4];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) w[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) x[i] = 0.f;
  const uint64_t dah = tile_desc(ahi), dal = tile_desc(alo),
                 db = tile_desc(b), dbh = tile_desc(b + N / 2 * 128);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t ka = ((kk / 4) * (kBM * 128) + (kk % 4) * 32) >> 4;
    Mma<N>::ss(w, dah + ka, db + ka, kk > 0);
    Mma<N / 2>::ss(x, dal + ka, dbh + ka, kk > 0);
  }
  wgmma::commit();
  wgmma::wait();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) wgmma::pin(w[i]);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    wgmma::pin(x[i]);
    d[i] = __fadd_rn(__fadd_rn(w[i], x[i]), w[N / 4 + i]);
  }
}

}  // namespace rows32

}  // namespace split_tf32
