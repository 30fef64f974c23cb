// The backward of K9 for float32 inputs (dh, dv <= 128): the gradients of
// causal (or not) GQA flash attention,
//
//   s = (q dh^-0.5) . k,  p = exp(s - lse),  D = rowsum(do * o),
//   dv = P^T do,  dP = do v^T,  dS = P * (dP - D),
//   dq = dh^-0.5 (dS k),  dk = dS^T (q dh^-0.5),
//
// for q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv], o and do [B, H,
// S, dv] and the forward's row statistic lse [B, H, S] (flash_tf32.cu
// writes it: m + log(max(l, 1e-30)) of the scaled scores), query head h
// reading kv head h / G, G = H / KV. The conventions are the forward's: q
// is scaled (rounded to float32) before the dot, the causal mask is t <= s
// with both counted from 0 (top-left aligned), rows past S and keys past
// T contribute nothing.
//
// It replaces no TPU kernel: the reference has no backward kernel. Its
// models never call their Pallas kernel, and jax.grad differentiates the
// jnp attention (repro/models/attention.py). The port's forward runs K9
// on the card, so its backward is a kernel too.
//
// Numerics: split TF32 on the tensor cores, as the forward (flash_tf32.cu).
// Every operand of every product splits into two TF32 parts, a_hi =
// tf32_rna(a) and a_lo = tf32_rna(a - a_hi), and a product is taken as
// a_hi b_lo + a_lo b_hi + a_hi b_hi, the small products first, each exact
// in the tensor core, which sums in float32. P and dS stay in float32 on
// CUDA cores (mask, exp, P (dP - D)), then split in registers and enter
// the next product as its A operand from registers.
//
// Design. Three launches on the stream, one entry point, no atomics:
//
//   flash_bwd_dot_kernel   D = rowsum(do * o), a warp a row;
//   flash_bwd_dkdv_kernel  a block of two warpgroups per (b, kv head,
//                          64-row kv tile), the tiles with the most query
//                          tiles under the causal frontier first. K and V
//                          stay in shared memory as their parts while the
//                          block walks its G query heads in order and, for
//                          each, the 32-row query tiles from the frontier
//                          on. A step:
//                            S^T  = K Q^T    warpgroup 0, wgmma, A K, B Q
//                            dP^T = V dO^T   warpgroup 1, A V, B dO
//                            P^T             warpgroup 0, handed to 1
//                            dS^T            warpgroup 1
//                            dV  += P^T dO   warpgroup 0, A P^T from
//                                            registers, B dO^T
//                            dK  += dS^T Q   warpgroup 1, A dS^T, B Q^T
//                          so each kv head's dk and dv sum over its query
//                          heads and tiles in one fixed order, in one block;
//   flash_bwd_dq_kernel    a block of two warpgroups per (b, head, 64-row
//                          query tile), the longest first. Q and dO stay in
//                          shared memory as their parts while the block
//                          walks the 32-row kv tiles up to the frontier:
//                          S = Q K^T and P in warpgroup 0, dP = dO V^T in
//                          1, each handed to the other, dS in both (the
//                          same), and dQ += dS K, columns 0 .. D / 2 - 1 in
//                          warpgroup 0, the rest in 1 (A dS, B K^T).
//
// Each product runs in its own warpgroup so that two warpgroups' wgmma
// chains share the tensor cores: one warpgroup's chain of dependent
// products alone kept them mostly idle. A step's product is taken on the
// tensor cores into fresh registers and added to the float32 sums on CUDA
// cores: the tensor cores' float32 sums truncate, and a kv row's sum over
// thousands of query rows (a few large P terms, then many small ones)
// drifted past chip_smoke.py's K9_BWD_REL at minitron-4b's layer.
//
// TF32 wgmma reads both operands K-major only (no transpose bit for 32-bit
// types), and both parts of an operand must be resident: a [R, D] operand
// takes 8 R D bytes. The 32-row tile of a step (Q and dO in dkdv, K and V
// in dq) comes in raw by cp.async (vec) into a raw buffer, one step ahead;
// the threads split it into its parts as it lies (the B operand of the
// score products), then, once those products are done, move the parts
// into the same buffers transposed (dO^T, Q^T, or K^T, [D, 32]: the B
// operand of the products that contract over the 32 rows), with the rows
// permuted by sigma to match the A fragments taken from the accumulator
// (flash_tf32.cu notes sigma at its PV product). The two parts of a step
// tile are stacked in one [64, D] tile, so that A_hi B_lo and A_hi B_hi
// are one m64n64 product. So at D = 128 a block takes 229,888 bytes
// (230,912 with the alignment slack) of an SM's 232,448: 4 parts of
// 64-row tiles (131,072), the step's two stacked tiles (65,536), the raw
// tiles (32,768), two steps' lse and D (512). One block an SM: nothing is
// double-buffered but the raw tiles, and a block's products wait on its
// own staging.
//
// Bound on this card: operations. The least work is 2 (3 dh + 2 dv) FLOPs
// a query-key pair under the mask (s, dP, dV, dK, dQ; P recomputed once);
// at minitron-4b's layer (H 24, S 4096, dh = dv = 128) 257.8 GFLOP, three
// TF32 products of it 773.3 GFLOP: 1.563 ms at the 494.7 TFLOP/s dense
// TF32 tensor-core peak (3.85 ms at the 67 TFLOP/s float32 CUDA-core
// peak). This design does 2 (4 dh + 3 dv) a pair (s and dP twice). Its
// bytes (q, k, v, o, do, lse, dq, dk, dv once) take 0.13 ms at 3.35 TB/s.
#include <stdint.h>

#include "../../csrc/float_io.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBM = 64;          // rows of the resident tile (the wgmma M)
constexpr int kBN = 32;          // rows of a step's tile
constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kThreads = 256;    // a block: two warpgroups

// Shared memory of both kernels at head dims up to D, byte offsets from a
// 1024-aligned base: the two parts of two resident [64, D] tiles (K and V
// in dkdv, Q and dO in dq), a step's two [32, D] tiles each as its two
// parts stacked into one [64, D] tile (Q and dO, then their transposes; K
// and V, then K^T), the two raw [32, D] tiles, two steps' 32 lse and D
// (dkdv), then the alignment slack.
template <int D>
struct Smem {
  static constexpr uint32_t kPart = kBM * D * 4;  // one [64, D] tile
  static constexpr uint32_t kRaw = kBN * D * 4;   // one [32, D] tile
  static constexpr uint32_t kAhi = 0;
  static constexpr uint32_t kAlo = kAhi + kPart;
  static constexpr uint32_t kBhi = kAlo + kPart;
  static constexpr uint32_t kBlo = kBhi + kPart;
  static constexpr uint32_t kX = kBlo + kPart;
  static constexpr uint32_t kY = kX + kPart;
  static constexpr uint32_t kRawX = kY + kPart;
  static constexpr uint32_t kRawY = kRawX + kRaw;
  static constexpr uint32_t kLse = kRawY + kRaw;       // two steps'
  static constexpr uint32_t kDelta = kLse + 2 * kBN * 4;
  static constexpr uint32_t kBytes = kDelta + 2 * kBN * 4 + 1024;
};
static_assert(Smem<128>::kBytes <= 232448, "an SM's shared memory");

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
// (times 1 is exact: dO, K and V go through it unchanged).
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

// Entries [r0, r0 + 32) of a [nrows] vector into dst[32] by cp.async,
// zero past nrows (threads tid < 32).
__device__ __forceinline__ void fill_vec(uint32_t dst, const float* src,
                                         int r0, int nrows, int tid) {
  if (tid >= kBN) return;
  const bool live = r0 + tid < nrows;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst + 4 * tid),
               "l"(live ? src + r0 + tid : src), "r"(live ? 4 : 0)
               : "memory");
}

// A step's raw tile [32, D], times `scale`, as its two parts stacked into
// the [64, D] operand tile at dst as it lies, by the block's threads: row
// r's lo part at row r, its hi part at row 32 + r (so one n64 product
// takes A_hi against both, and an n32 one A_lo against the hi rows).
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t dst, uint32_t raw,
                                           float scale, int tid) {
  constexpr int C4 = D / 4;
#pragma unroll
  for (int n = 0; n < kBN * C4 / kThreads; ++n) {
    const int u = tid + n * kThreads, r = u / C4, c4 = u % C4;
    store_split(dst + swz(r + kBN, c4, kBM), dst + swz(r, c4, kBM),
                lds128(raw + swz(r, c4, kBN)), scale);
  }
}

// Transposed unit u of 2 D (D / 4 column chunks nv x 8 chunks ch): u in
// phases of 8 lanes P = u / 8 (A = D / 32, a = P % A, b = P / A % 2, c =
// P / 2 A) with lane l = u % 8 taking ch = l ^ 2 c and nv = 8 a + 2 (l /
// 2) + b. Every (ch, nv) once, and in each phase the 8 lanes' reads
// (chunk (nv % 8) ^ (row % 8)) and transposed writes (chunk ch ^ (4 (nv %
// 2) + e)) fall in 8 different 16-byte bank groups.
template <int D>
__device__ __forceinline__ void t_unit(int u, int& ch, int& nv) {
  constexpr int A = D / 32;
  const int P = u / 8, l = u % 8;
  ch = l ^ (2 * (P / (2 * A)));
  nv = 8 * (P % A) + 2 * (l / 2) + (P / A) % 2;
}

// The transpose [D, 32] of a step's tile, in place: its parts as
// stage_rows stacked them at `tile` become the transpose's parts (hi at
// tile, lo D 128 bytes on; a row of 32 floats is one 128-byte swizzled
// row), by the block's threads over the 2 D units, one a thread: unit (ch,
// nv) moves columns 4 nv .. 4 nv + 3 of the rows 8 (ch / 2) + ch % 2 + 2 m
// (m = 0..3) to positions 4 ch .. 4 ch + 3 of rows 4 nv + e, where sigma
// puts those rows. The parts move unchanged. Every thread reads its unit,
// the block waits, then every thread writes.
template <int D>
__device__ __forceinline__ void stage_cols(uint32_t tile, int tid) {
  static_assert(2 * D <= kThreads, "a unit a thread");
  const bool live = tid < 2 * D;
  int ch = 0, nv = 0;
  float4 c[2][4];  // [lo, hi][m]
  if (live) {
    t_unit<D>(tid, ch, nv);
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
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       tile + (part == 0 ? D * 128 : 0) + off),
                   "f"(col.x), "f"(col.y), "f"(col.z), "f"(col.w)
                   : "memory");
    }
  }
}

// The descriptor of a tile at shared-memory address a (wgmma::desc, 16 /
// 1024), made opaque to the compiler so that it is formed where it is used
// rather than hoisted out of the step loop and kept in registers; a
// product's k8 steps add their byte offset / 16 to it (the 14-bit start
// field does not carry: shared addresses are below 2^18).
__device__ __forceinline__ uint64_t tile_desc(uint32_t a) {
  uint64_t d = wgmma::desc(a, 16, 1024);
  asm volatile("" : "+l"(d));
  return d;
}

// d[64 x 32] (+)= A[64 x 8] B[32 x 8]^T, TF32, A and B K-major in shared
// memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : WG_D16(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 8] B[64 x 8]^T, TF32, A and B K-major in shared
// memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 8] B[64 x 8]^T, TF32, A from registers (four a
// thread), B K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 8] B[128 x 8]^T, TF32, A from registers, B
// K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
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
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 32] (+)= A[64 x 8] B[32 x 8]^T, TF32, A from registers, B
// K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32)
    wgmma_rs_n32(d, a, db, scale_d);
  else if constexpr (N == 64)
    wgmma_rs_n64(d, a, db, scale_d);
  else
    wgmma_rs_n128(d, a, db, scale_d);
}

// The products of a score tile, d[64 x 32] = A B^T over D columns, A [64,
// D] as its parts, B [32, D] as its parts stacked (stage_rows), in two
// independent accumulator chains: w = A_hi [B_lo; B_hi]^T (one n64
// product a k8 step: columns 0..31 A_hi B_lo^T, 32..63 A_hi B_hi^T) and
// x = A_lo B_hi^T (n32); then d = (w's columns 0..31 + x) + w's columns
// 32..63 on CUDA cores, the small products first.
template <int D>
struct Scores {
  float w[32], x[16];
  __device__ __forceinline__ void issue(uint32_t ahi, uint32_t alo,
                                        uint32_t b) {
#pragma unroll
    for (int i = 0; i < 32; ++i) w[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = 0.f;
    const uint64_t dah = tile_desc(ahi), dal = tile_desc(alo),
                   db = tile_desc(b), dbh = tile_desc(b + kBN * 128);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t ka = ((kk / 4) * (kBM * 128) + (kk % 4) * 32) >> 4;
      wgmma_ss_n64(w, dah + ka, db + ka, kk > 0);
      wgmma_ss_n32(x, dal + ka, dbh + ka, kk > 0);
    }
  }
  __device__ __forceinline__ void take(float (&d)[16]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) wgmma::pin(w[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      wgmma::pin(x[i]);
      d[i] = __fadd_rn(__fadd_rn(w[i], x[i]), w[16 + i]);
    }
  }
};

// acc[64 x W] += X Bt^T over the step's 32 rows, X's parts as the A
// fragments of four k8 steps from registers, W rows of Bt [., 32] as its
// parts (at bhi and blo): X_hi Bt_lo + X_lo Bt_hi + X_hi Bt_hi on the
// tensor cores into fresh registers (W = 32, 64 or 128: one m64nW chain),
// then added to acc on CUDA cores. The tensor cores' float32 sums
// truncate, so a long sum over query rows or kv rows is kept out of them.
template <int W>
__device__ __forceinline__ void accumulate(float (&acc)[W / 2],
                                           const uint32_t (&xhi)[4][4],
                                           const uint32_t (&xlo)[4][4],
                                           uint32_t bhi, uint32_t blo) {
  float part[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) part[i] = 0.f;
  const uint64_t dhi = tile_desc(bhi), dlo = tile_desc(blo);
  wgmma::fence();
#pragma unroll
  for (int prod = 0; prod < 3; ++prod)  // hi lo, lo hi, hi hi
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs<W>(part, prod == 1 ? xlo[j] : xhi[j],
                  (prod == 0 ? dlo : dhi) + ((j * 32) >> 4), prod > 0 || j > 0);
  wgmma::commit();
  wgmma::wait();
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    wgmma::pin(part[i]);
    acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// Accumulator layout of wgmma m64nN (f32) for thread t of a warpgroup:
// warp w = t / 32, g = (t % 32) / 4, qd = t % 4; register 4 j + 2 h + e
// holds row 16 w + g + 8 h, column 8 j + 2 qd + e. The TF32 A fragment of
// m64k8: register r holds row 16 w + g + 8 (r % 2), column qd + 4 (r / 2).
// A score tile's registers become A's columns c = qd + 4 (r / 2) of k8
// step j, which hold the tile's column 8 j + sigma(c), sigma(c) = 2 (c %
// 4) + c / 4: accumulator 4 j + 2 (r % 2) + r / 2 (the transposed staging
// puts row 8 j + sigma(c) at position 8 j + c to match).
__device__ __forceinline__ void fragments(const float (&x)[16],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split(x[4 * j + 2 * (r % 2) + r / 2], hi[j][r], lo[j][r]);
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

// D[row] = sum_c do[row, c] o[row, c], a warp a row of BHS rows: lane l
// sums columns l, l + 32, .., then a butterfly over the warp.
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dot_kernel(const float* __restrict__ o,
                         const float* __restrict__ dO,
                         float* __restrict__ delta, long long BHS, int dv) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= BHS) return;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc = __fmaf_rn(dO[row * dv + c], o[row * dv + c], acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) delta[row] = acc;
}

// dK and dV of one 64-row kv tile (blockIdx.x: kv tile kt = blockIdx.x /
// BKV of kv head blockIdx.x % BKV, so the tiles with the most query tiles
// come first); the notes at the top. Both warpgroups stage each step;
// warpgroup 0 takes S^T and P^T and sums dV, warpgroup 1 takes dP^T and,
// with P^T handed over through the raw dO tile (free once staged, until
// the next step's dO is fetched), dS^T, and sums dK.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv_out,
                          int BKV, int H, int G, int S, int Tk, int dh,
                          int dv, float scale, int causal, int vec) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKhi = base + L::kAhi, sKlo = base + L::kAlo;
  const uint32_t sVhi = base + L::kBhi, sVlo = base + L::kBlo;
  const uint32_t sQ = base + L::kX;  // Q's parts, then Q^T's
  const uint32_t sO = base + L::kY;  // dO's, then dO^T's
  const uint32_t rawQ = base + L::kRawX, rawO = base + L::kRawY;
  const uint32_t sL = base + L::kLse, sD = base + L::kDelta;
  const int tid = threadIdx.x;
  const bool dk_wg = tid >= kWG;  // warpgroup 1 sums dK
  const int wt = tid % kWG;
  const int w = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
  const int kt = (int)(blockIdx.x / BKV);
  const int bkv = (int)(blockIdx.x % BKV);
  const int KV = H / G, b = bkv / KV, kvh = bkv % KV;
  const int t0 = kt * kBM;
  const int nq = (S + kBN - 1) / kBN;
  // query tiles from the one holding row t0 (the causal frontier)
  const int qstart = causal ? min(nq, t0 / kBN) : 0;
  const int per = nq - qstart;  // query tiles a head
  const int steps = G * per;
  // step i: query head kvh G + i / per, query tile qstart + i % per; its
  // Q, lse and D, then its dO
  auto fetch_q = [&](int i) {
    const long long bh = (long long)b * H + kvh * G + i / per;
    const int q0 = (qstart + i % per) * kBN;
    fill_raw<D>(rawQ, q + bh * S * dh, q0, S, dh, vec, tid);
    fill_vec(sL + (i % 2) * kBN * 4, lse + bh * S, q0, S, tid);
    fill_vec(sD + (i % 2) * kBN * 4, delta + bh * S, q0, S, tid);
    wgmma::cp_async_commit();
  };
  auto fetch_o = [&](int i) {
    const long long bh = (long long)b * H + kvh * G + i / per;
    const int q0 = (qstart + i % per) * kBN;
    fill_raw<D>(rawO, dO + bh * S * dv, q0, S, dv, vec, tid);
    wgmma::cp_async_commit();
  };
  if (steps > 0) {
    fetch_q(0);
    fetch_o(0);
  }
  stage_resident<D>(sKhi, sKlo, k + (long long)bkv * Tk * dh, t0, Tk, dh,
                        vec, 1.f, tid);
  stage_resident<D>(sVhi, sVlo, v + (long long)bkv * Tk * dv, t0, Tk,
                        dv, vec, 1.f, tid);
  float acc[D / 2];  // warpgroup 0: dV; 1: dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int kr = t0 + 16 * w + g;  // this thread's kv rows: kr, kr + 8
  for (int i = 0; i < steps; ++i) {
    const int q0 = (qstart + i % per) * kBN;
    // the step's raw tiles have landed, and every warp is done with the
    // step before's products
    wgmma::cp_async_wait<0>();
    __syncthreads();
    stage_rows<D>(sQ, rawQ, scale, tid);
    stage_rows<D>(sO, rawO, 1.f, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    if (i + 1 < steps) fetch_q(i + 1);
    // warpgroup 0: S^T = K Q^T; 1: dP^T = V dO^T (the operands chosen, the
    // products issued outside any branch: a wgmma on a divergent path
    // makes ptxas serialize them all)
    Scores<D> sc;
    sc.issue(dk_wg ? sVhi : sKhi, dk_wg ? sVlo : sKlo, dk_wg ? sO : sQ);
    wgmma::commit();
    wgmma::wait();
    float x[16];
    sc.take(x);
    // P^T = exp(S^T - lse[query]) under the mask, to warpgroup 1 through
    // the raw dO tile (thread wt's 16 as 4 chunks, conflict-free)
    const uint32_t sLi = sL + (i % 2) * kBN * 4, sDi = sD + (i % 2) * kBN * 4;
    if (!dk_wg) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * qd + e, row = q0 + c;
          const float l = lds32(sLi + 4 * c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int xi = 4 * j + 2 * h + e, t = kr + 8 * h;
            const bool live = row < S && t < Tk && !(causal && t > row);
            x[xi] = expf(live ? __fsub_rn(x[xi], l) : neg_inf());
          }
        }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         rawO + (c * kWG + wt) * 16),
                     "f"(x[4 * c]), "f"(x[4 * c + 1]), "f"(x[4 * c + 2]),
                     "f"(x[4 * c + 3])
                     : "memory");
    }
    __syncthreads();  // P^T handed over; every warp's products are done
    if (dk_wg) {
      // dS^T = P^T (dP^T - D[query])
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 pt = lds128(rawO + (c * kWG + wt) * 16);
        const float ps[4] = {pt.x, pt.y, pt.z, pt.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int xi = 4 * c + m;  // = 4 j + 2 h + e
          const float d = lds32(sDi + 4 * (8 * (xi / 4) + 2 * qd + xi % 2));
          x[xi] = __fmul_rn(ps[m], __fsub_rn(x[xi], d));
        }
      }
    }
    uint32_t xhi[4][4], xlo[4][4];
    fragments(x, xhi, xlo);
    // Q^T and dO^T over Q and dO, one after the other (both at once
    // spilled)
    stage_cols<D>(sQ, tid);
    stage_cols<D>(sO, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    if (i + 1 < steps) fetch_o(i + 1);
    const uint32_t bt = dk_wg ? sQ : sO;
    accumulate<D>(acc, xhi, xlo, bt, bt + D * 128);
  }
  if (dk_wg)
    store_acc<D>(dk + (long long)bkv * Tk * dh, acc, t0, Tk, 0, dh, 1.f, wt);
  else
    store_acc<D>(dv_out + (long long)bkv * Tk * dv, acc, t0, Tk, 0, dv, 1.f,
                 wt);
}

// dQ of one 64-row query tile (blockIdx.x: query tile nq - 1 -
// blockIdx.x / BH of head blockIdx.x % BH, the longest first); the notes
// at the top. Both warpgroups stage each step; warpgroup 0 takes S and P,
// warpgroup 1 dP, and they hand them over through the raw tiles (free
// once staged, until the next step's are fetched); each takes dS and sums
// half of dQ's columns.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int BH, int H, int G, int S,
                        int Tk, int dh, int dv, float scale, int causal,
                        int vec) {
  using L = Smem<D>;
  constexpr int W = D / 2;  // dQ columns a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQhi = base + L::kAhi, sQlo = base + L::kAlo;
  const uint32_t sOhi = base + L::kBhi, sOlo = base + L::kBlo;  // dO
  const uint32_t sK = base + L::kX;  // K's parts, then K^T's
  const uint32_t sV = base + L::kY;
  const uint32_t rawK = base + L::kRawX, rawV = base + L::kRawY;
  const int tid = threadIdx.x;
  const int wg = tid / kWG, wt = tid % kWG;
  const int w = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
  const int nq = (S + kBM - 1) / kBM;
  const int qi = nq - 1 - (int)(blockIdx.x / BH);
  const long long bh = blockIdx.x % BH;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const long long bkv = (long long)b * (H / G) + h / G;
  const int q0 = qi * kBM;
  const int ntk = (Tk + kBN - 1) / kBN;
  // causal frontier: kv tiles strictly above the diagonal are skipped
  const int last = causal ? min(ntk, (q0 + kBM + kBN - 1) / kBN) : ntk;
  const float* kp = k + bkv * Tk * dh;
  const float* vp = v + bkv * Tk * dv;
  auto fetch = [&](int kt) {
    fill_raw<D>(rawK, kp, kt * kBN, Tk, dh, vec, tid);
    fill_raw<D>(rawV, vp, kt * kBN, Tk, dv, vec, tid);
    wgmma::cp_async_commit();
  };
  if (last > 0) fetch(0);
  stage_resident<D>(sQhi, sQlo, q + bh * S * dh, q0, S, dh, vec, scale,
                        tid);
  stage_resident<D>(sOhi, sOlo, dO + bh * S * dv, q0, S, dv, vec, 1.f,
                        tid);
  const int r0 = q0 + 16 * w + g;  // this thread's rows: r0, r0 + 8
  float lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool live = r0 + 8 * hh < S;
    lr[hh] = live ? lse[bh * S + r0 + 8 * hh] : 0.f;
    dr[hh] = live ? delta[bh * S + r0 + 8 * hh] : 0.f;
  }
  float adq[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) adq[i] = 0.f;
  // a warpgroup's P (0) or dP (1) to the other, thread wt's 16 as 4 chunks
  const uint32_t mine = (wg == 0 ? rawK : rawV) + wt * 16;
  const uint32_t theirs = (wg == 0 ? rawV : rawK) + wt * 16;
  for (int kt = 0; kt < last; ++kt) {
    const int t0 = kt * kBN;
    // the step's raw tiles have landed, and every warp is done with the
    // step before's products
    wgmma::cp_async_wait<0>();
    __syncthreads();
    stage_rows<D>(sK, rawK, 1.f, tid);
    stage_rows<D>(sV, rawV, 1.f, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    // warpgroup 0: S = Q K^T; 1: dP = dO V^T (outside any branch)
    Scores<D> sc;
    sc.issue(wg == 0 ? sQhi : sOhi, wg == 0 ? sQlo : sOlo, wg == 0 ? sK : sV);
    wgmma::commit();
    wgmma::wait();
    float x[16];
    sc.take(x);
    if (wg == 0) {  // P = exp(S - lse[row]) under the mask
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int xi = 4 * j + 2 * hh + e, row = r0 + 8 * hh;
            const int t = t0 + 8 * j + 2 * qd + e;
            const bool live = row < S && t < Tk && !(causal && t > row);
            x[xi] = expf(live ? __fsub_rn(x[xi], lr[hh]) : neg_inf());
          }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       mine + c * kWG * 16),
                   "f"(x[4 * c]), "f"(x[4 * c + 1]), "f"(x[4 * c + 2]),
                   "f"(x[4 * c + 3])
                   : "memory");
    __syncthreads();  // P and dP handed over; every warp's products done
    // dS = P (dP - D[row]), the same in both warpgroups
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 y = lds128(theirs + c * kWG * 16);
      const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int xi = 4 * c + m;  // = 4 j + 2 h + e
        const float p = wg == 0 ? x[xi] : ys[m];
        const float dp = wg == 0 ? ys[m] : x[xi];
        x[xi] = __fmul_rn(p, __fsub_rn(dp, dr[(xi / 2) % 2]));
      }
    }
    uint32_t xhi[4][4], xlo[4][4];
    fragments(x, xhi, xlo);
    // K^T over K
    stage_cols<D>(sK, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    if (kt + 1 < last) fetch(kt + 1);
    accumulate<W>(adq, xhi, xlo, sK + wg * W * 128,
                  sK + D * 128 + wg * W * 128);
  }
  store_acc<W>(dq + bh * S * dh, adq, q0, S, wg * W, dh, scale, wt);
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* o, const float* dO, const float* lse,
               float* delta, float* dq, float* dk, float* dv_out, int B,
               int H, int KV, int S, int Tk, int dh, int dv, float scale,
               int causal, int vec, cudaStream_t stream) {
  const long long bhs = (long long)B * H * S;
  int err = 0;
  if (bhs > 0) {
    const int wpb = kThreads / 32;
    flash_bwd_dot_kernel<<<(int)((bhs + wpb - 1) / wpb), kThreads, 0,
                           stream>>>(o, dO, delta, bhs, dv);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int ntk = (Tk + kBM - 1) / kBM, nq = (S + kBM - 1) / kBM;
  if (ntk > 0) {
    err = float_io::launch(flash_bwd_dkdv_kernel<D>, B * KV * ntk,
                           kThreads, Smem<D>::kBytes, stream, q, k, v, dO,
                           lse, (const float*)delta, dk, dv_out, B * KV, H,
                           H / KV, S, Tk, dh, dv, scale, causal, vec);
    if (err) return err;
  }
  if (nq == 0) return 0;
  return float_io::launch(flash_bwd_dq_kernel<D>, B * H * nq, kThreads,
                          Smem<D>::kBytes, stream, q, k, v, dO, lse,
                          (const float*)delta, dq, B * H, H, H / KV, S, Tk, dh,
                          dv, scale, causal, vec);
}

}  // namespace

// The backward of K9, float32. q [B, H, S, dh], k [B, KV, T, dh], v [B,
// KV, T, dv], o and dO [B, H, S, dv], lse [B, H, S] (the forward's), all
// row-major float32; delta [B, H, S] float32 scratch; dq, dk, dv the
// gradients, shaped as q, k, v, every element written. scale is dh^-0.5
// rounded to float32; dh, dv <= 128; vec: dh and dv multiples of 4 and q,
// k, v, dO 16-byte aligned. Returns the first nonzero cudaGetLastError() of
// the three launches (0 on success), or cudaErrorInvalidValue for dh or dv
// over 128.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dO, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv_out, int B, int H, int KV,
                                       int S, int Tk, int dh, int dv,
                                       float scale, int causal, int vec,
                                       void* stream) {
  if (dh > 128 || dv > 128) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *of = (const float*)o,
              *gf = (const float*)dO, *lf = (const float*)lse;
  float *df = (float*)delta, *dqf = (float*)dq, *dkf = (float*)dk,
        *dvf = (float*)dv_out;
  const int d = dh > dv ? dh : dv;
  if (d <= 64)
    return launch_bwd<64>(qf, kf, vf, of, gf, lf, df, dqf, dkf, dvf, B, H, KV,
                          S, Tk, dh, dv, scale, causal, vec, s);
  return launch_bwd<128>(qf, kf, vf, of, gf, lf, df, dqf, dkf, dvf, B, H, KV,
                         S, Tk, dh, dv, scale, causal, vec, s);
}
