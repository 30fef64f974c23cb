// K9 for float32 inputs on Hopper's tensor cores, as split TF32: causal
// (or not) GQA flash-attention forward,
//
//   o[b, h, s] = sum_t softmax_t(q[b, h, s] * dh^-0.5 . k[b, h / G, t])
//                * v[b, h / G, t],         G = H / KV,
//
// for q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv] and o [B, H, S,
// dv] in float32. Bfloat16 inputs go to flash_wgmma.cu.
//
// K9 replaces repro/kernels/attention/kernel.py::_flash_kernel (entry
// flash_attention_kernel_call), the Pallas TPU kernel reached through
// repro/kernels/attention/ops.py::flash_attention. Its conventions are
// kept: q is scaled (rounded to float32) before the dot; masked scores are
// -1e30, not -inf; the causal mask is t <= s, both counted from 0 (top-left
// aligned); the online softmax keeps (m, l, o) per row, m starting at
// -1e30, and rescales by exp(m - m_new) once per kv tile; the row sum is
// clamped at 1e-30; kv tiles past the causal frontier are skipped. When
// asked (a non-null lse), it also writes each row's log-sum-exp, m +
// log(max(l, 1e-30)), for the backward (flash_f32_bwd.cu; at MLA's head
// flash_f32_bwd_mla.cu); o is the same either way.
//
// Numerics ("3xTF32"). One TF32 product keeps 10 mantissa bits, too few
// for the float32 check (1e-5). So each operand splits into two TF32
// parts, a_hi = tf32_rna(a) and a_lo = tf32_rna(a - a_hi), and a product
// is taken as a_hi b_lo + a_lo b_hi + a_hi b_hi, the two small products
// first; the dropped a_lo b_lo is ~2^-22 of a b. Each TF32 product is
// exact in the tensor core, which sums in float32. S = Q K^T and O += P V
// both run so; the softmax stays in float32 on CUDA cores.
//
// Design (dh <= 128): a block holds one warpgroup (128 threads) per query
// head of a 64-row query tile, two heads of one kv head when the group size
// is even (GQA: they share each K and V tile), else one; the tiles with the
// most kv tiles under the frontier are launched first. Every operand sits
// in shared memory as its two parts, K-major in the 128-byte swizzled
// layout of 32-column sub-tiles (wgmma.cuh), Q and K zero-padded to the
// instantiation's DK, V to its DV: DK = DV = 64 or 128, the least that
// holds max(dh, dv). Q is stored once (scaled and split as it is stored),
// then 32-row kv tiles. TF32 wgmma reads both operands K-major only (there
// is no transpose bit for TF32), so V is staged transposed, Vt [DV, 32],
// by the threads, from registers: tile kt + 1 is loaded from global memory
// into registers while tile kt is computed, and split and stored once
// every warpgroup is done with kt.
// A tile wholly below the diagonal and inside T skips the mask arithmetic.
//
// MLA's prefill (dh over 128: q and k 128 + 64 wide, v 128) runs
// flash_tf32_mla_kernel, warp-specialized and persistent (notes at the
// kernel): two producer warpgroups bring each raw kv tile in by TMA and
// split it into the parts while one consumer warpgroup of 64 query rows
// runs the products and the softmax of the tile before, with the
// arithmetic above.
//
//   S = Q K^T   wgmma m64n32k8, both operands from shared memory,
//               DK / 8 steps a product, three products;
//   softmax     each thread holds two rows' 8 scores; a row spans the 4
//               lanes of a quad, reduced with shuffles;
//   O += P V    wgmma m64nDVk8, A = P's parts from registers, B = Vt's
//               parts from shared memory, three products.
//
// P from registers: the accumulator of m64n32 gives a thread the score
// columns 8 j + 2 qd + e (e = 0, 1) of rows g and g + 8 (g = lane / 4, qd
// = lane % 4); the TF32 A fragment of a k8 step wants k columns qd and
// qd + 4. A thread's registers become A's columns c = qd + 4 e of step j,
// which hold kv 8 j + sigma(c), sigma(c) = 2 (c % 4) + c / 4; Vt's
// staging puts kv row 8 j + sigma(c) at position 8 j + c to match. The
// kv index is summed over, so the permutation changes nothing but the
// order of the tensor core's sums.
//
// Bound on this card: operations. Granite-20B's causal prefill layer
// (H = 48, KV = 1, S = T = 4096, dh = dv = 128) needs 206.2 GFLOP (S (S +
// 1) / 2 query-key pairs, 4 dh FLOPs each), three TF32 products of it
// 618.6 GFLOP: 1.25 ms at the 494.7 TFLOP/s dense TF32 tensor-core peak;
// its 201.3 MB of q, k, v and o take 0.060 ms at 3.35 TB/s. MLA's
// layer (dh = 192, dv = 128) needs 2 (dh + dv) FLOPs a query-key pair;
// DeepSeek-V2's f32 prefill at S = 384 (H = KV = 128) is bound by its
// 126 MB of bytes, 0.0376 ms (three TF32 products 0.0367 ms).
#include <stdint.h>
#include <string.h>

#include "../../csrc/float_io.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per warpgroup
constexpr int kBK = 32;        // kv rows per tile
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNeg = -1.0e30f;

// Shared-memory bytes of one part (hi or lo) of each operand tile, for
// head dims DK (q, k) and DV (v): Q [64, DK], K [32, DK], Vt [DV, 32].
template <int DK, int DV>
struct Tile {
  static constexpr uint32_t Q = DK * 256;
  static constexpr uint32_t K = DK * 128;
  static constexpr uint32_t V = DV * 128;
};
template <int DK, int DV, int NH>
constexpr size_t smem_bytes() {
  using T = Tile<DK, DV>;
  return 1024 + 2 * (NH * T::Q + T::K + T::V);
}

// Byte offset of 16-byte chunk c4 (columns 4 c4 .. 4 c4 + 3) of row r in
// a swizzled tile of R rows in 32-column sub-tiles.
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
// The parts of (a, b, c, d) to the hi and lo tiles, at byte offset off.
__device__ __forceinline__ void store_split(uint32_t hi, uint32_t lo,
                                            uint32_t off, float4 x) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  sts128(hi + off, h);
  sts128(lo + off, l);
}

// Vt unit (ch, nv): c[m], columns 4 nv .. 4 nv + 3 of kv row 8 (ch / 2) +
// ch % 2 + 2 m (m = 0..3), transposed into Vt [DV, 32] rows 4 nv + e at
// positions 4 ch .. 4 ch + 3, where sigma puts those kv rows; both parts.
__device__ __forceinline__ void store_vt(uint32_t hi, uint32_t lo, int ch,
                                         int nv, const float4 (&c)[4]) {
  const float4 cols[4] = {make_float4(c[0].x, c[1].x, c[2].x, c[3].x),
                          make_float4(c[0].y, c[1].y, c[2].y, c[3].y),
                          make_float4(c[0].z, c[1].z, c[2].z, c[3].z),
                          make_float4(c[0].w, c[1].w, c[2].w, c[3].w)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = 4 * nv + e;
    store_split(hi, lo, row * 128 + ((ch ^ (row & 7)) << 4), cols[e]);
  }
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// Columns [c0, c0 + 4) of row `row` of the row-major [nrows, cols] matrix
// src, zero past nrows and cols: one 16-byte load when vec (cols % 4 == 0
// and src 16-byte aligned).
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

// d[64 x N] += A[64 x 8] B[N x 8]^T, TF32, A from registers (four a
// thread), B K-major in shared memory.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WG_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// Masks a tile's scores (s, in the accumulator layout below) when MASK
// (the causal mask, t <= s, and the ragged T edge), and takes each of the
// thread's two rows' maxima over its 8 scores.
template <bool MASK>
__device__ __forceinline__ void mask_max(float (&s)[16], int t0, int r0,
                                         int qd, int Tk, int causal,
                                         float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        if (MASK) {
          const int t = t0 + 8 * j + 2 * qd + e;
          if (causal && t > r0 + 8 * h) s[i] = kNeg;
          if (t < Tk) mx[h] = fmaxf(mx[h], s[i]);
        } else {
          mx[h] = fmaxf(mx[h], s[i]);
        }
      }
}

// p = exp(s - m) in place, 0 past T when MASK; the two rows' sums.
template <bool MASK>
__device__ __forceinline__ void exp_sum(float (&s)[16], const float (&m)[2],
                                        int t0, int qd, int Tk,
                                        float (&rs)[2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        // a row of the ragged last tile past T contributes nothing
        const float p = !MASK || t0 + 8 * j + 2 * qd + e < Tk
                            ? expf(__fsub_rn(s[i], m[h]))
                            : 0.f;
        s[i] = p;
        rs[h] = __fadd_rn(rs[h], p);
      }
}

// Accumulator layout of wgmma m64nN (f32) for thread t of a warpgroup:
// warp w = t / 32, g = (t % 32) / 4, qd = t % 4; register 4 j + 2 h + e
// holds row 16 w + g + 8 h, column 8 j + 2 qd + e. The TF32 A fragment of
// m64k8: register r holds row 16 w + g + 8 (r % 2), column qd + 4 (r / 2).
//
// S = Q K^T of a warpgroup's 64-row query tile (Q's parts [64, DK]) and a
// 32-row kv tile (K's parts [32, DK]) as Q_hi K_lo^T + Q_lo K_hi^T + Q_hi
// K_hi^T, the small products first, into s; returns once it is done.
template <int DK>
__device__ __forceinline__ void scores(float (&s)[16], uint32_t sQhi,
                                       uint32_t sQlo, uint32_t sKhi,
                                       uint32_t sKlo) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
  wgmma::fence();
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const uint32_t a = part == 1 ? sQlo : sQhi;
    const uint32_t b = part == 0 ? sKlo : sKhi;
#pragma unroll
    for (int kk = 0; kk < DK / 8; ++kk) {
      wgmma_ss_n32(s,
                   wgmma::desc(a + (kk / 4) * (kBQ * 128) + (kk % 4) * 32, 16,
                               1024),
                   wgmma::desc(b + (kk / 4) * (kBK * 128) + (kk % 4) * 32, 16,
                               1024),
                   part > 0 || kk > 0);
    }
  }
  wgmma::commit();
  wgmma::wait();
#pragma unroll
  for (int i = 0; i < 16; ++i) wgmma::pin(s[i]);
}

// The online softmax of the kv tile at t0 for the query tile at q0: masks
// the scores (only a tile that crosses the diagonal or the ragged T edge
// needs it), updates the rows' m and l, rescales acc by exp(m - m_new),
// and leaves P's parts as the A fragments of the PV product's four k8
// steps: step j's register r is A's column c = qd + 4 (r / 2) of row g +
// 8 (r % 2), the score of kv 8 j + sigma(c) = 8 j + 2 qd + r / 2:
// accumulator 4 j + 2 (r % 2) + r / 2.
template <int NO>
__device__ __forceinline__ void softmax(float (&s)[16], float (&acc)[NO],
                                        float (&m)[2], float (&l)[2],
                                        uint32_t (&phi)[4][4],
                                        uint32_t (&plo)[4][4], int t0, int q0,
                                        int r0, int qd, int Tk, int causal) {
  const bool mask = (causal && t0 + kBK - 1 > q0) || t0 + kBK > Tk;
  float mx[2] = {kNeg, kNeg};
  if (mask)
    mask_max<true>(s, t0, r0, qd, Tk, causal, mx);
  else
    mask_max<false>(s, t0, r0, qd, Tk, causal, mx);
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    alpha[h] = expf(__fsub_rn(m[h], mn));
    m[h] = mn;
  }
  float rs[2] = {0.f, 0.f};
  if (mask)
    exp_sum<true>(s, m, t0, qd, Tk, rs);
  else
    exp_sum<false>(s, m, t0, qd, Tk, rs);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] = __fadd_rn(rs[h], __shfl_xor_sync(0xffffffffu, rs[h], 1));
    rs[h] = __fadd_rn(rs[h], __shfl_xor_sync(0xffffffffu, rs[h], 2));
    l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), rs[h]);
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = __fmul_rn(acc[i], alpha[(i / 2) % 2]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split(s[4 * j + 2 * (r % 2) + r / 2], phi[j][r], plo[j][r]);
}

// O += P_hi Vt_lo + P_lo Vt_hi + P_hi Vt_hi, the small products first, P's
// parts from registers and Vt's [DV, 32] from shared memory; returns once
// it is done.
template <int DV>
__device__ __forceinline__ void pv(float (&acc)[DV / 2],
                                   const uint32_t (&phi)[4][4],
                                   const uint32_t (&plo)[4][4],
                                   uint32_t sVhi, uint32_t sVlo) {
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) wgmma::pin(acc[i]);
  wgmma::fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    WgmmaRS<DV>::run(acc, phi[j], wgmma::desc(sVlo + j * 32, 16, 1024));
#pragma unroll
  for (int j = 0; j < 4; ++j)
    WgmmaRS<DV>::run(acc, plo[j], wgmma::desc(sVhi + j * 32, 16, 1024));
#pragma unroll
  for (int j = 0; j < 4; ++j)
    WgmmaRS<DV>::run(acc, phi[j], wgmma::desc(sVhi + j * 32, 16, 1024));
  wgmma::commit();
  wgmma::wait();
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) wgmma::pin(acc[i]);
}

// o's rows r0 and r0 + 8 of the thread (those below S), acc / max(l,
// 1e-30), columns past dv dropped; and, when lp is not null, each row's
// log-sum-exp m + log(max(l, 1e-30)) (in the units of the scaled scores)
// at lp[r], by the quad's first lane.
template <int DV>
__device__ __forceinline__ void store_rows(float* op,
                                           const float (&acc)[DV / 2],
                                           const float (&m)[2],
                                           const float (&l)[2], int r0,
                                           int qd, int S, int dv,
                                           float* lp) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= S) continue;
    const float den = fmaxf(l[h], 1e-30f);
    if (lp != nullptr && qd == 0) lp[r] = __fadd_rn(m[h], logf(den));
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * qd + e;
        if (col < dv)
          op[(long long)r * dv + col] = __fdiv_rn(acc[4 * j + 2 * h + e], den);
      }
  }
}

template <int DK, int DV, int NH>
__global__ void __launch_bounds__(kThreads* NH, DK == 64 && DV == 64 ? 2 : 1)
    flash_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int BH, int H, int G, int S,
                      int Tk, int dh, int dv, float scale, int causal,
                      int vec) {
  constexpr int NT = kThreads * NH;
  constexpr int NQ = DK / 8;             // Q chunks a thread: 64 x DK / 4 / 128
  constexpr int NK = 8 * DK / NT;        // K chunks a thread: 32 x DK / 4 / NT
  constexpr int VU = 2 * DV;             // Vt units: 8 chunks x DV / 4 columns
  constexpr int NV = (VU + NT - 1) / NT; // Vt units a thread
  constexpr int NO = DV / 2;             // output accumulators a thread
  static_assert(8 * DK % NT == 0, "K chunks a thread");
  using T = Tile<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid / kThreads, wt = tid % kThreads;
  const int warp = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
  const int nq = (S + kBQ - 1) / kBQ;
  const int ngrp = BH / NH;
  const int qi = nq - 1 - (int)(blockIdx.x / ngrp);
  const int bh = (int)(blockIdx.x % ngrp) * NH + wg;
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;  // b * KV + h / G
  const float* qp = q + (long long)bh * S * dh;
  const float* kp = k + (long long)kvh * Tk * dh;
  const float* vp = v + (long long)kvh * Tk * dv;
  const int q0 = qi * kBQ;
  const int ntk = (Tk + kBK - 1) / kBK;
  // causal frontier: kv tiles strictly above the diagonal are skipped
  const int last = causal ? min(ntk, (q0 + kBQ + kBK - 1) / kBK) : ntk;
  const uint32_t sQhi = base + 2 * wg * T::Q, sQlo = sQhi + T::Q;
  const uint32_t sKhi = base + 2 * NH * T::Q, sKlo = sKhi + T::K;
  const uint32_t sVhi = sKlo + T::K, sVlo = sVhi + T::V;

  // the warpgroup's query tile, scaled, then split
#pragma unroll 4
  for (int n = 0; n < NQ; ++n) {
    const int u = wt + n * kThreads, r = u / (DK / 4), c4 = u % (DK / 4);
    float4 x = load4(qp, q0 + r, S, 4 * c4, dh, vec);
    x.x = __fmul_rn(x.x, scale);
    x.y = __fmul_rn(x.y, scale);
    x.z = __fmul_rn(x.z, scale);
    x.w = __fmul_rn(x.w, scale);
    store_split(sQhi, sQlo, swz(r, c4, kBQ), x);
  }

  // kv tile registers: thread chunk n of K is row u / (DK / 4), columns
  // 4 (u % (DK / 4)) ..; Vt unit n is chunk ch = u % 8 of Vt rows 4 nv ..
  // 4 nv + 3 (u = tid + n NT, nv = u / 8), the kv rows 8 (ch / 2) + ch % 2
  // + 2 m (m = 0..3) that sigma puts at positions 4 ch .. 4 ch + 3
  float4 kr[NK], vr[NV][4];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int u = tid + n * NT;
      kr[n] = load4(kp, t0 + u / (DK / 4), Tk, 4 * (u % (DK / 4)), dh, vec);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int u = tid + n * NT, ch = u % 8, nv = u / 8;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        vr[n][m] = u < VU ? load4(vp, t0 + 8 * (ch / 2) + ch % 2 + 2 * m, Tk,
                                  4 * nv, dv, vec)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int u = tid + n * NT;
      store_split(sKhi, sKlo, swz(u / (DK / 4), u % (DK / 4), kBK), kr[n]);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int u = tid + n * NT, ch = u % 8, nv = u / 8;
      if (u >= VU) continue;
      store_vt(sVhi, sVlo, ch, nv, vr[n]);
    }
  };
  if (last > 0) {
    fetch(0);
    stash();
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8

  for (int kt = 0; kt < last; ++kt) {
    const int t0 = kt * kBK;
    // the stores of tile kt (and of Q) become visible to wgmma, then to
    // every thread of the block
    wgmma::fence_proxy_async();
    __syncthreads();
    if (kt + 1 < last) fetch(t0 + kBK);
    float s[16];
    scores<DK>(s, sQhi, sQlo, sKhi, sKlo);
    uint32_t phi[4][4], plo[4][4];
    softmax(s, acc, m, l, phi, plo, t0, q0, r0, qd, Tk, causal);
    pv<DV>(acc, phi, plo, sVhi, sVlo);
    __syncthreads();  // every read of tile kt is done
    if (kt + 1 < last) stash();
  }
  store_rows<DV>(o + (long long)bh * S * dv, acc, m, l, r0, qd, S, dv,
                 lse == nullptr ? nullptr : lse + (long long)bh * S);
}

template <int DK, int DV, int NH>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int H, int KV, int S, int Tk, int dh, int dv,
           float scale, int causal, int vec, cudaStream_t stream) {
  const int blocks = B * H / NH * ((S + kBQ - 1) / kBQ);
  return float_io::launch(flash_tf32_kernel<DK, DV, NH>, blocks,
                          kThreads * NH, smem_bytes<DK, DV, NH>(), stream, q,
                          k, v, o, lse, B * H, H, H / KV, S, Tk, dh, dv,
                          scale, causal, vec);
}


// ---- MLA's head: DK = 192, DV = 128, warp-specialized and persistent ------

constexpr int kMlaDK = 192;       // q and k columns in shared memory
constexpr int kMlaDV = 128;       // v and o columns
constexpr int kMlaProducers = 256;  // two producer warpgroups
constexpr int kMlaThreads = 384;  // the producers and one consumer
constexpr int kMlaBars = 8;       // mbarriers
// registers a thread after the hand-over: the producers give up 16 a
// thread of their 168, the consumer takes 32 more (256 x 16 = 128 x 32);
// fewer for the producers spilled their Q prefetch and splits
constexpr int kProducerRegs = 152;
constexpr int kConsumerRegs = 200;

// Shared memory of flash_tf32_mla_kernel, byte offsets from a 1024-aligned
// base: Q's two parts [64, 192], K's two parts [32, 192], Vt's two parts
// [128, 32] (each as Tile gives it), then the raw float32 tiles the TMA
// brings in, K [32, 192] in K's own layout and V [32, 128] in 32-column
// swizzled sub-tiles, then the mbarriers.
struct MlaSmem {
  using T = Tile<kMlaDK, kMlaDV>;
  static constexpr uint32_t kQhi = 0, kQlo = T::Q;
  static constexpr uint32_t kKhi = 2 * T::Q, kKlo = kKhi + T::K;
  static constexpr uint32_t kVhi = kKlo + T::K, kVlo = kVhi + T::V;
  static constexpr uint32_t kRawK = kVlo + T::V;        // 32 x 192 x 4
  static constexpr uint32_t kRawV = kRawK + T::K;       // 32 x 128 x 4
  static constexpr uint32_t kBar = kRawV + kBK * kMlaDV * 4;
  static constexpr uint32_t bytes = kBar + kMlaBars * 8 + 1024;  // + align
};
static_assert(MlaSmem::bytes <= 232448, "an SM's shared memory");
static_assert(2 * kMlaDV == kMlaProducers, "a Vt unit a producer thread");
static_assert(kMlaProducers * kProducerRegs + kThreads * kConsumerRegs <=
                  65536,
              "an SM's registers");

// Vt unit (ch, nv) of the producers' transpose: unit u (producer thread
// u) in phases of 8 lanes P = u / 8 (a = P % 4, b = P / 4 % 2, c = P / 8)
// with lane l = u % 8 taking ch = l ^ 2 c and nv = 8 a + 2 (l / 2) + b.
// Every (ch, nv) once, and in each phase the 8 lanes' raw reads (chunk
// (nv % 8) ^ (kv row % 8)) and Vt writes (chunk ch ^ (4 (nv % 2) + e))
// fall in 8 different 16-byte bank groups.
__device__ __forceinline__ void vt_unit(int u, int& ch, int& nv) {
  const int P = u / 8, l = u % 8;
  ch = l ^ (2 * (P / 8));
  nv = 8 * (P % 4) + 2 * (l / 2) + (P / 4) % 2;
}

// K9 f32 at MLA's head, warp-specialized and persistent. The work list is
// every (head, 64-row query tile), rank i being query tile nq - 1 - i / BH
// of head i % BH, so the tiles with the most kv tiles come first; block b
// takes ranks b, b + grid, ... (one block an SM: 222,272 bytes of shared
// memory). Its kv tiles (32 rows, up to the item's causal frontier) run in
// one sequence over the block's items.
//
// Warpgroups 0 and 1 are the producers; they hand registers to the
// consumer. One thread copies each raw kv tile's K and V into their
// staging buffers by TMA (32 x 32 float boxes in the 128-byte swizzle,
// zero past every edge, completing on the buffer's barrier), a tile ahead;
// rows that are not whole 16-byte chunks or storage not 16-byte aligned
// are loaded by the 256 producer threads instead. They split raw K into
// K's parts once the consumer's Q K^T of the tile before is done (the raw
// tile is already in K's layout, so a chunk keeps its offset), and raw V,
// transposed, into Vt's parts once the consumer's P V of the tile before
// is done; each staging buffer then takes the next tile's copy. A work
// item's Q is read from global memory into registers, then scaled and
// split into Q's parts once the consumer's last Q K^T of the item before
// is done.
//
// Warpgroup 2 is the consumer, the dh <= 128 kernels' arithmetic on its
// 64 rows: per kv tile, S = Q K^T (three products, 72 m64n32k8 steps),
// frees K's parts, the online softmax, then O += P V (three products, 12
// m64n128k8 steps), frees Vt's parts. So the loads, the splits and the
// transpose overlap the consumer's products and softmax.
__global__ void __launch_bounds__(kMlaThreads, 1)
    flash_tf32_mla_kernel(const __grid_constant__ CUtensorMap tmk,
                          const __grid_constant__ CUtensorMap tmv,
                          const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int BH, int H, int G,
                          int S, int Tk, int dh, int dv, float scale,
                          int causal, int vec) {
  using Sm = MlaSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / kThreads, wt = tid % kThreads;
  const int nq = (S + kBQ - 1) / kBQ;
  const int ntiles = BH * nq;
  const int ntk = (Tk + kBK - 1) / kBK;
  const uint32_t bar = base + Sm::kBar;
  const uint32_t qfull = bar, qempty = bar + 8, kfull = bar + 16,
                 kempty = bar + 24, vfull = bar + 32, vempty = bar + 40,
                 rawk = bar + 48, rawv = bar + 56;
  const uint32_t sQhi = base + Sm::kQhi, sQlo = base + Sm::kQlo;
  const uint32_t sKhi = base + Sm::kKhi, sKlo = base + Sm::kKlo;
  const uint32_t sVhi = base + Sm::kVhi, sVlo = base + Sm::kVlo;
  const uint32_t sRawK = base + Sm::kRawK, sRawV = base + Sm::kRawV;
  // kv tiles under the causal frontier of the query tile at q0
  auto kv_tiles = [&](int q0) {
    return causal ? min(ntk, (q0 + kBQ + kBK - 1) / kBK) : ntk;
  };
  if (tid == 0) {
    wgmma::mbar_init(qfull, kMlaProducers);
    wgmma::mbar_init(qempty, kThreads);
    wgmma::mbar_init(kfull, kMlaProducers);
    wgmma::mbar_init(kempty, kThreads);
    wgmma::mbar_init(vfull, kMlaProducers);
    wgmma::mbar_init(vempty, kThreads);
    // by TMA one thread arrives (with the copies' bytes), else all
    wgmma::mbar_init(rawk, vec ? 1 : kMlaProducers);
    wgmma::mbar_init(rawv, vec ? 1 : kMlaProducers);
  }
  __syncthreads();

  if (wg < 2) {  // ---- the producers, thread tid of 256
    wgmma::reg_dealloc<kProducerRegs>();
    // tile kt of item i into the raw K (or V) buffer
    auto kv_head = [&](int i) {
      const int bh = i % BH;
      return (bh / H) * (H / G) + (bh % H) / G;  // b * KV + h / G
    };
    auto fetch_k = [&](int i, int kt) {
      const int kvh = kv_head(i);
      if (vec) {
        if (tid == 0) {
          wgmma::mbar_expect_tx(rawk, Sm::T::K);
#pragma unroll
          for (int cb = 0; cb < kMlaDK / 32; ++cb)
            wgmma::tma_load_3d(sRawK + cb * (kBK * 128), &tmk, 32 * cb,
                               kt * kBK, kvh, rawk);
        }
        return;
      }
      const float* kp = k + (long long)kvh * Tk * dh;
#pragma unroll
      for (int n = 0; n < kBK * kMlaDK / 4 / kMlaProducers; ++n) {
        const int u = tid + n * kMlaProducers, r = u / (kMlaDK / 4),
                  c4 = u % (kMlaDK / 4);
        const float4 x = load4(kp, kt * kBK + r, Tk, 4 * c4, dh, false);
        const uint32_t w[4] = {__float_as_uint(x.x), __float_as_uint(x.y),
                               __float_as_uint(x.z), __float_as_uint(x.w)};
        sts128(sRawK + swz(r, c4, kBK), w);
      }
      wgmma::mbar_arrive(rawk);
    };
    auto fetch_v = [&](int i, int kt) {
      const int kvh = kv_head(i);
      if (vec) {
        if (tid == 0) {
          wgmma::mbar_expect_tx(rawv, kBK * kMlaDV * 4);
#pragma unroll
          for (int cb = 0; cb < kMlaDV / 32; ++cb)
            wgmma::tma_load_3d(sRawV + cb * (kBK * 128), &tmv, 32 * cb,
                               kt * kBK, kvh, rawv);
        }
        return;
      }
      const float* vp = v + (long long)kvh * Tk * dv;
#pragma unroll
      for (int n = 0; n < kBK * kMlaDV / 4 / kMlaProducers; ++n) {
        const int u = tid + n * kMlaProducers, r = u / (kMlaDV / 4),
                  c4 = u % (kMlaDV / 4);
        const float4 x = load4(vp, kt * kBK + r, Tk, 4 * c4, dv, false);
        const uint32_t w[4] = {__float_as_uint(x.x), __float_as_uint(x.y),
                               __float_as_uint(x.z), __float_as_uint(x.w)};
        sts128(sRawV + swz(r, c4, kBK), w);
      }
      wgmma::mbar_arrive(rawv);
    };
    if (ntk > 0 && (int)blockIdx.x < ntiles) {
      fetch_k(blockIdx.x, 0);
      fetch_v(blockIdx.x, 0);
    }
    constexpr int NQ = kBQ * kMlaDK / 4 / kMlaProducers;  // Q chunks a thread
    int j = 0, qi = 0;
    for (int i = blockIdx.x; i < ntiles; i += gridDim.x, ++qi) {
      const int q0 = (nq - 1 - i / BH) * kBQ;
      const float* qp = q + (long long)(i % BH) * S * dh;
      float4 xq[NQ];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int u = tid + n * kMlaProducers;
        xq[n] = load4(qp, q0 + u / (kMlaDK / 4), S, 4 * (u % (kMlaDK / 4)),
                      dh, vec);
      }
      wgmma::mbar_wait(qempty, (qi & 1) ^ 1);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int u = tid + n * kMlaProducers;
        float4 x = xq[n];
        x.x = __fmul_rn(x.x, scale);
        x.y = __fmul_rn(x.y, scale);
        x.z = __fmul_rn(x.z, scale);
        x.w = __fmul_rn(x.w, scale);
        store_split(sQhi, sQlo, swz(u / (kMlaDK / 4), u % (kMlaDK / 4), kBQ),
                    x);
      }
      wgmma::fence_proxy_async();
      wgmma::mbar_arrive(qfull);
      const int nkv = kv_tiles(q0);
      for (int kt = 0; kt < nkv; ++kt, ++j) {
        // the tile after this one in the block's sequence
        int ni = i, nkt = kt + 1;
        if (nkt == nkv) {
          ni = i + gridDim.x;
          nkt = 0;
        }
        const bool more = ni < ntiles;
        wgmma::mbar_wait(rawk, j & 1);
        wgmma::mbar_wait(kempty, (j & 1) ^ 1);
#pragma unroll
        for (int n = 0; n < kBK * kMlaDK / 4 / kMlaProducers; ++n) {
          const uint32_t off = (tid + n * kMlaProducers) * 16;
          store_split(sKhi, sKlo, off, lds128(sRawK + off));
        }
        // K's parts to the consumer's wgmma; raw K read (before its next
        // copy by the async proxy)
        wgmma::fence_proxy_async();
        wgmma::mbar_arrive(kfull);
        wgmma::named_bar(1, kMlaProducers);
        if (more) fetch_k(ni, nkt);
        wgmma::mbar_wait(rawv, j & 1);
        wgmma::mbar_wait(vempty, (j & 1) ^ 1);
        {  // Vt unit tid: kv rows 8 (ch / 2) + ch % 2 + 2 mm of columns nv
          int ch, nv;
          vt_unit(tid, ch, nv);
          float4 c[4];
#pragma unroll
          for (int mm = 0; mm < 4; ++mm)
            c[mm] = lds128(sRawV + swz(8 * (ch / 2) + ch % 2 + 2 * mm, nv,
                                       kBK));
          store_vt(sVhi, sVlo, ch, nv, c);
        }
        wgmma::fence_proxy_async();
        wgmma::mbar_arrive(vfull);
        wgmma::named_bar(1, kMlaProducers);
        if (more) fetch_v(ni, nkt);
      }
    }
    return;
  }

  // ---- the consumer: warpgroup 2, the item's 64 rows
  wgmma::reg_alloc<kConsumerRegs>();
  const int warp = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
  constexpr int NO = kMlaDV / 2;  // output accumulators a thread
  int j = 0, qi = 0;
  for (int i = blockIdx.x; i < ntiles; i += gridDim.x, ++qi) {
    const int bh = i % BH;
    const int q0 = (nq - 1 - i / BH) * kBQ;
    const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
    const int nkv = kv_tiles(q0);
    float acc[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) acc[e] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    wgmma::mbar_wait(qfull, qi & 1);
    if (nkv == 0) wgmma::mbar_arrive(qempty);
    for (int kt = 0; kt < nkv; ++kt, ++j) {
      const int t0 = kt * kBK;
      wgmma::mbar_wait(kfull, j & 1);
      float s[16];
      scores<kMlaDK>(s, sQhi, sQlo, sKhi, sKlo);
      wgmma::mbar_arrive(kempty);
      if (kt + 1 == nkv) wgmma::mbar_arrive(qempty);
      uint32_t phi[4][4], plo[4][4];
      softmax(s, acc, m, l, phi, plo, t0, q0, r0, qd, Tk, causal);
      wgmma::mbar_wait(vfull, j & 1);
      pv<kMlaDV>(acc, phi, plo, sVhi, sVlo);
      wgmma::mbar_arrive(vempty);
    }
    store_rows<kMlaDV>(o + (long long)bh * S * dv, acc, m, l, r0, qd, S, dv,
                       lse == nullptr ? nullptr : lse + (long long)bh * S);
  }
}

int launch_mla(const float* q, const float* k, const float* v, float* o,
               float* lse, int B, int H, int KV, int S, int Tk, int dh,
               int dv, float scale, int causal, int vec,
               cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tk, tv;
  memset(&tk, 0, sizeof tk);
  memset(&tv, 0, sizeof tv);
  vec = vec && Tk > 0;
  if (vec && !(wgmma::tile_map(&tk, k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                               dh, Tk, B * KV, 32, kBK) &&
               wgmma::tile_map(&tv, v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                               dv, Tk, B * KV, 32, kBK)))
    return (int)cudaErrorInvalidValue;
  const int tiles = B * H * ((S + kBQ - 1) / kBQ);
  return float_io::launch(flash_tf32_mla_kernel, tiles < sms ? tiles : sms,
                          kMlaThreads, MlaSmem::bytes, stream, tk, tv, q, k,
                          v, o, lse, B * H, H, H / KV, S, Tk, dh, dv, scale,
                          causal, vec);
}

}  // namespace

// K9, float32. q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv], o [B,
// H, S, dv], row-major float32; lse [B, H, S] float32, or null: each row's
// log-sum-exp of its scaled, masked scores (the backward's row statistic),
// written only when not null; scale is dh^-0.5 rounded to float32; dh <=
// 192, dv <= 128; vec: dh and dv multiples of 4 and q, k, v 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for dh over 192 or dv over 128.
extern "C" int flash_attention_fwd_tf32(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int KV, int S, int Tk,
                                        int dh, int dv, float scale,
                                        int causal, int vec, void* stream) {
  if (B == 0 || H == 0 || S == 0 || dv == 0) return 0;
  if (dh > 192 || dv > 128) return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  float* lf = (float*)lse;
  cudaStream_t s = (cudaStream_t)stream;
  // MLA's q and k: 192 wide, the warp-specialized persistent kernel
  if (dh > 128)
    return launch_mla(qf, kf, vf, of, lf, B, H, KV, S, Tk, dh, dv, scale,
                      causal, vec, s);
  const int d = dh > dv ? dh : dv;
  // two query heads of one kv head a block when the group size is even
  const bool pair = (H / KV) % 2 == 0;
  if (d <= 64)
    return pair ? launch<64, 64, 2>(qf, kf, vf, of, lf, B, H, KV, S, Tk, dh,
                                    dv, scale, causal, vec, s)
                : launch<64, 64, 1>(qf, kf, vf, of, lf, B, H, KV, S, Tk, dh,
                                    dv, scale, causal, vec, s);
  return pair ? launch<128, 128, 2>(qf, kf, vf, of, lf, B, H, KV, S, Tk, dh,
                                    dv, scale, causal, vec, s)
              : launch<128, 128, 1>(qf, kf, vf, of, lf, B, H, KV, S, Tk, dh,
                                    dv, scale, causal, vec, s);
}
