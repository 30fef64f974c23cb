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
// clamped at 1e-30; kv tiles past the causal frontier are skipped.
//
// Numerics ("3xTF32"). One TF32 product keeps 10 mantissa bits, too few
// for the float32 check (1e-5). So each operand splits into two TF32
// parts, a_hi = tf32_rna(a) and a_lo = tf32_rna(a - a_hi), and a product
// is taken as a_hi b_lo + a_lo b_hi + a_hi b_hi, the two small products
// first; the dropped a_lo b_lo is ~2^-22 of a b. Each TF32 product is
// exact in the tensor core, which sums in float32. S = Q K^T and O += P V
// both run so; the softmax stays in float32 on CUDA cores.
//
// Design: a block holds one warpgroup (128 threads) per query head of a
// 64-row query tile, two heads of one kv head when the group size is even
// (GQA: they share each K and V tile), else one; the tiles with the most
// kv tiles under the frontier are launched first. Every operand sits in
// shared memory as its two parts, K-major in the 128-byte swizzled layout
// of 32-column sub-tiles (wgmma.cuh), Q and K zero-padded to the
// instantiation's DK, V to its DV: DK = DV = 64 or 128 (the least that
// holds max(dh, dv)), or DK = 192, DV = 128 for MLA's prefill (one query
// head a block; 181,248 bytes of shared memory, where one D = 192 would
// need 197,632). Q is stored once (scaled and split as it is stored), then
// 32-row kv tiles. TF32 wgmma reads both operands K-major only (there is
// no transpose bit for TF32), so V is staged transposed, Vt [DV, 32], by
// the threads, from registers: tile kt + 1 is loaded from global memory
// into registers while tile kt is computed, and split and stored once
// every warpgroup is done with kt.
// A tile wholly below the diagonal and inside T skips the mask arithmetic.
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
// layer (dh = 192, dv = 128) needs 2 (dh + dv) FLOPs a query-key pair.
#include <stdint.h>

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
template <int DK, int DV, int NH>
__global__ void __launch_bounds__(kThreads* NH, DK == 64 && DV == 64 ? 2 : 1)
    flash_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int BH, int H, int G, int S, int Tk, int dh, int dv,
                      float scale, int causal, int vec) {
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
  float* op = o + (long long)bh * S * dv;
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
      // the 4 x 4 block transposed: Vt row 4 nv + e holds column e
      const float4(&c)[4] = vr[n];
      const float4 cols[4] = {make_float4(c[0].x, c[1].x, c[2].x, c[3].x),
                              make_float4(c[0].y, c[1].y, c[2].y, c[3].y),
                              make_float4(c[0].z, c[1].z, c[2].z, c[3].z),
                              make_float4(c[0].w, c[1].w, c[2].w, c[3].w)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 4 * nv + e;
        store_split(sVhi, sVlo, row * 128 + ((ch ^ (row & 7)) << 4),
                    cols[e]);
      }
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
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    wgmma::fence();
    // S = Q_hi K_lo^T + Q_lo K_hi^T + Q_hi K_hi^T, the small products first
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const uint32_t a = part == 1 ? sQlo : sQhi;
      const uint32_t b = part == 0 ? sKlo : sKhi;
#pragma unroll
      for (int kk = 0; kk < DK / 8; ++kk) {
        wgmma_ss_n32(s,
                     wgmma::desc(a + (kk / 4) * (kBQ * 128) + (kk % 4) * 32,
                                 16, 1024),
                     wgmma::desc(b + (kk / 4) * (kBK * 128) + (kk % 4) * 32,
                                 16, 1024),
                     part > 0 || kk > 0);
      }
    }
    wgmma::commit();
    wgmma::wait();
#pragma unroll
    for (int i = 0; i < 16; ++i) wgmma::pin(s[i]);

    // mask (only a tile that crosses the diagonal or the ragged T edge
    // needs it), online softmax
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

    // P's parts as the A fragments of the four k8 steps: step j's register
    // r is A's column c = qd + 4 (r / 2) of row g + 8 (r % 2), the score of
    // kv 8 j + sigma(c) = 8 j + 2 qd + r / 2: accumulator 4 j + 2 (r % 2)
    // + r / 2
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(s[4 * j + 2 * (r % 2) + r / 2], phi[j][r], plo[j][r]);
#pragma unroll
    for (int i = 0; i < NO; ++i) wgmma::pin(acc[i]);
    wgmma::fence();
    // O += P_hi Vt_lo + P_lo Vt_hi + P_hi Vt_hi, the small products first
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
    for (int i = 0; i < NO; ++i) wgmma::pin(acc[i]);
    __syncthreads();  // every read of tile kt is done
    if (kt + 1 < last) stash();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= S) continue;
    const float den = fmaxf(l[h], 1e-30f);
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
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int KV, int S, int Tk, int dh, int dv, float scale,
           int causal, int vec, cudaStream_t stream) {
  const int blocks = B * H / NH * ((S + kBQ - 1) / kBQ);
  return float_io::launch(flash_tf32_kernel<DK, DV, NH>, blocks,
                          kThreads * NH, smem_bytes<DK, DV, NH>(), stream, q,
                          k, v, o, B * H, H, H / KV, S, Tk, dh, dv, scale,
                          causal, vec);
}

}  // namespace

// K9, float32. q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv], o [B,
// H, S, dv], row-major float32; scale is dh^-0.5 rounded to float32; dh
// <= 192, dv <= 128; vec: dh and dv multiples of 4 and q, k, v 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for dh over 192 or dv over 128.
extern "C" int flash_attention_fwd_tf32(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KV, int S, int Tk, int dh, int dv,
                                        float scale, int causal, int vec,
                                        void* stream) {
  if (B == 0 || H == 0 || S == 0 || dv == 0) return 0;
  if (dh > 192 || dv > 128) return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t s = (cudaStream_t)stream;
  // MLA's q and k: 192 wide, one query head a block
  if (dh > 128)
    return launch<192, 128, 1>(qf, kf, vf, of, B, H, KV, S, Tk, dh, dv,
                               scale, causal, vec, s);
  const int d = dh > dv ? dh : dv;
  // two query heads of one kv head a block when the group size is even
  const bool pair = (H / KV) % 2 == 0;
  if (d <= 64)
    return pair ? launch<64, 64, 2>(qf, kf, vf, of, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s)
                : launch<64, 64, 1>(qf, kf, vf, of, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s);
  return pair ? launch<128, 128, 2>(qf, kf, vf, of, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s)
              : launch<128, 128, 1>(qf, kf, vf, of, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s);
}
