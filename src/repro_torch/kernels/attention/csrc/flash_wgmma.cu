// K9 for bfloat16 inputs on Hopper's tensor cores: causal (or not) GQA
// flash-attention forward,
//
//   o[b, h, s] = sum_t softmax_t(q[b, h, s] . k[b, h / G, t] * dh^-0.5)
//                * v[b, h / G, t],         G = H / KV,
//
// for q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv] in bfloat16, the
// softmax and every sum in float32, o [B, H, S, dv] in bfloat16. Float32
// inputs go to flash_tf32.cu, which splits each operand into two TF32
// parts.
//
// K9 replaces repro/kernels/attention/kernel.py::_flash_kernel (entry
// flash_attention_kernel_call). Its conventions are kept but one: masked
// scores are -1e30, not -inf; the causal mask is t <= s, both counted from
// 0 (top-left aligned); the online softmax keeps (m, l, o) per row, m
// starting at -1e30, and rescales by exp(m - m_new) once per kv tile; the
// row sum is clamped at 1e-30; kv tiles past the causal frontier are
// skipped. The one change: the reference scales q before the dot, but a
// scaled q is not representable in bfloat16, so the float32 score is
// multiplied by dh^-0.5 (rounded to float32) after the product.
//
// Design: a block holds one warpgroup (128 threads) per query head of a
// 64-row query tile, two heads of one kv head when the group size is
// even (GQA: they share each K and V tile), else one; the tiles with the
// most kv tiles under the frontier are launched first. Q stays in shared
// memory; 64-row K and V tiles go through a 2-stage ring loaded with
// cp.async, so tile kt + 1 arrives while tile kt is computed. A tile
// wholly below the diagonal and inside T skips the mask arithmetic.
// Every tile is stored as 64-column sub-tiles in the 128-byte swizzled
// layout (16-byte chunk c of row r at chunk c ^ (r % 8), each sub-tile
// 1024-byte aligned), Q and K zero-padded to the instantiation's DK, V
// and O to its DV; a zero column adds exact zeros, so padding changes
// nothing. The instantiations: DK = DV = 64 or 128 (the least that holds
// max(dh, dv)), and DK = 192, DV = 128 for MLA's prefill (q and k 128 +
// 64 wide, v 128; one query head a block, since MLA's H = KV): three Q
// and K sub-tiles and two V sub-tiles, 107,520 bytes of shared memory, so
// two blocks still fit an SM, where one D = 192 would pad V and O to 192
// (123,904 bytes, one block an SM) and do a third more PV work.
//
//   S = Q K^T   wgmma m64n64k16, both operands K-major from shared memory,
//               DK / 16 steps, float32 sums in registers;
//   softmax     each thread holds two rows' 16 scores; a row spans the 4
//               lanes of a quad, reduced with shuffles;
//   O += P V    P split into bf16 parts, P_hi = bf16(P) and
//               P_lo = bf16(P - P_hi), and O += P_hi V + P_lo V: wgmma
//               m64nDVk16 with A = P from registers and B = V from shared
//               memory, MN-major (the transpose bit).
//
// P rounded to bfloat16 alone is off by up to 2^-9 of each weight, which
// moves an output past one bfloat16 step of the float32 reference on ~10%
// of the elements at S = 4096; the split keeps P to ~2^-17 at 1.5x the
// reference's flops. The products are written in PTX, the fence, commit
// and wait too (wgmma.cuh).
//
// Bound on this card: operations. Granite-20B's causal prefill layer
// (H = 48, KV = 1, S = T = 4096, dh = dv = 128) needs 206.2 GFLOP (S (S +
// 1) / 2 query-key pairs, 4 dh FLOPs each), 0.209 ms at the 989 TFLOP/s
// bf16 tensor-core peak (0.313 ms with the split's second PV product);
// its 102.8 MB of q, k, v and o take 0.031 ms at 3.35 TB/s. DeepSeek-V2's
// MLA prefill layer (B = 4, H = KV = 128, S = T = 4096, dh = 192, dv =
// 128) needs 2 (dh + dv) = 640 FLOPs a query-key pair: 2.75 TFLOP, 2.78
// ms at the peak.
#include <stdint.h>

#include "../../csrc/float_io.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block (one warpgroup)
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNeg = -1.0e30f;
constexpr uint32_t kAtom = 64 * 128;  // a 64-row x 64-column bf16 sub-tile

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
  static_assert(RP % 8 == 0 && kBK % RP == 0, "tile passes");
  const int c = tid % CH, r = tid / CH, c0 = col0 + c * 8;
  const uint32_t d0 =
      dst + (c / 8) * kAtom + r * 128 + ((uint32_t)((c % 8) ^ (r & 7)) << 4);
  const bool col_live = c0 < cols;
  const long long g0 = (long long)(row0 + r) * cols + c0;
#pragma unroll
  for (int i = 0; i < kBK / RP; ++i) {
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

// d[64 x N] += A[64 x 16] B[16 x N], A from registers (four bf16x2 a
// thread), B MN-major in shared memory (transpose bit set).
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo,
                                         __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Scales a tile's float32 scores (s, in the accumulator layout below),
// masks them when MASK (the causal mask, t <= s, and the ragged T edge),
// and takes each of the thread's two rows' maxima over its 16 scores.
template <bool MASK>
__device__ __forceinline__ void scale_mask_max(float (&s)[32], float scale,
                                               int t0, int r0, int qd,
                                               int Tk, int causal,
                                               float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float x = __fmul_rn(s[i], scale);
        if (MASK) {
          const int t = t0 + 8 * j + 2 * qd + e;
          if (causal && t > r0 + 8 * h) x = kNeg;
          s[i] = x;
          if (t < Tk) mx[h] = fmaxf(mx[h], x);
        } else {
          s[i] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
}

// p = exp(s - m) in place, 0 past T when MASK; the two rows' sums.
template <bool MASK>
__device__ __forceinline__ void exp_sum(float (&s)[32], const float (&m)[2],
                                        int t0, int qd, int Tk,
                                        float (&rs)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
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
// holds row 16 w + g + 8 h, column 8 j + 2 qd + e.
//
// A block holds NH warpgroups, each the same 64-row query tile of NH
// query heads that read the same kv head (GQA), so the K and V tiles are
// loaded once for NH heads. Two blocks an SM: for NH = 2 that caps a
// thread at 128 registers (a few bytes spill), and four warpgroups an SM
// hide more of each one's serial chain of loads, products and softmax.
// Q and K are DK columns wide in shared memory, V and O DV.
template <int DK, int DV, int NH>
__global__ void __launch_bounds__(kThreads* NH, 2)
    flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int BH, int H, int G,
                       int S, int Tk, int dh, int dv, float scale,
                       int causal, int vec) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t TQ = tile_bytes<DK>(), TV = tile_bytes<DV>();
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid / kThreads, wt = tid % kThreads;
  const int warp = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
  const int nq = (S + kBQ - 1) / kBQ;
  const int ngrp = BH / NH;
  const int qi = nq - 1 - (int)(blockIdx.x / ngrp);
  const int bh = (int)(blockIdx.x % ngrp) * NH + wg;
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;  // b * KV + h / G
  const __nv_bfloat16* qp = q + (long long)bh * S * dh;
  const __nv_bfloat16* kp = k + (long long)kvh * Tk * dh;
  const __nv_bfloat16* vp = v + (long long)kvh * Tk * dv;
  __nv_bfloat16* op = o + (long long)bh * S * dv;
  const int q0 = qi * kBQ;
  const int ntk = (Tk + kBK - 1) / kBK;
  // causal frontier: kv tiles strictly above the diagonal are skipped
  const int last = causal ? min(ntk, (q0 + kBQ + kBK - 1) / kBK) : ntk;
  const uint32_t sQ = base + wg * TQ;
  auto sK = [&](int st) { return base + NH * TQ + st * (TQ + TV); };
  auto sV = [&](int st) { return sK(st) + TQ; };

  load_tile<DK, kThreads>(sQ, qp, q0, S, dh, vec, wt);
  for (int st = 0; st < 2 && st < last; ++st) {
    load_tile<DK, kThreads * NH>(sK(st), kp, st * kBK, Tk, dh, vec, tid);
    load_tile<DV, kThreads * NH>(sV(st), vp, st * kBK, Tk, dv, vec, tid);
    wgmma::cp_async_commit();
  }
  if (last == 0) wgmma::cp_async_commit();

  constexpr int NO = DV / 2;  // output accumulators a thread: DV / 8 x 4
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8

  for (int kt = 0; kt < last; ++kt) {
    const int st = kt & 1;
    const int t0 = kt * kBK;
    if (kt + 1 < last)
      wgmma::cp_async_wait<1>();
    else
      wgmma::cp_async_wait<0>();
    // the tile's generic-proxy stores become visible to wgmma (the async
    // proxy), then to every thread of the block
    wgmma::fence_proxy_async();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
      wgmma_ss_n64(s, wgmma::desc(sQ + off, 16, 1024),
                   wgmma::desc(sK(st) + off, 16, 1024), kk > 0);
    }
    wgmma::commit();
    wgmma::wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) wgmma::pin(s[i]);

    // scale after the product, mask (only a tile that crosses the
    // diagonal or the ragged T edge needs it), online softmax
    const bool mask =
        (causal && t0 + kBK - 1 > q0) || t0 + kBK > Tk;
    float mx[2] = {kNeg, kNeg};
    if (mask)
      scale_mask_max<true>(s, scale, t0, r0, qd, Tk, causal, mx);
    else
      scale_mask_max<false>(s, scale, t0, r0, qd, Tk, causal, mx);
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

    // P as A fragments of the four k16 steps over the tile's 64 keys:
    // register r of step kk packs scores 8 kk + 2 r and 8 kk + 2 r + 1
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = s[8 * kk + 2 * r], p1 = s[8 * kk + 2 * r + 1];
        const __nv_bfloat16 h0 = __float2bfloat16_rn(p0);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(p1);
        phi[kk][r] = pack(h0, h1);
        plo[kk][r] =
            pack(__float2bfloat16_rn(__fsub_rn(p0, __bfloat162float(h0))),
                 __float2bfloat16_rn(__fsub_rn(p1, __bfloat162float(h1))));
      }
#pragma unroll
    for (int i = 0; i < NO; ++i) wgmma::pin(acc[i]);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<DV>::run(acc, phi[kk],
                      wgmma::desc(sV(st) + kk * 2048, kAtom, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<DV>::run(acc, plo[kk],
                      wgmma::desc(sV(st) + kk * 2048, kAtom, 1024));
    wgmma::commit();
    wgmma::wait();
#pragma unroll
    for (int i = 0; i < NO; ++i) wgmma::pin(acc[i]);
    __syncthreads();  // every read of stage st is done
    if (kt + 2 < last) {
      load_tile<DK, kThreads * NH>(sK(st), kp, (kt + 2) * kBK, Tk, dh, vec,
                                   tid);
      load_tile<DV, kThreads * NH>(sV(st), vp, (kt + 2) * kBK, Tk, dv, vec,
                                   tid);
      wgmma::cp_async_commit();
    }
  }
  wgmma::cp_async_wait<0>();
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
          float_io::store(op + (long long)r * dv + col,
                          __fdiv_rn(acc[4 * j + 2 * h + e], den));
      }
  }
}

template <int DK, int DV, int NH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, int Tk, int dh, int dv, float scale,
           int causal, int vec, cudaStream_t stream) {
  const int blocks = B * H / NH * ((S + kBQ - 1) / kBQ);
  return float_io::launch(
      flash_wgmma_kernel<DK, DV, NH>, blocks, kThreads * NH,
      1024 + NH * (size_t)tile_bytes<DK>() +
          2 * ((size_t)tile_bytes<DK>() + tile_bytes<DV>()),
      stream,
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, B * H, H, H / KV, S, Tk,
      dh, dv, scale, causal, vec);
}

}  // namespace

// K9, bfloat16. q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv], o [B,
// H, S, dv], row-major bfloat16; scale is dh^-0.5 rounded to float32;
// dh <= 192, dv <= 128; vec: dh and dv multiples of 8 and q, k, v 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for dh over 192 or dv over 128.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KV, int S, int Tk, int dh, int dv,
                                        float scale, int causal, int vec,
                                        void* stream) {
  if (B == 0 || H == 0 || S == 0 || dv == 0) return 0;
  if (dh > 192 || dv > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // MLA's q and k: 192 wide, one query head a block
  if (dh > 128)
    return launch<192, 128, 1>(q, k, v, o, B, H, KV, S, Tk, dh, dv, scale,
                               causal, vec, s);
  const int d = dh > dv ? dh : dv;
  // two query heads of one kv head a block when the group size is even
  const bool pair = (H / KV) % 2 == 0;
  if (d <= 64)
    return pair ? launch<64, 64, 2>(q, k, v, o, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s)
                : launch<64, 64, 1>(q, k, v, o, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s);
  return pair ? launch<128, 128, 2>(q, k, v, o, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s)
              : launch<128, 128, 1>(q, k, v, o, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s);
}
