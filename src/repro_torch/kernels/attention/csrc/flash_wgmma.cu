// K9 for bfloat16 inputs on Hopper's tensor cores: causal (or not) GQA
// flash-attention forward,
//
//   o[b, h, s] = sum_t softmax_t(q[b, h, s] . k[b, h / G, t] * dh^-0.5)
//                * v[b, h / G, t],         G = H / KV,
//
// for q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv] in bfloat16, the
// softmax and every sum in float32, o [B, H, S, dv] in bfloat16 and, when
// asked, each row's log-sum-exp [B, H, S] in float32 (the backward's row
// statistic, flash_bf16_bwd.cuh). Float32 inputs go to flash_tf32.cu,
// which splits each operand into two TF32 parts.
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
// Design (dh <= 128): a block holds one warpgroup (128 threads) per query
// head of a 64-row query tile, two heads of one kv head when the group size
// is even (GQA: they share each K and V tile), else one; the tiles with the
// most kv tiles under the frontier are launched first. Q stays in shared
// memory; 64-row K and V tiles go through a 2-stage ring loaded with
// cp.async, so tile kt + 1 arrives while tile kt is computed. A tile
// wholly below the diagonal and inside T skips the mask arithmetic.
// Every tile is stored as 64-column sub-tiles in the 128-byte swizzled
// layout (bf16_tile.cuh), Q and K zero-padded to the instantiation's DK,
// V and O to its DV. The instantiations: DK = DV = 64 or 128, the least that holds
// max(dh, dv).
//
// MLA's prefill (dh over 128: q and k 128 + 64 wide, v 128, H = KV) runs
// flash_mla_kernel, warp-specialized and persistent (notes at the
// kernel): one block an SM walks the (head, 128-row query tile) list
// longest first; a producer warpgroup keeps two query buffers and a
// 3-slot K/V ring full by TMA, signalled on mbarriers; two
// consumer warpgroups of 64 rows share every K and V tile, and each
// issues tile kt + 1's Q K^T and tile kt's P V before it runs tile
// kt + 1's softmax, so the exp and the P split overlap a product. The
// arithmetic a score is the dh <= 128 kernels'.
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
// ms at the peak (3.89 ms with the split's second PV product); its 64-row
// query tiles loaded each K and V tile under their frontier again, 43.6 GB
// of tile loads from L2, which the 128-row tiles halve.
#include <stdint.h>
#include <string.h>

#include "../../csrc/float_io.cuh"
#include "bf16_tile.cuh"

namespace {

using namespace bf16_tile;

constexpr int kBQ = 64;        // query rows per block (one warpgroup)
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNeg = -1.0e30f;

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
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int BH, int H, int G, int S,
                       int Tk, int dh, int dv, float scale, int causal,
                       int vec) {
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

    // P as the A fragments of the four k16 steps over the tile's 64 keys,
    // in two bf16 parts
    uint32_t phi[4][4], plo[4][4];
    split_fragments(s, phi, plo);
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
  float* lp = lse == nullptr ? nullptr : lse + (long long)bh * S;
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
          float_io::store(op + (long long)r * dv + col,
                          __fdiv_rn(acc[4 * j + 2 * h + e], den));
      }
  }
}

template <int DK, int DV, int NH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int S, int Tk, int dh, int dv, float scale,
           int causal, int vec, cudaStream_t stream) {
  const int blocks = B * H / NH * ((S + kBQ - 1) / kBQ);
  return float_io::launch(
      flash_wgmma_kernel<DK, DV, NH>, blocks, kThreads * NH,
      1024 + NH * (size_t)tile_bytes<DK>() +
          2 * ((size_t)tile_bytes<DK>() + tile_bytes<DV>()),
      stream,
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, B * H, H, H / KV, S,
      Tk, dh, dv, scale, causal, vec);
}


// ---- MLA's head: DK = 192, DV = 128, warp-specialized and persistent ------

constexpr int kMlaBM = 128;       // query rows a tile: two consumers of 64
constexpr int kMlaQBufs = 2;      // query-tile buffers
constexpr int kMlaStages = 3;     // K/V ring slots
constexpr int kMlaThreads = 384;  // a producer warpgroup, two consumers
constexpr int kMlaDK = 192;       // q and k columns in shared memory
constexpr int kMlaDV = 128;       // v and o columns
// registers a thread after the hand-over: the producer gives up 112 a
// thread of its 168, the consumers take 56 more each (128 x 112 = 256 x 56)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

// Shared memory of flash_mla_kernel, byte offsets from a 1024-aligned
// base: [kMlaQBufs][2 consumers] query halves of 64 x 192, kMlaStages K
// tiles of 64 x 192 and V tiles of 64 x 128, all in swizzled 64-column
// sub-tiles, then the mbarriers (qfull, qempty, kfull, kempty).
struct MlaSmem {
  static constexpr uint32_t kQHalf = (kMlaDK / 64) * kAtom;
  static constexpr uint32_t kKTile = (kMlaDK / 64) * kAtom;
  static constexpr uint32_t kVTile = (kMlaDV / 64) * kAtom;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kMlaQBufs * 2 * kQHalf;
  static constexpr uint32_t kV = kK + kMlaStages * kKTile;
  static constexpr uint32_t kBar = kV + kMlaStages * kVTile;
  static constexpr uint32_t bytes =
      kBar + (2 * kMlaQBufs + 2 * kMlaStages) * 8 + 1024;  // + alignment
};
static_assert(MlaSmem::bytes <= 232448, "an SM's shared memory");

// K9 at MLA's head. The work list is every (head, 128-row query tile),
// rank i being query tile nq - 1 - i / BH of head i % BH, so the tiles
// with the most kv tiles come first; block b takes ranks b, b + grid, ...
// (one block an SM). Warpgroup 0 is the producer: it hands registers to
// the consumers, and one of its threads copies each tile's Q (into one of
// two buffers) and its K and V tiles up to the block's causal frontier
// (into a 3-slot ring) by TMA, 64 x 64 boxes in the 128-byte swizzle that
// complete on the item's full barrier, zero past every edge of the
// [heads, rows, columns] tensor; it waits on an empty barrier only to
// refill a slot. (Rows that are not whole 16-byte chunks, which TMA cannot
// take, are stored by the producer's 128 threads, which then signal.)
// Warpgroups 1 and 2 take rows [0, 64) and [64, 128) of the tile: each
// waits on the items it reads and frees them, never on the other
// consumer. A consumer's kv tile kt:
//
//   issue S_kt = Q K_kt^T (12 k16 steps), then O += P_{kt-1} V_{kt-1}
//   (hi and lo, 8 k16 steps); wait for S_kt alone (wgmma.wait_group 1);
//   scale, mask, the online softmax of S_kt while the P V product runs;
//   wait for it, free slot kt - 1, O *= alpha_kt, split P_kt.
//
// (Taking turns to issue, FlashAttention-3's ping-pong on two named
// barriers, measured slower here, and Q held in registers as the A
// operand spilled: PERF.md's findings.)
//
// So O_kt = (O_{kt-1} + P_{kt-1} V_{kt-1}) alpha_kt: the dh <= 128
// kernels' O_{kt-1} alpha_kt + P_kt V_kt with the rescale after the
// product, the same sums in another order. The consumer whose rows end
// before the block's frontier waits on and frees the tiles past its own.
__global__ void __launch_bounds__(kMlaThreads, 1)
    flash_mla_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int BH, int H, int G, int S, int Tk, int dh, int dv,
                     float scale, int causal, int vec) {
  using Sm = MlaSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int nq = (S + kMlaBM - 1) / kMlaBM;
  const int ntiles = BH * nq;
  const int ntk = (Tk + kBK - 1) / kBK;
  const uint32_t bar = base + Sm::kBar;
  auto qfull = [&](int b) { return bar + 8 * b; };
  auto qempty = [&](int b) { return bar + 8 * (kMlaQBufs + b); };
  auto kfull = [&](int s) { return bar + 8 * (2 * kMlaQBufs + s); };
  auto kempty = [&](int s) {
    return bar + 8 * (2 * kMlaQBufs + kMlaStages + s);
  };
  auto sQ = [&](int b, int half) {
    return base + Sm::kQ + (2 * b + half) * Sm::kQHalf;
  };
  auto sK = [&](int s) { return base + Sm::kK + s * Sm::kKTile; };
  auto sV = [&](int s) { return base + Sm::kV + s * Sm::kVTile; };
  // kv tiles under the frontier of query rows ending at r_end
  auto kv_tiles = [&](int r_end) {
    return causal ? min(ntk, (r_end + kBK - 1) / kBK) : ntk;
  };
  if (tid == 0) {
    for (int b = 0; b < kMlaQBufs; ++b) {
      wgmma::mbar_init(qfull(b), 1);
      wgmma::mbar_init(qempty(b), 256);
    }
    for (int s = 0; s < kMlaStages; ++s) {
      wgmma::mbar_init(kfull(s), 1);
      wgmma::mbar_init(kempty(s), 256);
    }
  }
  __syncthreads();

  if (wg == 0) {  // ---- the producer
    wgmma::reg_dealloc<kProducerRegs>();
    int qi = 0, ki = 0;
    for (int i = blockIdx.x; i < ntiles; i += gridDim.x) {
      const int qt = nq - 1 - i / BH, bh = i % BH;
      const int kvh = (bh / H) * (H / G) + (bh % H) / G;  // b * KV + h / G
      const int q0 = qt * kMlaBM;
      const int b = qi % kMlaQBufs;
      const int nkv = kv_tiles(q0 + kMlaBM);
      if (vec) {  // one thread issues TMA copies, 64 x 64 boxes
        if (wt == 0) {
          wgmma::mbar_wait(qempty(b), ((qi / kMlaQBufs) & 1) ^ 1);
          wgmma::mbar_expect_tx(qfull(b), 2 * Sm::kQHalf);
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int cb = 0; cb < kMlaDK / 64; ++cb)
              wgmma::tma_load_3d(sQ(b, half) + cb * kAtom, &tmq, 64 * cb,
                                 q0 + 64 * half, bh, qfull(b));
          for (int kt = 0; kt < nkv; ++kt) {
            const int st = (ki + kt) % kMlaStages;
            wgmma::mbar_wait(kempty(st),
                             (((ki + kt) / kMlaStages) & 1) ^ 1);
            wgmma::mbar_expect_tx(kfull(st), Sm::kKTile + Sm::kVTile);
#pragma unroll
            for (int cb = 0; cb < kMlaDK / 64; ++cb)
              wgmma::tma_load_3d(sK(st) + cb * kAtom, &tmk, 64 * cb,
                                 kt * kBK, kvh, kfull(st));
#pragma unroll
            for (int cb = 0; cb < kMlaDV / 64; ++cb)
              wgmma::tma_load_3d(sV(st) + cb * kAtom, &tmv, 64 * cb,
                                 kt * kBK, kvh, kfull(st));
          }
        }
      } else {  // rows that are not whole 16-byte chunks: the 128 threads
                // store them, then one signals
        wgmma::mbar_wait(qempty(b), ((qi / kMlaQBufs) & 1) ^ 1);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          load_tile<kMlaDK, 128>(sQ(b, half), q + (long long)bh * S * dh,
                                 q0 + 64 * half, S, dh, false, wt);
        wgmma::fence_proxy_async();
        wgmma::named_bar(1, 128);
        if (wt == 0) wgmma::mbar_arrive(qfull(b));
        for (int kt = 0; kt < nkv; ++kt) {
          const int st = (ki + kt) % kMlaStages;
          wgmma::mbar_wait(kempty(st), (((ki + kt) / kMlaStages) & 1) ^ 1);
          load_tile<kMlaDK, 128>(sK(st), k + (long long)kvh * Tk * dh,
                                 kt * kBK, Tk, dh, false, wt);
          load_tile<kMlaDV, 128>(sV(st), v + (long long)kvh * Tk * dv,
                                 kt * kBK, Tk, dv, false, wt);
          wgmma::fence_proxy_async();
          wgmma::named_bar(1, 128);
          if (wt == 0) wgmma::mbar_arrive(kfull(st));
        }
      }
      ++qi;
      ki += nkv;
    }
    return;
  }

  // ---- the consumers: warpgroup cw takes rows [64 cw, 64 cw + 64)
  wgmma::reg_alloc<kConsumerRegs>();
  const int cw = wg - 1;
  const int warp = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
  constexpr int NO = kMlaDV / 2;  // output accumulators a thread
  int qi = 0, ki = 0;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  for (int i = blockIdx.x; i < ntiles; i += gridDim.x) {
    const int qt = nq - 1 - i / BH, bh = i % BH;
    const int q0 = qt * kMlaBM, rw = q0 + 64 * cw;
    const int r0 = rw + warp * 16 + g;  // this thread's rows: r0, r0 + 8
    const int nkv = kv_tiles(q0 + kMlaBM);
    const int mine = kv_tiles(rw + 64);
    const int b = qi % kMlaQBufs;
    wgmma::mbar_wait(qfull(b), (qi / kMlaQBufs) & 1);
    const uint32_t qs = sQ(b, cw);
    float acc[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) acc[e] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    uint32_t phi[4][4] = {}, plo[4][4] = {};
    int prev = 0;  // the ring slot of tile kt - 1
    for (int kt = 0; kt < mine; ++kt, ++ki) {
      const int st = ki % kMlaStages;
      const int t0 = kt * kBK;
      wgmma::mbar_wait(kfull(st), (ki / kMlaStages) & 1);
      // every register write the products read is done before the fence
#pragma unroll
      for (int e = 0; e < NO; ++e) wgmma::pin(acc[e]);
#pragma unroll
      for (int e = 0; e < 32; ++e) wgmma::pin(s[e]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wgmma::pin(phi[kk][r]);
          wgmma::pin(plo[kk][r]);
        }
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < kMlaDK / 16; ++kk) {
        const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
        wgmma_ss_n64(s, wgmma::desc(qs + off, 16, 1024),
                     wgmma::desc(sK(st) + off, 16, 1024), kk > 0);
      }
      wgmma::commit();
      if (kt > 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaRS<kMlaDV>::run(acc, phi[kk],
                               wgmma::desc(sV(prev) + kk * 2048, kAtom,
                                           1024));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaRS<kMlaDV>::run(acc, plo[kk],
                               wgmma::desc(sV(prev) + kk * 2048, kAtom,
                                           1024));
        wgmma::commit();
        wgmma::wait_group<1>();
      } else {
        wgmma::wait();
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) wgmma::pin(s[e]);
      // scale after the product, mask (only a tile that crosses this
      // warpgroup's diagonal or the ragged T edge needs it), online softmax
      const bool mask = (causal && t0 + kBK - 1 > rw) || t0 + kBK > Tk;
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
      if (kt > 0) {  // P_{kt-1} V_{kt-1} is done: free its slot, rescale
        wgmma::wait();
#pragma unroll
        for (int e = 0; e < NO; ++e) wgmma::pin(acc[e]);
        wgmma::mbar_arrive(kempty(prev));
#pragma unroll
        for (int e = 0; e < NO; ++e)
          acc[e] = __fmul_rn(acc[e], alpha[(e / 2) % 2]);
      }
      // P_kt as A fragments of the four k16 steps over the tile's 64
      // keys: register r of step kk packs scores 8 kk + 2 r, 8 kk + 2 r + 1
      // (each pair rounded by one paired conversion, as the two single
      // ones round it)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p0 = s[8 * kk + 2 * r], p1 = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          phi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(__fsub_rn(p0, __low2float(hi)),
                                    __fsub_rn(p1, __high2float(hi)));
          plo[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      prev = st;
    }
    if (mine > 0) {  // the last tile's P V
#pragma unroll
      for (int e = 0; e < NO; ++e) wgmma::pin(acc[e]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wgmma::pin(phi[kk][r]);
          wgmma::pin(plo[kk][r]);
        }
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<kMlaDV>::run(acc, phi[kk],
                             wgmma::desc(sV(prev) + kk * 2048, kAtom, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<kMlaDV>::run(acc, plo[kk],
                             wgmma::desc(sV(prev) + kk * 2048, kAtom, 1024));
      wgmma::commit();
      wgmma::wait();
#pragma unroll
      for (int e = 0; e < NO; ++e) wgmma::pin(acc[e]);
      wgmma::mbar_arrive(kempty(prev));
    }
    // the tiles past this warpgroup's frontier, which the other reads
    for (int kt = mine; kt < nkv; ++kt, ++ki) {
      const int st = ki % kMlaStages;
      wgmma::mbar_wait(kfull(st), (ki / kMlaStages) & 1);
      wgmma::mbar_arrive(kempty(st));
    }
    wgmma::mbar_arrive(qempty(b));  // done with the query buffer
    ++qi;
    __nv_bfloat16* op = o + (long long)bh * S * dv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= S) continue;
      const float den = fmaxf(l[h], 1e-30f);
      if (lse != nullptr && qd == 0)
        lse[(long long)bh * S + r] = __fadd_rn(m[h], logf(den));
#pragma unroll
      for (int j = 0; j < kMlaDV / 8; ++j) {
        const int col = 8 * j + 2 * qd;
        const float y0 = __fdiv_rn(acc[4 * j + 2 * h], den);
        const float y1 = __fdiv_rn(acc[4 * j + 2 * h + 1], den);
        __nv_bfloat16* p = op + (long long)r * dv + col;
        if (dv % 2 == 0 && col + 1 < dv) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
        } else {
          if (col < dv) *p = __float2bfloat16_rn(y0);
          if (col + 1 < dv) p[1] = __float2bfloat16_rn(y1);
        }
      }
    }
  }
}

// The bf16 tensor [n, rows, cols] at p (cols % 8 == 0, p 16-byte
// aligned) as 64-column x 64-row boxes in the 128-byte swizzle, zero past
// every edge.
bool tile_map(CUtensorMap* map, const void* p, int cols, int rows, int n) {
  return wgmma::tile_map(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cols,
                         rows, n, 64, 64);
}

int launch_mla(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int KV, int S, int Tk, int dh,
               int dv, float scale, int causal, int vec,
               cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof tq);
  memset(&tk, 0, sizeof tk);
  memset(&tv, 0, sizeof tv);
  vec = vec && Tk > 0;
  if (vec && !(tile_map(&tq, q, dh, S, B * H) &&
               tile_map(&tk, k, dh, Tk, B * KV) &&
               tile_map(&tv, v, dv, Tk, B * KV)))
    return (int)cudaErrorInvalidValue;
  const int tiles = B * H * ((S + kMlaBM - 1) / kMlaBM);
  return float_io::launch(
      flash_mla_kernel, tiles < sms ? tiles : sms, kMlaThreads,
      MlaSmem::bytes, stream, tq, tk, tv, (const __nv_bfloat16*)q,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)o,
      lse, B * H, H, H / KV, S, Tk, dh, dv, scale, causal, vec);
}

}  // namespace

// K9, bfloat16. q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv], o [B,
// H, S, dv], row-major bfloat16; lse [B, H, S] float32, or null: each
// row's log-sum-exp of the scaled scores, m + log(max(l, 1e-30)) of the
// float32 m and l the kernel keeps (the backward's row statistic; o is
// the same with or without it); scale is dh^-0.5 rounded to float32;
// dh <= 192, dv <= 128; vec: dh and dv multiples of 8 and q, k, v 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for dh over 192 or dv over 128.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int KV, int S, int Tk,
                                        int dh, int dv, float scale,
                                        int causal, int vec, void* stream) {
  if (B == 0 || H == 0 || S == 0 || dv == 0) return 0;
  if (dh > 192 || dv > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* lf = (float*)lse;
  // MLA's q and k: 192 wide, the warp-specialized persistent kernel
  if (dh > 128)
    return launch_mla(q, k, v, o, lf, B, H, KV, S, Tk, dh, dv, scale, causal,
                      vec, s);
  const int d = dh > dv ? dh : dv;
  // two query heads of one kv head a block when the group size is even
  const bool pair = (H / KV) % 2 == 0;
  if (d <= 64)
    return pair ? launch<64, 64, 2>(q, k, v, o, lf, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s)
                : launch<64, 64, 1>(q, k, v, o, lf, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s);
  return pair ? launch<128, 128, 2>(q, k, v, o, lf, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s)
              : launch<128, 128, 1>(q, k, v, o, lf, B, H, KV, S, Tk, dh, dv,
                                    scale, causal, vec, s);
}
