// The backward of K9 for bfloat16 inputs: the gradients of causal (or not)
// GQA flash attention,
//
//   s = (q . k) dh^-0.5,  p = exp(s - lse),  D = rowsum(do * o),
//   dv = P^T do,  dP = do v^T,  dS = P * (dP - D),
//   dq = dh^-0.5 (dS k),  dk = dh^-0.5 (dS^T q),
//
// for q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv], o and do [B, H,
// S, dv] in bfloat16 and the forward's row statistic lse [B, H, S] in
// float32 (flash_wgmma.cu writes it: m + log(max(l, 1e-30)) of the scaled
// scores), query head h reading kv head h / G, G = H / KV; dq, dk, dv come
// out in bfloat16, each rounded once, at the end. The conventions are the
// bf16 forward's: the score is scaled after the product (a scaled q is not
// representable in bfloat16), the causal mask is t <= s with both counted
// from 0 (top-left aligned), rows past S and keys past T contribute
// nothing. Two entry points instantiate it: flash_bf16_bwd.cu (dh, dv <=
// 128) and flash_bf16_bwd_mla.cu (MLA's head, dh <= 192, dv <= 128).
//
// It replaces no TPU kernel: the reference has no backward kernel, and
// jax.grad differentiates its jnp attention (repro/models/attention.py).
// The port's forward runs K9 on the card, so its backward is a kernel too.
//
// Numerics. q, k, v and do are bf16 already, so S = Q K^T and dP = dO V^T
// are single bf16 products, exact in the tensor cores, summed in float32.
// P and dS are float32 (mask, exp, P (dP - D) on the CUDA cores); they
// enter dV, dK and dQ as two bf16 parts, x_hi = bf16(x) and x_lo = bf16(x -
// x_hi), as the forward's P enters P V: one part alone keeps 8 bits, and
// its emulation leaves the bound the card's check holds these kernels to
// (tests/test_torch_attention_bf16_bwd.py). A step's product is
// taken on the tensor cores into fresh registers and added to the float32
// sums on the CUDA cores: the tensor cores' float32 sums truncate, and a
// kv row's sum over thousands of query rows drifted past the float32
// backward's check (flash_f32_bwd.cu).
//
// Design. Three launches on the stream, one entry point, no atomics; every
// tile is 64 rows in bf16_tile.cuh's swizzled layout, D columns wide (D =
// the instantiation's head dim: 64 or 128, the least that holds max(dh,
// dv); 192 at MLA's head):
//
//   flash_bf16_bwd_dot_kernel   D = rowsum(do * o) in float32, a warp a row;
//   flash_bf16_bwd_dkdv_kernel  a block of two warpgroups per (b, kv head,
//                               64-row kv tile), the tiles with the most
//                               query tiles under the causal frontier
//                               first. K and V stay in shared memory while
//                               the block walks its G query heads in order
//                               and, for each, the 64-row query tiles from
//                               the frontier on, Q, dO, lse and D two
//                               stages deep by cp.async. A step:
//                                 S^T  = K Q^T     warpgroup 0
//                                 dP^T = V dO^T    warpgroup 1
//                                 P^T              warpgroup 0, handed to 1
//                                 dS^T             warpgroup 1
//                                 dV  += P^T dO    warpgroup 0
//                                 dK  += dS^T Q    warpgroup 1
//                               (A P^T or dS^T from registers, B dO or Q
//                               MN-major from the same tiles the score
//                               products read K-major), so each kv head's
//                               dk and dv sum over its query heads and
//                               tiles in one fixed order, in one block;
//   flash_bf16_bwd_dq_kernel    a warpgroup per (b, head, 64-row query
//                               tile), the longest first: Q and dO stay in
//                               shared memory while it walks the 64-row kv
//                               tiles up to the frontier, K and V two
//                               stages deep: S = Q K^T and dP = dO V^T as
//                               two chains, P and dS, dQ += dS K.
//
// In the dkdv kernel both warpgroups run the same code on operands chosen
// by select (a wgmma on a divergent path makes ptxas serialize them all),
// so V and dO are D wide there, zero past dv: at MLA's head dP^T takes 12
// k16 steps for its 8, and dV a third 64-column chunk of zeros, each beside
// warpgroup 0's S^T or warpgroup 1's dK, which take as many.
#pragma once

#include <stdint.h>

#include "../../csrc/float_io.cuh"
#include "bf16_tile.cuh"

namespace bf16_bwd {

using namespace bf16_tile;

constexpr int kBM = 64;   // rows of a block's resident tiles
constexpr int kBN = 64;   // rows of a step's tiles
constexpr int kWG = 128;  // threads of a warpgroup

// exp's argument where the mask drops a score: exp(-inf) = 0 exactly.
__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

__device__ __forceinline__ float lds32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}
__device__ __forceinline__ void sts128(uint32_t addr, float a, float b,
                                       float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Entries [r0, r0 + 64) of a [nrows] float32 vector into dst by cp.async,
// zero past nrows, by threads 0 <= i < 64 (others do nothing).
__device__ __forceinline__ void fill_vec64(uint32_t dst, const float* src,
                                           int r0, int nrows, int i) {
  if ((unsigned)i >= 64u) return;
  const bool live = r0 + i < nrows;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst + 4 * i),
               "l"(live ? src + r0 + i : src), "r"(live ? 4 : 0)
               : "memory");
}

// d[64 x 64] = A B^T over NK k16 steps, A and B 64-row tiles K-major in
// shared memory at a and b.
template <int NK>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
    wgmma_ss_n64(d, wgmma::desc(a + off, 16, 1024),
                 wgmma::desc(b + off, 16, 1024), kk > 0);
  }
  wgmma::commit();
  wgmma::wait();
#pragma unroll
  for (int i = 0; i < 32; ++i) wgmma::pin(d[i]);
}

// acc[64 x 64 NC] += X B over a step's 64 rows: X [64 x 64] as the A
// fragments of its two bf16 parts, B the step's tile at b (its rows the
// contraction, MN-major), a 64-column chunk at a time: X_lo B + X_hi B on
// the tensor cores into fresh registers, then added to acc on the CUDA
// cores.
template <int NC>
__device__ __forceinline__ void accumulate(float (&acc)[32 * NC],
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<64>::run(part, lo[kk],
                       wgmma::desc(b + c * kAtom + kk * 2048, kAtom, 1024),
                       kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<64>::run(part, hi[kk],
                       wgmma::desc(b + c * kAtom + kk * 2048, kAtom, 1024));
    wgmma::commit();
    wgmma::wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      wgmma::pin(part[i]);
      acc[32 * c + i] = __fadd_rn(acc[32 * c + i], part[i]);
    }
  }
}

// Rows r0 + 16 w + g + 8 h (those below nrows) of the [64 x 64 NC]
// accumulator of warpgroup thread wt, times `scale`, rounded once to the
// [nrows, cols] bf16 matrix dst, columns past cols dropped.
template <int NC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[32 * NC],
                                           int r0, int nrows, int cols,
                                           float scale, int wt) {
  const int w = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * w + g + 8 * h;
    if (row >= nrows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 64 * c + 8 * j + 2 * qd + e;
          if (col < cols)
            float_io::store(dst + (long long)row * cols + col,
                            __fmul_rn(acc[32 * c + 4 * j + 2 * h + e], scale));
        }
  }
}

// D[row] = sum_c do[row, c] o[row, c] in float32, a warp a row of BHS
// rows: lane l sums columns l, l + 32, .., then a butterfly over the warp.
__global__ void __launch_bounds__(256)
    flash_bf16_bwd_dot_kernel(const __nv_bfloat16* __restrict__ o,
                              const __nv_bfloat16* __restrict__ dO,
                              float* __restrict__ delta, long long BHS,
                              int dv) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= BHS) return;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc = __fmaf_rn(__bfloat162float(dO[row * dv + c]),
                    __bfloat162float(o[row * dv + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) delta[row] = acc;
}

// Shared memory of the dkdv kernel, byte offsets from a 1024-aligned base:
// the resident K and V tiles, two stages of Q and dO tiles, P^T handed
// from warpgroup 0 to 1 (64 x 64 float32), two stages' 64 lse and D, then
// the alignment slack.
template <int D>
struct DkdvSmem {
  static constexpr uint32_t kTile = tile_bytes<D>();
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kTile;
  static constexpr uint32_t kQ = kV + kTile;
  static constexpr uint32_t kO = kQ + 2 * kTile;
  static constexpr uint32_t kP = kO + 2 * kTile;
  static constexpr uint32_t kLse = kP + kBM * kBN * 4;
  static constexpr uint32_t kDelta = kLse + 2 * kBN * 4;
  static constexpr uint32_t kBytes = kDelta + 2 * kBN * 4 + 1024;
};
static_assert(DkdvSmem<192>::kBytes <= 232448, "an SM's shared memory");

// Accumulator layout of wgmma m64nN (f32) for thread t of a warpgroup:
// warp w = t / 32, g = (t % 32) / 4, qd = t % 4; register 4 j + 2 h + e
// holds row 16 w + g + 8 h, column 8 j + 2 qd + e.
//
// dK and dV of one 64-row kv tile (blockIdx.x: kv tile blockIdx.x / BKV of
// kv head blockIdx.x % BKV, so the tiles with the most query tiles come
// first); the notes at the top.
template <int D>
__global__ void __launch_bounds__(2 * kWG, 1)
    flash_bf16_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dO,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv_out, int BKV,
                               int H, int G, int S, int Tk, int dh, int dv,
                               float scale, int causal, int vec) {
  using L = DkdvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base + L::kK, sV = base + L::kV, sP = base + L::kP;
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
  // Q, dO, lse and D into stage i % 2
  auto fetch = [&](int i) {
    const int st = i & 1;
    const long long bh = (long long)b * H + kvh * G + i / per;
    const int q0 = (qstart + i % per) * kBN;
    load_tile<D, 2 * kWG>(base + L::kQ + st * L::kTile, q + bh * S * dh, q0,
                          S, dh, vec, tid);
    load_tile<D, 2 * kWG>(base + L::kO + st * L::kTile, dO + bh * S * dv, q0,
                          S, dv, vec, tid);
    fill_vec64(base + L::kLse + st * kBN * 4, lse + bh * S, q0, S, tid);
    fill_vec64(base + L::kDelta + st * kBN * 4, delta + bh * S, q0, S,
               tid - 64);
    wgmma::cp_async_commit();
  };
  load_tile<D, 2 * kWG>(sK, k + (long long)bkv * Tk * dh, t0, Tk, dh, vec,
                        tid);
  load_tile<D, 2 * kWG>(sV, v + (long long)bkv * Tk * dv, t0, Tk, dv, vec,
                        tid);
  wgmma::cp_async_commit();
  if (steps > 0) fetch(0);
  float acc[D / 2];  // warpgroup 0: dV; 1: dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int kr = t0 + 16 * w + g;  // this thread's kv rows: kr, kr + 8
  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    const int q0 = (qstart + i % per) * kBN;
    if (i + 1 < steps) {
      fetch(i + 1);
      wgmma::cp_async_wait<1>();
    } else {
      wgmma::cp_async_wait<0>();
    }
    // the step's stores become visible to wgmma (the async proxy), then
    // to every thread of the block
    wgmma::fence_proxy_async();
    __syncthreads();
    const uint32_t sQ = base + L::kQ + st * L::kTile;
    const uint32_t sO = base + L::kO + st * L::kTile;
    const uint32_t sL = base + L::kLse + st * kBN * 4;
    const uint32_t sD = base + L::kDelta + st * kBN * 4;
    // warpgroup 0: S^T = K Q^T; 1: dP^T = V dO^T
    float x[32];
    scores<D / 16>(x, dk_wg ? sV : sK, dk_wg ? sO : sQ);
    if (!dk_wg) {
      // P^T = exp(S^T dh^-0.5 - lse[query]) under the mask, to warpgroup 1
      // (thread wt's 32 as 8 chunks, conflict-free)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * qd + e, row = q0 + c;
          const float l = lds32(sL + 4 * c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int xi = 4 * j + 2 * h + e, t = kr + 8 * h;
            const bool live = row < S && t < Tk && !(causal && t > row);
            x[xi] = expf(live ? __fsub_rn(__fmul_rn(x[xi], scale), l)
                              : neg_inf());
          }
        }
#pragma unroll
      for (int c = 0; c < 8; ++c)
        sts128(sP + (c * kWG + wt) * 16, x[4 * c], x[4 * c + 1],
               x[4 * c + 2], x[4 * c + 3]);
    }
    __syncthreads();  // P^T handed over
    if (dk_wg) {
      // dS^T = P^T (dP^T - D[query])
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 pt = lds128(sP + (c * kWG + wt) * 16);
        const float ps[4] = {pt.x, pt.y, pt.z, pt.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int xi = 4 * c + m;  // = 4 j + 2 h + e
          const float d = lds32(sD + 4 * (8 * (xi / 4) + 2 * qd + xi % 2));
          x[xi] = __fmul_rn(ps[m], __fsub_rn(x[xi], d));
        }
      }
    }
    uint32_t xhi[4][4], xlo[4][4];
    split_fragments(x, xhi, xlo);
    // warpgroup 0: dV += P^T dO; 1: dK += dS^T Q
    accumulate<D / 64>(acc, xhi, xlo, dk_wg ? sQ : sO);
    __syncthreads();  // every read of stage st and of P^T is done
  }
  wgmma::cp_async_wait<0>();
  if (dk_wg)
    store_rows<D / 64>(dk + (long long)bkv * Tk * dh, acc, t0, Tk, dh, scale,
                       wt);
  else
    store_rows<D / 64>(dv_out + (long long)bkv * Tk * dv, acc, t0, Tk, dv,
                       1.f, wt);
}

// Shared memory of the dq kernel, byte offsets from a 1024-aligned base:
// the resident Q (DK wide) and dO (DV) tiles, two stages of K and V tiles,
// then the alignment slack.
template <int DK, int DV>
struct DqSmem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kO = kQ + tile_bytes<DK>();
  static constexpr uint32_t kK = kO + tile_bytes<DV>();
  static constexpr uint32_t kV = kK + 2 * tile_bytes<DK>();
  static constexpr uint32_t kBytes = kV + 2 * tile_bytes<DV>() + 1024;
};

// dQ of one 64-row query tile (blockIdx.x: query tile nq - 1 - blockIdx.x
// / BH of head blockIdx.x % BH, the longest first); the notes at the top.
template <int DK, int DV>
__global__ void __launch_bounds__(kWG, 2)
    flash_bf16_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dO,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int BH, int H,
                             int G, int S, int Tk, int dh, int dv,
                             float scale, int causal, int vec) {
  using L = DqSmem<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sO = base + L::kO;
  auto sK = [&](int st) { return base + L::kK + st * tile_bytes<DK>(); };
  auto sV = [&](int st) { return base + L::kV + st * tile_bytes<DV>(); };
  const int tid = threadIdx.x;
  const int w = tid / 32, g = (tid % 32) / 4, qd = tid % 4;
  const int nq = (S + kBM - 1) / kBM;
  const int qi = nq - 1 - (int)(blockIdx.x / BH);
  const long long bh = blockIdx.x % BH;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const long long bkv = (long long)b * (H / G) + h / G;
  const int q0 = qi * kBM;
  const int ntk = (Tk + kBN - 1) / kBN;
  // causal frontier: kv tiles strictly above the diagonal are skipped
  const int last = causal ? min(ntk, (q0 + kBM + kBN - 1) / kBN) : ntk;
  const __nv_bfloat16* kp = k + bkv * Tk * dh;
  const __nv_bfloat16* vp = v + bkv * Tk * dv;
  auto fetch = [&](int kt) {
    load_tile<DK, kWG>(sK(kt & 1), kp, kt * kBN, Tk, dh, vec, tid);
    load_tile<DV, kWG>(sV(kt & 1), vp, kt * kBN, Tk, dv, vec, tid);
    wgmma::cp_async_commit();
  };
  load_tile<DK, kWG>(sQ, q + bh * S * dh, q0, S, dh, vec, tid);
  load_tile<DV, kWG>(sO, dO + bh * S * dv, q0, S, dv, vec, tid);
  wgmma::cp_async_commit();
  if (last > 0) fetch(0);
  const int r0 = q0 + 16 * w + g;  // this thread's rows: r0, r0 + 8
  float lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool live = r0 + 8 * hh < S;
    lr[hh] = live ? lse[bh * S + r0 + 8 * hh] : 0.f;
    dr[hh] = live ? delta[bh * S + r0 + 8 * hh] : 0.f;
  }
  float acc[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < last; ++kt) {
    const int st = kt & 1;
    const int t0 = kt * kBN;
    if (kt + 1 < last) {
      fetch(kt + 1);
      wgmma::cp_async_wait<1>();
    } else {
      wgmma::cp_async_wait<0>();
    }
    wgmma::fence_proxy_async();
    __syncthreads();
    // S = Q K^T and dP = dO V^T, two chains
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
      wgmma_ss_n64(s, wgmma::desc(sQ + off, 16, 1024),
                   wgmma::desc(sK(st) + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
      wgmma_ss_n64(dp, wgmma::desc(sO + off, 16, 1024),
                   wgmma::desc(sV(st) + off, 16, 1024), kk > 0);
    }
    wgmma::commit();
    wgmma::wait();
    // dS = P (dP - D[row]), P = exp(S dh^-0.5 - lse[row]) under the mask
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int xi = 4 * j + 2 * hh + e, row = r0 + 8 * hh;
          const int t = t0 + 8 * j + 2 * qd + e;
          const bool live = row < S && t < Tk && !(causal && t > row);
          wgmma::pin(s[xi]);
          wgmma::pin(dp[xi]);
          const float p = expf(
              live ? __fsub_rn(__fmul_rn(s[xi], scale), lr[hh]) : neg_inf());
          s[xi] = __fmul_rn(p, __fsub_rn(dp[xi], dr[hh]));
        }
    uint32_t xhi[4][4], xlo[4][4];
    split_fragments(s, xhi, xlo);
    accumulate<DK / 64>(acc, xhi, xlo, sK(st));  // dQ += dS K
    __syncthreads();  // every read of stage st is done
  }
  wgmma::cp_async_wait<0>();
  store_rows<DK / 64>(dq + bh * S * dh, acc, q0, S, dh, scale, tid);
}

// The three launches at instantiation DK x DV (the dkdv kernel D = DK
// wide, DK >= DV). Returns the first nonzero error (0 on success).
template <int DK, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dO, const void* lse, void* delta, void* dq,
               void* dk, void* dv_out, int B, int H, int KV, int S, int Tk,
               int dh, int dv, float scale, int causal, int vec,
               void* stream) {
  static_assert(DK >= DV, "V and dO are DK wide in the dkdv kernel");
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* qb = (const __nv_bfloat16*)q;
  const auto* kb = (const __nv_bfloat16*)k;
  const auto* vb = (const __nv_bfloat16*)v;
  const auto* gb = (const __nv_bfloat16*)dO;
  const float* lf = (const float*)lse;
  float* df = (float*)delta;
  const long long bhs = (long long)B * H * S;
  int err = 0;
  if (bhs > 0) {
    flash_bf16_bwd_dot_kernel<<<(int)((bhs + 7) / 8), 256, 0, s>>>(
        (const __nv_bfloat16*)o, gb, df, bhs, dv);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int ntk = (Tk + kBM - 1) / kBM, nq = (S + kBM - 1) / kBM;
  if (ntk > 0) {
    err = float_io::launch(flash_bf16_bwd_dkdv_kernel<DK>, B * KV * ntk,
                           2 * kWG, DkdvSmem<DK>::kBytes, s, qb, kb, vb, gb,
                           lf, (const float*)df, (__nv_bfloat16*)dk,
                           (__nv_bfloat16*)dv_out, B * KV, H, H / KV, S, Tk,
                           dh, dv, scale, causal, vec);
    if (err) return err;
  }
  if (nq == 0) return 0;
  return float_io::launch(flash_bf16_bwd_dq_kernel<DK, DV>, B * H * nq, kWG,
                          DqSmem<DK, DV>::kBytes, s, qb, kb, vb, gb, lf,
                          (const float*)df, (__nv_bfloat16*)dq, B * H, H,
                          H / KV, S, Tk, dh, dv, scale, causal, vec);
}

}  // namespace bf16_bwd
