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
#include "tf32_split.cuh"

namespace {

using namespace split_tf32;
using namespace split_tf32::rows32;  // kBM 64, kBN 32, two warpgroups

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
    fill_vec(sL + (i % 2) * kBN * 4, lse + bh * S, q0, S, kBN, tid);
    fill_vec(sD + (i % 2) * kBN * 4, delta + bh * S, q0, S, kBN, tid);
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
    stage_rows<D>(sQ, rawQ, scale, 0, tid);
    stage_rows<D>(sO, rawO, 1.f, 0, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    if (i + 1 < steps) fetch_q(i + 1);
    // warpgroup 0: S^T = K Q^T; 1: dP^T = V dO^T (the operands chosen, the
    // products issued outside any branch: a wgmma on a divergent path
    // makes ptxas serialize them all)
    float x[16];
    scores<D, 64>(x, dk_wg ? sVhi : sKhi, dk_wg ? sVlo : sKlo,
                  dk_wg ? sO : sQ);
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
    fragments<4>(x, xhi, xlo);
    // Q^T and dO^T over Q and dO, one after the other (both at once
    // spilled)
    stage_cols<D>(sQ, tid);
    stage_cols<D>(sO, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    if (i + 1 < steps) fetch_o(i + 1);
    const uint32_t bt = dk_wg ? sQ : sO;
    accumulate<D, 4>(acc, xhi, xlo, bt, bt + D * 128);
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
    stage_rows<D>(sK, rawK, 1.f, 0, tid);
    stage_rows<D>(sV, rawV, 1.f, 0, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    // warpgroup 0: S = Q K^T; 1: dP = dO V^T (outside any branch)
    float x[16];
    scores<D, 64>(x, wg == 0 ? sQhi : sOhi, wg == 0 ? sQlo : sOlo,
                  wg == 0 ? sK : sV);
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
    fragments<4>(x, xhi, xlo);
    // K^T over K
    stage_cols<D>(sK, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    if (kt + 1 < last) fetch(kt + 1);
    accumulate<W, 4>(adq, xhi, xlo, sK + wg * W * 128,
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
