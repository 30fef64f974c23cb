// The backward of K9 for float32 inputs at MLA's head (q and k 192 wide:
// 128 + 64 rope columns; v 128): the gradients of causal (or not) GQA
// flash attention,
//
//   s = (q dh^-0.5) . k,  p = exp(s - lse),  D = rowsum(do * o),
//   dv = P^T do,  dP = do v^T,  dS = P * (dP - D),
//   dq = dh^-0.5 (dS k),  dk = dS^T (q dh^-0.5),
//
// for q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv], o and do [B, H,
// S, dv] and the forward's row statistic lse [B, H, S]
// (flash_tf32.cu's flash_tf32_mla_kernel writes it: m + log(max(l, 1e-30))
// of the scaled scores), query head h reading kv head h / G, G = H / KV,
// 128 < dh <= 192, dv <= 128. The conventions are the forward's: q is
// scaled (rounded to float32) before the dot, for the scores and for dk; dq
// is scaled once at the end; the causal mask is t <= s with both counted
// from 0 (top-left aligned); rows past S and keys past T contribute
// nothing. Heads up to 128 wide take flash_f32_bwd.cu.
//
// It replaces no TPU kernel: the reference has no backward kernel. Its
// models never call their Pallas kernel, and jax.grad differentiates the
// jnp attention under MLA (repro/models/attention.py::mla_apply). The
// port's forward runs K9 at MLA's head on the card, so its backward is a
// kernel too.
//
// Numerics: split TF32 on the tensor cores (tf32_split.cuh), as
// flash_f32_bwd.cu: three TF32 products a product, each step's product
// taken into fresh registers and added to the float32 sums on CUDA cores
// (a kv row's dk and dv sum over G S query rows). P and dS stay in float32
// on CUDA cores, then split in registers into the A fragments of the next
// product.
//
// Design. flash_f32_bwd.cu's, at 16-row steps. Three launches on the
// stream, one entry point, no atomics:
//
//   flash_bwd_dot_kernel   D = rowsum(do * o), a warp a row;
//   flash_bwd_mla_dkdv_kernel
//                          a block of two warpgroups per (b, kv head,
//                          64-row kv tile), the tiles with the most query
//                          steps under the causal frontier first. K and V
//                          stay in shared memory as their parts while the
//                          block walks its G query heads in order and, for
//                          each, the 16-row query steps from the frontier
//                          on;
//   flash_bwd_mla_dq_kernel
//                          a block of two warpgroups per (b, head, 64-row
//                          query tile), the longest first. Q and dO stay in
//                          shared memory as their parts while the block
//                          walks the 16-row kv steps up to the frontier.
//
// A step's score products contract over 192 columns (S) and 128 (dP): 24
// and 16 k8 steps. Both warpgroups issue the same wgmma instructions (a
// wgmma on a branch of the warpgroup makes ptxas serialize them all), so
// the 40 split evenly: warpgroup 0 takes S's columns 0-159 (dkdv: S^T = K
// Q^T; dq: S = Q K^T), warpgroup 1 dP (dP^T = V dO^T; dP = dO V^T) and S's
// columns 160-191, each as a 16-step chain into one accumulator and a
// 4-step chain into another. They hand their partial sums over through
// shared memory (warpgroup 0 its S partial, warpgroup 1 its S partial and
// dP), and each forms S = (S_0 + S_1), P and dS, the same in both. Then
// the products that contract over the step's 16 rows, from registers:
//
//   dkdv  warpgroup 0: dV += P^T dO (two n64) and dK[:, 0:32] += dS^T Q
//         (n32); warpgroup 1: dK[:, 32:160] (two n64) and dK[:, 160:192]
//         (n32);
//   dq    dQ += dS K, columns 0-95 in warpgroup 0, 96-191 in 1 (n96).
//
// TF32 wgmma reads both operands K-major only, so a step's tile comes in
// raw by cp.async into a raw buffer, one step ahead; the threads split it
// into its two parts stacked in one [32, D] tile (lo rows 0-15, hi 16-31:
// one n32 product takes A_hi against both, one n16 A_lo against the hi
// rows), the B operand of the score products; once those are done, they
// move the parts into the same buffer transposed, [D, 32] with a row of
// 128 bytes (hi K 0-15, then lo K 0-15), the K rows permuted by sigma to
// match the A fragments (stage_cols), the B operand of the products that
// contract over the step.
//
// Shared memory, bytes from a 1024-aligned base (Smem): the resident
// parts, 2 64 192 4 + 2 64 128 4 = 163,840; the step's stacked tiles [32,
// 192] and [32, 128], 40,960; their raw [16, .] tiles, 20,480; 4,096 for
// warpgroup 0's hand-over (warpgroup 1's 8,192 go to the raw [16, 128] tile
// in dkdv, fetched again once they are read, and to the stacked [32, 128]
// one in dq, which only warpgroup 1's products read, so that both next
// tiles are fetched as soon as a step is staged); two steps' 16 lse and D,
// 256; 1,024 of alignment slack: 230,656 of an SM's 232,448. (32-row
// steps, as flash_f32_bwd.cu, would take 286,720.) One block an SM.
//
// Bound on this card: operations. The least work is 2 (3 dh + 2 dv) FLOPs
// a query-key pair under the mask (s, dP, dV, dK, dQ; P recomputed once);
// at deepseek-v2's layer (B 1, H = KV = 128, S = T = 4096, dh 192, dv 128)
// 1.79 TFLOP: 10.8 ms as three TF32 products at 494.7 TFLOP/s (26.7 ms at
// the 67 TFLOP/s float32 CUDA-core peak). This design does 2 (4 dh + 3 dv)
// a pair (s and dP twice). Its bytes (q, k, v, o, do, lse, dq, dk, dv
// once) take 0.4 ms at 3.35 TB/s.
#include <stdint.h>

#include "../../csrc/float_io.cuh"
#include "tf32_split.cuh"

namespace {

using namespace split_tf32;

constexpr int kBM = 64;        // rows of the resident tile (the wgmma M)
constexpr int kBN = 16;        // rows of a step's tile
constexpr int kWG = 128;       // threads of a warpgroup
constexpr int kThreads = 256;  // a block: two warpgroups
constexpr int kDH = 192;       // q and k columns, zero-padded past dh
constexpr int kDV = 128;       // v columns, zero-padded past dv

// Shared memory of both kernels, byte offsets from a 1024-aligned base: the
// two parts of the resident [64, 192] tile (K in dkdv, Q in dq) and of the
// [64, 128] one (V, dO), the step's two stacked tiles [32, 192] (Q, K) and
// [32, 128] (dO, V), their raw [16, .] tiles, the hand-over's 4,096 bytes
// beyond the raw [16, 128] one, two steps' 16 lse and D (dkdv), then the
// alignment slack.
struct Smem {
  static constexpr uint32_t kPartH = kBM * kDH * 4;  // one [64, 192] part
  static constexpr uint32_t kPartV = kBM * kDV * 4;  // one [64, 128] part
  static constexpr uint32_t kAhi = 0;
  static constexpr uint32_t kAlo = kAhi + kPartH;
  static constexpr uint32_t kBhi = kAlo + kPartH;
  static constexpr uint32_t kBlo = kBhi + kPartV;
  static constexpr uint32_t kX = kBlo + kPartV;           // [32, 192]
  static constexpr uint32_t kY = kX + 2 * kBN * kDH * 4;  // [32, 128]
  static constexpr uint32_t kRawX = kY + 2 * kBN * kDV * 4;
  static constexpr uint32_t kRawY = kRawX + kBN * kDH * 4;
  static constexpr uint32_t kXchg = kRawY + kBN * kDV * 4;
  static constexpr uint32_t kLse = kXchg + 4096;  // two steps'
  static constexpr uint32_t kDelta = kLse + 2 * kBN * 4;
  static constexpr uint32_t kBytes = kDelta + 2 * kBN * 4 + 1024;
};
static_assert(Smem::kBytes <= 232448, "an SM's shared memory");
static_assert(Smem::kLse - Smem::kXchg == kWG * 8 * 4 &&
                  Smem::kXchg - Smem::kRawY >= 2 * kWG * 8 * 4,
              "the hand-over: 8 floats a thread, warpgroup 0's in the "
              "hand-over's own bytes, warpgroup 1's two in the raw [16, 128] "
              "tile (dkdv) or the stacked one (dq)");

// Rows [r0, r0 + 64) of the [nrows, cols] matrix src, times `scale`, as
// the parts of a resident [64, D] tile, zero past the edges, by the
// block's threads.
template <int D>
__device__ __forceinline__ void stage_resident(uint32_t hi, uint32_t lo,
                                               const float* src, int r0,
                                               int nrows, int cols, bool vec,
                                               float scale, int tid) {
  constexpr int C4 = D / 4;
  static_assert(kBM * C4 % kThreads == 0, "resident tile passes");
#pragma unroll 4
  for (int n = 0; n < kBM * C4 / kThreads; ++n) {
    const int u = tid + n * kThreads, r = u / C4, c4 = u % C4;
    const uint32_t off = swz(r, c4, kBM);
    store_split(hi + off, lo + off,
                load4(src, r0 + r, nrows, 4 * c4, cols, vec), scale);
  }
}

// Rows [r0, r0 + 16) of the [nrows, cols] matrix src into the raw tile at
// dst (swizzled as a [16, D] operand tile), zero past the edges, by the
// block's threads (fill_chunk: by cp.async when vec, the caller commits).
template <int D>
__device__ __forceinline__ void fill_raw(uint32_t dst, const float* src,
                                         int r0, int nrows, int cols,
                                         bool vec, int tid) {
  constexpr int C4 = D / 4;
  static_assert(kBN * C4 % kThreads == 0, "raw tile passes");
#pragma unroll
  for (int n = 0; n < kBN * C4 / kThreads; ++n) {
    const int u = tid + n * kThreads, r = u / C4, c4 = u % C4;
    fill_chunk(dst + swz(r, c4, kBN), src, r0 + r, nrows, c4, cols, vec);
  }
}

// A step's raw tile [16, D], times `scale`, as its two parts stacked into
// the [32, D] operand tile at dst as it lies, by the block's threads: row
// r's lo part at row r, its hi part at row 16 + r.
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t dst, uint32_t raw,
                                           float scale, int tid) {
  constexpr int C4 = D / 4;
#pragma unroll
  for (int n = 0; n < kBN * C4 / kThreads; ++n) {
    const int u = tid + n * kThreads, r = u / C4, c4 = u % C4;
    store_split(dst + swz(r + kBN, c4, 2 * kBN), dst + swz(r, c4, 2 * kBN),
                lds128(raw + swz(r, c4, kBN)), scale);
  }
}

// The transpose [D, 32] of a step's tile, in place: its parts as
// stage_rows stacked them at `tile` become rows of 128 bytes, row n's
// chunks 0-3 its hi part's K positions 0-15 and chunks 4-7 its lo part's,
// by the block's threads over D units, one a thread. Unit u in phases of 8
// lanes P = u / 8 (A = D / 32, a = P % A, c = P / A) with lane l = u % 8
// takes chunk ch = (l / 2 + c) % 4 of the K positions and the 16-byte
// column chunk nv = 8 a + l: it moves columns 4 nv .. 4 nv + 3 of rows 8
// (ch / 2) + ch % 2 + 2 m (m = 0..3) to K positions 4 ch .. 4 ch + 3 of
// rows 4 nv + e, where sigma puts those rows. In each phase the 8 lanes'
// reads (chunk nv % 8 ^ row % 8) and writes (chunk ch ^ (4 (nv % 2) + e),
// and 4 + that) fall in 8 different 16-byte bank groups. Every thread
// reads its unit and runs before(), the block waits, then every thread
// runs after() and writes (the hand-over rides on this barrier).
template <int D, typename Before, typename After>
__device__ __forceinline__ void stage_cols(uint32_t tile, int tid,
                                           Before before, After after) {
  static_assert(D <= kThreads, "a unit a thread");
  constexpr int A = D / 32;
  const bool live = tid < D;
  const int P = tid / 8, l = tid % 8;
  const int ch = (l / 2 + P / A) % 4, nv = 8 * (P % A) + l;
  float4 c[2][4];  // [hi, lo][m]
  if (live) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = 8 * (ch / 2) + ch % 2 + 2 * m;
      c[1][m] = lds128(tile + swz(r, nv, 2 * kBN));
      c[0][m] = lds128(tile + swz(r + kBN, nv, 2 * kBN));
    }
  }
  before();
  __syncthreads();  // every read of the tile is done
  after();
  if (!live) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = 4 * nv + e;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const float4* x = c[part];
      const float4 col =
          e == 0 ? make_float4(x[0].x, x[1].x, x[2].x, x[3].x)
          : e == 1 ? make_float4(x[0].y, x[1].y, x[2].y, x[3].y)
          : e == 2 ? make_float4(x[0].z, x[1].z, x[2].z, x[3].z)
                   : make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
      sts128(tile + row * 128 + (((4 * part + ch) ^ (row & 7)) << 4), col);
    }
  }
}

// A score chain: [64 x 16] = A B^T over N k8 steps from A's and B's
// addresses, A a resident [64, .] tile as its parts, B a step's [32, .]
// tile as its parts stacked: w = A_hi [B_lo; B_hi]^T (n32) and x = A_lo
// B_hi^T (n16).
template <int N>
__device__ __forceinline__ void score_chain(float (&w)[16], float (&x)[8],
                                            uint32_t ahi, uint32_t alo,
                                            uint32_t b) {
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {  // descriptors formed where used
    const uint32_t ka = (kk / 4) * (kBM * 128) + (kk % 4) * 32;
    const uint32_t kb = (kk / 4) * (2 * kBN * 128) + (kk % 4) * 32;
    Mma<32>::ss(w, tile_desc(ahi + ka), tile_desc(b + kb), kk > 0);
    Mma<16>::ss(x, tile_desc(alo + ka), tile_desc(b + kBN * 128 + kb),
                kk > 0);
  }
}

// The score products of a step in both warpgroups (the notes at the top):
// c1 over A1 and B1's first 16 k8 steps, c2 over S's k8 steps 16 + 4 wg
// .. 19 + 4 wg (warpgroup 0: 16 .. 19, 1: 20 .. 23) of the resident tile
// at a and the step tile at b; each chain's parts summed the small
// products first.
__device__ __forceinline__ void scores(float (&c1)[8], float (&c2)[8],
                                       uint32_t a1hi, uint32_t a1lo,
                                       uint32_t b1, uint32_t ahi,
                                       uint32_t alo, uint32_t b, int wg) {
  float w1[16], x1[8], w2[16], x2[8];
  const int k2 = 4 + wg;  // the 32-column sub-tile of S's last k8 steps
  wgmma::fence();
  score_chain<16>(w1, x1, a1hi, a1lo, b1);
  score_chain<4>(w2, x2, ahi + k2 * kBM * 128, alo + k2 * kBM * 128,
                 b + k2 * 2 * kBN * 128);
  wgmma::commit();
  wgmma::wait();
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    wgmma::pin(w1[i]);
    wgmma::pin(w2[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    wgmma::pin(x1[i]);
    wgmma::pin(x2[i]);
    c1[i] = __fadd_rn(__fadd_rn(w1[i], x1[i]), w1[8 + i]);
    c2[i] = __fadd_rn(__fadd_rn(w2[i], x2[i]), w2[8 + i]);
  }
}

// The hand-over of a step's partial scores (the notes at the top), thread
// wt's 8 as 2 chunks, on the barrier of a transpose: put() before it,
// take() after. Warpgroup 0 puts its S partial, mine = c1 + c2, to e0,
// warpgroup 1 its S partial, mine = c2, to e1 and dP (c1) 4,096 bytes on;
// take() gives both s = S_0 + S_1 and dp, the same in both. No wgmma of
// warpgroup 0 reads e1's 8,192 bytes, and none reads e0's 4,096.
__device__ __forceinline__ void put(const float (&c1)[8],
                                    const float (&mine)[8], uint32_t e0,
                                    uint32_t e1, int wg, int wt) {
  const uint32_t at0 = e0 + wt * 16, at1 = e1 + wt * 16;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    sts128((wg ? at1 : at0) + c * kWG * 16,
           make_float4(mine[4 * c], mine[4 * c + 1], mine[4 * c + 2],
                       mine[4 * c + 3]));
    if (wg == 1)
      sts128(at1 + 4096 + c * kWG * 16,
             make_float4(c1[4 * c], c1[4 * c + 1], c1[4 * c + 2],
                         c1[4 * c + 3]));
  }
}
__device__ __forceinline__ void take(const float (&c1)[8],
                                     const float (&mine)[8], float (&s)[8],
                                     float (&dp)[8], uint32_t e0,
                                     uint32_t e1, int wg, int wt) {
  const uint32_t at0 = e0 + wt * 16, at1 = e1 + wt * 16;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float4 y = lds128((wg ? at0 : at1) + c * kWG * 16);
    const float4 z = lds128(at1 + 4096 + c * kWG * 16);
    const float ys[4] = {y.x, y.y, y.z, y.w}, zs[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = 4 * c + m;
      s[i] = wg == 0 ? __fadd_rn(mine[i], ys[m]) : __fadd_rn(ys[m], mine[i]);
      dp[i] = wg == 0 ? zs[m] : c1[i];
    }
  }
}

// dK and dV of one 64-row kv tile (blockIdx.x: kv tile kt = blockIdx.x /
// BKV of kv head blockIdx.x % BKV, so the tiles with the most query steps
// come first); the notes at the top.
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_mla_dkdv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dO,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk,
                              float* __restrict__ dv_out, int BKV, int H,
                              int G, int S, int Tk, int dh, int dv,
                              float scale, int causal, int vec) {
  using L = Smem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKhi = base + L::kAhi, sKlo = base + L::kAlo;
  const uint32_t sVhi = base + L::kBhi, sVlo = base + L::kBlo;
  const uint32_t sQ = base + L::kX;  // Q's parts, then Q^T's
  const uint32_t sO = base + L::kY;  // dO's, then dO^T's
  const uint32_t rawQ = base + L::kRawX, rawO = base + L::kRawY;
  const uint32_t sL = base + L::kLse, sD = base + L::kDelta;
  const int tid = threadIdx.x;
  const int wg = tid / kWG, wt = tid % kWG;
  const int w = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
  const int kt = (int)(blockIdx.x / BKV);
  const int bkv = (int)(blockIdx.x % BKV);
  const int KV = H / G, b = bkv / KV, kvh = bkv % KV;
  const int t0 = kt * kBM;
  const int nq = (S + kBN - 1) / kBN;
  // query steps from the one holding row t0 (the causal frontier)
  const int qstart = causal ? min(nq, t0 / kBN) : 0;
  const int per = nq - qstart;  // query steps a head
  const int steps = G * per;
  // step i: query head kvh G + i / per, query step qstart + i % per; its
  // Q, lse and D, then its dO
  auto fetch_q = [&](int i) {
    const long long bh = (long long)b * H + kvh * G + i / per;
    const int q0 = (qstart + i % per) * kBN;
    fill_raw<kDH>(rawQ, q + bh * S * dh, q0, S, dh, vec, tid);
    fill_vec(sL + (i % 2) * kBN * 4, lse + bh * S, q0, S, kBN, tid);
    fill_vec(sD + (i % 2) * kBN * 4, delta + bh * S, q0, S, kBN, tid);
    wgmma::cp_async_commit();
  };
  auto fetch_o = [&](int i) {
    const long long bh = (long long)b * H + kvh * G + i / per;
    const int q0 = (qstart + i % per) * kBN;
    fill_raw<kDV>(rawO, dO + bh * S * dv, q0, S, dv, vec, tid);
    wgmma::cp_async_commit();
  };
  if (steps > 0) {
    fetch_q(0);
    fetch_o(0);
  }
  stage_resident<kDH>(sKhi, sKlo, k + (long long)bkv * Tk * dh, t0, Tk, dh,
                      vec, 1.f, tid);
  stage_resident<kDV>(sVhi, sVlo, v + (long long)bkv * Tk * dv, t0, Tk, dv,
                      vec, 1.f, tid);
  // warpgroup 0: dV's columns 0-63 and 64-127, dK's 0-31; 1: dK's 32-95,
  // 96-159 and 160-191
  float acc0[32], acc1[32], acc2[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc2[i] = 0.f;
  const int kr = t0 + 16 * w + g;  // this thread's kv rows: kr, kr + 8
  for (int i = 0; i < steps; ++i) {
    const int q0 = (qstart + i % per) * kBN;
    // the step's raw tiles have landed, and every warp is done with the
    // step before's products
    wgmma::cp_async_wait<0>();
    __syncthreads();
    stage_rows<kDH>(sQ, rawQ, scale, tid);
    stage_rows<kDV>(sO, rawO, 1.f, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    if (i + 1 < steps) fetch_q(i + 1);
    // warpgroup 0: S^T = K Q^T over columns 0 .. 159; 1: dP^T = V dO^T
    // and S^T over columns 160 .. 191 (operands chosen by select)
    float c1[8], c2[8], mine[8], st[8], dpt[8];
    scores(c1, c2, wg ? sVhi : sKhi, wg ? sVlo : sKlo, wg ? sO : sQ, sKhi,
           sKlo, sQ, wg);
#pragma unroll
    for (int j = 0; j < 8; ++j) mine[j] = wg ? c2[j] : __fadd_rn(c1[j], c2[j]);
    // Q^T over Q (every score product is done: each thread waited on its
    // own before the barrier), the hand-over on its barrier
    const uint32_t xchg = base + L::kXchg;
    stage_cols<kDH>(
        sQ, tid, [&] { put(c1, mine, xchg, rawO, wg, wt); },
        [&] { take(c1, mine, st, dpt, xchg, rawO, wg, wt); });
    // P^T = exp(S^T - lse[query]) under the mask, dS^T = P^T (dP^T -
    // D[query]), in both warpgroups
    const uint32_t sLi = sL + (i % 2) * kBN * 4, sDi = sD + (i % 2) * kBN * 4;
    float a1[8], dst_[8];  // a1: warpgroup 0 P^T, 1 dS^T
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * qd + e, row = q0 + c;
        const float l = lds32(sLi + 4 * c), d = lds32(sDi + 4 * c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int xi = 4 * j + 2 * h + e, t = kr + 8 * h;
          const bool live = row < S && t < Tk && !(causal && t > row);
          const float p = expf(live ? __fsub_rn(st[xi], l) : neg_inf());
          dst_[xi] = __fmul_rn(p, __fsub_rn(dpt[xi], d));
          a1[xi] = wg ? dst_[xi] : p;
        }
      }
    // dO^T over dO; once every read of the hand-over is done, the next
    // step's dO fetched
    stage_cols<kDV>(sO, tid, [] {}, [&] {
      if (i + 1 < steps) fetch_o(i + 1);
    });
    wgmma::fence_proxy_async();
    __syncthreads();
    uint32_t ahi[2][4], alo[2][4], shi[2][4], slo[2][4];
    fragments<2>(a1, ahi, alo);
    fragments<2>(dst_, shi, slo);
    // (n128 as two n64 products: one beside the sums spilled)
    const uint32_t b1 = wg ? sQ + 32 * 128 : sO;
    const uint32_t b2 = sQ + (wg ? 160 : 0) * 128;
    accumulate<64, 2>(acc0, ahi, alo, b1, b1 + 64);
    accumulate<64, 2>(acc1, ahi, alo, b1 + 64 * 128, b1 + 64 * 128 + 64);
    accumulate<32, 2>(acc2, shi, slo, b2, b2 + 64);
  }
  float* dkp = dk + (long long)bkv * Tk * dh;
  float* dvp = dv_out + (long long)bkv * Tk * dv;
  store_acc<64>(wg ? dkp : dvp, acc0, t0, Tk, wg ? 32 : 0, wg ? dh : dv,
                1.f, wt);
  store_acc<64>(wg ? dkp : dvp, acc1, t0, Tk, wg ? 96 : 64, wg ? dh : dv,
                1.f, wt);
  store_acc<32>(dkp, acc2, t0, Tk, wg ? 160 : 0, dh, 1.f, wt);
}

// dQ of one 64-row query tile (blockIdx.x: query tile nq - 1 -
// blockIdx.x / BH of head blockIdx.x % BH, the longest first); the notes
// at the top.
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_mla_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dO,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int BH, int H, int G,
                            int S, int Tk, int dh, int dv, float scale,
                            int causal, int vec) {
  using L = Smem;
  constexpr int W = kDH / 2;  // dQ columns a warpgroup
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
  // causal frontier: kv steps strictly above the diagonal are skipped
  const int last = causal ? min(ntk, (q0 + kBM + kBN - 1) / kBN) : ntk;
  const float* kp = k + bkv * Tk * dh;
  const float* vp = v + bkv * Tk * dv;
  auto fetch = [&](int kt) {
    fill_raw<kDH>(rawK, kp, kt * kBN, Tk, dh, vec, tid);
    fill_raw<kDV>(rawV, vp, kt * kBN, Tk, dv, vec, tid);
    wgmma::cp_async_commit();
  };
  if (last > 0) fetch(0);
  stage_resident<kDH>(sQhi, sQlo, q + bh * S * dh, q0, S, dh, vec, scale,
                      tid);
  stage_resident<kDV>(sOhi, sOlo, dO + bh * S * dv, q0, S, dv, vec, 1.f,
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
  for (int kt = 0; kt < last; ++kt) {
    const int t0 = kt * kBN;
    // the step's raw tiles have landed, and every warp is done with the
    // step before's products
    wgmma::cp_async_wait<0>();
    __syncthreads();
    stage_rows<kDH>(sK, rawK, 1.f, tid);
    stage_rows<kDV>(sV, rawV, 1.f, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    if (kt + 1 < last) fetch(kt + 1);
    // warpgroup 0: S = Q K^T over columns 0 .. 159; 1: dP = dO V^T and S
    // over columns 160 .. 191; warpgroup 1 hands over through the stacked
    // V tile, which only its own products read
    float c1[8], c2[8], mine[8], sc[8], dp[8];
    scores(c1, c2, wg ? sOhi : sQhi, wg ? sOlo : sQlo, wg ? sV : sK, sQhi,
           sQlo, sK, wg);
#pragma unroll
    for (int j = 0; j < 8; ++j) mine[j] = wg ? c2[j] : __fadd_rn(c1[j], c2[j]);
    // K^T over K, the hand-over on its barrier
    const uint32_t xchg = base + L::kXchg;
    stage_cols<kDH>(
        sK, tid, [&] { put(c1, mine, xchg, sV, wg, wt); },
        [&] { take(c1, mine, sc, dp, xchg, sV, wg, wt); });
    // dS = P (dP - D[row]), P = exp(S - lse[row]) under the mask
    float ds[8];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int xi = 4 * j + 2 * hh + e, row = r0 + 8 * hh;
          const int t = t0 + 8 * j + 2 * qd + e;
          const bool live = row < S && t < Tk && !(causal && t > row);
          const float p = expf(live ? __fsub_rn(sc[xi], lr[hh]) : neg_inf());
          ds[xi] = __fmul_rn(p, __fsub_rn(dp[xi], dr[hh]));
        }
    uint32_t shi[2][4], slo[2][4];
    fragments<2>(ds, shi, slo);
    wgmma::fence_proxy_async();
    __syncthreads();
    const uint32_t bt = sK + wg * W * 128;
    accumulate<W, 2>(adq, shi, slo, bt, bt + 64);
  }
  store_acc<W>(dq + bh * S * dh, adq, q0, S, wg * W, dh, scale, wt);
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

}  // namespace

// The backward of K9 at MLA's head, float32. q [B, H, S, dh], k [B, KV, T,
// dh], v [B, KV, T, dv], o and dO [B, H, S, dv], lse [B, H, S] (the
// forward's), all row-major float32; delta [B, H, S] float32 scratch; dq,
// dk, dv the gradients, shaped as q, k, v, every element written. scale is
// dh^-0.5 rounded to float32; 128 < dh <= 192, dv <= 128; vec: dh and dv
// multiples of 4 and q, k, v, dO 16-byte aligned. Returns the first nonzero
// cudaGetLastError() of the three launches (0 on success), or
// cudaErrorInvalidValue for head dims outside those.
extern "C" int flash_attention_bwd_f32_mla(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq, void* dk,
    void* dv_out, int B, int H, int KV, int S, int Tk, int dh, int dv,
    float scale, int causal, int vec, void* stream) {
  if (dh <= 128 || dh > kDH || dv > kDV) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *of = (const float*)o,
              *gf = (const float*)dO, *lf = (const float*)lse;
  float *df = (float*)delta, *dqf = (float*)dq, *dkf = (float*)dk,
        *dvf = (float*)dv_out;
  const long long bhs = (long long)B * H * S;
  int err = 0;
  if (bhs > 0) {
    const int wpb = kThreads / 32;
    flash_bwd_dot_kernel<<<(int)((bhs + wpb - 1) / wpb), kThreads, 0, s>>>(
        of, gf, df, bhs, dv);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int ntk = (Tk + kBM - 1) / kBM, nq = (S + kBM - 1) / kBM;
  if (ntk > 0) {
    err = float_io::launch(flash_bwd_mla_dkdv_kernel, B * KV * ntk, kThreads,
                           Smem::kBytes, s, qf, kf, vf, gf, lf,
                           (const float*)df, dkf, dvf, B * KV, H, H / KV, S,
                           Tk, dh, dv, scale, causal, vec);
    if (err) return err;
  }
  if (nq == 0) return 0;
  return float_io::launch(flash_bwd_mla_dq_kernel, B * H * nq, kThreads,
                          Smem::kBytes, s, qf, kf, vf, gf, lf,
                          (const float*)df, dqf, B * H, H, H / KV, S, Tk, dh,
                          dv, scale, causal, vec);
}
