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
// Design: CUDA cores, float32 fused multiply-adds, every product of a
// step added straight into float32 sums (the tensor cores' sums truncate
// and drift past the 1e-4 check over thousands of query rows). The
// split-TF32 design of flash_f32_bwd.cu takes 230,912 bytes of shared
// memory a block at D 128 and has no room for 192 columns; this one takes
// 203,264 at (192, 128). Three launches on the stream, one entry point:
//
//   flash_bwd_mla_dot_kernel   D = rowsum(do * o), a warp a row;
//   flash_bwd_mla_dkdv_kernel  a block per (b, kv head, 64-row kv tile),
//                              the tiles with the most query tiles under
//                              the causal frontier first; K and V stay in
//                              shared memory while the block walks its G
//                              query heads in order and, for each, the
//                              64-row query tiles from the diagonal on: P
//                              and dS of the tile pair into shared memory,
//                              then dV += P^T dO and dK += dS^T Q in
//                              registers. So each kv head's dk and dv sum
//                              over its query heads in one fixed order, in
//                              one block: no atomics, two runs bitwise
//                              equal;
//   flash_bwd_mla_dq_kernel    a block per (b, head, 64-row query tile); Q
//                              and dO stay in shared memory while the block
//                              walks the kv tiles up to the frontier: dS (P
//                              recomputed) into shared memory transposed,
//                              then dQ += dS K in registers.
//
// dq recomputes P and dP rather than sum partial dq over kv tiles, which
// would need atomics or a [kv tiles, B, H, S, dh] scratch. Every product
// is a 64 x 64 x D tile product on 256 threads, each holding a 4 x 4 block
// of the tile's scores or 4 rows x D / 16 columns of an accumulator, its
// operands read as 16-byte vectors from rows padded to D + 4 floats (no
// bank conflict between the 8 lanes of a vector load's phase).
//
// Bound on this card: operations. The least work is 2 (3 dh + 2 dv) FLOPs
// a query-key pair under the mask (s, dP, dV, dK, dQ; P recomputed once);
// at deepseek-v2's layer (B 1, H = KV = 128, S = T = 4096, dh 192, dv 128)
// 1.79 TFLOP: 10.8 ms as three TF32 products at 494.7 TFLOP/s, 26.7 ms at
// the 67 TFLOP/s float32 CUDA-core peak this design runs on. It does 2 (4
// dh + 3 dv) a pair (s and dP twice). Its bytes (q, k, v, o, do, lse, dq,
// dk, dv once) take 0.4 ms at 3.35 TB/s.
#include <stdint.h>

#include "../../csrc/float_io.cuh"

namespace {

constexpr int kB = 64;  // rows of a query or kv tile
constexpr int kThreads = 256;
constexpr int kPS = kB + 4;  // padded row of a [64, 64] score tile
constexpr int kDH = 192;     // q and k columns, zero-padded past dh
constexpr int kDV = 128;     // v columns, zero-padded past dv

// Shared-memory floats of one [64, D] operand tile (rows padded to D + 4).
template <int D>
__host__ __device__ constexpr int tile_floats() {
  return kB * (D + 4);
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

__device__ __forceinline__ float4 mul4(float4 x, float a) {
  return make_float4(__fmul_rn(x.x, a), __fmul_rn(x.y, a), __fmul_rn(x.z, a),
                     __fmul_rn(x.w, a));
}

// Rows [r0, r0 + 64) of the [nrows, cols] matrix src into the padded tile
// dst [64, D + 4], times `scale` unless it is 1, zero past the edges.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int nrows, int cols,
                                          bool vec, float scale) {
  constexpr int C4 = D / 4;
  for (int u = threadIdx.x; u < kB * C4; u += kThreads) {
    const int r = u / C4, c4 = u % C4;
    float4 x = load4(src, r0 + r, nrows, 4 * c4, cols, vec);
    if (scale != 1.f) x = mul4(x, scale);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + 4 * c4) = x;
  }
}

// Rows [r0, r0 + 64) of a [nrows] vector into dst[64], zero past nrows.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int nrows) {
  for (int u = threadIdx.x; u < kB; u += kThreads)
    dst[u] = r0 + u < nrows ? src[r0 + u] : 0.f;
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// s[a][b] = A[i_a] . Bm[j_b] over D columns, for the thread's rows i_a =
// tx + 16 a of A and j_b = ty + 16 b of Bm (tiles [64, D + 4]).
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* A,
                                       const float* Bm, int tx, int ty) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(A + (tx + 16 * a) * LD + c);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      y[b] = *reinterpret_cast<const float4*>(Bm + (ty + 16 * b) * LD + c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dot4(s[a][b], x[a], y[b]);
  }
}

// p = exp(s - lse) under the mask (query q0 + i_a below S, key t0 + j_b
// below T and, causal, t <= s), else 0; ds = p (dp - D). In place: s
// becomes p, dp becomes ds.
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* sL, const float* sD,
                                      int q0, int t0, int S, int Tk,
                                      int causal, int tx, int ty) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = tx + 16 * a, row = q0 + i;
    const float lse = sL[i], d = sD[i];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int t = t0 + ty + 16 * b;
      const bool live = row < S && t < Tk && !(causal && t > row);
      const float p = live ? expf(__fsub_rn(s[a][b], lse)) : 0.f;
      s[a][b] = p;
      dp[a][b] = __fmul_rn(p, __fsub_rn(dp[a][b], d));
    }
  }
}

// acc[r][k] (+)= sum_i X[i][4 jg + r] * Y[i][4 cg + 64 k ..] over the 64
// rows i: X a [64, kPS] score tile, Y a [64, D + 4] operand tile; the
// thread's 4 rows and D / 16 columns of a [64, D] product X^T Y.
template <int D>
__device__ __forceinline__ void accum_t(float4 (&acc)[4][D / 64],
                                        const float* X, const float* Y,
                                        int jg, int cg) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int i = 0; i < kB; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(X + i * kPS + 4 * jg);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < D / 64; ++k) {
      const float4 y =
          *reinterpret_cast<const float4*>(Y + i * LD + 4 * cg + 64 * k);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][k].x = __fmaf_rn(xs[r], y.x, acc[r][k].x);
        acc[r][k].y = __fmaf_rn(xs[r], y.y, acc[r][k].y);
        acc[r][k].z = __fmaf_rn(xs[r], y.z, acc[r][k].z);
        acc[r][k].w = __fmaf_rn(xs[r], y.w, acc[r][k].w);
      }
    }
  }
}

// Rows 4 jg + r of acc (times `scale` unless it is 1) to the [nrows, cols]
// matrix dst from row r0, columns 4 cg + 64 k .., dropping what lies past
// the edges.
template <int D>
__device__ __forceinline__ void store_acc(float* dst,
                                          const float4 (&acc)[4][D / 64],
                                          int r0, int nrows, int cols, int jg,
                                          int cg, float scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * jg + r;
    if (row >= nrows) continue;
#pragma unroll
    for (int k = 0; k < D / 64; ++k) {
      float4 x = acc[r][k];
      if (scale != 1.f) x = mul4(x, scale);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const int c0 = 4 * cg + 64 * k;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + e < cols) dst[(long long)row * cols + c0 + e] = xs[e];
    }
  }
}

// D[row] = sum_c do[row, c] o[row, c], a warp a row of BHS rows: lane l
// sums columns l, l + 32, .., then a butterfly over the warp.
__global__ void __launch_bounds__(kThreads)
    flash_bwd_mla_dot_kernel(const float* __restrict__ o,
                             const float* __restrict__ dO,
                             float* __restrict__ delta, long long BHS,
                             int dv) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
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

constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * tile_floats<kDH>() + 2 * tile_floats<kDV>() +
                          2 * kB * kPS + 2 * kB);
}
static_assert(dkdv_smem() <= 232448, "an SM's shared memory");

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
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sQ = sK + tile_floats<kDH>();
  float* sV = sQ + tile_floats<kDH>();
  float* sO = sV + tile_floats<kDV>();  // dO
  float* sP = sO + tile_floats<kDV>();
  float* sS = sP + kB * kPS;            // dS
  float* sL = sS + kB * kPS;
  float* sD = sL + kB;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // scores: rows tx + 16 a, ty + 16 b
  const int jg = tid % 16, cg = tid / 16;  // accumulators: rows 4 jg + r
  const int kt = (int)(blockIdx.x / BKV);  // the longest tiles first
  const int bkv = (int)(blockIdx.x % BKV);
  const int KV = H / G, b = bkv / KV, kvh = bkv % KV;
  const int t0 = kt * kB;
  const int nq = (S + kB - 1) / kB;
  load_tile<kDH>(sK, k + (long long)bkv * Tk * dh, t0, Tk, dh, vec, 1.f);
  load_tile<kDV>(sV, v + (long long)bkv * Tk * dv, t0, Tk, dv, vec, 1.f);
  float4 adk[4][kDH / 64], adv[4][kDV / 64];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < kDH / 64; ++c)
      adk[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kDV / 64; ++c)
      adv[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // query tiles from the one holding row t0 (the causal frontier)
  const int qstart = causal ? t0 / kB : 0;
  for (int g = 0; g < G; ++g) {
    const long long bh = (long long)b * H + kvh * G + g;
    const float* qp = q + bh * S * dh;
    const float* op = dO + bh * S * dv;
    for (int qi = qstart; qi < nq; ++qi) {
      const int q0 = qi * kB;
      __syncthreads();  // the tile pair before is done with sQ .. sS
      load_tile<kDH>(sQ, qp, q0, S, dh, vec, scale);
      load_tile<kDV>(sO, op, q0, S, dv, vec, 1.f);
      load_vec(sL, lse + bh * S, q0, S);
      load_vec(sD, delta + bh * S, q0, S);
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<kDH>(s, sQ, sK, tx, ty);
      scores<kDV>(dp, sO, sV, tx, ty);
      probs(s, dp, sL, sD, q0, t0, S, Tk, causal, tx, ty);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          sP[(tx + 16 * a) * kPS + ty + 16 * bb] = s[a][bb];
          sS[(tx + 16 * a) * kPS + ty + 16 * bb] = dp[a][bb];
        }
      __syncthreads();
      accum_t<kDV>(adv, sP, sO, jg, cg);
      accum_t<kDH>(adk, sS, sQ, jg, cg);
    }
  }
  store_acc<kDH>(dk + (long long)bkv * Tk * dh, adk, t0, Tk, dh, jg, cg, 1.f);
  store_acc<kDV>(dv_out + (long long)bkv * Tk * dv, adv, t0, Tk, dv, jg, cg,
                 1.f);
}

constexpr size_t dq_smem() {
  return sizeof(float) * (2 * tile_floats<kDH>() + 2 * tile_floats<kDV>() +
                          kB * kPS + 2 * kB);
}

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
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + tile_floats<kDH>();
  float* sO = sK + tile_floats<kDH>();  // dO
  float* sV = sO + tile_floats<kDV>();
  float* sT = sV + tile_floats<kDV>();  // dS transposed, [kv row][query row]
  float* sL = sT + kB * kPS;
  float* sD = sL + kB;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ig = tid % 16, cg = tid / 16;
  const int nq = (S + kB - 1) / kB;
  const int qi = nq - 1 - (int)(blockIdx.x / BH);  // the longest tiles first
  const long long bh = blockIdx.x % BH;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const long long bkv = (long long)b * (H / G) + h / G;
  const int q0 = qi * kB;
  const int ntk = (Tk + kB - 1) / kB;
  const int last = causal ? min(ntk, (q0 + kB + kB - 1) / kB) : ntk;
  load_tile<kDH>(sQ, q + bh * S * dh, q0, S, dh, vec, scale);
  load_tile<kDV>(sO, dO + bh * S * dv, q0, S, dv, vec, 1.f);
  load_vec(sL, lse + bh * S, q0, S);
  load_vec(sD, delta + bh * S, q0, S);
  float4 adq[4][kDH / 64];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kDH / 64; ++c)
      adq[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* kp = k + bkv * Tk * dh;
  const float* vp = v + bkv * Tk * dv;
  for (int kt = 0; kt < last; ++kt) {
    const int t0 = kt * kB;
    __syncthreads();  // the tile before is done with sK, sV, sT
    load_tile<kDH>(sK, kp, t0, Tk, dh, vec, 1.f);
    load_tile<kDV>(sV, vp, t0, Tk, dv, vec, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<kDH>(s, sQ, sK, tx, ty);
    scores<kDV>(dp, sO, sV, tx, ty);
    probs(s, dp, sL, sD, q0, t0, S, Tk, causal, tx, ty);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        sT[(ty + 16 * bb) * kPS + tx + 16 * a] = dp[a][bb];
    __syncthreads();
    accum_t<kDH>(adq, sT, sK, ig, cg);
  }
  store_acc<kDH>(dq + bh * S * dh, adq, q0, S, dh, ig, cg, scale);
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
  const int wpb = kThreads / 32;
  int err = 0;
  if (bhs > 0) {
    flash_bwd_mla_dot_kernel<<<(int)((bhs + wpb - 1) / wpb), kThreads, 0,
                               s>>>(of, gf, df, bhs, dv);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int ntk = (Tk + kB - 1) / kB, nq = (S + kB - 1) / kB;
  if (ntk > 0) {
    err = float_io::launch(flash_bwd_mla_dkdv_kernel, B * KV * ntk, kThreads,
                           dkdv_smem(), s, qf, kf, vf, gf, lf,
                           (const float*)df, dkf, dvf, B * KV, H, H / KV, S,
                           Tk, dh, dv, scale, causal, vec);
    if (err) return err;
  }
  if (nq == 0) return 0;
  return float_io::launch(flash_bwd_mla_dq_kernel, B * H * nq, kThreads,
                          dq_smem(), s, qf, kf, vf, gf, lf, (const float*)df,
                          dqf, B * H, H, H / KV, S, Tk, dh, dv, scale, causal,
                          vec);
}
