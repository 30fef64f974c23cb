// The backward of K10 for float32 inputs (dk, dv <= 128): the gradients of
// the chunked gated-linear-attention scan
//
//   o_t = sum_{s <= t} (q_t . k_s) e^{g_t - g_s} v_s + e^{g_t} q_t S_{c-1}
//   S_c = e^{g_L} S_{c-1} + sum_s e^{g_L - g_s} k_s^T v_s
//
// (gla.cu; g the within-chunk cumsum of log a, L the chunk) for q, k [BH,
// S, dk], v [BH, S, dv] and g [BH, S], given o's gradient do [BH, S, dv],
// the final state's gradient (or none: zero) and the forward's chunk states
// S_c [BH, nc, dk, dv] (its look-back scratch, kept by the wrapper; the last
// slot the final state). With dS_c the gradient of S_c, chunk c's rows take
//
//   dq_t = sum_{s <= t} (do_t . v_s) e^{g_t - g_s} k_s + e^{g_t} do_t S_{c-1}^T
//   dk_s = sum_{t >= s} (do_t . v_s) e^{g_t - g_s} q_t + e^{g_L - g_s} v_s dS_c^T
//   dv_s = sum_{t >= s} (q_t . k_s) e^{g_t - g_s} do_t + e^{g_L - g_s} k_s dS_c
//   dg_t = q_t . dq_t - k_t . dk_t   (+ <dS_c, S_c> at the chunk's last row)
//
// and the state's gradient runs backwards over the chunks:
//
//   dS_{c-1} = e^{g_L} dS_c + U_c,   U_c = sum_t e^{g_t} q_t^T do_t.
//
// It replaces no TPU kernel: the reference has no backward kernel. Its
// models differentiate the jnp scan (repro/models/ssm.py::gla_chunked) with
// jax.grad. The port's forward runs K10 on the card, so its backward is a
// kernel too.
//
// Design (simple first: CUDA cores, float32 fused multiply-adds). Three
// launches on the stream, one entry point:
//
//   gla_bwd_u_kernel      a block per (head, chunk c >= 1): U_c, from the
//                         chunk's q e^{g} and do staged in 64-row tiles;
//   gla_bwd_scan_kernel   a thread per (head, state element): dS_c for
//                         every chunk, last first, the chain above;
//   gla_bwd_chunk_kernel  a block per (head, chunk): (1) for each 64-row key
//                         tile, K and V in shared memory while the block
//                         walks the query tiles from the diagonal on: A =
//                         (do v^T) e^{g_t - g_s} and then B = (q k^T)
//                         e^{g_t - g_s}, masked, into shared memory, dK +=
//                         A^T Q and dV += B^T dO in registers; then the
//                         state terms through dS_c in shared memory; (2)
//                         for each query tile, dO in shared memory while the
//                         block walks the key tiles up to the diagonal, A
//                         recomputed, dQ += A K, then the inter-chunk term
//                         through S_{c-1}; (3) dg, a warp a row, from the dq
//                         and dk the block wrote.
//
// The chain is a separate launch, not the forward's look-back: it is 2 nc
// float32 operations an element, and a kernel boundary orders it without
// flags. No atomics: two runs are bitwise equal. dq recomputes A rather
// than sum partial dq over key tiles, which would need a [nt, L, dk]
// scratch or atomics. Tiles are 64 x 64 on 256 threads, each holding a 4 x
// 4 block of a score tile or 4 rows x D / 16 columns of an accumulator;
// rows padded to D + 1 floats (no bank conflict on a column walk).
//
// Bound on this card: operations. At zamba2-7B's layer (B 1, 112 heads,
// S 4096, chunk 256, dk = dv = 64) the least work a (head, chunk) is the
// causal half of four L x L products (A, B and their products with q, do;
// dq's A K makes five, ~L (L + 1) (3 dk + 2 dv)) and ten L dk dv
// products (U, the state terms, the inter-chunk term, dg's two dots),
// 56.5 GFLOP in all: 0.84 ms at the 67 TFLOP/s f32 CUDA-core peak. This
// design computes whole 64 x 64 tiles on the diagonal and recomputes A in
// (2). Its bytes (q, k, v, do, g, the states, dq, dk, dv, dg, U and dS
// once) take ~0.25 ms at 3.35 TB/s.
#include <stdint.h>

#include "../../csrc/float_io.cuh"

namespace {

constexpr int kTile = 64;  // rows a query or key tile
constexpr int kThreads = 256;

// Rows [r0, r0 + 64) of the [L, cols] row-major chunk src into the tile dst
// [64][D + 1], zero past L and cols; times e^{g[r]} when eg is not null.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int L, int cols,
                                          const float* eg) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, col = e % D;
    float x = 0.f;
    if (r0 + r < L && col < cols) {
      x = src[(long long)(r0 + r) * cols + col];
      if (eg != nullptr) x = __fmul_rn(x, expf(eg[r0 + r]));
    }
    dst[r * (D + 1) + col] = x;
  }
}

// dst[64] = g[r0 ..] (zero past L).
__device__ __forceinline__ void load_g(float* dst, const float* g, int r0,
                                       int L) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = r0 + r < L ? g[r0 + r] : 0.f;
}

// The [dk, dv] matrix src into dst [D][D + 1], zero past dk and dv (and
// everywhere when src is null).
template <int D>
__device__ __forceinline__ void load_state(float* dst, const float* src,
                                           int dk, int dv) {
  for (int e = threadIdx.x; e < D * D; e += kThreads) {
    const int r = e / D, col = e % D;
    dst[r * (D + 1) + col] =
        src != nullptr && r < dk && col < dv ? src[r * dv + col] : 0.f;
  }
}

// The decayed, masked score tile P[t][s] = (X_t . Y_s) e^{g_t - g_s} for
// query rows t = i0 + ty + 16 a and key rows s = j0 + tx + 16 b (s <= t,
// both below L), else 0: X, Y tiles [64][D + 1], into Ps [64][65].
template <int D>
__device__ __forceinline__ void score_tile(float* Ps, const float* X,
                                           const float* Y, const float* gq,
                                           const float* gk, int i0, int j0,
                                           int L, int tx, int ty) {
  constexpr int LD = D + 1;
  float sc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sc[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = X[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = Y[(tx + 16 * b) * LD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = __fmaf_rn(x[a], y[b], sc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = i0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int s = j0 + tx + 16 * b;
      Ps[(ty + 16 * a) * (kTile + 1) + tx + 16 * b] =
          (s <= t && t < L)
              ? __fmul_rn(sc[a][b],
                          expf(__fsub_rn(gq[ty + 16 * a], gk[tx + 16 * b])))
              : 0.f;
    }
  }
}

// acc[a][cc] += sum_i P[i][ty + 16 a] Y[i][tx + 16 cc] over the 64 rows i
// (P^T Y; P [64][65], Y [64][D + 1]).
template <int D>
__device__ __forceinline__ void accum_pt(float (&acc)[4][D / 16],
                                         const float* Ps, const float* Y,
                                         int tx, int ty) {
#pragma unroll 4
  for (int i = 0; i < kTile; ++i) {
    float p[4], y[D / 16];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = Ps[i * (kTile + 1) + ty + 16 * a];
#pragma unroll
    for (int cc = 0; cc < D / 16; ++cc) y[cc] = Y[i * (D + 1) + tx + 16 * cc];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < D / 16; ++cc)
        acc[a][cc] = __fmaf_rn(p[a], y[cc], acc[a][cc]);
  }
}

// acc[a][cc] += sum_j P[ty + 16 a][j] Y[j][tx + 16 cc] (P Y).
template <int D>
__device__ __forceinline__ void accum_p(float (&acc)[4][D / 16],
                                        const float* Ps, const float* Y,
                                        int tx, int ty) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float p[4], y[D / 16];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = Ps[(ty + 16 * a) * (kTile + 1) + j];
#pragma unroll
    for (int cc = 0; cc < D / 16; ++cc) y[cc] = Y[j * (D + 1) + tx + 16 * cc];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < D / 16; ++cc)
        acc[a][cc] = __fmaf_rn(p[a], y[cc], acc[a][cc]);
  }
}

// out[a][cc] = sum_e X[ty + 16 a][e] M[tx + 16 cc][e] (X M^T), or, with
// TR, sum_e X[ty + 16 a][e] M[e][tx + 16 cc] (X M); X [64][D + 1], M
// [D][D + 1].
template <int D, bool TR>
__device__ __forceinline__ void state_product(float (&out)[4][D / 16],
                                              const float* X, const float* M,
                                              int tx, int ty) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int cc = 0; cc < D / 16; ++cc) out[a][cc] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    float x[4], m[D / 16];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = X[(ty + 16 * a) * (D + 1) + e];
#pragma unroll
    for (int cc = 0; cc < D / 16; ++cc)
      m[cc] = TR ? M[e * (D + 1) + tx + 16 * cc]
                 : M[(tx + 16 * cc) * (D + 1) + e];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < D / 16; ++cc)
        out[a][cc] = __fmaf_rn(x[a], m[cc], out[a][cc]);
  }
}

// Rows r0 + ty + 16 a (below L) of acc + f[a] st (f[a] = e^{w[ty + 16 a]},
// w relative to gl: e^{gl - w} when rel, else e^{w}) to the [L, cols]
// chunk dst, columns tx + 16 cc below cols.
template <int D>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[4][D / 16],
                                           const float (&st)[4][D / 16],
                                           const float* w, float gl, bool rel,
                                           int r0, int L, int cols, int tx,
                                           int ty) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + 16 * a;
    if (r >= L) continue;
    const float f = rel ? expf(__fsub_rn(gl, w[ty + 16 * a]))
                        : expf(w[ty + 16 * a]);
#pragma unroll
    for (int cc = 0; cc < D / 16; ++cc) {
      const int col = tx + 16 * cc;
      if (col < cols)
        dst[(long long)r * cols + col] =
            __fadd_rn(acc[a][cc], __fmul_rn(f, st[a][cc]));
    }
  }
}

template <int D>
constexpr size_t u_smem_bytes() {
  return (size_t)2 * kTile * (D + 1) * sizeof(float);
}

// U_c = sum_t (q_t e^{g_t})^T do_t of chunk c >= 1 into u[bh, c]: block
// (nc - 1) bh + c - 1; the state rows ty + 16 a, columns tx + 16 cc a
// thread.
template <int D>
__global__ void __launch_bounds__(kThreads)
    gla_bwd_u_kernel(const float* __restrict__ q, const float* __restrict__ g,
                     const float* __restrict__ dO, float* __restrict__ u,
                     int S, int L, int dk, int dv) {
  extern __shared__ float sh[];
  constexpr int R = D / 16;
  float* Qs = sh;                   // [64][D + 1], q e^{g}
  float* Os = Qs + kTile * (D + 1);  // [64][D + 1], do
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nc = S / L;
  const int bh = blockIdx.x / (nc - 1), c = 1 + blockIdx.x % (nc - 1);
  const long long row0 = (long long)bh * S + (long long)c * L;
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int cc = 0; cc < R; ++cc) acc[a][cc] = 0.f;
  for (int i0 = 0; i0 < L; i0 += kTile) {
    __syncthreads();  // earlier reads of Qs, Os are done
    load_rows<D>(Qs, q + row0 * dk, i0, L, dk, g + row0);
    load_rows<D>(Os, dO + row0 * dv, i0, L, dv, nullptr);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float x[R], y[R];
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = Qs[i * (D + 1) + ty + 16 * a];
#pragma unroll
      for (int cc = 0; cc < R; ++cc) y[cc] = Os[i * (D + 1) + tx + 16 * cc];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int cc = 0; cc < R; ++cc)
          acc[a][cc] = __fmaf_rn(x[a], y[cc], acc[a][cc]);
    }
  }
  float* up = u + ((long long)bh * nc + c) * dk * dv;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int cc = 0; cc < R; ++cc) {
      const int d = ty + 16 * a, e = tx + 16 * cc;
      if (d < dk && e < dv) up[d * dv + e] = acc[a][cc];
    }
}

// dS_c for every chunk, last first: dS_{nc-1} = the final state's gradient
// (zero when dstate is null), dS_{c-1} = e^{g_L} dS_c + U_c. A thread an
// element (bh, e) of n = BH dk dv.
__global__ void __launch_bounds__(kThreads)
    gla_bwd_scan_kernel(const float* __restrict__ g,
                        const float* __restrict__ u,
                        const float* __restrict__ dstate,
                        float* __restrict__ ds, long long n, int S, int L,
                        int dkv) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long bh = i / dkv, e = i % dkv;
  const int nc = S / L;
  float x = dstate != nullptr ? dstate[i] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long slot = (bh * nc + c) * dkv + e;
    ds[slot] = x;
    if (c > 0)
      x = __fadd_rn(__fmul_rn(expf(g[bh * S + (long long)c * L + L - 1]), x),
                    u[slot]);
  }
}

template <int D>
constexpr size_t chunk_smem_bytes() {
  return (size_t)(4 * kTile * (D + 1) + kTile * (kTile + 1) + D * (D + 1) +
                  2 * kTile + kThreads) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    gla_bwd_chunk_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ states,
                         const float* __restrict__ dO,
                         const float* __restrict__ ds, float* dq, float* dk_out,
                         float* __restrict__ dv_out, float* __restrict__ dg,
                         int S, int L, int dk, int dv) {
  extern __shared__ float sh[];
  constexpr int R = D / 16;
  constexpr int LD = D + 1;
  float* T0 = sh;                 // K (part 1), dO (part 2)
  float* T1 = T0 + kTile * LD;    // V (1), K (2)
  float* T2 = T1 + kTile * LD;    // Q (1), V (2)
  float* T3 = T2 + kTile * LD;    // dO (1)
  float* Ps = T3 + kTile * LD;    // [64][65], a score tile
  float* M = Ps + kTile * (kTile + 1);  // [D][D + 1], dS_c (1), S_{c-1} (2)
  float* gq = M + D * LD;         // [64], g of the query tile
  float* gk = gq + kTile;         // [64], g of the key tile
  float* red = gk + kTile;        // [256], <dS_c, S_c>'s partial sums
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nc = S / L;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const long long row0 = (long long)bh * S + (long long)c * L;
  const float* qp = q + row0 * dk;
  const float* kp = k + row0 * dk;
  const float* vp = v + row0 * dv;
  const float* gp = g + row0;
  const float* op = dO + row0 * dv;
  const long long dkv = (long long)dk * dv;
  const float* dsc = ds + ((long long)bh * nc + c) * dkv;
  const float gl = gp[L - 1];

  // (1) dk, dv, a key tile at a time
  load_state<D>(M, dsc, dk, dv);
  for (int j0 = 0; j0 < L; j0 += kTile) {
    __syncthreads();  // the tile before is done with T0, T1, gk
    load_rows<D>(T0, kp, j0, L, dk, nullptr);
    load_rows<D>(T1, vp, j0, L, dv, nullptr);
    load_g(gk, gp, j0, L);
    float adk[4][R], adv[4][R];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < R; ++cc) adk[a][cc] = adv[a][cc] = 0.f;
    for (int i0 = j0; i0 < L; i0 += kTile) {
      __syncthreads();  // earlier reads of T2, T3, gq, Ps are done
      load_rows<D>(T2, qp, i0, L, dk, nullptr);
      load_rows<D>(T3, op, i0, L, dv, nullptr);
      load_g(gq, gp, i0, L);
      __syncthreads();
      score_tile<D>(Ps, T3, T1, gq, gk, i0, j0, L, tx, ty);  // A
      __syncthreads();
      accum_pt<D>(adk, Ps, T2, tx, ty);  // dK += A^T Q
      __syncthreads();
      score_tile<D>(Ps, T2, T0, gq, gk, i0, j0, L, tx, ty);  // B
      __syncthreads();
      accum_pt<D>(adv, Ps, T3, tx, ty);  // dV += B^T dO
    }
    float st[4][R];
    state_product<D, false>(st, T1, M, tx, ty);  // v_s dS_c^T
    store_rows<D>(dk_out + row0 * dk, adk, st, gk, gl, true, j0, L, dk, tx,
                  ty);
    state_product<D, true>(st, T0, M, tx, ty);  // k_s dS_c
    store_rows<D>(dv_out + row0 * dv, adv, st, gk, gl, true, j0, L, dv, tx,
                  ty);
  }

  // <dS_c, S_c>, added to the chunk's last dg
  {
    const float* sc = states + ((long long)bh * nc + c) * dkv;
    float part = 0.f;
    for (long long e = tid; e < dkv; e += kThreads)
      part = __fmaf_rn(dsc[e], sc[e], part);
    red[tid] = part;
  }

  // (2) dq, a query tile at a time
  __syncthreads();
  load_state<D>(M, c > 0 ? states + ((long long)bh * nc + c - 1) * dkv
                         : nullptr,
                dk, dv);
  for (int i0 = 0; i0 < L; i0 += kTile) {
    __syncthreads();  // earlier reads of T0, gq are done
    load_rows<D>(T0, op, i0, L, dv, nullptr);
    load_g(gq, gp, i0, L);
    float adq[4][R];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < R; ++cc) adq[a][cc] = 0.f;
    for (int j0 = 0; j0 <= i0; j0 += kTile) {
      __syncthreads();  // earlier reads of T1, T2, gk, Ps are done
      load_rows<D>(T1, kp, j0, L, dk, nullptr);
      load_rows<D>(T2, vp, j0, L, dv, nullptr);
      load_g(gk, gp, j0, L);
      __syncthreads();
      score_tile<D>(Ps, T0, T2, gq, gk, i0, j0, L, tx, ty);  // A
      __syncthreads();
      accum_p<D>(adq, Ps, T1, tx, ty);  // dQ += A K
    }
    float st[4][R];
    state_product<D, false>(st, T0, M, tx, ty);  // do_t S_{c-1}^T
    store_rows<D>(dq + row0 * dk, adq, st, gq, 0.f, false, i0, L, dk, tx,
                  ty);
  }

  // (3) dg_t = q_t . dq_t - k_t . dk_t, a warp a row; the block's own
  // stores of dq and dk are visible after the barrier
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s /= 2) {
    if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
    __syncthreads();
  }
  const int warp = tid / 32, lane = tid % 32;
  const float* dqp = dq + row0 * dk;
  const float* dkp = dk_out + row0 * dk;
  for (int t = warp; t < L; t += kThreads / 32) {
    float a = 0.f, b = 0.f;
    for (int d = lane; d < dk; d += 32) {
      a = __fmaf_rn(qp[(long long)t * dk + d], dqp[(long long)t * dk + d], a);
      b = __fmaf_rn(kp[(long long)t * dk + d], dkp[(long long)t * dk + d], b);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
      b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, off));
    }
    if (lane == 0) {
      float x = __fsub_rn(a, b);
      if (t == L - 1) x = __fadd_rn(x, red[0]);
      dg[row0 + t] = x;
    }
  }
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* g, const float* states, const float* dO,
               const float* dstate, float* u, float* ds, float* dq,
               float* dk_out, float* dv_out, float* dg, int BH, int S, int L,
               int dk, int dv, cudaStream_t stream) {
  const int nc = S / L;
  int err = 0;
  if (nc > 1) {
    err = float_io::launch(gla_bwd_u_kernel<D>, BH * (nc - 1), kThreads,
                           u_smem_bytes<D>(), stream, q, g, dO, u, S, L, dk,
                           dv);
    if (err) return err;
  }
  const long long n = (long long)BH * dk * dv;
  gla_bwd_scan_kernel<<<(int)((n + kThreads - 1) / kThreads), kThreads, 0,
                        stream>>>(g, (const float*)u, dstate, ds, n, S, L,
                                  dk * dv);
  err = (int)cudaGetLastError();
  if (err) return err;
  return float_io::launch(gla_bwd_chunk_kernel<D>, BH * nc, kThreads,
                          chunk_smem_bytes<D>(), stream, q, k, v, g, states,
                          dO, (const float*)ds, dq, dk_out, dv_out, dg, S, L,
                          dk, dv);
}

}  // namespace

// The backward of K10, float32. q, k [BH, S, dk], v [BH, S, dv], g [BH, S]
// (the within-chunk cumsum), states [BH, S / L, dk, dv] (S_c after each
// chunk c), dO [BH, S, dv], dstate [BH, dk, dv] or null (zero), all
// row-major float32; u and ds [BH, S / L, dk, dv] float32 scratch; dq, dk,
// dv, dg the gradients, shaped as q, k, v, g, every element written. S a
// multiple of L; dk, dv <= 128. Returns the first nonzero
// cudaGetLastError() of the three launches (0 on success), or
// cudaErrorInvalidValue for a head dim over 128.
extern "C" int gla_scan_bwd_f32(const void* q, const void* k, const void* v,
                                const void* g, const void* states,
                                const void* dO, const void* dstate, void* u,
                                void* ds, void* dq, void* dk_out,
                                void* dv_out, void* dg, int BH, int S, int L,
                                int dk, int dv, void* stream) {
  if (BH == 0 || S == 0 || dk == 0 || dv == 0) return 0;
  const int d = dk > dv ? dk : dv;
  return float_io::dispatch_head_dim(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return launch_bwd<D>((const float*)q, (const float*)k, (const float*)v,
                         (const float*)g, (const float*)states,
                         (const float*)dO, (const float*)dstate, (float*)u,
                         (float*)ds, (float*)dq, (float*)dk_out,
                         (float*)dv_out, (float*)dg, BH, S, L, dk, dv,
                         (cudaStream_t)stream);
  });
}
