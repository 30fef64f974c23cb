// K10: the chunked gated-linear-attention scan (the SSD / mLSTM core),
//
//   S_t = a_t S_{t-1} + k_t^T v_t,   o_t = q_t S_t,
//
// per (batch, head) for q, k [BH, S, dk] and v [BH, S, dv] in float32 or
// bfloat16, with g [BH, S] the within-chunk inclusive cumsum of log a
// (float32, taken by the wrapper); o [BH, S, dv] comes out in v's dtype,
// the final state [BH, dk, dv] in float32. Each chunk of L rows computes
//
//   o_i = sum_{j <= i} (q_i . k_j) e^{g_i - g_j} v_j + e^{g_i} q_i S
//   S  <- e^{g_L} S + sum_j (k_j e^{g_L - g_j})^T v_j
//
// in the reference's order of operations (scores times decay, then the
// intra-chunk sum plus the decayed inter-chunk read; k weighted before the
// state update).
//
// K10 replaces repro/kernels/gla/kernel.py::_gla_kernel (entry
// gla_kernel_call), the Pallas TPU kernel reached through
// repro/kernels/gla/ops.py::gla_scan. There each program holds the whole
// sequence of its head ([S, dk] is 1 MB in f32 at S = 4096) and a
// [chunk, chunk] score tile (256 KB at chunk 256) in VMEM; neither fits the
// 227 KB of shared memory a block may use here, so the [L, L] scores are
// never formed whole.
//
// Design: one block of 256 threads (16 x 16) per (batch, head) streams the
// chunks in order, the [dk, dv] state in float32 in shared memory. A chunk
// runs in 64-row tiles: a query tile is staged and read against the state
// (the inter-chunk term), then against each 64-row key tile up to the
// diagonal: a 64 x 64 block of decayed, masked scores (4 x 4 a thread),
// kept in shared memory only until it is multiplied into the tile's
// values. After the chunk's last tile every thread updates its D/16 x D/16
// block of the state from the chunk's weighted keys and values. Tiles are
// zero-padded to the head dim D of the instantiation (32, 64 or 128, the
// largest dk and dv taken) and to the chunk's end, so any chunk length is
// taken. Every product is an fmaf on CUDA cores.
//
// Bound on this card: bytes. Zamba2-7B's scan (112 heads of dk = dv = 64,
// S = 4096, chunk 256, bf16, B = 1) moves 238.6 MB (q, k, v, o in bf16,
// log a, the state), 0.071 ms at 3.35 TB/s; its 15.1 GFLOP (the causal
// half of each chunk's scores and their products, the inter-chunk read and
// the state update) take 0.015 ms at the 989 TFLOP/s bf16 peak. At B = 1
// the grid is 112 blocks, fewer than the card's 132 SMs, and each SM runs
// 8 warps whose score loops issue a shared-memory load per two fmas:
// latency and the shared-memory pipe bound this first version.
#include "../../csrc/float_io.cuh"

namespace {

constexpr int kTile = 64;      // rows per query or key tile
constexpr int kThreads = 256;  // 16 x 16

using float_io::store;
using float_io::to_f32;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(D * D + 2 * kTile * (D + 1) + kTile * D +
                  kTile * (kTile + 1) + 2 * kTile) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    gla_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ g,
               T* __restrict__ o, float* __restrict__ state_out, int S,
               int L, int dk, int dv) {
  extern __shared__ float sh[];
  constexpr int LD = D + 1;      // row stride of Qs and Ks
  constexpr int LP = kTile + 1;  // row stride of Ps
  constexpr int R = D / 16;      // state rows and output columns a thread
  float* St = sh;                // [D][D], the state
  float* Qs = St + D * D;        // [kTile][LD]
  float* Ks = Qs + kTile * LD;   // [kTile][LD]
  float* Vs = Ks + kTile * LD;   // [kTile][D]
  float* Ps = Vs + kTile * D;    // [kTile][LP], decayed scores of a tile
  float* gq = Ps + kTile * LP;   // [kTile], g of the query tile
  float* gk = gq + kTile;        // [kTile], g of the key tile
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* qp = q + (long long)bh * S * dk;
  const T* kp = k + (long long)bh * S * dk;
  const T* vp = v + (long long)bh * S * dv;
  const float* gp = g + (long long)bh * S;
  T* op = o + (long long)bh * S * dv;

  for (int e = tid; e < D * D; e += kThreads) St[e] = 0.f;
  for (int c0 = 0; c0 < S; c0 += L) {
    const float gl = gp[c0 + L - 1];
    for (int i0 = 0; i0 < L; i0 += kTile) {
      __syncthreads();  // earlier reads of Qs, gq and the state are done
      for (int e = tid; e < kTile * D; e += kThreads) {
        const int r = e / D, c = e % D;
        Qs[r * LD + c] = (i0 + r < L && c < dk)
                             ? to_f32(qp[(long long)(c0 + i0 + r) * dk + c])
                             : 0.f;
      }
      for (int r = tid; r < kTile; r += kThreads)
        gq[r] = i0 + r < L ? gp[c0 + i0 + r] : 0.f;
      __syncthreads();
      // the inter-chunk read q_i S
      float inter[4][R], acc[4][R];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < R; ++c) inter[i][c] = acc[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], sv[R];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int c = 0; c < R; ++c) sv[c] = St[d * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < R; ++c)
            inter[i][c] = __fmaf_rn(qv[i], sv[c], inter[i][c]);
      }
      // the intra-chunk sum, one key tile at a time up to the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        __syncthreads();  // the previous key tile's reads are done
        for (int e = tid; e < kTile * D; e += kThreads) {
          const int r = e / D, c = e % D;
          const bool row = j0 + r < L;
          Ks[r * LD + c] =
              (row && c < dk) ? to_f32(kp[(long long)(c0 + j0 + r) * dk + c])
                              : 0.f;
          Vs[r * D + c] =
              (row && c < dv) ? to_f32(vp[(long long)(c0 + j0 + r) * dv + c])
                              : 0.f;
        }
        for (int r = tid; r < kTile; r += kThreads)
          gk[r] = j0 + r < L ? gp[c0 + j0 + r] : 0.f;
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float qv[4], kv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sc[i][j] = __fmaf_rn(qv[i], kv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ii = i0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = j0 + tx + 16 * j;
            Ps[(ty + 16 * i) * LP + tx + 16 * j] =
                (jj <= ii && jj < L)
                    ? __fmul_rn(sc[i][j], expf(__fsub_rn(gq[ty + 16 * i],
                                                         gk[tx + 16 * j])))
                    : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          float pv[4], vv[R];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + j];
#pragma unroll
          for (int c = 0; c < R; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < R; ++c)
              acc[i][c] = __fmaf_rn(pv[i], vv[c], acc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = i0 + ty + 16 * i;
        if (ii >= L) continue;
        const float eg = expf(gq[ty + 16 * i]);
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int col = tx + 16 * c;
          if (col < dv)
            store(op + (long long)(c0 + ii) * dv + col,
                  __fadd_rn(acc[i][c], __fmul_rn(eg, inter[i][c])));
        }
      }
    }
    // the state update from the chunk's weighted keys and its values
    float upd[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) upd[a][c] = 0.f;
    for (int j0 = 0; j0 < L; j0 += kTile) {
      __syncthreads();  // earlier reads of Ks, Vs are done
      for (int e = tid; e < kTile * D; e += kThreads) {
        const int r = e / D, c = e % D;
        const bool row = j0 + r < L;
        Ks[r * LD + c] =
            (row && c < dk)
                ? __fmul_rn(to_f32(kp[(long long)(c0 + j0 + r) * dk + c]),
                            expf(__fsub_rn(gl, gp[c0 + j0 + r])))
                : 0.f;
        Vs[r * D + c] =
            (row && c < dv) ? to_f32(vp[(long long)(c0 + j0 + r) * dv + c])
                            : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float kv[R], vv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) kv[a] = Ks[j * LD + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < R; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < R; ++c)
            upd[a][c] = __fmaf_rn(kv[a], vv[c], upd[a][c]);
      }
    }
    // every read of the state in this chunk came before the barriers above
    const float egl = expf(gl);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float* s = St + (ty + 16 * a) * D + tx + 16 * c;
        *s = __fadd_rn(__fmul_rn(egl, *s), upd[a][c]);
      }
  }
  float* sp = state_out + (long long)bh * dk * dv;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int d = ty + 16 * a, col = tx + 16 * c;
      if (d < dk && col < dv) sp[d * dv + col] = St[d * D + col];
    }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* g,
             void* o, float* state, int BH, int S, int L, int dk, int dv,
             cudaStream_t stream) {
  return float_io::dispatch_head_dim(dk > dv ? dk : dv, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return float_io::launch(gla_kernel<T, D>, BH, kThreads, smem_bytes<D>(),
                            stream, (const T*)q, (const T*)k, (const T*)v, g,
                            (T*)o, state, S, L, dk, dv);
  });
}

}  // namespace

// K10. q, k [BH, S, dk], v [BH, S, dv], o [BH, S, dv], all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1); g [BH, S] and state [BH, dk, dv]
// float32; S a multiple of L; dk, dv <= 128. Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a head dim
// over 128.
extern "C" int gla_scan_fwd(const void* q, const void* k, const void* v,
                            const float* g, void* o, float* state, int BH,
                            int S, int L, int dk, int dv, int bf16,
                            void* stream) {
  if (BH == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, g, o, state, BH, S, L, dk,
                                        dv, s)
              : dispatch<float>(q, k, v, g, o, state, BH, S, L, dk, dv, s);
}
