// K9 for float32 inputs: causal (or not) GQA flash-attention forward on
// CUDA cores,
//
//   o[b, h, s] = sum_t softmax_t(q[b, h, s] . k[b, h / G, t] * dh^-0.5)
//                * v[b, h / G, t],         G = H / KV,
//
// for q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv] and o [B, H, S,
// dv] in float32. Bfloat16 inputs go to flash_wgmma.cu, on the tensor
// cores; float32 stays here, since TF32 products keep about three decimal
// digits, too few for the float32 check (1e-5).
//
// K9 replaces repro/kernels/attention/kernel.py::_flash_kernel (entry
// flash_attention_kernel_call), the Pallas TPU kernel reached through
// repro/kernels/attention/ops.py::flash_attention. Its conventions are
// kept: q is scaled (rounded to float32) before the dot; masked scores are
// -1e30, not -inf; the causal mask is t <= s, both counted from 0 (top-left
// aligned); the online softmax keeps (m, l, acc) per row, m starting at
// -1e30, and rescales by exp(m - m_new) once per kv tile; the row sum is
// clamped at 1e-30; kv tiles past the causal frontier are skipped.
//
// Design: one block of 256 threads per (b, h, 64-row query tile), the tiles
// with the most kv tiles under the frontier launched first. The scaled q
// tile stays in shared memory; each 64-row kv tile of kv head h / G is
// staged into shared memory (zero-padded to the head dim D of the
// instantiation: 32, 64 or 128, the largest dh and dv taken). The
// 16 x 16 threads each own a 4 x 4 block of the 64 x 64 score tile (rows
// ty + 16 i, columns tx + 16 j) and a 4 x D/16 block of the output rows'
// accumulators; a row's max and sum are reduced over the 16 lanes that
// share it with shuffles. Every dot product is written out as fmaf on CUDA
// cores.
//
// Bound on this card: operations. Granite-20B's causal prefill layer
// (H = 48, KV = 1, S = T = 4096, dh = dv = 128) needs 206.2 GFLOP (S (S +
// 1) / 2 query-key pairs, 4 dh FLOPs each): 3.08 ms at the 67 TFLOP/s
// float32 CUDA-core peak. This version issues two shared-memory loads per
// four fmas in the score loop, so the shared-memory pipe, not the fma
// pipe, bounds it.
#include "../../csrc/float_io.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNeg = -1.0e30f;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1)) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int BH,
                 int H, int G, int S, int Tk, int dh, int dv, float scale,
                 int causal) {
  extern __shared__ float sh[];
  constexpr int LD = D + 1;    // row stride of Qs and Ks (no bank conflict)
  constexpr int LP = kBK + 1;  // row stride of Ps
  constexpr int RC = D / 16;   // output columns per thread
  float* Qs = sh;              // [kBQ][LD], scaled q
  float* Ks = Qs + kBQ * LD;   // [kBK][LD]
  float* Vs = Ks + kBK * LD;   // [kBK][D]
  float* Ps = Vs + kBK * D;    // [kBQ][LP], probabilities of the tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nq = (S + kBQ - 1) / kBQ;
  const int qi = nq - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;  // b * KV + h / G
  const float* qp = q + (long long)bh * S * dh;
  const float* kp = k + (long long)kvh * Tk * dh;
  const float* vp = v + (long long)kvh * Tk * dv;
  float* op = o + (long long)bh * S * dv;
  const int q0 = qi * kBQ;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[r * LD + c] = (q0 + r < S && c < dh)
                         ? __fmul_rn(qp[(long long)(q0 + r) * dh + c],
                                     scale)
                         : 0.f;
  }
  float m[4], l[4], acc[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[i][c] = 0.f;
  }
  const int ntk = (Tk + kBK - 1) / kBK;
  // causal frontier: kv tiles strictly above the diagonal are skipped
  const int last =
      causal ? min(ntk, (q0 + kBQ + kBK - 1) / kBK) : ntk;
  for (int kt = 0; kt < last; ++kt) {
    const int t0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of Ks, Vs, Ps are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool row = t0 + r < Tk;
      Ks[r * LD + c] =
          (row && c < dh) ? kp[(long long)(t0 + r) * dh + c] : 0.f;
      Vs[r * D + c] =
          (row && c < dv) ? vp[(long long)(t0 + r) * dv + c] : 0.f;
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
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
      const int si = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ti = t0 + tx + 16 * j;
        if (causal && ti > si) sc[i][j] = kNeg;
        if (ti < Tk) mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(__fsub_rn(m[i], mn));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a row of the ragged last tile past T contributes nothing
        const float p =
            t0 + tx + 16 * j < Tk ? expf(__fsub_rn(sc[i][j], mn)) : 0.f;
        rs = __fadd_rn(rs, p);
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[RC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + j];
#pragma unroll
      for (int c = 0; c < RC; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < RC; ++c)
          acc[i][c] = __fmaf_rn(pv[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int col = tx + 16 * c;
      if (col < dv)
        op[(long long)r * dv + col] = __fdiv_rn(acc[i][c], den);
    }
  }
}

int dispatch(const float* q, const float* k, const float* v, float* o,
             int B, int H, int KV, int S, int Tk, int dh, int dv,
             float scale, int causal, cudaStream_t stream) {
  return float_io::dispatch_head_dim(dh > dv ? dh : dv, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return float_io::launch(
        flash_kernel<D>, B * H * ((S + kBQ - 1) / kBQ), kThreads,
        smem_bytes<D>(), stream, q, k, v, o, B * H, H, H / KV, S, Tk, dh,
        dv, scale, causal);
  });
}

}  // namespace

// K9, float32. q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv], o [B,
// H, S, dv], row-major float32; scale is dh^-0.5 rounded to float32; dh,
// dv <= 128. Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for a head dim over 128.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int KV, int S, int Tk, int dh, int dv,
                                   float scale, int causal, void* stream) {
  if (B == 0 || H == 0 || S == 0 || dv == 0) return 0;
  return dispatch((const float*)q, (const float*)k, (const float*)v,
                  (float*)o, B, H, KV, S, Tk, dh, dv, scale, causal,
                  (cudaStream_t)stream);
}
