// The sLSTM scan: xLSTM's scalar LSTM with exponential gating and the m
// stabilizer, run over a whole sequence in one launch. Per channel (b, d),
// from zifo [B, S, 4D] (the input projection's z, i, f, o pre-activations,
// in x's dtype), r [4, D] and the state (h, c, n, m) [B, D] in float32,
// step t computes
//
//   z = z_t + r0 h,  i = i_t + r1 h,  f = f_t + r2 h,  o = o_t + r3 h
//   m' = max(f + m, i),  ig = e^{i - m'},  fg = e^{(f + m) - m'}
//   c = fg c + ig tanh(z),  n = fg n + ig
//   h = (sigmoid(o) c) / max(n, 1),  sigmoid(o) = 1 / (1 + e^{-o})
//
// and writes h_t to hs [B, S, D] in zifo's dtype; the final (h, c, n, m)
// come out in float32. The forget pre-activation enters the stabilizer
// raw, and m starts where the caller's state has it (0 from an empty
// cache), as in the reference.
//
// Not a TPU kernel: the reference runs this recurrence as jnp
// (repro/models/ssm.py:301-369, _slstm_cell under jax.lax.scan in
// slstm_apply), which XLA compiles into one device loop. In PyTorch a
// Python loop over the steps would issue ~25 kernels a step.
//
// Design: the recurrence is diagonal (r enters element-wise), so the B D
// channels are independent and each runs its S steps in order: one thread
// a channel, h, c, n, m in registers, the step loop inside the kernel. A
// step's four gate loads are coalesced across d. Each thread keeps the
// next kAhead steps' gate values in flight in a register ring, loaded
// kAhead steps before they are used, so the loads overlap the dependent
// chain of the steps before. Every operation rounds on its own in the
// plain version's order (the library is built with -fmad=false; IEEE
// division), so the kernel can match the plain version bitwise.
//
// Bound on this card: bytes. xlstm-1p3b's prefill (B 4, S 4096, D 2048,
// bf16) reads 268 MB of zifo and writes 67 MB of hs: 0.10 ms at 3.35 TB/s;
// its ~1 GFLOP of f32 work takes 0.015 ms at 67 TFLOP/s. What holds the
// kernel above the bound is the chain: 4096 steps, each waiting on the
// last step's h through three exponentials, a tanh and two divisions,
// with only B D = 8192 threads (128 two-warp blocks, about one an SM) to
// overlap.
#include <stdint.h>

#include "../../csrc/float_io.cuh"

namespace {

constexpr int kThreads = 64;  // a block: two warps of channels
constexpr int kAhead = 8;     // steps whose gate loads are in flight

template <typename T>
__global__ void __launch_bounds__(kThreads)
    slstm_scan_kernel(const T* __restrict__ zifo, const float* __restrict__ r,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0, T* __restrict__ hs,
                      float* __restrict__ h1, float* __restrict__ c1,
                      float* __restrict__ n1, float* __restrict__ m1, int B,
                      int S, int D) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;  // b D + d
  if (ch >= B * D) return;
  const int b = ch / D, d = ch % D;
  const float r0 = r[d], r1 = r[D + d], r2 = r[2 * D + d], r3 = r[3 * D + d];
  float h = h0[ch], c = c0[ch], n = n0[ch], m = m0[ch];
  const long long step = 4LL * D;
  // step t's gate k at zp[t step + k D]
  const T* zp = zifo + (long long)b * S * step + d;
  T* hp = hs + (long long)b * S * D + d;

  T ring[kAhead][4];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (u < S) {
#pragma unroll
      for (int k = 0; k < 4; ++k) ring[u][k] = zp[u * step + k * D];
    }
  }

  for (int t0 = 0; t0 < S; t0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;
      if (t >= S) break;
      const float zt = float_io::to_f32(ring[u][0]);
      const float it = float_io::to_f32(ring[u][1]);
      const float ft = float_io::to_f32(ring[u][2]);
      const float ot = float_io::to_f32(ring[u][3]);
      if (t + kAhead < S) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          ring[u][k] = zp[(long long)(t + kAhead) * step + k * D];
      }
      const float z = __fadd_rn(zt, __fmul_rn(r0, h));
      const float i = __fadd_rn(it, __fmul_rn(r1, h));
      const float f = __fadd_rn(ft, __fmul_rn(r2, h));
      const float o = __fadd_rn(ot, __fmul_rn(r3, h));
      const float fm = __fadd_rn(f, m);
      const float mn = fmaxf(fm, i);
      const float ig = expf(__fsub_rn(i, mn));
      const float fg = expf(__fsub_rn(fm, mn));
      c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, tanhf(z)));
      n = __fadd_rn(__fmul_rn(fg, n), ig);
      const float sg = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-o)));
      h = __fdiv_rn(__fmul_rn(sg, c), fmaxf(n, 1.0f));
      m = mn;
      float_io::store(hp + (long long)t * D, h);
    }
  }
  h1[ch] = h;
  c1[ch] = c;
  n1[ch] = n;
  m1[ch] = m;
}

}  // namespace

// The sLSTM scan. zifo [B, S, 4D] and hs [B, S, D] both float32 (bf16 = 0)
// or both bfloat16 (bf16 = 1); r [4, D] and the states h0, c0, n0, m0 and
// h1, c1, n1, m1 [B, D] float32 (the outputs distinct from the inputs);
// every tensor contiguous. One launch of ceil(B D / 64) blocks of 64
// threads on `stream`. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int slstm_scan_fwd(const void* zifo, const float* r,
                              const float* h0, const float* c0,
                              const float* n0, const float* m0, void* hs,
                              float* h1, float* c1, float* n1, float* m1,
                              int B, int S, int D, int bf16, void* stream) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (B * D + kThreads - 1) / kThreads;
  if (bf16)
    slstm_scan_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)zifo, r, h0, c0, n0, m0, (__nv_bfloat16*)hs,
        h1, c1, n1, m1, B, S, D);
  else
    slstm_scan_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)zifo, r, h0, c0, n0, m0, (float*)hs, h1, c1, n1, m1, B,
        S, D);
  return (int)cudaGetLastError();
}
