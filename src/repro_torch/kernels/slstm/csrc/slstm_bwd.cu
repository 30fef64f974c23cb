// The backward of the sLSTM scan (slstm.cu), float32: the gradients of
// zifo [B, S, 4D], r [4, D] and the initial state (h0, c0, n0, m0) [B, D]
// from those of hs [B, S, D] and of the final state.
//
// Not a TPU kernel, and it replaces none: the reference differentiates its
// jnp recurrence with jax.grad (repro/models/ssm.py:329 slstm_apply,
// _slstm_cell under jax.lax.scan, time chunked under jax.checkpoint). It
// exists because training xlstm-1p3b on the card needs the scan's
// gradient, and eager PyTorch would differentiate a Python loop of ~25
// kernels a step.
//
// Per channel (b, d), walking t = S-1 .. 0 with the carried gradients dh,
// dc, dn, dm of the state after step t: the step's intermediates are
// recomputed from its gates and the previous state (the forward's records
// hs, cs, ns, ms at t - 1; the initial state at t = 0) by slstm_step.cuh's
// forward_step, in the forward's order, so they are bitwise the forward's.
// Then, with g = dhs_t + dh:
//
//   dq = g / max(n, 1)                       (h = q / max(n, 1), q = sg c)
//   dc' = dc + dq sg,  dn' = dn + wn (-(dq h))
//   do = (dq c) (sg (1 - sg))
//   dfg = dc' c_prev + dn' n_prev,  dig = dc' tanh(z) + dn'
//   dz = (dc' ig) (1 - tanh(z)^2)
//   af = dfg fg,  ai = dig ig,  dm' = (dm - af) - ai
//   df = af + wf dm',  di = ai + wi dm'      (m' = max(f + m, i))
//   dh_prev = ((r0 dz + r1 di) + r2 df) + r3 do
//   dc_prev = dc' fg,  dn_prev = dn' fg,  dm_prev = df
//   dr_k += dgate_k h_prev
//
// The tie rule is jax's (lax.max gives half of the gradient to each side
// on a tie): wn is 1 where n > 1, 1/2 where n == 1 and 0 below; wf, wi are
// 1 on the larger side of f + m and i, 1/2 each on a tie. The plain
// version (kernel.py: slstm_scan_backward_plain) takes the same operations
// in the same order, each rounded on its own (-fmad=false; IEEE division),
// so the two agree bitwise.
//
// Bound on this card: bytes. At xlstm-1p3b's training shape (B 1, S 4096,
// D 2048) it reads zifo, the four records and dhs (302 MB) and writes dzifo
// (134 MB): 0.130 ms at 3.35 TB/s. Out of reach: each channel is a chain of
// S dependent steps, and at B 1 only 2048 channels exist.
//
// Design: one thread a channel, the carried gradients and r's four partial
// sums in registers, a block of kThreads channels. Each thread loads kGroup
// steps' inputs (4 gates, the 4 recorded states before the step, dhs) into
// registers a group ahead of the group it computes, so a group's loads are
// in flight while the one before it runs; the recompute of a step hangs off
// the loads alone, not off the carried chain. r's gradient: each channel's
// sum over t, then a second kernel sums the B channels of each (k, d) in
// rising b (none at B 1), so the result is bitwise from run to run without
// atomics.
#include "slstm_step.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels a block: two warps
constexpr int kGroup = 8;     // steps loaded a group ahead

// A step's inputs: its gates, the state before it, and hs's gradient.
struct In {
  float zt, it, ft, ot, h, c, n, m, dhs;
};

struct Ptrs {
  const float *zifo, *h0, *c0, *n0, *m0, *hs, *cs, *ns, *ms, *dhs;
  long long zb, rb;  // (b, 0, d) in zifo's and the records' layout
  int ch, D;
};

__device__ __forceinline__ In load(const Ptrs& p, int t) {
  In x;
  const float* g = p.zifo + p.zb + (long long)t * 4 * p.D;
  x.zt = g[0];
  x.it = g[p.D];
  x.ft = g[2 * p.D];
  x.ot = g[3 * p.D];
  if (t > 0) {
    const long long at = p.rb + (long long)(t - 1) * p.D;
    x.h = p.hs[at];
    x.c = p.cs[at];
    x.n = p.ns[at];
    x.m = p.ms[at];
  } else {
    x.h = p.h0[p.ch];
    x.c = p.c0[p.ch];
    x.n = p.n0[p.ch];
    x.m = p.m0[p.ch];
  }
  x.dhs = p.dhs ? p.dhs[p.rb + (long long)t * p.D] : 0.0f;
  return x;
}

// The half-gradient tie rule of jax's max: the weight of side a of max(a,
// b).
__device__ __forceinline__ float max_weight(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

struct Carry {
  float dh, dc, dn, dm, dr0, dr1, dr2, dr3;
};

// Step t's adjoint: the carried gradients of the state after step t in,
// those of the state before it out; step t's four gate gradients to dz[0],
// dz[D], dz[2 D], dz[3 D].
__device__ __forceinline__ void step_back(Carry& k, const In& x, float r0,
                                          float r1, float r2, float r3,
                                          float* dz, int D) {
  const slstm::Step s =
      slstm::forward_step(r0, r1, r2, r3, x.h, x.c, x.n, x.m, x.zt, x.it,
                          x.ft, x.ot);
  const float wn = max_weight(s.n, 1.0f);
  const float wf = max_weight(s.fm, s.i), wi = max_weight(s.i, s.fm);
  const float g = __fadd_rn(x.dhs, k.dh);
  const float dq = __fdiv_rn(g, s.nc);
  const float dc = __fadd_rn(k.dc, __fmul_rn(dq, s.sg));
  const float dn = __fadd_rn(k.dn, __fmul_rn(wn, -__fmul_rn(dq, s.h)));
  const float d_o =
      __fmul_rn(__fmul_rn(dq, s.c), __fmul_rn(s.sg, __fsub_rn(1.0f, s.sg)));
  const float dfg = __fadd_rn(__fmul_rn(dc, x.c), __fmul_rn(dn, x.n));
  const float dig = __fadd_rn(__fmul_rn(dc, s.tz), dn);
  const float d_z = __fmul_rn(__fmul_rn(dc, s.ig),
                              __fsub_rn(1.0f, __fmul_rn(s.tz, s.tz)));
  const float af = __fmul_rn(dfg, s.fg), ai = __fmul_rn(dig, s.ig);
  const float dm = __fsub_rn(__fsub_rn(k.dm, af), ai);
  const float d_f = __fadd_rn(af, __fmul_rn(wf, dm));
  const float d_i = __fadd_rn(ai, __fmul_rn(wi, dm));
  k.dh = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r0, d_z), __fmul_rn(r1, d_i)),
                __fmul_rn(r2, d_f)),
      __fmul_rn(r3, d_o));
  k.dc = __fmul_rn(dc, s.fg);
  k.dn = __fmul_rn(dn, s.fg);
  k.dm = d_f;
  k.dr0 = __fadd_rn(k.dr0, __fmul_rn(d_z, x.h));
  k.dr1 = __fadd_rn(k.dr1, __fmul_rn(d_i, x.h));
  k.dr2 = __fadd_rn(k.dr2, __fmul_rn(d_f, x.h));
  k.dr3 = __fadd_rn(k.dr3, __fmul_rn(d_o, x.h));
  dz[0] = d_z;
  dz[D] = d_i;
  dz[2 * D] = d_f;
  dz[3 * D] = d_o;
}

__global__ void __launch_bounds__(kThreads) slstm_bwd_kernel(
    const float* __restrict__ zifo, const float* __restrict__ r,
    const float* __restrict__ h0, const float* __restrict__ c0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    const float* __restrict__ hs, const float* __restrict__ cs,
    const float* __restrict__ ns, const float* __restrict__ ms,
    const float* __restrict__ dhs, const float* __restrict__ dh1,
    const float* __restrict__ dc1, const float* __restrict__ dn1,
    const float* __restrict__ dm1, float* __restrict__ dzifo,
    float* __restrict__ part, float* __restrict__ dh0,
    float* __restrict__ dc0, float* __restrict__ dn0,
    float* __restrict__ dm0, int B, int S, int D) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;  // b D + d
  if (ch >= B * D) return;
  const int b = ch / D, d = ch % D;
  const float r0 = r[d], r1 = r[D + d], r2 = r[2 * D + d], r3 = r[3 * D + d];
  const Ptrs p{zifo, h0, c0, n0, m0, hs, cs, ns, ms, dhs,
               (long long)b * S * 4 * D + d, (long long)b * S * D + d, ch, D};
  Carry k{dh1 ? dh1[ch] : 0.0f, dc1 ? dc1[ch] : 0.0f, dn1 ? dn1[ch] : 0.0f,
          dm1 ? dm1[ch] : 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float* dz = dzifo + p.zb;
  // buf: the next group's inputs, steps t, t - 1, ..., t - kGroup + 1
  In buf[kGroup];
  int t = S - 1;
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
    if (t - u >= 0) buf[u] = load(p, t - u);
  while (t >= 0) {
    In cur[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) cur[u] = buf[u];
    const int tn = t - kGroup;
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (tn - u >= 0) buf[u] = load(p, tn - u);
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (t - u >= 0)
        step_back(k, cur[u], r0, r1, r2, r3,
                  dz + (long long)(t - u) * 4 * D, D);
    t = tn;
  }
  dh0[ch] = k.dh;
  dc0[ch] = k.dc;
  dn0[ch] = k.dn;
  dm0[ch] = k.dm;
  const long long bd = (long long)B * D;
  part[ch] = k.dr0;
  part[bd + ch] = k.dr1;
  part[2 * bd + ch] = k.dr2;
  part[3 * bd + ch] = k.dr3;
}

// dr [4, D] from the channels' sums part [4, B, D]: each (k, d) summed over
// b in rising order.
__global__ void slstm_bwd_dr_kernel(const float* __restrict__ part,
                                    float* __restrict__ dr, int B, int D) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;  // k D + d
  if (x >= 4 * D) return;
  const float* p = part + (long long)(x / D) * B * D + x % D;
  float acc = p[0];
  for (int b = 1; b < B; ++b) acc = __fadd_rn(acc, p[(long long)b * D]);
  dr[x] = acc;
}

}  // namespace

// The sLSTM scan's backward, float32, every tensor contiguous: zifo [B, S,
// 4D], r [4, D], the initial state h0, c0, n0, m0 [B, D], the forward's
// hs and records cs, ns, ms [B, S, D]; the gradients dhs [B, S, D] and dh1,
// dc1, dn1, dm1 [B, D] of hs and the final state, each null for zero. Out:
// dzifo [B, S, 4D], dr [4, D], dh0, dc0, dn0, dm0 [B, D]; part [4, B, D] a
// scratch for r's per-channel sums when B > 1 (null at B 1, where they are
// dr itself). Two kernels on `stream` (the second only when B > 1). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int slstm_scan_bwd_f32(
    const float* zifo, const float* r, const float* h0, const float* c0,
    const float* n0, const float* m0, const float* hs, const float* cs,
    const float* ns, const float* ms, const float* dhs, const float* dh1,
    const float* dc1, const float* dn1, const float* dm1, float* dzifo,
    float* part, float* dr, float* dh0, float* dc0, float* dn0, float* dm0,
    int B, int S, int D, void* stream) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (B * D + kThreads - 1) / kThreads;
  slstm_bwd_kernel<<<blocks, kThreads, 0, st>>>(
      zifo, r, h0, c0, n0, m0, hs, cs, ns, ms, dhs, dh1, dc1, dn1, dm1, dzifo,
      B > 1 ? part : dr, dh0, dc0, dn0, dm0, B, S, D);
  if (B > 1) {
    const int err = (int)cudaGetLastError();
    if (err) return err;
    slstm_bwd_dr_kernel<<<(4 * D + 127) / 128, 128, 0, st>>>(part, dr, B, D);
  }
  return (int)cudaGetLastError();
}
