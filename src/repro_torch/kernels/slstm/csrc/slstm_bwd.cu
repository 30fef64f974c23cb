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
// Per channel (b, d), step t's adjoint takes the carried gradients dh, dc,
// dn, dm of the state after step t to those of the state before it. The
// step's intermediates are recomputed from its gates and the previous state
// (the forward's records hs, cs, ns, ms at t - 1; the initial state at
// t = 0) by slstm_step.cuh's forward_step, in the forward's order, so they
// are bitwise the forward's. Then, with g = dhs_t + dh:
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
// (134 MB): 0.130 ms at 3.35 TB/s.
//
// Design: a scan over time chunks of the adjoint, which is affine in the
// carry (dh, dc, dn, dm) once the forward's values are fixed. A walk of S
// dependent steps a channel leaves the card idle at B 1 (2048 chains), so
// time is cut into nc chunks of kChunk steps from t = 0, the last one
// partial, and every phase but the second runs a thread a (b, chunk, d):
//
//   1. slstm_bwd_map_kernel, chunks 1 .. nc - 1: walking its chunk in
//      falling t, a thread pushes five carries through adjoint(): the zero
//      carry with dhs (the chunk's affine part aff) and the unit carries
//      dh, dc, dn, dm with dhs = 0 (its columns a0 .. a3); 20 floats out.
//   2. slstm_bwd_carry_kernel, a thread a (b, d): from the final state's
//      gradients x (the carry into chunk nc - 1), for j = nc - 1 .. 1 the
//      carry into chunk j - 1 is, per component i,
//      (((aff_i + x0 a0_i) + x1 a1_i) + x2 a2_i) + x3 a3_i.
//   3. slstm_bwd_replay_kernel: each chunk steps back from its carry
//      through the same adjoint(), writing dzifo and summing r's products
//      from 0 in falling t; chunk 0's thread writes the initial state's
//      gradients. At S <= kChunk this is the sequential walk, bitwise.
//   4. slstm_bwd_dr_kernel: dr [k, d] = for b in rising order, the sum of
//      b's chunk sums in falling t (from chunk nc - 1).
//
// Phases 1 and 3 each read the inputs once (loads coalesced over d; a
// group of steps' inputs in registers a group ahead of the group that
// computes, so a step's recompute hangs off loads already in flight);
// phase 1 does five adjoints a step. No atomics: every sum has one order,
// so the result is bitwise from run to run. One chunk skips phases 1 and
// 2, one (b, chunk) phase 4 (phase 3 then writes dr). kChunk, the blocks
// and the groups were chosen by timing variants on the H100
// (slstm_bwd_ab.py): 64-step chunks keep ~31 warps an SM on the maps at
// B 1, S 4096 (PERF.md §6).
#include "slstm_step.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;        // steps a chunk: kernel.py's K_CHUNK
constexpr int kThreads = 128;     // channels a block in phases 1 and 3
constexpr int kMapGroup = 2;      // steps loaded a group ahead in phase 1
constexpr int kReplayGroup = 4;   // steps loaded a group ahead in phase 3
constexpr int kCarryThreads = 32; // channels a block in phase 2
constexpr int kCarryWindow = 8;   // chunks' maps loaded at once in phase 2
constexpr int kMapRows = 20;      // a map: 5 pushes x (dh, dc, dn, dm)

// A step's inputs: its gates, the state before it, and hs's gradient.
struct In {
  float zt, it, ft, ot, h, c, n, m, dhs;
};

struct Args {
  const float *zifo, *r, *h0, *c0, *n0, *m0, *hs, *cs, *ns, *ms, *dhs;
  const float *dh1, *dc1, *dn1, *dm1;
  float *dzifo, *maps, *carries, *part, *dr, *dh0, *dc0, *dn0, *dm0;
  int B, S, D, nc;
};

// One channel's offsets: (b, 0, d) in zifo's and the records' layout, and
// b D + d.
struct Ptrs {
  long long zb, rb;
  int ch;
};

__device__ __forceinline__ Ptrs channel(const Args& a, int b, int d) {
  return Ptrs{(long long)b * a.S * 4 * a.D + d, (long long)b * a.S * a.D + d,
              b * a.D + d};
}

__device__ __forceinline__ In load(const Args& a, const Ptrs& p, int t) {
  In x;
  const float* g = a.zifo + p.zb + (long long)t * 4 * a.D;
  x.zt = g[0];
  x.it = g[a.D];
  x.ft = g[2 * a.D];
  x.ot = g[3 * a.D];
  if (t > 0) {
    const long long at = p.rb + (long long)(t - 1) * a.D;
    x.h = a.hs[at];
    x.c = a.cs[at];
    x.n = a.ns[at];
    x.m = a.ms[at];
  } else {
    x.h = a.h0[p.ch];
    x.c = a.c0[p.ch];
    x.n = a.n0[p.ch];
    x.m = a.m0[p.ch];
  }
  x.dhs = a.dhs ? a.dhs[p.rb + (long long)t * a.D] : 0.0f;
  return x;
}

// Steps t1 - 1 down to t0 of one channel: f(inputs, t) a step, each group
// of G steps' inputs loaded while the group before it computes.
template <int G, class F>
__device__ __forceinline__ void walk(const Args& a, const Ptrs& p, int t0,
                                     int t1, F&& f) {
  In buf[G];
#pragma unroll
  for (int u = 0; u < G; ++u)
    if (t1 - 1 - u >= t0) buf[u] = load(a, p, t1 - 1 - u);
  for (int t = t1 - 1; t >= t0; t -= G) {
    In cur[G];
#pragma unroll
    for (int u = 0; u < G; ++u) cur[u] = buf[u];
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (t - G - u >= t0) buf[u] = load(a, p, t - G - u);
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (t - u >= t0) f(cur[u], t - u);
  }
}

// The half-gradient tie rule of jax's max: the weight of side a of max(a,
// b).
__device__ __forceinline__ float max_weight(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// A step's forward values and tie weights, recomputed from its inputs.
struct Fwd {
  slstm::Step s;
  float wn, wf, wi;
};

__device__ __forceinline__ Fwd recompute(const In& x, const float* r) {
  Fwd f;
  f.s = slstm::forward_step(r[0], r[1], r[2], r[3], x.h, x.c, x.n, x.m,
                            x.zt, x.it, x.ft, x.ot);
  f.wn = max_weight(f.s.n, 1.0f);
  f.wf = max_weight(f.s.fm, f.s.i);
  f.wi = max_weight(f.s.i, f.s.fm);
  return f;
}

struct Grad {
  float dh, dc, dn, dm;
};

struct Gates {
  float z, i, f, o;
};

// Step t's adjoint: the carried gradients of the state after step t (with
// hs's gradient dhs at t) in, those of the state before it out; returns
// the step's four gate gradients. Affine in (k, dhs).
__device__ __forceinline__ Gates adjoint(Grad& k, const Fwd& f, const In& x,
                                         float dhs, const float* r) {
  const slstm::Step& s = f.s;
  const float g = __fadd_rn(dhs, k.dh);
  const float dq = __fdiv_rn(g, s.nc);
  const float dc = __fadd_rn(k.dc, __fmul_rn(dq, s.sg));
  const float dn = __fadd_rn(k.dn, __fmul_rn(f.wn, -__fmul_rn(dq, s.h)));
  const float d_o =
      __fmul_rn(__fmul_rn(dq, s.c), __fmul_rn(s.sg, __fsub_rn(1.0f, s.sg)));
  const float dfg = __fadd_rn(__fmul_rn(dc, x.c), __fmul_rn(dn, x.n));
  const float dig = __fadd_rn(__fmul_rn(dc, s.tz), dn);
  const float d_z = __fmul_rn(__fmul_rn(dc, s.ig),
                              __fsub_rn(1.0f, __fmul_rn(s.tz, s.tz)));
  const float af = __fmul_rn(dfg, s.fg), ai = __fmul_rn(dig, s.ig);
  const float dm = __fsub_rn(__fsub_rn(k.dm, af), ai);
  const float d_f = __fadd_rn(af, __fmul_rn(f.wf, dm));
  const float d_i = __fadd_rn(ai, __fmul_rn(f.wi, dm));
  k.dh = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r[0], d_z), __fmul_rn(r[1], d_i)),
                __fmul_rn(r[2], d_f)),
      __fmul_rn(r[3], d_o));
  k.dc = __fmul_rn(dc, s.fg);
  k.dn = __fmul_rn(dn, s.fg);
  k.dm = d_f;
  return Gates{d_z, d_i, d_f, d_o};
}

__device__ __forceinline__ void load_r(const Args& a, int d, float* r) {
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = a.r[k * a.D + d];
}

// Phase 1: chunk blockIdx.y + 1's map for channels (blockIdx.z, d). The
// map's row 4 p + i is push p's component i: push 0 the zero carry with
// dhs, push k + 1 the unit carry k with dhs = 0.
__global__ void __launch_bounds__(kThreads)
    slstm_bwd_map_kernel(const __grid_constant__ Args a) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= a.D) return;
  const int j = blockIdx.y + 1, b = blockIdx.z;
  float r[4];
  load_r(a, d, r);
  Grad v[5];
#pragma unroll
  for (int p = 0; p < 5; ++p) v[p] = Grad{0.0f, 0.0f, 0.0f, 0.0f};
  v[1].dh = v[2].dc = v[3].dn = v[4].dm = 1.0f;
  walk<kMapGroup>(a, channel(a, b, d), j * kChunk, min(a.S, (j + 1) * kChunk),
                  [&](const In& x, int) {
                    const Fwd f = recompute(x, r);
                    adjoint(v[0], f, x, x.dhs, r);
#pragma unroll
                    for (int p = 1; p < 5; ++p) adjoint(v[p], f, x, 0.0f, r);
                  });
  float* out = a.maps + (long long)(b * a.nc + j) * kMapRows * a.D + d;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    out[(4 * p) * a.D] = v[p].dh;
    out[(4 * p + 1) * a.D] = v[p].dc;
    out[(4 * p + 2) * a.D] = v[p].dn;
    out[(4 * p + 3) * a.D] = v[p].dm;
  }
}

// Phase 2: the carry into each chunk but the last, for channel (b, d),
// the maps read kCarryWindow chunks at a time (their loads in flight
// together: the walk itself is a few operations a chunk).
__global__ void __launch_bounds__(kCarryThreads)
    slstm_bwd_carry_kernel(const __grid_constant__ Args a) {
  const int ch = blockIdx.x * kCarryThreads + threadIdx.x;  // b D + d
  if (ch >= a.B * a.D) return;
  const int b = ch / a.D, d = ch % a.D;
  float x[4] = {a.dh1 ? a.dh1[ch] : 0.0f, a.dc1 ? a.dc1[ch] : 0.0f,
                a.dn1 ? a.dn1[ch] : 0.0f, a.dm1 ? a.dm1[ch] : 0.0f};
  for (int j0 = a.nc - 1; j0 >= 1; j0 -= kCarryWindow) {
    float mp[kCarryWindow][kMapRows];
#pragma unroll
    for (int w = 0; w < kCarryWindow; ++w)
      if (j0 - w >= 1) {
        const float* src =
            a.maps + (long long)(b * a.nc + j0 - w) * kMapRows * a.D + d;
#pragma unroll
        for (int q = 0; q < kMapRows; ++q) mp[w][q] = src[q * a.D];
      }
#pragma unroll
    for (int w = 0; w < kCarryWindow; ++w)
      if (j0 - w >= 1) {
        float y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          y[i] = __fadd_rn(
              __fadd_rn(
                  __fadd_rn(__fadd_rn(mp[w][i], __fmul_rn(x[0], mp[w][4 + i])),
                            __fmul_rn(x[1], mp[w][8 + i])),
                  __fmul_rn(x[2], mp[w][12 + i])),
              __fmul_rn(x[3], mp[w][16 + i]));
        float* dst =
            a.carries + (long long)(b * a.nc + j0 - w - 1) * 4 * a.D + d;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = y[i];
          dst[i * a.D] = y[i];
        }
      }
  }
}

// Phase 3: chunk blockIdx.y replayed for channels (blockIdx.z, d) from its
// carry: dzifo, r's sums over the chunk, and at chunk 0 the initial
// state's gradients.
__global__ void __launch_bounds__(kThreads)
    slstm_bwd_replay_kernel(const __grid_constant__ Args a) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= a.D) return;
  const int j = blockIdx.y, b = blockIdx.z, ch = b * a.D + d;
  float r[4];
  load_r(a, d, r);
  Grad k;
  if (j == a.nc - 1) {
    k = Grad{a.dh1 ? a.dh1[ch] : 0.0f, a.dc1 ? a.dc1[ch] : 0.0f,
             a.dn1 ? a.dn1[ch] : 0.0f, a.dm1 ? a.dm1[ch] : 0.0f};
  } else {
    const float* src = a.carries + (long long)(b * a.nc + j) * 4 * a.D + d;
    k = Grad{src[0], src[a.D], src[2 * a.D], src[3 * a.D]};
  }
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const Ptrs p = channel(a, b, d);
  float* dz = a.dzifo + p.zb;
  walk<kReplayGroup>(a, p, j * kChunk, min(a.S, (j + 1) * kChunk),
                     [&](const In& x, int t) {
                       const Fwd f = recompute(x, r);
                       const Gates g = adjoint(k, f, x, x.dhs, r);
                       sum[0] = __fadd_rn(sum[0], __fmul_rn(g.z, x.h));
                       sum[1] = __fadd_rn(sum[1], __fmul_rn(g.i, x.h));
                       sum[2] = __fadd_rn(sum[2], __fmul_rn(g.f, x.h));
                       sum[3] = __fadd_rn(sum[3], __fmul_rn(g.o, x.h));
                       float* o = dz + (long long)t * 4 * a.D;
                       o[0] = g.z;
                       o[a.D] = g.i;
                       o[2 * a.D] = g.f;
                       o[3 * a.D] = g.o;
                     });
  if (j == 0) {
    a.dh0[ch] = k.dh;
    a.dc0[ch] = k.dc;
    a.dn0[ch] = k.dn;
    a.dm0[ch] = k.dm;
  }
  if (a.B * a.nc == 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) a.dr[q * a.D + d] = sum[q];
  } else {
    float* dst = a.part + (long long)(b * a.nc + j) * 4 * a.D + d;
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q * a.D] = sum[q];
  }
}

// Phase 4: dr [4, D] from the chunks' sums part [B, nc, 4, D]: for each
// (k, d), b's sums added in falling chunk order, then the b's in rising
// order.
__global__ void slstm_bwd_dr_kernel(const float* __restrict__ part,
                                    float* __restrict__ dr, int B, int nc,
                                    int D) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;  // k D + d
  if (x >= 4 * D) return;
  const long long step = 4LL * D;  // one chunk in part
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* p = part + (long long)b * nc * step + x;
    float s = p[(nc - 1) * step];
#pragma unroll 8
    for (int j = nc - 2; j >= 0; --j) s = __fadd_rn(s, p[j * step]);
    acc = b ? __fadd_rn(acc, s) : s;
  }
  dr[x] = acc;
}

}  // namespace

// The sLSTM scan's backward, float32, every tensor contiguous: zifo [B, S,
// 4D], r [4, D], the initial state h0, c0, n0, m0 [B, D], the forward's
// hs and records cs, ns, ms [B, S, D]; the gradients dhs [B, S, D] and dh1,
// dc1, dn1, dm1 [B, D] of hs and the final state, each null for zero. Out:
// dzifo [B, S, 4D], dr [4, D], dh0, dc0, dn0, dm0 [B, D]; scratch: 28 B nc
// D floats (nc = ceil(S / kChunk): the maps [B, nc, 20, D], the carries
// and r's chunk sums [B, nc, 4, D] each). `phases` is a mask of the
// phases to launch (bit p - 1 for phase p; 15 for the whole backward, one
// bit to time a phase alone on what the phases before it left in
// scratch). Up to four kernels on `stream`. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int slstm_scan_bwd_f32(
    const float* zifo, const float* r, const float* h0, const float* c0,
    const float* n0, const float* m0, const float* hs, const float* cs,
    const float* ns, const float* ms, const float* dhs, const float* dh1,
    const float* dc1, const float* dn1, const float* dm1, float* dzifo,
    float* scratch, float* dr, float* dh0, float* dc0, float* dn0,
    float* dm0, int B, int S, int D, int phases, void* stream) {
  if (B == 0 || D == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + kChunk - 1) / kChunk;
  const long long rows = (long long)B * nc * D;
  const Args a{zifo, r, h0, c0, n0, m0, hs, cs, ns, ms, dhs, dh1, dc1, dn1,
               dm1, dzifo, scratch, scratch + kMapRows * rows,
               scratch + (kMapRows + 4) * rows, dr, dh0, dc0, dn0, dm0,
               B, S, D, nc};
  const int xb = (D + kThreads - 1) / kThreads;
  int err = 0;
  if ((phases & 1) && nc > 1) {
    slstm_bwd_map_kernel<<<dim3(xb, nc - 1, B), kThreads, 0, st>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if ((phases & 2) && nc > 1) {
    slstm_bwd_carry_kernel<<<(B * D + kCarryThreads - 1) / kCarryThreads,
                             kCarryThreads, 0, st>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (phases & 4) {
    slstm_bwd_replay_kernel<<<dim3(xb, nc, B), kThreads, 0, st>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if ((phases & 8) && B * nc > 1)
    slstm_bwd_dr_kernel<<<(4 * D + 127) / 128, 128, 0, st>>>(a.part, dr, B,
                                                              nc, D);
  return (int)cudaGetLastError();
}
