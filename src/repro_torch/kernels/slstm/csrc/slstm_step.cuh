// One step of the sLSTM recurrence for one channel, shared by the scan
// (slstm.cu) and its backward (slstm_bwd.cu), which recomputes each step's
// intermediates from the recorded previous state. From the gate
// pre-activations z_t, i_t, f_t, o_t, r (r0, r1, r2, r3) and the state
// (h, c, n, m):
//
//   z = z_t + r0 h,  i = i_t + r1 h,  f = f_t + r2 h,  o = o_t + r3 h
//   m' = max(f + m, i),  ig = e^{i - m'},  fg = e^{(f + m) - m'}
//   c = fg c + ig tanh(z),  n = fg n + ig
//   h = (sigmoid(o) c) / max(n, 1),  sigmoid(o) = 1 / (1 + e^{-o})
//
// Every operation rounds on its own in the plain version's order (the
// libraries are built with -fmad=false; IEEE division), so both kernels
// match their plain versions bitwise.
#pragma once

namespace slstm {

// A step's intermediates: the gates after r, f + m, the new m, the two
// exponential gates, tanh(z), the new c and n, sigmoid(o), max(n, 1) and
// the new h.
struct Step {
  float z, i, f, o, fm, m, ig, fg, tz, c, n, sg, nc, h;
};

__device__ __forceinline__ Step forward_step(float r0, float r1, float r2,
                                             float r3, float h, float c,
                                             float n, float m, float zt,
                                             float it, float ft, float ot) {
  Step s;
  s.z = __fadd_rn(zt, __fmul_rn(r0, h));
  s.i = __fadd_rn(it, __fmul_rn(r1, h));
  s.f = __fadd_rn(ft, __fmul_rn(r2, h));
  s.o = __fadd_rn(ot, __fmul_rn(r3, h));
  s.fm = __fadd_rn(s.f, m);
  s.m = fmaxf(s.fm, s.i);
  s.ig = expf(__fsub_rn(s.i, s.m));
  s.fg = expf(__fsub_rn(s.fm, s.m));
  s.tz = tanhf(s.z);
  s.c = __fadd_rn(__fmul_rn(s.fg, c), __fmul_rn(s.ig, s.tz));
  s.n = __fadd_rn(__fmul_rn(s.fg, n), s.ig);
  s.sg = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-s.o)));
  s.nc = fmaxf(s.n, 1.0f);
  s.h = __fdiv_rn(__fmul_rn(s.sg, s.c), s.nc);
  return s;
}

}  // namespace slstm
