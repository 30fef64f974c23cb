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
// Bound on this card: bytes. xlstm-1p3b's prefill (B 4, S 4096, D 2048,
// bf16) reads 268 MB of zifo and writes 67 MB of hs: 0.10 ms at 3.35 TB/s;
// its ~1 GFLOP of f32 work takes 0.015 ms at 67 TFLOP/s. Neither is in
// reach: the recurrence is diagonal (r enters element-wise), so the B D
// channels are independent, but each runs its S steps in order, and h_t
// enters every gate of step t + 1 through r, then the exponentials, tanh
// and two IEEE divisions, so no associative scan exists. The floor is S
// times one step's dependent chain; a thread issues a step's
// instructions in order, so whatever else the loop does stretches it.
//
// Design: one thread a channel, h, c, n, m in registers, the step loop
// inside the kernel, a block of kThreads channels. A block whose channels
// lie in one sequence, with rows of whole 16-byte copies, stages its gates
// in shared memory kChunk steps at a time, kStages - 1 stages ahead: its
// threads copy the block's contiguous gate rows by cp.async, so a step
// reads its four gates from shared memory and the loop over a stage's
// steps is unrolled, free of global loads and their addresses. Any other
// block, and a scan of one step (a decode step, where staging adds a
// barrier), reads each gate straight from global memory. Every operation
// rounds on its own in the plain version's order (the library is built
// with -fmad=false; IEEE division), so the kernel matches the plain
// version bitwise. The step itself is slstm_step.cuh's, which the
// backward (slstm_bwd.cu) recomputes.
//
// Training: given cs, ns, ms [B, S, D] float32, the kernel also writes each
// step's c, n and m after the step (its h is hs itself in float32), so the
// backward can walk the steps in reverse from the recorded states. Without
// them it writes nothing more; hs and the final state are the same either
// way.
#include <stdint.h>

#include "../../csrc/float_io.cuh"
#include "slstm_step.cuh"

namespace {

constexpr int kThreads = 64;  // channels a block: two warps
constexpr int kChunk = 16;    // steps a stage
constexpr int kStages = 3;    // stages in shared memory

struct State {
  float h, c, n, m, r0, r1, r2, r3;
};

// One step of channel s on its gate pre-activations; returns h_t.
__device__ __forceinline__ float step(State& s, float zt, float it, float ft,
                                      float ot) {
  const slstm::Step q = slstm::forward_step(s.r0, s.r1, s.r2, s.r3, s.h, s.c,
                                            s.n, s.m, zt, it, ft, ot);
  s.h = q.h;
  s.c = q.c;
  s.n = q.n;
  s.m = q.m;
  return s.h;
}

// Channel s's state after step t into the records at offset `at` (when
// kRec is 1).
template <int kRec>
__device__ __forceinline__ void record(const State& s, float* cs, float* ns,
                                       float* ms, long long at) {
  if (kRec) {
    cs[at] = s.c;
    ns[at] = s.n;
    ms[at] = s.m;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <typename T, int kRec>
__global__ void __launch_bounds__(kThreads)
    slstm_scan_kernel(const T* __restrict__ zifo, const float* __restrict__ r,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0, T* __restrict__ hs,
                      float* __restrict__ cs, float* __restrict__ ns,
                      float* __restrict__ ms,
                      float* __restrict__ h1, float* __restrict__ c1,
                      float* __restrict__ n1, float* __restrict__ m1, int B,
                      int S, int D) {
  // stage k's gates in slot k % kStages: [step][gate][channel]
  __shared__ __align__(16) T gates[kStages][kChunk][4][kThreads];
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte copy
  const int tid = threadIdx.x;
  const int ch0 = blockIdx.x * kThreads, ch = ch0 + tid;  // b D + d
  const bool live = ch < B * D;
  const int d0 = ch0 % D;
  const long long row = 4LL * D;  // a step's gates
  const int b = live ? ch / D : 0, d = live ? ch % D : 0;
  State s{};
  if (live) {
    s.r0 = r[d];
    s.r1 = r[D + d];
    s.r2 = r[2 * D + d];
    s.r3 = r[3 * D + d];
    s.h = h0[ch];
    s.c = c0[ch];
    s.n = n0[ch];
    s.m = m0[ch];
  }
  const T* zp = zifo + (long long)b * S * row + d;
  const long long rec = (long long)b * S * D + d;  // (b, 0, d) of hs
  T* hp = hs + rec;
  // uniform over the block
  const bool staged = S > 1 && d0 + kThreads <= D && D % kPer == 0 &&
                      ((uintptr_t)zifo & 15) == 0;
  if (!staged) {
    if (live) {
      for (int t = 0; t < S; ++t) {
        const T* g = zp + t * row;
        const float h = step(s, float_io::to_f32(g[0]),
                             float_io::to_f32(g[D]),
                             float_io::to_f32(g[2 * D]),
                             float_io::to_f32(g[3 * D]));
        float_io::store(hp + (long long)t * D, h);
        record<kRec>(s, cs, ns, ms, rec + (long long)t * D);
      }
    }
  } else {
    // the block's gate rows: copy x of a stage is 16 bytes of columns
    // [d0 + c kPer, d0 + (c + 1) kPer) of gate g at step u (c = x % CPR,
    // g = x / CPR % 4, u = x / (4 CPR)), the stage's live steps only
    constexpr int CPR = kThreads / kPer;
    const T* zb = zifo + (long long)(ch0 / D) * S * row + d0;
    const int nstages = (S + kChunk - 1) / kChunk;
    auto fill = [&](int k) {
      if (k >= nstages) return;
      const int t0 = k * kChunk, n = min(kChunk, S - t0) * 4 * CPR;
#pragma unroll
      for (int x = tid; x < kChunk * 4 * CPR; x += kThreads) {
        if (x >= n) break;
        const int c = x % CPR, g = x / CPR % 4, u = x / (4 * CPR);
        cp_async16(&gates[k % kStages][u][g][c * kPer],
                   zb + (t0 + u) * row + g * D + c * kPer);
      }
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      fill(k);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int k = 0; k < nstages; ++k) {
      // stage k has landed (its group and every older one), and every
      // thread is done with stage k - 1, whose slot takes stage k +
      // kStages - 1
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
      __syncthreads();
      fill(k + kStages - 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (!live) continue;
      const T(*g)[4][kThreads] = gates[k % kStages];
      const int t0 = k * kChunk;
      auto run = [&](int u) {
        const float h = step(s, float_io::to_f32(g[u][0][tid]),
                             float_io::to_f32(g[u][1][tid]),
                             float_io::to_f32(g[u][2][tid]),
                             float_io::to_f32(g[u][3][tid]));
        float_io::store(hp + (long long)(t0 + u) * D, h);
        record<kRec>(s, cs, ns, ms, rec + (long long)(t0 + u) * D);
      };
      if (t0 + kChunk <= S) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u) run(u);
      } else {
        for (int u = 0; u < S - t0; ++u) run(u);
      }
    }
  }
  if (live) {
    h1[ch] = s.h;
    c1[ch] = s.c;
    n1[ch] = s.n;
    m1[ch] = s.m;
  }
}

template <typename T>
void launch(const void* zifo, const float* r, const float* h0,
            const float* c0, const float* n0, const float* m0, void* hs,
            float* cs, float* ns, float* ms, float* h1, float* c1, float* n1,
            float* m1, int B, int S, int D, cudaStream_t s) {
  const int blocks = (B * D + kThreads - 1) / kThreads;
  if (cs)
    slstm_scan_kernel<T, 1><<<blocks, kThreads, 0, s>>>(
        (const T*)zifo, r, h0, c0, n0, m0, (T*)hs, cs, ns, ms, h1, c1, n1,
        m1, B, S, D);
  else
    slstm_scan_kernel<T, 0><<<blocks, kThreads, 0, s>>>(
        (const T*)zifo, r, h0, c0, n0, m0, (T*)hs, cs, ns, ms, h1, c1, n1,
        m1, B, S, D);
}

}  // namespace

// The sLSTM scan. zifo [B, S, 4D] and hs [B, S, D] both float32 (bf16 = 0)
// or both bfloat16 (bf16 = 1); r [4, D] and the states h0, c0, n0, m0 and
// h1, c1, n1, m1 [B, D] float32 (the outputs distinct from the inputs);
// the records cs, ns, ms [B, S, D] float32, all three or none (null);
// every tensor contiguous. One launch of ceil(B D / 64) blocks of 64
// threads on `stream`. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int slstm_scan_fwd(const void* zifo, const float* r,
                              const float* h0, const float* c0,
                              const float* n0, const float* m0, void* hs,
                              float* cs, float* ns, float* ms, float* h1,
                              float* c1, float* n1, float* m1, int B, int S,
                              int D, int bf16, void* stream) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch<__nv_bfloat16>(zifo, r, h0, c0, n0, m0, hs, cs, ns, ms, h1, c1,
                          n1, m1, B, S, D, s);
  else
    launch<float>(zifo, r, h0, c0, n0, m0, hs, cs, ns, ms, h1, c1, n1, m1, B,
                  S, D, s);
  return (int)cudaGetLastError();
}
