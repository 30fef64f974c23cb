// The backward of K9 for bfloat16 inputs at dh, dv <= 128 (the kernels
// and their notes: flash_bf16_bwd.cuh), instantiated at D = 64 and 128,
// the least that holds max(dh, dv).
//
// Bound on this card: operations. The least work is 2 (3 dh + 2 dv) FLOPs
// a query-key pair under the mask (S, dP, dV, dK, dQ; P recomputed once);
// at minitron-4b's layer (H 24, S 4096, dh = dv = 128) 257.8 GFLOP, 0.261
// ms at the 989.4 TFLOP/s dense bf16 tensor-core peak; with P and dS in
// two parts (dV, dK, dQ twice) 0.417 ms. This design takes S and dP twice
// (in the dkdv and the dq kernel). Its bytes (q, k, v, o, do in bf16, lse,
// dq, dk, dv once) take 0.040 ms at 3.35 TB/s.
#include "flash_bf16_bwd.cuh"

// The backward of K9, bfloat16. q [B, H, S, dh], k [B, KV, T, dh], v [B,
// KV, T, dv], o and dO [B, H, S, dv], row-major bfloat16; lse [B, H, S]
// float32 (the bf16 forward's); delta [B, H, S] float32 scratch; dq, dk,
// dv the gradients in bfloat16, shaped as q, k, v, every element written.
// scale is dh^-0.5 rounded to float32; dh, dv <= 128; vec: dh and dv
// multiples of 8 and q, k, v, dO 16-byte aligned. Returns the first
// nonzero cudaGetLastError() of the three launches (0 on success), or
// cudaErrorInvalidValue for dh or dv over 128.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dO, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv_out, int B, int H, int KV,
                                        int S, int Tk, int dh, int dv,
                                        float scale, int causal, int vec,
                                        void* stream) {
  if (dh > 128 || dv > 128) return (int)cudaErrorInvalidValue;
  const int d = dh > dv ? dh : dv;
  if (d <= 64)
    return bf16_bwd::launch_bwd<64, 64>(q, k, v, o, dO, lse, delta, dq, dk,
                                        dv_out, B, H, KV, S, Tk, dh, dv,
                                        scale, causal, vec, stream);
  return bf16_bwd::launch_bwd<128, 128>(q, k, v, o, dO, lse, delta, dq, dk,
                                        dv_out, B, H, KV, S, Tk, dh, dv,
                                        scale, causal, vec, stream);
}
