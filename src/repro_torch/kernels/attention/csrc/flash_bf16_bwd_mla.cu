// The backward of K9 for bfloat16 inputs at MLA's head (128 < dh <= 192,
// dv <= 128; the kernels and their notes: flash_bf16_bwd.cuh), instantiated
// at DK = 192, DV = 128: a 64-row tile of q or k 24,576 bytes in bf16, half
// its float32 parts' in flash_f32_bwd_mla.cu, so the dkdv block holds K, V
// and two stages of Q and dO whole (165,888 bytes with P^T's hand-over).
//
// Bound on this card: operations. At deepseek-v2's MLA layer (H 128, S
// 4096, dh 192, dv 128) the least work, 2 (3 dh + 2 dv) FLOPs a causal
// pair, is 1.806 ms at the 989.4 TFLOP/s dense bf16 tensor-core peak; with
// P and dS in two parts, 2.918 ms.
#include "flash_bf16_bwd.cuh"

// flash_attention_bwd_bf16 (flash_bf16_bwd.cu) at MLA's head: dh <= 192,
// dv <= 128, else cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_bf16_mla(const void* q, const void* k,
                                            const void* v, const void* o,
                                            const void* dO, const void* lse,
                                            void* delta, void* dq, void* dk,
                                            void* dv_out, int B, int H,
                                            int KV, int S, int Tk, int dh,
                                            int dv, float scale, int causal,
                                            int vec, void* stream) {
  if (dh > 192 || dv > 128) return (int)cudaErrorInvalidValue;
  return bf16_bwd::launch_bwd<192, 128>(q, k, v, o, dO, lse, delta, dq, dk,
                                        dv_out, B, H, KV, S, Tk, dh, dv,
                                        scale, causal, vec, stream);
}
