// The backward of K10's wide route: the gradients of gla.cu's chunked scan
// for bfloat16 heads of any width, taken whole (mLSTM's: dk 1024, dv = dh +
// 1 = 1025, the numerator and normalizer as one scan), in the formulas of
// gla_bf16_bwd.cuh. q, k [BH, S, dk], v and do [BH, S, ldv] (ldv >= dv a
// multiple of 8, the wrapper's zero padding) in bfloat16, g [BH, S] and
// the forward's chunk states [BH, nc, dk, ldv] (gla_wide's look-back
// scratch, its last slot the final state) in float32. dq, dk [BH, S, dk]
// and dv [BH, S, dv] come out in bfloat16, dg in float32.
//
// It replaces no TPU kernel: the reference differentiates its jnp scan
// (repro/models/ssm.py::gla_chunked) with jax.grad.
//
// Design. Each (head, chunk)'s two L x L score matrices are formed once,
// and the heads are never cut into blocks that recompute them: six launches
// on the stream, one entry point, no atomics, every block one warpgroup:
//
//   gla_wide_bwd_scores_kernel  a block per (head, chunk, lower 64 x 64
//                               tile (t, s)): P = (q k^T) and A = (do v^T),
//                               masked and decayed by e^{g_t - g_s}, dk and
//                               ldv streamed in 64-column slices, one exact
//                               bf16 product a slice; both written in
//                               float32 ([BH nc][nt (nt + 1) / 2][64][64],
//                               the lower tiles in row order, as the
//                               forward's gla_wide_scores_kernel writes P);
//   gla_bf16_bwd_ds_kernel<128> the dS chain, a block per (head, 64-row dk
//                               tile, 128-column dv tile) of the state
//                               (gla_bf16_bwd.cuh), each dS_c written out;
//   gla_wide_bwd_kernel<0>      dq: a block per (head, chunk, 64-row query
//                               tile, 128-column block of dk): e^{g_t} dO
//                               S_{c-1}^T over dv's 64-column slices (dO's
//                               slice K-major, S_{c-1}'s [128, 64] slice in
//                               parts K-major), then A's tiles up to the
//                               diagonal, read in float32 and split into
//                               the A fragments, against K's block;
//   gla_wide_bwd_kernel<1>      dk: a block per (head, chunk, 64-row key
//                               tile, 128-column block of dk): e^{g_L -
//                               g_s} V dS_c^T over dv's slices, then A^T's
//                               tiles from the diagonal on against Q's
//                               block;
//   gla_wide_bwd_kernel<2>      dv: a block per (head, chunk, 64-row key
//                               tile, 128-column block of dv): e^{g_L -
//                               g_s} K dS_c over dk's slices (dS_c's [64,
//                               128] slice in parts MN-major), then P^T's
//                               tiles against dO's block;
//   gla_wide_bwd_dg_kernel      dg_t = sum over dk's blocks of q_t . dq_t
//                               - the same of k_t . dk_t (+ <dS_c, S_c> at
//                               the chunk's last row), each block's row sum
//                               written by the dq and dk kernels and added
//                               here in block order.
//
// Bound on this card: operations. At xlstm-1p3b's mLSTM layer (B 1, H 4, S
// 4096, chunk 256, dk 1024, dv 1025) the least work a (head, chunk) is the
// causal half of five L x L products and eight L dk dv products, 159 GFLOP,
// 0.16 ms at the 989 TFLOP/s dense bf16 peak; its bytes (q, k, v, do, dq,
// dk, dv in bf16, g, dg, the states and dS in float32) ~0.17 ms at 3.35
// TB/s. This design takes the float32 operands in two parts, re-reads a
// chunk's state slices for each of its row tiles, and writes P, A and dS
// through device memory.
#include <stdint.h>

#include "gla_bf16_bwd.cuh"

namespace {

using namespace gla_bf16_bwd;

constexpr int kNB = 128;  // columns of an output block

__device__ __forceinline__ long long tri(int t) {
  return (long long)t * (t + 1) / 2;
}

// Shared memory of gla_wide_bwd_scores_kernel: two slots of two [64, 64]
// slices, then g of the query and the key tile.
struct ScoresSmem {
  static constexpr uint32_t kSlot = 2 * kAtom;
  static constexpr uint32_t kG = 2 * kSlot;
  static constexpr uint32_t kBytes = kG + 2 * kTile * 4 + 1024;
};

// P and A of block (head, chunk, lower tile ti = tri(t) + s) of grid BH nc
// nt (nt + 1) / 2; the notes at the top.
__global__ void __launch_bounds__(kThreads)
    gla_wide_bwd_scores_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dO,
                               const float* __restrict__ g,
                               float* __restrict__ P, float* __restrict__ A,
                               int L, int dk, int dv, int ldv, bool vec_qk,
                               bool vec_v) {
  using M = ScoresSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  const float* gt = reinterpret_cast<const float*>(sm + M::kG);
  const float* gs = gt + kTile;
  const int tid = threadIdx.x, warp = tid / 32, gq = (tid % 32) / 4,
            qd = tid % 4;
  const int nt = (L + kTile - 1) / kTile, ntri = nt * (nt + 1) / 2;
  const int bhc = blockIdx.x / ntri, ti = blockIdx.x % ntri;
  int tq = 0;
  while (tri(tq + 1) <= ti) ++tq;
  const int tk = ti - (int)tri(tq);
  const long long row0 = (long long)bhc * L;  // bh S + c L, S = nc L
  stage_g(base + M::kG, g + row0, tq * kTile, L, tid);
  stage_g(base + M::kG + kTile * 4, g + row0, tk * kTile, L, tid);
  wgmma::cp_async_commit();

  // x += X_t Y_s^T over the n slices of 64 columns of X and Y (ld, ncols)
  auto product = [&](float (&x)[32], const __nv_bfloat16* X,
                     const __nv_bfloat16* Y, long long ld, int ncols,
                     bool vec) {
    const int n = (ncols + 63) / 64;
    auto issue = [&](int sl) {
      const uint32_t slot = base + (sl & 1) * M::kSlot;
      load_bf16<64, kTile>(slot, X + row0 * ld, tq * kTile, L, ld, 64 * sl,
                           ncols, vec, tid);
      load_bf16<64, kTile>(slot + kAtom, Y + row0 * ld, tk * kTile, L, ld,
                           64 * sl, ncols, vec, tid);
      wgmma::cp_async_commit();
    };
    issue(0);
    for (int sl = 0; sl < n; ++sl) {
      if (sl + 1 < n) {
        issue(sl + 1);
        wgmma::cp_async_wait<1>();
      } else {
        wgmma::cp_async_wait<0>();
      }
      wgmma::fence_proxy_async();
      __syncthreads();  // slice sl is in
      const uint32_t slot = base + (sl & 1) * M::kSlot;
      scores<4>(x, slot, slot + kAtom);
      __syncthreads();  // every warp is done with the slot
    }
  };
  float x[32];
  // this thread's query rows' g (the slot's g landed with the first slice)
  float gr[2];
  auto put = [&](float* out) {
    float* pt = out + ((long long)bhc * ntri + ti) * (kTile * kTile);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * warp + gq + 8 * h;
        *reinterpret_cast<float2*>(pt + rl * kTile + 8 * j + 2 * qd) =
            make_float2(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
      }
  };
  zero(x);
  product(x, q, k, dk, dk, vec_qk);
#pragma unroll
  for (int h = 0; h < 2; ++h) gr[h] = gt[16 * warp + gq + 8 * h];
  mask_decay(x, gs, gr, tq * kTile, tk * kTile, L, true, warp, gq, qd);
  put(P);
  zero(x);
  product(x, dO, v, ldv, dv, vec_v);
  mask_decay(x, gs, gr, tq * kTile, tk * kTile, L, true, warp, gq, qd);
  put(A);
}

// Shared memory of gla_wide_bwd_kernel: the state term's resident slice
// [64, 64], the kParts parts of the state's slice ([128, 64] or [64, 128]),
// two slots of the accumulated operand's [64, 128] block.
struct GradSmem {
  static constexpr uint32_t SP = 2 * kAtom;  // a part, [128, 64] or [64, 128]
  static constexpr uint32_t kA = 0;
  static constexpr uint32_t kS = kA + kAtom;
  static constexpr uint32_t kC = kS + kParts * SP;  // 2 slots
  static constexpr uint32_t kBytes = kC + 2 * 2 * kAtom + 1024;
};

// One role (0: dq, 1: dk, 2: dv) for block (head, chunk, 64-row tile tr,
// 128-column output block b) of grid BH nc nt nb; the notes at the top.
// dgp: the dq (role 0) or dk (role 1) kernel's row sums [BH S, nb].
template <int ROLE>
__global__ void __launch_bounds__(kThreads)
    gla_wide_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ states,
                        const __nv_bfloat16* __restrict__ dO,
                        const float* __restrict__ ds,
                        const float* __restrict__ P,
                        const float* __restrict__ A,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ dgp, int S, int L, int dk, int dv,
                        int ldv, bool vec_qk, bool vec_v, bool vec_s) {
  using M = GradSmem;
  constexpr int TB = ROLE == 2 ? 1 : 0;  // the state slice MN-major
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x, warp = tid / 32, gq = (tid % 32) / 4,
            qd = tid % 4;
  const int nt = (L + kTile - 1) / kTile, nc = S / L;
  const int ntri = nt * (nt + 1) / 2;
  const int ocols = ROLE == 2 ? dv : dk, nb = (ocols + kNB - 1) / kNB;
  const int bhc = blockIdx.x / (nt * nb), tr = blockIdx.x / nb % nt,
            b = blockIdx.x % nb;
  const int bh = bhc / nc, c = bhc % nc, col0 = kNB * b;
  const long long row0 = (long long)bh * S + (long long)c * L;
  const long long dkv = (long long)dk * ldv;
  // the state term: X [64, K] (dO, V or K: its slices of 64 columns) times
  // the state (S_{c-1}, dS_c, dS_c) over the same K (dv, dv, dk)
  const __nv_bfloat16* X = ROLE == 0 ? dO : ROLE == 1 ? v : k;
  const long long ldx = ROLE == 2 ? dk : ldv;
  const int kcols = ROLE == 2 ? dk : dv;
  const long long prev = (long long)bh * nc + (c > 0 ? c - 1 : 0);
  const float* st = ROLE == 0 ? states + prev * dkv
                              : ds + ((long long)bh * nc + c) * dkv;
  const int n_sl = ROLE == 0 && c == 0 ? 0 : (kcols + 63) / 64;
  // the accumulated operand: K's, Q's or dO's 128-column block b
  const __nv_bfloat16* C = ROLE == 0 ? k : ROLE == 1 ? q : dO;
  const long long ldc = ROLE == 2 ? ldv : dk;
  const bool vec_c = ROLE == 2 ? vec_v : vec_qk;
  const bool vec_x = ROLE == 2 ? vec_qk : vec_v;
  const int r = tr * kTile + 16 * warp + gq;  // this thread's rows r, r + 8
  const float gl = g[row0 + L - 1];
  float gr[2], f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    gr[h] = r + 8 * h < L ? g[row0 + r + 8 * h] : 0.f;
    f[h] = ROLE == 0 ? expf(gr[h]) : expf(__fsub_rn(gl, gr[h]));
  }

  float acc[kNB / 2];
  zero(acc);
  for (int sl = 0; sl < n_sl; ++sl) {
    __syncthreads();  // the slice before is done with the buffers
    load_bf16<64, kTile>(base + M::kA, X + row0 * ldx, tr * kTile, L, ldx,
                         64 * sl, kcols, vec_x, tid);
    wgmma::cp_async_commit();
    if (TB)  // dS_c's rows 64 sl.. (dk), block b's columns (dv)
      load_split<kNB, 64>(base + M::kS, M::SP, st, 64 * sl, dk, ldv, col0,
                          dv, vec_s, nullptr, tid);
    else  // the state's rows col0.. (dk), columns 64 sl.. (dv)
      load_split<64, kNB>(base + M::kS, M::SP, st, col0, dk, ldv, 64 * sl,
                          dv, vec_s, nullptr, tid);
    wgmma::cp_async_wait<0>();
    wgmma::fence_proxy_async();
    __syncthreads();
    pin_all(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = kParts - 1; p >= 0; --p) {
        const uint32_t sp = base + M::kS + p * M::SP;
        SS<kNB, TB, 0>::run(acc, kdesc(base + M::kA, kk, kAtom),
                            TB ? mndesc(sp, kk, kAtom) : kdesc(sp, kk, 0), 1);
      }
    wgmma::commit();
    wgmma::wait();
    pin_all(acc);
  }
  scale_rows<kNB>(acc, f);

  // the intra-chunk sums: key tiles 0 .. tr (dq), query tiles tr .. nt - 1
  const int n_o = ROLE == 0 ? tr + 1 : nt - tr;
  auto tile_of = [&](int i) { return ROLE == 0 ? i : tr + i; };
  auto issue = [&](int i) {
    load_bf16<kNB, kTile>(base + M::kC + (i & 1) * 2 * kAtom, C + row0 * ldc,
                          tile_of(i) * kTile, L, ldc, col0, ocols, vec_c,
                          tid);
    wgmma::cp_async_commit();
  };
  __syncthreads();  // the state term is done with every buffer
  issue(0);
  const float* sc = ROLE == 2 ? P : A;
  const long long tbase = (long long)bhc * ntri;
  for (int i = 0; i < n_o; ++i) {
    const int o = tile_of(i);
    // this tile's scores in the A fragments' layout: X[row, col] of the
    // stored [t][s] tile (t, s) = (tr, o) for dq, its transpose at (o, tr)
    // for dk and dv
    float x[32];
    const long long ti = ROLE == 0 ? tri(tr) + o : tri(o) + tr;
    const float* pt = sc + (tbase + ti) * (kTile * kTile);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * warp + gq + 8 * h, cl = 8 * j + 2 * qd;
        if (ROLE == 0) {
          const float2 y = __ldcg(reinterpret_cast<const float2*>(
              pt + rl * kTile + cl));
          x[4 * j + 2 * h] = y.x;
          x[4 * j + 2 * h + 1] = y.y;
        } else {
          x[4 * j + 2 * h] = __ldcg(pt + cl * kTile + rl);
          x[4 * j + 2 * h + 1] = __ldcg(pt + (cl + 1) * kTile + rl);
        }
      }
    if (i + 1 < n_o) {
      issue(i + 1);
      wgmma::cp_async_wait<1>();
    } else {
      wgmma::cp_async_wait<0>();
    }
    wgmma::fence_proxy_async();
    __syncthreads();  // tile i's block is in
    score_product<kNB>(acc, x, base + M::kC + (i & 1) * 2 * kAtom, kAtom);
    __syncthreads();  // every warp is done with slot i % 2
  }

  const long long ldo = ROLE == 2 ? dv : dk;
  store_bf16<kNB>(out + row0 * ldo, acc, tr * kTile, L, ldo, col0, ocols,
                  warp, gq, qd);
  if (ROLE < 2) {  // block b's share of q_t . dq_t or k_s . dk_s
    const __nv_bfloat16* y = ROLE == 0 ? q : k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p = row_dot<kNB>(y + row0 * dk, acc, r + 8 * h, L, dk,
                                   col0, dk, h, qd);
      if (qd == 0 && r + 8 * h < L) dgp[(row0 + r + 8 * h) * nb + b] = p;
    }
  }
}

// dg_t of every row (a thread a row): the dq kernel's nb row sums in block
// order, less the dk kernel's, plus <dS_c, S_c> (the dS kernel's ntiles
// sums in order) at a chunk's last row.
__global__ void __launch_bounds__(256)
    gla_wide_bwd_dg_kernel(const float* __restrict__ dgq,
                           const float* __restrict__ dgk,
                           const float* __restrict__ red,
                           float* __restrict__ dg, long long rows, int L,
                           int nb, int ntiles) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows) return;
  float a = 0.f, b = 0.f;
  for (int i = 0; i < nb; ++i) {
    a = __fadd_rn(a, dgq[t * nb + i]);
    b = __fadd_rn(b, dgk[t * nb + i]);
  }
  float y = __fsub_rn(a, b);
  if (t % L == L - 1) {
    float rc = 0.f;
    for (int i = 0; i < ntiles; ++i)
      rc = __fadd_rn(rc, red[(t / L) * ntiles + i]);
    y = __fadd_rn(y, rc);
  }
  dg[t] = y;
}

}  // namespace

// The backward of K10's wide route, bfloat16. q, k [BH, S, dk], v, dO [BH,
// S, ldv] bfloat16 (ldv >= dv a multiple of 8, columns past dv zero); g
// [BH, S] (the within-chunk cumsum), states [BH, S / L, dk, ldv] (S_c after
// each chunk c, columns past dv never read), dstate [BH, dk, dv] or null
// (zero) float32, all row-major. Scratch (float32): ds [BH, S / L, dk,
// ldv]; red [BH S / L ceil(dk / 64) ceil(dv / 128)]; P and A [BH S / L nt
// (nt + 1) / 2 64 64] (nt = ceil(L / 64)); dgq, dgk [BH S ceil(dk / 128)].
// dq, dk [BH, S, dk], dv [BH, S, dv] (bfloat16) and dg [BH, S] (float32)
// the gradients, every element written. S a multiple of L. Returns the
// first nonzero CUDA error of the six launches (0 on success), or
// cudaErrorInvalidValue for ldv not a multiple of 8 or below dv.
extern "C" int gla_wide_bwd(const void* q, const void* k, const void* v,
                            const void* g, const void* states, const void* dO,
                            const void* dstate, void* ds, void* red, void* P,
                            void* A, void* dgq, void* dgk, void* dq,
                            void* dk_out, void* dv_out, void* dg, int BH,
                            int S, int L, int dk, int dv, int ldv,
                            void* stream) {
  if (BH == 0 || S == 0 || dk == 0 || dv == 0) return 0;
  if (ldv % 8 || ldv < dv) return (int)cudaErrorInvalidValue;
  auto al = [](const void* p) { return ((uintptr_t)p % 16) == 0; };
  const bool vec_qk = dk % 8 == 0 && al(q) && al(k);
  const bool vec_v = al(v) && al(dO);
  const bool vec_s = al(states) && al(ds);
  using B = const __nv_bfloat16*;
  using F = const float*;
  using O = __nv_bfloat16*;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = S / L, nt = (L + kTile - 1) / kTile;
  int err = launch(gla_wide_bwd_scores_kernel,
                   dim3(BH * nc * (nt * (nt + 1) / 2)), ScoresSmem::kBytes, s,
                   (B)q, (B)k, (B)v, (B)dO, (F)g, (float*)P, (float*)A, L, dk,
                   dv, ldv, vec_qk, vec_v);
  if (err) return err;
  const dim3 dgrid(BH, (dk + 63) / 64, (dv + 127) / 128);
  err = launch(gla_bf16_bwd_ds_kernel<128>, dgrid, DsSmem<128>::kBytes, s,
               (B)q, (B)dO, (F)g, (F)states, (F)dstate, (float*)ds,
               (float*)red, S, L, dk, dv, ldv, vec_qk, vec_v);
  if (err) return err;
  const int nbk = (dk + kNB - 1) / kNB, nbv = (dv + kNB - 1) / kNB;
  const size_t smem = GradSmem::kBytes;
  err = launch(gla_wide_bwd_kernel<0>, dim3(BH * nc * nt * nbk), smem, s,
               (B)q, (B)k, (B)v, (F)g, (F)states, (B)dO, (F)ds, (F)P, (F)A,
               (O)dq, (float*)dgq, S, L, dk, dv, ldv, vec_qk, vec_v, vec_s);
  if (err) return err;
  err = launch(gla_wide_bwd_kernel<1>, dim3(BH * nc * nt * nbk), smem, s,
               (B)q, (B)k, (B)v, (F)g, (F)states, (B)dO, (F)ds, (F)P, (F)A,
               (O)dk_out, (float*)dgk, S, L, dk, dv, ldv, vec_qk, vec_v,
               vec_s);
  if (err) return err;
  err = launch(gla_wide_bwd_kernel<2>, dim3(BH * nc * nt * nbv), smem, s,
               (B)q, (B)k, (B)v, (F)g, (F)states, (B)dO, (F)ds, (F)P, (F)A,
               (O)dv_out, (float*)nullptr, S, L, dk, dv, ldv, vec_qk, vec_v,
               vec_s);
  if (err) return err;
  const long long rows = (long long)BH * S;
  gla_wide_bwd_dg_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      (F)dgq, (F)dgk, (F)red, (float*)dg, rows, L, nbk,
      (int)(dgrid.y * dgrid.z));
  return (int)cudaGetLastError();
}
