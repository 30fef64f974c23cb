// The backward of K10 for bfloat16 inputs at dk, dv <= 128 (zamba2's Mamba2
// heads): the gradients of gla.cu's chunked scan, in the formulas of
// gla_bf16_bwd.cuh, for q, k [BH, S, dk], v and do [BH, S, dv] in bfloat16,
// g [BH, S] (the within-chunk cumsum) and the forward's chunk states S_c
// [BH, nc, dk, dv] (its look-back scratch, kept by the wrapper; the last
// slot the final state) in float32. dq, dk and dv come out in bfloat16, dg
// in float32.
//
// It replaces no TPU kernel: the reference has no backward kernel. Its
// models differentiate the jnp scan (repro/models/ssm.py::gla_chunked) with
// jax.grad, in any dtype. The port's forward runs K10 on the card, so its
// backward is a kernel too.
//
// Design: gla_bwd.cu's decomposition (the float32 backward's), on bf16
// wgmma with float32 operands in two bf16 parts (gla_bf16_bwd.cuh). Four
// launches on the stream, one entry point, no atomics; every block is one
// warpgroup, every tile 64 rows, zero-padded in shared memory to D = 64 or
// 128 columns:
//
//   gla_bf16_bwd_ds_kernel<D>  a block per (head, 64-row tile of dk): U_c
//                              taken per chunk on the tensor cores and the
//                              chain dS_{c-1} = e^{g_L} dS_c + U_c, last
//                              chunk first, carried in registers; each dS_c
//                              written out, <dS_c, S_c> summed per tile;
//   gla_bf16_bwd_kernel<D, 2>  dv: a block per (head, chunk, 64-row key
//                              tile s): the state term k_s dS_c (dS_c's
//                              parts MN-major) scaled by e^{g_L - g_s}, then
//                              for each query tile t from the diagonal on,
//                              B^T = K Q^T masked and decayed, dV += B^T dO;
//   gla_bf16_bwd_kernel<D, 1>  dk the same way: v_s dS_c^T (the same parts
//                              K-major), then A^T = V dO^T, dK += A^T Q; and
//                              k_s . dk_s of each row into dg;
//   gla_bf16_bwd_kernel<D, 0>  dq: a block per (head, chunk, 64-row query
//                              tile t): e^{g_t} dO S_{c-1}^T, then for each
//                              key tile up to the diagonal A = dO V^T
//                              (recomputed, as gla_bwd.cu's dq kernel does,
//                              rather than summed from the key tiles'
//                              blocks), dQ += A K; then dg_t = q_t . dq_t -
//                              k_t . dk_t (+ <dS_c, S_c> at the chunk's
//                              last row, the tiles' sums in order).
//
// A block's resident tile (K, V or dO) is the A operand of its state and
// score products, K-major; the streamed tiles of the other side come in by
// cp.async into two slots, the next one in flight while the current one is
// computed. The state terms go first, so a block holds one accumulator.
// Two runs are bitwise equal.
//
// Bound on this card: bytes. At zamba2-7B's layer (B 1, 112 heads, S 4096,
// chunk 256, dk = dv = 64) the least work is the causal half of five L x L
// products and eight L dk dv products a (head, chunk): 52.8 GFLOP, 0.053 ms
// at the 989 TFLOP/s dense bf16 peak; the bytes (q, k, v, do, dq, dk, dv in
// bf16, g, dg, the states and dS once in float32) take ~0.09 ms at 3.35
// TB/s. This design takes the float32 operands in two parts (about twice
// the tensor-core work), recomputes A and B in the key and query kernels,
// and carries the chain in series over the chunks (112 blocks at zamba2's
// layer).
#include <stdint.h>

#include "gla_bf16_bwd.cuh"

namespace {

using namespace gla_bf16_bwd;

// Shared memory of gla_bf16_bwd_kernel<D, ROLE>, byte offsets from a
// 1024-aligned base: the resident 64-row tile, the kParts parts of the
// [D, D] state (dS_c or S_{c-1}, rows dk, columns dv), two slots of the
// streamed tiles (the score operand, then the accumulated one), g of the
// two slots' rows.
template <int D>
struct Smem {
  static constexpr uint32_t T = (D / 64) * kAtom;  // a [64, D] tile
  static constexpr uint32_t SP = (D / 64) * D * 128;  // a [D, D] part
  static constexpr uint32_t kR = 0;
  static constexpr uint32_t kS = kR + T;
  static constexpr uint32_t kB = kS + kParts * SP;  // 2 slots of 2 tiles
  static constexpr uint32_t kG = kB + 4 * T;        // 2 slots of 64 g
  static constexpr uint32_t kBytes = kG + 2 * kTile * 4 + 1024;
};
static_assert(Smem<128>::kBytes <= 232448, "an SM's shared memory");

// One role of the backward (0: dq, 1: dk, 2: dv) for block (bh, c, 64-row
// tile tr) of grid BH nc nt; the notes at the top.
template <int D, int ROLE>
__global__ void __launch_bounds__(kThreads)
    gla_bf16_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ states,
                        const __nv_bfloat16* __restrict__ dO,
                        const float* __restrict__ ds,
                        const float* __restrict__ red,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ dg, int S, int L, int dk, int dv,
                        int ntiles, bool vec, bool vec_s) {
  using M = Smem<D>;
  constexpr int KS = D / 16;                // k16 steps over a head dim
  constexpr int TB = ROLE == 2 ? 1 : 0;     // the state operand MN-major
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x, warp = tid / 32, gq = (tid % 32) / 4,
            qd = tid % 4;
  const int nt = (L + kTile - 1) / kTile, nc = S / L;
  const int bh = blockIdx.x / (nc * nt), c = blockIdx.x / nt % nc,
            tr = blockIdx.x % nt;
  const long long row0 = (long long)bh * S + (long long)c * L;
  const long long dkv = (long long)dk * dv;
  // the role's matrices: the resident tile's (its columns the products'
  // K), the streamed score operand's (the same K), the accumulated one's
  // (its columns the output's)
  const __nv_bfloat16* res = ROLE == 0 ? dO : ROLE == 1 ? v : k;
  const __nv_bfloat16* sco = ROLE == 0 ? v : ROLE == 1 ? dO : q;
  const __nv_bfloat16* acc_op = ROLE == 0 ? k : ROLE == 1 ? q : dO;
  const int kcols = ROLE == 2 ? dk : dv, ocols = ROLE == 2 ? dv : dk;
  // the state: S_{c-1} (none at c = 0: zero) for dq, dS_c for dk and dv
  const long long prev = (long long)bh * nc + (c > 0 ? c - 1 : 0);
  const float* st = ROLE == 0 ? states + prev * dkv
                              : ds + ((long long)bh * nc + c) * dkv;
  const int st_rows = ROLE == 0 && c == 0 ? 0 : dk;
  // the streamed tiles: key tiles 0 .. tr for dq, query tiles tr .. nt - 1
  const int n_o = ROLE == 0 ? tr + 1 : nt - tr;
  auto tile_of = [&](int i) { return ROLE == 0 ? i : tr + i; };
  auto issue = [&](int i) {
    const int o = tile_of(i);
    const uint32_t slot = base + M::kB + (i & 1) * 2 * M::T;
    load_bf16<D, kTile>(slot, sco + row0 * kcols, o * kTile, L, kcols, 0,
                        kcols, vec, tid);
    load_bf16<D, kTile>(slot + M::T, acc_op + row0 * ocols, o * kTile, L,
                        ocols, 0, ocols, vec, tid);
    stage_g(base + M::kG + (i & 1) * kTile * 4, g + row0, o * kTile, L, tid);
    wgmma::cp_async_commit();
  };

  load_bf16<D, kTile>(base + M::kR, res + row0 * kcols, tr * kTile, L, kcols,
                      0, kcols, vec, tid);
  issue(0);
  load_split<D, D>(base + M::kS, M::SP, st, 0, st_rows, dv, 0, dv, vec_s,
                   nullptr, tid);
  // this thread's rows r, r + 8 of the tile: their g and the state term's
  // factor (e^{g_t} for dq, e^{g_L - g_s} for dk and dv)
  const int r = tr * kTile + 16 * warp + gq;
  const float gl = g[row0 + L - 1];
  float gr[2], f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    gr[h] = r + 8 * h < L ? g[row0 + r + 8 * h] : 0.f;
    f[h] = ROLE == 0 ? expf(gr[h]) : expf(__fsub_rn(gl, gr[h]));
  }

  // the state term
  constexpr int NO = D / 2;
  float acc[NO];
  zero(acc);
  wgmma::cp_async_wait<0>();
  wgmma::fence_proxy_async();
  __syncthreads();
  pin_all(acc);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int p = kParts - 1; p >= 0; --p) {
      const uint32_t sp = base + M::kS + p * M::SP;
      SS<D, TB, 0>::run(acc, kdesc(base + M::kR, kk, kAtom),
                        TB ? mndesc(sp, kk, D * 128) : kdesc(sp, kk, D * 128),
                        1);
    }
  wgmma::commit();
  wgmma::wait();
  pin_all(acc);
  scale_rows<D>(acc, f);

  // the intra-chunk sums, a streamed tile at a time
  for (int i = 0; i < n_o; ++i) {
    if (i + 1 < n_o) {
      issue(i + 1);
      wgmma::cp_async_wait<1>();
    } else {
      wgmma::cp_async_wait<0>();
    }
    wgmma::fence_proxy_async();
    __syncthreads();  // tile i is in
    const uint32_t slot = base + M::kB + (i & 1) * 2 * M::T;
    const float* gs = reinterpret_cast<const float*>(sm + M::kG +
                                                     (i & 1) * kTile * 4);
    float x[32];
    zero(x);
    scores<KS>(x, base + M::kR, slot);
    mask_decay(x, gs, gr, tr * kTile, tile_of(i) * kTile, L, ROLE == 0,
               warp, gq, qd);
    score_product<D>(acc, x, slot + M::T, kAtom);
    __syncthreads();  // every warp is done with slot i % 2
  }

  const long long orow0 = row0 * ocols;
  store_bf16<D>(out + orow0, acc, tr * kTile, L, ocols, 0, ocols, warp, gq,
                qd);
  if (ROLE == 1) {  // k_s . dk_s into dg, which the dq kernel subtracts
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p = row_dot<D>(k + row0 * dk, acc, r + 8 * h, L, dk, 0, dk,
                                 h, qd);
      if (qd == 0 && r + 8 * h < L) dg[row0 + r + 8 * h] = p;
    }
  }
  if (ROLE == 0) {  // dg_t = q_t . dq_t - k_t . dk_t (+ <dS_c, S_c>)
    float rc = 0.f;
    for (int i = 0; i < ntiles; ++i)
      rc = __fadd_rn(rc, red[((long long)bh * nc + c) * ntiles + i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r + 8 * h;
      const float p = row_dot<D>(q + row0 * dk, acc, t, L, dk, 0, dk, h, qd);
      if (qd == 0 && t < L) {
        float y = __fsub_rn(p, dg[row0 + t]);
        if (t == L - 1) y = __fadd_rn(y, rc);
        dg[row0 + t] = y;
      }
    }
  }
}

template <int D>
int launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const float* g, const float* states,
               const __nv_bfloat16* dO, const float* dstate, float* ds,
               float* red, __nv_bfloat16* dq, __nv_bfloat16* dk_out,
               __nv_bfloat16* dv_out, float* dg, int BH, int S, int L, int dk,
               int dv, bool vec_q, bool vec_o, bool vec, bool vec_s,
               cudaStream_t stream) {
  const int nc = S / L, nt = (L + kTile - 1) / kTile;
  const dim3 dgrid(BH, (dk + 63) / 64, (dv + D - 1) / D);
  const int ntiles = dgrid.y * dgrid.z;
  int err = launch(gla_bf16_bwd_ds_kernel<D>, dgrid, DsSmem<D>::kBytes,
                   stream, q, dO, g, states, dstate, ds, red, S, L, dk, dv,
                   dv, vec_q, vec_o);
  if (err) return err;
  const dim3 grid(BH * nc * nt);
  const size_t smem = Smem<D>::kBytes;
  err = launch(gla_bf16_bwd_kernel<D, 2>, grid, smem, stream, q, k, v, g,
               states, dO, (const float*)ds, (const float*)red, dv_out, dg,
               S, L, dk, dv, ntiles, vec, vec_s);
  if (err) return err;
  err = launch(gla_bf16_bwd_kernel<D, 1>, grid, smem, stream, q, k, v, g,
               states, dO, (const float*)ds, (const float*)red, dk_out, dg,
               S, L, dk, dv, ntiles, vec, vec_s);
  if (err) return err;
  return launch(gla_bf16_bwd_kernel<D, 0>, grid, smem, stream, q, k, v, g,
                states, dO, (const float*)ds, (const float*)red, dq, dg, S,
                L, dk, dv, ntiles, vec, vec_s);
}

}  // namespace

// The backward of K10, bfloat16. q, k [BH, S, dk], v, dO [BH, S, dv]
// bfloat16; g [BH, S] (the within-chunk cumsum), states [BH, S / L, dk, dv]
// (S_c after each chunk c), dstate [BH, dk, dv] or null (zero) float32, all
// row-major; ds [BH, S / L, dk, dv] and red [BH S / L ceil(dk / 64)
// ceil(dv / D)] float32 scratch (D = 64 when dk, dv <= 64, else 128); dq,
// dk, dv (bfloat16) and dg (float32) the gradients, shaped as q, k, v, g,
// every element written. S a multiple of L; dk, dv <= 128. Returns the
// first nonzero CUDA error of the four launches (0 on success), or
// cudaErrorInvalidValue for a head dim over 128.
extern "C" int gla_scan_bwd_bf16(const void* q, const void* k, const void* v,
                                 const void* g, const void* states,
                                 const void* dO, const void* dstate, void* ds,
                                 void* red, void* dq, void* dk_out,
                                 void* dv_out, void* dg, int BH, int S, int L,
                                 int dk, int dv, void* stream) {
  if (BH == 0 || S == 0 || dk == 0 || dv == 0) return 0;
  if (dk > 128 || dv > 128) return (int)cudaErrorInvalidValue;
  auto al = [](const void* p) { return ((uintptr_t)p % 16) == 0; };
  // 16-byte copies of whole 8-element rows from 16-byte aligned bases
  const bool vec_q = dk % 8 == 0 && al(q);
  const bool vec_o = dv % 8 == 0 && al(dO);
  const bool vec = dk % 8 == 0 && dv % 8 == 0 && al(q) && al(k) && al(v) &&
                   al(dO);
  const bool vec_s = dv % 4 == 0 && al(states) && al(ds);
  using B = const __nv_bfloat16*;
  using O = __nv_bfloat16*;
  cudaStream_t s = (cudaStream_t)stream;
  if (dk <= 64 && dv <= 64)
    return launch_bwd<64>((B)q, (B)k, (B)v, (const float*)g,
                          (const float*)states, (B)dO, (const float*)dstate,
                          (float*)ds, (float*)red, (O)dq, (O)dk_out,
                          (O)dv_out, (float*)dg, BH, S, L, dk, dv, vec_q,
                          vec_o, vec, vec_s, s);
  return launch_bwd<128>((B)q, (B)k, (B)v, (const float*)g,
                         (const float*)states, (B)dO, (const float*)dstate,
                         (float*)ds, (float*)red, (O)dq, (O)dk_out,
                         (O)dv_out, (float*)dg, BH, S, L, dk, dv, vec_q,
                         vec_o, vec, vec_s, s);
}
