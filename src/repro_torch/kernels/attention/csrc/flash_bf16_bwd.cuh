// The backward of K9 for bfloat16 inputs: the gradients of causal (or not)
// GQA flash attention,
//
//   s = (q . k) dh^-0.5,  p = exp(s - lse),  D = rowsum(do * o),
//   dv = P^T do,  dP = do v^T,  dS = P * (dP - D),
//   dq = dh^-0.5 (dS k),  dk = dh^-0.5 (dS^T q),
//
// for q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv], o and do [B, H,
// S, dv] in bfloat16 and the forward's row statistic lse [B, H, S] in
// float32 (flash_wgmma.cu writes it: m + log(max(l, 1e-30)) of the scaled
// scores), query head h reading kv head h / G, G = H / KV; dq, dk, dv come
// out in bfloat16, each rounded once, at the end. The conventions are the
// bf16 forward's: the score is scaled after the product (a scaled q is not
// representable in bfloat16), the causal mask is t <= s with both counted
// from 0 (top-left aligned), rows past S and keys past T contribute
// nothing. Two entry points instantiate it at DK x DV, the least that
// holds dh x dv: flash_bf16_bwd.cu (64 x 64, 128 x 128) and
// flash_bf16_bwd_mla.cu (MLA's head, 192 x 128).
//
// It replaces no TPU kernel: the reference has no backward kernel, and
// jax.grad differentiates its jnp attention (repro/models/attention.py).
// The port's forward runs K9 on the card, so its backward is a kernel too.
//
// Numerics. q, k, v and do are bf16 already, so S = Q K^T and dP = dO V^T
// are single bf16 products, exact in the tensor cores, summed in float32.
// P and dS are float32 (mask, exp, P (dP - D) on the CUDA cores); they
// enter dV, dK and dQ as two bf16 parts, x_hi = bf16(x) and x_lo = bf16(x -
// x_hi), as the forward's P enters P V: one part alone keeps 8 bits, and
// its emulation leaves the bound the card's check holds these kernels to
// (tests/test_torch_attention_bf16_bwd.py). A step's product is
// taken on the tensor cores into fresh registers and added to the float32
// sums on the CUDA cores: the tensor cores' float32 sums truncate, and a
// kv row's sum over thousands of query rows drifted past the float32
// backward's check (flash_f32_bwd.cu).
//
// Design. Three launches on the stream, one entry point, no atomics; every
// tile is 64 rows in bf16_tile.cuh's swizzled layout, as wide as its head
// dim's instantiation (q, k DK; v, o, do DV):
//
//   flash_bf16_bwd_dot_kernel   D = rowsum(do * o) in float32, a warp a row;
//   flash_bf16_bwd_dkdv_kernel  a block per (b, kv head, 64-row kv tile),
//                               the tiles with the most query tiles under
//                               the causal frontier first; it walks its G
//                               query heads in order and, for each, the
//                               64-row query tiles from the frontier on;
//   flash_bf16_bwd_dq_kernel    a block per (b, head, 128-row query tile),
//                               the longest first; it walks the 64-row kv
//                               tiles up to the frontier.
//
// Both are warp-specialized: three warpgroups, one block an SM. Warpgroup 0
// is the producer: it hands registers to the consumers (setmaxnreg), and
// one of its threads loads the block's resident tiles and keeps the
// streamed tiles in flight by TMA, 64 x 64 boxes in the 128-byte swizzle
// (zero past every edge), in a ring of kStages slots on full / empty
// mbarriers. (Rows that are not whole 16-byte chunks, which TMA cannot
// take, are stored by the producer's 128 threads, which then signal.)
// Warpgroups 1 and 2 consume; they wait only on the ring's mbarriers and
// on named barriers between the two of them, so one's products run while
// the other works on the CUDA cores.
//
// dkdv: K and V stay resident; a slot holds a step's Q and dO tiles and its
// 64 lse and D (a 1-D TMA box each). The consumers split by role, each in
// its own code after its own register hand-over:
//
//   warpgroup 1: S^T = K Q^T (DK / 16 k16 steps), P^T = exp(S^T dh^-0.5 -
//                lse) under the mask, handed to warpgroup 2 in shared
//                memory (float32, two buffers on named barriers), dV +=
//                P^T dO (DV / 64 column chunks);
//   warpgroup 2: dP^T = V dO^T (DV / 16 k16 steps), dS^T = P^T (dP^T - D),
//                dK += dS^T Q (DK / 64 chunks);
//
// (A P^T or dS^T from registers, B dO or Q MN-major from the same tiles
// the score products read K-major), so each kv head's dk and dv sum over
// its query heads and tiles in one fixed order, in one block. At MLA's
// head no product takes a zero chunk: 6 DK + 4 DV FLOPs of issued
// products a causal pair over both kernels, against 9 DK + DV when V and
// dO were DK wide.
//
// dq: a 128-row query tile's Q and dO stay resident, 64 rows to each
// consumer, which run the same code on their own rows over the block's kv
// tiles; a slot holds a kv tile's K and V. A consumer's kv tile kt: S_kt
// and dP_kt issued, P while dP_kt runs, dS, then dQ += dS K a 64-column
// chunk at a time. Each 64-row tile's dQ sums its kv tiles in order, as
// one block of 64 rows did, so the gradients are bitwise those of the
// single-warpgroup design before this one.
//
// ptxas serializes every wgmma of a kernel (C7518, C7520) where it must
// insert a wait of its own on a path that is divergent to it: a wgmma
// group in flight where a loop or a branch of the warpgroup ends, or
// accumulators shared across such a branch. So each role's registers are
// its own, the warpgroup index is broadcast from lane 0, no group is in
// flight where a loop begins or ends, and every chain's first k16 step
// writes its accumulators without reading them (scale-d 0, "=f"), so that
// no register of a product is live before its chain. Issuing the next
// step's score product before this step's elementwise work measured no
// faster and spilled more (PERF.md), so each step issues its own.
#pragma once

#include <stdint.h>
#include <string.h>

#include "../../csrc/float_io.cuh"
#include "bf16_tile.cuh"

namespace bf16_bwd {

using namespace bf16_tile;

constexpr int kBM = 64;        // rows of every tile
constexpr int kWG = 128;       // threads of a warpgroup
constexpr int kThreads = 384;  // a producer warpgroup, two consumers
constexpr int kStages = 3;     // ring slots
constexpr int kQRows = 128;    // query rows a dq block: two consumers of 64
// registers a thread after the hand-over: the producer gives up 112 a
// thread of its 168, the consumers take 56 more each (128 x 112 = 256 x 56)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
// named barriers (0 is __syncthreads): the producer's threads on the
// thread path; the dkdv consumers' P^T hand-over, two buffers each way
constexpr int kBarProducer = 1;
constexpr int kBarPFull = 2;   // + buffer: P^T stored
constexpr int kBarPEmpty = 4;  // + buffer: P^T read

// exp's argument where the mask drops a score: exp(-inf) = 0 exactly.
__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

__device__ __forceinline__ float lds32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}
__device__ __forceinline__ void sts32(uint32_t addr, float a) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(a) : "memory");
}
__device__ __forceinline__ void sts128(uint32_t addr, float a, float b,
                                       float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ void pin32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) wgmma::pin(d[i]);
}

#define BWD_O8(d, i)                                                   \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),          \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define BWD_O32(d) BWD_O8(d, 0), BWD_O8(d, 8), BWD_O8(d, 16), BWD_O8(d, 24)

// The first k16 step of a chain, d overwritten (scale-d 0): the same
// instructions as bf16_tile.cuh's forms, with d written and not read, so
// that the compiler keeps no register of d live before the chain.
// d[64 x 64] = A B^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : BWD_O32(d)
      : "l"(da), "l"(db), "r"(0));
}
// d[64 x 64] = A B, A from registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_first(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : BWD_O32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// Issues d[64 x 64] = A B^T over NK k16 steps as one wgmma group, A and B
// 64-row tiles K-major in shared memory at a and b; the caller waits.
template <int NK>
__device__ __forceinline__ void issue_scores(float (&d)[32], uint32_t a,
                                             uint32_t b) {
  wgmma::fence();
  wgmma_ss_first(d, wgmma::desc(a, 16, 1024), wgmma::desc(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < NK; ++kk) {
    const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
    wgmma_ss_n64(d, wgmma::desc(a + off, 16, 1024),
                 wgmma::desc(b + off, 16, 1024), 1);
  }
  wgmma::commit();
}

// Issues part[64 x 64] = X_lo B + X_hi B over a step's 64 rows as one
// wgmma group: X [64 x 64] as the A fragments of its two bf16 parts, B
// 64-column chunk c of the step's tile at b (its rows the contraction,
// MN-major).
__device__ __forceinline__ void issue_chunk(float (&part)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4], uint32_t b,
                                            int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      wgmma::pin(hi[kk][r]);
      wgmma::pin(lo[kk][r]);
    }
  wgmma::fence();
  wgmma_rs_first(part, lo[0], wgmma::desc(b + c * kAtom, kAtom, 1024));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    WgmmaRS<64>::run(part, lo[kk],
                     wgmma::desc(b + c * kAtom + kk * 2048, kAtom, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    WgmmaRS<64>::run(part, hi[kk],
                     wgmma::desc(b + c * kAtom + kk * 2048, kAtom, 1024));
  wgmma::commit();
}

// acc[i] += part[i]: a chunk's product once it is done.
__device__ __forceinline__ void add_chunk(float* acc, float (&part)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    wgmma::pin(part[i]);
    acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// acc[64 x 64 NC] += X B, a 64-column chunk at a time, each taken into
// fresh registers and added on the CUDA cores; waits for every group in
// flight.
template <int NC>
__device__ __forceinline__ void accumulate(float (&acc)[32 * NC],
                                           float (&part)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    issue_chunk(part, hi, lo, b, c);
    wgmma::wait();
    add_chunk(acc + 32 * c, part);
  }
}

// Rows r0 + 16 w + g + 8 h (those below nrows) of the [64 x 64 NC]
// accumulator of warpgroup thread wt, times `scale`, rounded once to the
// [nrows, cols] bf16 matrix dst, columns past cols dropped.
template <int NC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[32 * NC],
                                           int r0, int nrows, int cols,
                                           float scale, int wt) {
  const int w = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * w + g + 8 * h;
    if (row >= nrows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 64 * c + 8 * j + 2 * qd + e;
          if (col < cols)
            float_io::store(dst + (long long)row * cols + col,
                            __fmul_rn(acc[32 * c + 4 * j + 2 * h + e], scale));
        }
  }
}

// Rows [r0, r0 + 64) (those below nrows) of the [nrows, cols] bf16
// matrix dst set to zero by the 128 threads of a warpgroup.
__device__ __forceinline__ void zero_rows(__nv_bfloat16* dst, int r0,
                                          int nrows, int cols, int wt) {
  const int n = (min(nrows, r0 + kBM) - r0) * cols;
  for (int e = wt; e < n; e += kWG)
    dst[(long long)r0 * cols + e] = __float2bfloat16_rn(0.f);
}

// D[row] = sum_c do[row, c] o[row, c] in float32, a warp a row of BHS
// rows: lane l sums columns l, l + 32, .., then a butterfly over the warp.
__global__ void __launch_bounds__(256)
    flash_bf16_bwd_dot_kernel(const __nv_bfloat16* __restrict__ o,
                              const __nv_bfloat16* __restrict__ dO,
                              float* __restrict__ delta, long long BHS,
                              int dv) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= BHS) return;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc = __fmaf_rn(__bfloat162float(dO[row * dv + c]),
                    __bfloat162float(o[row * dv + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) delta[row] = acc;
}

// Shared memory of the dkdv kernel, byte offsets from a 1024-aligned base:
// the resident K (DK wide) and V (DV) tiles, kStages slots of Q and dO
// tiles, two P^T hand-over buffers (64 x 64 float32), kStages slots' 64
// lse and D, the mbarriers (kvfull, full, empty), then the alignment
// slack.
template <int DK, int DV>
struct DkdvSmem {
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + tile_bytes<DK>();
  static constexpr uint32_t kQ = kV + tile_bytes<DV>();
  static constexpr uint32_t kO = kQ + kStages * tile_bytes<DK>();
  static constexpr uint32_t kP = kO + kStages * tile_bytes<DV>();
  static constexpr uint32_t kLse = kP + 2 * kBM * kBM * 4;
  static constexpr uint32_t kDelta = kLse + kStages * kBM * 4;
  static constexpr uint32_t kBar = kDelta + kStages * kBM * 4;
  static constexpr uint32_t kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};
static_assert(DkdvSmem<192, 128>::kBytes <= 232448, "an SM's shared memory");

// Accumulator layout of wgmma m64nN (f32) for thread t of a warpgroup:
// warp w = t / 32, g = (t % 32) / 4, qd = t % 4; register 4 j + 2 h + e
// holds row 16 w + g + 8 h, column 8 j + 2 qd + e.
//
// dK and dV of one 64-row kv tile (blockIdx.x: kv tile blockIdx.x / BKV of
// kv head blockIdx.x % BKV, so the tiles with the most query tiles come
// first); the notes at the top. The tensor maps: q and do as [B H, S,
// cols], k and v as [B KV, T, cols], lse and D as [B H S] (read only when
// vec).
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tmq,
                               const __grid_constant__ CUtensorMap tmk,
                               const __grid_constant__ CUtensorMap tmv,
                               const __grid_constant__ CUtensorMap tmo,
                               const __grid_constant__ CUtensorMap tml,
                               const __grid_constant__ CUtensorMap tmd,
                               const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dO,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv_out, int BKV,
                               int H, int G, int S, int Tk, int dh, int dv,
                               float scale, int causal, int vec) {
  using L = DkdvSmem<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  // the warpgroup index, broadcast from lane 0 so that the compiler knows
  // it is the same across the warp
  const int tid = threadIdx.x, wt = tid % kWG;
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int kt = (int)(blockIdx.x / BKV);
  const int bkv = (int)(blockIdx.x % BKV);
  const int KV = H / G, b = bkv / KV, kvh = bkv % KV;
  const int t0 = kt * kBM;
  const int nq = (S + kBM - 1) / kBM;
  // query tiles from the one holding row t0 (the causal frontier)
  const int qstart = causal ? min(nq, t0 / kBM) : 0;
  const int per = nq - qstart;  // query tiles a head
  const int steps = G * per;
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  auto sQ = [&](int st) { return base + L::kQ + st * tile_bytes<DK>(); };
  auto sO = [&](int st) { return base + L::kO + st * tile_bytes<DV>(); };
  auto sL = [&](int st) { return base + L::kLse + st * kBM * 4; };
  auto sD = [&](int st) { return base + L::kDelta + st * kBM * 4; };
  auto sP = [&](int pb) { return base + L::kP + pb * kBM * kBM * 4; };
  const uint32_t kvfull = base + L::kBar;
  auto full = [&](int st) { return kvfull + 8 * (1 + st); };
  auto empty = [&](int st) { return kvfull + 8 * (1 + kStages + st); };
  // step i: query head kvh G + i / per of batch b, query tile qstart + i %
  // per, in ring slot i % kStages
  auto head = [&](int i) { return b * H + kvh * G + i / per; };
  auto row0 = [&](int i) { return (qstart + i % per) * kBM; };
  if (tid == 0) {
    wgmma::mbar_init(kvfull, 1);
    for (int st = 0; st < kStages; ++st) {
      wgmma::mbar_init(full(st), 1);
      wgmma::mbar_init(empty(st), 2 * kWG);
    }
  }
  __syncthreads();
  if (steps == 0) {  // no query row reaches this kv tile: dK = dV = 0
    if (wg == 1) zero_rows(dv_out + (long long)bkv * Tk * dv, t0, Tk, dv, wt);
    if (wg == 2) zero_rows(dk + (long long)bkv * Tk * dh, t0, Tk, dh, wt);
    return;
  }

  if (wg == 0) {  // ---- the producer
    wgmma::reg_dealloc<kProducerRegs>();
    if (vec) {  // one thread issues TMA copies
      if (wt == 0) {
        wgmma::mbar_expect_tx(kvfull, tile_bytes<DK>() + tile_bytes<DV>());
#pragma unroll
        for (int cb = 0; cb < DK / 64; ++cb)
          wgmma::tma_load_3d(sK + cb * kAtom, &tmk, 64 * cb, t0, bkv, kvfull);
#pragma unroll
        for (int cb = 0; cb < DV / 64; ++cb)
          wgmma::tma_load_3d(sV + cb * kAtom, &tmv, 64 * cb, t0, bkv, kvfull);
        for (int i = 0; i < steps; ++i) {
          const int st = i % kStages, bh = head(i), q0 = row0(i);
          wgmma::mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
          wgmma::mbar_expect_tx(full(st), tile_bytes<DK>() + tile_bytes<DV>() +
                                              2 * kBM * 4);
#pragma unroll
          for (int cb = 0; cb < DK / 64; ++cb)
            wgmma::tma_load_3d(sQ(st) + cb * kAtom, &tmq, 64 * cb, q0, bh,
                               full(st));
#pragma unroll
          for (int cb = 0; cb < DV / 64; ++cb)
            wgmma::tma_load_3d(sO(st) + cb * kAtom, &tmo, 64 * cb, q0, bh,
                               full(st));
          // rows past S read the next head's (or zeros): masked
          wgmma::tma_load_1d(sL(st), &tml, bh * S + q0, full(st));
          wgmma::tma_load_1d(sD(st), &tmd, bh * S + q0, full(st));
        }
      }
    } else {  // the 128 threads store, then one signals
      load_tile<DK, kWG>(sK, k + (long long)bkv * Tk * dh, t0, Tk, dh, false,
                         wt);
      load_tile<DV, kWG>(sV, v + (long long)bkv * Tk * dv, t0, Tk, dv, false,
                         wt);
      wgmma::fence_proxy_async();
      wgmma::named_bar(kBarProducer, kWG);
      if (wt == 0) wgmma::mbar_arrive(kvfull);
      for (int i = 0; i < steps; ++i) {
        const int st = i % kStages, q0 = row0(i);
        const long long bh = head(i);
        wgmma::mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        load_tile<DK, kWG>(sQ(st), q + bh * S * dh, q0, S, dh, false, wt);
        load_tile<DV, kWG>(sO(st), dO + bh * S * dv, q0, S, dv, false, wt);
        const int r = q0 + wt % kBM;  // threads 0-63 lse, 64-127 D
        const float* src = wt < kBM ? lse : delta;
        sts32((wt < kBM ? sL(st) : sD(st)) + 4 * (wt % kBM),
              r < S ? src[bh * S + r] : 0.f);
        wgmma::fence_proxy_async();
        wgmma::named_bar(kBarProducer, kWG);
        if (wt == 0) wgmma::mbar_arrive(full(st));
      }
    }
    return;
  }

  // ---- the consumers, each role in its own code after its own register
  // hand-over. No wgmma group is in flight where a loop begins or ends, and
  // none sits in a branch.
  const int w = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
  const int kr = t0 + 16 * w + g;  // this thread's kv rows: kr, kr + 8
  if (wg == 1) {  // S^T, P^T, dV += P^T dO
    wgmma::reg_alloc<kConsumerRegs>();
    wgmma::mbar_wait(kvfull, 0);
    float x[32], part[32], acc[DV / 2];
    uint32_t xhi[4][4], xlo[4][4];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) acc[e] = 0.f;
    for (int i = 0; i < steps; ++i) {
      const int st = i % kStages, q0 = row0(i), pb = i & 1;
      wgmma::mbar_wait(full(st), (i / kStages) & 1);
      issue_scores<DK / 16>(x, sK, sQ(st));
      wgmma::wait();
      pin32(x);
      // P^T = exp(S^T dh^-0.5 - lse[query]) under the mask
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * qd + e, row = q0 + c;
          const float l = lds32(sL(st) + 4 * c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int xi = 4 * j + 2 * h + e, t = kr + 8 * h;
            const bool live = row < S && t < Tk && !(causal && t > row);
            x[xi] = expf(live ? __fsub_rn(__fmul_rn(x[xi], scale), l)
                              : neg_inf());
          }
        }
      // to warpgroup 2 (thread wt's 32 as 8 chunks, conflict-free), once
      // it has read the buffer's P^T of step i - 2
      if (i >= 2) wgmma::named_bar(kBarPEmpty + pb, 2 * kWG);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        sts128(sP(pb) + (c * kWG + wt) * 16, x[4 * c], x[4 * c + 1],
               x[4 * c + 2], x[4 * c + 3]);
      wgmma::named_arrive(kBarPFull + pb, 2 * kWG);
      split_fragments(x, xhi, xlo);
      accumulate<DV / 64>(acc, part, xhi, xlo, sO(st));
      wgmma::mbar_arrive(empty(st));
    }
    store_rows<DV / 64>(dv_out + (long long)bkv * Tk * dv, acc, t0, Tk, dv,
                        1.f, wt);
    return;
  }
  {  // dP^T, dS^T, dK += dS^T Q
    wgmma::reg_alloc<kConsumerRegs>();
    wgmma::mbar_wait(kvfull, 0);
    float x[32], part[32], acc[DK / 2];
    uint32_t xhi[4][4], xlo[4][4];
#pragma unroll
    for (int e = 0; e < DK / 2; ++e) acc[e] = 0.f;
    for (int i = 0; i < steps; ++i) {
      const int st = i % kStages, pb = i & 1;
      wgmma::mbar_wait(full(st), (i / kStages) & 1);
      issue_scores<DV / 16>(x, sV, sO(st));
      wgmma::wait();
      pin32(x);
      // dS^T = P^T (dP^T - D[query]), P^T from warpgroup 1
      wgmma::named_bar(kBarPFull + pb, 2 * kWG);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 pt = lds128(sP(pb) + (c * kWG + wt) * 16);
        const float ps[4] = {pt.x, pt.y, pt.z, pt.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int xi = 4 * c + m;  // = 4 j + 2 h + e
          const float d = lds32(sD(st) + 4 * (8 * (xi / 4) + 2 * qd + xi % 2));
          x[xi] = __fmul_rn(ps[m], __fsub_rn(x[xi], d));
        }
      }
      if (i + 2 < steps) wgmma::named_arrive(kBarPEmpty + pb, 2 * kWG);
      split_fragments(x, xhi, xlo);
      accumulate<DK / 64>(acc, part, xhi, xlo, sQ(st));
      wgmma::mbar_arrive(empty(st));
    }
    store_rows<DK / 64>(dk + (long long)bkv * Tk * dh, acc, t0, Tk, dh, scale,
                        wt);
  }
}

// Shared memory of the dq kernel, byte offsets from a 1024-aligned base:
// the resident Q (DK wide) and dO (DV) tiles of the block's two 64-row
// halves, kStages slots of K and V tiles, the mbarriers (qfull, full,
// empty), then the alignment slack.
template <int DK, int DV>
struct DqSmem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kO = kQ + 2 * tile_bytes<DK>();
  static constexpr uint32_t kK = kO + 2 * tile_bytes<DV>();
  static constexpr uint32_t kV = kK + kStages * tile_bytes<DK>();
  static constexpr uint32_t kBar = kV + kStages * tile_bytes<DV>();
  static constexpr uint32_t kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};
static_assert(DqSmem<192, 128>::kBytes <= 232448, "an SM's shared memory");

// dQ of one 128-row query tile (blockIdx.x: query tile nq - 1 - blockIdx.x
// / BH of head blockIdx.x % BH, the longest first); the notes at the top.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_bwd_dq_kernel(const __grid_constant__ CUtensorMap tmq,
                             const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             const __grid_constant__ CUtensorMap tmo,
                             const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dO,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int BH, int H,
                             int G, int S, int Tk, int dh, int dv,
                             float scale, int causal, int vec) {
  using L = DqSmem<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  // the warpgroup index, broadcast from lane 0 so that the compiler knows
  // it is the same across the warp
  const int tid = threadIdx.x, wt = tid % kWG;
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nq = (S + kQRows - 1) / kQRows;
  const int qt = nq - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int bkv = b * (H / G) + h / G;
  const int q0 = qt * kQRows;
  const int ntk = (Tk + kBM - 1) / kBM;
  // kv tiles under the frontier of query rows ending at r_end
  auto kv_tiles = [&](int r_end) {
    return causal ? min(ntk, (r_end + kBM - 1) / kBM) : ntk;
  };
  const int nkv = kv_tiles(q0 + kQRows);
  auto sQ = [&](int half) { return base + L::kQ + half * tile_bytes<DK>(); };
  auto sO = [&](int half) { return base + L::kO + half * tile_bytes<DV>(); };
  auto sK = [&](int st) { return base + L::kK + st * tile_bytes<DK>(); };
  auto sV = [&](int st) { return base + L::kV + st * tile_bytes<DV>(); };
  const uint32_t qfull = base + L::kBar;
  auto full = [&](int st) { return qfull + 8 * (1 + st); };
  auto empty = [&](int st) { return qfull + 8 * (1 + kStages + st); };
  if (tid == 0) {
    wgmma::mbar_init(qfull, 1);
    for (int st = 0; st < kStages; ++st) {
      wgmma::mbar_init(full(st), 1);
      wgmma::mbar_init(empty(st), 2 * kWG);
    }
  }
  __syncthreads();
  if (nkv == 0) {  // no key under the frontier: dQ = 0
    if (wg > 0) zero_rows(dq + (long long)bh * S * dh, q0 + kBM * (wg - 1), S,
                          dh, wt);
    return;
  }

  if (wg == 0) {  // ---- the producer
    wgmma::reg_dealloc<kProducerRegs>();
    if (vec) {  // one thread issues TMA copies
      if (wt == 0) {
        wgmma::mbar_expect_tx(qfull, 2 * (tile_bytes<DK>() + tile_bytes<DV>()));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int cb = 0; cb < DK / 64; ++cb)
            wgmma::tma_load_3d(sQ(half) + cb * kAtom, &tmq, 64 * cb,
                               q0 + kBM * half, bh, qfull);
#pragma unroll
          for (int cb = 0; cb < DV / 64; ++cb)
            wgmma::tma_load_3d(sO(half) + cb * kAtom, &tmo, 64 * cb,
                               q0 + kBM * half, bh, qfull);
        }
        for (int kt = 0; kt < nkv; ++kt) {
          const int st = kt % kStages;
          wgmma::mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
          wgmma::mbar_expect_tx(full(st), tile_bytes<DK>() + tile_bytes<DV>());
#pragma unroll
          for (int cb = 0; cb < DK / 64; ++cb)
            wgmma::tma_load_3d(sK(st) + cb * kAtom, &tmk, 64 * cb, kt * kBM,
                               bkv, full(st));
#pragma unroll
          for (int cb = 0; cb < DV / 64; ++cb)
            wgmma::tma_load_3d(sV(st) + cb * kAtom, &tmv, 64 * cb, kt * kBM,
                               bkv, full(st));
        }
      }
    } else {  // the 128 threads store, then one signals
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        load_tile<DK, kWG>(sQ(half), q + (long long)bh * S * dh,
                           q0 + kBM * half, S, dh, false, wt);
        load_tile<DV, kWG>(sO(half), dO + (long long)bh * S * dv,
                           q0 + kBM * half, S, dv, false, wt);
      }
      wgmma::fence_proxy_async();
      wgmma::named_bar(kBarProducer, kWG);
      if (wt == 0) wgmma::mbar_arrive(qfull);
      for (int kt = 0; kt < nkv; ++kt) {
        const int st = kt % kStages;
        wgmma::mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        load_tile<DK, kWG>(sK(st), k + (long long)bkv * Tk * dh, kt * kBM, Tk,
                           dh, false, wt);
        load_tile<DV, kWG>(sV(st), v + (long long)bkv * Tk * dv, kt * kBM, Tk,
                           dv, false, wt);
        wgmma::fence_proxy_async();
        wgmma::named_bar(kBarProducer, kWG);
        if (wt == 0) wgmma::mbar_arrive(full(st));
      }
    }
    return;
  }

  // ---- the consumers: warpgroup cw takes rows [q0 + 64 cw, q0 + 64 cw + 64)
  // over the block's kv tiles (a tile past its own frontier or rows past S
  // adds exact zeros), so no branch of theirs depends on the warpgroup; no
  // wgmma group is in flight where the loop begins or ends
  wgmma::reg_alloc<kConsumerRegs>();
  const int cw = wg - 1;
  const int w = wt / 32, g = (wt % 32) / 4, qd = wt % 4;
  const int rw = q0 + kBM * cw;
  const int r0 = rw + 16 * w + g;  // this thread's rows: r0, r0 + 8
  float lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool live = r0 + 8 * hh < S;
    lr[hh] = live ? lse[(long long)bh * S + r0 + 8 * hh] : 0.f;
    dr[hh] = live ? delta[(long long)bh * S + r0 + 8 * hh] : 0.f;
  }
  float acc[DK / 2];
#pragma unroll
  for (int e = 0; e < DK / 2; ++e) acc[e] = 0.f;
  float s[32], dp[32];  // dP's registers then take each chunk's product
  uint32_t xhi[4][4], xlo[4][4];
  const uint32_t qs = sQ(cw), os = sO(cw);
  wgmma::mbar_wait(qfull, 0);
  for (int kt = 0; kt < nkv; ++kt) {
    const int st = kt % kStages, t0 = kt * kBM;
    wgmma::mbar_wait(full(st), (kt / kStages) & 1);
    issue_scores<DK / 16>(s, qs, sK(st));
    issue_scores<DV / 16>(dp, os, sV(st));  // dP_kt
    wgmma::wait_group<1>();                 // S_kt
    pin32(s);
    // P = exp(S dh^-0.5 - lse[row]) under the mask, while dP_kt runs
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int xi = 4 * j + 2 * hh + e, row = r0 + 8 * hh;
          const int t = t0 + 8 * j + 2 * qd + e;
          const bool live = row < S && t < Tk && !(causal && t > row);
          s[xi] = expf(live ? __fsub_rn(__fmul_rn(s[xi], scale), lr[hh])
                            : neg_inf());
        }
    wgmma::wait();
    pin32(dp);
    // dS = P (dP - D[row])
#pragma unroll
    for (int xi = 0; xi < 32; ++xi)
      s[xi] = __fmul_rn(s[xi], __fsub_rn(dp[xi], dr[(xi / 2) % 2]));
    split_fragments(s, xhi, xlo);
    // dQ += dS K, a 64-column chunk at a time
#pragma unroll
    for (int c = 0; c < DK / 64; ++c) {
      issue_chunk(dp, xhi, xlo, sK(st), c);
      wgmma::wait();
      add_chunk(acc + 32 * c, dp);
    }
    wgmma::mbar_arrive(empty(st));  // K_kt and V_kt are read
  }
  store_rows<DK / 64>(dq + (long long)bh * S * dh, acc, rw, S, dh, scale, wt);
}

// The bf16 tensor [n, rows, cols] at p as 64 x 64 boxes in the 128-byte
// swizzle, zero past every edge.
inline bool bf16_map(CUtensorMap* map, const void* p, int cols, int rows,
                     int n) {
  return wgmma::tile_map(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cols,
                         rows, n, 64, 64);
}

// The three launches at instantiation DK x DV. The tensor maps are built
// when vec holds (and every pointer they read is 16-byte aligned); else
// the producers store every tile by threads. Returns the first nonzero
// error (0 on success).
template <int DK, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dO, const void* lse, void* delta, void* dq,
               void* dk, void* dv_out, int B, int H, int KV, int S, int Tk,
               int dh, int dv, float scale, int causal, int vec,
               void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* qb = (const __nv_bfloat16*)q;
  const auto* kb = (const __nv_bfloat16*)k;
  const auto* vb = (const __nv_bfloat16*)v;
  const auto* gb = (const __nv_bfloat16*)dO;
  const float* lf = (const float*)lse;
  float* df = (float*)delta;
  const long long bhs = (long long)B * H * S;
  int err = 0;
  if (bhs > 0) {
    flash_bf16_bwd_dot_kernel<<<(int)((bhs + 7) / 8), 256, 0, s>>>(
        (const __nv_bfloat16*)o, gb, df, bhs, dv);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  CUtensorMap tq, tk, tv, to, tl, td;
  memset(&tq, 0, sizeof tq);
  memset(&tk, 0, sizeof tk);
  memset(&tv, 0, sizeof tv);
  memset(&to, 0, sizeof to);
  memset(&tl, 0, sizeof tl);
  memset(&td, 0, sizeof td);
  vec = vec && S > 0 && Tk > 0 && (uintptr_t)lse % 16 == 0 &&
        (uintptr_t)delta % 16 == 0;
  if (vec && !(bf16_map(&tq, q, dh, S, B * H) &&
               bf16_map(&tk, k, dh, Tk, B * KV) &&
               bf16_map(&tv, v, dv, Tk, B * KV) &&
               bf16_map(&to, dO, dv, S, B * H) &&
               wgmma::vec_map(&tl, lf, bhs, kBM) &&
               wgmma::vec_map(&td, df, bhs, kBM)))
    return (int)cudaErrorInvalidValue;
  const int ntk = (Tk + kBM - 1) / kBM, nq = (S + kQRows - 1) / kQRows;
  if (ntk > 0) {
    err = float_io::launch(flash_bf16_bwd_dkdv_kernel<DK, DV>, B * KV * ntk,
                           kThreads, DkdvSmem<DK, DV>::kBytes, s, tq, tk, tv,
                           to, tl, td, qb, kb, vb, gb, lf, (const float*)df,
                           (__nv_bfloat16*)dk, (__nv_bfloat16*)dv_out,
                           B * KV, H, H / KV, S, Tk, dh, dv, scale, causal,
                           vec);
    if (err) return err;
  }
  if (nq == 0) return 0;
  return float_io::launch(flash_bf16_bwd_dq_kernel<DK, DV>, B * H * nq,
                          kThreads, DqSmem<DK, DV>::kBytes, s, tq, tk, tv, to,
                          qb, kb, vb, gb, lf, (const float*)df,
                          (__nv_bfloat16*)dq, B * H, H, H / KV, S, Tk, dh, dv,
                          scale, causal, vec);
}

}  // namespace bf16_bwd
