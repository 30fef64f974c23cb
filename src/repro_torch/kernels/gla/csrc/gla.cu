// K10: the chunked gated-linear-attention scan (the SSD / mLSTM core),
//
//   S_t = a_t S_{t-1} + k_t^T v_t,   o_t = q_t S_t,
//
// per (batch, head) for q, k [BH, S, dk] and v [BH, S, dv] in float32 or
// bfloat16, with g [BH, S] the within-chunk inclusive cumsum of log a
// (float32, taken by the wrapper); o [BH, S, dv] comes out in v's dtype,
// the final state [BH, dk, dv] in float32. Chunk c of L rows computes
//
//   o_i = sum_{j <= i} (q_i . k_j) e^{g_i - g_j} v_j + e^{g_i} q_i S_{c-1}
//   S_c = e^{g_L} S_{c-1} + dS_c,   dS_c = sum_j (k_j e^{g_L - g_j})^T v_j
//
// in the reference's order of operations (scores times decay, then the
// causal mask; the intra-chunk sum plus the decayed inter-chunk read; k
// weighted before the state update).
//
// K10 replaces repro/kernels/gla/kernel.py::_gla_kernel (entry
// gla_kernel_call), the Pallas TPU kernel reached through
// repro/kernels/gla/ops.py::gla_scan, where each program holds a head's
// whole sequence in VMEM and walks its chunks in order.
//
// Design: chunk-parallel, one launch. The work unit is one (head, chunk),
// not one head: zamba2-7B's scan (112 heads x 16 chunks) is 1792 units,
// which fill all 132 SMs where 112 one-head blocks left 20 idle. A unit
// stages its chunk once and computes its intra-chunk output and dS_c,
// neither of which needs the state; then it takes S_{c-1} from its
// predecessor, publishes S_c and adds e^{g_i} q_i S_{c-1} to its rows.
// The state crosses blocks by a look-back inside the launch:
//
//   - each block takes a ticket from an atomic counter (not blockIdx), so
//     no block waits on one that has not started, and maps ticket t to
//     chunk t / BH, head t % BH: its predecessor was issued BH tickets
//     earlier and has usually published when it is needed;
//   - S_c goes to a float32 scratch [BH, nc, dk, dv] the wrapper
//     allocates; a barrier after the writes precedes thread 0's
//     st.release.gpu of the unit's flag, which the successor's thread 0
//     polls with ld.acquire.gpu before the block reads S_{c-1} through L2
//     (__ldcg, up to 8 loads of a thread in flight); the last chunk writes
//     `state`;
//   - the counter and the flags are zeroed on the stream (cudaMemsetAsync)
//     before each launch, with no host sync. A wait that outlasts seconds
//     traps rather than hangs.
//
// bf16 inputs: Hopper's warpgroup MMA (wgmma, in PTX, with the fence /
// commit / wait of attention/csrc/wgmma.cuh), f32 sums. Tiles sit in
// shared memory in the 128-byte swizzled layout (64-column sub-tiles,
// 16-byte chunk c of row r at chunk c ^ (r % 8)), copied by cp.async
// (16-byte copies; element-wise loads when dk or dv is not a multiple of
// 8 or an input is not 16-byte aligned). A pass takes 128 query rows, 64
// a warpgroup, and each warpgroup takes the key tiles up to its diagonal:
//
//   S = q k^T        m64nNk16, both operands K-major in shared memory,
//                    exactly bf16: one product;
//   P = S e^{g_i - g_j}, masked only where the keys cross the diagonal or
//                    the chunk's end, in registers;
//   O += P V         P split into three bf16 parts (hi, mid, lo: each the
//                    bf16 of what the parts before it leave), fed from
//                    registers (m64nDk16 with A in registers, V MN-major),
//                    the small part first;
//   dS += (k w)^T v  k w in f32 (w = e^{g_L - g_j}), split in three once a
//                    tile and stored transposed, so (k w)^T is a K-major
//                    operand;
//   O' = q S_{c-1}   S_{c-1} split in three once by the block and stored
//                    transposed (K-major), m64nDk16.
//
// dk, dv <= 64 (zamba2's heads) run gla_ws_kernel: persistent and
// warp-specialized, one block an SM of a producer warpgroup, which keeps
// two query buffers and a 4-slot key ring filled and signals them on
// mbarriers, and two consumer warpgroups that compute without a
// block-wide barrier (notes at the kernel). Larger head dims (D = 128)
// run gla_mma_kernel, whose shared memory (194 KB) leaves no room for the
// producer's ring: a block a unit, two warpgroups that stage through a
// 2-slot ring together, block-wide barriers at each tile.
//
// Heads wider than 128 (mLSTM's 1024) reach K10 cut into 128-wide blocks
// (kernels/gla/ops.py::gla_blocked): a launch takes q's and k's dk blocks
// as extra heads and one block of v, and gla_mma_kernel<128, float> writes
// its float32 partial outputs, which the wrapper sums over the dk blocks
// before rounding once to bf16; each state block is exact. QK^T is
// recomputed for every dv block: at xlstm-1p3b's scan (dk = dv = 1024)
// each (head, chunk) does 1.78x the un-blocked work, and the split
// products more.
//
// Three parts keep each split operand to ~2^-27 of its value, below f32's
// own rounding; two parts (~2^-18) move some near-zero outputs past the
// check's 1e-5 absolute tolerance (tests/test_torch_gla_schedule.py
// witnesses it). The passes run last first: the last 128 rows see every
// key, so that pass also accumulates dS, and the unit publishes S_c after
// its first pass, not at its end; the next pass's query rows are copied
// while the epilogue runs. For L <= 128 every tile is loaded once; at
// L = 256 the first two key tiles twice (from L2). Any L, and dk, dv up
// to 128 are taken, zero-padded in shared memory to D = 64 or 128.
//
// f32 inputs (gla_fma_kernel): the same units, tickets and look-back; a
// 16 x 16-thread block computes with fmaf on CUDA cores in 64-row tiles:
// dS from the chunk's weighted key and value tiles, then, with S_{c-1} in
// shared memory, each query tile's inter-chunk read and its intra-chunk
// sum over key tiles up to the diagonal (re-read from L2).
//
// Bound on this card: bytes. Zamba2-7B's scan (112 heads of dk = dv = 64, S =
// 4096, chunk 256, bf16, B = 1) moves 238.6 MB (q, k, v, o in bf16, log a, the
// state), 0.071 ms at 3.35 TB/s; its 15.1 GFLOP (the causal half of each
// chunk's scores and their products, the inter-chunk read and the state update)
// take 0.015 ms at the 989 TFLOP/s bf16 peak. The split products raise the
// tensor-core work to ~53 GFLOP (~0.054 ms at that peak), the published states
// add 29 MB of L2 traffic, and the first version's points are each met: 1792
// units fill the card where 112 blocks left 20 SMs idle; the chunks of a head
// run in parallel, not in series; the products run on tensor cores, not fmaf; a
// key or value tile is staged once a pass, not again for every query tile and a
// third time for the state update; and the next tile's copy is in flight while
// the current one is computed. What holds it above the bound is the consumers'
// own work: they wait on every product they issue, so a warpgroup's exp and
// three-part split (~20 instructions a score) never overlap its tensor-core
// work, and two of them an SM (163 registers a thread) hide little of it; they
// wait for data a small share of their time.
#include <stdint.h>

#include "../../attention/csrc/wgmma.cuh"
#include "../../csrc/float_io.cuh"

namespace {

constexpr int kTile = 64;  // rows a query or key tile
constexpr int kThreads = 256;

// ---- the look-back ---------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// The block's ticket, from the counter sync[0], in every thread.
__device__ __forceinline__ int take_ticket(int* sync) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  return ticket;
}

// Thread 0 waits for the flag (set by the predecessor's publish); the
// block then passes a barrier. A wait of ~2^24 polls (seconds) traps: a
// fault, never a hang.
__device__ __forceinline__ void wait_flag(const int* flag) {
  if (threadIdx.x == 0) {
    int polls = 0;
    while (ld_acquire(flag) == 0) {
      __nanosleep(64);
      if (++polls > (1 << 24)) __trap();
    }
  }
  __syncthreads();
}

// Every thread has written its share of S_c: after the barrier, thread
// 0's release (cumulative over the block's writes it has synchronized
// with) sets the flag.
__device__ __forceinline__ void publish(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, 1);
}

// The scratch slot of (bh, c), [dk, dv] float32.
__device__ __forceinline__ long long slot(int bh, int c, int nc, int dk,
                                          int dv) {
  return ((long long)bh * nc + c) * dk * dv;
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int kWG = kThreads / 128;   // warpgroups a block
constexpr int kQT = 64 * kWG;         // query rows a pass, 64 a warpgroup
constexpr uint32_t kAtom = 64 * 128;  // a 64-row x 64-column bf16 sub-tile

using wgmma::smem_u32;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float lo_f32(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// (x0, x1) as three packed bf16 pairs, p[0] + p[1] + p[2] within ~2^-27
// of each: every part the bf16 (round to nearest even) of what the parts
// before it leave, every difference exact.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = bits(__floats2bfloat162_rn(x0, x1));
    x0 = __fsub_rn(x0, lo_f32(p[i]));
    x1 = __fsub_rn(x1, hi_f32(p[i]));
  }
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], both in shared memory, A K-major,
// B K-major (TB = 0) or MN-major (TB = 1); scale_d = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wg_ss(float (&d)[16], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : WG_D16(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wg_ss(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wg_ss(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : WG_D64(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d[64 x N] += A[64 x 16] B[16 x N], A from registers (four bf16x2 a
// thread), B MN-major in shared memory.
__device__ __forceinline__ void wg_rs(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wg_rs(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void pin_all(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) wgmma::pin(d[i]);
}

// K-major descriptor of k16 step kk of a swizzled tile at t whose
// 64-column sub-tiles are `sub` bytes apart.
__device__ __forceinline__ uint64_t kdesc(uint32_t t, int kk, uint32_t sub) {
  return wgmma::desc(t + (kk / 4) * sub + (kk % 4) * 32, 16, 1024);
}
// MN-major descriptor of rows [16 kk, 16 kk + 16) of a 64-row swizzled
// tile at t (its 64-column sub-tiles kAtom apart).
__device__ __forceinline__ uint64_t mndesc(uint32_t t, int kk) {
  return wgmma::desc(t + kk * 2048, kAtom, 1024);
}

// Shared memory of gla_mma_kernel<D>, byte offsets from a 1024-aligned
// base. Tiles are swizzled (16-byte chunk c of row r at chunk c ^ (r % 8),
// rows 128 bytes apart) in 64-column sub-tiles.
template <int D>
struct Smem {
  static constexpr uint32_t T64 = (D / 64) * kAtom;  // a 64-row tile
  static constexpr uint32_t KW = D * 128;            // k w part: [D][64]
  static constexpr uint32_t ST = (D / 64) * D * 128;  // S part: [D][D]
  static constexpr uint32_t SF = D * (D + 4) * 4;     // dS, f32 [D][D + 4]
  static constexpr uint32_t kQ = 0;                   // a tile a warpgroup
  static constexpr uint32_t kK = kQ + kWG * T64;      // 2 slots
  static constexpr uint32_t kV = kK + 2 * T64;        // 2 slots
  // the parts of k w ^T (pass 0's tiles), then dS in f32, then the parts
  // of S_{c-1} ^T
  static constexpr uint32_t kP = kV + 2 * T64;
  static constexpr uint32_t PB = 3 * ST > SF ? 3 * ST : SF;
  static constexpr uint32_t kGq = kP + PB;   // g of the pass's rows
  static constexpr uint32_t kGk = kGq + kQT * 4;     // g of 2 key tiles
  static constexpr uint32_t kW = kGk + 2 * kTile * 4;  // w of a key tile
  static constexpr uint32_t bytes = kW + kTile * 4 + 1024;  // + alignment
  static_assert(3 * KW <= PB, "k w parts");
};

// Rows [row0, row0 + R) of a chunk's row-major [L, cols] bf16 matrix at
// src into the swizzled R-row tile at dst (R * 128-byte sub-tiles), zero
// past L and past cols, by NT threads (thread tid). vec (cols % 8 == 0,
// src 16-byte aligned): whole 16-byte chunks by cp.async; else element by
// element.
template <int D, int R, int NT = kThreads>
__device__ __forceinline__ void stage(uint32_t dst, const __nv_bfloat16* src,
                                      int row0, int L, int cols, bool vec,
                                      int tid = threadIdx.x) {
  constexpr int CH = D / 8;
  static_assert(R * CH % NT == 0, "whole passes");
#pragma unroll
  for (int n = 0; n < R * CH / NT; ++n) {
    const int e = tid + n * NT;
    const int r = e / CH, c = e % CH, c0 = 8 * c, row = row0 + r;
    const uint32_t d =
        dst + (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
    const bool live = row < L && c0 < cols;
    const __nv_bfloat16* s = src + (long long)row * cols + c0;
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(live ? s : src), "r"(live ? 16 : 0)
                   : "memory");
    } else {
      const unsigned short* p = reinterpret_cast<const unsigned short*>(s);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = c0 + 2 * i;
        const uint32_t lo = live && a < cols ? p[2 * i] : 0u;
        const uint32_t hi = live && a + 1 < cols ? p[2 * i + 1] : 0u;
        w[i] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// g of rows [r0, r0 + n) of the chunk into dst, zero past L, by NT
// threads (thread tid).
template <int NT = kThreads>
__device__ __forceinline__ void stage_g(float* dst, const float* g, int r0,
                                        int n, int L, int tid = threadIdx.x) {
  for (int e = tid; e < n; e += NT) {
    const bool live = r0 + e < L;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst + e)),
                 "l"(live ? g + r0 + e : g), "r"(live ? 4 : 0)
                 : "memory");
  }
}

// Eight consecutive values as three 16-byte chunks of bf16 parts, stored
// at dst + i * part (shared addresses).
__device__ __forceinline__ void store_parts(uint32_t dst, uint32_t part,
                                            const float (&x)[8]) {
  uint32_t w[3][4], p[3];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    split3(x[2 * u], x[2 * u + 1], p);
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i][u] = p[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + i * part),
                 "r"(w[i][0]), "r"(w[i][1]), "r"(w[i][2]), "r"(w[i][3])
                 : "memory");
}

// The wgmma accumulator layout of m64nN (f32) for thread t of a
// warpgroup: warp w = t / 32, g = (t % 32) / 4, qd = t % 4; register
// 4 j + 2 h + e holds row 16 w + g + 8 h, column 8 j + 2 qd + e.
//
// K10 for bf16 inputs with dk or dv over 64 (D = 128): a block a unit
// (its ticket); its two warpgroups stage each pass's query rows and a
// 2-slot key ring together, with block-wide barriers, and warpgroup w
// takes rows [64 w, 64 w + 64) of dk of dS. o is OutT: bf16, or float32
// (the partial outputs of a head cut into 128-wide blocks, which the
// caller sums before their one rounding to bf16); only the stores differ.
template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    gla_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ g, OutT* __restrict__ o,
                   float* __restrict__ state, float* scratch, int* sync,
                   int BH, int S, int L, int dk, int dv, bool vec) {
  static_assert(D == 128, "dk, dv <= 64 take gla_ws_kernel");
  using Sm = Smem<D>;
  constexpr int KS = D / 16;  // k16 steps of a head dim
  constexpr int NO = D / 2;   // accumulators of m64nD a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  float* gq = reinterpret_cast<float*>(sm + Sm::kGq);
  float* gk = reinterpret_cast<float*>(sm + Sm::kGk);
  float* wk = reinterpret_cast<float*>(sm + Sm::kW);
  float* Sd = reinterpret_cast<float*>(sm + Sm::kP);
  const uint32_t sP = base + Sm::kP;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, gr = (wt % 32) / 4, qd = wt % 4;
  const uint32_t sQ = base + Sm::kQ + wg * Sm::T64;

  const int t = take_ticket(sync);
  const int nc = S / L, c = t / BH, bh = t % BH;
  const long long row0 = (long long)bh * S + (long long)c * L;
  const __nv_bfloat16* qc = q + row0 * dk;
  const __nv_bfloat16* kc = k + row0 * dk;
  const __nv_bfloat16* vc = v + row0 * dv;
  const float* gc = g + row0;
  OutT* oc = o + row0 * dv;
  const float gl = gc[L - 1];
  const int npass = (L + kQT - 1) / kQT;
  int* flags = sync + 1;

  // key tile kt into ring slot kt % 2
  auto issue = [&](int kt) {
    const uint32_t s = (kt & 1) * Sm::T64;
    stage<D, kTile>(base + Sm::kK + s, kc, kt * kTile, L, dk, vec);
    stage<D, kTile>(base + Sm::kV + s, vc, kt * kTile, L, dv, vec);
    stage_g(gk + (kt & 1) * kTile, gc, kt * kTile, kTile, L);
  };
  // the copies that open pass p: its query rows (a group), and its first
  // two key tiles (a group each)
  auto stage_q = [&](int p) {
    const int q0 = (npass - 1 - p) * kQT;
#pragma unroll
    for (int w = 0; w < kWG; ++w)
      stage<D, 64>(base + Sm::kQ + w * Sm::T64, qc, q0 + 64 * w, L, dk, vec);
    stage_g(gq, gc, q0, kQT, L);
    cp_async_commit();
  };
  auto stage_tiles = [&](int p) {
    const int nkt = (min((npass - p) * kQT, L) + kTile - 1) / kTile;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      if (kt < nkt) issue(kt);
      cp_async_commit();
    }
  };

  // dS: warpgroup w takes rows [64 w, 64 w + 64) of dk
  float ds[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) ds[i] = 0.f;

  stage_q(0);
  for (int pi = 0; pi < npass; ++pi) {
    const bool first = pi == 0;  // the last rows, every key, dS
    __syncthreads();  // the last pass's epilogue is done with the ring
    stage_tiles(pi);
    const int q0 = (npass - 1 - pi) * kQT;
    const int nkt = (min(q0 + kQT, L) + kTile - 1) / kTile;
    const int rw = q0 + 64 * wg;           // this warpgroup's first row
    const bool live = rw < L;
    const int r0 = rw + 16 * warp + gr;    // this thread's rows r0, r0 + 8
    float gi[2];
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < nkt; ++kt) {
      cp_async_wait<1>();
      // the copies become visible to wgmma (the async proxy), then to
      // every thread
      wgmma::fence_proxy_async();
      __syncthreads();  // tile kt (and at kt = 0, Q and gq) is in
      if (kt == 0) {
        gi[0] = gq[64 * wg + 16 * warp + gr];
        gi[1] = gq[64 * wg + 16 * warp + gr + 8];
      }
      const int j0 = kt * kTile;
      const uint32_t sK = base + Sm::kK + (kt & 1) * Sm::T64;
      const uint32_t sV = base + Sm::kV + (kt & 1) * Sm::T64;
      const float* gkt = gk + (kt & 1) * kTile;
      if (first) {  // (k w)^T of the tile, w = e^{g_L - g_j}, in parts
        if (tid < kTile)
          wk[tid] = j0 + tid < L ? expf(__fsub_rn(gl, gkt[tid])) : 0.f;
        __syncthreads();
        for (int e = tid; e < D * 8; e += kThreads) {
          const int d = e % D, cc = e / D;  // row d of k^T, keys 8 cc..
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int j = 8 * cc + u;
            const unsigned short kv = *reinterpret_cast<const unsigned short*>(
                sm + Sm::kK + (kt & 1) * Sm::T64 + (d / 64) * kAtom +
                j * 128 + ((((d % 64) / 8) ^ (j % 8)) << 4) + (d % 8) * 2);
            x[u] = __fmul_rn(__uint_as_float((uint32_t)kv << 16), wk[j]);
          }
          store_parts(sP + d * 128 + ((cc ^ (d % 8)) << 4), Sm::KW, x);
        }
        wgmma::fence_proxy_async();
        __syncthreads();
      }
      // this warpgroup's rows against the tile, 32 keys at a time
      if (live) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int jh = j0 + 32 * hf;
          if (jh > rw + 63 || jh >= L) continue;  // wholly above or past
          float s[16];
          wgmma::fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wg_ss<0>(s, kdesc(sQ, kk, kAtom),
                     kdesc(sK + hf * 32 * 128, kk, kAtom), kk > 0);
          wgmma::commit();
          wgmma::wait();
          pin_all(s);
          // P = S e^{g_i - g_j}; the causal and chunk-end mask where
          // the half crosses the diagonal or the chunk's end
          const bool mask = jh + 31 > rw || jh + 32 > L;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * h + e;
                const int jl = 32 * hf + 8 * j + 2 * qd + e;
                const float p =
                    __fmul_rn(s[i], expf(__fsub_rn(gi[h], gkt[jl])));
                s[i] = mask && (j0 + jl > r0 + 8 * h || j0 + jl >= L) ? 0.f
                                                                      : p;
              }
          // P as A fragments of the two k16 steps, three parts each:
          // register r of step kk packs keys 8 kk + 2 r, 8 kk + 2 r + 1
          uint32_t pa[2][3][4], part[3];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], part);
#pragma unroll
              for (int i = 0; i < 3; ++i) pa[kk][i][r] = part[i];
            }
          pin_all(acc);
          wgmma::fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int i = 2; i >= 0; --i)
              wg_rs(acc, pa[kk][i], mndesc(sV, 2 * hf + kk));
          wgmma::commit();
          wgmma::wait();
          pin_all(acc);
        }
      }
      if (first) {  // dS += (k w)^T v over the tile's keys
        pin_all(ds);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 2; i >= 0; --i)
            wg_ss<1>(ds, kdesc(sP + i * Sm::KW + wg * kAtom, kk, 0),
                     mndesc(sV, kk), 1);
        wgmma::commit();
        wgmma::wait();
        pin_all(ds);
      }
      __syncthreads();  // every warp is done with slot kt % 2
      if (kt + 2 < nkt) issue(kt + 2);
      cp_async_commit();
    }

    // Qs and gq are free: the next pass's query rows fly during this
    // pass's epilogue
    if (pi + 1 < npass) stage_q(pi + 1);

    if (first) {  // S_{c-1} in, S_c out
      if (c > 0) wait_flag(flags + (long long)bh * nc + c - 1);
      const float* s_in =
          scratch + (c > 0 ? slot(bh, c - 1, nc, dk, dv) : 0);
      // dS to shared memory, in float32
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            Sd[(64 * wg + 16 * warp + gr + 8 * h) * (D + 4) + 8 * j + 2 * qd +
               e] = ds[4 * j + 2 * h + e];
      __syncthreads();
      float* s_out = c + 1 < nc ? scratch + slot(bh, c, nc, dk, dv)
                                : state + (long long)bh * dk * dv;
      const float egl = expf(gl);
      constexpr int N8 = D * D / kThreads < 8 ? D * D / kThreads : 8;
      for (int e0 = 0; e0 < D * D; e0 += N8 * kThreads) {
        float x[N8];  // S_{c-1}, its loads in flight together
#pragma unroll
        for (int u = 0; u < N8; ++u) {
          const int e = e0 + tid + u * kThreads, r = e / D, col = e % D;
          x[u] = c > 0 && r < dk && col < dv ? __ldcg(s_in + r * dv + col)
                                             : 0.f;
        }
#pragma unroll
        for (int u = 0; u < N8; ++u) {
          const int e = e0 + tid + u * kThreads, r = e / D, col = e % D;
          if (r < dk && col < dv)
            s_out[r * dv + col] =
                __fadd_rn(__fmul_rn(egl, x[u]), Sd[r * (D + 4) + col]);
        }
      }
      __syncthreads();  // S_c written; Sd read
      if (c + 1 < nc && tid == 0)
        st_release(flags + (long long)bh * nc + c, 1);
      // S_{c-1}^T in three parts (row n of dv, 8 dk values a chunk), the
      // B operand of every warpgroup's inter-chunk read
      for (int e = tid; e < D * D / 8; e += kThreads) {
        const int n = e % D, kc = e / D;
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = 8 * kc + u;
          x[u] = c > 0 && r < dk && n < dv ? __ldcg(s_in + r * dv + n) : 0.f;
        }
        store_parts(sP + (kc / 8) * (D * 128) + n * 128 +
                        (((kc % 8) ^ (n % 8)) << 4),
                    Sm::ST, x);
      }
      wgmma::fence_proxy_async();
      __syncthreads();
    }

    // o = intra + e^{g_i} (q_i S_{c-1})
    if (live) {
      float in[NO];
      wgmma::fence();
#pragma unroll
      for (int i = 2; i >= 0; --i)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wg_ss<0>(in, kdesc(sQ, kk, kAtom),
                   kdesc(sP + i * Sm::ST, kk, D * 128), i < 2 || kk > 0);
      wgmma::commit();
      wgmma::wait();
      pin_all(in);
      const float eg[2] = {expf(gi[0]), expf(gi[1])};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + 8 * h;
        if (i >= L) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = 8 * j + 2 * qd;
          const float y0 = __fadd_rn(acc[4 * j + 2 * h],
                                     __fmul_rn(eg[h], in[4 * j + 2 * h]));
          const float y1 =
              __fadd_rn(acc[4 * j + 2 * h + 1],
                        __fmul_rn(eg[h], in[4 * j + 2 * h + 1]));
          OutT* op = oc + (long long)i * dv + col;
          if constexpr (std::is_same<OutT, float>::value) {
            if (dv % 2 == 0 && col + 1 < dv) {
              *reinterpret_cast<float2*>(op) = make_float2(y0, y1);
            } else {
              if (col < dv) op[0] = y0;
              if (col + 1 < dv) op[1] = y1;
            }
          } else {
            if (dv % 2 == 0 && col + 1 < dv) {
              *reinterpret_cast<__nv_bfloat162*>(op) =
                  __floats2bfloat162_rn(y0, y1);
            } else {
              if (col < dv) op[0] = __float2bfloat16_rn(y0);
              if (col + 1 < dv) op[1] = __float2bfloat16_rn(y1);
            }
          }
        }
      }
    }
  }
}

// ---- bf16, D <= 64: warp-specialized and persistent ------------------------

constexpr int kWsThreads = 384;  // a producer warpgroup, two consumers
constexpr int kNS = 4;           // key-tile slots in the ring

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_test(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits until the phase of `bar` with this parity has completed; traps
// after ~2^22 tries (seconds): a fault, never a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  int tries = 0;
  while (!mbar_test(bar, parity))
    if (++tries > (1 << 22)) __trap();
}
__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared memory of gla_ws_kernel (D = 64), byte offsets from a
// 1024-aligned base; tiles swizzled as gla_mma_kernel's.
struct WsSmem {
  static constexpr uint32_t kQ = 0;               // [2 buffers][2] tiles
  static constexpr uint32_t kK = kQ + 4 * kAtom;  // [kNS] key tiles
  static constexpr uint32_t kV = kK + kNS * kAtom;
  static constexpr uint32_t kKW = kV + kNS * kAtom;  // k w ^T, 3 parts
  static constexpr uint32_t kP = kKW + 3 * kAtom;    // dS f32, S ^T parts
  static constexpr uint32_t kGq = kP + 3 * kAtom;    // [2][128] f32
  static constexpr uint32_t kGk = kGq + 2 * 128 * 4;     // [kNS][64] f32
  static constexpr uint32_t kW = kGk + kNS * kTile * 4;  // [64] f32
  static constexpr uint32_t kMeta = kW + kTile * 4;      // [2] (t, p)
  static constexpr uint32_t kBar = kMeta + 16;  // qfull, qempty, kfull,
                                                // kempty
  static constexpr uint32_t bytes = kBar + (4 + 2 * kNS) * 8 + 1024;
  static_assert(64 * 68 * 4 <= 3 * kAtom, "dS in the parts' room");
};

// K10 for bf16 inputs with dk, dv <= 64: gla_mma_kernel's arithmetic and
// order of operations, in another schedule. One block an SM takes units
// (tickets) until none is left. Warpgroup 0 is the producer: it copies
// each pass's query rows (into one of two buffers) and key tiles (into
// kNS ring slots) with cp.async, two items in flight, and signals each
// item's full barrier when its copies have landed; it waits on an
// empty barrier only after signalling everything it issued. Warpgroups 1
// and 2 consume 64 query rows each, with no block-wide barrier: each
// waits for the items it reads and frees them, so the two drift out of
// phase and one's exp and split work runs beside the other's products,
// and the next unit's tiles arrive while a unit's epilogue runs. The two
// consumers meet (a named barrier) only in a unit's pass-0 epilogue.
__global__ void __launch_bounds__(kWsThreads, 1)
    gla_ws_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ g, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ state, float* scratch, int* sync,
                  int BH, int S, int L, int dk, int dv, bool vec) {
  constexpr int D = 64, KS = D / 16, NO = D / 2;
  using Sm = WsSmem;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int ticket;
  uint8_t* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  float* gq = reinterpret_cast<float*>(sm + Sm::kGq);
  float* gk = reinterpret_cast<float*>(sm + Sm::kGk);
  float* wk = reinterpret_cast<float*>(sm + Sm::kW);
  float* Sd = reinterpret_cast<float*>(sm + Sm::kP);
  int* meta = reinterpret_cast<int*>(sm + Sm::kMeta);
  const uint32_t bar = base + Sm::kBar;
  auto qfull = [&](int b) { return bar + 8 * b; };
  auto qempty = [&](int b) { return bar + 8 * (2 + b); };
  auto kfull = [&](int s) { return bar + 8 * (4 + s); };
  auto kempty = [&](int s) { return bar + 8 * (4 + kNS + s); };
  auto qtile = [&](int b, int w) {
    return base + Sm::kQ + (2 * b + w) * kAtom;
  };
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int nc = S / L, units = BH * nc;
  const int npass = (L + kQT - 1) / kQT;
  auto ntiles = [&](int p) {  // key tiles pass p streams
    return (min((npass - p) * kQT, L) + kTile - 1) / kTile;
  };
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(qfull(b), 128);
      mbar_init(qempty(b), 256);
    }
    for (int s = 0; s < kNS; ++s) {
      mbar_init(kfull(s), 128);
      mbar_init(kempty(s), 256);
    }
  }
  __syncthreads();

  if (wg == 0) {  // ---- the producer
    uint32_t pending = 0;  // the full barrier of the last item issued
    auto signal = [&]() {  // its copies have landed: make them visible
      if (pending) {
        wgmma::fence_proxy_async();
        mbar_arrive(pending);
        pending = 0;
      }
    };
    auto issued = [&](uint32_t full) {  // the item before has landed
      cp_async_wait<1>();
      signal();
      pending = full;
    };
    auto acquire = [&](uint32_t empty, int parity) {
      if (!mbar_test(empty, parity)) {
        cp_async_wait<0>();
        signal();
        mbar_wait(empty, parity);
      }
    };
    int qi = 0, ki = 0;
    while (true) {
      if (wt == 0) ticket = atomicAdd(sync, 1);
      named_bar(4, 128);
      const int t = ticket;
      named_bar(4, 128);
      const int b0 = qi % 2;
      if (t >= units) {  // a query item that says there is no more
        acquire(qempty(b0), ((qi / 2) & 1) ^ 1);
        cp_async_wait<0>();
        signal();
        if (wt == 0) meta[2 * b0] = -1;
        mbar_arrive(qfull(b0));
        break;
      }
      const long long row0 =
          (long long)(t % BH) * S + (long long)(t / BH) * L;
      const __nv_bfloat16* qc = q + row0 * dk;
      const __nv_bfloat16* kc = k + row0 * dk;
      const __nv_bfloat16* vc = v + row0 * dv;
      const float* gc = g + row0;
      for (int p = 0; p < npass; ++p) {
        const int b = qi % 2, q0 = (npass - 1 - p) * kQT;
        acquire(qempty(b), ((qi / 2) & 1) ^ 1);
        if (wt == 0) {
          meta[2 * b] = t;
          meta[2 * b + 1] = p;
        }
#pragma unroll
        for (int w = 0; w < 2; ++w)
          stage<D, 64, 128>(qtile(b, w), qc, q0 + 64 * w, L, dk, vec, wt);
        stage_g<128>(gq + kQT * b, gc, q0, kQT, L, wt);
        cp_async_commit();
        issued(qfull(b));
        ++qi;
        const int nkt = ntiles(p);
        for (int kt = 0; kt < nkt; ++kt, ++ki) {
          const int s = ki % kNS;
          acquire(kempty(s), ((ki / kNS) & 1) ^ 1);
          stage<D, kTile, 128>(base + Sm::kK + s * kAtom, kc, kt * kTile, L,
                               dk, vec, wt);
          stage<D, kTile, 128>(base + Sm::kV + s * kAtom, vc, kt * kTile, L,
                               dv, vec, wt);
          stage_g<128>(gk + kTile * s, gc, kt * kTile, kTile, L, wt);
          cp_async_commit();
          issued(kfull(s));
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup cw takes rows [64 cw, 64 cw + 64) of a
  // pass; consumer 0 also takes dS
  const int cw = wg - 1, ctid = tid - 128;
  const int warp = wt / 32, gr = (wt % 32) / 4, qd = wt % 4;
  const bool has_ds = cw == 0;
  const uint32_t sKW = base + Sm::kKW, sP = base + Sm::kP;
  int* flags = sync + 1;
  float ds[NO];
  int qi = 0, ki = 0;
  while (true) {
    const int b = qi % 2;
    mbar_wait(qfull(b), (qi / 2) & 1);
    const int t = meta[2 * b], pi = meta[2 * b + 1];
    if (t < 0) break;
    const int c = t / BH, bh = t % BH;
    const long long row0 = (long long)bh * S + (long long)c * L;
    __nv_bfloat16* oc = o + row0 * dv;
    const float gl = g[row0 + L - 1];
    const bool first = pi == 0;  // the last rows, every key, dS
    if (first) {
#pragma unroll
      for (int i = 0; i < NO; ++i) ds[i] = 0.f;
    }
    const int q0 = (npass - 1 - pi) * kQT;
    const int rw = q0 + 64 * cw;  // this warpgroup's first row
    const bool live = rw < L;
    const int r0 = rw + 16 * warp + gr;  // this thread's rows r0, r0 + 8
    const uint32_t sQ = qtile(b, cw);
    float gi[2];
    gi[0] = gq[kQT * b + 64 * cw + 16 * warp + gr];
    gi[1] = gq[kQT * b + 64 * cw + 16 * warp + gr + 8];
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;

    const int nkt = ntiles(pi);
    for (int kt = 0; kt < nkt; ++kt, ++ki) {
      const int s = ki % kNS;
      mbar_wait(kfull(s), (ki / kNS) & 1);
      const int j0 = kt * kTile;
      const uint32_t sK = base + Sm::kK + s * kAtom;
      const uint32_t sV = base + Sm::kV + s * kAtom;
      const float* gkt = gk + kTile * s;
      if (first && has_ds) {  // (k w)^T of the tile, in parts
        if (wt < kTile)
          wk[wt] = j0 + wt < L ? expf(__fsub_rn(gl, gkt[wt])) : 0.f;
        named_bar(1, 128);
        for (int e = wt; e < D * 8; e += 128) {
          const int d = e % D, cc = e / D;  // row d of k^T, keys 8 cc..
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int j = 8 * cc + u;
            const unsigned short kv = *reinterpret_cast<const unsigned short*>(
                sm + Sm::kK + s * kAtom + j * 128 + (((d / 8) ^ (j % 8)) << 4) +
                (d % 8) * 2);
            x[u] = __fmul_rn(__uint_as_float((uint32_t)kv << 16), wk[j]);
          }
          store_parts(sKW + d * 128 + ((cc ^ (d % 8)) << 4), kAtom, x);
        }
        wgmma::fence_proxy_async();
        named_bar(1, 128);
      }
      if (live && j0 <= rw + 63) {
        float sc[32];
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wg_ss<0>(sc, kdesc(sQ, kk, kAtom), kdesc(sK, kk, kAtom), kk > 0);
        wgmma::commit();
        wgmma::wait();
        pin_all(sc);
        // P = S e^{g_i - g_j}; the causal and chunk-end mask where the
        // tile crosses the diagonal or the chunk's end
        const bool mask = j0 + 63 > rw || j0 + 64 > L;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e, jl = 8 * j + 2 * qd + e;
              const float p =
                  __fmul_rn(sc[i], expf(__fsub_rn(gi[h], gkt[jl])));
              sc[i] = mask && (j0 + jl > r0 + 8 * h || j0 + jl >= L) ? 0.f
                                                                     : p;
            }
        // O += P V, P as A fragments in three parts, two k16 steps a batch
#pragma unroll
        for (int kb = 0; kb < 4; kb += 2) {
          uint32_t pa[2][3][4], part[3];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              split3(sc[8 * (kb + kk) + 2 * r], sc[8 * (kb + kk) + 2 * r + 1],
                     part);
#pragma unroll
              for (int i = 0; i < 3; ++i) pa[kk][i][r] = part[i];
            }
          pin_all(acc);
          wgmma::fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int i = 2; i >= 0; --i)
              wg_rs(acc, pa[kk][i], mndesc(sV, kb + kk));
          wgmma::commit();
          wgmma::wait();
          pin_all(acc);
        }
      }
      if (first && has_ds) {  // dS += (k w)^T v over the tile's keys
        pin_all(ds);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 2; i >= 0; --i)
            wg_ss<1>(ds, kdesc(sKW + i * kAtom, kk, 0), mndesc(sV, kk), 1);
        wgmma::commit();
        wgmma::wait();
        pin_all(ds);
      }
      mbar_arrive(kempty(s));  // this warpgroup is done with slot s
    }

    if (first) {  // S_{c-1} in, S_c out: the two consumers together
      named_bar(3, 256);
      if (c > 0) {
        if (ctid == 0) {
          const int* f = flags + (long long)bh * nc + c - 1;
          int polls = 0;
          while (ld_acquire(f) == 0) {
            __nanosleep(64);
            if (++polls > (1 << 24)) __trap();
          }
        }
        named_bar(3, 256);
      }
      const float* s_in =
          scratch + (c > 0 ? slot(bh, c - 1, nc, dk, dv) : 0);
      if (has_ds) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              Sd[(16 * warp + gr + 8 * h) * (D + 4) + 8 * j + 2 * qd + e] =
                  ds[4 * j + 2 * h + e];
      }
      named_bar(3, 256);
      float* s_out = c + 1 < nc ? scratch + slot(bh, c, nc, dk, dv)
                                : state + (long long)bh * dk * dv;
      const float egl = expf(gl);
      constexpr int N8 = D * D / 256 < 8 ? D * D / 256 : 8;
      for (int e0 = 0; e0 < D * D; e0 += N8 * 256) {
        float x[N8];  // S_{c-1}, its loads in flight together
#pragma unroll
        for (int u = 0; u < N8; ++u) {
          const int e = e0 + ctid + u * 256, r = e / D, col = e % D;
          x[u] = c > 0 && r < dk && col < dv ? __ldcg(s_in + r * dv + col)
                                             : 0.f;
        }
#pragma unroll
        for (int u = 0; u < N8; ++u) {
          const int e = e0 + ctid + u * 256, r = e / D, col = e % D;
          if (r < dk && col < dv)
            s_out[r * dv + col] =
                __fadd_rn(__fmul_rn(egl, x[u]), Sd[r * (D + 4) + col]);
        }
      }
      named_bar(3, 256);  // S_c written; Sd read
      if (c + 1 < nc && ctid == 0)
        st_release(flags + (long long)bh * nc + c, 1);
      // S_{c-1}^T in three parts, every consumer's inter-chunk operand
      for (int e = ctid; e < D * D / 8; e += 256) {
        const int n = e % D, kc = e / D;
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = 8 * kc + u;
          x[u] = c > 0 && r < dk && n < dv ? __ldcg(s_in + r * dv + n) : 0.f;
        }
        store_parts(sP + n * 128 + ((kc ^ (n % 8)) << 4), kAtom, x);
      }
      wgmma::fence_proxy_async();
      named_bar(3, 256);
    }

    // o = intra + e^{g_i} (q_i S_{c-1})
    if (live) {
      float in[NO];
      wgmma::fence();
#pragma unroll
      for (int i = 2; i >= 0; --i)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wg_ss<0>(in, kdesc(sQ, kk, kAtom), kdesc(sP + i * kAtom, kk, 0),
                   i < 2 || kk > 0);
      wgmma::commit();
      wgmma::wait();
      pin_all(in);
      const float eg[2] = {expf(gi[0]), expf(gi[1])};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + 8 * h;
        if (i >= L) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = 8 * j + 2 * qd;
          const float y0 = __fadd_rn(acc[4 * j + 2 * h],
                                     __fmul_rn(eg[h], in[4 * j + 2 * h]));
          const float y1 =
              __fadd_rn(acc[4 * j + 2 * h + 1],
                        __fmul_rn(eg[h], in[4 * j + 2 * h + 1]));
          __nv_bfloat16* op = oc + (long long)i * dv + col;
          if (dv % 2 == 0 && col + 1 < dv) {
            *reinterpret_cast<__nv_bfloat162*>(op) =
                __floats2bfloat162_rn(y0, y1);
          } else {
            if (col < dv) op[0] = __float2bfloat16_rn(y0);
            if (col + 1 < dv) op[1] = __float2bfloat16_rn(y1);
          }
        }
      }
    }
    mbar_arrive(qempty(b));  // done with the query buffer
    ++qi;
  }
}

// ---- f32: CUDA cores -------------------------------------------------------

template <int D>
constexpr size_t fma_smem_bytes() {
  return (size_t)(D * D + 2 * kTile * (D + 1) + kTile * D +
                  kTile * (kTile + 1) + 2 * kTile) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    gla_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   float* __restrict__ o, float* __restrict__ state,
                   float* scratch, int* sync, int BH, int S, int L, int dk,
                   int dv) {
  extern __shared__ float sh[];
  constexpr int LD = D + 1;      // row stride of Qs and Ks
  constexpr int LP = kTile + 1;  // row stride of Ps
  constexpr int R = D / 16;      // state rows and output columns a thread
  float* St = sh;                // [D][D], S_{c-1}
  float* Qs = St + D * D;        // [kTile][LD]
  float* Ks = Qs + kTile * LD;   // [kTile][LD]
  float* Vs = Ks + kTile * LD;   // [kTile][D]
  float* Ps = Vs + kTile * D;    // [kTile][LP], decayed scores of a tile
  float* gq = Ps + kTile * LP;   // [kTile], g of the query tile
  float* gk = gq + kTile;        // [kTile], g of the key tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const int t = take_ticket(sync);
  const int nc = S / L, c = t / BH, bh = t % BH;
  const long long row0 = (long long)bh * S + (long long)c * L;
  const float* qp = q + row0 * dk;
  const float* kp = k + row0 * dk;
  const float* vp = v + row0 * dv;
  const float* gp = g + row0;
  float* op = o + row0 * dv;
  const float gl = gp[L - 1];
  int* flags = sync + 1;

  // dS from the chunk's weighted keys and its values
  float upd[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int cc = 0; cc < R; ++cc) upd[a][cc] = 0.f;
  for (int j0 = 0; j0 < L; j0 += kTile) {
    __syncthreads();  // earlier reads of Ks, Vs are done
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D, col = e % D;
      const bool row = j0 + r < L;
      Ks[r * LD + col] =
          (row && col < dk)
              ? __fmul_rn(kp[(long long)(j0 + r) * dk + col],
                          expf(__fsub_rn(gl, gp[j0 + r])))
              : 0.f;
      Vs[r * D + col] =
          (row && col < dv) ? vp[(long long)(j0 + r) * dv + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kv[R], vv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) kv[a] = Ks[j * LD + ty + 16 * a];
#pragma unroll
      for (int cc = 0; cc < R; ++cc) vv[cc] = Vs[j * D + tx + 16 * cc];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int cc = 0; cc < R; ++cc)
          upd[a][cc] = __fmaf_rn(kv[a], vv[cc], upd[a][cc]);
    }
  }

  // S_{c-1} in, S_c out
  if (c > 0) wait_flag(flags + (long long)bh * nc + c - 1);
  const float* s_in =
      scratch + (c > 0 ? slot(bh, c - 1, nc, dk, dv) : 0);
  for (int e = tid; e < D * D; e += kThreads) {
    const int r = e / D, col = e % D;
    St[e] = c > 0 && r < dk && col < dv ? __ldcg(s_in + r * dv + col) : 0.f;
  }
  __syncthreads();
  float* s_out = c + 1 < nc ? scratch + slot(bh, c, nc, dk, dv)
                           : state + (long long)bh * dk * dv;
  const float egl = expf(gl);
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int cc = 0; cc < R; ++cc) {
      const int d = ty + 16 * a, col = tx + 16 * cc;
      if (d < dk && col < dv)
        s_out[d * dv + col] =
            __fadd_rn(__fmul_rn(egl, St[d * D + col]), upd[a][cc]);
    }
  if (c + 1 < nc) publish(flags + (long long)bh * nc + c);

  // the output, one 64-row query tile at a time
  for (int i0 = 0; i0 < L; i0 += kTile) {
    __syncthreads();  // earlier reads of Qs, gq, Ks, Vs, Ps are done
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D, col = e % D;
      Qs[r * LD + col] = (i0 + r < L && col < dk)
                             ? qp[(long long)(i0 + r) * dk + col]
                             : 0.f;
    }
    for (int r = tid; r < kTile; r += kThreads)
      gq[r] = i0 + r < L ? gp[i0 + r] : 0.f;
    __syncthreads();
    // the inter-chunk read q_i S_{c-1}
    float inter[4][R], acc[4][R];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < R; ++cc) inter[i][cc] = acc[i][cc] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], sv[R];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int cc = 0; cc < R; ++cc) sv[cc] = St[d * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < R; ++cc)
          inter[i][cc] = __fmaf_rn(qv[i], sv[cc], inter[i][cc]);
    }
    // the intra-chunk sum, one key tile at a time up to the diagonal
    for (int j0 = 0; j0 <= i0; j0 += kTile) {
      __syncthreads();  // the previous key tile's reads are done
      for (int e = tid; e < kTile * D; e += kThreads) {
        const int r = e / D, col = e % D;
        const bool row = j0 + r < L;
        Ks[r * LD + col] =
            (row && col < dk) ? kp[(long long)(j0 + r) * dk + col] : 0.f;
        Vs[r * D + col] =
            (row && col < dv) ? vp[(long long)(j0 + r) * dv + col] : 0.f;
      }
      for (int r = tid; r < kTile; r += kThreads)
        gk[r] = j0 + r < L ? gp[j0 + r] : 0.f;
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sc[i][j] = __fmaf_rn(qv[i], kv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = i0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = j0 + tx + 16 * j;
          Ps[(ty + 16 * i) * LP + tx + 16 * j] =
              (jj <= ii && jj < L)
                  ? __fmul_rn(sc[i][j], expf(__fsub_rn(gq[ty + 16 * i],
                                                       gk[tx + 16 * j])))
                  : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float pv[4], vv[R];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + j];
#pragma unroll
        for (int cc = 0; cc < R; ++cc) vv[cc] = Vs[j * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < R; ++cc)
            acc[i][cc] = __fmaf_rn(pv[i], vv[cc], acc[i][cc]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ii = i0 + ty + 16 * i;
      if (ii >= L) continue;
      const float eg = expf(gq[ty + 16 * i]);
#pragma unroll
      for (int cc = 0; cc < R; ++cc) {
        const int col = tx + 16 * cc;
        if (col < dv)
          op[(long long)ii * dv + col] =
              __fadd_rn(acc[i][cc], __fmul_rn(eg, inter[i][cc]));
      }
    }
  }
}

}  // namespace

// K10. q, k [BH, S, dk], v [BH, S, dv], all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1), any 2-byte (bf16) or 4-byte (f32) alignment; o
// [BH, S, dv] in their dtype, or float32 for bfloat16 inputs when of32 = 1
// (gla_mma_kernel only: max(dk, dv) over 64); g [BH, S] and state [BH, dk,
// dv] float32; scratch float32 [BH, S / L, dk, dv]; sync int32 [1 + BH S /
// L] (zeroed here, on the stream); S a multiple of L; dk, dv <= 128. One
// kernel launch of BH S / L blocks after the memset. Returns the CUDA error
// of the memset or cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim over 128 or a float32 output that
// gla_ws_kernel would have to write.
extern "C" int gla_scan_fwd(const void* q, const void* k, const void* v,
                            const float* g, void* o, float* state,
                            float* scratch, int* sync, int BH, int S, int L,
                            int dk, int dv, int bf16, int of32,
                            void* stream) {
  const int d = dk > dv ? dk : dv;
  if (bf16 && (d > 128 || (of32 && d <= 64)))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int units = BH * (S / L);
  const cudaError_t err =
      cudaMemsetAsync(sync, 0, (size_t)(1 + units) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (bf16) {
    const bool vec = dk % 8 == 0 && dv % 8 == 0 && (uintptr_t)q % 16 == 0 &&
                     (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
    auto mma = [&](auto kernel, auto* out) {
      return float_io::launch(kernel, units, kThreads, Smem<128>::bytes, s,
                              (const __nv_bfloat16*)q,
                              (const __nv_bfloat16*)k,
                              (const __nv_bfloat16*)v, g, out, state,
                              scratch, sync, BH, S, L, dk, dv, vec);
    };
    if (d > 64)
      return of32 ? mma(gla_mma_kernel<128, float>, (float*)o)
                  : mma(gla_mma_kernel<128, __nv_bfloat16>,
                        (__nv_bfloat16*)o);
    // persistent: one block an SM
    int dev = 0, sms = 0;
    cudaError_t e = cudaFuncSetAttribute(
        gla_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)WsSmem::bytes);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    gla_ws_kernel<<<units < sms ? units : sms, kWsThreads, WsSmem::bytes,
                    s>>>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                         (const __nv_bfloat16*)v, g, (__nv_bfloat16*)o,
                         state, scratch, sync, BH, S, L, dk, dv, vec);
    return (int)cudaGetLastError();
  }
  return float_io::dispatch_head_dim(dk > dv ? dk : dv, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return float_io::launch(gla_fma_kernel<D>, units, kThreads,
                            fma_smem_bytes<D>(), s, (const float*)q,
                            (const float*)k, (const float*)v, g, (float*)o,
                            state, scratch, sync, BH, S, L, dk, dv);
  });
}
