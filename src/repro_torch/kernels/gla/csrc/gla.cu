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
// Heads wider than 128 (mLSTM's 1024) in bf16 take the wide route
// (kernels/gla/kernel.py::gla_wide), whole: gla_wide_scores_kernel writes
// each chunk's decayed, masked scores P in float32 once, then
// gla_wide_kernel runs a unit per (head, chunk, 128-wide block of v): the
// state phase streams k in 128-column dk slices and writes S_c's block
// slice by slice through the same look-back; the output phase streams q
// in 64-column slices for the inter-chunk read, reads P for the
// intra-chunk sum, and keeps o's block in float32 registers until its one
// rounding (notes at the kernels). v's last block runs 64 wide when it
// has at most 64 columns (the mLSTM normalizer's one). Float32 inputs and
// the CPU cut wide heads into 128-wide blocks instead
// (kernels/gla/ops.py::gla_blocked): a launch takes q's and k's dk blocks
// as extra heads and one block of v, and gla_mma_kernel<128, float>
// writes float32 partial outputs, summed over the dk blocks before one
// rounding.
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

// d[64 x N] (+)= A[64 x 16] B[16 x N], both in shared memory, A K-major
// (TA = 0) or MN-major (TA = 1), B K-major (TB = 0) or MN-major (TB = 1);
// scale_d = 0 overwrites d.
template <int TB, int TA = 0>
__device__ __forceinline__ void wg_ss(float (&d)[16], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %20, %19;\n}\n"
      : WG_D16(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}
template <int TB, int TA = 0>
__device__ __forceinline__ void wg_ss(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}
template <int TB, int TA = 0>
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
      "%64, %65, p, 1, 1, %68, %67;\n}\n"
      : WG_D64(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
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

// Rows [row0, row0 + R) and columns [col0, col0 + D) of a chunk's
// row-major bf16 matrix at src (row stride ld) into the swizzled R-row
// tile at dst (R * 128-byte sub-tiles), zero past L rows and past ncols
// columns, by NT threads (thread tid). vec (ld and col0 multiples of 8,
// src 16-byte aligned, and every column below ld readable): whole 16-byte
// chunks by cp.async; else element by element.
template <int D, int R, int NT = kThreads>
__device__ __forceinline__ void stage_cols(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           int row0, int L, int ld, int col0,
                                           int ncols, bool vec,
                                           int tid = threadIdx.x) {
  constexpr int CH = D / 8;
  static_assert(R * CH % NT == 0, "whole passes");
#pragma unroll
  for (int n = 0; n < R * CH / NT; ++n) {
    const int e = tid + n * NT;
    const int r = e / CH, c = e % CH, c0 = col0 + 8 * c, row = row0 + r;
    const uint32_t d =
        dst + (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
    const bool live = row < L && c0 < ncols;
    const __nv_bfloat16* s = src + (long long)row * ld + c0;
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
        const uint32_t lo = live && a < ncols ? p[2 * i] : 0u;
        const uint32_t hi = live && a + 1 < ncols ? p[2 * i + 1] : 0u;
        w[i] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// Rows [row0, row0 + R) of a chunk's row-major [L, cols] bf16 matrix at
// src into the swizzled R-row tile at dst: stage_cols of all its columns.
template <int D, int R, int NT = kThreads>
__device__ __forceinline__ void stage(uint32_t dst, const __nv_bfloat16* src,
                                      int row0, int L, int cols, bool vec,
                                      int tid = threadIdx.x) {
  stage_cols<D, R, NT>(dst, src, row0, L, cols, 0, cols, vec, tid);
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

using wgmma::mbar_arrive;
using wgmma::mbar_init;
using wgmma::mbar_test;
using wgmma::mbar_wait;
using wgmma::named_bar;

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


// ---- bf16, heads wider than 128: the scores, then the scan ---------------

constexpr int kWideMaxL = 256;  // chunk rows the scan's value tiles hold
constexpr int kWideKT = 4;      // key tiles a round of the scores kernel

// Shared memory of gla_wide_scores_kernel, byte offsets from a 1024-aligned
// base: two slots of a query tile and kWideKT key tiles, 64 dk columns
// each, then g of the chunk.
struct WideScoresSmem {
  static constexpr uint32_t kSlot = (1 + kWideKT) * kAtom;
  static constexpr uint32_t kG = 2 * kSlot;
  static constexpr uint32_t bytes = kG + kWideMaxL * 4 + 1024;
};

// The chunk's scores for heads wider than 128, the first of the wide
// route's two launches: block (head, chunk, query tile qt) writes
//
//   P[i, j] = (q_i . k_j) e^{g_i - g_j}, 0 where j > i or past L,
//
// for its 64 rows and every key tile kt <= qt, float32, to the tile
// (qt, kt) of the [BH nc][nt (nt + 1) / 2][64][64] buffer (lower tiles in
// row order). q k^T is one exact bf16 product with float32 sums over dk,
// streamed in 64-column slices through a 2-slot cp.async ring (a query
// tile and up to four key tiles a slot); warpgroup w takes key tiles w
// and w + 2 of a round of four. The scan then reads each P once for every
// 128-wide block of v, where the one-launch alternative recomputes q k^T
// for each block.
__global__ void __launch_bounds__(kThreads, 1)
    gla_wide_scores_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const float* __restrict__ g,
                           float* __restrict__ P, int S, int L, int dk,
                           bool vec) {
  using Sm = WideScoresSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  float* gs = reinterpret_cast<float*>(sm + Sm::kG);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, gr = (wt % 32) / 4, qd = wt % 4;
  const int nt = (L + kTile - 1) / kTile;
  const int bhc = blockIdx.x / nt, qt = blockIdx.x % nt;
  const long long row0 = (long long)bhc * L;  // (bh S + c L): S = nc L
  const __nv_bfloat16* qc = q + row0 * dk;
  const __nv_bfloat16* kc = k + row0 * dk;
  const int ns = (dk + 63) / 64;
  float* pc = P + ((long long)bhc * (nt * (nt + 1) / 2) + qt * (qt + 1) / 2) *
                      (kTile * kTile);
  stage_g(gs, g + row0, 0, nt * kTile, L);
  cp_async_commit();
  for (int kt0 = 0; kt0 <= qt; kt0 += kWideKT) {
    const int nk = min(kWideKT, qt + 1 - kt0);
    auto issue = [&](int sl) {
      const uint32_t slot = base + (sl & 1) * Sm::kSlot;
      stage_cols<64, kTile>(slot, qc, qt * kTile, L, dk, 64 * sl, dk, vec);
      for (int i = 0; i < nk; ++i)
        stage_cols<64, kTile>(slot + (1 + i) * kAtom, kc, (kt0 + i) * kTile,
                              L, dk, 64 * sl, dk, vec);
      cp_async_commit();
    };
    float a0[32], a1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a0[i] = a1[i] = 0.f;
    issue(0);
    for (int sl = 0; sl < ns; ++sl) {
      if (sl + 1 < ns) {
        issue(sl + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      wgmma::fence_proxy_async();
      __syncthreads();  // slice sl (and g) is in
      const uint32_t slot = base + (sl & 1) * Sm::kSlot;
      pin_all(a0);
      pin_all(a1);
      wgmma::fence();
      if (wg < nk) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg_ss<0>(a0, kdesc(slot, kk, 0),
                   kdesc(slot + (1 + wg) * kAtom, kk, 0), 1);
      }
      if (wg + 2 < nk) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg_ss<0>(a1, kdesc(slot, kk, 0),
                   kdesc(slot + (3 + wg) * kAtom, kk, 0), 1);
      }
      wgmma::commit();
      wgmma::wait();
      pin_all(a0);
      pin_all(a1);
      __syncthreads();  // every warp is done with the slot
    }
    // P = S e^{g_i - g_j}, 0 above the diagonal and past the chunk's end
    auto put = [&](const float (&a)[32], int kt) {
      float* pt = pc + (long long)kt * (kTile * kTile);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = 16 * warp + gr + 8 * h, i = qt * kTile + rl;
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = 8 * j + 2 * qd + e, jj = kt * kTile + jl;
            p[e] = jj > i || jj >= L || i >= L
                       ? 0.f
                       : __fmul_rn(a[4 * j + 2 * h + e],
                                   expf(__fsub_rn(gs[i], gs[jj])));
          }
          *reinterpret_cast<float2*>(pt + rl * kTile + 8 * j + 2 * qd) =
              make_float2(p[0], p[1]);
        }
    };
    if (wg < nk) put(a0, kt0 + wg);
    if (wg + 2 < nk) put(a1, kt0 + wg + 2);
  }
}

// Shared memory of the scan's unit at a value block NV wide, byte offsets
// from a 1024-aligned base: a region the two phases share (the state
// phase: a 2-slot ring of 64-key x 128-dk key tiles, the three parts of
// k w in the key tiles' own layout, and S's 128-row slice of the block in
// float32, rows kSW floats apart; the output phase: two buffers of a
// slice of up to four 64-row query tiles, 64 dk columns, and the three
// parts of S_{c-1}'s slice, [64 dk][NV]), g and w of the chunk, then its
// value block, [nt][64 keys][NV].
constexpr int kSW = 128 + 4;  // the float32 slice's row stride
template <int NV>
struct WideSmem {
  static constexpr uint32_t KT = 2 * kAtom;  // a key tile, a part of k w
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kKW = kK + 2 * KT;
  static constexpr uint32_t kS = kKW + 3 * KT;
  static constexpr uint32_t QB = 4 * kAtom;  // a query slice buffer
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t SP = (NV / 64) * kAtom;  // a part of S_{c-1}
  static constexpr uint32_t kSP = kQ + 2 * QB;
  static constexpr uint32_t kSEnd = kS + 128 * kSW * 4;
  static constexpr uint32_t kR = ((kSEnd > kSP + 3 * SP ? kSEnd
                                                         : kSP + 3 * SP) +
                                  1023) / 1024 * 1024;
  static constexpr uint32_t kG = kR;
  static constexpr uint32_t kW = kG + kWideMaxL * 4;
  static constexpr uint32_t kV = kW + kWideMaxL * 4;
  static constexpr uint32_t VT = (NV / 64) * kAtom;  // a value tile
  static __host__ __device__ constexpr uint32_t bytes(int nt) {
    return kV + nt * VT + 1024;  // + alignment
  }
  static_assert(kV % 1024 == 0, "value tiles 1024-aligned");
};
static_assert(WideSmem<128>::bytes(kWideMaxL / 64) <= 232448,
              "an SM's shared memory");

// Eight float32 values of a row at p (32-byte aligned), those of columns
// [c, c + 8) that are below n and of a live row, else 0: two 16-byte
// loads through L2 when all eight are live.
__device__ __forceinline__ void load8(const float* p, bool row, int c, int n,
                                      float (&x)[8]) {
  if (row && c + 8 <= n) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = row && c + u < n ? __ldcg(p + u) : 0.f;
  }
}

// The scan's unit (head bh, chunk c, value block j of NV columns: nv of
// them live) on its block's two warpgroups. S's scratch rows are ldv
// floats apart (a multiple of 8), the final state's dv.
//
//   state phase: wait for S_{c-1}[:, j] (the look-back, as gla_mma_kernel);
//   then for each 128-row dk slice, dS[slice, j] = sum over key tiles of
//   (k w)^T v_j, k w split in three bf16 parts in the key tile's own
//   layout (the product reads it MN-major, transposed: warpgroup w takes
//   the slice's rows [64 w, 64 w + 64)), and S_c[slice, j] = e^{g_L}
//   S_{c-1} + dS in shared memory, S_{c-1}'s slice copied in by cp.async
//   a slice ahead and S_c's copied out in 16-byte stores; then publish.
//
//   output phase: for up to four 64-row query tiles at a time (warpgroup w
//   takes tiles w and 3 - w, so the causal work splits evenly), O = q
//   S_{c-1}[:, j] over 64-row dk slices, S_{c-1}'s slice in three parts
//   read MN-major (its own row layout), the next slice's query tiles and
//   S values in flight while a slice is computed; O *= e^{g_i}; then O +=
//   P v_j over the key tiles up to the diagonal (P read from the scores in
//   float32 and split in three parts in registers), rounded once to bf16.
//
// o's block stays in float32 registers from the inter-chunk read to the
// rounding: no partial output reaches device memory, no head is copied.
template <int NV>
__device__ __forceinline__ void wide_unit(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ P, __nv_bfloat16* __restrict__ o,
    float* __restrict__ state, float* scratch, int* sync, int t, int BH,
    int S, int L, int dk, int dv, int ldv, bool vec_qk, bool vec_v) {
  using Sm = WideSmem<NV>;
  constexpr int NO = NV / 2;          // accumulators of m64nNV a thread
  constexpr int NI = 64 * NV / 8 / kThreads;  // 8-value items a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  float* gs = reinterpret_cast<float*>(sm + Sm::kG);
  float* ws = reinterpret_cast<float*>(sm + Sm::kW);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, gr = (wt % 32) / 4, qd = wt % 4;
  const int nc = S / L, nt = (L + kTile - 1) / kTile;
  const int nj = (dv + 127) / 128, per = BH * nj;
  const int c = t / per, bh = (t % per) / nj, j = t % nj;
  const int col0 = 128 * j, nv = min(128, dv - col0);
  const long long row0 = (long long)bh * S + (long long)c * L;
  const __nv_bfloat16* qc = q + row0 * dk;
  const __nv_bfloat16* kc = k + row0 * dk;
  int* flags = sync + 1;
  auto vtile = [&](int kt) { return base + Sm::kV + kt * Sm::VT; };

  // the value block and g, once for both phases
  for (int kt = 0; kt < nt; ++kt)
    stage_cols<NV, kTile>(vtile(kt), v + row0 * ldv, kt * kTile, L, ldv,
                          col0, dv, vec_v);
  stage_g(gs, g + row0, 0, nt * kTile, L);
  cp_async_commit();
  cp_async_wait<0>();
  wgmma::fence_proxy_async();
  __syncthreads();
  const float gl = gs[L - 1], egl = expf(gl);
  for (int e = tid; e < nt * kTile; e += kThreads)
    ws[e] = e < L ? expf(__fsub_rn(gl, gs[e])) : 0.f;

  // ---- the state phase
  if (c > 0) wait_flag(flags + t - per);  // its barrier also orders ws
  const float* s_in =
      scratch + (c > 0 ? ((long long)bh * nc + c - 1) * dk * ldv : 0);
  const bool last = c + 1 == nc;
  float* s_out = last ? state + (long long)bh * dk * dv
                      : scratch + ((long long)bh * nc + c) * dk * ldv;
  const int ld_out = last ? dv : ldv;
  const int ns = (dk + 127) / 128, total = ns * nt;
  auto issue_k = [&](int it) {  // key tile it % nt of dk slice it / nt
    stage_cols<128, kTile>(base + Sm::kK + (it & 1) * Sm::KT, kc,
                           (it % nt) * kTile, L, dk, 128 * (it / nt), dk,
                           vec_qk);
    cp_async_commit();
  };
  float* sf = reinterpret_cast<float*>(sm + Sm::kS);
  // S_{c-1}'s rows [128 sl, 128 sl + 128) of the block's columns (all
  // 128 of the scratch's padded row: columns past nv are never stored)
  // into sf, 16-byte copies, one group
  auto issue_s = [&](int sl) {
    for (int e = tid; e < 128 * 32; e += kThreads) {
      const int r = e / 32, ch = e % 32, row = 128 * sl + r;
      const bool live = row < dk && 4 * ch < nv;
      const float* src = s_in + (long long)row * ldv + col0 + 4 * ch;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(sf + r * kSW + 4 * ch)),
                   "l"(live ? src : s_in), "r"(live ? 16 : 0)
                   : "memory");
    }
    cp_async_commit();
  };
  float ds[NO];
  if (c > 0) issue_s(0);
  issue_k(0);
  for (int it = 0; it < total; ++it) {
    const int kt = it % nt, sl = it / nt;
    if (kt == 0) {
#pragma unroll
      for (int e = 0; e < NO; ++e) ds[e] = 0.f;
    }
    if (it + 1 < total) {
      issue_k(it + 1);
      // a slice's first key tile may leave that slice's S copy, issued
      // after the last tile of the slice before, in flight
      if (c > 0 && kt == 0 && sl > 0 && nt > 1)
        cp_async_wait<2>();
      else
        cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // key tile it is in (read by the threads below)
    const uint32_t kt_sm = Sm::kK + (it & 1) * Sm::KT;
    // k w in three parts, in the key tile's layout: key row jk, dk
    // columns 8 ch..
    for (int e = tid; e < kTile * 16; e += kThreads) {
      const int jk = e / 16, ch = e % 16;
      const uint32_t off =
          (ch / 8) * kAtom + jk * 128 + (((ch % 8) ^ (jk % 8)) << 4);
      const uint4 kv = *reinterpret_cast<const uint4*>(sm + kt_sm + off);
      const uint32_t kw4[4] = {kv.x, kv.y, kv.z, kv.w};
      const float w = ws[kt * kTile + jk];
      float x[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x[2 * u] = __fmul_rn(lo_f32(kw4[u]), w);
        x[2 * u + 1] = __fmul_rn(hi_f32(kw4[u]), w);
      }
      store_parts(base + Sm::kKW + off, Sm::KT, x);
    }
    wgmma::fence_proxy_async();
    __syncthreads();
    pin_all(ds);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 2; i >= 0; --i)
        wg_ss<1, 1>(ds, mndesc(base + Sm::kKW + i * Sm::KT + wg * kAtom, kk),
                    mndesc(vtile(kt), kk), 1);
    wgmma::commit();
    wgmma::wait();
    pin_all(ds);
    if (kt == nt - 1) {  // S_c = e^{g_L} S_{c-1} + dS in place, then out
      const int rs = 64 * wg + 16 * warp + gr;  // slice rows rs, rs + 8
#pragma unroll
      for (int jj = 0; jj < NV / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* p = sf + (rs + 8 * h) * kSW + 8 * jj + 2 * qd + e;
            *p = __fadd_rn(__fmul_rn(egl, c > 0 ? *p : 0.f),
                           ds[4 * jj + 2 * h + e]);
          }
      __syncthreads();
      for (int e = tid; e < 128 * 32; e += kThreads) {
        const int r = e / 32, ch = e % 32, row = 128 * sl + r;
        if (row >= dk || 4 * ch >= nv) continue;
        const float* src = sf + r * kSW + 4 * ch;
        float* dst = s_out + (long long)row * ld_out + col0 + 4 * ch;
        if (ld_out % 4 == 0 && 4 * ch + 4 <= nv) {
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src);
        } else {
          for (int u = 0; u < 4 && 4 * ch + u < nv; ++u) dst[u] = src[u];
        }
      }
      __syncthreads();  // sf is read out before the next slice's copy
      if (c > 0 && sl + 1 < ns) issue_s(sl + 1);
    } else {
      __syncthreads();  // the key slot and the parts are free
    }
  }
  if (!last) publish(flags + t);
  __syncthreads();  // the shared region passes to the output phase

  // ---- the output phase, up to four query tiles a pass
  const int ns2 = (dk + 63) / 64;
  const int ntri = nt * (nt + 1) / 2;
  const float* pc = P + (long long)(bh * nc + c) * ntri * (kTile * kTile);
  __nv_bfloat16* oc = o + row0 * dv;
  for (int pb = 0; pb < nt; pb += 4) {
    const int ta = pb + wg, tb = pb + 3 - wg;
    const bool la = ta < nt, lb = tb < nt;
    const int npt = min(4, nt - pb);
    float oa[NO], ob[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) oa[e] = ob[e] = 0.f;
    // the query tiles of dk slice sl into buffer sl % 2
    auto issue_q = [&](int sl) {
      for (int rt = 0; rt < npt; ++rt)
        stage_cols<64, kTile>(base + Sm::kQ + (sl & 1) * Sm::QB + rt * kAtom,
                              qc, (pb + rt) * kTile, L, dk, 64 * sl, dk,
                              vec_qk);
      cp_async_commit();
    };
    // S_{c-1}'s rows [64 sl, 64 sl + 64) of the block's columns: item n
    // of this thread is row e / (NV / 8), columns 8 (e % (NV / 8)).., e =
    // tid + n kThreads
    float xs[NI][8];
    auto load_s = [&](int sl) {
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int e = tid + n * kThreads, r = e / (NV / 8), ch = e % (NV / 8);
        load8(s_in + (long long)(64 * sl + r) * ldv + col0 + 8 * ch,
              64 * sl + r < dk, 8 * ch, nv, xs[n]);
      }
    };
    if (c > 0) {
      issue_q(0);
      load_s(0);
    }
    for (int sl = 0; c > 0 && sl < ns2; ++sl) {  // O = q S_{c-1}[:, j]
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int e = tid + n * kThreads, r = e / (NV / 8), ch = e % (NV / 8);
        store_parts(base + Sm::kSP + (ch / 8) * kAtom + r * 128 +
                        (((ch % 8) ^ (r % 8)) << 4),
                    Sm::SP, xs[n]);
      }
      if (sl + 1 < ns2) {  // the next slice flies while this one runs
        issue_q(sl + 1);
        load_s(sl + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      wgmma::fence_proxy_async();
      __syncthreads();
      const uint32_t qb = base + Sm::kQ + (sl & 1) * Sm::QB;
      pin_all(oa);
      pin_all(ob);
      wgmma::fence();
      if (la) {
#pragma unroll
        for (int i = 2; i >= 0; --i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wg_ss<1>(oa, kdesc(qb + wg * kAtom, kk, 0),
                     mndesc(base + Sm::kSP + i * Sm::SP, kk), 1);
      }
      if (lb) {
#pragma unroll
        for (int i = 2; i >= 0; --i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wg_ss<1>(ob, kdesc(qb + (3 - wg) * kAtom, kk, 0),
                     mndesc(base + Sm::kSP + i * Sm::SP, kk), 1);
      }
      wgmma::commit();
      wgmma::wait();
      pin_all(oa);
      pin_all(ob);
      __syncthreads();  // the slice's tiles and parts are free
    }
    // O *= e^{g_i}, then O += P v_j over the key tiles up to the diagonal,
    // then the one rounding to bf16
    auto finish = [&](float (&acc)[NO], int rt) {
      const int rl = 16 * warp + gr;  // this thread's rows rl, rl + 8
      const float eg[2] = {expf(gs[rt * kTile + rl]),
                           expf(gs[rt * kTile + rl + 8])};
#pragma unroll
      for (int e = 0; e < NO; ++e) acc[e] = __fmul_rn(acc[e], eg[(e / 2) % 2]);
      const float* pr = pc + (long long)(rt * (rt + 1) / 2) * (kTile * kTile);
      for (int kt = 0; kt <= rt; ++kt) {
        // the tile's P in the A-fragment order: k16 step kk, register r =
        // row rl + 8 (r % 2), keys 16 kk + 8 (r / 2) + 2 qd and the next
        float2 pf[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pf[kk][r] = *reinterpret_cast<const float2*>(
                pr + (long long)kt * (kTile * kTile) +
                (rl + 8 * (r % 2)) * kTile + 16 * kk + 8 * (r / 2) + 2 * qd);
#pragma unroll
        for (int kb = 0; kb < 4; kb += 2) {
          uint32_t pa[2][3][4], part[3];
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              split3(pf[kb + k2][r].x, pf[kb + k2][r].y, part);
#pragma unroll
              for (int i = 0; i < 3; ++i) pa[k2][i][r] = part[i];
            }
          pin_all(acc);
          wgmma::fence();
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
            for (int i = 2; i >= 0; --i)
              wg_rs(acc, pa[k2][i], mndesc(vtile(kt), kb + k2));
          wgmma::commit();
          wgmma::wait();
          pin_all(acc);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = rt * kTile + rl + 8 * h;
        if (i >= L) continue;
#pragma unroll
        for (int jj = 0; jj < NV / 8; ++jj) {
          const int cl = 8 * jj + 2 * qd;
          const float y0 = acc[4 * jj + 2 * h], y1 = acc[4 * jj + 2 * h + 1];
          __nv_bfloat16* op = oc + (long long)i * dv + col0 + cl;
          if (dv % 2 == 0 && cl + 1 < nv) {
            *reinterpret_cast<__nv_bfloat162*>(op) =
                __floats2bfloat162_rn(y0, y1);
          } else {
            if (cl < nv) op[0] = __float2bfloat16_rn(y0);
            if (cl + 1 < nv) op[1] = __float2bfloat16_rn(y1);
          }
        }
      }
    };
    if (la) finish(oa, ta);
    if (lb) finish(ob, tb);
    __syncthreads();  // the next pass's query tiles overwrite the region
  }
}

// The scan for heads wider than 128, the wide route's second launch: a
// block a unit (head, chunk, 128-wide block of v), its ticket from the
// counter sync[0]; ticket t is chunk t / (BH nj), so a unit's predecessor
// (the same head and block, chunk c - 1) holds an earlier ticket; block
// j of a v whose last block is 64 columns wide or less runs at NV = 64
// (the mLSTM normalizer's one column).
__global__ void __launch_bounds__(kThreads, 1)
    gla_wide_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ g, const float* __restrict__ P,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ state,
                    float* scratch, int* sync, int BH, int S, int L, int dk,
                    int dv, int ldv, bool vec_qk, bool vec_v) {
  const int t = take_ticket(sync);
  const int nj = (dv + 127) / 128;
  if (dv - 128 * (t % nj) > 64)
    wide_unit<128>(q, k, v, g, P, o, state, scratch, sync, t, BH, S, L, dk,
                   dv, ldv, vec_qk, vec_v);
  else
    wide_unit<64>(q, k, v, g, P, o, state, scratch, sync, t, BH, S, L, dk,
                  dv, ldv, vec_qk, vec_v);
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

// K10 for bfloat16 heads wider than 128 (max(dk, dv) > 128; any dk, dv):
// q, k [BH, S, dk], v [BH, S, dv] in rows of ldv elements (ldv >= dv, a
// multiple of 8: the wrapper pads v), g [BH, S] float32; o [BH, S, dv]
// bf16 and the final state [BH, dk, dv] float32; P float32 [BH S / L][nt
// (nt + 1) / 2][64][64] (nt = ceil(L / 64)), scratch float32 [BH, S / L,
// dk, ldv], sync int32 [1 + BH (S / L) ceil(dv / 128)] (zeroed here, on
// the stream); S a multiple of L, L <= 256. Two launches after the
// memset: gla_wide_scores_kernel, then gla_wide_kernel. Returns the CUDA
// error of the memset or of either launch (0 on success), or
// cudaErrorInvalidValue for L over 256 or ldv not a multiple of 8.
extern "C" int gla_wide_fwd(const void* q, const void* k, const void* v,
                            const float* g, float* P, void* o, float* state,
                            float* scratch, int* sync, int BH, int S, int L,
                            int dk, int dv, int ldv, void* stream) {
  if (L > kWideMaxL || ldv % 8 || ldv < dv) return (int)cudaErrorInvalidValue;
  if (BH == 0 || S == 0 || dk == 0 || dv == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = S / L, nt = (L + kTile - 1) / kTile;
  const int units = BH * nc * ((dv + 127) / 128);
  cudaError_t err =
      cudaMemsetAsync(sync, 0, (size_t)(1 + units) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const bool vec_qk = dk % 8 == 0 && (uintptr_t)q % 16 == 0 &&
                      (uintptr_t)k % 16 == 0;
  const bool vec_v = (uintptr_t)v % 16 == 0;
  const int e1 = float_io::launch(
      gla_wide_scores_kernel, BH * nc * nt, kThreads, WideScoresSmem::bytes,
      s, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, g, P, S, L, dk,
      vec_qk);
  if (e1 != 0) return e1;
  return float_io::launch(
      gla_wide_kernel, units, kThreads, WideSmem<128>::bytes(nt), s,
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, g, (const float*)P, (__nv_bfloat16*)o, state,
      scratch, sync, BH, S, L, dk, dv, ldv, vec_qk, vec_v);
}
