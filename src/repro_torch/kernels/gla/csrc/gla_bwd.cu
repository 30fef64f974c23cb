// The backward of K10 for float32 inputs (dk, dv <= 128): the gradients of
// the chunked gated-linear-attention scan
//
//   o_t = sum_{s <= t} (q_t . k_s) e^{g_t - g_s} v_s + e^{g_t} q_t S_{c-1}
//   S_c = e^{g_L} S_{c-1} + sum_s e^{g_L - g_s} k_s^T v_s
//
// (gla.cu; g the within-chunk cumsum of log a, L the chunk) for q, k [BH,
// S, dk], v [BH, S, dv] and g [BH, S], given o's gradient do [BH, S, dv],
// the final state's gradient (or none: zero) and the forward's chunk states
// S_c [BH, nc, dk, dv] (its look-back scratch, kept by the wrapper; the last
// slot the final state). With dS_c the gradient of S_c, chunk c's rows take
//
//   dq_t = sum_{s <= t} (do_t . v_s) e^{g_t - g_s} k_s + e^{g_t} do_t S_{c-1}^T
//   dk_s = sum_{t >= s} (do_t . v_s) e^{g_t - g_s} q_t + e^{g_L - g_s} v_s dS_c^T
//   dv_s = sum_{t >= s} (q_t . k_s) e^{g_t - g_s} do_t + e^{g_L - g_s} k_s dS_c
//   dg_t = q_t . dq_t - k_t . dk_t   (+ <dS_c, S_c> at the chunk's last row)
//
// and the state's gradient runs backwards over the chunks:
//
//   dS_{c-1} = e^{g_L} dS_c + U_c,   U_c = sum_t e^{g_t} q_t^T do_t.
//
// It replaces no TPU kernel: the reference has no backward kernel. Its
// models differentiate the jnp scan (repro/models/ssm.py::gla_chunked) with
// jax.grad. The port's forward runs K10 on the card, so its backward is a
// kernel too.
//
// Numerics: split TF32 on the tensor cores (attention/csrc/tf32_split.cuh),
// as K9's float32 backward: every product three TF32 products of split
// operands, each step's product taken into fresh registers and added to
// the float32 sums on CUDA cores. The masks and the e^{g_t - g_s} factors
// stay on CUDA cores, applied to a score tile's float32 product before it
// is split for the next product.
//
// Design. Four launches on the stream, one entry point, no atomics:
//
//   gla_bwd_u_kernel      a block of two warpgroups per (head, chunk c >=
//                         1): U_c = (q e^g)^T do over the chunk's 32-row
//                         steps, both operands staged transposed, each
//                         warpgroup a [64, N] block of U;
//   gla_bwd_scan_kernel   a block per (head, 32 x 32 tile of the state):
//                         dS_c for every chunk, last first, the chain
//                         above, written as it lies and transposed;
//   gla_bwd_dkdv_kernel   a block of two warpgroups per (head, chunk), for
//                         each 64-row key tile K and V in shared memory as
//                         their parts while the block walks the 32-row
//                         query steps from the diagonal on:
//                           B^T = K Q^T       warpgroup 0
//                           A^T = V dO^T      warpgroup 1
//                           masked and decayed on CUDA cores, then
//                           dV += B^T dO      warpgroup 0, A B^T from
//                                             registers, B dO^T
//                           dK += A^T Q       warpgroup 1, B Q^T
//                         then the state terms, 32 columns at a time:
//                         e^{g_L - g_s} K dS_c (warpgroup 0, B 32 rows of
//                         dS_c^T) and e^{g_L - g_s} V dS_c^T (1, B 32 rows
//                         of dS_c); k_s . dk_s of each row into dg;
//   gla_bwd_dq_kernel     a block of two warpgroups per (head, chunk), for
//                         each 64-row query tile dO in shared memory as its
//                         parts while the block walks the 32-row key steps
//                         up to the diagonal: A = dO V^T, 16 key columns in
//                         each warpgroup, handed over through shared
//                         memory, masked and decayed, then dQ += A K, half
//                         of dQ's columns in each (B K^T); then e^{g_t} dO
//                         S_{c-1}^T, a warpgroup its half of the columns;
//                         then dg_t = q_t . dq_t (each warpgroup's half
//                         from its sums) - k_t . dk_t (+ <dS_c, S_c> at the
//                         chunk's last row).
//
// Both warpgroups issue the same wgmma instructions, operands chosen by
// select (a wgmma on a branch of the warpgroup makes ptxas serialize them
// all), and the two chains share the tensor cores. dq recomputes A rather
// than sum partial dq over key tiles, which would need a [nt, L, dk]
// scratch or atomics. The chain is a separate launch, not the forward's
// look-back: it is 2 nc float32 operations an element, and a kernel
// boundary orders it without flags. Two runs are bitwise equal.
//
// TF32 wgmma reads both operands K-major only, so a step's tile comes in
// raw by cp.async into a raw buffer, one step ahead; the threads split it
// into its two parts stacked in one [64, D] tile (lo rows 0-31, hi 32-63:
// one n64 product takes A_hi against both, one n32 A_lo against the hi
// rows), the B operand of the score products; once those are done, they
// move the parts into the same buffer transposed ([D, 32], hi, then lo D
// 128 bytes on), with the rows permuted by sigma to match the A fragments
// taken from the accumulator, the B operand of the products that contract
// over the step. V's step in the dq kernel is stacked by halves (lo, hi of
// rows 0-15, then of rows 16-31), so that each warpgroup's 16 columns are
// one n32 and one n16 product.
//
// Shared memory, bytes from a 1024-aligned base. The dk, dv kernel
// (Smem<D>): the parts of two resident [64, D] tiles, 4 64 D 4; two
// stacked step tiles, 2 64 D 4; two raw [32, D] tiles, 2 32 D 4; 1,024 of
// alignment slack: 230,400 at D 128 of an SM's 232,448, 115,712 at D 64
// (zamba2's heads), one block an SM (it needs more than 128 registers a
// thread). The dq kernel (QSmem<D>): one resident tile's parts, the step
// and raw tiles, two steps' 32 g, <dS_c, S_c>'s 256 partial sums and 64
// rows' q . dq halves: 84,480 at D 64, two blocks an SM (128 registers a
// thread). The U kernel (USmem<D>): the step and raw tiles and g, 50,432 at
// D 64.
//
// Bound on this card: operations. At zamba2-7B's layer (B 1, 112 heads,
// S 4096, chunk 256, dk = dv = 64) the least work a (head, chunk) is the
// causal half of four L x L products (A, B and their products with q, do;
// dq's A K makes five, ~L (L + 1) (3 dk + 2 dv)) and eight L dk dv
// products (U, the two state terms, the inter-chunk term), 52.8 GFLOP in
// all, three TF32 products of it 0.32 ms at the 494.7 TFLOP/s dense TF32
// peak (0.79 ms at the 67 TFLOP/s f32 CUDA-core peak). This design
// computes whole 64 x 32 tiles on the diagonal and recomputes A in the dq
// kernel. Its bytes (q, k, v, do, g, the states, dq, dk, dv, dg, U and dS
// once) take ~0.25 ms at 3.35 TB/s.
#include <stdint.h>

#include "../../attention/csrc/tf32_split.cuh"
#include "../../csrc/float_io.cuh"

namespace {

using namespace split_tf32;
using namespace split_tf32::rows32;  // kBM 64, kBN 32, two warpgroups

// Blocks an SM the dq kernel is built for: two at D 64 (within 115,712
// bytes of shared memory and 128 registers a thread), one at D 128. The dk,
// dv kernel spilled a kilobyte a thread at 128 registers and runs one.
template <int D>
constexpr int kMinBlocks = D == 64 ? 2 : 1;

// Shared memory of the dk, dv kernel at head dims up to D, byte offsets
// from a 1024-aligned base: the two parts of two resident [64, D] tiles (K
// and V), two step tiles [32, D] each as its two parts stacked into one
// [64, D] tile, the two raw [32, D] tiles, then the alignment slack.
template <int D>
struct Smem {
  static constexpr uint32_t kPart = kBM * D * 4;  // one [64, D] tile
  static constexpr uint32_t kRaw = kBN * D * 4;   // one [32, D] tile
  static constexpr uint32_t kAhi = 0;
  static constexpr uint32_t kAlo = kAhi + kPart;
  static constexpr uint32_t kBhi = kAlo + kPart;
  static constexpr uint32_t kBlo = kBhi + kPart;
  static constexpr uint32_t kX = kBlo + kPart;
  static constexpr uint32_t kY = kX + kPart;
  static constexpr uint32_t kRawX = kY + kPart;
  static constexpr uint32_t kRawY = kRawX + kRaw;
  static constexpr uint32_t kBytes = kRawY + kRaw + 1024;
};
static_assert(Smem<128>::kBytes <= 232448, "an SM's shared memory");
static_assert(2 * (Smem<64>::kBytes + 1024) <= 233472, "two blocks an SM");

// The dq kernel's: the parts of the resident [64, D] dO tile, the two
// step tiles and their raw tiles as in Smem, two steps' 32 g, <dS_c,
// S_c>'s partial sums, then the alignment slack.
template <int D>
struct QSmem {
  static constexpr uint32_t kPart = kBM * D * 4;
  static constexpr uint32_t kRaw = kBN * D * 4;
  static constexpr uint32_t kAhi = 0;
  static constexpr uint32_t kAlo = kAhi + kPart;
  static constexpr uint32_t kX = kAlo + kPart;
  static constexpr uint32_t kY = kX + kPart;
  static constexpr uint32_t kRawX = kY + kPart;
  static constexpr uint32_t kRawY = kRawX + kRaw;
  static constexpr uint32_t kG = kRawY + kRaw;  // two steps'
  static constexpr uint32_t kRed = kG + 2 * kBN * 4;
  static constexpr uint32_t kHalf = kRed + kThreads * 4;  // 64 rows' q . dq
  static constexpr uint32_t kBytes = kHalf + kBM * 4 + 1024;
};
static_assert(2 * (QSmem<64>::kBytes + 1024) <= 233472, "two blocks an SM");

// The U kernel's: the step tiles, their raw tiles and g, as in Smem.
template <int D>
struct USmem {
  static constexpr uint32_t kPart = kBM * D * 4;
  static constexpr uint32_t kRaw = kBN * D * 4;
  static constexpr uint32_t kX = 0;
  static constexpr uint32_t kY = kX + kPart;
  static constexpr uint32_t kRawX = kY + kPart;
  static constexpr uint32_t kRawY = kRawX + kRaw;
  static constexpr uint32_t kG = kRawY + kRaw;
  static constexpr uint32_t kBytes = kG + 2 * kBN * 4 + 1024;
};

// acc[64 x N] += A^T B over a step's 32 rows, A and B the step's two
// transposed tiles ([D, 32] as their parts, hi at a, lo D 128 bytes on),
// A's rows from ra, B's from rb: A_hi B_lo + A_lo B_hi + A_hi B_hi on the
// tensor cores into fresh registers, then added to acc on CUDA cores.
template <int D, int N>
__device__ __forceinline__ void accumulate_ss(float (&acc)[N / 2],
                                              uint32_t a, uint32_t b) {
  float part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
  const uint64_t dah = tile_desc(a), dal = tile_desc(a + D * 128),
                 dbh = tile_desc(b), dbl = tile_desc(b + D * 128);
  wgmma::fence();
#pragma unroll
  for (int prod = 0; prod < 3; ++prod)  // hi lo, lo hi, hi hi
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      Mma<N>::ss(part, (prod == 1 ? dal : dah) + ((j * 32) >> 4),
                 (prod == 0 ? dbl : dbh) + ((j * 32) >> 4), prod > 0 || j > 0);
  wgmma::commit();
  wgmma::wait();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    wgmma::pin(part[i]);
    acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// sum_c x[row, c] acc[row, c] over the columns c0 + 8 j + 2 qd + e (below
// cols) that this thread's [64 x W] accumulator holds of row `row` (its
// row 16 w + g + 8 h), summed over the quad's 4 threads (zero for rows
// from L on); x the [L, cols] chunk.
template <int W>
__device__ __forceinline__ float row_dot(const float* x,
                                         const float (&acc)[W / 2], int row,
                                         int L, int c0, int cols, int h,
                                         int qd) {
  float p = 0.f;
  if (row < L)
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * qd + e;
        if (col < cols)
          p = __fmaf_rn(x[(long long)row * cols + col], acc[4 * j + 2 * h + e],
                        p);
      }
  p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
  return __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
}

// U_c = sum_t (q_t e^{g_t})^T do_t of chunk c >= 1 into u[bh, c]: block
// (nc - 1) bh + c - 1, over the chunk's 32-row steps. Warpgroup wg takes
// U's rows 0-63 and columns 32 wg .. (D 64), or rows 64 wg .. and every
// column (D 128).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    gla_bwd_u_kernel(const float* __restrict__ q, const float* __restrict__ g,
                     const float* __restrict__ dO, float* __restrict__ u,
                     int S, int L, int dk, int dv, int vec) {
  using M = USmem<D>;
  constexpr int N = D == 64 ? 32 : 128;  // U's columns a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sX = base + M::kX, sY = base + M::kY;
  const uint32_t rawX = base + M::kRawX, rawY = base + M::kRawY;
  const uint32_t sG = base + M::kG;
  const int tid = threadIdx.x, wg = tid / kWG, wt = tid % kWG;
  const int nc = S / L;
  const int bh = blockIdx.x / (nc - 1), c = 1 + blockIdx.x % (nc - 1);
  const long long row0 = (long long)bh * S + (long long)c * L;
  const float* qp = q + row0 * dk;
  const float* op = dO + row0 * dv;
  const int steps = (L + kBN - 1) / kBN;
  auto fetch = [&](int i) {
    fill_raw<D>(rawX, qp, i * kBN, L, dk, vec, tid);
    fill_raw<D>(rawY, op, i * kBN, L, dv, vec, tid);
    fill_vec(sG + (i % 2) * kBN * 4, g + row0, i * kBN, L, kBN, tid);
    wgmma::cp_async_commit();
  };
  fetch(0);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int ra = D == 64 ? 0 : 64 * wg, rb = D == 64 ? 32 * wg : 0;
  for (int i = 0; i < steps; ++i) {
    // the step's raw tiles have landed, and every warp is done with the
    // step before's products
    wgmma::cp_async_wait<0>();
    __syncthreads();
    stage_rows<D>(sX, rawX, 1.f, sG + (i % 2) * kBN * 4, tid);
    stage_rows<D>(sY, rawY, 1.f, 0, tid);
    __syncthreads();
    if (i + 1 < steps) fetch(i + 1);
    // (q e^g)^T and do^T over them
    stage_cols2<D>(sX, sY, tid);
    wgmma::fence_proxy_async();
    __syncthreads();
    accumulate_ss<D, N>(acc, sX + ra * 128, sY + rb * 128);
  }
  store_acc<N>(u + ((long long)bh * nc + c) * dk * dv, acc, ra, dk, rb, dv,
               1.f, wt);
}

// dS_c for every chunk, last first: dS_{nc-1} = the final state's gradient
// (zero when dstate is null), dS_{c-1} = e^{g_L} dS_c + U_c, written to ds
// [BH, nc, dk, dv] and transposed to ds + BH nc dk dv ([BH, nc, dv, dk]). A
// block per (bh, 32 x 32 tile of the state): thread (tx, ty) of 32 x 8
// carries rows ty + 8 m (m = 0..3), column tx, and each chunk's tile goes
// through shared memory so that both stores run along rows.
__global__ void __launch_bounds__(kThreads)
    gla_bwd_scan_kernel(const float* __restrict__ g,
                        const float* __restrict__ u,
                        const float* __restrict__ dstate,
                        float* __restrict__ ds, int BH, int S, int L, int dk,
                        int dv) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int te = (dv + 31) / 32, td = (dk + 31) / 32;
  const int bh = blockIdx.x / (td * te), d0 = blockIdx.x / te % td * 32,
            e0 = blockIdx.x % te * 32;
  const long long dkv = (long long)dk * dv;
  const int nc = S / L;
  float* dst = ds + (long long)BH * nc * dkv;
  float x[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int d = d0 + ty + 8 * m, e = e0 + tx;
    x[m] = dstate != nullptr && d < dk && e < dv
               ? dstate[(long long)bh * dkv + (long long)d * dv + e]
               : 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const long long slot = ((long long)bh * nc + c) * dkv;
    const float a = c > 0 ? expf(g[(long long)bh * S + (long long)c * L + L - 1])
                          : 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int d = d0 + ty + 8 * m, e = e0 + tx;
      const bool live = d < dk && e < dv;
      const long long at = slot + (long long)d * dv + e;
      if (live) ds[at] = x[m];
      tile[ty + 8 * m][tx] = x[m];
      if (c > 0 && live) x[m] = __fadd_rn(__fmul_rn(a, x[m]), u[at]);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = e0 + ty + 8 * m, d = d0 + tx;
      if (e < dv && d < dk)
        dst[slot + (long long)e * dk + d] = tile[tx][ty + 8 * m];
    }
    __syncthreads();
  }
}

// dk and dv of one (head, chunk): block nc bh + c; (1) of the notes at the
// top.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    gla_bwd_dkdv_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ dO,
                        const float* __restrict__ ds,
                        float* __restrict__ dk_out,
                        float* __restrict__ dv_out, float* __restrict__ dg,
                        int BH, int S, int L, int dk, int dv, int vec) {
  using M = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sAhi = base + M::kAhi, sAlo = base + M::kAlo;  // K
  const uint32_t sBhi = base + M::kBhi, sBlo = base + M::kBlo;  // V
  const uint32_t sX = base + M::kX, sY = base + M::kY;
  const uint32_t rawX = base + M::kRawX, rawY = base + M::kRawY;
  const int tid = threadIdx.x, wg = tid / kWG, wt = tid % kWG;
  const int w = wt / 32, gr = (wt % 32) / 4, qd = wt % 4;
  const int nc = S / L;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const long long row0 = (long long)bh * S + (long long)c * L;
  const float* qp = q + row0 * dk;
  const float* kp = k + row0 * dk;
  const float* vp = v + row0 * dv;
  const float* gp = g + row0;
  const float* op = dO + row0 * dv;
  const long long dkv = (long long)dk * dv;
  const float* dsc = ds + ((long long)bh * nc + c) * dkv;
  const bool svec = dk % 4 == 0 && dv % 4 == 0;  // the state rows
  const int steps = (L + kBN - 1) / kBN;
  const float* dstc = dsc + (long long)BH * nc * dkv;  // dS_c^T [dv, dk]
  const float gl = gp[L - 1];
  // step i's 32 rows of X and of Y into the raw tiles
  auto fetch_x = [&](const float* src, int cols, int i) {
    fill_raw<D>(rawX, src, i * kBN, L, cols, vec, tid);
    wgmma::cp_async_commit();
  };
  auto fetch_y = [&](const float* src, int cols, int i) {
    fill_raw<D>(rawY, src, i * kBN, L, cols, vec, tid);
    wgmma::cp_async_commit();
  };

  // (1) dk, dv, a key tile at a time
  for (int j0 = 0; j0 < L; j0 += kBM) {
    const int i0 = j0 / kBN;  // the query step on the diagonal
    __syncthreads();  // the tile before is done with every buffer
    fetch_x(qp, dk, i0);
    fetch_y(op, dv, i0);
    stage_resident<D>(sAhi, sAlo, kp, j0, L, dk, vec, 1.f, tid);
    stage_resident<D>(sBhi, sBlo, vp, j0, L, dv, vec, 1.f, tid);
    const int kr = j0 + 16 * w + gr;  // this thread's key rows: kr, kr + 8
    float gs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) gs[h] = kr + 8 * h < L ? gp[kr + 8 * h] : 0.f;
    float acc[D / 2];  // warpgroup 0: dV; 1: dK
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int i = i0; i < steps; ++i) {
      // g of this thread's 8 query columns
      float gq[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int t = i * kBN + 8 * (n / 2) + 2 * qd + n % 2;
        gq[n] = t < L ? __ldg(gp + t) : 0.f;
      }
      // the step's raw tiles have landed, and every warp is done with the
      // step before's products
      wgmma::cp_async_wait<0>();
      __syncthreads();
      stage_rows<D>(sX, rawX, 1.f, 0, tid);  // Q
      stage_rows<D>(sY, rawY, 1.f, 0, tid);  // dO
      wgmma::fence_proxy_async();
      __syncthreads();
      if (i + 1 < steps) {
        fetch_x(qp, dk, i + 1);
        fetch_y(op, dv, i + 1);
      }
      // warpgroup 0: B^T = K Q^T; 1: A^T = V dO^T (operands by select)
      float x[16];
      scores<D, 64>(x, wg ? sBhi : sAhi, wg ? sBlo : sAlo, wg ? sY : sX);
      // masked (s <= t < L) and decayed by e^{g_t - g_s}
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * qd + e, t = i * kBN + col;
          const float gt = gq[2 * j + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int xi = 4 * j + 2 * h + e;
            const bool live = kr + 8 * h <= t && t < L;
            x[xi] = live ? __fmul_rn(x[xi], expf(__fsub_rn(gt, gs[h])))
                         : 0.f;
          }
        }
      uint32_t xhi[4][4], xlo[4][4];
      fragments<4>(x, xhi, xlo);
      // Q^T and dO^T over Q and dO
      stage_cols2<D>(sX, sY, tid);
      wgmma::fence_proxy_async();
      __syncthreads();
      const uint32_t bt = wg ? sX : sY;
      accumulate<D, 4>(acc, xhi, xlo, bt, bt + D * 128);
    }
    // the state terms, 32 columns at a time: warpgroup 0 e^{g_L - g_s} K
    // dS_c against 32 rows of dS_c^T, 1 e^{g_L - g_s} V dS_c^T against 32
    // rows of dS_c
    float f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) f[h] = expf(__fsub_rn(gl, gs[h]));
#pragma unroll
    for (int cb = 0; cb < D / kBN; ++cb) {
      __syncthreads();  // every warp is done with the step tiles
      fill_raw<D>(rawX, dsc, cb * kBN, dk, dv, svec, tid);
      fill_raw<D>(rawY, dstc, cb * kBN, dv, dk, svec, tid);
      wgmma::cp_async_commit();
      wgmma::cp_async_wait<0>();
      __syncthreads();
      stage_rows<D>(sX, rawX, 1.f, 0, tid);
      stage_rows<D>(sY, rawY, 1.f, 0, tid);
      wgmma::fence_proxy_async();
      __syncthreads();
      float x[16];
      scores<D, 64>(x, wg ? sBhi : sAhi, wg ? sBlo : sAlo, wg ? sX : sY);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        acc[16 * cb + i] =
            __fadd_rn(acc[16 * cb + i], __fmul_rn(f[(i / 2) % 2], x[i]));
    }
    store_acc<D>(wg ? dk_out + row0 * dk : dv_out + row0 * dv, acc, j0, L, 0,
                 wg ? dk : dv, 1.f, wt);
    // k_s . dk_s of this thread's rows into dg, which the dq kernel
    // subtracts (warpgroup 1's dK; the quad's 4 threads hold a row)
    if (wg) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = row_dot<D>(kp, acc, kr + 8 * h, L, 0, dk, h, qd);
        if (qd == 0 && kr + 8 * h < L) dg[row0 + kr + 8 * h] = p;
      }
    }
  }

}

// dq and dg of one (head, chunk): block nc bh + c; (2) and (3) of the
// notes at the top, after the dk, dv kernel.
template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
    gla_bwd_dq_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ g,
                      const float* __restrict__ states,
                      const float* __restrict__ dO,
                      const float* __restrict__ ds, float* __restrict__ dq,
                      float* __restrict__ dg, int S, int L, int dk, int dv,
                      int vec) {
  using M = QSmem<D>;
  constexpr int W = D / 2;  // dQ columns a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wgmma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sAhi = base + M::kAhi, sAlo = base + M::kAlo;  // dO
  const uint32_t sX = base + M::kX, sY = base + M::kY;
  const uint32_t rawX = base + M::kRawX, rawY = base + M::kRawY;
  const uint32_t sG = base + M::kG, sRed = base + M::kRed;
  const uint32_t sHalf = base + M::kHalf;
  const int tid = threadIdx.x, wg = tid / kWG, wt = tid % kWG;
  const int w = wt / 32, gr = (wt % 32) / 4, qd = wt % 4;
  const int nc = S / L;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const long long row0 = (long long)bh * S + (long long)c * L;
  const float* qp = q + row0 * dk;
  const float* kp = k + row0 * dk;
  const float* vp = v + row0 * dv;
  const float* gp = g + row0;
  const float* op = dO + row0 * dv;
  const long long dkv = (long long)dk * dv;
  const float* dsc = ds + ((long long)bh * nc + c) * dkv;
  const bool svec = dk % 4 == 0 && dv % 4 == 0;  // the state rows
  const int steps = (L + kBN - 1) / kBN;
  // step i's 32 rows of X (and g) and of Y into the raw tiles
  auto fetch_x = [&](const float* src, int cols, int i) {
    fill_raw<D>(rawX, src, i * kBN, L, cols, vec, tid);
    fill_vec(sG + (i % 2) * kBN * 4, gp, i * kBN, L, kBN, tid);
    wgmma::cp_async_commit();
  };
  auto fetch_y = [&](const float* src, int cols, int i) {
    fill_raw<D>(rawY, src, i * kBN, L, cols, vec, tid);
    wgmma::cp_async_commit();
  };

  // <dS_c, S_c>, added to the chunk's last dg
  {
    const float* sc = states + ((long long)bh * nc + c) * dkv;
    float part = 0.f;
    for (long long e = tid; e < dkv; e += kThreads)
      part = __fmaf_rn(dsc[e], sc[e], part);
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sRed + 4 * tid), "f"(part)
                 : "memory");
  }
  __syncthreads();
  for (int n = kThreads / 2; n > 0; n /= 2) {
    if (tid < n)
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sRed + 4 * tid),
                   "f"(__fadd_rn(lds32(sRed + 4 * tid),
                                 lds32(sRed + 4 * (tid + n))))
                   : "memory");
    __syncthreads();
  }
  const float red = lds32(sRed);

  // (2) dq, a query tile at a time
  const float* prev =  // S_{c-1}, read when c >= 1
      states + ((long long)bh * nc + (c > 0 ? c - 1 : 0)) * dkv;
  for (int i0 = 0; i0 < L; i0 += kBM) {
    const int last = min(steps, (i0 + kBM + kBN - 1) / kBN);
    __syncthreads();  // the tile before is done with every buffer
    fetch_x(kp, dk, 0);
    fetch_y(vp, dv, 0);
    stage_resident<D>(sAhi, sAlo, op, i0, L, dv, vec, 1.f, tid);  // dO
    const int r = i0 + 16 * w + gr;  // this thread's rows: r, r + 8
    float gt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) gt[h] = r + 8 * h < L ? gp[r + 8 * h] : 0.f;
    float adq[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) adq[i] = 0.f;
    // a warpgroup's 16 columns of A to the other, thread wt's 8 as 2
    // chunks in the stacked V tile (free once both have taken A)
    const uint32_t mine = sY + wg * 4096 + wt * 16;
    const uint32_t theirs = sY + (1 - wg) * 4096 + wt * 16;
    for (int j = 0; j < last; ++j) {
      wgmma::cp_async_wait<0>();
      __syncthreads();
      stage_rows<D>(sX, rawX, 1.f, 0, tid);  // K
      stage_rows<D, true>(sY, rawY, 1.f, 0, tid);   // V, by halves
      wgmma::fence_proxy_async();
      __syncthreads();
      if (j + 1 < last) {
        fetch_x(kp, dk, j + 1);
        fetch_y(vp, dv, j + 1);
      }
      // A = dO V^T, key columns 16 wg .. 16 wg + 15 in warpgroup wg
      float a[8];
      scores<D, 32>(a, sAhi, sAlo, sY + 32 * wg * 128);
      __syncthreads();  // both warpgroups' products are done with V
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        sts128(mine + cc * kWG * 16,
               make_float4(a[4 * cc], a[4 * cc + 1], a[4 * cc + 2],
                           a[4 * cc + 3]));
      __syncthreads();
      float x[16];  // key columns 0-15 in x[0 .. 7], 16-31 in x[8 .. 15]
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float4 y = lds128(theirs + cc * kWG * 16);
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          x[4 * cc + m] = wg ? ys[m] : a[4 * cc + m];
          x[8 + 4 * cc + m] = wg ? a[4 * cc + m] : ys[m];
        }
      }
      // masked (s <= t < L) and decayed by e^{g_t - g_s}
      const uint32_t sGj = sG + (j % 2) * kBN * 4;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * jj + 2 * qd + e, s = j * kBN + col;
          const float gs = lds32(sGj + 4 * col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int xi = 4 * jj + 2 * h + e, t = r + 8 * h;
            const bool live = s <= t && t < L;
            x[xi] = live ? __fmul_rn(x[xi], expf(__fsub_rn(gt[h], gs)))
                         : 0.f;
          }
        }
      uint32_t xhi[4][4], xlo[4][4];
      fragments<4>(x, xhi, xlo);
      // K^T over K
      stage_cols<D>(sX, tid);
      wgmma::fence_proxy_async();
      __syncthreads();
      accumulate<W, 4>(adq, xhi, xlo, sX + wg * W * 128,
                       sX + D * 128 + wg * W * 128);
    }
    // e^{g_t} dO S_{c-1}^T, warpgroup wg's columns 32 b of its half
    if (c > 0) {
      float et[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) et[h] = expf(gt[h]);
#pragma unroll
      for (int cb = 0; cb < W / kBN; ++cb) {
        __syncthreads();  // every warp is done with the step tiles
        fill_raw<D>(rawX, prev, cb * kBN, dk, dv, svec, tid);
        fill_raw<D>(rawY, prev, W + cb * kBN, dk, dv, svec, tid);
        wgmma::cp_async_commit();
        wgmma::cp_async_wait<0>();
        __syncthreads();
        stage_rows<D>(sX, rawX, 1.f, 0, tid);
        stage_rows<D>(sY, rawY, 1.f, 0, tid);
        wgmma::fence_proxy_async();
        __syncthreads();
        float x[16];
        scores<D, 64>(x, sAhi, sAlo, wg ? sY : sX);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          adq[16 * cb + i] =
              __fadd_rn(adq[16 * cb + i], __fmul_rn(et[(i / 2) % 2], x[i]));
      }
    }
    store_acc<W>(dq + row0 * dk, adq, i0, L, wg * W, dk, 1.f, wt);
    // (3) dg_t = q_t . dq_t - k_t . dk_t (+ <dS_c, S_c> at the chunk's
    // last row): each warpgroup's half of q_t . dq_t from its sums,
    // warpgroup 1's through shared memory to warpgroup 0, k_t . dk_t from
    // the dk, dv kernel
    float pq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pq[h] = row_dot<W>(qp, adq, r + 8 * h, L, wg * W, dk, h, qd);
    if (wg == 1 && qd == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(
                         sHalf + 4 * (r - i0 + 8 * h)),
                     "f"(pq[h])
                     : "memory");
    __syncthreads();
    if (wg == 0 && qd == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r + 8 * h;
        if (t >= L) continue;
        float x = __fsub_rn(__fadd_rn(pq[h], lds32(sHalf + 4 * (t - i0))),
                            dg[row0 + t]);
        if (t == L - 1) x = __fadd_rn(x, red);
        dg[row0 + t] = x;
      }
  }

}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* g, const float* states, const float* dO,
               const float* dstate, float* u, float* ds, float* dq,
               float* dk_out, float* dv_out, float* dg, int BH, int S, int L,
               int dk, int dv, int vec, cudaStream_t stream) {
  const int nc = S / L;
  int err = 0;
  if (nc > 1) {
    err = float_io::launch(gla_bwd_u_kernel<D>, BH * (nc - 1), kThreads,
                           USmem<D>::kBytes, stream, q, g, dO, u, S, L, dk,
                           dv, vec);
    if (err) return err;
  }
  gla_bwd_scan_kernel<<<BH * ((dk + 31) / 32) * ((dv + 31) / 32), kThreads,
                        0, stream>>>(g, (const float*)u, dstate, ds, BH, S, L,
                                     dk, dv);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = float_io::launch(gla_bwd_dkdv_kernel<D>, BH * nc, kThreads,
                         Smem<D>::kBytes, stream, q, k, v, g, dO,
                         (const float*)ds, dk_out, dv_out, dg, BH, S, L, dk,
                         dv, vec);
  if (err) return err;
  return float_io::launch(gla_bwd_dq_kernel<D>, BH * nc, kThreads,
                          QSmem<D>::kBytes, stream, q, k, v, g, states, dO,
                          (const float*)ds, dq, dg, S, L, dk, dv, vec);
}

}  // namespace

// The backward of K10, float32. q, k [BH, S, dk], v [BH, S, dv], g [BH, S]
// (the within-chunk cumsum), states [BH, S / L, dk, dv] (S_c after each
// chunk c), dO [BH, S, dv], dstate [BH, dk, dv] or null (zero), all
// row-major float32; u [BH, S / L, dk, dv] and ds [2, BH, S / L, dk, dv]
// float32 scratch; dq, dk, dv, dg the gradients, shaped as q, k, v, g,
// every element written. S a multiple of L; dk, dv <= 128. Returns the
// first nonzero cudaGetLastError() of the three launches (0 on success),
// or cudaErrorInvalidValue for a head dim over 128.
extern "C" int gla_scan_bwd_f32(const void* q, const void* k, const void* v,
                                const void* g, const void* states,
                                const void* dO, const void* dstate, void* u,
                                void* ds, void* dq, void* dk_out,
                                void* dv_out, void* dg, int BH, int S, int L,
                                int dk, int dv, void* stream) {
  if (BH == 0 || S == 0 || dk == 0 || dv == 0) return 0;
  if (dk > 128 || dv > 128) return (int)cudaErrorInvalidValue;
  // 16-byte loads of q, k, v and do: whole 16-byte rows, aligned bases
  const int vec = dk % 4 == 0 && dv % 4 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                    (uintptr_t)dO) % 16) == 0;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *gf = (const float*)g,
              *sf = (const float*)states, *of = (const float*)dO,
              *df = (const float*)dstate;
  float *uf = (float*)u, *dsf = (float*)ds, *dqf = (float*)dq,
        *dkf = (float*)dk_out, *dvf = (float*)dv_out, *dgf = (float*)dg;
  cudaStream_t s = (cudaStream_t)stream;
  if (dk <= 64 && dv <= 64)
    return launch_bwd<64>(qf, kf, vf, gf, sf, of, df, uf, dsf, dqf, dkf, dvf,
                          dgf, BH, S, L, dk, dv, vec, s);
  return launch_bwd<128>(qf, kf, vf, gf, sf, of, df, uf, dsf, dqf, dkf, dvf,
                         dgf, BH, S, L, dk, dv, vec, s);
}
