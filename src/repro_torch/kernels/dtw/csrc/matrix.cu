// K7: the DTW accumulated-cost matrix (paper Eq. 1), every row of it, for
// host backtracking (the warped series Y' of Eq. 3).
//
// K7 replaces repro/kernels/dtw/kernel.py::_dtw_kernel (entry
// dtw_matrix_kernel, one query x [N] against references ys [K, M]) and
// ::_dtw_pairs_kernel (entry dtw_matrix_pairs_kernel, query p against
// reference p), the Pallas TPU kernels reached through
// repro/kernels/dtw/ops.py. Both write D [K, N, M]. The same kernel
// serves the function those compute wherever the port needs it: the
// matrix functions of core/dtw.py (bank, pairs, banded, scalar), the
// streaming bank DP (dtw_bank_extend, resumed from a carried row), and
// the last-row-only distance bank.
//
// For each pair p it computes C rows of the DP of query chunk x_p [C]
// against reference y_p [M], resuming from a carried row D[n0 - 1, :]
// (row_in [P, M]; null is the empty row, all 3e38), where n0 is the
// number of query samples consumed before the chunk. Every cell is
//
//   D(i, j) = min(d(i, j) + min(min(diag, vert), horiz), 3e38)
//
// with d = |x_i - y_j|, 3e38 outside the Sakoe-Chiba band (centre
// ((n0 + i) * (rlen_p - 1)) / max(qlen_p - 1, 1), floor division), and
// the virtual corner D[-1, -1] = 0 only for absolute row 0 (n0 == 0).
// That is the cell of dtw_sweep.cuh, so K7's rows are bitwise K3's and
// K1's rows and K2's endpoint distances on any data. The TPU kernel
// solves each row with a min-plus Hillis-Steele scan, which adds the
// costs in a tree: the two agree bitwise where every sum is exact
// (dyadic data), and to rounding elsewhere.
//
// Design: one block per pair sweeps anti-diagonals, one thread per query
// row: at step s, thread i computes cell (i, s - i), reading its vertical
// predecessor from the previous step's diagonal in shared memory (a
// double buffer indexed by row), its diagonal predecessor from a
// register (the vertical value it read one step earlier) and its
// horizontal one from a register (its own previous cell); one
// __syncthreads a step. Row 0 reads the carried row, staged into shared
// memory blockDim.x columns at a time. A chunk longer than the block
// (blockDim.x <= 1024 rows) runs in bands of blockDim.x rows, each band
// resuming from the previous band's last row, so any N and M are taken.
// Every cell is written to rows_out [P, C, M] (null: not written) and the
// band's last row to last_out [P, M] (always: the new carried row).
//
// Bound on this card: bytes. At full width (K = 256 pairs, N = 384 rows,
// M = 360) the matrix stack is 141.6 MB written once, 0.042 ms at
// 3.35 TB/s; its 35.4 M cells take 5 f32 operations each, 0.005 ms at
// 33.5 T operations a second (no FMA under -fmad=false: half the FMA-
// counted 67 TFLOP/s). This first version is latency-bound rather than byte-bound:
// each step is one dependent cell per thread plus a barrier, and a
// warp's stores go to 32 different rows (stride M - 1), one 4-byte
// sector write each, which L2 merges before they reach memory. Staging
// the diagonals through shared memory into row-contiguous stores is left
// to a later version.
//
// Every add is an _rn intrinsic and the library is built with
// -fmad=false, so each result rounds as the plain PyTorch version's does.
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e38f;

__global__ void dtw_matrix_kernel(const float* __restrict__ xs,
                                  long long x_stride,
                                  const float* __restrict__ ys,
                                  const float* row_in,
                                  const int* __restrict__ qlens,
                                  const int* __restrict__ rlens,
                                  float* rows_out, float* last_out, int C,
                                  int M, int n0, int band) {
  extern __shared__ float sh[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  float* vbuf = sh;            // [2][T]: the last two diagonals by row
  float* car = sh + 2 * T;     // [T]: carried-row columns of this window
  const int p = blockIdx.x;
  const float* x = xs + (long long)p * x_stride;
  const float* y = ys + (long long)p * M;
  float* out = rows_out ? rows_out + (long long)p * C * M : nullptr;
  float* last = last_out + (long long)p * M;
  const int rl = rlens[p];
  const long long ql = qlens[p];
  const long long qden = ql - 1 > 1 ? ql - 1 : 1;
  for (int b0 = 0; b0 < C; b0 += T) {
    const int nb = C - b0 < T ? C - b0 : T;
    // the row above this band: the carried row, then the previous band's
    // last row (written to last_out by this block before the barrier).
    const float* carry = b0 == 0 ? (row_in ? row_in + (long long)p * M
                                           : nullptr)
                                 : last;
    const bool active = tid < nb;
    const int gi = b0 + tid;
    const long long ai = (long long)n0 + gi;     // absolute query row
    const float xv = active ? x[gi] : 0.f;
    const long long centre = band >= 0 ? ai * (rl - 1) / qden : 0;
    float h = kInf;                        // own row, previous column
    float dg = ai == 0 ? 0.f : kInf;       // diag of column 0
    const int steps = nb + M - 1;
    for (int s = 0; s < steps; ++s) {
      if (s % T == 0) {
        const int c = s + tid;
        car[tid] = (carry != nullptr && c < M) ? carry[c] : kInf;
        __syncthreads();
      }
      const int j = s - tid;
      if (active && j >= 0 && j < M) {
        const float vt =
            tid == 0 ? car[s % T] : vbuf[((s - 1) & 1) * T + tid - 1];
        float d = fabsf(__fsub_rn(xv, y[j]));
        if (band >= 0) {
          const long long off = (long long)j - centre;
          if ((off < 0 ? -off : off) > band) d = kInf;
        }
        const float best = fminf(fminf(dg, vt), h);
        const float cell = fminf(__fadd_rn(d, best), kInf);
        h = cell;
        dg = vt;
        vbuf[(s & 1) * T + tid] = cell;
        if (out) out[(long long)gi * M + j] = cell;
        if (tid == nb - 1) last[j] = cell;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// K7. Pair p's query chunk is xs[p * x_stride : p * x_stride + C]
// (x_stride 0: one query shared by every pair, the bank form), its
// reference ys[p * M : (p + 1) * M]; qlens and rlens [P] give the band
// geometry (read only when band >= 0). Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int dtw_matrix_rows(const float* xs, long long x_stride,
                               const float* ys, const float* row_in,
                               const int* qlens, const int* rlens,
                               float* rows_out, float* last_out, int P,
                               int C, int M, int n0, int band,
                               void* stream) {
  if (P == 0 || C == 0 || M == 0) return 0;
  int T = ((C + 31) / 32) * 32;
  if (T > 1024) T = 1024;
  const size_t smem = 3 * (size_t)T * sizeof(float);
  dtw_matrix_kernel<<<P, T, smem, (cudaStream_t)stream>>>(
      xs, x_stride, ys, row_in, qlens, rlens, rows_out, last_out, C, M, n0,
      band);
  return (int)cudaGetLastError();
}
