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
// ((n0 + i) * (rlen_p - 1)) / max(qlen_p - 1, 1), C's division), and the
// virtual corner D[-1, -1] = 0 only for absolute row 0 (n0 == 0). Every
// cell goes through dtw_sweep.cuh's dp_cell<0, BAND>, the cell of K1, K3
// and K2 (its minimum taken in another, exactly equal, order), so K7's
// rows are bitwise K3's and K1's rows and K2's endpoint distances on any
// data. The TPU kernel solves each row with a min-plus Hillis-Steele
// scan, which adds the costs in a tree: the two agree bitwise where every
// sum is exact (dyadic data), and to rounding elsewhere.
//
// Design: a warp per pair runs the DP as a wavefront, the schedule of the
// verdict scorers (score.cu). Lane l owns a strip of W consecutive
// columns, W = min(12, ceil(M / 32)) (each W its own instantiation, so the
// strip's registers are indexed at compile time), and a panel of 32 W
// columns spans the warp. Query rows stream from the top, skewed: at step
// t lane l updates row i = t - l across its strip, left to right. The
// horizontal predecessor is the strip's previous cell (a register), the
// vertical one the lane's own row above (registers; the carried row for
// the chunk's first row), the strip's left edge (row i at column s0 - 1)
// arrives from lane l - 1 by __shfl_up_sync, and the diagonal is the edge
// received one step before. No block barrier: a step's only wait is the
// shuffle. A reference longer than 384 columns runs in panels, left to
// right: the last lane of a panel writes its right edge column into the
// pair's [C] edge buffer, which lane 0 of the next panel reads as its left
// edge (in place: row i is read at step i and rewritten at step i + 31 of
// the next panel). Lanes wholly past M sweep nothing.
//
// Stores: rows, never diagonals. At step t lane l holds row t - l of its
// strip, W consecutive columns, and writes it as 16-byte vector stores
// where its address is 16-byte aligned (8-byte or scalar otherwise): a
// warp's store writes 32 rows, 16 bytes each. The last row (last_out, the
// new carried row) is always written; the rows (rows_out) only when it is
// not null. Staging the strips through a per-warp 33-row shared-memory
// ring into coalesced row stores was 4-6% slower on the H100 at the
// full-width matching phase's 256 pairs (PERF.md).
//
// Bound on this card: bytes. At full width (K = 256 pairs, N = 384 rows,
// M = 360) the matrix stack is 141.6 MB written once, 0.042 ms at
// 3.35 TB/s; its 35.4 M cells take 5 f32 operations each, 0.005 ms at
// 33.5 T operations a second (no FMA under -fmad=false: half the FMA-
// counted 67 TFLOP/s). A step's critical path is the shuffle and the
// strip's W dependent cells, 415 steps a full-width pair; the 256 pairs
// run at once, two warps an SM. With the rows stored, each step takes
// about twice as long as without: at two warps an SM a warp's stores,
// not the card's bandwidth, set the pace (neither the staged rows above
// nor a second warp a pair that copies them out ran faster).
//
// Every add is an _rn intrinsic and the library is built with
// -fmad=false, so each result rounds as the plain PyTorch version's does.
#include <stdint.h>

#include "dtw_sweep.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kStrip = 12;  // widest strip: 32 of them span 384 columns
constexpr unsigned kFull = 0xffffffffu;
using dtw::kInf;

// The band centres of one lane's consecutive absolute rows ai, ai + 1, ...:
// ai * (rl - 1) / den with C's truncating division, carried as the
// quotient and remainder of ai |rl - 1| over den (one division a panel,
// none a row). Handed to dp_cell as an int clamped to +-2^30, which
// changes no band test while band < 2^30 - M.
template <bool BAND>
struct BandCentre {
  long long q = 0, r = 0, dq = 0, dr = 0, den = 1;
  bool neg = false;
  __device__ BandCentre(long long ai, int rl, long long d) {
    if (!BAND) return;
    const long long a = rl - 1 < 0 ? 1 - (long long)rl : rl - 1;
    neg = rl - 1 < 0;
    den = d;
    q = ai * a / d;
    r = ai * a % d;
    dq = a / d;
    dr = a % d;
  }
  __device__ __forceinline__ int get() const {
    if (!BAND) return 0;
    const long long c = neg ? -q : q;
    const long long lim = 1ll << 30;
    return (int)(c > lim ? lim : (c < -lim ? -lim : c));
  }
  __device__ __forceinline__ void next() {
    if (!BAND) return;
    q += dq;
    r += dr;
    if (r >= den) {
      r -= den;
      ++q;
    }
  }
};

// The n (<= W) leading values of a strip to dst: 16-byte stores when the
// strip is whole (n == W) and dst 16-byte aligned, 8-byte when 8-byte
// aligned, else one float at a time.
template <int W>
__device__ __forceinline__ void store_strip(float* dst, const float (&v)[W],
                                            int n, bool whole) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if constexpr (W % 4 == 0) {
    if (whole && (a & 15) == 0) {
#pragma unroll
      for (int w = 0; w < W; w += 4)
        *reinterpret_cast<float4*>(dst + w) =
            make_float4(v[w], v[w + 1], v[w + 2], v[w + 3]);
      return;
    }
  }
  if constexpr (W % 2 == 0) {
    if (whole && (a & 7) == 0) {
#pragma unroll
      for (int w = 0; w < W; w += 2)
        *reinterpret_cast<float2*>(dst + w) = make_float2(v[w], v[w + 1]);
      return;
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w < n) dst[w] = v[w];
}

// Block p (one warp) computes pair p's C rows (see the header).
template <int W, bool BAND>
__global__ void __launch_bounds__(kLanes)
    dtw_matrix_kernel(const float* __restrict__ xs, long long x_stride,
                      const float* __restrict__ ys, const float* row_in,
                      const int* __restrict__ qlens,
                      const int* __restrict__ rlens, float* rows_out,
                      float* last_out, float* edges, int C, int M, int n0,
                      int band) {
  constexpr int PW = kLanes * W;
  const int lane = threadIdx.x;
  const int p = blockIdx.x;
  const float* x = xs + p * x_stride;
  const float* y = ys + (long long)p * M;
  const float* rin = row_in ? row_in + (long long)p * M : nullptr;
  float* out = rows_out ? rows_out + (long long)p * C * M : nullptr;
  float* last = last_out + (long long)p * M;
  float* edge = edges ? edges + (long long)p * C : nullptr;
  const int rl = BAND ? rlens[p] : 0;
  const long long ql = BAND ? qlens[p] : 0;
  const long long den = ql - 1 > 1 ? ql - 1 : 1;
  const int npanel = (M + PW - 1) / PW;
  float nil[1] = {0.f};  // dp_cell's moment arguments: none for NCH = 0
  for (int pn = 0; pn < npanel; ++pn) {
    const int pbase = pn * PW;
    const int s0 = pbase + lane * W;
    // the lane's columns inside M: W for the panel's whole strips, the
    // rest for the one M cuts, none past it. (Written as min / max, the
    // whole-strip test of the last-row store compiled to a test that held
    // for the strip M cuts, which then stored all W columns: chip_smoke's
    // references of 385-1000 columns caught it.)
    const int nfull = (M - pbase) / W;
    const bool whole = lane < nfull;
    const int ncol = whole ? W : (lane == nfull ? (M - pbase) % W : 0);
    const int nact = min(kLanes, (M - pbase + W - 1) / W);
    // the strip's columns, and its row above: the carried row
    float yv[W], vD[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      yv[w] = w < ncol ? y[s0 + w] : 0.f;
      vD[w] = w < ncol && rin ? rin[s0 + w] : kInf;
    }
    // the carried row at column s0 - 1: the first row's diag (column -1:
    // the virtual corner D[-1, -1] = 0 for the absolute first row)
    float pD = s0 == 0 ? (n0 == 0 ? 0.f : kInf)
                       : (rin && ncol > 0 ? rin[s0 - 1] : kInf);
    // this lane's right edge of the last step, sent to lane + 1
    float sD = kInf;
    BandCentre<BAND> centre(n0, rl, den);
    const bool write_edge = pn + 1 < npanel && lane == kLanes - 1;
    const int nsteps = C + nact - 1;
    // row i's sample and, for lane 0, the previous panel's edge at row i
    // (column -1: 3e38), loaded a step ahead
    auto load_x = [&](int i) { return i >= 0 && i < C ? x[i] : 0.f; };
    auto load_edge = [&](int i) {
      return lane == 0 && pn > 0 && i < C ? edge[i] : kInf;
    };
    float xv_next = load_x(-lane), e_next = load_edge(0);
    for (int t = 0; t < nsteps; ++t) {
      const int i = t - lane;
      const float xv = xv_next, ev = e_next;
      xv_next = load_x(i + 1);
      e_next = load_edge(i + 1);
      // row i at column s0 - 1: lane l - 1's last cell of the last step;
      // lane 0's is the previous panel's edge
      float hD = __shfl_up_sync(kFull, sD, 1);
      if (lane == 0) hD = ev;
      const bool live = i >= 0 && i < C && ncol > 0;
      if (live) {
        const int center = centre.get();
        float dD = pD;  // row i - 1 at column s0 - 1
        pD = hD;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float oD = vD[w];
          hD = dtw::dp_cell<0, BAND>(xv, 0.f, 0.f, center, yv[w], 0.f, 0.f,
                                     s0 + w, band, dD, nil, oD, nil, hD, nil,
                                     nil);
          vD[w] = hD;
          dD = oD;
        }
        sD = hD;
        if (write_edge) edge[i] = hD;
        centre.next();
        if (out) store_strip<W>(out + (long long)i * M + s0, vD, ncol, whole);
        if (i == C - 1) store_strip<W>(last + s0, vD, ncol, whole);
      }
    }
    __syncwarp();  // the panel's edge writes before the next panel's reads
  }
}

// The instantiation of strip width w (W <= w <= kStrip) and band.
template <int W = 1>
int launch(int w, bool band_on, const float* xs, long long x_stride,
           const float* ys, const float* row_in, const int* qlens,
           const int* rlens, float* rows_out, float* last_out, float* edges,
           int P, int C, int M, int n0, int band, cudaStream_t stream) {
  if (w == W) {
    auto kernel = band_on ? dtw_matrix_kernel<W, true>
                          : dtw_matrix_kernel<W, false>;
    kernel<<<P, kLanes, 0, stream>>>(xs, x_stride, ys, row_in, qlens, rlens,
                                     rows_out, last_out, edges, C, M, n0,
                                     band);
    return (int)cudaGetLastError();
  }
  if constexpr (W < kStrip)
    return launch<W + 1>(w, band_on, xs, x_stride, ys, row_in, qlens, rlens,
                         rows_out, last_out, edges, P, C, M, n0, band,
                         stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The widest panel of the wavefront: references longer than this need the
// [P, C] panel-edge buffer.
extern "C" int dtw_matrix_panel() { return kLanes * kStrip; }

// K7. Pair p's query chunk is xs[p * x_stride : p * x_stride + C]
// (x_stride 0: one query shared by every pair, the bank form), its
// reference ys[p * M : (p + 1) * M]; qlens and rlens [P] give the band
// geometry (read only when band >= 0); edges is the [P, C] f32 panel-edge
// buffer, read and written only when M > dtw_matrix_panel() (null
// otherwise). Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue when a longer reference comes without an edge
// buffer.
extern "C" int dtw_matrix_rows(const float* xs, long long x_stride,
                               const float* ys, const float* row_in,
                               const int* qlens, const int* rlens,
                               float* rows_out, float* last_out,
                               float* edges, int P, int C, int M, int n0,
                               int band, void* stream) {
  if (P == 0 || C == 0 || M == 0) return 0;
  const int w = min(kStrip, (M + kLanes - 1) / kLanes);
  if (M > kLanes * w && edges == nullptr) return (int)cudaErrorInvalidValue;
  return launch(w, band >= 0, xs, x_stride, ys, row_in, qlens, rlens,
                rows_out, last_out, edges, P, C, M, n0, band,
                (cudaStream_t)stream);
}
