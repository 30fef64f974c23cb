// The moment-carrying DTW recurrence: its cell update (dp_cell, the one
// definition that the ticks' column sweep below, K1, K3 and K4, and the
// verdict scorers' warp wavefront, score.cu's K2, K2 pairs, K5 and K6,
// both call, so they cannot drift apart), and the column sweep.
//
// In the sweep one thread owns one (query, reference) pair. It walks the
// reference columns j = 0, 1, ... left to right and, at each column,
// updates up to ROWS query rows top to bottom, keeping the previous
// column's value of each row (DP distance plus NCH warp-path moment
// bases) in registers:
//
//   diag(i, j)  = row i-1 at column j-1   (the state row for i = 0)
//   vert(i, j)  = row i-1 at column j     (the state row for i = 0)
//   horiz(i, j) = row i   at column j-1
//
//   D(i, j) = min(d(i, j) + min(min(diag, vert), horiz), 3e38)
//
// with d = |x_i - y_j| (3e38 outside the Sakoe-Chiba band). The
// predecessor is chosen diag, then vert, then horiz, the tie order of
// repro's host backtrack. A cell's moments are base + pair(i, j); an
// anchored cell (diag or vert) takes its predecessor's full moments as
// base, a horizontal cell carries the base of its left neighbour. That is
// what the Pallas kernel's anchored forward fill computes, so the two
// round alike. Only the state row (the last valid query row) is read and
// written: each column costs one coalesced load and store per channel,
// since neighbouring threads hold neighbouring references in the K-last
// layout. The state row is the DP row after the previous samples; a pass
// handles at most ROWS samples and longer chunks take several passes over
// the row, which keeps the row set in registers.
//
// The pair of row i and column j, with yc = y_j - 0.5, xm = x_i - 0.5 and
// v_i the sample's measurement variance, is
//
//   NCH = 3 (point):          (yc, yc^2, xm yc)
//   NCH = 4 (approx prob):    (yc, yc^2, xm yc, v yc)
//   NCH = 6 (exact prob):     (yc, yc^2, xm yc, v yc, v yc^2, v (xm yc))
//
//   NCH = 0 (distance only):  no pairs; the DP distances alone
//
// Each variance channel is v times the matching base pair, formed after
// it (v * (xm * yc), never (v * xm) * yc), as the reference forms it.
// Channel 3 is svy in both variance layouts. The distances never read
// the moments, so every channel count computes bitwise the same rows:
// the NCH = 0 instantiation (the distance-only tick) is the NCH = 3 one
// with its moment code compiled out.
//
// Every add and multiply below is written with an _rn intrinsic, and the
// library is built with -fmad=false: nothing is contracted into a fused
// multiply-add, so each result rounds exactly as the plain PyTorch
// version's does.
#pragma once

#include <cuda_runtime.h>

namespace dtw {

constexpr float kInf = 3.0e38f;
constexpr float kShift = 0.5f;

// Rows a pass holds in registers for NCH channels: per row the distance,
// NCH bases, x, x - 0.5, v and the band centre. 16 rows fit for 3 and 4
// channels; 6 channels take 8 rows, so a 16-sample chunk is two passes.
// With no channels a row is the distance, x and the band centre: 16 rows
// take a 16-sample chunk (the main path's) in one pass at 69 registers
// and no spill (ptxas -v on sm_90a), so seven 128-thread blocks fit an
// SM; more rows would only serve chunks longer than the main path's, at
// a lower occupancy. A longer chunk takes one more pass per 16 samples.
template <int NCH>
struct RowsPerPass {
  static constexpr int value = NCH == 6 ? 8 : 16;
};

// Array extent for NCH channels: C++ has no zero-length arrays, and with
// NCH = 0 every loop over the channels runs zero times.
template <int NCH>
struct Extent {
  static constexpr int value = NCH > 0 ? NCH : 1;
};

// The NCH pair values of one (row, column) cell (see the header).
template <int NCH>
__device__ __forceinline__ void pair(float yc, float yy, float xm, float v,
                                     float out[NCH]) {
  out[0] = yc;
  out[1] = yy;
  out[2] = __fmul_rn(xm, yc);
  if constexpr (NCH >= 4) out[3] = __fmul_rn(v, yc);
  if constexpr (NCH == 6) {
    out[4] = __fmul_rn(v, yy);
    out[5] = __fmul_rn(v, out[2]);
  }
}

// The full moments of a cell from its base: base + pair(i, j), channel by
// channel.
template <int NCH>
__device__ __forceinline__ void moments(const float base[], float yc,
                                        float yy, float xm, float v,
                                        float out[]) {
  if constexpr (NCH > 0) {
    float pr[NCH];
    pair<NCH>(yc, yy, xm, v, pr);
#pragma unroll
    for (int c = 0; c < NCH; ++c) out[c] = __fadd_rn(base[c], pr[c]);
  }
}

// One cell (row i, column j) of the recurrence. Row i is the sample x
// (xm = x - 0.5, variance v) with band centre `center`; column j is y (yc
// = y - 0.5, yy = yc^2). Its predecessors: diag (dd, full moments dm),
// vert (vd, full moments vm) and horiz (hd, base hb); band < 0 is no
// band, and BAND = false compiles the band test out. Returns D(i, j); hb
// becomes the cell's base (the selected predecessor's full moments for
// diag and vert, the left neighbour's base for horiz) and m its full
// moments, base + pair(i, j). m may alias vm.
template <int NCH, bool BAND = true>
__device__ __forceinline__ float dp_cell(float x, float xm, float v, int center,
                                         float y, float yc, float yy, int j,
                                         int band, float dd, const float dm[],
                                         float vd, const float vm[], float hd,
                                         float hb[], float m[]) {
  float d = fabsf(__fsub_rn(x, y));
  if (BAND && band >= 0 && abs(j - center) > band) d = kInf;
  // min is exact: min(dd, min(vd, hd)) is min(min(dd, vd), hd) bitwise,
  // and the inner min serves the selection too
  const float vh = fminf(vd, hd);
  const float best = fminf(dd, vh);
  const float cell = fminf(__fadd_rn(d, best), kInf);
  if constexpr (NCH > 0) {
    const bool sel_diag = dd <= vh;
    const bool sel_vert = !sel_diag && vd <= hd;
    float cur[NCH];
    pair<NCH>(yc, yy, xm, v, cur);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float b = sel_diag ? dm[c] : (sel_vert ? vm[c] : hb[c]);
      hb[c] = b;
      m[c] = __fadd_rn(b, cur[c]);
    }
  }
  return cell;
}

// One pass of `nrows` (<= ROWS) query rows over reference columns
// [0, ncols). Row r is query sample n0 + r, x[r], with variance v[r]
// (v is not read when NCH == 3). Column j of the reference is
// y[j * col_stride]; column j of the state row is d_in[j * col_stride]
// and channel c of its moments m_in[c * ch_stride + j * col_stride]
// (likewise for the outputs, which may alias the inputs; with NCH = 0
// m_in and m_out are not read and may be null). `fresh`: the
// state row is the empty one (D = 3e38, moments 0) and is not read.
// `write`: store the pass's last row. Column `capture` (-1: none) of the
// last row is copied to cap[1 + NCH] (distance, then the moments).
// nrows == 0 copies the state row through.
template <int NCH, int ROWS>
__device__ __forceinline__ void sweep_pass(
    const float* __restrict__ x, const float* __restrict__ v, int nrows,
    int n0, int qlen, int band, int len_k, const float* __restrict__ y,
    long long col_stride, int ncols, const float* d_in, const float* m_in,
    float* d_out, float* m_out, long long ch_stride, bool fresh, bool write,
    int capture, float cap[1 + NCH]) {
  constexpr int NE = Extent<NCH>::value;
  float xr[ROWS], xm[ROWS], vr[ROWS];
  int center[ROWS];
  float pd[ROWS], pb[ROWS][NE];
  const int qden = qlen - 1 > 1 ? qlen - 1 : 1;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float xv = r < nrows ? x[r] : 0.f;
    xr[r] = xv;
    xm[r] = __fsub_rn(xv, kShift);
    vr[r] = (NCH > 3 && r < nrows) ? v[r] : 0.f;
    // all terms are non-negative: C's '/' is the floor division
    center[r] = band >= 0 ? ((n0 + r) * (len_k - 1)) / qden : 0;
    pd[r] = kInf;
#pragma unroll
    for (int c = 0; c < NCH; ++c) pb[r][c] = 0.f;
  }
  // the state row one column to the left: the diag predecessor of row 0
  // (column -1 is the virtual corner D[-1, -1] = 0 for a job's first
  // sample only).
  float sd_prev = n0 == 0 ? 0.f : kInf;
  float sm_prev[NE];
#pragma unroll
  for (int c = 0; c < NCH; ++c) sm_prev[c] = 0.f;
  float yc_prev = 0.f;
  for (int j = 0; j < ncols; ++j) {
    const long long off = (long long)j * col_stride;
    const float yv = y[off];
    const float yc = __fsub_rn(yv, kShift);
    const float yy = __fmul_rn(yc, yc);
    const float yy_prev = __fmul_rn(yc_prev, yc_prev);
    float sd, sm[NE];
    if (fresh) {
      sd = kInf;
#pragma unroll
      for (int c = 0; c < NCH; ++c) sm[c] = 0.f;
    } else {
      sd = d_in[off];
#pragma unroll
      for (int c = 0; c < NCH; ++c) sm[c] = m_in[c * ch_stride + off];
    }
    float dd = sd_prev, vd = sd, dm[NE], vm[NE];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      dm[c] = sm_prev[c];
      vm[c] = sm[c];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
        const float hd = pd[r];
        // row r's full moments at column j-1: the next row's diag
        float nd[NE];
        moments<NCH>(pb[r], yc_prev, yy_prev, xm[r], vr[r], nd);
        const float cell =
            dp_cell<NCH>(xr[r], xm[r], vr[r], center[r], yv, yc, yy, j, band,
                         dd, dm, vd, vm, hd, pb[r], vm);
#pragma unroll
        for (int c = 0; c < NCH; ++c) dm[c] = nd[c];
        dd = hd;
        pd[r] = cell;
        vd = cell;
      }
    }
    if (write) {
      d_out[off] = vd;
#pragma unroll
      for (int c = 0; c < NCH; ++c) m_out[c * ch_stride + off] = vm[c];
    }
    if (j == capture) {
      cap[0] = vd;
#pragma unroll
      for (int c = 0; c < NCH; ++c) cap[1 + c] = vm[c];
    }
    sd_prev = sd;
#pragma unroll
    for (int c = 0; c < NCH; ++c) sm_prev[c] = sm[c];
    yc_prev = yc;
  }
}

}  // namespace dtw
