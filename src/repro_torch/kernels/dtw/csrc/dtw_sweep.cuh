// Column sweep of the moment-carrying DTW recurrence, shared by the
// streaming tick (stream.cu) and the offline verdict scorer (score.cu).
//
// One thread owns one (query, reference) pair. It walks the reference
// columns j = 0, 1, ... left to right and, at each column, updates up to
// kRows query rows top to bottom, keeping the previous column's value of
// each row (DP distance plus the three warp-path moment bases) in
// registers:
//
//   diag(i, j)  = row i-1 at column j-1   (the state row for i = 0)
//   vert(i, j)  = row i-1 at column j     (the state row for i = 0)
//   horiz(i, j) = row i   at column j-1
//
//   D(i, j) = min(d(i, j) + min(min(diag, vert), horiz), 3e38)
//
// with d = |x_i - y_j| (3e38 outside the Sakoe-Chiba band). The
// predecessor is chosen diag, then vert, then horiz, the tie order of
// repro's host backtrack. A cell's moments are base + pair(i, j) with
// pair = (yc, yc^2, (x_i - 0.5) yc), yc = y_j - 0.5; an anchored cell
// (diag or vert) takes its predecessor's full moments as base, a
// horizontal cell carries the base of its left neighbour. That is what
// the Pallas kernel's anchored forward fill computes, so the two round
// alike. Only the state row (the last valid query row) is read and
// written: each column costs one coalesced load and store per channel,
// since neighbouring threads hold neighbouring references in the K-last
// layout. The state row is the DP row after the previous samples; a pass
// handles at most kRows samples and longer chunks take several passes
// over the row, which keeps the row set in registers.
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
constexpr int kRows = 16;

// One pass of `nrows` (<= kRows) query rows over reference columns
// [0, ncols). Row r is query sample n0 + r, x[r]. Column j of the
// reference is y[j * col_stride]; column j of the state row is
// d_in[j * col_stride] and channel c of its moments
// m_in[c * ch_stride + j * col_stride] (likewise for the outputs, which
// may alias the inputs). `fresh`: the state row is the empty one
// (D = 3e38, moments 0) and is not read. `write`: store the pass's last
// row. Column `capture` (-1: none) of the last row is copied to cap[4].
// nrows == 0 copies the state row through.
__device__ __forceinline__ void sweep_pass(
    const float* __restrict__ x, int nrows, int n0, int qlen, int band,
    int len_k, const float* __restrict__ y, long long col_stride,
    int ncols, const float* d_in, const float* m_in, float* d_out,
    float* m_out, long long ch_stride, bool fresh, bool write,
    int capture, float cap[4]) {
  float xr[kRows], xm[kRows];
  int center[kRows];
  float pd[kRows], pb0[kRows], pb1[kRows], pb2[kRows];
  const int qden = qlen - 1 > 1 ? qlen - 1 : 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float xv = r < nrows ? x[r] : 0.f;
    xr[r] = xv;
    xm[r] = __fsub_rn(xv, kShift);
    // all terms are non-negative: C's '/' is the floor division
    center[r] = band >= 0 ? ((n0 + r) * (len_k - 1)) / qden : 0;
    pd[r] = kInf;
    pb0[r] = 0.f;
    pb1[r] = 0.f;
    pb2[r] = 0.f;
  }
  // the state row one column to the left: the diag predecessor of row 0
  // (column -1 is the virtual corner D[-1, -1] = 0 for a job's first
  // sample only).
  float sd_prev = n0 == 0 ? 0.f : kInf;
  float sm0_prev = 0.f, sm1_prev = 0.f, sm2_prev = 0.f;
  float yc_prev = 0.f;
  for (int j = 0; j < ncols; ++j) {
    const long long off = (long long)j * col_stride;
    const float yv = y[off];
    const float yc = __fsub_rn(yv, kShift);
    const float yy = __fmul_rn(yc, yc);
    const float yy_prev = __fmul_rn(yc_prev, yc_prev);
    float sd, sm0, sm1, sm2;
    if (fresh) {
      sd = kInf;
      sm0 = sm1 = sm2 = 0.f;
    } else {
      sd = d_in[off];
      sm0 = m_in[off];
      sm1 = m_in[ch_stride + off];
      sm2 = m_in[2 * ch_stride + off];
    }
    float dd = sd_prev, dm0 = sm0_prev, dm1 = sm1_prev, dm2 = sm2_prev;
    float vd = sd, vm0 = sm0, vm1 = sm1, vm2 = sm2;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        const float hd = pd[r];
        float d = fabsf(__fsub_rn(xr[r], yv));
        if (band >= 0 && abs(j - center[r]) > band) d = kInf;
        const float best = fminf(fminf(dd, vd), hd);
        const float cell = fminf(__fadd_rn(d, best), kInf);
        const bool sel_diag = dd <= fminf(vd, hd);
        const bool sel_vert = !sel_diag && vd <= hd;
        const float b0 = sel_diag ? dm0 : (sel_vert ? vm0 : pb0[r]);
        const float b1 = sel_diag ? dm1 : (sel_vert ? vm1 : pb1[r]);
        const float b2 = sel_diag ? dm2 : (sel_vert ? vm2 : pb2[r]);
        // row r's full moments at column j-1: the next row's diag.
        const float nm0 = __fadd_rn(pb0[r], yc_prev);
        const float nm1 = __fadd_rn(pb1[r], yy_prev);
        const float nm2 = __fadd_rn(pb2[r], __fmul_rn(xm[r], yc_prev));
        const float m0 = __fadd_rn(b0, yc);
        const float m1 = __fadd_rn(b1, yy);
        const float m2 = __fadd_rn(b2, __fmul_rn(xm[r], yc));
        dd = hd;
        dm0 = nm0;
        dm1 = nm1;
        dm2 = nm2;
        pd[r] = cell;
        pb0[r] = b0;
        pb1[r] = b1;
        pb2[r] = b2;
        vd = cell;
        vm0 = m0;
        vm1 = m1;
        vm2 = m2;
      }
    }
    if (write) {
      d_out[off] = vd;
      m_out[off] = vm0;
      m_out[ch_stride + off] = vm1;
      m_out[2 * ch_stride + off] = vm2;
    }
    if (j == capture) {
      cap[0] = vd;
      cap[1] = vm0;
      cap[2] = vm1;
      cap[3] = vm2;
    }
    sd_prev = sd;
    sm0_prev = sm0;
    sm1_prev = sm1;
    sm2_prev = sm2;
    yc_prev = yc;
  }
}

}  // namespace dtw
