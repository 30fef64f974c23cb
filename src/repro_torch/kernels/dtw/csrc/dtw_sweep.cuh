// The moment-carrying DTW recurrence: its cell update (dp_cell, the one
// definition that the ticks' column sweep below, K1, K3 and K4, and the
// verdict scorers' warp wavefront, score.cu's K2, K2 pairs, K5 and K6,
// both call, so they cannot drift apart), and the column sweep.
//
// In the sweep a group of G lanes of one warp owns one (query,
// reference) pair. Together they walk the reference columns j = 0, 1, ...
// left to right through a pass of up to 16 query rows, each row keeping
// its value at the previous column in registers (DP distance, NCH
// warp-path moment bases, and the NCH full moments base + pair):
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
// round alike.
//
// The pass's rows are split over the group: lane g holds rows
// [g R, (g + 1) R), R = 16 / G, and runs skewed, column j = t - g at step
// t. Its first row's vert (column j) and diag (column j - 1) are lane
// g - 1's last row, received by __shfl_up_sync one step late with the
// column's y; lane 0 reads them from the state row instead, the last
// lane writes its last row back as the new state row. Only the state row
// is read and written, once a pass: each column costs one load and one
// store per channel, and the groups of a warp hold neighbouring
// references of the K-last layout, so they fill whole 32-byte sectors.
// The warp stages both through shared memory (sweep_pass). A lane
// before its first column (t < g) is fed the virtual column j < 0 (y =
// 0.5, distance 3e38, moments 0), which leaves its rows as they start;
// after its last it computes columns past M that nothing reads. A pass
// handles at most 16 samples; a longer chunk takes one more pass over
// the row per 16 samples.
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
// with its moment code compiled out and its minimum taken in another,
// exactly equal, order.
//
// Every add and multiply below is written with an _rn intrinsic, and the
// library is built with -fmad=false: nothing is contracted into a fused
// multiply-add, so each result rounds exactly as the plain PyTorch
// version's does.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace dtw {

constexpr float kInf = 3.0e38f;
constexpr float kShift = 0.5f;

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
  // min is exact: min(dd, min(vd, hd)) is min(min(dd, vd), hd) bitwise.
  // With moments the inner min serves the selection too; without, the
  // diag and horiz are known before the vert (the row above), so only
  // the outer min waits on it.
  const float vh = fminf(vd, hd);
  const float best = NCH > 0 ? fminf(dd, vh) : fminf(vd, fminf(dd, hd));
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


// The ticks' column sweep (see the header).

// Rows a pass holds, split over a group.
constexpr int kPassRows = 16;
// Column slots of a warp's load ring: the copies of a column are issued
// kRing - 1 steps before it is computed.
constexpr int kRing = 8;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Lanes a group holds for NCH channels (a power of 2 dividing 16): each
// lane keeps 16 / G rows of 2 + 2 NCH floats (3 + 2 NCH with variances).
// Fewer lanes with more rows each ran faster on an H100, as long as the
// rows fit the registers: a lane's rows run a column in series, but each
// extra lane adds its column's shuffles and a slice of the staging.
// Sixteen rows of 3 channels take 235 registers, eight of 6 take 236.
template <int NCH>
struct Split {
  static constexpr int value = NCH == 0 ? 1 : NCH == 3 ? 1 : 2;
};

// A warp's shared column tiles: the load ring (per slot, the state row's
// distance, NCH moments and the reference's y for each of the warp's
// groups) and one column of the last lanes' rows on their way out.
template <int NCH, int G>
struct Stage {
  static constexpr int NG = kWarp / G;  // groups a warp
  static constexpr int NV = NCH + 2;    // values a column loads
  static constexpr int NS = NCH + 1;    // values a column stores
  float ring[kRing][NV][NG];
  float out[NS][NG];
};

// One pass of `nrows` (<= kPassRows) query rows over reference columns
// [0, M), run by one warp for its groups: the group's k is k0 + lane / G
// and the lane is g = lane % G of it. Row r of the lane is query sample
// n0 + g R + r, x[g R + r], with variance v[g R + r] (read when NCH > 3).
// Column j of reference k is y[j * K + k]; of the state row, d_in[j * K
// + k] and channel c of its moments m_in[c * ch_stride + j * K + k]
// (d_in, m_in, y and the outputs are offset to the warp's slot; with NCH
// = 0, m_in and m_out are not read; M K < 2^31). The pass's last row
// goes to d_out and m_out, which never alias the inputs, for k < K; a
// group past K sweeps reference K - 1. FULL: nrows == kPassRows, so no row is guarded.
// A row at or past nrows passes the row above through, as a padded
// sample does; nrows == 0 copies the state row through.
//
// Loads: each lane copies its share of a column's NV x NG values into
// the ring with cp.async (4 bytes each), kRing - 1 columns ahead; lane 0
// of each group reads its values there. Stores: the last lanes write
// their column into `out`, and the warp copies it to memory, each lane
// its share. __syncwarp orders each hand-over.
template <int NCH, int G, bool BAND, bool FULL>
__device__ __forceinline__ void sweep_pass(
    Stage<NCH, G>& st, int lane, const float* __restrict__ x,
    const float* __restrict__ v, int nrows, int n0, int qlen, int band,
    int len_k, const float* __restrict__ y, int k0, int K, int M,
    const float* d_in, const float* m_in, float* d_out, float* m_out,
    long long ch_stride) {
  using S = Stage<NCH, G>;
  constexpr int R = kPassRows / G;
  constexpr int NE = Extent<NCH>::value;
  constexpr int NI = (S::NV * S::NG + kWarp - 1) / kWarp;  // copies a lane
  constexpr int NO = (S::NS * S::NG + kWarp - 1) / kWarp;  // stores a lane
  const int g = lane % G;
  const int q = lane / G;
  const int k = min(k0 + q, K - 1);
  const int nr = FULL ? R : min(max(nrows - g * R, 0), R);
  float xr[R], xm[R], vr[R];
  int center[R];
  float pd[R], pb[R][NE], pf[R][NE];
  const int qden = qlen - 1 > 1 ? qlen - 1 : 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool ok = FULL || r < nr;
    const float xv = ok ? x[g * R + r] : 0.f;
    xr[r] = xv;
    xm[r] = __fsub_rn(xv, kShift);
    vr[r] = NCH > 3 && ok ? v[g * R + r] : 0.f;
    // all terms are non-negative: C's '/' is the floor division
    center[r] = BAND ? ((n0 + g * R + r) * (len_k - 1)) / qden : 0;
    pd[r] = kInf;
#pragma unroll
    for (int c = 0; c < NCH; ++c) pb[r][c] = pf[r][c] = 0.f;
  }
  // this lane's shares: value i = lane + 32 n of a column is value i / NG
  // of group i % NG
  const float* src[NI];
  int src_at[NI];
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int i = lane + kWarp * n;
    const int val = i / S::NG, grp = i % S::NG;
    const int kk = min(k0 + grp, K - 1);
    src[n] = (val == 0        ? d_in
              : val < S::NV - 1 ? m_in + (val - 1) * ch_stride
                                : y) + kk;
    src_at[n] = i < S::NV * S::NG ? i : -1;
  }
  float* dst[NO];
  int dst_at[NO];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int i = lane + kWarp * n;
    const int val = i / S::NG, grp = i % S::NG;
    dst[n] = (val == 0 ? d_out : m_out + (val - 1) * ch_stride) + k0 + grp;
    dst_at[n] = i < S::NS * S::NG && k0 + grp < K ? i : -1;
  }
  // copy column j, if there is one, into ring slot `slot`; commit a
  // group every step, empty or not, so that the wait below counts steps
  auto fetch = [&](int j, int slot) {
    if (j < M) {
      const int off = j * K;
#pragma unroll
      for (int n = 0; n < NI; ++n)
        if (S::NV * S::NG % kWarp == 0 || src_at[n] >= 0)
          __pipeline_memcpy_async(&st.ring[slot][0][0] + src_at[n],
                                  src[n] + off, sizeof(float));
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int u = 0; u < kRing - 1; ++u) fetch(u, u);
  // the lane's last row at the previous step (the virtual column before
  // the first), and its first row's diag: the column before the input's
  // (column -1 is the virtual corner D[-1, -1] = 0 for a job's first
  // sample only)
  float od = kInf, om[NE], oy = kShift;
  float dd0 = g == 0 && n0 == 0 ? 0.f : kInf, dm0[NE];
#pragma unroll
  for (int c = 0; c < NCH; ++c) om[c] = dm0[c] = 0.f;
  const int nsteps = M + G - 1;
  for (int t0 = 0; t0 < nsteps; t0 += kRing) {
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
      const int t = t0 + u;
      const int j = t - g;
      // column t's copies are done (kRing - 2 later ones may not be),
      // and every lane's are visible; the slot read at step t - 1 is
      // free again
      __pipeline_wait_prior(kRing - 2);
      __syncwarp();
      // this step's column: lane 0's from the ring, the others' from
      // the lane before
      float id = od, im[NE], iy = oy;
#pragma unroll
      for (int c = 0; c < NCH; ++c) im[c] = om[c];
      if constexpr (G > 1) {
        id = __shfl_up_sync(kFullMask, id, 1, G);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          im[c] = __shfl_up_sync(kFullMask, im[c], 1, G);
        iy = __shfl_up_sync(kFullMask, iy, 1, G);
      }
      if (g == 0) {
        id = st.ring[u][0][q];
#pragma unroll
        for (int c = 0; c < NCH; ++c) im[c] = st.ring[u][1 + c][q];
        iy = st.ring[u][S::NV - 1][q];
      }
      fetch(t + kRing - 1, (u + kRing - 1) % kRing);
      const float yc = __fsub_rn(iy, kShift);
      const float yy = __fmul_rn(yc, yc);
      float dd = dd0, dm[NE], vd = id, vm[NE];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        dm[c] = dm0[c];
        vm[c] = im[c];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (FULL || r < nr) {
          const float hd = pd[r];
          // row r's full moments at column j - 1: the next row's diag
          float nd[NE];
#pragma unroll
          for (int c = 0; c < NCH; ++c) nd[c] = pf[r][c];
          const float cell =
              dp_cell<NCH, BAND>(xr[r], xm[r], vr[r], center[r], iy, yc,
                                 yy, j, band, dd, dm, vd, vm, hd, pb[r],
                                 pf[r]);
          dd = hd;
          vd = cell;
          pd[r] = cell;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            dm[c] = nd[c];
            vm[c] = pf[r][c];
          }
        }
      }
      dd0 = id;
      od = vd;
      oy = iy;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        dm0[c] = im[c];
        om[c] = vm[c];
      }
      // the last lanes' column t - (G - 1) out through `out`
      const int js = t - (G - 1);
      if (js >= 0 && js < M) {
        if (g == G - 1) {
          st.out[0][q] = vd;
#pragma unroll
          for (int c = 0; c < NCH; ++c) st.out[1 + c][q] = vm[c];
        }
        __syncwarp();
        const int off = js * K;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          if (dst_at[n] >= 0) dst[n][off] = (&st.out[0][0])[dst_at[n]];
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncwarp();
}

}  // namespace dtw
