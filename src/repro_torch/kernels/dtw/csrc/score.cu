// K2, K5 and K6: the offline verdict scorers (closed-end warp correlation,
// and the match probabilities of uncertain queries).
//
// K2 replaces repro/kernels/dtw/score.py::_score_kernel (the Pallas TPU
// kernel reached through score_bank_offline_kernel). For J complete
// queries against the [M, K] reference bank it runs each query through
// the moment-carrying DP from a fresh row and reduces at the closed-end
// column len_k - 1 to a score (the correlation of corr_from_moments) and
// the endpoint distance. Only the [J, K] results reach memory.
//
// K5 and K6 replace repro/kernels/dtw/score.py::_score_var_kernel, its
// exact and approx forms. Each query sample carries a variance (xvars
// [J, N]), the DP carries 6 (K5) or 4 (K6) moment channels, and the
// captured endpoint moments plus the query's path-independent folds
// vstats [J, 3] = (sv, svx, svxx) go through the exact or approximate
// probability tail (prob_tail.cuh) beside the point score: scores,
// probs and dists, each [J, K].
//
// K2 pairs is K2's entry for P (query, reference) pairs: warp p scores
// query p against reference p (repro/core/dtw.py::dtw_score_pairs, the
// engine of match_application, which the reference runs as jnp). It is
// K2's wavefront and tail on a K-last [M, P] reference block, so its
// scores and distances are bitwise K2's for the same pair.
//
// Design: one warp per (query, reference) pair runs the DP as a wavefront.
// Lane l owns a strip of w consecutive reference columns, w = min(W,
// ceil(len_k / 32)) (W = Strip<NCH>; each w from 1 to W is its own
// instantiation, so the registers that hold the strip's column values and
// the row above it are indexed at compile time and no cell is guarded),
// and a panel of 32 w columns spans the warp. Query rows stream from the
// top, skewed: at step t lane l updates row i = t - l across its strip,
// left to right. The strip's left boundary (row i at column start - 1:
// distance and moment base) comes from lane l - 1 by __shfl_up_sync, one
// step late; the diagonal is the same column one row up, received the
// step before, its moments formed from its base as the column sweep
// forms them. The vertical predecessor is the lane's own previous row.
// A reference longer than 32 W runs in panels, left to right: the last
// lane of a panel writes its right edge column (distance and base, 1 +
// NCH floats a row) into an [N, 1 + NCH] buffer of the pair, and lane 0
// of the next panel reads it as its left boundary (in place: row i is
// read at step i and rewritten at step i + 31, after the read it depends
// on). Columns at or past len_k feed
// nothing: lanes wholly past len_k sweep nothing, and a strip that len_k
// cuts computes its dead cells right of every live one. The lane that
// owns the endpoint (xl - 1, len_k - 1) applies the score tail.
//
// Every cell goes through dtw_sweep.cuh's dp_cell, the update the ticks'
// column sweep uses, in the same operations (-fmad=false, _rn
// intrinsics): the verdict cannot drift from the tick, and K2, K2 pairs,
// K5 and K6 are bitwise their plain versions.
//
// Bound on this card: operations (17, 21 or 29 f32 a cell for 3, 4 or 6
// channels, J * N * len_k cells; the inputs are a few hundred kilobytes).
// The wavefront puts 32 lanes on each pair (8192 warps for a 32-job
// verdict, 256 for one matrix-free query) and keeps the whole DP state in
// registers; a step's critical path is the horizontal chain through the
// strip's w cells.
#include "dtw_sweep.cuh"
#include "prob_tail.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;  // warps (pairs) a block
constexpr unsigned kFull = 0xffffffffu;

// The widest strip a lane holds, by moment channel count: 12 columns take
// a 384-column panel, the bank's full width (M = 360) in one.
template <int NCH>
struct Strip {
  static constexpr int value = 12;
};

// The wavefront of one (query, reference) pair in strips of WE columns
// (WE = min(W, ceil(lk / 32)), compile-time, so no cell of the step loop
// is guarded): the query x [xl] (variances v, read when NCH > 3) against
// reference columns y[j * col_stride], j < lk, in panels of 32 WE
// columns; `edge` is the pair's [xl, 1 + NCH] panel-edge buffer. A strip
// cut by lk computes its WE cells all the same: the cells at or past lk
// see y = 0 and feed nothing (they lie right of every real cell, and the
// lanes past lk sweep nothing). The lane that owns the endpoint (xl - 1,
// lk - 1) copies it to cap (distance, then the moments).
template <int NCH, bool BAND, int WE>
__device__ __forceinline__ void wavefront(const float* x, const float* v,
                                          int xl, const float* y,
                                          long long col_stride, int lk,
                                          float* edge, int band, int lane,
                                          float cap[1 + NCH]) {
  constexpr int NE = dtw::Extent<NCH>::value;
  constexpr int ES = 1 + NCH;  // edge floats a row
  constexpr int pw = kLanes * WE;
  const int npanel = (lk + pw - 1) / pw;
  const int qden = xl - 1 > 1 ? xl - 1 : 1;
  // the row above the strip (vertical predecessors); after the last
  // panel, the lane's last row
  float vD[WE], vM[WE][NE];
  int s0 = 0;
  for (int p = 0; p < npanel; ++p) {
    s0 = p * pw + lane * WE;
    const int ncol = max(0, min(WE, lk - s0));
    const int nact = min(kLanes, (lk - p * pw + WE - 1) / WE);
    float yv[WE], ycv[WE], yyv[WE];
#pragma unroll
    for (int w = 0; w < WE; ++w) {
      yv[w] = w < ncol ? y[(long long)(s0 + w) * col_stride] : 0.f;
      ycv[w] = __fsub_rn(yv[w], dtw::kShift);
      yyv[w] = __fmul_rn(ycv[w], ycv[w]);
      // row -1 is the empty state row
      vD[w] = dtw::kInf;
#pragma unroll
      for (int c = 0; c < NCH; ++c) vM[w][c] = 0.f;
    }
    // column s0 - 1, the diag's column (j = -1: 0, the sweep's yc_prev)
    const float ycl =
        s0 > 0 && ncol > 0
            ? __fsub_rn(y[(long long)(s0 - 1) * col_stride], dtw::kShift)
            : 0.f;
    const float yyl = __fmul_rn(ycl, ycl);
    // this lane's right edge of the last step, sent to lane + 1
    float sD = dtw::kInf, sB[NE];
    // the left boundary received the step before (row i - 1), with row
    // i - 1's sample
    float pD = dtw::kInf, pB[NE], pxm = 0.f, pv = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) sB[c] = pB[c] = 0.f;
    const bool write_edge = p + 1 < npanel && lane == kLanes - 1;
    const int nsteps = xl + nact - 1;
    // row i's sample, loaded a step ahead
    auto load_x = [&](int i) { return i >= 0 && i < xl ? x[i] : 0.f; };
    auto load_v = [&](int i) {
      return NCH > 3 && i >= 0 && i < xl ? v[i] : 0.f;
    };
    float xv_next = load_x(-lane), vv_next = load_v(-lane);
    for (int t = 0; t < nsteps; ++t) {
      const int i = t - lane;
      const float xv = xv_next, vv = vv_next;
      xv_next = load_x(i + 1);
      vv_next = load_v(i + 1);
      float hD = __shfl_up_sync(kFull, sD, 1), hB[NE];
#pragma unroll
      for (int c = 0; c < NCH; ++c) hB[c] = __shfl_up_sync(kFull, sB[c], 1);
      if (lane == 0) {
        // column -1 of the first panel: D = 3e38, base 0; a later panel
        // reads the previous one's right edge
        const bool from_edge = p > 0 && i < xl;
        hD = from_edge ? edge[(long long)i * ES] : dtw::kInf;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          hB[c] = from_edge ? edge[(long long)i * ES + 1 + c] : 0.f;
      }
      if (i >= 0 && i < xl && ncol > 0) {
        const float xm = __fsub_rn(xv, dtw::kShift);
        // all terms are non-negative: C's '/' is the floor division
        const int center = BAND ? (i * (lk - 1)) / qden : 0;
        // diag of the strip's first column: column s0 - 1, row i - 1 (for
        // row 0 the empty state row, with the virtual corner D[-1, -1] = 0)
        float dD, dM[NE];
        if (i == 0) {
          dD = s0 == 0 ? 0.f : dtw::kInf;
#pragma unroll
          for (int c = 0; c < NCH; ++c) dM[c] = 0.f;
        } else {
          dD = pD;
          dtw::moments<NCH>(pB, ycl, yyl, pxm, pv, dM);
        }
        pD = hD;
#pragma unroll
        for (int c = 0; c < NCH; ++c) pB[c] = hB[c];
        pxm = xm;
        pv = vv;
#pragma unroll
        for (int w = 0; w < WE; ++w) {
          const float oD = vD[w];
          float oM[NE];
#pragma unroll
          for (int c = 0; c < NCH; ++c) oM[c] = vM[w][c];
          hD = dtw::dp_cell<NCH, BAND>(xv, xm, vv, center, yv[w], ycv[w],
                                       yyv[w], s0 + w, band, dD, dM, oD, oM,
                                       hD, hB, vM[w]);
          vD[w] = hD;
          dD = oD;
#pragma unroll
          for (int c = 0; c < NCH; ++c) dM[c] = oM[c];
        }
        sD = hD;
#pragma unroll
        for (int c = 0; c < NCH; ++c) sB[c] = hB[c];
        if (write_edge) {
          edge[(long long)i * ES] = hD;
#pragma unroll
          for (int c = 0; c < NCH; ++c) edge[(long long)i * ES + 1 + c] = hB[c];
        }
      }
    }
    __syncwarp();  // the panel's edge is written before the next reads it
  }
  // the endpoint's lane: the last panel's strip that holds column lk - 1;
  // its registers hold row xl - 1
  if (npanel == 0 || xl == 0 || lane != (lk - 1 - (npanel - 1) * pw) / WE)
    return;
#pragma unroll
  for (int w = 0; w < WE; ++w)
    if (s0 + w == lk - 1) {
      cap[0] = vD[w];
#pragma unroll
      for (int c = 0; c < NCH; ++c) cap[1 + c] = vM[w][c];
    }
}

// wavefront<NCH, BAND, w_eff> for the runtime strip width w_eff in [WE, W].
template <int NCH, bool BAND, int WE = 1>
__device__ __forceinline__ void wavefront_of(int w_eff, const float* x,
                                             const float* v, int xl,
                                             const float* y,
                                             long long col_stride, int lk,
                                             float* edge, int band, int lane,
                                             float cap[1 + NCH]) {
  if (w_eff == WE)
    wavefront<NCH, BAND, WE>(x, v, xl, y, col_stride, lk, edge, band, lane,
                             cap);
  else if constexpr (WE < Strip<NCH>::value)
    wavefront_of<NCH, BAND, WE + 1>(w_eff, x, v, xl, y, col_stride, lk, edge,
                                    band, lane, cap);
}

// Closed-end score of one (query, reference) pair, by the warp of lane
// `lane`: the wavefront over the query x [xl] against reference columns
// y[j * col_stride], j < lk (edge: the pair's panel-edge buffer, read and
// written only when lk > 32 W), then the score tail (and the probability
// tail for NCH > 3) in the lane that owns the endpoint (xl - 1, lk - 1);
// every output is written by one lane. One definition for the bank and
// the pairs kernels, so their scores and distances are bitwise the same
// for the same pair.
template <int NCH, bool BAND>
__device__ __forceinline__ void score_warp(
    const float* x, const float* v, int xl, const float* y,
    long long col_stride, int lk, float sxq, float sxxq, const float* vs,
    float* edge, int band, float threshold, float* score, float* prob,
    float* dist, int lane) {
  constexpr int W = Strip<NCH>::value;
  const int w_eff = min(W, max((lk + kLanes - 1) / kLanes, 1));
  // the defaults when nothing is swept (xl == 0 or lk == 0)
  float cap[1 + NCH];
  cap[0] = dtw::kInf;
#pragma unroll
  for (int c = 0; c < NCH; ++c) cap[1 + c] = 0.f;
  wavefront_of<NCH, BAND>(w_eff, x, v, xl, y, col_stride, lk, edge, band,
                          lane, cap);
  const int pw = kLanes * w_eff;
  const int npanel = (lk + pw - 1) / pw;
  const int owner =
      npanel > 0 && xl > 0 ? (lk - 1 - (npanel - 1) * pw) / w_eff : 0;
  if (lane != owner) return;
  const float n = (float)(xl > 1 ? xl : 1);
  const float s = dtw::corr_from_moments(cap[1], cap[2], cap[3], sxq, sxxq,
                                         n);
  *score = xl > 0 ? s : 0.f;
  *dist = cap[0];
  if constexpr (NCH > 3) {
    float pr;
    if constexpr (NCH == 6)
      pr = dtw::prob_from_moments(cap[1], cap[2], cap[3], cap[4], cap[5],
                                  cap[6], sxq, sxxq, vs[0], vs[1], vs[2], n,
                                  threshold);
    else
      pr = dtw::prob_from_moments_approx(cap[1], cap[2], cap[3], cap[4],
                                         sxq, sxxq, vs[0], vs[1], vs[2], n,
                                         threshold);
    *prob = xl > 0 ? pr : 0.f;
  }
}

// Blocks of 4 warps an SM must hold, by moment channel count: the register
// cap (168 a thread for 3 channels, 255 for 4 and 6) that keeps the most
// warps resident without a spill. The strip's cells form a dependent
// chain, so resident warps, not issue slots, set the pace (measured on the
// H100: 3 blocks beat 4 with spills and 2 without for K2).
template <int NCH>
struct MinBlocks {
  static constexpr int value = NCH == 3 ? 3 : 2;
};

// Warp w of block (bx, q) scores query q against reference bx * kWarps + w;
// BAND: band >= 0.
template <int NCH, bool BAND>
__global__ void __launch_bounds__(kLanes* kWarps, MinBlocks<NCH>::value)
    score_kernel(const float* __restrict__ xs, const float* __restrict__ xvars,
                 const int* __restrict__ xlens,
                 const float* __restrict__ bank_t,
                 const int* __restrict__ lengths,
                 const float* __restrict__ sx, const float* __restrict__ sxx,
                 const float* __restrict__ vstats, float* edges,
                 float* __restrict__ scores, float* __restrict__ probs,
                 float* __restrict__ dists, int N, int K, int band,
                 float threshold) {
  const int lane = threadIdx.x % kLanes;
  const int k = blockIdx.x * kWarps + threadIdx.x / kLanes;
  const int q = blockIdx.y;
  if (k >= K) return;  // the whole warp
  const long long o = (long long)q * K + k;
  score_warp<NCH, BAND>(xs + (long long)q * N,
                  NCH > 3 ? xvars + (long long)q * N : nullptr, xlens[q],
                  bank_t + k, K, lengths[k], sx[q], sxx[q],
                  NCH > 3 ? vstats + 3LL * q : nullptr,
                  edges + o * N * (1 + NCH), band, threshold, scores + o,
                  NCH > 3 ? probs + o : nullptr, dists + o, lane);
}

// K2 pairs: warp p scores query p against reference p (column p of the
// K-last [M, P] reference block), the wavefront and tail of K2.
template <bool BAND>
__global__ void __launch_bounds__(kLanes* kWarps)
    score_pairs_kernel(const float* __restrict__ xs,
                       const int* __restrict__ xlens,
                       const float* __restrict__ ys_t,
                       const int* __restrict__ ylens,
                       const float* __restrict__ sx,
                       const float* __restrict__ sxx, float* edges,
                       float* __restrict__ scores, float* __restrict__ dists,
                       int P, int N, int band) {
  const int lane = threadIdx.x % kLanes;
  const int p = blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (p >= P) return;  // the whole warp
  score_warp<3, BAND>(xs + (long long)p * N, nullptr, xlens[p], ys_t + p, P,
                ylens[p], sx[p], sxx[p], nullptr,
                edges + (long long)p * N * 4, band, 0.f, scores + p, nullptr,
                dists + p, lane);
}

template <int NCH>
int launch(const float* xs, const float* xvars, const int* xlens,
           const float* bank_t, const int* lengths, const float* sx,
           const float* sxx, const float* vstats, float* edges,
           float* scores, float* probs, float* dists, int J, int N, int K,
           int band, float threshold, void* stream) {
  if (J == 0 || K == 0) return 0;
  const dim3 grid((K + kWarps - 1) / kWarps, J);
  auto kernel = band >= 0 ? score_kernel<NCH, true> : score_kernel<NCH, false>;
  kernel<<<grid, kLanes * kWarps, 0, (cudaStream_t)stream>>>(
      xs, xvars, xlens, bank_t, lengths, sx, sxx, vstats, edges, scores,
      probs, dists, N, K, band, threshold);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest strip of the wavefront for nch moment channels: references
// longer than 32 times it need the panel-edge buffer.
extern "C" int dtw_score_strip(int nch) {
  switch (nch) {
    case 3: return Strip<3>::value;
    case 4: return Strip<4>::value;
    case 6: return Strip<6>::value;
  }
  return 0;
}

// K2. Returns cudaGetLastError() after the launch (0 on success). edges is
// the [J, K, N, 4] f32 panel-edge buffer, read and written only for a
// reference longer than 32 * dtw_score_strip(3) columns.
extern "C" int dtw_score_offline(const float* xs, const int* xlens,
                                 const float* bank_t, const int* lengths,
                                 const float* sx, const float* sxx,
                                 float* edges, float* scores, float* dists,
                                 int J, int N, int K, int band,
                                 void* stream) {
  return launch<3>(xs, nullptr, xlens, bank_t, lengths, sx, sxx, nullptr,
                   edges, scores, nullptr, dists, J, N, K, band, 0.f,
                   stream);
}

// K5 (approx == 0: 6 channels, the exact tail) and K6 (approx != 0: 4
// channels, the approximate tail). edges is [J, K, N, 1 + NCH], used as
// K2's. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dtw_score_offline_var(const float* xs, const float* xvars,
                                     const int* xlens, const float* bank_t,
                                     const int* lengths, const float* sx,
                                     const float* sxx, const float* vstats,
                                     float* edges, float* scores,
                                     float* probs, float* dists, int J,
                                     int N, int K, int band, float threshold,
                                     int approx, void* stream) {
  if (approx)
    return launch<4>(xs, xvars, xlens, bank_t, lengths, sx, sxx, vstats,
                     edges, scores, probs, dists, J, N, K, band, threshold,
                     stream);
  return launch<6>(xs, xvars, xlens, bank_t, lengths, sx, sxx, vstats,
                   edges, scores, probs, dists, J, N, K, band, threshold,
                   stream);
}

// K2 pairs. ys_t is the [M, P] K-last block of the P references; edges is
// the [P, N, 4] panel-edge buffer, used as K2's. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dtw_score_pairs(const float* xs, const int* xlens,
                               const float* ys_t, const int* ylens,
                               const float* sx, const float* sxx,
                               float* edges, float* scores, float* dists,
                               int P, int N, int band, void* stream) {
  if (P == 0) return 0;
  auto kernel = band >= 0 ? score_pairs_kernel<true>
                          : score_pairs_kernel<false>;
  kernel<<<(P + kWarps - 1) / kWarps, kLanes * kWarps, 0,
           (cudaStream_t)stream>>>(xs, xlens, ys_t, ylens, sx, sxx, edges,
                                   scores, dists, P, N, band);
  return (int)cudaGetLastError();
}
