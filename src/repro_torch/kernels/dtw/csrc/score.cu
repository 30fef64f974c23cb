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
// K2 pairs is K2's entry for P (query, reference) pairs: thread p scores
// query p against reference p (repro/core/dtw.py::dtw_score_pairs, the
// engine of match_application, which the reference runs as jnp). It is
// K2's sweep and tail on a K-last [M, P] reference block, so its scores
// and distances are bitwise K2's for the same pair.
//
// Design: one thread per (query q, reference k) runs the streaming tick's
// column sweep (dtw_sweep.cuh) over the query in passes of
// RowsPerPass<NCH> samples, starting from the empty row, with ns = 0 (so
// the virtual corner applies) and band centres from the query's own
// length. A pass reads and writes the row it resumes from in a scratch
// [J, M, K] x (1 + NCH) tensor that the wrapper allocates; the first pass
// reads nothing and the last writes nothing, capturing column len_k - 1
// instead, so a query of at most one pass never touches the scratch.
// Columns at or past len_k are never swept: they cannot feed the
// endpoint.
//
// This reuses the one sweep the tick has, rather than a second design
// with the row in shared memory, so the kernels cannot drift apart.
// Bound on this card: operations (17, 21 or 29 f32 a cell for 3, 4 or 6
// channels, J * N * len_k cells; the inputs are a few hundred kilobytes).
// This first version is far from that bound (PERF.md): J * K threads
// (8192 for a 32-job verdict) leave most of the card's warp slots empty,
// so each pass's dependent scratch loads and the row chain's latency are
// exposed.
#include "dtw_sweep.cuh"
#include "prob_tail.cuh"

namespace {

// Closed-end score of one (query, reference) pair: the query x [xl]
// (variances v, read when NCH > 3) runs through the moment-carrying DP
// from a fresh row in passes of RowsPerPass<NCH> samples over reference
// columns y[j * col_stride], j < lk, resuming each pass from the scratch
// row at column stride col_stride and channel stride ch; the endpoint
// (xl - 1, lk - 1) goes through the score tail (and the probability tail
// for NCH > 3). One definition for the bank and the pairs kernels, so
// their scores and distances are bitwise the same for the same pair.
template <int NCH>
__device__ __forceinline__ void score_one(
    const float* x, const float* v, int xl, const float* y,
    long long col_stride, int lk, float sxq, float sxxq, const float* vs,
    float* scratch_d, float* scratch_m, long long ch, int band,
    float threshold, float* score, float* prob, float* dist) {
  constexpr int R = dtw::RowsPerPass<NCH>::value;
  float cap[1 + NCH];
  cap[0] = dtw::kInf;
#pragma unroll
  for (int c = 0; c < NCH; ++c) cap[1 + c] = 0.f;
  const int npass = (xl + R - 1) / R;
  for (int p = 0; p < npass; ++p) {
    const int left = xl - p * R;
    const int nr = left < R ? left : R;
    const bool last = p == npass - 1;
    dtw::sweep_pass<NCH, R>(
        x + p * R, NCH > 3 ? v + p * R : nullptr, nr, p * R, xl, band, lk,
        y, col_stride, lk, scratch_d, scratch_m, scratch_d, scratch_m, ch,
        p == 0, !last, last ? lk - 1 : -1, cap);
  }
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

template <int NCH>
__global__ void score_kernel(const float* __restrict__ xs,
                             const float* __restrict__ xvars,
                             const int* __restrict__ xlens,
                             const float* __restrict__ bank_t,
                             const int* __restrict__ lengths,
                             const float* __restrict__ sx,
                             const float* __restrict__ sxx,
                             const float* __restrict__ vstats,
                             float* scratch_d, float* scratch_m,
                             float* __restrict__ scores,
                             float* __restrict__ probs,
                             float* __restrict__ dists, int J, int N, int M,
                             int K, int band, float threshold) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y;
  if (k >= K) return;
  const long long mk = (long long)M * K;
  const long long base = (long long)q * mk + k;
  const long long o = (long long)q * K + k;
  score_one<NCH>(xs + (long long)q * N,
                 NCH > 3 ? xvars + (long long)q * N : nullptr, xlens[q],
                 bank_t + k, K, lengths[k], sx[q], sxx[q],
                 NCH > 3 ? vstats + 3LL * q : nullptr, scratch_d + base,
                 scratch_m + base, (long long)J * mk, band, threshold,
                 scores + o, NCH > 3 ? probs + o : nullptr, dists + o);
}

// K2 pairs: thread p scores query p against reference p (column p of the
// K-last [M, P] reference block), the sweep and tail of K2.
__global__ void score_pairs_kernel(const float* __restrict__ xs,
                                   const int* __restrict__ xlens,
                                   const float* __restrict__ ys_t,
                                   const int* __restrict__ ylens,
                                   const float* __restrict__ sx,
                                   const float* __restrict__ sxx,
                                   float* scratch_d, float* scratch_m,
                                   float* __restrict__ scores,
                                   float* __restrict__ dists, int P, int N,
                                   int M, int band) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  score_one<3>(xs + (long long)p * N, nullptr, xlens[p], ys_t + p, P,
               ylens[p], sx[p], sxx[p], nullptr, scratch_d + p,
               scratch_m + p, (long long)M * P, band, 0.f, scores + p,
               nullptr, dists + p);
}

template <int NCH>
int launch(const float* xs, const float* xvars, const int* xlens,
           const float* bank_t, const int* lengths, const float* sx,
           const float* sxx, const float* vstats, float* scratch_d,
           float* scratch_m, float* scores, float* probs, float* dists,
           int J, int N, int M, int K, int band, float threshold,
           void* stream) {
  if (J == 0 || K == 0) return 0;
  const dim3 block(64);
  const dim3 grid((K + block.x - 1) / block.x, J);
  score_kernel<NCH><<<grid, block, 0, (cudaStream_t)stream>>>(
      xs, xvars, xlens, bank_t, lengths, sx, sxx, vstats, scratch_d,
      scratch_m, scores, probs, dists, J, N, M, K, band, threshold);
  return (int)cudaGetLastError();
}

}  // namespace

// K2. Returns cudaGetLastError() after the launch (0 on success). The
// scratch tensors are [J, M, K] and [3, J, M, K] f32; they are read only
// when some query is longer than one pass.
extern "C" int dtw_score_offline(const float* xs, const int* xlens,
                                 const float* bank_t, const int* lengths,
                                 const float* sx, const float* sxx,
                                 float* scratch_d, float* scratch_m,
                                 float* scores, float* dists, int J, int N,
                                 int M, int K, int band, void* stream) {
  return launch<3>(xs, nullptr, xlens, bank_t, lengths, sx, sxx, nullptr,
                   scratch_d, scratch_m, scores, nullptr, dists, J, N, M, K,
                   band, 0.f, stream);
}

// K5 (approx == 0: 6 channels, the exact tail) and K6 (approx != 0: 4
// channels, the approximate tail). scratch_m is [NCH, J, M, K]. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dtw_score_offline_var(const float* xs, const float* xvars,
                                     const int* xlens, const float* bank_t,
                                     const int* lengths, const float* sx,
                                     const float* sxx, const float* vstats,
                                     float* scratch_d, float* scratch_m,
                                     float* scores, float* probs,
                                     float* dists, int J, int N, int M,
                                     int K, int band, float threshold,
                                     int approx, void* stream) {
  if (approx)
    return launch<4>(xs, xvars, xlens, bank_t, lengths, sx, sxx, vstats,
                     scratch_d, scratch_m, scores, probs, dists, J, N, M, K,
                     band, threshold, stream);
  return launch<6>(xs, xvars, xlens, bank_t, lengths, sx, sxx, vstats,
                   scratch_d, scratch_m, scores, probs, dists, J, N, M, K,
                   band, threshold, stream);
}

// K2 pairs. ys_t is the [M, P] K-last block of the P references; the
// scratch tensors are [M, P] and [3, M, P] f32, read only when some query
// is longer than one pass. Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int dtw_score_pairs(const float* xs, const int* xlens,
                               const float* ys_t, const int* ylens,
                               const float* sx, const float* sxx,
                               float* scratch_d, float* scratch_m,
                               float* scores, float* dists, int P, int N,
                               int M, int band, void* stream) {
  if (P == 0) return 0;
  const dim3 block(64);
  const dim3 grid((P + block.x - 1) / block.x);
  score_pairs_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      xs, xlens, ys_t, ylens, sx, sxx, scratch_d, scratch_m, scores, dists,
      P, N, M, band);
  return (int)cudaGetLastError();
}
