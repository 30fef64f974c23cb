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
  constexpr int R = dtw::RowsPerPass<NCH>::value;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y;
  if (k >= K) return;
  const int xl = xlens[q];
  const int lk = lengths[k];
  const long long mk = (long long)M * K;
  const long long base = (long long)q * mk + k;
  const long long ch = (long long)J * mk;
  const float* x = xs + (long long)q * N;
  const float* v = NCH > 3 ? xvars + (long long)q * N : nullptr;
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
        bank_t + k, K, lk, scratch_d + base, scratch_m + base,
        scratch_d + base, scratch_m + base, ch, p == 0, !last,
        last ? lk - 1 : -1, cap);
  }
  const float n = (float)(xl > 1 ? xl : 1);
  const long long o = (long long)q * K + k;
  const float s = dtw::corr_from_moments(cap[1], cap[2], cap[3], sx[q],
                                         sxx[q], n);
  scores[o] = xl > 0 ? s : 0.f;
  dists[o] = cap[0];
  if constexpr (NCH > 3) {
    const float* vs = vstats + 3LL * q;
    float p;
    if constexpr (NCH == 6)
      p = dtw::prob_from_moments(cap[1], cap[2], cap[3], cap[4], cap[5],
                                 cap[6], sx[q], sxx[q], vs[0], vs[1],
                                 vs[2], n, threshold);
    else
      p = dtw::prob_from_moments_approx(cap[1], cap[2], cap[3], cap[4],
                                        sx[q], sxx[q], vs[0], vs[1], vs[2],
                                        n, threshold);
    probs[o] = xl > 0 ? p : 0.f;
  }
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
