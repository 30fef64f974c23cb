// K2: the offline verdict scorer (closed-end warp correlation).
//
// Replaces repro/kernels/dtw/score.py::_score_kernel (the Pallas TPU
// kernel reached through score_bank_offline_kernel). For J complete
// queries against the [M, K] reference bank it runs each query through
// the moment-carrying DP from a fresh row and reduces at the closed-end
// column len_k - 1 to a score (the correlation of _corr_from_moments) and
// the endpoint distance. Only the [J, K] results reach memory.
//
// Design: one thread per (query q, reference k) runs the streaming tick's
// column sweep (dtw_sweep.cuh) over the query in passes of kRows samples,
// starting from the empty row, with ns = 0 (so the virtual corner
// applies) and band centres from the query's own length. A pass reads and
// writes the row it resumes from in a scratch [J, M, K] x 4 tensor that
// the wrapper allocates; the first pass reads nothing and the last writes
// nothing, capturing column len_k - 1 instead, so a query of at most kRows
// samples never touches the scratch. Columns at or past len_k are never
// swept: they cannot feed the endpoint.
//
// This reuses the one sweep the tick has, rather than a second design
// with the row in shared memory, so the two kernels cannot drift apart.
// Bound on this card: operations (17 f32 a cell, J * N * len_k cells;
// the inputs are a few hundred kilobytes). This first version is far
// from that bound (PERF.md): J * K threads (8192 for a 32-job verdict)
// leave most of the card's warp slots empty, so each pass's dependent
// scratch loads and the row chain's latency are exposed.
#include "dtw_sweep.cuh"

namespace {

// repro.core.dtw._corr_from_moments, with its degenerate-variance
// conventions, in the same order of operations as the PyTorch version.
__device__ __forceinline__ float corr_from_moments(float sy, float syy,
                                                   float sxy, float sx,
                                                   float sxx, float n) {
  const float sx2n = __fdiv_rn(__fmul_rn(sx, sx), n);
  const float sy2n = __fdiv_rn(__fmul_rn(sy, sy), n);
  const float vx = fmaxf(__fsub_rn(sxx, sx2n), 0.f);
  const float vy = fmaxf(__fsub_rn(syy, sy2n), 0.f);
  const float cov = __fsub_rn(sxy, __fdiv_rn(__fmul_rn(sx, sy), n));
  const float denom = __fsqrt_rn(__fmul_rn(vx, vy));
  const float corr = fminf(
      fmaxf(__fdiv_rn(cov, denom > 0.f ? denom : 1.f), -1.f), 1.f);
  const bool degx =
      vx <= __fadd_rn(__fmul_rn(1e-5f, __fadd_rn(sxx, sx2n)), 1e-12f);
  const bool degy =
      vy <= __fadd_rn(__fmul_rn(1e-5f, __fadd_rn(syy, sy2n)), 1e-12f);
  const bool both =
      degx && degy && __fdiv_rn(fabsf(__fsub_rn(sx, sy)), n) < 1e-6f;
  return (degx || degy) ? (both ? 1.f : 0.f) : corr;
}

__global__ void score_kernel(const float* __restrict__ xs,
                             const int* __restrict__ xlens,
                             const float* __restrict__ bank_t,
                             const int* __restrict__ lengths,
                             const float* __restrict__ sx,
                             const float* __restrict__ sxx,
                             float* scratch_d, float* scratch_m,
                             float* __restrict__ scores,
                             float* __restrict__ dists, int J, int N, int M,
                             int K, int band) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y;
  if (k >= K) return;
  const int xl = xlens[q];
  const int lk = lengths[k];
  const long long mk = (long long)M * K;
  const long long base = (long long)q * mk + k;
  const long long ch = (long long)J * mk;
  const float* x = xs + (long long)q * N;
  float cap[4] = {dtw::kInf, 0.f, 0.f, 0.f};
  const int npass = (xl + dtw::kRows - 1) / dtw::kRows;
  for (int p = 0; p < npass; ++p) {
    const int left = xl - p * dtw::kRows;
    const int nr = left < dtw::kRows ? left : dtw::kRows;
    const bool last = p == npass - 1;
    dtw::sweep_pass(x + p * dtw::kRows, nr, p * dtw::kRows, xl, band, lk,
                    bank_t + k, K, lk, scratch_d + base, scratch_m + base,
                    scratch_d + base, scratch_m + base, ch, p == 0, !last,
                    last ? lk - 1 : -1, cap);
  }
  const float n = (float)(xl > 1 ? xl : 1);
  const float s = corr_from_moments(cap[1], cap[2], cap[3], sx[q], sxx[q], n);
  scores[(long long)q * K + k] = xl > 0 ? s : 0.f;
  dists[(long long)q * K + k] = cap[0];
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The
// scratch tensors are [J, M, K] and [3, J, M, K] f32; they are read only
// when some query is longer than kRows.
extern "C" int dtw_score_offline(const float* xs, const int* xlens,
                                 const float* bank_t, const int* lengths,
                                 const float* sx, const float* sxx,
                                 float* scratch_d, float* scratch_m,
                                 float* scores, float* dists, int J, int N,
                                 int M, int K, int band, void* stream) {
  if (J == 0 || K == 0) return 0;
  const dim3 block(64);
  const dim3 grid((K + block.x - 1) / block.x, J);
  score_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      xs, xlens, bank_t, lengths, sx, sxx, scratch_d, scratch_m, scores,
      dists, J, N, M, K, band);
  return (int)cudaGetLastError();
}
