// K1 and K4: the scored streaming ticks (one service tick, all in-flight
// jobs).
//
// K1 replaces repro/kernels/dtw/stream.py::_stream_scored_kernel (the
// Pallas TPU kernel reached through stream_bank_extend_scored_kernel). It
// advances S streaming DP rows and their (sy, syy, sxy) warp-path moment
// slabs by one chunk of C samples against the whole [M, K] reference bank.
// K4 replaces the same Pallas kernel with variance=True: the slab carries
// 6 channels (exact: sy, syy, sxy, svy, svyy, svxy) or 4 (approx: sy,
// syy, sxy, svy), and a per-sample variance chunk rides beside the
// samples. One template serves all three channel counts (dtw_sweep.cuh),
// so the variance ticks run K1's arithmetic on channels 0..2 unchanged.
//
// Layout is the service's K-last tick state: rows [S, M, K], moms
// [NCH, S, M, K], bank_t [M, K]. One thread per (slot s, reference k)
// sweeps the M columns, so consecutive threads touch consecutive
// addresses and every load and store is coalesced.
//
// Bound on this card: memory. The kernel reads and writes the 1 + NCH
// [S, M, K] f32 channels once a pass (2 x 4 (1 + NCH) bytes a state cell)
// and does 5 + 4 NCH f32 operations (17, 21, 29) per state cell per
// sample; at C = 16 that is under the H100's f32 balance of ~20
// (67 TFLOP/s over 3.35 TB/s), so the state traffic sets the bound. The
// design touches each state element twice (one load, one store) per pass
// of up to RowsPerPass<NCH> samples, the pass's rows held in registers:
// the 3- and 4-channel ticks take a 16-sample chunk in one pass, the
// 6-channel tick in two (8 rows a pass keeps its registers from
// spilling), which doubles its state traffic.
#include "dtw_sweep.cuh"

namespace {

template <int NCH>
__global__ void stream_scored_kernel(
    const float* rows, const float* moms, float* out_rows, float* out_moms,
    const int* __restrict__ ns, const int* __restrict__ nvalid,
    const int* __restrict__ qlens, const float* __restrict__ bank_t,
    const int* __restrict__ lengths, const float* __restrict__ chunks,
    const float* __restrict__ vchunks, int S, int M, int K, int C,
    int band) {
  constexpr int R = dtw::RowsPerPass<NCH>::value;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (k >= K) return;
  const long long mk = (long long)M * K;
  const long long base = (long long)s * mk + k;
  const long long ch = (long long)S * mk;
  const int nv = nvalid[s];
  const int n0 = ns[s];
  const int ql = qlens[s];
  const int lk = lengths[k];
  const float* x = chunks + (long long)s * C;
  const float* v = NCH > 3 ? vchunks + (long long)s * C : nullptr;
  float cap[1 + NCH];
  // nv == 0 still takes one pass: it copies the state row through.
  const int npass = nv > 0 ? (nv + R - 1) / R : 1;
  for (int p = 0; p < npass; ++p) {
    const int left = nv - p * R;
    const int nr = left < R ? left : R;
    const bool first = p == 0;
    dtw::sweep_pass<NCH, R>(
        x + p * R, NCH > 3 ? v + p * R : nullptr, nr, n0 + p * R, ql, band,
        lk, bank_t + k, K, M, first ? rows + base : out_rows + base,
        first ? moms + base : out_moms + base, out_rows + base,
        out_moms + base, ch, false, true, -1, cap);
  }
}

template <int NCH>
int launch(const float* rows, const float* moms, float* out_rows,
           float* out_moms, const int* ns, const int* nvalid,
           const int* qlens, const float* bank_t, const int* lengths,
           const float* chunks, const float* vchunks, int S, int M, int K,
           int C, int band, void* stream) {
  if (S == 0 || K == 0 || M == 0) return 0;
  const dim3 block(128);
  const dim3 grid((K + block.x - 1) / block.x, S);
  stream_scored_kernel<NCH><<<grid, block, 0, (cudaStream_t)stream>>>(
      rows, moms, out_rows, out_moms, ns, nvalid, qlens, bank_t, lengths,
      chunks, vchunks, S, M, K, C, band);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dtw_stream_scored(const float* rows, const float* moms,
                                 float* out_rows, float* out_moms,
                                 const int* ns, const int* nvalid,
                                 const int* qlens, const float* bank_t,
                                 const int* lengths, const float* chunks,
                                 int S, int M, int K, int C, int band,
                                 void* stream) {
  return launch<3>(rows, moms, out_rows, out_moms, ns, nvalid, qlens, bank_t,
                   lengths, chunks, nullptr, S, M, K, C, band, stream);
}

// K4: moms has nch = 6 (exact) or 4 (approx) channels and vchunks is
// [S, C]. Returns cudaGetLastError() after the launch, or -1 for another
// channel count (nothing launched).
extern "C" int dtw_stream_scored_var(const float* rows, const float* moms,
                                     float* out_rows, float* out_moms,
                                     const int* ns, const int* nvalid,
                                     const int* qlens, const float* bank_t,
                                     const int* lengths, const float* chunks,
                                     const float* vchunks, int S, int M,
                                     int K, int C, int band, int nch,
                                     void* stream) {
  if (nch == 6)
    return launch<6>(rows, moms, out_rows, out_moms, ns, nvalid, qlens,
                     bank_t, lengths, chunks, vchunks, S, M, K, C, band,
                     stream);
  if (nch == 4)
    return launch<4>(rows, moms, out_rows, out_moms, ns, nvalid, qlens,
                     bank_t, lengths, chunks, vchunks, S, M, K, C, band,
                     stream);
  return -1;
}
