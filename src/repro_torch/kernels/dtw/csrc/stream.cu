// K1, K3 and K4: the streaming ticks (one service tick, all in-flight
// jobs).
//
// K3 replaces repro/kernels/dtw/stream.py::_stream_kernel (the Pallas TPU
// kernel reached through stream_bank_extend_kernel): the distance-only
// tick. It advances S streaming DP rows by one chunk of C samples and
// carries no moments; it is the NCH = 0 instantiation of the same column
// sweep, so its rows are bitwise K1's and K4's on the same inputs (the
// reference's invariant that every tick flavour updates the DP rows
// identically, on which the overload ladder's "delayed, never different"
// rests). Where the TPU kernel solves each row with a min-plus
// Hillis-Steele scan, the sweep walks the columns in order: the two agree
// bitwise wherever every sum is exact (dyadic data), and to rounding
// elsewhere.
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
// Bound on this card: memory. K3 at the main path's full width (S = 256,
// K = 256, M = 360, C = 16) reads and writes the [S, M, K] f32 row once:
// 2 x 94.4 MB = 189 MB, 0.056 ms at 3.35 TB/s, against 5 f32 operations
// a cell a sample (sub, abs, 2 min, add; the clamp's min not counted),
// 1.9 GFLOP, 0.028 ms at 67 TFLOP/s. Its design does what K1's does: one
// load and one store of each state element per pass, the pass's 16 rows
// in registers, so a 16-sample chunk is one pass. A 16-row column chain
// per thread is latency-bound rather than byte-bound; the kernel stays
// simple in this slice.
//
// K1 and K4 are bound by memory too. They read and write the 1 + NCH
// [S, M, K] f32 channels once a pass (2 x 4 (1 + NCH) bytes a state cell)
// and do 5 + 4 NCH f32 operations (17, 21, 29) per state cell per
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
  float* m_out = NCH > 0 ? out_moms + base : nullptr;
  float cap[1 + NCH];
  // nv == 0 still takes one pass: it copies the state row through.
  const int npass = nv > 0 ? (nv + R - 1) / R : 1;
  for (int p = 0; p < npass; ++p) {
    const int left = nv - p * R;
    const int nr = left < R ? left : R;
    const bool first = p == 0;
    const float* m_in = NCH > 0 ? (first ? moms : out_moms) + base : nullptr;
    dtw::sweep_pass<NCH, R>(
        x + p * R, NCH > 3 ? v + p * R : nullptr, nr, n0 + p * R, ql, band,
        lk, bank_t + k, K, M, first ? rows + base : out_rows + base, m_in,
        out_rows + base, m_out, ch, false, true, -1, cap);
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

// K3: rows only (no moments). Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int dtw_stream_distance(const float* rows, float* out_rows,
                                   const int* ns, const int* nvalid,
                                   const int* qlens, const float* bank_t,
                                   const int* lengths, const float* chunks,
                                   int S, int M, int K, int C, int band,
                                   void* stream) {
  return launch<0>(rows, nullptr, out_rows, nullptr, ns, nvalid, qlens,
                   bank_t, lengths, chunks, nullptr, S, M, K, C, band,
                   stream);
}

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
