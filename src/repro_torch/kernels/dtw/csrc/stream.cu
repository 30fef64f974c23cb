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
// [NCH, S, M, K], bank_t [M, K].
//
// Bound on this card: memory, and close behind it the issue of the cell
// instructions. At the main path's full width (S = 256, K = 256, M =
// 360, C = 16) a tick reads and writes the 1 + NCH [S, M, K] f32
// channels once: 2 x 94.4 MB x (1 + NCH), 0.056 ms at 3.35 TB/s for K3,
// 0.226 ms for K1, 0.282 and 0.394 ms for K4's 4 and 6 channels. The
// 377 M cells take 5 + 4 NCH f32 operations each (5, 17, 21, 29), and
// with -fmad=false each is one instruction a lane, at half the FMA-
// counted 67 TFLOP/s: 0.056, 0.19, 0.24 and 0.33 ms.
//
// Design (dtw_sweep.cuh): a group of G = Split<NCH> lanes per (slot s,
// reference k), 16 / G rows a lane, skewed one column a lane, so a
// 16-sample chunk is one pass of the state row for every channel count.
// The row is staged through shared memory: each warp's lanes copy their
// share of a column (state, moments and y of the warp's groups) into a
// ring of kRing column slots with cp.async, kRing - 1 columns ahead of
// the compute, and copy their share of the last lanes' column back out,
// so a lane issues a few memory instructions a column, not 2 + 2 NCH.
// Per slot (one block row), a full pass of 16 rows takes the
// instantiation without row guards, and a band of None the one without
// the band test. A chunk longer than 16 samples takes one pass per 16,
// each reading the row the previous one wrote: passes alternate between
// the output and a scratch row set (tmp_rows, tmp_moms; null when C <=
// 16), so that no pass reads what it writes, and the last pass writes
// the output.
#include "dtw_sweep.cuh"

namespace {

constexpr int kBlock = 128;  // threads a block (stream.py's BLOCK)

template <int NCH, int G, bool BAND>
__global__ void __launch_bounds__(kBlock) stream_scored_kernel(
    const float* __restrict__ rows, const float* __restrict__ moms,
    float* out_rows, float* out_moms, float* tmp_rows, float* tmp_moms,
    const int* __restrict__ ns, const int* __restrict__ nvalid,
    const int* __restrict__ qlens, const float* __restrict__ bank_t,
    const int* __restrict__ lengths, const float* __restrict__ chunks,
    const float* __restrict__ vchunks, int S, int M, int K, int C,
    int band) {
  constexpr int P = dtw::kPassRows;
  __shared__ dtw::Stage<NCH, G> stage[kBlock / dtw::kWarp];
  const int warp = threadIdx.x / dtw::kWarp;
  const int lane = threadIdx.x % dtw::kWarp;
  // the warp's groups hold references k0, k0 + 1, ...; a group past the
  // bank's end sweeps its last reference and stores nothing
  const int k0 = (blockIdx.x * kBlock + warp * dtw::kWarp) / G;
  if (k0 >= K) return;
  const int k = min(k0 + lane / G, K - 1);
  const int s = blockIdx.y;
  const long long mk = (long long)M * K;
  const long long sb = (long long)s * mk;
  const long long ch = (long long)S * mk;
  const int nv = nvalid[s];
  const int n0 = ns[s];
  const int ql = qlens[s];
  const int lk = lengths[k];
  const float* x = chunks + (long long)s * C;
  const float* v = NCH > 3 ? vchunks + (long long)s * C : nullptr;
  // nv == 0 still takes one pass: it copies the state row through.
  const int npass = nv > 0 ? (nv + P - 1) / P : 1;
  for (int p = 0; p < npass; ++p) {
    const int nr = min(nv - p * P, P);
    const bool to_out = (npass - 1 - p) % 2 == 0;
    float* d_out = (to_out ? out_rows : tmp_rows) + sb;
    float* m_out = NCH > 0 ? (to_out ? out_moms : tmp_moms) + sb : nullptr;
    const float* d_in = (p == 0 ? rows : to_out ? tmp_rows : out_rows) + sb;
    const float* m_in =
        NCH > 0 ? (p == 0 ? moms : to_out ? tmp_moms : out_moms) + sb
                : nullptr;
    const float* xp = x + p * P;
    const float* vp = NCH > 3 ? v + p * P : nullptr;
    // (sweep_pass ends on a __syncwarp: the previous pass's stores are
    // visible to this pass's loads)
    if (nr == P)
      dtw::sweep_pass<NCH, G, BAND, true>(
          stage[warp], lane, xp, vp, nr, n0 + p * P, ql, band, lk, bank_t,
          k0, K, M, d_in, m_in, d_out, m_out, ch);
    else
      dtw::sweep_pass<NCH, G, BAND, false>(
          stage[warp], lane, xp, vp, nr, n0 + p * P, ql, band, lk, bank_t,
          k0, K, M, d_in, m_in, d_out, m_out, ch);
  }
}

template <int NCH, bool BAND>
void launch_band(const float* rows, const float* moms, float* out_rows,
                 float* out_moms, float* tmp_rows, float* tmp_moms,
                 const int* ns, const int* nvalid, const int* qlens,
                 const float* bank_t, const int* lengths, const float* chunks,
                 const float* vchunks, int S, int M, int K, int C, int band,
                 cudaStream_t stream) {
  constexpr int G = dtw::Split<NCH>::value;
  const dim3 grid((K * G + kBlock - 1) / kBlock, S);
  stream_scored_kernel<NCH, G, BAND><<<grid, kBlock, 0, stream>>>(
      rows, moms, out_rows, out_moms, tmp_rows, tmp_moms, ns, nvalid, qlens,
      bank_t, lengths, chunks, vchunks, S, M, K, C, band);
}

template <int NCH>
int launch(const float* rows, const float* moms, float* out_rows,
           float* out_moms, float* tmp_rows, float* tmp_moms, const int* ns,
           const int* nvalid, const int* qlens, const float* bank_t,
           const int* lengths, const float* chunks, const float* vchunks,
           int S, int M, int K, int C, int band, void* stream) {
  if (S == 0 || K == 0 || M == 0) return 0;
  auto* st = (cudaStream_t)stream;
  if (band >= 0)
    launch_band<NCH, true>(rows, moms, out_rows, out_moms, tmp_rows,
                           tmp_moms, ns, nvalid, qlens, bank_t, lengths,
                           chunks, vchunks, S, M, K, C, band, st);
  else
    launch_band<NCH, false>(rows, moms, out_rows, out_moms, tmp_rows,
                            tmp_moms, ns, nvalid, qlens, bank_t, lengths,
                            chunks, vchunks, S, M, K, C, band, st);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points: out_* are the new state, distinct from the inputs;
// tmp_* a scratch state of the same shape when C > 16, else null (see
// the design note). Each returns cudaGetLastError() after the launch (0
// on success).

// K3: rows only (no moments).
extern "C" int dtw_stream_distance(const float* rows, float* out_rows,
                                   float* tmp_rows, const int* ns,
                                   const int* nvalid, const int* qlens,
                                   const float* bank_t, const int* lengths,
                                   const float* chunks, int S, int M, int K,
                                   int C, int band, void* stream) {
  return launch<0>(rows, nullptr, out_rows, nullptr, tmp_rows, nullptr, ns,
                   nvalid, qlens, bank_t, lengths, chunks, nullptr, S, M, K,
                   C, band, stream);
}

// K1.
extern "C" int dtw_stream_scored(const float* rows, const float* moms,
                                 float* out_rows, float* out_moms,
                                 float* tmp_rows, float* tmp_moms,
                                 const int* ns, const int* nvalid,
                                 const int* qlens, const float* bank_t,
                                 const int* lengths, const float* chunks,
                                 int S, int M, int K, int C, int band,
                                 void* stream) {
  return launch<3>(rows, moms, out_rows, out_moms, tmp_rows, tmp_moms, ns,
                   nvalid, qlens, bank_t, lengths, chunks, nullptr, S, M, K,
                   C, band, stream);
}

// K4: moms has nch = 6 (exact) or 4 (approx) channels and vchunks is
// [S, C]. Returns -1 for another channel count (nothing launched).
extern "C" int dtw_stream_scored_var(const float* rows, const float* moms,
                                     float* out_rows, float* out_moms,
                                     float* tmp_rows, float* tmp_moms,
                                     const int* ns, const int* nvalid,
                                     const int* qlens, const float* bank_t,
                                     const int* lengths, const float* chunks,
                                     const float* vchunks, int S, int M,
                                     int K, int C, int band, int nch,
                                     void* stream) {
  if (nch == 6)
    return launch<6>(rows, moms, out_rows, out_moms, tmp_rows, tmp_moms, ns,
                     nvalid, qlens, bank_t, lengths, chunks, vchunks, S, M,
                     K, C, band, stream);
  if (nch == 4)
    return launch<4>(rows, moms, out_rows, out_moms, tmp_rows, tmp_moms, ns,
                     nvalid, qlens, bank_t, lengths, chunks, vchunks, S, M,
                     K, C, band, stream);
  return -1;
}
