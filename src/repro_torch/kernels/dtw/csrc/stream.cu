// K1: the scored streaming tick (one service tick, all in-flight jobs).
//
// Replaces repro/kernels/dtw/stream.py::_stream_scored_kernel (the Pallas
// TPU kernel reached through stream_bank_extend_scored_kernel). It
// advances S streaming DP rows and their (sy, syy, sxy) warp-path moment
// slabs by one chunk of C samples against the whole [M, K] reference bank.
//
// Layout is the service's K-last tick state: rows [S, M, K], moms
// [3, S, M, K], bank_t [M, K]. One thread per (slot s, reference k)
// sweeps the M columns (dtw_sweep.cuh), so consecutive threads touch
// consecutive addresses and every load and store is coalesced.
//
// Bound on this card: memory. The kernel reads and writes the four
// [S, M, K] f32 channels once a tick (2 x 16 bytes a state cell) and does
// 17 f32 operations per state cell per sample; at C = 16 that is ~8.5
// operations a byte, under the H100's f32 balance of ~20 (67 TFLOP/s over
// 3.35 TB/s), so the state traffic sets the bound. The design touches
// each state element twice (one load, one store) per pass of up to 16
// samples, the pass's rows held in registers; the service's chunks of 8
// or 16 samples take one pass.
#include "dtw_sweep.cuh"

namespace {

__global__ void stream_scored_kernel(
    const float* rows, const float* moms, float* out_rows, float* out_moms,
    const int* __restrict__ ns, const int* __restrict__ nvalid,
    const int* __restrict__ qlens, const float* __restrict__ bank_t,
    const int* __restrict__ lengths, const float* __restrict__ chunks,
    int S, int M, int K, int C, int band) {
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
  float cap[4];
  // nv == 0 still takes one pass: it copies the state row through.
  const int npass = nv > 0 ? (nv + dtw::kRows - 1) / dtw::kRows : 1;
  for (int p = 0; p < npass; ++p) {
    const int left = nv - p * dtw::kRows;
    const int nr = left < dtw::kRows ? left : dtw::kRows;
    const bool first = p == 0;
    dtw::sweep_pass(x + p * dtw::kRows, nr, n0 + p * dtw::kRows, ql, band,
                    lk, bank_t + k, K, M, first ? rows + base : out_rows + base,
                    first ? moms + base : out_moms + base, out_rows + base,
                    out_moms + base, ch, false, true, -1, cap);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dtw_stream_scored(const float* rows, const float* moms,
                                 float* out_rows, float* out_moms,
                                 const int* ns, const int* nvalid,
                                 const int* qlens, const float* bank_t,
                                 const int* lengths, const float* chunks,
                                 int S, int M, int K, int C, int band,
                                 void* stream) {
  if (S == 0 || K == 0 || M == 0) return 0;
  const dim3 block(128);
  const dim3 grid((K + block.x - 1) / block.x, S);
  stream_scored_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      rows, moms, out_rows, out_moms, ns, nvalid, qlens, bank_t, lengths,
      chunks, S, M, K, C, band);
  return (int)cudaGetLastError();
}
