"""K2: the offline verdict scorer — CUDA kernel, its wrapper and its plain
PyTorch version.

J complete queries are scored against the whole reference bank at the
closed alignment endpoint ``(xlen - 1, len_k - 1)``: the moment-carrying
DP runs from a fresh row over each query and the warp correlation is read
through :func:`corr_from_moments` (``repro/kernels/dtw/score.py::
_score_kernel`` on the TPU).  Results are ``[J, K]`` scores and endpoint
distances.

* :func:`score_bank_offline` is the wrapper: CUDA tensors launch
  ``csrc/score.cu`` (or raise), CPU tensors take
  :func:`score_bank_offline_plain`.  ``LIB.launches`` counts kernel launches.
* :func:`score_bank_offline_plain` is the streaming tick's plain version
  run over the whole query from the empty state (``ns = 0``, band centres
  from ``xlen``) and read at column ``len_k - 1``: the same per-cell
  arithmetic as the kernel, so the two agree bitwise.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..common import KernelLib, check_kernel_device, check_tensor
from .stream import INF, _CSRC, stream_bank_extend_scored_plain

__all__ = ["corr_from_moments", "score_bank_offline",
           "score_bank_offline_plain", "LIB"]

#: Rows a pass of the column sweep holds in registers (``kRows`` in
#: ``csrc/dtw_sweep.cuh``): longer queries need the scratch row.
_KROWS = 16

_P = ctypes.c_void_p
_I = ctypes.c_int

LIB = KernelLib(
    "dtw_score", os.path.join(_CSRC, "score.cu"),
    headers=(os.path.join(_CSRC, "dtw_sweep.cuh"),),
    signatures={"dtw_score_offline": (
        [_P] * 10 + [_I] * 5 + [_P], ctypes.c_int)})


def corr_from_moments(sy, syy, sxy, sx, sxx, n):
    """Warp correlation from (centred) moment sums, elementwise over
    broadcast-compatible tensors — repro's ``_corr_from_moments``, the one
    score tail of the tick, the verdict and both kernels.  Degeneracy is
    judged relative to the cancellation scale: a variance within ~1e-5 of
    it is rounding noise, and the score is then 1.0 for an identical
    constant pair, else 0.0."""
    vx = torch.clamp_min(sxx - sx * sx / n, 0.0)
    vy = torch.clamp_min(syy - sy * sy / n, 0.0)
    cov = sxy - sx * sy / n
    # PyTorch's float32 sqrt on the CPU is not always correctly rounded;
    # float64 then float32 is (the IEEE result of the kernel's
    # __fsqrt_rn and of the reference).
    denom = torch.sqrt((vx * vy).double()).float()
    corr = torch.clamp(cov / torch.where(denom > 0, denom, 1.0), -1.0, 1.0)
    degx = vx <= 1e-5 * (sxx + sx * sx / n) + 1e-12
    degy = vy <= 1e-5 * (syy + sy * sy / n) + 1e-12
    both = degx & degy & ((sx - sy).abs() / n < 1e-6)
    return torch.where(degx | degy, torch.where(both, 1.0, 0.0), corr)


def score_bank_offline(xs, xlens, bank_t, lengths, sx, sxx,
                       band: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-end scores and endpoint distances -> ``(scores, dists)``,
    both [J, K] f32.

    xs [J, N] f32 (padded; ``xlens`` [J] i32 true lengths), bank_t
    [M, K] f32 with lengths [K] i32, sx/sxx [J] f32 centred query folds.
    A query of length 0 scores 0.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if not xs.is_cuda:
        return score_bank_offline_plain(xs, xlens, bank_t, lengths, sx, sxx,
                                        band)
    dev = xs.device
    check_kernel_device(xs)
    j, n = xs.shape
    m, k = bank_t.shape
    check_tensor(xs, "xs", torch.float32, (j, n), dev)
    check_tensor(bank_t, "bank_t", torch.float32, (m, k), dev)
    check_tensor(xlens, "xlens", torch.int32, (j,), dev)
    check_tensor(lengths, "lengths", torch.int32, (k,), dev)
    check_tensor(sx, "sx", torch.float32, (j,), dev)
    check_tensor(sxx, "sxx", torch.float32, (j,), dev)
    if band is not None and band < 0:
        raise ValueError("band must be >= 0 (or None)")
    scores = torch.empty((j, k), dtype=torch.float32, device=dev)
    dists = torch.empty((j, k), dtype=torch.float32, device=dev)
    if n > _KROWS:
        scratch_d = torch.empty((j, m, k), dtype=torch.float32, device=dev)
        scratch_m = torch.empty((3, j, m, k), dtype=torch.float32,
                                device=dev)
    else:                       # never read: every query fits one pass
        scratch_d = scratch_m = torch.empty((1,), dtype=torch.float32,
                                            device=dev)
    err = LIB.get().dtw_score_offline(
        xs.data_ptr(), xlens.data_ptr(), bank_t.data_ptr(),
        lengths.data_ptr(), sx.data_ptr(), sxx.data_ptr(),
        scratch_d.data_ptr(), scratch_m.data_ptr(), scores.data_ptr(),
        dists.data_ptr(), j, n, m, k, -1 if band is None else int(band),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dtw_score_offline launch failed: CUDA error "
                           f"{err}")
    LIB.launches += 1
    return scores, dists


def score_bank_offline_plain(xs, xlens, bank_t, lengths, sx, sxx,
                             band: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`score_bank_offline` (same arguments
    and results), on whatever device the tensors are on."""
    j = xs.shape[0]
    m, k = bank_t.shape
    dev = xs.device
    rows, moms = stream_bank_extend_scored_plain(
        torch.full((j, m, k), INF, dtype=torch.float32, device=dev),
        torch.zeros((3, j, m, k), dtype=torch.float32, device=dev),
        torch.zeros((j,), dtype=torch.int32, device=dev), bank_t, lengths,
        xs, xlens, xlens, band)
    jend = (lengths - 1).long()
    kk = torch.arange(k, device=dev)
    dists = rows[:, jend, kk]                                     # [J, K]
    msel = moms[:, :, jend, kk]                                   # [3, J, K]
    nn = torch.clamp_min(xlens, 1).to(torch.float32)[:, None]
    scores = corr_from_moments(msel[0], msel[1], msel[2], sx[:, None],
                               sxx[:, None], nn)
    return torch.where(xlens[:, None] > 0, scores, 0.0), dists
