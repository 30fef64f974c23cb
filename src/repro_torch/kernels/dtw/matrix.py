"""K7: the DTW accumulated-cost matrix — the CUDA kernel, its wrapper,
its plain PyTorch version and the numpy oracle.

K7 (``repro/kernels/dtw/kernel.py::_dtw_kernel`` and
``::_dtw_pairs_kernel`` on the TPU) writes the full ``[N, M]`` matrix of
the DP (paper Eq. 1) for each (query, reference) pair, which the host
backtracks into the warped series Y' of Eq. 3.  The port's kernel
computes C rows of each pair's DP, resumed from a carried row, so one
kernel serves every matrix function of ``core.dtw`` (bank, pairs, banded,
scalar), the streaming bank DP (``dtw_bank_extend``) and the distance
bank (last row only).

* :func:`dtw_rows` is the wrapper: CUDA tensors launch
  ``csrc/matrix.cu`` (or raise), CPU tensors take :func:`dtw_rows_plain`.
  ``LIB.launches`` counts the launches.  The kernel runs a warp per pair
  as a wavefront of 32 column strips, the verdict scorers' schedule;
  ``tests/test_torch_matrix_schedule.py`` replays it in numpy.
* :func:`dtw_rows_plain` evaluates the same cells along anti-diagonals
  through the ticks' plain sweep (``stream._extend_plain``),
  ``min(d + min(min(diag, vert), horiz), 3e38)`` with the same operations
  in the same order as the kernel (and as the ticks' column sweep), so
  the two agree bitwise on any input, and its rows equal K3's rows and
  K2's endpoint distances bitwise.  The reference's matrix functions
  solve each row with a min-plus scan, which sums in another order: the
  port matches them bitwise on dyadic data and to rounding elsewhere.
* :func:`dtw_matrix_ref` is the reference's numpy oracle (float64, the
  per-cell recurrence), copied.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..common import (KernelLib, as_tensor, check_kernel_device,
                      check_launch, check_tensor)
from .stream import _CSRC, INF, _extend_plain

__all__ = ["dtw_rows", "dtw_rows_plain", "dtw_matrix_ref",
           "lengths_or_full", "LIB"]

_P = ctypes.c_void_p
_I = ctypes.c_int

LIB = KernelLib(
    "dtw_matrix", os.path.join(_CSRC, "matrix.cu"),
    headers=(os.path.join(_CSRC, "dtw_sweep.cuh"),),
    signatures={"dtw_matrix_rows": (
        [_P, ctypes.c_longlong] + [_P] * 7 + [_I] * 5 + [_P],
        ctypes.c_int),
        "dtw_matrix_panel": ([], ctypes.c_int)})

def lengths_or_full(lengths, k: int, m: int,
                    dev: torch.device) -> torch.Tensor:
    """int32 [K] true-length vector on ``dev``; defaults to the full
    padded width M."""
    if lengths is None:
        return torch.full((k,), m, dtype=torch.int32, device=dev)
    return as_tensor(lengths, torch.int32, dev)


def _check(xs, ys, qlens, rlens, row, band) -> None:
    """Raise unless the tensors are what the kernel's pointer arithmetic
    assumes."""
    dev = ys.device
    check_kernel_device(ys)
    p, m = ys.shape
    c = xs.shape[-1]
    check_tensor(xs, "xs", torch.float32, (c,) if xs.dim() == 1
                 else (p, c), dev)
    check_tensor(ys, "ys", torch.float32, (p, m), dev)
    check_tensor(qlens, "qlens", torch.int32, (p,), dev)
    check_tensor(rlens, "rlens", torch.int32, (p,), dev)
    if row is not None:
        check_tensor(row, "row", torch.float32, (p, m), dev)
    if band is not None and band < 0:
        raise ValueError("band must be >= 0 (or None)")


def dtw_rows(xs, ys, qlens, rlens, row=None, n0: int = 0,
             band: Optional[int] = None, collect_rows: bool = True
             ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """C rows of P pair DPs -> ``(rows [P, C, M] or None, last [P, M])``.

    xs [C] f32 (one query chunk for every pair, the bank form) or [P, C]
    (chunk p for pair p); ys [P, M] f32 references; qlens/rlens [P] i32
    the query and reference lengths that place the Sakoe-Chiba band
    (read only with ``band``); ``row`` [P, M] f32 the carried row
    D[n0 - 1, :] (None: the empty row); ``n0`` the samples consumed
    before the chunk (the virtual corner D[-1, -1] = 0 applies only when
    it is 0).  ``rows`` (with ``collect_rows``) holds every new row,
    ``last`` the new carried row.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if not ys.is_cuda:
        return dtw_rows_plain(xs, ys, qlens, rlens, row, n0, band,
                              collect_rows)
    _check(xs, ys, qlens, rlens, row, band)
    p, m = ys.shape
    c = xs.shape[-1]
    dev = ys.device
    rows = torch.empty((p, c, m), dtype=torch.float32, device=dev) \
        if collect_rows else None
    last = torch.empty((p, m), dtype=torch.float32, device=dev)
    lib = LIB.get()
    # a reference longer than one panel: the panels' [P, C] edge columns
    edges = torch.empty((p, c), dtype=torch.float32, device=dev) \
        if m > lib.dtw_matrix_panel() else None
    err = lib.dtw_matrix_rows(
        xs.data_ptr(), 0 if xs.dim() == 1 else c, ys.data_ptr(),
        None if row is None else row.data_ptr(), qlens.data_ptr(),
        rlens.data_ptr(), None if rows is None else rows.data_ptr(),
        last.data_ptr(), None if edges is None else edges.data_ptr(), p, c,
        m, int(n0), -1 if band is None else int(band),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("dtw_matrix_rows", err)
    LIB.launches += 1
    return rows, last


def dtw_rows_plain(xs, ys, qlens, rlens, row=None, n0: int = 0,
                   band: Optional[int] = None, collect_rows: bool = True
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of :func:`dtw_rows` (same arguments and
    results), on whatever device the tensors are on: the ticks' plain
    anti-diagonal sweep with one job a pair and a bank of one reference
    each (S = P, K = 1)."""
    p, m = ys.shape
    c = xs.shape[-1]
    dev = ys.device
    carry = torch.full((p, m), INF, dtype=torch.float32, device=dev) \
        if row is None else row
    rows = torch.empty((p, c, m, 1), dtype=torch.float32, device=dev) \
        if collect_rows else None
    last, _ = _extend_plain(
        carry[:, :, None], None,
        torch.full((p,), n0, dtype=torch.int32, device=dev),
        ys[:, :, None], rlens[:, None], xs.expand(p, c), None,
        torch.full((p,), c, dtype=torch.int32, device=dev), qlens, band,
        rows)
    return (None if rows is None else rows[..., 0]), last[:, :, 0]


def dtw_matrix_ref(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Pure-numpy O(N*M) oracle of the DTW matrix (paper Eq. 1-2), in
    float64 — ``repro/kernels/dtw/ref.py::dtw_matrix_ref``."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n, m = len(x), len(y)
    D = np.empty((n, m), np.float64)
    for i in range(n):
        for j in range(m):
            d = abs(x[i] - y[j])
            if i == 0 and j == 0:
                D[i, j] = d
            elif i == 0:
                D[i, j] = D[i, j - 1] + d
            elif j == 0:
                D[i, j] = D[i - 1, j] + d
            else:
                D[i, j] = d + min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return D
