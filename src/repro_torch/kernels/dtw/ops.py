"""The batched DTW matrix API on kernel K7 — the port of
``repro/kernels/dtw/ops.py``.

Every entry point is whole-bank batched: one K7 launch covers every
reference, or every (query, reference) pair.  ``lengths`` vectors carry
the true (pre-padding) series lengths; distances are read at column
``lengths[k] - 1``, which padding can never influence (D[i, j] depends
only on cells (<= i, <= j)).  The reference's ``interpret`` argument
becomes ``device``: CUDA unless the caller passes ``device="cpu"``, which
runs K7's plain version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..common import as_tensor, resolve_device
from .matrix import dtw_rows, lengths_or_full

__all__ = ["dtw_batched", "dtw_batched_pairs", "dtw_distances",
           "dtw_distances_pairs"]

Device = Union[str, torch.device, None]
F32 = torch.float32


def _last_valid(D, row_idx, col_idx) -> torch.Tensor:
    """D [K, N, M] -> D[k, row_idx[k], col_idx[k]] per pair."""
    kk = torch.arange(D.shape[0], device=D.device)
    return D[kk, row_idx.long(), col_idx.long()]


def dtw_batched(x, ys, device: Device = None, *, lengths=None,
                band: Optional[int] = None) -> torch.Tensor:
    """Query x [N] against references ys [K, M] -> D matrices [K, N, M].

    ``band`` (keyword-only, like ``lengths``) restricts each matrix to
    the Sakoe-Chiba band centred on the query's length N and reference
    k's true length ``lengths[k]`` (default M), 3e38 outside it."""
    dev = resolve_device(device)
    x, ys = as_tensor(x, F32, dev).reshape(-1), as_tensor(ys, F32, dev)
    k, m = ys.shape
    qlens = lengths_or_full(None, k, x.shape[0], dev)
    return dtw_rows(x, ys, qlens, lengths_or_full(lengths, k, m, dev),
                    band=band)[0]


def dtw_batched_pairs(xs, ys, device: Device = None, *, xlens=None,
                      ylens=None, band: Optional[int] = None
                      ) -> torch.Tensor:
    """Pairwise queries xs [K, N] vs references ys [K, M] -> [K, N, M].

    ``band`` (keyword-only) centres pair k's band on its true lengths
    ``xlens[k]`` and ``ylens[k]`` (default N and M)."""
    dev = resolve_device(device)
    xs, ys = as_tensor(xs, F32, dev), as_tensor(ys, F32, dev)
    if xs.shape[0] != ys.shape[0]:
        raise ValueError(f"pair count mismatch {xs.shape[0]} vs "
                         f"{ys.shape[0]}")
    k, m = ys.shape
    return dtw_rows(xs, ys, lengths_or_full(xlens, k, xs.shape[1], dev),
                    lengths_or_full(ylens, k, m, dev), band=band)[0]


def dtw_distances(x, ys, device: Device = None, *, lengths=None,
                  band: Optional[int] = None) -> torch.Tensor:
    """-> similarity distances D(N, len_k) per reference, shape [K].

    ``lengths`` gives each padded reference row's true length; omitted
    means every row uses the full width M.  ``band`` as in
    :func:`dtw_batched`.  One K7 launch that writes only the last row."""
    dev = resolve_device(device)
    x, ys = as_tensor(x, F32, dev).reshape(-1), as_tensor(ys, F32, dev)
    k, m = ys.shape
    ls = lengths_or_full(lengths, k, m, dev)
    qlens = lengths_or_full(None, k, x.shape[0], dev)
    last = dtw_rows(x, ys, qlens, ls, band=band, collect_rows=False)[1]
    return last.gather(1, (ls.long() - 1)[:, None])[:, 0]


def dtw_distances_pairs(xs, ys, xlens=None, ylens=None,
                        device: Device = None) -> torch.Tensor:
    """-> distances D(xlen_k, ylen_k) per (query, reference) pair, [K]."""
    D = dtw_batched_pairs(xs, ys, device=device)
    k = D.shape[0]
    ql = lengths_or_full(xlens, k, D.shape[1], D.device)
    rl = lengths_or_full(ylens, k, D.shape[2], D.device)
    return _last_valid(D, ql - 1, rl - 1)
