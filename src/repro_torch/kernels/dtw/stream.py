"""K1, K3 and K4: the streaming ticks — CUDA kernels, their wrappers and
their plain PyTorch versions.

One service tick advances S streaming DTW rows by one chunk of C samples
against the whole reference bank.  K3
(``repro/kernels/dtw/stream.py::_stream_kernel`` on the TPU) advances the
rows alone: the distance-only tick.  K1 (``_stream_scored_kernel``)
also carries the warp-path correlation moments, three point channels
(sy, syy, sxy); K4 (the same Pallas kernel with ``variance=True``)
carries six (exact: sy, syy, sxy, svy, svyy, svxy) or four (approx: sy,
syy, sxy, svy), each variance channel's per-cell pair being the sample's
variance times the matching point pair.  All three update the rows
identically: K3's rows are bitwise K1's and K4's.  The tensors keep the
service's K-last tick layout: rows ``[S, M, K]``, moms
``[NCH, S, M, K]``, bank ``[M, K]``, variances ``[S, C]``.

* :func:`stream_bank_extend` (K3), :func:`stream_bank_extend_scored`
  (K1) and :func:`stream_bank_extend_scored_var` (K4) are the wrappers:
  for CUDA tensors they launch ``csrc/stream.cu`` (or raise); for CPU
  tensors they run the plain versions.  ``DIST_LAUNCHES`` counts K3's
  launches, ``LIB.launches`` K1's and ``VAR_LAUNCHES[nch]`` K4's, per
  channel count.
* :func:`stream_bank_extend_plain`,
  :func:`stream_bank_extend_scored_plain` and
  :func:`stream_bank_extend_scored_var_plain` evaluate the same
  recurrence along anti-diagonals of the chunk block (the formulation of
  ``repro.core.dtw._bank_extend_diag_impl``): every cell is
  ``min(d + min(min(diag, vert), horiz), 3e38)`` with the diag, vert,
  horiz selection order and horizontal runs carrying their anchor's
  moment base, the exact per-cell arithmetic of the kernel's column
  sweep, so the two agree bitwise on any input.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..common import (KernelLib, check_kernel_device, check_launch,
                      check_tensor)

__all__ = ["INF", "MOM_SHIFT", "stream_bank_extend",
           "stream_bank_extend_plain", "stream_bank_extend_scored",
           "stream_bank_extend_scored_plain",
           "stream_bank_extend_scored_var",
           "stream_bank_extend_scored_var_plain", "LIB", "DIST_LAUNCHES",
           "VAR_LAUNCHES"]

#: DP saturation value (repro's ``_INF``).
INF = 3.0e38
#: Centre of the correlation moments (repro's ``_MOM_SHIFT``).
MOM_SHIFT = 0.5
#: Reference values beyond this are the sentinel padding of the
#: anti-diagonal gather, not data (repro's ``_Y_VALID``).
_Y_VALID = 1.0e30
_BIG = 1.0e38

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_P = ctypes.c_void_p
_I = ctypes.c_int

LIB = KernelLib(
    "dtw_stream", os.path.join(_CSRC, "stream.cu"),
    headers=(os.path.join(_CSRC, "dtw_sweep.cuh"),),
    signatures={
        "dtw_stream_distance": ([_P] * 9 + [_I] * 5 + [_P], ctypes.c_int),
        "dtw_stream_scored": ([_P] * 12 + [_I] * 5 + [_P], ctypes.c_int),
        "dtw_stream_scored_var": ([_P] * 13 + [_I] * 6 + [_P],
                                  ctypes.c_int)})

#: Threads a block of ``csrc/stream.cu``'s launches.
BLOCK = 128
#: Samples a pass of the kernels' sweep takes (``dtw_sweep.cuh``'s
#: ``kPassRows``): a longer chunk takes one more pass per PASS_ROWS.
PASS_ROWS = 16

#: K3 launches.  The wrapper adds one per launch; a caller resets it to
#: 0 before a run it audits.
DIST_LAUNCHES = 0

#: K4 launches by moment channel count: 6 is the exact tick, 4 the
#: approx tick.  The wrapper adds one per launch; a caller resets them to
#: 0 before a run it audits.
VAR_LAUNCHES = {6: 0, 4: 0}


def _check_tick(rows, moms, ns, bank_t, lengths, chunks, nvalid, qlens,
                band, nch, vchunks=None) -> None:
    """Raise unless the tick's tensors are what the kernel's pointer
    arithmetic assumes (contiguous f32/i32 of the tick's shapes, one
    device, a Hopper card); ``nch`` 0 is the distance-only tick, which
    has no moments."""
    dev = rows.device
    check_kernel_device(rows)
    s, m, k = rows.shape
    c = chunks.shape[1]
    check_tensor(rows, "rows", torch.float32, (s, m, k), dev)
    if nch:
        check_tensor(moms, "moms", torch.float32, (nch, s, m, k), dev)
    check_tensor(bank_t, "bank_t", torch.float32, (m, k), dev)
    check_tensor(chunks, "chunks", torch.float32, (s, c), dev)
    if vchunks is not None:
        check_tensor(vchunks, "vchunks", torch.float32, (s, c), dev)
    for name, t, n in (("ns", ns, s), ("nvalid", nvalid, s),
                       ("qlens", qlens, s), ("lengths", lengths, k)):
        check_tensor(t, name, torch.int32, (n,), dev)
    if band is not None and band < 0:
        raise ValueError("band must be >= 0 (or None)")
    if m * k >= 2 ** 31:
        raise ValueError(f"the kernels index a [M, K] = [{m}, {k}] row "
                         f"with 32-bit offsets: M K must be < 2^31")


def _scratch(t: Optional[torch.Tensor], c: int) -> Optional[torch.Tensor]:
    """A scratch tensor shaped as ``t`` for the kernels' passes past the
    first (a chunk of ``c`` > PASS_ROWS samples), else None: the passes
    alternate between it and the output, so that no pass reads what it
    writes.  The caller holds it until the launch is enqueued."""
    return torch.empty_like(t) if t is not None and c > PASS_ROWS else None


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def stream_bank_extend(rows, ns, bank_t, lengths, chunks, nvalid, qlens,
                       band: Optional[int] = None) -> torch.Tensor:
    """K3: advance the distance-only tick state by one padded chunk ->
    ``rows``.

    rows [S, M, K] f32, ns/nvalid/qlens [S] i32, bank_t [M, K] f32,
    lengths [K] i32, chunks [S, C] f32.  Samples at or past
    ``nvalid[s]`` leave slot s untouched.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    global DIST_LAUNCHES
    if not rows.is_cuda:
        return stream_bank_extend_plain(rows, ns, bank_t, lengths, chunks,
                                        nvalid, qlens, band)
    _check_tick(rows, None, ns, bank_t, lengths, chunks, nvalid, qlens,
                band, 0)
    s, m, k = rows.shape
    out_rows = torch.empty_like(rows)
    tmp_rows = _scratch(rows, chunks.shape[1])
    err = LIB.get().dtw_stream_distance(
        rows.data_ptr(), out_rows.data_ptr(), _ptr(tmp_rows), ns.data_ptr(),
        nvalid.data_ptr(), qlens.data_ptr(), bank_t.data_ptr(),
        lengths.data_ptr(), chunks.data_ptr(), s, m, k, chunks.shape[1],
        -1 if band is None else int(band),
        torch.cuda.current_stream(rows.device).cuda_stream)
    check_launch("dtw_stream_distance", err)
    DIST_LAUNCHES += 1
    return out_rows


def stream_bank_extend_scored(rows, moms, ns, bank_t, lengths, chunks,
                              nvalid, qlens, band: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance the tick state by one padded chunk -> ``(rows, moms)``.

    rows [S, M, K] f32, moms [3, S, M, K] f32, ns/nvalid/qlens [S] i32,
    bank_t [M, K] f32, lengths [K] i32, chunks [S, C] f32.  Samples at or
    past ``nvalid[s]`` leave slot s untouched.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if not rows.is_cuda:
        return stream_bank_extend_scored_plain(rows, moms, ns, bank_t,
                                               lengths, chunks, nvalid,
                                               qlens, band)
    _check_tick(rows, moms, ns, bank_t, lengths, chunks, nvalid, qlens,
                band, 3)
    s, m, k = rows.shape
    out_rows = torch.empty_like(rows)
    out_moms = torch.empty_like(moms)
    tmp_rows = _scratch(rows, chunks.shape[1])
    tmp_moms = _scratch(moms, chunks.shape[1])
    err = LIB.get().dtw_stream_scored(
        rows.data_ptr(), moms.data_ptr(), out_rows.data_ptr(),
        out_moms.data_ptr(), _ptr(tmp_rows), _ptr(tmp_moms), ns.data_ptr(),
        nvalid.data_ptr(), qlens.data_ptr(), bank_t.data_ptr(),
        lengths.data_ptr(), chunks.data_ptr(), s, m, k, chunks.shape[1],
        -1 if band is None else int(band),
        torch.cuda.current_stream(rows.device).cuda_stream)
    check_launch("dtw_stream_scored", err)
    LIB.launches += 1
    return out_rows, out_moms


def stream_bank_extend_scored_var(rows, moms, ns, bank_t, lengths, chunks,
                                  vchunks, nvalid, qlens,
                                  band: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: advance the variance-carrying tick state by one padded chunk
    -> ``(rows, moms)``.

    As :func:`stream_bank_extend_scored`, with moms [NCH, S, M, K] of
    NCH = 6 (exact) or 4 (approx) channels and vchunks [S, C] f32 the
    samples' measurement variances.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    nch = moms.shape[0]
    if nch not in VAR_LAUNCHES:
        raise ValueError(f"a variance tick carries 6 (exact) or 4 "
                         f"(approx) moment channels, got {nch}")
    if not rows.is_cuda:
        return stream_bank_extend_scored_var_plain(
            rows, moms, ns, bank_t, lengths, chunks, vchunks, nvalid,
            qlens, band)
    _check_tick(rows, moms, ns, bank_t, lengths, chunks, nvalid, qlens,
                band, nch, vchunks)
    s, m, k = rows.shape
    out_rows = torch.empty_like(rows)
    out_moms = torch.empty_like(moms)
    tmp_rows = _scratch(rows, chunks.shape[1])
    tmp_moms = _scratch(moms, chunks.shape[1])
    err = LIB.get().dtw_stream_scored_var(
        rows.data_ptr(), moms.data_ptr(), out_rows.data_ptr(),
        out_moms.data_ptr(), _ptr(tmp_rows), _ptr(tmp_moms), ns.data_ptr(),
        nvalid.data_ptr(), qlens.data_ptr(), bank_t.data_ptr(),
        lengths.data_ptr(), chunks.data_ptr(), vchunks.data_ptr(), s, m, k,
        chunks.shape[1],
        -1 if band is None else int(band), nch,
        torch.cuda.current_stream(rows.device).cuda_stream)
    check_launch("dtw_stream_scored_var", err)
    VAR_LAUNCHES[nch] += 1
    return out_rows, out_moms


def stream_bank_extend_plain(rows, ns, bank_t, lengths, chunks, nvalid,
                             qlens, band: Optional[int] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`stream_bank_extend` (same
    arguments and result), on whatever device the tensors are on: the
    scored recurrence with no moment channels."""
    return _extend_plain(rows, None, ns, bank_t, lengths, chunks, None,
                         nvalid, qlens, band)[0]


def stream_bank_extend_scored_plain(rows, moms, ns, bank_t, lengths,
                                    chunks, nvalid, qlens,
                                    band: Optional[int] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`stream_bank_extend_scored` (same
    arguments and results), on whatever device the tensors are on."""
    return _extend_plain(rows, moms, ns, bank_t, lengths, chunks, None,
                         nvalid, qlens, band)


def stream_bank_extend_scored_var_plain(rows, moms, ns, bank_t, lengths,
                                        chunks, vchunks, nvalid, qlens,
                                        band: Optional[int] = None
                                        ) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Plain PyTorch version of :func:`stream_bank_extend_scored_var`
    (same arguments and results), on whatever device the tensors are
    on."""
    return _extend_plain(rows, moms, ns, bank_t, lengths, chunks, vchunks,
                         nvalid, qlens, band)


def _extend_plain(rows, moms, ns, bank_t, lengths, chunks, vchunks, nvalid,
                  qlens, band: Optional[int],
                  all_rows: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The anti-diagonal formulation shared by the plain versions.

    Cell (i, j) of the chunk block lives on anti-diagonal t = i + j at
    slot i; each of the C + M - 1 steps updates one [S, C, K] diagonal
    elementwise.  The state row enters as the diagonal-indexed boundary,
    and slot C - 1 emits the new state row column by column.  Padded
    samples (i >= nvalid) pass the row above through unchanged.  With
    ``vchunks`` the moms' channels 3.. take v times the matching point
    pair, v * (xm * yc) in that order (the reference's).  ``moms`` None
    is the distance-only tick: the rows alone, and None for the moments
    (the distances do not depend on them).  ``bank_t`` may also be
    [S, M, K] with ``lengths`` [S, K]: a bank of its own for each job
    (the plain versions of K2 pairs and K7, one reference a job).  With
    ``all_rows`` [S, C, M, K] every row of the chunk block is written
    there too, not only the last (K7's collected rows)."""
    s, c = chunks.shape
    m, k = bank_t.shape[-2:]
    dev = rows.device
    f32 = torch.float32
    ii = torch.arange(c, device=dev, dtype=torch.int32)
    il = ii.long()
    # reversed, sentinel-padded bank [1 or S, M + 2C, K]: slot i of
    # diagonal t reads y[t - i]
    bank3 = bank_t if bank_t.dim() == 3 else bank_t[None]
    big = torch.full((bank3.shape[0], c, k), _BIG, dtype=f32, device=dev)
    yrp = torch.cat([big, bank3.flip(1), big], dim=1)
    corner = torch.where(ns == 0, 0.0, INF).to(f32)
    # boundary index t: the diag predecessor D[-1, t-1]; t + 1: the vert.
    prow = torch.cat([corner[:, None, None].expand(s, 1, k), rows,
                      torch.full((s, c, k), INF, dtype=f32, device=dev)],
                     dim=1)
    valid = (ii[None, :] < nvalid[:, None])[:, :, None]          # [S, C, 1]
    x3 = chunks[:, :, None]
    if band is not None:
        centers = torch.div((ns[:, None] + ii[None, :])[:, :, None]
                            * (lengths[..., None, :] - 1),
                            torch.clamp(qlens - 1, min=1)[:, None, None],
                            rounding_mode="floor")               # [S, C, K]
    prev = torch.full((s, c, k), INF, dtype=f32, device=dev)
    pvert = torch.cat([prow[:, 0:1],
                       torch.full((s, c - 1, k), INF, dtype=f32,
                                  device=dev)], dim=1)
    out_rows = torch.empty((s, m, k), dtype=f32, device=dev)
    out_moms = None
    if moms is not None:
        nch = moms.shape[0]
        pmom = torch.cat([torch.zeros((nch, s, 1, k), dtype=f32,
                                      device=dev),
                          moms,
                          torch.zeros((nch, s, c, k), dtype=f32,
                                      device=dev)], dim=2)
        xm = (chunks - MOM_SHIFT)[:, :, None]                    # [S, C, 1]
        vv = None if vchunks is None else vchunks[:, :, None]    # [S, C, 1]
        bprev = torch.zeros((nch, s, c, k), dtype=f32, device=dev)
        mprev = torch.zeros_like(bprev)
        mvert = torch.zeros_like(bprev)
        out_moms = torch.empty((nch, s, m, k), dtype=f32, device=dev)
    for t in range(c + m - 1):
        yd = yrp[:, c + m - 1 - t: 2 * c + m - 1 - t]      # [1 or S, C, K]
        d = (x3 - yd).abs()
        if band is not None:
            off = (t - ii)[None, :, None]
            d = torch.where((off - centers).abs() <= band, d, INF)
        p_vert = torch.cat([prow[:, t + 1: t + 2], prev[:, : c - 1]], dim=1)
        p_diag = pvert
        p_horiz = prev
        best = torch.minimum(torch.minimum(p_diag, p_vert), p_horiz)
        cell = torch.clamp_max(d + best, INF)
        cell = torch.where(valid, cell, p_vert)
        if t >= c - 1:
            out_rows[:, t - (c - 1)] = cell[:, c - 1]
        if all_rows is not None:
            jj = t - il
            ok = (jj >= 0) & (jj < m)
            all_rows[:, il[ok], jj[ok]] = cell[:, ok]
        if moms is not None:
            yc = torch.where(yd.abs() < _Y_VALID, yd - MOM_SHIFT, 0.0)
            pairs = [yc.expand(s, c, k), (yc * yc).expand(s, c, k), xm * yc]
            if vv is not None:
                pairs += [vv * p for p in pairs[:nch - 3]]
            delta = torch.stack(pairs)                           # [NCH,S,C,K]
            m_vert = torch.cat([pmom[:, :, t + 1: t + 2],
                                mprev[:, :, : c - 1]], dim=2)
            m_diag = mvert
            sel_diag = p_diag <= torch.minimum(p_vert, p_horiz)
            sel_vert = ~sel_diag & (p_vert <= p_horiz)
            base = torch.where(sel_diag, m_diag,
                               torch.where(sel_vert, m_vert, bprev))
            m_cell = torch.where(valid, base + delta, m_vert)
            if t >= c - 1:
                out_moms[:, :, t - (c - 1)] = m_cell[:, :, c - 1]
            bprev, mprev, mvert = base, m_cell, m_vert
        prev, pvert = cell, p_vert
    return out_rows, out_moms
