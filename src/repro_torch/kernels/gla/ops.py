"""The public API of the GLA chunked-scan kernel K10 — the port of
``repro/kernels/gla/ops.py``.  The reference's ``interpret`` argument
becomes ``device``: CUDA unless the caller passes ``device="cpu"``, which
runs K10's plain version.

K10 takes head dims up to ``kernel.MAX_HEAD_DIM`` (128) in one launch;
the reference's kernel takes any.  Wider bfloat16 heads on the card
(mLSTM's 1024) go whole to ``kernel.gla_wide``, and so do wider bfloat16
heads on the CPU when a gradient is asked for (the wide route's
function, ``kernel.GlaWide``, through its plain versions, undivided).
:func:`gla_blocked` runs wider heads of float32 on the card, and every
other wide head on the CPU, on 128-wide blocks of them.  The state is
exact under the cut: state block (i, j) needs only k's column block i
and v's column block j.  o's
column block j needs v's block j and every block of k, since q_i . k_j
sums over all of dk: the dk blocks give partial outputs, which are
summed in float32 in rising block order and rounded once to v's dtype.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from ..common import as_float_tensor, as_tensor, resolve_device
from .kernel import (MAX_HEAD_DIM, WIDE_MAX_CHUNK, GlaChunks, _wants_grad,
                     chunk_cumsum, gla_chunks, gla_meta, gla_wide)

__all__ = ["gla_scan", "gla_blocked"]


def gla_scan(q, k, v, log_a, *, chunk: int = 128,
             device: Union[str, torch.device, None] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k [B, H, S, dk], v [B, H, S, dv] (tensors or numpy arrays;
    float32 or bfloat16 tensors, one dtype for the three), log_a [B, H, S]
    (<= 0) -> (o [B, H, S, dv] in v's dtype, final state [B, H, dk, dv]
    float32).  S must be a multiple of ``chunk``.  After the within-chunk
    cumsum of log_a: one K10 launch when dk, dv <= MAX_HEAD_DIM; else,
    for bfloat16 CUDA tensors and chunk <= WIDE_MAX_CHUNK,
    ``kernel.gla_wide`` (two launches; bfloat16 CPU tensors too when a
    gradient is asked for), and otherwise :func:`gla_blocked`
    (ceil(dv / MAX_HEAD_DIM) launches).  Meta tensors take
    ``kernel.gla_meta`` at any width: one operation, the undivided
    scan (with a gradient asked for, through ``kernel.GlaChunks``, whose
    backward is one operation too).  When a gradient is asked for, the
    launches go through ``kernel.GlaChunks`` (dk, dv <= MAX_HEAD_DIM) or
    ``kernel.GlaWide`` (bfloat16 wider heads): their backward kernels on
    the card, the plain backward on the CPU.  Float32's blocked route
    goes through ``GlaChunks`` block by block; bfloat16 heads wider than
    MAX_HEAD_DIM at a chunk over WIDE_MAX_CHUNK raise on the card."""
    dev = resolve_device(device)
    q, k, v = (as_float_tensor(t, dev) for t in (q, k, v))
    la = as_tensor(log_a, torch.float32, dev)
    if la.dim() != 3 or la.shape[-1] % chunk:
        raise ValueError(f"log_a: want [B, H, S] with S a multiple of "
                         f"chunk = {chunk}, got {tuple(la.shape)}")
    g = chunk_cumsum(la, chunk)
    if q.is_meta:
        if _wants_grad(q, k, v, g):
            return GlaChunks.apply(q, k, v, g, chunk)
        return gla_meta(q, k, v, g, chunk)
    if max(q.shape[-1], v.shape[-1]) <= MAX_HEAD_DIM:
        return gla_chunks(q, k, v, g, chunk)
    if q.dtype == torch.bfloat16 and chunk <= WIDE_MAX_CHUNK and (
            q.is_cuda or _wants_grad(q, k, v, g)):
        return gla_wide(q, k, v, g, chunk)
    return gla_blocked(q, k, v, g, chunk)


def gla_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 on MAX_HEAD_DIM-wide blocks of the heads: the arguments and
    results of ``kernel.gla_chunks``, any dk and dv.

    dk is zero-padded to a multiple of MAX_HEAD_DIM (exact: the padded
    columns add zero products and zero state rows) and its nk blocks
    become extra heads, [B, H nk, S, 128].  For each block j of dv, one
    ``gla_chunks`` call over those heads, with v's block j repeated for
    each of them and a float32 o: its nk partial outputs are summed in
    rising block order and cast once to v's dtype, and its state's nk
    [128, dv_j] blocks are copied out.  Every launch has dk = 128, which
    the bfloat16 kernel runs on ``gla_mma_kernel``.  CPU tensors take
    the plain version block by block, so the CPU runs this same
    decomposition."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    n = MAX_HEAD_DIM
    nk = -(-dk // n)
    pad = nk * n - dk

    def heads(t):              # [B, H, S, nk n] -> [B, H nk, S, n]
        if pad:
            t = F.pad(t, (0, pad))
        return t.reshape(b, h, s, nk, n).transpose(2, 3).reshape(
            b, h * nk, s, n)

    qb, kb = heads(q), heads(k)
    gb = g[:, :, None].expand(b, h, nk, s).reshape(b, h * nk, s)
    o = torch.empty((b, h, s, dv), dtype=v.dtype, device=v.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32,
                        device=v.device)
    for j0 in range(0, dv, n):
        vj = v[..., j0:j0 + n]
        w = vj.shape[-1]
        vb = vj[:, :, None].expand(b, h, nk, s, w).reshape(b, h * nk, s, w)
        part, st = gla_chunks(qb, kb, vb, gb, chunk,
                              out_dtype=torch.float32)
        part = part.reshape(b, h, nk, s, w)
        acc = part[:, :, 0]
        for i in range(1, nk):
            acc = acc + part[:, :, i]
        o[..., j0:j0 + w] = acc.to(v.dtype)
        state[..., j0:j0 + w] = st.reshape(b, h, nk * n, w)[:, :, :dk]
        del part, st, acc
    return o, state
