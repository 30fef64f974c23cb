"""K9: causal GQA flash-attention forward — the CUDA kernel, its wrapper
and its plain PyTorch version.

K9 (``repro/kernels/attention/kernel.py::_flash_kernel`` on the TPU)
computes ``softmax(q k^T / sqrt(dh)) v`` for q [B, H, S, dh] against k
[B, KV, T, dh] and v [B, KV, T, dv], query head h reading kv head
``h // (H // KV)``, with an online softmax over kv blocks and the kv loop
bounded at the causal frontier.  Inputs are float32 or bfloat16 (one
dtype for q, k and v); the math is float32; o [B, H, S, dv] comes out in
q's dtype.  The reference kernel's conventions are kept: q is scaled by
``dh ** -0.5`` (rounded to float32) before the dot, masked scores are
``-1e30`` (not ``-inf``), the row sum is clamped at ``1e-30``, and the
causal mask is ``t <= s`` with both counted from 0 (top-left aligned).
The numpy oracle ``ref.attention_ref`` aligns the mask bottom-right
(``np.tril(k=T - S)``): the two agree only when S == T, and the port
follows the kernel.

* :func:`flash_forward` is the wrapper.  CUDA tensors launch a kernel
  (or raise), chosen by dtype, both on the tensor cores (``wgmma``):
  bfloat16 inputs ``csrc/flash_wgmma.cu`` (the score is scaled after the
  product, since a scaled q is not representable in bfloat16, and P
  enters the PV product as two bfloat16 parts, P_hi + P_lo; at MLA's
  head, dh over 128, its warp-specialized persistent
  ``flash_mla_kernel``, whose work list :func:`mla_tiles` gives); float32
  inputs ``csrc/flash_tf32.cu``, every operand split into two TF32
  parts and each product taken as three TF32 products (one would keep
  too few digits for the float32 tolerance; at MLA's head its
  warp-specialized persistent ``flash_tf32_mla_kernel``, whose work list
  is ``mla_tiles(..., bm=MLA_F32_BM)``).  CPU tensors take
  :func:`flash_forward_plain`.  ``BF16_LIB.launches`` and
  ``LIB.launches`` count the two kernels' launches.  Meta tensors take
  neither: o comes back empty, and the call is reported as one
  operation "K9" of ``2 (dh + dv)`` flops a query-key pair under the
  mask (:func:`causal_pairs`) through ``common.meta_kernel``; when a
  gradient is asked for, through :class:`FlashAttention` as on the other
  devices, whose backward on meta is one operation "K9_bwd" of ``2 (3
  dh + 2 dv)`` flops a pair (the K9 f32 backward's bound in
  ``PERF.md``), q, k, v, o, do and the lse read and dq, dk, dv written
  once, with empty gradients of the inputs' shapes.
* :func:`flash_forward_plain` is the reference kernel's block loop: for
  each ``bq`` query block, an online softmax over the ``bk`` kv blocks up
  to the causal frontier, in float32.  Its products go through
  ``torch.matmul``; the CUDA kernels' never do.

The backward (float32 or bfloat16, dh <= MAX_DH, dv <= MAX_DV): when q,
k or v requires grad and grad mode is on, :func:`flash_forward` goes
through :class:`FlashAttention`, an ``autograd.Function``.  On CUDA its
forward launches the kernel of the inputs' dtype with the rows'
log-sum-exp ``lse`` [B, H, S] (float32) written beside o (o itself is the
lse-free launch's, bitwise), and its backward (:func:`flash_backward`)
the backward kernel of the dtype and head, three kernels on the stream
counted as one launch: float32 at dh and dv <= 128
``csrc/flash_f32_bwd.cu`` (every product as three TF32 products on the
tensor cores, as the forward's; ``BWD_LIB.launches``), at MLA's head (dh
over 128) ``csrc/flash_f32_bwd_mla.cu`` (split TF32 too, at 16-row
steps; ``BWD_MLA_LIB.launches``); bfloat16 at dh and dv <= 128
``csrc/flash_bf16_bwd.cu`` (``BF16_BWD_LIB.launches``), at MLA's head
``csrc/flash_bf16_bwd_mla.cu`` (``BF16_BWD_MLA_LIB.launches``), both
``csrc/flash_bf16_bwd.cuh``: Q K^T and dO V^T single bf16 products, P and
dS entering dV, dK and dQ as two bf16 parts, the gradients rounded to
bfloat16 once, at the end.  ``LIB.launches`` and ``BF16_LIB.launches``
stay the forwards' counts.  On the CPU it takes
:func:`flash_forward_plain` with the lse and :func:`flash_backward_plain`.
Head dims past MAX_DH / MAX_DV raise ``NotImplementedError`` when a
gradient is asked for on the card; no plain version runs there.  The
reference has no backward kernel (jax.grad differentiates its jnp
attention), so the backward replaces no TPU kernel.  It follows the
standard flash backward: D = rowsum(do o), P recomputed from q k^T and
the lse, dP = do v^T, dS = P (dP - D), dq = scale dS k, dk = dS^T (q
scale), dv = P^T do, with the forward's scale, mask and tiling.

``bq`` and ``bk`` are the reference's tiling: S and T must be multiples
of them, as there.  The CUDA kernels tile by 64 query rows and 64 (bf16)
or 32 (f32) kv rows whatever they are; a kv block past the frontier
contributes exact zeros, so the tiling changes only the order of the
float32 sums.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..common import (FLOAT_DTYPES, FLOAT_IO_HEADER, KernelLib,
                      check_float_dtypes, check_kernel_device,
                      check_launch, check_tensor, meta_kernel)

__all__ = ["flash_forward", "flash_forward_plain", "flash_backward",
           "flash_backward_plain", "FlashAttention", "mla_tiles",
           "causal_pairs", "LIB", "BF16_LIB", "BWD_LIB", "BWD_MLA_LIB",
           "BF16_BWD_LIB", "BF16_BWD_MLA_LIB", "MAX_DH", "MAX_DV",
           "MAX_BWD_D", "MLA_BM", "MLA_F32_BM"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_P = ctypes.c_void_p
_I = ctypes.c_int

#: Largest q and k head dim the kernel takes: 192 for MLA's prefill (128
#: + 64), whose instantiation holds q and k 192 wide and v 128.
MAX_DH = 192
#: Largest v head dim the kernel takes.
MAX_DV = 128
#: The masked score of the reference kernel.
NEG = -1.0e30
#: Query rows a tile of ``flash_mla_kernel`` (two consumer warpgroups of
#: 64).
MLA_BM = 128
#: Query rows a tile of ``flash_tf32_mla_kernel`` (one consumer
#: warpgroup: a tile's query parts fill 96 KB of shared memory).
MLA_F32_BM = 64

_WGMMA_HEADER = os.path.join(_CSRC, "wgmma.cuh")
_BF16_TILE_HEADER = os.path.join(_CSRC, "bf16_tile.cuh")
#: The split-TF32 pieces of the float32 backward kernels (K9's and K10's).
TF32_SPLIT_HEADER = os.path.join(_CSRC, "tf32_split.cuh")
#: K9 for float32 inputs, on the tensor cores as split TF32.
LIB = KernelLib(
    "flash_tf32", os.path.join(_CSRC, "flash_tf32.cu"),
    headers=(FLOAT_IO_HEADER, _WGMMA_HEADER),
    signatures={"flash_attention_fwd_tf32": (
        [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _I, _P], ctypes.c_int)})
#: The backward of K9 for float32 inputs, on the tensor cores as split
#: TF32.
BWD_LIB = KernelLib(
    "flash_f32_bwd", os.path.join(_CSRC, "flash_f32_bwd.cu"),
    headers=(FLOAT_IO_HEADER, _WGMMA_HEADER, TF32_SPLIT_HEADER),
    signatures={"flash_attention_bwd_f32": (
        [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _I, _P], ctypes.c_int)})
#: Largest head dim (dh and dv) the tensor-core backward takes; MLA's
#: head (dh over it, up to MAX_DH) takes ``BWD_MLA_LIB``.
MAX_BWD_D = 128
#: The backward of K9 for float32 inputs at MLA's head (128 < dh <=
#: MAX_DH, dv <= MAX_DV), on the tensor cores as split TF32.
BWD_MLA_LIB = KernelLib(
    "flash_f32_bwd_mla", os.path.join(_CSRC, "flash_f32_bwd_mla.cu"),
    headers=(FLOAT_IO_HEADER, _WGMMA_HEADER, TF32_SPLIT_HEADER),
    signatures={"flash_attention_bwd_f32_mla": (
        [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _I, _P], ctypes.c_int)})
#: K9 for bfloat16 inputs, on the tensor cores.
BF16_LIB = KernelLib(
    "flash_wgmma", os.path.join(_CSRC, "flash_wgmma.cu"),
    headers=(FLOAT_IO_HEADER, _WGMMA_HEADER, _BF16_TILE_HEADER),
    signatures={"flash_attention_fwd_bf16": (
        [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _I, _P], ctypes.c_int)})
_BF16_BWD_HEADERS = (FLOAT_IO_HEADER, _WGMMA_HEADER, _BF16_TILE_HEADER,
                     os.path.join(_CSRC, "flash_bf16_bwd.cuh"))
#: The backward of K9 for bfloat16 inputs (dh, dv <= MAX_BWD_D), on the
#: tensor cores.
BF16_BWD_LIB = KernelLib(
    "flash_bf16_bwd", os.path.join(_CSRC, "flash_bf16_bwd.cu"),
    headers=_BF16_BWD_HEADERS,
    signatures={"flash_attention_bwd_bf16": (
        [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _I, _P], ctypes.c_int)})
#: The backward of K9 for bfloat16 inputs at MLA's head (MAX_BWD_D < dh
#: <= MAX_DH, dv <= MAX_DV), on the tensor cores.
BF16_BWD_MLA_LIB = KernelLib(
    "flash_bf16_bwd_mla", os.path.join(_CSRC, "flash_bf16_bwd_mla.cu"),
    headers=_BF16_BWD_HEADERS,
    signatures={"flash_attention_bwd_bf16_mla": (
        [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _I, _P], ctypes.c_int)})


def _shapes(q, k, v, bq: int, bk: int):
    """(B, H, KV, S, T, dh, dv), raising on what the reference's kernel
    does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v: want [B, H, S, dh], [B, KV, T, dh], "
                         "[B, KV, T, dv]")
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if tuple(k.shape) != (b, kv, t, dh) or tuple(v.shape[:3]) != (b, kv, t):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if kv == 0 or h % kv:
        raise ValueError(f"H = {h} is not a multiple of KV = {kv}")
    if s % bq or t % bk:
        raise ValueError(f"S = {s} and T = {t} must be multiples of "
                         f"bq = {bq} and bk = {bk}")
    check_float_dtypes(q=q, k=k, v=v)
    return b, h, kv, s, t, dh, dv


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bq: int = 128, bk: int = 128,
                  causal: bool = True) -> torch.Tensor:
    """K9: attention of q [B, H, S, dh] over k [B, KV, T, dh] and v
    [B, KV, T, dv] -> o [B, H, S, dv] in q's dtype.  CUDA tensors launch
    the kernel of their dtype (dh <= MAX_DH, dv <= MAX_DV): bfloat16 the
    bf16 one, float32 the split-TF32 one; CPU tensors take the plain
    version; meta tensors an empty o, reported as one operation.  When a
    gradient is asked for (grad mode on, an input requiring grad), the
    call goes through :class:`FlashAttention`."""
    b, h, kv, s, t, dh, dv = _shapes(q, k, v, bq, bk)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.is_cuda:
            _check_backward(dh, dv)
        return FlashAttention.apply(q, k, v, bq, bk, causal)
    if q.is_meta:
        return _meta_forward(q, k, v, causal, with_lse=False)[0]
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, bq, bk, causal)
    return _launch_forward(q, k, v, causal, with_lse=False)[0]


def _check_backward(dh: int, dv: int) -> None:
    """Raise NotImplementedError unless a backward kernel of K9 takes
    these CUDA inputs (float32 or bfloat16, as ``_shapes`` checks; dh <=
    MAX_DH, dv <= MAX_DV)."""
    if dh > MAX_DH or dv > MAX_DV:
        raise NotImplementedError(
            f"K9 backward: no backward kernel for head dims dh = {dh}, dv "
            f"= {dv} (at most {MAX_DH} and {MAX_DV})")


def _meta_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, with_lse: bool):
    """K9 on meta tensors: (empty o, empty lse or None), reported as one
    operation "K9"; with the lse, its bytes written too."""
    b, h, s, dh = q.shape
    t, dv = k.shape[2], v.shape[-1]
    o = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    meta_kernel("K9", 2 * (dh + dv) * b * h * causal_pairs(s, t, causal),
                (q, k, v), (o,) if lse is None else (o, lse))
    return o, lse


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, with_lse: bool):
    """One launch of the kernel of q's dtype -> (o, lse or None): with
    ``with_lse`` the kernel also writes the lse [B, H, S] float32."""
    b, h, s, dh = q.shape
    kv, t, dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    check_kernel_device(q)
    if dh > MAX_DH:
        raise ValueError(f"K9 takes a q/k head dim dh up to {MAX_DH}, got "
                         f"dh = {dh}")
    if dv > MAX_DV:
        raise ValueError(f"K9 takes a v head dim dv up to {MAX_DV}, got "
                         f"dv = {dv}")
    check_tensor(q, "q", FLOAT_DTYPES, (b, h, s, dh), dev)
    check_tensor(k, "k", q.dtype, (b, kv, t, dh), dev)
    check_tensor(v, "v", q.dtype, (b, kv, t, dv), dev)
    o = torch.empty((b, h, s, dv), dtype=q.dtype, device=dev)
    scale = float(np.float32(dh ** -0.5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    # whole 16-byte chunks of a row go by one load; other head dims
    # element-wise
    per = 16 // q.element_size()
    vec = dh % per == 0 and dv % per == 0 and all(p % 16 == 0
                                                  for p in ptrs[:3])
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) \
        if with_lse else None
    lib, fn = (BF16_LIB, "flash_attention_fwd_bf16") \
        if q.dtype == torch.bfloat16 else (LIB, "flash_attention_fwd_tf32")
    err = getattr(lib.get(), fn)(
        *ptrs, None if lse is None else lse.data_ptr(), b, h, kv, s, t, dh,
        dv, scale, int(causal), int(vec), stream)
    check_launch(fn, err)
    lib.launches += 1
    return o, lse


def causal_pairs(s: int, t: int, causal: bool = True) -> int:
    """The query-key pairs one (batch, head) of K9 computes: under the
    top-left causal mask (key j <= query i, both from 0) query i takes
    min(i + 1, T) keys; without the mask S T."""
    if not causal:
        return s * t
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def mla_tiles(bh: int, s: int, blocks: int, bm: int = MLA_BM):
    """The work list ``flash_mla_kernel`` (``bm`` = MLA_BM) and
    ``flash_tf32_mla_kernel`` (``bm`` = MLA_F32_BM) walk: for each of
    ``blocks`` persistent blocks, its (head, query tile) pairs in order.
    Rank i is query tile nq - 1 - i // bh of head i % bh (nq = ceil(s /
    bm)), so the tiles with the most kv tiles under the causal frontier
    come first; block b takes ranks b, b + blocks, ...  The launch has
    min(bh nq, SMs) blocks."""
    nq = -(-s // bm)
    return [[(i % bh, nq - 1 - i // bh) for i in range(b, bh * nq, blocks)]
            for b in range(blocks)]


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bq: int = 128, bk: int = 128, causal: bool = True,
                        with_lse: bool = False):
    """Plain PyTorch version of :func:`flash_forward` (same arguments and
    result), on whatever device the tensors are on.  With ``with_lse``,
    (o, lse): lse [B, H, S] float32, each row's m + log(max(l, 1e-30))."""
    b, h, kv, s, t, dh, dv = _shapes(q, k, v, bq, bk)
    g = h // kv
    dev = q.device
    scale = float(np.float32(dh ** -0.5))
    qg = q.reshape(b, kv, g, s, dh).float() * scale   # [B, KV, G, S, dh]
    kf = k.float()[:, :, None]                          # [B, KV, 1, T, dh]
    vf = v.float()[:, :, None]
    out = torch.empty((b, kv, g, s, dv), dtype=torch.float32, device=dev)
    lse = torch.empty((b, kv, g, s), dtype=torch.float32, device=dev)
    nk = t // bk
    rows = torch.arange(bq, device=dev)[:, None]
    cols = torch.arange(bk, device=dev)[None, :]
    for qi in range(s // bq):
        q0 = qi * bq
        qb = qg[:, :, :, q0:q0 + bq]
        # causal frontier: kv blocks strictly above the diagonal are skipped
        last = min(nk, (q0 + bq + bk - 1) // bk) if causal else nk
        m = torch.full((b, kv, g, bq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kv, g, bq), dtype=torch.float32, device=dev)
        o = torch.zeros((b, kv, g, bq, dv), dtype=torch.float32, device=dev)
        for ki in range(last):
            kb = kf[:, :, :, ki * bk:(ki + 1) * bk]
            vb = vf[:, :, :, ki * bk:(ki + 1) * bk]
            sc = torch.matmul(qb, kb.transpose(-1, -2))   # [B,KV,G,bq,bk]
            if causal:
                sc = torch.where(ki * bk + cols <= q0 + rows, sc, NEG)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.matmul(p, vb)
            m = m_new
        den = torch.clamp_min(l, 1e-30)
        out[:, :, :, q0:q0 + bq] = o / den[..., None]
        lse[:, :, :, q0:q0 + bq] = m + torch.log(den)
    o = out.reshape(b, h, s, dv).to(q.dtype)
    return (o, lse.reshape(b, h, s)) if with_lse else o


class FlashAttention(torch.autograd.Function):
    """K9 with its backward: ``apply(q, k, v, bq, bk, causal) -> o``.
    CUDA (float32 or bfloat16, dh <= MAX_DH, dv <= MAX_DV): the forward
    kernel of the dtype writing the lse, then the backward kernel of the
    dtype and head; CPU: the two plain versions; meta: "K9" and "K9_bwd",
    one operation each."""

    @staticmethod
    def forward(ctx, q, k, v, bq: int, bk: int, causal: bool):
        if q.is_meta:
            o, lse = _meta_forward(q, k, v, causal, with_lse=True)
        elif q.is_cuda:
            o, lse = _launch_forward(q, k, v, causal, with_lse=True)
        else:
            o, lse = flash_forward_plain(q, k, v, bq, bk, causal,
                                         with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tiles = (bq, bk, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, do.contiguous(), lse,
                                    *ctx.tiles)
        return dq, dk, dv, None, None, None


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                   bq: int = 64, bk: int = 64, causal: bool = True):
    """The gradients (dq, dk, dv) of K9 at q, k, v, given its output o,
    the output's gradient do [B, H, S, dv] and the forward's lse [B, H,
    S].  CUDA tensors launch the backward kernel of their dtype (q, k, v,
    o and do of one dtype, the lse float32) and head, three kernels on the
    stream counted as one launch: float32 (split TF32 on the tensor cores)
    ``BWD_LIB`` at dh, dv <= MAX_BWD_D and ``BWD_MLA_LIB`` at MLA's head
    (dh up to MAX_DH, dv up to MAX_DV), bfloat16 ``BF16_BWD_LIB`` and
    ``BF16_BWD_MLA_LIB`` the same; CPU tensors take
    :func:`flash_backward_plain`; meta tensors come back empty, reported
    as one operation "K9_bwd"."""
    b, h, kv, s, t, dh, dv = _shapes(q, k, v, bq, bk)
    if q.is_meta:
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        meta_kernel("K9_bwd",
                    2 * (3 * dh + 2 * dv) * b * h * causal_pairs(s, t, causal),
                    (q, k, v, o, do, lse), grads)
        return grads
    if not q.is_cuda:
        return flash_backward_plain(q, k, v, o, do, lse, bq, bk, causal)
    dev = q.device
    check_kernel_device(q)
    _check_backward(dh, dv)
    check_tensor(q, "q", FLOAT_DTYPES, (b, h, s, dh), dev)
    check_tensor(k, "k", q.dtype, (b, kv, t, dh), dev)
    check_tensor(v, "v", q.dtype, (b, kv, t, dv), dev)
    check_tensor(o, "o", q.dtype, (b, h, s, dv), dev)
    check_tensor(do, "do", q.dtype, (b, h, s, dv), dev)
    check_tensor(lse, "lse", torch.float32, (b, h, s), dev)
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    scale = float(np.float32(dh ** -0.5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    # whole 16-byte chunks of a row go by one load; other head dims
    # element-wise
    per = 16 // q.element_size()
    vec = dh % per == 0 and dv % per == 0 and all(
        x.data_ptr() % 16 == 0 for x in (q, k, v, do))
    mla = dh > MAX_BWD_D
    if q.dtype == torch.bfloat16:
        lib, fn = (BF16_BWD_MLA_LIB, "flash_attention_bwd_bf16_mla") if mla \
            else (BF16_BWD_LIB, "flash_attention_bwd_bf16")
    else:
        lib, fn = (BWD_MLA_LIB, "flash_attention_bwd_f32_mla") if mla \
            else (BWD_LIB, "flash_attention_bwd_f32")
    err = getattr(lib.get(), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dvv.data_ptr(), b, h, kv, s, t, dh, dv, scale,
        int(causal), int(vec), stream)
    check_launch(fn, err)
    lib.launches += 1
    return dq, dk, dvv


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, do: torch.Tensor,
                         lse: torch.Tensor, bq: int = 64, bk: int = 64,
                         causal: bool = True):
    """Plain PyTorch version of :func:`flash_backward` (same arguments
    and result, the gradients in their inputs' dtypes), tiled as the
    kernel tiles: for each ``bk`` kv block, the ``bq`` query blocks from
    the causal frontier on, each pair's P recomputed from the lse, dk and
    dv summed over the pairs (and a kv head's query heads) in float32;
    dq summed over its kv blocks in order, scaled at the end."""
    b, h, kv, s, t, dh, dv = _shapes(q, k, v, bq, bk)
    g = h // kv
    dev = q.device
    scale = float(np.float32(dh ** -0.5))
    qs = q.reshape(b, kv, g, s, dh).float() * scale
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dof = do.reshape(b, kv, g, s, dv).float()
    lsef = lse.reshape(b, kv, g, s).float()
    delta = (dof * o.reshape(b, kv, g, s, dv).float()).sum(dim=-1)
    dq = torch.zeros((b, kv, g, s, dh), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, kv, t, dh), dtype=torch.float32, device=dev)
    dvv = torch.zeros((b, kv, t, dv), dtype=torch.float32, device=dev)
    rows = torch.arange(bq, device=dev)[:, None]
    cols = torch.arange(bk, device=dev)[None, :]
    for ki in range(t // bk):
        t0 = ki * bk
        kb = kf[:, :, :, t0:t0 + bk]
        vb = vf[:, :, :, t0:t0 + bk]
        for qi in range(t0 // bq if causal else 0, s // bq):
            q0 = qi * bq
            qb = qs[:, :, :, q0:q0 + bq]
            gb = dof[:, :, :, q0:q0 + bq]
            sc = torch.matmul(qb, kb.transpose(-1, -2))   # [B,KV,G,bq,bk]
            if causal:
                sc = torch.where(t0 + cols <= q0 + rows, sc, NEG)
            p = torch.exp(sc - lsef[:, :, :, q0:q0 + bq, None])
            dp = torch.matmul(gb, vb.transpose(-1, -2))
            ds = p * (dp - delta[:, :, :, q0:q0 + bq, None])
            dvv[:, :, t0:t0 + bk] += torch.matmul(
                p.transpose(-1, -2), gb).sum(dim=2)
            dk[:, :, t0:t0 + bk] += torch.matmul(
                ds.transpose(-1, -2), qb).sum(dim=2)
            dq[:, :, :, q0:q0 + bq] += torch.matmul(ds, kb)
    return ((dq * scale).reshape(b, h, s, dh).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))
