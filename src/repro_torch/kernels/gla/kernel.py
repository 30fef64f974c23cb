"""K10: the chunked gated-linear-attention scan — the CUDA kernel, its
wrapper and its plain PyTorch version.

K10 (``repro/kernels/gla/kernel.py::_gla_kernel`` on the TPU) evaluates
the recurrence ``S_t = a_t S_{t-1} + k_t^T v_t``, ``o_t = q_t S_t`` per
(batch, head) chunk by chunk, the [dk, dv] state carried in float32.  With
``g`` the within-chunk inclusive cumsum of ``log_a`` and L the chunk
length, each chunk computes

    o_i = sum_{j <= i} (q_i . k_j) e^{g_i - g_j} v_j + e^{g_i} q_i S
    S  <- e^{g_L} S + sum_j (k_j e^{g_L - g_j})^T v_j

for q, k [B, H, S, dk] and v [B, H, S, dv] in float32 or bfloat16 (one
dtype for the three), returning o in v's dtype (or in float32 when the
caller asks: the partial outputs of ``ops.gla_blocked``) and the final
state [B, H, dk, dv] in float32.  The cumsum stays a torch op outside the
kernel, as the reference's ``jnp.cumsum`` sits outside its kernel.

* :func:`gla_chunks` is the wrapper: CUDA tensors launch ``csrc/gla.cu``
  (or raise), CPU tensors take :func:`gla_chunks_plain`.  dk and dv are
  at most MAX_HEAD_DIM; :func:`gla_wide` takes wider bfloat16 heads
  whole (mLSTM's 1024), and ``ops.gla_blocked`` cuts wider heads into
  blocks of that width (float32 on the card, and the CPU).
  ``LIB.launches`` counts the launches.  The kernel computes each
  (head, chunk) as a unit of its own and hands each chunk's state to the
  next chunk's unit inside the launch (a look-back through a float32
  scratch the wrapper allocates, [B H, S / chunk, dk, dv], and int32
  flags that the C entry zeroes on the stream before it launches).
* :func:`gla_chunks_plain` is the reference kernel's chunk loop, batched
  over (batch, head).  Its products go through ``torch.matmul``; the
  CUDA kernel's never do.
* :func:`gla_wide` is K10 for bfloat16 heads wider than MAX_HEAD_DIM:
  two launches of ``csrc/gla.cu`` (a chunk's scores P, float32, once;
  then a unit per (head, chunk, 128-wide block of v) that streams dk in
  slices, keeps o's block in float32 registers from the inter-chunk read
  to its one rounding, and hands S_c's block on by the same look-back).
  ``WIDE_LAUNCHES`` counts them (two a call).
* :func:`chunk_cumsum` is the within-chunk cumsum both take as ``g``.
* :func:`gla_meta` is what ``ops.gla_scan`` does with meta tensors:
  empty outputs, the call reported as one operation "K10" through
  ``common.meta_kernel`` with the undivided scan's work, whatever route
  the card would take.  When a gradient is asked for, ``ops.gla_scan``
  takes meta tensors through :class:`GlaChunks`, whose backward on meta
  is one operation "K10_bwd" of the undivided backward's work (the K10
  f32 backward's bound in ``PERF.md``: L (L + 1) (3 dk + 2 dv) + 8 L dk
  dv flops a (head, chunk)), with empty gradients of the inputs'
  shapes.

The backward (float32, dk and dv <= MAX_HEAD_DIM): when q, k, v or g
requires grad and grad mode is on, :func:`gla_chunks` on float32 inputs
goes through :class:`GlaChunks`, an ``autograd.Function``.  Its forward
keeps every chunk's state S_c [B, H, nc, dk, dv] (on the card the
look-back scratch the kernel writes anyway, its last slot filled with the
final state; on the CPU :func:`gla_chunks_plain`'s), and its backward is
:func:`gla_chunks_backward`: on CUDA ``csrc/gla_bwd.cu`` (three kernels
on the stream, counted as one launch by ``BWD_LIB.launches``), on the
CPU :func:`gla_chunks_backward_plain`.  With dS_c the gradient of S_c
(the final state's gradient for the last chunk, zero when none flows),
chunk c's rows take

    dq_t = sum_{s <= t} (do_t . v_s) e^{g_t - g_s} k_s + e^{g_t} do_t S_{c-1}^T
    dk_s = sum_{t >= s} (do_t . v_s) e^{g_t - g_s} q_t + e^{g_L - g_s} v_s dS_c^T
    dv_s = sum_{t >= s} (q_t . k_s) e^{g_t - g_s} do_t + e^{g_L - g_s} k_s dS_c
    dg_t = q_t . dq_t - k_t . dk_t   (+ <dS_c, S_c> at the chunk's last row)
    dS_{c-1} = e^{g_L} dS_c + sum_t e^{g_t} q_t^T do_t

and autograd takes dg back through :func:`chunk_cumsum` to log_a.  The
reference has no backward kernel (jax.grad differentiates its jnp
``gla_chunked``), so the backward replaces no TPU kernel.

bfloat16 (q, k, v and do in bf16; g, the states and dS in float32; dq,
dk, dv rounded once to bf16, dg float32): :class:`GlaChunks` takes bf16
inputs the same way, and on the card its backward launches
``csrc/gla_bf16_bwd.cu`` (``BF16_BWD_LIB``: four kernels, one launch of
the count), the float32 operands of its products in two bf16 parts on the
tensor cores.  :func:`gla_wide` with a gradient asked for goes through
:class:`GlaWide`: on the card the wide route's two launches, their
look-back scratch [B, H, nc, dk, ldv] kept as the chunk states, then
``csrc/gla_wide_bwd.cu`` (``WIDE_BWD_LIB``: six kernels, one launch of
the count), which forms each (head, chunk)'s P and A once and runs its
gradient units per 128-wide column block; on the CPU the plain forward
and backward, undivided.  A float32 o of bfloat16 inputs
(``ops.gla_blocked``'s partial outputs) has no backward on the card and
raises ``NotImplementedError`` there: no plain version runs on CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..common import (FLOAT_DTYPES, FLOAT_IO_HEADER, KernelLib,
                      check_float_dtypes, check_kernel_device,
                      check_launch, check_no_backward, check_tensor,
                      meta_kernel)

__all__ = ["gla_chunks", "gla_chunks_plain", "gla_wide", "gla_meta",
           "chunk_cumsum", "GlaChunks", "GlaWide", "gla_chunks_backward",
           "gla_wide_backward", "gla_chunks_backward_plain",
           "LIB", "BWD_LIB", "BF16_BWD_LIB", "WIDE_BWD_LIB", "MAX_HEAD_DIM",
           "WIDE_MAX_CHUNK"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_P = ctypes.c_void_p
_I = ctypes.c_int

#: Largest dk and dv the kernel takes.
MAX_HEAD_DIM = 128
#: Largest chunk :func:`gla_wide` takes (its value block stays in shared
#: memory beside double-buffered query slices).
WIDE_MAX_CHUNK = 256
#: Launches of the wide route's two kernels (two a :func:`gla_wide` call).
WIDE_LAUNCHES = 0

_ATTN_CSRC = os.path.join(os.path.dirname(os.path.dirname(_CSRC)),
                          "attention", "csrc")
_WGMMA_HEADER = os.path.join(_ATTN_CSRC, "wgmma.cuh")
TF32_SPLIT_HEADER = os.path.join(_ATTN_CSRC, "tf32_split.cuh")

LIB = KernelLib(
    "gla", os.path.join(_CSRC, "gla.cu"),
    headers=(FLOAT_IO_HEADER, _WGMMA_HEADER),
    signatures={"gla_scan_fwd": ([_P] * 8 + [_I] * 7 + [_P],
                                 ctypes.c_int),
                "gla_wide_fwd": ([_P] * 9 + [_I] * 6 + [_P],
                                 ctypes.c_int)})
#: The backward of K10 for float32 inputs, on the tensor cores as split
#: TF32.
BWD_LIB = KernelLib(
    "gla_bwd", os.path.join(_CSRC, "gla_bwd.cu"),
    headers=(FLOAT_IO_HEADER, _WGMMA_HEADER, TF32_SPLIT_HEADER),
    signatures={"gla_scan_bwd_f32": ([_P] * 13 + [_I] * 5 + [_P],
                                     ctypes.c_int)})
_BF16_TILE_HEADER = os.path.join(_ATTN_CSRC, "bf16_tile.cuh")
#: The pieces both bfloat16 backwards share.
BF16_BWD_HEADER = os.path.join(_CSRC, "gla_bf16_bwd.cuh")
_BF16_BWD_HEADERS = (FLOAT_IO_HEADER, _WGMMA_HEADER, _BF16_TILE_HEADER,
                     BF16_BWD_HEADER)
#: The backward of K10 for bfloat16 inputs at dk, dv <= MAX_HEAD_DIM.
BF16_BWD_LIB = KernelLib(
    "gla_bf16_bwd", os.path.join(_CSRC, "gla_bf16_bwd.cu"),
    headers=_BF16_BWD_HEADERS,
    signatures={"gla_scan_bwd_bf16": ([_P] * 13 + [_I] * 5 + [_P],
                                      ctypes.c_int)})
#: The backward of the wide route (:func:`gla_wide`), bfloat16.
WIDE_BWD_LIB = KernelLib(
    "gla_wide_bwd", os.path.join(_CSRC, "gla_wide_bwd.cu"),
    headers=_BF16_BWD_HEADERS,
    signatures={"gla_wide_bwd": ([_P] * 17 + [_I] * 6 + [_P],
                                 ctypes.c_int)})


def chunk_cumsum(log_a: torch.Tensor, chunk: int) -> torch.Tensor:
    """log_a [B, H, S] -> its inclusive cumsum within each chunk, float32
    [B, H, S]."""
    b, h, s = log_a.shape
    return torch.cumsum(log_a.reshape(b, h, s // chunk, chunk).float(),
                        dim=-1).reshape(b, h, s)


def _shapes(q, k, v, g, chunk: int):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or v.dim() != 4 \
            or tuple(v.shape[:3]) != tuple(q.shape[:3]) \
            or tuple(g.shape) != tuple(q.shape[:3]):
        raise ValueError(f"want q, k [B, H, S, dk], v [B, H, S, dv], g "
                         f"[B, H, S]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(g.shape)}")
    b, h, s, dk = q.shape
    if chunk < 1 or s % chunk:
        raise ValueError(f"pad S = {s} to a multiple of chunk = {chunk}")
    check_float_dtypes(q=q, k=k, v=v)
    return b, h, s, dk, v.shape[-1]


def _out_dtype(v: torch.Tensor, out_dtype) -> torch.dtype:
    if out_dtype not in (None, v.dtype, torch.float32):
        raise ValueError(f"o comes out in v's dtype or float32, not "
                         f"{out_dtype}")
    return v.dtype if out_dtype is None else out_dtype


def gla_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, chunk: int,
               out_dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: the chunked scan of q, k [B, H, S, dk], v [B, H, S, dv] with
    the within-chunk cumsum g [B, H, S] (float32) -> (o [B, H, S, dv] in
    ``out_dtype``: v's dtype when None, or float32; final state [B, H,
    dk, dv] float32).  CUDA tensors launch the kernel (dk, dv <=
    MAX_HEAD_DIM; a float32 o of bfloat16 inputs needs max(dk, dv) > 64,
    which runs ``gla_mma_kernel``); CPU tensors take the plain version.
    When a gradient is asked for (grad mode on, an input requiring grad),
    inputs whose o comes out in v's dtype go through :class:`GlaChunks`;
    a float32 o of bfloat16 CUDA inputs raises
    ``NotImplementedError``."""
    b, h, s, dk, dv = _shapes(q, k, v, g, chunk)
    odt = _out_dtype(v, out_dtype)
    if odt == v.dtype and _wants_grad(q, k, v, g):
        return GlaChunks.apply(q, k, v, g, chunk)
    if not q.is_cuda:
        return gla_chunks_plain(q, k, v, g, chunk, odt)
    check_no_backward("K10", q, k, v, g)
    return _launch_forward(q, k, v, g, chunk, odt)[:2]


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, chunk: int, odt: torch.dtype):
    """One launch of ``gla_scan_fwd`` -> (o, final state, the look-back
    scratch [B, H, nc, dk, dv]: S_c in slot c for every chunk but the
    last, whose slot the kernel leaves unwritten)."""
    b, h, s, dk, dv = q.shape + (v.shape[-1],)
    dev = q.device
    check_kernel_device(q)
    if max(dk, dv) > MAX_HEAD_DIM:
        raise ValueError(f"K10 takes dk, dv up to {MAX_HEAD_DIM}, got "
                         f"{dk}, {dv}")
    of32 = odt != v.dtype
    if of32 and max(dk, dv) <= 64:
        raise ValueError(f"a float32 o of bfloat16 inputs needs max(dk, "
                         f"dv) > 64 (gla_mma_kernel), got {dk}, {dv}")
    check_tensor(q, "q", FLOAT_DTYPES, (b, h, s, dk), dev)
    check_tensor(k, "k", q.dtype, (b, h, s, dk), dev)
    check_tensor(v, "v", q.dtype, (b, h, s, dv), dev)
    check_tensor(g, "g", torch.float32, (b, h, s), dev)
    o = torch.empty((b, h, s, dv), dtype=odt, device=dev)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    units = b * h * (s // chunk)
    scratch = torch.empty((b, h, s // chunk, dk, dv), dtype=torch.float32,
                          device=dev)
    sync = torch.empty((1 + units,), dtype=torch.int32, device=dev)
    err = LIB.get().gla_scan_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        o.data_ptr(), state.data_ptr(), scratch.data_ptr(), sync.data_ptr(),
        b * h, s, chunk, dk, dv,
        int(q.dtype == torch.bfloat16), int(of32),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("gla_scan_fwd", err)
    LIB.launches += 1
    return o, state, scratch


def gla_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             g: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 for bfloat16 heads of any width, taken whole: the arguments
    and results of :func:`gla_chunks`.  CUDA tensors launch the wide
    route's two kernels (bfloat16 only, chunk <= WIDE_MAX_CHUNK; v
    padded to a multiple of 8 columns when it is not one, so its rows are
    whole 16-byte chunks); CPU tensors take the plain version.  When a
    gradient is asked for, through :class:`GlaWide`."""
    _shapes(q, k, v, g, chunk)
    if _wants_grad(q, k, v, g):
        return GlaWide.apply(q, k, v, g, chunk)
    if not q.is_cuda:
        return gla_chunks_plain(q, k, v, g, chunk)
    return _launch_wide(q, k, v, g, chunk)[:2]


def _wide_ldv(dv: int) -> int:
    """The row stride of the wide route's padded v, do and chunk states."""
    return -(-dv // 8) * 8


def _launch_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, chunk: int):
    """The wide route's two launches -> (o, final state, the look-back
    scratch [B, H, nc, dk, ldv]: S_c in slot c for every chunk but the
    last, columns past dv unwritten)."""
    global WIDE_LAUNCHES
    b, h, s, dk, dv = _shapes(q, k, v, g, chunk)
    dev = q.device
    check_kernel_device(q)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the wide route takes bfloat16 inputs, got "
                         f"{q.dtype}")
    if chunk > WIDE_MAX_CHUNK:
        raise ValueError(f"the wide route takes chunks up to "
                         f"{WIDE_MAX_CHUNK}, got {chunk}")
    check_tensor(q, "q", torch.bfloat16, (b, h, s, dk), dev)
    check_tensor(k, "k", torch.bfloat16, (b, h, s, dk), dev)
    check_tensor(v, "v", torch.bfloat16, (b, h, s, dv), dev)
    check_tensor(g, "g", torch.float32, (b, h, s), dev)
    ldv = _wide_ldv(dv)
    vp = v if ldv == dv else torch.nn.functional.pad(v, (0, ldv - dv))
    nc, nt = s // chunk, -(-chunk // 64)
    o = torch.empty((b, h, s, dv), dtype=v.dtype, device=dev)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    scores = torch.empty((b * h * nc * nt * (nt + 1) // 2 * 64 * 64,),
                         dtype=torch.float32, device=dev)
    scratch = torch.empty((b, h, nc, dk, ldv), dtype=torch.float32,
                          device=dev)
    sync = torch.empty((1 + b * h * nc * -(-dv // 128),), dtype=torch.int32,
                       device=dev)
    err = LIB.get().gla_wide_fwd(
        q.data_ptr(), k.data_ptr(), vp.data_ptr(), g.data_ptr(),
        scores.data_ptr(), o.data_ptr(), state.data_ptr(),
        scratch.data_ptr(), sync.data_ptr(), b * h, s, chunk, dk, dv, ldv,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("gla_wide_fwd", err)
    WIDE_LAUNCHES += 2
    return o, state, scratch


def gla_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             g: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 on meta tensors (the arguments and results of
    :func:`gla_chunks`, o in v's dtype, any dk and dv): empty o and
    state, and one operation "K10" reported with the undivided scan's
    flops, a chunk's causal half of the scores and their products with
    v, 2 L (L + 1) / 2 (dk + dv), and its inter-chunk read and state
    update, 4 L dk dv."""
    b, h, s, dk, dv = _shapes(q, k, v, g, chunk)
    o = torch.empty((b, h, s, dv), dtype=v.dtype, device=q.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32,
                        device=q.device)
    flops = b * h * (s // chunk) * (chunk * (chunk + 1) * (dk + dv)
                                    + 4 * chunk * dk * dv)
    meta_kernel("K10", flops, (q, k, v, g), (o, state))
    return o, state


def gla_chunks_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor, chunk: int,
                     out_dtype: Optional[torch.dtype] = None,
                     with_states: bool = False):
    """Plain PyTorch version of :func:`gla_chunks` (same arguments and
    results, any head dims), on whatever device the tensors are on.  A
    float32 o is the float32 sum before its rounding to v's dtype.  With
    ``with_states``, (o, final state, states): states [B, H, nc, dk, dv]
    float32, S_c after each chunk c (the last the final state)."""
    b, h, s, dk, dv = _shapes(q, k, v, g, chunk)
    odt = _out_dtype(v, out_dtype)
    dev = q.device
    qf = q.reshape(b * h, s, dk)
    kf = k.reshape(b * h, s, dk)
    vf = v.reshape(b * h, s, dv)
    gf = g.reshape(b * h, s).float()
    idx = torch.arange(chunk, device=dev)
    causal = idx[:, None] >= idx[None, :]
    state = torch.zeros((b * h, dk, dv), dtype=torch.float32, device=dev)
    out = torch.empty((b * h, s, dv), dtype=odt, device=dev)
    states = []
    for c0 in range(0, s, chunk):
        qb = qf[:, c0:c0 + chunk].float()                 # [BH, L, dk]
        kb = kf[:, c0:c0 + chunk].float()
        vb = vf[:, c0:c0 + chunk].float()
        gb = gf[:, c0:c0 + chunk]                         # [BH, L]
        scores = torch.matmul(qb, kb.transpose(1, 2))
        decay = torch.exp(gb[:, :, None] - gb[:, None, :])
        scores = torch.where(causal, scores * decay, 0.0)
        o = torch.matmul(scores, vb)
        o = o + torch.exp(gb)[:, :, None] * torch.matmul(qb, state)
        out[:, c0:c0 + chunk] = o.to(odt)
        w = torch.exp(gb[:, -1:] - gb)                    # [BH, L]
        state = (torch.exp(gb[:, -1])[:, None, None] * state
                 + torch.matmul((kb * w[:, :, None]).transpose(1, 2), vb))
        if with_states:
            states.append(state)
    o, state = out.reshape(b, h, s, dv), state.reshape(b, h, dk, dv)
    if with_states:
        return o, state, torch.stack(states, dim=1).reshape(
            b, h, s // chunk, dk, dv)
    return o, state


def _meta_states(q, k, v, g, chunk):
    """Empty chunk states [B, H, nc, dk, dv] on meta, beside ``gla_meta``'s
    report of the forward."""
    b, h, s, dk, dv = _shapes(q, k, v, g, chunk)
    return torch.empty((b, h, s // chunk, dk, dv), dtype=torch.float32,
                       device=q.device)


class GlaChunks(torch.autograd.Function):
    """K10 with its backward, float32 or bfloat16: ``apply(q, k, v, g,
    chunk) -> (o in v's dtype, final state)``.  CUDA (dk, dv <=
    MAX_HEAD_DIM): the forward kernel, its chunk states kept, then the
    backward kernel of the dtype; CPU: the two plain versions; meta (any
    dtype and width): "K10" and "K10_bwd", one operation each.  The
    gradient of the final state is taken when one flows (None otherwise:
    zero)."""

    @staticmethod
    def forward(ctx, q, k, v, g, chunk: int):
        if q.is_meta:
            o, state = gla_meta(q, k, v, g, chunk)
            states = _meta_states(q, k, v, g, chunk)
        elif q.is_cuda:
            o, state, states = _launch_forward(q, k, v, g, chunk, v.dtype)
            states[:, :, -1] = state
        else:
            o, state, states = gla_chunks_plain(q, k, v, g, chunk,
                                                with_states=True)
        ctx.save_for_backward(q, k, v, g, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return o, state

    @staticmethod
    def backward(ctx, do, dstate):
        q, k, v, g, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
        dq, dk, dv, dg = gla_chunks_backward(
            q, k, v, g, states, do.contiguous(),
            None if dstate is None else dstate.contiguous(), ctx.chunk)
        return dq, dk, dv, dg, None


class GlaWide(torch.autograd.Function):
    """The wide route with its backward, bfloat16 heads of any width:
    ``apply(q, k, v, g, chunk) -> (o, final state)``.  CUDA: the wide
    route's two launches, their look-back scratch [B, H, nc, dk, ldv] kept
    as the chunk states (its last slot filled with the final state), then
    :func:`gla_wide_backward`'s kernel; CPU: :func:`gla_chunks_plain` and
    :func:`gla_chunks_backward_plain`, undivided; meta: "K10" and
    "K10_bwd", one operation each, as :class:`GlaChunks`."""

    @staticmethod
    def forward(ctx, q, k, v, g, chunk: int):
        if q.is_meta:
            o, state = gla_meta(q, k, v, g, chunk)
            states = _meta_states(q, k, v, g, chunk)
        elif q.is_cuda:
            o, state, states = _launch_wide(q, k, v, g, chunk)
            states[:, :, -1, :, :state.shape[-1]] = state
        else:
            o, state, states = gla_chunks_plain(q, k, v, g, chunk,
                                                with_states=True)
        ctx.save_for_backward(q, k, v, g, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return o, state

    @staticmethod
    def backward(ctx, do, dstate):
        q, k, v, g, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
        dq, dk, dv, dg = gla_wide_backward(
            q, k, v, g, states, do.contiguous(),
            None if dstate is None else dstate.contiguous(), ctx.chunk)
        return dq, dk, dv, dg, None


def _backward_meta(q, k, v, g, states, do, dstate, chunk):
    """The backward on meta tensors: empty gradients, reported as one
    operation "K10_bwd" of the undivided backward's work."""
    b, h, s, dk, dv = _shapes(q, k, v, g, chunk)
    grads = tuple(torch.empty_like(x) for x in (q, k, v, g))
    flops = b * h * (s // chunk) * (
        chunk * (chunk + 1) * (3 * dk + 2 * dv) + 8 * chunk * dk * dv)
    meta_kernel("K10_bwd", flops,
                tuple(t for t in (q, k, v, g, states, do, dstate)
                      if t is not None), grads)
    return grads


def gla_chunks_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, states: torch.Tensor,
                        do: torch.Tensor, dstate: Optional[torch.Tensor],
                        chunk: int):
    """The gradients (dq, dk, dv, dg) of K10 at q, k, v (float32, or
    bfloat16 with do in bfloat16) and g, given the forward's chunk states
    [B, H, nc, dk, dv] (S_c after chunk c), o's gradient do [B, H, S, dv]
    and the final state's gradient dstate [B, H, dk, dv] (None: zero).
    dq, dk, dv come back in the inputs' dtype, dg in float32.  CUDA
    tensors (dk, dv <= MAX_HEAD_DIM) launch the backward kernel of the
    dtype (``BWD_LIB`` for float32, ``BF16_BWD_LIB`` for bfloat16, each
    counted as one launch); CPU tensors take
    :func:`gla_chunks_backward_plain`; meta tensors come back empty,
    reported as one operation "K10_bwd"."""
    b, h, s, dk, dv = _shapes(q, k, v, g, chunk)
    if q.is_meta:
        return _backward_meta(q, k, v, g, states, do, dstate, chunk)
    if not q.is_cuda:
        return gla_chunks_backward_plain(q, k, v, g, states, do, dstate,
                                         chunk)
    dev = q.device
    check_kernel_device(q)
    if max(dk, dv) > MAX_HEAD_DIM:
        raise ValueError(f"K10's backward takes dk, dv up to "
                         f"{MAX_HEAD_DIM}, got {dk}, {dv}")
    nc = s // chunk
    dt = q.dtype
    for t, name, shape, want in (
            (q, "q", (b, h, s, dk), dt), (k, "k", (b, h, s, dk), dt),
            (v, "v", (b, h, s, dv), dt), (g, "g", (b, h, s), torch.float32),
            (states, "states", (b, h, nc, dk, dv), torch.float32),
            (do, "do", (b, h, s, dv), dt)):
        check_tensor(t, name, want, shape, dev)
    if dstate is not None:
        check_tensor(dstate, "dstate", torch.float32, (b, h, dk, dv), dev)
    dq, dk_, dv_ = (torch.empty_like(x) for x in (q, k, v))
    dg = torch.empty_like(g)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.bfloat16:
        # dS_c, a chunk each, and <dS_c, S_c> a (head, chunk, state tile)
        d = 64 if max(dk, dv) <= 64 else 128
        ds = torch.empty_like(states)
        red = torch.empty((b * h * nc * -(-dk // 64) * -(-dv // d),),
                          dtype=torch.float32, device=dev)
        err = BF16_BWD_LIB.get().gla_scan_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            states.data_ptr(), do.data_ptr(),
            None if dstate is None else dstate.data_ptr(), ds.data_ptr(),
            red.data_ptr(), dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(),
            dg.data_ptr(), b * h, s, chunk, dk, dv, stream)
        check_launch("gla_scan_bwd_bf16", err)
        BF16_BWD_LIB.launches += 1
        return dq, dk_, dv_, dg
    # U_c = sum_t e^{g_t} q_t^T do_t, then dS_c, a chunk each, and dS_c
    # transposed
    u = torch.empty_like(states)
    ds = torch.empty((2,) + tuple(states.shape), dtype=torch.float32,
                     device=dev)
    err = BWD_LIB.get().gla_scan_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        states.data_ptr(), do.data_ptr(),
        None if dstate is None else dstate.data_ptr(), u.data_ptr(),
        ds.data_ptr(), dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(),
        dg.data_ptr(), b * h, s, chunk, dk, dv, stream)
    check_launch("gla_scan_bwd_f32", err)
    BWD_LIB.launches += 1
    return dq, dk_, dv_, dg


def gla_wide_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor, states: torch.Tensor,
                      do: torch.Tensor, dstate: Optional[torch.Tensor],
                      chunk: int):
    """The gradients (dq, dk, dv in bfloat16, dg in float32) of the wide
    route at bfloat16 q, k, v of any width, given :func:`_launch_wide`'s
    chunk states [B, H, nc, dk, ldv] (S_c after chunk c in its first dv
    columns, ldv = dv rounded up to a multiple of 8), do [B, H, S, dv]
    bfloat16 and dstate [B, H, dk, dv] float32 (None: zero).  CUDA tensors
    launch ``WIDE_BWD_LIB`` (six kernels, counted as one launch); CPU
    tensors (states [B, H, nc, dk, dv]) take
    :func:`gla_chunks_backward_plain`, undivided; meta tensors come back
    empty, reported as one operation "K10_bwd"."""
    b, h, s, dk, dv = _shapes(q, k, v, g, chunk)
    if q.is_meta:
        return _backward_meta(q, k, v, g, states, do, dstate, chunk)
    if not q.is_cuda:
        return gla_chunks_backward_plain(q, k, v, g, states, do, dstate,
                                         chunk)
    dev = q.device
    check_kernel_device(q)
    ldv = _wide_ldv(dv)
    nc, nt = s // chunk, -(-chunk // 64)
    for t, name, shape, want in (
            (q, "q", (b, h, s, dk), torch.bfloat16),
            (k, "k", (b, h, s, dk), torch.bfloat16),
            (v, "v", (b, h, s, dv), torch.bfloat16),
            (g, "g", (b, h, s), torch.float32),
            (states, "states", (b, h, nc, dk, ldv), torch.float32),
            (do, "do", (b, h, s, dv), torch.bfloat16)):
        check_tensor(t, name, want, shape, dev)
    if dstate is not None:
        check_tensor(dstate, "dstate", torch.float32, (b, h, dk, dv), dev)
    pad = (lambda x: x) if ldv == dv else (
        lambda x: torch.nn.functional.pad(x, (0, ldv - dv)))
    vp, dop = pad(v), pad(do)
    dq, dk_ = torch.empty_like(q), torch.empty_like(k)
    dv_ = torch.empty_like(v)
    dg = torch.empty_like(g)
    ds = torch.empty_like(states)
    red = torch.empty((b * h * nc * -(-dk // 64) * -(-dv // 128),),
                      dtype=torch.float32, device=dev)
    tiles = b * h * nc * nt * (nt + 1) // 2 * 64 * 64
    p = torch.empty((2, tiles), dtype=torch.float32, device=dev)
    dgp = torch.empty((2, b * h * s * -(-dk // 128)), dtype=torch.float32,
                      device=dev)
    err = WIDE_BWD_LIB.get().gla_wide_bwd(
        q.data_ptr(), k.data_ptr(), vp.data_ptr(), g.data_ptr(),
        states.data_ptr(), dop.data_ptr(),
        None if dstate is None else dstate.data_ptr(), ds.data_ptr(),
        red.data_ptr(), p[0].data_ptr(), p[1].data_ptr(), dgp[0].data_ptr(),
        dgp[1].data_ptr(), dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(),
        dg.data_ptr(), b * h, s, chunk, dk, dv, ldv,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("gla_wide_bwd", err)
    WIDE_BWD_LIB.launches += 1
    return dq, dk_, dv_, dg


def gla_chunks_backward_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor,
                              states: torch.Tensor, do: torch.Tensor,
                              dstate: Optional[torch.Tensor], chunk: int):
    """Plain PyTorch version of :func:`gla_chunks_backward` (same
    arguments and results, any head dims), on whatever device the tensors
    are on: the chunks in reverse order, dS carried in float32, each
    chunk's gradients from the formulas of the module docstring in the
    kernel's order of operations (the intra-chunk sum, then the decayed
    state term; dg as q . dq - k . dk)."""
    b, h, s, dk, dv = _shapes(q, k, v, g, chunk)
    nc = s // chunk
    bh = b * h
    dev = q.device
    qf = q.reshape(bh, s, dk).float()
    kf = k.reshape(bh, s, dk).float()
    vf = v.reshape(bh, s, dv).float()
    gf = g.reshape(bh, s).float()
    dof = do.reshape(bh, s, dv).float()
    st = states.reshape(bh, nc, dk, dv).float()
    ds = (torch.zeros((bh, dk, dv), dtype=torch.float32, device=dev)
          if dstate is None else dstate.reshape(bh, dk, dv).float())
    idx = torch.arange(chunk, device=dev)
    causal = idx[:, None] >= idx[None, :]
    dq = torch.empty((bh, s, dk), dtype=torch.float32, device=dev)
    dkk = torch.empty((bh, s, dk), dtype=torch.float32, device=dev)
    dvv = torch.empty((bh, s, dv), dtype=torch.float32, device=dev)
    dg = torch.empty((bh, s), dtype=torch.float32, device=dev)
    for c in reversed(range(nc)):
        c0 = c * chunk
        sl = slice(c0, c0 + chunk)
        qb, kb, vb, gb, gob = qf[:, sl], kf[:, sl], vf[:, sl], gf[:, sl], \
            dof[:, sl]
        prev = st[:, c - 1] if c > 0 else torch.zeros_like(ds)
        decay = torch.exp(gb[:, :, None] - gb[:, None, :])
        a = torch.where(causal, torch.matmul(gob, vb.transpose(1, 2))
                        * decay, 0.0)                      # [BH, t, s]
        p = torch.where(causal, torch.matmul(qb, kb.transpose(1, 2))
                        * decay, 0.0)
        eg = torch.exp(gb)
        w = torch.exp(gb[:, -1:] - gb)
        dqb = torch.matmul(a, kb) + eg[:, :, None] * torch.matmul(
            gob, prev.transpose(1, 2))
        dkb = torch.matmul(a.transpose(1, 2), qb) + w[:, :, None] * \
            torch.matmul(vb, ds.transpose(1, 2))
        dvb = torch.matmul(p.transpose(1, 2), gob) + w[:, :, None] * \
            torch.matmul(kb, ds)
        dgb = (qb * dqb).sum(dim=-1) - (kb * dkb).sum(dim=-1)
        dgb[:, -1] = dgb[:, -1] + (ds * st[:, c]).sum(dim=(1, 2))
        dq[:, sl], dkk[:, sl], dvv[:, sl], dg[:, sl] = dqb, dkb, dvb, dgb
        ds = (torch.exp(gb[:, -1])[:, None, None] * ds
              + torch.matmul((qb * eg[:, :, None]).transpose(1, 2), gob))
    return (dq.reshape(b, h, s, dk).to(q.dtype),
            dkk.reshape(b, h, s, dk).to(k.dtype),
            dvv.reshape(b, h, s, dv).to(v.dtype), dg.reshape(b, h, s))
