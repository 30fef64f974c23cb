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
  enters the PV product as two bfloat16 parts, P_hi + P_lo); float32
  inputs ``csrc/flash_tf32.cu``, every operand split into two TF32
  parts and each product taken as three TF32 products (one would keep
  too few digits for the float32 tolerance).  CPU tensors take
  :func:`flash_forward_plain`.  ``BF16_LIB.launches`` and
  ``LIB.launches`` count the two kernels' launches.
* :func:`flash_forward_plain` is the reference kernel's block loop: for
  each ``bq`` query block, an online softmax over the ``bk`` kv blocks up
  to the causal frontier, in float32.  Its products go through
  ``torch.matmul``; the CUDA kernels' never do.

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
                      check_launch, check_tensor)

__all__ = ["flash_forward", "flash_forward_plain", "LIB", "BF16_LIB",
           "MAX_DH", "MAX_DV"]

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

_WGMMA_HEADER = os.path.join(_CSRC, "wgmma.cuh")
#: K9 for float32 inputs, on the tensor cores as split TF32.
LIB = KernelLib(
    "flash_tf32", os.path.join(_CSRC, "flash_tf32.cu"),
    headers=(FLOAT_IO_HEADER, _WGMMA_HEADER),
    signatures={"flash_attention_fwd_tf32": (
        [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I, _I, _P], ctypes.c_int)})
#: K9 for bfloat16 inputs, on the tensor cores.
BF16_LIB = KernelLib(
    "flash_wgmma", os.path.join(_CSRC, "flash_wgmma.cu"),
    headers=(FLOAT_IO_HEADER, _WGMMA_HEADER),
    signatures={"flash_attention_fwd_bf16": (
        [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I, _I, _P], ctypes.c_int)})


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
    version."""
    b, h, kv, s, t, dh, dv = _shapes(q, k, v, bq, bk)
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, bq, bk, causal)
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
    lib = BF16_LIB if q.dtype == torch.bfloat16 else LIB
    fn = "flash_attention_fwd_bf16" if lib is BF16_LIB \
        else "flash_attention_fwd_tf32"
    err = getattr(lib.get(), fn)(*ptrs, b, h, kv, s, t, dh, dv, scale,
                                 int(causal), int(vec), stream)
    check_launch(fn, err)
    lib.launches += 1
    return o


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bq: int = 128, bk: int = 128,
                        causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_forward` (same arguments and
    result), on whatever device the tensors are on."""
    b, h, kv, s, t, dh, dv = _shapes(q, k, v, bq, bk)
    g = h // kv
    dev = q.device
    scale = float(np.float32(dh ** -0.5))
    qg = q.reshape(b, kv, g, s, dh).float() * scale   # [B, KV, G, S, dh]
    kf = k.float()[:, :, None]                          # [B, KV, 1, T, dh]
    vf = v.float()[:, :, None]
    out = torch.empty((b, kv, g, s, dv), dtype=torch.float32, device=dev)
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
        out[:, :, :, q0:q0 + bq] = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, h, s, dv).to(q.dtype)
