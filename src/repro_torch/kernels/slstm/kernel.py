"""The sLSTM scan — the CUDA kernel, its wrapper and its plain PyTorch
version.

Not a port of a TPU kernel: the reference runs sLSTM's recurrence as jnp
(``repro/models/ssm.py:301-369``: ``_slstm_cell`` under ``jax.lax.scan``
in ``slstm_apply``), which XLA compiles into one device loop.  Eager
PyTorch has no such loop, so the port gives the scan a kernel, as it gave
K2 pairs one.

Per channel (b, d), with zifo [B, S, 4D] the input projection's z, i, f,
o pre-activations (in x's dtype), r [4, D] and the state (h, c, n, m)
[B, D] in float32, step t computes::

    z = z_t + r0 h,  i = i_t + r1 h,  f = f_t + r2 h,  o = o_t + r3 h
    m' = max(f + m, i),  ig = e^(i - m'),  fg = e^((f + m) - m')
    c = fg c + ig tanh(z),  n = fg n + ig
    h = (sigmoid(o) c) / max(n, 1),  sigmoid(o) = 1 / (1 + e^-o)

and emits h_t, cast to zifo's dtype; the final state stays float32.

* :func:`slstm_scan` is the wrapper: CUDA tensors launch ``csrc/slstm.cu``
  (or raise), CPU tensors take :func:`slstm_scan_plain`.
  ``LIB.launches`` counts the launches.  The kernel runs a thread a
  channel; a block of 64 channels stages its gates in shared memory 16
  steps at a time by ``cp.async`` when it can (the schedule is emulated
  in ``tests/test_torch_slstm.py``), else reads them from global memory.
* Meta tensors take neither: empty outputs, and the call reported as
  one operation "sLSTM" through ``common.meta_kernel``, OPS_PER_STEP
  operations a channel a step.
* :func:`slstm_scan_plain` loops :func:`slstm_step_plain` over S in
  plain torch, with the kernel's operations in the kernel's order
  (sigmoid as the reciprocal of 1 + e^-o, IEEE division), so on the card
  the two can agree bitwise.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from ..common import (FLOAT_DTYPES, FLOAT_IO_HEADER, KernelLib,
                      check_kernel_device, check_launch, check_no_backward,
                      check_tensor, meta_kernel)

__all__ = ["slstm_scan", "slstm_scan_plain", "slstm_step_plain", "LIB",
           "OPS_PER_STEP"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_P = ctypes.c_void_p
_I = ctypes.c_int

LIB = KernelLib(
    "slstm", os.path.join(_CSRC, "slstm.cu"), headers=(FLOAT_IO_HEADER,),
    signatures={"slstm_scan_fwd": ([_P] * 11 + [_I] * 4 + [_P],
                                   ctypes.c_int)})

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: float32 operations a channel a step of :func:`slstm_step_plain` (8
#: multiplies, 10 adds and subtracts, a negation, 2 max, 3 exp, a tanh,
#: 2 divisions), each counted as one.
OPS_PER_STEP = 27


def _shapes(zifo: torch.Tensor, r: torch.Tensor, state: State):
    if zifo.dim() != 3 or zifo.shape[-1] % 4:
        raise ValueError(f"zifo: want [B, S, 4D], got {tuple(zifo.shape)}")
    b, s, d4 = zifo.shape
    d = d4 // 4
    if zifo.dtype not in FLOAT_DTYPES:
        raise ValueError(f"zifo: want one of {FLOAT_DTYPES}, got "
                         f"{zifo.dtype}")
    if tuple(r.shape) != (4, d) or r.dtype != torch.float32:
        raise ValueError(f"r: want float32 (4, {d}), got {r.dtype} "
                         f"{tuple(r.shape)}")
    for name, t in zip("hcnm", state):
        if tuple(t.shape) != (b, d) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 ({b}, {d}), got "
                             f"{t.dtype} {tuple(t.shape)}")
    return b, s, d


def slstm_scan(zifo: torch.Tensor, r: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor, n: torch.Tensor, m: torch.Tensor
               ) -> Tuple[torch.Tensor, State]:
    """The sLSTM scan of zifo [B, S, 4D] (float32 or bfloat16) with r [4,
    D] and the state h, c, n, m [B, D] (float32) -> (hs [B, S, D] in
    zifo's dtype, the final (h, c, n, m) float32).  CUDA tensors launch
    the kernel (one launch); CPU tensors take the plain version; meta
    tensors come back empty, reported as one operation."""
    b, s, d = _shapes(zifo, r, (h, c, n, m))
    if zifo.is_meta:
        hs = torch.empty((b, s, d), dtype=zifo.dtype, device=zifo.device)
        out = tuple(torch.empty((b, d), dtype=torch.float32,
                                device=zifo.device) for _ in range(4))
        meta_kernel("sLSTM", OPS_PER_STEP * b * s * d, (zifo, r, h, c, n, m),
                    (hs,) + out)
        return hs, out
    if not zifo.is_cuda:
        return slstm_scan_plain(zifo, r, h, c, n, m)
    check_no_backward("the sLSTM scan", zifo, r, h, c, n, m)
    dev = zifo.device
    check_kernel_device(zifo)
    check_tensor(zifo, "zifo", FLOAT_DTYPES, (b, s, 4 * d), dev)
    check_tensor(r, "r", torch.float32, (4, d), dev)
    for name, t in zip("hcnm", (h, c, n, m)):
        check_tensor(t, name, torch.float32, (b, d), dev)
    hs = torch.empty((b, s, d), dtype=zifo.dtype, device=dev)
    out = tuple(torch.empty((b, d), dtype=torch.float32, device=dev)
                for _ in range(4))
    err = LIB.get().slstm_scan_fwd(
        zifo.data_ptr(), r.data_ptr(), h.data_ptr(), c.data_ptr(),
        n.data_ptr(), m.data_ptr(), hs.data_ptr(),
        *(t.data_ptr() for t in out), b, s, d,
        int(zifo.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("slstm_scan_fwd", err)
    LIB.launches += 1
    return hs, out


def slstm_scan_plain(zifo: torch.Tensor, r: torch.Tensor, h: torch.Tensor,
                     c: torch.Tensor, n: torch.Tensor, m: torch.Tensor
                     ) -> Tuple[torch.Tensor, State]:
    """Plain PyTorch version of :func:`slstm_scan` (same arguments and
    results), on whatever device the tensors are on: the reference's
    ``_slstm_cell`` looped over S."""
    b, s, d = _shapes(zifo, r, (h, c, n, m))
    hs = torch.empty((b, s, d), dtype=zifo.dtype, device=zifo.device)
    for t in range(s):
        h, c, n, m = slstm_step_plain(zifo[:, t].float().split(d, dim=-1),
                                      r, h, c, n, m)
        hs[:, t] = h.to(zifo.dtype)
    return hs, (h, c, n, m)


def slstm_step_plain(gates, r: torch.Tensor, h: torch.Tensor,
                     c: torch.Tensor, n: torch.Tensor, m: torch.Tensor
                     ) -> State:
    """One step of the scan on float32 tensors: gates (z_t, i_t, f_t,
    o_t) and r (r0, r1, r2, r3) of one shape [..., D'], the state (h, c,
    n, m) -> the next state.  Every operation is element-wise, so a
    subset of the channels steps bitwise as the whole does."""
    zt, it, ft, ot = gates
    r0, r1, r2, r3 = r
    z = zt + r0 * h
    i = it + r1 * h
    f = ft + r2 * h
    o = ot + r3 * h
    fm = f + m
    m = torch.maximum(fm, i)
    ig = torch.exp(i - m)
    fg = torch.exp(fm - m)
    c = fg * c + ig * torch.tanh(z)
    n = fg * n + ig
    sg = torch.reciprocal(1.0 + torch.exp(-o))
    h = (sg * c) / torch.clamp(n, min=1.0)
    return h, c, n, m
