"""K8: batched IIR filtering (direct form II transposed) — the CUDA
kernel, its wrapper and its plain PyTorch version.

K8 (``repro/kernels/iir/kernel.py::_iir_kernel`` on the TPU) filters a
batch of series ``x [B, T]`` along time with one filter ``(b, a)``,
``a[0] = 1``, carrying the ``[B, order]`` filter state through the time
loop: the paper's Chebyshev de-noise over every series of a reference DB.

* :func:`iir_filter` is the wrapper: CUDA tensors launch ``csrc/iir.cu``
  (or raise), CPU tensors take :func:`iir_filter_plain`.
  ``LIB.launches`` counts the launches.
* :func:`iir_filter_plain` is :func:`df2t` from the zero state.
* :func:`df2t` is the recurrence with a carried state.  It is also the
  host filter of ``core.filters`` (``lfilter``, ``filtfilt``,
  ``StreamingFilter``): one copy serves both.
* :func:`coeffs` normalises ``(b, a)`` by ``a[0]`` in float64 and rounds
  them to float32, as the reference's ``ops.py`` does.

The order-6 filter is ill-conditioned in float32 (one rounding moves
outputs by ~1e-3), so the two steps that the reference's compiled
recurrence contracts into fused multiply-adds are fused here too, and
the kernel fuses exactly those two (the library is built with
``-fmad=false``).  :func:`_fma` rounds ``p * q + r`` from float64, a
double rounding that can differ from the kernel's single-rounding
``__fmaf_rn`` in rare halfway cases; elsewhere the two agree bitwise.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np
import torch

from ..common import (KernelLib, check_kernel_device, check_launch,
                      check_tensor)

__all__ = ["iir_filter", "iir_filter_plain", "df2t", "coeffs", "LIB",
           "MAX_ORDER"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_P = ctypes.c_void_p
_I = ctypes.c_int

#: Largest filter order the kernel is instantiated for.
MAX_ORDER = 8

LIB = KernelLib(
    "iir", os.path.join(_CSRC, "iir.cu"),
    signatures={"iir_filter": ([_P] * 4 + [_I] * 3 + [_P], ctypes.c_int)})


def coeffs(b, a, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, a) normalized by a[0] in float64, then rounded to float32, on
    ``device``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64) / a[0]
    return (torch.tensor(b, dtype=torch.float32, device=device),
            torch.tensor(a / a[0], dtype=torch.float32, device=device))


def _fma(p: torch.Tensor, q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``p * q + r`` rounded once to float32 (a fused multiply-add): the
    float32 product is exact in float64."""
    return (p.double() * q.double() + r.double()).float()


def df2t(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
         z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-form-II-transposed pass over the last axis of x [B, T] from
    state z [B, n-1] -> (y [B, T], final state), every tensor on x's
    device.

    The reference's compiled recurrence contracts ``b0 x + z0`` and
    ``b x - a y`` into fused multiply-adds, and this order-6 filter is
    ill-conditioned in float32 (one rounding moves outputs by ~1e-3), so
    the same two steps are fused here: the two packages filter alike."""
    b0, bk, ak = b[0], b[1:][None, :], a[1:][None, :]
    ys = []
    for t in range(x.shape[-1]):
        xt = x[:, t]
        yt = _fma(b0.expand_as(xt), xt, z[:, 0])
        # z_i <- b_{i+1} x - a_{i+1} y + z_{i+1}
        xb = xt[:, None].expand_as(z)
        z = (_fma(bk.expand_as(z), xb, -(ak * yt[:, None]))
             + torch.nn.functional.pad(z[:, 1:], (0, 1)))
        ys.append(yt)
    y = torch.stack(ys, dim=-1) if ys else x.clone()
    return y, z


def _check_shapes(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor) -> int:
    if x.dim() != 2:
        raise ValueError(f"x: want [B, T], got shape {tuple(x.shape)}")
    order = b.shape[0] - 1
    if b.dim() != 1 or tuple(a.shape) != tuple(b.shape) or order < 1:
        raise ValueError(f"b, a: want two [order + 1] vectors, order >= 1; "
                         f"got {tuple(b.shape)} and {tuple(a.shape)}")
    return order


def iir_filter(b: torch.Tensor, a: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """K8: filter every row of x [B, T] (float32) with (b, a) [order + 1]
    (float32, a[0] = 1) from the zero state -> y [B, T] float32.  CUDA
    tensors launch the kernel (orders 1 to MAX_ORDER); CPU tensors take
    the plain version."""
    order = _check_shapes(b, a, x)
    if not x.is_cuda:
        return iir_filter_plain(b, a, x)
    dev = x.device
    check_kernel_device(x)
    if order > MAX_ORDER:
        raise ValueError(f"K8 takes orders 1 to {MAX_ORDER}, got {order}")
    bsz, t = x.shape
    check_tensor(x, "x", torch.float32, (bsz, t), dev)
    check_tensor(b, "b", torch.float32, (order + 1,), dev)
    check_tensor(a, "a", torch.float32, (order + 1,), dev)
    y = torch.empty_like(x)
    err = LIB.get().iir_filter(
        b.data_ptr(), a.data_ptr(), x.data_ptr(), y.data_ptr(), bsz, t,
        order, torch.cuda.current_stream(dev).cuda_stream)
    check_launch("iir_filter", err)
    LIB.launches += 1
    return y


def iir_filter_plain(b: torch.Tensor, a: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`iir_filter` (same arguments and
    result), on whatever device the tensors are on."""
    order = _check_shapes(b, a, x)
    z0 = torch.zeros((x.shape[0], order), dtype=torch.float32,
                     device=x.device)
    return df2t(b, a, x, z0)[0]
