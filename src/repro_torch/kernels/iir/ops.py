"""The public API of the batched IIR kernel K8 — the port of
``repro/kernels/iir/ops.py``.  The reference's ``interpret`` argument
becomes ``device``: CUDA unless the caller passes ``device="cpu"``, which
runs K8's plain version."""

from __future__ import annotations

from typing import Union

import torch

from ..common import as_tensor, resolve_device
from .kernel import coeffs, iir_filter

__all__ = ["lfilter_batched"]


def lfilter_batched(b, a, x, device: Union[str, torch.device, None] = None
                    ) -> torch.Tensor:
    """Filter a batch of series [B, T] along time (normalizes by a[0] in
    float64, then runs in float32) -> y [B, T] float32.  One K8 launch."""
    dev = resolve_device(device)
    bt, at = coeffs(b, a, dev)
    return iir_filter(bt, at, as_tensor(x, torch.float32, dev))
