"""The public API of the flash-attention kernel K9 — the port of
``repro/kernels/attention/ops.py``.  The reference's ``interpret``
argument becomes ``device``: CUDA unless the caller passes
``device="cpu"``, which runs K9's plain version."""

from __future__ import annotations

from typing import Union

import torch

from ..common import as_float_tensor, resolve_device
from .kernel import flash_forward

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, bq: int = 128, bk: int = 128,
                    causal: bool = True,
                    device: Union[str, torch.device, None] = None
                    ) -> torch.Tensor:
    """q [B, H, S, dh], k [B, KV, T, dh], v [B, KV, T, dv] (tensors or
    numpy arrays; float32 or bfloat16 tensors, one dtype for the three)
    -> o [B, H, S, dv] in q's dtype.  S and T must be multiples of bq and
    bk; H of KV.  One K9 launch."""
    dev = resolve_device(device)
    q, k, v = (as_float_tensor(t, dev) for t in (q, k, v))
    return flash_forward(q, k, v, bq=bq, bk=bk, causal=causal)
