"""The public API of the GLA chunked-scan kernel K10 — the port of
``repro/kernels/gla/ops.py``.  The reference's ``interpret`` argument
becomes ``device``: CUDA unless the caller passes ``device="cpu"``, which
runs K10's plain version."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..common import as_float_tensor, as_tensor, resolve_device
from .kernel import chunk_cumsum, gla_chunks

__all__ = ["gla_scan"]


def gla_scan(q, k, v, log_a, *, chunk: int = 128,
             device: Union[str, torch.device, None] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k [B, H, S, dk], v [B, H, S, dv] (tensors or numpy arrays;
    float32 or bfloat16 tensors, one dtype for the three), log_a [B, H, S]
    (<= 0) -> (o [B, H, S, dv] in v's dtype, final state [B, H, dk, dv]
    float32).  S must be a multiple of ``chunk``.  One K10 launch, after
    the within-chunk cumsum of log_a."""
    dev = resolve_device(device)
    q, k, v = (as_float_tensor(t, dev) for t in (q, k, v))
    la = as_tensor(log_a, torch.float32, dev)
    if la.dim() != 3 or la.shape[-1] % chunk:
        raise ValueError(f"log_a: want [B, H, S] with S a multiple of "
                         f"chunk = {chunk}, got {tuple(la.shape)}")
    return gla_chunks(q, k, v, chunk_cumsum(la, chunk), chunk)
