"""The public API of the sLSTM scan: a state dict in and out, float32
zeros where the caller has none (``m`` included, as the reference starts
its stabilizer at 0), and ``device`` (CUDA unless the caller passes
``device="cpu"``, which runs the plain version)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..common import as_float_tensor, as_tensor, resolve_device
from .kernel import slstm_scan

__all__ = ["slstm"]


def slstm(zifo, r, state: Optional[Dict] = None, *,
          device: Union[str, torch.device, None] = None
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """zifo [B, S, 4D] (a float32 or bfloat16 tensor, or a numpy array:
    float32), r [4, D] (cast to float32) and ``state`` {"h", "c", "n",
    "m"} [B, D] (zeros when None) -> (hs [B, S, D] in zifo's dtype, the
    final state {"h", "c", "n", "m"} float32).  One kernel launch."""
    dev = resolve_device(device)
    zifo = as_float_tensor(zifo, dev)
    r = as_tensor(r, torch.float32, dev)
    b, d = zifo.shape[0], zifo.shape[-1] // 4
    if state is None:
        state = {}
    hcnm = [as_tensor(state[k], torch.float32, dev) if k in state
            else torch.zeros((b, d), dtype=torch.float32, device=dev)
            for k in "hcnm"]
    hs, out = slstm_scan(zifo, r, *hcnm)
    return hs, dict(zip("hcnm", out))
