"""The model zoo's serving path — the port of ``repro/models``: configs,
layers, GQA attention (prefill through K9), the GLA core and Mamba2
(prefill through K10), and the decoder with its caches.  MoE and MLA
(``moe``), mLSTM and sLSTM are later slices of the port."""

from .config import ModelConfig, segments
from . import layers, attention, ssm, model
from .model import (init, make_cache, forward, loss_fn, prefill, decode_step,
                    param_count, active_param_count)

__all__ = ["ModelConfig", "segments", "layers", "attention", "ssm",
           "model", "init", "make_cache", "forward", "loss_fn", "prefill",
           "decode_step", "param_count", "active_param_count"]
