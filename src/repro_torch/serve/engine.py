"""Serving: prefill/decode step builders and a small batched engine — the
port of ``repro/serve/engine.py``.

The steps update the KV/SSM cache in place (the reference donates it to
its decode step).  The prefill runs K9 in every attention layer (GQA or
MLA) and K10 in every Mamba2 layer; a decode step runs neither (plain
torch over the cache, MLA in its absorbed form over the latent cache, as
the reference's decode is jnp).  Every arch but xLSTM is served, the
MoE archs (deepseek-v2, kimi-k2) included.  ``mesh``, ``data_axes`` and
``shard`` have no effect when serving on one card; the signatures keep
them.

One deliberate difference: temperature sampling draws from an explicit
``torch.Generator`` that advances with every step, where the reference
passes one ``key`` to every step and so draws each step with the same
randomness.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models import model as model_lib
from ..models.config import ModelConfig

__all__ = ["make_prefill_step", "make_decode_step", "ServeEngine"]


def make_prefill_step(cfg: ModelConfig, mesh=None, data_axes=("data",),
                      shard=model_lib._id_shard) -> Callable:
    def prefill_step(model, tokens, cache, extra_embeds=None,
                     positions=None):
        return model_lib.prefill(model, tokens, cache, cfg,
                                 extra_embeds=extra_embeds,
                                 positions=positions, mesh=mesh,
                                 data_axes=data_axes, shard=shard)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, data_axes=("data",),
                     shard=model_lib._id_shard) -> Callable:
    def decode_one(model, token, cache, pos):
        return model_lib.decode_step(model, token, cache, pos, cfg,
                                     mesh=mesh, data_axes=data_axes,
                                     shard=shard)
    return decode_one


class ServeEngine:
    """Minimal batched greedy/temperature serving loop (single card).

    Each generate() call prefills a batch and decodes until all sequences
    emit EOS or hit ``max_new``, under ``torch.inference_mode()``, on the
    model's device.
    """

    def __init__(self, model: model_lib.DecoderLM, cfg: ModelConfig, *,
                 max_len: int = 2048, temperature: float = 0.0,
                 eos_id: Optional[int] = None) -> None:
        self.model = model
        self.cfg = cfg
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)

    @torch.inference_mode()
    def generate(self, tokens: np.ndarray, max_new: int = 32,
                 generator: Optional[torch.Generator] = None
                 ) -> np.ndarray:
        """tokens [B, S] (or [B, S, nb]) -> the new tokens [B, n] (or
        [B, n, nb]) int32, n <= ``max_new``.  Sampling at a temperature
        > 0 draws from ``generator`` (on the model's device); without one
        the engine decodes greedily."""
        B, S = tokens.shape[:2]
        if S + max_new > self.max_len:
            raise ValueError(f"prompt {S} + max_new {max_new} exceeds "
                             f"max_len {self.max_len}")
        dev = self.model.device
        cache = model_lib.make_cache(self.cfg, B, self.max_len,
                                     concrete=True, device=dev)
        logits, cache = self._prefill(self.model,
                                      torch.as_tensor(tokens, device=dev),
                                      cache)
        tok = self._sample(logits, generator)
        out = [tok.cpu().numpy()]
        done = np.zeros(B, bool)
        for i in range(max_new - 1):
            logits, cache = self._decode(self.model, tok, cache, S + i)
            tok = self._sample(logits, generator)
            t = tok.cpu().numpy()
            if self.eos_id is not None:
                done |= (t.reshape(B, -1)[:, 0] == self.eos_id)
            out.append(t)
            if self.eos_id is not None and done.all():
                break
        return np.stack(out, axis=1).astype(np.int32)

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        cfg = self.cfg
        if cfg.num_codebooks > 1:
            logits = logits.reshape(logits.shape[0], cfg.num_codebooks,
                                    cfg.vocab_size)
        if self.temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        draw = torch.multinomial(flat, 1, generator=generator)
        return draw.reshape(probs.shape[:-1])
