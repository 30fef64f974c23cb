"""GQA attention (RoPE / M-RoPE) with a KV-cache decode path — the port of
the GQA part of ``repro/models/attention.py`` (lines 28-184).

The route to K9: a call with S > 1 from position 0 (no cache, or a
prefill at ``cache_pos`` 0) runs ``kernels.attention.flash_attention``
on the prompt's own keys (T = S).  S is padded at the end to a multiple
of 64 and the pad sliced off the output; this is exact, since K9's
causal mask is top-left aligned and a real query row i never reads a
padded key >= S.  K9 scales by ``dh ** -0.5``, the reference's default.
Above ``blockwise_attn_threshold`` the reference switches to its
blockwise online softmax (``_blockwise_attention``), which computes the
same function K9 does at any length, so it has no counterpart here.

Decode (S = 1 over the cache) and a chunked prefill at ``cache_pos`` > 0
stay plain torch (:func:`_plain_attention`), as the reference computes
them in jnp, not in its Pallas kernel; K9 takes no query offset.  The
decode attends over the cache's filled prefix ``[:cache_pos + S]``
rather than masking the rest: the masked scores' softmax weights are
exact zeros, so the result is the same.

MLA (DeepSeek-V2/V3, Kimi-K2) is the next slice of the port.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import flash_attention
from .config import ModelConfig
from .layers import Dense, Dtypes, mrope, rope

__all__ = ["GQAttention", "attention"]

_NEG = -1e30
#: K9's tile: S is padded to a multiple of it, and K9 is called with
#: ``bq = bk = K9_TILE``.
K9_TILE = 64


def _apply_rope(cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope_kind == "rope":
        return rope(x, positions, cfg.rope_theta)
    if cfg.rope_kind == "mrope":
        return mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return x


# ---------------------------------------------------------------------------
# core attention math (q: [B, S, H, dh]; k/v: [B, T, KV, dh])
# ---------------------------------------------------------------------------

def _plain_attention(q, k, v, *, q_offset: int) -> torch.Tensor:
    """Causal attention of queries at positions ``q_offset + i`` over the
    keys at positions 0..T-1, scaled by ``dh ** -0.5``."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dv = v.shape[-1]
    qg = q.reshape(B, S, KV, G, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * dh ** -0.5
    ti = torch.arange(T, device=q.device)
    si = torch.arange(S, device=q.device) + q_offset
    scores = torch.where(ti[None, :] <= si[:, None], scores, _NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, dv)


def _flash(q, k, v) -> torch.Tensor:
    """Causal self-attention of q [B, S, H, dh] over its own k, v
    [B, S, KV, dh] through K9 (one launch), S padded to K9_TILE."""
    S = q.shape[1]
    pad = -S % K9_TILE
    qh, kh, vh = (F.pad(x.transpose(1, 2), (0, 0, 0, pad))
                  for x in (q, k, v))
    o = flash_attention(qh, kh, vh, bq=K9_TILE, bk=K9_TILE, causal=True,
                        device=q.device)
    return o[:, :, :S].transpose(1, 2)


def attention(q, k, v, *, q_offset: int = 0) -> torch.Tensor:
    """Causal attention of q [B, S, H, dh] (positions ``q_offset`` on)
    over k, v [B, T, KV, dh] (positions 0..T-1) -> [B, S, H, dv].
    Self-attention from position 0 (S > 1, T = S) goes through K9; every
    other call (a decode step, a chunked prefill over the cache) through
    :func:`_plain_attention`."""
    if q_offset == 0 and q.shape[1] > 1 and k.shape[1] == q.shape[1]:
        return _flash(q, k, v)
    return _plain_attention(q, k, v, q_offset=q_offset)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

class GQAttention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (the reference's ``gqa_init``);
    ``forward`` is its ``gqa_apply`` and ``cache_spec`` its
    ``gqa_cache_spec``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        H, KV, dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
            cfg.d_model
        kw = dict(generator=generator, device=device)
        self.wq = Dense(D, H * dh, pd, **kw)
        self.wk = Dense(D, KV * dh, pd, **kw)
        self.wv = Dense(D, KV * dh, pd, **kw)
        self.wo = Dense(H * dh, D, pd, **kw)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, cache: Optional[Dict] = None,
                cache_pos: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B, S, D].  With a cache: write K/V at ``cache_pos`` (in
        place) and attend over the filled prefix (decode /
        prefill-with-cache); returns (out, cache)."""
        B, S, D = x.shape
        H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.wq(x).reshape(B, S, H, dh)
        k = self.wk(x).reshape(B, S, KV, dh)
        v = self.wv(x).reshape(B, S, KV, dh)
        q = _apply_rope(cfg, q, positions)
        k = _apply_rope(cfg, k, positions)

        if cache is None:
            out = attention(q, k, v)
        else:
            pos = int(cache_pos)
            cache["k"][:, pos:pos + S] = k.to(cache["k"].dtype)
            cache["v"][:, pos:pos + S] = v.to(cache["v"].dtype)
            if pos == 0:
                # a prefill from position 0: K9 on the prompt's own keys
                out = attention(q, k, v)
            else:
                kv_len = pos + S
                out = attention(q, cache["k"][:, :kv_len].to(q.dtype),
                                cache["v"][:, :kv_len].to(q.dtype),
                                q_offset=pos)
        return self.wo(out.reshape(B, S, H * dh)), cache

    @staticmethod
    def cache_spec(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{name: (shape, dtype)} of the block's KV cache."""
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        dt = Dtypes.compute(cfg)
        return {"k": (shape, dt), "v": (shape, dt)}
