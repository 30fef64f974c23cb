"""Attention blocks: GQA (RoPE / M-RoPE) and MLA (DeepSeek-V2/V3, Kimi-K2),
each with a prefill path and a KV-cache decode path — the port of
``repro/models/attention.py``.

The route to K9: a call with S > 1 from position 0 (no cache, or a
prefill at ``cache_pos`` 0) runs ``kernels.attention.flash_attention``
on the prompt's own keys (T = S).  S is padded at the end to a multiple
of 64 and the pad sliced off the output; this is exact, since K9's
causal mask is top-left aligned and a real query row i never reads a
padded key >= S.  K9 scales by ``dh ** -0.5``, the reference's default.
Above ``blockwise_attn_threshold`` the reference switches to its
blockwise online softmax (``_blockwise_attention``), which computes the
same function K9 does at any length, so it has no counterpart here.

A forward pass that builds an autograd graph (training) takes the same
route: ``flash_attention`` then runs K9 through its ``FlashAttention``
function, whose backward on the card is K9 f32's backward kernel (dh,
dv <= 128; bf16 or MLA's 192-wide head raise there), and the pad's rows
get exact zero gradients.

Decode (S = 1 over the cache) and a chunked prefill at ``cache_pos`` > 0
stay plain torch (:func:`_plain_attention`), as the reference computes
them in jnp, not in its Pallas kernel; K9 takes no query offset.  The
decode attends over the cache's filled prefix ``[:cache_pos + S]``
rather than masking the rest: the masked scores' softmax weights are
exact zeros, so the result is the same.

MLA (:class:`MLAttention`) caches the compressed latent ``c_kv`` and the
shared rotary key ``k_rope``.  Its prefill from position 0 decompresses
K and V per head and runs K9 on ``q = [q_nope | q_rope]`` and ``k =
[k_nope | k_pe]`` (192 wide at the published widths, v 128: K9's
``dh <= 192, dv <= 128`` instantiation), with k_pe broadcast to the H
heads; K9's ``dh ** -0.5`` is the reference's ``(dn + dr) ** -0.5``.  A
decode step (S = 1 over the cache) takes the reference's absorbed form
in plain torch: the queries pulled into the latent space, scores and
values against the latent cache's filled prefix.  A multi-token call at
``cache_pos`` > 0 decompresses the filled prefix and takes
:func:`_plain_attention`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import flash_attention
from .config import ModelConfig
from .layers import Dense, Dtypes, RMSNorm, _id_shard, mrope, rope

__all__ = ["GQAttention", "MLAttention", "attention"]

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
    keys at positions 0..T-1, scaled by ``dh ** -0.5`` (q's head dim)."""
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
    """Causal self-attention of q [B, S, H, dh] over its own k [B, S, KV,
    dh] and v [B, S, KV, dv] through K9 (one launch), S padded to
    K9_TILE."""
    S = q.shape[1]
    pad = -S % K9_TILE
    qh, kh, vh = (F.pad(x.transpose(1, 2), (0, 0, 0, pad))
                  for x in (q, k, v))
    o = flash_attention(qh, kh, vh, bq=K9_TILE, bk=K9_TILE, causal=True,
                        device=q.device)
    return o[:, :, :S].transpose(1, 2)


def attention(q, k, v, *, q_offset: int = 0) -> torch.Tensor:
    """Causal attention of q [B, S, H, dh] (positions ``q_offset`` on)
    over k [B, T, KV, dh] and v [B, T, KV, dv] (positions 0..T-1) -> [B,
    S, H, dv].
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
                cache_pos: Optional[int] = None, shard=_id_shard
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B, S, D].  With a cache: write K/V at ``cache_pos`` (in
        place) and attend over the filled prefix (decode /
        prefill-with-cache); returns (out, cache)."""
        B, S, D = x.shape
        H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = shard(self.wq(x).reshape(B, S, H, dh), "heads")
        k = shard(self.wk(x).reshape(B, S, KV, dh), "heads")
        v = shard(self.wv(x).reshape(B, S, KV, dh), "heads")
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


# ---------------------------------------------------------------------------
# MLA block (multi-head latent attention)
# ---------------------------------------------------------------------------

class MLAttention(nn.Module):
    """The reference's ``mla_init`` tree: ``wq_a``, ``q_norm``, ``wq_b``
    (or ``wq`` without q compression), ``wkv_a`` (-> [c_kv | k_rope]),
    ``kv_norm``, ``wk_b``, ``wv_b``, ``wo``; ``forward`` is its
    ``mla_apply`` and ``cache_spec`` its ``mla_cache_spec``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        D, H = cfg.d_model, cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        kl = cfg.kv_lora_rank
        kw = dict(generator=generator, device=device)
        if cfg.q_lora_rank:
            self.wq_a = Dense(D, cfg.q_lora_rank, pd, **kw)
            self.q_norm = RMSNorm(cfg.q_lora_rank, pd, device=device)
            self.wq_b = Dense(cfg.q_lora_rank, H * (dn + dr), pd, **kw)
        else:
            self.wq = Dense(D, H * (dn + dr), pd, **kw)
        self.wkv_a = Dense(D, kl + dr, pd, **kw)
        self.kv_norm = RMSNorm(kl, pd, device=device)
        self.wk_b = Dense(kl, H * dn, pd, **kw)
        self.wv_b = Dense(kl, H * dv, pd, **kw)
        self.wo = Dense(H * dv, D, pd, **kw)

    def _qkv(self, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
        """The reference's ``_mla_qkv``: (q_nope [B,S,H,dn], q_rope
        [B,S,H,dr], c_kv [B,S,kl], k_rope [B,S,dr])."""
        B, S, _ = x.shape
        H = cfg.num_heads
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            q = self.wq_b(self.q_norm(self.wq_a(x), cfg.norm_eps))
        else:
            q = self.wq(x)
        q = q.reshape(B, S, H, dn + dr)
        q_nope = q[..., :dn]
        q_rope = rope(q[..., dn:], positions, cfg.rope_theta)
        kv = self.wkv_a(x)
        c_kv = self.kv_norm(kv[..., :cfg.kv_lora_rank], cfg.norm_eps)
        k_rope = rope(kv[..., cfg.kv_lora_rank:].reshape(B, S, 1, dr),
                      positions, cfg.rope_theta)[:, :, 0]
        return q_nope, q_rope, c_kv, k_rope

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, cache: Optional[Dict] = None,
                cache_pos: Optional[int] = None, shard=_id_shard
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B, S, D].  With a cache: write the latents at
        ``cache_pos`` (in place) and attend over the filled prefix; a
        single token takes the absorbed form.  Returns (out, cache)."""
        B, S, _ = x.shape
        H = cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        kl = cfg.kv_lora_rank
        q_nope, q_rope, c_kv, k_rope = self._qkv(x, cfg, positions)
        q_nope = shard(q_nope, "heads")
        pos = 0 if cache is None else int(cache_pos)
        if cache is not None:
            cache["c_kv"][:, pos:pos + S] = c_kv.to(cache["c_kv"].dtype)
            cache["k_rope"][:, pos:pos + S] = \
                k_rope.to(cache["k_rope"].dtype)
        wk_b = self.wk_b.w.to(x.dtype).reshape(kl, H, dn)
        wv_b = self.wv_b.w.to(x.dtype).reshape(kl, H, dv)

        if S == 1 and cache is not None:
            # absorbed decode: scores over the latent cache's filled
            # prefix, no K/V expansion
            cc = cache["c_kv"][:, :pos + 1].to(x.dtype)
            cr = cache["k_rope"][:, :pos + 1].to(x.dtype)
            q_lat = torch.einsum("bshd,lhd->bshl", q_nope, wk_b)
            s_lat = torch.einsum("bshl,btl->bhst", q_lat, cc)
            s_pe = torch.einsum("bshd,btd->bhst", q_rope, cr)
            sc = (s_lat + s_pe).float() * (dn + dr) ** -0.5
            w = torch.softmax(sc, dim=-1).to(x.dtype)
            o_lat = torch.einsum("bhst,btl->bshl", w, cc)
            out = torch.einsum("bshl,lhd->bshd", o_lat, wv_b)
        else:
            if pos == 0:
                # the prompt's own latents: K9's route
                cc, cr = c_kv, k_rope
            else:
                cc = cache["c_kv"][:, :pos + S].to(x.dtype)
                cr = cache["k_rope"][:, :pos + S].to(x.dtype)
            T = cc.shape[1]
            k_nope = shard(torch.einsum("btl,lhd->bthd", cc, wk_b),
                           "heads")
            v = shard(torch.einsum("btl,lhd->bthd", cc, wv_b), "heads")
            k_pe = cr[:, :, None, :].expand(B, T, H, dr)
            k = torch.cat([k_nope, k_pe], dim=-1)
            q = torch.cat([q_nope, q_rope], dim=-1)
            out = attention(q, k, v, q_offset=pos)
        return self.wo(out.reshape(B, S, H * dv)), cache

    @staticmethod
    def cache_spec(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{name: (shape, dtype)} of the block's latent cache."""
        dt = Dtypes.compute(cfg)
        return {"c_kv": ((batch, max_len, cfg.kv_lora_rank), dt),
                "k_rope": ((batch, max_len, cfg.qk_rope_head_dim), dt)}
