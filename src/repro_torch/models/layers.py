"""Shared layer primitives — the port of ``repro/models/layers.py``: norms,
projections, rotary embeddings, MLPs, embeddings and the loss.

Each weight-holding primitive is an ``nn.Module`` whose parameters are
named as the reference's parameter tree names them (``Dense.w``,
``RMSNorm.scale``, ``MLP.w_up.w``, ``Embedding.table``), so that a
reference tree flattened with ``.`` is the module's ``state_dict``.  The
constructors are the reference's ``*_init`` functions: they draw from an
explicit ``torch.Generator`` on ``device`` (the same distributions and
scales, not the same numbers as jax's PRNG).  The math is in plain
functions on tensors (``dense``, ``rmsnorm``, ``rope``, ``mlp``, ...),
which the modules' ``forward`` call.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig

__all__ = ["Dtypes", "normal", "Dense", "dense", "RMSNorm", "rmsnorm",
           "rope", "mrope", "MLP", "mlp", "Embedding", "embed", "unembed",
           "cross_entropy"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _id_shard(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The default activation callback: ``x`` as it is."""
    return x


class Dtypes:
    @staticmethod
    def param(cfg: ModelConfig) -> torch.dtype:
        return _DTYPES[cfg.param_dtype]

    @staticmethod
    def compute(cfg: ModelConfig) -> torch.dtype:
        return _DTYPES[cfg.dtype]


def normal(generator: torch.Generator, shape, scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """``scale`` times a standard normal draw of ``shape``, drawn in
    float32 on ``device`` and cast to ``dtype`` (the reference's
    ``(jax.random.normal(key, shape) * scale).astype(dtype)``)."""
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# dense / norm
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """A projection ``w`` [d_in, d_out], drawn with std ``1 / sqrt(d_in)``
    unless ``scale`` is given."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, *,
                 generator: torch.Generator, device,
                 scale: Optional[float] = None) -> None:
        super().__init__()
        scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
        self.w = nn.Parameter(normal(generator, (d_in, d_out), scale, dtype,
                                     device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.w, x)


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, *, device) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype,
                                             device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd] rotated by the angles ang [..., S, hd / 2]."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin,
                      x2f * cos + x1f * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, hd]; positions: [..., S] int."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)         # [half]
    return _rotate(x, positions[..., None].float() * freqs)


def mrope(x: torch.Tensor, positions: torch.Tensor,
          sections: Tuple[int, ...], theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): ``positions`` is [3, ..., S] for the
    (temporal, height, width) ids; the head_dim/2 frequency channels are
    split into ``sections`` (summing to head_dim//2), each section rotated
    by its own position stream."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    parts, start = [], 0
    for s, sec in zip(positions, sections):
        parts.append(s[..., None].float() * freqs[start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``w_up``, ``w_down`` and, for swiglu, ``w_gate``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        d_ff = cfg.d_ff
        pd = Dtypes.param(cfg)
        kw = dict(generator=generator, device=device)
        self.w_up = Dense(cfg.d_model, d_ff, pd, **kw)
        self.w_down = Dense(d_ff, cfg.d_model, pd, **kw)
        if cfg.act == "swiglu":
            self.w_gate = Dense(cfg.d_model, d_ff, pd, **kw)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                shard=_id_shard) -> torch.Tensor:
        return mlp(self, x, cfg, shard)


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig,
        shard=_id_shard) -> torch.Tensor:
    up = shard(p.w_up(x), "ffn")
    if cfg.act == "swiglu":
        h = F.silu(shard(p.w_gate(x), "ffn")) * up
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return p.w_down(h)


# ---------------------------------------------------------------------------
# embeddings / loss
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """The token table [nb * vocab, d] (codebooks stacked) and, unless the
    embeddings are tied, the unembedding ``unembed.w`` [d, nb * vocab]."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        nb = max(cfg.num_codebooks, 1)
        self.table = nn.Parameter(normal(
            generator, (nb * cfg.vocab_size, cfg.d_model), 0.02, pd, device),
            requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = Dense(cfg.d_model, nb * cfg.vocab_size, pd,
                                 generator=generator, device=device,
                                 scale=0.02)


def embed(p: Embedding, tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """tokens: [B, S] or [B, S, num_codebooks] -> [B, S, d] (codebooks sum)."""
    table = p.table.to(Dtypes.compute(cfg))
    tokens = tokens.long()
    if tokens.dim() == 3:                     # musicgen: per-codebook offset
        nb = tokens.shape[-1]
        offs = torch.arange(nb, device=tokens.device) * cfg.vocab_size
        return table[tokens + offs].sum(dim=2)
    return table[tokens]


def unembed(p: Embedding, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-> [B, S, (nb*)vocab] logits."""
    if cfg.tie_embeddings:
        return torch.matmul(x, p.table.to(x.dtype).t())
    return p.unembed(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits [..., V] (any leading dims).
    With ``denom`` (a tensor on the logits' device), a data shard's
    term of the global mean: its summed ``nll * mask`` (or ``nll``) over
    ``denom``, the global batch's ``clamp_min(mask sum, 1)`` or its
    label count, so the shards' terms sum to the global mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        if denom is None:
            denom = torch.clamp_min(mask.sum(), 1.0)
    elif denom is None:
        return nll.mean()
    return nll.sum() / denom
