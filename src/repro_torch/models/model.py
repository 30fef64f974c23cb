"""Decoder-only LM assembly — the port of ``repro/models/model.py``: the
layer loop over heterogeneous block patterns, KV/SSM caches, the loss,
prefill and decode.

A :class:`DecoderLM` holds the layers in order: ``layers[i]`` is layer
i's block (an :class:`AttnBlock`, a :class:`Mamba2Block`, or for zamba2's
``shared_attn`` a :class:`SharedAttnSlot` without weights, since one
shared :class:`AttnBlock`, ``shared_attn``, serves every occurrence).
``config.segments`` only fixes that order: the reference scans each
segment with ``lax.scan``, and a torch loop needs none.  Its parameter
names are the reference's tree flattened with ``.``, with each
segment's stacked ``[repeats, ...]`` leaves unstacked to their layers
(:func:`params_from_reference`).

A cache is ``{"layers": [per-layer dict]}``: ``{"k", "v"}``
[B, max_len, KV, dh] for attention layers, ``{"conv", "ssm"}`` for
Mamba2 layers.  :func:`prefill` and :func:`decode_step` update its
tensors in place (the reference donates its cache to the decode step)
and return it.

The reference's ``remat`` and ``shard`` callbacks (and ``mesh`` /
``data_axes``, used by MoE only) have no effect when serving; the
signatures keep them.  MoE, MLA, mLSTM and sLSTM raise
``NotImplementedError`` from :func:`init`: they are later slices of the
port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, \
    Union

import numpy as np
import torch
from torch import nn

from ..kernels.common import resolve_device
from .attention import GQAttention
from .config import ModelConfig, segments
from .layers import (Dtypes, Embedding, MLP, RMSNorm, cross_entropy, embed,
                     rmsnorm, unembed)
from .ssm import Mamba2

__all__ = ["init", "make_cache", "forward", "loss_fn", "prefill",
           "decode_step", "param_count", "active_param_count",
           "DecoderLM", "AttnBlock", "Mamba2Block", "SharedAttnSlot",
           "params_from_reference", "unstack_segments"]

ShardFn = Callable[[torch.Tensor, str], torch.Tensor]
_id_shard: ShardFn = lambda x, kind: x

#: The block kinds this slice serves, and those a later slice ports.
KINDS = ("attn", "shared_attn", "mamba2")
_LATER = {"mlstm": "the mLSTM/sLSTM slice",
          "slstm": "the mLSTM/sLSTM slice",
          "mla": "the MoE/MLA slice", "moe": "the MoE/MLA slice"}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class AttnBlock(nn.Module):
    """Pre-norm attention + MLP: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        self.ln1 = RMSNorm(cfg.d_model, pd, device=device)
        self.ln2 = RMSNorm(cfg.d_model, pd, device=device)
        self.attn = GQAttention(cfg, generator=generator, device=device)
        self.mlp = MLP(cfg, generator=generator, device=device)

    def forward(self, x, cfg: ModelConfig, positions, cache, cache_pos):
        h, new_cache = self.attn(self.ln1(x, cfg.norm_eps), cfg, positions,
                                 cache, cache_pos)
        x = x + h
        x = x + self.mlp(self.ln2(x, cfg.norm_eps), cfg)
        return x, new_cache


class Mamba2Block(nn.Module):
    """Pre-norm Mamba2 mixer: ``ln``, ``mix``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, Dtypes.param(cfg), device=device)
        self.mix = Mamba2(cfg, generator=generator, device=device)

    def forward(self, x, cfg: ModelConfig, positions, cache, cache_pos):
        h, new_cache = self.mix(self.ln(x, cfg.norm_eps), cfg, cache)
        return x + h, new_cache


class SharedAttnSlot(nn.Module):
    """A ``shared_attn`` layer: it applies the model's one shared
    attention block and holds no weights of its own."""


def _check_supported(cfg: ModelConfig) -> None:
    later = [k for k in cfg.layer_kinds() if k not in KINDS]
    if cfg.attn_kind == "mla":
        later.append("mla")
    if cfg.is_moe:
        later.append("moe")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {later[0]} is not ported yet: it is "
            f"{_LATER.get(later[0], 'a later slice')} of the port; this "
            f"slice serves {', '.join(KINDS)} blocks with GQA attention "
            f"and dense MLPs")


class DecoderLM(nn.Module):
    """``embed``, ``final_norm``, ``shared_attn`` (zamba2 only) and
    ``layers`` in depth order."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        kinds = cfg.layer_kinds()
        self.embed = Embedding(cfg, **kw)
        self.final_norm = RMSNorm(cfg.d_model, Dtypes.param(cfg),
                                  device=device)
        if "shared_attn" in kinds:
            self.shared_attn = AttnBlock(cfg, **kw)
        block = {"attn": AttnBlock, "mamba2": Mamba2Block}
        self.layers = nn.ModuleList(
            SharedAttnSlot() if kind == "shared_attn"
            else block[kind](cfg, **kw) for kind in kinds)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def run_layers(self, x: torch.Tensor, positions: torch.Tensor,
                   caches: Optional[Dict], cache_pos: Optional[int]
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Every layer in order (the reference's ``_run_segments``);
        ``caches`` None for a forward pass without a cache."""
        cfg = self.cfg
        new = None if caches is None else []
        for i, kind in enumerate(cfg.layer_kinds()):
            cache = None if caches is None else caches["layers"][i]
            x, nc = _apply_block(kind, self.layers[i], x, cfg, positions,
                                 cache, cache_pos,
                                 getattr(self, "shared_attn", None))
            if new is not None:
                new.append(nc)
        return x, None if new is None else {"layers": new}


def _apply_block(kind: str, block: nn.Module, x, cfg: ModelConfig,
                 positions, cache, cache_pos, shared: Optional[AttnBlock]):
    """-> (x, new_cache)"""
    if kind == "shared_attn":
        block = shared
    return block(x, cfg, positions, cache, cache_pos)


# ---------------------------------------------------------------------------
# init / weights carried across
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None) -> DecoderLM:
    """Random weights for ``cfg`` drawn on ``device`` (CUDA unless the
    caller passes another) from ``generator`` (a fresh one seeded 0 on
    the device when None).  Raises when CUDA is asked for and no card is
    visible, and ``NotImplementedError`` for kinds of a later slice."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return DecoderLM(cfg, generator=generator, device=dev).eval()


def unstack_segments(seg_trees: List[Mapping], cfg: ModelConfig
                     ) -> List[Dict]:
    """The reference's per-segment trees (``params["segments"]`` or
    ``cache["segments"]``: ``{f"{ki}_{kind}": leaves stacked on a leading
    [repeats] axis}``) as one tree per layer: layer ``start + r *
    len(kinds) + ki`` gets ``segments[i][f"{ki}_{kind}"][r]``."""
    layers: List[Any] = [None] * cfg.num_layers

    def take(tree, r):
        if isinstance(tree, Mapping):
            return {k: take(v, r) for k, v in tree.items()}
        return tree[r]

    for seg, tree in zip(segments(cfg), seg_trees):
        for ki, kind in enumerate(seg.kinds):
            for r in range(seg.repeats):
                layers[seg.start_layer + r * len(seg.kinds) + ki] = take(
                    tree[f"{ki}_{kind}"], r)
    return layers


def _flatten(tree: Mapping, prefix: str, out: Dict[str, Any]) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[f"{prefix}{k}"] = v


def params_from_reference(np_params: Mapping, cfg: ModelConfig,
                          device: Union[str, torch.device, None] = None
                          ) -> DecoderLM:
    """A :class:`DecoderLM` on ``device`` holding the reference's weights
    ``np_params`` (``jax.tree.map(np.asarray, params)``), each cast to the
    port's parameter dtype.  Every parameter must be matched."""
    dev = resolve_device(device)
    flat: Dict[str, Any] = {}
    _flatten({k: v for k, v in np_params.items() if k != "segments"}, "",
             flat)
    for i, layer in enumerate(unstack_segments(np_params["segments"], cfg)):
        _flatten(layer, f"layers.{i}.", flat)
    model = DecoderLM(cfg, generator=torch.Generator().manual_seed(0),
                      device="meta")
    want = model.state_dict()
    state = {name: torch.from_numpy(
        np.array(flat[name], dtype=np.float32)).to(dev, want[name].dtype)
        for name in want if name in flat}
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _block_cache_spec(kind: str, cfg: ModelConfig, batch: int,
                      max_len: int):
    if kind in ("attn", "shared_attn"):
        return GQAttention.cache_spec(cfg, batch, max_len)
    if kind == "mamba2":
        return Mamba2.state_spec(cfg, batch)
    raise ValueError(kind)


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               concrete: bool = False,
               device: Union[str, torch.device, None] = None) -> Dict:
    """The cache of ``cfg``: zeros on ``device`` (``concrete=True``), or
    shape-and-dtype stand-ins on the ``meta`` device (the reference's
    ShapeDtypeStructs)."""
    dev = resolve_device(device) if concrete else torch.device("meta")
    return {"layers": [
        {name: torch.zeros(shape, dtype=dt, device=dev)
         for name, (shape, dt) in
         _block_cache_spec(kind, cfg, batch, max_len).items()}
        for kind in cfg.layer_kinds()]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _default_positions(cfg: ModelConfig, batch: int, seq: int, device,
                       offset: int = 0) -> torch.Tensor:
    pos = (torch.arange(seq, device=device) + offset)[None, :]
    pos = pos.expand(batch, seq)
    if cfg.rope_kind == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos


def _embed_inputs(model: DecoderLM, tokens, cfg: ModelConfig,
                  extra_embeds) -> torch.Tensor:
    x = embed(model.embed, torch.as_tensor(tokens, device=model.device),
              cfg)
    if extra_embeds is not None:     # modality stub: precomputed embeddings
        x = x + torch.as_tensor(extra_embeds, device=x.device).to(x.dtype)
    return x


def forward(model: DecoderLM, tokens, cfg: ModelConfig, *,
            positions: Optional[torch.Tensor] = None,
            extra_embeds: Optional[torch.Tensor] = None,
            mesh=None, data_axes=("data",), shard: ShardFn = _id_shard
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scoring forward pass -> (logits [B,S,V*nb], aux_loss).  aux is the
    MoE router loss: 0 for the kinds this slice serves."""
    B, S = tokens.shape[:2]
    x = _embed_inputs(model, tokens, cfg, extra_embeds)
    if positions is None:
        positions = _default_positions(cfg, B, S, x.device)
    x, _ = model.run_layers(x, torch.as_tensor(positions, device=x.device),
                            None, None)
    x = rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = unembed(model.embed, x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(model: DecoderLM, batch: Dict, cfg: ModelConfig, *, mesh=None,
            data_axes=("data",), shard: ShardFn = _id_shard
            ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(model, batch["tokens"], cfg,
                          positions=batch.get("positions"),
                          extra_embeds=batch.get("extra_embeds"))
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    if labels.dim() == 3:            # musicgen: [B,S,nb] codebook targets
        nb = labels.shape[-1]
        logits = logits.reshape(logits.shape[:2] + (nb, cfg.vocab_size))
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)
    ce = cross_entropy(logits, labels, mask)
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prefill(model: DecoderLM, tokens, cache: Dict, cfg: ModelConfig, *,
            positions=None, extra_embeds=None, mesh=None,
            data_axes=("data",), shard: ShardFn = _id_shard):
    """Process the prompt from position 0, fill the cache.  Returns
    (last_logits [B, V*nb], cache)."""
    B, S = tokens.shape[:2]
    x = _embed_inputs(model, tokens, cfg, extra_embeds)
    if positions is None:
        positions = _default_positions(cfg, B, S, x.device)
    x, new_cache = model.run_layers(
        x, torch.as_tensor(positions, device=x.device), cache, 0)
    x = rmsnorm(model.final_norm.scale, x[:, -1:], cfg.norm_eps)
    logits = unembed(model.embed, x, cfg)[:, 0]
    return logits, new_cache


def decode_step(model: DecoderLM, token, cache: Dict, pos: int,
                cfg: ModelConfig, *, mesh=None, data_axes=("data",),
                shard: ShardFn = _id_shard):
    """One decode step.  token: [B] (or [B, nb]); pos: int.
    Returns (logits [B, V*nb], cache)."""
    token = torch.as_tensor(token, device=model.device)
    tok = token[:, None] if token.dim() == 1 else token[:, None, :]
    B = tok.shape[0]
    x = embed(model.embed, tok, cfg)
    positions = _default_positions(cfg, B, 1, x.device, offset=int(pos))
    x, new_cache = model.run_layers(x, positions, cache, int(pos))
    x = rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = unembed(model.embed, x, cfg)[:, 0]
    return logits, new_cache


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_param_count(model: nn.Module, cfg: ModelConfig) -> int:
    """Params touched per token: all of them for the kinds this slice
    serves (the reference's MoE count waits for the MoE slice)."""
    if cfg.is_moe:
        raise NotImplementedError("MoE is the MoE/MLA slice of the port")
    return param_count(model)
