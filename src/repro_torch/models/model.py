"""Decoder-only LM assembly — the port of ``repro/models/model.py``: the
layer loop over heterogeneous block patterns, KV/SSM caches, the loss,
prefill and decode.

A :class:`DecoderLM` holds the layers in order: ``layers[i]`` is layer
i's block (an :class:`AttnBlock` for ``attn``, ``attn_dense`` and
``attn_moe``, with GQA or MLA attention and an MLP or an MoE FFN; a
:class:`Mamba2Block`; or for zamba2's ``shared_attn`` a
:class:`SharedAttnSlot` without weights, since one shared
:class:`AttnBlock`, ``shared_attn``, serves every occurrence).
``config.segments`` only fixes that order: the reference scans each
segment with ``lax.scan``, and a torch loop needs none.  Its parameter
names are the reference's tree flattened with ``.``, with each
segment's stacked ``[repeats, ...]`` leaves unstacked to their layers
(:func:`params_from_reference`).

A cache is ``{"layers": [per-layer dict]}``: ``{"k", "v"}``
[B, max_len, KV, dh] for GQA layers, ``{"c_kv", "k_rope"}`` for MLA
layers, ``{"conv", "ssm"}`` for Mamba2 layers.  :func:`prefill` and
:func:`decode_step` update its tensors in place (the reference donates
its cache to the decode step) and return it.

The reference's ``remat`` and ``shard`` callbacks have no effect when
serving; the signatures keep them.  ``mesh`` and ``data_axes`` go to the
MoE layers, which run unmapped (a mesh that shards the experts raises,
``moe.moe_apply``).  ``forward`` and ``loss_fn`` sum the MoE layers' aux
losses.  mLSTM and sLSTM raise ``NotImplementedError`` from
:func:`init`: they are a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, \
    Union

import numpy as np
import torch
from torch import nn

from ..kernels.common import resolve_device
from .attention import GQAttention, MLAttention
from .config import ModelConfig, segments
from .layers import (Dtypes, Embedding, MLP, RMSNorm, cross_entropy, embed,
                     rmsnorm, unembed)
from .moe import MoE
from .ssm import Mamba2

__all__ = ["init", "make_cache", "forward", "loss_fn", "prefill",
           "decode_step", "param_count", "active_param_count",
           "DecoderLM", "AttnBlock", "Mamba2Block", "SharedAttnSlot",
           "params_from_reference", "unstack_segments", "block_kinds"]

ShardFn = Callable[[torch.Tensor, str], torch.Tensor]
_id_shard: ShardFn = lambda x, kind: x

#: The block kinds the port serves, and those a later slice ports.
KINDS = ("attn", "attn_dense", "attn_moe", "shared_attn", "mamba2")
ATTN_KINDS = ("attn", "attn_dense", "attn_moe")
_LATER = {"mlstm": "the mLSTM/sLSTM slice",
          "slstm": "the mLSTM/sLSTM slice"}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class AttnBlock(nn.Module):
    """Pre-norm attention + FFN: ``ln1``, ``attn`` (MLA when the config
    says so, else GQA), ``ln2``, and ``moe`` for an ``attn_moe`` layer,
    else ``mlp``.  zamba2's shared block is always GQA + MLP."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device, kind: str = "attn") -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        kw = dict(generator=generator, device=device)
        self.ln1 = RMSNorm(cfg.d_model, pd, device=device)
        self.ln2 = RMSNorm(cfg.d_model, pd, device=device)
        mla = cfg.attn_kind == "mla" and kind != "shared_attn"
        self.attn = (MLAttention if mla else GQAttention)(cfg, **kw)
        if kind == "attn_moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg, **kw)

    def forward(self, x, cfg: ModelConfig, positions, cache, cache_pos,
                mesh=None, data_axes=("data",)):
        """-> (x, new_cache, aux): aux the MoE router loss, None without
        experts."""
        h, new_cache = self.attn(self.ln1(x, cfg.norm_eps), cfg, positions,
                                 cache, cache_pos)
        x = x + h
        h2_in = self.ln2(x, cfg.norm_eps)
        aux = None
        if hasattr(self, "moe"):
            h2, aux = self.moe(h2_in, cfg, mesh=mesh, data_axes=data_axes,
                               expert_tp=cfg.moe_expert_tp)
        else:
            h2 = self.mlp(h2_in, cfg)
        return x + h2, new_cache, aux


class Mamba2Block(nn.Module):
    """Pre-norm Mamba2 mixer: ``ln``, ``mix``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, Dtypes.param(cfg), device=device)
        self.mix = Mamba2(cfg, generator=generator, device=device)

    def forward(self, x, cfg: ModelConfig, positions, cache, cache_pos,
                mesh=None, data_axes=("data",)):
        h, new_cache = self.mix(self.ln(x, cfg.norm_eps), cfg, cache)
        return x + h, new_cache, None


class SharedAttnSlot(nn.Module):
    """A ``shared_attn`` layer: it applies the model's one shared
    attention block and holds no weights of its own."""


def block_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's block kind, in depth order, as the reference's
    segments name them: an MoE model's layers are ``attn_dense`` for the
    first ``first_dense_layers``, then ``attn_moe`` (``cfg.layer_kinds()``
    says ``attn`` for both)."""
    kinds: List[str] = []
    for seg in segments(cfg):
        kinds += list(seg.kinds) * seg.repeats
    return kinds


def _check_supported(cfg: ModelConfig) -> None:
    later = [k for k in block_kinds(cfg) if k not in KINDS]
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {later[0]} is not ported yet: it is "
            f"{_LATER.get(later[0], 'a later slice')} of the port, which "
            f"serves {', '.join(KINDS)} blocks")


class DecoderLM(nn.Module):
    """``embed``, ``final_norm``, ``shared_attn`` (zamba2 only) and
    ``layers`` in depth order."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        kinds = block_kinds(cfg)
        self.embed = Embedding(cfg, **kw)
        self.final_norm = RMSNorm(cfg.d_model, Dtypes.param(cfg),
                                  device=device)
        if "shared_attn" in kinds:
            self.shared_attn = AttnBlock(cfg, kind="shared_attn", **kw)
        self.layers = nn.ModuleList(
            SharedAttnSlot() if kind == "shared_attn"
            else Mamba2Block(cfg, **kw) if kind == "mamba2"
            else AttnBlock(cfg, kind=kind, **kw) for kind in kinds)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def run_layers(self, x: torch.Tensor, positions: torch.Tensor,
                   caches: Optional[Dict], cache_pos: Optional[int],
                   mesh=None, data_axes=("data",),
                   cfg: Optional[ModelConfig] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
        """Every layer in order (the reference's ``_run_segments``) under
        ``cfg`` (the model's own when None; the caller's may change what
        the weights do not fix, such as the MoE capacity factor);
        ``caches`` None for a forward pass without a cache.  Returns (x,
        new caches, the MoE layers' aux losses summed in float32)."""
        cfg = self.cfg if cfg is None else cfg
        new = None if caches is None else []
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        shared = getattr(self, "shared_attn", None)
        for i, kind in enumerate(block_kinds(cfg)):
            cache = None if caches is None else caches["layers"][i]
            block = shared if kind == "shared_attn" else self.layers[i]
            x, nc, aux = block(x, cfg, positions, cache, cache_pos, mesh,
                               data_axes)
            if aux is not None:
                aux_total = aux_total + aux
            if new is not None:
                new.append(nc)
        return x, None if new is None else {"layers": new}, aux_total


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
    if kind in ATTN_KINDS and cfg.attn_kind == "mla":
        return MLAttention.cache_spec(cfg, batch, max_len)
    if kind in ATTN_KINDS + ("shared_attn",):
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
        for kind in block_kinds(cfg)]}


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
    """Scoring forward pass -> (logits [B,S,V*nb], aux_loss): aux the
    MoE layers' router losses summed (0 without experts)."""
    B, S = tokens.shape[:2]
    x = _embed_inputs(model, tokens, cfg, extra_embeds)
    if positions is None:
        positions = _default_positions(cfg, B, S, x.device)
    x, _, aux = model.run_layers(
        x, torch.as_tensor(positions, device=x.device), None, None, mesh,
        data_axes, cfg)
    x = rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = unembed(model.embed, x, cfg)
    return logits, aux


def loss_fn(model: DecoderLM, batch: Dict, cfg: ModelConfig, *, mesh=None,
            data_axes=("data",), shard: ShardFn = _id_shard
            ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(model, batch["tokens"], cfg,
                          positions=batch.get("positions"),
                          extra_embeds=batch.get("extra_embeds"),
                          mesh=mesh, data_axes=data_axes)
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
    x, new_cache, _ = model.run_layers(
        x, torch.as_tensor(positions, device=x.device), cache, 0, mesh,
        data_axes, cfg)
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
    x, new_cache, _ = model.run_layers(x, positions, cache, int(pos),
                                       mesh, data_axes, cfg)
    x = rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = unembed(model.embed, x, cfg)[:, 0]
    return logits, new_cache


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_param_count(model: nn.Module, cfg: ModelConfig) -> int:
    """Params touched per token (MoE: the routed experts count top_k /
    num_experts of theirs)."""
    total = param_count(model)
    if not cfg.is_moe:
        return total
    routed = sum(param_count(m.experts) for m in model.modules()
                 if isinstance(m, MoE))
    active_frac = cfg.top_k / cfg.num_experts
    return int(total - routed + routed * active_frac)
