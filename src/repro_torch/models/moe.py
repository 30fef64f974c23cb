"""Mixture-of-Experts FFN — the port of ``repro/models/moe.py``.

Each token's router probabilities (softmax in float32) pick its top-k
experts; a capacity-bounded dispatch gathers the tokens into a dense
[E, C, D] buffer (an assignment's position in its expert is the count of
earlier assignments to that expert in the flat ``t * K + k`` order,
those past the capacity C dropped), the expert GEMMs run as batched
products over it, and the weighted expert outputs go back to token
order.  The reference computes all of this
outside any Pallas kernel, and so does the port: the GEMMs are
``torch.bmm`` (cuBLAS on the card).

Deliberate choices, each to compute the reference's function:

* The top-k is a stable descending sort, so equal probabilities go to
  the lower expert index, as ``jax.lax.top_k`` breaks ties
  (``torch.topk`` does not: a zero router gives it the highest
  indices).  Ties are common in bf16, where router logits round to a
  coarse grid.
* The position in expert is each assignment's rank among its expert's
  assignments after a stable sort by expert, where the reference takes
  the exclusive cumsum of a [T K, E + 1] one-hot down its T K rows: the
  same integers, but PyTorch's scan down the long axis of that one-hot
  took 38 ms a layer on the card at deepseek-v2's 4 x 4096 prefill.
* The combine is deterministic: each token's kept contributions are
  added one at a time in rising expert id, in x's dtype, which is the
  order of the reference's scatter-add over its [E * C] slots
  (``.at[slot_to_tok].add``).  ``index_add_`` would sum with atomics on
  the card, in an order that changes from run to run.

:func:`_moe_local` keeps the reference's expert-shard contract: it
serves the experts ``[e_offset, e_offset + E_loc)`` of the ``E_loc``
weight slices it is given, and the outputs of the shards sum to the
whole (the reference's ``psum``).  :func:`moe_apply` runs the unmapped
path; a mesh whose ``model`` axis shards the experts raises
``NotImplementedError``: expert parallelism is a later slice of the
port.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import Dense, Dtypes, normal

__all__ = ["MoE", "moe_apply", "route", "dispatch"]


class Experts(nn.Module):
    """The routed experts' stacked weights: ``w_gate``, ``w_up`` [E, D,
    F] and ``w_down`` [E, F, D]."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        E, D, Fe = cfg.num_experts, cfg.d_model, cfg.d_ff_expert

        def stack(d_in, d_out):
            # drawn in blocks of experts, each float32 draw at most 1 GiB
            # (kimi-k2's whole w_gate is 22.5 GB in float32)
            w = torch.empty((E, d_in, d_out), dtype=pd, device=device)
            step = max(1, (1 << 28) // (d_in * d_out))
            for e in range(0, E, step):
                n = min(step, E - e)
                w[e:e + n] = normal(generator, (n, d_in, d_out),
                                    1.0 / math.sqrt(d_in), pd, device)
            return nn.Parameter(w, requires_grad=False)

        self.w_gate = stack(D, Fe)
        self.w_up = stack(D, Fe)
        self.w_down = stack(Fe, D)


class SharedExperts(nn.Module):
    """The always-active shared experts, one swiglu MLP of width
    ``d_ff_expert * num_shared_experts``: ``w_gate``, ``w_up``,
    ``w_down``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        Fs = cfg.d_ff_expert * cfg.num_shared_experts
        kw = dict(generator=generator, device=device)
        self.w_gate = Dense(cfg.d_model, Fs, pd, **kw)
        self.w_up = Dense(cfg.d_model, Fs, pd, **kw)
        self.w_down = Dense(Fs, cfg.d_model, pd, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class MoE(nn.Module):
    """The reference's ``moe_init`` tree: ``router`` [D, E] (std 0.02),
    ``experts`` and, with shared experts, ``shared``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.router = Dense(cfg.d_model, cfg.num_experts, Dtypes.param(cfg),
                            scale=0.02, **kw)
        self.experts = Experts(cfg, **kw)
        if cfg.num_shared_experts:
            self.shared = SharedExperts(cfg, **kw)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, mesh=None,
                data_axes=("data",), model_axis: str = "model",
                expert_tp: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_apply(self, x, cfg, mesh=mesh, data_axes=data_axes,
                         model_axis=model_axis, expert_tp=expert_tp)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.num_experts))
    return max(4, c)


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """Router probabilities [T, E] (float32) and each token's top-k
    experts: (probs, top_p [T, K] float32, top_e [T, K] int64), the
    probabilities in descending order, ties to the lower expert index
    (``jax.lax.top_k``'s order)."""
    logits = torch.matmul(x2d, router_w.to(x2d.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]


def dispatch(top_e: torch.Tensor, e_offset: int, e_loc: int, capacity: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, k) assignment's slot ``local expert * C + position in
    its expert`` (flat ``t * K + k`` order) and whether it is kept:
    served by the experts ``[e_offset, e_offset + e_loc)`` and within the
    capacity.  Dropped assignments get the sentinel slot ``e_loc * C``."""
    le = top_e.reshape(-1) - e_offset
    le = torch.where((le >= 0) & (le < e_loc), le, e_loc)
    # rank within its expert in flat order: a stable sort keeps the flat
    # order inside each expert's run, which starts where the counts of
    # the lower experts end
    order = torch.sort(le, stable=True).indices
    counts = torch.bincount(le, minlength=e_loc + 1)
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(le.numel(), device=le.device) - starts[le[order]]
    pos = torch.empty_like(le)
    pos[order] = rank
    keep = (le < e_loc) & (pos < capacity)
    slot = torch.where(keep, le * capacity + pos, e_loc * capacity)
    return slot, keep


def _moe_local(x2d: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
               wu: torch.Tensor, wd: torch.Tensor, cfg: ModelConfig,
               e_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE over the local experts.  x2d: [T, D]; wg, wu, wd: the expert
    slices [E_loc, ...] of the global experts from ``e_offset`` on.
    Returns (out [T, D] in x's dtype, aux loss float32)."""
    T, D = x2d.shape
    E, K = cfg.num_experts, cfg.top_k
    E_loc = wg.shape[0]
    C = _capacity(T, cfg)
    dev = x2d.device

    probs, top_p, top_e = route(x2d, router_w, cfg)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # aux load-balancing loss (global statistics, the same on every shard)
    me = probs.mean(dim=0)
    ce = torch.bincount(top_e.reshape(-1), minlength=E).float() \
        / torch.tensor(float(T * K), device=dev)
    aux = E * torch.sum(me * ce)

    slot, keep = dispatch(top_e, e_offset, E_loc, C)
    tok_idx = torch.arange(T, device=dev).repeat_interleave(K)
    # slot -> token (the sentinel T: a zero row)
    slot_to_tok = torch.full((E_loc * C,), T, dtype=torch.long, device=dev)
    slot_to_tok[slot[keep]] = tok_idx[keep]
    xpad = torch.cat([x2d, x2d.new_zeros((1, D))], dim=0)
    xe = xpad[slot_to_tok].reshape(E_loc, C, D)

    # expert GEMMs
    if cfg.act == "swiglu":
        h = F.silu(torch.bmm(xe, wg.to(xe.dtype))) \
            * torch.bmm(xe, wu.to(xe.dtype))
    else:
        h = F.gelu(torch.bmm(xe, wu.to(xe.dtype)), approximate="tanh")
    ye = torch.bmm(h, wd.to(xe.dtype))                       # [E_loc, C, D]

    # combine: a token's kept contributions in rising slot (= expert)
    # order, one add at a time in x's dtype; dropped ones read the zero
    # row at the sentinel slot
    w_slot = torch.zeros((E_loc * C + 1,), dtype=torch.float32, device=dev)
    w_slot[slot[keep]] = top_p.reshape(-1)[keep]
    contrib = ye.reshape(E_loc * C, D) * w_slot[:-1, None].to(ye.dtype)
    contrib = torch.cat([contrib, contrib.new_zeros((1, D))], dim=0)
    order = slot.reshape(T, K).sort(dim=1).values
    out = x2d.new_zeros((T, D))
    for k in range(K):
        out = out + contrib[order[:, k]].to(x2d.dtype)
    return out, aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig, mesh=None,
              data_axes=("data",), model_axis: str = "model",
              expert_tp: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss scalar).  Without a mesh
    (or with one whose ``model`` axis is 1, or does not divide the
    experts, where the reference runs unmapped too) every expert runs
    here; a mesh that would shard the experts raises."""
    B, S, D = x.shape
    ep = 1 if mesh is None else int(mesh.shape.get(model_axis, 1))
    if ep > 1 and cfg.num_experts % ep == 0:
        raise NotImplementedError(
            f"moe_apply over a mesh with {model_axis}={ep} shards the "
            f"experts (expert_tp={expert_tp}): expert parallelism is a "
            f"later slice of the port; pass mesh=None")
    ex = p.experts
    out, aux = _moe_local(x.reshape(-1, D), p.router.w, ex.w_gate, ex.w_up,
                          ex.w_down, cfg)
    out = out.reshape(B, S, D)
    if cfg.num_shared_experts:
        out = out + p.shared(x)
    return out, aux
