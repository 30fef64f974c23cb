"""Recurrent blocks — the port of ``repro/models/ssm.py``: the chunked
gated-linear-attention (GLA) core, Mamba2 (SSD), mLSTM and sLSTM.

Mamba2 and mLSTM are instances of the per-head recurrence::

    S_t = a_t * S_{t-1} + k_t^T v_t          (state  [d_k, d_v])
    o_t = q_t @ S_t

with a per-step scalar decay ``a_t = exp(log_a_t) <= 1``: Mamba2 takes
q = C, k = B, v = dt * x and log a = -dt * exp(A_log) (d_k = N, d_v =
P); mLSTM takes its q, k, v projections, log a = log sigmoid(f~) and v
scaled by the input gate, with the normalizer a second column block of v
= the input gate (d_v = dh + 1 in one scan, :func:`mlstm_scan`), h = (q
S) / max(|q n|, 1).

The route to K10: :func:`gla_chunked` runs ``kernels.gla.gla_scan``,
which takes bfloat16 heads wider than 128 (mLSTM's) whole on the card and
cuts float32 ones, and every wide head on the CPU, into 128-wide blocks.
It pads
S at the end to a multiple of the chunk with q = k = v = 0 and log_a =
0, which leaves the real rows and the final state exact.  K10 takes no
initial state (as the reference's ``gla_kernel_call`` takes none), so an
initial state S0 enters here, in float32, by linearity: ``o_t +=
exp(sum_{u<=t} log_a_u) q_t S0`` and ``final += exp(sum log_a) S0``; at
a prefill from an empty cache the term is exactly zero, and still costs
its product.  Decode is :func:`gla_step` in plain torch with a float32
state, as in the reference.

sLSTM is a true sequential scan (exponential gating with the m
stabilizer); its recurrence runs in ``kernels.slstm``, one launch a
call, prefill and decode alike.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.gla import gla_scan
from ..kernels.slstm import slstm
from .config import ModelConfig
from .layers import Dense, Dtypes, RMSNorm, _id_shard, normal, rmsnorm

__all__ = ["gla_chunked", "gla_step", "mlstm_scan", "Mamba2", "MLSTM",
           "SLSTM"]


# ---------------------------------------------------------------------------
# chunked GLA core
# ---------------------------------------------------------------------------

def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_a: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k: [B,H,S,dk]; v: [B,H,S,dv]; log_a: [B,H,S] (<= 0).

    Returns (o [B,H,S,dv] in v's dtype, final_state [B,H,dk,dv] float32),
    through one K10 launch on CUDA tensors (its plain version on CPU
    tensors)."""
    S = q.shape[2]
    L = min(chunk, S)
    pad = -S % L
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        log_a = F.pad(log_a, (0, pad))
    o, final = gla_scan(q, k, v, log_a, chunk=L, device=q.device)
    o = o[:, :, :S]
    if initial_state is not None:
        s0 = initial_state.float()
        g = torch.cumsum(log_a[..., :S].float(), dim=-1)         # [B,H,S]
        o = o + (torch.exp(g)[..., None] * torch.matmul(
            q[:, :, :S].float(), s0)).to(o.dtype)
        final = final + torch.exp(g[..., -1])[..., None, None] * s0
    return o, final


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_g: torch.Tensor, log_f: torch.Tensor, chunk: int,
               ssm: Optional[torch.Tensor] = None, shard=_id_shard
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The mLSTM's numerator and normalizer scans as one.  q, k, v
    [B,H,S,dh]; i_g, log_f [B,H,S] float32; ``ssm`` None (no state) or
    [B,H,dh,dh+1] float32, the numerator's state and, in its last column,
    the normalizer's.  Returns (o_num [B,H,S,dh], o_den [B,H,S] in v's
    dtype, the new ssm, or None without a state).

    The reference scans v_num = v i_g and v_den = i_g apart; here they are
    the dh + 1 columns of one v: each column of o and of the state depends
    only on its own column of v, so one scan (one ``gla_chunked``: on the
    card one K10 call, the wide route's at dh + 1 over 128) gives both, and
    the state keeps the cache's [num | den] layout.  A decode step (S = 1)
    is one ``gla_step`` over the same columns."""
    dh = v.shape[-1]
    v_num = shard(v * i_g[..., None].to(v.dtype), "heads_bhs")
    vv = torch.cat([v_num, i_g[..., None].to(v.dtype)], dim=-1)
    if ssm is None:
        o, _ = gla_chunked(q, k, vv, log_f, chunk)
    elif q.shape[2] == 1:
        o, ssm = gla_step(q[:, :, 0], k[:, :, 0], vv[:, :, 0], log_f[..., 0],
                          ssm)
        o = o[:, :, None]
    else:
        o, ssm = gla_chunked(q, k, vv, log_f, chunk, initial_state=ssm)
    return o[..., :dh], o[..., dh], ssm


def gla_step(q, k, v, log_a, state):
    """One decode step.  q,k: [B,H,dk]; v: [B,H,dv]; log_a: [B,H];
    state: [B,H,dk,dv] -> (o [B,H,dv], new state)."""
    a = torch.exp(log_a.float())[..., None, None]
    state = a * state + k.float()[..., :, None] * v.float()[..., None, :]
    o = torch.einsum("bhd,bhdv->bhv", q.float(), state)
    return o.to(v.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return d_inner, heads, cfg.ssm_state, cfg.ssm_head_dim


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """x: [B,S,C]; w: [K,C] depthwise causal conv.  Returns (y, new_state)
    where state is the trailing K-1 inputs."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    # a copy: a view would keep the whole padded input alive in the cache
    new_state = xp[:, xp.shape[1] - (K - 1):].clone()
    return y + b.to(x.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) for every x (``F.softplus``
    returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Mamba2(nn.Module):
    """The Mamba2 mixer (the reference's ``mamba2_init``); ``forward`` is
    its ``mamba2_apply`` and ``state_spec`` its ``mamba2_state_spec``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        D = cfg.d_model
        d_inner, H, N, _ = _mamba_dims(cfg)
        conv_ch = d_inner + 2 * N
        kw = dict(generator=generator, device=device)
        f32 = torch.float32
        par = lambda t: nn.Parameter(t, requires_grad=False)
        self.in_proj = Dense(D, 2 * d_inner + 2 * N + H, pd, **kw)
        self.conv_w = par(normal(generator, (cfg.ssm_conv, conv_ch), 0.1,
                                 pd, device))
        self.conv_b = par(torch.zeros((conv_ch,), dtype=pd, device=device))
        self.A_log = par(torch.zeros((H,), dtype=f32, device=device))
        self.D = par(torch.ones((H,), dtype=f32, device=device))
        self.dt_bias = par(torch.zeros((H,), dtype=f32, device=device))
        self.norm = RMSNorm(d_inner, pd, device=device)
        self.out_proj = Dense(d_inner, D, pd, **kw)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict] = None, shard=_id_shard
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B,S,D].  ``state`` = {"conv": [B,K-1,C], "ssm": [B,H,N,P]}."""
        B, S, _ = x.shape
        d_inner, H, N, P_ = _mamba_dims(cfg)
        z, xin, Bc, Cc, dt = torch.split(
            self.in_proj(x), [d_inner, d_inner, N, N, H], dim=-1)
        conv_in = torch.cat([xin, Bc, Cc], dim=-1)
        conv_out, conv_state = _causal_conv(
            conv_in, self.conv_w, self.conv_b,
            None if state is None else state["conv"])
        xin, Bc, Cc = torch.split(F.silu(conv_out), [d_inner, N, N], dim=-1)

        dt = _softplus(dt.float() + self.dt_bias)                  # [B,S,H]
        A = -torch.exp(self.A_log)                                  # [H]
        log_a = (dt * A).transpose(1, 2)                            # [B,H,S]

        xh = shard(xin.reshape(B, S, H, P_).transpose(1, 2),
                   "heads_bhs")                                     # [B,H,S,P]
        v = xh * dt.transpose(1, 2)[..., None].to(xh.dtype)
        k = Bc[:, None].expand(B, H, S, N).to(xh.dtype)
        q = Cc[:, None].expand(B, H, S, N).to(xh.dtype)

        if state is None:
            o, _ = gla_chunked(q, k, v, log_a, cfg.gla_chunk)
            new_state = None
        elif S == 1:
            o, final = gla_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                log_a[..., 0], state["ssm"])
            o = o[:, :, None]
            new_state = {"conv": conv_state, "ssm": final}
        else:
            o, final = gla_chunked(q, k, v, log_a, cfg.gla_chunk,
                                   initial_state=state["ssm"])
            new_state = {"conv": conv_state, "ssm": final}

        o = o + self.D.to(o.dtype)[None, :, None, None] * xh
        y = o.transpose(1, 2).reshape(B, S, d_inner)
        y = rmsnorm(self.norm.scale, y, cfg.norm_eps) * F.silu(z)
        return self.out_proj(y), new_state

    @staticmethod
    def state_spec(cfg: ModelConfig, batch: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{name: (shape, dtype)} of the block's recurrent state."""
        d_inner, H, N, P_ = _mamba_dims(cfg)
        conv_ch = d_inner + 2 * N
        return {"conv": ((batch, cfg.ssm_conv - 1, conv_ch),
                         Dtypes.compute(cfg)),
                "ssm": ((batch, H, N, P_), torch.float32)}


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, cfg.num_heads, d_inner // cfg.num_heads


class MLSTM(nn.Module):
    """The mLSTM mixer (the reference's ``mlstm_init``); ``forward`` is
    its ``mlstm_apply`` and ``state_spec`` its ``mlstm_state_spec``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        D = cfg.d_model
        d_inner, H, _ = _mlstm_dims(cfg)
        kw = dict(generator=generator, device=device)
        par = lambda t: nn.Parameter(t, requires_grad=False)
        self.up_proj = Dense(D, 2 * d_inner, pd, **kw)
        self.conv_w = par(normal(generator, (cfg.ssm_conv, d_inner), 0.1,
                                 pd, device))
        self.conv_b = par(torch.zeros((d_inner,), dtype=pd, device=device))
        self.wq = Dense(d_inner, d_inner, pd, **kw)
        self.wk = Dense(d_inner, d_inner, pd, **kw)
        self.wv = Dense(d_inner, d_inner, pd, **kw)
        self.w_gates = Dense(d_inner, 2 * H, pd, **kw)   # i~, f~ per head
        self.norm = RMSNorm(d_inner, pd, device=device)
        self.down_proj = Dense(d_inner, D, pd, **kw)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict] = None, shard=_id_shard
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B,S,D].  ``state`` = {"conv": [B,K-1,d_inner], "ssm":
        [B,H,dh,dh+1]}: the numerator's state and, in its last column,
        the normalizer's."""
        B, S, _ = x.shape
        d_inner, H, dh = _mlstm_dims(cfg)
        u, z = torch.chunk(self.up_proj(x), 2, dim=-1)
        c, conv_state = _causal_conv(u, self.conv_w, self.conv_b,
                                     None if state is None else state["conv"])
        c = F.silu(c)

        def heads(t):
            return shard(t.reshape(B, S, H, dh).transpose(1, 2),
                         "heads_bhs")

        q = heads(self.wq(c)) * (dh ** -0.5)
        k = heads(self.wk(c)) * (dh ** -0.5)
        v = heads(self.wv(u))
        gates = self.w_gates(u).float()                            # [B,S,2H]
        i_g = torch.sigmoid(gates[..., :H]).transpose(1, 2)        # [B,H,S]
        # jax.nn.log_sigmoid(x) = -softplus(-x)
        log_f = (-_softplus(-gates[..., H:])).transpose(1, 2)
        o_num, o_den, ssm = mlstm_scan(
            q, k, v, i_g, log_f, cfg.gla_chunk,
            None if state is None else state["ssm"], shard)
        new_state = None if state is None else {"conv": conv_state,
                                                "ssm": ssm}

        # in num's dtype, as the reference divides
        den = torch.clamp(o_den.abs(), min=1.0)
        h = o_num / den[..., None].to(o_num.dtype)
        h = h.transpose(1, 2).reshape(B, S, d_inner)
        h = rmsnorm(self.norm.scale, h, cfg.norm_eps) * F.silu(z)
        return self.down_proj(h), new_state

    @staticmethod
    def state_spec(cfg: ModelConfig, batch: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{name: (shape, dtype)} of the block's recurrent state."""
        d_inner, H, dh = _mlstm_dims(cfg)
        return {"conv": ((batch, cfg.ssm_conv - 1, d_inner),
                         Dtypes.compute(cfg)),
                "ssm": ((batch, H, dh, dh + 1), torch.float32)}


# ---------------------------------------------------------------------------
# sLSTM block (scalar LSTM with exponential gating + stabilizer)
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """The sLSTM mixer (the reference's ``slstm_init``); ``forward`` is
    its ``slstm_apply`` (the scan through ``kernels.slstm``, one launch)
    and ``state_spec`` its ``slstm_state_spec``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        pd = Dtypes.param(cfg)
        D = cfg.d_model
        self.w_in = Dense(D, 4 * D, pd, generator=generator, device=device)
        self.r = nn.Parameter(normal(generator, (4, D), 0.02, pd, device),
                              requires_grad=False)
        self.out_norm = RMSNorm(D, pd, device=device)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict] = None, shard=_id_shard
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B,S,D].  ``state`` = {"h", "c", "n", "m"}: [B,D] float32
        each (zeros when None).  ``shard`` is unused: the reference's
        sLSTM constrains no activation."""
        zifo = self.w_in(x)                                        # [B,S,4D]
        hs, new = slstm(zifo, self.r, state, device=x.device)  # x's dtype
        y = rmsnorm(self.out_norm.scale, hs, cfg.norm_eps)
        return y, None if state is None else new

    @staticmethod
    def state_spec(cfg: ModelConfig, batch: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{name: (shape, dtype)} of the block's recurrent state."""
        spec = ((batch, cfg.d_model), torch.float32)
        return {"h": spec, "c": spec, "n": spec, "m": spec}
