"""The chunked gated-linear-attention (GLA) core and the Mamba2 (SSD)
block — the port of ``repro/models/ssm.py`` (lines 44-207).

Mamba2 is an instance of the per-head recurrence::

    S_t = a_t * S_{t-1} + k_t^T v_t          (state  [d_k, d_v])
    o_t = q_t @ S_t

with q = C, k = B, v = dt * x and log a = -dt * exp(A_log) (d_k = N,
d_v = P), and a per-step scalar decay ``a_t = exp(log_a_t) <= 1``.

The route to K10: :func:`gla_chunked` runs ``kernels.gla.gla_scan``.  It
pads S at the end to a multiple of the chunk with q = k = v = 0 and
log_a = 0, which leaves the real rows and the final state exact.  K10
takes no initial state (as the reference's ``gla_kernel_call`` takes
none), so an initial state S0 enters here, in float32, by linearity:
``o_t += exp(sum_{u<=t} log_a_u) q_t S0`` and ``final += exp(sum log_a)
S0``; at a prefill from an empty cache the term is exactly zero.
Decode is :func:`gla_step` in plain torch with a float32 state, as in
the reference.

mLSTM and sLSTM (xLSTM) are the next slice but one of the port.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.gla import gla_scan
from .config import ModelConfig
from .layers import Dense, Dtypes, RMSNorm, normal, rmsnorm

__all__ = ["gla_chunked", "gla_step", "Mamba2"]


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
                state: Optional[Dict] = None
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

        xh = xin.reshape(B, S, H, P_).transpose(1, 2)               # [B,H,S,P]
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
