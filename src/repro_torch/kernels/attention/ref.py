"""Numpy oracle: causal GQA softmax attention.

A copy of ``repro/kernels/attention/ref.py``: the port imports nothing of
``repro``, and the tests hold the two copies to each other bitwise.
"""

from __future__ import annotations

import numpy as np

__all__ = ["attention_ref"]


def attention_ref(q: np.ndarray, k: np.ndarray, v: np.ndarray,
                  causal: bool = True) -> np.ndarray:
    """q: [B,H,S,dh]; k/v: [B,KV,T,dh] -> [B,H,S,dv] (float64 math)."""
    q = np.asarray(q, np.float64)
    k = np.asarray(k, np.float64)
    v = np.asarray(v, np.float64)
    B, H, S, dh = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    out = np.empty((B, H, S, v.shape[-1]))
    for b in range(B):
        for h in range(H):
            kv = h // G
            s = (q[b, h] @ k[b, kv].T) * scale
            if causal:
                mask = np.tril(np.ones((S, T), bool), k=T - S)
                s = np.where(mask, s, -np.inf)
            s = s - s.max(axis=-1, keepdims=True)
            p = np.exp(s)
            p /= p.sum(axis=-1, keepdims=True)
            out[b, h] = p @ v[b, kv]
    return out
