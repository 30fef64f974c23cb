"""Numpy oracle: step-by-step gated linear attention recurrence.

A copy of ``repro/kernels/gla/ref.py``: the port imports nothing of
``repro``, and the tests hold the two copies to each other bitwise.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gla_ref"]


def gla_ref(q, k, v, log_a, initial_state=None):
    """q,k: [B,H,S,dk]; v: [B,H,S,dv]; log_a: [B,H,S].
    Returns (o, final_state) in float64."""
    q = np.asarray(q, np.float64)
    k = np.asarray(k, np.float64)
    v = np.asarray(v, np.float64)
    log_a = np.asarray(log_a, np.float64)
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    state = (np.zeros((B, H, dk, dv)) if initial_state is None
             else np.asarray(initial_state, np.float64).copy())
    o = np.empty((B, H, S, dv))
    for t in range(S):
        a = np.exp(log_a[..., t])[..., None, None]
        state = a * state + np.einsum("bhd,bhv->bhdv", k[..., t, :], v[..., t, :])
        o[..., t, :] = np.einsum("bhd,bhdv->bhv", q[..., t, :], state)
    return o, state
