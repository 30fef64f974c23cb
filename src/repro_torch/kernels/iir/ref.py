"""Numpy oracle: direct-form II transposed IIR (matches scipy.lfilter).

A copy of ``repro/kernels/iir/ref.py``: the port imports nothing of
``repro``, and the tests hold the two copies to each other bitwise.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lfilter_ref"]


def lfilter_ref(b: np.ndarray, a: np.ndarray, x: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.float64) / a[0]
    a = np.asarray(a, np.float64) / a[0]
    n = len(b)
    x = np.asarray(x, np.float64)
    y = np.zeros_like(x)
    z = np.zeros(x.shape[:-1] + (n - 1,))
    for t in range(x.shape[-1]):
        xt = x[..., t]
        yt = b[0] * xt + z[..., 0]
        y[..., t] = yt
        z = np.concatenate([
            (b[1:] * xt[..., None] - a[1:] * yt[..., None]
             + np.pad(z[..., 1:], [(0, 0)] * (z.ndim - 1) + [(0, 1)]))
        ], axis=-1) if False else (
            b[1:] * xt[..., None] - a[1:] * yt[..., None]
            + np.pad(z[..., 1:], [(0, 0)] * (z.ndim - 1) + [(0, 1)]))
    return y
