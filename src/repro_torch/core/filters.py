"""Chebyshev type-I low-pass filtering of utilization time series.

The paper de-noises every captured CPU-utilization series with a 6th-order
low-pass Chebyshev filter before storing/matching (§3.1.1, §4).  The filter
is designed here (analog Chebyshev-I prototype -> frequency pre-warp ->
bilinear transform) in numpy, and applied as a direct-form-II-transposed
recurrence over float32 tensors, in the reference's order of operations
(``kernels/iir/kernel.py::df2t``, the plain version of kernel K8).

The recurrence is serial in time and tiny per step, so it runs on the host
(CPU tensors) whatever device the matcher uses: the service filters each
drained chunk there before it uploads the chunk, as the reference's
ingest layer does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..kernels.iir.kernel import coeffs as _coeffs
from ..kernels.iir.kernel import df2t as _df2t

__all__ = [
    "cheby1_design",
    "lfilter",
    "filtfilt",
    "denoise",
    "normalize01",
    "preprocess",
    "preprocess_bank",
    "StreamingFilter",
]


# ---------------------------------------------------------------------------
# Filter design (numpy, runs once at trace time)
# ---------------------------------------------------------------------------

def _cheby1_analog_prototype(order: int, ripple_db: float):
    """Poles/gain of the analog Chebyshev-I prototype (cutoff 1 rad/s)."""
    if order < 1:
        raise ValueError("order must be >= 1")
    eps = np.sqrt(10.0 ** (0.1 * ripple_db) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(1, order + 1)
    theta = np.pi * (2.0 * k - 1.0) / (2.0 * order)
    poles = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    gain = np.real(np.prod(-poles))
    if order % 2 == 0:  # even order: passband sits at -ripple dB at DC
        gain /= np.sqrt(1.0 + eps * eps)
    return poles, gain


def cheby1_design(order: int, ripple_db: float, cutoff: float) -> Tuple[np.ndarray, np.ndarray]:
    """Digital Chebyshev-I low-pass ``(b, a)``.

    ``cutoff`` is the normalized cutoff in (0, 1), as a fraction of the
    Nyquist frequency (scipy convention).  Returns float64 coefficient
    arrays of length ``order + 1``.
    """
    if not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff must be in (0,1), got {cutoff}")
    poles, gain = _cheby1_analog_prototype(order, ripple_db)

    # Pre-warp and scale the prototype (lp2lp), then bilinear transform.
    fs = 2.0
    warped = 2.0 * fs * np.tan(np.pi * cutoff / fs)
    poles = poles * warped
    gain = gain * warped ** order

    fs2 = 2.0 * fs
    z_digital = np.full(order, -1.0 + 0j)          # zeros map to z = -1
    p_digital = (fs2 + poles) / (fs2 - poles)
    gain = gain * np.real(np.prod(1.0 / (fs2 - poles)))

    b = gain * np.real(np.poly(z_digital))
    a = np.real(np.poly(p_digital))
    return b.astype(np.float64), a.astype(np.float64)


# ---------------------------------------------------------------------------
# Filter application
# ---------------------------------------------------------------------------

def lfilter(b: np.ndarray, a: np.ndarray, x) -> torch.Tensor:
    """Apply an IIR filter along the last axis (normalizes by a[0]);
    float32 in and out."""
    x = torch.as_tensor(x, dtype=torch.float32)
    b_, a_ = _coeffs(b, a)
    xf = x.reshape(-1, x.shape[-1])
    z0 = torch.zeros((xf.shape[0], b_.shape[0] - 1), dtype=torch.float32)
    y, _ = _df2t(b_, a_, xf, z0)
    return y.reshape(x.shape)


def filtfilt(b: np.ndarray, a: np.ndarray, x) -> torch.Tensor:
    """Zero-phase filtering: forward pass, reverse, forward, reverse.

    Simple odd-reflection padding at both ends to suppress edge transients.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    T = x.shape[-1]
    pad = min(3 * (max(len(a), len(b)) - 1), T - 1)
    if pad > 0:
        left = 2 * x[..., :1] - x[..., 1:pad + 1].flip(-1)
        right = 2 * x[..., -1:] - x[..., -pad - 1:-1].flip(-1)
        xp = torch.cat([left, x, right], dim=-1)
    else:
        xp = x
    y = lfilter(b, a, xp)
    y = lfilter(b, a, y.flip(-1)).flip(-1)
    if pad > 0:
        y = y[..., pad:pad + T]
    return y


# ---------------------------------------------------------------------------
# Streaming (stateful causal) filtering
# ---------------------------------------------------------------------------

class StreamingFilter:
    """Causal Chebyshev de-noise for in-flight series, chunk by chunk.

    The paper pipeline's :func:`filtfilt` is zero-phase and therefore
    anti-causal — it needs the whole series.  A job being matched *while it
    executes* only ever has a prefix, so the online path uses the causal
    forward filter with its direct-form-II-transposed state carried across
    chunks: any chunking of the input produces the same output as one
    one-shot :func:`lfilter` call (DTW downstream absorbs the filter's
    group delay).  Utilization series are already on the [0, 1] scale, so
    no running normalization is applied.
    """

    def __init__(self, order: int = None, ripple_db: float = None,
                 cutoff: float = None) -> None:
        b, a = _default_ba(order if order is not None else DEFAULT_ORDER,
                           ripple_db if ripple_db is not None
                           else DEFAULT_RIPPLE_DB,
                           cutoff if cutoff is not None else DEFAULT_CUTOFF)
        self._b, self._a = _coeffs(b, a)
        self.reset()

    def reset(self) -> None:
        self._z = torch.zeros((1, self._b.shape[0] - 1), dtype=torch.float32)

    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(chunk, np.float32).reshape(1, -1))
        y, self._z = _df2t(self._b, self._a, x, self._z)
        return y[0].numpy()


# ---------------------------------------------------------------------------
# The paper's pre-processing pipeline
# ---------------------------------------------------------------------------

#: Paper §3.1.1/§4: six-order low-pass Chebyshev filter.  Ripple/cutoff are
#: not stated in the paper; 1 dB ripple with cutoff at 0.125 Nyquist keeps
#: the multi-second phase structure of 1 Hz utilization traces while killing
#: sampling jitter.
DEFAULT_ORDER = 6
DEFAULT_RIPPLE_DB = 1.0
DEFAULT_CUTOFF = 0.125


@functools.lru_cache(maxsize=None)
def _default_ba(order: int, ripple_db: float, cutoff: float):
    return cheby1_design(order, ripple_db, cutoff)


def denoise(x, *, order: int = DEFAULT_ORDER,
            ripple_db: float = DEFAULT_RIPPLE_DB,
            cutoff: float = DEFAULT_CUTOFF,
            zero_phase: bool = True) -> torch.Tensor:
    """De-noise series (last axis) with the paper's Chebyshev low-pass."""
    b, a = _default_ba(order, ripple_db, cutoff)
    x = torch.as_tensor(x, dtype=torch.float32)
    return filtfilt(b, a, x) if zero_phase else lfilter(b, a, x)


def normalize01(x, eps: float = 1e-8) -> torch.Tensor:
    """Magnitude normalization to [0, 1] (paper §3.1.1), per series."""
    x = torch.as_tensor(x, dtype=torch.float32)
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    return (x - lo) / torch.clamp_min(hi - lo, eps)


def preprocess(x, **kw) -> torch.Tensor:
    """Full paper pre-processing: Chebyshev de-noise then [0,1] normalize."""
    return normalize01(denoise(x, **kw))


# ---------------------------------------------------------------------------
# Batched (padded-bank) pre-processing
# ---------------------------------------------------------------------------

def preprocess_bank(x, lengths, **kw) -> np.ndarray:
    """Paper pre-processing over a padded ``[K, M]`` bank, row-for-row
    **identical** to the scalar :func:`preprocess` of each unpadded series.

    ``filtfilt``'s backward pass is anti-causal, so filtering the padded
    rows directly would bleed the padding's edge transient back into the
    valid prefix.  Instead rows are grouped by true length and each group
    is processed as one batch at its native length, then re-packed with
    edge padding.  Returns a float32 numpy array [K, M].
    """
    x = np.asarray(x, np.float32)
    lengths = np.asarray(lengths, np.int64).reshape(-1)
    out = np.empty_like(x)
    for l in np.unique(lengths):
        idx = np.nonzero(lengths == l)[0]
        block = preprocess(torch.from_numpy(x[idx, :l]), **kw).numpy()
        out[idx, :l] = block
        out[idx, l:] = block[:, -1:]
    return out
