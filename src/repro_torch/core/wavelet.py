"""Haar wavelet compression of utilization series; the port of
``repro.core.wavelet``.

The paper notes DTW's quadratic cost makes cluster-scale matching (3N
series per N-node cluster) expensive, and proposes representing each
series by M wavelet coefficients so equal-length series can be compared
with a plain distance instead of DTW.  This module holds a Haar DWT,
top-|coefficient| truncation and the fast matcher;
``AutoTuner(wavelet_prefilter=)`` ranks candidates with
:func:`wavelet_similarity_bank` before its narrowed DTW match.

The **streaming** half (:class:`StreamingHaar`) maintains the Haar
coefficients of an in-flight job's edge-extended prefix incrementally:
each arriving chunk dirties only the coefficient pyramid to the right of
the first changed sample, so an update costs O(size - n) instead of an
O(size log size) full re-transform, and equals the offline
:func:`haar_dwt` of the same padded prefix at every chunk boundary,
bit for bit.  ``serve.tuning.TuningService(prefilter_top=)`` ranks the
reference bank against these prefix coefficients to prune the scored
streaming tick at large K.

Host code in float64 numpy, as in the reference, so every function is
bitwise the reference's on the same inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

__all__ = ["haar_dwt", "haar_idwt", "compress", "reconstruct",
           "wavelet_distance", "wavelet_similarity", "match_series_wavelet",
           "haar_dwt_bank", "compress_bank", "wavelet_similarity_bank",
           "StreamingHaar", "coeff_similarity_bank"]

_SQRT2 = np.sqrt(2.0)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def haar_dwt(x: np.ndarray) -> np.ndarray:
    """Full Haar decomposition.  Pads (edge) to a power of two.

    Layout: [approx | level_k detail | ... | level_1 detail] — i.e. the
    coarsest coefficients first.
    """
    x = np.asarray(x, np.float64)
    n = _next_pow2(len(x))
    if n != len(x):
        x = np.pad(x, (0, n - len(x)), mode="edge")
    out = []
    cur = x
    while len(cur) > 1:
        even, odd = cur[0::2], cur[1::2]
        out.append((even - odd) / _SQRT2)     # detail
        cur = (even + odd) / _SQRT2           # approximation
    out.append(cur)                            # final approx, length 1
    return np.concatenate(out[::-1])


def haar_idwt(c: np.ndarray) -> np.ndarray:
    """Inverse of :func:`haar_dwt` (returns the padded power-of-two length)."""
    c = np.asarray(c, np.float64)
    n = len(c)
    cur = c[:1]
    pos = 1
    while pos < n:
        detail = c[pos:pos + len(cur)]
        even = (cur + detail) / _SQRT2
        odd = (cur - detail) / _SQRT2
        nxt = np.empty(2 * len(cur))
        nxt[0::2], nxt[1::2] = even, odd
        pos += len(cur)
        cur = nxt
    return cur


def compress(x: np.ndarray, m: int) -> np.ndarray:
    """Keep the M highest-energy coefficients (others zeroed), as the paper
    proposes; returns the full-length sparse coefficient vector so distance
    computation stays a plain vector op."""
    c = haar_dwt(x)
    if m >= len(c):
        return c
    keep = np.argsort(np.abs(c))[::-1][:m]
    out = np.zeros_like(c)
    out[keep] = c[keep]
    return out


def reconstruct(c: np.ndarray, length: int) -> np.ndarray:
    return haar_idwt(c)[:length]


def wavelet_distance(cx: np.ndarray, cy: np.ndarray) -> float:
    """Plain Euclidean distance between (equal-length) coefficient vectors —
    the paper's replacement for DTW on compressed series."""
    n = max(len(cx), len(cy))
    cx = np.pad(cx, (0, n - len(cx)))
    cy = np.pad(cy, (0, n - len(cy)))
    return float(np.linalg.norm(cx - cy))


def wavelet_similarity(x: np.ndarray, y: np.ndarray, m: int = 64) -> float:
    """Similarity in [0, 1] from compressed-domain correlation."""
    n = max(_next_pow2(len(x)), _next_pow2(len(y)))
    xp = np.pad(np.asarray(x, np.float64), (0, n - len(x)), mode="edge")
    yp = np.pad(np.asarray(y, np.float64), (0, n - len(y)), mode="edge")
    cx, cy = compress(xp, m), compress(yp, m)
    num = float((cx * cy).sum())
    den = float(np.linalg.norm(cx) * np.linalg.norm(cy))
    if den < 1e-12:
        return 1.0 if np.allclose(cx, cy) else 0.0
    return float(np.clip(num / den, 0.0, 1.0))


def match_series_wavelet(query: np.ndarray,
                         references: Mapping[str, np.ndarray],
                         m: int = 64) -> Mapping[str, float]:
    return {name: wavelet_similarity(query, ref, m=m)
            for name, ref in references.items()}


# ---------------------------------------------------------------------------
# Batched (bank) variants — vectorized over K series at once
# ---------------------------------------------------------------------------

def haar_dwt_bank(x: np.ndarray) -> np.ndarray:
    """Row-wise Haar decomposition of ``[K, T]`` (edge-pads T to a power of
    two); same coefficient layout as :func:`haar_dwt` per row."""
    x = np.asarray(x, np.float64)
    n = _next_pow2(x.shape[1])
    if n != x.shape[1]:
        x = np.pad(x, ((0, 0), (0, n - x.shape[1])), mode="edge")
    out = []
    cur = x
    while cur.shape[1] > 1:
        even, odd = cur[:, 0::2], cur[:, 1::2]
        out.append((even - odd) / _SQRT2)
        cur = (even + odd) / _SQRT2
    out.append(cur)
    return np.concatenate(out[::-1], axis=1)


def compress_bank(c: np.ndarray, m: int) -> np.ndarray:
    """Per-row top-|coefficient| truncation of a ``[K, P]`` coefficient
    bank (row-wise :func:`compress` tail)."""
    c = np.asarray(c, np.float64)
    if m >= c.shape[1]:
        return c
    keep = np.argpartition(np.abs(c), -m, axis=1)[:, -m:]
    out = np.zeros_like(c)
    np.put_along_axis(out, keep, np.take_along_axis(c, keep, axis=1), axis=1)
    return out


def wavelet_similarity_bank(x: np.ndarray, bank: np.ndarray,
                            lengths: np.ndarray, m: int = 64) -> np.ndarray:
    """Compressed-domain similarity of one query against a padded bank ->
    [K] in [0, 1] — the whole-DB form of :func:`wavelet_similarity`, used
    as the AutoTuner's fast prefilter ranking.

    All series are edge-extended to one common power-of-two length (the
    scalar function picks it per pair), so values can differ slightly from
    per-pair calls when lengths are very unequal; the *ranking* is what the
    prefilter consumes.
    """
    bank = np.asarray(bank, np.float64)
    lengths = np.asarray(lengths)
    x = np.asarray(x, np.float64).reshape(-1)
    k, width = bank.shape
    if k == 0:
        return np.zeros((0,), np.float64)
    n = max(_next_pow2(len(x)),
            _next_pow2(int(lengths.max()) if k else 1))
    xp = np.pad(x, (0, n - len(x)), mode="edge")
    if n >= width:
        # bank rows already repeat their edge value past lengths[k]
        bp = np.pad(bank, ((0, 0), (0, n - width)), mode="edge")
    else:
        bp = bank[:, :n]
    cx = compress(xp, m)
    cb = compress_bank(haar_dwt_bank(bp), m)
    return coeff_similarity_bank(cx, cb)


def coeff_similarity_bank(cx: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """Cosine similarity of one (compressed) coefficient vector against a
    ``[K, P]`` compressed coefficient bank -> [K] in [0, 1].

    The scoring tail of :func:`wavelet_similarity_bank`, split out so the
    streaming prefilter (which already holds :class:`StreamingHaar`
    prefix coefficients) can rank the bank without re-transforming
    anything."""
    num = cb @ cx
    den = np.linalg.norm(cx) * np.linalg.norm(cb, axis=1)
    sims = np.where(den < 1e-12,
                    np.all(np.isclose(cb, cx[None, :]), axis=1).astype(float),
                    num / np.maximum(den, 1e-300))
    return np.clip(sims, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Streaming (prefix) Haar — the online prefilter's transform
# ---------------------------------------------------------------------------

class StreamingHaar:
    """Incremental Haar decomposition of an in-flight job's prefix.

    After ``update()`` has consumed ``n`` samples, :meth:`coeffs` equals
    ``haar_dwt(edge-extension of x[:n] to the fixed power-of-two target
    length)`` exactly — same layout (coarsest first), bitwise-identical
    values — without re-transforming the whole series: appending a chunk
    changes samples ``[n_old, size)`` (the new samples plus the moved
    edge extension), so only pyramid positions at or right of
    ``n_old >> level`` are recomputed per level.

    ``total_len`` is the job's *expected* length (the prefilter target
    resolution); a job that overruns the power-of-two target transparently
    regrows to the next one (full O(size) rebuild, amortized by the
    doubling).
    """

    def __init__(self, total_len: int) -> None:
        if total_len < 1:
            raise ValueError("total_len must be >= 1")
        self.n = 0
        self._samples = np.zeros((0,), np.float64)
        self._alloc(_next_pow2(max(int(total_len), 2)))

    def _alloc(self, size: int) -> None:
        self.size = size
        self._x = np.zeros((size,), np.float64)
        self._detail = []
        self._approx = []
        while size > 1:
            size //= 2
            self._detail.append(np.zeros((size,), np.float64))
            self._approx.append(np.zeros((size,), np.float64))

    def _refresh(self, dirty: int) -> None:
        """Recompute the pyramid from level-0 position ``dirty`` up."""
        cur = self._x
        for det, apx in zip(self._detail, self._approx):
            dirty //= 2
            even = cur[2 * dirty::2]
            odd = cur[2 * dirty + 1::2]
            det[dirty:] = (even - odd) / _SQRT2
            apx[dirty:] = (even + odd) / _SQRT2
            cur = apx

    def update(self, chunk: np.ndarray) -> "StreamingHaar":
        """Consume one chunk of samples; O(size - n + log size) work."""
        chunk = np.asarray(chunk, np.float64).reshape(-1)
        if chunk.shape[0] == 0:
            return self
        self._samples = np.concatenate([self._samples, chunk])
        n0, self.n = self.n, self.n + chunk.shape[0]
        if self.n > self.size:
            self._alloc(_next_pow2(self.n))
            n0 = 0
        self._x[n0: self.n] = self._samples[n0: self.n]
        self._x[self.n:] = self._samples[-1]        # edge extension
        self._refresh(n0)
        return self

    def coeffs(self) -> np.ndarray:
        """Haar coefficients of the edge-extended prefix, in
        :func:`haar_dwt` layout (``[approx | coarsest .. finest
        detail]``) at the current target ``size``."""
        if not self._detail:                         # size == 1 degenerate
            return self._x.copy()
        return np.concatenate(
            [self._approx[-1]] + self._detail[::-1])

    def compressed(self, m: int) -> np.ndarray:
        """Top-|coefficient| truncation of :meth:`coeffs` (the vector the
        prefilter ranks the bank against)."""
        return compress_bank(self.coeffs()[None, :], m)[0]
