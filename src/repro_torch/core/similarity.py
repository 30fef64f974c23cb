"""Similarity measurement (paper §3.1.3, Eq. 3) and the matching phase
(paper Fig. 4-b) — the port of ``repro.core.similarity``.

After DTW aligns a reference series Y into Y' (the length of the query
X), the similarity is the correlation CORR(X, Y'); ``CORR >= 0.9`` is an
acceptable match.  The matching phase compares a new application's
series, per configuration-parameter set, with every database
application's series for the same set, and the application with the
most >= 0.9 wins is the most similar.  Scores are the raw Pearson
correlation in [-1, 1]; the threshold is the only place a clamp
semantically happens.

Two engines score a query against a padded ``[K, M]`` bank
(``database.SeriesBank``):

* :func:`similarity_bank` (default): the matrix-free closed-end moment
  scorer (``dtw.dtw_score_bank``, kernel K2), one launch for all K
  references, no matrix, no host backtracking.
* ``similarity_bank(matrix_path=True)``: one ``dtw.dtw_matrix_bank``
  launch (kernel K7) per chunk of at most :data:`MAX_MATRIX_ELEMS`
  matrix elements, copied to the host and backtracked there per
  reference, then correlated (the reference path).

The two agree bitwise-path on tie-free (dyadic-grid) data and to
warp-path-tie tolerance elsewhere.  :func:`match_application` scores
every (parameter set, application) pair with one launch of K2's pairs
entry (``dtw.dtw_score_pairs``); :func:`prefix_similarity_bank` scores a
partial query from streamed DP rows (``tuner.OnlineMatcher``).  The
scalar :func:`similarity` (one K7 launch and a backtrack) is the
reference implementation.  Every entry point runs on ``device``, CUDA
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from . import dtw as _dtw
from . import filters as _filters
from .database import SeriesBank, pack_series
from ..kernels.common import resolve_device

__all__ = ["correlation", "similarity", "similarity_bank", "MatchResult",
           "match_series", "match_application", "MATCH_THRESHOLD",
           "RunningMoments", "prefix_similarity_bank", "MAX_MATRIX_ELEMS"]

Device = Union[str, torch.device, None]

#: Paper §3.1.3: acceptable-match threshold.
MATCH_THRESHOLD = 0.9

#: Chunk bound for the [K, N, M] accumulated-cost stack of one launch
#: (2**27 f32 elements = 512 MiB).  Typical DB banks fit in one chunk.
MAX_MATRIX_ELEMS = 1 << 27


def correlation(x: np.ndarray, y: np.ndarray) -> float:
    """Pearson correlation coefficient between equal-length series."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {x.shape} vs {y.shape}")
    xc = x - x.mean()
    yc = y - y.mean()
    vx = (xc * xc).sum()
    vy = (yc * yc).sum()
    # Relative degeneracy guard: cancellation on a constant series leaves
    # a residue proportional to the uncentred energy, not an absolute
    # epsilon.
    degx = vx <= 1e-10 * (x * x).sum() + 1e-12
    degy = vy <= 1e-10 * (y * y).sum() + 1e-12
    if degx or degy:
        return 1.0 if np.allclose(x, y) else 0.0
    return float((xc * yc).sum() / np.sqrt(vx * vy))


def _preprocess(x) -> np.ndarray:
    return _filters.preprocess(np.asarray(x, np.float32)).numpy()


def similarity(x: np.ndarray, y: np.ndarray, *, preprocess: bool = False,
               band: Optional[int] = None, device: Device = None) -> float:
    """SIM(X, Y) in [-1, 1]: DTW-align Y to X (K7 on ``device``), then
    CORR(X, Y').  ``preprocess=True`` runs the paper's Chebyshev de-noise
    and [0, 1] normalization on both series first."""
    dev = resolve_device(device)
    if preprocess:
        x, y = _preprocess(x), _preprocess(y)
    yp, _ = _dtw.dtw_warp(x, y, band=band, device=dev)
    return float(np.clip(correlation(x, yp), -1.0, 1.0))


def _as_bank(references: Union[SeriesBank, np.ndarray, Sequence[np.ndarray]],
             lengths: Optional[np.ndarray]) -> SeriesBank:
    if isinstance(references, SeriesBank):
        if lengths is not None:
            raise ValueError("lengths is implied by the SeriesBank")
        return references
    if isinstance(references, np.ndarray):
        if references.ndim != 2:
            raise ValueError(
                f"references array must be [K, M], got shape "
                f"{references.shape}; wrap a single series in a list")
        if lengths is None:
            lengths = np.full((references.shape[0],), references.shape[1],
                              np.int32)
        return SeriesBank(np.asarray(references, np.float32),
                          np.asarray(lengths, np.int32))
    # ragged sequence of 1-D series: each element's own length counts
    if lengths is not None:
        raise ValueError("lengths only applies to a padded 2-D bank; pass "
                         "a [K, M] array (or a SeriesBank) with it")
    return pack_series(list(references))


def _warp_corr(x: np.ndarray, y: np.ndarray, D: np.ndarray) -> float:
    """Host-side Eq. 3 tail: backtrack D, warp Y to Y', correlate."""
    path = _dtw.backtrack(D)
    yp = _dtw.warp_to(y, path, len(x))
    return float(np.clip(correlation(np.asarray(x, np.float64), yp),
                         -1.0, 1.0))


def similarity_bank(x: np.ndarray,
                    references: Union[SeriesBank, np.ndarray,
                                      Sequence[np.ndarray]],
                    lengths: Optional[np.ndarray] = None, *,
                    preprocess: bool = False,
                    band: Optional[int] = None,
                    matrix_path: bool = False,
                    device: Device = None) -> np.ndarray:
    """SIM(X, Y_k) for every reference in a bank -> float64 [K].

    Default engine: the matrix-free closed-end moment scorer (K2), one
    launch against the bank's memoized device upload
    (``SeriesBank.score_plan``).  ``matrix_path=True``: K7 matrices
    ([K, N, M], chunked to :data:`MAX_MATRIX_ELEMS` elements a launch)
    backtracked on the host.  ``preprocess=True`` applies the paper
    pipeline to the query and the whole bank (memoized on the bank)."""
    dev = resolve_device(device)
    bank = _as_bank(references, lengths)
    x = np.asarray(x, np.float32).reshape(-1)
    if len(bank) == 0:
        return np.zeros((0,), np.float64)
    if preprocess:
        x = _preprocess(x)
        bank = bank.preprocessed()
    if not matrix_path:
        return _dtw.dtw_score_bank(
            x, bank.series, bank.lengths, band=band,
            plan=bank.score_plan(dev)).double().cpu().numpy()
    k, m = bank.series.shape
    n = x.shape[0]
    chunk = max(1, int(MAX_MATRIX_ELEMS // max(n * m, 1)))
    out = np.empty((k,), np.float64)
    for lo in range(0, k, chunk):
        hi = min(lo + chunk, k)
        D = _dtw.dtw_matrix_bank(x, bank.series[lo:hi], bank.lengths[lo:hi],
                                 band=band, device=dev).cpu().numpy()
        for r in range(lo, hi):
            l = int(bank.lengths[r])
            out[r] = _warp_corr(x, bank.series[r, :l], D[r - lo, :, :l])
    return out


# ---------------------------------------------------------------------------
# Prefix (streaming) scoring
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunningMoments:
    """Single-pass correlation accumulator over aligned sample pairs.

    The streaming scorer re-derives the warp path every tick (it can change
    as the prefix grows) but correlates along it in one pass with these
    running moments instead of the offline two-pass :func:`correlation`;
    float64 accumulators keep the two within ~1e-7 on [0, 1] utilization
    series.  Degenerate (constant) series follow :func:`correlation`'s
    convention: 1.0 when the pair is (all-close) identical, else 0.0.
    """
    n: int = 0
    sx: float = 0.0
    sy: float = 0.0
    sxx: float = 0.0
    syy: float = 0.0
    sxy: float = 0.0

    def update(self, x: np.ndarray, y: np.ndarray) -> "RunningMoments":
        x = np.asarray(x, np.float64).reshape(-1)
        y = np.asarray(y, np.float64).reshape(-1)
        self.n += x.shape[0]
        self.sx += float(x.sum())
        self.sy += float(y.sum())
        self.sxx += float((x * x).sum())
        self.syy += float((y * y).sum())
        self.sxy += float((x * y).sum())
        return self

    @property
    def corr(self) -> float:
        if self.n == 0:
            return 0.0
        vx = max(self.sxx - self.sx * self.sx / self.n, 0.0)
        vy = max(self.syy - self.sy * self.sy / self.n, 0.0)
        # Relative degeneracy guard (see :func:`correlation`): cancellation
        # residue on constant series scales with the uncentered moments.
        degx = vx <= 1e-10 * (self.sxx + self.sx * self.sx / self.n) + 1e-12
        degy = vy <= 1e-10 * (self.syy + self.sy * self.sy / self.n) + 1e-12
        if degx or degy:
            mean_close = abs(self.sx - self.sy) / self.n < 1e-6
            return 1.0 if degx and degy and mean_close else 0.0
        cov = self.sxy - self.sx * self.sy / self.n
        return float(np.clip(cov / np.sqrt(vx * vy), -1.0, 1.0))


#: "No band argument given" sentinel for :func:`prefix_similarity_bank`:
#: the caller's streamed rows already embed whatever banding the stream
#: used, so only an EXPLICIT band (None included) licenses the rows-free
#: matrix-free closed-end path.
_BAND_UNSET = object()


def prefix_similarity_bank(x_prefix: np.ndarray, bank: SeriesBank,
                           rows: Optional[np.ndarray] = None, *,
                           open_end: bool = True,
                           band=_BAND_UNSET,
                           device: Device = None) -> np.ndarray:
    """SIM of a *partial* query against every reference -> float64 [K].

    ``rows`` is the [n, K, M] stack of streamed DP rows (what
    ``dtw.dtw_bank_extend(..., collect_rows=True)`` hands back,
    accumulated across chunks; numpy or a tensor).  ``open_end=True``
    scores each reference against its best matching prefix (backtrack
    from the argmin of the last row); ``open_end=False`` uses the full
    reference endpoint ``len_k - 1``.  The closed-end branch is
    matrix-free (K2 on ``device``, no rows needed) when ``band`` is
    passed explicitly (``None`` meaning unbanded); otherwise the rows are
    backtracked on the host."""
    x = np.asarray(x_prefix, np.float64).reshape(-1)
    if not open_end and band is not _BAND_UNSET:
        dev = resolve_device(device)
        return _dtw.dtw_score_bank(
            x, bank.series, bank.lengths, band=band,
            plan=bank.score_plan(dev)).double().cpu().numpy()
    if rows is None:
        raise ValueError("rows are required unless scoring closed-end "
                         "with an explicit band= (the matrix-free path)")
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    rows = np.asarray(rows)
    n, k, _ = rows.shape
    if n != x.shape[0]:
        raise ValueError(f"{x.shape[0]} query samples but {n} DP rows")
    out = np.empty((k,), np.float64)
    for r in range(k):
        l = int(bank.lengths[r])
        D = rows[:, r, :l]
        j_end = int(np.argmin(D[-1])) if open_end else l - 1
        path = _dtw.backtrack(D[:, : j_end + 1])
        yp = _dtw.warp_to(bank.series[r, : j_end + 1], path, n)
        out[r] = RunningMoments().update(x, yp).corr
    return out


@dataclasses.dataclass
class MatchResult:
    """Outcome of the matching phase for one query application."""
    best: Optional[str]                 # app with most >=threshold wins
    wins: Mapping[str, int]             # per-app count of matched param sets
    scores: Mapping[str, Sequence[float]]  # per-app raw CORR per param set
    threshold: float = MATCH_THRESHOLD


def match_series(query: np.ndarray, references: Mapping[str, np.ndarray],
                 *, preprocess: bool = True, band: Optional[int] = None,
                 device: Device = None) -> Mapping[str, float]:
    """Similarity of one query series against named reference series,
    one scorer launch for the whole set."""
    names = list(references)
    bank = pack_series([references[nm] for nm in names], labels=names)
    sims = similarity_bank(query, bank, preprocess=preprocess, band=band,
                           device=device)
    return {nm: float(s) for nm, s in zip(names, sims)}


def match_application(query_series: Sequence[np.ndarray],
                      reference_series: Mapping[str, Sequence[np.ndarray]],
                      *, threshold: float = MATCH_THRESHOLD,
                      preprocess: bool = True,
                      band: Optional[int] = None,
                      device: Device = None) -> MatchResult:
    """Paper Fig. 4-b: per parameter set j, score the query's series j
    against every reference app's series j; an app scores a *win* when
    its CORR is the highest of all apps AND >= threshold.  The app with
    the most wins is the match.  Every (parameter set, app) pair is
    scored by one launch of K2's pairs entry, ragged on both sides."""
    dev = resolve_device(device)
    names = list(reference_series)
    napps = {name: len(s) for name, s in reference_series.items()}
    nsets = len(query_series)
    for name, kk in napps.items():
        if kk != nsets:
            raise ValueError(f"{name} has {kk} series, query has {nsets}")
    if nsets == 0 or not names:
        return MatchResult(best=None, wins={name: 0 for name in names},
                           scores={name: [] for name in names},
                           threshold=threshold)

    qbank = pack_series(list(query_series))
    rbank = pack_series([reference_series[name][j]
                         for name in names for j in range(nsets)])
    if preprocess:
        qbank = qbank.preprocessed()
        rbank = rbank.preprocessed()

    # pair p = (app a, set j) -> query row j, reference row a * nsets + j
    qidx = np.tile(np.arange(nsets), len(names))
    xs, xl = qbank.series[qidx], qbank.lengths[qidx]
    corr = _dtw.dtw_score_pairs(xs, rbank.series, xl, rbank.lengths,
                                band=band, device=dev
                                ).double().cpu().numpy()

    scores = {name: [float(corr[a * nsets + j]) for j in range(nsets)]
              for a, name in enumerate(names)}
    wins = {name: 0 for name in names}
    for j in range(nsets):
        best_name = max(names, key=lambda nm: scores[nm][j])
        if scores[best_name][j] >= threshold:
            wins[best_name] += 1

    best = max(wins, key=lambda kk: wins[kk]) if wins else None
    if best is not None and wins[best] == 0:
        best = None
    return MatchResult(best=best, wins=wins, scores=scores,
                       threshold=threshold)
