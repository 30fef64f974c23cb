"""AutoTuner — the paper's end goal — and the single-job streaming
matcher; the port of ``repro.core.tuner``.

Given a new workload, the tuner (1) stores profiled, de-noised
utilization series of known workloads with their best-known
configurations (paper Fig. 4-a), (2) matches a new workload's series
against every candidate entry with the paper's DTW + correlation
pipeline in one scorer launch (``similarity.similarity_bank``, kernel K2,
against the DB's cached padded bank), and (3) if the best match clears
the 0.9 threshold, transfers that workload's configuration instead of
running a parameter search (Fig. 4-b).  Scores are raw correlations in
[-1, 1].

:class:`OnlineMatcher` matches ONE in-flight job while it runs: each
arriving chunk advances the streaming bank DP (``dtw.dtw_bank_extend``,
one K7 launch resumed from the carried row), and the consumed prefix is
scored from the collected rows on the host.  A service multiplexing many
jobs uses ``serve.tuning.TuningService`` instead.

Both run on ``device``, CUDA unless the caller passes ``device="cpu"``.
``AutoTuner(wavelet_prefilter=P)`` ranks the candidates by the batched
wavelet-domain similarity (``wavelet.wavelet_similarity_bank``, numpy on
the host) and scores only the top P with the DTW pipeline (one K2
launch).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from . import dtw as _dtw
from . import filters as _filters
from . import wavelet as _wavelet
from .database import ReferenceDB, SeriesBank
from .similarity import (MATCH_THRESHOLD, prefix_similarity_bank,
                         similarity_bank as _sim_bank)
from ..kernels.common import resolve_device

__all__ = ["TuneDecision", "AutoTuner", "OnlineMatcher"]


@dataclasses.dataclass
class TuneDecision:
    workload: str
    matched: Optional[str]            # workload id of the best DB match
    corr: float                       # best raw correlation in [-1, 1]
    # (-1.0 when there were no candidates at all)
    config: Optional[Dict[str, Any]]  # transferred exec config (None -> search)
    scores: Dict[str, float]          # all candidate raw correlations
    used_wavelet_prefilter: bool = False
    # streaming decisions (serve.tuning.TuningService): how much of the job
    # had been observed, and whether this is the early (prefix) or the
    # final (complete-series, offline-exact) verdict.
    fraction_seen: Optional[float] = None
    final: bool = True
    # fraction of the job observed when the streaming service first
    # committed to a match (== fraction_seen for early decisions; carried
    # onto the final verdict; 1.0 when no early decision fired).  This is
    # the datum ReferenceDB's decision history accumulates so the
    # margin / stable_ticks / min_fraction rule can be calibrated per
    # workload family instead of fixed constants (ROADMAP).
    decided_at_fraction: Optional[float] = None
    # Calibrated match probability P[true warp correlation >= threshold]
    # under the query's per-sample measurement variance (the uncertain-
    # series matcher, arXiv:1112.5505).  None when the decision came from
    # the exact (point-correlation) rule; at zero input variance the
    # probability is exactly 0.0/1.0 and the two rules coincide bitwise.
    probability: Optional[float] = None

    def to_record(self) -> Dict[str, Any]:
        """JSON-serializable form for ``ReferenceDB`` decision history
        (drops the transferred config — history is for calibration, and
        configs live on the matched entry already)."""
        return {"workload": self.workload, "matched": self.matched,
                "corr": float(self.corr),
                "scores": {k: float(v) for k, v in self.scores.items()},
                "fraction_seen": self.fraction_seen,
                "decided_at_fraction": self.decided_at_fraction,
                "final": bool(self.final),
                "probability": (None if self.probability is None
                                else float(self.probability))}

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "TuneDecision":
        return cls(workload=rec["workload"], matched=rec.get("matched"),
                   corr=float(rec.get("corr", -1.0)), config=None,
                   scores=dict(rec.get("scores", {})),
                   fraction_seen=rec.get("fraction_seen"),
                   final=bool(rec.get("final", True)),
                   decided_at_fraction=rec.get("decided_at_fraction"),
                   probability=rec.get("probability"))


class AutoTuner:
    def __init__(self, db: ReferenceDB, *, threshold: float = MATCH_THRESHOLD,
                 band: Optional[int] = None,
                 wavelet_prefilter: int = 0,
                 wavelet_coeffs: int = 64,
                 device: Union[str, torch.device, None] = None) -> None:
        """``wavelet_prefilter``: if >0, rank candidates by the fast
        wavelet-domain similarity first and run full DTW only on the top-k
        (the paper's future-work scaling fix)."""
        self.db = db
        self.threshold = threshold
        self.band = band
        self.wavelet_prefilter = wavelet_prefilter
        self.wavelet_coeffs = wavelet_coeffs
        self.device = resolve_device(device)

    # -- profiling -------------------------------------------------------------
    @staticmethod
    def preprocess(series: np.ndarray) -> np.ndarray:
        """Paper pipeline: Chebyshev de-noise + [0,1] normalization."""
        return _filters.preprocess(np.asarray(series, np.float32)).numpy()

    def profile(self, workload: str, params: Mapping[str, Any],
                series: np.ndarray, **meta: Any) -> None:
        """Store a (de-noised) profiled series in the reference DB."""
        self.db.add(workload, params, self.preprocess(series), **meta)

    # -- matching ----------------------------------------------------------------
    def match(self, workload: str, series: np.ndarray,
              exclude: Sequence[str] = ()) -> TuneDecision:
        """Score the query against every candidate DB entry in one scorer
        launch and transfer the best match's config if its raw
        correlation clears the threshold."""
        q = self.preprocess(series)
        candidates = [w for w in self.db.workloads()
                      if w != workload and w not in exclude]

        used_prefilter = False
        if self.wavelet_prefilter and len(candidates) > self.wavelet_prefilter:
            used_prefilter = True
            bank = self.db.bank(workloads=candidates)
            wsims = _wavelet.wavelet_similarity_bank(
                q, bank.series, bank.lengths, m=self.wavelet_coeffs)
            wbest: Dict[str, float] = {}
            for lbl, s in zip(bank.labels, wsims):
                wbest[lbl] = max(wbest.get(lbl, -1.0), float(s))
            ranked = sorted(candidates, key=lambda w: wbest[w], reverse=True)
            candidates = ranked[:self.wavelet_prefilter]

        scores: Dict[str, float] = {}
        if candidates:
            bank = self.db.bank(workloads=candidates)
            corrs = _sim_bank(q, bank, preprocess=False, band=self.band,
                              device=self.device)
            for lbl, c in zip(bank.labels, corrs):
                scores[lbl] = max(scores.get(lbl, -1.0), float(c))

        matched, corr = None, -1.0
        for w in candidates:          # insertion order, ties -> first
            c = scores[w]
            if c > corr:
                matched, corr = w, c

        config = None
        if matched is not None and corr >= self.threshold:
            config = self.db.best_config(matched)
        else:
            matched = None if corr < self.threshold else matched
        return TuneDecision(workload=workload, matched=matched, corr=corr,
                            config=config, scores=scores,
                            used_wavelet_prefilter=used_prefilter)

    # -- feedback ------------------------------------------------------------------
    def record(self, workload: str, config: Mapping[str, Any], score: float,
               series: Optional[np.ndarray] = None,
               params: Optional[Mapping[str, Any]] = None) -> None:
        """Record a tuned config so future workloads can inherit it via
        matching."""
        if series is not None:
            self.profile(workload, params or {}, series)
        if not self.db.series_for(workload):
            raise ValueError(f"no series stored for {workload}; pass series=")
        self.db.set_best_config(workload, config, score)

    def tune(self, workload: str, series: np.ndarray,
             fallback: Optional[Callable[[], Mapping[str, Any]]] = None,
             **profile_meta: Any) -> TuneDecision:
        """Match; on success transfer config, else invoke the fallback
        search (and record its outcome)."""
        decision = self.match(workload, series)
        if decision.config is None and fallback is not None:
            cfg = dict(fallback())
            self.profile(workload, profile_meta.pop("params", {}), series,
                         **profile_meta)
            self.db.set_best_config(workload, cfg, score=0.0)
            decision = dataclasses.replace(decision, config=cfg)
        return decision


class _RowBuffer:
    """Append-only growable [n, ...] numpy buffer (geometric doubling).

    The scoring layer reads the whole history every tick, so a
    list-of-chunks + concatenate would cost O(n^2) copy traffic over a
    job's lifetime; this keeps appends amortized O(1) and reads zero-copy
    views.
    """

    def __init__(self) -> None:
        self._buf: Optional[np.ndarray] = None
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, block: np.ndarray) -> None:
        block = np.asarray(block)
        if block.shape[0] == 0:
            return
        if self._buf is None:
            self._buf = np.empty((max(block.shape[0], 64),)
                                 + block.shape[1:], block.dtype)
        while self._n + block.shape[0] > self._buf.shape[0]:
            grown = np.empty((2 * self._buf.shape[0],)
                             + self._buf.shape[1:], self._buf.dtype)
            grown[: self._n] = self._buf[: self._n]
            self._buf = grown
        self._buf[self._n: self._n + block.shape[0]] = block
        self._n += block.shape[0]

    def view(self) -> np.ndarray:
        """Zero-copy [n, ...] view of everything appended so far."""
        if self._buf is None:
            return np.zeros((0,), np.float32)
        return self._buf[: self._n]


class OnlineMatcher:
    """Streaming (prefix) matcher for ONE in-flight job.

    Arriving CPU-sample chunks feed the incremental bank DP
    (``dtw.dtw_bank_extend``: one K7 launch per chunk, resumed from the
    carried row, so any chunking reproduces the one-shot matrix bitwise),
    and the consumed prefix is scored against every reference with the
    open-ended warp correlation (``similarity.prefix_similarity_bank``).
    Once the series completes, :meth:`final_scores` equals the offline
    ``similarity_bank`` of the full query.

    ``collect_rows=True`` copies each chunk's [c, K, M] rows to the host
    (``_RowBuffer``) for scoring; ``denoise=True`` routes chunks through
    the causal streaming Chebyshev filter first, and scores are then
    exact with respect to the causally filtered query.
    """

    def __init__(self, bank: SeriesBank, *, band: Optional[int] = None,
                 query_len: Optional[int] = None, collect_rows: bool = True,
                 denoise: bool = False,
                 device: Union[str, torch.device, None] = None) -> None:
        self.bank = bank
        self.device = resolve_device(device)
        self._state = _dtw.dtw_bank_init(bank.series, bank.lengths,
                                         band=band, query_len=query_len,
                                         device=self.device)
        self._collect = collect_rows
        self._rows = _RowBuffer()
        self._x = _RowBuffer()
        self._filter = _filters.StreamingFilter() if denoise else None

    @property
    def n(self) -> int:
        """Query samples consumed so far."""
        return self._state.n

    def extend(self, chunk: np.ndarray) -> "OnlineMatcher":
        """Consume one chunk of samples (one K7 launch)."""
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        if chunk.shape[0] == 0:
            return self
        if self._filter is not None:
            chunk = self._filter(chunk)
        self._x.append(chunk)
        self._state, rows = _dtw.dtw_bank_extend(self._state, chunk,
                                                 collect_rows=self._collect)
        if self._collect:
            self._rows.append(rows.cpu().numpy())
        return self

    def query(self) -> np.ndarray:
        """The consumed (possibly causally filtered) query prefix."""
        return self._x.view()

    def distances(self) -> np.ndarray:
        """Prefix-vs-complete-reference DTW distances -> [K]."""
        return self._state.distances().cpu().numpy()

    def prefix_distances(self) -> np.ndarray:
        """Open-end distances (best reference *prefix*) -> [K]; monotone
        non-decreasing in the number of consumed samples."""
        return self._state.prefix_distances().cpu().numpy()

    def prefix_scores(self, open_end: bool = True) -> np.ndarray:
        """Warp correlation of the consumed prefix per reference -> [K]."""
        if not self._collect:
            raise ValueError("prefix scoring needs collect_rows=True")
        if self.n < 2:
            return np.zeros((len(self.bank),), np.float64)
        return prefix_similarity_bank(self.query(), self.bank,
                                      self._rows.view(),
                                      open_end=open_end)

    def final_scores(self) -> np.ndarray:
        """Complete-series scores; equal the offline ``similarity_bank``
        of the full (filtered) query against the bank.

        With ``collect_rows=True`` the streamed rows already hold the
        full matrix of the consumed query, so the verdict is a host
        backtrack of those rows (and keeps the stream's corridor as
        scored in flight).  Without rows, the matrix-free closed-end
        scorer (K2) re-solves in one launch, with the banded corridor
        re-derived from the true consumed length."""
        if self.n < 2:
            return np.zeros((len(self.bank),), np.float64)
        if self._collect:
            return self.prefix_scores(open_end=False)
        return prefix_similarity_bank(self.query(), self.bank, None,
                                      open_end=False, band=self._state.band,
                                      device=self.device)
