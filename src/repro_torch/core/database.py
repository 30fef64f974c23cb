"""Reference database of profiled workloads (paper Fig. 3-a / Fig. 4-a).

Each entry stores ``(workload, params, series, meta)`` — in the paper:
(application, {M, R, FS, I}, de-noised CPU series).  Here ``workload`` is a
free-form id (e.g. ``"deepseek-v2-236b/train_4k"`` or ``"wordcount"``),
``params`` the configuration-parameter values the series was captured
under, and ``meta`` carries whatever tuning knowledge exists for the
workload (best-known exec config, roofline terms, ...).

Persistence is a directory with one ``.npz`` for the series plus an
``index.json`` manifest — append-only, atomic (tmp+rename), safe for
concurrent readers; this is the on-disk format the AutoTuner ships between
jobs on a cluster.

Batched matching support: :meth:`ReferenceDB.bank` packs any selection of
entries into a :class:`SeriesBank` — all series padded (edge value) to a
common length in one ``[K, M]`` float32 array plus an ``int32 [K]`` vector
of true lengths — so the whole DB can be matched with a single batched DTW
kernel launch (see ``core/dtw.py``).  Banks are cached per selection and
invalidated on :meth:`add`.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Entry", "SeriesBank", "pack_series", "bank_to_device",
           "ReferenceDB", "atomic_write_npz", "atomic_write_json"]


def atomic_write_npz(dir_path: str, filename: str,
                     arrays: Mapping[str, np.ndarray]) -> str:
    """Write ``dir_path/filename`` (an ``.npz``) atomically: compress
    into a tmp file in the same directory, then ``os.replace`` — readers
    (and crashed writers) never observe a torn archive.  Shared by the
    reference-DB persistence and the serving trace log."""
    fd, tmp = tempfile.mkstemp(dir=dir_path, suffix=".tmp")
    os.close(fd)
    np.savez_compressed(tmp + ".npz", **arrays)
    final = os.path.join(dir_path, filename)
    os.replace(tmp + ".npz", final)
    os.unlink(tmp)
    return final


def atomic_write_json(dir_path: str, filename: str, obj: Any) -> str:
    """Atomic (tmp+rename) JSON dump next to :func:`atomic_write_npz`."""
    fd, tmp = tempfile.mkstemp(dir=dir_path, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f, indent=1, default=str)
    final = os.path.join(dir_path, filename)
    os.replace(tmp, final)
    return final


def _params_key(params: Mapping[str, Any]) -> str:
    return json.dumps({k: params[k] for k in sorted(params)}, sort_keys=True)


@dataclasses.dataclass
class Entry:
    workload: str
    params: Dict[str, Any]
    series: np.ndarray
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class SeriesBank:
    """K ragged series packed for one-launch batched matching.

    ``series[k, :lengths[k]]`` is series k; the tail ``series[k,
    lengths[k]:]`` repeats its edge value (padding never reaches the DTW
    distance — see ``core/dtw.py`` docstring).  ``labels[k]`` names row k
    (workload id for DB banks) and ``entries`` holds the source
    :class:`Entry` objects when the bank was built from a DB.
    """
    series: np.ndarray                       # [K, M] float32
    lengths: np.ndarray                      # [K] int32
    labels: Tuple[str, ...] = ()
    entries: Tuple[Entry, ...] = ()
    #: memoized device uploads for the verdict scorer
    #: (``core.dtw.ScoreBankPlan``), one per device — series/lengths are
    #: frozen, so a plan can never go stale; ``dataclasses.replace``
    #: copies start fresh.  Excluded from comparison/repr.
    _score_plans: dict = dataclasses.field(default_factory=dict, init=False,
                                           repr=False, compare=False)
    #: memoized paper-pipeline-filtered copy (see :meth:`preprocessed`).
    _preprocessed: object = dataclasses.field(default=None, init=False,
                                              repr=False, compare=False)

    @classmethod
    def from_numpy(cls, series, lengths=None, labels=()) -> "SeriesBank":
        """Bank from already packed arrays: ``series`` [K, M] (rows padded
        past their true length), ``lengths`` [K] (default M)."""
        series = np.ascontiguousarray(series, np.float32)
        if series.ndim != 2:
            raise ValueError(f"series must be [K, M], got {series.shape}")
        lengths = np.full((series.shape[0],), series.shape[1], np.int32) \
            if lengths is None else np.asarray(lengths, np.int32)
        if lengths.shape != (series.shape[0],) or (lengths < 1).any() \
                or (lengths > series.shape[1]).any():
            raise ValueError("lengths must be [K] values in [1, M]")
        return cls(series, lengths, tuple(labels))

    def __len__(self) -> int:
        return self.series.shape[0]

    def row(self, k: int) -> np.ndarray:
        """Unpadded series k."""
        return self.series[k, : int(self.lengths[k])]

    def score_plan(self, device=None):
        """This bank uploaded for the verdict scorer
        (``core.dtw.dtw_score_bank_many``) on ``device`` (CUDA by
        default), built once per device and reused across verdicts — a
        verdict moves query bytes only."""
        from . import dtw as _dtw
        from ..kernels.common import resolve_device
        dev = resolve_device(device)
        plan = self._score_plans.get(str(dev))
        if plan is None:
            plan = _dtw.build_score_plan(self.series, self.lengths, dev)
            self._score_plans[str(dev)] = plan
        return plan

    def preprocessed(self) -> "SeriesBank":
        """Paper-pipeline (Chebyshev de-noise + [0, 1] normalization)
        filtered copy of this bank, memoized — repeated
        ``preprocess=True`` scoring against the same bank reuses ONE
        filtered pack, and therefore one :meth:`score_plan` device
        upload, instead of re-filtering and re-uploading per call."""
        pb = self._preprocessed
        if pb is None:
            from . import filters as _filters
            pb = SeriesBank(_filters.preprocess_bank(
                self.series, self.lengths), self.lengths, self.labels,
                self.entries)
            object.__setattr__(self, "_preprocessed", pb)
        return pb


def pack_series(series: Sequence[np.ndarray],
                labels: Sequence[str] = (),
                entries: Sequence[Entry] = (),
                pad_multiple: int = 8) -> SeriesBank:
    """Pack ragged 1-D series into a padded ``[K, M]`` bank.

    M is the max length rounded up to ``pad_multiple`` (the reference's
    packing, so both packages see the same bank); padding repeats each
    series' final sample.
    """
    arrs = [np.asarray(s, np.float32).reshape(-1) for s in series]
    lengths = np.asarray([a.shape[0] for a in arrs], np.int32)
    if any(l == 0 for l in lengths):
        raise ValueError("cannot pack empty series into a bank")
    if not arrs:
        return SeriesBank(np.zeros((0, pad_multiple), np.float32), lengths,
                          tuple(labels), tuple(entries))
    m = max(int(lengths.max()), 2)
    m = ((m + pad_multiple - 1) // pad_multiple) * pad_multiple
    out = np.empty((len(arrs), m), np.float32)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
        out[i, a.shape[0]:] = a[-1]
    return SeriesBank(out, lengths, tuple(labels), tuple(entries))


def bank_to_device(bank: SeriesBank, device=None):
    """The bank's device upload (``core.dtw.ScoreBankPlan``: the K-last
    ``[M, K]`` series and ``[K]`` lengths) on ``device``, memoized on the
    bank."""
    return bank.score_plan(device)


class ReferenceDB:
    """In-memory reference DB with directory persistence."""

    #: Each cached bank is a padded copy of its selection, and every
    #: distinct exclude-set produces a distinct selection (AutoTuner
    #: excludes the query workload), so the cache must be bounded: LRU
    #: over the most recent selections.
    BANK_CACHE_MAX = 8

    def __init__(self) -> None:
        self._entries: List[Entry] = []
        self._bank_cache: "collections.OrderedDict[Tuple[int, ...], SeriesBank]" \
            = collections.OrderedDict()
        #: accumulated match-decision records (dicts, see
        #: ``TuneDecision.to_record``) — the raw material for calibrating
        #: the streaming early-decision rule per workload family.
        self._decisions: List[Dict[str, Any]] = []

    # -- population ---------------------------------------------------------
    def add(self, workload: str, params: Mapping[str, Any],
            series: np.ndarray, meta: Optional[Mapping[str, Any]] = None,
            **extra_meta: Any) -> Entry:
        """Add one profiled series.  ``meta`` may be passed explicitly (a
        mapping — the persistence round-trip uses this so meta keys named
        ``workload``/``params``/``series`` can't shadow positional args) or
        as keyword arguments; both merge into the entry's meta dict."""
        md = dict(meta or {})
        md.update(extra_meta)
        e = Entry(workload=str(workload), params=dict(params),
                  series=np.asarray(series, np.float32), meta=md)
        self._entries.append(e)
        self._bank_cache.clear()
        return e

    # -- queries -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> Sequence[Entry]:
        return tuple(self._entries)

    def workloads(self) -> List[str]:
        seen: List[str] = []
        for e in self._entries:
            if e.workload not in seen:
                seen.append(e.workload)
        return seen

    def series_for(self, workload: str) -> List[Entry]:
        return [e for e in self._entries if e.workload == workload]

    def lookup(self, workload: str, params: Mapping[str, Any]) -> Optional[Entry]:
        key = _params_key(params)
        for e in self._entries:
            if e.workload == workload and _params_key(e.params) == key:
                return e
        return None

    def best_config(self, workload: str) -> Optional[Dict[str, Any]]:
        """The stored best-known execution config for a workload, if any."""
        best = None
        for e in self.series_for(workload):
            cfg = e.meta.get("best_config")
            if cfg is None:
                continue
            score = e.meta.get("score", 0.0)
            if best is None or score > best[0]:
                best = (score, cfg)
        return best[1] if best else None

    def set_best_config(self, workload: str, config: Mapping[str, Any],
                        score: float) -> None:
        for e in self.series_for(workload):
            e.meta["best_config"] = dict(config)
            e.meta["score"] = float(score)

    # -- batched matching ----------------------------------------------------
    def bank(self, workloads: Optional[Sequence[str]] = None,
             exclude: Sequence[str] = ()) -> SeriesBank:
        """Padded ``[K, M]`` bank over the selected entries (all by
        default), row-labelled with each entry's workload id.  LRU-cached
        per selection (:data:`BANK_CACHE_MAX` most recent); the cache is
        cleared by :meth:`add`."""
        inc = None if workloads is None else set(workloads)
        exc = set(exclude)
        sel = tuple(i for i, e in enumerate(self._entries)
                    if (inc is None or e.workload in inc)
                    and e.workload not in exc)
        cached = self._bank_cache.get(sel)
        if cached is not None:
            self._bank_cache.move_to_end(sel)
            return cached
        entries = [self._entries[i] for i in sel]
        bank = pack_series([e.series for e in entries],
                           labels=[e.workload for e in entries],
                           entries=entries)
        self._bank_cache[sel] = bank
        while len(self._bank_cache) > self.BANK_CACHE_MAX:
            self._bank_cache.popitem(last=False)
        return bank

    # -- decision history -----------------------------------------------------
    def record_decision(self, decision: Any) -> None:
        """Append one match decision to the history.

        ``decision`` is a ``tuner.TuneDecision`` (anything with a
        ``to_record()``) or an already-serialized record dict.  The
        streaming service calls this on :meth:`~repro.serve.tuning.
        TuningService.finish`, so every completed job contributes a
        ``decided_at_fraction`` datum; history persists with the DB.
        """
        rec = decision.to_record() if hasattr(decision, "to_record") \
            else dict(decision)
        self._decisions.append(rec)

    def decision_history(self, matched: Optional[str] = None
                         ) -> List[Dict[str, Any]]:
        """Recorded decisions, optionally filtered to one matched
        workload family (the calibration unit: "when did jobs that
        matched W become decidable?")."""
        if matched is None:
            return list(self._decisions)
        return [d for d in self._decisions if d.get("matched") == matched]

    def decided_at_fractions(self, matched: str) -> List[float]:
        """The ``decided_at_fraction`` data points for one workload
        family (finals without an early decision report 1.0 — they were
        never decidable in flight)."""
        return [float(d["decided_at_fraction"])
                for d in self._decisions
                if d.get("matched") == matched
                and d.get("decided_at_fraction") is not None]

    # -- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        index = []
        arrays = {}
        for i, e in enumerate(self._entries):
            key = f"s{i}"
            arrays[key] = e.series
            index.append({"workload": e.workload, "params": e.params,
                          "meta": e.meta, "key": key})
        atomic_write_npz(path, "series.npz", arrays)
        atomic_write_json(path, "index.json",
                          {"version": 1, "entries": index,
                           "decisions": self._decisions})

    @classmethod
    def load(cls, path: str) -> "ReferenceDB":
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        arrays = np.load(os.path.join(path, "series.npz"))
        db = cls()
        for rec in index["entries"]:
            # meta passed explicitly: a meta key named "workload"/"params"/
            # "series" must not shadow the positional arguments.
            db.add(rec["workload"], rec["params"], arrays[rec["key"]],
                   meta=rec.get("meta", {}))
        for rec in index.get("decisions", ()):   # absent in pre-v3 saves
            db.record_decision(rec)
        return db
