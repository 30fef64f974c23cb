"""Tuning decisions and the host-side sample buffer of in-flight jobs.

``AutoTuner`` and ``OnlineMatcher`` are not ported yet: ROADMAP.md queue
1 item 5.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["TuneDecision"]


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
