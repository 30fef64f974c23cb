"""Similarity pieces the online service needs (paper §3.1.3).

The offline similarity engine (``similarity_bank``, ``match_series``,
``match_application``, ``prefix_similarity_bank``) is not ported yet:
ROADMAP.md queue 1 item 5.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MATCH_THRESHOLD", "RunningMoments"]

#: Paper §3.1.3: acceptable-match threshold.
MATCH_THRESHOLD = 0.9


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
