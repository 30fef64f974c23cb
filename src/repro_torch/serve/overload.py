"""Overload control plane: admission + graded degradation ladder.

OPERATIONS RUNBOOK
==================

What this plane does
--------------------
A burst of submissions (or a slow device) must degrade the tuning
service *predictably*: shed precision and latency headroom in a fixed,
graded order instead of blowing queue limits or stalling ticks.  Two
cooperating controllers implement that:

* :class:`OverloadController` — watches measured tick latency and walks
  a **degradation ladder**; the tick engine consults the current rung
  before every dispatch.
* :class:`AdmissionController` — gates ``TuningService.submit`` with
  per-job cost estimates and QoS classes, raising
  :class:`AdmissionShedError` (a ``BackpressureError``) when the service
  should not take the job.

The ladder (rungs, in escalation order)
---------------------------------------
====  ===============  ====================================================
rung  name             effect on the tick engine
====  ===============  ====================================================
0     normal           full prob-scored tick (6 moment channels + vstats)
1     approx_prob      approximate probability tick — 4 moment channels
                       (one carried variance channel, the remaining tail
                       reconstructed at the score tail, ~1.3x a scored
                       tick instead of ~2x).  The ladder sheds probability
                       *precision* here before it sheds probabilities
                       entirely: probabilities keep flowing but early
                       decisions are suppressed for exact-mode services
                       (``degraded_level=1`` on jobs ticked here).
                       Services configured with ``prob_mode="approx"``
                       already run this tick as their base mode and are
                       unaffected by this rung.
2     exact_score      exact scored tick only — variance channels go stale,
                       probability-gated early decisions suppressed
                       (``degraded_level=1`` on jobs ticked here)
3     distance_only    distance-only tick — all moment channels stale, no
                       early decisions for jobs ticked here
                       (``degraded_level=2``); final verdicts recomputed
                       offline from the full query, bitwise unchanged
4     deep_prune       the prune's ``prefilter_top`` divided by
                       ``prefilter_divisor`` (2); the tick itself is
                       distance-only as at rung 3, and a job it ticks
                       (``degraded_level=2``) stops shrinking its live
                       set, as in the reference; without
                       ``prefilter_top=`` this rung is rung 3
5     slow_cohorts     ``TickCohorts`` re-arm intervals stretched by
                       ``cohort_scale`` — jobs tick less often
6     reject           admission pressure pinned to 1.0 — every submit
                       sheds regardless of QoS
====  ===============  ====================================================

Every rung may *delay* decisions; none may change them.  The invariant
(pinned by the golden tests) is that the DP warp path is identical in
all tick modes, so a downgraded tick computes the same rows — only the
side channels used for *early* (pre-finish) decisions go stale, and a
stale channel suppresses the early decision rather than risking a wrong
one.  The final verdict is always recomputed from the full accumulated
query at finish time and is bit-identical to an unloaded run.

Signals
-------
* **EWMA p99 tick latency** vs ``OverloadConfig.target_p99`` — the
  escalation signal.  Latency is measured per top-level tick (plus any
  chaos-injected slowdown); ``TuningService.tick(latency=)`` replays a
  recorded latency, so a replay reproduces the rung trajectory
  bit-identically.  On a GPU the host returns before a kernel ends: a
  tick that copies scores to the host waits for its kernel, a
  distance-only tick copies nothing back and its latency is host time.
* **queue fill** — ``IngestFront.queue_fill()``, worst-case bounded
  buffer occupancy across jobs; an admission signal.
* **cost fill** — expected job length over the reference-bank mean
  length (the cumulative-CPU cost proxy of arXiv:1203.4054); an
  admission signal.
* **rung fraction** — ``rung / (len(RUNGS) - 1)``; couples the ladder
  into admission so a degraded service also sheds harder.

How to read ``rung_history``
----------------------------
``OverloadController.rung_history`` is a list of
``(observation_index, from_rung, to_rung)`` transitions, e.g.
``[(6, 0, 1), (8, 1, 2), (31, 2, 1), (34, 1, 0)]`` reads: escalated to
``exact_score`` at the 6th observed tick, on to ``distance_only`` two
ticks later, then de-escalated back to normal once the burst passed.
A non-trivial history under load plus an empty tail (back at rung 0)
after the burst is the healthy signature.  A history pinned at high
rungs means the target is simply unachievable — rescale instead (see
``runtime.fault.ElasticController.decide_ahead``, which consumes
``TuningService.overload_pressure()`` as the rescale-ahead signal).

Counters (on ``TuningService``)
-------------------------------
* ``shed_count`` / ``shed_by_class`` — admissions refused, total and per
  QoS class (monitoring only: shed submits are *not* journaled, the job
  never existed as far as recovery is concerned).
* ``overload_ticks`` — ticks dispatched at rung >= 1.
* ``worst_rung`` — high-water rung reached.
* breaker counters (``CircuitBreaker.opened_count`` /
  ``reclosed_count``) — kernel-path demotions; ``TuningService.degraded``
  is True while the breaker is engaged OR the ladder is above rung 0.

All controller state is JSON-serialisable (``state_dict`` /
``load_state``), so a restored controller resumes mid-ladder,
bit-identically.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, List, Optional, Tuple

from .ingest import BackpressureError

__all__ = ["RUNGS", "AdmissionController", "AdmissionPolicy",
           "AdmissionShedError", "OverloadConfig", "OverloadController"]

#: Ladder rungs in escalation order (see the runbook table above).
RUNGS: Tuple[str, ...] = ("normal", "approx_prob", "exact_score",
                          "distance_only", "deep_prune", "slow_cohorts",
                          "reject")


class AdmissionShedError(BackpressureError):
    """Submit refused by admission control.  Subclasses
    ``BackpressureError`` so callers already handling ingest
    backpressure handle shedding the same way."""

    def __init__(self, job_id: str, qos: str, pressure: float,
                 threshold: float) -> None:
        super().__init__(
            f"job {job_id!r} (qos={qos}) shed: pressure {pressure:.3f} "
            f">= threshold {threshold:.3f}")
        self.job_id = job_id
        self.qos = qos
        self.pressure = pressure
        self.threshold = threshold


@dataclasses.dataclass
class OverloadConfig:
    """Knobs for the degradation ladder (JSON-able; rides snapshots).

    ``target_p99`` is the tick-latency SLO in seconds; the ladder
    escalates after ``patience`` consecutive observations whose EWMA'd
    window-p99 exceeds it, and de-escalates after ``cooldown``
    consecutive calm observations.  ``cohort_scale`` is the tick-rate
    stretch applied at rung >= 5."""

    target_p99: float = 0.25
    window: int = 32
    ewma_alpha: float = 0.3
    patience: int = 2
    cooldown: int = 3
    max_rung: int = len(RUNGS) - 1
    cohort_scale: float = 4.0

    def __post_init__(self) -> None:
        if self.target_p99 <= 0.0:
            raise ValueError("target_p99 must be > 0")
        if self.window < 1 or self.patience < 1 or self.cooldown < 1:
            raise ValueError("window/patience/cooldown must be >= 1")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if not 0 <= self.max_rung <= len(RUNGS) - 1:
            raise ValueError(f"max_rung must be in [0, {len(RUNGS) - 1}]")
        if self.cohort_scale < 1.0:
            raise ValueError("cohort_scale must be >= 1.0")


class OverloadController:
    """Walks the degradation ladder from observed tick latencies.

    Fully deterministic given the observation sequence: replaying each
    top-level tick's measured latency through :meth:`observe` reproduces
    the exact rung trajectory (hence the exact tick modes and staleness
    markers) of the original run.
    """

    def __init__(self, config: Optional[OverloadConfig] = None) -> None:
        self.config = config or OverloadConfig()
        self.rung: int = 0
        #: ``(observation_index, from_rung, to_rung)`` transitions.
        self.rung_history: List[Tuple[int, int, int]] = []
        self._window: Deque[float] = deque(maxlen=self.config.window)
        self._ewma: Optional[float] = None
        self._hot = 0
        self._calm = 0
        self._observed = 0

    # -- signal ---------------------------------------------------------
    def observe(self, latency: float) -> int:
        """Feed one top-level tick's measured latency (seconds); returns
        the rung in force for the *next* tick."""
        self._window.append(float(latency))
        n = len(self._window)
        p99 = sorted(self._window)[min(n - 1,
                                       max(0, math.ceil(0.99 * n) - 1))]
        a = self.config.ewma_alpha
        self._ewma = p99 if self._ewma is None else \
            a * p99 + (1.0 - a) * self._ewma
        self._observed += 1
        if self._ewma > self.config.target_p99:
            self._hot += 1
            self._calm = 0
            if self._hot >= self.config.patience:
                self._hot = 0
                self._move(min(self.config.max_rung, self.rung + 1))
        else:
            self._calm += 1
            self._hot = 0
            if self._calm >= self.config.cooldown:
                self._calm = 0
                self._move(max(0, self.rung - 1))
        return self.rung

    def _move(self, new: int) -> None:
        if new != self.rung:
            self.rung_history.append((self._observed, self.rung, new))
            self.rung = new

    # -- derived knobs the tick engine consults -------------------------
    @property
    def tick_mode_cap(self) -> str:
        """Most expensive tick mode the current rung allows:
        ``"prob"`` (rung 0), ``"approx_prob"`` (rung 1), ``"scored"``
        (rung 2) or ``"distance"`` (rung >= 3)."""
        if self.rung == 0:
            return "prob"
        if self.rung == 1:
            return "approx_prob"
        if self.rung == 2:
            return "scored"
        return "distance"

    @property
    def prefilter_divisor(self) -> int:
        """Divide ``prefilter_top`` by this (rung >= 4 prunes deeper)."""
        return 2 if self.rung >= 4 else 1

    @property
    def cohort_scale(self) -> float:
        """Stretch factor for ``TickCohorts`` re-arm intervals."""
        return self.config.cohort_scale if self.rung >= 5 else 1.0

    def pressure(self) -> float:
        """Scalar overload pressure in [0, 1] for admission and
        rescale-ahead: the worse of the ladder position and the
        latency-vs-target ratio."""
        rung_frac = self.rung / max(1, len(RUNGS) - 1)
        lat_frac = 0.0 if self._ewma is None else \
            min(1.0, self._ewma / self.config.target_p99)
        return max(rung_frac, lat_frac)

    # -- persistence ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"rung": self.rung,
                "rung_history": [list(t) for t in self.rung_history],
                "window": list(self._window),
                "ewma": self._ewma,
                "hot": self._hot, "calm": self._calm,
                "observed": self._observed}

    def load_state(self, st: dict) -> None:
        self.rung = int(st["rung"])
        self.rung_history = [tuple(int(v) for v in t)
                             for t in st["rung_history"]]
        self._window = deque((float(v) for v in st["window"]),
                             maxlen=self.config.window)
        self._ewma = None if st["ewma"] is None else float(st["ewma"])
        self._hot = int(st["hot"])
        self._calm = int(st["calm"])
        self._observed = int(st["observed"])


@dataclasses.dataclass
class AdmissionPolicy:
    """Per-QoS shed thresholds on the admission pressure (JSON-able).

    A submit is shed when pressure >= its class threshold.  Thresholds
    must be ordered bronze <= silver <= gold, which *guarantees* gold
    jobs are never shed at a pressure that admits bronze.  ``cost_scale``
    normalises the per-job cost estimate: a job of
    ``cost_scale * mean_reference_length`` expected samples contributes
    cost-fill 1.0 on its own."""

    bronze: float = 0.7
    silver: float = 0.85
    gold: float = 1.0
    cost_scale: float = 4.0

    def __post_init__(self) -> None:
        if not 0.0 < self.bronze <= self.silver <= self.gold:
            raise ValueError(
                "thresholds must satisfy 0 < bronze <= silver <= gold")
        if self.cost_scale <= 0.0:
            raise ValueError("cost_scale must be > 0")

    def threshold(self, qos: str) -> float:
        try:
            return {"bronze": self.bronze, "silver": self.silver,
                    "gold": self.gold}[qos]
        except KeyError:
            raise ValueError(f"unknown QoS class {qos!r} "
                             "(expected bronze/silver/gold)") from None


class AdmissionController:
    """Stateless admission gate: combines the instantaneous signals into
    one pressure scalar and sheds by QoS class.

    Statelessness matters for recovery: given replayed signals the gate
    re-makes identical decisions, and shed submits are never journaled
    (the job simply never existed), so replay cannot diverge.
    """

    def __init__(self, policy: Optional[AdmissionPolicy] = None) -> None:
        self.policy = policy or AdmissionPolicy()

    def pressure(self, *, cost_fill: float, queue_fill: float,
                 rung_frac: float) -> float:
        """Worst of the three normalised signals, clipped to [0, 1]."""
        return max(0.0, min(1.0, max(float(cost_fill), float(queue_fill),
                                     float(rung_frac))))

    def admit(self, job_id: str, *, qos: str, cost_fill: float,
              queue_fill: float, rung_frac: float) -> float:
        """Return the admission pressure, or raise
        :class:`AdmissionShedError` when the class threshold is hit."""
        p = self.pressure(cost_fill=cost_fill, queue_fill=queue_fill,
                          rung_frac=rung_frac)
        thr = self.policy.threshold(qos)
        if p >= thr:
            raise AdmissionShedError(job_id, qos, p, thr)
        return p
