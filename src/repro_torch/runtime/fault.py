"""Liveness, straggler tracking and rescale decisions.

Clock-injected and deterministic, so every policy is unit-testable
without real failures:

* :class:`HeartbeatTracker` — workers report (worker_id, step, t); a
  worker whose last heartbeat is older than ``timeout`` is declared dead.
  Ids are any hashable: the tuning service beats per push with job-id
  strings (``serve.ingest``) and evicts swept jobs.
* :class:`StragglerDetector` — per-step durations; a worker consistently
  slower than ``factor`` x the median over a sliding window is flagged.
* :class:`ElasticController` — given alive workers, picks the largest
  usable data-parallel degree (a power of two) and emits a
  :class:`RescaleDecision`; :meth:`ElasticController.decide_ahead` also
  reads the serving stack's overload pressure.  A decision is carried
  out by ``TuningService.rescale``, which re-homes the service's bank
  shards onto the new mesh.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Deque, Dict, Hashable, List, Optional, Sequence

__all__ = ["WorkerState", "HeartbeatTracker", "StragglerDetector",
           "RescaleDecision", "ElasticController"]


@dataclasses.dataclass
class WorkerState:
    worker_id: Hashable
    last_step: int = -1
    last_time: float = 0.0
    alive: bool = True


class HeartbeatTracker:
    """Clock-injected liveness tracking, hardened against skewed clocks.

    Timestamps come from the callers (monitoring agents beat, the
    service sweeps), and on a real fleet those clocks jump — NTP steps,
    VM migrations, injected skew.  Two monotonicity
    guards keep a skewed stamp from mass-evicting healthy workers:

    * a beat carrying a *backwards* ``now`` can never rewind
      ``last_time`` (the worker just proved it is alive; an older stamp
      adds no information), so a later honest sweep cannot time it out
      on the strength of a skewed beat;
    * a sweep carrying a backwards ``now`` is clamped to the sweep
      high-water mark, so the sweep clock is monotone too and
      ``sweep(t); sweep(t - skew)`` decides exactly what ``sweep(t)``
      alone would.
    """

    def __init__(self, timeout: float = 60.0):
        self.timeout = timeout
        self.workers: Dict[Hashable, WorkerState] = {}
        self._sweep_high_water = -float("inf")

    def beat(self, worker_id: Hashable, step: int, now: float) -> None:
        w = self.workers.setdefault(worker_id, WorkerState(worker_id))
        w.last_step = max(w.last_step, step)
        w.last_time = max(w.last_time, now)
        w.alive = True

    def sweep(self, now: float) -> List[Hashable]:
        """Mark timed-out workers dead; return newly-dead ids."""
        self._sweep_high_water = max(self._sweep_high_water, now)
        now = self._sweep_high_water
        dead = []
        for w in self.workers.values():
            if w.alive and now - w.last_time > self.timeout:
                w.alive = False
                dead.append(w.worker_id)
        return sorted(dead)

    def alive_workers(self) -> List[Hashable]:
        return sorted(w.worker_id for w in self.workers.values() if w.alive)

    def forget(self, worker_id: Hashable) -> None:
        """Drop a worker that left cleanly (a finished/evicted serving
        job, a decommissioned host) so it can never be swept as newly
        dead after the fact — worker ids are reusable."""
        self.workers.pop(worker_id, None)


class StragglerDetector:
    def __init__(self, window: int = 16, factor: float = 1.5,
                 min_samples: int = 4):
        self.window = window
        self.factor = factor
        self.min_samples = min_samples
        self._durations: Dict[Hashable, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, worker_id: Hashable, step_duration: float) -> None:
        self._durations[worker_id].append(step_duration)

    def _median_of_medians(self) -> Optional[float]:
        meds = []
        for d in self._durations.values():
            if len(d) >= self.min_samples:
                s = sorted(d)
                meds.append(s[len(s) // 2])
        if not meds:
            return None
        meds.sort()
        return meds[len(meds) // 2]

    def stragglers(self) -> List[Hashable]:
        base = self._median_of_medians()
        if base is None:
            return []
        out = []
        for wid, d in self._durations.items():
            if len(d) < self.min_samples:
                continue
            s = sorted(d)
            if s[len(s) // 2] > self.factor * base:
                out.append(wid)
        return sorted(out)


@dataclasses.dataclass(frozen=True)
class RescaleDecision:
    should_rescale: bool
    new_data_parallel: int
    dropped_workers: Sequence[int]
    reason: str


class ElasticController:
    """Chooses the data-parallel degree from the alive/non-straggler set.

    ``model_parallel`` stays fixed (changing the model-parallel degree
    means re-sharding every weight — only worth it on large permanent
    shrinkage); the data axis snaps to the largest power of two <= usable
    hosts.
    """

    def __init__(self, model_parallel: int, min_data_parallel: int = 1):
        self.model_parallel = model_parallel
        self.min_data_parallel = min_data_parallel

    @staticmethod
    def _pow2_floor(n: int) -> int:
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def decide(self, current_data_parallel: int, alive: Sequence[int],
               stragglers: Sequence[int] = ()) -> RescaleDecision:
        usable = [w for w in alive if w not in set(stragglers)]
        target = max(self.min_data_parallel, self._pow2_floor(len(usable)))
        if target == current_data_parallel:
            return RescaleDecision(False, current_data_parallel, (),
                                   "stable")
        dropped = tuple(sorted(set(alive) - set(usable)))
        reason = ("shrink: dead/straggler workers" if
                  target < current_data_parallel else "grow: workers joined")
        return RescaleDecision(True, target, dropped, reason)

    def decide_ahead(self, current_data_parallel: int,
                     alive: Sequence[int],
                     stragglers: Sequence[int] = (), *,
                     overload_pressure: float = 0.0,
                     grow_threshold: float = 0.75,
                     shrink_threshold: float = 0.25) -> RescaleDecision:
        """Rescale-AHEAD: :meth:`decide` reacts to workers dying; this
        variant also reacts to the serving stack's measured overload
        (``TuningService.overload_pressure()`` — the degradation
        ladder's latency pressure and queue fill) BEFORE jobs are shed.

        Pressure at or above ``grow_threshold`` doubles the data axis
        (capped at the pow2 floor of the usable worker count — growing
        past the hardware is not a plan); pressure at or below
        ``shrink_threshold`` halves it (floored at
        ``min_data_parallel``), reclaiming hosts an earlier spike
        grabbed.  In between, defer to the reactive :meth:`decide`."""
        if not 0.0 <= shrink_threshold < grow_threshold <= 1.0:
            raise ValueError("need 0 <= shrink_threshold < "
                             "grow_threshold <= 1")
        usable = [w for w in alive if w not in set(stragglers)]
        ceil = max(self.min_data_parallel, self._pow2_floor(len(usable)))
        if overload_pressure >= grow_threshold \
                and current_data_parallel < ceil:
            target = min(ceil, current_data_parallel * 2)
            return RescaleDecision(
                True, target, (),
                f"grow-ahead: overload pressure {overload_pressure:.2f}")
        if overload_pressure <= shrink_threshold:
            if self.min_data_parallel < current_data_parallel <= ceil:
                target = max(self.min_data_parallel,
                             current_data_parallel // 2)
                return RescaleDecision(
                    True, target, (),
                    "shrink-ahead: overload pressure "
                    f"{overload_pressure:.2f}")
            # idle: reactive shrink (dead/straggler hosts) still applies,
            # but never grow an idle service onto newly-joined workers.
            d = self.decide(current_data_parallel, alive, stragglers)
            if d.new_data_parallel > current_data_parallel:
                return RescaleDecision(False, current_data_parallel, (),
                                       "stable: idle")
            return d
        return self.decide(current_data_parallel, alive, stragglers)
