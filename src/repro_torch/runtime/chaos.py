"""Chaos-injection harness for the crash-safe serving stack.

The recovery guarantees of ``serve.recovery`` (snapshot + WAL replay ==
never crashed, bit-identical) and the dispatch-resilience guarantees of
``serve.tuning`` (retry-then-fallback == fault-free) are only as good as
the faults they were demonstrated against.  This module is the fault
*generator*: a seeded, fully deterministic :class:`FaultPlan` that the
service consults at its hook points, so every chaos scenario in the test
suite replays exactly from its seed.

Fault classes covered (mirroring what a real deployment sees):

* **dispatch failures** — :meth:`FaultPlan.on_dispatch` raises
  :class:`InjectedDispatchError` on seeded ticks (with configurable
  burst length, so a burst longer than the retry budget exercises the
  service's fallback path);
* **sample corruption** — :meth:`FaultPlan.corrupt` flips seeded samples
  of a pushed chunk to NaN/Inf (the ingest layer must quarantine the
  job, not poison the shared slab);
* **clock skew** — :meth:`FaultPlan.skew` perturbs heartbeat ``now``
  values, including *backwards* jumps (the ``HeartbeatTracker`` guard);
* **process kill** — :meth:`FaultPlan.should_kill` marks seeded command
  indices, for a scenario that SIGKILLs itself at the marked point and
  checks that a restored service matches an uninterrupted golden run;
* **torn WAL tails** — :func:`truncate_file` chops bytes off a trace
  segment, the crash case ``serve.ingest.TraceLog`` must tolerate.

Overload fault classes, driving ``serve.overload``:

* **submission spikes** — :meth:`FaultPlan.spike_multiplier` scales a
  scenario's nominal arrival rate by ``spike_factor`` during seeded
  windows (the 10x Poisson burst of the golden overload test);
* **slow dispatch** — :meth:`FaultPlan.slow_dispatch` returns seeded
  *extra latency seconds* to add to a tick's observed latency (never
  sleeps — the latency is reported, not paid, so overload tests run at
  full speed while the degradation ladder sees a saturated device);
* **queue-pressure bursts** — :meth:`FaultPlan.queue_burst` marks seeded
  windows during which a scenario withholds drains/ticks so ingest
  queues fill toward their bounds (admission-control backpressure).

Nothing here sleeps or consults a real clock: determinism is the point.
Each fault class draws from its own stream ``np.random.default_rng((seed,
i))``, so one seed gives the same faults here as in the reference's
``repro.runtime.chaos``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["InjectedDispatchError", "FaultPlan", "truncate_file"]


class InjectedDispatchError(RuntimeError):
    """A dispatch failure injected by a :class:`FaultPlan` (stands in
    for a transient device/runtime error)."""


class FaultPlan:
    """Deterministic fault schedule, seeded once and consumed statefully.

    ``dispatch_fail_rate`` is the per-dispatch probability of starting a
    failure burst; ``dispatch_fail_burst`` is how many consecutive
    attempts of that dispatch fail (a burst longer than the service's
    retry budget forces the fallback path).  ``corrupt_rate`` is the
    per-push probability of poisoning one sample; ``skew_rate`` is the
    per-stamp probability of perturbing a heartbeat clock by up to
    ``±max_skew`` (backwards jumps included).  ``kill_every`` marks
    every N-th command index as a kill point for subprocess scenarios.
    """

    def __init__(self, seed: int = 0, *,
                 dispatch_fail_rate: float = 0.0,
                 dispatch_fail_burst: int = 1,
                 corrupt_rate: float = 0.0,
                 skew_rate: float = 0.0,
                 max_skew: float = 100.0,
                 kill_every: Optional[int] = None,
                 spike_rate: float = 0.0,
                 spike_factor: float = 10.0,
                 spike_len: int = 4,
                 slow_rate: float = 0.0,
                 slow_extra: float = 0.1,
                 queue_burst_rate: float = 0.0,
                 queue_burst_len: int = 2) -> None:
        if dispatch_fail_burst < 1:
            raise ValueError("dispatch_fail_burst must be >= 1")
        if kill_every is not None and kill_every < 1:
            raise ValueError("kill_every must be >= 1 (or None)")
        if spike_len < 1 or queue_burst_len < 1:
            raise ValueError("spike_len/queue_burst_len must be >= 1")
        self.seed = seed
        self.dispatch_fail_rate = float(dispatch_fail_rate)
        self.dispatch_fail_burst = int(dispatch_fail_burst)
        self.corrupt_rate = float(corrupt_rate)
        self.skew_rate = float(skew_rate)
        self.max_skew = float(max_skew)
        self.kill_every = kill_every
        self.spike_rate = float(spike_rate)
        self.spike_factor = float(spike_factor)
        self.spike_len = int(spike_len)
        self.slow_rate = float(slow_rate)
        self.slow_extra = float(slow_extra)
        self.queue_burst_rate = float(queue_burst_rate)
        self.queue_burst_len = int(queue_burst_len)
        # independent streams per fault class so e.g. enabling skew does
        # not shift which dispatches fail under the same seed.
        self._rng_dispatch = np.random.default_rng((seed, 1))
        self._rng_corrupt = np.random.default_rng((seed, 2))
        self._rng_skew = np.random.default_rng((seed, 3))
        self._rng_spike = np.random.default_rng((seed, 4))
        self._rng_slow = np.random.default_rng((seed, 5))
        self._rng_qburst = np.random.default_rng((seed, 6))
        self._burst_left = 0
        self._spike_left = 0
        self._qburst_left = 0
        #: dispatch attempts failed so far (diagnostics for tests).
        self.injected_failures = 0
        self.corrupted_pushes = 0
        self.slowed_dispatches = 0
        self.spiked_beats = 0
        self.queue_bursts = 0

    # -- dispatch failures ---------------------------------------------------
    def on_dispatch(self, kind: str = "tick") -> None:
        """Consulted once per dispatch *attempt* (retries re-consult):
        raises :class:`InjectedDispatchError` while a failure burst is
        active, and rolls the dice to start a new burst otherwise."""
        if self._burst_left > 0:
            self._burst_left -= 1
            self.injected_failures += 1
            raise InjectedDispatchError(
                f"injected {kind} failure (seed={self.seed})")
        if self.dispatch_fail_rate > 0.0 and \
                self._rng_dispatch.random() < self.dispatch_fail_rate:
            self._burst_left = self.dispatch_fail_burst - 1
            self.injected_failures += 1
            raise InjectedDispatchError(
                f"injected {kind} failure (seed={self.seed})")

    # -- sample corruption ---------------------------------------------------
    def corrupt(self, samples: np.ndarray) -> np.ndarray:
        """Return ``samples`` with (per plan) one seeded element replaced
        by NaN or ±Inf; the original array is never mutated."""
        s = np.asarray(samples, np.float32).reshape(-1)
        if not s.shape[0] or self.corrupt_rate <= 0.0 or \
                self._rng_corrupt.random() >= self.corrupt_rate:
            return samples
        out = np.array(s, np.float32)
        i = int(self._rng_corrupt.integers(s.shape[0]))
        out[i] = [np.nan, np.inf, -np.inf][
            int(self._rng_corrupt.integers(3))]
        self.corrupted_pushes += 1
        return out

    # -- clock skew ----------------------------------------------------------
    def skew(self, now: Optional[float]) -> Optional[float]:
        """Perturb a heartbeat timestamp (None passes through): uniform
        in ``[-max_skew, +max_skew]`` on seeded stamps — a negative draw
        is exactly the backwards jump the heartbeat guard absorbs."""
        if now is None or self.skew_rate <= 0.0 or \
                self._rng_skew.random() >= self.skew_rate:
            return now
        return now + float(self._rng_skew.uniform(-self.max_skew,
                                                  self.max_skew))

    # -- overload faults -----------------------------------------------------
    def spike_multiplier(self) -> float:
        """Consulted once per arrival beat: returns ``spike_factor``
        while a seeded submission spike is active (``spike_len``
        consecutive beats), else 1.0.  Scenarios multiply their nominal
        Poisson arrival rate by this."""
        if self._spike_left > 0:
            self._spike_left -= 1
            self.spiked_beats += 1
            return self.spike_factor
        if self.spike_rate > 0.0 and \
                self._rng_spike.random() < self.spike_rate:
            self._spike_left = self.spike_len - 1
            self.spiked_beats += 1
            return self.spike_factor
        return 1.0

    def slow_dispatch(self, kind: str = "tick") -> float:
        """Consulted once per completed dispatch: returns seeded extra
        latency *seconds* to fold into the observed tick latency (a
        saturated-device simulator).  Never sleeps — overload is
        reported to the degradation ladder, not actually paid."""
        if self.slow_rate > 0.0 and \
                self._rng_slow.random() < self.slow_rate:
            self.slowed_dispatches += 1
            return self.slow_extra
        return 0.0

    def queue_burst(self) -> bool:
        """Consulted once per beat: True while a seeded queue-pressure
        burst is active — the scenario withholds drains/ticks so
        bounded ingest queues fill toward their limits."""
        if self._qburst_left > 0:
            self._qburst_left -= 1
            return True
        if self.queue_burst_rate > 0.0 and \
                self._rng_qburst.random() < self.queue_burst_rate:
            self._qburst_left = self.queue_burst_len - 1
            self.queue_bursts += 1
            return True
        return False

    # -- process kill points -------------------------------------------------
    def should_kill(self, command_index: int) -> bool:
        """True when the scripted workload should SIGKILL itself after
        command ``command_index`` (0-based) — a modular schedule, so one
        plan yields a kill point however long the run is."""
        return (self.kill_every is not None and command_index >= 0
                and (command_index + 1) % self.kill_every == 0)


def truncate_file(path: str, drop_bytes: int) -> int:
    """Chop ``drop_bytes`` off the end of ``path`` (a torn-write
    simulator for WAL segments); returns the new size."""
    size = os.path.getsize(path)
    new = max(0, size - int(drop_bytes))
    with open(path, "rb+") as f:
        f.truncate(new)
    return new
