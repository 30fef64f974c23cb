"""Slot scheduler of the streaming tuning service.

Second layer of the serving stack (``ingest -> scheduler -> tick engine
-> verdicts``, see ``serve.tuning``): WHO occupies WHICH row of the
device-resident ``[S, M, K]`` tick state, and WHEN each job's buffered
samples are drained into a tick.

S-axis slot bucketing
---------------------
The tick engine's device arrays are sized by the slot capacity S.  A
fixed S = ``max_slots`` wastes compute and bandwidth whenever fewer jobs
are in flight — and a serving front sized for a 1024-job burst idles at
64 jobs most of the day.  The scheduler therefore sizes S to the
power-of-two bucket of the *active* job count (floor
:data:`MIN_SLOT_BUCKET`, ceiling ``max_slots``): state shapes stay few
(at most log2(S) buckets), growth re-packs the state tensors by an
S-axis ``index_select`` on the device (never a host round-trip), and
shrink COMPACTS surviving jobs into the low slots before cutting
capacity.  Per-job DP state is row-independent, so slot moves are
bit-exact: every decision is invariant to packing, admission order and
capacity history.  Re-packs are counted by the service in
``slot_repack_count``, never inflating ``dispatch_count``.

Tick-rate cohorts
-----------------
Jobs declare a monitoring rate at submit (``tick_hz``); jobs sharing a
rate form a cohort with one due-clock.  ``tick(now=...)`` drains only
the cohorts whose period has elapsed, so a 4 Hz trace is touched (host
chunk assembly, score scatter, decision rule) only on its own beats
instead of paying for a 100 Hz neighbor's cadence — between beats its
samples just accumulate in the ingest queue.  Jobs without a rate sit
in the always-due cohort, and a clock-less ``tick()`` drains everyone:
the pre-cohort behavior, preserving dispatches == data-ticks.

Fault wiring
------------
The scheduler consumes the ingest layer's ``HeartbeatTracker`` sweeps:
a job whose monitoring agent stops pushing is *evicted* — slot freed
with no verdict, state compacted at the next tick — rather than pinning
a device row forever (``TuningService.sweep_stalled``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

__all__ = ["MIN_SLOT_BUCKET", "slot_bucket", "TickCohorts", "SlotScheduler"]

#: smallest elastic S capacity: one growth step below this saves little
#: (the arrays are tiny) while doubling the compiled tick shapes.
MIN_SLOT_BUCKET = 4


def slot_bucket(n: int, max_slots: int,
                lo: int = MIN_SLOT_BUCKET) -> int:
    """Padded slot capacity for ``n`` active jobs: the power of two >= n
    (floor ``lo``), clamped to ``max_slots``."""
    p = max(lo, 1 << max(n - 1, 0).bit_length())
    return min(max_slots, max(p, n))


class TickCohorts:
    """Groups jobs by declared tick rate and meters their drains.

    One due-clock per distinct ``tick_hz``; a cohort becomes due when
    ``now`` passes its next-due time, and draining re-arms it one period
    ahead.  ``tick_hz=None`` jobs are always due, and a ``now=None``
    query means "ignore pacing" (every job due) — both keep the legacy
    drain-everything semantics.
    """

    def __init__(self) -> None:
        self._hz: Dict[str, Optional[float]] = {}
        self._next_due: Dict[float, float] = {}
        #: re-arm stretch factor (>= 1.0): the overload ladder's
        #: ``slow_cohorts`` rung sets this > 1 so due cohorts re-arm
        #: ``scale / hz`` ahead instead of ``1 / hz`` — jobs tick less
        #: often under load, they are never skipped outright.
        self.rate_scale: float = 1.0

    def assign(self, job_id: str, tick_hz: Optional[float]) -> None:
        if tick_hz is not None and tick_hz <= 0:
            raise ValueError("tick_hz must be positive (or None)")
        self._hz[job_id] = tick_hz
        if tick_hz is not None:
            self._next_due.setdefault(float(tick_hz), -np.inf)

    def remove(self, job_id: str) -> None:
        self._hz.pop(job_id, None)

    @property
    def n_cohorts(self) -> int:
        """Distinct rate cohorts with members (always-due counts as one
        when any unrated job exists)."""
        rates = set(self._hz.values())
        return len(rates)

    def due_jobs(self, now: Optional[float]) -> Set[str]:
        """Jobs whose cohort should drain at ``now`` (all jobs when
        ``now`` is None); due rate-cohorts are re-armed
        ``rate_scale/hz`` ahead."""
        if now is None:
            return set(self._hz)
        due_rates = {hz for hz, t in self._next_due.items() if now >= t}
        for hz in due_rates:
            self._next_due[hz] = now + self.rate_scale / hz
        return {j for j, hz in self._hz.items()
                if hz is None or float(hz) in due_rates}

    # -- (de)hydration (serve.recovery) --------------------------------------
    def state_dict(self) -> Dict:
        """JSON-able snapshot of the cohort clocks (``-inf`` next-due
        values survive the round trip: stdlib json emits ``-Infinity``),
        so a restored service re-arms every cohort where the snapshotted
        one left it.  The keys are the reference's."""
        return {"hz": dict(self._hz),
                "next_due": {repr(hz): t
                             for hz, t in self._next_due.items()},
                "rate_scale": self.rate_scale}

    def load_state(self, state: Dict) -> None:
        self._hz = {j: (None if hz is None else float(hz))
                    for j, hz in state["hz"].items()}
        self._next_due = {float(hz): float(t)
                          for hz, t in state["next_due"].items()}
        self.rate_scale = float(state.get("rate_scale", 1.0))


class SlotScheduler:
    """Slot admission/eviction with power-of-two S-axis capacity.

    ``elastic=False`` pins capacity at ``max_slots`` (the pre-refactor
    fixed-slot service); ``elastic=True`` starts at the smallest bucket
    and grows/shrinks with the active set.  The scheduler only plans —
    every plan returns a gather ``src`` array (new slot -> old slot, -1
    for fresh rows) that the tick engine applies to its device arrays;
    host bookkeeping (job -> slot, free list) is committed here in the
    same call so the two views never diverge.
    """

    def __init__(self, max_slots: int, *, elastic: bool = True) -> None:
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self.elastic = elastic
        self.capacity = slot_bucket(0, max_slots) if elastic else max_slots
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._slot_of: Dict[str, int] = {}
        self.cohorts = TickCohorts()

    @property
    def n_active(self) -> int:
        return len(self._slot_of)

    def slot_of(self, job_id: str) -> int:
        return self._slot_of[job_id]

    def admit(self, job_id: str,
              tick_hz: Optional[float] = None
              ) -> Tuple[int, Optional[np.ndarray]]:
        """Assign the lowest free slot, growing capacity to the next
        bucket when none is free.  Returns ``(slot, grow_src)`` where
        ``grow_src`` (int64 [new_capacity], old slot or -1) is the
        S-axis gather the engine must apply BEFORE using the slot, or
        None when capacity is unchanged.  Raises ``RuntimeError`` once
        ``max_slots`` jobs are in flight — admission control is the
        caller-visible backpressure, elastic or not."""
        if job_id in self._slot_of:
            raise ValueError(f"job {job_id!r} already scheduled")
        grow_src = None
        if not self._free:
            if self.n_active >= self.max_slots:
                raise RuntimeError(f"all {self.max_slots} slots busy")
            new_cap = slot_bucket(self.n_active + 1, self.max_slots)
            grow_src = np.concatenate([
                np.arange(self.capacity, dtype=np.int64),
                np.full((new_cap - self.capacity,), -1, np.int64)])
            self._free = list(range(new_cap - 1, self.capacity - 1, -1))
            self.capacity = new_cap
        slot = self._free.pop()
        self._slot_of[job_id] = slot
        self.cohorts.assign(job_id, tick_hz)
        return slot, grow_src

    def release(self, job_id: str) -> int:
        slot = self._slot_of.pop(job_id)
        self._free.append(slot)
        self.cohorts.remove(job_id)
        return slot

    def shrink_plan(self) -> Optional[Tuple[np.ndarray,
                                            Dict[str, int]]]:
        """When the active set fits a smaller bucket, compact jobs into
        the low slots (stable: slot order preserved) and cut capacity.
        Returns ``(src, moves)`` — the S-axis gather plus the job ->
        new-slot reassignments, already committed to the host
        bookkeeping — or None when capacity should stand.  Hysteresis
        is inherent to the power-of-two buckets: a set oscillating
        within one bucket never re-packs."""
        if not self.elastic:
            return None
        target = slot_bucket(self.n_active, self.max_slots)
        if target >= self.capacity:
            return None
        order = sorted(self._slot_of.items(), key=lambda kv: kv[1])
        src = np.full((target,), -1, np.int64)
        moves: Dict[str, int] = {}
        for new_slot, (job_id, old_slot) in enumerate(order):
            src[new_slot] = old_slot
            moves[job_id] = new_slot
        self._slot_of.update(moves)
        self._free = list(range(target - 1, len(order) - 1, -1))
        self.capacity = target
        return src, moves

    def due_jobs(self, now: Optional[float],
                 job_ids: Iterable[str]) -> Set[str]:
        due = self.cohorts.due_jobs(now)
        return due.intersection(job_ids) if now is not None else set(job_ids)

    # -- (de)hydration (serve.recovery) --------------------------------------
    def state_dict(self) -> Dict:
        """JSON-able snapshot of the slot layout (capacity bucket, free
        list ORDER, job -> slot map, cohort clocks).  The free-list order
        decides which slot the next admit takes, so a restored service
        packs its next jobs as the snapshotted one would have."""
        return {"max_slots": self.max_slots, "elastic": self.elastic,
                "capacity": self.capacity, "free": list(self._free),
                "slot_of": dict(self._slot_of),
                "cohorts": self.cohorts.state_dict()}

    def load_state(self, state: Dict) -> None:
        self.max_slots = int(state["max_slots"])
        self.elastic = bool(state["elastic"])
        self.capacity = int(state["capacity"])
        self._free = [int(s) for s in state["free"]]
        self._slot_of = {j: int(s) for j, s in state["slot_of"].items()}
        self.cohorts.load_state(state["cohorts"])
