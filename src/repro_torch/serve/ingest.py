"""Ingest front end of the streaming tuning service.

This is the first layer of the serving stack (``ingest -> scheduler ->
tick engine -> verdicts``, see ``serve.tuning``): everything that happens
to a job's samples BEFORE they reach the device-resident matcher lives
here, so the tick engine only ever sees clean, causally-filtered chunks.

* :class:`BoundedBuffer` — the per-job sample queue.  Monitoring agents
  push at their own cadence while the service drains at tick rate; an
  unbounded queue would let one stalled tick loop (or one runaway agent)
  grow host memory without limit.  ``policy="reject"`` raises
  :class:`BackpressureError` at the producer (the MapReduce-side agent
  retries next beat), ``policy="drop_oldest"`` sheds the oldest buffered
  samples instead (the matcher tolerates a gapped prefix far better than
  the cluster tolerates a blocked agent).  Dropped samples are counted.
* :class:`TraceLog` — append-only on-disk capture of every ingested
  chunk, rotated by segment size and segment count.  The paper's offline
  pipeline profiles jobs and stores their series in the reference DB;
  the trace log is how a *serving* deployment gets those series — replay
  yesterday's accepted traces into ``AutoTuner.profile`` instead of
  re-running instrumented jobs.  Persistence reuses the reference DB's
  atomic tmp+rename writers (``core.database``), so a crashed service
  never leaves a torn segment.
* :class:`IngestFront` — per-job composition of the above plus the
  causal streaming Chebyshev filter (``denoise=True``) and heartbeat
  stamping: every push beats a ``runtime.fault.HeartbeatTracker`` and
  feeds a ``runtime.fault.StragglerDetector`` with the observed
  inter-push gaps, which is what lets the scheduler layer evict a
  stalled job's slot (``TuningService.sweep_stalled``) and flag jobs
  whose monitoring agent has degraded.

The filter is applied at *drain* time on the concatenated chunk, on the
host, before the tick uploads it.  In the probabilistic mode
(``track_variance=True``) per-sample measurement variances ride beside
the samples in a second queue (``push(variance=)``,
``drain(with_variance=True)``).
"""

from __future__ import annotations

import collections
import json
import warnings
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core.database import atomic_write_json, atomic_write_npz
from ..core.filters import StreamingFilter
from ..runtime.fault import HeartbeatTracker, StragglerDetector

__all__ = ["BackpressureError", "PoisonedSampleError", "BoundedBuffer",
           "TraceLog", "IngestFront"]


class BackpressureError(RuntimeError):
    """Raised by a full ``policy="reject"`` :class:`BoundedBuffer`."""


class PoisonedSampleError(ValueError):
    """A push carried values the matcher must never see: NaN/Inf samples
    or negative/non-finite variances.  Raised BEFORE anything is
    enqueued (the push is atomic), so the serving layer can quarantine
    the offending job while every other job's state stays untouched.
    Subclasses ``ValueError`` for callers of the pre-quarantine API."""

    def __init__(self, job_id: str, reason: str) -> None:
        super().__init__(f"job {job_id!r}: {reason}")
        self.job_id = job_id
        self.reason = reason


class BoundedBuffer:
    """Bounded per-job sample queue between the push side and the tick.

    ``limit`` bounds the number of *samples* (not chunks) buffered;
    ``None`` means unbounded (the pre-refactor behavior).  On overflow
    ``policy="reject"`` refuses the whole push with
    :class:`BackpressureError` — nothing is partially enqueued, so the
    producer can retry the identical chunk — while ``"drop_oldest"``
    sheds buffered samples from the front until the new chunk fits
    (``dropped`` counts every sample lost this way).

    Counter invariant (conservation): ``total_in`` counts every sample
    *accepted* into the buffer (pre-shed size, including the samples a
    ``drop_oldest`` shed immediately discards), so at any quiescent point
    ``total_in == drained-so-far + len(buffer) + dropped``.
    """

    def __init__(self, limit: Optional[int] = None,
                 policy: str = "reject") -> None:
        if policy not in ("reject", "drop_oldest"):
            raise ValueError(f"unknown backpressure policy {policy!r}")
        if limit is not None and limit < 1:
            raise ValueError("queue limit must be >= 1 (or None)")
        self.limit = limit
        self.policy = policy
        self.dropped = 0
        self.total_in = 0
        self._chunks: Deque[np.ndarray] = collections.deque()
        self._pending = 0

    def __len__(self) -> int:
        return self._pending

    def append(self, samples: np.ndarray) -> None:
        s = np.asarray(samples, np.float32).reshape(-1)
        if not s.shape[0]:
            return
        # Count the ORIGINAL push size before any overflow truncation
        # below rebinds ``s`` — counting after the `s = s[-limit:]` shed
        # undercounted total_in and broke the conservation invariant.
        pushed = s.shape[0]
        if self.limit is not None and self._pending + s.shape[0] > self.limit:
            if self.policy == "reject":
                raise BackpressureError(
                    f"buffer full ({self._pending}/{self.limit} samples "
                    f"pending); tick() the service or slow the producer")
            if s.shape[0] >= self.limit:      # chunk alone overflows
                self.dropped += self._pending + s.shape[0] - self.limit
                self._chunks.clear()
                self._pending = 0
                s = s[-self.limit:]
            else:
                while self._pending + s.shape[0] > self.limit:
                    head = self._chunks[0]
                    need = self._pending + s.shape[0] - self.limit
                    if head.shape[0] <= need:
                        self._chunks.popleft()
                        self._pending -= head.shape[0]
                        self.dropped += head.shape[0]
                    else:
                        self._chunks[0] = head[need:]
                        self._pending -= need
                        self.dropped += need
        self._chunks.append(s)
        self._pending += s.shape[0]
        self.total_in += pushed

    def drain(self) -> Optional[np.ndarray]:
        """All buffered samples as one chunk (None when empty)."""
        if not self._pending:
            return None
        out = self._chunks.popleft() if len(self._chunks) == 1 \
            else np.concatenate(self._chunks)
        self._chunks.clear()
        self._pending = 0
        return out


class TraceLog:
    """Size-rotated on-disk capture of ingested chunks — and the serving
    stack's write-ahead log.

    Chunks accumulate in memory and flush to ``seg-<n>.npz`` once
    ``max_segment_bytes`` of float32 samples are pending (or on an
    explicit :meth:`flush`); only the newest ``max_segments`` segment
    files are kept.  A ``trace_index.json`` manifest records the live
    segment names and the next record sequence number.  Writes are
    atomic (tmp+rename via ``core.database``), so readers — and a
    service restarted mid-write — never observe a torn file.

    WAL duties (``serve.recovery``):

    * **records carry replay context** — a chunk record can ride with
      the push's per-sample variances and heartbeat timestamp (aux
      ``v``/``t`` entries under the same sequence number), and
      :meth:`append_event` journals non-push commands (submit / tick /
      finish / evict ...) as JSON payloads, all in ONE total order.
    * **durable across restart** — a TraceLog reopened on an existing
      directory adopts the on-disk index and resumes the sequence
      counter, so a recovering process appends after the crashed
      process's last durable record instead of clobbering the journal.
    * **torn tails are data, not errors** — a segment truncated by the
      crash (or corrupted on disk) is skipped with a warning and
      counted in ``corrupt_segments``; everything before it replays.
    * **write failures degrade, never raise mid-push** — a flush that
      hits ``OSError`` (disk full, permissions yanked) keeps every
      record pending in memory, sets ``journal_degraded`` and counts
      ``journal_write_errors``; the next flush retries the identical
      segment (atomic overwrite, so a half-landed attempt is
      harmless).  ``durable_seq`` reports how far the journal is
      actually on disk — ``serve.recovery`` refuses to advance a
      checkpoint watermark past it, because records that exist only in
      this process would otherwise be double-applied or lost.
    * :meth:`prune` drops segments wholly below a snapshot watermark
      once a snapshot has made them redundant.
    """

    def __init__(self, path: str, *, max_segment_bytes: int = 1 << 20,
                 max_segments: int = 8) -> None:
        import os
        if max_segment_bytes < 4 or max_segments < 1:
            raise ValueError("rotation limits must be positive")
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.max_segment_bytes = max_segment_bytes
        self.max_segments = max_segments
        #: segments found unreadable (truncated/corrupt) — each bad file
        #: is counted once, at first encounter.
        self.corrupt_segments = 0
        #: True while flushed-but-unwritable records are held in memory
        #: only (disk write failed); clears when a flush lands.
        self.journal_degraded = False
        #: flush attempts that failed with OSError.
        self.journal_write_errors = 0
        self._bad: set = set()
        # (seq, {full_key: array}) per un-flushed record
        self._pending: List[Tuple[int, Dict[str, np.ndarray]]] = []
        self._pending_bytes = 0
        self._seq = 0
        self._segments: List[str] = []
        self._adopt_existing()

    def _adopt_existing(self) -> None:
        """Resume from an on-disk journal: adopt the indexed segments
        that still exist and continue the sequence counter past every
        durable record (legacy indexes without ``next_seq`` derive it
        from the newest readable segment's keys)."""
        import os
        idx_path = os.path.join(self.path, "trace_index.json")
        if not os.path.isfile(idx_path):
            return
        try:
            with open(idx_path) as f:
                idx = json.load(f)
            segs = [s for s in idx.get("segments", [])
                    if os.path.isfile(os.path.join(self.path, s))]
        except (OSError, ValueError):
            warnings.warn(f"unreadable trace_index.json under "
                          f"{self.path}; starting a fresh journal",
                          RuntimeWarning)
            return
        self._segments = segs
        next_seq = idx.get("next_seq")
        if next_seq is None:
            next_seq = 0
            for seg in reversed(segs):
                arrs = self._segment_arrays(seg)
                if arrs:
                    next_seq = 1 + max(int(k[1:9]) for k in arrs)
                    break
                # even an unreadable tail pins the floor via its name
                next_seq = max(next_seq, int(seg[4:12]))
        self._seq = int(next_seq)

    def _record(self, seq: int, arrays: Dict[str, np.ndarray]) -> None:
        self._pending.append((seq, arrays))
        self._pending_bytes += sum(a.nbytes for a in arrays.values())
        if self._pending_bytes >= self.max_segment_bytes:
            self.flush()

    def append(self, job_id: str, samples: np.ndarray,
               variance: Optional[np.ndarray] = None,
               now: Optional[float] = None) -> Optional[int]:
        """Journal one accepted push.  ``variance``/``now`` ride as aux
        entries under the same sequence number so a replay can re-issue
        the push exactly (probabilistic mode, heartbeat stamps).
        Returns the record's sequence number (None for empty pushes)."""
        s = np.asarray(samples, np.float32).reshape(-1)
        if not s.shape[0]:
            return None
        seq, self._seq = self._seq, self._seq + 1
        arrays = {f"c{seq:08d}__{job_id}": s}
        if variance is not None:
            arrays[f"v{seq:08d}__{job_id}"] = \
                np.asarray(variance, np.float32).reshape(-1)
        if now is not None:
            arrays[f"t{seq:08d}__{job_id}"] = \
                np.asarray([now], np.float64)
        self._record(seq, arrays)
        return seq

    def append_event(self, kind: str, payload: Dict[str, Any]) -> int:
        """Journal a non-push command (JSON payload) into the same total
        order as the chunk records — the WAL entries replay recovery
        re-executes after the snapshot watermark."""
        if "__" in kind:
            raise ValueError("event kind must not contain '__'")
        seq, self._seq = self._seq, self._seq + 1
        blob = np.frombuffer(
            json.dumps(payload, sort_keys=True).encode(), np.uint8)
        self._record(seq, {f"e{seq:08d}__{kind}": blob})
        return seq

    @property
    def next_seq(self) -> int:
        """Sequence number the NEXT record will get (== the snapshot
        watermark when taken between commands)."""
        return self._seq

    @property
    def durable_seq(self) -> int:
        """First sequence number NOT yet durable on disk.  Equals
        ``next_seq`` when everything pending has flushed; lags behind it
        while records are held in memory (including the
        ``journal_degraded`` disk-failure mode)."""
        return self._pending[0][0] if self._pending else self._seq

    def flush(self) -> None:
        import os
        if not self._pending:
            return
        name = f"seg-{self._pending[0][0]:08d}.npz"
        arrays: Dict[str, np.ndarray] = {}
        for _, recs in self._pending:
            arrays.update(recs)
        old_segments = self._segments
        try:
            atomic_write_npz(self.path, name, arrays)
            self._segments = self._segments + [name]
            drop = self._segments[:max(0, len(self._segments)
                                       - self.max_segments)]
            self._segments = self._segments[len(drop):]
            try:
                self._write_index()
            except OSError:
                self._segments = old_segments
                raise
        except OSError as e:
            # Disk refused the write: degrade to in-memory-only — the
            # records stay pending (still replayable from this process,
            # still visible to ``records()``) and the NEXT flush retries
            # the same segment name, so a half-landed attempt overwrites
            # cleanly.  Never raise mid-push.
            self.journal_write_errors += 1
            if not self.journal_degraded:
                warnings.warn(
                    f"trace journal write failed under {self.path} "
                    f"({type(e).__name__}: {e}); holding records in "
                    f"memory (journal_degraded)", RuntimeWarning)
            self.journal_degraded = True
            return
        self._pending = []
        self._pending_bytes = 0
        for old in drop:                                   # rotate
            try:
                os.unlink(os.path.join(self.path, old))
            except OSError:
                pass
        self.journal_degraded = False

    def _write_index(self) -> None:
        atomic_write_json(self.path, "trace_index.json",
                          {"version": 2, "segments": self._segments,
                           "next_seq": self._seq})

    def segments(self) -> List[str]:
        return list(self._segments)

    def _segment_arrays(self, seg: str) -> Optional[Dict[str, np.ndarray]]:
        """All entries of one segment, or None when the file is
        truncated/corrupt (counted + warned once per file) — the crash
        case the WAL must shrug off, not die on."""
        import os
        if seg in self._bad:
            return None
        try:
            with np.load(os.path.join(self.path, seg)) as z:
                return {k: np.array(z[k]) for k in z.files}
        except Exception as e:          # torn zip: BadZipFile/OSError/...
            self._bad.add(seg)
            self.corrupt_segments += 1
            warnings.warn(f"trace segment {seg} is truncated or corrupt "
                          f"({type(e).__name__}: {e}); skipping",
                          RuntimeWarning)
            return None

    def prune(self, before_seq: int) -> int:
        """Delete segments whose every record precedes ``before_seq``
        (they are covered by a snapshot); returns segments dropped."""
        import os
        keep: List[str] = []
        dropped = 0
        for i, seg in enumerate(self._segments):
            # a segment's records span [its name seq, next segment's)
            nxt = int(self._segments[i + 1][4:12]) \
                if i + 1 < len(self._segments) else self._seq
            if nxt <= before_seq:
                dropped += 1
                try:
                    os.unlink(os.path.join(self.path, seg))
                except FileNotFoundError:
                    pass
            else:
                keep.append(seg)
        if dropped:
            self._segments = keep
            self._write_index()
        return dropped

    def records(self, since: int = 0) -> List[Tuple[int, str,
                                                    Dict[str, Any]]]:
        """Every durable + pending record with ``seq >= since``, in
        sequence order: ``(seq, kind, payload)`` where pushes have kind
        ``"push"`` and payload ``{job_id, samples, variance, now}``, and
        events carry their JSON payloads under their own kind.  Corrupt
        segments are skipped (see ``corrupt_segments``)."""
        by_seq: Dict[int, Dict[str, Any]] = {}
        for seg in self._segments:
            arrs = self._segment_arrays(seg)
            if arrs:
                self._parse_into(by_seq, arrs)
        for _, recs in self._pending:
            self._parse_into(by_seq, recs)
        return [(seq, *by_seq[seq]["_rec"]) for seq in sorted(by_seq)
                if seq >= since]

    @staticmethod
    def _parse_into(by_seq: Dict[int, Dict[str, Any]],
                    arrays: Dict[str, np.ndarray]) -> None:
        for key, arr in arrays.items():
            tag, seq, rest = key[0], int(key[1:9]), key[11:]
            slot = by_seq.setdefault(seq, {})
            if tag == "e":
                slot["_rec"] = (rest, json.loads(bytes(arr).decode()))
                continue
            if "_rec" not in slot:
                slot["_rec"] = ("push", {"job_id": rest, "samples": None,
                                         "variance": None, "now": None})
            payload = slot["_rec"][1]
            if tag == "c":
                payload["samples"] = arr
            elif tag == "v":
                payload["variance"] = arr
            elif tag == "t":
                payload["now"] = float(arr[0])

    def read_job(self, job_id: str) -> np.ndarray:
        """Concatenated retained samples of one job, ingest order (the
        replay path into ``AutoTuner.profile``).  Pending un-flushed
        chunks are included; truncated/corrupt segments are skipped."""
        parts: List[tuple] = []
        for seg in self._segments:
            arrs = self._segment_arrays(seg)
            if arrs is None:
                continue
            for key, arr in arrs.items():
                seq, _, jid = key.partition("__")
                if key[0] == "c" and jid == job_id:
                    parts.append((int(seq[1:]), arr))
        for seq, recs in self._pending:
            for key, arr in recs.items():
                if key[0] == "c" and key.partition("__")[2] == job_id:
                    parts.append((seq, arr))
        if not parts:
            return np.zeros((0,), np.float32)
        return np.concatenate([c for _, c in sorted(parts,
                                                    key=lambda p: p[0])])


class _JobIngest:
    """Per-job ingest state: queue (+ optional variance queue) + causal
    filter."""

    __slots__ = ("buffer", "vbuffer", "filt", "pushed")

    def __init__(self, buffer: BoundedBuffer,
                 filt: Optional[StreamingFilter],
                 vbuffer: Optional[BoundedBuffer] = None) -> None:
        self.buffer = buffer
        self.vbuffer = vbuffer
        self.filt = filt
        self.pushed = 0


class IngestFront:
    """Routes pushes into per-job bounded queues, stamps heartbeats, and
    hands the tick engine causally-filtered chunks on drain.

    ``track_variance=True`` adds a per-job *variance* queue riding in
    lockstep with the sample queue (same limit/policy, identical chunk
    sizes, so ``drop_oldest`` sheds both by the same counts and
    ``reject`` raises before either mutates): :meth:`push` then accepts
    optional per-sample measurement variances and
    ``drain(with_variance=True)`` returns an aligned ``(chunk, vchunk)``
    pair.  Samples pushed *without* an explicit variance get a default at
    drain time: the squared causal-filter residual ``(raw - filtered)^2``
    when ``denoise=True`` (the filter's own estimate of per-sample
    measurement noise), else 0.0 — so exact pushes stay exact.
    """

    def __init__(self, *, denoise: bool = False,
                 queue_limit: Optional[int] = None,
                 queue_policy: str = "reject",
                 trace: Optional[TraceLog] = None,
                 heartbeat_timeout: Optional[float] = None,
                 straggler_factor: float = 2.0,
                 track_variance: bool = False) -> None:
        BoundedBuffer(queue_limit, queue_policy)   # validate eagerly
        self.denoise = denoise
        self.queue_limit = queue_limit
        self.queue_policy = queue_policy
        self.trace = trace
        self.track_variance = track_variance
        self.heartbeats = HeartbeatTracker(timeout=heartbeat_timeout) \
            if heartbeat_timeout is not None else None
        self.stragglers = StragglerDetector(factor=straggler_factor)
        self._jobs: Dict[str, _JobIngest] = {}
        self._last_push: Dict[str, float] = {}

    def register(self, job_id: str) -> None:
        self._jobs[job_id] = _JobIngest(
            BoundedBuffer(self.queue_limit, self.queue_policy),
            StreamingFilter() if self.denoise else None,
            BoundedBuffer(self.queue_limit, self.queue_policy)
            if self.track_variance else None)

    def push(self, job_id: str, samples: np.ndarray,
             variance: Optional[np.ndarray] = None,
             now: Optional[float] = None) -> None:
        ji = self._jobs[job_id]
        s = np.asarray(samples, np.float32).reshape(-1)
        if variance is not None and ji.vbuffer is None:
            raise ValueError("per-sample variance requires "
                             "track_variance=True on the IngestFront")
        # Poison checks run BEFORE anything is enqueued or journaled:
        # a poisoned push is atomic (nothing partially accepted), so the
        # serving layer can quarantine the job while survivors never see
        # the bad values.
        if not np.all(np.isfinite(s)):
            raise PoisonedSampleError(job_id, "non-finite sample (NaN/Inf)")
        if ji.vbuffer is not None:
            # NaN marks "no variance supplied" — resolved to the causal
            # filter residual (or 0.0) at drain time, when the filtered
            # values exist.
            v = np.full((s.shape[0],), np.nan, np.float32) \
                if variance is None \
                else np.asarray(variance, np.float32).reshape(-1)
            if v.shape[0] != s.shape[0]:
                raise ValueError(f"{s.shape[0]} samples but "
                                 f"{v.shape[0]} variances")
            supplied = v[~np.isnan(v)]
            if np.any(supplied < 0.0):
                raise PoisonedSampleError(
                    job_id, "variances must be >= 0")
            if not np.all(np.isfinite(supplied)):
                raise PoisonedSampleError(job_id, "non-finite variance")
        ji.buffer.append(s)                      # may raise Backpressure
        if ji.vbuffer is not None and s.shape[0]:
            # Same pre-push pending count and same chunk length as the
            # sample buffer, so this cannot raise after buffer accepted.
            ji.vbuffer.append(v)
        ji.pushed += s.shape[0]
        if self.trace is not None and s.shape[0]:
            # journal with full replay context: the variance row (when
            # tracked) and the heartbeat stamp ride the chunk record.
            self.trace.append(
                job_id, s,
                variance=v if ji.vbuffer is not None else None, now=now)
        if now is not None:
            if self.heartbeats is not None:
                self.heartbeats.beat(job_id, ji.pushed, now)
            prev = self._last_push.get(job_id)
            if prev is not None and now > prev:
                self.stragglers.record(job_id, now - prev)
            self._last_push[job_id] = now

    def has_data(self, job_id: str) -> bool:
        return len(self._jobs[job_id].buffer) > 0

    def drain(self, job_id: str, with_variance: bool = False):
        """Buffered samples as ONE causally-filtered chunk (None when
        the queue is empty) — bit-identical to filtering the same
        samples in any other push/drain grouping (the streaming filter
        is stateful and causal).

        ``with_variance=True`` (requires ``track_variance=True``)
        returns an aligned ``(chunk, vchunk)`` pair instead, with
        unsupplied variances defaulted from the filter residual."""
        ji = self._jobs[job_id]
        if with_variance and ji.vbuffer is None:
            raise ValueError("drain(with_variance=True) requires "
                             "track_variance=True on the IngestFront")
        raw = ji.buffer.drain()
        if raw is None:
            return (None, None) if with_variance else None
        chunk = ji.filt(raw) if ji.filt is not None else raw
        if ji.vbuffer is None:
            return chunk
        vchunk = ji.vbuffer.drain()
        if not with_variance:
            return chunk
        resid = (raw - chunk) ** 2 if ji.filt is not None \
            else np.zeros_like(raw)
        vchunk = np.where(np.isnan(vchunk), resid, vchunk) \
            .astype(np.float32)
        return chunk, vchunk

    def dropped(self, job_id: str) -> int:
        return self._jobs[job_id].buffer.dropped

    def queue_fill(self) -> float:
        """Worst-case bounded-buffer occupancy across registered jobs in
        [0, 1].  0.0 when queues are unbounded (no limit to fill)."""
        if self.queue_limit is None or not self._jobs:
            return 0.0
        worst = max(len(ji.buffer) for ji in self._jobs.values())
        return min(1.0, worst / float(self.queue_limit))

    def stalled(self, now: float) -> List[str]:
        """Job ids newly declared dead by the heartbeat tracker."""
        if self.heartbeats is None:
            return []
        return [j for j in self.heartbeats.sweep(now) if j in self._jobs]

    def retire(self, job_id: str) -> None:
        self._jobs.pop(job_id)
        self._last_push.pop(job_id, None)
        if self.heartbeats is not None:
            self.heartbeats.forget(job_id)
