"""Crash-safe serving: durable snapshots + write-ahead replay recovery;
the port of ``repro.serve.recovery``.

The serving stack (``ingest -> scheduler -> tick engine -> verdicts``,
see :mod:`repro_torch.serve.tuning`) holds state in three places: device
tensors (the ``[S, M, K]`` DP rows and moment slabs), host bookkeeping
(ingest queues, slot layout, cohort clocks, decision history) and the
on-disk trace.  A process crash loses the first two.  This module makes
the whole service durable with the database recipe:

**snapshot + write-ahead log (WAL) => bit-identical recovery.**

* :func:`snapshot_service` dehydrates a live :class:`TuningService` into
  ONE dict-nested numpy tree (device slabs gathered from the bank
  shards, copied to the host and sliced to the live packed columns;
  every queue, clock, counter and pending verdict alongside; the
  JSON-able metadata rides as a ``uint8`` leaf) that round-trips through
  :mod:`repro_torch.checkpoint`: two-phase atomic saves,
  manifest-verified restores, no pickles.
* :func:`restore_service` rehydrates that tree into a fresh process on
  ``device``, or onto a bank mesh of any device count (``mesh=``): the
  packed state is re-homed through the service's own K-axis gather
  (``_pack_device_state``, an identity gather plus the re-pad to the
  target's width, split over its shards), so the restored ticks run on
  the card's kernels.
* :class:`RecoverableTuningService` wraps the service with the WAL
  discipline.  The ingest layer's :class:`~repro_torch.serve.ingest.
  TraceLog` IS the journal: every accepted push already lands there with
  its replay context (samples, variance row, heartbeat stamp), and the
  wrapper journals every OTHER mutating command (submit / tick / finish
  / evict / quarantine / drain, one event record per command) into the
  same sequence space, flushing after each command so *acked == durable*.
  :meth:`RecoverableTuningService.checkpoint` saves a snapshot stamped
  with the journal watermark (``TraceLog.next_seq``);
  :meth:`RecoverableTuningService.recover` loads the newest complete
  snapshot and REPLAYS the journal tail (``seq >= watermark``) against
  it with journaling suppressed.

Every layer underneath is exactly re-executable (chunked DP == one-shot
DP, any drain grouping == any other, decisions independent of packing
history), so replaying the logged commands reproduces the crashed
service's scores, probabilities, decisions and schedule position
bitwise, tick for tick.

The snapshot layout, its JSON keys, ``SNAPSHOT_VERSION`` and the bank
fingerprint are the reference's, so a snapshot either package writes
restores in the other.

Torn-write tolerance: a crash mid-``flush`` may leave a truncated final
``.npz`` segment; :class:`TraceLog` skips it (counted, warned) and
recovery proceeds from the durable prefix.  A crash mid-snapshot leaves
no ``manifest.json``, so :func:`repro_torch.checkpoint.
load_checkpoint_tree` falls back to the newest COMPLETE step.

What is NOT persisted: process-local handles (the device or mesh, the
retry policy, a chaos plan, the ReferenceDB object), which the restoring
caller re-supplies, and the wavelet coefficient cache, rebuilt lazily,
bitwise the same.  A snapshot holds no trace of the mesh it was taken
on, so it restores onto any other.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..checkpoint import CheckpointManager, load_checkpoint_tree
from ..core.database import ReferenceDB, SeriesBank
from ..core.tuner import TuneDecision
from ..core import wavelet as _wavelet
from ..kernels.common import resolve_device
from ..runtime.chaos import FaultPlan
from ..runtime.fault import WorkerState
from ..runtime.retry import CircuitBreaker, RetryPolicy
from ..sharding.mesh import BankMesh
from .ingest import PoisonedSampleError, TraceLog
from .tuning import InFlightJob, TuningService

__all__ = ["SNAPSHOT_VERSION", "snapshot_service", "restore_service",
           "RecoverableTuningService"]

SNAPSHOT_VERSION = 1


def _bank_fingerprint(svc: TuningService) -> str:
    """Content hash of the reference bank a snapshot was taken against.

    Restore refuses a mismatched bank: the packed DP columns are
    positional, so rehydrating them against different references would
    silently mis-score every job."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(svc.bank.series).tobytes())
    h.update(np.ascontiguousarray(svc.bank.lengths).tobytes())
    h.update(json.dumps(list(svc._labels)).encode())
    return h.hexdigest()


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor: a snapshot must not alias the service's
    state, which a ladder-capped tick updates in place."""
    return np.array(t.cpu())


def _decision_record(d: Optional[TuneDecision]) -> Optional[Dict]:
    return None if d is None else d.to_record()


def _decision_from(rec: Optional[Dict],
                   svc: TuningService) -> Optional[TuneDecision]:
    if rec is None:
        return None
    d = TuneDecision.from_record(rec)
    # to_record drops the transferred config (it lives on the matched DB
    # entry); re-derive it exactly as the original decision did.
    if d.matched is not None and svc.db is not None:
        d.config = svc.db.best_config(d.matched)
    return d


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------

def snapshot_service(svc: TuningService) -> Dict[str, Any]:
    """Dehydrate a live service into a dict-nested numpy tree.

    The tree is pure ``{str: array-or-dict}``: what
    :func:`repro_torch.checkpoint.save_checkpoint` persists with
    leaf-path manifests, so :func:`repro_torch.checkpoint.
    load_checkpoint_tree` rebuilds it in a fresh process with no target
    skeleton.  Device state comes back to the host gathered from the
    bank shards, then sliced to the live packed columns (``k_live``);
    re-padding is the restorer's job.
    Metadata that is JSON, not array (config, slot layout, per-job
    scalars, pending decisions, counters), rides as one ``uint8`` JSON
    leaf."""
    k_live = len(svc._packed_idx)
    jobs_meta: List[Dict[str, Any]] = []
    jobs_tree: Dict[str, Dict[str, np.ndarray]] = {}
    for i, job in enumerate(svc._jobs.values()):
        ji = svc._front._jobs[job.job_id]
        jm: Dict[str, Any] = {
            "job_id": job.job_id, "slot": int(job.slot),
            "expected_len": int(job.expected_len),
            "tick_hz": job.tick_hz, "n": int(job.n),
            "leader": job.leader, "stable_for": int(job.stable_for),
            "qos": job.qos,
            "degraded_level": int(job.degraded_level),
            "early": _decision_record(job.early),
            "pushed": int(ji.pushed),
            "dropped": int(ji.buffer.dropped),
            "vdropped": int(ji.vbuffer.dropped)
            if ji.vbuffer is not None else 0,
        }
        jt: Dict[str, np.ndarray] = {}
        x = job.x.view()
        if x.shape[0]:
            jt["x"] = np.array(x, np.float32)
        vx = job.vx.view()
        if vx.shape[0]:
            jt["vx"] = np.array(vx, np.float32)
        if job.last_sims is not None:
            jt["last_sims"] = np.array(job.last_sims, np.float64)
        if job.last_probs is not None:
            jt["last_probs"] = np.array(job.last_probs, np.float64)
        if job.allowed is not None:
            jt["allowed"] = np.array(job.allowed, bool)
        # pending (pushed, not yet drained) ingest queues.  Chunk
        # boundaries are irrelevant to both drain (one concatenate) and
        # drop_oldest shedding (sheds a sample COUNT off the front), so
        # one concatenated row per queue is an exact snapshot.
        buf = ji.buffer.drain()
        if buf is not None:
            jt["buf"] = np.array(buf, np.float32)
            ji.buffer.append(buf)               # put it back (read-only op)
        if ji.vbuffer is not None:
            vbuf = ji.vbuffer.drain()
            if vbuf is not None:
                jt["vbuf"] = np.array(vbuf, np.float32)
                ji.vbuffer.append(vbuf)
        if ji.filt is not None:
            # the port's filter state is [1, order]; the reference's
            # (and the snapshot's) [order]
            jt["filtz"] = _host(ji.filt._z.reshape(-1))
        jobs_meta.append(jm)
        jobs_tree[str(i)] = jt

    fq_meta: List[Dict[str, Any]] = []
    fq_tree: Dict[str, Dict[str, np.ndarray]] = {}
    for i, (jid, x, vxq, early) in enumerate(svc._finish_queue):
        fq_meta.append({"job_id": jid, "early": _decision_record(early)})
        ft = {"x": np.array(x, np.float32)}
        if vxq is not None:
            ft["vx"] = np.array(vxq, np.float32)
        fq_tree[str(i)] = ft

    front = svc._front
    hb = None
    if front.heartbeats is not None:
        hb = {"high_water": front.heartbeats._sweep_high_water,
              "workers": [[w.worker_id, int(w.last_step),
                           float(w.last_time), bool(w.alive)]
                          for w in front.heartbeats.workers.values()]}

    meta: Dict[str, Any] = {
        "version": SNAPSHOT_VERSION,
        "bank": {"k": svc._k, "m": svc._m,
                 "fingerprint": _bank_fingerprint(svc)},
        "config": svc._config,
        "scheduler": svc._sched.state_dict(),
        "dirty": [int(s) for s in svc._dirty],
        "jobs": jobs_meta,
        "finish_queue": fq_meta,
        "finished": {j: d.to_record() for j, d in svc._finished.items()},
        "undelivered": {j: d.to_record()
                        for j, d in svc._undelivered.items()},
        "quarantined": dict(svc.quarantined),
        "last_push": dict(front._last_push),
        "heartbeats": hb,
        "stragglers": {j: list(d)
                       for j, d in front.stragglers._durations.items()},
        "counters": {
            "dispatch_count": svc.dispatch_count,
            "repack_count": svc.repack_count,
            "slot_repack_count": svc.slot_repack_count,
            "rescale_count": svc.rescale_count,
            "evicted_count": svc.evicted_count,
            "offline_dispatch_count": svc.offline_dispatch_count,
            "ticks": svc.ticks,
            "retry_count": svc.retry_count,
            "degraded_dispatch_count": svc.degraded_dispatch_count,
            "quarantined_count": svc.quarantined_count,
            "quarantine_dropped": svc.quarantine_dropped,
            "shed_count": svc.shed_count,
            "shed_by_class": dict(svc.shed_by_class),
            "overload_ticks": svc.overload_ticks,
            "worst_rung": svc.worst_rung,
        },
        # overload control plane: the ladder's rung/window and the
        # breaker's state machine must survive a crash so recovery of an
        # OVERLOADED service replays the same rung trajectory.
        "overload": (svc._overload.state_dict()
                     if svc._overload is not None else None),
        "breaker": (svc.breaker.state_dict()
                    if svc.breaker is not None else None),
        # WAL watermark: replay records with seq >= this after restoring.
        "watermark": front.trace.next_seq if front.trace is not None
        else 0,
    }

    device: Dict[str, np.ndarray] = {
        "packed_idx": np.asarray(svc._packed_idx, np.int64),
        "rows": _host(svc._rows[:, :, :k_live]),
        "ns": _host(svc._ns),
        "sx": _host(svc._sx),
        "sxx": _host(svc._sxx),
        "qlens": np.asarray(svc._qlens, np.int32),
    }
    if svc._moms is not None:
        device["moms"] = _host(svc._moms[:, :, :, :k_live])
    if svc._vstats is not None:
        device["vstats"] = _host(svc._vstats)

    return {"meta_json": np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), np.uint8).copy(),
        "device": device, "jobs": jobs_tree, "fq": fq_tree}


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def restore_service(tree: Dict[str, Any],
                    refs: Union[ReferenceDB, SeriesBank], *,
                    device: Union[str, torch.device, None] = None,
                    mesh: Optional[BankMesh] = None,
                    trace_log: Optional[TraceLog] = None,
                    retry_policy: Optional[RetryPolicy] = None,
                    chaos: Optional[FaultPlan] = None,
                    breaker: Optional[CircuitBreaker] = None
                    ) -> TuningService:
    """Rehydrate a :func:`snapshot_service` tree into a live service on
    ``device`` (CUDA unless the caller passes another), or sharded over
    ``mesh`` (a 1-D :class:`repro_torch.sharding.BankMesh`).

    ``refs`` must be the SAME reference bank the snapshot was taken
    against (content-hash enforced).  ``mesh`` may differ from the
    crashed process's: the packed device state is re-homed by the
    service's K-axis gather with the snapshot's columns as the previous
    pack, an identity gather on the live columns plus fresh padding to
    the target mesh's width (exactly a rescale's re-pad), then split
    over its shards.  Every score is a per-column quantity, so the
    restored service's decisions are bitwise identical whatever the
    mesh.  Process-local handles (``trace_log``, ``retry_policy``,
    ``chaos``, ``breaker``) are re-supplied here, not persisted, but the
    breaker's state machine and the overload ladder's rung/window ARE
    restored onto them, so an overloaded service recovers mid-ladder."""
    meta = json.loads(bytes(np.asarray(tree["meta_json"],
                                       np.uint8)).decode())
    if meta["version"] != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {meta['version']} != "
                         f"{SNAPSHOT_VERSION}")
    svc = TuningService(refs, device=device, mesh=mesh, trace_log=trace_log,
                        retry_policy=retry_policy, chaos=chaos,
                        breaker=breaker, **meta["config"])
    dev = svc.device
    if meta.get("overload") is not None and svc._overload is not None:
        svc._overload.load_state(meta["overload"])
    if meta.get("breaker") is not None and svc.breaker is not None:
        svc.breaker.load_state(meta["breaker"])
    if meta["bank"]["fingerprint"] != _bank_fingerprint(svc):
        raise ValueError("snapshot was taken against a different "
                         "reference bank (content hash mismatch)")

    svc._sched.load_state(meta["scheduler"])
    svc._s_cap = svc._sched.capacity
    svc._dirty = [int(s) for s in meta["dirty"]]

    state = tree.get("device", {})

    def upload(name, dtype):
        return torch.tensor(np.asarray(state[name], dtype), device=dev)

    svc._replicate(upload("ns", np.int32), upload("sx", np.float32),
                   upload("sxx", np.float32),
                   upload("vstats", np.float32) if "vstats" in state
                   else None)
    svc._qlens = np.asarray(state["qlens"], np.int32).copy()

    # Re-home the packed DP state.  _pack_device_state gathers surviving
    # columns out of tensors aligned with the PREVIOUS _packed_idx: set
    # that to the snapshot's index first and the gather is the identity
    # on the live columns, with fresh +inf/zero padding to the target
    # mesh's bucket width, split over its shards.
    idx = np.asarray(state["packed_idx"], np.int64)
    rows = upload("rows", np.float32)
    moms = upload("moms", np.float32) if "moms" in state else None
    svc._packed_idx = idx
    svc._pack_device_state(idx, rows, moms)

    jobs_tree = tree.get("jobs", {})
    for i, jm in enumerate(meta["jobs"]):
        jt = jobs_tree.get(str(i), {})
        job = InFlightJob(
            job_id=jm["job_id"], slot=int(jm["slot"]),
            expected_len=int(jm["expected_len"]),
            tick_hz=jm["tick_hz"],
            haar=_wavelet.StreamingHaar(int(jm["expected_len"]))
            if svc.prefilter_top is not None else None)
        job.n = int(jm["n"])
        job.leader = jm["leader"]
        job.stable_for = int(jm["stable_for"])
        job.qos = jm.get("qos", "silver")
        job.degraded_level = int(jm.get("degraded_level", 0))
        job.early = _decision_from(jm["early"], svc)
        if "x" in jt:
            x = np.asarray(jt["x"], np.float32)
            job.x.append(x)
            if job.haar is not None:
                # one-shot rebuild == the original per-chunk updates,
                # bitwise (the pyramid refresh is prefix-deterministic).
                job.haar.update(x)
        if "vx" in jt:
            job.vx.append(np.asarray(jt["vx"], np.float32))
        if "last_sims" in jt:
            job.last_sims = np.asarray(jt["last_sims"], np.float64)
        if "last_probs" in jt:
            job.last_probs = np.asarray(jt["last_probs"], np.float64)
        if "allowed" in jt:
            job.allowed = np.asarray(jt["allowed"], bool)
        svc._front.register(job.job_id)
        ji = svc._front._jobs[job.job_id]
        ji.pushed = int(jm["pushed"])
        ji.buffer.dropped = int(jm["dropped"])
        if "buf" in jt:
            ji.buffer.append(np.asarray(jt["buf"], np.float32))
        if ji.vbuffer is not None:
            ji.vbuffer.dropped = int(jm["vdropped"])
            if "vbuf" in jt:
                ji.vbuffer.append(np.asarray(jt["vbuf"], np.float32))
        if ji.filt is not None and "filtz" in jt:
            ji.filt._z = torch.tensor(
                np.asarray(jt["filtz"], np.float32)).reshape(1, -1)
        svc._jobs[job.job_id] = job

    fq_tree = tree.get("fq", {})
    for i, fm in enumerate(meta["finish_queue"]):
        ft = fq_tree[str(i)]
        svc._finish_queue.append(
            (fm["job_id"], np.asarray(ft["x"], np.float32),
             np.asarray(ft["vx"], np.float32) if "vx" in ft else None,
             _decision_from(fm["early"], svc)))
    svc._finished = {j: _decision_from(r, svc)
                     for j, r in meta["finished"].items()}
    svc._undelivered = {j: _decision_from(r, svc)
                        for j, r in meta["undelivered"].items()}
    svc.quarantined = dict(meta["quarantined"])

    front = svc._front
    front._last_push = {j: float(t)
                        for j, t in meta["last_push"].items()}
    if front.heartbeats is not None and meta["heartbeats"] is not None:
        front.heartbeats._sweep_high_water = float(
            meta["heartbeats"]["high_water"])
        for wid, step, t, alive in meta["heartbeats"]["workers"]:
            front.heartbeats.workers[wid] = WorkerState(
                wid, last_step=int(step), last_time=float(t),
                alive=bool(alive))
    for j, durs in meta["stragglers"].items():
        for d in durs:
            front.stragglers.record(j, float(d))

    c = meta["counters"]
    svc.dispatch_count = int(c["dispatch_count"])
    svc.repack_count = int(c["repack_count"])
    svc.slot_repack_count = int(c["slot_repack_count"])
    svc.rescale_count = int(c["rescale_count"])
    svc.evicted_count = int(c["evicted_count"])
    svc.offline_dispatch_count = int(c["offline_dispatch_count"])
    svc.ticks = int(c["ticks"])
    svc.retry_count = int(c["retry_count"])
    svc.degraded_dispatch_count = int(c["degraded_dispatch_count"])
    svc.quarantined_count = int(c["quarantined_count"])
    svc.quarantine_dropped = int(c["quarantine_dropped"])
    svc.shed_count = int(c.get("shed_count", 0))
    svc.shed_by_class = {k: int(v)
                         for k, v in c.get("shed_by_class", {}).items()}
    svc.overload_ticks = int(c.get("overload_ticks", 0))
    svc.worst_rung = int(c.get("worst_rung", 0))
    return svc


# ---------------------------------------------------------------------------
# the WAL wrapper
# ---------------------------------------------------------------------------

class RecoverableTuningService:
    """Crash-safe façade: ``TuningService`` + journal + snapshots.

    Layout under ``root``::

        root/wal/    TraceLog journal (push chunks + command events)
        root/ckpt/   CheckpointManager snapshots (two-phase atomic)

    Every mutating command is executed, journaled, then FLUSHED before
    it returns — a command the caller saw succeed is durable, and a
    crash mid-command at worst loses that un-acked command (at-most-once
    on the unflushed tail, never divergence).  Pushes are journaled by
    the ingest layer itself (with variance row and heartbeat stamp);
    everything else becomes one ``append_event`` record, so the journal
    is a total order over commands and ``next_seq`` doubles as the
    schedule position.  :meth:`checkpoint` snapshots the service with
    the current watermark and prunes the journal below it (override
    with ``prune=False``); :meth:`recover` = newest complete snapshot +
    replay of the journal tail, bit-identical to the uninterrupted run
    (see the module docstring for why replay is exact).

    Poisoned pushes need one extra journal record: the push itself is
    rejected atomically (never journaled), but the quarantine eviction
    it triggers DID mutate the service, so the wrapper journals an
    explicit ``quarantine`` event before re-raising — replay re-evicts
    instead of re-poisoning.
    """

    def __init__(self, refs: Union[ReferenceDB, SeriesBank], *,
                 root: str,
                 keep: int = 3,
                 device: Union[str, torch.device, None] = None,
                 mesh: Optional[BankMesh] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 chaos: Optional[FaultPlan] = None,
                 _service: Optional[TuningService] = None,
                 **svc_kwargs) -> None:
        self.root = root
        # effectively unbounded rotation: the journal is bounded by
        # checkpoint-time pruning, not by dropping un-replayed tail.
        self.wal = TraceLog(os.path.join(root, "wal"),
                            max_segments=1 << 30)
        self.manager = CheckpointManager(os.path.join(root, "ckpt"),
                                         keep=keep)
        self.refs = refs
        self.svc = _service if _service is not None else TuningService(
            refs, device=device, mesh=mesh, trace_log=self.wal,
            retry_policy=retry_policy, chaos=chaos, **svc_kwargs)
        #: journal records replayed by :meth:`recover` (0 on a cold
        #: start or when the snapshot was current).
        self.replayed = 0

    # -- journaling -----------------------------------------------------------
    def _journal(self, kind: str, payload: Dict[str, Any]) -> None:
        self.wal.append_event(kind, payload)
        self.wal.flush()

    # -- journaled commands ---------------------------------------------------
    def submit(self, job_id: str, expected_len: int,
               tick_hz: Optional[float] = None,
               qos: str = "silver") -> InFlightJob:
        # a SHED submit mutates nothing and is never journaled — the
        # AdmissionShedError propagates before the journal line below.
        job = self.svc.submit(job_id, expected_len, tick_hz=tick_hz,
                              qos=qos)
        self._journal("submit", {"job_id": job_id,
                                 "expected_len": int(expected_len),
                                 "tick_hz": tick_hz, "qos": qos})
        return job

    def push(self, job_id: str, samples, variance=None,
             now: Optional[float] = None) -> None:
        # the accepted chunk is journaled inside IngestFront.push (same
        # sequence space); flush makes it durable before the ack.
        try:
            self.svc.push(job_id, samples, variance=variance, now=now)
        except PoisonedSampleError as err:
            self._journal("quarantine", {"job_id": job_id,
                                         "reason": err.reason})
            raise
        self.wal.flush()

    def tick(self, now: Optional[float] = None):
        # journal AFTER execution so the measured tick latency — the
        # overload ladder's input signal — rides in the record; replay
        # feeds it back via ``tick(latency=...)`` and the restored
        # service walks the exact same rung trajectory.
        out = self.svc.tick(now=now)
        self._journal("tick", {"now": now,
                               "latency": self.svc.last_tick_latency})
        return out

    def finish(self, job_id: str) -> TuneDecision:
        return self.finish_many((job_id,))[job_id]

    def finish_many(self, job_ids) -> Dict[str, TuneDecision]:
        ids = list(job_ids)
        out = self.svc.finish_many(ids)
        self._journal("finish", {"job_ids": ids})
        return out

    def finish_later(self, job_id: str) -> None:
        self.svc.finish_later(job_id)
        self._journal("finish_later", {"job_id": job_id})

    def drain_finishes(self) -> Dict[str, TuneDecision]:
        out = self.svc.drain_finishes()
        self._journal("drain", {})
        return out

    def evict(self, job_id: str) -> Optional[TuneDecision]:
        out = self.svc.evict(job_id)
        self._journal("evict", {"job_id": job_id})
        return out

    def sweep_stalled(self, now: float):
        out = self.svc.sweep_stalled(now)
        self._journal("sweep", {"now": float(now)})
        return out

    # -- read-only passthroughs ----------------------------------------------
    def __getattr__(self, name: str):
        # counters, properties, diagnostics — anything not journaled.
        if name == "svc":               # not set yet (mid-construction)
            raise AttributeError(name)
        return getattr(self.svc, name)

    # -- snapshots ------------------------------------------------------------
    def checkpoint(self, step: Optional[int] = None,
                   prune: bool = True) -> int:
        """Durable snapshot of the full service at the current journal
        watermark.  Returns the step id.  ``prune=True`` (default) drops
        journal segments wholly below the watermark — they precede every
        snapshot the manager retains only when ``keep`` snapshots agree,
        so pruning uses the OLDEST retained snapshot's watermark.

        Refuses (``RuntimeError``) while the journal is DEGRADED
        (:attr:`TraceLog.journal_degraded` — flush failing with
        ``OSError``): commands the caller saw succeed are then only in
        memory, and stamping a watermark past ``durable_seq`` would
        silently drop them from every future recovery."""
        self.wal.flush()
        if self.wal.journal_degraded:
            raise RuntimeError(
                "journal degraded: commands past durable_seq="
                f"{self.wal.durable_seq} are not on disk; refusing to "
                "checkpoint a watermark that would orphan them "
                f"(write errors: {self.wal.journal_write_errors})")
        if step is None:
            latest = self.manager.latest_step()
            step = 0 if latest is None else latest + 1
        tree = snapshot_service(self.svc)
        self.manager.save(step, tree)
        if prune:
            floors = []
            for s in self.manager.steps():
                try:
                    t, _ = load_checkpoint_tree(self.manager.root, step=s,
                                                verify=False)
                    floors.append(json.loads(bytes(np.asarray(
                        t["meta_json"], np.uint8)).decode())["watermark"])
                except Exception:        # torn/partial step: keep journal
                    floors.append(0)
            if floors:
                self.wal.prune(min(floors))
        return step

    # -- recovery -------------------------------------------------------------
    @classmethod
    def recover(cls, refs: Union[ReferenceDB, SeriesBank], *,
                root: str,
                keep: int = 3,
                device: Union[str, torch.device, None] = None,
                mesh: Optional[BankMesh] = None,
                retry_policy: Optional[RetryPolicy] = None,
                chaos: Optional[FaultPlan] = None,
                breaker: Optional[CircuitBreaker] = None,
                **svc_kwargs) -> "RecoverableTuningService":
        """Rebuild the service a crashed process was running: newest
        complete snapshot (if any) + replay of every journal record at
        or past its watermark.  With no snapshot the journal replays
        from the beginning against a fresh service.  The restored
        service is bit-identical to the crashed one's last DURABLE
        state: same scores, probabilities, decisions, counters, and
        schedule position, even when ``mesh`` differs from the crashed
        process's.  Replayed ticks run on ``device``'s (or the mesh's)
        kernels."""
        if mesh is None:
            device = resolve_device(device)
        wal = TraceLog(os.path.join(root, "wal"), max_segments=1 << 30)
        watermark = 0
        svc: Optional[TuningService] = None
        try:
            tree, _ = load_checkpoint_tree(os.path.join(root, "ckpt"))
        except FileNotFoundError:
            tree = None
        if tree is not None:
            svc = restore_service(tree, refs, device=device, mesh=mesh,
                                  trace_log=wal, retry_policy=retry_policy,
                                  chaos=chaos, breaker=breaker)
            watermark = json.loads(bytes(np.asarray(
                tree["meta_json"], np.uint8)).decode())["watermark"]
        else:
            svc = TuningService(refs, device=device, mesh=mesh,
                                trace_log=wal, retry_policy=retry_policy,
                                chaos=chaos, breaker=breaker, **svc_kwargs)

        out = cls.__new__(cls)
        out.root = root
        out.wal = wal
        out.manager = CheckpointManager(os.path.join(root, "ckpt"),
                                        keep=keep)
        out.refs = refs
        out.svc = svc
        out.replayed = _replay(svc, wal, watermark)
        return out


def _replay(svc: TuningService, wal: TraceLog, watermark: int) -> int:
    """Re-execute journal records with ``seq >= watermark`` against a
    restored service, with journaling SUPPRESSED (the records are
    already durable; re-journaling would double them).  Returns the
    number of records replayed."""
    records = [r for r in wal.records(since=watermark)]
    # suppress journaling (the records are already durable), chaos
    # injection (replayed samples are the post-corruption originals;
    # re-corrupting them would diverge from the crashed run) AND
    # admission control (a journaled submit was by definition admitted;
    # re-gating it against the restored rung could shed it).
    trace, svc._front.trace = svc._front.trace, None
    chaos, svc.chaos = svc.chaos, None
    suppressed = svc._admission_suppressed
    svc._admission_suppressed = True
    try:
        for _, kind, payload in records:
            if kind == "push":
                svc.push(payload["job_id"], payload["samples"],
                         variance=payload.get("variance"),
                         now=payload.get("now"))
            elif kind == "submit":
                svc.submit(payload["job_id"],
                           int(payload["expected_len"]),
                           tick_hz=payload["tick_hz"],
                           qos=payload.get("qos", "silver"))
            elif kind == "tick":
                # replay the MEASURED latency (absent in journals older
                # than the overload plane: wall-clock is re-measured,
                # harmless when no overload controller is configured).
                svc.tick(now=payload["now"],
                         latency=payload.get("latency"))
            elif kind == "finish":
                svc.finish_many(payload["job_ids"])
            elif kind == "finish_later":
                svc.finish_later(payload["job_id"])
            elif kind == "drain":
                svc.drain_finishes()
            elif kind == "evict":
                svc.evict(payload["job_id"])
            elif kind == "sweep":
                svc.sweep_stalled(float(payload["now"]))
            elif kind == "quarantine":
                svc._quarantine(payload["job_id"], payload["reason"])
            else:
                raise ValueError(f"unknown journal record kind {kind!r}")
    finally:
        svc._front.trace = trace
        svc.chaos = chaos
        svc._admission_suppressed = suppressed
    return len(records)
