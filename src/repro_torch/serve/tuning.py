"""Streaming self-tuning service: match in-flight jobs WHILE they execute.

The paper's end goal is acting on a job *before* it finishes: compare the
utilization pattern observed so far against the reference database, and
as soon as the most probable execution pattern is clear, transfer that
workload's tuned configuration.  This service runs that matching phase
online on one device, in exact point mode or in probabilistic mode.

Layered serving stack
---------------------
* **ingest** (``serve.ingest``): bounded per-job sample queues with
  backpressure, optional rotated trace persistence, the causal streaming
  Chebyshev filter, and heartbeat/straggler stamping of every push.
* **scheduler** (``serve.scheduler``): slot admission/eviction with
  power-of-two S-axis capacity buckets (the device state is sized to the
  ACTIVE job count, growing and compact-shrinking by on-device
  ``index_select`` gathers), plus tick-rate cohorts so ``tick(now=...)``
  drains a 4 Hz trace only on its own beats.
* **tick engine** (this module + ``core.dtw``): each in-flight job
  occupies one slot; its DP row against the whole reference bank and the
  warp-path correlation moments of every row cell live stacked with every
  other job's as ``[S, M, K]`` / ``[3, S, M, K]`` device tensors (K
  last).  :meth:`TuningService.tick` drains every due job's samples into
  ONE launch of the scored streaming kernel (K1, or K4 in probabilistic
  mode), which returns a ``[S, K]`` open-end warp-correlation array.
  ``dispatch_count`` records the invariant: dispatches == ticks with
  data, however many jobs are in flight.
* **verdicts** (this module): :meth:`TuningService.finish` recomputes the
  final verdict from the job's full (causally filtered) query at the
  closed alignment endpoint with the verdict kernel (K2, or K5 in
  probabilistic mode).
  :meth:`finish_many` renders J decisions from one drain tick + one
  launch, and :meth:`finish_later` parks completed jobs in a drain queue
  that :meth:`drain_finishes` — or an automatic drain at
  ``finish_batch`` pending verdicts — renders in one launch, so
  ``offline_dispatch_count`` amortizes.  Batched and sequential verdicts
  are bit-identical by construction.

The early-decision rule is confidence/abstain: emit a
:class:`core.tuner.TuneDecision` only once the leading workload has
cleared the threshold AND led the runner-up by ``margin`` for
``stable_ticks`` consecutive scoring ticks, with at least
``min_fraction`` of the job observed (>= 2 distinct workloads required —
no vacuous margins).

A job's decisions (early and final — matched workload, correlation,
``decided_at_fraction``) are bit-for-bit independent of slot packing,
admission order, tick-rate cohort, capacity history and verdict
batching: per-job DP state is row-independent and per-reference.

Probabilistic (uncertain-series) mode
-------------------------------------
``min_probability=`` switches the decision gates from the point
correlation to a calibrated match probability (arXiv:1112.5505): pushes
may carry per-sample measurement variances (``push(..., variance=)``;
unsupplied variances default to the causal filter's squared residual,
or 0.0 without ``denoise``), the tick's moment slab carries the
variance-weighted twins of (sy, syy, sxy) along the same warp path
beside a per-slot ``[S, 3]`` (sv, svx, svxx) fold, and the tick returns
``[S, K]`` probabilities ``P[true warp correlation >= threshold]``
beside the scores.  The leader is still ranked by point correlation, but
the commit gate becomes ``P >= min_probability`` (in flight and at the
final verdict), and the emitted ``TuneDecision`` records the
probability.  At zero input variance the probability is exactly 1.0 iff
the correlation clears ``threshold``, so probabilistic decisions reduce
bitwise to the point rule.  ``prob_mode`` picks the in-flight tail:

* ``"exact"`` (default): six channels ([6, S, M, K]: sy, syy, sxy, svy,
  svyy, svxy), the exact tail.
* ``"approx"``: four channels (sy, syy, sxy, svy), svyy and svxy rebuilt
  at the tail from the folds — 5 state channels a cell instead of 7.

Verdicts (:meth:`finish`, :meth:`finish_many`) always go through the
exact six-channel scorer (kernel K5), whatever mode served the ticks, so
verdict probabilities are bitwise independent of ``prob_mode``.

Not ported yet (the constructor keywords exist and raise
``NotImplementedError`` naming the ROADMAP.md queue item): the
distance-only tick and the serving-front extras (``score_in_flight=
False``, ``retry_policy``, ``chaos``, ``overload``, ``admission``,
``breaker``, :class:`MultiTenantTuningService`: item 6), the wavelet
prefilter (item 7) and bank sharding (``mesh``: item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import dtw as _dtw
from ..core.database import ReferenceDB, SeriesBank
from ..core.similarity import MATCH_THRESHOLD
from ..core.tuner import TuneDecision, _RowBuffer
from ..kernels.common import resolve_device
from .ingest import IngestFront, PoisonedSampleError, TraceLog
from .scheduler import SlotScheduler

__all__ = ["InFlightJob", "TuningService", "MultiTenantTuningService"]


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item {item}")


@dataclasses.dataclass
class InFlightJob:
    """Host-side bookkeeping for one slot (device state lives stacked in
    the service's ``[S, M, K]`` tensors; buffering/filtering lives in the
    ingest layer)."""
    job_id: str
    slot: int
    expected_len: int
    tick_hz: Optional[float] = None
    x: _RowBuffer = dataclasses.field(default_factory=_RowBuffer)
    n: int = 0
    leader: Optional[str] = None
    stable_for: int = 0
    early: Optional[TuneDecision] = None
    #: per-sample measurement variances aligned with ``x`` (filled only
    #: in probabilistic mode; empty otherwise).
    vx: _RowBuffer = dataclasses.field(default_factory=_RowBuffer)
    #: last [K] open-end score row seen for this job (float64 on the
    #: host; None until the first tick touches the job).
    last_sims: Optional[np.ndarray] = None
    #: last [K] match-probability row (probabilistic mode only).
    last_probs: Optional[np.ndarray] = None
    #: QoS class the job was submitted under (read by admission control,
    #: which is not ported yet).
    qos: str = "silver"

    @property
    def fraction_seen(self) -> float:
        return self.n / max(self.expected_len, 1)


class TuningService:
    """Multiplexed online matcher over a fixed reference bank.

    ``refs`` is a :class:`ReferenceDB` (bank + config transfer) or a bare
    :class:`SeriesBank` (matching only).  ``device`` is where the tick
    state lives and the kernels run: CUDA unless the caller passes
    another (``device="cpu"`` runs the kernels' plain versions).
    ``min_probability=`` enables the probabilistic decision rule and
    ``prob_mode`` ("exact" or "approx", the latter needing
    ``min_probability``) its in-flight tail; see the module docstring.

    Serving-front knobs:

    * ``slots`` caps concurrent jobs; with ``elastic_slots=True`` (the
      default) the device state is sized to the power-of-two bucket of
      the ACTIVE job count (``slot_repack_count`` counts the S-axis
      gathers); ``elastic_slots=False`` pins ``slots`` rows.
    * ``queue_limit``/``queue_policy`` bound each job's ingest queue
      (``"reject"`` raises ``serve.ingest.BackpressureError`` at the
      producer, ``"drop_oldest"`` sheds and counts).
    * ``trace_log`` (a :class:`serve.ingest.TraceLog`) persists every
      accepted chunk with size/count rotation.
    * ``heartbeat_timeout`` arms per-job heartbeats: pushes carrying a
      ``now=`` timestamp beat the tracker, and :meth:`sweep_stalled`
      evicts jobs whose agent went silent.
    * ``submit(..., tick_hz=)`` assigns the job to a tick-rate cohort;
      ``tick(now=...)`` drains only due cohorts.
    * ``finish_batch`` sets the drain-queue auto-flush threshold.
    """

    def __init__(self, refs: Union[ReferenceDB, SeriesBank], *,
                 band: Optional[int] = None,
                 threshold: float = MATCH_THRESHOLD,
                 min_probability: Optional[float] = None,
                 prob_mode: str = "exact",
                 margin: float = 0.02, stable_ticks: int = 3,
                 min_fraction: float = 0.15, slots: int = 8,
                 denoise: bool = False,
                 score_in_flight: Optional[bool] = None,
                 collect_rows: Optional[bool] = None,
                 mesh=None,
                 prefilter_top: Optional[int] = None,
                 prefilter_margin: float = 0.05,
                 prefilter_min_fraction: float = 0.1,
                 prefilter_coeffs: int = 64,
                 finish_batch: int = 16,
                 elastic_slots: bool = True,
                 queue_limit: Optional[int] = None,
                 queue_policy: str = "reject",
                 trace_log: Optional[TraceLog] = None,
                 heartbeat_timeout: Optional[float] = None,
                 retry_policy=None, chaos=None, overload=None,
                 admission=None, breaker=None,
                 device: Union[str, torch.device, None] = None) -> None:
        if score_in_flight is None:
            score_in_flight = True if collect_rows is None else collect_rows
        if not score_in_flight:
            raise _not_ported("score_in_flight=False (the distance-only "
                              "tick, kernel K3)", 6)
        if min_probability is not None \
                and not 0.0 < min_probability <= 1.0:
            raise ValueError("min_probability must be in (0, 1]")
        if prob_mode not in ("exact", "approx"):
            raise ValueError("prob_mode must be 'exact' or 'approx', got "
                             f"{prob_mode!r}")
        if prob_mode == "approx" and min_probability is None:
            raise ValueError("prob_mode='approx' needs min_probability= "
                             "(the approximate tail serves the in-flight "
                             "probability gate)")
        if mesh is not None:
            raise _not_ported("bank sharding (mesh=)", 10)
        if prefilter_top is not None:
            raise _not_ported("the wavelet prefilter (prefilter_top=)", 7)
        for name, val in (("retry_policy", retry_policy), ("chaos", chaos),
                          ("overload", overload), ("admission", admission),
                          ("breaker", breaker)):
            if val is not None:
                raise _not_ported(f"{name}=", 6)
        if finish_batch < 1:
            raise ValueError("finish_batch must be >= 1")
        if isinstance(refs, ReferenceDB):
            self.db: Optional[ReferenceDB] = refs
            self.bank = refs.bank()
        else:
            self.db = None
            self.bank = refs
        if len(self.bank) == 0:
            raise ValueError("empty reference bank")
        self.device = resolve_device(device)
        self._labels: Tuple[str, ...] = self.bank.labels or tuple(
            f"ref{k}" for k in range(len(self.bank)))
        self._n_workloads = len(set(self._labels))
        self.band = band
        self.threshold = threshold
        self.min_probability = min_probability
        self.prob_mode = prob_mode
        self.margin = margin
        self.stable_ticks = stable_ticks
        self.min_fraction = min_fraction
        self.slots = slots
        self.denoise = denoise
        self.finish_batch = finish_batch

        k, m = self.bank.series.shape
        self._k = k
        # one device upload of the bank serves the tick and the verdicts
        plan = self.bank.score_plan(self.device)
        self._bank_t = plan.bank_t                         # [M, K]
        self._lengths = plan.lengths                       # [K]
        self._jobs: Dict[str, InFlightJob] = {}
        # slots awaiting their fresh-state reset (applied in one masked
        # op at the top of the next data tick, see submit()).
        self._dirty: List[int] = []
        self._front = IngestFront(
            denoise=denoise, queue_limit=queue_limit,
            queue_policy=queue_policy, trace=trace_log,
            heartbeat_timeout=heartbeat_timeout,
            track_variance=min_probability is not None)
        self._sched = SlotScheduler(slots, elastic=elastic_slots)
        self._s_cap = self._sched.capacity
        dev, s = self.device, self._s_cap
        self._rows = torch.full((s, m, k), _dtw._INF, dtype=torch.float32,
                                device=dev)
        # moment channels: 3 point, 6 exact-probability, 4 approx
        if min_probability is None:
            nch = 3
        else:
            nch = 4 if prob_mode == "approx" else 6
        self._moms = torch.zeros((nch, s, m, k), dtype=torch.float32,
                                 device=dev)
        self._ns = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._sx = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._sxx = torch.zeros((s,), dtype=torch.float32, device=dev)
        # probabilistic mode: per-slot (sv, svx, svxx) variance folds
        self._vstats = torch.zeros((s, 3), dtype=torch.float32,
                                   device=dev) \
            if min_probability is not None else None
        self._qlens = np.zeros((s,), np.int32)

        #: kernel launches issued by :meth:`tick` — one per tick with
        #: data, however many jobs are live.
        self.dispatch_count = 0
        #: S-axis capacity changes (elastic grow / compact-shrink), never
        #: a dispatch.
        self.slot_repack_count = 0
        #: jobs dropped by :meth:`evict`/:meth:`sweep_stalled` (no
        #: verdict rendered).
        self.evicted_count = 0
        #: verdict launches: one per :meth:`finish`, one per *drain* for
        #: :meth:`finish_many` / the :meth:`finish_later` queue.
        self.offline_dispatch_count = 0
        self.ticks = 0
        #: {job_id: reason} for jobs evicted by the input-poison
        #: quarantine (NaN/Inf samples).  Survivors are bit-identical to
        #: a run that never saw the poisoned job's tail.
        self.quarantined: Dict[str, str] = {}
        self.quarantined_count = 0
        #: pushes dropped because their job was already quarantined.
        self.quarantine_dropped = 0
        # early decisions emitted by a tick the caller didn't see (the
        # internal drain tick of another job's finish()); surfaced by the
        # next tick() return so no decision is ever dropped.
        self._undelivered: Dict[str, TuneDecision] = {}
        # deferred-finish drain queue: (job_id, full query, variances or
        # None, early decision) awaiting one batched verdict, plus
        # auto-drained decisions not yet handed to the caller.
        self._finish_queue: List[Tuple[str, np.ndarray,
                                       Optional[np.ndarray],
                                       Optional[TuneDecision]]] = []
        self._finished: Dict[str, TuneDecision] = {}

    # -- slot-indexed device state ---------------------------------------------
    def _repack_slots(self, src: np.ndarray) -> None:
        """Apply an S-axis gather plan from the scheduler (new slot ->
        old slot, -1 = fresh) to every slot-indexed tensor, on the
        device.  Per-job DP state is row-independent, so a slot move is
        bit-exact; fresh rows get the +inf/zero init a reset writes."""
        dev = self.device
        gather = torch.as_tensor(np.maximum(src, 0), dtype=torch.long,
                                 device=dev)
        fresh = torch.as_tensor(src < 0, device=dev)
        self._rows = torch.where(fresh[:, None, None], _dtw._INF,
                                 self._rows.index_select(0, gather))
        self._moms = torch.where(fresh[None, :, None, None], 0.0,
                                 self._moms.index_select(1, gather))
        self._ns = torch.where(fresh, 0, self._ns.index_select(0, gather))
        self._sx = torch.where(fresh, 0.0, self._sx.index_select(0, gather))
        self._sxx = torch.where(fresh, 0.0,
                                self._sxx.index_select(0, gather))
        if self._vstats is not None:
            self._vstats = torch.where(fresh[:, None], 0.0,
                                       self._vstats.index_select(0, gather))
        self._qlens = np.where(src >= 0, self._qlens[np.maximum(src, 0)],
                               0).astype(np.int32)
        self._s_cap = len(src)
        self.slot_repack_count += 1

    def _apply_resets(self) -> None:
        """Fresh-initialize every slot submitted since the last data tick
        (+inf DP row, zero moments/query stats) in ONE masked op per
        tensor, before any gather or launch."""
        if not self._dirty:
            return
        mask = np.zeros((self._s_cap,), bool)
        mask[self._dirty] = True
        md = torch.as_tensor(mask, device=self.device)
        self._rows = torch.where(md[:, None, None], _dtw._INF, self._rows)
        self._moms = torch.where(md[None, :, None, None], 0.0, self._moms)
        self._ns = torch.where(md, 0, self._ns)
        self._sx = torch.where(md, 0.0, self._sx)
        self._sxx = torch.where(md, 0.0, self._sxx)
        if self._vstats is not None:
            self._vstats = torch.where(md[:, None], 0.0, self._vstats)
        self._dirty = []

    def _maybe_shrink_slots(self) -> None:
        """Compact-shrink the S axis when the active set fits a smaller
        power-of-two bucket (elastic mode; a data tick's preamble)."""
        plan = self._sched.shrink_plan()
        if plan is None:
            return
        src, moves = plan
        self._repack_slots(src)
        for jid, s in moves.items():
            self._jobs[jid].slot = s

    # -- job lifecycle -------------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self._jobs)

    @property
    def slot_capacity(self) -> int:
        """Current S bucket (== ``slots`` when ``elastic_slots=False``)."""
        return self._s_cap

    def submit(self, job_id: str, expected_len: int,
               tick_hz: Optional[float] = None,
               qos: str = "silver") -> InFlightJob:
        """Register an in-flight job (``expected_len`` = predicted total
        sample count; it anchors the Sakoe-Chiba band and the
        fraction-seen gate of the early-decision rule).  ``tick_hz``
        assigns the job to a tick-rate cohort: ``tick(now=...)`` drains
        it only on its own period (None = every tick)."""
        if job_id in self._jobs:
            raise ValueError(f"job {job_id!r} already in flight")
        if expected_len < 1:
            raise ValueError("expected_len must be >= 1")
        slot, grow_src = self._sched.admit(job_id, tick_hz)
        if grow_src is not None:
            self._repack_slots(grow_src)
        # the slot's device state is reset LAZILY (one masked op at the
        # next data tick covers every submit since the last one) — a
        # stale freed row is inert until then: its nvalid is 0 in every
        # launch and only pending jobs' scores are ever read.
        self._dirty.append(slot)
        self._qlens[slot] = expected_len
        job = InFlightJob(job_id=job_id, slot=slot, expected_len=expected_len,
                          tick_hz=tick_hz, qos=qos)
        self._front.register(job_id)
        self._jobs[job_id] = job
        return job

    def push(self, job_id: str, samples: np.ndarray,
             variance: Optional[np.ndarray] = None,
             now: Optional[float] = None) -> None:
        """Buffer newly observed samples; consumed at the job's next due
        tick.  ``now`` stamps the heartbeat/straggler trackers (when
        armed).  ``variance`` (probabilistic mode only) carries aligned
        per-sample measurement variances; when omitted the ingest layer
        estimates them from the causal filter residual at drain time
        (0.0 without ``denoise``).

        Poisoned payloads (NaN/Inf samples, negative or non-finite
        variances) QUARANTINE the job: the push is rejected atomically
        by the ingest layer, the job is evicted with the reason recorded
        in :attr:`quarantined`, and ``PoisonedSampleError`` is re-raised
        to the caller."""
        if job_id in self.quarantined:
            # a sick agent keeps streaming; swallow, never resurrect.
            self.quarantine_dropped += 1
            return
        if job_id not in self._jobs:
            raise KeyError(job_id)
        try:
            self._front.push(job_id, samples, variance=variance, now=now)
        except PoisonedSampleError as err:
            self._quarantine(job_id, err.reason)
            raise

    def _quarantine(self, job_id: str, reason: str) -> None:
        self.quarantined[job_id] = reason
        self.quarantined_count += 1
        self.evict(job_id)

    # -- the hot path --------------------------------------------------------
    def tick(self, now: Optional[float] = None
             ) -> Dict[str, Optional[TuneDecision]]:
        """Drain every due job's buffered samples into ONE launch of the
        scored streaming tick, then apply the early-decision rule to the
        returned [S, K] scores.

        ``now`` meters the tick-rate cohorts: only cohorts whose period
        has elapsed drain.  Without a clock every job is due.

        Returns {job_id: TuneDecision} for decisions *newly emitted* this
        tick (None for touched jobs where the service abstains), plus any
        decision a previous internal tick (see :meth:`finish`) emitted
        but could not deliver.
        """
        self.ticks += 1
        out: Dict[str, Optional[TuneDecision]] = self._undelivered
        self._undelivered = {}
        due = self._sched.due_jobs(now, self._jobs.keys())
        prob = self.min_probability is not None
        pending: List[Tuple[InFlightJob, np.ndarray,
                            Optional[np.ndarray]]] = []
        for job in self._jobs.values():
            if job.job_id not in due:
                continue
            if prob:
                chunk, vchunk = self._front.drain(job.job_id,
                                                  with_variance=True)
            else:
                chunk, vchunk = self._front.drain(job.job_id), None
            if chunk is None:
                continue
            job.x.append(chunk)
            if vchunk is not None:
                job.vx.append(vchunk)
            pending.append((job, chunk, vchunk))
        if not pending:
            return out

        # state motion first (never a dispatch): deferred fresh-slot
        # resets, then the S-axis shrink when the active set fits a
        # smaller bucket.
        self._apply_resets()
        self._maybe_shrink_slots()

        c = _dtw._chunk_bucket(max(ch.shape[0] for _, ch, _ in pending))
        chunks = np.zeros((self._s_cap, c), np.float32)
        nvalid = np.zeros((self._s_cap,), np.int32)
        vchunks = np.zeros((self._s_cap, c), np.float32) if prob else None
        for job, ch, vch in pending:
            chunks[job.slot, : ch.shape[0]] = ch
            nvalid[job.slot] = ch.shape[0]
            if prob:
                vchunks[job.slot, : ch.shape[0]] = vch
        dev = self.device
        args = (self._bank_t, self._lengths,
                torch.from_numpy(chunks).to(dev))
        tail = (torch.from_numpy(nvalid).to(dev),
                torch.from_numpy(self._qlens).to(dev))
        probs_all = None
        if prob:
            tick_fn = _dtw.bank_extend_tick_scored_var_approx_dispatch \
                if self.prob_mode == "approx" \
                else _dtw.bank_extend_tick_scored_var_dispatch
            (self._rows, self._moms, self._ns, self._sx, self._sxx, scores,
             self._vstats, probs) = tick_fn(
                self._rows, self._moms, self._ns, self._sx, self._sxx,
                self._vstats, *args, torch.from_numpy(vchunks).to(dev),
                *tail, band=self.band, threshold=float(self.threshold))
            probs_all = probs.cpu().numpy().astype(np.float64)
        else:
            (self._rows, self._moms, self._ns, self._sx, self._sxx,
             scores) = _dtw.bank_extend_tick_scored_dispatch(
                self._rows, self._moms, self._ns, self._sx, self._sxx,
                *args, *tail, band=self.band)
        self.dispatch_count += 1
        # the tick's device -> host transfers: the [S, K] scores (and
        # the [S, K] probabilities in probabilistic mode).
        sims_all = scores.cpu().numpy().astype(np.float64)

        for job, ch, _ in pending:
            job.n += ch.shape[0]
            job.last_sims = sims_all[job.slot]
            if probs_all is not None:
                job.last_probs = probs_all[job.slot]
            decision = self._maybe_decide(job) if job.early is None \
                else None
            if out.get(job.job_id) is None:
                out[job.job_id] = decision
        return out

    # -- decision rule -------------------------------------------------------
    def _reduce(self, sims: np.ndarray) -> Dict[str, float]:
        """Per-workload best over the bank's (possibly multi-entry) rows."""
        scores: Dict[str, float] = {}
        for lbl, s in zip(self._labels, sims):
            scores[lbl] = max(scores.get(lbl, -1.0), float(s))
        return scores

    @staticmethod
    def _rank(scores: Dict[str, float]) -> Tuple[str, float, float]:
        """(leader, leader_score, runner_up_score); insertion order breaks
        ties so repeated ticks rank deterministically."""
        leader, ls = None, -np.inf
        for w, s in scores.items():
            if s > ls:
                leader, ls = w, s
        rs = max((s for w, s in scores.items() if w != leader), default=-1.0)
        return leader, ls, rs

    def _maybe_decide(self, job: InFlightJob) -> Optional[TuneDecision]:
        if job.n < 2:
            return None
        scores = self._reduce(job.last_sims)
        leader, ls, rs = self._rank(scores)
        # the margin test needs a real runner-up: with < 2 workloads in
        # the bank it would be vacuously true (rs == -1.0), so the
        # service abstains in flight instead of fast-tracking the only
        # candidate (finish() still decides from the complete series).
        margin_ok = self._n_workloads >= 2 and ls - rs >= self.margin
        if leader == job.leader and margin_ok:
            job.stable_for += 1
        else:
            job.stable_for = 1 if margin_ok else 0
        job.leader = leader
        # confidence gate: the point correlation threshold, or in
        # probabilistic mode the leader workload's match probability (a
        # flat posterior keeps the service abstaining even when the point
        # estimate clears the threshold).  At zero input variance the
        # probability is exactly 1{corr >= threshold}: the gates agree.
        lp = None
        if self.min_probability is not None:
            lp = self._reduce(job.last_probs).get(leader, 0.0)
            confident = lp >= self.min_probability
        else:
            confident = ls >= self.threshold
        if (job.fraction_seen >= self.min_fraction
                and confident
                and job.stable_for >= self.stable_ticks):
            cfg = self.db.best_config(leader) if self.db is not None else None
            job.early = TuneDecision(
                workload=job.job_id, matched=leader, corr=ls, config=cfg,
                scores=scores, fraction_seen=job.fraction_seen, final=False,
                decided_at_fraction=job.fraction_seen, probability=lp)
            return job.early
        return None

    # -- fault handling ------------------------------------------------------
    def evict(self, job_id: str) -> Optional[TuneDecision]:
        """Drop an in-flight job WITHOUT a verdict: slot freed, queue and
        heartbeat state discarded, device rows left to be compacted away
        by the next data tick's S-axis shrink.  Returns the job's early
        decision if one was emitted.  Survivors are untouched."""
        if job_id not in self._jobs:
            raise KeyError(job_id)
        _, _, early = self._retire(job_id)
        self.evicted_count += 1
        return early

    def sweep_stalled(self, now: float) -> Dict[str, Optional[TuneDecision]]:
        """Evict every job whose heartbeat (stamped by ``push(...,
        now=)``) is older than the service's ``heartbeat_timeout``.
        Returns {job_id: early decision or None} for the evicted set; a
        no-op (empty dict) when heartbeats are not armed."""
        return {jid: self.evict(jid) for jid in self._front.stalled(now)}

    def stragglers(self) -> List[str]:
        """In-flight jobs whose observed push cadence is consistently
        slower than the cohort median."""
        return [j for j in self._front.stragglers.stragglers()
                if j in self._jobs]

    # -- completion ----------------------------------------------------------
    def _verdict_scores(self, queries, variances=None):
        """[J, K] float64 closed-end scores (and, in probabilistic mode,
        the [J, K] match probabilities, else None) for J completed
        queries in ONE launch of the verdict kernel, the Sakoe-Chiba band
        re-derived from each query's TRUE length.  Queries with fewer
        than 2 samples score 0 without touching the device.  Probabilities
        always come from the exact six-channel tail (kernel K5)."""
        prob = self.min_probability is not None
        out = np.zeros((len(queries), self._k), np.float64)
        pout = np.zeros((len(queries), self._k), np.float64) \
            if prob else None
        live = [i for i, q in enumerate(queries) if q.shape[0] >= 2]
        if not live:
            return out, pout
        # pow2 buckets on both axes, as the reference pads them
        jb = _dtw._pad_pow2(len(live), lo=1)
        npad = _dtw._pad_pow2(max(queries[i].shape[0] for i in live))
        xs = np.zeros((jb, npad), np.float32)
        xl = np.zeros((jb,), np.int32)
        sx = np.zeros((jb,), np.float32)
        sxx = np.zeros((jb,), np.float32)
        xv = np.zeros((jb, npad), np.float32) if prob else None
        for r, i in enumerate(live):
            q = queries[i]
            xs[r, : q.shape[0]] = q
            xl[r] = q.shape[0]
            sx[r], sxx[r] = _dtw.query_moments(q)
            if prob:
                v = variances[i]
                if v is not None and v.shape[0] == q.shape[0]:
                    xv[r, : q.shape[0]] = v
        res = _dtw.dtw_score_bank_many(
            xs, self.bank.series, self.bank.lengths, xlens=xl,
            band=self.band, sx=sx, sxx=sxx, xvars=xv,
            threshold=float(self.threshold),
            plan=self.bank.score_plan(self.device))
        scores, probs = res if prob else (res, None)
        scores = scores.cpu().numpy().astype(np.float64)
        if prob:
            probs = probs.cpu().numpy().astype(np.float64)
        self.offline_dispatch_count += 1
        for r, i in enumerate(live):
            out[i] = scores[r]
            if prob:
                pout[i] = probs[r]
        return out, pout

    def _render_verdict(self, job_id: str, sims: np.ndarray,
                        early: Optional[TuneDecision],
                        probs: Optional[np.ndarray] = None) -> TuneDecision:
        scores = self._reduce(sims)
        leader, ls, _ = self._rank(scores)
        lp = None
        if self.min_probability is not None:
            lp = self._reduce(probs).get(leader, 0.0)
            matched = leader if lp >= self.min_probability else None
        else:
            matched = leader if ls >= self.threshold else None
        cfg = self.db.best_config(matched) \
            if self.db is not None and matched is not None else None
        decision = TuneDecision(
            workload=job_id, matched=matched, corr=ls, config=cfg,
            scores=scores, fraction_seen=1.0, final=True,
            decided_at_fraction=(early.decided_at_fraction
                                 if early is not None else 1.0),
            probability=lp)
        if self.db is not None:
            self.db.record_decision(decision)
        return decision

    def _drain_tick_for(self, finishing) -> None:
        """Flush buffered samples before a verdict (ONE tick covering
        every live job) and park early decisions emitted for jobs that
        are NOT being finished, so they surface from the next tick()."""
        if any(self._front.has_data(j) for j in finishing):
            emitted = self.tick()
            for jid, d in emitted.items():
                if jid not in finishing and d is not None:
                    self._undelivered[jid] = d

    def _retire(self, job_id: str):
        """Free a job's slot, returning its (full query, per-sample
        variances or None, early decision).  A parked early decision must
        not outlive the job (the id is reusable), so it is purged
        here."""
        job = self._jobs.pop(job_id)
        self._undelivered.pop(job_id, None)
        self._sched.release(job_id)
        self._front.retire(job_id)
        vx = job.vx.view() if self.min_probability is not None else None
        return job.x.view(), vx, job.early

    def finish(self, job_id: str) -> TuneDecision:
        """Final verdict for a completed job, recomputed from the full
        streamed (causally filtered) query by the closed-end scorer.
        Frees the slot and, when a ReferenceDB backs the service, records
        the decision history."""
        return self.finish_many((job_id,))[job_id]

    def finish_many(self, job_ids) -> Dict[str, TuneDecision]:
        """Final verdicts for several completed jobs — ONE buffer-drain
        tick plus ONE batched verdict launch, each decision identical to
        what a sequential :meth:`finish` would have rendered."""
        ids = list(job_ids)
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate job ids in finish_many")
        missing = [j for j in ids if j not in self._jobs]
        if missing:
            raise KeyError(f"unknown job(s): {missing}")
        if not ids:
            return {}
        self._drain_tick_for(set(ids))
        retired = [self._retire(j) for j in ids]
        sims, probs = self._verdict_scores([x for x, _, _ in retired],
                                           [v for _, v, _ in retired])
        return {jid: self._render_verdict(
                    jid, sims[i], retired[i][2],
                    None if probs is None else probs[i])
                for i, jid in enumerate(ids)}

    def finish_later(self, job_id: str) -> None:
        """Deferred finish: the job leaves its slot now, but its verdict
        joins the drain queue and is rendered by the next
        :meth:`drain_finishes` — or automatically once ``finish_batch``
        verdicts are pending — in one batched launch with the others.
        Deferring an id whose previous verdict is still undelivered is
        refused (drain first): the two decisions would collide."""
        if any(jid == job_id for jid, *_ in self._finish_queue) \
                or job_id in self._finished:
            raise ValueError(
                f"a verdict for job {job_id!r} is already pending "
                "delivery; drain_finishes() before deferring a reused id")
        self._drain_tick_for({job_id})
        x, vx, early = self._retire(job_id)
        self._finish_queue.append((job_id, x, vx, early))
        if len(self._finish_queue) >= self.finish_batch:
            self._finished.update(self._drain_queue())

    def _drain_queue(self) -> Dict[str, TuneDecision]:
        if not self._finish_queue:
            return {}
        queued, self._finish_queue = self._finish_queue, []
        sims, probs = self._verdict_scores([x for _, x, _, _ in queued],
                                           [v for _, _, v, _ in queued])
        return {jid: self._render_verdict(
                    jid, sims[i], early,
                    None if probs is None else probs[i])
                for i, (jid, _, _, early) in enumerate(queued)}

    def drain_finishes(self) -> Dict[str, TuneDecision]:
        """Render every deferred verdict (one batched launch), plus any
        decisions an automatic drain already rendered but has not yet
        delivered."""
        out = self._finished
        self._finished = {}
        out.update(self._drain_queue())
        return out

    @property
    def pending_finishes(self) -> int:
        """Verdicts owed to the caller: queued by :meth:`finish_later`
        and not yet rendered, PLUS auto-drained decisions not yet
        delivered."""
        return len(self._finish_queue) + len(self._finished)


class MultiTenantTuningService:
    """Per-tenant reference banks behind one front: not ported yet."""

    def __init__(self, banks, **engine_kwargs) -> None:
        raise _not_ported("MultiTenantTuningService", 6)
