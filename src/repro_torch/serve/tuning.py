"""Streaming self-tuning service: match in-flight jobs WHILE they execute.

The paper's end goal is acting on a job *before* it finishes: compare the
utilization pattern observed so far against the reference database, and
as soon as the most probable execution pattern is clear, transfer that
workload's tuned configuration.  This service runs that matching phase
online on one device or a mesh of them, in exact point mode or in
probabilistic mode.

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
  mode), which returns a ``[S, K]`` open-end warp-correlation array (or
  of the distance-only kernel K3, which returns none).
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

Distance-only mode and the overload ladder
------------------------------------------
``score_in_flight=False`` runs the distance-only tick (kernel K3): the
DP rows advance, no moment slab is held and no early decision is made;
:meth:`finish` still renders the offline verdict.  ``overload=`` arms the
degradation ladder (``serve.overload``): the rung decided by earlier
ticks' measured latencies caps the tick mode for the whole tick, in the
expense order ``prob < approx_prob < scored < distance`` (a cap only
ever makes the tick cheaper).  A probabilistic service capped at
``approx_prob`` runs K4 with four channels over ``moms[:4]`` of its slab,
one capped at ``scored`` runs K1 over ``moms[:3]``, and rung 3 runs K3 on
the rows alone; the untouched channels go stale and are never read,
because a job ticked below its base mode is marked ``degraded_level`` 1
(2 at ``distance``) and makes no more early decisions.  Every tick
flavour updates the rows identically, so finals are bitwise unchanged.
``admission=`` sheds submits by QoS class under pressure.

Resilient dispatch
------------------
``retry_policy=`` and ``breaker=`` (a ``runtime.retry.CircuitBreaker``)
arm a fallback for the tick and verdict dispatches: after retries on an
injected ``runtime.chaos.InjectedDispatchError``, or while the breaker
is open, the same dispatch runs once more without consulting the chaos
plan (the kernel on CUDA tensors, its plain version on CPU tensors, as
everywhere).  Each such dispatch is counted in
``degraded_dispatch_count``.  A real failed launch
(``kernels.common.KernelLaunchError``) is retried like an injected
fault but has no second path on the card: once it outlasts the retries,
or fails a half-open probe, it raises ``runtime.retry.DispatchFailure``.
Without ``retry_policy`` or ``breaker`` there is no fallback: a
transient error that outlasts the chaos plan's burst raises
``DispatchFailure``.  ``chaos=``
(a ``runtime.chaos.FaultPlan``) injects dispatch failures, corrupted
samples, clock skew and slow-dispatch latency at the service's hook
points.

Streaming wavelet prefilter
---------------------------
``prefilter_top=P`` prunes the bank at large K.  Each job keeps a
``core.wavelet.StreamingHaar`` of its (filtered) prefix; after each tick
its live-reference set (``InFlightJob.allowed``, over the full bank)
shrinks to the union of two top-P (+ ``prefilter_margin``) rules: the
Haar cosine against every reference's prefix of the same length, and
the job's own in-flight DTW scores, which veto the eviction of anything
still plausibly winning (and keep the best reference of each of the top
two workloads).  Sets only shrink.  At the top of the next data tick the
union of the active jobs' sets becomes the packed K axis: the bank, the
DP rows and the moment slab are gathered on the device (``index_select``
on their K axis, padded to a power of two of at least 8 with length-1,
zero-series columns whose state starts fresh) whenever the union has
outgrown the pack or shrunk past the next bucket.  ``repack_count``
counts these re-packs; they never add a dispatch.  Scores leave the tick
sliced to the live columns, scattered back to full-bank columns (-inf
where unpacked), and masked per job to its own set (-inf scores, 0.0
probabilities).  Every DP cell is per (job, reference), so a pruned
run's scores on a job's allowed columns are bitwise the unpruned run's.
The overload ladder's ``deep_prune`` rung divides P by its
``prefilter_divisor``.

Crash safety (``serve.recovery``) snapshots this service and replays its
write-ahead log; ``_admission_suppressed`` keeps a replayed submit from
being shed again.

Bank sharding
-------------
``mesh=`` (a 1-D :class:`repro_torch.sharding.BankMesh`) splits the K
axis over the mesh's devices, single-controller as the reference is: one
service object drives every shard.  Each shard keeps its slice of the
packed bank, lengths, DP rows and moment slab as contiguous tensors on
its own device, beside its own copies of the replicated per-slot folds
(``ns``, ``sx``, ``sxx``, ``vstats``).  The full pack pads K to a
multiple of the device count, a pruned pack to :meth:`_k_bucket`.  A
tick launches the mode's kernel once a shard on that shard's K slice,
inside ONE dispatch (one ``dispatch_count``, one chaos consult, one
retry envelope); the ``[S, kp / n]`` scores are concatenated along K on
the primary device (the mesh's first) and leave in one host transfer.
Every DP cell and score is per (job, reference), so a sharded service's
scores, rows and decisions are bitwise the unsharded one's.  The
verdicts stay unsharded on the primary device.  :meth:`rescale` re-homes
the state onto another mesh (or ``None``) mid-flight by the same gather
a prefilter re-pack uses.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..core import dtw as _dtw
from ..core import wavelet as _wavelet
from ..core.database import ReferenceDB, SeriesBank
from ..core.similarity import MATCH_THRESHOLD
from ..core.tuner import TuneDecision, _RowBuffer
from ..kernels.common import KernelLaunchError, resolve_device
from ..runtime.chaos import FaultPlan, InjectedDispatchError
from ..runtime.retry import (CircuitBreaker, DispatchFailure, RetryPolicy,
                             call_with_retry)
from ..sharding.mesh import BankMesh, canonical_device, mesh_layout
from .ingest import IngestFront, PoisonedSampleError, TraceLog
from .overload import (RUNGS, AdmissionController, AdmissionPolicy,
                       AdmissionShedError, OverloadConfig,
                       OverloadController)
from .scheduler import SlotScheduler

#: Errors a resilient dispatch retries: injected chaos faults and failed
#: kernel launches (the reference's injected faults and device runtime
#: errors).
_TRANSIENT = (InjectedDispatchError, KernelLaunchError)

#: Tick modes in expense order: a ladder cap only ever moves a tick
#: right, never left.
_MODE_ORDER = {"prob": 0, "approx_prob": 1, "scored": 2, "distance": 3}

#: Each tick mode's dispatch (its kernel for CUDA tensors).
_TICK_FNS = {
    "prob": _dtw.bank_extend_tick_scored_var_dispatch,
    "approx_prob": _dtw.bank_extend_tick_scored_var_approx_dispatch,
    "scored": _dtw.bank_extend_tick_scored_dispatch,
    "distance": _dtw.bank_extend_tick_dispatch,
}

__all__ = ["InFlightJob", "TuningService", "MultiTenantTuningService"]


@dataclasses.dataclass
class _Shard:
    """One K shard's tick state, every tensor contiguous on ``device``:
    its slice of the packed bank ([M, kp / n] ``bank_t``, [kp / n]
    ``lengths``), of the DP rows ([S, M, kp / n]) and of the moment slab
    ([NCH, S, M, kp / n], None in distance-only mode), and its own copy
    of the replicated per-slot folds (``ns``, ``sx``, ``sxx`` [S];
    ``vstats`` [S, 3] in probabilistic mode)."""
    device: torch.device
    bank_t: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    moms: Optional[torch.Tensor] = None
    ns: Optional[torch.Tensor] = None
    sx: Optional[torch.Tensor] = None
    sxx: Optional[torch.Tensor] = None
    vstats: Optional[torch.Tensor] = None


def _on(device: torch.device):
    """The context a shard's launch runs in: its card made current (a
    kernel launches on the current card), nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


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
    #: streaming-Haar prefix coefficients of the (filtered) query: the
    #: wavelet prefilter's per-job transform state (None without it).
    haar: Optional[_wavelet.StreamingHaar] = None
    #: bool [K] over the FULL bank: references still live for this job.
    #: None means all (prefilter off, or not engaged yet).  Monotone: a
    #: reference once dropped never comes back for this job, so its DP
    #: column may leave the packed tick without going stale for it.
    allowed: Optional[np.ndarray] = None
    #: QoS class (bronze/silver/gold) the job was admitted under.
    qos: str = "silver"
    #: staleness marker set by degraded (ladder) ticks — monotone per
    #: job, because a skipped side-channel contribution can never be
    #: recovered in flight.  0 = all channels exact; 1 = variance
    #: channels stale (early decisions suppressed); 2 = all moment
    #: channels stale (``last_sims``/``last_probs`` frozen, no early
    #: decisions ever — the final verdict recomputes offline from the
    #: full query and is bitwise unchanged).
    degraded_level: int = 0

    @property
    def fraction_seen(self) -> float:
        return self.n / max(self.expected_len, 1)


class TuningService:
    """Multiplexed online matcher over a fixed reference bank.

    ``refs`` is a :class:`ReferenceDB` (bank + config transfer) or a bare
    :class:`SeriesBank` (matching only).  ``device`` is where the tick
    state lives and the kernels run: CUDA unless the caller passes
    another (``device="cpu"`` runs the kernels' plain versions).
    ``mesh=`` (a 1-D :class:`repro_torch.sharding.BankMesh`) shards the
    bank axis over the mesh's devices instead (see "Bank sharding" in
    the module docstring); ``device`` then defaults to the mesh's first
    device, and naming another raises.
    ``min_probability=`` enables the probabilistic decision rule and
    ``prob_mode`` ("exact" or "approx", the latter needing
    ``min_probability``) its in-flight tail; see the module docstring.
    ``score_in_flight=False`` is the distance-only mode (no moment slab,
    no early decisions; ``collect_rows`` is its older alias).
    ``prefilter_top=P`` enables the streaming wavelet prefilter (see the
    module docstring); it needs ``score_in_flight=True``, whose in-flight
    scores veto the prune.

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
    * ``overload`` (an ``OverloadConfig``, ``OverloadController`` or its
      dict) arms the degradation ladder; ``admission`` (an
      ``AdmissionPolicy``, ``AdmissionController`` or its dict) the QoS
      admission gate of :meth:`submit`.
    * ``retry_policy``, ``breaker`` and ``chaos``: see "Resilient
      dispatch" in the module docstring.
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
                 retry_policy: Optional[RetryPolicy] = None,
                 chaos: Optional[FaultPlan] = None,
                 overload: Union[OverloadConfig, OverloadController,
                                 Dict, None] = None,
                 admission: Union[AdmissionPolicy, AdmissionController,
                                  Dict, None] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        if score_in_flight is None:
            score_in_flight = True if collect_rows is None else collect_rows
        if min_probability is not None:
            if not 0.0 < min_probability <= 1.0:
                raise ValueError("min_probability must be in (0, 1]")
            if not score_in_flight:
                raise ValueError("min_probability needs "
                                 "score_in_flight=True (the probability "
                                 "rides the fused scoring tick)")
        if prob_mode not in ("exact", "approx"):
            raise ValueError("prob_mode must be 'exact' or 'approx', got "
                             f"{prob_mode!r}")
        if prob_mode == "approx" and min_probability is None:
            raise ValueError("prob_mode='approx' needs min_probability= "
                             "(the approximate tail serves the in-flight "
                             "probability gate)")
        ndev, axis, primary = mesh_layout(mesh)
        if prefilter_top is not None and prefilter_top < 1:
            raise ValueError("prefilter_top must be >= 1 (or None)")
        if prefilter_top is not None and not score_in_flight:
            # without the tick's scores there is no DTW veto: the
            # warp-blind wavelet ranking alone evicts warp-matching
            # references (the paper's exim-vs-wordcount case), and sticky
            # pruning makes that irrecoverable in flight.
            raise ValueError("prefilter_top needs score_in_flight=True "
                             "(the prune rule's soundness veto runs on "
                             "the in-flight DTW scores)")
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
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if device is not None and canonical_device(device) != primary:
                raise ValueError(f"device={device!r} is not the mesh's "
                                 f"first device {primary}")
            self.device = primary
        self.mesh: Optional[BankMesh] = mesh
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
        self.score_in_flight = score_in_flight
        self.prefilter_top = prefilter_top
        self.prefilter_margin = prefilter_margin
        self.prefilter_min_fraction = prefilter_min_fraction
        self.prefilter_coeffs = prefilter_coeffs
        self.finish_batch = finish_batch
        self.retry_policy = retry_policy
        self.chaos = chaos
        self.breaker = breaker
        # the overload control plane: the degradation-ladder controller
        # and the admission gate (see serve.overload's runbook).  Dict
        # forms rebuild them from a JSON config; a live controller keeps
        # its walked state.
        if isinstance(overload, dict):
            overload = OverloadConfig(**overload)
        if isinstance(overload, OverloadConfig):
            overload = OverloadController(overload)
        self._overload: Optional[OverloadController] = overload
        if isinstance(admission, dict):
            admission = AdmissionPolicy(**admission)
        if isinstance(admission, AdmissionPolicy):
            admission = AdmissionController(admission)
        self._admission: Optional[AdmissionController] = admission
        # a WAL replay (serve.recovery) must never shed a journaled
        # submit: the live run already admitted it.
        self._admission_suppressed = False
        # the serializable constructor config that serve.recovery
        # persists in a snapshot, with the reference's keys, so that a
        # restoring process rebuilds an identical service (the device,
        # trace log, retry policy, chaos plan and breaker are
        # process-local and re-supplied at restore).
        self._config: Dict[str, object] = dict(
            band=band, threshold=threshold,
            min_probability=min_probability, prob_mode=prob_mode,
            margin=margin,
            stable_ticks=stable_ticks, min_fraction=min_fraction,
            slots=slots, denoise=denoise, score_in_flight=score_in_flight,
            prefilter_top=prefilter_top, prefilter_margin=prefilter_margin,
            prefilter_min_fraction=prefilter_min_fraction,
            prefilter_coeffs=prefilter_coeffs, finish_batch=finish_batch,
            elastic_slots=elastic_slots, queue_limit=queue_limit,
            queue_policy=queue_policy,
            heartbeat_timeout=heartbeat_timeout,
            overload=(dataclasses.asdict(self._overload.config)
                      if self._overload is not None else None),
            admission=(dataclasses.asdict(self._admission.policy)
                       if self._admission is not None else None))

        k, m = self.bank.series.shape
        self._k = k
        self._m = m
        # the devices the bank axis spans, and the mesh axis it is named
        # by (None unsharded)
        self._ndev = ndev
        self._axis = axis
        # the true lengths, where the prefilter cuts reference prefixes
        # (a pack gathers its bank columns from the device upload below)
        self._full_lengths = self.bank.lengths.astype(np.int32)
        # admission cost proxy: expected job length over the bank's mean
        # reference length (the cumulative-CPU estimate stand-in).
        self._mean_ref_len = float(np.mean(self._full_lengths))
        self._wcoeff_cache: Dict[Tuple[int, int], np.ndarray] = {}
        # one device upload of the full bank serves the verdicts, and the
        # tick while its pack is the whole bank; a pruned pack gathers
        # its [M, kp] columns from it on the device.
        self._plan = self.bank.score_plan(self.device)
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
        self._shards = [_Shard(d) for d in self._shard_devices()]
        # per-slot query folds, and in probabilistic mode the (sv, svx,
        # svxx) variance folds: one copy a shard
        self._replicate(
            torch.zeros((s,), dtype=torch.int32, device=dev),
            torch.zeros((s,), dtype=torch.float32, device=dev),
            torch.zeros((s,), dtype=torch.float32, device=dev),
            torch.zeros((s, 3), dtype=torch.float32, device=dev)
            if min_probability is not None else None)
        self._qlens = np.zeros((s,), np.int32)
        # the tick's K axis: the bank columns packed on the device (all
        # of them until the prefilter prunes), and their [S, M, kp] DP
        # rows and [NCH, S, M, kp] moment slab.
        self._packed_idx = np.arange(k)
        self._pack_device_state(self._packed_idx, rows=None, moms=None)

        #: tick dispatches issued by :meth:`tick` — one per tick with
        #: data, however many jobs are live.
        self.dispatch_count = 0
        #: prefilter re-packs: the K-axis gathers that shrink or re-grow
        #: the packed bank and state when the survivor set changes.  A
        #: re-pack is state motion, never a dispatch.
        self.repack_count = 0
        #: S-axis capacity changes (elastic grow / compact-shrink), never
        #: a dispatch.
        self.slot_repack_count = 0
        #: mesh re-homes by :meth:`rescale`, never a dispatch.
        self.rescale_count = 0
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
        #: failed dispatch attempts absorbed by the retry wrapper
        #: (failed kernel launches and injected chaos faults).
        self.retry_count = 0
        #: dispatches served by the fallback, the same dispatch without
        #: the chaos consult (retries exhausted, or the breaker open):
        #: the unfaulted results, degraded latency.
        self.degraded_dispatch_count = 0
        #: True when the most recent tick or verdict dispatch came from
        #: the fallback.
        self.last_tick_degraded = False
        #: submits refused by admission control, total and per QoS class.
        self.shed_count = 0
        self.shed_by_class: Dict[str, int] = {}
        #: top-level ticks observed while the ladder was above rung 0.
        self.overload_ticks = 0
        #: high-water ladder rung reached (see serve.overload.RUNGS).
        self.worst_rung = 0
        #: latency of the most recent top-level tick: host wall clock
        #: around the tick (plus any chaos-injected slowdown), or the
        #: ``tick(latency=)`` override; what the ladder observes.
        self.last_tick_latency = 0.0
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

    # -- packed device state (full bank or pruned survivor subset) -----------
    def _shard_devices(self) -> Tuple[torch.device, ...]:
        """Each K shard's device: the mesh's, or the one device."""
        return (self.device,) if self.mesh is None \
            else self.mesh.device_list

    def _split(self, t: Optional[torch.Tensor], dim: int):
        """``t`` (on the primary device) as one part a shard along
        ``dim``: itself when unsharded, else a contiguous copy of each
        part on its shard's device."""
        if t is None:
            return [None] * self._ndev
        return [t] if self.mesh is None else self.mesh.split(t, dim)

    def _cat(self, parts: List[Optional[torch.Tensor]],
             dim: int) -> Optional[torch.Tensor]:
        """Per-shard parts concatenated along ``dim`` on the primary
        device (the one shard's own tensor when unsharded)."""
        if parts[0] is None or len(parts) == 1:
            return parts[0]
        return self.mesh.gather(parts, dim)

    def _gather(self, name: str, dim: int) -> Optional[torch.Tensor]:
        """The shards' ``name`` tensors, whole (see :meth:`_cat`)."""
        return self._cat([getattr(sh, name) for sh in self._shards], dim)

    def _replicate(self, ns, sx, sxx, vstats) -> None:
        """Give every shard its own copy of the per-slot folds."""
        for name, t in (("ns", ns), ("sx", sx), ("sxx", sxx),
                        ("vstats", vstats)):
            parts = [t] * self._ndev if t is None or self.mesh is None \
                else self.mesh.replicate(t)
            for sh, part in zip(self._shards, parts):
                setattr(sh, name, part)

    # The packed state, whole: K-indexed tensors gathered onto the primary
    # device (each shard's own when unsharded), the replicated folds as
    # shard 0 holds them (every shard computes them identically).
    _bank_t = property(lambda self: self._gather("bank_t", 1))
    _lengths = property(lambda self: self._gather("lengths", 0))
    _rows = property(lambda self: self._gather("rows", 2))
    _moms = property(lambda self: self._gather("moms", 3))
    _ns = property(lambda self: self._shards[0].ns)
    _sx = property(lambda self: self._shards[0].sx)
    _sxx = property(lambda self: self._shards[0].sxx)
    _vstats = property(lambda self: self._shards[0].vstats)

    def _k_full(self) -> int:
        """Padded width of the full pack: K up to a multiple of the
        device count."""
        return self._k + ((-self._k) % self._ndev)

    def _k_bucket(self, k: int) -> int:
        """Padded width of a pruned pack: a power of two (so re-packs
        cycle through at most log2(K) tick shapes), at least 8, and a
        multiple of the device count."""
        kp = max(8, 1 << (max(k, 1) - 1).bit_length())
        return kp + ((-kp) % self._ndev)

    def _pack_device_state(self, idx: np.ndarray, rows, moms) -> None:
        """(Re)build the tick's device tensors over bank columns ``idx``
        (full-bank order kept) and split them over the shards.
        ``rows``/``moms`` ([S, M, K_old] / [NCH, S, M, K_old] on the
        primary device, aligned with the PREVIOUS ``_packed_idx``) carry
        the surviving columns' DP state, gathered on the device by
        ``index_select`` on the K axis, so a re-pack never moves the
        slabs through the host.  Columns without prior state start fresh
        (+inf row, zero moments): exact for jobs that have consumed
        nothing, don't-care for jobs whose prefilter already dropped the
        reference (their scores for it are masked after every tick).
        ``rows=None`` allocates fresh state on each shard.

        The full pack is the bank itself (the verdicts' upload), padded
        to :meth:`_k_full`; a pruned pack pads to :meth:`_k_bucket`.
        Padding columns have length 1 and a zero series."""
        k_new, m, dev = len(idx), self._m, self.device
        full = k_new == self._k
        kp = self._k_full() if full else self._k_bucket(k_new)
        if full and kp == self._k:
            bank_t, lengths = self._plan.bank_t, self._plan.lengths
        else:
            cols = np.zeros((kp,), np.int64)
            cols[:k_new] = idx
            gather = torch.as_tensor(cols, device=dev)
            pad = torch.as_tensor(np.arange(kp) >= k_new, device=dev)
            bank_t = torch.where(
                pad[None, :], 0.0, self._plan.bank_t.index_select(1, gather))
            lengths = torch.where(
                pad, 1, self._plan.lengths.index_select(0, gather))
        # moment channels: 3 point, 6 exact-probability, 4 approx, and
        # none in distance-only mode
        if self.min_probability is None:
            nch = 3
        else:
            nch = 4 if self.prob_mode == "approx" else 6
        w = kp // self._ndev
        for sh, b, ln in zip(self._shards, self._split(bank_t, 1),
                             self._split(lengths, 0)):
            sh.bank_t, sh.lengths = b, ln
            if rows is None:
                sh.rows = torch.full((self._s_cap, m, w), _dtw._INF,
                                     dtype=torch.float32, device=sh.device)
                sh.moms = torch.zeros(
                    (nch, self._s_cap, m, w), dtype=torch.float32,
                    device=sh.device) if self.score_in_flight else None
        if rows is not None:
            pos = np.full((self._k,), -1, np.int64)
            pos[self._packed_idx] = np.arange(len(self._packed_idx))
            src = np.concatenate([pos[idx], np.full((kp - k_new,), -1)])
            gather = torch.as_tensor(np.maximum(src, 0), device=dev)
            fresh = torch.as_tensor(src < 0, device=dev)
            rows_s = self._split(torch.where(
                fresh[None, None, :], _dtw._INF,
                rows.index_select(2, gather)), 2)
            moms_s = self._split(None if moms is None else torch.where(
                fresh[None, None, None, :], 0.0,
                moms.index_select(3, gather)), 3)
            for sh, r, mo in zip(self._shards, rows_s, moms_s):
                sh.rows = r
                if moms is not None:
                    sh.moms = mo
        self._packed_idx = np.asarray(idx)
        self._kp = kp

    # -- slot-indexed device state ---------------------------------------------
    def _on_shards(self, host: np.ndarray):
        """``host`` uploaded once to each distinct shard device ->
        {device: tensor}."""
        return {d: torch.as_tensor(host, device=d)
                for d in dict.fromkeys(sh.device for sh in self._shards)}

    def _repack_slots(self, src: np.ndarray) -> None:
        """Apply an S-axis gather plan from the scheduler (new slot ->
        old slot, -1 = fresh) to every slot-indexed tensor of every
        shard, on its device.  Per-job DP state is row-independent, so a
        slot move is bit-exact; fresh rows get the +inf/zero init a reset
        writes."""
        gathers = self._on_shards(np.maximum(src, 0).astype(np.int64))
        freshes = self._on_shards(src < 0)
        for sh in self._shards:
            gather, fresh = gathers[sh.device], freshes[sh.device]
            sh.rows = torch.where(fresh[:, None, None], _dtw._INF,
                                  sh.rows.index_select(0, gather))
            if sh.moms is not None:
                sh.moms = torch.where(fresh[None, :, None, None], 0.0,
                                      sh.moms.index_select(1, gather))
            sh.ns = torch.where(fresh, 0, sh.ns.index_select(0, gather))
            sh.sx = torch.where(fresh, 0.0, sh.sx.index_select(0, gather))
            sh.sxx = torch.where(fresh, 0.0,
                                 sh.sxx.index_select(0, gather))
            if sh.vstats is not None:
                sh.vstats = torch.where(fresh[:, None], 0.0,
                                        sh.vstats.index_select(0, gather))
        self._qlens = np.where(src >= 0, self._qlens[np.maximum(src, 0)],
                               0).astype(np.int32)
        self._s_cap = len(src)
        self.slot_repack_count += 1

    def _apply_resets(self) -> None:
        """Fresh-initialize every slot submitted since the last data tick
        (+inf DP row, zero moments/query stats) in ONE masked op per
        tensor of each shard, before any gather or launch."""
        if not self._dirty:
            return
        mask = np.zeros((self._s_cap,), bool)
        mask[self._dirty] = True
        masks = self._on_shards(mask)
        for sh in self._shards:
            md = masks[sh.device]
            sh.rows = torch.where(md[:, None, None], _dtw._INF, sh.rows)
            if sh.moms is not None:
                sh.moms = torch.where(md[None, :, None, None], 0.0,
                                      sh.moms)
            sh.ns = torch.where(md, 0, sh.ns)
            sh.sx = torch.where(md, 0.0, sh.sx)
            sh.sxx = torch.where(md, 0.0, sh.sxx)
            if sh.vstats is not None:
                sh.vstats = torch.where(md[:, None], 0.0, sh.vstats)
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

    # -- streaming wavelet prefilter -----------------------------------------
    def _ref_prefix_coeffs(self, size: int, n: int) -> np.ndarray:
        """Compressed Haar coefficient bank of every reference's first
        ``n`` samples, edge-extended to target length ``size``: the
        counterpart of a job's :class:`StreamingHaar` prefix
        coefficients (``n`` job samples correspond to about ``n``
        reference samples; comparing the prefix against FULL references
        would correlate the job's constant extension tail against unseen
        reference structure).  Cached per (size, n): lockstep jobs share
        the transform."""
        key = (size, n)
        cb = self._wcoeff_cache.get(key)
        if cb is None:
            series = self.bank.series.astype(np.float64)
            w = series.shape[1]
            cut = np.minimum(self._full_lengths, n)             # [K]
            edge = np.take_along_axis(series, (cut - 1)[:, None], axis=1)
            bp = np.where(np.arange(w)[None, :] < cut[:, None], series,
                          edge)
            bp = np.pad(bp, ((0, 0), (0, size - w)), mode="edge") \
                if size >= w else bp[:, :size]
            cb = _wavelet.compress_bank(_wavelet.haar_dwt_bank(bp),
                                        self.prefilter_coeffs)
            if len(self._wcoeff_cache) >= 16:
                self._wcoeff_cache.pop(next(iter(self._wcoeff_cache)))
            self._wcoeff_cache[key] = cb
        return cb

    @staticmethod
    def _top_p_with_margin(sims: np.ndarray, allowed: np.ndarray, p: int,
                           margin: float) -> np.ndarray:
        """Bool keep-mask: references ranking in the top ``p`` of ``sims``
        among ``allowed``, widened by ``margin`` (anything within margin
        of the p-th best survives too, so near-ties are not evicted on
        ranking noise)."""
        ranked = np.where(allowed, sims, -np.inf)
        kth = np.partition(ranked, -p)[-p]
        return ranked >= kth - margin

    def _update_prefilter(self, pending) -> None:
        """Shrink each touched job's live-reference set.  Two top-P (+
        margin) rules vote and the UNION survives:

        * the streaming-Haar ranking (coarse, warp-blind, cheap) proposes
          the bulk prune;
        * the job's own in-flight open-end DTW scores (from the tick just
          run) veto the eviction of anything still plausibly winning: the
          Haar cosine compares prefixes rigidly, so a reference that
          matches the job only under warping (the paper's
          exim-vs-wordcount case) ranks poorly there while its warp
          correlation is already high.

        Sticky per job: sets only ever shrink, so a dropped reference's
        DP column never has to re-enter for a job that already has
        samples (re-entry would be stale)."""
        p = self.prefilter_top
        if self._overload is not None:
            # deep_prune rung: survivor sets shrink harder (sticky, so
            # the deeper cut persists after de-escalation).
            p = max(1, p // self._overload.prefilter_divisor)
        for job, *_ in pending:
            if job.haar is None or job.n < 2:
                continue
            if job.degraded_level >= 2:
                # distance-only ticks froze this job's DTW veto scores;
                # pruning on a stale veto could evict the eventual
                # winner, so the live set stops shrinking.
                continue
            if job.fraction_seen < self.prefilter_min_fraction:
                continue
            if self.score_in_flight and job.last_sims is None:
                continue          # no DTW veto yet: too early to prune
            allowed = job.allowed if job.allowed is not None \
                else np.ones((self._k,), bool)
            if int(allowed.sum()) <= p:
                continue                              # converged
            keep = self._top_p_with_margin(
                _wavelet.coeff_similarity_bank(
                    job.haar.compressed(self.prefilter_coeffs),
                    self._ref_prefix_coeffs(job.haar.size, job.n)),
                allowed, p, self.prefilter_margin)
            if job.last_sims is not None:
                dsims = np.where(allowed,
                                 np.nan_to_num(job.last_sims, neginf=-1.0),
                                 -np.inf)
                keep |= self._top_p_with_margin(dsims, allowed, p,
                                                self.prefilter_margin)
                # the early-decision margin compares the leader WORKLOAD
                # against the runner-up WORKLOAD: protect the best
                # reference of each of the current top-2 workloads, or
                # evicting the whole runner-up family would floor its
                # score to -1.0 and make the margin gate vacuously true.
                seen = set()
                for r in np.argsort(dsims)[::-1]:
                    if not np.isfinite(dsims[r]) or len(seen) == 2:
                        break
                    if self._labels[r] not in seen:
                        seen.add(self._labels[r])
                        keep[r] = True
            job.allowed = np.logical_and(allowed, keep)

    def _survivors(self) -> np.ndarray:
        """Union of the active jobs' live sets -> full-bank index array.
        A job whose prefilter has not engaged needs every reference."""
        mask = np.zeros((self._k,), bool)
        for job in self._jobs.values():
            if job.allowed is None:
                return np.arange(self._k)
            mask |= job.allowed
        return np.flatnonzero(mask)

    def _maybe_repack(self) -> None:
        """Re-pack the device state when the survivor union has outgrown
        the packed columns (a fresh job needs everything again) or has
        shrunk past the next power-of-two bucket.  A pack that merely
        *contains* the survivors is left alone: the extra columns cost at
        most one bucket's compute, while every re-pack is a gather of
        the whole state."""
        if self.prefilter_top is None:
            return
        idx = self._survivors()
        grown = not np.isin(idx, self._packed_idx,
                            assume_unique=True).all()
        full = len(idx) == self._k
        kp_target = self._k_full() if full else self._k_bucket(len(idx))
        if not grown and kp_target >= self._kp:
            return
        self._pack_device_state(idx, self._rows, self._moms)
        self.repack_count += 1

    # -- job lifecycle -------------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self._jobs)

    @property
    def slot_capacity(self) -> int:
        """Current S bucket (== ``slots`` when ``elastic_slots=False``)."""
        return self._s_cap

    def rescale(self, mesh: Optional[BankMesh]) -> None:
        """Re-home the device state onto another 1-D mesh (or, with
        ``None``, onto the primary device alone) mid-flight: the hook an
        ``runtime.fault.ElasticController`` rescale decision drives when
        hosts die or join.  The shards are gathered onto the primary
        device, the pack re-pads to the new device-count multiple by the
        same gather a prefilter re-pack uses, and the result is split
        over the new mesh, so scores and decisions are unchanged.  With a
        mesh, its first device becomes the primary device."""
        ndev, axis, primary = mesh_layout(mesh)
        rows, moms = self._rows, self._moms
        folds = (self._ns, self._sx, self._sxx, self._vstats)
        if primary is not None and primary != self.device:
            # the verdicts' bank upload follows the primary device
            self.device = primary
            self._plan = self.bank.score_plan(primary)
            rows = rows.to(primary)
            moms = None if moms is None else moms.to(primary)
            folds = tuple(None if t is None else t.to(primary)
                          for t in folds)
        self.mesh, self._ndev, self._axis = mesh, ndev, axis
        self._shards = [_Shard(d) for d in self._shard_devices()]
        self._replicate(*folds)
        self._pack_device_state(self._packed_idx, rows, moms)
        self.rescale_count += 1

    # -- overload surface (serve.overload runbook) ---------------------------
    @property
    def rung(self) -> int:
        """Current degradation-ladder rung (0 without a controller)."""
        return 0 if self._overload is None else self._overload.rung

    @property
    def rung_history(self) -> List[Tuple[int, int, int]]:
        """Ladder transitions ``(observation_index, from, to)`` — empty
        without a controller."""
        return [] if self._overload is None \
            else list(self._overload.rung_history)

    @property
    def degraded(self) -> bool:
        """True while the service is NOT serving its configured quality:
        the circuit breaker has demoted the kernel path, or the overload
        ladder sits above rung 0."""
        return (self.breaker is not None and self.breaker.engaged) \
            or self.rung > 0

    def overload_pressure(self) -> float:
        """Scalar [0, 1] rescale-ahead signal for
        ``runtime.fault.ElasticController.decide_ahead``: the worse of
        the ladder's latency pressure and the ingest queue fill."""
        p = self._front.queue_fill()
        if self._overload is not None:
            p = max(p, self._overload.pressure())
        return p

    def submit(self, job_id: str, expected_len: int,
               tick_hz: Optional[float] = None,
               qos: str = "silver") -> InFlightJob:
        """Register an in-flight job (``expected_len`` = predicted total
        sample count; it anchors the Sakoe-Chiba band and the
        fraction-seen gate of the early-decision rule).  ``tick_hz``
        assigns the job to a tick-rate cohort: ``tick(now=...)`` drains
        it only on its own period (None = every tick).

        ``qos`` (bronze/silver/gold) is the job's admission class: with
        ``admission=`` armed, a submit under measured overload raises
        :class:`serve.overload.AdmissionShedError` — bronze sheds first,
        gold last.  A shed submit leaves no state behind."""
        if job_id in self._jobs:
            raise ValueError(f"job {job_id!r} already in flight")
        if expected_len < 1:
            raise ValueError("expected_len must be >= 1")
        if self._admission is not None and not self._admission_suppressed:
            rung_frac = (self._overload.rung / max(1, len(RUNGS) - 1)
                         if self._overload is not None else 0.0)
            cost_fill = min(1.0, expected_len / (
                self._admission.policy.cost_scale * self._mean_ref_len))
            try:
                self._admission.admit(
                    job_id, qos=qos, cost_fill=cost_fill,
                    queue_fill=self._front.queue_fill(),
                    rung_frac=rung_frac)
            except AdmissionShedError:
                self.shed_count += 1
                self.shed_by_class[qos] = \
                    self.shed_by_class.get(qos, 0) + 1
                raise
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
                          tick_hz=tick_hz, qos=qos,
                          haar=_wavelet.StreamingHaar(expected_len)
                          if self.prefilter_top is not None else None)
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
        (0.0 without ``denoise``).  A ``chaos`` plan may corrupt the
        samples and skew ``now`` first.

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
        if self.chaos is not None:
            samples = self.chaos.corrupt(samples)
            now = self.chaos.skew(now)
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
    def tick(self, now: Optional[float] = None, *,
             latency: Optional[float] = None,
             _observe: bool = True) -> Dict[str, Optional[TuneDecision]]:
        """Drain every due job's buffered samples into ONE launch of the
        streaming tick, then apply the early-decision rule to the
        returned [S, K] scores.

        ``now`` meters the tick-rate cohorts: only cohorts whose period
        has elapsed drain.  Without a clock every job is due.

        Overload plumbing (``overload=``): the rung decided by earlier
        observations holds for this whole tick (mode cap, cohort
        stretch), then the tick's latency feeds the ladder: the host
        wall clock around the tick, plus any chaos-injected slowdown, or
        ``latency=`` when given (a recorded latency replayed).
        ``_observe=False`` marks an internal drain tick (see
        :meth:`finish`), which does not advance the ladder.

        Returns {job_id: TuneDecision} for decisions *newly emitted* this
        tick (None for touched jobs where the service abstains), plus any
        decision a previous internal tick (see :meth:`finish`) emitted
        but could not deliver.
        """
        if self._overload is not None:
            self._sched.cohorts.rate_scale = self._overload.cohort_scale
            if _observe and self._overload.rung >= 1:
                self.overload_ticks += 1
        # On a card the host returns before a kernel ends.  A scored tick
        # copies its [S, K] scores to the host, which waits for the
        # kernel; a distance-only tick copies nothing back, so its
        # measured latency is host time.  No synchronisation is added
        # here that the reference lacks.
        t0 = time.perf_counter()
        out = self._tick_impl(now)
        if _observe:
            lat = time.perf_counter() - t0 if latency is None \
                else float(latency)
            if latency is None and self.chaos is not None:
                lat += self.chaos.slow_dispatch("tick")
            self.last_tick_latency = lat
            if self._overload is not None:
                self._overload.observe(lat)
                self.worst_rung = max(self.worst_rung,
                                      self._overload.rung)
        return out

    def _base_mode(self) -> str:
        """The configured (unloaded) tick mode: ``"prob"`` (exact
        6-channel probabilities), ``"approx_prob"`` (the 4-channel
        approximate tail), ``"scored"`` or ``"distance"``."""
        if self.min_probability is not None:
            return "approx_prob" if self.prob_mode == "approx" else "prob"
        return "scored" if self.score_in_flight else "distance"

    def _tick_mode(self) -> str:
        """This tick's mode: the configured mode, capped by the overload
        ladder's current rung.  A cap only ever makes the tick CHEAPER
        (the later of the two in the expense order), so a distance-only
        service is never upgraded and an approx service never moves to
        the exact tail."""
        base = self._base_mode()
        if self._overload is None:
            return base
        cap = self._overload.tick_mode_cap
        return cap if _MODE_ORDER[cap] > _MODE_ORDER[base] else base

    def _tick_impl(self, now: Optional[float]
                   ) -> Dict[str, Optional[TuneDecision]]:
        self.ticks += 1
        self.last_tick_degraded = False
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
            if job.haar is not None:
                job.haar.update(chunk)
            pending.append((job, chunk, vchunk))
        if not pending:
            return out

        # state motion first (never a dispatch): deferred fresh-slot
        # resets (so no gather moves stale rows), then the K-axis re-pack
        # when the prefilter's survivor union crossed a bucket boundary,
        # then the S-axis shrink when the active set fits a smaller
        # bucket.
        self._apply_resets()
        self._maybe_repack()
        self._maybe_shrink_slots()
        k_live = len(self._packed_idx)

        c = _dtw._chunk_bucket(max(ch.shape[0] for _, ch, _ in pending))
        chunks = np.zeros((self._s_cap, c), np.float32)
        nvalid = np.zeros((self._s_cap,), np.int32)
        vchunks = np.zeros((self._s_cap, c), np.float32) if prob else None
        for job, ch, vch in pending:
            chunks[job.slot, : ch.shape[0]] = ch
            nvalid[job.slot] = ch.shape[0]
            if prob:
                vchunks[job.slot, : ch.shape[0]] = vch
        # This tick's mode: the configured one, or a cheaper one under
        # the overload ladder.  Every mode updates the DP rows (and ns)
        # identically, so a capped tick leaves the rows bitwise what the
        # full tick computes; the channels it skips go stale, and the
        # jobs it touches are marked so that nothing reads them.
        mode = self._tick_mode()
        base = self._base_mode()
        # the mode's channels: all of the slab in the base mode, else its
        # leading 3 (scored) or 4 (approx) channels.  A leading slice of
        # the contiguous [NCH, S, M, K] slab is contiguous.
        nch = {"prob": 6, "approx_prob": 4, "scored": 3,
               "distance": 0}[mode]
        # the chunk, its valid counts and the expected lengths (and the
        # variances) are uploaded once to each shard device
        inputs = (self._on_shards(chunks), self._on_shards(nvalid),
                  self._on_shards(self._qlens),
                  self._on_shards(vchunks) if mode in ("prob", "approx_prob")
                  else None)
        # ONE dispatch: every shard's launch on its own K slice, retried
        # as a whole; the state is assigned only after every shard has
        # returned, so a retried dispatch never sees a half-advanced one.
        results = self._dispatch_resilient(
            self._fan_out, (mode, nch, inputs), {}, "tick")
        for sh, res in zip(self._shards, results):
            if mode == "distance":
                sh.rows, sh.ns = res
                continue
            sh.rows, moms_out, sh.ns, sh.sx, sh.sxx = res[:5]
            if mode == base:
                sh.moms = moms_out
            else:
                # written back into the slab's leading channels in place:
                # a concatenation would allocate a second slab.
                sh.moms[:nch].copy_(moms_out)
            if mode != "scored":
                sh.vstats = res[6]
        sims_all = probs_all = None
        if mode != "distance":
            # the tick's device -> host transfers: the [S, kp] scores (and
            # the [S, kp] probabilities in the probabilistic modes), the
            # shards' [S, kp / n] parts concatenated along K on the
            # primary device, sliced to the live columns (a padded
            # column's score is meaningless) and scattered back to
            # full-bank columns: an unpacked reference reads -inf (never a
            # leader, never a runner-up) and carries zero match
            # probability.
            sims_all = np.full((self._s_cap, self._k), -np.inf)
            sims_all[:, self._packed_idx] = self._cat(
                [res[5] for res in results], 1)[:, :k_live].cpu().numpy() \
                .astype(np.float64)
            if mode != "scored":
                probs_all = np.zeros((self._s_cap, self._k))
                probs_all[:, self._packed_idx] = self._cat(
                    [res[7] for res in results], 1)[:, :k_live].cpu() \
                    .numpy().astype(np.float64)
        self.dispatch_count += 1

        if mode != base:
            lvl = 2 if mode == "distance" else 1
            for job, *_ in pending:
                job.degraded_level = max(job.degraded_level, lvl)

        for job, ch, _ in pending:
            job.n += ch.shape[0]
            decision = None
            # a level-2 job's moment channels are stale, so any score a
            # later scored tick emits for its slot is garbage: freeze
            # last_sims/last_probs at their last exact values.
            if sims_all is not None and job.degraded_level < 2:
                sims = sims_all[job.slot]
                if job.allowed is not None:
                    # a column another job kept alive may be pruned for
                    # THIS job: mask it out of this job's view.
                    sims = np.where(job.allowed, sims, -np.inf)
                job.last_sims = sims
                if probs_all is not None:
                    pr = probs_all[job.slot]
                    if job.allowed is not None:
                        pr = np.where(job.allowed, pr, 0.0)
                    job.last_probs = pr
                if job.early is None and job.degraded_level == 0:
                    decision = self._maybe_decide(job)
            if out.get(job.job_id) is None:
                out[job.job_id] = decision
        # prune with THIS tick's scores (n just advanced): the re-pack
        # they imply happens at the top of the next data tick.
        if self.prefilter_top is not None:
            self._update_prefilter(pending)
        return out

    def _fan_out(self, mode: str, nch: int, inputs) -> List[tuple]:
        """One tick's launches: the mode's tick function (its kernel for
        CUDA tensors) once a shard, on the shard's K slice and device,
        with that device's copies of the chunk inputs.  Returns each
        shard's results; the caller assigns them."""
        chunks, nvalid, qlens, vchunks = inputs
        tick_fn, base = _TICK_FNS[mode], self._base_mode()
        kw = dict(band=self.band)
        if mode in ("prob", "approx_prob"):
            kw["threshold"] = float(self.threshold)
        results = []
        for sh in self._shards:
            d = sh.device
            data = (sh.bank_t, sh.lengths, chunks[d])
            tail = (nvalid[d], qlens[d])
            with _on(d):
                if mode == "distance":
                    res = tick_fn(sh.rows, sh.ns, *data, *tail, **kw)
                else:
                    moms_in = sh.moms if mode == base else sh.moms[:nch]
                    head = (sh.rows, moms_in, sh.ns, sh.sx, sh.sxx)
                    res = tick_fn(*head, *data, *tail, **kw) \
                        if mode == "scored" else \
                        tick_fn(*head, sh.vstats, *data, vchunks[d], *tail,
                                **kw)
            results.append(res)
        return results

    # -- dispatch resilience -------------------------------------------------
    def _dispatch_resilient(self, fn, args, kwargs, kind: str):
        """One tick or verdict dispatch, ``fn(*args, **kwargs)``, through
        the retry wrapper and the circuit breaker.

        With neither ``retry_policy``, ``chaos`` nor ``breaker`` armed
        this is a plain call.  A chaos plan is consulted per attempt, so
        a fault burst spans retries.  The fallback exists only when the
        caller armed ``retry_policy`` or ``breaker``: it runs ``fn`` once
        more without the chaos consult, so on a card the kernel serves it
        (there is no plain version on CUDA tensors) and its result is the
        unfaulted dispatch's, bitwise.  It serves after the retries on an
        injected fault, and directly while the breaker is open; a
        half-open breaker probes once per probe slot and re-closes on
        success.  Every fallback dispatch is counted in
        ``degraded_dispatch_count``.  A real ``KernelLaunchError`` has no
        second path: once it outlasts the retries, or fails a probe, it
        raises ``DispatchFailure``, and on the open breaker's direct path
        it propagates as it is.  Injected faults move latency and
        counters, never results."""
        chaos, breaker = self.chaos, self.breaker
        if chaos is None and self.retry_policy is None and breaker is None:
            return fn(*args, **kwargs)
        errors: List[BaseException] = []

        def attempt():
            if chaos is not None:
                chaos.on_dispatch(kind)
            return fn(*args, **kwargs)

        def fallback():
            if errors and isinstance(errors[-1], KernelLaunchError):
                raise DispatchFailure(
                    f"{kind} dispatch: kernel launch failed on every "
                    "attempt") from errors[-1]
            result = fn(*args, **kwargs)
            self.degraded_dispatch_count += 1
            self.last_tick_degraded = True
            return result

        if breaker is not None:
            route = breaker.before_dispatch()
            if route == "fallback":
                return fallback()
            if route == "probe":
                try:
                    result = attempt()       # one un-retried attempt
                except _TRANSIENT as e:
                    breaker.record_failure()
                    errors.append(e)
                    return fallback()
                breaker.record_success()
                return result

        armed = self.retry_policy is not None or breaker is not None
        policy = self.retry_policy or RetryPolicy(max_retries=0,
                                                  base_delay=0.0)
        result, report = call_with_retry(
            attempt, policy=policy, transient=_TRANSIENT,
            fallback=fallback if armed else None,
            on_retry=lambda _, e: errors.append(e))
        self.retry_count += report["retries"]
        if breaker is not None:
            if report["degraded"]:
                breaker.record_failure()
            else:
                breaker.record_success()
        return result

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
        res = self._dispatch_resilient(
            _dtw.dtw_score_bank_many,
            (xs, self.bank.series, self.bank.lengths),
            dict(xlens=xl, band=self.band, sx=sx, sxx=sxx, xvars=xv,
                 threshold=float(self.threshold),
                 plan=self.bank.score_plan(self.device)), "verdict")
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
        are NOT being finished, so they surface from the next tick().
        The internal tick does not advance the overload ladder
        (``_observe=False``): only top-level ticks are observed."""
        if any(self._front.has_data(j) for j in finishing):
            emitted = self.tick(_observe=False)
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
    """Continuous-batching front over per-tenant reference banks.

    ``banks`` maps tenant name -> :class:`ReferenceDB` or
    :class:`SeriesBank`; each tenant gets an isolated
    :class:`TuningService` engine (its own bank, device state, cohorts
    and counters) built with the shared ``**engine_kwargs``.  Jobs are
    keyed to a tenant at :meth:`submit` and routed by job id afterwards
    — ids are unique across the front, so ``push``/``finish`` need no
    tenant argument.  A :meth:`tick` drains every engine (each engine
    dispatches only when one of its due jobs has data), so total device
    dispatches are bounded by data-ticks x tenants.
    """

    def __init__(self, banks: Mapping[str, Union[ReferenceDB, SeriesBank]],
                 **engine_kwargs) -> None:
        if not banks:
            raise ValueError("no tenants")
        self._engines: Dict[str, TuningService] = {
            t: TuningService(bank, **engine_kwargs)
            for t, bank in banks.items()}
        self._tenant_of: Dict[str, str] = {}

    # -- routing --------------------------------------------------------------
    def engine(self, tenant: str) -> TuningService:
        """The tenant's tick engine (for counters/diagnostics)."""
        return self._engines[tenant]

    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._engines)

    @property
    def n_active(self) -> int:
        return sum(e.n_active for e in self._engines.values())

    @property
    def dispatch_count(self) -> int:
        return sum(e.dispatch_count for e in self._engines.values())

    @property
    def offline_dispatch_count(self) -> int:
        return sum(e.offline_dispatch_count for e in self._engines.values())

    @property
    def quarantined(self) -> Dict[str, str]:
        """{job_id: poison reason} across every tenant engine."""
        out: Dict[str, str] = {}
        for e in self._engines.values():
            out.update(e.quarantined)
        return out

    def _engine_of(self, job_id: str) -> TuningService:
        return self._engines[self._tenant_of[job_id]]

    # -- lifecycle ------------------------------------------------------------
    def submit(self, job_id: str, expected_len: int, *, tenant: str,
               tick_hz: Optional[float] = None,
               qos: str = "silver") -> InFlightJob:
        if tenant not in self._engines:
            raise KeyError(f"unknown tenant {tenant!r}")
        if job_id in self._tenant_of:
            raise ValueError(f"job {job_id!r} already in flight "
                             f"(tenant {self._tenant_of[job_id]!r})")
        job = self._engines[tenant].submit(job_id, expected_len,
                                           tick_hz=tick_hz, qos=qos)
        self._tenant_of[job_id] = tenant
        return job

    def push(self, job_id: str, samples,
             variance: Optional[np.ndarray] = None,
             now: Optional[float] = None) -> None:
        self._engine_of(job_id).push(job_id, samples, variance=variance,
                                     now=now)

    def tick(self, now: Optional[float] = None
             ) -> Dict[str, Optional[TuneDecision]]:
        out: Dict[str, Optional[TuneDecision]] = {}
        for engine in self._engines.values():
            out.update(engine.tick(now=now))
        return out

    def finish(self, job_id: str) -> TuneDecision:
        return self.finish_many((job_id,))[job_id]

    def finish_many(self, job_ids) -> Dict[str, TuneDecision]:
        """Batched verdicts, grouped per tenant: one drain tick + one
        verdict launch per tenant with completing jobs."""
        ids = list(job_ids)
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate job ids in finish_many")
        missing = [j for j in ids if j not in self._tenant_of]
        if missing:
            raise KeyError(f"unknown job(s): {missing}")
        by_tenant: Dict[str, List[str]] = {}
        for jid in ids:
            by_tenant.setdefault(self._tenant_of[jid], []).append(jid)
        out: Dict[str, TuneDecision] = {}
        for tenant, group in by_tenant.items():
            out.update(self._engines[tenant].finish_many(group))
            for jid in group:
                del self._tenant_of[jid]
        return out

    def finish_later(self, job_id: str) -> None:
        self._engine_of(job_id).finish_later(job_id)
        del self._tenant_of[job_id]

    def drain_finishes(self) -> Dict[str, TuneDecision]:
        out: Dict[str, TuneDecision] = {}
        for engine in self._engines.values():
            out.update(engine.drain_finishes())
        return out

    @property
    def pending_finishes(self) -> int:
        return sum(e.pending_finishes for e in self._engines.values())

    def sweep_stalled(self, now: float) -> Dict[str, Optional[TuneDecision]]:
        out: Dict[str, Optional[TuneDecision]] = {}
        for engine in self._engines.values():
            evicted = engine.sweep_stalled(now)
            for jid in evicted:
                self._tenant_of.pop(jid, None)
            out.update(evicted)
        return out
