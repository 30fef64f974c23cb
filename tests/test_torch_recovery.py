"""Crash-safe serving in the port (``repro_torch.serve.recovery``):
snapshot/restore + WAL replay == never crashed.

The reference's recovery tests run against the port's service on the
CPU (``device="cpu"``, the kernels' plain versions): a service
snapshotted and rehydrated at any point of a command schedule, or killed
and rebuilt from snapshot + journal tail, continues the schedule with
decisions, scores and counters bit-identical to a service that ran it
uninterrupted.  Then the two packages' snapshots cross: a snapshot the
reference wrote restores in the port and replays to the reference's
decisions (and the other way round), the port's kill-and-recover runs
in child processes (unsharded, and crashing on 8 bank shards to recover
onto 4), and the recovery modules import no jax."""
import os
import signal
import subprocess
import sys
import tempfile
import textwrap
import warnings

import numpy as np
import pytest

from repro.core.database import pack_series as ref_pack
from repro.serve.recovery import restore_service as ref_restore_service
from repro.serve.recovery import snapshot_service as ref_snapshot_service
from repro.serve.tuning import TuningService as RefService
from repro_torch.core.database import pack_series
from repro_torch.runtime.chaos import truncate_file
from repro_torch.serve.ingest import PoisonedSampleError, TraceLog
from repro_torch.serve.recovery import (RecoverableTuningService,
                                        restore_service, snapshot_service)
from repro_torch.serve.tuning import TuningService

CPU = dict(device="cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: In-flight score tolerance across packages: the ticks' moments differ
#: in float32 rounding on continuous data (tests/test_torch_service.py).
SCORE_TOL = 1e-4
#: Probability tolerance across packages (tests/test_torch_prob_*.py).
PROB_TOL = 2e-6


def _bank(k=5, seed=0, base=90, pack=pack_series):
    rng = np.random.default_rng(seed)
    return pack([np.abs(np.cumsum(rng.normal(size=base + 7 * i)))
                 .astype(np.float32) for i in range(k)],
                labels=[f"w{i}" for i in range(k)])


def _streams(n=3, seed=42, length=80):
    r = np.random.default_rng(seed)
    return {f"j{i}": np.abs(np.cumsum(r.normal(size=length)))
            .astype(np.float32) for i in range(n)}


def _schedule(streams, chunks=10, chunk=8, variance=False, evict=None,
              finish_later=None):
    """Deterministic command list: submits, interleaved pushes + ticks,
    optional evict / deferred finish, then a batched finish."""
    cmds = [("submit", jid, chunks * chunk) for jid in streams]
    vr = np.random.default_rng(99)
    for t in range(chunks):
        for jid, s in streams.items():
            x = s[t * chunk: (t + 1) * chunk]
            v = (0.01 * np.abs(vr.normal(size=x.shape[0]))
                 .astype(np.float32)) if variance else None
            cmds.append(("push", jid, x, v))
        cmds.append(("tick",))
        if evict is not None and t == chunks // 2:
            cmds.append(("evict", evict))
        if finish_later is not None and t == chunks - 2:
            cmds.append(("finish_later", finish_later))
    live = [j for j in streams if j not in (evict, finish_later)]
    cmds.append(("finish", live))
    if finish_later is not None:
        cmds.append(("drain",))
    return cmds


def _run(svc, cmds, lo=0, hi=None, key=None):
    """Execute cmds[lo:hi]; returns the emitted decision trajectory with
    full-precision scores (float hex) so equality means bitwise.  Pushes
    of a job evicted or deferred earlier in the tape are skipped."""
    key = key or _keyd
    outs = []
    hi = len(cmds) if hi is None else min(hi, len(cmds))
    gone = {c[1] for c in cmds[:lo] if c[0] in ("evict", "finish_later")}
    for i in range(lo, hi):
        c = cmds[i]
        if c[0] == "submit":
            svc.submit(c[1], c[2])
        elif c[0] == "push":
            if c[1] in gone:
                continue
            svc.push(c[1], c[2], variance=c[3], now=float(i))
        elif c[0] == "tick":
            outs.append((i, key(svc.tick(now=float(i)))))
        elif c[0] == "evict":
            svc.evict(c[1])
            gone.add(c[1])
        elif c[0] == "finish_later":
            svc.finish_later(c[1])
            gone.add(c[1])
        elif c[0] == "finish":
            outs.append((i, key(svc.finish_many(c[1]))))
        elif c[0] == "drain":
            outs.append((i, key(svc.drain_finishes())))
    return outs


def _keyd(decisions):
    out = []
    for j, d in sorted(decisions.items()):
        if d is None:
            out.append((j, None))
        else:
            out.append((j, d.matched, float(d.corr).hex(), d.final,
                        d.fraction_seen,
                        None if d.probability is None
                        else float(d.probability).hex(),
                        tuple((k, float(v).hex())
                              for k, v in sorted(d.scores.items()))))
    return out


# ---------------------------------------------------------------------------
# snapshot/restore: bitwise continuation at every kind of cut point
# ---------------------------------------------------------------------------

def test_snapshot_restore_bitwise_exact_mode():
    bank = _bank()
    streams = _streams()
    cmds = _schedule(streams)
    gold = _run(TuningService(bank, slots=8, **CPU), cmds)
    for cut in (0, 3, 9, 17, len(cmds) - 2):
        svc = TuningService(bank, slots=8, **CPU)
        _run(svc, cmds, 0, cut)
        twin = restore_service(snapshot_service(svc), bank, **CPU)
        a = _run(svc, cmds, cut)
        b = _run(twin, cmds, cut)
        assert a == b, f"restored service diverged (cut={cut})"
        assert a == gold[-len(a):], f"continuation != golden (cut={cut})"
        assert twin.ticks == svc.ticks
        assert twin.dispatch_count == svc.dispatch_count


PREFILTER_KW = dict(slots=8, min_probability=0.5, threshold=0.5,
                    denoise=True, prefilter_top=3,
                    prefilter_min_fraction=0.05, heartbeat_timeout=50.0,
                    queue_limit=512, queue_policy="drop_oldest")


def test_snapshot_restore_prob_prefilter_denoise():
    """All the stateful features at once: probabilistic rule (6-channel
    moments + vstats + variance queues), wavelet prefilter (haar state,
    allowed masks, packed-K state), causal denoise filter state, queues,
    heartbeats, eviction and the deferred-finish queue."""
    bank = _bank(k=6, seed=1)
    streams = _streams(n=4, seed=7, length=64)
    cmds = _schedule(streams, chunks=8, variance=True, evict="j0",
                     finish_later="j1")
    gold = _run(TuningService(bank, **PREFILTER_KW, **CPU), cmds)
    engaged = False
    for cut in (2, 11, 23, len(cmds) - 3):
        svc = TuningService(bank, **PREFILTER_KW, **CPU)
        _run(svc, cmds, 0, cut)
        engaged |= any(j.allowed is not None and not j.allowed.all()
                       for j in svc._jobs.values())
        twin = restore_service(snapshot_service(svc), bank, **CPU)
        a = _run(svc, cmds, cut)
        b = _run(twin, cmds, cut)
        assert a == b, f"restored service diverged (cut={cut})"
        assert a == gold[-len(a):], f"continuation != golden (cut={cut})"
    assert engaged, "test setup: the prefilter never pruned a job"


#: A bank wide enough (K = 16 > the smallest pruned pack, 8) that the
#: prefilter's survivor union shrinks the packed K axis mid-schedule.
WIDE = dict(k=16, seed=1, base=40)


def test_snapshot_restore_mid_prune_repacked_pack():
    """Snapshots taken before and after the K-axis re-pack (16 -> 8
    packed columns): the restored twin rebuilds the same pack, width and
    counters, and continues bitwise, pack changes included."""
    bank = _bank(**WIDE)
    streams = _streams(n=4, seed=7, length=64)
    cmds = _schedule(streams, chunks=8, variance=True, evict="j0",
                     finish_later="j1")
    gold = _run(TuningService(bank, **PREFILTER_KW, **CPU), cmds)
    repacked = False
    for cut in (23, 30, 35):
        svc = TuningService(bank, **PREFILTER_KW, **CPU)
        _run(svc, cmds, 0, cut)
        repacked |= svc.repack_count > 0 and len(svc._packed_idx) < 16
        twin = restore_service(snapshot_service(svc), bank, **CPU)
        np.testing.assert_array_equal(twin._packed_idx, svc._packed_idx)
        assert (twin._kp, twin.repack_count, twin._rows.shape) == \
            (svc._kp, svc.repack_count, svc._rows.shape)
        a = _run(svc, cmds, cut)
        b = _run(twin, cmds, cut)
        assert a == b, f"restored service diverged (cut={cut})"
        assert a == gold[-len(a):], f"continuation != golden (cut={cut})"
        assert twin.repack_count == svc.repack_count
    assert repacked, "test setup: the prefilter never re-packed"


def test_snapshot_restore_approx_prob_mode():
    """Approx probability mode rides snapshots: the 4-channel moment
    slab and the ``prob_mode`` flag are persisted, the restored twin
    rebuilds an approx-mode service (same channel count, same config)
    and continues the schedule bitwise."""
    bank = _bank(k=6, seed=1)
    streams = _streams(n=4, seed=7, length=64)
    kw = dict(slots=8, min_probability=0.5, prob_mode="approx",
              threshold=0.5, denoise=True, queue_limit=512)
    cmds = _schedule(streams, chunks=8, variance=True, evict="j0",
                     finish_later="j1")
    gold = _run(TuningService(bank, **kw, **CPU), cmds)
    for cut in (2, 11, 23, len(cmds) - 3):
        svc = TuningService(bank, **kw, **CPU)
        _run(svc, cmds, 0, cut)
        twin = restore_service(snapshot_service(svc), bank, **CPU)
        assert twin.prob_mode == "approx"
        assert twin._config["prob_mode"] == "approx"
        assert twin._moms.shape[0] == 4
        a = _run(svc, cmds, cut)
        b = _run(twin, cmds, cut)
        assert a == b, f"restored service diverged (cut={cut})"
        assert a == gold[-len(a):], f"continuation != golden (cut={cut})"


def test_snapshot_mid_repack_dirty_slots():
    """Snapshot taken AFTER a submit but BEFORE its lazy slot reset ran
    (the `_dirty` list is non-empty) must carry the pending reset."""
    bank = _bank()
    streams = _streams(n=2)
    svc = TuningService(bank, slots=8, **CPU)
    svc.submit("j0", 80)
    svc.push("j0", streams["j0"][:8])
    svc.tick()
    svc.submit("j1", 80)            # slot dirty, no tick yet
    assert svc._dirty, "test setup: expected a pending lazy reset"
    twin = restore_service(snapshot_service(svc), bank, **CPU)
    assert twin._dirty == svc._dirty
    for s in (svc, twin):
        s.push("j0", streams["j0"][8:16])
        s.push("j1", streams["j1"][:8])
    a, b = svc.tick(), twin.tick()
    assert _keyd(a) == _keyd(b)
    np.testing.assert_array_equal(svc._jobs["j1"].last_sims,
                                  twin._jobs["j1"].last_sims)


def test_restore_rejects_wrong_bank():
    svc = TuningService(_bank(), slots=4, **CPU)
    tree = snapshot_service(svc)
    with pytest.raises(ValueError, match="different reference bank"):
        restore_service(tree, _bank(seed=123), **CPU)


# ---------------------------------------------------------------------------
# the WAL wrapper: checkpoint + journal tail replay
# ---------------------------------------------------------------------------

def test_recover_snapshot_plus_journal_tail(tmp_path):
    bank = _bank()
    cmds = _schedule(_streams())
    gold = _run(TuningService(bank, slots=8, **CPU), cmds)

    r1 = RecoverableTuningService(bank, root=str(tmp_path), slots=8, **CPU)
    _run(r1, cmds, 0, 9)
    r1.checkpoint()
    _run(r1, cmds, 9, 21)           # journaled past the snapshot
    del r1                          # "crash": nothing carried over

    r2 = RecoverableTuningService.recover(bank, root=str(tmp_path), **CPU)
    assert r2.replayed > 0, "tail records should have replayed"
    a = _run(r2, cmds, 21)
    assert a == gold[-len(a):]
    assert r2.ticks == 10


def test_recover_journal_only_cold_start(tmp_path):
    """No checkpoint was ever taken: the whole journal replays against a
    fresh service built from the recover() kwargs."""
    bank = _bank()
    cmds = _schedule(_streams())
    gold = _run(TuningService(bank, slots=8, **CPU), cmds)
    r1 = RecoverableTuningService(bank, root=str(tmp_path), slots=8, **CPU)
    _run(r1, cmds, 0, 15)
    del r1
    r2 = RecoverableTuningService.recover(bank, root=str(tmp_path),
                                          slots=8, **CPU)
    assert r2.replayed == 15
    a = _run(r2, cmds, 15)
    assert a == gold[-len(a):]


def test_checkpoint_prunes_journal(tmp_path):
    bank = _bank()
    cmds = _schedule(_streams())
    r1 = RecoverableTuningService(bank, root=str(tmp_path), slots=8,
                                  keep=1, **CPU)
    _run(r1, cmds, 0, 20)
    n_before = len(r1.wal.segments())
    r1.checkpoint()
    assert len(r1.wal.segments()) < n_before or n_before == 0
    # pruning must not break recovery
    del r1
    gold = _run(TuningService(bank, slots=8, **CPU), cmds)
    r2 = RecoverableTuningService.recover(bank, root=str(tmp_path), **CPU)
    a = _run(r2, cmds, 20)
    assert a == gold[-len(a):]


def test_recover_replays_quarantine_not_poison(tmp_path):
    """A poisoned push quarantines its job and is journaled as an
    explicit quarantine EVENT (the poison never enters the WAL); replay
    re-evicts and survivors continue bit-identically."""
    bank = _bank()
    streams = _streams()
    r1 = RecoverableTuningService(bank, root=str(tmp_path), slots=8, **CPU)
    for j in streams:
        r1.submit(j, 80)
    for t in range(3):
        for j, s in streams.items():
            r1.push(j, s[t * 8: (t + 1) * 8], now=float(t))
        r1.tick(now=float(t))
    bad = streams["j1"][24:32].copy()
    bad[2] = np.inf
    with pytest.raises(PoisonedSampleError):
        r1.push("j1", bad, now=3.0)
    assert r1.quarantined == {"j1": "non-finite sample (NaN/Inf)"}
    survivors_before = {j: svc_job.last_sims.copy()
                        for j, svc_job in r1.svc._jobs.items()}
    del r1

    r2 = RecoverableTuningService.recover(bank, root=str(tmp_path), **CPU)
    assert r2.quarantined == {"j1": "non-finite sample (NaN/Inf)"}
    assert "j1" not in r2.svc._jobs
    for j, sims in survivors_before.items():
        np.testing.assert_array_equal(r2.svc._jobs[j].last_sims, sims)
    # a sick agent still pushing is dropped, not resurrected
    r2.push("j1", streams["j1"][24:32], now=4.0)
    assert r2.quarantine_dropped == 1 and "j1" not in r2.svc._jobs


def test_quarantine_sticks_across_checkpoint_and_recover(tmp_path):
    """Quarantine survives the SNAPSHOT path too, not just WAL replay: a
    job quarantined before ``checkpoint()`` stays quarantined after
    ``recover()``, its sick agent's post-recovery pushes are swallowed
    and counted, and the survivors finish with bitwise-identical
    verdicts to an uninterrupted run."""
    bank = _bank()
    streams = _streams()

    gold = TuningService(bank, slots=8, **CPU)
    for j in streams:
        gold.submit(j, 80)
    for t in range(3):
        for j, s in streams.items():
            if j == "j1" and t >= 1:
                continue
            gold.push(j, s[t * 8: (t + 1) * 8], now=float(t))
        gold.tick(now=float(t))
    gold_fin = _run(gold, [("finish", ["j0", "j2"])])

    r1 = RecoverableTuningService(bank, root=str(tmp_path), slots=8, **CPU)
    for j in streams:
        r1.submit(j, 80)
    for j, s in streams.items():
        r1.push(j, s[:8], now=0.0)
    r1.tick(now=0.0)
    bad = streams["j1"][8:16].copy()
    bad[4] = np.nan
    with pytest.raises(PoisonedSampleError):
        r1.push("j1", bad, now=1.0)
    r1.push("j1", streams["j1"][8:16], now=1.0)   # swallowed pre-crash
    assert r1.quarantine_dropped == 1
    for t in range(1, 3):
        for j, s in streams.items():
            if j == "j1":
                continue
            r1.push(j, s[t * 8: (t + 1) * 8], now=float(t))
        r1.tick(now=float(t))
    r1.checkpoint()
    del r1

    r2 = RecoverableTuningService.recover(bank, root=str(tmp_path), **CPU)
    assert r2.replayed == 0                       # snapshot was current
    assert r2.quarantined == {"j1": "non-finite sample (NaN/Inf)"}
    assert r2.quarantine_dropped == 1
    assert "j1" not in r2.svc._jobs
    # still-sick agent keeps pushing: swallowed + counted, never revived
    r2.push("j1", streams["j1"][16:24], now=3.0)
    assert r2.quarantine_dropped == 2 and "j1" not in r2.svc._jobs
    assert _run(r2, [("finish", ["j0", "j2"])]) == gold_fin


# ---------------------------------------------------------------------------
# torn files: truncated journal tails and incomplete snapshot steps
# ---------------------------------------------------------------------------

def test_tracelog_truncated_tail_is_skipped(tmp_path):
    """Chop bytes off a real flushed segment: the reopened log warns,
    counts it in ``corrupt_segments``, and replays everything before."""
    log = TraceLog(str(tmp_path), max_segment_bytes=1 << 14)
    rng = np.random.default_rng(0)
    for _ in range(4):
        log.append("job0", rng.normal(size=32).astype(np.float32))
        log.flush()                 # one segment per record
    segs = log.segments()
    assert len(segs) == 4
    victim = os.path.join(str(tmp_path), segs[-1])
    truncate_file(victim, drop_bytes=max(1, os.path.getsize(victim) // 2))

    reopened = TraceLog(str(tmp_path), max_segment_bytes=1 << 14)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        recs = reopened.records()
    assert reopened.corrupt_segments == 1
    assert any("truncated or corrupt" in str(x.message) for x in w)
    assert [seq for seq, _, _ in recs] == [0, 1, 2]  # tail record lost
    assert reopened.read_job("job0").shape[0] == 3 * 32


def test_tracelog_reopen_resumes_sequence(tmp_path):
    log = TraceLog(str(tmp_path))
    log.append("a", np.ones(4, np.float32))
    log.append_event("tick", {"now": 1.0})
    log.flush()
    assert log.next_seq == 2
    reopened = TraceLog(str(tmp_path))
    assert reopened.next_seq == 2
    assert reopened.segments() == log.segments()
    seq = reopened.append_event("tick", {"now": 2.0})
    assert seq == 2                 # no clobbering of the old journal


def test_recover_with_torn_snapshot_falls_back(tmp_path):
    """A crash mid-save leaves a manifest-less step dir; recovery must
    restore the newest COMPLETE snapshot and replay a longer tail."""
    bank = _bank()
    cmds = _schedule(_streams())
    gold = _run(TuningService(bank, slots=8, **CPU), cmds)
    r1 = RecoverableTuningService(bank, root=str(tmp_path), slots=8, **CPU)
    _run(r1, cmds, 0, 9)
    r1.checkpoint(prune=False)
    _run(r1, cmds, 9, 15)
    # fake a crash mid-checkpoint: a step dir with arrays but no manifest
    torn = os.path.join(str(tmp_path), "ckpt", "step_000099")
    os.makedirs(torn)
    np.savez(os.path.join(torn, "arrays.npz"), junk=np.zeros(3))
    del r1
    r2 = RecoverableTuningService.recover(bank, root=str(tmp_path), **CPU)
    a = _run(r2, cmds, 15)
    assert a == gold[-len(a):]


# ---------------------------------------------------------------------------
# random interleavings of push/tick/snapshot/crash/restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 1 << 20, 2 ** 31 - 1])
def test_random_interleaving_recovery_invariance(seed):
    """Random command tapes (uneven pushes, empty ticks, evictions,
    deferred finishes, zero-job stretches) crashed at a random point and
    recovered from snapshot+journal continue exactly like the
    uninterrupted run."""
    rng = np.random.default_rng(seed)
    bank = _bank(k=4, seed=3)
    n_jobs = int(rng.integers(1, 5))
    streams = _streams(n=n_jobs, seed=int(rng.integers(1 << 30)),
                       length=48)
    cmds = [("submit", j, 48) for j in streams]
    pos = {j: 0 for j in streams}
    for _ in range(int(rng.integers(4, 12))):
        for j in streams:
            step = int(rng.integers(0, 9))
            if step and pos[j] < 48:
                cmds.append(("push", j, streams[j][pos[j]:pos[j] + step],
                             None))
                pos[j] = min(48, pos[j] + step)
        cmds.append(("tick",))
    if n_jobs > 1 and rng.random() < 0.5:
        cmds.append(("evict", f"j{n_jobs - 1}"))
        live = [j for j in streams if j != f"j{n_jobs - 1}"]
    else:
        live = list(streams)
    cmds.append(("finish", live))

    gold = _run(TuningService(bank, slots=8, **CPU), cmds)
    with tempfile.TemporaryDirectory() as root:
        r1 = RecoverableTuningService(bank, root=root, slots=8, **CPU)
        cut = int(rng.integers(0, len(cmds)))
        ckpt_at = int(rng.integers(0, cut + 1))
        _run(r1, cmds, 0, ckpt_at)
        r1.checkpoint()
        _run(r1, cmds, ckpt_at, cut)
        del r1
        r2 = RecoverableTuningService.recover(bank, root=root, slots=8,
                                              **CPU)
        a = _run(r2, cmds, cut)
        tail = gold[len(gold) - len(a):]
        assert a == tail, f"seed={seed} cut={cut} ckpt={ckpt_at}"


# ---------------------------------------------------------------------------
# the overload control plane across recovery
# ---------------------------------------------------------------------------

def _ladder_bank():
    rng = np.random.default_rng(2)
    return pack_series([np.abs(np.cumsum(rng.normal(size=100)))
                        .astype(np.float32) for _ in range(4)],
                       labels=[f"w{i}" for i in range(4)])


@pytest.mark.parametrize("seed", [5, 17])
def test_recover_mid_ladder_bitwise(tmp_path, seed):
    """Kill an overloaded service mid-burst; the recovered twin (its
    journaled submits never re-gated by admission, its ticks replayed
    with their journaled latencies) resumes at the same rung with the
    same history, same QoS/degraded markers, and finishes with
    bitwise-identical verdicts."""
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.serve.overload import AdmissionPolicy, OverloadConfig
    streams = _streams(seed=seed, length=48)
    kw = dict(overload=OverloadConfig(target_p99=0.01, patience=1,
                                      cooldown=1000, window=64),
              admission=AdmissionPolicy(),
              chaos=FaultPlan(seed=seed, slow_rate=1.0, slow_extra=10.0))
    rsvc = RecoverableTuningService(_ladder_bank(), root=str(tmp_path),
                                    **kw, **CPU)
    for j in streams:
        rsvc.submit(j, 48, qos="gold")
    for t in range(3):
        for j, s in streams.items():
            rsvc.push(j, s[t * 8: (t + 1) * 8])
        rsvc.tick()
    assert rsvc.rung >= 1
    rsvc.checkpoint()
    for t in range(3, 5):                     # journal tail past snapshot
        for j, s in streams.items():
            rsvc.push(j, s[t * 8: (t + 1) * 8])
        rsvc.tick()

    rec = RecoverableTuningService.recover(_ladder_bank(),
                                           root=str(tmp_path), **CPU)
    assert rec.replayed > 0
    assert rec.rung == rsvc.rung
    assert rec.rung_history == rsvc.rung_history
    assert not rec.svc._admission_suppressed
    for j in streams:
        assert rec.svc._jobs[j].qos == "gold"
        assert (rec.svc._jobs[j].degraded_level
                == rsvc.svc._jobs[j].degraded_level)
    for j, s in streams.items():
        rsvc.push(j, s[40:48])
        rec.push(j, s[40:48])
    rsvc.tick()
    rec.tick()
    assert (_keyd(rec.finish_many(list(streams)))
            == _keyd(rsvc.finish_many(list(streams))))


def test_replay_never_sheds_a_journaled_submit(tmp_path):
    """A submit admitted live is journaled; replayed against a restored
    service whose admission gate would now shed it (every class at zero
    headroom), it is admitted all the same."""
    from repro_torch.serve.overload import (AdmissionPolicy,
                                            AdmissionShedError)
    kw = dict(admission=AdmissionPolicy(bronze=0.1, silver=0.1, gold=0.1,
                                        cost_scale=0.01))
    with pytest.raises(AdmissionShedError):   # the gate would shed it
        TuningService(_ladder_bank(), **kw, **CPU).submit("big", 400,
                                                          qos="silver")
    r1 = RecoverableTuningService(_ladder_bank(), root=str(tmp_path),
                                  **kw, **CPU)
    r1.svc._admission_suppressed = True       # the live run admitted it
    r1.submit("big", 400, qos="silver")
    r1.svc._admission_suppressed = False
    r1.push("big", np.full(8, 0.5, np.float32))
    del r1
    r2 = RecoverableTuningService.recover(_ladder_bank(),
                                          root=str(tmp_path), **kw, **CPU)
    assert r2.replayed == 2 and "big" in r2.svc._jobs
    assert r2.shed_count == 0


def test_checkpoint_refuses_degraded_journal(tmp_path, monkeypatch):
    """While the journal's writes fail, commands are accepted in memory
    and ``checkpoint()`` refuses to stamp a watermark past them; once
    writes heal it checkpoints and recovery sees the push."""
    import repro_torch.serve.ingest as ingest
    real = ingest.atomic_write_npz

    def boom(*a, **kw):
        raise OSError("disk full")

    rsvc = RecoverableTuningService(_ladder_bank(), root=str(tmp_path),
                                    **CPU)
    rsvc.submit("a", 48)
    monkeypatch.setattr(ingest, "atomic_write_npz", boom)
    with pytest.warns(RuntimeWarning):
        rsvc.push("a", np.ones(8, np.float32))   # accepted, in-memory
    with pytest.raises(RuntimeError, match="journal degraded"):
        rsvc.checkpoint()
    monkeypatch.setattr(ingest, "atomic_write_npz", real)
    rsvc.checkpoint()                     # heals, then succeeds
    rec = RecoverableTuningService.recover(_ladder_bank(),
                                           root=str(tmp_path), **CPU)
    assert rec.svc._front._jobs["a"].pushed == 8


def test_snapshot_restores_breaker_and_shed_counters():
    from repro_torch.runtime.retry import CircuitBreaker
    from repro_torch.serve.overload import (AdmissionPolicy,
                                            AdmissionShedError,
                                            OverloadConfig)
    br = CircuitBreaker(fail_threshold=1, cooldown=3, probe_interval=4,
                        seed=9)
    svc = TuningService(_ladder_bank(), overload=OverloadConfig(),
                        admission=AdmissionPolicy(bronze=0.1, silver=0.1,
                                                  gold=0.1,
                                                  cost_scale=0.01),
                        breaker=br, **CPU)
    with pytest.raises(AdmissionShedError):
        svc.submit("big", 400, qos="silver")
    br.record_failure()                       # tripped at snapshot time
    tree = snapshot_service(svc)
    br2 = CircuitBreaker(fail_threshold=1, cooldown=3, probe_interval=4,
                         seed=0)
    svc2 = restore_service(tree, _ladder_bank(), breaker=br2, **CPU)
    assert svc2.shed_count == 1 and svc2.shed_by_class == {"silver": 1}
    assert br2.state == br2.OPEN and br2.opened_count == 1
    assert [br.before_dispatch() for _ in range(8)] \
        == [br2.before_dispatch() for _ in range(8)]
    assert svc2._config == svc._config


# ---------------------------------------------------------------------------
# snapshots across the packages
# ---------------------------------------------------------------------------

def _near(decisions):
    """Decision trajectory for cross-package comparison: matched
    workload, finality and fractions exactly; scores and probabilities as
    floats, held within SCORE_TOL / PROB_TOL by ``_same_near``."""
    out = []
    for j, d in sorted(decisions.items()):
        out.append((j, None) if d is None else
                   (j, d.matched, d.final, d.fraction_seen,
                    d.decided_at_fraction, d.corr, d.probability,
                    tuple(sorted(d.scores.items()))))
    return out


def _same_near(got, want):
    assert len(got) == len(want)
    for (ig, dg), (iw, dw) in zip(got, want):
        assert ig == iw and len(dg) == len(dw)
        for g, w in zip(dg, dw):
            assert g[:5] == w[:5], (ig, g, w)
            if len(g) == 2:                     # (job, None): abstained
                continue
            assert abs(g[5] - w[5]) <= SCORE_TOL
            assert (g[6] is None) == (w[6] is None)
            if g[6] is not None:
                assert abs(g[6] - w[6]) <= PROB_TOL
            assert [k for k, _ in g[7]] == [k for k, _ in w[7]]
            for (_, sg), (_, sw) in zip(g[7], w[7]):
                assert abs(sg - sw) <= SCORE_TOL


CROSS_MODES = {
    "point-prefilter": dict(slots=8, threshold=0.5, denoise=True,
                            prefilter_top=3, prefilter_min_fraction=0.05,
                            heartbeat_timeout=50.0, queue_limit=512),
    "prob-prefilter": PREFILTER_KW,
}


@pytest.mark.parametrize("mode", sorted(CROSS_MODES))
@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_snapshot_crosses_packages_and_replays(mode, direction):
    """A snapshot one package wrote (with the prefilter on, mid-prune)
    restores in the other, and the restored service continues the
    schedule to the writer's uninterrupted decisions; the restored pack,
    live sets, DP rows and moment slabs equal the snapshot's."""
    kw = CROSS_MODES[mode]
    prob = "min_probability" in kw
    ref_bank = _bank(**WIDE, pack=ref_pack)
    bank = _bank(**WIDE)
    streams = _streams(n=4, seed=7, length=64)
    cmds = _schedule(streams, chunks=8, variance=prob, evict="j0",
                     finish_later="j1")
    to_port = direction == "reference-to-port"
    writer_cls, writer_bank = (RefService, ref_bank) if to_port \
        else (TuningService, bank)
    wkw = dict(kw) if to_port else dict(kw, **CPU)
    for cut in (23, 30):
        writer = writer_cls(writer_bank, **wkw)
        _run(writer, cmds, 0, cut)
        assert len(writer._packed_idx) < 16 or cut == 23
        tree = (ref_snapshot_service if to_port
                else snapshot_service)(writer)
        twin = restore_service(tree, bank, **CPU) if to_port \
            else ref_restore_service(tree, ref_bank)
        np.testing.assert_array_equal(twin._packed_idx, writer._packed_idx)
        k_live = len(writer._packed_idx)
        for name in ("_rows", "_moms"):
            np.testing.assert_array_equal(
                np.asarray(getattr(twin, name))[..., :k_live],
                np.asarray(getattr(writer, name))[..., :k_live])
        for jid, job in writer._jobs.items():
            if job.allowed is None:
                assert twin._jobs[jid].allowed is None
            else:
                np.testing.assert_array_equal(twin._jobs[jid].allowed,
                                              job.allowed)
        a = _run(writer, cmds, cut, key=_near)
        b = _run(twin, cmds, cut, key=_near)
        _same_near(b, a)


# ---------------------------------------------------------------------------
# kill and recover in child processes
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import json
    import os
    import signal
    import sys
    import numpy as np
    from repro_torch.core.database import pack_series
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.serve.recovery import RecoverableTuningService
    from repro_torch.serve.tuning import TuningService
    from repro_torch.sharding import make_mesh

    MODE = os.environ["CR_MODE"]            # golden | serve | recover
    ROOT = os.environ["CR_ROOT"]
    MESH = os.environ.get("CR_MESH", "none")  # bank shards, or none
    KILL_EVERY = int(os.environ.get("CR_KILL_EVERY", "0")) or None
    CKPT_AT = int(os.environ.get("CR_CKPT_AT", "11"))

    rng = np.random.default_rng(7)
    series = [np.abs(np.cumsum(rng.normal(size=int(l))))
              .astype(np.float32)
              for l in rng.integers(40, 90, size=6)]
    bank = pack_series(series, labels=[f"w{i}" for i in range(6)])
    streams = {f"j{i}": np.abs(np.cumsum(rng.normal(size=64)))
               .astype(np.float32) for i in range(3)}

    # the command tape: every entry journals EXACTLY one WAL record, so
    # a crashed run's resume position is wal.next_seq.
    cmds = [("submit", j) for j in streams]
    for t in range(8):
        cmds += [("push", j, t) for j in streams]
        cmds += [("tick", float(t))]
    cmds += [("finish", sorted(streams))]

    def keyd(decisions):
        out = []
        for j, d in sorted(decisions.items()):
            if d is None:
                out.append([j, None])
            else:
                out.append([j, d.matched, float(d.corr).hex(), d.final,
                            sorted([k, float(v).hex()]
                                   for k, v in d.scores.items())])
        return out

    def run_cmd(svc, cmd):
        kind = cmd[0]
        if kind == "submit":
            svc.submit(cmd[1], 64)
        elif kind == "push":
            j, t = cmd[1], cmd[2]
            svc.push(j, streams[j][t * 8:(t + 1) * 8], now=float(t))
        elif kind == "tick":
            return keyd(svc.tick(now=cmd[1]))
        elif kind == "finish":
            return keyd(svc.finish_many(cmd[1]))
        return None

    KW = dict(threshold=0.5, margin=0.01, stable_ticks=2,
              min_fraction=0.2, slots=4, device="cpu")
    if MESH != "none":
        KW["mesh"] = make_mesh(int(MESH), devices=["cpu"] * int(MESH))

    if MODE == "golden":
        svc = TuningService(bank, **KW)
        out = {}
        for i, cmd in enumerate(cmds):
            d = run_cmd(svc, cmd)
            if d is not None:
                out[str(i)] = d
        print("GOLDEN " + json.dumps(out), flush=True)

    elif MODE == "serve":
        svc = RecoverableTuningService(bank, root=ROOT, **KW)
        plan = FaultPlan(seed=0, kill_every=KILL_EVERY)
        for i, cmd in enumerate(cmds):
            run_cmd(svc, cmd)
            print(f"ACK {i}", flush=True)
            if i == CKPT_AT:
                svc.checkpoint()
                print(f"CKPT {i}", flush=True)
            if plan.should_kill(i):
                os.kill(os.getpid(), signal.SIGKILL)   # a REAL crash
        print("SERVE_DONE", flush=True)

    elif MODE == "recover":
        svc = RecoverableTuningService.recover(bank, root=ROOT, **KW)
        resume = svc.wal.next_seq
        print(f"RESUMED_AT {resume} REPLAYED {svc.replayed}", flush=True)
        out = {}
        for i in range(resume, len(cmds)):
            d = run_cmd(svc, cmds[i])
            if d is not None:
                out[str(i)] = d
        print("RECOVERED " + json.dumps(out), flush=True)
""")

N_CMDS = 3 + 8 * 4 + 1     # keep in sync with the tape in SCRIPT


def _child(mode, root, **env_extra):
    env = dict(os.environ, PYTHONPATH=SRC, CR_MODE=mode, CR_ROOT=str(root),
               **{k: str(v) for k, v in env_extra.items()})
    return subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600)


def _kill_and_recover(tmp_path, crash_mesh="none", recover_mesh="none"):
    import json
    root = tmp_path / "svc"
    g = _child("golden", root, CR_MESH=recover_mesh)
    assert g.returncode == 0, g.stdout + g.stderr
    golden = json.loads(g.stdout.split("GOLDEN ", 1)[1].splitlines()[0])

    s = _child("serve", root, CR_KILL_EVERY=20, CR_CKPT_AT=11,
               CR_MESH=crash_mesh)
    assert s.returncode == -signal.SIGKILL, \
        f"serve process should die by SIGKILL: {s.returncode}\n" \
        + s.stdout + s.stderr
    assert "SERVE_DONE" not in s.stdout, "crash must land mid-tape"
    assert "CKPT 11" in s.stdout, s.stdout + s.stderr
    assert "ACK 19" in s.stdout and "ACK 20" not in s.stdout, s.stdout

    r = _child("recover", root, CR_MESH=recover_mesh)
    assert r.returncode == 0, r.stdout + r.stderr
    head = r.stdout.split("RESUMED_AT ", 1)[1].split()
    resume, replayed = int(head[0]), int(head[2])
    assert resume == 20, (resume, r.stdout)       # crash after cmd 19
    assert replayed == 20 - 1 - 11, (replayed, r.stdout)  # tail past ckpt
    recovered = json.loads(
        r.stdout.split("RECOVERED ", 1)[1].splitlines()[0])
    assert recovered, "recovered run emitted no decisions"
    for i, dec in recovered.items():
        assert int(i) >= resume
        assert dec == golden[i], (i, dec, golden[i])
    assert str(N_CMDS - 1) in recovered


def test_kill_and_recover_unsharded(tmp_path):
    """SIGKILL a serving child mid-tape (after a checkpoint at command
    11), recover in a second child from snapshot + journal tail, and
    hold every decision it emits bitwise to a golden child's."""
    _kill_and_recover(tmp_path)


def test_kill_and_recover_onto_fewer_devices(tmp_path):
    """The reference's test of the same name: crash on a mesh of 8 bank
    shards, recover onto 4, the golden run on 4.  Decisions are still
    bitwise the golden child's: recovery composes with elastic
    rescale."""
    _kill_and_recover(tmp_path, crash_mesh="8", recover_mesh="4")


def test_recovery_modules_import_no_jax():
    """``repro_torch.serve.recovery``, ``repro_torch.checkpoint`` and
    ``repro_torch.sharding`` pull in no module of jax or of the reference
    package."""
    code = ("import sys; import repro_torch.serve.recovery, "
            "repro_torch.checkpoint, repro_torch.core.wavelet, "
            "repro_torch.sharding; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print('bad', bad)")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "bad []", out.stdout
