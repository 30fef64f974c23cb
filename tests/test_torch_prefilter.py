"""The port's streaming wavelet prefilter (``TuningService(prefilter_top=)``)
and ``AutoTuner(wavelet_prefilter=)`` against the reference's.

Golden traces: every mrsim app streamed at 4 Hz in 8-sample chunks
against the preprocessed 3-app x 4-parameter-set bank (band 16,
threshold 0.85, denoise), as the reference's pruned-vs-unpruned property
test runs them.  The port's pruned service must take the reference's
pruned decisions tick for tick, with the same live sets (``allowed``),
the same packed K axis and re-pack count, and scores within SCORE_TOL
(the ticks' moments differ only in float32 rounding on continuous data;
tests/test_torch_service.py).  Within the port, every DP cell is per
(job, reference), so a pruned run's scores on a job's allowed columns
are BITWISE the unpruned run's: a difference is a gather fault."""

import numpy as np
import pytest

from repro import mrsim as rmrsim
from repro.core import ReferenceDB as RefDB
from repro.core.database import SeriesBank as RefBank
from repro.core.database import pack_series as ref_pack
from repro.core.filters import preprocess_bank as ref_preprocess
from repro.core.tuner import AutoTuner as RefTuner
from repro.serve.overload import OverloadConfig as RefOverloadConfig
from repro.serve.tuning import TuningService as RefService
from repro_torch import mrsim
from repro_torch.core import AutoTuner, ReferenceDB
from repro_torch.core.database import SeriesBank, pack_series
from repro_torch.core.filters import preprocess_bank
from repro_torch.serve.overload import OverloadConfig
from repro_torch.serve.tuning import TuningService

CPU = dict(device="cpu")
KW = dict(band=16, threshold=0.85, margin=0.02, stable_ticks=3,
          min_fraction=0.15, denoise=True)
SCORE_TOL = 1e-4
APPS = sorted(mrsim.APPS)


def _golden(mod, pack, preprocess, bank_cls, apps=None):
    series, labels = [], []
    for app in apps or mod.APPS:
        for p in mod.paper_param_sets():
            series.append(mod.simulate_cpu_series(app, p, dt=0.25))
            labels.append(app)
    b = pack(series, labels=labels)
    return bank_cls(np.asarray(preprocess(b.series, b.lengths)), b.lengths,
                    b.labels, b.entries)


@pytest.fixture(scope="module")
def banks():
    return (_golden(rmrsim, ref_pack, ref_preprocess, RefBank),
            _golden(mrsim, pack_series, preprocess_bank, SeriesBank))


def _key(d):
    return None if d is None else (d.matched, d.decided_at_fraction,
                                   d.fraction_seen, d.final)


def _finite(x):
    return np.where(np.isfinite(x), x, 0.0)


@pytest.mark.parametrize("app", APPS)
def test_pruned_service_matches_reference_tick_for_tick(banks, app):
    """The port's pruned service against the reference's pruned service
    on one golden trace: decisions, live sets, the packed K axis, re-pack
    count and dispatches equal at every tick, scores within SCORE_TOL;
    the final verdict equal."""
    ref_bank, bank = banks
    p = mrsim.paper_param_sets()[0]
    q = mrsim.simulate_cpu_series(app, p, run=1, dt=0.25)
    ref = RefService(ref_bank, prefilter_top=4, **KW)
    svc = TuningService(bank, prefilter_top=4, **KW, **CPU)
    for s in (ref, svc):
        s.submit(app, expected_len=len(q))
    engaged = False
    for lo in range(0, len(q), 8):
        ref.push(app, q[lo: lo + 8])
        svc.push(app, q[lo: lo + 8])
        assert _key(svc.tick().get(app)) == _key(ref.tick().get(app))
        rj, sj = ref._jobs[app], svc._jobs[app]
        assert (sj.allowed is None) == (rj.allowed is None)
        if sj.allowed is not None:
            np.testing.assert_array_equal(sj.allowed, rj.allowed)
            engaged |= not sj.allowed.all()
        np.testing.assert_array_equal(svc._packed_idx, ref._packed_idx)
        assert (svc._kp, svc.repack_count, svc.dispatch_count) == \
            (ref._kp, ref.repack_count, ref.dispatch_count)
        np.testing.assert_array_equal(np.isfinite(sj.last_sims),
                                      np.isfinite(rj.last_sims))
        np.testing.assert_allclose(_finite(sj.last_sims),
                                   _finite(rj.last_sims), atol=SCORE_TOL)
        np.testing.assert_array_equal(sj.haar.coeffs(), rj.haar.coeffs())
    fr, fs = ref.finish(app), svc.finish(app)
    assert _key(fs) == _key(fr) and fs.corr == fr.corr
    assert engaged, "the prefilter never pruned"


@pytest.mark.parametrize("mode", ["point", "exact", "approx"])
@pytest.mark.parametrize("app", APPS)
def test_pruned_scores_bitwise_unpruned_on_allowed_columns(banks, app,
                                                           mode):
    """Pruned against unpruned in the port, on one golden trace: every
    in-flight decision and the final verdict equal tick for tick, the
    scores (and probabilities) on the job's allowed columns bitwise the
    unpruned run's at every tick, one dispatch a tick.  The
    probabilistic modes stream zero variances."""
    _, bank = banks
    p = mrsim.paper_param_sets()[0]
    q = mrsim.simulate_cpu_series(app, p, run=1, dt=0.25)
    kw = dict(KW, **CPU)
    if mode != "point":
        kw.update(min_probability=0.5, prob_mode=mode)
    runs = [TuningService(bank, prefilter_top=pf, **kw) for pf in (None, 4)]
    for s in runs:
        s.submit(app, expected_len=len(q))
    for lo in range(0, len(q), 8):
        # the live set this tick's scores are masked to: the one the
        # previous tick's prune left (this tick's prune narrows it after)
        pr = runs[1]._jobs[app]
        live = np.ones(len(bank), bool) if pr.allowed is None \
            else pr.allowed.copy()
        outs = []
        for s in runs:
            if mode == "point":
                s.push(app, q[lo: lo + 8])
            else:
                s.push(app, q[lo: lo + 8],
                       variance=np.zeros(len(q[lo: lo + 8]), np.float32))
            d = s.tick().get(app)
            outs.append(None if d is None else
                        (d.matched, d.corr, d.decided_at_fraction,
                         d.probability))
        assert outs[0] == outs[1]
        u = runs[0]._jobs[app]
        np.testing.assert_array_equal(pr.last_sims[live], u.last_sims[live])
        assert np.isneginf(pr.last_sims[~live]).all()
        if mode != "point":
            np.testing.assert_array_equal(pr.last_probs[live],
                                          u.last_probs[live])
            assert (pr.last_probs[~live] == 0.0).all()
    finals = [s.finish(app) for s in runs]
    assert (finals[0].matched, finals[0].corr, finals[0].scores) == \
        (finals[1].matched, finals[1].corr, finals[1].scores)
    assert finals[0].decided_at_fraction == finals[1].decided_at_fraction
    for s in runs:
        assert s.dispatch_count == s.ticks


def _diverse_bank(rng, k, min_len=64):
    series = []
    for i in range(k):
        n = int(rng.integers(min_len, min_len + 40))
        t = np.linspace(0, 1, n, dtype=np.float32)
        s = (0.5 + 0.28 * np.sin(2 * np.pi * (1.5 + 0.3 * i) * t + 0.7 * i)
             + 0.06 * rng.normal(size=n).astype(np.float32))
        series.append(np.clip(s, 0, 1).astype(np.float32))
    return series


def test_prefilter_repack_accounting_and_dispatch_invariant():
    """Re-packs are counted separately and never inflate dispatch_count:
    dispatches == data-carrying ticks holds through prune-driven shrinks
    AND the re-grow when a fresh job re-widens the survivor union; the
    packed bank is the full bank's columns, padded with length-1 zero
    columns; the reference's service takes the same steps."""
    rng = np.random.default_rng(42)
    series = _diverse_bank(rng, 24)
    bank, ref_bank = pack_series(series), ref_pack(series)
    qlen = 64
    kw = dict(prefilter_top=2, prefilter_margin=0.0,
              prefilter_min_fraction=0.1, slots=4)
    svc = TuningService(bank, **kw, **CPU)
    ref = RefService(ref_bank, **kw)
    for s in (svc, ref):
        for j in range(2):
            s.submit(f"job{j}", expected_len=qlen)
    qs = np.stack([np.clip(bank.row(7 * j)[:qlen]
                           + 0.04 * rng.normal(size=qlen), 0, 1)
                   .astype(np.float32) for j in range(2)])
    data_ticks = 0
    for lo in range(0, qlen, 8):
        for s in (svc, ref):
            for j in range(2):
                s.push(f"job{j}", qs[j, lo: lo + 8])
            s.tick()
        data_ticks += 1
        np.testing.assert_array_equal(svc._packed_idx, ref._packed_idx)
    assert svc.dispatch_count == data_ticks == svc.ticks
    shrink_repacks = svc.repack_count
    assert shrink_repacks == ref.repack_count >= 1, \
        "prune never re-packed the device state"
    k_live = len(svc._packed_idx)
    assert k_live < len(bank)
    # the packed bank: the live columns of the full bank, then padding
    assert svc._bank_t.shape == (bank.series.shape[1], svc._kp)
    assert svc._rows.shape[2] == svc._moms.shape[3] == svc._kp
    np.testing.assert_array_equal(svc._bank_t[:, :k_live].numpy(),
                                  bank.series[svc._packed_idx].T)
    assert (svc._bank_t[:, k_live:] == 0).all()
    assert (svc._lengths[k_live:] == 1).all()
    # an empty tick moves nothing: no dispatch, no re-pack
    svc.tick()
    assert svc.dispatch_count == data_ticks
    assert svc.repack_count == shrink_repacks
    # pruned-for-this-job references surface as -inf, never a leader
    for j in range(2):
        job = svc._jobs[f"job{j}"]
        assert job.allowed is not None and not job.allowed.all()
        assert np.isneginf(job.last_sims[~job.allowed]).all()
        assert np.isfinite(job.last_sims[int(np.argmax(job.last_sims))])
    for j in range(2):
        svc.finish(f"job{j}")
    # a fresh job needs the whole bank again: the next data tick re-grows
    # the pack (one more re-pack, still one dispatch per data tick)
    svc.submit("fresh", expected_len=qlen)
    svc.push("fresh", qs[0, :8])
    svc.tick()
    assert len(svc._packed_idx) == len(bank)
    assert svc.repack_count == shrink_repacks + 1
    assert svc.dispatch_count == data_ticks + 1
    # the full pack is the verdicts' upload itself
    assert svc._bank_t is bank.score_plan("cpu").bank_t


def test_deep_prune_rung_halves_prefilter_budget():
    """Rung 4 (``deep_prune``) divides ``prefilter_top`` by 2, as in the
    reference's service walked by the same latencies."""
    rng = np.random.default_rng(2)
    series = [np.abs(np.cumsum(rng.normal(size=100))).astype(np.float32)
              for _ in range(8)]
    labels = [f"w{i}" for i in range(8)]
    cfg = dict(target_p99=0.01, patience=1, cooldown=1000, max_rung=4)
    svc = TuningService(pack_series(series, labels=labels),
                        prefilter_top=6, overload=OverloadConfig(**cfg),
                        **CPU)
    ref = RefService(ref_pack(series, labels=labels), prefilter_top=6,
                     overload=RefOverloadConfig(**cfg))
    for _ in range(8):
        svc.tick(latency=10.0)
        ref.tick(latency=10.0)
    assert svc.rung == ref.rung == 4
    assert svc._overload.prefilter_divisor == 2
    assert svc.rung_history == ref.rung_history


def _job_chunks(q, rng):
    """Fixed per-job chunk schedule (identical in every run)."""
    chunks, lo = [], 0
    while lo < len(q):
        c = int(rng.integers(4, 24))
        chunks.append(q[lo: lo + c])
        lo += c
    return chunks


def _decision_key(d):
    return None if d is None else (d.matched, d.corr, d.decided_at_fraction,
                                   tuple(sorted(d.scores.items())))


def _fixed_run(bank, jobs, **kw):
    """Fixed-slot, fixed-order baseline: all jobs submitted up front,
    chunk i consumed at tick i, sequential finishes."""
    svc = TuningService(bank, elastic_slots=False, **kw, **CPU)
    for jid, chunks in jobs.items():
        svc.submit(jid, expected_len=sum(len(c) for c in chunks))
    early = {}
    for t in range(max(len(c) for c in jobs.values())):
        for jid, chunks in jobs.items():
            if t < len(chunks):
                svc.push(jid, chunks[t])
        for jid, d in svc.tick().items():
            if d is not None:
                early.setdefault(jid, d)
    finals = {jid: svc.finish(jid) for jid in jobs}
    return early, finals


def _churned_run(bank, jobs, seed, **kw):
    """Elastic slots, randomized admission order + staggered starts,
    decoy jobs evicted mid-run (forcing compaction + slot moves), and
    grouped/deferred finishes.  Job j still consumes chunk i at its i-th
    data tick, so the information schedule matches the fixed run."""
    rng = np.random.default_rng(seed)
    svc = TuningService(bank, **kw, **CPU)
    order = list(jobs)
    rng.shuffle(order)
    start = {jid: int(rng.integers(0, 4)) for jid in order}
    decoys = {}
    early, finals, t = {}, {}, 0
    live = set()
    while len(finals) < len(jobs):
        for jid in order:                   # staggered admissions
            if start[jid] == t:
                svc.submit(jid, expected_len=sum(
                    len(c) for c in jobs[jid]))
                live.add(jid)
        if t == 1:                          # decoys force bucket growth
            for i in range(3):
                d = f"decoy{i}"
                svc.submit(d, expected_len=64)
                decoys[d] = 0
        for jid in sorted(live):
            k = t - start[jid]
            if k < len(jobs[jid]):
                svc.push(jid, jobs[jid][k])
        for d in list(decoys):
            svc.push(d, np.full(8, 0.5, np.float32))
            decoys[d] += 1
        for jid, d in svc.tick().items():
            if d is not None and jid in jobs:
                early.setdefault(jid, d)
        if t == 4:                          # evict decoys mid-run
            for d in list(decoys):
                svc.evict(d)
                del decoys[d]
        done = [jid for jid in sorted(live)
                if t - start[jid] + 1 >= len(jobs[jid])]
        if done:
            if rng.integers(2):             # grouped batch finish
                finals.update(svc.finish_many(done))
            else:                           # deferred drain queue
                for jid in done:
                    svc.finish_later(jid)
                finals.update(svc.drain_finishes())
            live.difference_update(done)
        t += 1
    assert svc.slot_repack_count > 0        # buckets actually crossed
    assert svc.evicted_count == 3
    return early, finals


def test_churn_invariance_with_prefilter():
    """S-axis churn composes with K-axis pruning: the prefiltered churned
    run reproduces the prefiltered fixed-slot run bitwise (over the
    paper's wordcount/terasort bank, as the reference's test runs it)."""
    bank = _golden(mrsim, pack_series, preprocess_bank, SeriesBank,
                   apps=("wordcount", "terasort"))
    rng = np.random.default_rng(7)
    psets = mrsim.paper_param_sets()
    jobs = {}
    for i, app in enumerate(("wordcount", "exim", "terasort")):
        q = mrsim.simulate_cpu_series(app, psets[i], run=1, dt=0.25)
        jobs[f"{app}{i}"] = _job_chunks(q, rng)

    kw = dict(band=16, threshold=0.85, margin=0.02, stable_ticks=2,
              min_fraction=0.15, denoise=True, slots=16,
              prefilter_top=2, prefilter_margin=0.02)
    early_ref, fin_ref = _fixed_run(bank, jobs, **kw)
    early_chn, fin_chn = _churned_run(bank, jobs, 7, **kw)

    assert early_ref.keys() == early_chn.keys()
    for jid in early_ref:
        assert _decision_key(early_ref[jid]) == _decision_key(early_chn[jid])
    for jid in jobs:
        assert _decision_key(fin_ref[jid]) == _decision_key(fin_chn[jid])


def test_distance_only_prefilter_mode_is_guarded():
    """A distance-only service (score_in_flight=False) with prefilter_top
    set would prune on the wavelet ranking ALONE, with no in-flight DTW
    veto, which evicts warp-matching references: construction refuses,
    as in the reference, and so does prefilter_top < 1."""
    rng = np.random.default_rng(0)
    bank = pack_series([rng.random(32).astype(np.float32)
                        for _ in range(4)])
    with pytest.raises(ValueError, match="score_in_flight"):
        TuningService(bank, score_in_flight=False, prefilter_top=2, **CPU)
    with pytest.raises(ValueError, match="prefilter_top must be >= 1"):
        TuningService(bank, prefilter_top=0, **CPU)


def _quickstart_dbs():
    """The quickstart's DB (examples/quickstart.py): wordcount and
    terasort profiled at every paper parameter set, in both packages."""
    dbs = []
    for mod, db_cls, tuner_cls, kw in (
            (rmrsim, RefDB, RefTuner, {}),
            (mrsim, ReferenceDB, AutoTuner, CPU)):
        db = db_cls()
        tuner = tuner_cls(db, band=8, **kw)
        for app in ("wordcount", "terasort"):
            for j, p in enumerate(mod.paper_param_sets()):
                tuner.profile(app, {"pset": j},
                              mod.simulate_cpu_series(app, p))
            tuner.record(app, {"app": app}, score=1.0)
        dbs.append(db)
    return dbs


@pytest.mark.parametrize("top", [1, 2])
def test_autotuner_wavelet_prefilter_matches_reference(top):
    """``AutoTuner(wavelet_prefilter=)`` narrows the candidates as the
    reference does and takes its decision: exim matches wordcount
    through the narrowed match, with ``used_wavelet_prefilter`` set."""
    ref_db, db = _quickstart_dbs()
    p = mrsim.paper_param_sets()[0]
    q = mrsim.simulate_cpu_series("exim", p)
    want = RefTuner(ref_db, band=8, wavelet_prefilter=top).match("exim", q)
    got = AutoTuner(db, band=8, wavelet_prefilter=top, **CPU).match(
        "exim", q)
    assert got.used_wavelet_prefilter == want.used_wavelet_prefilter
    assert got.used_wavelet_prefilter == (top < 2)
    assert (got.matched, got.config) == (want.matched, want.config)
    assert got.scores.keys() == want.scores.keys()
    for w in want.scores:
        assert abs(got.scores[w] - want.scores[w]) <= 1e-5
    if top == 1:
        assert got.matched == "wordcount"
        assert list(got.scores) == ["wordcount"]
