"""The port's exact point-mode ``TuningService`` against the reference's.

Golden traces: every mrsim app x the paper's parameter sets, streamed at
4 Hz in 8-sample chunks against a preprocessed 3-app bank (band 16,
threshold 0.85, denoise).  Both services must emit the same decisions
tick for tick — matched workload and ``decided_at_fraction``, early and
final — with scores within SCORE_TOL.  The two ticks compute bitwise the
same DP distances (so the same warp paths); their moments differ only in
float32 rounding (the reference rebuilds a horizontal cell's base as
m - pair, the port carries it), which moves in-flight scores by ~1e-5.
Final verdicts go through scorers with identical arithmetic and agree
bitwise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import mrsim as rmrsim
from repro.core.database import ReferenceDB as RefDB
from repro.core.database import SeriesBank as RefBank
from repro.core.database import pack_series as ref_pack
from repro.core.filters import StreamingFilter as RefFilter
from repro.core.filters import preprocess_bank as ref_preprocess
from repro.core.tuner import TuneDecision as RefDecision
from repro.serve.tuning import TuningService as RefService
from repro_torch import mrsim
from repro_torch.core.database import ReferenceDB, SeriesBank, pack_series
from repro_torch.core.filters import StreamingFilter, preprocess_bank
from repro_torch.kernels.dtw import score as tscore
from repro_torch.kernels.dtw import stream as tstream
from repro_torch.serve.tuning import TuningService

DT = 0.25
CHUNK = 8
KW = dict(band=16, threshold=0.85, margin=0.02, stable_ticks=3,
          min_fraction=0.15, denoise=True)
#: In-flight score tolerance (moment rounding only; see module doc).
SCORE_TOL = 1e-4
#: Reference early-decision fractions on the paper scenario
#: (BENCH_streaming.json stream_early_p0..p3).
PAPER_EARLY = (0.44, 0.50, 0.47, 0.75)


def _bank(mod, pack, preprocess, bank_cls, apps):
    series, labels = [], []
    for app in apps:
        for p in mod.paper_param_sets():
            series.append(mod.simulate_cpu_series(app, p, dt=DT))
            labels.append(app)
    b = pack(series, labels=labels)
    return bank_cls(np.asarray(preprocess(b.series, b.lengths)), b.lengths,
                    b.labels, b.entries)


def _banks(apps):
    ref = _bank(rmrsim, ref_pack, ref_preprocess, RefBank, apps)
    port = _bank(mrsim, pack_series, preprocess_bank, SeriesBank, apps)
    return ref, port


def _same_decision(a, b, score_tol):
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    assert a.matched == b.matched
    assert a.decided_at_fraction == b.decided_at_fraction
    assert a.fraction_seen == b.fraction_seen
    assert a.final == b.final
    assert abs(a.corr - b.corr) <= score_tol
    for w in a.scores:
        assert abs(a.scores[w] - b.scores[w]) <= score_tol


def test_golden_traces_decisions_tick_for_tick():
    """All 12 golden jobs multiplexed in one service per package; every
    tick's decisions and every final verdict agree, and the port issues
    exactly one tick launch per tick with data."""
    ref_bank, bank = _banks(tuple(mrsim.APPS))
    np.testing.assert_array_equal(bank.series, ref_bank.series)
    ref = RefService(ref_bank, slots=16, **KW)
    svc = TuningService(bank, slots=16, device="cpu", **KW)
    streams = {}
    for app in mrsim.APPS:
        for j, p in enumerate(mrsim.paper_param_sets()):
            jid = f"{app}-{j}"
            q = mrsim.simulate_cpu_series(app, p, run=1, dt=DT)
            ref.submit(jid, expected_len=len(q))
            svc.submit(jid, expected_len=len(q))
            streams[jid] = mrsim.iter_cpu_series(app, p, run=1,
                                                 chunk=CHUNK, dt=DT)
    data_ticks = 0
    early = 0
    while streams:
        done = []
        for jid, it in streams.items():
            chunk = next(it, None)
            if chunk is None:
                done.append(jid)
            else:
                ref.push(jid, chunk)
                svc.push(jid, chunk)
        if done:
            want = ref.finish_many(done)
            got = svc.finish_many(done)
            for jid in done:
                _same_decision(got[jid], want[jid], 0.0)
                del streams[jid]
        if any(svc._front.has_data(j) for j in svc._jobs):
            data_ticks += 1
        want = ref.tick()
        got = svc.tick()
        assert got.keys() == want.keys()
        for jid in want:
            _same_decision(got[jid], want[jid], SCORE_TOL)
            early += want[jid] is not None
        for jid, job in svc._jobs.items():
            if job.last_sims is not None:
                np.testing.assert_allclose(
                    job.last_sims, ref._jobs[jid].last_sims, atol=SCORE_TOL)
    assert early > 0
    assert svc.dispatch_count == data_ticks == ref.dispatch_count
    assert svc.offline_dispatch_count == ref.offline_dispatch_count


def test_paper_scenario_early_fractions():
    """Exim streamed against a wordcount/terasort bank, one service per
    parameter set: the same early decision at the same fraction as the
    reference (0.44 / 0.50 / 0.47 / 0.75), every final verdict
    wordcount, and one launch per tick."""
    ref_bank, bank = _banks(("wordcount", "terasort"))
    for j, p in enumerate(mrsim.paper_param_sets()):
        ref = RefService(ref_bank, **KW)
        svc = TuningService(bank, device="cpu", **KW)
        q = mrsim.simulate_cpu_series("exim", p, run=1, dt=DT)
        ref.submit("exim", expected_len=len(q))
        svc.submit("exim", expected_len=len(q))
        first = None
        for chunk in mrsim.iter_cpu_series("exim", p, run=1, chunk=CHUNK,
                                           dt=DT):
            ref.push("exim", chunk)
            svc.push("exim", chunk)
            dr = ref.tick().get("exim")
            d = svc.tick().get("exim")
            _same_decision(d, dr, SCORE_TOL)
            first = first or d
        final = svc.finish("exim")
        _same_decision(final, ref.finish("exim"), 0.0)
        assert final.matched == "wordcount"
        assert first is not None and first.matched == "wordcount"
        assert round(first.fraction_seen, 2) == PAPER_EARLY[j]
        assert svc.dispatch_count == svc.ticks


def test_finish_many_equals_sequential_finish():
    """Batched verdicts equal sequential ones exactly, and a batch costs
    one verdict launch."""
    _, bank = _banks(("wordcount", "terasort"))
    rng = np.random.default_rng(1)
    qs = {f"j{i}": np.clip(bank.series[i % len(bank)][:int(n)]
                           + 0.05 * rng.normal(size=int(n)), 0, 1)
          .astype(np.float32)
          for i, n in enumerate(rng.integers(20, 90, 5))}

    def run(batched):
        svc = TuningService(bank, band=16, threshold=0.85, device="cpu")
        for jid, q in qs.items():
            svc.submit(jid, expected_len=len(q))
            svc.push(jid, q)
        svc.tick()
        if batched:
            out = svc.finish_many(list(qs))
        else:
            out = {jid: svc.finish(jid) for jid in qs}
        return out, svc.offline_dispatch_count

    batched, n_batched = run(True)
    seq, n_seq = run(False)
    assert n_batched == 1 and n_seq == len(qs)
    for jid in qs:
        assert batched[jid] == seq[jid]


def test_dispatch_count_counts_ticks_with_data():
    _, bank = _banks(("wordcount", "terasort"))
    svc = TuningService(bank, device="cpu", slots=4)
    svc.submit("a", expected_len=40)
    svc.submit("b", expected_len=40)
    svc.tick()                                    # no data: no launch
    svc.push("a", bank.series[0][:8])
    svc.tick()
    svc.push("a", bank.series[0][8:16])
    svc.push("b", bank.series[1][:5])
    svc.tick()
    svc.tick()
    assert (svc.ticks, svc.dispatch_count) == (4, 2)


def test_reference_db_loads_in_port(tmp_path):
    """A ReferenceDB saved by the reference loads unchanged: entries,
    labels, parameters, configs and decision history, and the packed
    bank."""
    db = RefDB()
    rng = np.random.default_rng(2)
    for i, app in enumerate(("wordcount", "terasort", "wordcount")):
        db.add(app, {"M": i, "R": 2 * i}, rng.random(30 + 5 * i),
               meta={"source": "trace", "workload": "shadow"})
    db.set_best_config("wordcount", {"mappers": 12}, score=0.9)
    db.record_decision(RefDecision(
        workload="job", matched="wordcount", corr=0.93, config=None,
        scores={"wordcount": 0.93, "terasort": 0.2}, fraction_seen=0.4,
        final=False, decided_at_fraction=0.4))
    db.save(str(tmp_path))
    port = ReferenceDB.load(str(tmp_path))
    assert len(port) == len(db)
    for a, b in zip(port.entries, db.entries):
        assert (a.workload, a.params, a.meta) == (b.workload, b.params,
                                                  b.meta)
        np.testing.assert_array_equal(a.series, b.series)
    assert port.best_config("wordcount") == {"mappers": 12}
    assert port.decision_history() == db.decision_history()
    assert port.decided_at_fractions("wordcount") == [0.4]
    pb, rb = port.bank(), db.bank()
    np.testing.assert_array_equal(pb.series, rb.series)
    np.testing.assert_array_equal(pb.lengths, rb.lengths)
    assert pb.labels == rb.labels


@pytest.mark.parametrize("chunks", [(7,), (1, 13, 4), (64,)])
def test_streaming_filter_chunking_invariance(chunks):
    """Any chunking filters like one call, and like the reference's
    filter, bitwise."""
    x = mrsim.simulate_cpu_series("exim", mrsim.paper_param_sets()[2],
                                  dt=DT)[:150]
    whole = StreamingFilter()(x)
    f, ref = StreamingFilter(), RefFilter()
    parts, ref_parts, lo, i = [], [], 0, 0
    while lo < len(x):
        c = chunks[i % len(chunks)]
        parts.append(f(x[lo:lo + c]))
        ref_parts.append(ref(x[lo:lo + c]))
        lo += c
        i += 1
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    np.testing.assert_array_equal(np.concatenate(ref_parts), whole)


def test_port_imports_without_jax():
    """``repro_torch`` (the whole slice) imports with jax and repro made
    unimportable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serve.tuning, repro_torch.mrsim, "
            "repro_torch.core.filters, repro_torch.kernels.iir, "
            "repro_torch.kernels.attention, repro_torch.kernels.gla, "
            "repro_torch.models, repro_torch.configs, "
            "repro_torch.serve.engine, repro_torch.launch.serve; "
            "print('ok')")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    """With no CUDA device, the default (CUDA) entry points raise instead
    of falling back to the CPU."""
    from repro_torch.core import dtw as tdtw
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bank = pack_series([np.linspace(0, 1, 12, dtype=np.float32)] * 2,
                       labels=("a", "b"))
    before = (tstream.LIB.launches, tscore.LIB.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        TuningService(bank)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdtw.dtw_score_bank(bank.series[0], bank.series, bank.lengths)
    with pytest.raises(RuntimeError, match="CUDA"):
        bank.score_plan()
    assert (tstream.LIB.launches, tscore.LIB.launches) == before
    # the model zoo: init, a concrete cache and the CLI's device
    from repro_torch import configs, models
    from repro_torch.kernels.attention import kernel as k9
    from repro_torch.kernels.gla import kernel as k10
    cfg = configs.smoke_config("zamba2-7b")
    before = (k9.LIB.launches, k9.BF16_LIB.launches, k10.LIB.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        models.make_cache(cfg, 1, 8, concrete=True)
    assert (k9.LIB.launches, k9.BF16_LIB.launches,
            k10.LIB.launches) == before


def test_distance_only_rejects_probabilities_and_multitenant_builds():
    """``score_in_flight=False`` with ``min_probability=`` is refused as
    in the reference (the probability rides the scoring tick), and the
    multi-tenant front builds one engine per tenant."""
    from repro_torch.serve.tuning import MultiTenantTuningService
    bank = pack_series([np.linspace(0, 1, 12, dtype=np.float32)] * 2,
                       labels=("a", "b"))
    ref_bank = ref_pack([np.linspace(0, 1, 12, dtype=np.float32)] * 2,
                        labels=("a", "b"))
    for cls, b, kw in ((TuningService, bank, dict(device="cpu")),
                       (RefService, ref_bank, {})):
        with pytest.raises(ValueError, match="score_in_flight=True"):
            cls(b, score_in_flight=False, min_probability=0.5, **kw)
    front = MultiTenantTuningService({"x": bank, "y": bank}, device="cpu",
                                     score_in_flight=False)
    assert front.tenants == ("x", "y")
    assert front.engine("x")._moms is None


def test_distance_only_golden_traces_tick_for_tick():
    """All 12 golden jobs through a distance-only service per package:
    no early decision in either, the same DP rows after every tick
    (bitwise, and bitwise the scored service's rows), one launch per tick
    with data, no moment slab, and final verdicts bitwise the
    reference's (and the scored service's scores)."""
    ref_bank, bank = _banks(tuple(mrsim.APPS))
    ref = RefService(ref_bank, slots=16, score_in_flight=False, **KW)
    svc = TuningService(bank, slots=16, device="cpu", collect_rows=False,
                        **KW)
    scored = TuningService(bank, slots=16, device="cpu", **KW)
    assert svc._moms is None and ref._moms is None
    streams = {}
    for app in mrsim.APPS:
        for j, p in enumerate(mrsim.paper_param_sets()):
            jid = f"{app}-{j}"
            q = mrsim.simulate_cpu_series(app, p, run=1, dt=DT)
            for s in (ref, svc, scored):
                s.submit(jid, expected_len=len(q))
            streams[jid] = mrsim.iter_cpu_series(app, p, run=1,
                                                 chunk=CHUNK, dt=DT)
    before = tstream.DIST_LAUNCHES
    while streams:
        done = []
        for jid, it in streams.items():
            chunk = next(it, None)
            if chunk is None:
                done.append(jid)
            else:
                for s in (ref, svc, scored):
                    s.push(jid, chunk)
        if done:
            want = ref.finish_many(done)
            got = svc.finish_many(done)
            full = scored.finish_many(done)
            for jid in done:
                _same_decision(got[jid], want[jid], 0.0)
                assert (got[jid].matched, got[jid].corr,
                        got[jid].scores) == (full[jid].matched,
                                             full[jid].corr,
                                             full[jid].scores)
                del streams[jid]
        want, got = ref.tick(), svc.tick()
        scored.tick()
        assert got.keys() == want.keys()
        assert all(d is None for d in got.values())
        assert all(d is None for d in want.values())
        rr = np.asarray(ref._rows)
        assert (rr < 1e37).sum() > 0 or not svc._jobs
        np.testing.assert_array_equal(svc._rows.numpy(), rr)
        np.testing.assert_array_equal(svc._rows.numpy(),
                                      scored._rows.numpy())
    assert svc.dispatch_count == ref.dispatch_count == \
        scored.dispatch_count
    assert tstream.DIST_LAUNCHES == before


def test_quarantine_and_eviction_leave_survivors_untouched():
    """A poisoned push quarantines its job, an evicted job frees its
    slot, and the survivor's scores match a run that never saw either."""
    _, bank = _banks(("wordcount", "terasort"))
    q = bank.series[0][:48]

    def run(with_others):
        svc = TuningService(bank, band=16, device="cpu", slots=4)
        svc.submit("keep", expected_len=48)
        if with_others:
            svc.submit("sick", expected_len=48)
            svc.submit("gone", expected_len=48)
        for lo in range(0, 48, 8):
            svc.push("keep", q[lo:lo + 8])
            if with_others:
                bad = q[lo:lo + 8].copy()
                if lo == 16:
                    bad[2] = np.nan
                    with pytest.raises(ValueError):
                        svc.push("sick", bad)
                else:
                    svc.push("sick", bad)
                if lo == 24:
                    svc.evict("gone")
                elif lo < 24:
                    svc.push("gone", q[lo:lo + 8][::-1].copy())
            svc.tick()
        return svc

    clean, noisy = run(False), run(True)
    assert "sick" in noisy.quarantined and noisy.evicted_count == 2
    np.testing.assert_array_equal(noisy._jobs["keep"].last_sims,
                                  clean._jobs["keep"].last_sims)
    assert noisy.finish("keep") == clean.finish("keep")


def test_series_bank_from_numpy_and_device_upload():
    """A packed reference bank crosses over as arrays; its device upload
    is the K-last series and the lengths, memoized per device."""
    from repro_torch.core.database import bank_to_device
    ref = ref_pack([np.linspace(0, 1, n, dtype=np.float32)
                    for n in (9, 16, 12)], labels=("a", "b", "a"))
    bank = SeriesBank.from_numpy(ref.series, ref.lengths, ref.labels)
    np.testing.assert_array_equal(bank.row(0), ref.row(0))
    assert bank.labels == ref.labels
    plan = bank_to_device(bank, "cpu")
    assert plan is bank.score_plan("cpu")
    np.testing.assert_array_equal(plan.bank_t.numpy(), ref.series.T)
    np.testing.assert_array_equal(plan.lengths.numpy(), ref.lengths)
    with pytest.raises(ValueError):
        SeriesBank.from_numpy(ref.series, [9, 17, 12])


def test_trace_log_and_running_moments(tmp_path):
    """The service's trace log journals every accepted chunk (readable
    by the reference's TraceLog too), and RunningMoments correlates like
    the reference's."""
    from repro.core.similarity import RunningMoments as RefMoments
    from repro.serve.ingest import TraceLog as RefTraceLog
    from repro_torch.core.similarity import RunningMoments
    from repro_torch.serve.ingest import TraceLog
    bank = pack_series([np.linspace(0, 1, 12, dtype=np.float32)] * 2,
                       labels=("a", "b"))
    svc = TuningService(bank, device="cpu",
                        trace_log=TraceLog(str(tmp_path), max_segment_bytes=64))
    svc.submit("j", expected_len=20)
    x = np.random.default_rng(4).random(20).astype(np.float32)
    for lo in range(0, 20, 6):
        svc.push("j", x[lo:lo + 6])
        svc.tick()
    svc._front.trace.flush()
    np.testing.assert_array_equal(svc._front.trace.read_job("j"), x)
    np.testing.assert_array_equal(RefTraceLog(str(tmp_path)).read_job("j"),
                                  x)
    y = np.random.default_rng(5).random(20)
    assert RunningMoments().update(x, y).corr == \
        RefMoments().update(x, y).corr
