"""The port's probabilistic ``TuningService`` (``min_probability=``,
``prob_mode="exact"|"approx"``) against the reference's, on the golden
traces of tests/test_uncertain_matching.py: every mrsim app at the first
paper parameter set, streamed in 16-sample chunks against a 3-app bank.

Both services run the same DP on the same inputs: scores are held to
SCORE_TOL = 1e-4 (the reference rebuilds a horizontal cell's moment base
as m - pair, the port carries it; the same tolerance as the point
service's tests; observed <= 4.2e-6) and match probabilities to
PROB_TOL = 1e-4 (those moment roundings, and the tail's own rounding
differences, seen through the probability's slope; observed <= 1.1e-5).
Decisions — matched workload, early fraction and the gate's outcome —
must be identical tick for tick.  Final
verdicts go through scorers with identical DP arithmetic: scores
bitwise, probabilities within 2e-6 (the tails' rounding, see
tests/test_torch_prob_score.py)."""

import numpy as np
import pytest

from repro.core.database import pack_series as ref_pack
from repro.core.filters import preprocess as ref_preprocess
from repro.mrsim import simulate_cpu_series_uncertain as ref_uncertain
from repro.serve.ingest import TraceLog as RefTraceLog
from repro.serve.tuning import TuningService as RefService
from repro_torch.core.database import pack_series
from repro_torch.core.filters import preprocess
from repro_torch.kernels.dtw import score as tscore
from repro_torch.kernels.dtw import stream as tstream
from repro_torch.mrsim import (APPS, paper_param_sets, simulate_cpu_series,
                               simulate_cpu_series_uncertain)
from repro_torch.serve.ingest import (IngestFront, PoisonedSampleError,
                                      TraceLog)
from repro_torch.serve.tuning import TuningService

PS = paper_param_sets()[0]
SCORE_TOL = 1e-4
PROB_TOL = 1e-4
VERDICT_PROB_TOL = 2e-6
HET_KW = dict(band=16, threshold=0.7, denoise=True, stable_ticks=2,
              min_fraction=0.1, margin=0.01)


@pytest.fixture(scope="module")
def banks():
    series = [np.asarray(preprocess(simulate_cpu_series(a, PS, run=1)))
              for a in APPS]
    ref = ref_pack([np.asarray(ref_preprocess(s)) for s in
                    (simulate_cpu_series(a, PS, run=1) for a in APPS)],
                   labels=list(APPS))
    port = pack_series(series, labels=list(APPS))
    np.testing.assert_array_equal(port.series, ref.series)
    return ref, port


def _stream(svc, q, v=None, chunk=16):
    """Push q (and v) through svc chunk by chunk -> (per-tick trace of
    (scores, probs, decision), final verdict)."""
    svc.submit("j", expected_len=q.shape[0])
    trace = []
    for lo in range(0, q.shape[0], chunk):
        if v is None:
            svc.push("j", q[lo:lo + chunk])
        else:
            svc.push("j", q[lo:lo + chunk], variance=v[lo:lo + chunk])
        d = svc.tick().get("j")
        job = svc._jobs["j"]
        trace.append((job.last_sims.copy(),
                      None if job.last_probs is None
                      else job.last_probs.copy(), d))
    return trace, svc.finish("j")


def _same_decision(a, b, prob_tol):
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    assert a.matched == b.matched
    assert a.decided_at_fraction == b.decided_at_fraction
    assert abs(a.corr - b.corr) <= SCORE_TOL
    assert (a.probability is None) == (b.probability is None)
    if a.probability is not None:
        assert abs(a.probability - b.probability) <= prob_tol


@pytest.mark.parametrize("app", list(APPS))
def test_zero_variance_reduces_bitwise_to_point_service(banks, app):
    """A probabilistic service (either tail) fed zero variance equals the
    port's point service tick for tick: identical score rows, identical
    decisions, probabilities exactly 1{score >= threshold}; and it
    decides as the reference's probabilistic service does."""
    ref_bank, bank = banks
    q = simulate_cpu_series(app, PS, run=2)
    z = np.zeros_like(q)
    kw = dict(band=16, threshold=0.8, denoise=False)
    tp, fp = _stream(TuningService(bank, device="cpu", **kw), q)
    tr, fr = _stream(RefService(ref_bank, min_probability=0.5, **kw), q, z)
    for mode in ("exact", "approx"):
        tb, fb = _stream(TuningService(bank, min_probability=0.5,
                                       prob_mode=mode, device="cpu", **kw),
                         q, z)
        assert len(tp) == len(tb) == len(tr) > 0
        for (sa, _, da), (sb, pb, db), (_, prr, dr) in zip(tp, tb, tr):
            np.testing.assert_array_equal(sa, sb)
            assert set(np.unique(pb)) <= {0.0, 1.0}
            np.testing.assert_array_equal(pb == 1.0, sb >= 0.8)
            np.testing.assert_array_equal(pb, prr)
            assert (da is None) == (db is None)
            if da is not None:
                assert (da.matched, da.corr, da.decided_at_fraction) == \
                    (db.matched, db.corr, db.decided_at_fraction)
                assert db.probability == 1.0
            _same_decision(db, dr, 0.0)
        assert fp.matched == fb.matched and fp.corr == fb.corr
        assert fb.probability in (0.0, 1.0)
        assert (fb.probability == 1.0) == (fp.corr >= 0.8)
        assert fp.probability is None
        _same_decision(fb, fr, 0.0)


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_heteroscedastic_decisions_tick_for_tick(banks, mode):
    """Golden heteroscedastic traces (every app, runs 3-5, noise 0.12, the
    true per-sample variances pushed): the port decides as the reference
    on every tick — matched workload, fraction and probability gate —
    with scores and probabilities within tolerance; final verdicts
    agree, their probabilities within VERDICT_PROB_TOL."""
    ref_bank, bank = banks
    decided = 0
    for app in APPS:
        for run in (3, 4, 5):
            q, v = simulate_cpu_series_uncertain(app, PS, run=run,
                                                 noise=0.12)
            rq, rv = ref_uncertain(app, PS, run=run, noise=0.12)
            np.testing.assert_array_equal(q, rq)
            np.testing.assert_array_equal(v, rv)
            tr, fr = _stream(RefService(ref_bank, min_probability=0.6,
                                        prob_mode=mode, **HET_KW), q, v)
            tp, fp = _stream(TuningService(bank, min_probability=0.6,
                                           prob_mode=mode, device="cpu",
                                           **HET_KW), q, v)
            assert len(tr) == len(tp) > 0
            for (sr, pr, dr), (sp, pp, dp) in zip(tr, tp):
                np.testing.assert_allclose(sp, sr, atol=SCORE_TOL)
                np.testing.assert_allclose(pp, pr, atol=PROB_TOL)
                _same_decision(dp, dr, PROB_TOL)
                decided += dp is not None
            _same_decision(fp, fr, VERDICT_PROB_TOL)
            assert fp.corr == fr.corr
    assert decided > 0


def test_approx_calibration_band_and_gate_agreement(banks):
    """The reference's calibration contract held by the port: in-flight
    approx probabilities within 0.2 of the exact tail's, the gate agrees
    wherever the exact probability clears the band, no additional wrong
    early decision, and final verdicts bitwise the exact service's."""
    _, bank = banks
    band, gate = 0.2, 0.6
    kw = dict(HET_KW, min_probability=gate)
    wrong_exact = wrong_approx = ticks = 0
    for app in APPS:
        for run in (3, 4):
            q, v = simulate_cpu_series_uncertain(app, PS, run=run,
                                                 noise=0.12)
            te, fe = _stream(TuningService(bank, device="cpu", **kw), q, v)
            ta, fa = _stream(TuningService(bank, prob_mode="approx",
                                           device="cpu", **kw), q, v)
            for (se, pe, _), (sa, pa, _) in zip(te, ta):
                np.testing.assert_array_equal(sa, se)
                assert np.abs(pa - pe).max() <= band
                clear = np.abs(pe - gate) > band
                np.testing.assert_array_equal((pa >= gate)[clear],
                                              (pe >= gate)[clear])
                ticks += 1
            ee = next((t[2] for t in te if t[2] is not None), None)
            ea = next((t[2] for t in ta if t[2] is not None), None)
            wrong_exact += ee is not None and ee.matched != app
            wrong_approx += ea is not None and ea.matched != app
            assert (fa.matched, fa.corr, fa.probability) == \
                (fe.matched, fe.corr, fe.probability)
    assert wrong_approx <= wrong_exact
    assert ticks > 0


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_constant_trace_scores_zero_and_abstains(banks, mode):
    """A constant query: score 0.0 (never NaN) and no commitment, with
    zero and with non-zero claimed variance; the probability is exactly
    0.0 at zero variance and finite, below the gate, otherwise."""
    _, bank = banks
    qc = np.full(200, 0.5, np.float32)
    for var in (0.0, 0.01):
        trace, final = _stream(
            TuningService(bank, band=16, threshold=0.7, denoise=False,
                          min_probability=0.5, prob_mode=mode,
                          device="cpu"),
            qc, np.full_like(qc, var))
        assert all(d is None for _, _, d in trace)
        assert all(np.isfinite(p).all() for _, p, _ in trace)
        assert final.matched is None
        assert final.corr == 0.0
        assert np.isfinite(final.probability)
        assert final.probability < 0.5
        assert (final.probability == 0.0) == (var == 0.0)


@pytest.mark.parametrize("kw", [
    dict(min_probability=0.5, prob_mode="bogus"), dict(prob_mode="approx"),
    dict(min_probability=0.0), dict(min_probability=1.5)])
def test_prob_mode_validation_matches_reference(banks, kw):
    """The port refuses what the reference refuses, with its message."""
    ref_bank, bank = banks
    with pytest.raises(ValueError) as want:
        RefService(ref_bank, **kw)
    with pytest.raises(ValueError) as got:
        TuningService(bank, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_verdict_probabilities_independent_of_prob_mode(banks):
    """finish_many always scores through the exact six-channel tail:
    verdicts of exact and approx services are bitwise equal, batched
    verdicts equal sequential ones, and a batch costs one verdict
    launch."""
    _, bank = banks
    jobs = {f"{a}-{r}": simulate_cpu_series_uncertain(a, PS, run=r,
                                                      noise=0.12)
            for a in APPS for r in (3, 4)}

    def run(mode, batched):
        svc = TuningService(bank, min_probability=0.6, prob_mode=mode,
                            device="cpu", **HET_KW)
        for jid, (q, v) in jobs.items():
            svc.submit(jid, expected_len=len(q))
            svc.push(jid, q[:20], variance=v[:20])
        svc.tick()
        for jid, (q, v) in jobs.items():
            svc.push(jid, q[20:], variance=v[20:])
        out = svc.finish_many(list(jobs)) if batched \
            else {jid: svc.finish(jid) for jid in jobs}
        return out, svc.offline_dispatch_count

    exact, n_exact = run("exact", True)
    approx, _ = run("approx", True)
    seq, n_seq = run("approx", False)
    assert n_exact == 1 and n_seq == len(jobs)
    for jid in jobs:
        assert exact[jid] == approx[jid] == seq[jid]
        assert exact[jid].probability is not None


def test_variance_poison_checks_and_quarantine(banks):
    """Variance pushes are checked before anything is enqueued: a length
    mismatch is refused (ValueError), negative and non-finite variances
    quarantine the job; the survivor's scores and probabilities equal a
    run that never saw the sick jobs.  A point-mode front refuses
    variances outright."""
    _, bank = banks
    q, v = simulate_cpu_series_uncertain("exim", PS, run=3, noise=0.12)

    def run(with_sick):
        svc = TuningService(bank, min_probability=0.6, device="cpu",
                            slots=4, **HET_KW)
        svc.submit("keep", expected_len=len(q))
        if with_sick:
            for jid in ("neg", "nan"):
                svc.submit(jid, expected_len=len(q))
            with pytest.raises(ValueError, match="variances"):
                svc.push("neg", q[:8], variance=v[:7])
            with pytest.raises(PoisonedSampleError, match=">= 0"):
                svc.push("neg", q[:8], variance=-v[:8])
            bad = v[:8].copy()
            bad[3] = np.inf
            with pytest.raises(PoisonedSampleError, match="non-finite"):
                svc.push("nan", q[:8], variance=bad)
            svc.push("nan", q[:8], variance=v[:8])        # swallowed
        for lo in range(0, len(q), 8):
            svc.push("keep", q[lo:lo + 8], variance=v[lo:lo + 8])
            svc.tick()
        return svc

    clean, sick = run(False), run(True)
    assert set(sick.quarantined) == {"neg", "nan"}
    assert sick.quarantine_dropped == 1
    for attr in ("last_sims", "last_probs"):
        np.testing.assert_array_equal(getattr(sick._jobs["keep"], attr),
                                      getattr(clean._jobs["keep"], attr))
    assert sick.finish("keep") == clean.finish("keep")
    point = TuningService(bank, device="cpu")
    point.submit("j", expected_len=10)
    with pytest.raises(ValueError, match="track_variance"):
        point.push("j", q[:4], variance=v[:4])


def test_ingest_default_variances_and_trace_journal(tmp_path):
    """Unsupplied variances default to the squared causal-filter residual
    with ``denoise`` and to 0 without; supplied ones pass through; the
    trace log journals the variance row (NaN where defaulted), readable
    by the reference's TraceLog, as the reference's front does."""
    from repro.serve.ingest import IngestFront as RefFront
    x = np.random.default_rng(6).random(24).astype(np.float32)
    v = np.full(8, 0.25, np.float32)
    for denoise in (True, False):
        path = tmp_path / f"d{int(denoise)}"
        fronts = (IngestFront(denoise=denoise, track_variance=True,
                              trace=TraceLog(str(path))),
                  RefFront(denoise=denoise, track_variance=True))
        outs = []
        for f in fronts:
            f.register("j")
            f.push("j", x[:8])
            f.push("j", x[8:16], variance=v)
            f.push("j", x[16:])
            outs.append(f.drain("j", with_variance=True))
        (ch, vch), (rch, rvch) = outs
        np.testing.assert_array_equal(ch, rch)
        np.testing.assert_array_equal(vch, rvch)
        np.testing.assert_array_equal(vch[8:16], v)
        if denoise:
            np.testing.assert_array_equal(vch[:8], (x[:8] - ch[:8]) ** 2)
        else:
            assert not vch[:8].any() and not vch[16:].any()
        assert fronts[0].drain("j", with_variance=True) == (None, None)
        fronts[0].trace.flush()
        recs = RefTraceLog(str(path)).records()
        assert [r[2]["job_id"] for r in recs] == ["j"] * 3
        np.testing.assert_array_equal(recs[1][2]["variance"], v)
        assert np.isnan(recs[0][2]["variance"]).all()
    point = IngestFront()
    point.register("j")
    with pytest.raises(ValueError, match="track_variance"):
        point.drain("j", with_variance=True)


def test_slot_churn_carries_variance_state(banks):
    """Elastic slots (grow, compact-shrink, lazy resets) move the
    variance folds with the slab: decisions, scores and probabilities
    equal a fixed-slot run bitwise, and the probabilistic ticks launch no
    kernel on CPU tensors."""
    _, bank = banks
    traces = {f"{a}-{r}": simulate_cpu_series_uncertain(a, PS, run=r,
                                                        noise=0.12)
              for a in APPS for r in (3, 4)}
    before = (dict(tstream.VAR_LAUNCHES), dict(tscore.VAR_LAUNCHES),
              tstream.LIB.launches, tscore.LIB.launches)

    def run(elastic):
        svc = TuningService(bank, min_probability=0.6, prob_mode="approx",
                            slots=8, elastic_slots=elastic, device="cpu",
                            **HET_KW)
        log, pos = [], {}

        def submit(jid):
            svc.submit(jid, expected_len=len(traces[jid.split("/")[0]][0]))
            pos[jid] = 0

        for jid in traces:                  # six jobs: grow to 8 slots
            submit(jid)
        for step in range(5):
            for jid in list(pos):
                q, v = traces[jid.split("/")[0]]
                lo = pos[jid]
                if lo < len(q):
                    svc.push(jid, q[lo:lo + 8], variance=v[lo:lo + 8])
                    pos[jid] = lo + 8
            log.append(sorted((k, str(d)) for k, d in svc.tick().items()))
            if step == 1:                   # four leave: shrink to 4
                for jid in list(pos)[:4]:
                    log.append((jid, str(svc.finish(jid))))
                    del pos[jid]
            if step == 2:                   # a reused slot is reset
                submit(next(iter(traces)) + "/again")
        for jid in list(pos):
            log.append((jid, str(svc.finish(jid))))
        return log, svc.slot_repack_count

    fixed, _ = run(False)
    elastic, repacks = run(True)
    assert repacks > 0
    assert fixed == elastic
    assert (dict(tstream.VAR_LAUNCHES), dict(tscore.VAR_LAUNCHES),
            tstream.LIB.launches, tscore.LIB.launches) == before
