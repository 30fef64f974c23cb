"""The port's overload control plane against the reference's: the
degradation ladder, QoS admission, the circuit breaker, the retry
deadline, the overload fault streams and rescale-ahead.

Controllers, gates and fault plans are held to the reference class on
the same inputs: the same rungs, routes, sheds, delays and fault
schedules.  Services run the reference's overload scenarios
(tests/test_overload.py) in both packages on the same streams; the
port's early decisions and final verdicts must equal the reference's
(finals bitwise: both verdict scorers do the same arithmetic), and the
reference's own invariants must hold in the port: a ladder rung may
delay a decision, never change it."""

import json
import os

import numpy as np
import pytest

from repro.core.database import pack_series as ref_pack
from repro.runtime.chaos import FaultPlan as RefFaultPlan
from repro.runtime.fault import ElasticController as RefElastic
from repro.runtime.retry import CircuitBreaker as RefBreaker
from repro.runtime.retry import RetryPolicy as RefPolicy
from repro.runtime.retry import call_with_retry as ref_call
from repro.serve import overload as rov
from repro.serve.tuning import TuningService as RefService
from repro_torch.core.database import pack_series
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.runtime.fault import ElasticController
from repro_torch.runtime.retry import (CircuitBreaker, RetryPolicy,
                                       call_with_retry)
from repro_torch.serve import overload as tov
from repro_torch.serve.ingest import BackpressureError
from repro_torch.serve.tuning import TuningService

SEEDS = [int(s) for s in os.environ.get("CHAOS_SEEDS", "5,17").split(",")]


def _series(k=4, seed=2):
    rng = np.random.default_rng(seed)
    return [np.abs(np.cumsum(rng.normal(size=100))).astype(np.float32)
            for _ in range(k)]


def _banks(k=4):
    labels = [f"w{i}" for i in range(k)]
    return (ref_pack(_series(k), labels=labels),
            pack_series(_series(k), labels=labels))


def _streams(n=3, seed=3, length=48):
    r = np.random.default_rng(seed)
    return {f"j{i}": np.abs(np.cumsum(r.normal(size=length)))
            .astype(np.float32) for i in range(n)}


def _keyd(decisions):
    return sorted((j, None if d is None else
                   (d.matched, float(d.corr).hex(), d.final,
                    tuple((k, float(v).hex())
                          for k, v in sorted(d.scores.items()))))
                  for j, d in decisions.items())


def _services(**kw):
    """(reference, port) services on the same bank, the port on the CPU;
    ``kw`` values that are per-package pairs are split."""
    ref_bank, bank = _banks()
    rkw = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    pkw = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    return RefService(ref_bank, **rkw), TuningService(bank, device="cpu",
                                                      **pkw)


def _policies(**kw):
    kw.setdefault("base_delay", 0.0)
    kw.setdefault("sleep", lambda s: None)
    return RefPolicy(**kw), RetryPolicy(**kw)


# ---------------------------------------------------------------------------
# the ladder controller
# ---------------------------------------------------------------------------

def _walk(mod, cfg, lat):
    c = mod.OverloadController(mod.OverloadConfig(**cfg))
    return [c.observe(v) for v in lat], c


@pytest.mark.parametrize("cfg,lat,rungs,history", [
    (dict(target_p99=0.1, patience=2, cooldown=3, window=8), [10.0] * 4,
     [0, 1, 1, 2], [(2, 0, 1), (4, 1, 2)]),
    (dict(target_p99=0.1, patience=1, cooldown=2, window=2),
     [10.0] + [0.0] * 40, None, None),
    (dict(target_p99=0.01, patience=1, max_rung=2), [5.0] * 10, None,
     None),
], ids=["escalate", "deescalate", "max_rung"])
def test_controller_walk_matches_reference(cfg, lat, rungs, history):
    """Escalation after ``patience``, de-escalation after ``cooldown``
    and the ``max_rung`` cap: the port walks the reference's rungs and
    records the reference's history."""
    got, c = _walk(tov, cfg, lat)
    want, rc = _walk(rov, cfg, lat)
    assert got == want and c.rung_history == rc.rung_history
    if rungs is not None:
        assert got == rungs and c.rung_history == history
    if "max_rung" in cfg:
        assert c.rung == cfg["max_rung"]
    if cfg.get("cooldown") == 2:
        assert c.rung == 0 and c.rung_history[-1][2] == 0


def test_derived_knobs_by_rung():
    c = tov.OverloadController(tov.OverloadConfig(cohort_scale=4.0))
    rc = rov.OverloadController(rov.OverloadConfig(cohort_scale=4.0))
    assert tov.RUNGS == rov.RUNGS
    caps = {}
    for r in range(len(tov.RUNGS)):
        c.rung = rc.rung = r
        caps[r] = (c.tick_mode_cap, c.prefilter_divisor, c.cohort_scale)
        assert caps[r] == (rc.tick_mode_cap, rc.prefilter_divisor,
                           rc.cohort_scale)
        assert c.pressure() == rc.pressure()
    assert caps[0] == ("prob", 1, 1.0)
    assert caps[3] == ("distance", 1, 1.0)
    assert caps[4] == ("distance", 2, 1.0)
    assert caps[6] == ("distance", 2, 4.0)


def test_controller_state_crosses_packages():
    """A controller's JSON state loads into the other package's
    controller, and both resume identically."""
    kw = dict(target_p99=0.1, patience=2, cooldown=2, window=4)
    a = tov.OverloadController(tov.OverloadConfig(**kw))
    for v in [10.0, 10.0, 0.0, 10.0, 10.0]:
        a.observe(v)
    st = json.loads(json.dumps(a.state_dict()))
    b = rov.OverloadController(rov.OverloadConfig(**kw))
    b.load_state(st)
    tail = [10.0, 0.0, 0.0, 0.0, 10.0, 10.0]
    assert [a.observe(v) for v in tail] == [b.observe(v) for v in tail]
    assert a.rung_history == b.rung_history
    assert a.state_dict() == b.state_dict()


@pytest.mark.parametrize("bad", [dict(target_p99=0.0), dict(patience=0),
                                 dict(ewma_alpha=0.0), dict(max_rung=7),
                                 dict(cohort_scale=0.5)])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        rov.OverloadConfig(**bad)
    with pytest.raises(ValueError):
        tov.OverloadConfig(**bad)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(bronze=0.9, silver=0.5),
                                 dict(silver=0.99, gold=0.98),
                                 dict(bronze=0.0), dict(cost_scale=0.0)])
def test_admission_policy_validation(bad):
    with pytest.raises(ValueError):
        rov.AdmissionPolicy(**bad)
    with pytest.raises(ValueError):
        tov.AdmissionPolicy(**bad)


def _shed(ctl, qos, **signals):
    try:
        return ctl.admit("j", qos=qos, **signals)
    except (tov.AdmissionShedError, rov.AdmissionShedError) as e:
        return ("shed", e.pressure, e.threshold)


def test_admission_decisions_match_reference_and_gold_last():
    """Every (class, signal) point sheds or admits as in the reference,
    and gold never sheds at a pressure that admits bronze or silver."""
    a, ra = tov.AdmissionController(), rov.AdmissionController()
    for p in np.linspace(0.0, 1.0, 41):
        for sig in (dict(cost_fill=p, queue_fill=0.0, rung_frac=0.0),
                    dict(cost_fill=0.1, queue_fill=p, rung_frac=p / 2)):
            got = {q: _shed(a, q, **sig) for q in ("bronze", "silver",
                                                    "gold")}
            assert got == {q: _shed(ra, q, **sig) for q in got}
            shed = {q: isinstance(v, tuple) for q, v in got.items()}
            assert not (shed["gold"] and not shed["bronze"])
            assert not (shed["silver"] and not shed["bronze"])
    with pytest.raises(ValueError, match="unknown QoS"):
        a.admit("j", qos="platinum", cost_fill=0.0, queue_fill=0.0,
                rung_frac=0.0)


def test_shed_error_carries_context_and_is_backpressure():
    a = tov.AdmissionController(tov.AdmissionPolicy(bronze=0.5))
    with pytest.raises(tov.AdmissionShedError) as ei:
        a.admit("jb", qos="bronze", cost_fill=0.2, queue_fill=0.9,
                rung_frac=0.0)
    e = ei.value
    assert isinstance(e, BackpressureError)
    assert (e.job_id, e.qos) == ("jb", "bronze")
    assert e.pressure == pytest.approx(0.9)
    assert e.threshold == pytest.approx(0.5)
    assert a.pressure(cost_fill=3.0, queue_fill=0.0, rung_frac=0.0) == 1.0


def test_shed_submit_leaves_no_state():
    """A shed submit leaves nothing behind and counts by class, as in the
    reference; lifting the gate admits the same id cleanly."""
    kw = dict(bronze=0.1, silver=0.1, gold=0.1, cost_scale=0.01)
    ref, svc = _services(overload=(rov.OverloadConfig(),
                                   tov.OverloadConfig()),
                         admission=(rov.AdmissionPolicy(**kw),
                                    tov.AdmissionPolicy(**kw)))
    for s, err in ((ref, rov.AdmissionShedError),
                   (svc, tov.AdmissionShedError)):
        with pytest.raises(err):
            s.submit("big", 400, qos="bronze")
        assert s.n_active == 0 and "big" not in s._jobs
        assert s.shed_count == 1 and s.shed_by_class == {"bronze": 1}
        s._admission = None
        s.submit("big", 400, qos="bronze")
        assert s.n_active == 1
    # a small job is admitted by both at the same pressure
    kw2 = dict(cost_scale=4.0)
    ref, svc = _services(admission=(rov.AdmissionPolicy(**kw2),
                                    tov.AdmissionPolicy(**kw2)))
    ref.submit("s", 40, qos="bronze")
    svc.submit("s", 40, qos="bronze")
    assert svc._mean_ref_len == ref._mean_ref_len


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def _breaker_script(br):
    """Walk a breaker through trip, cooldown, probe and re-close; return
    the routes and states seen."""
    out = [br.before_dispatch()]
    br.record_failure()
    out.append(br.state)
    br.record_failure()
    out += [br.state, br.opened_count]
    out += [br.before_dispatch() for _ in range(3)]
    out += [br.state, br.before_dispatch()]
    br.record_success()
    out += [br.state, br.reclosed_count, br.engaged]
    return out


def test_breaker_state_machine_matches_reference():
    kw = dict(fail_threshold=2, cooldown=3, probe_interval=1, seed=0)
    got = _breaker_script(CircuitBreaker(**kw))
    assert got == _breaker_script(RefBreaker(**kw))
    assert got == ["primary", "closed", "open", 1, "fallback", "fallback",
                   "fallback", "half_open", "probe", "closed", 1, False]


def test_breaker_failed_probe_reopens():
    for cls in (CircuitBreaker, RefBreaker):
        br = cls(fail_threshold=1, cooldown=1, probe_interval=1, seed=0)
        br.record_failure()
        br.before_dispatch()
        assert br.before_dispatch() == "probe"
        br.record_failure()
        assert br.state == br.OPEN and br.opened_count == 2


@pytest.mark.parametrize("seed", SEEDS)
def test_breaker_probe_schedule_matches_reference_and_crosses(seed):
    """The seeded probe schedule is the reference's, and a breaker's JSON
    state restored into the other package's breaker resumes it."""
    def routes(br, n):
        out = []
        for _ in range(n):
            r = br.before_dispatch()
            out.append(r)
            if r == "probe":
                br.record_failure()
        return out

    kw = dict(fail_threshold=1, cooldown=2, probe_interval=5)
    a, ra = CircuitBreaker(seed=seed, **kw), RefBreaker(seed=seed, **kw)
    for br in (a, ra):
        br.record_failure()
    assert routes(a, 7) == routes(ra, 7)
    st = json.loads(json.dumps(a.state_dict()))
    b = RefBreaker(seed=seed + 999, **kw)
    b.load_state(st)
    assert routes(a, 30) == routes(b, 30)
    with pytest.raises(ValueError):
        CircuitBreaker(fail_threshold=0)
    with pytest.raises(ValueError):
        CircuitBreaker(cooldown=0)


# ---------------------------------------------------------------------------
# retry deadline
# ---------------------------------------------------------------------------

def _deadline_run(call, policy_cls):
    t = [0.0]
    calls = []

    def fn():
        calls.append("primary")
        raise OSError("transient")

    pol = policy_cls(max_retries=10, base_delay=1.0, jitter=0.0,
                     sleep=lambda d: t.__setitem__(0, t[0] + d))
    out, rep = call(fn, policy=pol, transient=(OSError,),
                    fallback=lambda: "fb", max_elapsed=2.5,
                    clock=lambda: t[0])
    return out, rep, calls, t[0]


def test_retry_deadline_abandons_retries_like_reference():
    got = _deadline_run(call_with_retry, RetryPolicy)
    assert got == _deadline_run(ref_call, RefPolicy)
    assert got[0] == "fb" and got[1]["degraded"]
    assert got[2] == ["primary", "primary"]


@pytest.mark.parametrize("max_elapsed", [None, 1e9])
def test_retry_jitter_stream_matches_reference(max_elapsed):
    """Seeded backoff delays are the reference's, with or without a
    deadline that is never hit."""
    def run(call, cls):
        slept = []
        pol = cls(max_retries=3, base_delay=0.01, seed=7, sleep=slept.append)
        fails = [0]

        def fn():
            if fails[0] < 3:
                fails[0] += 1
                raise OSError("transient")
            return "ok"

        out, rep = call(fn, policy=pol, transient=(OSError,),
                        max_elapsed=max_elapsed)
        return out, rep, slept

    got = run(call_with_retry, RetryPolicy)
    assert got == run(ref_call, RefPolicy)
    assert got[0] == "ok" and got[1]["retries"] == 3


def test_retry_exhaustion_report_matches_reference():
    def fn():
        raise OSError("transient")

    reps = []
    for call, pol in zip((ref_call, call_with_retry),
                         _policies(max_retries=2)):
        reps.append(call(fn, policy=pol, transient=(OSError,),
                         fallback=lambda: "fb", max_elapsed=1e9))
    assert reps[0] == reps[1] == ("fb", {"retries": 3, "degraded": True})


# ---------------------------------------------------------------------------
# ladder downgrades: delayed, never different
# ---------------------------------------------------------------------------

def _drive(svc, streams, hot_ticks):
    for _ in range(hot_ticks):
        svc.tick(latency=10.0)
    for j in streams:
        svc.submit(j, 48)
    earlies = []
    for t in range(6):
        for j, s in streams.items():
            svc.push(j, s[t * 8: (t + 1) * 8])
        for j, d in svc.tick().items():
            if d is not None:
                earlies.append((j, d.matched))
    return earlies, _keyd(svc.finish_many(list(streams))), svc


_PROB = dict(min_probability=0.5, margin=0.01, stable_ticks=1,
             min_fraction=0.1)


@pytest.mark.parametrize("rung,base,hot", [
    (1, _PROB, 3), (1, dict(_PROB, prob_mode="approx"), 3),
    (2, _PROB, 5), (3, {}, 5), (3, _PROB, 5)],
    ids=["approx_prob", "approx_prob-on-approx", "exact_score",
         "distance_only", "distance_only-on-prob"])
def test_ladder_rung_never_changes_a_decision(rung, base, hot):
    """The reference's ``_drive_pair`` in both packages: an unloaded
    service and one pre-heated to ``rung``.  The port's early decisions
    and finals equal the reference's in both runs; under load the finals
    are bitwise the unloaded ones, every early is one the unloaded run
    made, and the degradation markers are the reference's (none for an
    approx service at the approx rung, no earlies at all at rung 3)."""
    streams = _streams()
    cfg = dict(target_p99=0.01, patience=1, cooldown=1000, window=64,
               max_rung=rung)
    runs = {}
    for tag, load in (("golden", False), ("loaded", True)):
        kw = dict(base)
        if load:
            kw["overload"] = (rov.OverloadConfig(**cfg),
                              tov.OverloadConfig(**cfg))
        ref, svc = _services(**kw)
        r = _drive(ref, streams, hot if load else 0)
        p = _drive(svc, streams, hot if load else 0)
        assert p[:2] == r[:2], tag
        assert [j.degraded_level for j in p[2]._jobs.values()] == \
            [j.degraded_level for j in r[2]._jobs.values()]
        runs[tag] = p
    (ge, gf, _), (le, lf, lsvc) = runs["golden"], runs["loaded"]
    assert lsvc.worst_rung == rung and lsvc.overload_ticks > 0
    assert lf == gf
    assert set(le) <= set(ge)
    if rung == 3:
        assert le == []
    if base.get("prob_mode") == "approx":
        assert le == ge


def test_deep_prune_rung_without_prefilter_is_a_distance_tick():
    """Rung 4 is a controller state; with no prefilter a tick there is
    the distance-only tick, as at rung 3: no early decisions, finals
    bitwise the unloaded run's."""
    streams = _streams()
    golden = _drive(TuningService(_banks()[1], device="cpu"), streams, 0)
    svc = TuningService(_banks()[1], device="cpu",
                        overload=tov.OverloadConfig(
                            target_p99=0.01, patience=1, cooldown=1000,
                            max_rung=4))
    earlies, finals, _ = _drive(svc, streams, 8)
    assert svc.rung == 4 and svc._overload.prefilter_divisor == 2
    assert svc._tick_mode() == "distance"
    assert earlies == [] and finals == golden[1]


def test_slow_cohorts_rung_stretches_tick_rates():
    cfg = dict(target_p99=0.01, patience=1, cooldown=1000, max_rung=5,
               cohort_scale=8.0)
    ref, svc = _services(overload=(rov.OverloadConfig(**cfg),
                                   tov.OverloadConfig(**cfg)))
    for s in (ref, svc):
        s.submit("a", 48, tick_hz=10.0)
        for _ in range(10):
            s.tick(now=0.0, latency=10.0)
        assert s.rung == 5
        s.tick(now=0.1, latency=10.0)
    assert svc._sched.cohorts._next_due[10.0] == pytest.approx(0.9)
    assert svc._sched.cohorts._next_due == ref._sched.cohorts._next_due


# ---------------------------------------------------------------------------
# the golden overload test and the breaker's fault burst
# ---------------------------------------------------------------------------

def _golden(svc, streams):
    for j in streams:
        svc.submit(j, 48)
    earlies = []
    for t in range(6):
        for j, s in streams.items():
            svc.push(j, s[t * 8: (t + 1) * 8])
        for j, d in svc.tick().items():
            if d is not None:
                earlies.append((j, d.matched))
    return earlies, _keyd(svc.finish_many(list(streams)))


def _spike_run(svc, plan, streams, seed):
    """The reference's seeded 10x spike with slow-dispatch chaos; every
    observed latency carries plan.slow_extra, so the climb does not
    depend on the host's speed (the walk back down does: the measured
    part of each latency decays through the EWMA)."""
    for j in streams:
        svc.submit(j, 48, qos="gold")
    spike_rng = np.random.default_rng((seed, 8))
    earlies, sheds = [], []
    for t in range(6):
        mult = plan.spike_multiplier()
        for i in range(int(mult) - 1):
            try:
                svc.submit(f"spike{t}_{i}", 48, qos="bronze")
            except RuntimeError as e:       # shed, or out of slots
                sheds.append(type(e).__name__)
        for j, s in streams.items():
            svc.push(j, s[t * 8: (t + 1) * 8])
        for jid in list(svc._jobs):
            if jid.startswith("spike"):
                svc.push(jid, np.abs(spike_rng.normal(size=4))
                         .astype(np.float32))
        for j, d in svc.tick().items():
            if d is not None and not j.startswith("spike"):
                earlies.append((j, d.matched))
    finals = _keyd(svc.finish_many(list(streams)))
    svc.chaos = None
    for _ in range(40):
        svc.tick(latency=0.0)
        if svc.rung == 0:
            break
    return earlies, finals, sheds, list(svc.rung_history), svc


@pytest.mark.parametrize("seed", SEEDS)
def test_golden_overload_spike_matches_reference(seed):
    """Under the seeded spike the port climbs the reference's rungs,
    sheds the same spike jobs, emits the reference's decisions (a subset
    of the unloaded run's earlies, finals bitwise), and after the burst
    walks back to rung 0 with ``degraded`` cleared."""
    streams = _streams()
    g_earlies, g_finals = _golden(TuningService(_banks()[1], device="cpu",
                                                queue_limit=64), streams)
    out = []
    for fp, ov, adm, pack_i in ((RefFaultPlan, rov, rov, 0),
                                (FaultPlan, tov, tov, 1)):
        plan = fp(seed=seed, slow_rate=1.0, slow_extra=10.0,
                  spike_rate=0.5, spike_factor=10.0, spike_len=2)
        bank = _banks()[pack_i]
        kw = dict(queue_limit=64, slots=64,
                  overload=ov.OverloadConfig(target_p99=0.2, patience=1,
                                             cooldown=2, window=4),
                  admission=adm.AdmissionPolicy(), chaos=plan)
        svc = RefService(bank, **kw) if pack_i == 0 else \
            TuningService(bank, device="cpu", **kw)
        out.append(_spike_run(svc, plan, streams, seed) + (plan,))
    ref, port = out
    assert port[:3] == ref[:3]

    def climb(history):
        return [h for h in history if h[2] > h[1]]
    assert climb(port[3]) == climb(ref[3])
    earlies, finals, _, history, svc, plan = port
    assert svc.worst_rung >= 1 and len(history) >= 1
    assert plan.spiked_beats >= 1 and plan.slowed_dispatches >= 1
    assert set(earlies) <= set(g_earlies)
    assert finals == g_finals
    assert svc.rung == 0 and not svc.degraded and history[-1][2] == 0
    assert svc.shed_by_class == ref[4].shed_by_class


@pytest.mark.parametrize("seed", SEEDS)
def test_breaker_rides_fault_burst_then_recloses(seed):
    """A persistent fault burst trips the breaker OPEN and the plain
    version serves; when the burst ends the seeded probe re-closes it.
    The port's breaker walk and counters are the reference's, and its
    finals are bitwise the fault-free run's."""
    streams = _streams()
    g_finals = _golden(TuningService(_banks()[1], device="cpu",
                                     queue_limit=64), streams)[1]
    walks = []
    for pack_i, (bcls, fcls) in enumerate(((RefBreaker, RefFaultPlan),
                                           (CircuitBreaker, FaultPlan))):
        br = bcls(fail_threshold=2, cooldown=2, probe_interval=2,
                  seed=seed)
        pol = _policies(max_retries=1, seed=seed)[pack_i]
        kw = dict(queue_limit=64, retry_policy=pol, breaker=br,
                  chaos=fcls(seed=seed, dispatch_fail_rate=1.0))
        bank = _banks()[pack_i]
        svc = RefService(bank, **kw) if pack_i == 0 else \
            TuningService(bank, device="cpu", **kw)
        for j in streams:
            svc.submit(j, 48)
        walk = []
        for t in range(6):
            if t == 3:
                walk.append((br.state, svc.degraded,
                             svc.degraded_dispatch_count))
                svc.chaos = None
            for j, s in streams.items():
                svc.push(j, s[t * 8: (t + 1) * 8])
            svc.tick()
        walk += [br.state, br.reclosed_count, svc.degraded,
                 svc.retry_count, _keyd(svc.finish_many(list(streams)))]
        walks.append(walk)
    assert walks[1] == walks[0]
    assert walks[1][0][0] == "open" and walks[1][0][1]
    assert walks[1][0][2] >= 2
    assert walks[1][1] == "closed" and walks[1][2] >= 1
    assert not walks[1][3]
    assert walks[1][-1] == g_finals


def test_overload_pressure_feeds_rescale_ahead():
    cfg = dict(target_p99=0.01, patience=1, cooldown=1000)
    ref, svc = _services(overload=(rov.OverloadConfig(**cfg),
                                   tov.OverloadConfig(**cfg)))
    ec, rec = ElasticController(model_parallel=1), \
        RefElastic(model_parallel=1)
    assert svc.overload_pressure() == ref.overload_pressure()
    calm = ec.decide_ahead(2, range(8),
                           overload_pressure=svc.overload_pressure())
    assert calm.new_data_parallel <= 2
    for _ in range(10):
        svc.tick(latency=10.0)
        ref.tick(latency=10.0)
    assert svc.overload_pressure() == ref.overload_pressure()
    hot = ec.decide_ahead(2, range(8),
                          overload_pressure=svc.overload_pressure())
    assert hot.should_rescale and hot.new_data_parallel == 4
    assert "grow-ahead" in hot.reason
    assert hot.__dict__ == rec.decide_ahead(
        2, range(8), overload_pressure=ref.overload_pressure()).__dict__


@pytest.mark.parametrize("args,kw", [
    ((4, range(6)), dict(overload_pressure=1.0)),
    ((8, range(8)), dict(overload_pressure=0.0)),
    ((2, range(8)), dict(overload_pressure=0.0)),
    ((4, range(3), ()), dict(overload_pressure=0.5)),
    ((4, range(8), (1, 2, 3, 4)), dict(overload_pressure=0.5)),
], ids=["grow-capped", "shrink-idle", "floor", "mid-defers", "stragglers"])
def test_decide_ahead_matches_reference(args, kw):
    ec = ElasticController(model_parallel=1, min_data_parallel=2)
    rec = RefElastic(model_parallel=1, min_data_parallel=2)
    d = ec.decide_ahead(*args, **kw)
    assert d.__dict__ == rec.decide_ahead(*args, **kw).__dict__
    if kw["overload_pressure"] == 0.5:
        assert d == ec.decide(*args)
    with pytest.raises(ValueError):
        ec.decide_ahead(1, range(2), overload_pressure=0.5,
                        grow_threshold=0.2, shrink_threshold=0.4)


# ---------------------------------------------------------------------------
# overload fault classes (chaos plan)
# ---------------------------------------------------------------------------

def _fault_trace(plan, n=40):
    return ([plan.spike_multiplier() for _ in range(n)],
            [plan.slow_dispatch() for _ in range(n)],
            [plan.queue_burst() for _ in range(n)],
            plan.spiked_beats, plan.slowed_dispatches, plan.queue_bursts)


@pytest.mark.parametrize("seed", SEEDS)
def test_overload_fault_streams_match_reference_and_are_independent(seed):
    """The same seed gives the reference's spike, slow-dispatch and
    queue-burst schedules; enabling dispatch faults does not shift
    them."""
    kw = dict(spike_rate=0.3, spike_factor=10.0, spike_len=2,
              slow_rate=0.3, slow_extra=0.5, queue_burst_rate=0.3)
    a = _fault_trace(FaultPlan(seed=seed, **kw))
    assert a == _fault_trace(RefFaultPlan(seed=seed, **kw))
    assert a == _fault_trace(FaultPlan(seed=seed, dispatch_fail_rate=0.9,
                                       **kw))


def test_spike_slow_and_burst_windows():
    plan = FaultPlan(seed=1, spike_rate=1.0, spike_factor=7.0, spike_len=3)
    assert [plan.spike_multiplier() for _ in range(6)] == [7.0] * 6
    assert [FaultPlan(seed=1).spike_multiplier() for _ in range(4)] == \
        [1.0] * 4
    slow = FaultPlan(seed=2, slow_rate=1.0, slow_extra=123.0)
    assert [slow.slow_dispatch() for _ in range(10)] == [123.0] * 10
    burst = FaultPlan(seed=3, queue_burst_rate=1.0, queue_burst_len=2)
    assert all(burst.queue_burst() for _ in range(6))
    assert not FaultPlan(seed=3).queue_burst()
