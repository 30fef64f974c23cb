"""The port's chaos harness and resilient dispatch against the
reference's: retry, exhaustion to the fallback,
non-transient errors, injected failures never changing decisions,
corruption quarantining through ``push``, and clock skew.

The fault plan's per-class streams are the reference's for the same
seed, and the retry wrapper makes the reference's attempts and sleeps.
Service runs are held two ways: against the port's own fault-free run
bitwise (the reference's invariant: faults move counters, never
decisions), and against the reference's run on the same streams — the
same decisions, the same counters, in-flight scores within SCORE_TOL
(the two DPs round the moments differently, tests/test_torch_service.py)
and final verdicts bitwise."""

import os

import numpy as np
import pytest

from repro.core.database import pack_series as ref_pack
from repro.runtime.chaos import FaultPlan as RefFaultPlan
from repro.runtime.retry import RetryPolicy as RefPolicy
from repro.runtime.retry import call_with_retry as ref_call
from repro.serve.tuning import TuningService as RefService
from repro_torch.core.database import pack_series
from repro_torch.kernels.common import KernelLaunchError
from repro_torch.runtime.retry import CircuitBreaker
from repro_torch.runtime.chaos import (FaultPlan, InjectedDispatchError,
                                       truncate_file)
from repro_torch.runtime.retry import (DispatchFailure, RetryPolicy,
                                       call_with_retry)
from repro_torch.serve import tuning as ttuning
from repro_torch.serve.ingest import PoisonedSampleError
from repro_torch.serve.tuning import TuningService

SEEDS = [int(s) for s in os.environ.get("CHAOS_SEEDS", "5,17").split(",")]
#: In-flight score tolerance between the packages (moment rounding).
SCORE_TOL = 1e-4


def _series(k=4, seed=2):
    rng = np.random.default_rng(seed)
    return [np.abs(np.cumsum(rng.normal(size=100))).astype(np.float32)
            for _ in range(k)]


def _bank(ref=False):
    pack = ref_pack if ref else pack_series
    return pack(_series(), labels=[f"w{i}" for i in range(4)])


def _keyd(decisions):
    return sorted((j, None if d is None else
                   (d.matched, float(d.corr).hex(), d.final,
                    tuple((k, float(v).hex())
                          for k, v in sorted(d.scores.items()))))
                  for j, d in decisions.items())


def _drive(svc, poison=None):
    """The reference's fixed schedule; poisons one chunk of j1 when
    ``poison`` is set.  Returns per tick the decisions keyed with
    float-hex scores, then the finals."""
    outs = []
    r = np.random.default_rng(3)
    streams = {f"j{i}": np.abs(np.cumsum(r.normal(size=48)))
               .astype(np.float32) for i in range(3)}
    for j in streams:
        svc.submit(j, 48)
    for t in range(6):
        for j, s in streams.items():
            if j in svc.quarantined:
                continue
            x = s[t * 8: (t + 1) * 8]
            if poison == (j, t):
                x = x.copy()
                x[3] = np.nan
                with pytest.raises(ValueError):
                    svc.push(j, x)
                continue
            svc.push(j, x)
        outs.append(_keyd(svc.tick()))
    outs.append(_keyd(svc.finish_many(
        [j for j in streams if j not in svc.quarantined])))
    return outs


def _same_as_reference(port, ref):
    """Tick for tick the same jobs and decisions (matched, final), scores
    within SCORE_TOL; finals bitwise."""
    assert len(port) == len(ref)
    for got, want in zip(port[:-1], ref[:-1]):
        assert [g[0] for g in got] == [w[0] for w in want]
        for (_, g), (_, w) in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g[0] == w[0] and g[2] == w[2]
                assert abs(float.fromhex(g[1]) - float.fromhex(w[1])) \
                    <= SCORE_TOL
    assert port[-1] == ref[-1]


def _policy(cls=RetryPolicy, **kw):
    kw.setdefault("base_delay", 0.0)
    kw.setdefault("sleep", lambda s: None)
    return cls(**kw)


# ---------------------------------------------------------------------------
# retry / fallback wrapper
# ---------------------------------------------------------------------------

def _flaky(fail_first, exc=InjectedDispatchError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fail_first:
            raise exc("boom")
        return 42
    return fn, calls


@pytest.mark.parametrize("fail_first,retries,fallback,want", [
    (2, 3, False, (42, {"retries": 2, "degraded": False})),
    (99, 2, True, ("degraded-result", {"retries": 3, "degraded": True})),
    (99, 1, False, DispatchFailure),
], ids=["succeeds", "falls-back", "exhausted-raises"])
def test_retry_outcomes_match_reference(fail_first, retries, fallback, want):
    """Retry success, exhaustion to the fallback, exhaustion without one:
    the same results, reports and attempt counts as the reference."""
    got = []
    for call, cls, err in ((call_with_retry, RetryPolicy,
                            InjectedDispatchError),
                           (ref_call, RefPolicy, InjectedDispatchError)):
        fn, calls = _flaky(fail_first)
        kw = dict(policy=_policy(cls, max_retries=retries),
                  transient=(err,))
        if fallback:
            kw["fallback"] = lambda: "degraded-result"
        if want is DispatchFailure:
            with pytest.raises(RuntimeError, match="dispatch failed"):
                call(fn, **kw)
            got.append(calls["n"])
        else:
            got.append((call(fn, **kw), calls["n"]))
    assert got[0] == got[1]
    if want is not DispatchFailure:
        assert got[0][0] == want


def test_non_transient_errors_propagate_immediately():
    fn, calls = _flaky(99, exc=TypeError)
    with pytest.raises(TypeError):
        call_with_retry(fn, policy=_policy(max_retries=5),
                        transient=(InjectedDispatchError,))
    assert calls["n"] == 1


def test_backoff_delays_match_reference():
    kw = dict(max_retries=8, base_delay=0.1, max_delay=1.0, jitter=0.5,
              seed=3, sleep=lambda s: None)
    p, rp = RetryPolicy(**kw), RefPolicy(**kw)
    delays = [p.delay(a) for a in range(8)]
    assert delays == [rp.delay(a) for a in range(8)]
    flat = RetryPolicy(**dict(kw, jitter=0.0))
    d0 = [flat.delay(a) for a in range(8)]
    assert d0[0] == pytest.approx(0.1) and d0 == sorted(d0)
    assert max(d0) <= 1.0


# ---------------------------------------------------------------------------
# fault plan determinism
# ---------------------------------------------------------------------------

def _dispatch_schedule(plan, n=50, noise=False):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        if noise:
            plan.corrupt(rng.normal(size=4).astype(np.float32))
            plan.skew(1.0)
        try:
            plan.on_dispatch()
            out.append(0)
        except RuntimeError:
            out.append(1)
    return out


@pytest.mark.parametrize("burst", [1, 3])
def test_fault_plan_schedule_matches_reference(burst):
    """The same seed fails the same dispatches as the reference, and
    enabling corruption and skew does not shift the schedule."""
    kw = dict(dispatch_fail_rate=0.3, dispatch_fail_burst=burst)
    a = _dispatch_schedule(FaultPlan(seed=9, **kw))
    assert a == _dispatch_schedule(RefFaultPlan(seed=9, **kw))
    assert a == _dispatch_schedule(FaultPlan(seed=9, corrupt_rate=1.0,
                                             skew_rate=1.0, **kw),
                                   noise=True)
    assert sum(a) > 0


def test_corrupt_skew_and_kill_match_reference():
    """Corruption (never mutating its input), skew and kill points draw
    the reference's values."""
    plan = FaultPlan(seed=4, corrupt_rate=0.7, skew_rate=0.6)
    ref = RefFaultPlan(seed=4, corrupt_rate=0.7, skew_rate=0.6)
    x = np.zeros(16, np.float32)
    for _ in range(20):
        y, ry = plan.corrupt(x), ref.corrupt(x)
        np.testing.assert_array_equal(y, ry)
        assert plan.skew(5.0) == ref.skew(5.0)
    assert np.all(np.isfinite(x))
    assert plan.corrupted_pushes == ref.corrupted_pushes > 0
    kill = FaultPlan(seed=0, kill_every=5)
    assert [i for i in range(20) if kill.should_kill(i)] == [4, 9, 14, 19]


def test_truncate_file(tmp_path):
    p = tmp_path / "seg.npz"
    p.write_bytes(b"x" * 100)
    assert truncate_file(str(p), 30) == 70
    assert p.stat().st_size == 70


# ---------------------------------------------------------------------------
# service-level invariants, over the seed matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_injected_failures_never_change_decisions(seed):
    """Retried injected faults: decisions bitwise the fault-free run's,
    every injected failure absorbed by a retry, none served by the
    fallback — and the reference's decisions and counters."""
    gold = _drive(TuningService(_bank(), slots=4, device="cpu"))
    chaos = FaultPlan(seed=seed, dispatch_fail_rate=0.5)
    svc = TuningService(_bank(), slots=4, chaos=chaos, device="cpu",
                        retry_policy=_policy(max_retries=3))
    assert _drive(svc) == gold, "retried faults changed decisions"
    assert svc.retry_count == chaos.injected_failures > 0
    assert svc.degraded_dispatch_count == 0
    rchaos = RefFaultPlan(seed=seed, dispatch_fail_rate=0.5)
    ref = RefService(_bank(True), slots=4, chaos=rchaos,
                     retry_policy=_policy(RefPolicy, max_retries=3))
    _same_as_reference(gold, _drive(ref))
    assert (svc.retry_count, rchaos.injected_failures) == \
        (ref.retry_count, chaos.injected_failures)


@pytest.mark.parametrize("seed", SEEDS)
def test_burst_exhausts_retries_falls_back_degraded(seed):
    """Bursts longer than the retry budget fall back to the unfaulted
    dispatch: flagged degraded, decisions still bitwise the fault-free
    run's, counters the reference's."""
    gold = _drive(TuningService(_bank(), slots=4, device="cpu"))
    chaos = FaultPlan(seed=seed, dispatch_fail_rate=0.9,
                      dispatch_fail_burst=10)
    svc = TuningService(_bank(), slots=4, chaos=chaos, device="cpu",
                        retry_policy=_policy(max_retries=2))
    assert _drive(svc) == gold, "degraded fallback changed decisions"
    assert svc.degraded_dispatch_count > 0
    assert svc.retry_count >= 3 * svc.degraded_dispatch_count
    ref = RefService(_bank(True), slots=4,
                     chaos=RefFaultPlan(seed=seed, dispatch_fail_rate=0.9,
                                        dispatch_fail_burst=10),
                     retry_policy=_policy(RefPolicy, max_retries=2))
    _drive(ref)
    assert (svc.degraded_dispatch_count, svc.retry_count) == \
        (ref.degraded_dispatch_count, ref.retry_count)


def test_chaos_without_policy_or_breaker_has_no_fallback():
    """The plain version serves a dispatch only when the caller armed
    ``retry_policy`` or ``breaker``: an injected failure with neither
    raises ``DispatchFailure`` and serves nothing."""
    svc = TuningService(_bank(), slots=4, device="cpu",
                        chaos=FaultPlan(seed=1, dispatch_fail_rate=1.0))
    svc.submit("j0", 48)
    svc.push("j0", np.ones(8, np.float32))
    with pytest.raises(DispatchFailure):
        svc.tick()
    assert svc.degraded_dispatch_count == 0 and svc.dispatch_count == 0


@pytest.mark.parametrize("exc,retried", [(KernelLaunchError, True),
                                         (ValueError, False)])
def test_kernel_launch_errors_are_transient_others_propagate(
        monkeypatch, exc, retried):
    """A failed kernel launch is retried like an injected fault and the
    decisions stay the fault-free run's; any other error from the
    dispatch propagates at once, with no retry and no fallback."""
    gold = _drive(TuningService(_bank(), slots=4, device="cpu"))
    kernel = ttuning._TICK_FNS["scored"]
    state = {"n": 0}

    def flaky(*args, **kwargs):
        state["n"] += 1
        if state["n"] % 3 == 1:
            raise exc("dtw_stream_scored launch failed: CUDA error 700") \
                if retried else exc("not a device fault")
        return kernel(*args, **kwargs)

    monkeypatch.setitem(ttuning._TICK_FNS, "scored", flaky)
    svc = TuningService(_bank(), slots=4, device="cpu",
                        retry_policy=_policy(max_retries=1))
    if retried:
        assert _drive(svc) == gold
        assert svc.retry_count == 3 and svc.degraded_dispatch_count == 0
    else:
        with pytest.raises(ValueError, match="not a device fault"):
            _drive(svc)
        assert svc.retry_count == 0 and svc.degraded_dispatch_count == 0


def _counting(monkeypatch, mode="scored", fail=None):
    """Replace a tick mode's dispatch with one that counts its calls
    (and raises ``fail`` on every call when given)."""
    kernel = ttuning._TICK_FNS[mode]
    calls = {"n": 0}

    def counted(*args, **kwargs):
        calls["n"] += 1
        if fail is not None:
            raise fail("dtw_stream_scored launch failed: CUDA error 700")
        return kernel(*args, **kwargs)

    monkeypatch.setitem(ttuning._TICK_FNS, mode, counted)
    return calls


@pytest.mark.parametrize("seed", SEEDS)
def test_fallback_reruns_the_same_dispatch(monkeypatch, seed):
    """Under a fault burst the fallback is the tick's own dispatch run
    without the chaos consult (on a card its kernel: no plain version
    serves CUDA tensors): every dispatch the service counts, degraded or
    not, called the mode's dispatch exactly once, and the breaker that
    opened re-closes once the faults stop."""
    gold = _drive(TuningService(_bank(), slots=4, device="cpu"))
    calls = _counting(monkeypatch)
    chaos = FaultPlan(seed=seed, dispatch_fail_rate=1.0)
    br = CircuitBreaker(fail_threshold=1, cooldown=1, probe_interval=1,
                        seed=seed)
    svc = TuningService(_bank(), slots=4, device="cpu", chaos=chaos,
                        breaker=br, retry_policy=_policy(max_retries=1))
    r = np.random.default_rng(3)
    streams = {f"j{i}": np.abs(np.cumsum(r.normal(size=48)))
               .astype(np.float32) for i in range(3)}
    outs = []
    for j in streams:
        svc.submit(j, 48)
    for t in range(6):
        if t == 3:
            svc.chaos = None
        for j, s in streams.items():
            svc.push(j, s[t * 8: (t + 1) * 8])
        outs.append(_keyd(svc.tick()))
        if t == 2:
            assert br.opened_count >= 1 and svc.degraded_dispatch_count == 3
    outs.append(_keyd(svc.finish_many(list(streams))))
    assert outs == gold
    assert calls["n"] == svc.dispatch_count == 6
    assert br.state == br.CLOSED and br.reclosed_count >= 1


@pytest.mark.parametrize("armed", ["retry", "breaker"])
def test_real_launch_failure_outlasting_retries_raises(monkeypatch, armed):
    """A real failed launch has no second path: after the retries (or a
    closed breaker's single attempt) it raises ``DispatchFailure`` with
    the launch error as its cause, and nothing counts as degraded."""
    calls = _counting(monkeypatch, fail=KernelLaunchError)
    kw = dict(retry_policy=_policy(max_retries=2)) if armed == "retry" \
        else dict(breaker=CircuitBreaker(fail_threshold=3))
    svc = TuningService(_bank(), slots=4, device="cpu", **kw)
    svc.submit("j0", 48)
    svc.push("j0", np.ones(8, np.float32))
    with pytest.raises(DispatchFailure) as info:
        svc.tick()
    assert isinstance(info.value.__cause__, KernelLaunchError)
    assert calls["n"] == (3 if armed == "retry" else 1)
    assert svc.degraded_dispatch_count == 0 and svc.dispatch_count == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_quarantine_leaves_survivors_bit_identical(seed):
    poison = ("j1", 2 + seed % 3)
    run1 = _drive(TuningService(_bank(), slots=4, device="cpu"),
                  poison=poison)
    assert run1 == _drive(TuningService(_bank(), slots=4, device="cpu"),
                          poison=poison)
    clean = _drive(TuningService(_bank(), slots=4, device="cpu"))
    assert [[e for e in t if e[0] != "j1"] for t in clean] == \
        [[e for e in t if e[0] != "j1"] for t in run1]
    svc = TuningService(_bank(), slots=4, device="cpu")
    _drive(svc, poison=poison)
    ref = RefService(_bank(True), slots=4)
    _same_as_reference(run1, _drive(ref, poison=poison))
    assert svc.quarantined == ref.quarantined == \
        {"j1": "non-finite sample (NaN/Inf)"}
    assert svc.quarantined_count == 1


def test_chaos_corruption_quarantines_via_push():
    """``FaultPlan.corrupt`` wired through ``push`` poisons a stream; the
    service quarantines instead of crashing, as the reference does, and
    drops the job's later pushes."""
    for cls, fcls, kw in ((TuningService, FaultPlan, dict(device="cpu")),
                          (RefService, RefFaultPlan, {})):
        svc = cls(_bank(cls is RefService), slots=4,
                  chaos=fcls(seed=1, corrupt_rate=1.0), **kw)
        svc.submit("j0", 48)
        err = PoisonedSampleError if cls is TuningService else ValueError
        with pytest.raises(err):
            svc.push("j0", np.ones(8, np.float32))
        assert svc.quarantined == {"j0": "non-finite sample (NaN/Inf)"}
        svc.push("j0", np.ones(8, np.float32))
        assert svc.quarantine_dropped == 1


def test_backwards_clock_skew_never_mass_evicts():
    """A sweep clock that jumps backwards decides what the honest sweep
    decided, and a backwards beat cannot rewind liveness."""
    svc = TuningService(_bank(), slots=4, heartbeat_timeout=10.0,
                        device="cpu")
    svc.submit("j0", 48)
    svc.submit("j1", 48)
    rng = np.random.default_rng(0)
    for step in range(1, 21):
        t = float(step)
        for j in ("j0", "j1"):
            svc.push(j, np.abs(rng.normal(size=4)).astype(np.float32),
                     now=t)
        assert svc.sweep_stalled(t) == {}
        assert svc.sweep_stalled(t - 100.0) == {}
    assert svc.n_active == 2
    svc2 = TuningService(_bank(), slots=4, heartbeat_timeout=10.0,
                         device="cpu")
    svc2.submit("j0", 48)
    svc2.push("j0", np.ones(4, np.float32), now=100.0)
    svc2.push("j0", np.ones(4, np.float32), now=3.0)
    assert svc2.sweep_stalled(105.0) == {}


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_skew_through_push_matches_reference(seed):
    """A skewing plan wired through ``push``: the same jobs survive the
    same sweeps as in the reference."""
    out = []
    for cls, fcls, kw in ((TuningService, FaultPlan, dict(device="cpu")),
                          (RefService, RefFaultPlan, {})):
        svc = cls(_bank(cls is RefService), slots=4, heartbeat_timeout=30.0,
                  chaos=fcls(seed=seed, skew_rate=0.5, max_skew=40.0), **kw)
        for j in ("j0", "j1", "j2"):
            svc.submit(j, 48)
        evicted = []
        for step in range(1, 16):
            t = 10.0 * step
            for j in list(svc._jobs):
                svc.push(j, np.full(2, 0.5, np.float32), now=t)
            evicted.append(sorted(svc.sweep_stalled(t)))
        out.append(evicted)
    assert out[0] == out[1]
