"""Elastic rescale and restore onto another mesh in the port: rescale and
recovery move state, never numbers.

``TuningService.rescale`` re-homes a live service's state onto another
bank mesh (or onto one device with ``None``) mid-flight, and
``restore_service(mesh=)`` rehydrates a snapshot taken on one mesh onto
another.  Either way every later score, probability, DP row and decision
is bitwise the run that never moved.  The meshes are repeated CPU
devices (``["cpu"] * n``); the reference's rescale cases are
``tests/test_fault_wiring.py`` (one device) and the third part of
``tests/test_streaming_sharded.py`` (8 -> 4 devices, which this jax
never reaches), and its snapshot cases cross the packages here too."""
import functools

import numpy as np
import pytest

from repro.core.database import pack_series as ref_pack
from repro.serve.recovery import restore_service as ref_restore_service
from repro.serve.recovery import snapshot_service as ref_snapshot_service
from repro.serve.tuning import TuningService as RefService
from repro_torch import mrsim
from repro_torch.core.database import SeriesBank, pack_series
from repro_torch.core.filters import preprocess_bank
from repro_torch.runtime.fault import ElasticController
from repro_torch.serve.recovery import restore_service, snapshot_service
from repro_torch.serve.tuning import TuningService
from repro_torch.sharding import make_mesh

#: The reference's sharded-vs-unsharded bound (its
#: tests/test_streaming_sharded.py), across the two packages.
SCORE_TOL = 1e-6
PROB_TOL = 2e-6

KW = dict(threshold=0.5, margin=0.01, stable_ticks=2, min_fraction=0.2,
          slots=4)
CONFIGS = {
    "point": dict(band=6),
    "exact": dict(band=6, min_probability=0.5),
    "pruned": dict(prefilter_top=2, prefilter_margin=0.02),
}


def cpu_mesh(n):
    return None if n is None else make_mesh(n, devices=["cpu"] * n)


def make_bank(rng, pack, k=11, lo=18, hi=40):
    """The reference sharded test's bank: K = 11 (not a multiple of the
    device counts), one of four workloads a reference."""
    series = []
    for i in range(k):
        n = int(rng.integers(lo, hi))
        t = np.linspace(0, 1, n, dtype=np.float32)
        s = 0.5 + 0.3 * np.sin(2 * np.pi * (1.5 + 0.7 * i) * t) \
            + 0.04 * rng.normal(size=n)
        series.append(np.clip(s, 0, 1).astype(np.float32))
    return pack(series, labels=[f"w{i % 4}" for i in range(k)])


@functools.lru_cache(maxsize=None)
def case(seed=3):
    rng = np.random.default_rng(seed + 100)
    queries, variances = {}, {}
    for j in range(3):
        t = np.linspace(0, 1, 42, dtype=np.float32)
        q = 0.5 + 0.3 * np.sin(2 * np.pi * (1.5 + 0.7 * j) * t) \
            + 0.04 * rng.normal(size=42)
        queries[f"job{j}"] = np.clip(q, 0, 1).astype(np.float32)
        variances[f"job{j}"] = (0.01 * np.abs(rng.normal(size=42))) \
            .astype(np.float32)
    return (make_bank(np.random.default_rng(seed), ref_pack),
            make_bank(np.random.default_rng(seed), pack_series),
            queries, variances)


def build(config, mesh=None, ref=False):
    ref_bank, bank, queries, _ = case()
    kw = dict(KW, **CONFIGS[config])
    svc = RefService(ref_bank, **kw) if ref else \
        TuningService(bank, mesh=mesh, device=None if mesh else "cpu", **kw)
    for jid, q in queries.items():
        svc.submit(jid, expected_len=len(q))
    return svc


def step(svc, t, config):
    """Tick ``t`` of the tape: 7 samples a job, then one tick.  Returns
    the tick's decisions (float hex) and every job's scores,
    probabilities and, for a port service, its DP rows on the live
    columns."""
    _, _, queries, variances = case()
    for jid, q in queries.items():
        sl = slice(7 * t, 7 * (t + 1))
        if "min_probability" in CONFIGS[config]:
            svc.push(jid, q[sl], variance=variances[jid][sl])
        else:
            svc.push(jid, q[sl])
    out = svc.tick()
    rec = dict(decisions=sorted(
        (j, d.matched, float(d.corr).hex(), d.decided_at_fraction)
        for j, d in out.items() if d is not None),
        sims={j: job.last_sims.copy() for j, job in svc._jobs.items()},
        probs={j: None if job.last_probs is None else job.last_probs.copy()
               for j, job in svc._jobs.items()})
    if hasattr(svc, "_shards"):
        rec["rows"] = np.array(svc._rows[:, :, :len(svc._packed_idx)])
    return rec


N_TICKS = 6


def finals(svc):
    return {j: (d.matched, float(d.corr).hex(),
                None if d.probability is None else float(d.probability))
            for j, d in svc.finish_many(list(case()[2])).items()}


@functools.lru_cache(maxsize=None)
def golden(config):
    """The port's unsharded, never-moved run: every tick and the finals."""
    svc = build(config)
    ticks = [step(svc, t, config) for t in range(N_TICKS)]
    return ticks, finals(svc), svc.dispatch_count


def assert_tick_bitwise(got, want):
    assert got["decisions"] == want["decisions"]
    assert got["sims"].keys() == want["sims"].keys()
    for jid in got["sims"]:
        np.testing.assert_array_equal(got["sims"][jid], want["sims"][jid])
        if want["probs"][jid] is not None:
            np.testing.assert_array_equal(got["probs"][jid],
                                          want["probs"][jid])
    np.testing.assert_array_equal(got["rows"], want["rows"])


def assert_tick_near(got, want):
    """Across the packages: the same decisions, scores within SCORE_TOL
    and probabilities within PROB_TOL."""
    assert [d[:2] + d[3:] for d in got["decisions"]] == \
        [d[:2] + d[3:] for d in want["decisions"]]
    for jid in got["sims"]:
        a, b = got["sims"][jid], np.asarray(want["sims"][jid])
        fa = np.isfinite(a)
        assert (fa == np.isfinite(b)).all()
        assert np.abs(a[fa] - b[fa]).max() <= SCORE_TOL, jid
        if want["probs"][jid] is not None:
            assert np.abs(got["probs"][jid]
                          - np.asarray(want["probs"][jid])).max() <= PROB_TOL


# ---------------------------------------------------------------------------
# rescale
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paper_bank():
    psets = mrsim.paper_param_sets()
    series, labels = [], []
    for app in ("wordcount", "terasort"):
        for p in psets:
            series.append(mrsim.simulate_cpu_series(app, p, dt=0.25))
            labels.append(app)
    bank = pack_series(series, labels=labels)
    return SeriesBank(np.asarray(preprocess_bank(bank.series, bank.lengths)),
                      bank.lengths, bank.labels, bank.entries)


@pytest.fixture(scope="module")
def paper_queries():
    psets = mrsim.paper_param_sets()
    return {f"job{i}": mrsim.simulate_cpu_series(app, psets[i], run=i + 1,
                                                 dt=0.25)
            for i, app in enumerate(("wordcount", "exim", "terasort"))}


def test_elastic_controller_decision_drives_rescale(paper_bank,
                                                   paper_queries):
    """The reference's ``tests/test_fault_wiring.py``
    ``test_elastic_controller_decision_drives_rescale`` on the port: an
    ``ElasticController`` shrink decision re-homes the state mid-run
    (``rescale(None)``: the one device's pack gathered and re-split)
    without touching any score."""
    kw = dict(band=16, threshold=0.85, margin=0.02, stable_ticks=2,
              min_fraction=0.15, denoise=True, slots=8, device="cpu")
    ctl = ElasticController(model_parallel=1)
    base = TuningService(paper_bank, **kw)
    resc = TuningService(paper_bank, **kw)
    for jid, q in paper_queries.items():
        base.submit(jid, expected_len=len(q))
        resc.submit(jid, expected_len=len(q))
    n = max(len(q) for q in paper_queries.values())
    for t, lo in enumerate(range(0, n, 16)):
        if t == 3:
            d = ctl.decide(current_data_parallel=2,
                           alive=[0, 1], stragglers=[1])
            assert d.should_rescale and d.new_data_parallel == 1
            resc.rescale(None)
        for jid, q in paper_queries.items():
            base.push(jid, q[lo: lo + 16])
            resc.push(jid, q[lo: lo + 16])
        base.tick()
        resc.tick()
        for jid in paper_queries:
            np.testing.assert_array_equal(base._jobs[jid].last_sims,
                                          resc._jobs[jid].last_sims)
    assert resc.rescale_count == 1 and resc.mesh is None
    fin_a = base.finish_many(list(paper_queries))
    fin_b = resc.finish_many(list(paper_queries))
    for jid in paper_queries:
        assert fin_a[jid].matched == fin_b[jid].matched
        assert fin_a[jid].corr == fin_b[jid].corr


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_elastic_rescale_8_to_4(config):
    """The reference sharded test's third part: two of eight hosts
    flagged as stragglers, the ``ElasticController`` snaps the data axis
    to 4, and the 8-shard service re-homes onto a 4-shard mesh at tick 3.
    Every tick bitwise the port's never-moved unsharded run, one
    dispatch a tick; the scores within the reference test's 1e-6 of the
    reference's unsharded service, decisions equal."""
    ticks, fins, _ = golden(config)
    shd = build(config, cpu_mesh(8))
    ref = build(config, ref=True)
    ctl = ElasticController(model_parallel=1)
    for t in range(N_TICKS):
        if t == 3:
            d = ctl.decide(current_data_parallel=8, alive=list(range(8)),
                           stragglers=[6, 7])
            assert d.should_rescale and d.new_data_parallel == 4, d
            shd.rescale(cpu_mesh(d.new_data_parallel))
            assert shd._kp % 4 == 0 and len(shd._shards) == 4
        got = step(shd, t, config)
        assert_tick_bitwise(got, ticks[t])
        assert_tick_near(got, step(ref, t, config))
    assert shd.rescale_count == 1 and shd.mesh.devices.size == 4
    assert shd.dispatch_count == shd.ticks == N_TICKS
    assert finals(shd) == fins


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_rescale_4_to_none_to_2(config):
    """4 shards, then one device (``None``), then 2 shards, mid-flight:
    bitwise the never-moved run, each rescale counted."""
    ticks, fins, _ = golden(config)
    svc = build(config, cpu_mesh(4))
    plan = {2: None, 4: cpu_mesh(2)}
    for t in range(N_TICKS):
        if t in plan:
            svc.rescale(plan[t])
            assert len(svc._shards) == (1 if plan[t] is None else 2)
        assert_tick_bitwise(step(svc, t, config), ticks[t])
    assert svc.rescale_count == 2 and svc.dispatch_count == N_TICKS
    assert finals(svc) == fins


# ---------------------------------------------------------------------------
# snapshot on one mesh, restore onto another
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("src,dst", [(8, 4), (4, None), (None, 2)])
def test_snapshot_restores_onto_another_mesh(config, src, dst):
    """A snapshot taken on one mesh after tick 3 restores onto another
    (re-padded and re-split by the restorer) and continues bitwise the
    never-moved run; the snapshot carries no padding and no trace of the
    mesh."""
    ticks, fins, _ = golden(config)
    svc = build(config, cpu_mesh(src))
    for t in range(3):
        step(svc, t, config)
    tree = snapshot_service(svc)
    assert tree["device"]["rows"].shape[2] == len(svc._packed_idx)
    twin = restore_service(tree, case()[1], mesh=cpu_mesh(dst),
                           device=None if dst else "cpu")
    assert len(twin._shards) == (dst or 1) and twin._kp % (dst or 1) == 0
    for t in range(3, N_TICKS):
        assert_tick_bitwise(step(twin, t, config), ticks[t])
    assert twin.dispatch_count == N_TICKS
    assert finals(twin) == fins


@pytest.mark.parametrize("config", ["exact", "pruned"])
def test_reference_snapshot_onto_port_mesh(config):
    """The reference's unsharded snapshot after tick 3 restores onto a
    port mesh of 4, which continues to the reference's decisions, its
    scores within SCORE_TOL; then the other way round, a port 4-shard
    snapshot restores in the reference and continues to the port's."""
    ref_bank, bank, _, _ = case()
    ref = build(config, ref=True)
    port = build(config, cpu_mesh(4))
    for t in range(3):
        step(ref, t, config)
        step(port, t, config)
    from_ref = restore_service(ref_snapshot_service(ref), bank,
                               mesh=cpu_mesh(4))
    from_port = ref_restore_service(snapshot_service(port), ref_bank)
    np.testing.assert_array_equal(from_ref._packed_idx, ref._packed_idx)
    for t in range(3, N_TICKS):
        assert_tick_near(step(from_ref, t, config), step(ref, t, config))
        assert_tick_near(step(port, t, config), step(from_port, t, config))
