"""Bank sharding in the port (``mesh=``): a service whose K axis is split
over a mesh of CPU devices (``["cpu"] * n``, the counterpart of the
reference's forced host devices) against the port's unsharded service
and the reference's unsharded service.

The drive is the reference's ``tests/test_streaming_sharded.py``: K = 11
references over meshes of 2, 4 and 8 (so the bank pads to 12, 12 and 16
columns, and over 8 the last shards are all padding), band None and 6,
ragged chunk sizes and jobs that push nothing on a tick.  Against the
port's unsharded run the sharded scores and DP rows are bitwise, the
decisions equal tick for tick, the finals equal and one tick is one
dispatch.  Against the reference's unsharded service the decisions are
equal and the scores within SCORE_TOL.  The reference's own sharded
test is not the comparison: it fails under this jax at its pruned
re-pack (see ROADMAP.md)."""
import functools

import numpy as np
import pytest
import torch

from repro.core.database import pack_series as ref_pack
from repro.serve.tuning import MultiTenantTuningService as RefMultiTenant
from repro.serve.tuning import TuningService as RefService
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.database import pack_series
from repro_torch.serve.tuning import MultiTenantTuningService, TuningService
from repro_torch.sharding import (BankMesh, PartitionSpec, ShardedTensor,
                                  make_mesh, shard_tensor)

#: The reference test's sharded-vs-unsharded bound, here across the two
#: packages.  The port's ticks rebuild no moment base the reference
#: rebuilds (tests/test_torch_service.py), but on these banks the two
#: packages' scores agree well inside it.
SCORE_TOL = 1e-6
#: Probabilities across the packages (tests/test_torch_prob_*.py).
PROB_TOL = 2e-6

KW = dict(threshold=0.5, margin=0.01, stable_ticks=2, min_fraction=0.2,
          slots=4)
MODES = {
    "point": {},
    "exact": dict(min_probability=0.5),
    "approx": dict(min_probability=0.5, prob_mode="approx"),
    "distance": dict(score_in_flight=False),
}
#: The overload ladder walked one rung a hot tick (tests/
#: test_torch_overload.py's deterministic configuration).
LADDER = dict(target_p99=1.0, window=1, ewma_alpha=1.0, patience=1,
              cooldown=10 ** 6, max_rung=3)


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def make_bank(rng, pack, k=11, lo=18, hi=40):
    """The reference test's bank: K = 11, deliberately not a multiple of
    the device count."""
    series = []
    for i in range(k):
        n = int(rng.integers(lo, hi))
        t = np.linspace(0, 1, n, dtype=np.float32)
        s = 0.5 + 0.3 * np.sin(2 * np.pi * (1.5 + 0.7 * i) * t) \
            + 0.04 * rng.normal(size=n)
        series.append(np.clip(s, 0, 1).astype(np.float32))
    return pack(series, labels=[f"w{i % 4}" for i in range(k)])


def make_queries(rng, n=3, qlen=42):
    out = {}
    for j in range(n):
        t = np.linspace(0, 1, qlen, dtype=np.float32)
        q = 0.5 + 0.3 * np.sin(2 * np.pi * (1.5 + 0.7 * j) * t) \
            + 0.04 * rng.normal(size=qlen)
        out[f"job{j}"] = np.clip(q, 0, 1).astype(np.float32)
    return out


def make_variances(queries, seed=5):
    r = np.random.default_rng(seed)
    return {j: (0.01 * np.abs(r.normal(size=q.shape[0]))).astype(np.float32)
            for j, q in queries.items()}


@functools.lru_cache(maxsize=None)
def case(seed=0):
    """(reference bank, port bank, queries, variances) of one seed."""
    bank_np = make_bank(np.random.default_rng(seed), pack_series)
    ref_bank = make_bank(np.random.default_rng(seed), ref_pack)
    queries = make_queries(np.random.default_rng(seed + 100))
    return ref_bank, bank_np, queries, make_variances(queries)


def drive(svc, queries, variances=None, hot=()):
    """The reference test's drive: per-job chunk sizes that differ and
    drift tick to tick (0 included), so every tick has ragged nvalid and
    jobs that push nothing.  ``hot`` ticks report a 10 s latency (the
    ladder climbs one rung each).  Returns per tick the decisions, the
    scores (and probabilities) of every job that has any, and the DP
    rows over the bank's K live columns; then the finals."""
    decisions, sims, probs, rows = [], [], [], []
    pos = {jid: 0 for jid in queries}
    sizes = {jid: (7, 3, 9, 0, 5)[i % 5:] + (7, 3, 9, 0, 5)[:i % 5]
             for i, jid in enumerate(queries)}
    t = 0
    while any(pos[jid] < len(q) for jid, q in queries.items()):
        for jid, q in queries.items():
            step = sizes[jid][t % 5]
            sl = slice(pos[jid], pos[jid] + step)
            if variances is not None:
                svc.push(jid, q[sl], variance=variances[jid][sl])
            else:
                svc.push(jid, q[sl])
            pos[jid] = min(pos[jid] + step, len(q))
        out = svc.tick(latency=10.0 if t in hot else 0.0)
        t += 1
        decisions.append({jid: (d.matched, d.corr, d.decided_at_fraction,
                                d.probability)
                          for jid, d in out.items() if d is not None})
        sims.append({jid: svc._jobs[jid].last_sims.copy()
                     for jid in queries
                     if svc._jobs[jid].last_sims is not None})
        probs.append({jid: svc._jobs[jid].last_probs.copy()
                      for jid in queries
                      if svc._jobs[jid].last_probs is not None})
        if hasattr(svc, "_shards"):
            rows.append(np.array(svc._rows[:, :, :len(svc._packed_idx)]))
    finals = svc.finish_many(list(queries))
    return dict(decisions=decisions, sims=sims, probs=probs, rows=rows,
                finals={j: (d.matched, d.corr, d.scores, d.probability)
                        for j, d in finals.items()})


@functools.lru_cache(maxsize=None)
def port_run(mode, band, ndev, ladder=False, seed=0):
    _, bank, queries, variances = case(seed)
    kw = dict(KW, band=band, **MODES[mode])
    if ladder:
        kw["overload"] = LADDER
    if ndev is None:
        svc = TuningService(bank, device="cpu", **kw)
    else:
        svc = TuningService(bank, mesh=cpu_mesh(ndev), **kw)
    for jid, q in queries.items():
        svc.submit(jid, expected_len=len(q))
    out = drive(svc, queries, variances if "min_probability" in kw
                else None, hot=(2, 4, 6) if ladder else ())
    assert svc.dispatch_count == svc.ticks, (svc.dispatch_count, svc.ticks)
    out["svc"] = svc
    return out


@functools.lru_cache(maxsize=None)
def ref_run(mode, band, ladder=False, seed=0):
    ref_bank, _, queries, variances = case(seed)
    kw = dict(KW, band=band, **MODES[mode])
    if ladder:
        kw["overload"] = LADDER
    svc = RefService(ref_bank, **kw)
    for jid, q in queries.items():
        svc.submit(jid, expected_len=len(q))
    return drive(svc, queries, variances if "min_probability" in kw
                 else None, hot=(2, 4, 6) if ladder else ())


def assert_bitwise(got, want):
    """A sharded run against the port's unsharded run of the same drive:
    scores, probabilities and rows bitwise, decisions and finals equal."""
    assert got["decisions"] == want["decisions"]
    assert len(got["sims"]) == len(want["sims"])
    for key in ("sims", "probs"):
        for tg, tw in zip(got[key], want[key]):
            assert tg.keys() == tw.keys()
            for jid in tg:
                np.testing.assert_array_equal(tg[jid], tw[jid])
    for rg, rw in zip(got["rows"], want["rows"]):
        np.testing.assert_array_equal(rg, rw)
    assert got["finals"] == want["finals"]


def assert_near_reference(got, ref):
    """The port against the reference's unsharded service: decisions
    equal (matched workload and decision fraction), scores within
    SCORE_TOL, probabilities within PROB_TOL."""
    strip = [{j: (d[0], d[2]) for j, d in tick.items()}
             for tick in got["decisions"]]
    assert strip == [{j: (d[0], d[2]) for j, d in tick.items()}
                     for tick in ref["decisions"]]
    for key, tol in (("sims", SCORE_TOL), ("probs", PROB_TOL)):
        for tg, tr in zip(got[key], ref[key]):
            assert tg.keys() == tr.keys()
            for jid in tg:
                a, b = tg[jid], np.asarray(tr[jid])
                fa = np.isfinite(a)
                assert (fa == np.isfinite(b)).all()
                assert np.abs(a[fa] - b[fa]).max() <= tol, (key, jid)
    for jid, (m, corr, _, p) in got["finals"].items():
        rm, rcorr, _, rp = ref["finals"][jid]
        assert m == rm and abs(corr - rcorr) <= SCORE_TOL
        assert (p is None) == (rp is None)
        if p is not None:
            assert abs(p - rp) <= PROB_TOL


# ---------------------------------------------------------------------------
# the reference test's drive, every mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("band", [None, 6])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_point_sharded_bitwise_unsharded(ndev, band):
    got = port_run("point", band, ndev)
    svc = got["svc"]
    assert svc._kp == 11 + (-11) % ndev and svc._kp % ndev == 0
    assert len(svc._shards) == ndev
    for sh in svc._shards:
        assert sh.rows.is_contiguous() and sh.rows.shape[2] == svc._kp // ndev
        assert torch.equal(sh.ns, svc._ns) and torch.equal(sh.sx, svc._sx)
    assert_bitwise(got, port_run("point", band, None))


@pytest.mark.parametrize("band", [None, 6])
def test_point_unsharded_against_reference(band):
    assert_near_reference(port_run("point", band, None),
                          ref_run("point", band))


@pytest.mark.parametrize("band", [None, 6])
def test_point_sharded_against_reference(band):
    assert_near_reference(port_run("point", band, 8), ref_run("point", band))


@pytest.mark.parametrize("mode", ["exact", "approx", "distance"])
@pytest.mark.parametrize("ndev", [2, 8])
def test_modes_sharded_bitwise_unsharded(mode, ndev):
    """Probabilistic (both tails) and distance-only ticks: the sharded
    run's scores, probabilities and rows are bitwise the unsharded
    run's.  The tails are elementwise, and each element goes through the
    same float64 ``erfc`` and ``sqrt`` whatever the shard width."""
    got = port_run(mode, 6, ndev)
    assert_bitwise(got, port_run(mode, 6, None))
    if mode == "distance":
        assert not any(got["decisions"]) and not any(got["sims"])


@pytest.mark.parametrize("mode", ["exact", "approx", "distance"])
def test_modes_sharded_against_reference(mode):
    assert_near_reference(port_run(mode, 6, 4), ref_run(mode, 6))


@pytest.mark.parametrize("ndev", [3, 8])
def test_ladder_rungs_sharded(ndev):
    """An exact-probability service walked up the overload ladder's
    rungs 1-3 (approx over ``moms[:4]``, scored over ``moms[:3]``, then
    distance-only; capped ticks write their channels into each shard's
    slab in place): bitwise the unsharded run, decisions the
    reference's."""
    got = port_run("exact", 6, ndev, ladder=True)
    want = port_run("exact", 6, None, ladder=True)
    assert got["svc"].worst_rung == want["svc"].worst_rung == 3
    assert_bitwise(got, want)
    assert_near_reference(got, ref_run("exact", 6, ladder=True))


# ---------------------------------------------------------------------------
# the pruned service (the reference script's second part)
# ---------------------------------------------------------------------------

PRUNED = dict(prefilter_top=2, prefilter_margin=0.02)


@functools.lru_cache(maxsize=None)
def pruned_run(ndev, ref=False):
    ref_bank, bank, queries, _ = case(1)
    kw = dict(KW, **PRUNED)
    if ref:
        svc = RefService(ref_bank, **kw)
    elif ndev is None:
        svc = TuningService(bank, device="cpu", **kw)
    else:
        svc = TuningService(bank, mesh=cpu_mesh(ndev), **kw)
    kps = []
    for jid, q in queries.items():
        svc.submit(jid, expected_len=len(q))
    inner = svc._maybe_repack

    def repack():
        inner()
        kps.append(svc._kp)
    svc._maybe_repack = repack
    out = drive(svc, queries)
    out.update(svc=svc, kps=kps)
    return out


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_pruned_sharded(ndev):
    """The same -inf pattern and bitwise finite scores as the port's
    unsharded pruned run, the same re-packs, every pack's width a
    multiple of the device count; decisions the reference's."""
    got, want = pruned_run(ndev), pruned_run(None)
    svc = got["svc"]
    assert svc.repack_count == want["svc"].repack_count >= 1
    assert svc.repack_count == pruned_run(None, ref=True)["svc"].repack_count
    assert all(kp % ndev == 0 for kp in got["kps"])
    assert min(got["kps"]) < 11
    for tg, tw in zip(got["sims"], want["sims"]):
        for jid in tg:
            np.testing.assert_array_equal(np.isfinite(tg[jid]),
                                          np.isfinite(tw[jid]))
    assert_bitwise(dict(got, rows=[]), dict(want, rows=[]))
    assert_near_reference(dict(got, probs=[]),
                          dict(pruned_run(None, ref=True), probs=[]))


# ---------------------------------------------------------------------------
# the multi-tenant front
# ---------------------------------------------------------------------------

def test_multitenant_forwards_mesh():
    """``mesh=`` reaches every tenant's engine through
    ``**engine_kwargs``: a two-tenant sharded front decides as the
    unsharded front and as the reference's, with the same dispatches."""
    ref_bank, bank, queries, _ = case(2)
    halves = {"a": [0, 2, 4, 6, 8, 10], "b": [1, 3, 5, 7, 9]}

    def sub(b, idx, pack):
        return pack([b.row(i) for i in idx],
                    labels=[b.labels[i] for i in idx])
    fronts = [MultiTenantTuningService(
        {t: sub(bank, i, pack_series) for t, i in halves.items()},
        device="cpu", **KW),
        MultiTenantTuningService(
        {t: sub(bank, i, pack_series) for t, i in halves.items()},
        mesh=cpu_mesh(4), **KW),
        RefMultiTenant({t: sub(ref_bank, i, ref_pack)
                        for t, i in halves.items()}, **KW)]
    assert len(fronts[1].engine("a")._shards) == 4
    outs = []
    for front in fronts:
        for n, jid in enumerate(queries):
            front.submit(jid, len(queries[jid]), tenant="ab"[n % 2])
        ticks = []
        for lo in range(0, 42, 7):
            for jid, q in queries.items():
                front.push(jid, q[lo:lo + 7])
            ticks.append({j: (d.matched, d.decided_at_fraction)
                          for j, d in front.tick().items() if d is not None})
        fin = front.finish_many(list(queries))
        outs.append((ticks, {j: d.matched for j, d in fin.items()},
                     front.dispatch_count))
    assert outs[0] == outs[1] == outs[2]


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _tiny_bank():
    return pack_series([np.linspace(0, 1, 12, dtype=np.float32)] * 2,
                       labels=("a", "b"))


def test_two_axis_mesh_rejected():
    mesh = make_mesh((2, 2), ("data", "bank"), devices=["cpu"] * 4)
    assert mesh.devices.shape == (2, 2) and mesh.size == 4
    with pytest.raises(ValueError, match="needs a 1-D mesh"):
        TuningService(_tiny_bank(), mesh=mesh)
    svc = TuningService(_tiny_bank(), device="cpu")
    with pytest.raises(ValueError, match="needs a 1-D mesh"):
        svc.rescale(mesh)


def test_device_disagreeing_with_mesh_rejected():
    mesh = cpu_mesh(2)
    TuningService(_tiny_bank(), mesh=mesh, device="cpu")   # agrees
    with pytest.raises(ValueError, match="first device"):
        TuningService(_tiny_bank(), mesh=mesh, device="meta")


def test_make_mesh_without_card_raises(monkeypatch):
    """``make_mesh(n)`` names CUDA devices only: with no card visible it
    raises, and never falls back to the CPU; nor does a mesh that names
    ``"cuda"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (1, 2):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh(n)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(2, devices=["cuda", "cuda"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(4, devices=["cpu"] * 3)


def test_mesh_split_and_gather():
    """Each part is its own contiguous tensor (never a view of the
    whole), and the gather inverts the split."""
    mesh = cpu_mesh(4)
    t = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    parts = mesh.split(t, 2)
    assert [p.shape for p in parts] == [(2, 3, 2)] * 4
    assert all(p.is_contiguous() and p.data_ptr() != t.data_ptr()
               for p in parts)
    assert torch.equal(mesh.gather(parts, 2), t)
    with pytest.raises(ValueError, match="does not split"):
        mesh.split(t, 1)
    assert BankMesh(["cpu"], "data").shape == {"data": 1}


# ---------------------------------------------------------------------------
# checkpoint restore onto a mesh
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(32, dtype=torch.float32).reshape(8, 4),
            "b": {"c": torch.arange(6, dtype=torch.int32)}}


def test_elastic_restore_onto_mesh(tmp_path):
    """The reference's ``test_elastic_restore_onto_mesh``: restore places
    leaves onto a (new) mesh + spec tree."""
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    mesh = make_mesh(1, "data", devices=["cpu"])
    specs = {"a": PartitionSpec(None, None), "b": {"c": PartitionSpec()}}
    restored, _ = restore_checkpoint(str(tmp_path), t, mesh=mesh,
                                     specs=specs)
    assert restored["a"].sharding.mesh.shape["data"] == 1
    for got, want in ((restored["a"], t["a"]), (restored["b"]["c"],
                                                  t["b"]["c"])):
        assert isinstance(got, ShardedTensor)
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_restore_leaf_split_over_mesh(tmp_path, n):
    """A leaf split along dim 0 over 2 and 4 shards, another replicated,
    a third with no spec restored as without a mesh."""
    t = dict(_tree(), d=torch.ones(3))
    save_checkpoint(str(tmp_path), 1, t)
    mesh = make_mesh(n, "data", devices=["cpu"] * n)
    specs = {"a": ("data", None), "b": {"c": PartitionSpec(None)},
             "d": None}
    restored, _ = restore_checkpoint(str(tmp_path), t, mesh=mesh,
                                     specs=specs)
    a = restored["a"]
    assert len(a.shards) == n and a.sharding.dim == 0
    assert all(s.shape == (8 // n, 4) for s in a.shards)
    assert a.shape == (8, 4) and a.dtype == torch.float32
    assert torch.equal(a.gather(), t["a"])
    c = restored["b"]["c"]
    assert c.sharding.dim is None and len(c.shards) == n
    assert all(torch.equal(s, t["b"]["c"]) for s in c.shards)
    assert isinstance(restored["d"], torch.Tensor)
    with pytest.raises(ValueError, match="does not split"):
        restore_checkpoint(str(tmp_path), t, mesh=mesh,
                           specs={"a": None, "b": None, "d": ("data",)})


def test_shard_tensor_rejects_other_axis():
    mesh = cpu_mesh(2)
    with pytest.raises(ValueError, match="one axis is 'bank'"):
        shard_tensor(torch.zeros(4), mesh, ("data",))
    st = shard_tensor(torch.arange(4.0), mesh, PartitionSpec("bank"))
    assert [s.tolist() for s in st.shards] == [[0.0, 1.0], [2.0, 3.0]]
