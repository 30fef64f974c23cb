"""The port's ``MultiTenantTuningService`` against the reference's:
routing by job id, per-tenant isolation, summed counters, and the same
decisions as the reference front on the same traces.

Tenant A holds the paper bank (2 apps x 4 parameter sets, preprocessed),
tenant B its first half.  The port's verdicts equal the reference
front's bitwise (both verdict scorers do the same arithmetic) and equal a
single-tenant port service over the tenant's bank (isolation); in-flight
decisions agree tick for tick."""

import numpy as np
import pytest

from repro import mrsim as rmrsim
from repro.core.database import SeriesBank as RefBank
from repro.core.database import pack_series as ref_pack
from repro.core.filters import preprocess_bank as ref_preprocess
from repro.serve.tuning import MultiTenantTuningService as RefFront
from repro_torch import mrsim
from repro_torch.core.database import SeriesBank, pack_series
from repro_torch.core.filters import preprocess_bank
from repro_torch.serve.tuning import MultiTenantTuningService, TuningService

KW = dict(band=16, denoise=True)


def _paper_bank(mod, pack, preprocess, bank_cls):
    series, labels = [], []
    for app in ("wordcount", "terasort"):
        for p in mod.paper_param_sets():
            series.append(mod.simulate_cpu_series(app, p, dt=0.25))
            labels.append(app)
    b = pack(series, labels=labels)
    return bank_cls(np.asarray(preprocess(b.series, b.lengths)), b.lengths,
                    b.labels, b.entries)


def _half(bank_cls, bank):
    h = len(bank) // 2
    return bank_cls(bank.series[:h], bank.lengths[:h], bank.labels[:h],
                    bank.entries[:h])


@pytest.fixture(scope="module")
def banks():
    ref = _paper_bank(rmrsim, ref_pack, ref_preprocess, RefBank)
    port = _paper_bank(mrsim, pack_series, preprocess_bank, SeriesBank)
    np.testing.assert_array_equal(port.series, ref.series)
    return ({"A": ref, "B": _half(RefBank, ref)},
            {"A": port, "B": _half(SeriesBank, port)})


def _run(front, q, chunk=16):
    front.submit("ja", expected_len=len(q), tenant="A")
    front.submit("jb", expected_len=len(q), tenant="B")
    ticks, earlies = 0, []
    for lo in range(0, len(q), chunk):
        front.push("ja", q[lo: lo + chunk])
        front.push("jb", q[lo: lo + chunk])
        for jid, d in front.tick().items():
            if d is not None:
                earlies.append((ticks, jid, d.matched,
                                d.decided_at_fraction))
        ticks += 1
    return ticks, earlies


def test_multi_tenant_routing_and_isolation(banks):
    """Routing, refusals, per-engine dispatch bound and verdicts scored
    against each tenant's own bank; B's verdict equals a single-tenant
    service's over the same sub-bank."""
    _, port = banks
    front = MultiTenantTuningService(port, device="cpu", **KW)
    assert front.tenants == ("A", "B")
    q = mrsim.simulate_cpu_series("wordcount", mrsim.paper_param_sets()[0],
                                  dt=0.25)
    front.submit("ja", expected_len=len(q), tenant="A")
    with pytest.raises(ValueError, match="already in flight"):
        front.submit("ja", expected_len=8, tenant="B")
    with pytest.raises(KeyError, match="unknown tenant"):
        front.submit("jc", expected_len=8, tenant="C")
    front.submit("jb", expected_len=len(q), tenant="B")
    ticks = 0
    for lo in range(0, len(q), 16):
        front.push("ja", q[lo: lo + 16])
        front.push("jb", q[lo: lo + 16])
        front.tick()
        ticks += 1
    assert front.dispatch_count <= ticks * 2
    assert front.dispatch_count == sum(front.engine(t).dispatch_count
                                       for t in front.tenants)
    assert front.n_active == 2
    d = front.finish_many(["ja", "jb"])
    assert set(d["ja"].scores) == set(port["A"].labels)
    assert set(d["jb"].scores) == set(port["B"].labels)
    assert front.n_active == 0 and front.offline_dispatch_count == 2
    solo = TuningService(port["B"], device="cpu", **KW)
    solo.submit("jb", expected_len=len(q))
    for lo in range(0, len(q), 16):
        solo.push("jb", q[lo: lo + 16])
        solo.tick()
    want = solo.finish("jb")
    assert (d["jb"].matched, d["jb"].corr, d["jb"].scores) == \
        (want.matched, want.corr, want.scores)


@pytest.mark.parametrize("app,pset", [("exim", 0), ("wordcount", 2)])
def test_multi_tenant_decisions_equal_reference_front(banks, app, pset):
    """The same two-tenant traffic through both fronts: the same early
    decisions at the same ticks and fractions, finals bitwise, the same
    dispatch counts."""
    ref_banks, port_banks = banks
    q = mrsim.simulate_cpu_series(app, mrsim.paper_param_sets()[pset],
                                  run=1, dt=0.25)
    ref = RefFront(ref_banks, **KW)
    front = MultiTenantTuningService(port_banks, device="cpu", **KW)
    assert _run(front, q) == _run(ref, q)
    assert front.dispatch_count == ref.dispatch_count
    got, want = front.finish_many(["ja", "jb"]), ref.finish_many(["ja",
                                                                  "jb"])
    for jid in ("ja", "jb"):
        assert (got[jid].matched, got[jid].corr, got[jid].scores,
                got[jid].decided_at_fraction) == \
            (want[jid].matched, want[jid].corr, want[jid].scores,
             want[jid].decided_at_fraction)


def test_multi_tenant_deferred_finishes_and_sweep(banks):
    """``finish_later``/``drain_finishes`` route per tenant, and a stalled
    job is swept from its tenant and forgotten by the front."""
    _, port = banks
    front = MultiTenantTuningService(port, device="cpu",
                                     heartbeat_timeout=5.0, **KW)
    q = port["A"].row(0)[:40]
    front.submit("a1", expected_len=40, tenant="A")
    front.submit("b1", expected_len=40, tenant="B")
    front.submit("b2", expected_len=40, tenant="B")
    front.push("a1", q, now=0.0)
    front.push("b1", q, now=0.0)
    front.push("b2", q[:8], now=0.0)
    front.tick()
    front.finish_later("a1")
    front.finish_later("b1")
    assert front.pending_finishes == 2
    out = front.drain_finishes()
    assert set(out) == {"a1", "b1"} and front.pending_finishes == 0
    assert set(front.sweep_stalled(10.0)) == {"b2"}
    assert front.n_active == 0
    with pytest.raises(KeyError):
        front.finish("b2")
    with pytest.raises(ValueError):
        MultiTenantTuningService({}, device="cpu")
