"""The port's workload signatures (``repro_torch.core.signatures``)
against ``repro.core.signatures``, and the shape-only ``meta`` paths of
the kernels on the model path (K9, K10, the sLSTM scan).

* The reference's four properties (``tests/test_signatures.py``) on the
  port's op walker: exact dot flops, a Python loop's dots summed (the
  counterpart of the reference's scan expansion), a deterministic
  series in [0, 1], two programs told apart.
* ``utilization_series`` bitwise the reference's on seeded cost lists,
  at the reference's chip and the H100 spec; ``ChipSpec``, ``TPU_V5E``
  and ``OpCost`` field for field the reference's.
* The pricing table of the module docstring, one operator class a case.
* Each kernel wrapper on ``meta`` tensors: the CPU call's output shapes
  and dtypes, exactly one operation of its name with the stated flops
  and bytes, and its plain version never called.
* ``loss_fn`` on ``meta`` for all ten archs at their SMOKE sizes, no
  plain version reached.
* The matching front on signatures: the port's ``AutoTuner`` on the
  reference's golden arch signatures at band 32 reaches the reference's
  decision with every score within GOLDEN_TOL; and bench_autotune's
  experiment (six profiled archs at their published configs, kimi-k2
  the query, 4 x 512 tokens, 2048 samples, band 32, threshold 0.85) on
  the port's own walks.
"""

import _torch_threads  # noqa: F401  (an xdist worker's share of the threads)
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import AutoTuner as RAutoTuner
from repro.core import ReferenceDB as RReferenceDB
from repro.core import signatures as rsig
from repro_torch import configs
from repro_torch.core import AutoTuner, ReferenceDB
from repro_torch.core import signatures as sig
from repro_torch.kernels.attention import kernel as k9
from repro_torch.kernels.gla import kernel as k10
from repro_torch.kernels.gla import ops as gla_ops
from repro_torch.kernels.slstm import kernel as k_slstm
from repro_torch.models import model as tmodel

#: Scores of the port's AutoTuner against the reference's on the same
#: golden signatures: both run the same float32 DTW and float64
#: correlation; the sums' order differs.
GOLDEN_TOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "arch_signatures.npz")
PROFILE_ARCHS = ["deepseek-v2-236b", "phi3-mini-3p8b", "starcoder2-15b",
                 "granite-20b", "minitron-4b", "zamba2-7b"]
QUERY_ARCH = "kimi-k2-1t-a32b"
PROF_B, PROF_S, SAMPLES, BAND, THRESHOLD = 4, 512, 2048, 32, 0.85


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the reference's four properties
# ---------------------------------------------------------------------------

def test_dot_flops_exact():
    costs = sig.op_costs(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32))
    dot = [c for c in costs if c.name == "mm"]
    assert len(dot) == 1
    assert dot[0].flops == 2 * 64 * 128 * 32


def test_loop_of_layers_sums_costs():
    """The reference expands a ``lax.scan`` of ``tanh(c @ w)`` over 5
    steps; the port's layers are a Python loop, each step recorded."""
    def f(x, ws):
        c = x
        for w in ws:
            c = torch.tanh(c @ w)
        return c
    costs = sig.op_costs(f, _meta(8, 16), _meta(5, 16, 16))
    assert sum(c.flops for c in costs if c.name == "mm") \
        == 5 * 2 * 8 * 16 * 16


def test_signature_deterministic_and_shaped():
    def f(a, b):
        return torch.sum(torch.tanh(a @ b))
    a, b = _meta(32, 64), _meta(64, 32)
    s1 = sig.signature_of(f, a, b, samples=128)
    s2 = sig.signature_of(f, a, b, samples=128)
    assert s1.shape == (128,) and s1.dtype == np.float32
    np.testing.assert_array_equal(s1, s2)
    assert (s1 >= 0).all() and (s1 <= 1 + 1e-6).all()


def test_different_programs_different_signatures():
    a = _meta(64, 64)
    s_mm = sig.signature_of(lambda x: x @ x, a, samples=64)
    s_el = sig.signature_of(lambda x: torch.tanh(x) * 2, a, samples=64)
    assert not np.allclose(s_mm, s_el)


def test_cpu_tensors_are_walked_on_meta():
    """Tensors not on ``meta`` are moved there: nothing is computed."""
    x = torch.ones((4, 8))
    got = sig.op_costs(lambda t: t.sum(), x)
    assert [c.name for c in got] == ["sum"]


# ---------------------------------------------------------------------------
# the series and the chip specs
# ---------------------------------------------------------------------------

def _ref_chip(chip):
    return rsig.ChipSpec(**dataclasses.asdict(chip))


@pytest.mark.parametrize("chip", [sig.TPU_V5E, sig.H100],
                         ids=lambda c: c.name)
@pytest.mark.parametrize("seed,n,samples", [(0, 1, 16), (1, 7, 512),
                                            (2, 300, 2048), (3, 2048, 100)])
def test_utilization_series_bitwise(chip, seed, n, samples):
    """Random costs, with zero-cost operations (the 1e-12 floor), pure
    byte and pure flop operations among them."""
    rng = np.random.default_rng(seed)
    flops = rng.exponential(1e9, n) * (rng.random(n) > 0.2)
    nbytes = rng.exponential(1e7, n) * (rng.random(n) > 0.2)
    got = sig.utilization_series(
        [sig.OpCost(f"op{i}", f, b) for i, (f, b)
         in enumerate(zip(flops, nbytes))], samples, chip)
    want = rsig.utilization_series(
        [rsig.OpCost(f"op{i}", f, b) for i, (f, b)
         in enumerate(zip(flops, nbytes))], samples, _ref_chip(chip))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chip", [sig.TPU_V5E, sig.H100],
                         ids=lambda c: c.name)
def test_utilization_series_empty_and_floor(chip):
    np.testing.assert_array_equal(
        sig.utilization_series([], 64, chip),
        rsig.utilization_series([], 64, _ref_chip(chip)))
    zeros = [sig.OpCost("z", 0.0, 0.0)] * 3
    got = sig.utilization_series(zeros, 32, chip)
    want = rsig.utilization_series([rsig.OpCost("z", 0.0, 0.0)] * 3, 32,
                                   _ref_chip(chip))
    np.testing.assert_array_equal(got, want)


def test_chip_specs_and_opcost_equal_reference():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(sig.ChipSpec) == fields(rsig.ChipSpec)
    assert fields(sig.OpCost) == fields(rsig.OpCost)
    assert dataclasses.asdict(sig.TPU_V5E) == dataclasses.asdict(
        rsig.TPU_V5E)
    assert (sig.H100.peak_flops, sig.H100.hbm_bw) == (989e12, 3.35e12)


# ---------------------------------------------------------------------------
# the pricing table
# ---------------------------------------------------------------------------

N = 6 * 10

PRICES = [
    # (name, fn, args, recorded op, flops)
    ("mm", lambda a, b: torch.mm(a, b), ((6, 10), (10, 3)), "mm",
     2 * 18 * 10),
    ("bmm", lambda a, b: torch.bmm(a, b), ((2, 6, 10), (2, 10, 3)), "bmm",
     2 * 36 * 10),
    ("addmm", lambda c, a, b: torch.addmm(c, a, b), ((3,), (6, 10), (10, 3)),
     "addmm", 2 * 18 * 10 + 18),
    ("exp", torch.exp, ((6, 10),), "exp", 4 * N),
    ("sigmoid", torch.sigmoid, ((6, 10),), "sigmoid", 4 * N),
    ("pow_int", lambda x: x ** 2, ((6, 10),), "pow", N),
    ("pow_float", lambda x: x ** 2.5, ((6, 10),), "pow", 4 * N),
    ("sum", lambda x: x.sum(-1), ((6, 10),), "sum", N),
    ("amax", lambda x: x.amax(-1), ((6, 10),), "amax", N),
    ("maximum", lambda x, y: torch.max(x, y), ((6, 10), (6, 10)), "maximum",
     N),
    ("mean", lambda x: x.mean(-1), ((6, 10),), "mean", N + 6),
    ("softmax", lambda x: torch.softmax(x, -1), ((6, 10),), "_softmax",
     8 * N),
    ("log_softmax", lambda x: torch.log_softmax(x, -1), ((6, 10),),
     "_log_softmax", 8 * N + 4 * 6),
    ("logsumexp", lambda x: torch.logsumexp(x, -1), ((6, 10),), "logsumexp",
     7 * N + 5 * 6),
    ("silu", torch.nn.functional.silu, ((6, 10),), "silu", 5 * N),
    ("gelu_tanh", lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
     ((6, 10),), "gelu", 11 * N),
    ("gelu", torch.nn.functional.gelu, ((6, 10),), "gelu", 8 * N),
    ("logaddexp", torch.logaddexp, ((6, 10), (6, 10)), "logaddexp", 16 * N),
    ("view", lambda x: x.view(60), ((6, 10),), "view", 0),
    ("transpose", lambda x: x.t(), ((6, 10),), "t", 0),
    ("cast", lambda x: x.to(torch.bfloat16), ((6, 10),), "_to_copy", 0),
    ("cat", lambda x, y: torch.cat([x, y]), ((6, 10), (2, 10)), "cat", 0),
    ("zeros", lambda x: torch.zeros_like(x), ((6, 10),), "zeros_like", 0),
    ("add", lambda x: x + 1.0, ((6, 10),), "add", N),
    ("cumsum", lambda x: x.cumsum(-1), ((6, 10),), "cumsum", N),
    ("add_", lambda x: x.add_(1.0), ((6, 10),), "add", N),
    ("empty_like", torch.empty_like, ((6, 10),), "empty_like", N),
]


@pytest.mark.parametrize("name,fn,shapes,op,flops", PRICES,
                         ids=[p[0] for p in PRICES])
def test_pricing_table(name, fn, shapes, op, flops):
    """One operator class of the module docstring's table a case: one
    recorded operation, its flops, and as bytes every tensor input and
    output (4-byte elements; the cast writes 2-byte ones)."""
    args = [_meta(*s) for s in shapes]
    costs = sig.op_costs(fn, *args)
    assert [c.name for c in costs] == [op]
    assert costs[0].flops == flops
    with torch.device("meta"):
        out = fn(*[_meta(*s) for s in shapes])
    in_bytes = sum(4 * a.numel() for a in args)
    assert costs[0].bytes == in_bytes + out.numel() * out.element_size()


def test_allocations_priced_as_everything_else():
    """An allocation is none of the table's named classes: ``out`` flops,
    its output's bytes (and its tensor inputs')."""
    costs = sig.op_costs(lambda x: torch.empty_like(x).fill_(1.0),
                         _meta(6, 10))
    assert [(c.name, c.flops, c.bytes) for c in costs] == [
        ("empty_like", N, 2 * 4 * N), ("fill", 0.0, 2 * 4 * N)]
    costs = sig.op_costs(lambda: torch.empty((6, 10), device="meta"))
    assert [(c.name, c.flops, c.bytes) for c in costs] == [
        ("empty", N, 4 * N)]


# ---------------------------------------------------------------------------
# the kernels on meta
# ---------------------------------------------------------------------------

def _raise(*args, **kwargs):
    raise AssertionError("a plain version was reached on meta tensors")


@pytest.fixture
def no_plain(monkeypatch):
    """Every plain version the model path's kernels have raises."""
    for mod, name in ((k9, "flash_forward_plain"),
                      (k10, "gla_chunks_plain"),
                      (gla_ops, "gla_blocked"),
                      (k_slstm, "slstm_scan_plain")):
        monkeypatch.setattr(mod, name, _raise)


def _bytes(*ts):
    return float(sum(t.numel() * t.element_size() for t in ts))


def _one(costs, name):
    ops = [c for c in costs if c.name == name]
    assert len(ops) == 1, [c.name for c in costs]
    return ops[0]


K9_CASES = [
    # (b, h, kv, s, t, dh, dv, causal)
    (2, 4, 2, 128, 128, 64, 64, True),
    (1, 2, 1, 64, 192, 128, 32, True),
    (1, 2, 2, 192, 64, 32, 32, True),
    (1, 2, 1, 64, 128, 64, 64, False),
    (1, 2, 2, 128, 128, 192, 128, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", K9_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k9_on_meta(case, dtype, monkeypatch):
    b, h, kv, s, t, dh, dv, causal = case
    g = torch.Generator().manual_seed(1)
    cpu = [torch.randn(shape, generator=g).to(dtype) for shape in
           ((b, h, s, dh), (b, kv, t, dh), (b, kv, t, dv))]
    want = k9.flash_forward(*cpu, bq=64, bk=64, causal=causal)
    monkeypatch.setattr(k9, "flash_forward_plain", _raise)
    meta = [x.to("meta") for x in cpu]
    out = []
    costs = sig.op_costs(
        lambda *x: out.append(k9.flash_forward(*x, bq=64, bk=64,
                                               causal=causal)), *meta)
    (o,) = out
    assert (o.shape, o.dtype, o.device.type) == (want.shape, want.dtype,
                                                 "meta")
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    assert k9.causal_pairs(s, t, causal) == pairs
    op = _one(costs, "K9")
    # o's allocation, then the kernel's one operation
    assert [c.name for c in costs] == ["empty", "K9"]
    assert op.flops == 2 * (dh + dv) * b * h * pairs
    assert op.bytes == _bytes(*meta, o)


GLA_CASES = [
    # (b, h, s, dk, dv, chunk, dtype)
    (2, 3, 128, 32, 48, 64, torch.float32),
    (1, 2, 128, 64, 64, 64, torch.bfloat16),
    (1, 1, 64, 1024, 1025, 64, torch.float32),
    (1, 1, 64, 1024, 1025, 64, torch.bfloat16),
]


@pytest.mark.parametrize("case", GLA_CASES,
                         ids=lambda c: "-".join(map(str, c[:6]))
                         + ("-bf16" if c[6] == torch.bfloat16 else "-f32"))
def test_gla_scan_on_meta(case, monkeypatch):
    """``gla_scan`` at heads K10 takes in one launch and at mLSTM's 1024
    / 1025 (the blocked route on the CPU, the wide route on the card):
    on meta one operation, the undivided scan's work."""
    b, h, s, dk, dv, chunk, dtype = case
    g = torch.Generator().manual_seed(2)
    cpu = [torch.randn(shape, generator=g).to(dtype) for shape in
           ((b, h, s, dk), (b, h, s, dk), (b, h, s, dv))]
    log_a = -torch.rand((b, h, s), generator=g)
    want = gla_ops.gla_scan(*cpu, log_a, chunk=chunk, device="cpu")
    for mod, name in ((k10, "gla_chunks_plain"), (gla_ops, "gla_blocked")):
        monkeypatch.setattr(mod, name, _raise)
    meta = [x.to("meta") for x in cpu + [log_a]]
    out = []
    costs = sig.op_costs(lambda *x: out.append(
        gla_ops.gla_scan(*x, chunk=chunk, device="meta")), *meta)
    (got,) = out
    for a, w in zip(got, want):
        assert (a.shape, a.dtype, a.device.type) == (w.shape, w.dtype,
                                                     "meta")
    op = _one(costs, "K10")
    assert op.flops == b * h * (s // chunk) * (
        chunk * (chunk + 1) * (dk + dv) + 4 * chunk * dk * dv)
    g_meta = torch.empty((b, h, s), device="meta")
    assert op.bytes == _bytes(*meta[:3], g_meta, *got)
    # the within-chunk cumsum is torch, recorded apart
    assert "cumsum" in [c.name for c in costs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d", [(2, 5, 8), (1, 1, 64), (3, 17, 40)])
def test_slstm_scan_on_meta(b, s, d, dtype, monkeypatch):
    g = torch.Generator().manual_seed(3)
    zifo = torch.randn((b, s, 4 * d), generator=g).to(dtype)
    r = 0.1 * torch.randn((4, d), generator=g)
    st = [torch.zeros((b, d)) for _ in range(4)]
    hs, want = k_slstm.slstm_scan(zifo, r, *st)
    monkeypatch.setattr(k_slstm, "slstm_scan_plain", _raise)
    meta = [x.to("meta") for x in [zifo, r] + st]
    out = []
    costs = sig.op_costs(lambda *x: out.append(k_slstm.slstm_scan(*x)),
                         *meta)
    ((hs_m, st_m),) = out
    for a, w in zip((hs_m,) + tuple(st_m), (hs,) + tuple(want)):
        assert (a.shape, a.dtype, a.device.type) == (w.shape, w.dtype,
                                                     "meta")
    # hs's and the four states' allocations, then the kernel's operation
    assert [c.name for c in costs] == ["empty"] * 5 + ["sLSTM"]
    assert costs[-1].flops == k_slstm.OPS_PER_STEP * b * s * d == \
        27 * b * s * d
    assert costs[-1].bytes == _bytes(*meta, hs_m, *st_m)


# ---------------------------------------------------------------------------
# the model path on meta
# ---------------------------------------------------------------------------

def _batch(cfg, b, s):
    shape = (b, s) if cfg.num_codebooks == 1 else (b, s, cfg.num_codebooks)
    return {"tokens": _meta(*shape, dtype=torch.int32),
            "labels": _meta(*shape, dtype=torch.int32)}


def _walk(cfg, b, s):
    model = tmodel.DecoderLM(cfg, generator=torch.Generator().manual_seed(0),
                             device="meta").eval()
    batch = _batch(cfg, b, s)
    walker = sig.OpWalker()
    with torch.no_grad(), walker:
        loss, aux = tmodel.loss_fn(model, batch, cfg)
    return walker, loss, aux


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_loss_fn_on_meta(arch, no_plain):
    """Every arch's loss at its SMOKE size on meta: a float32 scalar,
    its kernels once per layer that runs them, each a single operation,
    and no plain version reached."""
    cfg = configs.smoke_config(arch)
    walker, loss, aux = _walk(cfg, 2, 37)
    assert (loss.shape, loss.dtype, loss.device.type) == \
        ((), torch.float32, "meta")
    kinds = tmodel.block_kinds(cfg)
    want = {}
    n_attn = sum(k in tmodel.ATTN_KINDS + ("shared_attn",) for k in kinds)
    if n_attn:
        want["K9"] = n_attn
    n_gla = sum(k in ("mamba2", "mlstm") for k in kinds)
    if n_gla:
        want["K10"] = n_gla
    if "slstm" in kinds:
        want["sLSTM"] = kinds.count("slstm")
    assert walker.kernels == want
    assert all(np.isfinite([c.flops, c.bytes]).all() and c.bytes >= 0
               for c in walker.costs)


# ---------------------------------------------------------------------------
# the matching front on signatures
# ---------------------------------------------------------------------------

def _tuner(cls_db, cls_tuner, sigs, **kw):
    db = cls_db()
    tuner = cls_tuner(db, band=BAND, threshold=THRESHOLD, **kw)
    for name, s in sigs.items():
        if name != QUERY_ARCH:
            tuner.profile(name, {}, s)
            db.set_best_config(name, {"arch": name}, 1.0)
    return tuner


def test_golden_arch_signatures_match_reference():
    """The matcher half, pinned apart from the walker: on the reference's
    golden jaxpr-trace signatures the port's AutoTuner reaches the
    reference's decision (``tests/test_database_tuner.py:89-105``)."""
    sigs = dict(np.load(GOLDEN))
    got = _tuner(ReferenceDB, AutoTuner, sigs, device="cpu").match(
        QUERY_ARCH, sigs[QUERY_ARCH])
    want = _tuner(RReferenceDB, RAutoTuner, sigs).match(
        QUERY_ARCH, sigs[QUERY_ARCH])
    assert got.matched == want.matched == "deepseek-v2-236b"
    assert got.config == want.config == {"arch": "deepseek-v2-236b"}
    assert got.scores.keys() == want.scores.keys()
    for name in want.scores:
        assert abs(got.scores[name] - want.scores[name]) <= GOLDEN_TOL
    assert abs(got.corr - want.corr) <= GOLDEN_TOL
    assert got.corr >= THRESHOLD
    assert got.scores["phi3-mini-3p8b"] < got.corr - 0.1


@pytest.fixture(scope="module")
def arch_costs():
    """Each arch's loss at its published config, 4 x 512 tokens, walked
    on meta."""
    out = {}
    for arch in PROFILE_ARCHS + [QUERY_ARCH]:
        cfg = configs.get(arch)
        walker, _, _ = _walk(cfg, PROF_B, PROF_S)
        out[arch] = walker.costs
    return out


def _kimi_match(arch_costs, chip):
    sigs = {a: sig.utilization_series(c, SAMPLES, chip)
            for a, c in arch_costs.items()}
    return _tuner(ReferenceDB, AutoTuner, sigs, device="cpu").match(
        QUERY_ARCH, sigs[QUERY_ARCH])


@pytest.mark.parametrize("chip", [sig.TPU_V5E, sig.H100],
                         ids=lambda c: c.name)
def test_kimi_ranks_deepseek_first(arch_costs, chip):
    """bench_autotune's experiment on the port's walks: kimi-k2's nearest
    profiled arch is deepseek-v2 (the other MLA + MoE arch), phi3 more
    than 0.1 below it, at the reference's chip and at the H100 spec."""
    d = _kimi_match(arch_costs, chip)
    best = max(d.scores, key=d.scores.get)
    assert best == "deepseek-v2-236b", d.scores
    assert d.corr == d.scores[best]
    assert d.scores["phi3-mini-3p8b"] < d.corr - 0.1, d.scores


def test_kimi_matched_to_deepseek_at_reference_chip(arch_costs):
    """At the reference's chip spec the port's walks reach the golden
    test's decision (``tests/test_database_tuner.py:99-105``): kimi-k2
    matched to deepseek-v2 at corr >= 0.85, phi3 more than 0.1 below,
    deepseek-v2's configuration transferred."""
    d = _kimi_match(arch_costs, sig.TPU_V5E)
    assert d.matched == "deepseek-v2-236b", d.scores
    assert d.corr >= THRESHOLD
    assert d.scores["phi3-mini-3p8b"] < d.corr - 0.1
    assert d.config == {"arch": "deepseek-v2-236b"}
