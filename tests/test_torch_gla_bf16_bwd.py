"""K10's backward on bfloat16 inputs: ``GlaChunks`` (dk, dv <= 128) and
the wide route's ``GlaWide`` on the CPU (their plain versions, the
definitions the bf16 backward kernels ``csrc/gla_bf16_bwd.cu`` and
``csrc/gla_wide_bwd.cu`` are held to on the card) against jax.grad of the
reference's jnp ``gla_chunked``, the kernels' bf16-part products emulated
in torch, their shared memory parsed from the sources, and the routing of
a bf16 gradient to the kernels' entry points.

Tolerances.  (i) Neither bf16 gradient is exact, so both are held to the
float32 gradient (jax.grad of the reference in float32 on the same
bf16-valued inputs): the port's distance, gradient by gradient, within
REF_BF16_X times the reference's own bf16 distance.  The reference rounds
each chunk's scores to bf16 before their product with v
(``repro/models/ssm.py:81``); the port keeps every float32 intermediate
and rounds dq, dk and dv once.  (ii) The kernels take their float32
operands (score tiles, q e^g, S_{c-1}, dS_c) in ``kParts`` = 2 bf16 parts:
emulated at zamba2's and mLSTM's dims, each element of dq, dk and dv
within one bf16 rounding of the plain element plus BWD_REL of the
gradient's max |plain|, dg within BWD_REL of its max, the bound the card
holds the kernels to (``chip_smoke.py``'s K10_BF16_BWD_REL); one part
leaves it.
"""

import _torch_threads  # noqa: F401  (an xdist worker's share of the threads)

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import gla_chunked as ref_gla_chunked
from repro_torch.kernels.gla import kernel as k10
from repro_torch.kernels.gla import ops as gla_ops
from repro_torch.models import ssm as tssm

#: The port's distance to the float32 gradient over the reference's
#: bf16 distance.
REF_BF16_X = 2.0
#: (ii)'s relative part: 1e-4 of a gradient's max |plain|.
BWD_REL = 1e-4

_CSRC = os.path.join(os.path.dirname(k10.__file__), "csrc")


def _bf16_valued(rng, shape, scale=1.0) -> np.ndarray:
    x = torch.tensor((rng.normal(size=shape) * scale).astype(np.float32))
    return x.bfloat16().float().numpy()


def _inputs(seed, b, h, s, dk, dv):
    """bf16-valued q, k (x 0.3), v, do; log_a <= 0 and the final state's
    gradient in float32."""
    rng = np.random.default_rng(seed)
    return (_bf16_valued(rng, (b, h, s, dk)),
            _bf16_valued(rng, (b, h, s, dk), 0.3),
            _bf16_valued(rng, (b, h, s, dv)),
            -np.abs(rng.normal(size=(b, h, s)) * 0.2).astype(np.float32),
            _bf16_valued(rng, (b, h, s, dv)),
            rng.normal(size=(b, h, dk, dv)).astype(np.float32))


def _jax_grads(q, k, v, la, do, dst, chunk, dtype):
    """jax.grad of sum(o do) (+ sum(state dst)) of the reference's
    ``gla_chunked`` with q, k, v in ``dtype``, as float32 arrays."""
    def loss(q_, k_, v_, la_):
        o, st = ref_gla_chunked(q_, k_, v_, la_, chunk)
        out = jnp.sum(o.astype(jnp.float32) * do)
        return out if dst is None else out + jnp.sum(st * dst)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(la))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


class _Spy:
    """Counts the calls of ``mod.fn`` while it is patched in, keeping
    each call's positional arguments."""

    def __init__(self, monkeypatch, mod, fn):
        self.calls, self.args = 0, []
        orig = getattr(mod, fn)

        def call(*args, **kwargs):
            self.calls += 1
            self.args.append(args)
            return orig(*args, **kwargs)
        monkeypatch.setattr(mod, fn, call)


#: (B, H, S, dk, dv, chunk): zamba2's head dims cut down (16, 64) and a
#: wide head (the wide route's function on the CPU).
CASES = [(1, 2, 64, 16, 16, 16), (1, 2, 128, 64, 64, 32),
         (1, 2, 128, 160, 161, 32)]


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_bf16_gradients_nearer_than_reference_bf16(case, with_dstate,
                                                   monkeypatch):
    """(i): ``models.ssm.gla_chunked`` on bf16 CPU tensors requiring grad
    goes through ``gla_chunks`` (dk, dv <= 128: ``GlaChunks``) or
    ``gla_wide`` (wider: ``GlaWide``; not ``gla_blocked``), the plain
    backward called once, undivided; dq, dk,
    dv (bf16) and dlog_a within REF_BF16_X times the reference's bf16
    jax.grad's distance to its float32 jax.grad, with and without a
    final-state gradient."""
    b, h, s, dk, dv, chunk = case
    q, k, v, la, do, dst = _inputs(sum(case), b, h, s, dk, dv)
    dst = dst if with_dstate else None
    want = _jax_grads(q, k, v, la, do, dst, chunk, jnp.float32)
    ref = _jax_grads(q, k, v, la, do, dst, chunk, jnp.bfloat16)
    xs = [torch.tensor(x).bfloat16().requires_grad_() for x in (q, k, v)]
    xs.append(torch.tensor(la, requires_grad=True))
    spy = _Spy(monkeypatch, k10, "gla_chunks_backward_plain")
    blocked = _Spy(monkeypatch, gla_ops, "gla_blocked")
    route = _Spy(monkeypatch, gla_ops, "gla_wide" if max(dk, dv)
                 > k10.MAX_HEAD_DIM else "gla_chunks")
    o, st = tssm.gla_chunked(*xs, chunk)
    assert route.calls == 1 and o.dtype == torch.bfloat16
    out = (o.float() * torch.tensor(do)).sum()
    if with_dstate:
        out = out + (st * torch.tensor(dst)).sum()
    got = torch.autograd.grad(out, xs)
    assert spy.calls == 1 and blocked.calls == 0
    assert spy.args[0][0].shape == (b, h, s, dk)
    assert spy.args[0][2].shape == (b, h, s, dv)
    assert (spy.args[0][6] is not None) == with_dstate
    for name, g, w, r in zip(("dq", "dk", "dv", "dlog_a"), got, want, ref):
        assert g.dtype == (torch.float32 if name == "dlog_a"
                           else torch.bfloat16)
        ours = np.abs(g.float().numpy() - w).max()
        theirs = np.abs(r - w).max()
        assert ours <= REF_BF16_X * theirs, (name, ours, theirs)


# ---- (ii) the kernels' bf16 parts, emulated ---------------------------------

def _header() -> str:
    with open(os.path.join(_CSRC, "gla_bf16_bwd.cuh")) as f:
        return f.read()


def _kparts() -> int:
    return int(re.search(r"constexpr int kParts = (\d+);",
                         _header()).group(1))


def _parts(x: torch.Tensor, n: int):
    """x as n bf16 parts, each the bf16 (round to nearest even) of what
    the parts before it leave (``store_parts``, ``split_fragments``)."""
    out, r = [], x.float()
    for _ in range(n):
        p = r.bfloat16().float()
        out.append(p)
        r = r - p
    return out


def _mm(a, b, parts_a=0, parts_b=0):
    """a @ b as the tensor cores take it: a (or b) in that many bf16
    parts, each part's product exact (float64 here) and summed, the sum
    rounded to float32."""
    xs = _parts(a, parts_a) if parts_a else [a.float()]
    ys = _parts(b, parts_b) if parts_b else [b.float()]
    acc = 0
    for x in xs:
        for y in ys:
            acc = acc + x.double() @ y.double()
    return acc.float()


def _emulate(q, k, v, g, states, do, dstate, chunk, n):
    """Both kernels' arithmetic with float32 operands in n bf16 parts:
    the dS chain with U_c = (q e^g)^T do ((q e^g) in parts); a chunk's
    scores (one exact bf16 product), masked and decayed, in parts against
    the other side's bf16 rows; the state terms first, S_{c-1} and dS_c
    in parts, scaled by e^{g_t} or e^{g_L - g_s}; dg from the float32
    sums; dq, dk, dv rounded once to bf16."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    nc, bh = s // chunk, b * h
    qf, kf, vf, of = (x.reshape(bh, s, -1).float() for x in (q, k, v, do))
    gf = g.reshape(bh, s)
    st = states.reshape(bh, nc, dk, dv)
    ds = torch.zeros(bh, dk, dv) if dstate is None else \
        dstate.reshape(bh, dk, dv).float()
    dss = [None] * nc
    for c in reversed(range(nc)):
        dss[c] = ds
        if c:
            sl = slice(c * chunk, (c + 1) * chunk)
            qe = qf[:, sl] * torch.exp(gf[:, sl])[..., None]
            u = _mm(qe.transpose(1, 2), of[:, sl], parts_a=n)
            ds = torch.exp(gf[:, (c + 1) * chunk - 1])[:, None, None] * ds + u
    idx = torch.arange(chunk)
    causal = idx[:, None] >= idx[None, :]
    dq, dkk = torch.empty(bh, s, dk), torch.empty(bh, s, dk)
    dvv, dg = torch.empty(bh, s, dv), torch.empty(bh, s)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qb, kb, vb, ob, gb = qf[:, sl], kf[:, sl], vf[:, sl], of[:, sl], \
            gf[:, sl]
        prev = st[:, c - 1] if c else torch.zeros(bh, dk, dv)
        decay = torch.exp(gb[:, :, None] - gb[:, None, :])
        a = torch.where(causal, _mm(ob, vb.transpose(1, 2)) * decay, 0.0)
        p = torch.where(causal, _mm(qb, kb.transpose(1, 2)) * decay, 0.0)
        eg = torch.exp(gb)[..., None]
        w = torch.exp(gb[:, -1:] - gb)[..., None]
        dqb = eg * _mm(ob, prev.transpose(1, 2), parts_b=n) + _mm(
            a, kb, parts_a=n)
        dkb = w * _mm(vb, dss[c].transpose(1, 2), parts_b=n) + _mm(
            a.transpose(1, 2), qb, parts_a=n)
        dvb = w * _mm(kb, dss[c], parts_b=n) + _mm(
            p.transpose(1, 2), ob, parts_a=n)
        dgb = (qb * dqb).sum(-1) - (kb * dkb).sum(-1)
        dgb[:, -1] += (dss[c] * st[:, c]).sum((1, 2))
        dq[:, sl], dkk[:, sl], dvv[:, sl], dg[:, sl] = dqb, dkb, dvb, dgb
    return (dq.reshape(q.shape).bfloat16(), dkk.reshape(k.shape).bfloat16(),
            dvv.reshape(v.shape).bfloat16(), dg.reshape(g.shape))


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding at each element: bfloat16's spacing at |x|."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8) * (
        x != 0)


def _worst(b, h, s, dk, dv, chunk, n, with_dstate):
    """The emulation's largest distance to ``gla_chunks_backward_plain``
    over its bound, dq, dk, dv and dg, on chip_smoke's inputs' scales."""
    gen = torch.Generator().manual_seed(s + dk + dv)
    q = torch.randn(b, h, s, dk, generator=gen).bfloat16()
    k = (0.3 * torch.randn(b, h, s, dk, generator=gen)).bfloat16()
    v = torch.randn(b, h, s, dv, generator=gen).bfloat16()
    la = -0.2 * torch.randn(b, h, s, generator=gen).abs()
    do = torch.randn(b, h, s, dv, generator=gen).bfloat16()
    dst = torch.randn(b, h, dk, dv, generator=gen) if with_dstate else None
    g = k10.chunk_cumsum(la, chunk)
    _, _, states = k10.gla_chunks_plain(q, k, v, g, chunk, with_states=True)
    want = k10.gla_chunks_backward_plain(q, k, v, g, states, do, dst, chunk)
    got = _emulate(q, k, v, g, states, do, dst, chunk, n)
    out = []
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == y.dtype
        tol = BWD_REL * y.float().abs().max() + (_bf16_step(y) if i < 3
                                                 else 0.0)
        out.append(float(((x.float() - y.float()).abs() / tol).max()))
    return out


#: zamba2-7b's Mamba2 layer (dk = dv = 64, chunk 256) and xlstm-1p3b's
#: mLSTM layer (dk 1024, dv 1025, chunk 256), three and two chunks.
DIMS = [(1, 2, 768, 64, 64, 256), (1, 1, 512, 1024, 1025, 256)]


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("dims", DIMS, ids=["zamba2", "mlstm"])
def test_kernel_parts_within_bound(dims, with_dstate):
    """(ii): the kernels' products with their float32 operands in the
    source's kParts (2) bf16 parts hold dq, dk, dv and dg within the
    card's bound of the plain backward."""
    assert _kparts() == 2
    worst = _worst(*dims, _kparts(), with_dstate)
    assert max(worst) <= 1.0, worst


def test_one_part_witnessed_outside_bound():
    """(ii): with one bf16 part a float32 operand, at zamba2's dims, the
    gradients leave the bound."""
    assert max(_worst(*DIMS[0], 1, False)) > 1.0


# ---- (iii) shared memory, parsed from the sources ---------------------------

def _src(name: str) -> str:
    with open(os.path.join(_CSRC, name)) as f:
        return f.read()


def _struct(src: str, name: str, **env) -> dict:
    """The members of ``struct name`` in ``src``, each evaluated from its
    definition with the header's constants and ``env``."""
    consts = {n: int(x) for n, x in re.findall(
        r"constexpr int (\w+) = (\d+);", _header() + src)}
    consts["kAtom"] = eval(re.search(
        r"constexpr uint32_t kAtom = ([^;]+);", _header()).group(1))
    body = re.search(rf"struct {name} {{(.*?)\n}};", src, re.S).group(1)
    env = {**consts, **env}
    for member, expr in re.findall(
            r"static constexpr uint32_t (\w+) = ([^;]+);", body):
        env[member] = eval(" ".join(expr.split()).replace("/", "//"), {},
                           env)
    return env


def _tiles(m: dict, tiles) -> None:
    """Each named tile starts on a 1024-byte boundary where the one before
    ends; the block, its 1024 bytes of alignment slack included, fits an
    SM's 232,448 bytes."""
    end = 0
    for name, size in tiles:
        assert m[name] == end and m[name] % 1024 == 0, name
        end += size
    assert m["kBytes"] <= 232448


@pytest.mark.parametrize("d", [64, 128])
def test_narrow_shared_memory_fits(d):
    """(iii): ``gla_bf16_bwd.cu``'s ``Smem<D>`` (the resident tile, the
    state's parts [D, D], two slots of two streamed tiles, g) and the
    header's ``DsSmem<D>`` (q e^g's parts, a do tile) within an SM; at D
    64 (zamba2's heads) three blocks an SM."""
    m = _struct(_src("gla_bf16_bwd.cu"), "Smem", D=d)
    t, sp = 64 * d * 2, d * d * 2
    _tiles(m, [("kR", t), ("kS", m["kParts"] * sp), ("kB", 4 * t)])
    assert m["kBytes"] == m["kG"] + 2 * 64 * 4 + 1024
    ds = _struct(_header(), "DsSmem", NV=d)
    _tiles(ds, [("kA", ds["kParts"] * 8192), ("kB", 64 * d * 2)])
    if d == 64:
        assert 3 * (m["kBytes"] + 1024) <= 233472


def test_wide_shared_memory_fits():
    """(iii): ``gla_wide_bwd.cu``'s ``ScoresSmem`` (two slots of two [64,
    64] slices) and ``GradSmem`` (a [64, 64] slice, the state slice's
    parts, [128, 64] or [64, 128], two slots of a [64, 128] block) within
    an SM, two blocks an SM each."""
    src = _src("gla_wide_bwd.cu")
    sc = _struct(src, "ScoresSmem")
    assert sc["kSlot"] == 2 * 64 * 64 * 2 and sc["kG"] == 2 * sc["kSlot"]
    gr = _struct(src, "GradSmem")
    assert gr["SP"] == 128 * 64 * 2
    _tiles(gr, [("kA", 64 * 64 * 2), ("kS", gr["kParts"] * gr["SP"]),
                ("kC", 2 * 64 * 128 * 2)])
    for m in (sc, gr):
        assert m["kBytes"] <= 232448 and 2 * (m["kBytes"] + 1024) <= 233472


# ---- (iv) the routing of a bf16 gradient on the card ------------------------

class _FakeLib:
    """Stands in for a built kernel library: records each entry point
    called with its integer arguments, and returns 0 (a launch that
    succeeded) without touching the tensors."""

    def __init__(self, calls: list) -> None:
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append(
            (fn, [a for a in args if isinstance(a, int) and a < 1 << 20]))\
            or 0


LIBS = ("LIB", "BWD_LIB", "BF16_BWD_LIB", "WIDE_BWD_LIB")


@pytest.mark.parametrize("dk,dv,fwd,bwd,lib", [
    (64, 64, "gla_scan_fwd", "gla_scan_bwd_bf16", "BF16_BWD_LIB"),
    (128, 96, "gla_scan_fwd", "gla_scan_bwd_bf16", "BF16_BWD_LIB"),
    (200, 129, "gla_wide_fwd", "gla_wide_bwd", "WIDE_BWD_LIB"),
    (1024, 1025, "gla_wide_fwd", "gla_wide_bwd", "WIDE_BWD_LIB"),
])
def test_bf16_gradient_reaches_the_bf16_kernels(monkeypatch, dk, dv, fwd,
                                                bwd, lib):
    """(iv): bf16 inputs on the card (``is_cuda`` patched true) under a
    gradient, through ``ops.gla_scan``, launch the forward of their
    route (``gla_chunks``' kernel, or ``gla_wide``'s) and, on backward,
    its bf16 backward kernel: one launch counted on ``lib``, none on the
    float32 backward's, no plain version called, ``gla_blocked`` not
    taken.  (This replaces the test that bf16 CUDA inputs and
    ``gla_wide`` raised with a gradient asked for.)"""
    calls = []
    fake = _FakeLib(calls)
    for name in LIBS:
        monkeypatch.setattr(getattr(k10, name), "launches", 0)
        monkeypatch.setattr(getattr(k10, name), "get", lambda: fake)
    monkeypatch.setattr(k10, "WIDE_LAUNCHES", 0)
    monkeypatch.setattr(k10, "check_kernel_device", lambda t: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    for plain in ("gla_chunks_plain", "gla_chunks_backward_plain"):
        monkeypatch.setattr(k10, plain, None)   # a call would raise
    monkeypatch.setattr(gla_ops, "gla_blocked", None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    b, h, s, chunk = 1, 2, 256, 128
    xs = [torch.zeros((b, h, s, d), dtype=torch.bfloat16, requires_grad=True)
          for d in (dk, dk, dv)]
    la = torch.zeros((b, h, s), requires_grad=True)
    o, st = gla_ops.gla_scan(*xs, la, chunk=chunk, device="cpu")
    assert o.dtype == torch.bfloat16 and st.dtype == torch.float32
    torch.autograd.grad((o.float().sum(), st.sum()), xs + [la])
    assert [c[0] for c in calls] == [fwd, bwd]
    assert calls[1][1][:5] == [b * h, s, chunk, dk, dv]
    narrow = lib == "BF16_BWD_LIB"
    assert {n: getattr(k10, n).launches for n in LIBS} == {
        n: int(n == lib or (narrow and n == "LIB")) for n in LIBS}
    assert k10.WIDE_LAUNCHES == (2 if lib == "WIDE_BWD_LIB" else 0)


def test_wide_function_on_meta_reports_one_op_each():
    """``GlaWide`` on meta tensors (bf16 mLSTM-wide heads): "K10" forward
    and "K10_bwd" backward, one op each, the backward's flops the
    undivided backward's least work; every input a meta gradient of its
    shape."""
    from repro_torch.core.signatures import OpWalker
    b, h, s, dk, dv, chunk = 1, 2, 512, 1024, 1025, 256
    xs = [torch.empty((b, h, s, d), dtype=torch.bfloat16, device="meta",
                      requires_grad=True) for d in (dk, dk, dv)]
    g = torch.empty((b, h, s), device="meta", requires_grad=True)
    walker = OpWalker()
    with walker:
        o, st = k10.GlaWide.apply(*xs, g, chunk)
        (o.float().sum() + st.sum()).backward()
    assert walker.kernels == {"K10": 1, "K10_bwd": 1}
    cost = next(c for c in walker.costs if c.name == "K10_bwd")
    nc = s // chunk
    assert cost.flops == b * h * nc * (
        chunk * (chunk + 1) * (3 * dk + 2 * dv) + 8 * chunk * dk * dv)
    for t in xs + [g]:
        assert t.grad is not None and t.grad.is_meta and \
            t.grad.shape == t.shape
