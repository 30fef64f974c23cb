"""The float32 backward kernels of the Mamba2 and MLA archs' training,
through their plain versions on the CPU: K10's
(``kernels.gla.kernel.GlaChunks``, ``gla_chunks_backward_plain``) and
K9's at MLA's head (dh 192 = 128 + 64 rope, dv 128;
``kernels.attention.kernel.FlashAttention``, ``flash_backward_plain``),
against ``jax.grad`` of the reference's jnp functions
(``repro.models.ssm.gla_chunked``, ``repro.models.attention.attention``)
on the same numpy-seeded float32 inputs; the CUDA kernels' tilings
emulated in torch; and one SMOKE train step of zamba2 and of deepseek-v2
through those routes against the reference's step.

Tolerances: each gradient within GRAD_REL = 1e-5 of the largest element
of the reference's (float32 sums in other orders: measured 1e-7 to 6e-7
for K10, where dg = q . dq - k . dk differences terms the reference sums
as the decay's gradient; K9 as ``tests/test_torch_attention.py`` holds
it); the train steps within ``tests/test_torch_train_archs.py``'s
LOSS_REL, RTOL and SMOKE_ATOL.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import gla_chunked as ref_gla_chunked
from repro_torch.kernels.attention import kernel as k9
from repro_torch.kernels.gla import kernel as k10
from repro_torch.kernels.slstm import kernel as k_slstm
from repro_torch.models import ssm as tssm
from test_torch_attention import _split

GRAD_REL = 1e-5


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


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


# ---------------------------------------------------------------------------
# K10's backward
# ---------------------------------------------------------------------------

def _gla_inputs(seed, b, h, s, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, dk)).astype(np.float32),
            (rng.normal(size=(b, h, s, dk)) * 0.3).astype(np.float32),
            rng.normal(size=(b, h, s, dv)).astype(np.float32),
            -np.abs(rng.normal(size=(b, h, s)) * 0.2).astype(np.float32),
            rng.normal(size=(b, h, s, dv)).astype(np.float32),
            rng.normal(size=(b, h, dk, dv)).astype(np.float32))


GLA_CASES = [(1, 2, 64, 16, 16, 16), (2, 3, 96, 64, 64, 32),
             (1, 2, 130, 64, 128, 64)]


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("case", GLA_CASES)
def test_gla_backward_vs_jax_grad(case, with_dstate, monkeypatch):
    """``models.ssm.gla_chunked``'s gradients (q, k, v, log_a; S padded
    to the chunk where it is not a multiple) through ``GlaChunks`` and
    the plain backward, within GRAD_REL of jax.grad of the reference's
    ``gla_chunked``; with a nonzero gradient of the final state, or
    without one (the state unused, its gradient None)."""
    b, h, s, dk, dv, chunk = case
    q, k, v, la, do, dst = _gla_inputs(sum(case), b, h, s, dk, dv)

    def loss(q_, k_, v_, la_):
        o, st = ref_gla_chunked(q_, k_, v_, la_, chunk)
        out = jnp.sum(o * do)
        return out + jnp.sum(st * dst) if with_dstate else out

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, la)))
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v, la)]
    spy = _Spy(monkeypatch, k10, "gla_chunks_backward_plain")
    o, st = tssm.gla_chunked(*xs, chunk)
    out = (o * torch.tensor(do)).sum()
    if with_dstate:
        out = out + (st * torch.tensor(dst)).sum()
    got = torch.autograd.grad(out, xs)
    assert spy.calls == 1 and (spy.args[0][6] is not None) == with_dstate
    for name, g, w in zip(("dq", "dk", "dv", "dlog_a"), got, want):
        assert tuple(g.shape) == np.shape(w)
        assert _rel(g, w) <= GRAD_REL, name


@pytest.mark.parametrize("b,h,s,dk,dv,chunk", [
    (1, 2, 64, 16, 16, 16), (2, 1, 48, 8, 24, 24), (1, 3, 128, 32, 64, 64),
    (1, 1, 100, 12, 10, 100)])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_gla_backward_plain_vs_autograd(b, h, s, dk, dv, chunk, with_dstate):
    """``gla_chunks_backward_plain`` against autograd of
    ``gla_chunks_plain`` (the same function differentiated op by op)
    with g a leaf: dq, dk, dv and dg within GRAD_REL of each largest."""
    q, k, v, la, do, dst = _gla_inputs(s + dk, b, h, s, dk, dv)
    g = k10.chunk_cumsum(torch.tensor(la), chunk)
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)] + [
        g.clone().requires_grad_()]
    o, st = k10.gla_chunks_plain(*xs, chunk)
    out = (o * torch.tensor(do)).sum()
    if with_dstate:
        out = out + (st * torch.tensor(dst)).sum()
    want = torch.autograd.grad(out, xs)
    _, final, states = k10.gla_chunks_plain(
        *(x.detach() for x in xs), chunk, with_states=True)
    assert torch.equal(states[:, :, -1], final)
    got = k10.gla_chunks_backward_plain(
        *(x.detach() for x in xs), states, torch.tensor(do),
        torch.tensor(dst) if with_dstate else None, chunk)
    for g_, w in zip(got, want):
        assert g_.dtype == torch.float32 and g_.shape == w.shape
        assert _rel(g_, w) <= GRAD_REL


def test_gla_chunks_function_on_the_cpu():
    """``gla_chunks`` on float32 CPU tensors requiring grad goes through
    ``GlaChunks`` (o and the state bitwise the plain forward's, its
    states those of ``gla_chunks_plain(with_states=True)``), launching
    nothing; without grad, or on bfloat16 CPU tensors, the plain forward
    as before."""
    q, k, v, la, do, _ = _gla_inputs(3, 1, 2, 64, 16, 8)
    g = k10.chunk_cumsum(torch.tensor(la), 16)
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    before = (k10.LIB.launches, k10.BWD_LIB.launches)
    o, st = k10.gla_chunks(*xs, g, 16)
    assert o.grad_fn is not None and "GlaChunks" in type(o.grad_fn).__name__
    want_o, want_st = k10.gla_chunks_plain(*(x.detach() for x in xs), g, 16)
    assert torch.equal(o, want_o) and torch.equal(st, want_st)
    torch.autograd.grad((o * torch.tensor(do)).sum(), xs)
    assert (k10.LIB.launches, k10.BWD_LIB.launches) == before
    with torch.no_grad():
        o2, _ = k10.gla_chunks(*xs, g, 16)
    assert o2.grad_fn is None and torch.equal(o2, want_o)
    xb = [x.detach().bfloat16().requires_grad_() for x in xs]
    ob, _ = k10.gla_chunks(*xb, g, 16)
    assert "GlaChunks" not in type(ob.grad_fn).__name__


@pytest.mark.parametrize("with_dstate", [False, True])
def test_gla_blocked_backward_vs_jax_grad(with_dstate, monkeypatch):
    """K10 on heads wider than MAX_HEAD_DIM (``ops.gla_blocked``: mLSTM's
    route in float32) at dk 256 / dv 129: two 128-wide key blocks taken
    as extra heads, value blocks of 128 and 1.  Through
    ``models.ssm.gla_chunked``, the gradients go through ``GlaChunks``
    (the plain backward called once a value block, the last 1 wide)
    within GRAD_REL of jax.grad of the reference's ``gla_chunked``, with
    and without a final-state gradient."""
    b, h, s, dk, dv, chunk = 1, 2, 64, 256, 129, 32
    q, k, v, la, do, dst = _gla_inputs(dk + dv, b, h, s, dk, dv)

    def loss(q_, k_, v_, la_):
        o, st = ref_gla_chunked(q_, k_, v_, la_, chunk)
        out = jnp.sum(o * do)
        return out + jnp.sum(st * dst) if with_dstate else out

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, la)))
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v, la)]
    spy = _Spy(monkeypatch, k10, "gla_chunks_backward_plain")
    o, st = tssm.gla_chunked(*xs, chunk)
    out = (o * torch.tensor(do)).sum()
    if with_dstate:
        out = out + (st * torch.tensor(dst)).sum()
    got = torch.autograd.grad(out, xs)
    assert spy.calls == 2
    assert sorted(a[2].shape[-1] for a in spy.args) == [1, 128]
    assert all(a[0].shape == (b, 2 * h, s, 128) for a in spy.args)
    for name, g, w in zip(("dq", "dk", "dv", "dlog_a"), got, want):
        assert tuple(g.shape) == np.shape(w)
        assert _rel(g, w) <= GRAD_REL, name


def test_gla_backward_raises_on_the_card_without_a_kernel(monkeypatch):
    """bfloat16 CUDA inputs to ``gla_chunks``, and ``gla_wide``, with a
    gradient asked for raise NotImplementedError naming K10's backward
    before any launch."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    g = torch.zeros(1, 2, 64)
    xs = [torch.zeros(1, 2, 64, 16, dtype=torch.bfloat16,
                      requires_grad=True) for _ in range(3)]
    before = (k10.LIB.launches, k10.BWD_LIB.launches, k10.WIDE_LAUNCHES)
    with pytest.raises(NotImplementedError, match="K10 backward"):
        k10.gla_chunks(*xs, g, 16)
    with pytest.raises(NotImplementedError, match="K10 backward"):
        k10.gla_wide(*xs, g, 16)
    assert (k10.LIB.launches, k10.BWD_LIB.launches,
            k10.WIDE_LAUNCHES) == before


def _gla_src():
    """``csrc/gla_bwd.cu`` and the shared header whose 32-row steps it
    takes (``attention/csrc/tf32_split.cuh``)."""
    src = _cu_src(os.path.join(os.path.dirname(k10.__file__), "gla_bwd.cu"))
    return src + open(k9.TF32_SPLIT_HEADER).read()


def _gla_consts():
    """The K10 backward's tiling: (kBM, kBN), the resident tiles' and the
    steps' rows."""
    get = lambda n: int(re.search(rf"constexpr int {n} = (\d+);",
                                  _gla_src()).group(1))
    return get("kBM"), get("kBN")


def _mm_exact(a, b):
    return a @ b


def _mm_tf32(three):
    """A product as the kernels take it on the tensor cores: the two
    operands split into TF32 parts (``_split``, the emulated
    ``cvt.rna.tf32.f32``), (a_hi b_lo + a_lo b_hi) + a_hi b_hi in float32,
    or, with ``three`` False, one product a_hi b_hi."""
    def mm(a, b):
        ah, al = _split(a)
        bh, bl = _split(b)
        if not three:
            return ah @ bh
        return (ah @ bl + al @ bh) + ah @ bh
    return mm


def _emulate_gla_bwd(q, k, v, g, states, do, dstate, chunk,
                     mm=_mm_exact, dtype=torch.float64):
    """``csrc/gla_bwd.cu``'s schedule in torch, in ``dtype`` with its
    products through ``mm``: U_c over 32-row steps of (q e^g)^T do, the dS
    chain; the dk, dv kernel: a 64-row key tile over the 32-row query
    steps from the diagonal on (B^T = K Q^T and A^T = V dO^T masked by s
    <= t < L and decayed by e^{g_t - g_s}, then dV += B^T dO, dK += A^T Q,
    each step's product added to the sums), then the state terms
    e^{g_L - g_s} K dS_c and e^{g_L - g_s} V dS_c^T; the dq kernel: a
    64-row query tile over the 32-row key steps up to the diagonal (A =
    dO V^T masked and decayed, dQ += A K), then e^{g_t} dO S_{c-1}^T; dg =
    q . dq - k . dk, <dS_c, S_c> added at the chunk's last row.  Rows past
    the chunk are zero in every tile."""
    bm, bn = _gla_consts()
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    nc, bh = s // chunk, b * h
    f = lambda x, *shape: x.reshape(*shape).to(dtype)
    qf, kf, vf = f(q, bh, s, dk), f(k, bh, s, dk), f(v, bh, s, dv)
    gf, dof = f(g, bh, s), f(do, bh, s, dv)
    st = f(states, bh, nc, dk, dv)

    def rows(x, c0, r0, n):         # rows [r0, r0 + n) of chunk c0, zero
        out = torch.zeros((bh, n) + x.shape[2:], dtype=dtype)  # past it
        m = max(0, min(n, chunk - r0))
        out[:, :m] = x[:, c0 + r0:c0 + r0 + m]
        return out

    ns = -(-chunk // bn)
    u = torch.zeros_like(st)
    for c in range(1, nc):
        c0 = c * chunk
        for i in range(ns):
            qe = rows(qf, c0, i * bn, bn) * torch.exp(
                rows(gf, c0, i * bn, bn))[..., None]
            u[:, c] += mm(qe.transpose(1, 2), rows(dof, c0, i * bn, bn))
    ds = torch.empty_like(st)
    x = (torch.zeros((bh, dk, dv), dtype=dtype) if dstate is None
         else f(dstate, bh, dk, dv))
    for c in reversed(range(nc)):
        ds[:, c] = x
        if c > 0:
            x = torch.exp(gf[:, c * chunk + chunk - 1])[:, None, None] * x \
                + u[:, c]
    out = [torch.zeros_like(t) for t in (qf, kf, vf, gf)]
    for c in range(nc):
        c0 = c * chunk
        gl = gf[:, c0 + chunk - 1]
        for j0 in range(0, chunk, bm):
            ks, vs = rows(kf, c0, j0, bm), rows(vf, c0, j0, bm)
            gs, sr = rows(gf, c0, j0, bm), torch.arange(j0, j0 + bm)
            adk = torch.zeros((bh, bm, dk), dtype=dtype)
            adv = torch.zeros((bh, bm, dv), dtype=dtype)
            for i in range(j0 // bn, ns):
                qt, ot = rows(qf, c0, i * bn, bn), rows(dof, c0, i * bn, bn)
                gt, tr = rows(gf, c0, i * bn, bn), torch.arange(i * bn,
                                                                (i + 1) * bn)
                live = (sr[:, None] <= tr[None, :]) & (tr[None, :] < chunk)
                dec = torch.exp(gt[:, None, :] - gs[:, :, None])
                bt = torch.where(live, mm(ks, qt.transpose(1, 2)) * dec, 0.0)
                at = torch.where(live, mm(vs, ot.transpose(1, 2)) * dec, 0.0)
                adv = adv + mm(bt, ot)
                adk = adk + mm(at, qt)
            w = torch.exp(gl[:, None] - gs)[..., None]
            adk = adk + w * mm(vs, ds[:, c].transpose(1, 2))
            adv = adv + w * mm(ks, ds[:, c])
            n = min(bm, chunk - j0)
            out[1][:, c0 + j0:c0 + j0 + n] = adk[:, :n]
            out[2][:, c0 + j0:c0 + j0 + n] = adv[:, :n]
        for i0 in range(0, chunk, bm):
            ot, gt = rows(dof, c0, i0, bm), rows(gf, c0, i0, bm)
            tr = torch.arange(i0, i0 + bm)
            adq = torch.zeros((bh, bm, dk), dtype=dtype)
            for j in range(min(ns, (i0 + bm + bn - 1) // bn)):
                ks, vs = rows(kf, c0, j * bn, bn), rows(vf, c0, j * bn, bn)
                gs, sr = rows(gf, c0, j * bn, bn), torch.arange(j * bn,
                                                                (j + 1) * bn)
                live = (sr[None, :] <= tr[:, None]) & (tr[:, None] < chunk)
                a = torch.where(live, mm(ot, vs.transpose(1, 2)) * torch.exp(
                    gt[:, :, None] - gs[:, None, :]), 0.0)
                adq = adq + mm(a, ks)
            if c > 0:
                adq = adq + torch.exp(gt)[..., None] * mm(
                    ot, st[:, c - 1].transpose(1, 2))
            n = min(bm, chunk - i0)
            out[0][:, c0 + i0:c0 + i0 + n] = adq[:, :n]
        r = slice(c0, c0 + chunk)
        out[3][:, r] = (qf[:, r] * out[0][:, r]).sum(-1) - (
            kf[:, r] * out[1][:, r]).sum(-1)
        out[3][:, c0 + chunk - 1] += (ds[:, c] * st[:, c]).sum((1, 2))
    return [o.reshape(t.shape) for o, t in zip(out, (q, k, v, g))]


#: The backward kernel's test shapes (B, H, S, dk, dv, chunk).
GLA_SCHEDULE_CASES = [
    (1, 2, 512, 64, 64, 256),    # zamba2's chunk and heads, four key tiles
    (1, 2, 260, 16, 24, 130),    # a chunk that is not whole tiles
    (2, 1, 96, 128, 32, 24),     # a chunk shorter than one step
    (1, 1, 64, 8, 8, 64)]        # one chunk: no U, no chain


def _gla_schedule_inputs(b, h, s, dk, dv, chunk):
    q, k, v, la, do, dst = _gla_inputs(s + chunk, b, h, s, dk, dv)
    q, k, v, do, dst = (torch.tensor(x) for x in (q, k, v, do, dst))
    g = k10.chunk_cumsum(torch.tensor(la), chunk)
    _, _, states = k10.gla_chunks_plain(q, k, v, g, chunk, with_states=True)
    return q, k, v, g, states, do, dst


@pytest.mark.parametrize("b,h,s,dk,dv,chunk", GLA_SCHEDULE_CASES)
def test_gla_backward_kernel_schedule(b, h, s, dk, dv, chunk):
    """The backward kernel's tiles, steps, masks and chain, emulated in
    float64 (``_emulate_gla_bwd``), within GRAD_REL of the plain
    backward."""
    args = _gla_schedule_inputs(b, h, s, dk, dv, chunk)
    want = k10.gla_chunks_backward_plain(*args, chunk)
    got = _emulate_gla_bwd(*args, chunk)
    for g_, w in zip(got, want):
        assert _rel(g_, w.numpy()) <= GRAD_REL


@pytest.mark.parametrize("case", GLA_SCHEDULE_CASES + [
    pytest.param(GLA_SCHEDULE_CASES[0] + ("one",), id="one-product")])
def test_gla_backward_tf32_precision(case):
    """Why the backward takes three TF32 products: its schedule emulated
    at its precision (float32 sums, every product three TF32 products of
    split operands, each step's product added in float32) holds dq, dk,
    dv and dg within GRAD_REL of ``gla_chunks_backward_plain``, dg (a
    difference of dots of the gradients) included; one TF32 product a
    product, at zamba2's chunk, is witnessed outside it."""
    *shape, chunk = case[:6]
    three = len(case) == 6
    args = _gla_schedule_inputs(*shape, chunk)
    want = k10.gla_chunks_backward_plain(*args, chunk)
    got = _emulate_gla_bwd(*args, chunk, mm=_mm_tf32(three),
                           dtype=torch.float32)
    err = max(_rel(g_, w.numpy()) for g_, w in zip(got, want))
    if three:
        assert err <= GRAD_REL, err
    else:
        assert err > GRAD_REL, err


def _cu_src(path):
    return open(os.path.join(os.path.dirname(path), "csrc",
                             os.path.basename(path))).read()


def _smem_struct(src, name, d, consts):
    """The members of the source's ``struct name`` (templated on D or
    not), each evaluated from its definition."""
    body = re.search(rf"struct {name} {{(.*?)\n}};", src, re.S).group(1)
    env = dict(consts, D=d)
    for member, expr in re.findall(
            r"static constexpr uint32_t (\w+) = ([^;]+);", body):
        env[member] = eval(" ".join(expr.split()).replace("/", "//"), {},
                           env)
    return env


def _check_layout(m, tiles, end_name):
    """Each named operand tile of the layout m starts on a 1024-byte
    boundary (the 128-byte swizzle's 8-row atom) where the one before
    ends, and the block, alignment slack included, fits an SM's 232,448
    bytes."""
    end = 0
    for name, size in tiles:
        assert m[name] == end and m[name] % 1024 == 0, name
        end += size
    assert m[end_name] >= end
    assert m["kBytes"] <= 232448
    return end


@pytest.mark.parametrize("d", [32, 64, 128])
def test_gla_backward_shared_memory_fits(d):
    """The backward kernels' shared memory at head dims up to d, evaluated
    from ``Smem<D>`` (the dk, dv kernel), ``QSmem<D>`` (the dq kernel) and
    ``USmem<D>`` (U_c) in the source, D the instantiation d takes (64 at
    d <= 64): every operand tile on a 1024-byte boundary, each block
    within 232,448 bytes, and at D 64 (zamba2's heads) each within half of
    an SM's 233,472 less a block's reserved 1,024, so two blocks an SM fit
    (the dq and U kernels run two; the dk, dv kernel's registers hold it to
    one)."""
    src = _gla_src()
    consts = {n: int(x) for n, x in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    big = 64 if d <= 64 else 128
    part, raw = consts["kBM"] * big * 4, consts["kBN"] * big * 4
    assert consts["kBN"] * big // 4 % consts["kThreads"] == 0
    m = _smem_struct(src, "Smem", big, consts)
    end = _check_layout(m, [("kAhi", part), ("kAlo", part), ("kBhi", part),
                            ("kBlo", part), ("kX", part), ("kY", part),
                            ("kRawX", raw), ("kRawY", raw)], "kBytes")
    assert m["kBytes"] == end + 1024
    q = _smem_struct(src, "QSmem", big, consts)
    _check_layout(q, [("kAhi", part), ("kAlo", part), ("kX", part),
                      ("kY", part), ("kRawX", raw), ("kRawY", raw)], "kG")
    u = _smem_struct(src, "USmem", big, consts)
    _check_layout(u, [("kX", part), ("kY", part), ("kRawX", raw),
                      ("kRawY", raw)], "kG")
    if big == 64:
        for lay in (m, q, u):
            assert 2 * (lay["kBytes"] + 1024) <= 233472


# ---------------------------------------------------------------------------
# K9's backward at MLA's head
# ---------------------------------------------------------------------------

def _mla_inputs(seed, b, h, kv, s, dh=192, dv=128):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, dh)).astype(np.float32),
            rng.normal(size=(b, kv, s, dh)).astype(np.float32),
            rng.normal(size=(b, kv, s, dv)).astype(np.float32),
            rng.normal(size=(b, h, s, dv)).astype(np.float32))


@pytest.mark.parametrize("b,h,kv,s", [(1, 2, 2, 128), (1, 4, 2, 128),
                                      (2, 3, 3, 64), (1, 4, 1, 192)])
def test_mla_backward_vs_jax_grad(b, h, kv, s):
    """``flash_backward_plain`` at dh 192 / dv 128 (H = KV and G > 1, S =
    T, causal: the reference's bottom-right mask is the kernel's
    top-left one there) within GRAD_REL of jax.grad of
    ``repro.models.attention.attention`` at the same scale dh ** -0.5."""
    from repro.models import ModelConfig as RefConfig
    from repro.models.attention import attention as ref_attention
    q, k, v, do = _mla_inputs(s + h, b, h, kv, s)
    cfg = RefConfig(name="t", num_layers=1, d_model=h * 192, num_heads=h,
                    num_kv_heads=kv, d_ff=4, vocab_size=8,
                    param_dtype="float32", dtype="float32")
    tr = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))   # [B, S, H, d]

    def loss(q_, k_, v_):
        return jnp.sum(ref_attention(q_, k_, v_, cfg) * tr(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(tr(q), tr(k), tr(v))
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = k9.flash_forward_plain(tq, tk, tv, 64, 64, with_lse=True)
    got = k9.flash_backward_plain(tq, tk, tv, o, tdo, lse, 64, 64)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 2, 1, 3)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _rel(g, w) <= GRAD_REL


@pytest.mark.parametrize("causal", [True, False])
def test_mla_flash_attention_function_on_the_cpu(causal):
    """``flash_forward`` at MLA's head on grad-requiring CPU tensors goes
    through ``FlashAttention``: o bitwise the plain forward's and the
    gradients those of autograd of ``flash_forward_plain`` within
    GRAD_REL, nothing launched."""
    q, k, v, do = _mla_inputs(11, 1, 4, 2, 128)
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = k9.flash_forward_plain(*xs, 64, 64, causal)
    want = torch.autograd.grad(o, xs, torch.tensor(do))
    before = (k9.LIB.launches, k9.BWD_LIB.launches, k9.BWD_MLA_LIB.launches)
    o2 = k9.flash_forward(*xs, 64, 64, causal)
    assert type(o2.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(o2, o)
    got = torch.autograd.grad(o2, xs, torch.tensor(do))
    assert (k9.LIB.launches, k9.BWD_LIB.launches,
            k9.BWD_MLA_LIB.launches) == before
    for g, w in zip(got, want):
        assert _rel(g, w.numpy()) <= GRAD_REL


def _mla_src():
    return _cu_src(os.path.join(os.path.dirname(k9.__file__),
                                "flash_f32_bwd_mla.cu"))


def _mla_consts():
    return {n: int(x) for n, x in re.findall(
        r"constexpr int (\w+) = (\d+);", _mla_src())}


def test_mla_backward_shared_memory_fits():
    """``flash_bwd_mla_dkdv_kernel``'s and ``flash_bwd_mla_dq_kernel``'s
    shared memory, ``Smem`` evaluated from its definition in the source:
    the two parts of the resident [64, 192] and [64, 128] tiles, the
    step's two tiles [16, d] each as its parts stacked into [32, d], their
    raw [16, d] tiles and warpgroup 0's 4,096-byte hand-over lie one after
    another from a 1024-aligned base, each operand tile on a 1024-byte
    boundary (the 128-byte swizzle's 8-row atom); two steps' 16 lse and D
    follow, and the block, alignment slack included, fits an SM's 232,448
    bytes.  Warpgroup 1's 8,192 hand-over bytes fit the raw [16, 128] tile
    (dkdv) and the stacked [32, 128] one (dq), and the staging loops'
    chunk counts divide by the threads."""
    c = _mla_consts()
    bm, bn, nt, dh, dv = (c[n] for n in ("kBM", "kBN", "kThreads", "kDH",
                                         "kDV"))
    assert (bm, bn, nt, dh, dv) == (64, 16, 256, 192, 128)
    m = _smem_struct(_mla_src(), "Smem", None, c)
    end = _check_layout(m, [
        ("kAhi", bm * dh * 4), ("kAlo", bm * dh * 4), ("kBhi", bm * dv * 4),
        ("kBlo", bm * dv * 4), ("kX", 2 * bn * dh * 4),
        ("kY", 2 * bn * dv * 4), ("kRawX", bn * dh * 4),
        ("kRawY", bn * dv * 4), ("kXchg", 4096)], "kLse")
    assert m["kLse"] == end and m["kDelta"] == end + 2 * bn * 4
    assert m["kBytes"] == end + 4 * bn * 4 + 1024
    half = c["kWG"] * 8 * 4                  # a warpgroup's 8 floats a thread
    assert half == 4096 and bn * dv * 4 >= 2 * half
    for d in (dh, dv):
        assert bn * d // 4 % nt == 0 and bm * d // 4 % nt == 0
        assert d <= nt                       # stage_cols: a unit a thread


def _emulate_mla_bwd(q, k, v, o, do, lse, causal=True, three=True):
    """``csrc/flash_f32_bwd_mla.cu``'s three launches in torch, with its
    tiles, order and precision: D = rowsum(do o); one dkdv block per (b,
    kv head, 64-row kv tile), which walks its G query heads in order and,
    for each, the 16-row query steps from the causal frontier on; one dq
    block per (b, head, 64-row query tile) over the 16-row kv steps up to
    the frontier.  The scores split as the warpgroups take them: S over
    dh's columns 0-127 and 128-159 (warpgroup 0, summed), plus 160-191
    (warpgroup 1), dP over dv's 128; each a chain of three TF32 products
    (``_mm_tf32``; one with ``three`` False), P and dS in float32, every
    step's dV, dK, dQ product added to the float32 sums.  Returns (dq,
    dk, dv, visits), visits counting each (b, head, 16-row query step,
    64-row kv tile) the dkdv blocks took."""
    c = _mla_consts()
    bm, bn, dh_k, dv_k = c["kBM"], c["kBN"], c["kDH"], c["kDV"]
    mm = _mm_tf32(three)
    b, h, s, dh = q.shape
    kv, t, dv = k.shape[1], k.shape[2], v.shape[-1]
    g_ = h // kv
    scale = float(np.float32(dh ** -0.5))
    padc = lambda x, n: torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    qp, kp = padc(q, dh_k), padc(k, dh_k)
    vp, dop = padc(v, dv_k), padc(do, dv_k)

    def score(a, bt):              # a [M, 192], bt [N, 192]: S's three parts
        cut = lambda x, lo, hi: x[:, lo:hi]
        s0 = mm(cut(a, 0, 128), cut(bt, 0, 128).T) + mm(
            cut(a, 128, 160), cut(bt, 128, 160).T)
        return s0 + mm(cut(a, 160, 192), cut(bt, 160, 192).T)

    def tile(x, r0, rows, n):      # rows [r0, r0 + rows) zero past n
        out = torch.zeros((rows,) + x.shape[1:], dtype=x.dtype)
        m_ = max(0, min(rows, n - r0))
        out[:m_] = x[r0:r0 + m_]
        return out

    delta = (do * o).sum(-1)
    dq, dk, dvv = (torch.zeros_like(x) for x in (q, k, v))
    visits = {}
    nk, nq = -(-t // bm), -(-s // bn)
    for blk in range(b * kv * nk):              # the longest tiles first
        kt_i, bkv = blk // (b * kv), blk % (b * kv)
        bi, kvh = bkv // kv, bkv % kv
        t0 = kt_i * bm
        kt, vt = tile(kp[bi, kvh], t0, bm, t), tile(vp[bi, kvh], t0, bm, t)
        adk = torch.zeros((bm, dh_k))
        adv = torch.zeros((bm, dv_k))
        rows = t0 + torch.arange(bm)[:, None]
        for gg in range(g_):
            hh = kvh * g_ + gg
            for qi in range(min(nq, t0 // bn) if causal else 0, nq):
                q0 = qi * bn
                qs = tile(qp[bi, hh] * scale, q0, bn, s)
                os_ = tile(dop[bi, hh], q0, bn, s)
                lt, dt = tile(lse[bi, hh], q0, bn, s), tile(delta[bi, hh], q0,
                                                            bn, s)
                cols = q0 + torch.arange(bn)[None, :]
                live = (cols < s) & (rows < t) & ((rows <= cols) | (not causal))
                pt = torch.where(live, torch.exp(score(kt, qs) - lt), 0.0)
                dst = pt * (mm(vt, os_.T) - dt)
                adv = adv + mm(pt, os_)
                adk = adk + mm(dst, qs)
                key = (bi, hh, qi, kt_i)
                visits[key] = visits.get(key, 0) + 1
        n = max(0, min(bm, t - t0))
        dk[bi, kvh, t0:t0 + n] = adk[:n, :dh]
        dvv[bi, kvh, t0:t0 + n] = adv[:n, :dv]
    nq, nk = -(-s // bm), -(-t // bn)
    for blk in range(b * h * nq):
        qi, bh = nq - 1 - blk // (b * h), blk % (b * h)
        bi, hh = bh // h, bh % h
        q0 = qi * bm
        qs = tile(qp[bi, hh] * scale, q0, bm, s)
        os_ = tile(dop[bi, hh], q0, bm, s)
        lt = tile(lse[bi, hh], q0, bm, s)[:, None]
        dt = tile(delta[bi, hh], q0, bm, s)[:, None]
        rows = q0 + torch.arange(bm)[:, None]
        last = min(nk, (q0 + bm + bn - 1) // bn) if causal else nk
        adq = torch.zeros((bm, dh_k))
        for kt_i in range(last):
            t0 = kt_i * bn
            kt = tile(kp[bi, hh // g_], t0, bn, t)
            vt = tile(vp[bi, hh // g_], t0, bn, t)
            cols = t0 + torch.arange(bn)[None, :]
            live = (rows < s) & (cols < t) & ((cols <= rows) | (not causal))
            p = torch.where(live, torch.exp(score(qs, kt) - lt), 0.0)
            ds = p * (mm(os_, vt.T) - dt)
            adq = adq + mm(ds, kt)
        n = max(0, min(bm, s - q0))
        dq[bi, hh, q0:q0 + n] = adq[:n, :dh] * scale
    return dq, dk, dvv, visits


@pytest.mark.parametrize("b,h,kv,s,t,causal", [
    (1, 4, 2, 200, 200, True),       # S not whole tiles, G 2
    (2, 4, 2, 128, 256, False),      # non-causal, S < T, G 2
    (1, 2, 2, 96, 96, True)])        # MHA, S = 1.5 kv tiles
def test_mla_backward_schedule_within_tolerance(b, h, kv, s, t, causal):
    """The MLA backward kernel's schedule and precision emulated
    (``_emulate_mla_bwd``) at dh 192 / dv 128, against
    ``flash_backward_plain`` (padded to the plain version's tiles) within
    GRAD_REL of the largest gradient; every (head, 16-row query step,
    64-row kv tile) pair under the causal frontier visited once by the
    dkdv blocks; two runs bitwise.  One TF32 product a product is
    witnessed outside GRAD_REL at the first shape."""
    c = _mla_consts()
    bm, bn = c["kBM"], c["kBN"]
    rng = np.random.default_rng(s * 5 + t + h)
    q = torch.tensor(rng.normal(size=(b, h, s, 192)).astype(np.float32))
    k = torch.tensor(rng.normal(size=(b, kv, t, 192)).astype(np.float32))
    v = torch.tensor(rng.normal(size=(b, kv, t, 128)).astype(np.float32))
    do = torch.tensor(rng.normal(size=(b, h, s, 128)).astype(np.float32))
    sp, tp = s + -s % 64, t + -t % 64
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))
    # padding is exact here: a real causal query never reads a padded key
    o, lse = k9.flash_forward_plain(pad(q, sp), pad(k, tp), pad(v, tp), 64,
                                    64, causal, with_lse=True)
    o, lse = o[:, :, :s], lse[:, :, :s]
    want = k9.flash_backward_plain(pad(q, sp), pad(k, tp), pad(v, tp),
                                   pad(o, sp), pad(do, sp),
                                   pad(lse[..., None], sp)[..., 0], 64, 64,
                                   causal)
    want = (want[0][:, :, :s], want[1][:, :, :t], want[2][:, :, :t])
    *got, visits = _emulate_mla_bwd(q, k, v, o, do, lse, causal)
    *again, _ = _emulate_mla_bwd(q, k, v, o, do, lse, causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for g_, w in zip(got, want):
        assert _rel(g_, w) <= GRAD_REL
    nq, nk = -(-s // bn), -(-t // bm)
    want_pairs = {(bi, hh, qi, ki) for bi in range(b) for hh in range(h)
                  for qi in range(nq) for ki in range(nk)
                  if not causal or ki * bm <= qi * bn + bn - 1}
    assert set(visits) == want_pairs and set(visits.values()) == {1}
    if s == 200:
        *one, _ = _emulate_mla_bwd(q, k, v, o, do, lse, causal, three=False)
        assert max(_rel(g_, w) for g_, w in zip(one, want)) > GRAD_REL


# ---------------------------------------------------------------------------
# SMOKE train steps through the routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,spied", [
    ("zamba2-7b", ("gla_chunks_backward_plain", "flash_backward_plain")),
    ("deepseek-v2-236b", ("flash_backward_plain",)),
    ("xlstm-1p3b", ("slstm_scan_backward_plain",))])
def test_smoke_train_step_through_the_backward_routes(arch, spied,
                                                      monkeypatch):
    """The SMOKE train step of ``tests/test_torch_train_archs.py`` for
    zamba2 (Mamba2 and the shared attention), deepseek-v2 (MLA) and
    xlstm (sLSTM; its mLSTM layers through ``GlaChunks`` too) on the
    CPU, its gradients through ``GlaChunks``, ``FlashAttention`` and
    ``SlstmScan`` (their plain backwards called, a Mamba2 layer's once,
    an attention layer's once and an sLSTM layer's once), held to the
    reference's step within that file's tolerances."""
    from repro import configs as rconfigs
    from repro.models import model as rmodel
    from repro.sharding.rules import ExecConfig as RefExec
    from repro.train import optim as ropt
    from repro.train.step import make_train_step as ref_make_train_step
    from repro_torch import configs as tconfigs
    from repro_torch.models import model
    from repro_torch.sharding.rules import ExecConfig
    from repro_torch.train.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    from test_torch_train_archs import (LOSS_REL, RTOL, SMOKE_ATOL,
                                        SMOKE_ATOL_DEFAULT,
                                        _assert_params_close, _np_tree,
                                        _smoke_batch)
    rcfg = rconfigs.smoke_config(arch)
    params = rmodel.init(jax.random.PRNGKey(0), rcfg)
    batch = _smoke_batch(rcfg)
    rstep = jax.jit(ref_make_train_step(rcfg, RefExec(),
                                        ropt.AdamWConfig(lr=1e-3)))
    p2, _, want = rstep(params, ropt.adamw_init(params, ropt.AdamWConfig()),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = tconfigs.smoke_config(arch)
    m = model.params_from_reference(_np_tree(params), cfg, device="cpu")
    mods = {"gla": k10, "flash": k9, "slstm": k_slstm}
    spies = {fn: _Spy(monkeypatch, mods[fn.split("_")[0]], fn)
             for fn in spied}
    step = make_train_step(cfg, ExecConfig(), AdamWConfig(lr=1e-3))
    _, got = step(m, adamw_init(m, AdamWConfig()), batch)
    kinds = cfg.layer_kinds()
    n_gla = kinds.count("mamba2")
    n_slstm = kinds.count("slstm")
    n_attn = len(kinds) - n_gla - n_slstm - kinds.count("mlstm")
    if arch.startswith("zamba2"):
        assert spies["gla_chunks_backward_plain"].calls == n_gla
    if n_slstm:
        assert spies["slstm_scan_backward_plain"].calls == n_slstm
    else:
        assert spies["flash_backward_plain"].calls == n_attn
    for key in ("loss", "grad_norm", "ce"):
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=LOSS_REL), key
    _assert_params_close(m, p2, cfg, RTOL,
                         SMOKE_ATOL.get(arch, SMOKE_ATOL_DEFAULT))
