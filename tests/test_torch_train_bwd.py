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
from repro_torch.models import ssm as tssm

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


def _emulate_gla_bwd(q, k, v, g, states, do, dstate, chunk, tile=64):
    """``csrc/gla_bwd.cu``'s schedule in float64 torch: U_c a chunk, the
    dS chain, then a unit per (head, chunk): dk, dv a 64-row key tile
    over the query tiles from the diagonal on (A, B masked by s <= t < L
    in 64 x 64 tiles, then the state terms), dq a query tile over the key
    tiles up to the diagonal, dg from the written dq and dk."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    nc, bh = s // chunk, b * h
    f = lambda x, *shape: x.reshape(*shape).double()
    qf, kf, vf = f(q, bh, s, dk), f(k, bh, s, dk), f(v, bh, s, dv)
    gf, dof = f(g, bh, s), f(do, bh, s, dv)
    st = f(states, bh, nc, dk, dv)
    u = torch.zeros_like(st)
    for c in range(1, nc):
        r = slice(c * chunk, (c + 1) * chunk)
        u[:, c] = (qf[:, r] * torch.exp(gf[:, r])[..., None]).transpose(
            1, 2) @ dof[:, r]
    ds = torch.empty_like(st)
    x = (torch.zeros((bh, dk, dv), dtype=torch.float64) if dstate is None
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
        for j0 in range(0, chunk, tile):
            rs = torch.arange(j0, j0 + tile)
            live_s = rs < chunk
            ks = torch.where(live_s[:, None], kf[:, c0 + rs.clamp(
                max=chunk - 1)], 0.0)
            vs = torch.where(live_s[:, None], vf[:, c0 + rs.clamp(
                max=chunk - 1)], 0.0)
            gs = torch.where(live_s, gf[:, c0 + rs.clamp(max=chunk - 1)],
                             0.0)
            adk = torch.zeros((bh, tile, dk), dtype=torch.float64)
            adv = torch.zeros((bh, tile, dv), dtype=torch.float64)
            for i0 in range(j0, chunk, tile):
                rt = torch.arange(i0, i0 + tile)
                live_t = rt < chunk
                ix = c0 + rt.clamp(max=chunk - 1)
                qt = torch.where(live_t[:, None], qf[:, ix], 0.0)
                ot = torch.where(live_t[:, None], dof[:, ix], 0.0)
                gt = torch.where(live_t, gf[:, ix], 0.0)
                mask = (rs[None, :] <= rt[:, None]) & live_t[:, None]
                dec = torch.exp(gt[:, :, None] - gs[:, None, :])
                a = torch.where(mask, (ot @ vs.transpose(1, 2)) * dec, 0.0)
                bb = torch.where(mask, (qt @ ks.transpose(1, 2)) * dec, 0.0)
                adk += a.transpose(1, 2) @ qt
                adv += bb.transpose(1, 2) @ ot
            w = torch.exp(gl[:, None] - gs)[..., None]
            adk += w * (vs @ ds[:, c].transpose(1, 2))
            adv += w * (ks @ ds[:, c])
            n = min(tile, chunk - j0)
            out[1][:, c0 + j0:c0 + j0 + n] = adk[:, :n]
            out[2][:, c0 + j0:c0 + j0 + n] = adv[:, :n]
        prev = st[:, c - 1] if c > 0 else torch.zeros_like(st[:, 0])
        for i0 in range(0, chunk, tile):
            rt = torch.arange(i0, i0 + tile)
            live_t = rt < chunk
            ix = c0 + rt.clamp(max=chunk - 1)
            ot = torch.where(live_t[:, None], dof[:, ix], 0.0)
            gt = torch.where(live_t, gf[:, ix], 0.0)
            adq = torch.zeros((bh, tile, dk), dtype=torch.float64)
            for j0 in range(0, i0 + 1, tile):
                rs = torch.arange(j0, j0 + tile)
                live_s = rs < chunk
                jx = c0 + rs.clamp(max=chunk - 1)
                ks = torch.where(live_s[:, None], kf[:, jx], 0.0)
                vs = torch.where(live_s[:, None], vf[:, jx], 0.0)
                gs = torch.where(live_s, gf[:, jx], 0.0)
                mask = (rs[None, :] <= rt[:, None]) & live_t[:, None]
                a = torch.where(mask, (ot @ vs.transpose(1, 2)) * torch.exp(
                    gt[:, :, None] - gs[:, None, :]), 0.0)
                adq += a @ ks
            adq += torch.exp(gt)[..., None] * (ot @ prev.transpose(1, 2))
            n = min(tile, chunk - i0)
            out[0][:, c0 + i0:c0 + i0 + n] = adq[:, :n]
        r = slice(c0, c0 + chunk)
        out[3][:, r] = (qf[:, r] * out[0][:, r]).sum(-1) - (
            kf[:, r] * out[1][:, r]).sum(-1)
        out[3][:, c0 + chunk - 1] += (ds[:, c] * st[:, c]).sum((1, 2))
    return [o.reshape(t.shape) for o, t in zip(out, (q, k, v, g))]


@pytest.mark.parametrize("b,h,s,dk,dv,chunk", [
    (1, 2, 512, 64, 64, 256),    # zamba2's chunk, four 64-row tiles
    (1, 2, 260, 16, 24, 130),    # a chunk that is not whole tiles
    (2, 1, 96, 128, 32, 24),     # a chunk shorter than one tile
    (1, 1, 64, 8, 8, 64)])       # one chunk: no U, no chain
def test_gla_backward_kernel_schedule(b, h, s, dk, dv, chunk):
    """The backward kernel's tiles, masks and chain, emulated in float64
    (``_emulate_gla_bwd``), within GRAD_REL of the plain backward."""
    q, k, v, la, do, dst = _gla_inputs(s + chunk, b, h, s, dk, dv)
    q, k, v, do, dst = (torch.tensor(x) for x in (q, k, v, do, dst))
    g = k10.chunk_cumsum(torch.tensor(la), chunk)
    _, _, states = k10.gla_chunks_plain(q, k, v, g, chunk, with_states=True)
    want = k10.gla_chunks_backward_plain(q, k, v, g, states, do, dst, chunk)
    got = _emulate_gla_bwd(q, k, v, g, states, do, dst, chunk)
    for g_, w in zip(got, want):
        assert _rel(g_, w.numpy()) <= GRAD_REL


def _cu_src(path):
    return open(os.path.join(os.path.dirname(path), "csrc",
                             os.path.basename(path))).read()


@pytest.mark.parametrize("d", [32, 64, 128])
def test_gla_backward_shared_memory_fits(d):
    """``gla_bwd_chunk_kernel<D>``'s shared memory, evaluated from its
    definition in the source, fits a block's 232,448 bytes at every
    instantiation, and D = 64 (zamba2's heads) leaves room for two
    blocks an SM."""
    src = _cu_src(os.path.join(os.path.dirname(k10.__file__), "gla_bwd.cu"))
    body = re.search(r"chunk_smem_bytes\(\) \{\s*return \(size_t\)\((.*?)\)"
                     r" \*\s*sizeof\(float\);", src, re.S).group(1)
    consts = {n: int(x) for n, x in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    floats = eval(" ".join(body.split()), {}, dict(consts, D=d))
    assert 4 * floats <= 232448
    if d <= 64:
        assert 2 * 4 * floats <= 232448


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


def test_mla_backward_shared_memory_fits():
    """``flash_bwd_mla_dkdv_kernel``'s and ``flash_bwd_mla_dq_kernel``'s
    shared memory, evaluated from their definitions in the source, fit a
    block's 232,448 bytes."""
    src = _cu_src(os.path.join(os.path.dirname(k9.__file__),
                               "flash_f32_bwd_mla.cu"))
    consts = {n: int(x) for n, x in re.findall(
        r"constexpr int (\w+) = (\w+);", src) if x.isdigit()}
    consts["kPS"] = consts["kB"] + 4
    tile = lambda d: consts["kB"] * (d + 4)
    for fn in ("dkdv_smem", "dq_smem"):
        body = re.search(rf"{fn}\(\) \{{\s*return sizeof\(float\) \* \((.*?)\);",
                         src, re.S).group(1)
        body = re.sub(r"tile_floats<(\w+)>\(\)", r"tile(\1)", body)
        floats = eval(" ".join(body.split()), {"tile": tile}, consts)
        assert 4 * floats <= 232448, fn


# ---------------------------------------------------------------------------
# SMOKE train steps through the routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,spied", [
    ("zamba2-7b", ("gla_chunks_backward_plain", "flash_backward_plain")),
    ("deepseek-v2-236b", ("flash_backward_plain",))])
def test_smoke_train_step_through_the_backward_routes(arch, spied,
                                                      monkeypatch):
    """The SMOKE train step of ``tests/test_torch_train_archs.py`` for
    zamba2 (Mamba2 and the shared attention) and deepseek-v2 (MLA) on the
    CPU, its gradients through ``GlaChunks`` and ``FlashAttention``
    (their plain backwards called, a Mamba2 layer's once and an attention
    layer's once), held to the reference's step within that file's
    tolerances."""
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
    spies = {fn: _Spy(monkeypatch, k10 if fn.startswith("gla") else k9, fn)
             for fn in spied}
    step = make_train_step(cfg, ExecConfig(), AdamWConfig(lr=1e-3))
    _, got = step(m, adamw_init(m, AdamWConfig()), batch)
    kinds = cfg.layer_kinds()
    n_gla = kinds.count("mamba2")
    n_attn = len(kinds) - n_gla
    if arch.startswith("zamba2"):
        assert spies["gla_chunks_backward_plain"].calls == n_gla
    assert spies["flash_backward_plain"].calls == n_attn
    for key in ("loss", "grad_norm", "ce"):
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=LOSS_REL), key
    _assert_params_close(m, p2, cfg, RTOL,
                         SMOKE_ATOL.get(arch, SMOKE_ATOL_DEFAULT))
