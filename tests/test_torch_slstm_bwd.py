"""The sLSTM scan's float32 backward (``repro_torch.kernels.slstm``:
``SlstmScan`` and ``slstm_scan_backward_plain`` on the CPU) against
``jax.grad`` of the reference's recurrence (``_slstm_cell`` under
``jax.lax.scan``, and at S = 256 ``slstm_apply``'s chunked form: two
checkpointed scans of 128 steps), on the same numpy-seeded inputs; the
plain backward, a scan over chunks of K_CHUNK steps, against the
sequential walk it replaced and against the kernel's schedule, emulated.

Tolerances: dzifo and dr within GRAD_REL = 1e-5 of each gradient's
largest |g| (both sides differentiate the same float32 recurrence, rounding
exp, tanh, the sigmoid and the sums their own ways: ~2e-7 of it seen);
the initial state's gradients the same, and within STATE_RTOL = 5e-5
relative besides, as the forward's c, n and m caches are held (they grow
with S, and so can their gradients).  No bound is under GRAD_REL of
dzifo's largest: on a tie at m' with fg = ig = 1 the gradient of m0 is
(af - ai) / 2, two of dzifo's terms cancelling to their rounding noise.

The tie rule is jax's: ``max`` gives half of the gradient to each side on
a tie, at m' = max(f + m, i) and at max(n, 1).  Autograd of the plain
forward (``torch.clamp(n, min=1)``) passes all of it at n == 1, so ties
are held to ``jax.grad``, never to autograd.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro_torch.kernels.slstm import kernel as tkernel

GRAD_REL = 1e-5
STATE_RTOL = 5e-5


def _inputs(rng, b, s, d, state: bool):
    """zifo, r and the state as ``tests/test_torch_slstm.py`` draws them;
    the gradients of hs and of the final state."""
    zifo = rng.normal(size=(b, s, 4 * d)).astype(np.float32)
    zifo[..., 2 * d:3 * d] += 0.5
    r = (rng.normal(size=(4, d)) * 0.5).astype(np.float32)
    hcnm = [np.zeros((b, d), np.float32) for _ in range(4)]
    if state:
        hcnm = [rng.normal(size=(b, d)).astype(np.float32) for _ in range(4)]
        hcnm[2] = np.abs(hcnm[2]) + 0.5
    dhs = rng.normal(size=(b, s, d)).astype(np.float32)
    dfin = [rng.normal(size=(b, d)).astype(np.float32) for _ in range(4)]
    return zifo, r, hcnm, dhs, dfin


def _ref_grads(zifo, r, hcnm, dhs, dfin):
    """jax.grad of sum(hs dhs) + sum_k sum(final_k dfin_k) (dfin None: the
    final state unused) with respect to zifo, r and the initial state,
    through the reference's ``_slstm_cell`` under ``lax.scan``; for S a
    multiple of 128 above it, ``slstm_apply``'s chunked form."""
    s = zifo.shape[1]

    def loss(z, r_, h, c, n, m):
        p = {"r": r_}

        def step(carry, zt):
            carry = rssm._slstm_cell(p, zt, *carry)
            return carry, carry[0]

        zs = jnp.moveaxis(z, 1, 0)
        if s % 128 == 0 and s > 128:
            zc = zs.reshape(s // 128, 128, *zs.shape[1:])

            @jax.checkpoint
            def chunk(carry, zch):
                return jax.lax.scan(step, carry, zch)

            fin, hs = jax.lax.scan(chunk, (h, c, n, m), zc)
            hs = hs.reshape(s, *hs.shape[2:])
        else:
            fin, hs = jax.lax.scan(step, (h, c, n, m), zs)
        out = jnp.sum(jnp.moveaxis(hs, 0, 1) * dhs)
        if dfin is not None:
            out = out + sum(jnp.sum(a * w) for a, w in zip(fin, dfin))
        return out

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *(jnp.asarray(x) for x in [zifo, r] + list(hcnm)))
    return [np.asarray(g) for g in grads]


def _assert_grads(got, want):
    names = ("dzifo", "dr", "dh0", "dc0", "dn0", "dm0")
    floor = float(np.abs(want[0]).max())
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, name
        atol = GRAD_REL * max(float(np.abs(w).max()), floor)
        rtol = STATE_RTOL if name in names[2:] else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


def _plain_backward(zifo, r, hcnm, dhs, dfin):
    """``slstm_scan_backward_plain`` on the plain forward's records."""
    z, rr = torch.tensor(zifo), torch.tensor(r)
    st = [torch.tensor(a) for a in hcnm]
    hs, _, recs = tkernel.slstm_scan_plain(z, rr, *st, with_states=True)
    dfin_t = [None] * 4 if dfin is None else [torch.tensor(a) for a in dfin]
    return tkernel.slstm_scan_backward_plain(z, rr, *st, hs, *recs,
                                             torch.tensor(dhs), *dfin_t)


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("s", [1, 16, 129, 256])
def test_backward_plain_vs_jax_grad(s, state, with_final):
    """``slstm_scan_backward_plain`` within GRAD_REL (STATE_RTOL) of
    jax.grad of the reference's recurrence: a decode step (S 1), a short
    scan, S 129 and S 256 (``slstm_apply``'s two checkpointed chunks),
    from the zero state and from a nonzero one, with and without the
    final state's gradients."""
    zifo, r, hcnm, dhs, dfin = _inputs(
        np.random.default_rng(s * 4 + 2 * state + with_final), 2, s, 8, state)
    dfin = dfin if with_final else None
    want = _ref_grads(zifo, r, hcnm, dhs, dfin)
    _assert_grads(_plain_backward(zifo, r, hcnm, dhs, dfin), want)


def _tie_inputs():
    """Dyadic inputs with ties from the zero state: at step 0, i >= f in
    every channel (so m' = i and n = fg 0 + e^0 = 1 exactly), and f == i
    exactly in channel 3 of sequence 0 (a tie at m'), whose z and hs
    gradient at step 0 are nonzero.  Where i > f, i's gradient cancels
    the n == 1 term (di = ai + dm' = dm - af); at the tie half of it
    stays, so the rule at n == 1 reaches dzifo and dm0 there, and dn0
    everywhere."""
    rng = np.random.default_rng(11)
    b, s, d = 2, 6, 8
    zifo = (rng.integers(-8, 9, size=(b, s, 4 * d)) / 8).astype(np.float32)
    zifo[:, 0, d:2 * d] = np.abs(zifo[:, 0, d:2 * d])
    zifo[:, 0, 2 * d:3 * d] = -np.abs(zifo[:, 0, 2 * d:3 * d])
    zifo[0, 0, 2 * d + 3] = zifo[0, 0, d + 3] = 0.25
    zifo[0, 0, 3] = 0.5
    r = (rng.integers(-4, 5, size=(4, d)) / 8).astype(np.float32)
    hcnm = [np.zeros((b, d), np.float32) for _ in range(4)]
    dhs = (rng.integers(-8, 9, size=(b, s, d)) / 8).astype(np.float32)
    dhs[0, 0, 3] = 0.5
    return zifo, r, hcnm, dhs


def test_ties_take_jax_half_rule():
    """On the dyadic ties of ``_tie_inputs`` (n0 = 0 requiring grad, so n
    == 1 exactly at step 0; f + m == i exactly in one channel): every
    gradient through ``SlstmScan`` within the tolerances of jax.grad.
    Autograd of the plain forward, whose clamp passes the whole gradient
    at n == 1, is witnessed outside them at dn0, dm0 and dzifo."""
    zifo, r, hcnm, dhs = _tie_inputs()
    want = _ref_grads(zifo, r, hcnm, dhs, None)
    xs = [torch.tensor(x, requires_grad=True) for x in [zifo, r] + hcnm]
    hs, _ = tkernel.slstm_scan(*xs)
    assert type(hs.grad_fn).__name__ == "SlstmScanBackward"
    assert float(torch.tensor(zifo)[0, 0, 16 + 3]) == \
        float(torch.tensor(zifo)[0, 0, 8 + 3])
    got = torch.autograd.grad((hs * torch.tensor(dhs)).sum(), xs)
    _assert_grads(got, want)
    ys = [torch.tensor(x, requires_grad=True) for x in [zifo, r] + hcnm]
    hs2, _ = tkernel.slstm_scan_plain(*ys)
    auto = torch.autograd.grad((hs2 * torch.tensor(dhs)).sum(), ys)
    floor = float(np.abs(want[0]).max())
    for i in (0, 4, 5):
        w = want[i]
        err = float(np.abs(auto[i].numpy() - w).max())
        assert err > GRAD_REL * max(float(np.abs(w).max()), floor), i


@pytest.mark.parametrize("with_final", [False, True])
def test_function_is_the_plain_versions(with_final):
    """``slstm_scan`` on float32 CPU tensors requiring grad goes through
    ``SlstmScan``: hs and the final state bitwise the plain forward's
    without records, its records those of ``slstm_scan_plain(with_states=
    True)``, and its gradients bitwise ``slstm_scan_backward_plain`` called
    on them, launching nothing.  Without grad, and for bfloat16 zifo on
    the CPU, the plain forward as before."""
    zifo, r, hcnm, dhs, dfin = _inputs(np.random.default_rng(3), 3, 37, 8,
                                       True)
    xs = [torch.tensor(x, requires_grad=True) for x in [zifo, r] + hcnm]
    before = (tkernel.LIB.launches, tkernel.BWD_LIB.launches)
    hs, fin = tkernel.slstm_scan(*xs)
    assert type(hs.grad_fn).__name__ == "SlstmScanBackward"
    det = [x.detach() for x in xs]
    want_hs, want_fin = tkernel.slstm_scan_plain(*det)
    rec_hs, rec_fin, recs = tkernel.slstm_scan_plain(*det, with_states=True)
    assert torch.equal(hs, want_hs) and torch.equal(rec_hs, want_hs)
    for a, b_, c_ in zip(fin, want_fin, rec_fin):
        assert torch.equal(a, b_) and torch.equal(c_, b_)
    for k, rec in enumerate(recs):
        assert torch.equal(rec[:, -1], want_fin[k + 1])
    dfin_t = [torch.tensor(a) for a in dfin] if with_final else [None] * 4
    out = (hs * torch.tensor(dhs)).sum()
    if with_final:
        out = out + sum((a * w).sum() for a, w in zip(fin, dfin_t))
    got = torch.autograd.grad(out, xs)
    want = tkernel.slstm_scan_backward_plain(*det, want_hs, *recs,
                                             torch.tensor(dhs), *dfin_t)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (tkernel.LIB.launches, tkernel.BWD_LIB.launches) == before
    with torch.no_grad():
        hs2, _ = tkernel.slstm_scan(*xs)
    assert hs2.grad_fn is None and torch.equal(hs2, want_hs)
    zb = xs[0].detach().bfloat16().requires_grad_()
    hsb, _ = tkernel.slstm_scan(zb, *xs[1:])
    assert "SlstmScan" not in type(hsb.grad_fn).__name__


def test_only_final_state_gradient():
    """With hs unused (its gradient None, taken as zero) and only the final
    c's gradient flowing, ``SlstmScan``'s gradients equal the plain
    backward's with dhs and the other final gradients zero."""
    zifo, r, hcnm, _, dfin = _inputs(np.random.default_rng(4), 2, 20, 8, True)
    xs = [torch.tensor(x, requires_grad=True) for x in [zifo, r] + hcnm]
    _, fin = tkernel.slstm_scan(*xs)
    got = torch.autograd.grad((fin[1] * torch.tensor(dfin[1])).sum(), xs)
    zeros = np.zeros_like(zifo[..., :8])
    want = _plain_backward(zifo, r, hcnm, zeros,
                           [np.zeros_like(dfin[0]), dfin[1],
                            np.zeros_like(dfin[2]), np.zeros_like(dfin[3])])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_backward_raises_on_the_card_without_a_kernel(monkeypatch):
    """bfloat16 zifo on the card with a gradient asked for raises
    NotImplementedError naming the sLSTM scan's backward, before any
    launch and without calling a plain version."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    called = []
    for fn in ("slstm_scan_plain", "slstm_scan_backward_plain"):
        monkeypatch.setattr(tkernel, fn,
                            lambda *a, _fn=fn, **k: called.append(_fn))
    zifo = torch.zeros(1, 4, 32, dtype=torch.bfloat16, requires_grad=True)
    r = torch.zeros(4, 8)
    st = [torch.zeros(1, 8) for _ in range(4)]
    before = (tkernel.LIB.launches, tkernel.BWD_LIB.launches)
    with pytest.raises(NotImplementedError, match="sLSTM scan backward"):
        tkernel.slstm_scan(zifo, r, *st)
    assert (tkernel.LIB.launches, tkernel.BWD_LIB.launches) == before
    assert called == []


@pytest.mark.parametrize("bad", ["cs", "dhs", "dm", "dtype"])
def test_backward_rejects_what_the_kernel_does_not_take(bad):
    """The backward's shape and dtype checks, on the CPU as on the card."""
    zifo, r, hcnm, dhs, dfin = _inputs(np.random.default_rng(6), 2, 5, 8,
                                       True)
    z, rr = torch.tensor(zifo), torch.tensor(r)
    st = [torch.tensor(a) for a in hcnm]
    hs, _, recs = tkernel.slstm_scan_plain(z, rr, *st, with_states=True)
    recs, d_hs = list(recs), torch.tensor(dhs)
    dfin_t = [torch.tensor(a) for a in dfin]
    if bad == "cs":
        recs[0] = recs[0][:, :-1]
    elif bad == "dhs":
        d_hs = d_hs[..., :-1]
    elif bad == "dm":
        dfin_t[3] = dfin_t[3][:1]
    else:
        z = z.double()
    with pytest.raises(ValueError):
        tkernel.slstm_scan_backward(z, rr, *st, hs, *recs, d_hs, *dfin_t)


# --- the chunked scan against the sequential walk ---------------------------

def _sequential(zifo, r, h, c, n, m, hs, cs, ns, ms, dhs, dfin):
    """The backward as one walk a channel: ``step_back_plain`` over t = S-1
    .. 0 from the final state's gradients, r's sums over t, then over b in
    rising order (the backward's order before it was chunked)."""
    b, s, d4 = zifo.shape
    d = d4 // 4
    zero = torch.zeros((b, d))
    carry = tuple(zero if t is None else t for t in dfin)
    part = (zero,) * 4
    dz = torch.empty_like(zifo)
    for t in reversed(range(s)):
        prev = (hs[:, t - 1], cs[:, t - 1], ns[:, t - 1],
                ms[:, t - 1]) if t else (h, c, n, m)
        carry, part, out = tkernel.step_back_plain(
            r, zifo[:, t].split(d, dim=-1), prev, dhs[:, t], carry, part)
        dz[:, t] = torch.cat(out, dim=-1)
    dr = torch.stack([p[0] for p in part])
    for bi in range(1, b):
        dr = dr + torch.stack([p[bi] for p in part])
    return (dz, dr) + carry


def _plain_args(s, seed, b=3, d=8):
    """The backward's arguments on the plain forward's records, from a
    nonzero state with the final state's gradients."""
    zifo, r, hcnm, dhs, dfin = _inputs(np.random.default_rng(seed), b, s, d,
                                       True)
    z, rr = torch.tensor(zifo), torch.tensor(r)
    st = [torch.tensor(a) for a in hcnm]
    hs, _, recs = tkernel.slstm_scan_plain(z, rr, *st, with_states=True)
    return (z, rr, *st, hs, *recs, torch.tensor(dhs),
            [torch.tensor(a) for a in dfin])


K = tkernel.K_CHUNK


@pytest.mark.parametrize("s", [1, 16, K - 1, K])
def test_one_chunk_is_the_sequential_walk(s):
    """At S <= K_CHUNK (one chunk: no map, no carry) the chunked plain
    backward is bitwise the sequential walk."""
    args = _plain_args(s, s + 60)
    want = _sequential(*args)
    got = tkernel.slstm_scan_backward_plain(*args[:-1], *args[-1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("s", [K + 1, 2 * K + 7, 4 * K + 3])
def test_chunks_stay_near_the_sequential_walk(s):
    """Beyond one chunk the maps round their own way: every gradient within
    the tolerances that hold it to jax.grad (GRAD_REL of max(its own
    largest |g|, dzifo's), the initial state's STATE_RTOL relative
    besides; stated before the first run)."""
    args = _plain_args(s, s + 70)
    want = [w.numpy() for w in _sequential(*args)]
    _assert_grads(tkernel.slstm_scan_backward_plain(*args[:-1], *args[-1]),
                  want)


@pytest.mark.parametrize("with_final", [False, True])
def test_backward_plain_vs_jax_grad_over_chunks(with_final):
    """S = 4 K_CHUNK + 3 (five chunks, the last of three steps; one
    ``lax.scan`` in the reference): the chunked plain backward within
    GRAD_REL (STATE_RTOL) of jax.grad, from a nonzero state."""
    s = 4 * K + 3
    zifo, r, hcnm, dhs, dfin = _inputs(
        np.random.default_rng(s + with_final), 2, s, 8, True)
    dfin = dfin if with_final else None
    want = _ref_grads(zifo, r, hcnm, dhs, dfin)
    _assert_grads(_plain_backward(zifo, r, hcnm, dhs, dfin), want)


# --- the backward kernel's schedule (csrc/slstm_bwd.cu), emulated ------------

def _bwd_constants() -> dict:
    """``constexpr int NAME = VALUE;`` constants of ``csrc/slstm_bwd.cu``."""
    path = os.path.join(os.path.dirname(tkernel.__file__), "csrc",
                        "slstm_bwd.cu")
    with open(path) as f:
        text = f.read()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", text)}


def _emulate_chunks(zifo, r, h, c, n, m, hs, cs, ns, ms, dhs, dfin):
    """slstm_bwd.cu's four phases in torch, a chunk at a time with every
    (b, d) of it at once (a step is element-wise), as its threads of a
    (b, chunk, d) run them: (1) chunks 1 .. nc - 1 push the zero carry
    with dhs and the four unit carries with a zero dhs through
    ``step_back_plain`` in falling t; (2) the carries from the final
    state's gradients, chunk nc - 1 down to 1, each component
    (((aff + x0 a0) + x1 a1) + x2 a2) + x3 a3; (3) each chunk replayed
    from its carry, r's sums from 0; (4) dr: b's chunk sums in falling
    chunk order, the b's in rising order.  Returns (the gradients, how
    often each step's inputs were loaded in each phase, the steps each
    phase computed, in computing order)."""
    kc = _bwd_constants()["kChunk"]
    b, s, d4 = zifo.shape
    d = d4 // 4
    nc = -(-s // kc)
    zero = torch.zeros((b, d))
    fin = tuple(zero if t is None else t for t in dfin)
    loads = {p: [0] * s for p in (1, 3)}
    order = {p: [] for p in (1, 3)}

    def load(phase, t):
        loads[phase][t] += 1
        order[phase].append(t)
        prev = (hs[:, t - 1], cs[:, t - 1], ns[:, t - 1],
                ms[:, t - 1]) if t > 0 else (h, c, n, m)
        return zifo[:, t].split(d, dim=-1), prev, dhs[:, t]

    def steps(j):
        return reversed(range(j * kc, min(s, (j + 1) * kc)))

    maps = {}
    for j in range(1, nc):
        pushes = [(zero,) * 4] + [
            tuple(torch.ones((b, d)) if i == k else zero for i in range(4))
            for k in range(4)]
        for t in steps(j):
            gates, prev, grad = load(1, t)
            pushes = [tkernel.step_back_plain(
                r, gates, prev, grad if p == 0 else zero, v, (zero,) * 4)[0]
                for p, v in enumerate(pushes)]
        maps[j] = pushes
    carries = {nc - 1: fin}
    x = fin
    for j in reversed(range(1, nc)):
        aff, *cols = maps[j]
        x = tuple(aff[i] + x[0] * cols[0][i] + x[1] * cols[1][i]
                  + x[2] * cols[2][i] + x[3] * cols[3][i] for i in range(4))
        carries[j - 1] = x
    dz = torch.full_like(zifo, float("nan"))
    sums = {}
    for j in range(nc):
        carry, part = carries[j], (zero,) * 4
        for t in steps(j):
            gates, prev, grad = load(3, t)
            carry, part, out = tkernel.step_back_plain(r, gates, prev, grad,
                                                       carry, part)
            dz[:, t] = torch.cat(out, dim=-1)
        sums[j] = part
        if j == 0:
            d0 = carry
    dr = None
    for bi in range(b):
        acc = torch.stack([p[bi] for p in sums[nc - 1]])
        for j in reversed(range(nc - 1)):
            acc = acc + torch.stack([p[bi] for p in sums[j]])
        dr = acc if dr is None else dr + acc
    return (dz, dr) + d0, loads, order


@pytest.mark.parametrize("s_of_k", [(0, 1), (1, -1), (1, 0), (1, 1), (2, 0),
                                    (3, 5)])
def test_chunk_schedule_is_the_backward(s_of_k):
    """The kernel's chunked scan (``_emulate_chunks``, kChunk read from
    ``csrc/slstm_bwd.cu`` and equal to ``K_CHUNK``) at S = a kChunk + c:
    S 1, kChunk - 1, kChunk, kChunk + 1, 2 kChunk and 3 kChunk + 5 (one
    partial chunk, whole chunks only, a partial last chunk), B 3, from a
    nonzero state with the final state's gradients.  Phase 1 loads the
    inputs of every step past the first chunk once, phase 3 every step's
    once, each chunk in falling t; and the result is bitwise
    ``slstm_scan_backward_plain``'s."""
    kc = _bwd_constants()["kChunk"]
    assert kc == tkernel.K_CHUNK
    s = max(1, s_of_k[0] * kc + s_of_k[1])
    args = _plain_args(s, s + 40)
    got, loads, order = _emulate_chunks(*args)
    assert loads[1] == [int(t >= kc) for t in range(s)]
    assert loads[3] == [1] * s
    nc = -(-s // kc)
    chunks = [list(reversed(range(j * kc, min(s, (j + 1) * kc))))
              for j in range(nc)]
    assert order[1] == sum(chunks[1:], [])
    assert order[3] == sum(chunks, [])
    want = tkernel.slstm_scan_backward_plain(*args[:-1], *args[-1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
