"""The sLSTM scan's float32 backward (``repro_torch.kernels.slstm``:
``SlstmScan`` and ``slstm_scan_backward_plain`` on the CPU) against
``jax.grad`` of the reference's recurrence (``_slstm_cell`` under
``jax.lax.scan``, and at S = 256 ``slstm_apply``'s chunked form: two
checkpointed scans of 128 steps), on the same numpy-seeded inputs.

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


# --- the backward kernel's schedule (csrc/slstm_bwd.cu), emulated ------------

def _bwd_constants() -> dict:
    """``constexpr int NAME = VALUE;`` constants of ``csrc/slstm_bwd.cu``."""
    path = os.path.join(os.path.dirname(tkernel.__file__), "csrc",
                        "slstm_bwd.cu")
    with open(path) as f:
        text = f.read()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", text)}


def _emulate_groups(zifo, r, h, c, n, m, hs, cs, ns, ms, dhs, dfin):
    """slstm_bwd.cu's schedule in torch, every channel at once (its steps
    are element-wise): the inputs of steps t .. t - kGroup + 1 (gates,
    the state before the step, dhs) loaded a group ahead into ``buf``, the
    group before copied to ``cur`` and stepped back by ``step_back_plain``
    in falling t, the last group partial; then r's channel sums over b in
    rising order.  Returns (the gradients, how often each step's inputs
    were loaded, how often each step was computed, in computing order)."""
    kg = _bwd_constants()["kGroup"]
    b, s, d4 = zifo.shape
    d = d4 // 4
    zero = torch.zeros((b, d))
    carry = tuple(zero if t is None else t for t in dfin)
    part = (zero,) * 4
    dz = torch.full_like(zifo, float("nan"))
    loads, order = [0] * s, []

    def load(t):
        loads[t] += 1
        prev = (hs[:, t - 1], cs[:, t - 1], ns[:, t - 1],
                ms[:, t - 1]) if t > 0 else (h, c, n, m)
        return zifo[:, t].split(d, dim=-1), prev, dhs[:, t]

    t = s - 1
    buf = [load(t - u) if t - u >= 0 else None for u in range(kg)]
    while t >= 0:
        cur = list(buf)
        tn = t - kg
        buf = [load(tn - u) if tn - u >= 0 else None for u in range(kg)]
        for u in range(kg):
            if t - u >= 0:
                gates, prev, dh_t = cur[u]
                carry, part, out = tkernel.step_back_plain(
                    r, gates, prev, dh_t, carry, part)
                dz[:, t - u] = torch.cat(out, dim=-1)
                order.append(t - u)
        t = tn
    dr = torch.stack([p[0] for p in part])
    for bi in range(1, b):
        dr = dr + torch.stack([p[bi] for p in part])
    return (dz, dr) + carry, loads, order


@pytest.mark.parametrize("s", [1, 7, 8, 9, 16, 129])
def test_group_schedule_is_the_backward(s):
    """The kernel's group walk (``_emulate_groups``) loads every step's
    inputs once, computes every step once in falling t, including a
    partial last group (S 1, 7, 9, 129) and whole ones only (8, 16), and
    is bitwise the plain backward, from a nonzero state with the final
    state's gradients."""
    zifo, r, hcnm, dhs, dfin = _inputs(np.random.default_rng(s + 40), 3, s,
                                       8, True)
    z, rr = torch.tensor(zifo), torch.tensor(r)
    st = [torch.tensor(a) for a in hcnm]
    hs, _, recs = tkernel.slstm_scan_plain(z, rr, *st, with_states=True)
    args = (z, rr, *st, hs, *recs, torch.tensor(dhs),
            [torch.tensor(a) for a in dfin])
    got, loads, order = _emulate_groups(*args)
    assert loads == [1] * s and order == list(reversed(range(s)))
    want = tkernel.slstm_scan_backward_plain(*args[:-1], *args[-1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
