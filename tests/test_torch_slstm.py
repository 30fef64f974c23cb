"""The port's sLSTM scan (``repro_torch.kernels.slstm``: the kernel's
plain version on the CPU) against the reference's ``_slstm_cell`` looped
over S and its ``slstm_apply`` recurrence, on the same numpy-seeded
inputs.

Tolerance, float32: hs and h within SCAN_TOL = 1e-5 absolute of the
reference (|h| <= 1: c / n is a weighted mean of tanh values; each side
rounds exp, tanh and the sigmoid its own way); c, n and m within
SCAN_TOL relative besides, since they grow with S (n sums the decayed
input gates, m climbs by the raw forget pre-activations).
A bfloat16 zifo gives bfloat16 outputs within one bfloat16 step of the
float32 h.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import ssm as rssm
from repro_torch.kernels import slstm as tslstm
from repro_torch.kernels.slstm import kernel as tkernel
from repro_torch.kernels.slstm.kernel import slstm_step_plain
from repro_torch.models import layers as tlayers

SCAN_TOL = 1e-5
BF16_ULP = 2.0 ** -7


def _inputs(rng, b, s, d, state: bool):
    zifo = rng.normal(size=(b, s, 4 * d)).astype(np.float32)
    # forget pre-activations above 0 too: they enter the stabilizer raw
    zifo[..., 2 * d:3 * d] += 0.5
    r = (rng.normal(size=(4, d)) * 0.5).astype(np.float32)
    hcnm = [np.zeros((b, d), np.float32) for _ in range(4)]
    if state:
        hcnm = [rng.normal(size=(b, d)).astype(np.float32) for _ in range(4)]
        hcnm[2] = np.abs(hcnm[2]) + 0.5
    return zifo, r, hcnm


def _ref_scan(zifo, r, hcnm):
    """The reference's cell looped over S (its lax.scan's step)."""
    p = {"r": jnp.asarray(r)}
    cell = jax.jit(rssm._slstm_cell)
    h, c, n, m = (jnp.asarray(a) for a in hcnm)
    hs = []
    for t in range(zifo.shape[1]):
        h, c, n, m = cell(p, jnp.asarray(zifo[:, t]), h, c, n, m)
        hs.append(np.asarray(h))
    return np.stack(hs, 1), [np.asarray(a) for a in (h, c, n, m)]


@pytest.mark.parametrize("b,s,d,state", [
    (2, 1, 8, False), (2, 1, 8, True), (3, 40, 16, False),
    (2, 64, 8, True)])
def test_plain_vs_reference_cell(b, s, d, state):
    """hs and the final (h, c, n, m) against the reference's cell, step
    by step; a decode step is S = 1."""
    zifo, r, hcnm = _inputs(np.random.default_rng(s + d), b, s, d, state)
    want_hs, want = _ref_scan(zifo, r, hcnm)
    before = tkernel.LIB.launches
    hs, got = tkernel.slstm_scan_plain(
        torch.tensor(zifo), torch.tensor(r), *map(torch.tensor, hcnm))
    assert tkernel.LIB.launches == before
    assert hs.dtype == torch.float32 and hs.shape == (b, s, d)
    np.testing.assert_allclose(hs.numpy(), want_hs, rtol=0, atol=SCAN_TOL)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=SCAN_TOL,
                                   atol=SCAN_TOL)


@pytest.mark.parametrize("s", [128, 256])
def test_ops_vs_reference_apply(s):
    """``ops.slstm`` from a state against the recurrence inside the
    reference's ``slstm_apply`` (at S = 256 its chunked branch, two
    checkpointed scans of 128 steps): the final (h, c, n, m), and hs
    through the output norm."""
    b, d = 2, 16
    rng = np.random.default_rng(s)
    _, r, hcnm = _inputs(rng, b, s, d, True)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w_in = (rng.normal(size=(d, 4 * d)) / np.sqrt(d)).astype(np.float32)
    p = {"w_in": {"w": jnp.asarray(w_in)}, "r": jnp.asarray(r),
         "out_norm": {"scale": jnp.ones((d,), jnp.float32)}}
    cfg = rconfigs.smoke_config("xlstm-1p3b")
    y, ref_state = jax.jit(rssm.slstm_apply, static_argnums=(2,))(
        p, jnp.asarray(x), cfg, {n: jnp.asarray(a)
                                 for n, a in zip("hcnm", hcnm)})
    zifo = torch.matmul(torch.tensor(x), torch.tensor(w_in))
    before = tkernel.LIB.launches
    hs, got = tslstm.slstm(zifo, torch.tensor(r),
                           {n: torch.tensor(a) for n, a in
                            zip("hcnm", hcnm)}, device="cpu")
    assert tkernel.LIB.launches == before
    assert set(got) == set("hcnm") and hs.shape == (b, s, d)
    for n in "hcnm":
        np.testing.assert_allclose(got[n].numpy(), np.asarray(ref_state[n]),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(
        tlayers.rmsnorm(torch.ones(d), hs, cfg.norm_eps).numpy(),
        np.asarray(y), rtol=0, atol=SCAN_TOL)


def test_zero_state_and_bf16():
    """No state is the zero state (m included); a bfloat16 zifo gives a
    bfloat16 hs within one bfloat16 step of the float32 scan of the same
    values, and a float32 state."""
    zifo, r, _ = _inputs(np.random.default_rng(5), 2, 24, 8, False)
    zt = torch.tensor(zifo).to(torch.bfloat16)
    hs, st = tslstm.slstm(zt, torch.tensor(r), device="cpu")
    zeros = [torch.zeros((2, 8)) for _ in range(4)]
    hs32, st32 = tkernel.slstm_scan_plain(zt.float(), torch.tensor(r),
                                          *zeros)
    assert hs.dtype == torch.bfloat16
    assert all(st[n].dtype == torch.float32 for n in "hcnm")
    for n, want in zip("hcnm", st32):
        assert torch.equal(st[n], want)
    np.testing.assert_allclose(hs.float().numpy(), hs32.numpy(),
                               rtol=BF16_ULP, atol=0)


@pytest.mark.parametrize("change", ["zifo", "r", "state", "dtype"])
def test_rejects_what_the_kernel_does_not_take(change):
    zifo, r, hcnm = _inputs(np.random.default_rng(6), 2, 4, 8, True)
    zifo, r = torch.tensor(zifo), torch.tensor(r)
    hcnm = [torch.tensor(a) for a in hcnm]
    if change == "zifo":
        zifo = zifo[..., :-1]                    # 4D not whole
    elif change == "r":
        r = r[:3]
    elif change == "state":
        hcnm[1] = hcnm[1][:1]
    else:
        zifo = zifo.double()
    with pytest.raises(ValueError):
        tkernel.slstm_scan(zifo, r, *hcnm)


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zifo, r, _ = _inputs(np.random.default_rng(7), 1, 4, 8, False)
    before = tkernel.LIB.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        tslstm.slstm(zifo, r)
    assert tkernel.LIB.launches == before


# --- the kernel's schedule (csrc/slstm.cu), emulated -------------------------

def _slstm_constants() -> dict:
    """``constexpr int NAME = VALUE;`` constants of ``csrc/slstm.cu``."""
    import os
    import re
    path = os.path.join(os.path.dirname(tkernel.__file__), "csrc",
                        "slstm.cu")
    with open(path) as f:
        text = f.read()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", text)}


def _emulate_staged(zifo, r, h, c, n, m):
    """slstm.cu's schedule in torch: a block of kThreads channels (b D +
    d).  A block whose channels lie in one sequence and whose rows hold
    whole 16-byte copies, in a scan of more than one step, runs the S
    steps in stages of kChunk, each stage's gates staged into slot k %
    kStages of shared memory kStages - 1 stages ahead by the copy map
    (copy x: column chunk x % CPR, gate x / CPR % 4, step x / (4 CPR),
    CPR = kThreads / (16 / element size), the stage's live steps only);
    each live thread then steps its channel through the stage
    (``slstm_step_plain`` on its gates, read from the slot) and stores
    h_t.  Any other block reads each step's gates straight from zifo.
    Returns (hs, state, how often each zifo element was read into a step,
    how often each hs element was stored); asserts that no slot is
    refilled before its stage was read."""
    k = _slstm_constants()
    nt, chunk, stages = k["kThreads"], k["kChunk"], k["kStages"]
    b, s, d4 = zifo.shape
    d = d4 // 4
    epc = 16 // zifo.element_size()
    flat = zifo.reshape(-1)
    staged = torch.zeros(flat.numel(), dtype=torch.int64)
    hs = torch.zeros((b, s, d), dtype=zifo.dtype)
    stored = torch.zeros((b, s, d), dtype=torch.int64)
    h, c, n, m = (x.clone() for x in (h, c, n, m))
    nchunks = -(-s // chunk)
    for ch0 in range(0, b * d, nt):
        chs = torch.arange(ch0, min(ch0 + nt, b * d))
        bb, dd = chs // d, chs % d
        d0 = ch0 % d
        if not (s > 1 and d0 + nt <= d and d % epc == 0):
            for t in range(s):          # straight from zifo
                at = (bb * s + t) * d4 + dd
                gates = torch.stack([flat[at + g * d] for g in range(4)])
                staged[torch.cat([at + g * d for g in range(4)])] += 1
                st = slstm_step_plain(gates.float(), r[:, dd], h[bb, dd],
                                      c[bb, dd], n[bb, dd], m[bb, dd])
                h[bb, dd], c[bb, dd], n[bb, dd], m[bb, dd] = st
                hs[bb, t, dd] = st[0].to(zifo.dtype)
                stored[bb, t, dd] += 1
            continue
        slots = [None] * stages
        reading = [-1]

        def fill(kk):
            if kk >= nchunks:
                return
            old = slots[kk % stages]
            assert old is None or old[0] < reading[0], "slot refilled early"
            buf = torch.zeros((chunk, 4, nt), dtype=zifo.dtype)
            t0 = kk * chunk
            cpr = nt // epc
            for x in range(min(chunk, s - t0) * 4 * cpr):
                cc, g, u = x % cpr, x // cpr % 4, x // (4 * cpr)
                at = ((ch0 // d) * s + t0 + u) * d4 + g * d + d0 + cc * epc
                buf[u, g, cc * epc:(cc + 1) * epc] = flat[at:at + epc]
                staged[at:at + epc] += 1
            slots[kk % stages] = (kk, buf)

        for kk in range(stages - 1):
            fill(kk)
        for kk in range(nchunks):
            # after the barrier: stage kk has landed; the slot of stage kk
            # - 1, read before the barrier, takes stage kk + kStages - 1
            reading[0] = kk
            got, buf = slots[kk % stages]
            assert got == kk
            fill(kk + stages - 1)
            for u in range(min(chunk, s - kk * chunk)):
                t = kk * chunk + u
                gates = buf[u, :, :len(chs)].float()
                st = slstm_step_plain(gates, r[:, dd], h[bb, dd], c[bb, dd],
                                      n[bb, dd], m[bb, dd])
                h[bb, dd], c[bb, dd], n[bb, dd], m[bb, dd] = st
                hs[bb, t, dd] = st[0].to(zifo.dtype)
                stored[bb, t, dd] += 1
    return hs, (h, c, n, m), staged, stored


@pytest.mark.parametrize("b,s,d", [(2, 1, 128), (3, 7, 100), (2, 129, 96),
                                   (1, 129, 64), (3, 40, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_schedule_is_the_scan(b, s, d, dtype):
    """The kernel's schedule (``_emulate_staged``) feeds every channel
    every step's gates once and in order, and stores every h_t once: the
    emulated scan is bitwise the plain version's from a nonzero state, at
    S 1 (straight from zifo), 7, 129 and 40, with staged blocks (D 128,
    64, 96's first block, 100 in f32), blocks that straddle two sequences
    or whose rows are not whole 16-byte copies (D 100 in bf16, 70), and
    B D not a multiple of the block."""
    zifo, r, hcnm = _inputs(np.random.default_rng(b * s + d), b, s, d, True)
    z = torch.tensor(zifo).to(dtype)
    r, hcnm = torch.tensor(r), [torch.tensor(a) for a in hcnm]
    hs, st, staged, stored = _emulate_staged(z, r, *hcnm)
    assert bool((staged == 1).all()), "a gate staged twice or never"
    assert bool((stored == 1).all()), "an h_t stored twice or never"
    want_hs, want = tkernel.slstm_scan_plain(z, r, *hcnm)
    assert torch.equal(hs, want_hs)
    for g, w in zip(st, want):
        assert torch.equal(g, w)
