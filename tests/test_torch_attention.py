"""The port's flash attention — K9's plain version through
``repro_torch.kernels.attention.flash_attention`` — against the
reference's ``repro.kernels.attention.flash_attention`` (its Pallas
kernel in interpret mode) on the same numpy-seeded inputs, and the bf16
support of ``kernels.common`` that the entry point needs.

Tolerances: the reference's own (``tests/test_kernels.py``): 1e-5 for
float32 (both run the same block loop in float32; the products sum in
another order), 5e-2 for bfloat16 inputs (the output is rounded to
bfloat16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as rattn
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import common
from repro_torch.kernels.attention import kernel as tkernel

F32_TOL = 1e-5
BF16_TOL = 5e-2


def _qkv(rng, b, h, kv, s, t, dh, dv=None):
    dv = dh if dv is None else dv
    return (rng.normal(size=(b, h, s, dh)).astype(np.float32),
            rng.normal(size=(b, kv, t, dh)).astype(np.float32),
            rng.normal(size=(b, kv, t, dv)).astype(np.float32))


def _ref(q, k, v, **kw):
    return np.asarray(rattn.flash_attention(q, k, v, **kw), np.float32)


def _port(q, k, v, **kw):
    before = tkernel.LIB.launches
    o = tattn.flash_attention(q, k, v, device="cpu", **kw)
    assert tkernel.LIB.launches == before      # the plain version ran
    return o


@pytest.mark.parametrize("B,H,KV,S,dh,bq,bk", [
    (1, 2, 2, 128, 32, 64, 64),
    (2, 4, 2, 256, 32, 128, 128),
    (1, 8, 1, 128, 64, 32, 64),
])
def test_f32_vs_reference(B, H, KV, S, dh, bq, bk):
    """tests/test_kernels.py's float32 cases: the port against the
    reference's interpret-mode kernel within 1e-5, and both against the
    float64 oracle (S == T, where its mask is the kernel's)."""
    q, k, v = _qkv(np.random.default_rng(S + H), B, H, KV, S, S, dh)
    want = _ref(q, k, v, bq=bq, bk=bk)
    got = _port(q, k, v, bq=bq, bk=bk)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), rattn.attention_ref(q, k, v),
                               rtol=F32_TOL, atol=F32_TOL)


def test_bf16_vs_reference():
    """tests/test_kernels.py's bfloat16 case: both packages round the
    same float32 inputs to bfloat16 (to nearest even) bitwise alike; the
    outputs, bfloat16, agree within 5e-2."""
    B, H, KV, S, dh, bq, bk = 2, 4, 4, 128, 16, 64, 32
    q, k, v = _qkv(np.random.default_rng(S + H), B, H, KV, S, S, dh)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    tq, tk, tv = (torch.tensor(t).to(torch.bfloat16) for t in (q, k, v))
    for j, t in ((jq, tq), (jk, tk), (jv, tv)):
        assert np.array_equal(np.asarray(j).view(np.uint16),
                              t.view(torch.int16).numpy().view(np.uint16))
    want = np.asarray(rattn.flash_attention(jq, jk, jv, bq=bq, bk=bk),
                      np.float32)
    got = _port(tq, tk, tv, bq=bq, bk=bk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_non_causal_vs_reference():
    q, k, v = _qkv(np.random.default_rng(0), 1, 2, 2, 64, 64, 16)
    want = _ref(q, k, v, bq=32, bk=32, causal=False)
    got = _port(q, k, v, bq=32, bk=32, causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(
        got.numpy(), rattn.attention_ref(q, k, v, causal=False),
        rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("S,T,bq,bk", [(64, 128, 32, 32), (128, 64, 64, 32)])
def test_causal_top_left_mask_s_ne_t(S, T, bq, bk):
    """S != T: the kernel masks t <= s counted from 0 (top-left), the
    oracle bottom-right.  The port follows the reference's kernel, not
    the oracle; a dv other than dh is taken too."""
    q, k, v = _qkv(np.random.default_rng(S * 3 + T), 1, 4, 2, S, T, 16, 24)
    want = _ref(q, k, v, bq=bq, bk=bk)
    got = _port(q, k, v, bq=bq, bk=bk)
    assert got.shape == (1, 4, S, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    with np.errstate(invalid="ignore"):     # S > T: oracle rows see no key
        oracle = rattn.attention_ref(q, k, v)
    assert not np.allclose(got.numpy(), oracle, atol=1e-2)


def test_oracle_copy_bitwise():
    rng = np.random.default_rng(5)
    for causal in (True, False):
        q, k, v = _qkv(rng, 1, 4, 2, 32, 48, 8, 12)
        assert np.array_equal(tattn.attention_ref(q, k, v, causal),
                              rattn.attention_ref(q, k, v, causal))


@pytest.mark.parametrize("change", ["bq", "kv", "dtype", "rank"])
def test_rejects_what_the_kernel_does_not_take(change):
    q, k, v = (torch.tensor(t) for t in _qkv(np.random.default_rng(1), 1, 4,
                                                2, 64, 64, 8))
    kw = dict(bq=32, bk=32)
    if change == "bq":
        kw["bq"] = 48                       # S % bq != 0
    elif change == "kv":
        k, v = k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1)
    elif change == "dtype":
        k = k.to(torch.bfloat16)
    else:
        q = q[0]
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, v, device="cpu", **kw)


@pytest.mark.parametrize("dtypes,ok", [
    ((torch.float32,) * 3, True), ((torch.bfloat16,) * 3, True),
    ((torch.float32, torch.bfloat16, torch.float32), False),
    ((torch.float16,) * 3, False)])
def test_check_float_dtypes(dtypes, ok):
    """The attention kernels' inputs share one dtype of FLOAT_DTYPES."""
    q, k, v = (torch.zeros(2, dtype=d) for d in dtypes)
    if ok:
        assert common.check_float_dtypes(q=q, k=k, v=v) == dtypes[0]
    else:
        with pytest.raises(ValueError, match="q, k, v must share"):
            common.check_float_dtypes(q=q, k=k, v=v)


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, k, v = _qkv(np.random.default_rng(2), 1, 2, 2, 64, 64, 8)
    before = tkernel.LIB.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.flash_attention(q, k, v, bq=32, bk=32)
    assert tkernel.LIB.launches == before


def test_common_takes_bf16_tensors():
    """``as_tensor`` and ``check_tensor`` take bfloat16 tensors; a numpy
    array asked to become one raises a clear error (numpy has none)."""
    cpu = torch.device("cpu")
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16)
    assert common.as_tensor(t, torch.bfloat16, cpu) is t
    assert common.as_float_tensor(t, cpu).dtype == torch.bfloat16
    assert common.as_float_tensor(np.ones(3), cpu).dtype == torch.float32
    common.check_tensor(t, "t", torch.bfloat16, (2, 3), cpu)
    common.check_tensor(t, "t", (torch.float32, torch.bfloat16), (2, 3), cpu)
    with pytest.raises(ValueError, match="bfloat16"):
        common.check_tensor(t.float(), "t", torch.bfloat16, (2, 3), cpu)
    with pytest.raises(TypeError, match="numpy has no torch.bfloat16"):
        common.as_tensor(np.ones(3, np.float32), torch.bfloat16, cpu)


def _emulate_wgmma(q, k, v, split: bool) -> torch.Tensor:
    """The bfloat16 tensor-core kernel's precision in torch, causal, over
    64-key tiles: bfloat16 operands, float32 scores scaled by dh^-0.5
    after the product, the online softmax in float32, P entering the PV
    product as bfloat16 (two parts, P_hi + P_lo, when ``split``), float32
    sums.  Tiles past a row's frontier add exact zeros, so every row runs
    every tile."""
    b, h, s, dh = q.shape
    g = h // k.shape[1]
    scale = float(np.float32(dh ** -0.5))
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    m = torch.full((b, h, s), tkernel.NEG)
    l = torch.zeros((b, h, s))
    o = torch.zeros((b, h, s, vf.shape[-1]))
    rows = torch.arange(s)[:, None]
    for t0 in range(0, kf.shape[2], 64):
        sc = torch.matmul(qf, kf[:, :, t0:t0 + 64].transpose(-1, -2)) * scale
        sc = torch.where(t0 + torch.arange(64)[None] <= rows, sc,
                         tkernel.NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        parts = (hi, (p - hi).bfloat16().float()) if split else (hi,)
        o = o * alpha[..., None]
        for part in parts:
            o = o + torch.matmul(part, vf[:, :, t0:t0 + 64])
        m = m_new
    return (o / torch.clamp_min(l, 1e-30)[..., None]).bfloat16()


@pytest.mark.parametrize("split", [True, False])
def test_wgmma_precision_split_p(split):
    """Why the bfloat16 kernel splits P: emulated at its precision on a
    seeded causal GQA case (H 2, KV 1, S 1024, dh 128), its output is
    held to the plain version with the on-card check, one bfloat16 step
    (2^-7 |o| + 1e-5).  P as two bfloat16 parts passes; P rounded to
    bfloat16 alone is witnessed to violate it."""
    q, k, v = (torch.tensor(t).bfloat16() for t in
               _qkv(np.random.default_rng(1024), 1, 2, 1, 1024, 1024, 128))
    want = tkernel.flash_forward_plain(q, k, v).float()
    got = _emulate_wgmma(q, k, v, split).float()
    bad = (got - want).abs() > 2.0 ** -7 * want.abs() + F32_TOL
    if split:
        assert not bool(bad.any()), f"{int(bad.sum())} elements off"
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=BF16_TOL)
    else:
        assert float(bad.float().mean()) > 0.01, int(bad.sum())
