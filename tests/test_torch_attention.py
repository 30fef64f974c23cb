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

import _torch_threads  # noqa: F401  (an xdist worker's share of the threads)
import os
import re

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


# --- the float32 kernel's split TF32 (csrc/flash_tf32.cu), emulated ---

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 explicit mantissa bits
    (the low 13 of 23 cleared), to nearest, ties away from zero."""
    u = x.float().contiguous().numpy().view(np.uint32)
    r = ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return torch.from_numpy(r.copy())


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _emulate_tf32(q, k, v, three: bool, causal: bool = True
                  ) -> torch.Tensor:
    """The float32 tensor-core kernels' precision and order in torch over
    their 32-key tiles (``flash_tf32_kernel`` and
    ``flash_tf32_mla_kernel`` alike): q scaled (rounded to float32), then each
    operand split into TF32 parts and every product taken as hi lo + lo hi
    + hi hi, the small products first (``three``), or as one TF32 product;
    the online softmax in float32, O rescaled before each tile's P V; -1e30
    where masked (top-left causal when ``causal``) or past T (the ragged
    last tile zero-padded, as TMA fills it).  Tiles past a row's frontier
    add exact zeros, so every row runs every tile."""
    b, h, s, dh = q.shape
    t = k.shape[2]
    g = h // k.shape[1]
    scale = float(np.float32(dh ** -0.5))
    qh, ql = _split(q * scale)
    bk = 32
    pad = -t % bk
    kf = torch.nn.functional.pad(k.repeat_interleave(g, dim=1),
                                 (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.repeat_interleave(g, dim=1),
                                 (0, 0, 0, pad))
    m = torch.full((b, h, s), tkernel.NEG)
    l = torch.zeros((b, h, s))
    o = torch.zeros((b, h, s, vf.shape[-1]))
    rows = torch.arange(s)[:, None]

    def dot(ah, al, bh, bl):
        if not three:
            return torch.matmul(ah, bh)
        return (torch.matmul(ah, bl) + torch.matmul(al, bh)) \
            + torch.matmul(ah, bh)

    for t0 in range(0, kf.shape[2], bk):
        kh, kl = _split(kf[:, :, t0:t0 + bk])
        vh, vl = _split(vf[:, :, t0:t0 + bk])
        sc = dot(qh, ql, kh.transpose(-1, -2), kl.transpose(-1, -2))
        cols = t0 + torch.arange(bk)[None]
        live = (cols <= rows) & (cols < t) if causal else cols < t
        sc = torch.where(live, sc, tkernel.NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        ph, pl = _split(p)
        o = o * alpha[..., None] + dot(ph, pl, vh, vl)
        m = m_new
    return o / torch.clamp_min(l, 1e-30)[..., None]


def test_tf32_rounding_emulation():
    """The emulated ``cvt.rna.tf32.f32``: ties go away from zero, and the
    two parts of a float32 hold it to ~2^-22."""
    one = np.float32(1.0)
    half_ulp = np.float32(2.0 ** -11)
    x = torch.tensor([one + half_ulp, one + half_ulp - np.float32(2 ** -23),
                      -(one + half_ulp), 3.0, 0.0], dtype=torch.float32)
    want = [1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10), 3.0, 0.0]
    assert _tf32(x).tolist() == want
    a = torch.tensor(np.random.default_rng(3).normal(size=4096)
                     .astype(np.float32))
    hi, lo = _split(a)
    assert bool(((_tf32(hi) == hi) & (_tf32(lo) == lo)).all())
    rel = ((hi.double() + lo.double() - a.double()).abs()
           / a.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


@pytest.mark.parametrize("three", [True, False])
@pytest.mark.parametrize("dh", [128, 96])
def test_tf32_precision_three_products(dh, three):
    """Why the float32 kernel takes three TF32 products: emulated at its
    precision on a seeded causal GQA layer (H 2, KV 1, S 1024), its
    output is held to the plain version with the on-card tolerance,
    F32_TOL (``chip_smoke.py``'s ATTN_F32_TOL).  Three products pass at
    dh 128 and 96; one TF32 product is witnessed to violate it."""
    q, k, v = (torch.tensor(t) for t in
               _qkv(np.random.default_rng(dh), 1, 2, 1, 1024, 1024, dh))
    want = tkernel.flash_forward_plain(q, k, v)
    err = float((_emulate_tf32(q, k, v, three) - want).abs().max())
    if three:
        assert err <= F32_TOL, err
    else:
        assert err > F32_TOL, err


def test_tf32_p_fragment_and_permuted_v_staging():
    """P enters the PV product from registers: the m64n32 accumulator's
    layout (register 4 j + 2 h + e of thread t: row 16 w + g + 8 h, column
    8 j + 2 qd + e) read as the TF32 A fragments of four k8 steps
    (register r: row 16 w + g + 8 (r % 2), column qd + 4 (r / 2)), against
    Vt staged by the kernel's thread units (unit u: chunk u % 8 of Vt rows
    4 (u // 8) ..), which put kv row 8 j + sigma(c) at position 8 j + c.
    Every A element and every Vt position is written once, and sum_j A_j
    Vt_j^T is exactly P V (integer data: every sum exact)."""
    rng = np.random.default_rng(9)
    d = 24
    p = rng.integers(-8, 9, (64, 32)).astype(np.float64)
    v = rng.integers(-8, 9, (32, d)).astype(np.float64)
    # the accumulator of each of the 128 threads
    acc = np.empty((128, 16))
    for t in range(128):
        w, g, qd = t // 32, (t % 32) // 4, t % 4
        for j in range(4):
            for h in range(2):
                for e in range(2):
                    acc[t, 4 * j + 2 * h + e] = p[16 * w + g + 8 * h,
                                                  8 * j + 2 * qd + e]
    # the kernel's staging of Vt [d, 32]: unit u, kv rows 8 (ch / 2) +
    # ch % 2 + 2 m at positions 4 ch + m of Vt rows 4 nv + e
    vt = np.full((d, 32), np.nan)
    for u in range(2 * d):
        ch, nv = u % 8, u // 8
        for m in range(4):
            for e in range(4):
                assert np.isnan(vt[4 * nv + e, 4 * ch + m])
                vt[4 * nv + e, 4 * ch + m] = v[8 * (ch // 2) + ch % 2 + 2 * m,
                                               4 * nv + e]
    assert not np.isnan(vt).any()
    o = np.zeros((64, d))
    for j in range(4):
        a = np.full((64, 8), np.nan)
        for t in range(128):
            w, g, qd = t // 32, (t % 32) // 4, t % 4
            for r in range(4):
                row, col = 16 * w + g + 8 * (r % 2), qd + 4 * (r // 2)
                assert np.isnan(a[row, col])
                a[row, col] = acc[t, 4 * j + 2 * (r % 2) + r // 2]
        assert not np.isnan(a).any()
        o += a @ vt[:, 8 * j:8 * j + 8].T
    np.testing.assert_array_equal(o, p @ v)


# --- MLA's head: dh 192 (q and k), dv 128 -----------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_head_vs_reference(dtype):
    """K9's plain version at MLA's head, q and k 192 wide and v 128 (H =
    KV, as MLA gives it), against the reference's interpret-mode kernel:
    1e-5 in float32, 5e-2 in bfloat16.  The scale is 192^-0.5, the
    reference's MLA scale (dn + dr)^-0.5."""
    q, k, v = _qkv(np.random.default_rng(192), 1, 2, 2, 128, 128, 192, 128)
    if dtype == "float32":
        want = _ref(q, k, v, bq=64, bk=64)
        got = _port(q, k, v, bq=64, bk=64)
        tol = F32_TOL
    else:
        want = np.asarray(rattn.flash_attention(
            *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), bq=64,
            bk=64), np.float32)
        got = _port(*(torch.tensor(t).bfloat16() for t in (q, k, v)),
                    bq=64, bk=64).float()
        tol = BF16_TOL
    assert got.shape == (1, 2, 128, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_wgmma_precision_mla_head():
    """The bfloat16 kernel's precision (split P) at MLA's head, dh 192 /
    dv 128, on a seeded causal layer (H = KV = 2, S 1024): within one
    bfloat16 step of the plain version, as on the card."""
    q, k, v = (torch.tensor(t).bfloat16() for t in
               _qkv(np.random.default_rng(193), 1, 2, 2, 1024, 1024, 192,
                    128))
    want = tkernel.flash_forward_plain(q, k, v).float()
    got = _emulate_wgmma(q, k, v, True).float()
    bad = (got - want).abs() > 2.0 ** -7 * want.abs() + F32_TOL
    assert not bool(bad.any()), f"{int(bad.sum())} elements off"


def test_tf32_precision_mla_head():
    """The float32 kernel's three TF32 products at MLA's head (dh 192, dv
    128): within F32_TOL of the plain version."""
    q, k, v = (torch.tensor(t) for t in
               _qkv(np.random.default_rng(194), 1, 2, 2, 512, 512, 192, 128))
    want = tkernel.flash_forward_plain(q, k, v)
    err = float((_emulate_tf32(q, k, v, True) - want).abs().max())
    assert err <= F32_TOL, err


def _bf16_tile_image(d: int, cols: int, nt: int = 128) -> np.ndarray:
    """flash_wgmma.cu's ``load_tile<d, nt>`` for a whole 64-row tile of a
    row-major [64, cols] matrix: the column each 2-byte position of the
    d / 64 swizzled 64-column sub-tiles receives (-1 where none does),
    every position written at most once.  A tile over 128 columns goes as
    ``load_part<128>`` at column 0 and ``load_part<d - 128>`` at column
    128 into the sub-tiles from the third."""
    atom = 64 * 128
    img = np.full(d // 64 * atom // 2, -1)
    parts = [(128, 0), (d - 128, 128)] if d > 128 else [(d, 0)]
    for width, col0 in parts:
        dst = (col0 // 64) * atom
        ch = width // 8
        rp = nt // ch
        assert rp % 8 == 0 and 64 % rp == 0
        for tid in range(nt):
            c, r = tid % ch, tid // ch
            c0 = col0 + c * 8
            d0 = dst + (c // 8) * atom + r * 128 + (((c % 8) ^ (r & 7)) << 4)
            for i in range(64 // rp):
                row = r + i * rp
                for e in range(8):
                    at = (d0 + i * rp * 128) // 2 + e
                    assert img[at] == -1
                    img[at] = row * cols + c0 + e if c0 + e < cols else -2
    return img


@pytest.mark.parametrize("d", [64, 128, 192])
def test_bf16_tile_loader_layout(d):
    """Every element of a [64, d] tile lands once where the swizzled
    layout (16-byte chunk c of row r of sub-tile a at a * 8192 + r * 128 +
    16 (c ^ (r % 8))) puts it, for the 128-thread loader at d 64, 128 and
    MLA's 192."""
    img = _bf16_tile_image(d, d)
    want = np.empty_like(img)
    for row in range(64):
        for col in range(d):
            a, c = col // 64, (col % 64) // 8
            at = a * 8192 + row * 128 + ((c ^ (row & 7)) << 4)
            want[at // 2 + col % 8] = row * d + col
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128), (192, 128)])
def test_tf32_chunk_maps(dk, dv):
    """flash_tf32.cu's thread maps at one warpgroup a block: Q's NQ = dk /
    8 chunks a thread (row u / (dk / 4), chunk u % (dk / 4)) cover the
    [64, dk] tile once, K's NK = 8 dk / 128 the [32, dk] tile once, and
    Vt's 2 dv units (NV a thread) the [dv, 32] tile once; shared memory
    stays inside the card's 227 KB."""
    nt = 128
    seen = np.zeros((64, dk // 4), int)
    for n in range(dk // 8):
        for wt in range(nt):
            u = wt + n * nt
            seen[u // (dk // 4), u % (dk // 4)] += 1
    assert (seen == 1).all()
    assert 8 * dk % nt == 0
    seen = np.zeros((32, dk // 4), int)
    for n in range(8 * dk // nt):
        for t in range(nt):
            u = t + n * nt
            seen[u // (dk // 4), u % (dk // 4)] += 1
    assert (seen == 1).all()
    seen = np.zeros((dv, 32), int)
    for n in range(-(-2 * dv // nt)):
        for t in range(nt):
            u = t + n * nt
            if u >= 2 * dv:
                continue
            ch, nv = u % 8, u // 8
            for m in range(4):
                for e in range(4):
                    seen[4 * nv + e, 4 * ch + m] += 1
    assert (seen == 1).all()
    smem = 1024 + 2 * (dk * 256 + dk * 128 + dv * 128)
    assert smem <= 232448


# --- MLA's head on flash_mla_kernel: its schedule, emulated ---------------

def _emulate_mla(q, k, v, causal: bool = True, split: bool = True,
                 bk: int = 64) -> torch.Tensor:
    """flash_mla_kernel's arithmetic and order in torch: each head's
    128-row query tiles as two 64-row online softmaxes over 64-key tiles,
    each taking the kv tiles under its own frontier in the ring's order;
    the float32 score scaled by dh^-0.5 after the product, -1e30 where
    masked (top-left causal) or past T; tile kt's product issued before
    its softmax, so O_kt = (O_{kt-1} + P_{kt-1} V_{kt-1}) alpha_kt and
    the last tile's P V after the loop; P as P_hi + P_lo bfloat16 parts
    (one part when not ``split``); o = O / max(l, 1e-30) in bfloat16."""
    b, h, s, dh = q.shape
    t = k.shape[2]
    g = h // k.shape[1]
    scale = float(np.float32(dh ** -0.5))
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    ntk = -(-t // bk)
    out = torch.empty((b, h, s, vf.shape[-1]))
    for r0 in range(0, s, 64):               # a consumer's 64 rows
        rows = torch.arange(r0, min(r0 + 64, s))
        mine = min(ntk, -(-(r0 + 64) // bk)) if causal else ntk
        m = torch.full((b, h, len(rows)), tkernel.NEG)
        l = torch.zeros((b, h, len(rows)))
        o = torch.zeros((b, h, len(rows), vf.shape[-1]))
        parts = None
        for kt in range(mine):
            cols = torch.arange(kt * bk, min(kt * bk + bk, t))
            sc = torch.matmul(qf[:, :, rows], kf[:, :, cols].transpose(-1, -2))
            sc = sc * scale
            if causal:
                sc = torch.where(cols[None] <= rows[:, None], sc, tkernel.NEG)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            if parts is not None:            # the product issued before
                for part, vv in parts:
                    o = o + torch.matmul(part, vv)
                o = o * alpha[..., None]
            hi = p.bfloat16().float()
            parts = [(hi, vf[:, :, cols])]
            if split:
                parts.append(((p - hi).bfloat16().float(), vf[:, :, cols]))
            m = m_new
        for part, vv in parts or []:
            o = o + torch.matmul(part, vv)
        out[:, :, rows] = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.bfloat16()


@pytest.mark.parametrize("s,t,causal", [(1024, 1024, True),
                                        (192, 320, True),
                                        (320, 192, True),
                                        (256, 256, False)])
def test_mla_schedule_within_one_bf16_step(s, t, causal):
    """flash_mla_kernel's schedule (128-row tiles of two 64-row online
    softmaxes, the rescale after the product of the tile before, split P)
    at MLA's head, dh 192 / dv 128 (H = KV = 2): within one bfloat16 step
    (2^-7 |o| + 1e-5) of the plain version, causal with S = T and S != T
    both ways (top-left mask) and not causal."""
    q, k, v = (torch.tensor(x).bfloat16() for x in
               _qkv(np.random.default_rng(s + t), 1, 2, 2, s, t, 192, 128))
    want = tkernel.flash_forward_plain(q, k, v, 64, 64, causal).float()
    got = _emulate_mla(q, k, v, causal).float()
    bad = (got - want).abs() > 2.0 ** -7 * want.abs() + F32_TOL
    assert not bool(bad.any()), f"{int(bad.sum())} elements off"


def test_mla_schedule_single_bf16_p_witnessed():
    """The same schedule with P rounded to one bfloat16 part moves
    outputs past one bfloat16 step at S = 1024: the split stays."""
    q, k, v = (torch.tensor(x).bfloat16() for x in
               _qkv(np.random.default_rng(2048), 1, 2, 2, 1024, 1024, 192,
                    128))
    want = tkernel.flash_forward_plain(q, k, v).float()
    got = _emulate_mla(q, k, v, split=False).float()
    bad = (got - want).abs() > 2.0 ** -7 * want.abs() + F32_TOL
    assert float(bad.float().mean()) > 0.01, int(bad.sum())


@pytest.mark.parametrize("bh,s,blocks", [(512, 4096, 132), (128, 4096, 132),
                                         (3, 256, 132), (5, 896, 4),
                                         (7, 100, 3)])
def test_mla_tile_list_once_longest_first(bh, s, blocks):
    """``mla_tiles`` (flash_mla_kernel's persistent work list) visits
    every (head, 128-row query tile) exactly once, no block takes more
    than one tile beyond another, every block's tiles come longest first
    (causal kv tiles), and at deepseek-v2's and kimi-k2's layers (B H =
    512 and 128, S 4096, 132 SMs) the blocks' causal kv tiles are within
    6% of their mean."""
    blocks = min(blocks, bh * -(-s // tkernel.MLA_BM))
    lists = tkernel.mla_tiles(bh, s, blocks)
    seen = [tile for lst in lists for tile in lst]
    nq = -(-s // tkernel.MLA_BM)
    assert sorted(seen) == [(h, qt) for h in range(bh) for qt in range(nq)]
    assert max(map(len, lists)) - min(map(len, lists)) <= 1
    kv = lambda qt: min(-(-s // 64), -(-(qt * 128 + 128) // 64))
    for lst in lists:
        loads = [kv(qt) for _, qt in lst]
        assert loads == sorted(loads, reverse=True)
    if s == 4096 and blocks == 132:
        per = np.array([sum(kv(qt) for _, qt in lst) for lst in lists])
        assert per.max() <= 1.06 * per.mean(), (per.max(), per.mean())


def _cu_constants(path: str) -> dict:
    """``constexpr int NAME = VALUE;`` integer constants of a source."""
    import re
    with open(path) as f:
        text = f.read()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", text)}


def test_mla_shared_memory_and_registers_fit():
    """flash_mla_kernel's constants, parsed from flash_wgmma.cu: two
    query buffers of 128 x 192 bf16 and a ring of 64-row K (192) and V
    (128) tiles, with its mbarriers and the alignment slack, fit the
    card's 232,448 bytes a block; the producer's registers handed to the
    consumers balance (128 x 168 given up = 256 x taken), each a
    multiple of 8, the consumers' at most 255."""
    import os
    c = _cu_constants(os.path.join(os.path.dirname(tkernel.__file__),
                                   "csrc", "flash_wgmma.cu"))
    nbytes = (c["kMlaQBufs"] * c["kMlaBM"] * c["kMlaDK"] * 2
              + c["kMlaStages"] * 64 * (c["kMlaDK"] + c["kMlaDV"]) * 2
              + (2 * c["kMlaQBufs"] + 2 * c["kMlaStages"]) * 8 + 1024)
    assert c["kMlaStages"] >= 2 and c["kMlaQBufs"] == 2
    assert nbytes <= 232448, nbytes
    assert c["kMlaThreads"] == 384 and c["kMlaBM"] == 128
    start = 65536 // c["kMlaThreads"] // 8 * 8     # 168 a thread
    assert 128 * (start - c["kProducerRegs"]) == \
        256 * (c["kConsumerRegs"] - start)
    assert c["kProducerRegs"] % 8 == 0 and c["kConsumerRegs"] % 8 == 0
    assert 24 <= c["kProducerRegs"] and c["kConsumerRegs"] <= 255



# --- MLA's head on flash_tf32_mla_kernel (float32): its plan, checked ------

def _tf32_src() -> str:
    import os
    return os.path.join(os.path.dirname(tkernel.__file__), "csrc",
                        "flash_tf32.cu")


def test_tf32_mla_shared_memory_and_registers_fit():
    """flash_tf32_mla_kernel's constants, parsed from flash_tf32.cu: Q's
    two TF32 parts (64 x 192), K's (32 x 192), Vt's (128 x 32), the raw
    float32 staging of one kv tile (K 32 x 192 and V 32 x 128) and its
    mbarriers, with the alignment slack, fit the card's 232,448 bytes a
    block.  Its 384 threads (two producer warpgroups, one consumer)
    start at 168 registers; the registers the producers hand over
    balance what the consumer takes (256 x 16 = 128 x 32), each count a
    multiple of 8, the consumer's at most 255, and the kernel makes the
    hand-over (setmaxnreg) on both sides."""
    c = _cu_constants(_tf32_src())
    bq, bk, dk, dv = c["kBQ"], c["kBK"], c["kMlaDK"], c["kMlaDV"]
    assert (bq, bk, dk, dv) == (64, 32, 192, 128)
    parts = 2 * 4 * (bq * dk + bk * dk + dv * bk)
    raw = 4 * (bk * dk + bk * dv)
    nbytes = parts + raw + c["kMlaBars"] * 8 + 1024
    assert nbytes == 222272 and nbytes <= 232448, nbytes
    # one more raw K buffer would not fit: the staging is one kv tile
    assert nbytes + 4 * bk * dk > 232448
    nt, prod = c["kMlaThreads"], c["kMlaProducers"]
    assert prod == 2 * c["kThreads"] == 256 and nt == prod + c["kThreads"]
    start = 65536 // nt // 8 * 8                     # 168 a thread
    assert prod * (start - c["kProducerRegs"]) == \
        c["kThreads"] * (c["kConsumerRegs"] - start)
    assert c["kProducerRegs"] % 8 == 0 and c["kConsumerRegs"] % 8 == 0
    assert 24 <= c["kProducerRegs"] and c["kConsumerRegs"] <= 255
    with open(_tf32_src()) as f:
        text = f.read()
    body = text[text.index("flash_tf32_mla_kernel(const"):
                text.index("int launch_mla(")]
    assert "reg_dealloc<kProducerRegs>" in body
    assert "reg_alloc<kConsumerRegs>" in body
    assert "__launch_bounds__(kMlaThreads, 1)" in text


@pytest.mark.parametrize("bh,s,blocks", [(128, 384, 132), (128, 4096, 132),
                                         (3, 256, 132), (5, 896, 4),
                                         (7, 100, 3)])
def test_tf32_mla_tile_list_once_longest_first(bh, s, blocks):
    """``mla_tiles(..., bm=MLA_F32_BM)``, flash_tf32_mla_kernel's
    persistent work list, visits every (head, 64-row query tile) exactly
    once, no block takes more than one tile beyond another, every block's
    tiles come longest first (causal 32-row kv tiles), and at deepseek-v2's
    f32 check (B H = 128, S 384, 132 SMs) and at S 4096 the blocks' causal
    kv tiles are within 6% of their mean."""
    bm = tkernel.MLA_F32_BM
    assert bm == _cu_constants(_tf32_src())["kBQ"]
    blocks = min(blocks, bh * -(-s // bm))
    lists = tkernel.mla_tiles(bh, s, blocks, bm=bm)
    seen = [tile for lst in lists for tile in lst]
    nq = -(-s // bm)
    assert sorted(seen) == [(h, qt) for h in range(bh) for qt in range(nq)]
    assert max(map(len, lists)) - min(map(len, lists)) <= 1
    kv = lambda qt: min(-(-s // 32), -(-(qt * bm + bm) // 32))  # noqa: E731
    for lst in lists:
        loads = [kv(qt) for _, qt in lst]
        assert loads == sorted(loads, reverse=True)
    if blocks == 132 and bh == 128:
        per = np.array([sum(kv(qt) for _, qt in lst) for lst in lists])
        assert per.max() <= 1.06 * per.mean(), (per.max(), per.mean())


def _vt_unit(u: int):
    """flash_tf32.cu's ``vt_unit``: the (ch, nv) of producer unit u."""
    p, lane = u // 8, u % 8
    return lane ^ (2 * (p // 8)), 8 * (p % 4) + 2 * (lane // 2) + (p // 4) % 2


def _swz(r: int, c4: int, rows: int) -> int:
    """flash_tf32.cu's ``swz``: the byte offset of 16-byte chunk c4 of row
    r in a tile of ``rows`` rows in 32-column swizzled sub-tiles."""
    return (c4 // 8) * (rows * 128) + r * 128 + (((c4 % 8) ^ (r & 7)) << 4)


def _tma_box_offset(r: int, c: int, rows: int) -> int:
    """Where a TMA copy in the 128-byte swizzle puts float (r, c) of a
    tile copied as 32-column x ``rows``-row boxes, box cb at cb x rows x
    128 bytes: within each 1024-byte span the 16-byte chunk index is XORed
    with the row's index mod 8."""
    lin = (c // 32) * rows * 128 + r * 128 + (c % 32) * 4
    return lin ^ (((lin >> 7) & 7) << 4)


def test_tf32_mla_producer_maps():
    """flash_tf32_mla_kernel's producers: the TMA's raw tiles land in the
    kernel's swizzled layout (so raw K's chunks split in place into K's
    parts); their 256 threads' Q map (u = tid + 256 n, n < 12), K split
    (6 chunks a thread) and the elementwise raw fills cover every chunk
    once; the Vt transpose's 256 units, one a thread (``vt_unit``), cover
    Vt once, in the staging that the P fragments read (kv row 8 j +
    sigma(c) at position 8 j + c,
    ``test_tf32_p_fragment_and_permuted_v_staging``), and each 8-lane
    phase's raw reads and Vt writes fall in 8 distinct 16-byte bank groups
    (no bank conflict)."""
    bq, bk, dk, dv = 64, 32, 192, 128
    nt = _cu_constants(_tf32_src())["kMlaProducers"]
    assert nt == 2 * dv
    for rows, cols in ((bk, dk), (bk, dv), (bq, dk)):
        for r in range(rows):
            for c in range(0, cols, 4):
                assert _tma_box_offset(r, c, rows) == _swz(r, c // 4, rows)
    for rows, cols, per in ((bq, dk, 12), (bk, dk, 6), (bk, dv, 4)):
        seen = np.zeros(rows * cols // 4, int)
        for n in range(per):
            for wt in range(nt):
                u = wt + n * nt
                seen[_swz(u // (cols // 4), u % (cols // 4), rows) // 16] += 1
        assert (seen == 1).all()
    rng = np.random.default_rng(26)
    vraw = rng.integers(-99, 99, (bk, dv)).astype(np.float64)
    flat = np.full(bk * dv, np.nan)                # raw V as TMA puts it
    for r in range(bk):
        for c in range(dv):
            flat[_tma_box_offset(r, c, bk) // 4] = vraw[r, c]
    vt = np.full((dv, bk), np.nan)
    units = set()
    for n in range(2 * dv // nt):
        for wt in range(nt):
            ch, nv = _vt_unit(wt + n * nt)
            units.add((ch, nv))
            for m in range(4):
                kr = 8 * (ch // 2) + ch % 2 + 2 * m
                chunk = flat[_swz(kr, nv, bk) // 4:][:4]
                for e in range(4):
                    assert np.isnan(vt[4 * nv + e, 4 * ch + m])
                    vt[4 * nv + e, 4 * ch + m] = chunk[e]
    assert units == {(ch, nv) for ch in range(8) for nv in range(dv // 4)}
    want = np.empty((dv, bk))
    for row in range(dv):
        for pos in range(bk):
            ch, m = pos // 4, pos % 4
            want[row, pos] = vraw[8 * (ch // 2) + ch % 2 + 2 * m, row]
    np.testing.assert_array_equal(vt, want)
    for p in range(2 * dv // 8):
        lanes = [_vt_unit(8 * p + lane) for lane in range(8)]
        for m in range(4):
            groups = {(_swz(8 * (ch // 2) + ch % 2 + 2 * m, nv, bk) // 16)
                      % 8 for ch, nv in lanes}
            assert len(groups) == 8, (p, m)
        for e in range(4):
            groups = {(ch ^ ((4 * nv + e) & 7)) for ch, nv in lanes}
            assert len(groups) == 8, (p, e)


@pytest.mark.parametrize("s,t,dh,dv,h,kv,causal", [
    (512, 512, 192, 128, 2, 2, True),
    (192, 320, 192, 128, 4, 2, True),
    (320, 200, 192, 128, 2, 2, True),
    (256, 256, 192, 128, 2, 2, False),
    (384, 384, 136, 64, 2, 2, True),
    (200, 136, 136, 64, 2, 1, False)])
def test_tf32_mla_schedule_within_tolerance(s, t, dh, dv, h, kv, causal):
    """flash_tf32_mla_kernel's arithmetic, emulated by ``_emulate_tf32``
    over its 32-key tiles (the dh <= 128 kernels' order: each tile's Q
    K^T, the softmax, O rescaled, then P V, every product three TF32
    products), within F32_TOL of the plain version at MLA's head (dh 192
    / dv 128) and at dh 136 / dv 64: causal with S = T and S != T both
    ways (the top-left mask; T ragged against the tiles, zero-filled),
    a GQA group, and not causal."""
    q, k, v = (torch.tensor(x) for x in _qkv(
        np.random.default_rng(s + t + dh), 1, h, kv, s, t, dh, dv))
    bq = 64 if s % 64 == 0 else 8
    bk = 8 if t % 64 else 64
    want = tkernel.flash_forward_plain(q, k, v, bq, bk, causal)
    got = _emulate_tf32(q, k, v, True, causal)
    err = float((got - want).abs().max())
    assert err <= F32_TOL, err


# ---------------------------------------------------------------------------
# the backward (K9 f32's backward kernel and its plain version)
# ---------------------------------------------------------------------------

BWD_TOL = 1e-5


def _bwd_inputs(seed, b, h, kv, s, dh, dv=None):
    dv = dh if dv is None else dv
    rng = np.random.default_rng(seed)
    q, k, v = _qkv(rng, b, h, kv, s, s, dh, dv)
    do = rng.normal(size=(b, h, s, dv)).astype(np.float32)
    return q, k, v, do


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plain_grads(q, k, v, do, bq=64, bk=64, causal=True):
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = tkernel.flash_forward_plain(tq, tk, tv, bq, bk, causal,
                                         with_lse=True)
    return tkernel.flash_backward_plain(tq, tk, tv, o, tdo, lse, bq, bk,
                                        causal)


@pytest.mark.parametrize("b,h,kv,s,dh", [
    (2, 4, 2, 128, 64),      # GQA
    (1, 4, 4, 128, 64),      # MHA
    (1, 6, 2, 192, 96),      # GQA, phi3-mini's head dim
    (1, 2, 1, 128, 128),     # MQA, minitron-4b's head dim
])
def test_bwd_plain_vs_jax_grad(b, h, kv, s, dh):
    """``flash_backward_plain`` (S == T, causal) within 1e-5 of jax.grad
    of ``repro.models.attention.attention``, the jnp function the
    reference differentiates, at the same scale dh ** -0.5."""
    import jax
    from repro.models import ModelConfig as RefConfig
    from repro.models.attention import attention as ref_attention
    q, k, v, do = _bwd_inputs(s + dh, b, h, kv, s, dh)
    cfg = RefConfig(name="t", num_layers=1, d_model=h * dh, num_heads=h,
                    num_kv_heads=kv, d_ff=4, vocab_size=8,
                    param_dtype="float32", dtype="float32")
    tr = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))   # [B, S, H, d]

    def loss(q_, k_, v_):
        return jnp.sum(ref_attention(q_, k_, v_, cfg) * tr(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(tr(q), tr(k), tr(v))
    got = _plain_grads(q, k, v, do)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 2, 1, 3)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=BWD_TOL, atol=BWD_TOL)


@pytest.mark.parametrize("case", [
    (1, 4, 2, 128, 128, 64, 64, 64, 64, True),
    (2, 2, 1, 64, 128, 32, 48, 32, 64, True),    # S < T, dv != dh
    (1, 3, 3, 128, 64, 16, 16, 32, 32, True),    # S > T
    (1, 2, 2, 128, 64, 16, 16, 64, 32, False),
])
def test_bwd_plain_equals_autograd_of_forward(case):
    """The plain backward against autograd of ``flash_forward_plain``
    (the same function differentiated op by op) within 1e-5 of the
    largest gradient, and ``flash_forward`` on grad-requiring CPU
    tensors (the ``FlashAttention`` function) gives the plain version's
    o and gradients, launching nothing."""
    b, h, kv, s, t, dh, dv, bq, bk, causal = case
    rng = np.random.default_rng(sum(case[:8]))
    q, k, v = _qkv(rng, b, h, kv, s, t, dh, dv)
    do = torch.tensor(rng.normal(size=(b, h, s, dv)).astype(np.float32))
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = tkernel.flash_forward_plain(*xs, bq, bk, causal)
    want = torch.autograd.grad(o, xs, do)
    before = (tkernel.LIB.launches, tkernel.BWD_LIB.launches)
    o2 = tkernel.flash_forward(*xs, bq, bk, causal)
    assert o2.grad_fn is not None and torch.equal(o2, o)
    got = torch.autograd.grad(o2, xs, do)
    assert (tkernel.LIB.launches, tkernel.BWD_LIB.launches) == before
    for g, w in zip(got, want):
        assert _rel(g, w) <= BWD_TOL


def test_bwd_lse_is_the_rows_log_sum_exp():
    """The plain forward's lse is each row's m + log(l): logsumexp of the
    scaled, masked scores, within float32 rounding."""
    q, k, v, _ = _bwd_inputs(5, 1, 4, 2, 128, 32)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    o, lse = tkernel.flash_forward_plain(tq, tk, tv, 64, 64, with_lse=True)
    assert torch.equal(o, tkernel.flash_forward_plain(tq, tk, tv, 64, 64))
    scale = float(np.float32(32 ** -0.5))
    sc = torch.einsum("bhsd,bhtd->bhst", tq * scale,
                      tk.repeat_interleave(2, dim=1)).double()
    mask = torch.ones(128, 128, dtype=torch.bool).tril()
    want = torch.logsumexp(sc.masked_fill(~mask, -np.inf), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("s", [100, 64, 129])
def test_bwd_padded_rows_get_exact_zeros(s):
    """``models.attention._flash``'s padding (S to a multiple of 64, the
    output sliced): the padded query rows' and keys' gradients are exact
    zeros, and the real rows' equal the unpadded plain attention's."""
    import torch.nn.functional as F
    from repro_torch.models import attention as mattn
    rng = np.random.default_rng(s)
    b, h, kv, dh = 2, 4, 2, 32
    q = torch.tensor(rng.normal(size=(b, s, h, dh)).astype(np.float32))
    k = torch.tensor(rng.normal(size=(b, s, kv, dh)).astype(np.float32))
    v = torch.tensor(rng.normal(size=(b, s, kv, dh)).astype(np.float32))
    do = torch.tensor(rng.normal(size=(b, s, h, dh)).astype(np.float32))
    pad = -s % mattn.K9_TILE
    padded = [F.pad(x.transpose(1, 2), (0, 0, 0, pad)).requires_grad_()
              for x in (q, k, v)]
    o = tkernel.flash_forward(*padded, mattn.K9_TILE, mattn.K9_TILE)
    grads = torch.autograd.grad(o[:, :, :s].transpose(1, 2), padded, do)
    for g in grads:
        assert g.is_contiguous()
        assert torch.count_nonzero(g[:, :, s:]) == 0
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(mattn._plain_attention(*xs, q_offset=0), xs,
                               do)
    for g, w in zip(grads, want):
        assert _rel(g[:, :, :s].transpose(1, 2), w) <= BWD_TOL
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(mattn._flash(*xs), xs, do)
    for g, w in zip(got, grads):
        assert torch.equal(g, w[:, :, :s].transpose(1, 2))


def test_bwd_raises_on_the_card_without_a_kernel(monkeypatch):
    """Head dims past MAX_DH / MAX_DV with a gradient asked for on the
    card raise NotImplementedError naming K9's backward, before any
    launch, in float32 and bfloat16; both dtypes pass ``_check_backward``
    up to MLA's head (dh 192, dv 128) and at dh 64 and 128, each having
    backward kernels there."""
    for dh, dv in ((64, 64), (128, 128), (192, 128)):
        tkernel._check_backward(dh, dv)
    for dh, dv in ((256, 128), (192, 136)):
        with pytest.raises(NotImplementedError, match="K9 backward"):
            tkernel._check_backward(dh, dv)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for dtype in (torch.float32, torch.bfloat16):
        xs = [torch.zeros(1, 2, 64, d, dtype=dtype, requires_grad=True)
              for d in (256, 256, 128)]
        with pytest.raises(NotImplementedError, match="K9 backward"):
            tkernel.flash_forward(xs[0], xs[1][:, :1], xs[2][:, :1], 64, 64)


# ---- the backward kernel's schedule (csrc/flash_f32_bwd.cu), emulated ----

_BWD_SRC = os.path.join(os.path.dirname(tkernel.__file__), "csrc",
                        "flash_f32_bwd.cu")


def _bwd_consts():
    """The kernel's tiling from its sources (``tf32_split.cuh``'s 32-row
    steps): (kBM, kBN, a block's threads)."""
    src = open(_BWD_SRC).read() + open(os.path.join(
        os.path.dirname(_BWD_SRC), "tf32_split.cuh")).read()

    def get(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    return get("kBM"), get("kBN"), get("kThreads")


def _bwd_smem(d):
    """The members of the kernel's ``Smem<D>`` at head dim d, each
    evaluated from its definition in the source."""
    body = re.search(r"struct Smem \{(.*?)\n\};", open(_BWD_SRC).read(),
                     re.S).group(1)
    kbm, kbn, _ = _bwd_consts()
    env = {"kBM": kbm, "kBN": kbn, "D": d}
    for name, expr in re.findall(
            r"static constexpr uint32_t (\w+) = ([^;]+);", body):
        env[name] = eval(expr.replace("/", "//"), {}, env)
    return env


def _emulate_bwd(q, k, v, o, do, lse, causal=True, three=True):
    """The kernel's three launches in torch, with its tiles, order and
    precision: D = rowsum(do o); one dkdv block per (b, kv head, 64-row kv
    tile), which walks its G query heads in order and, for each, the
    32-row query tiles from the causal frontier on, taking S^T = K (q
    scale)^T and dP^T = V do^T, P^T and dS^T in float32, and adding each
    step's P^T dO and dS^T (q scale) to its sums; one dq block per (b,
    head, 64-row query tile), which walks the 32-row kv tiles up to the
    frontier and adds each step's dS K.  Every product is three TF32
    products of split operands, (a_hi b_lo + a_lo b_hi) + a_hi b_hi, or
    one, a_hi b_hi (``three`` False); a step's product is added to the
    float32 sums as a whole (the kernel takes it on the tensor cores into
    fresh registers).  Every tile pair masks past S, past T and above the
    diagonal.  Returns (dq, dk, dv, visits): visits counts each (b, head,
    32-row query tile, 64-row kv tile) the dkdv blocks took."""
    kbm, kbn, _ = _bwd_consts()
    b, h, s, dh = q.shape
    kv, t, dv = k.shape[1], k.shape[2], v.shape[-1]
    g_ = h // kv
    scale = float(np.float32(dh ** -0.5))

    def parts(x):
        return _split(x) if three else (_tf32(x), None)

    def mm(a, bb):                  # a [M, K] b [K, N], both as parts
        if not three:
            return a[0] @ bb[0]
        return (a[0] @ bb[1] + a[1] @ bb[0]) + a[0] @ bb[0]

    def tr(a):
        return tuple(None if x is None else x.T for x in a)

    def tile(x, r0, rows, n):       # rows [r0, r0 + rows) zero past n
        out = torch.zeros((rows,) + x.shape[1:], dtype=x.dtype)
        m = max(0, min(rows, n - r0))
        out[:m] = x[r0:r0 + m]
        return out

    delta = (do * o).sum(-1)
    dq, dk, dvv = (torch.zeros_like(x) for x in (q, k, v))
    visits = {}
    nk, nq = -(-t // kbm), -(-s // kbn)
    for blk in range(b * kv * nk):              # the longest tiles first
        kt_i, bkv = blk // (b * kv), blk % (b * kv)
        bi, kvh = bkv // kv, bkv % kv
        t0 = kt_i * kbm
        kp = parts(tile(k[bi, kvh], t0, kbm, t))
        vp = parts(tile(v[bi, kvh], t0, kbm, t))
        adk = torch.zeros((kbm, dh))
        adv = torch.zeros((kbm, dv))
        rows = t0 + torch.arange(kbm)[:, None]
        for gg in range(g_):
            hh = kvh * g_ + gg
            for qi in range(min(nq, t0 // kbn) if causal else 0, nq):
                q0 = qi * kbn
                qp = parts(tile(q[bi, hh] * scale, q0, kbn, s))
                gp = parts(tile(do[bi, hh], q0, kbn, s))
                lt = tile(lse[bi, hh], q0, kbn, s)
                dt = tile(delta[bi, hh], q0, kbn, s)
                cols = q0 + torch.arange(kbn)[None, :]
                live = (cols < s) & (rows < t) & ((rows <= cols) | (not causal))
                pt = torch.where(live, torch.exp(mm(kp, tr(qp)) - lt), 0.0)
                dst = pt * (mm(vp, tr(gp)) - dt)
                adv = adv + mm(parts(pt), gp)
                adk = adk + mm(parts(dst), qp)
                key = (bi, hh, qi, kt_i)
                visits[key] = visits.get(key, 0) + 1
        n = max(0, min(kbm, t - t0))
        dk[bi, kvh, t0:t0 + n], dvv[bi, kvh, t0:t0 + n] = adk[:n], adv[:n]
    nq, nk = -(-s // kbm), -(-t // kbn)
    for blk in range(b * h * nq):
        qi, bh = nq - 1 - blk // (b * h), blk % (b * h)
        bi, hh = bh // h, bh % h
        q0 = qi * kbm
        qp = parts(tile(q[bi, hh] * scale, q0, kbm, s))
        gp = parts(tile(do[bi, hh], q0, kbm, s))
        lt = tile(lse[bi, hh], q0, kbm, s)[:, None]
        dt = tile(delta[bi, hh], q0, kbm, s)[:, None]
        rows = q0 + torch.arange(kbm)[:, None]
        last = min(nk, (q0 + kbm + kbn - 1) // kbn) if causal else nk
        adq = torch.zeros((kbm, dh))
        for kt_i in range(last):
            t0 = kt_i * kbn
            kp = parts(tile(k[bi, hh // g_], t0, kbn, t))
            vp = parts(tile(v[bi, hh // g_], t0, kbn, t))
            cols = t0 + torch.arange(kbn)[None, :]
            live = (rows < s) & (cols < t) & ((cols <= rows) | (not causal))
            p = torch.where(live, torch.exp(mm(qp, tr(kp)) - lt), 0.0)
            ds = p * (mm(gp, tr(vp)) - dt)
            adq = adq + mm(parts(ds), kp)
        n = max(0, min(kbm, s - q0))
        dq[bi, hh, q0:q0 + n] = adq[:n] * scale
    return dq, dk, dvv, visits


@pytest.mark.parametrize("b,h,kv,s,t,dh,dv,causal", [
    (1, 4, 2, 192, 192, 64, 64, True),
    (2, 3, 1, 100, 100, 18, 10, True),       # ragged S and T, odd dims
    (1, 2, 2, 128, 256, 32, 48, True),       # S < T
    (1, 4, 2, 192, 128, 64, 32, True),       # S > T
    (1, 2, 1, 128, 192, 16, 16, False),
])
def test_bwd_schedule_within_tolerance(b, h, kv, s, t, dh, dv, causal):
    """The emulated schedule against ``flash_backward_plain`` (padded to
    the plain version's tiles) within BWD_TOL of the largest gradient;
    every (head, 32-row query tile, 64-row kv tile) pair under the causal
    frontier visited exactly once by the dkdv blocks; a kv head's G query
    heads summed in one block in a fixed order (the emulation is
    deterministic: two runs bitwise)."""
    kbm, kbn, _ = _bwd_consts()
    rng = np.random.default_rng(s * 7 + t)
    q, k, v = (torch.tensor(x) for x in _qkv(rng, b, h, kv, s, t, dh, dv))
    do = torch.tensor(rng.normal(size=(b, h, s, dv)).astype(np.float32))
    sp, tp = s + -s % 64, t + -t % 64
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))
    # padding is exact here: a real causal query never reads a padded key
    o, lse = tkernel.flash_forward_plain(pad(q, sp), pad(k, tp), pad(v, tp),
                                         64, 64, causal, with_lse=True)
    o, lse = o[:, :, :s], lse[:, :, :s]
    want = tkernel.flash_backward_plain(pad(q, sp), pad(k, tp), pad(v, tp),
                                        pad(o, sp), pad(do, sp),
                                        pad(lse[..., None], sp)[..., 0],
                                        64, 64, causal)
    want = (want[0][:, :, :s], want[1][:, :, :t], want[2][:, :, :t])
    *got, visits = _emulate_bwd(q, k, v, o, do, lse, causal)
    *again, _ = _emulate_bwd(q, k, v, o, do, lse, causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for g, w in zip(got, want):
        assert _rel(g, w) <= BWD_TOL
    nq, nk = -(-s // kbn), -(-t // kbm)
    want_pairs = {(bi, hh, qi, ki) for bi in range(b) for hh in range(h)
                  for qi in range(nq) for ki in range(nk)
                  if not causal or ki * kbm <= qi * kbn + kbn - 1}
    assert set(visits) == want_pairs and set(visits.values()) == {1}


@pytest.mark.parametrize("d", [64, 128])
def test_bwd_shared_memory_budget(d):
    """The backward kernels' shared memory at head dim d, from the
    source's ``Smem<D>``: the two parts of two resident [64, d] tiles, the
    step's two stacked [64, d] tiles, two raw [32, d] tiles and two steps'
    lse and D lie one after another from a 1024-aligned base, each
    operand tile on a 1024-byte boundary (the 128-byte swizzle's 8-row
    atom), and the block, alignment slack included, fits an SM's 232,448
    bytes.  The staging loops' chunk counts divide by the threads, and a
    tile's 2 d transposed units take a thread at most once."""
    kbm, kbn, nt = _bwd_consts()
    assert (kbm, kbn, nt) == (64, 32, 256)
    m = _bwd_smem(d)
    part, raw = kbm * d * 4, kbn * d * 4
    assert (m["kPart"], m["kRaw"]) == (part, raw)
    # a step's [32, d] tile as two stacked parts fills one [64, d] tile,
    # and so does its transpose's two [d, 32] parts
    assert 2 * raw == part and 2 * (d * kbn * 4) == part
    layout = [("kAhi", part), ("kAlo", part), ("kBhi", part),
              ("kBlo", part), ("kX", part), ("kY", part), ("kRawX", raw),
              ("kRawY", raw), ("kLse", 2 * kbn * 4), ("kDelta", 2 * kbn * 4)]
    end = 0
    for name, size in layout:
        assert m[name] == end, name
        if name.startswith(("kA", "kB", "kX", "kY", "kRaw")):
            assert m[name] % 1024 == 0, name
        end += size
    assert m["kBytes"] == end + 1024 <= 232448
    assert (kbm * d // 4) % nt == 0 and (kbn * d // 4) % nt == 0
    assert 2 * d <= nt


def _bwd_units(d):
    """The kernel's transposed units (t_unit): unit u of 2 d -> (ch, nv)."""
    out = []
    a_ = d // 32
    for u in range(2 * d):
        p_, l_ = u // 8, u % 8
        out.append((l_ ^ (2 * (p_ // (2 * a_))),
                    8 * (p_ % a_) + 2 * (l_ // 2) + (p_ // a_) % 2))
    return out


def _swz(r, c4, rows):
    """Byte offset of 16-byte chunk c4 of row r in a swizzled tile of
    ``rows`` rows in 32-column sub-tiles."""
    return (c4 // 8) * (rows * 128) + r * 128 + (((c4 % 8) ^ (r & 7)) << 4)


@pytest.mark.parametrize("product", ["dV = P^T dO", "dK = dS^T Q",
                                     "dQ = dS K"])
@pytest.mark.parametrize("d", [64, 128])
def test_bwd_fragments_against_transposed_staging(product, d):
    """The accumulating products take their A operand from a score
    tile's accumulator (m64n32: register 4 j + 2 h + e of thread t holds
    row 16 w + g + 8 h, column 8 j + 2 qd + e) as the TF32 A fragments of
    four k8 steps (register r: row 16 w + g + 8 (r % 2), column qd + 4 (r
    / 2), accumulator 4 j + 2 (r % 2) + r / 2), and their B operand from
    the step's [32, d] tile staged twice in shared memory by the kernel's
    threads (dkdv: 256 threads over Q and dO, each in turn; dq: 256 over
    K): ``stage_rows`` stacks its parts (lo at row r, hi at row 32 + r of
    a swizzled [64, d] tile), then ``stage_cols`` moves them, a unit a
    thread, to the transpose [d, 32] (hi, then lo d 128 bytes on) with
    sigma's order.
    Every element of both tiles is written once, each 8-lane phase of
    the 16-byte loads and stores falls in 8 bank groups, the parts keep
    their part, and sum_j A_j Bt_j^T, read as wgmma reads the swizzled
    tile, is exactly X Y on integer data, for each part."""
    kbm, kbn, nt = _bwd_consts()
    ntile, which = {"dV = P^T dO": (2, 1), "dK = dS^T Q": (2, 0),
                    "dQ = dS K": (1, 0)}[product]
    assert 2 * d <= nt               # stage_cols: a unit a thread
    rng = np.random.default_rng(d + len(product))
    x = rng.integers(-8, 9, (kbm, kbn)).astype(np.float64)
    y = {part: rng.integers(-8, 9, (kbn, d)).astype(np.float64)
         for part in ("hi", "lo")}
    c4n = d // 4
    # stage_rows: tile `which` of `ntile`, its parts stacked; labels
    # (part, row, column) at word addresses
    nat, phases = {}, []
    for tl in range(ntile):
        for n in range(kbn * c4n // nt):
            groups = {}
            for tid in range(nt):
                u = tid + n * nt
                r, c4 = u // c4n, u % c4n
                for part, row in (("hi", r + kbn), ("lo", r)):
                    off = _swz(row, c4, kbm)
                    groups.setdefault((part, tid // 8), set()).add(
                        off // 16 % 8)
                    if tl == which:
                        for e in range(4):
                            w = (off + 4 * e) // 4
                            assert w not in nat
                            nat[w] = (part, r, 4 * c4 + e)
            phases += list(groups.values())
    assert all(len(gr) == 8 for gr in phases)
    assert len(nat) == 2 * kbn * d
    # stage_cols: each tile in turn, unit u on thread u; read the stacked
    # parts, write the transposes
    units = _bwd_units(d)
    trans, reads, writes = {}, {}, {}
    for tl in range(ntile):
        for tid in range(2 * d):
            n = tl
            ch, nv = units[tid]
            for m_ in range(4):
                r = 8 * (ch // 2) + ch % 2 + 2 * m_
                for part, row in (("lo", r), ("hi", r + kbn)):
                    off = _swz(row, nv, kbm)
                    reads.setdefault((n, tid // 8, m_, part), set()).add(
                        off // 16 % 8)
                    for e in range(4):
                        row_t = 4 * nv + e
                        toff = (0 if part == "hi" else d * 128) + \
                            row_t * 128 + ((ch ^ (row_t & 7)) << 4) + 4 * m_
                        writes.setdefault((n, tid // 8, e, part),
                                          set()).add(toff // 16 % 8)
                        if tl == which:
                            assert toff // 4 not in trans
                            trans[toff // 4] = nat[(off + 4 * e) // 4]
    assert all(len(gr) == 8 for gr in list(reads.values())
               + list(writes.values()))
    assert len(trans) == 2 * kbn * d
    # the accumulator, its A fragments, and Bt as the wgmma reads it
    for part in ("hi", "lo"):
        bt = np.empty((d, kbn))
        for nn in range(d):
            for kk in range(kbn):
                toff = (0 if part == "hi" else d * 128) + nn * 128 + \
                    (((kk // 4) ^ (nn & 7)) << 4) + 4 * (kk % 4)
                lp, lr, lc = trans[toff // 4]
                assert lp == part and lc == nn
                bt[nn, kk] = y[part][lr, lc]
        got = np.zeros((kbm, d))
        for j in range(4):
            a = np.full((kbm, 8), np.nan)
            for tid in range(128):
                w_, g_, qd = tid // 32, (tid % 32) // 4, tid % 4
                for r in range(4):
                    row, col = 16 * w_ + g_ + 8 * (r % 2), qd + 4 * (r // 2)
                    # accumulator 4 j + 2 (r % 2) + r / 2
                    hh, e = r % 2, r // 2
                    assert np.isnan(a[row, col])
                    a[row, col] = x[16 * w_ + g_ + 8 * hh, 8 * j + 2 * qd + e]
            assert not np.isnan(a).any()
            got += a @ bt[:, 8 * j:8 * j + 8].T
        np.testing.assert_array_equal(got, x @ y[part])


@pytest.mark.parametrize("three", [True, False])
def test_bwd_precision_three_products(three):
    """Why the backward takes three TF32 products: emulated at its
    precision on a seeded causal GQA layer (dh 128, S 1024, H 2, KV 1),
    dq, dk and dv are held to ``flash_backward_plain`` within BWD_TOL of
    the largest gradient.  Three products pass; one TF32 product a
    product is witnessed to violate it."""
    q, k, v, do = (torch.tensor(x) for x in
                   _bwd_inputs(1024, 1, 2, 1, 1024, 128))
    o, lse = tkernel.flash_forward_plain(q, k, v, 64, 64, with_lse=True)
    want = tkernel.flash_backward_plain(q, k, v, o, do, lse, 64, 64)
    *got, _ = _emulate_bwd(q, k, v, o, do, lse, three=three)
    err = max(_rel(g, w) for g, w in zip(got, want))
    if three:
        assert err <= BWD_TOL, err
    else:
        assert err > BWD_TOL, err
