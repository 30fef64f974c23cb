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


def _emulate_tf32(q, k, v, three: bool) -> torch.Tensor:
    """The float32 tensor-core kernel's precision in torch, causal, over
    its 32-key tiles: q scaled (rounded to float32), then each operand
    split into TF32 parts and every product taken as hi lo + lo hi + hi hi,
    the small products first (``three``), or as one TF32 product; the
    online softmax in float32.  Tiles past a row's frontier add exact
    zeros, so every row runs every tile."""
    b, h, s, dh = q.shape
    g = h // k.shape[1]
    scale = float(np.float32(dh ** -0.5))
    qh, ql = _split(q * scale)
    kf = k.repeat_interleave(g, dim=1)
    vf = v.repeat_interleave(g, dim=1)
    m = torch.full((b, h, s), tkernel.NEG)
    l = torch.zeros((b, h, s))
    o = torch.zeros((b, h, s, vf.shape[-1]))
    rows = torch.arange(s)[:, None]

    def dot(ah, al, bh, bl):
        if not three:
            return torch.matmul(ah, bh)
        return (torch.matmul(ah, bl) + torch.matmul(al, bh)) \
            + torch.matmul(ah, bh)

    for t0 in range(0, kf.shape[2], 32):
        kh, kl = _split(kf[:, :, t0:t0 + 32])
        vh, vl = _split(vf[:, :, t0:t0 + 32])
        sc = dot(qh, ql, kh.transpose(-1, -2), kl.transpose(-1, -2))
        sc = torch.where(t0 + torch.arange(32)[None] <= rows, sc,
                         tkernel.NEG)
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
