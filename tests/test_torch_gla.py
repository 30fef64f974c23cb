"""The port's GLA chunked scan — K10's plain version through
``repro_torch.kernels.gla.gla_scan`` — against the reference's
``repro.kernels.gla.gla_scan`` (its Pallas kernel in interpret mode) and
its model path ``repro.models.ssm.gla_chunked`` on the same numpy-seeded
inputs.

Tolerance: rtol 1e-4, atol 1e-5 on o and the final state, the
reference's kernel-against-model-path tolerance (``tests/test_kernels.py``):
the same chunk loop in float32, the products summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gla as rgla
from repro.models.ssm import gla_chunked
from repro_torch.kernels import gla as tgla
from repro_torch.kernels.gla import kernel as tkernel

RTOL, ATOL = 1e-4, 1e-5


def _inputs(rng, b, h, s, dk, dv):
    return (rng.normal(size=(b, h, s, dk)).astype(np.float32),
            (rng.normal(size=(b, h, s, dk)) * 0.3).astype(np.float32),
            rng.normal(size=(b, h, s, dv)).astype(np.float32),
            -np.abs(rng.normal(size=(b, h, s)) * 0.2).astype(np.float32))


def _port(q, k, v, log_a, chunk):
    before = tkernel.LIB.launches
    o, s = tgla.gla_scan(q, k, v, log_a, chunk=chunk, device="cpu")
    assert tkernel.LIB.launches == before      # the plain version ran
    return o, s


@pytest.mark.parametrize("B,H,S,dk,dv,chunk", [
    (1, 2, 32, 8, 8, 8), (2, 3, 64, 16, 8, 16), (1, 1, 128, 64, 64, 32),
])
def test_vs_reference_kernel(B, H, S, dk, dv, chunk):
    """tests/test_kernels.py's three shapes: o and the final state against
    the reference's interpret-mode kernel, and both within the reference's
    1e-3 of the float64 step oracle."""
    q, k, v, log_a = _inputs(np.random.default_rng(S + dk), B, H, S, dk, dv)
    ro, rs = rgla.gla_scan(q, k, v, log_a, chunk=chunk)
    o, s = _port(q, k, v, log_a, chunk)
    assert o.dtype == torch.float32 and o.shape == (B, H, S, dv)
    assert s.dtype == torch.float32 and s.shape == (B, H, dk, dv)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=RTOL,
                               atol=ATOL)
    oo, so = rgla.gla_ref(q, k, v, log_a)
    np.testing.assert_allclose(o.numpy(), oo, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), so, rtol=1e-3, atol=1e-4)


def test_vs_reference_model_path():
    """The reference's jnp ``gla_chunked`` (the models' path), as
    tests/test_kernels.py holds its kernel to it."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(1, 2, 64, 8)).astype(np.float32)
    k = rng.normal(size=(1, 2, 64, 8)).astype(np.float32)
    v = rng.normal(size=(1, 2, 64, 4)).astype(np.float32)
    log_a = -np.abs(rng.normal(size=(1, 2, 64)) * 0.1).astype(np.float32)
    o, s = _port(q, k, v, log_a, 16)
    o2, s2 = gla_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(log_a), 16)
    np.testing.assert_allclose(o.numpy(), np.asarray(o2), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s2), rtol=RTOL,
                               atol=ATOL)


def test_bf16_output_in_v_dtype():
    """bfloat16 inputs: o comes out in bfloat16, the state in float32, and
    both agree with the reference's kernel on the same bfloat16 inputs
    (o within one bfloat16 ulp, 2^-7 relative: the float32 sums round
    differently, and a rounding to bfloat16 can fall either side)."""
    q, k, v, log_a = _inputs(np.random.default_rng(3), 1, 2, 64, 16, 16)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    tq, tk, tv = (torch.tensor(t).to(torch.bfloat16) for t in (q, k, v))
    ro, rs = rgla.gla_scan(jq, jk, jv, log_a, chunk=16)
    o, s = _port(tq, tk, tv, log_a, 16)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(ro, np.float32), rtol=2 ** -7,
                               atol=ATOL)


@pytest.mark.parametrize("dk,dv", [(256, 256), (256, 1), (1, 256),
                                   (200, 130)])
def test_blocked_head_dims(dk, dv, monkeypatch):
    """Heads wider than K10's 128 (mLSTM's 1024, its normalizer's dv = 1)
    through ``gla_blocked``: o and the state against the reference's
    kernel (interpret mode) and its model path within the tolerance; the
    state bitwise the undivided plain version's (a state block needs only
    its own k and v blocks; at dk = 1 the undivided state update is a
    [1, L] x [L, dv] product, which the CPU's BLAS sums in another order
    than the padded [128, L] x [L, 128] blocks: within the tolerance);
    ceil(dv / 128) K10 calls, each over the dk blocks as extra heads of
    width 128."""
    from repro_torch.kernels.gla import ops as tops
    B, H, S, chunk = 1, 2, 64, 16
    q, k, v, log_a = _inputs(np.random.default_rng(dk + dv), B, H, S, dk, dv)
    q, k = (t / np.float32(np.sqrt(dk)) for t in (q, k))
    ro, rs = rgla.gla_scan(q, k, v, log_a, chunk=chunk)
    mo, ms = gla_chunked(*map(jnp.asarray, (q, k, v, log_a)), chunk)
    calls = []
    real = tops.gla_chunks

    def spy(qb, kb, vb, gb, c, out_dtype=None):
        calls.append((tuple(qb.shape), tuple(vb.shape), out_dtype))
        return real(qb, kb, vb, gb, c, out_dtype=out_dtype)

    monkeypatch.setattr(tops, "gla_chunks", spy)
    o, st = _port(q, k, v, log_a, chunk)
    nk = -(-dk // 128)
    assert calls == [((B, H * nk, S, 128), (B, H * nk, S, min(128, dv - j)),
                      torch.float32) for j in range(0, dv, 128)]
    assert o.shape == (B, H, S, dv) and st.shape == (B, H, dk, dv)
    for want_o, want_s in ((ro, rs), (mo, ms)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s),
                                   rtol=RTOL, atol=ATOL)
    tq, tk, tv = (torch.tensor(t) for t in (q, k, v))
    g = tkernel.chunk_cumsum(torch.tensor(log_a), chunk)
    po, ps = tkernel.gla_chunks_plain(tq, tk, tv, g, chunk)
    assert torch.equal(st, ps) or dk == 1
    np.testing.assert_allclose(st.numpy(), ps.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(o.numpy(), po.numpy(), rtol=RTOL, atol=ATOL)


def test_blocked_bf16():
    """bfloat16 heads of 256: o in bfloat16 (the float32 partials summed,
    then rounded once) within one bfloat16 step of the undivided plain
    version and of the reference's kernel on the same bfloat16 inputs;
    the state bitwise the undivided plain version's."""
    q, k, v, log_a = _inputs(np.random.default_rng(12), 1, 2, 64, 256, 256)
    q, k = q / 16.0, k / 16.0
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    tq, tk, tv = (torch.tensor(t).to(torch.bfloat16) for t in (q, k, v))
    ro, rs = rgla.gla_scan(jq, jk, jv, log_a, chunk=16)
    o, s = _port(tq, tk, tv, log_a, 16)
    g = tkernel.chunk_cumsum(torch.tensor(log_a), 16)
    po, ps = tkernel.gla_chunks_plain(tq, tk, tv, g, 16)
    assert o.dtype == torch.bfloat16 and torch.equal(s, ps)
    for want in (po.float().numpy(), np.asarray(ro, np.float32)):
        np.testing.assert_allclose(o.float().numpy(), want,
                                   rtol=RTOL + 2 ** -7, atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=RTOL,
                               atol=ATOL)


def test_float32_output_mode():
    """``out_dtype=torch.float32`` on bfloat16 inputs is the plain
    version's float32 o before its cast: cast, it is the bfloat16 o
    bitwise; the state is the same.  Other output dtypes are refused."""
    q, k, v, log_a = _inputs(np.random.default_rng(13), 1, 2, 64, 128, 96)
    tq, tk, tv = (torch.tensor(t).to(torch.bfloat16) for t in (q, k, v))
    g = tkernel.chunk_cumsum(torch.tensor(log_a), 16)
    o32, s32 = tkernel.gla_chunks(tq, tk, tv, g, 16,
                                  out_dtype=torch.float32)
    o16, s16 = tkernel.gla_chunks(tq, tk, tv, g, 16)
    assert o32.dtype == torch.float32 and o16.dtype == torch.bfloat16
    assert torch.equal(o32.to(torch.bfloat16), o16) and torch.equal(s32, s16)
    assert not torch.equal(o32, o16.float())
    with pytest.raises(ValueError, match="dtype"):
        tkernel.gla_chunks(tq, tk, tv, g, 16, out_dtype=torch.float16)


def test_oracle_copy_bitwise():
    q, k, v, log_a = _inputs(np.random.default_rng(4), 1, 2, 24, 4, 6)
    init = np.random.default_rng(5).normal(size=(1, 2, 4, 6))
    for state in (None, init):
        for a, b in zip(tgla.gla_ref(q, k, v, log_a, state),
                        rgla.gla_ref(q, k, v, log_a, state)):
            assert np.array_equal(a, b)


def test_chunk_cumsum():
    la = -np.abs(np.random.default_rng(6).normal(size=(1, 2, 12))) \
        .astype(np.float32)
    g = tkernel.chunk_cumsum(torch.tensor(la), 4).numpy()
    want = np.cumsum(la.reshape(1, 2, 3, 4), axis=-1).reshape(1, 2, 12)
    np.testing.assert_allclose(g, want, rtol=1e-6)
    assert np.all(g[..., 3::4] <= g[..., 0::4])


@pytest.mark.parametrize("change", ["chunk", "dtype", "log_a"])
def test_rejects_what_the_kernel_does_not_take(change):
    q, k, v, log_a = (torch.tensor(t) for t in _inputs(
        np.random.default_rng(8), 1, 2, 32, 8, 8))
    chunk = 8
    if change == "chunk":
        chunk = 12                          # S % chunk != 0
    elif change == "dtype":
        v = v.to(torch.bfloat16)
    else:
        log_a = log_a[0]
    with pytest.raises(ValueError):
        tgla.gla_scan(q, k, v, log_a, chunk=chunk, device="cpu")


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, k, v, log_a = _inputs(np.random.default_rng(9), 1, 1, 16, 4, 4)
    before = tkernel.LIB.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        tgla.gla_scan(q, k, v, log_a, chunk=8)
    assert tkernel.LIB.launches == before
