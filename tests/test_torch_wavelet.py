"""The port's Haar wavelet module (``repro_torch.core.wavelet``) against
the reference's (``repro.core.wavelet``).

The reference's seven wavelet tests run against the port, and every
function is held BITWISE to the reference's on the same numpy-seeded
inputs: both are float64 host code with the same operations in the same
order, so any difference is a porting fault."""

import numpy as np
import pytest

from repro.core import wavelet as rw
from repro_torch.core import wavelet

SEEDS = (0, 1, 7, 42, 1234)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n", [(0, 2), (1, 3), (2, 64), (3, 100),
                                    (4, 129), (5, 200)])
def test_perfect_reconstruction(seed, n):
    x = np.random.default_rng(seed).normal(size=n)
    c = wavelet.haar_dwt(x)
    xr = wavelet.reconstruct(c, n)
    np.testing.assert_allclose(x, xr, atol=1e-9)
    _same(c, rw.haar_dwt(x))
    _same(wavelet.haar_idwt(c), rw.haar_idwt(c))
    _same(xr, rw.reconstruct(c, n))


def test_compression_keeps_top_energy():
    x = np.sin(np.linspace(0, 4 * np.pi, 128))
    c_full = wavelet.haar_dwt(x)
    c16 = wavelet.compress(x, 16)
    assert (c16 != 0).sum() <= 16
    # kept coefficients carry most of the energy
    assert np.sum(c16 ** 2) >= 0.95 * np.sum(c_full ** 2)
    _same(c16, rw.compress(x, 16))


def test_wavelet_similarity_self():
    x = np.random.default_rng(0).normal(size=100)
    assert wavelet.wavelet_similarity(x, x) > 0.999
    assert wavelet.wavelet_similarity(x, x) == rw.wavelet_similarity(x, x)


@pytest.mark.parametrize("seed", SEEDS)
def test_streaming_haar_equals_offline_at_every_chunk_boundary(seed):
    """StreamingHaar prefix coefficients == offline haar_dwt of the same
    edge-extended prefix, bitwise, at EVERY chunk boundary of a random
    chunking, and bitwise the reference's StreamingHaar fed the same
    chunks (compressed coefficients too)."""
    rng = np.random.default_rng(seed)
    total = int(rng.integers(2, 200))
    x = rng.normal(size=total)
    sh = wavelet.StreamingHaar(total)
    ref = rw.StreamingHaar(total)
    lo = 0
    while lo < total:
        c = int(rng.integers(1, max(2, total // 3)))
        sh.update(x[lo: lo + c])
        ref.update(x[lo: lo + c])
        lo = min(lo + c, total)
        prefix = np.pad(x[:lo], (0, sh.size - lo), mode="edge")
        np.testing.assert_array_equal(sh.coeffs(), wavelet.haar_dwt(prefix))
        _same(sh.coeffs(), ref.coeffs())
        _same(sh.compressed(16), ref.compressed(16))
        assert (sh.n, sh.size) == (ref.n, ref.size)
    assert sh.size == wavelet._next_pow2(max(total, 2))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_streaming_haar_regrows_past_expected_len(seed):
    """expected_len is a prediction: a job that overruns the power-of-two
    target regrows transparently and stays equal to the offline
    transform, and to the reference at every chunk boundary."""
    rng = np.random.default_rng(3 + seed)
    x = rng.normal(size=70)
    sh = wavelet.StreamingHaar(16)          # predicted 16, actual 70
    ref = rw.StreamingHaar(16)
    for lo in range(0, 70, 7):
        sh.update(x[lo: lo + 7])
        ref.update(x[lo: lo + 7])
        _same(sh.coeffs(), ref.coeffs())
        hi = min(lo + 7, 70)
        np.testing.assert_array_equal(sh.coeffs(), wavelet.haar_dwt(
            np.pad(x[:hi], (0, sh.size - hi), mode="edge")))
    assert sh.size == 128
    want = wavelet.haar_dwt(np.pad(x, (0, 128 - 70), mode="edge"))
    np.testing.assert_array_equal(sh.coeffs(), want)
    # compressed() keeps at most m nonzeros of the same coefficients
    cm = sh.compressed(16)
    assert (cm != 0).sum() <= 16
    assert set(np.flatnonzero(cm)) <= set(np.flatnonzero(want))


def test_coeff_similarity_bank_matches_offline_tail():
    """The split-out cosine tail reproduces wavelet_similarity_bank."""
    rng = np.random.default_rng(9)
    x = rng.random(100)
    bank = rng.random((5, 90)).astype(np.float64)
    lengths = np.full((5,), 90, np.int64)
    want = wavelet.wavelet_similarity_bank(x, bank, lengths, m=32)
    n = max(wavelet._next_pow2(100), wavelet._next_pow2(90))
    xp = np.pad(x, (0, n - 100), mode="edge")
    bp = np.pad(bank, ((0, 0), (0, n - 90)), mode="edge")
    cx = wavelet.compress(xp, 32)
    cb = wavelet.compress_bank(wavelet.haar_dwt_bank(bp), 32)
    np.testing.assert_array_equal(wavelet.coeff_similarity_bank(cx, cb),
                                  want)
    _same(want, rw.wavelet_similarity_bank(x, bank, lengths, m=32))


def test_wavelet_matching_agrees_with_dtw_on_easy_cases():
    from repro_torch import mrsim
    p = mrsim.paper_param_sets()[0]
    exim = mrsim.simulate_cpu_series("exim", p)
    wc = mrsim.simulate_cpu_series("wordcount", p)
    ts = mrsim.simulate_cpu_series("terasort", p)
    s_wc = wavelet.wavelet_similarity(exim, wc, m=64)
    s_ts = wavelet.wavelet_similarity(exim, ts, m=64)
    assert s_wc > s_ts
    assert (s_wc, s_ts) == (rw.wavelet_similarity(exim, wc, m=64),
                            rw.wavelet_similarity(exim, ts, m=64))


def _bank_inputs(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 9))
    lengths = rng.integers(5, 120, size=k)
    width = int(lengths.max())
    bank = np.zeros((k, width), np.float32)
    for i, n in enumerate(lengths):
        bank[i, :n] = rng.random(n)
        bank[i, n:] = bank[i, n - 1]
    return rng, bank, lengths


@pytest.mark.parametrize("seed", SEEDS)
def test_bank_functions_bitwise_reference(seed):
    """The batched forms (DWT bank, per-row truncation, the whole-DB
    ranking and its cosine tail), the scalar similarity and distance,
    and the per-reference matcher: bitwise the reference's."""
    rng, bank, lengths = _bank_inputs(seed)
    x = rng.random(int(rng.integers(3, 150)))
    for m in (4, 16, 64, 1024):
        _same(wavelet.haar_dwt_bank(bank), rw.haar_dwt_bank(bank))
        cb = wavelet.haar_dwt_bank(bank)
        _same(wavelet.compress_bank(cb, m), rw.compress_bank(cb, m))
        _same(wavelet.compress(x, m), rw.compress(x, m))
        _same(wavelet.wavelet_similarity_bank(x, bank, lengths, m=m),
              rw.wavelet_similarity_bank(x, bank, lengths, m=m))
        n = cb.shape[1]
        cx = wavelet.compress(
            np.pad(x, (0, max(0, n - len(x))), mode="edge")[:n], m)
        _same(wavelet.coeff_similarity_bank(cx, cb),
              rw.coeff_similarity_bank(cx, cb))
        assert wavelet.wavelet_similarity(x, bank[0], m=m) == \
            rw.wavelet_similarity(x, bank[0], m=m)
    assert wavelet.wavelet_distance(x[:7], x[:5]) == \
        rw.wavelet_distance(x[:7], x[:5])
    refs = {f"r{i}": bank[i, :n] for i, n in enumerate(lengths)}
    assert dict(wavelet.match_series_wavelet(x, refs, m=16)) == \
        dict(rw.match_series_wavelet(x, refs, m=16))
    # degenerate: an empty bank and constant (zero-energy) series
    assert wavelet.wavelet_similarity_bank(
        x, np.zeros((0, 4)), np.zeros((0,), np.int64)).shape == (0,)
    zeros = np.zeros((2, 32))
    _same(wavelet.coeff_similarity_bank(np.zeros(32), zeros),
          rw.coeff_similarity_bank(np.zeros(32), zeros))
