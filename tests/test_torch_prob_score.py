"""The port's probabilistic verdict scorers (plain PyTorch versions of
kernels K5, exact, and K6, approx) and its probability tails against the
reference's offline variance kernel in interpret mode, its jnp tile
scorer and ``dtw_score_bank_many(xvars=)``.

On dyadic data with dyadic variances scores and endpoint distances are
compared bitwise.  Probabilities are held to PROB_TOL = 2e-6 absolute:
the tail's ``var_r`` sums terms of both signs, so a rounding difference
in one product (XLA may contract products into fused multiply-adds, the
port rounds each) is amplified by the cancellation, and the erfc
implementations differ in the last bits.  At zero variance sigma is
exactly 0 and the probabilities are bitwise the point rule."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dtw as rdtw
from repro.core.database import pack_series
from repro.kernels.dtw import (score_bank_offline_var_approx_kernel,
                               score_bank_offline_var_kernel)
from repro_torch.core import dtw as tdtw
from repro_torch.kernels.dtw import score as tscore

PROB_TOL = 2e-6
THR = 0.85


def _dyadic_series(rng, n):
    return (rng.integers(0, 9, n) / 8.0).astype(np.float32)


def _queries(rng, xlens, n):
    xs = np.zeros((len(xlens), n), np.float32)
    xv = np.zeros((len(xlens), n), np.float32)
    for i, ln in enumerate(xlens):
        xs[i, :ln] = _dyadic_series(rng, ln)
        xv[i, :ln] = (rng.integers(0, 5, ln) / 64.0).astype(np.float32)
    sx = np.zeros(len(xlens), np.float32)
    sxx = np.zeros(len(xlens), np.float32)
    vst = np.zeros((len(xlens), 3), np.float32)
    for i, ln in enumerate(xlens):
        sx[i], sxx[i] = tdtw.query_moments(xs[i, :ln])
        vst[i] = tdtw.query_var_moments(xs[i, :ln], xv[i, :ln])
    return xs, xv, sx, sxx, vst


def _port_scorer(xs, xv, xlens, bank, sx, sxx, vst, band, approx):
    return tscore.score_bank_offline_var(
        torch.tensor(xs), torch.tensor(xv), torch.tensor(xlens),
        torch.tensor(bank.series.T.copy()), torch.tensor(bank.lengths),
        torch.tensor(sx), torch.tensor(sxx), torch.tensor(vst), band, THR,
        approx=approx)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("ref", ["pallas", "jnp"])
@pytest.mark.parametrize("band,n", [(None, 20), (6, 20), (None, 7),
                                    (6, 40)])
def test_var_scorer_vs_reference(approx, ref, band, n):
    """Ragged queries (lengths 0, 1, short and full, one pass and several
    for the kernel) against a ragged bank: scores and distances bitwise,
    probabilities within PROB_TOL, against the Pallas variance kernel in
    interpret mode (block_k 4: reference-tile padding) and the jnp tile
    scorer."""
    rng = np.random.default_rng((3 if band is None else 10 * band) + n
                                + 7 * approx)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(12, 30)))
                        for _ in range(7)])
    xlens = np.asarray([n, max(n - 7, 2), n // 2 + 1, 1, 0], np.int32)
    xs, xv, sx, sxx, vst = _queries(rng, xlens, n)
    if ref == "pallas":
        kern = score_bank_offline_var_approx_kernel if approx \
            else score_bank_offline_var_kernel
        want = kern(xs, xv, xlens, bank.series, bank.lengths, sx, sxx, vst,
                    band=band, threshold=THR, block_k=4, interpret=True)
    else:
        want = rdtw._score_tile_var_many(
            jnp.asarray(xs), jnp.asarray(xv), jnp.asarray(xlens),
            jnp.asarray(bank.series), jnp.asarray(bank.lengths),
            jnp.asarray(sx), jnp.asarray(sxx), jnp.asarray(vst), band, THR,
            approx=approx)
    sc, pr, di = _port_scorer(xs, xv, xlens, bank, sx, sxx, vst, band,
                              approx)
    ws, wp, wd = (np.asarray(a) for a in want)
    # an endpoint the band leaves unreachable (distance 3e38) carries
    # don't-care moments, which the jnp scorer forms in its own order
    reach = (wd < 1e37) | (ref == "pallas")
    np.testing.assert_array_equal(di.numpy(), wd)
    np.testing.assert_array_equal(sc.numpy()[reach], ws[reach])
    np.testing.assert_allclose(pr.numpy()[reach], wp[reach], rtol=0,
                               atol=PROB_TOL)
    assert np.isfinite(pr.numpy()).all()
    if band is None:
        assert reach[xlens > 0].all()


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("band", [None, 6])
def test_var_scorer_zero_variance_reduces_bitwise(approx, band):
    """Zero variances: scores and distances equal the point scorer's (K2's
    plain version) bitwise and every probability is exactly
    1{score >= threshold}, as the reference's."""
    rng = np.random.default_rng(11 + band if band else 11)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(12, 30)))
                        for _ in range(7)])
    xlens = np.asarray([20, 13, 17], np.int32)
    xs, xv, sx, sxx, _ = _queries(rng, xlens, 20)
    zv, zst = np.zeros_like(xv), np.zeros((3, 3), np.float32)
    sc, pr, di = _port_scorer(xs, zv, xlens, bank, sx, sxx, zst, band,
                              approx)
    ps, pd = tscore.score_bank_offline(
        torch.tensor(xs), torch.tensor(xlens),
        torch.tensor(bank.series.T.copy()), torch.tensor(bank.lengths),
        torch.tensor(sx), torch.tensor(sxx), band)
    assert torch.equal(sc, ps) and torch.equal(di, pd)
    p = pr.numpy()
    assert set(np.unique(p)) <= {0.0, 1.0}
    np.testing.assert_array_equal(p == 1.0, sc.numpy() >= THR)
    kern = score_bank_offline_var_approx_kernel if approx \
        else score_bank_offline_var_kernel
    want = kern(xs, zv, xlens, bank.series, bank.lengths, sx, sxx, zst,
                band=band, threshold=THR, block_k=8, interpret=True)
    np.testing.assert_array_equal(p, np.asarray(want[1]))


@pytest.mark.parametrize("prob_mode", ["exact", "approx"])
def test_score_bank_many_xvars_vs_reference(prob_mode):
    """``dtw_score_bank_many(xvars=, prob_mode=)`` against the
    reference's jnp path (vstats computed inside on both sides, and
    passed in): scores and distances bitwise, probabilities within
    PROB_TOL; scores do not depend on prob_mode; the default threshold
    is the reference's."""
    rng = np.random.default_rng(91 if prob_mode == "exact" else 97)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(12, 30)))
                        for _ in range(9)])
    j, n = 3, 24
    xs = np.stack([_dyadic_series(rng, n) for _ in range(j)])
    xv = (rng.integers(0, 5, (j, n)) / 64.0).astype(np.float32)
    xlens = np.asarray([24, 19, 9], np.int32)
    want = rdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                    xlens=xlens, band=6, xvars=xv,
                                    prob_mode=prob_mode, use_kernel=False,
                                    return_distances=True)
    got = tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                   xlens=xlens, band=6, xvars=xv,
                                   prob_mode=prob_mode, device="cpu",
                                   return_distances=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=PROB_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    vst = np.stack([tdtw.query_var_moments(xs[i, :xlens[i]],
                                           xv[i, :xlens[i]])
                    for i in range(j)])
    again = tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                     xlens=xlens, band=6, xvars=xv,
                                     vstats=vst, prob_mode=prob_mode,
                                     device="cpu")
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    point = tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                     xlens=xlens, band=6, device="cpu")
    assert torch.equal(point, got[0])
    with pytest.raises(ValueError):
        tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                 xvars=xv[:, :5], device="cpu")


def test_query_var_moments_bitwise():
    rng = np.random.default_rng(2)
    x = rng.random(37).astype(np.float32)
    v = (0.02 * rng.random(37)).astype(np.float32)
    got = tdtw.query_var_moments(x, v)
    want = rdtw.query_var_moments(x, v)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a == b


@pytest.mark.parametrize("approx", [False, True])
def test_probability_tails_vs_reference(approx):
    """The tails alone on random moment sums built from real (x, y, v)
    triples, including constant queries and zero fold variance: finite,
    in [0, 1], within PROB_TOL of the reference's; exact zero variance
    gives the point rule bitwise."""
    rng = np.random.default_rng(8 + approx)
    cols = []
    for case in range(400):
        n = int(rng.integers(2, 60))
        x = rng.random(n) if case % 10 else np.full(n, 0.4)
        y = np.clip(x + rng.normal(scale=rng.uniform(0.01, 0.5), size=n),
                    0, 1) if case % 7 else rng.random(n)
        v = rng.uniform(0, 0.02, n) * (case % 5 != 0)
        xm, yc = x - 0.5, y - 0.5
        cols.append([yc.sum(), (yc * yc).sum(), (xm * yc).sum(),
                     (v * yc).sum(), (v * yc * yc).sum(),
                     (v * xm * yc).sum(), xm.sum(), (xm * xm).sum(),
                     v.sum(), (v * xm).sum(), (v * xm * xm).sum(), n])
    a = np.asarray(cols, np.float32).T
    if approx:
        idx = (0, 1, 2, 3, 6, 7, 8, 9, 10, 11)
        got = tdtw._prob_from_moments_approx(
            *(torch.tensor(a[i]) for i in idx), THR)
        want = rdtw._prob_from_moments_approx(
            *(jnp.asarray(a[i]) for i in idx), jnp.float32(THR))
    else:
        got = tdtw._prob_from_moments(*(torch.tensor(r) for r in a), THR)
        want = rdtw._prob_from_moments(*(jnp.asarray(r) for r in a),
                                       jnp.float32(THR))
    g, w = got.numpy(), np.asarray(want)
    assert np.isfinite(g).all() and (g >= 0).all() and (g <= 1).all()
    np.testing.assert_allclose(g, w, rtol=0, atol=PROB_TOL)
    zero = a[8] == 0
    assert zero.any()
    np.testing.assert_array_equal(g[zero], w[zero])
    assert set(np.unique(g[zero])) <= {0.0, 1.0}


def test_cpu_call_counts_no_launch():
    rng = np.random.default_rng(4)
    bank = pack_series([_dyadic_series(rng, 14) for _ in range(3)])
    xlens = np.asarray([10, 6], np.int32)
    xs, xv, sx, sxx, vst = _queries(rng, xlens, 10)
    before = dict(tscore.VAR_LAUNCHES), tscore.LIB.launches
    for approx in (False, True):
        a = _port_scorer(xs, xv, xlens, bank, sx, sxx, vst, 4, approx)
        b = tscore.score_bank_offline_var_plain(
            torch.tensor(xs), torch.tensor(xv), torch.tensor(xlens),
            torch.tensor(bank.series.T.copy()), torch.tensor(bank.lengths),
            torch.tensor(sx), torch.tensor(sxx), torch.tensor(vst), 4, THR,
            approx)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert (dict(tscore.VAR_LAUNCHES), tscore.LIB.launches) == before
