"""The port's verdict scorer (plain PyTorch version of kernel K2) against
``repro.core.dtw.dtw_score_bank_many``: its jnp wavefront and its Pallas
kernel in interpret mode.  Bitwise on dyadic-grid data, scores and
endpoint distances alike; distances are bitwise on smooth data too (every
cell is the same min-plus update)."""

import numpy as np
import pytest
import torch

from repro.core import dtw as rdtw
from repro.core.database import pack_series
from repro_torch.core import dtw as tdtw
from repro_torch.kernels.dtw import score as tscore


def _dyadic_series(rng, n, denom=8, hi=9):
    return (rng.integers(0, hi, n) / float(denom)).astype(np.float32)


def _queries(rng, xlens, n, make):
    xs = np.zeros((len(xlens), n), np.float32)
    for i, l in enumerate(xlens):
        xs[i, :l] = make(rng, int(l))
    return xs


@pytest.mark.parametrize("use_kernel,block_k", [(False, 64), (True, 128),
                                                (True, 4)])
@pytest.mark.parametrize("band", [None, 6])
def test_plain_scorer_bitwise_vs_reference(use_kernel, block_k, band):
    """Ragged dyadic bank and ragged queries (xlen < N): scores and
    distances equal the reference's bitwise, through its jnp path and
    its Pallas kernel (block_k 4 pads the reference tiles)."""
    rng = np.random.default_rng(7 if band is None else 13)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(10, 30)))
                        for _ in range(7)])
    xlens = np.asarray([21, 9, 16, 1], np.int32)
    xs = _queries(rng, xlens, 24, _dyadic_series)
    want = rdtw.dtw_score_bank_many(
        xs, bank.series, bank.lengths, xlens=xlens, band=band,
        use_kernel=use_kernel, interpret=True if use_kernel else None,
        block_k=block_k, return_distances=True)
    got = tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                   xlens=xlens, band=band, device="cpu",
                                   return_distances=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("band", [None, 6])
def test_scorer_distances_equal_distance_bank(band):
    """The port's endpoint distances equal the reference's
    ``dtw_distance_bank`` bitwise, on dyadic and on continuous data."""
    rng = np.random.default_rng(3)
    for make in (_dyadic_series,
                 lambda r, n: r.random(n).astype(np.float32)):
        bank = pack_series([make(rng, int(rng.integers(12, 40)))
                            for _ in range(9)])
        x = make(rng, 31)
        _, dists = tdtw.dtw_score_bank(x, bank.series, bank.lengths,
                                       band=band, device="cpu",
                                       return_distances=True)
        want = np.asarray(rdtw.dtw_distance_bank(
            x, bank.series, bank.lengths, band=band))
        np.testing.assert_array_equal(dists.numpy(), want)


def test_plain_scorer_smooth_data():
    """Smooth data: the closed-end scores track the reference's jnp
    scorer; both carry the same moment bases through the same selections,
    so they agree to float32 rounding of the folds (1e-5)."""
    rng = np.random.default_rng(11)
    series = []
    for i in range(8):
        l = int(rng.integers(30, 70))
        t = np.linspace(0, 1, l, dtype=np.float32)
        series.append(np.clip(0.5 + 0.3 * np.sin(2 * np.pi * (1 + i) * t)
                              + 0.05 * rng.normal(size=l), 0, 1)
                      .astype(np.float32))
    bank = pack_series(series)
    xlens = np.asarray([50, 33, 64], np.int32)
    xs = _queries(rng, xlens, 64,
                  lambda r, n: np.clip(0.5 + 0.2 * r.normal(size=n), 0, 1)
                  .astype(np.float32))
    want = rdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                    xlens=xlens, band=8, use_kernel=False)
    got = tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                   xlens=xlens, band=8, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_score_bank_plan_and_unported_options():
    """A plan is bank-specific; variance mode (once an unported option,
    now ported) returns scores and probabilities and refuses an unknown
    prob_mode; a CPU call counts no kernel launch."""
    rng = np.random.default_rng(0)
    bank = pack_series([_dyadic_series(rng, 12) for _ in range(3)])
    xs = _dyadic_series(rng, 10)[None]
    plan = tdtw.build_score_plan(bank.series[:2], bank.lengths[:2],
                                 device="cpu")
    with pytest.raises(ValueError):
        tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths, plan=plan)
    sc, pr = tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                      xvars=np.zeros_like(xs), device="cpu")
    assert torch.equal(pr, (sc >= 0.9).float())
    with pytest.raises(ValueError):
        tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                 xvars=np.zeros_like(xs), prob_mode="bogus",
                                 device="cpu")
    before = tscore.LIB.launches
    full = tdtw.build_score_plan(bank.series, bank.lengths, device="cpu")
    a = tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths, plan=full)
    b = tdtw.dtw_score_bank_many(xs, bank.series, bank.lengths,
                                 device="cpu")
    assert tscore.LIB.launches == before
    assert torch.equal(a, b)
