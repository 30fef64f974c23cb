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


# --- the kernels' warp wavefront (csrc/score.cu::score_warp), emulated ---

_F = np.float32
_INF = _F(3.0e38)
_HALF = _F(0.5)


def _pair(nch, yc, yy, xm, v):
    """dtw_sweep.cuh::pair: the cell's NCH pair values."""
    out = [yc, yy, _F(xm * yc)]
    if nch >= 4:
        out.append(_F(v * yc))
    if nch == 6:
        out += [_F(v * yy), _F(v * out[2])]
    return out


def _cell(nch, x, xm, v, center, y, yc, yy, j, band, dd, dm, vd, vm, hd,
          hb):
    """dtw_sweep.cuh::dp_cell -> (D, base, moments)."""
    d = np.abs(_F(x - y))
    if band >= 0 and abs(j - center) > band:
        d = _INF
    best = min(min(dd, vd), hd)
    with np.errstate(over="ignore"):
        cell = min(_F(d + best), _INF)
    sel_diag = dd <= min(vd, hd)
    sel_vert = not sel_diag and vd <= hd
    base = list(dm if sel_diag else vm if sel_vert else hb)
    cur = _pair(nch, yc, yy, xm, v)
    return cell, base, [_F(b + c) for b, c in zip(base, cur)]


def _wavefront(nch, x, v, xl, y, lk, band, lanes, width):
    """One warp's schedule for one (query, reference) pair, step by step:
    lane l updates row t - l across its strip of w_eff columns; its left
    boundary comes from lane l - 1's previous step (a shuffle), the diag
    from the step before that, lane 0's from the previous panel's edge
    buffer; a strip cut by the reference's end still computes w_eff
    cells.  Returns the endpoint (distance, moments)."""
    w_eff = min(width, max(-(-lk // lanes), 1))
    pw = lanes * w_eff
    npanel = -(-lk // pw) if lk > 0 else 0
    qden = max(xl - 1, 1)
    zero = [_F(0)] * nch
    edge = np.zeros((max(xl, 1), 1 + nch), np.float32)
    vd = vm = s0 = None
    for p in range(npanel):
        s0 = [p * pw + l * w_eff for l in range(lanes)]
        ncol = [max(0, min(w_eff, lk - s)) for s in s0]
        nact = min(lanes, -(-(lk - p * pw) // w_eff))
        yv = [[y[s + w] if w < n else _F(0) for w in range(width)]
              for s, n in zip(s0, ncol)]
        ycv = [[_F(a - _HALF) for a in row] for row in yv]
        yyv = [[_F(a * a) for a in row] for row in ycv]
        ycl = [_F(y[s - 1] - _HALF) if s > 0 and n > 0 else _F(0)
               for s, n in zip(s0, ncol)]
        yyl = [_F(a * a) for a in ycl]
        vd = [[_INF] * width for _ in range(lanes)]
        vm = [[zero] * width for _ in range(lanes)]
        sd, sb = [_INF] * lanes, [zero] * lanes
        pd, pb = [_INF] * lanes, [zero] * lanes
        pxm, pv = [_F(0)] * lanes, [_F(0)] * lanes
        for t in range(xl + nact - 1):
            recv = [(sd[l - 1], sb[l - 1]) if l else None
                    for l in range(lanes)]
            for l in range(lanes):
                i = t - l
                if l == 0:
                    if p > 0 and i < xl:
                        hd, hb = edge[i, 0], list(edge[i, 1:])
                    else:
                        hd, hb = _INF, zero
                else:
                    hd, hb = recv[l]
                if not (0 <= i < xl and ncol[l] > 0):
                    continue
                xv = x[i]
                xm = _F(xv - _HALF)
                vv = v[i] if nch > 3 else _F(0)
                center = i * (lk - 1) // qden if band >= 0 else 0
                if i == 0:
                    dd, dm = (_F(0) if s0[l] == 0 else _INF), zero
                else:
                    dd = pd[l]
                    prv = _pair(nch, ycl[l], yyl[l], pxm[l], pv[l])
                    dm = [_F(b + c) for b, c in zip(pb[l], prv)]
                pd[l], pb[l], pxm[l], pv[l] = hd, hb, xm, vv
                # a strip cut by lk computes all w_eff cells, as the
                # kernel does: those at or past lk see y = 0, feed nothing
                for w in range(w_eff):
                    od, om = vd[l][w], vm[l][w]
                    hd, hb, vm[l][w] = _cell(
                        nch, xv, xm, vv, center, yv[l][w], ycv[l][w],
                        yyv[l][w], s0[l] + w, band, dd, dm, od, om, hd, hb)
                    vd[l][w] = hd
                    dd, dm = od, om
                sd[l], sb[l] = hd, hb
                if l == lanes - 1 and p + 1 < npanel:
                    edge[i] = [hd] + hb
    if npanel == 0 or xl == 0:
        return _INF, zero
    owner = (lk - 1 - (npanel - 1) * pw) // w_eff
    w = lk - 1 - s0[owner]
    return vd[owner][w], vm[owner][w]


def _wavefront_bank(nch, xs, xvars, xlens, bank, band, lanes, width):
    """Endpoint distances [J, K] and moments [NCH, J, K] of every pair."""
    j, k = len(xlens), len(bank.lengths)
    dists = np.zeros((j, k), np.float32)
    moms = np.zeros((nch, j, k), np.float32)
    for q in range(j):
        for r in range(k):
            d, m = _wavefront(nch, xs[q], xvars[q], int(xlens[q]),
                              bank.series[r], int(bank.lengths[r]),
                              -1 if band is None else band, lanes, width)
            dists[q, r] = d
            moms[:, q, r] = m
    return dists, moms


@pytest.mark.parametrize("nch", [3, 4, 6])
@pytest.mark.parametrize("band", [None, 1, 4])
@pytest.mark.parametrize("lanes,width", [(4, 3), (32, 12)])
def test_wavefront_schedule_bitwise_plain(nch, band, lanes, width):
    """The warp wavefront's schedule (skewed rows, strips, shuffled
    boundaries, panels, the band and the closed-end capture), emulated in
    float32 with few lanes and a narrow strip so that panels occur, and
    with the kernel's 32 lanes of 12 columns: its endpoints through the
    score (and probability) tails are bitwise the plain versions' on
    dyadic data.  Ragged lengths: references shorter than a strip, of one
    column and longer than a panel; queries of 0 and 1 rows and shorter
    than the lanes; band 1 is narrower than a strip."""
    rng = np.random.default_rng(31 * nch + (band or 0) + lanes)
    rlens = [1, 2, 5, 13, 30] if lanes == 4 else [1, 7, 33, 400]
    bank = pack_series([_dyadic_series(rng, n) for n in rlens])
    xlens = np.asarray([0, 1, 3, 11, 17], np.int32)
    if lanes == 32:
        xlens = np.asarray([1, 6, 40], np.int32)
    n = int(xlens.max())
    xs = _queries(rng, xlens, n, _dyadic_series)
    xv = _queries(rng, xlens, n,
                  lambda r, m: (r.integers(0, 5, m) / 64.0).astype(np.float32))
    dists, moms = _wavefront_bank(nch, xs, xv, xlens, bank, band, lanes,
                                  width)
    folds = [tdtw.query_moments(xs[q, :xlens[q]]) for q in range(len(xlens))]
    t = {name: torch.tensor(a) for name, a in (
        ("xs", xs), ("xv", xv), ("xl", xlens), ("len", bank.lengths),
        ("bank", bank.series.T.copy()),
        ("sx", np.asarray([f[0] for f in folds], np.float32)),
        ("sxx", np.asarray([f[1] for f in folds], np.float32)))}
    nn = torch.clamp_min(t["xl"], 1).float()[:, None]
    sxj, sxxj = t["sx"][:, None], t["sxx"][:, None]
    m = torch.tensor(moms)
    live = t["xl"][:, None] > 0
    scores = torch.where(live, tscore.corr_from_moments(
        m[0], m[1], m[2], sxj, sxxj, nn), 0.0)
    if nch == 3:
        want = tscore.score_bank_offline_plain(
            t["xs"], t["xl"], t["bank"], t["len"], t["sx"], t["sxx"], band)
        got = (scores, torch.tensor(dists))
    else:
        vst = torch.tensor(np.asarray(
            [tdtw.query_var_moments(xs[q, :xlens[q]], xv[q, :xlens[q]])
             for q in range(len(xlens))], np.float32))
        want = tscore.score_bank_offline_var_plain(
            t["xs"], t["xv"], t["xl"], t["bank"], t["len"], t["sx"],
            t["sxx"], vst, band, threshold=0.85, approx=nch == 4)
        sv, svx, svxx = (vst[:, i:i + 1] for i in range(3))
        if nch == 4:
            probs = tscore.prob_from_moments_approx(
                m[0], m[1], m[2], m[3], sxj, sxxj, sv, svx, svxx, nn, 0.85)
        else:
            probs = tscore.prob_from_moments(
                m[0], m[1], m[2], m[3], m[4], m[5], sxj, sxxj, sv, svx,
                svxx, nn, 0.85)
        got = (scores, torch.where(live, probs, 0.0), torch.tensor(dists))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
