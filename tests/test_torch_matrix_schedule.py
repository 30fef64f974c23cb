"""K7's warp wavefront (``csrc/matrix.cu::dtw_matrix_kernel``), emulated
step by step in float32 and held bitwise to the plain version
``kernels.dtw.matrix.dtw_rows_plain``.

The emulation runs the kernel's schedule as written: a warp a pair, lane
l a strip of W = min(12, ceil(M / 32)) columns, 32 strips a panel and
panels left to right through the [C] edge buffer; at step t lane l
updates row t - l, its strip's left edge shuffled from lane l - 1 one
step late and the diagonal one step before that; the carried row as row
-1, the virtual corner only at absolute row 0; the band centre carried
as a quotient and remainder a row; each lane stores its strip to row
t - l as it computes it.  Lanes are numpy arrays over the 32 lanes and
the pairs, so the test also checks what the kernel cannot report: every
cell (i, j) < (C, M) is computed once, after its three predecessors (an
earlier step, or the same lane earlier in its strip), and every cell is
stored exactly once, to i * M + j, with nothing stored past C or M."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.dtw import matrix as tmatrix

_F = np.float32
_INF = _F(3.0e38)
_LANES = 32
_STRIP = 12


def _cell(x, y, j, center, band, dd, vd, hd):
    """dtw_sweep.cuh::dp_cell<0, BAND> over the pairs: min(d + min(vd,
    min(dd, hd)), 3e38), d = |x - y| (3e38 outside the band)."""
    d = np.abs(x - y)
    if band >= 0:
        d = np.where(np.abs(j - center) > band, _INF, d)
    return np.minimum(d + np.minimum(vd, np.minimum(dd, hd)), _INF)


def _emulate(xs, ys, row_in, qlens, rlens, n0, band):
    """matrix.cu's kernel over P pairs -> (rows [P, C, M], last [P, M]),
    with the schedule's bookkeeping checked on the way."""
    p, c = xs.shape
    m = ys.shape[1]
    w_ = min(_STRIP, -(-m // _LANES))
    pw = _LANES * w_
    npanel = -(-m // pw)
    band = -1 if band is None else band
    size = c * m
    slack = 64 * m + 2 * pw                   # catches stores past the end
    out = np.full((p, size + slack), np.nan, _F)
    nstore = np.zeros(size + slack, np.int64)
    last = np.full((p, m + pw), np.nan, _F)
    nlast = np.zeros(m + pw, np.int64)
    # when each cell was computed: its panel and step (as one key), lane
    # and place in the strip; -1 not yet
    key = np.full((c, m), -1, np.int64)
    lane_of = np.full((c, m), -1, np.int64)
    w_of = np.full((c, m), -1, np.int64)
    edge = np.full((p, c), np.nan, _F)
    lanes = np.arange(_LANES)
    den = np.maximum(qlens.astype(np.int64) - 1, 1)
    a = np.abs(rlens.astype(np.int64) - 1)
    neg = rlens.astype(np.int64) - 1 < 0

    def store(addr, vals):
        assert (addr >= 0).all() and (addr < size + slack).all()
        out[:, addr] = vals
        np.add.at(nstore, addr, 1)

    def store_last(col, vals):
        assert (col >= 0).all() and (col < m + pw).all()
        last[:, col] = vals
        np.add.at(nlast, col, 1)

    for pn in range(npanel):
        pbase = pn * pw
        s0 = pbase + lanes * w_
        # the panel's whole strips, then the one M cuts, then none
        nfull = (m - pbase) // w_
        ncol = np.where(lanes < nfull, w_,
                        np.where(lanes == nfull, (m - pbase) % w_, 0))
        nact = min(_LANES, -(-(m - pbase) // w_))
        cols = s0[:, None] + np.arange(w_)[None, :]          # [32, W]
        has = np.arange(w_)[None, :] < ncol[:, None]
        yv = np.where(has, ys[:, np.minimum(cols, m - 1)], _F(0))
        vd = np.where(has, _INF if row_in is None
                      else row_in[:, np.minimum(cols, m - 1)], _INF)
        vd = np.broadcast_to(vd, (p, _LANES, w_)).astype(_F)
        first = _F(0) if n0 == 0 else _INF
        left = _INF if row_in is None \
            else row_in[:, np.clip(s0 - 1, 0, m - 1)]
        pd = np.where(s0 == 0, first,
                      np.where(ncol > 0, left, _INF)).astype(_F)
        pd = np.broadcast_to(pd, (p, _LANES)).copy()
        sd = np.full((p, _LANES), _INF, _F)
        # BandCentre: quotient and remainder of ai |rl - 1| over den
        q = (n0 * a) // den
        r = (n0 * a) % den
        q = np.repeat(q[:, None], _LANES, 1)
        r = np.repeat(r[:, None], _LANES, 1)
        for t in range(c + nact - 1):
            i = t - lanes
            rows_ok = (i >= 0) & (i < c)
            xv = np.where(rows_ok, xs[:, np.clip(i, 0, c - 1)], _F(0))
            hd = np.concatenate([sd[:, :1], sd[:, :-1]], axis=1)
            hd[:, 0] = edge[:, i[0]] if pn > 0 and 0 <= i[0] < c else _INF
            live = rows_ok & (ncol > 0)
            li = np.nonzero(live)[0]
            if li.size:
                cen = np.clip(np.where(neg[:, None], -q, q), -(1 << 30),
                              1 << 30)[:, li]
                dd = pd[:, li].copy()
                pd[:, li] = hd[:, li]
                h = hd[:, li]
                for w in range(w_):
                    j = cols[li, w]
                    real = j < m
                    ii, jj = t - li[real], j[real]
                    assert (key[ii, jj] < 0).all(), (t, w)
                    key[ii, jj] = (pn << 40) + t
                    lane_of[ii, jj] = li[real]
                    w_of[ii, jj] = w
                    od = vd[:, li, w].copy()
                    h = _cell(xv[:, li], yv[:, li, w], j, cen, band, dd, od,
                              h)
                    vd[:, li, w] = h
                    dd = od
                sd[:, li] = h
                if pn + 1 < npanel and live[_LANES - 1]:
                    edge[:, i[_LANES - 1]] = sd[:, _LANES - 1]
                q[:, li] += a[:, None] // den[:, None]
                r[:, li] += a[:, None] % den[:, None]
                over = r[:, li] >= den[:, None]
                r[:, li] -= np.where(over, den[:, None], 0)
                q[:, li] += over
                # each live lane's strip to row t - l, its ncol columns
                sel = has[li]
                ii = np.broadcast_to((t - li)[:, None], sel.shape)[sel]
                jj = cols[li][sel]
                vals = vd[:, li][:, sel]
                store(ii * m + jj, vals)
                tail = ii == c - 1
                if tail.any():
                    store_last(jj[tail], vals[:, tail])
    assert (key >= 0).all(), "a cell never computed"
    # every predecessor earlier: a former step, or this lane's strip
    # earlier in the same step
    for di, dj in ((1, 0), (0, 1), (1, 1)):
        now = np.s_[di:, dj:]
        pre = np.s_[:c - di, :m - dj]
        same = (key[now] == key[pre]) & (lane_of[now] == lane_of[pre]) \
            & (w_of[now] > w_of[pre])
        assert ((key[pre] < key[now]) | same).all(), (di, dj)
    assert (nstore[:size] == 1).all(), "a cell stored never or twice"
    assert (nstore[size:] == 0).all(), "a store past the last row"
    assert (nlast[:m] == 1).all() and (nlast[m:] == 0).all()
    return out[:, :size].reshape(p, c, m), last[:, :m]


def _series(rng, n, dyadic):
    if dyadic:
        return (rng.integers(0, 9, n) / 8.0).astype(_F)
    return rng.normal(size=n).astype(_F)


#: (C, M, band, resumed, dyadic): every C x M, banded and not, resumed
#: and not, dyadic and smooth; M 384 fills one panel exactly, 385 spills
#: one column into a second.
_CASES = [(c, m, band, resumed, dyadic)
          for c in (1, 15, 16, 384, 1100)
          for m in (1, 31, 360, 384, 385, 800)
          for band in (None, 5) for resumed in (False, True)
          for dyadic in (True, False)]


@pytest.mark.parametrize("c,m,band,resumed,dyadic", _CASES)
def test_matrix_schedule_bitwise_plain(c, m, band, resumed, dyadic):
    """Two pairs, ragged reference and query lengths for the band, with
    and without a carried row (n0 = 7 samples before the chunk): the
    emulated schedule computes and stores every cell exactly once, and
    its rows and last row are bitwise ``dtw_rows_plain``'s."""
    rng = np.random.default_rng(
        [c, m, 0 if band is None else band, resumed, dyadic])
    p = 2
    ys = np.stack([_series(rng, m, dyadic) for _ in range(p)])
    xs = np.stack([_series(rng, c, dyadic) for _ in range(p)])
    rlens = rng.integers(max(m // 2, 1), m + 1, p).astype(np.int32)
    n0 = 7 if resumed else 0
    qlens = (n0 + c + rng.integers(0, 5, p)).astype(np.int32)
    row_in = None
    if resumed:
        before = np.stack([_series(rng, n0, dyadic) for _ in range(p)])
        _, row = tmatrix.dtw_rows_plain(
            torch.tensor(before), torch.tensor(ys), torch.tensor(qlens),
            torch.tensor(rlens), band=band, collect_rows=False)
        row_in = row.numpy()
    want_rows, want_last = tmatrix.dtw_rows_plain(
        torch.tensor(xs), torch.tensor(ys), torch.tensor(qlens),
        torch.tensor(rlens), None if row_in is None else torch.tensor(row_in),
        n0, band)
    with np.errstate(over="ignore"):
        rows, last = _emulate(xs, ys, row_in, qlens, rlens, n0, band)
    np.testing.assert_array_equal(rows, want_rows.numpy())
    np.testing.assert_array_equal(last, want_last.numpy())
