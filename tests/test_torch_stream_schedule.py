"""The ticks' column sweep (``csrc/dtw_sweep.cuh::sweep_pass``, launched
by ``csrc/stream.cu`` for K1, K3 and K4), emulated step by step in
float32 and held bitwise to the plain versions on dyadic data.

The emulation runs the kernel's schedule as written: a group of G lanes
a (slot, reference) pair, 16 / G rows a lane, lane g at column t - g of
step t; lane 0 reads the state row, lane g > 0 the last row of lane
g - 1 from the step before (the shuffle, one column late); lanes before
their first column are fed the virtual column (y = 0.5, distance 3e38,
moments 0), and after their last they compute columns nothing reads
(lane 0 from a stale ring slot, NaN here); the full-chunk pass without
row guards and the partial one with them; chunks past 16 samples in
passes that alternate between the output and a scratch state.  The
kernel splits the rows over 1 lane (0 and 3 channels) or 2 (4 and 6);
the test takes every split from 1 to 16 lanes.  Every lane's registers
are numpy arrays over the bank axis, so a fault in the order shows here
before it shows on the card."""

import numpy as np
import pytest
import torch

from repro.core.database import pack_series
from repro_torch.kernels.dtw import stream as tstream

_F = np.float32
_INF = _F(3.0e38)
_HALF = _F(0.5)
_PASS = tstream.PASS_ROWS
#: Column slots of a warp's load ring (dtw_sweep.cuh's kRing): the step
#: loop runs in rounds of this many steps.
_RING = 8


def _pair(nch, yc, yy, xm, v):
    """dtw_sweep.cuh::pair over the bank axis."""
    out = [yc, yy, xm * yc]
    if nch >= 4:
        out.append(v * yc)
    if nch == 6:
        out += [v * yy, v * out[2]]
    return out


def _cell(nch, x, xm, v, center, y, yc, yy, j, band, dd, dm, vd, vm, hd,
          hb):
    """dtw_sweep.cuh::dp_cell over the bank axis -> (D, base, moments)."""
    d = np.abs(x - y)
    if band >= 0:
        d = np.where(np.abs(j - center) > band, _INF, d)
    vh = np.minimum(vd, hd)
    best = np.minimum(dd, vh) if nch else np.minimum(vd, np.minimum(dd, hd))
    cell = np.minimum(d + best, _INF)
    sel_diag = dd <= vh
    sel_vert = ~sel_diag & (vd <= hd)
    cur = _pair(nch, yc, yy, xm, v)
    base = [np.where(sel_diag, dm[c], np.where(sel_vert, vm[c], hb[c]))
            for c in range(nch)]
    return cell, base, [b + u for b, u in zip(base, cur)]


def _sweep_pass(nch, lanes, full, x, v, nrows, n0, qlen, band, lengths, y,
                d_in, m_in, d_out, m_out):
    """One pass of ``nrows`` rows for one slot, all references at once:
    d_in/d_out [M, K], m_in/m_out [NCH, M, K], y [M, K]."""
    m, k = y.shape
    rpl = _PASS // lanes
    qden = max(qlen - 1, 1)
    zero = np.zeros(k, _F)
    lane = []
    for g in range(lanes):
        nr = rpl if full else min(max(nrows - g * rpl, 0), rpl)
        rows = []
        for r in range(rpl):
            ok = full or r < nr
            xv = x[g * rpl + r] if ok else _F(0)
            rows.append(dict(
                x=xv, xm=_F(xv - _HALF),
                v=v[g * rpl + r] if nch > 3 and ok else _F(0),
                center=((n0 + g * rpl + r) * (lengths - 1)) // qden,
                d=np.full(k, _INF), b=[zero] * nch, f=[zero] * nch))
        lane.append(dict(nr=nr, rows=rows,
                         out=(np.full(k, _INF), [zero] * nch,
                              np.full(k, _HALF)),
                         dd0=np.full(k, _F(0) if g == 0 and n0 == 0
                                     else _INF),
                         dm0=[zero] * nch))
    nsteps = -(-(m + lanes - 1) // _RING) * _RING
    nan = np.full(k, np.nan, _F)
    for t in range(nsteps):
        # past the last column lane 0 reads a stale ring slot: NaN here,
        # which must reach no stored column
        first = (d_in[t], [m_in[c, t] for c in range(nch)], y[t]) \
            if t < m else (nan, [nan] * nch, nan)
        ins = [first] + [lane[g - 1]["out"] for g in range(1, lanes)]
        for g in range(lanes):
            j = t - g
            st = lane[g]
            ind, inm, iny = ins[g]
            yc = iny - _HALF
            yy = yc * yc
            dd, dm, vd, vm = st["dd0"], st["dm0"], ind, inm
            for r in range(rpl):
                if not (full or r < st["nr"]):
                    continue
                row = st["rows"][r]
                hd, nd = row["d"], row["f"]
                cell, row["b"], row["f"] = _cell(
                    nch, row["x"], row["xm"], row["v"], row["center"], iny,
                    yc, yy, j, band, dd, dm, vd, vm, hd, row["b"])
                row["d"] = cell
                dd, dm, vd, vm = hd, nd, cell, row["f"]
            st["dd0"], st["dm0"] = ind, inm
            st["out"] = (vd, vm, iny)
            if g == lanes - 1 and 0 <= j < m:
                d_out[j] = vd
                for c in range(nch):
                    m_out[c, j] = vm[c]


def _sweep_tick(nch, lanes, rows, moms, ns, bank_t, lengths, chunks,
                vchunks, nvalid, qlens, band):
    """stream.cu's kernel over every slot: passes of 16 rows, full or
    guarded, alternating between the output and a scratch state."""
    s_n, m, k = rows.shape
    moms = np.zeros((0, s_n, m, k), _F) if moms is None else moms
    outs = (np.empty_like(rows), np.empty_like(moms))
    tmps = (np.empty_like(rows), np.empty_like(moms))
    band = -1 if band is None else band
    with np.errstate(over="ignore"):
        for s in range(s_n):
            nv = int(nvalid[s])
            npass = -(-nv // _PASS) if nv > 0 else 1
            for p in range(npass):
                nr = min(nv - p * _PASS, _PASS)
                dst = outs if (npass - 1 - p) % 2 == 0 else tmps
                src = (rows, moms) if p == 0 else \
                    (tmps if dst is outs else outs)
                _sweep_pass(nch, lanes, nr == _PASS,
                            chunks[s, p * _PASS:], vchunks[s, p * _PASS:],
                            nr, int(ns[s]) + p * _PASS, int(qlens[s]), band,
                            lengths, bank_t, src[0][s], src[1][:, s],
                            dst[0][s], dst[1][:, s])
    return outs


def _plain_tick(nch, rows, moms, ns, bank_t, lengths, chunks, vchunks,
                nvalid, qlens, band):
    t = [torch.tensor(a) for a in (ns, bank_t, lengths, chunks)]
    nv, ql = torch.tensor(nvalid), torch.tensor(qlens)
    if nch == 0:
        return tstream.stream_bank_extend_plain(
            torch.tensor(rows), *t, nv, ql, band).numpy(), None
    if nch == 3:
        out = tstream.stream_bank_extend_scored_plain(
            torch.tensor(rows), torch.tensor(moms), *t, nv, ql, band)
    else:
        out = tstream.stream_bank_extend_scored_var_plain(
            torch.tensor(rows), torch.tensor(moms), *t,
            torch.tensor(vchunks), nv, ql, band)
    return out[0].numpy(), out[1].numpy()


@pytest.mark.parametrize("nch", [0, 3, 4, 6])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("band", [None, 6])
@pytest.mark.parametrize("c", [1, 12, 16, 32])
def test_sweep_schedule_bitwise_plain(nch, lanes, band, c):
    """Two ticks from the empty state on a ragged dyadic bank, one slot
    starting its job (the virtual corner), one taking a full chunk, one
    none (nvalid 0: the state copied through) and one a partial chunk:
    every row and moment of the emulated schedule is bitwise the plain
    version's, for any split of the 16 rows over 1-16 lanes."""
    rng = np.random.default_rng(1000 * nch + 10 * lanes + c
                                + (0 if band is None else 5))
    bank = pack_series([(rng.integers(0, 9, n) / 8.0).astype(_F)
                        for n in (3, 17, 9, 20, 1)])
    bank_t = bank.series.T.copy()
    lengths = bank.lengths.astype(np.int32)
    m, k = bank_t.shape
    s_n = 4
    qlens = np.full(s_n, 4 * c + 3, np.int32)
    rows = np.full((s_n, m, k), _INF)
    moms = np.zeros((nch, s_n, m, k), _F) if nch else None
    ns = np.zeros(s_n, np.int32)
    emu = (rows, moms)
    plain = (rows, moms)
    for tick in range(2):
        nvalid = np.array([c, c, 0, rng.integers(0, c + 1)], np.int32)
        if tick == 1:
            nvalid[0] = rng.integers(1, c + 1)
        chunks = (rng.integers(0, 9, (s_n, c)) / 8.0).astype(_F)
        vchunks = (rng.integers(0, 5, (s_n, c)) / 64.0).astype(_F)
        emu = _sweep_tick(nch, lanes, emu[0], emu[1], ns, bank_t, lengths,
                          chunks, vchunks, nvalid, qlens, band)
        plain = _plain_tick(nch, plain[0], plain[1], ns, bank_t, lengths,
                            chunks, vchunks, nvalid, qlens, band)
        np.testing.assert_array_equal(emu[0], plain[0])
        if nch:
            np.testing.assert_array_equal(emu[1], plain[1])
        ns = ns + nvalid
