"""The port's DTW matrix path — the plain PyTorch version of kernel K7,
the batched ``kernels.dtw.ops`` API over it, the matrix functions, the
distance bank, the streaming bank DP of ``core.dtw`` and K2's pairs entry
— against the reference (``repro.kernels.dtw`` in interpret mode, its
numpy oracle, and ``repro.core.dtw``) on the same numpy-seeded inputs.

Tolerances: every comparison is bitwise on dyadic-grid data (every sum
is exact in float32).  On continuous data the port's per-cell recurrence
rounds like the reference's distance wavefront, K2 and the ticks
(bitwise), but not like the reference's min-plus scans (its matrix
functions and its Pallas K7), which sum the costs in a tree: those are
held to the reference's own 1e-4 (``tests/test_kernels.py``).
"""

import numpy as np
import pytest
import torch

from repro.core import dtw as rdtw
from repro.core.database import pack_series
from repro.kernels import dtw as rkern
from repro_torch.core import dtw as tdtw
from repro_torch.kernels.dtw import matrix as tmatrix
from repro_torch.kernels.dtw import ops as tops
from repro_torch.kernels.dtw import score as tscore

#: The reference's tolerance for its scan formulation against the
#: per-cell oracle (tests/test_kernels.py, tests/test_batched_matching.py).
SCAN_TOL = 1e-4
#: K2-style closed-end scores on continuous data: the same cells, the
#: score tail's float32 folds (tests/test_torch_score.py).
SCORE_TOL = 1e-5


def _dyadic(rng, n):
    return (rng.integers(0, 9, n) / 8.0).astype(np.float32)


def _normal(rng, n):
    return rng.normal(size=n).astype(np.float32)


def _bank(rng, make, lo, hi, k):
    return pack_series([make(rng, int(rng.integers(lo, hi))) for _ in range(k)])


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("n,m,k", [(16, 16, 1), (33, 57, 3), (64, 40, 2),
                                   (8, 128, 4)])
def test_plain_kernel_vs_pallas_and_oracle(n, m, k):
    """Random normal data (tests/test_kernels.py's sweep): the port's
    matrices against the reference's Pallas K7 in interpret mode and both
    packages' numpy oracles, to SCAN_TOL; the oracle copies agree
    exactly."""
    rng = np.random.default_rng(n * m + k)
    x = _normal(rng, n)
    ys = rng.normal(size=(k, m)).astype(np.float32)
    D = _np(tops.dtw_batched(x, ys, device="cpu"))
    want = np.asarray(rkern.dtw_batched(x, ys, interpret=True))
    np.testing.assert_allclose(D, want, rtol=SCAN_TOL, atol=SCAN_TOL)
    for i in range(k):
        ref = rkern.dtw_matrix_ref(x, ys[i])
        np.testing.assert_array_equal(tmatrix.dtw_matrix_ref(x, ys[i]), ref)
        np.testing.assert_allclose(D[i], ref, rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("n,m,band", [(1, 1, None), (1, 7, None),
                                      (7, 1, None), (9, 13, 0), (13, 9, 0)])
def test_edge_shapes(n, m, band):
    """One-row, one-column and band-0 matrices: bitwise the reference's
    (dyadic data), and the unbanded ones the numpy oracle."""
    rng = np.random.default_rng(n * 31 + m)
    x, y = _dyadic(rng, n), _dyadic(rng, m)
    if band is None:
        got = _np(tdtw.dtw_matrix(x, y, device="cpu"))
        np.testing.assert_array_equal(got, np.asarray(rdtw.dtw_matrix(x, y)))
        np.testing.assert_array_equal(got, rkern.dtw_matrix_ref(x, y))
    else:
        np.testing.assert_array_equal(
            _np(tdtw.dtw_matrix_banded(x, y, band, device="cpu")),
            np.asarray(rdtw.dtw_matrix_banded(x, y, band)))


def test_ops_bitwise_on_dyadic_data():
    """Dyadic data: ``dtw_batched``, ``dtw_batched_pairs``,
    ``dtw_distances(lengths=)`` and ``dtw_distances_pairs`` equal the
    reference's Pallas entry points bitwise, ragged on both sides."""
    rng = np.random.default_rng(5)
    bank = _bank(rng, _dyadic, 8, 40, 6)
    x = _dyadic(rng, 27)
    xs = np.stack([_dyadic(rng, 27) for _ in range(6)])
    xl = np.asarray([27, 3, 14, 1, 26, 9], np.int32)
    pairs = [
        (tops.dtw_batched(x, bank.series, device="cpu"),
         rkern.dtw_batched(x, bank.series, interpret=True)),
        (tops.dtw_batched_pairs(xs, bank.series, device="cpu"),
         rkern.dtw_batched_pairs(xs, bank.series, interpret=True)),
        (tops.dtw_distances(x, bank.series, device="cpu",
                            lengths=bank.lengths),
         rkern.dtw_distances(x, bank.series, True, lengths=bank.lengths)),
        (tops.dtw_distances(x, bank.series, device="cpu"),
         rkern.dtw_distances(x, bank.series, True)),
        (tops.dtw_distances_pairs(xs, bank.series, xl, bank.lengths,
                                  device="cpu"),
         rkern.dtw_distances_pairs(xs, bank.series, xl, bank.lengths,
                                   interpret=True)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_ops_rejects_pair_count_mismatch():
    with pytest.raises(ValueError, match="pair count"):
        tops.dtw_batched_pairs(np.zeros((3, 5), np.float32),
                               np.zeros((2, 5), np.float32), device="cpu")


@pytest.mark.parametrize("band", [None, 6])
@pytest.mark.parametrize("dyadic", [True, False])
def test_matrix_bank_and_pairs(band, dyadic):
    """``dtw_matrix_bank`` (band centred on the padded query length and
    each reference's true length) and ``dtw_matrix_pairs`` (band on both
    true lengths): whole padded matrices bitwise the reference's on
    dyadic data, within SCAN_TOL on continuous data."""
    rng = np.random.default_rng(11 if band is None else 12)
    make = _dyadic if dyadic else (lambda r, n: r.random(n)
                                   .astype(np.float32))
    bank = _bank(rng, make, 10, 40, 7)
    x = make(rng, 33)
    xs = np.stack([make(rng, 30) for _ in range(7)])
    xl = rng.integers(1, 31, 7).astype(np.int32)
    got = [tdtw.dtw_matrix_bank(x, bank.series, bank.lengths, band=band,
                                device="cpu"),
           tdtw.dtw_matrix_pairs(xs, bank.series, xl, bank.lengths,
                                 band=band, device="cpu")]
    want = [rdtw.dtw_matrix_bank(x, bank.series, bank.lengths, band=band),
            rdtw.dtw_matrix_pairs(xs, bank.series, xl, bank.lengths,
                                  band=band)]
    for g, w in zip(got, want):
        if dyadic:
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=SCAN_TOL,
                                       atol=SCAN_TOL)


@pytest.mark.parametrize("band", [None, 5])
def test_scalar_matrix_functions(band):
    """``dtw_matrix``/``dtw_matrix_banded``, ``dtw_distance``,
    ``cost_matrix`` and ``dtw_warp`` against the reference, dyadic data
    (bitwise; the warped series and distance exactly)."""
    rng = np.random.default_rng(21)
    x, y = _dyadic(rng, 29), _dyadic(rng, 37)
    if band is None:
        got = tdtw.dtw_matrix(x, y, device="cpu")
        want = rdtw.dtw_matrix(x, y)
        assert float(tdtw.dtw_distance(x, y, device="cpu")) == \
            float(rdtw.dtw_distance(x, y))
    else:
        got = tdtw.dtw_matrix_banded(x, y, band, device="cpu")
        want = rdtw.dtw_matrix_banded(x, y, band)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(tdtw.cost_matrix(x, y, device="cpu")),
                                  np.asarray(rdtw.cost_matrix(x, y)))
    yp, dist = tdtw.dtw_warp(x, y, band=band, device="cpu")
    ryp, rdist = rdtw.dtw_warp(x, y, band=band)
    np.testing.assert_array_equal(yp, ryp)
    assert dist == rdist


@pytest.mark.parametrize("band", [None, 6])
def test_distance_bank_bitwise_on_any_data(band):
    """``dtw_distance_bank`` (K7, last row only) equals the reference's
    per-cell wavefront bitwise on dyadic and on continuous data, and the
    port's K2 endpoint distances too."""
    rng = np.random.default_rng(31)
    for make in (_dyadic, lambda r, n: r.random(n).astype(np.float32)):
        bank = _bank(rng, make, 12, 40, 9)
        x = make(rng, 31)
        got = _np(tdtw.dtw_distance_bank(x, bank.series, bank.lengths,
                                         band=band, device="cpu"))
        want = np.asarray(rdtw.dtw_distance_bank(x, bank.series,
                                                 bank.lengths, band=band))
        np.testing.assert_array_equal(got, want)
        _, d2 = tdtw.dtw_score_bank(x, bank.series, bank.lengths, band=band,
                                    device="cpu", return_distances=True)
        np.testing.assert_array_equal(got, _np(d2))


def _chunks(rng, n):
    out, lo = [], 0
    while lo < n:
        c = int(rng.integers(1, max(2, n // 2)))
        out.append((lo, min(n, lo + c)))
        lo += c
    return out


@pytest.mark.parametrize("band", [None, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bank_extend_random_chunkings(band, seed):
    """Random chunkings: the port's streamed rows equal the reference's
    bitwise on dyadic data (ragged bank, banded); on continuous data the
    port's streamed rows equal its own one-shot matrix bitwise (any
    chunking is the same cells)."""
    rng = np.random.default_rng(40 + seed)
    n = 37
    for dyadic in (True, False):
        make = _dyadic if dyadic else (lambda r, k: r.random(k)
                                       .astype(np.float32))
        bank = _bank(rng, make, 8, 30, 5)
        x = make(rng, n)
        st = tdtw.dtw_bank_init(bank.series, bank.lengths, band=band,
                                query_len=n, device="cpu")
        rst = rdtw.dtw_bank_init(bank.series, bank.lengths, band=band,
                                 query_len=n)
        rows, rrows = [], []
        for lo, hi in _chunks(rng, n):
            st, r = tdtw.dtw_bank_extend(st, x[lo:hi], collect_rows=True)
            rows.append(_np(r))
            if dyadic:
                rst, rr = rdtw.dtw_bank_extend(rst, x[lo:hi],
                                               collect_rows=True)
                rrows.append(np.asarray(rr))
        rows = np.concatenate(rows)
        assert st.n == n and rows.shape == (n, 5, bank.series.shape[1])
        if dyadic:
            np.testing.assert_array_equal(rows, np.concatenate(rrows))
            np.testing.assert_array_equal(_np(st.row), np.asarray(rst.row))
            np.testing.assert_array_equal(_np(st.distances()),
                                          np.asarray(rst.distances()))
            np.testing.assert_array_equal(_np(st.prefix_distances()),
                                          np.asarray(rst.prefix_distances()))
        qlens = torch.full((5,), n, dtype=torch.int32)
        one, _ = tmatrix.dtw_rows(torch.tensor(x), torch.tensor(bank.series),
                                  qlens, torch.tensor(bank.lengths),
                                  band=band)
        np.testing.assert_array_equal(rows, _np(one).transpose(1, 0, 2))


def test_bank_extend_without_rows_and_empty_chunk():
    rng = np.random.default_rng(50)
    bank = _bank(rng, _dyadic, 8, 20, 4)
    st = tdtw.dtw_bank_init(bank.series, bank.lengths, device="cpu")
    st2, rows = tdtw.dtw_bank_extend(st, np.zeros(0, np.float32),
                                     collect_rows=True)
    assert st2 is st and tuple(rows.shape) == (0, 4, bank.series.shape[1])
    st3, none = tdtw.dtw_bank_extend(st, _dyadic(rng, 9))
    assert none is None and st3.n == 9
    with pytest.raises(ValueError, match="query_len"):
        tdtw.dtw_bank_init(bank.series, bank.lengths, band=3, device="cpu")


@pytest.mark.parametrize("band", [None, 4])
def test_hydrate_reference_state_resumes_bitwise(band):
    """A stream begun in the reference, dehydrated and continued in the
    port gives the reference's continuation rows bitwise (dyadic data);
    the port's dehydrate round-trips into the reference too."""
    rng = np.random.default_rng(60)
    bank = _bank(rng, _dyadic, 8, 30, 6)
    x = _dyadic(rng, 40)
    rst = rdtw.dtw_bank_init(bank.series, bank.lengths, band=band,
                             query_len=40)
    rst, _ = rdtw.dtw_bank_extend(rst, x[:17])
    tree = rst.dehydrate()
    st = tdtw.DtwBankState.hydrate(tree, device="cpu")
    assert (st.n, st.band, st.query_len) == (17, band, 40)
    st, rows = tdtw.dtw_bank_extend(st, x[17:], collect_rows=True)
    rst2, rrows = rdtw.dtw_bank_extend(rst, x[17:], collect_rows=True)
    np.testing.assert_array_equal(_np(rows), np.asarray(rrows))
    np.testing.assert_array_equal(_np(st.row), np.asarray(rst2.row))
    back = rdtw.DtwBankState.hydrate(st.dehydrate())
    assert back.n == 40
    np.testing.assert_array_equal(np.asarray(back.row), _np(st.row))
    for key, leaf in st.dehydrate().items():
        np.testing.assert_array_equal(leaf, rst2.dehydrate()[key])


@pytest.mark.parametrize("band", [None, 6])
def test_score_pairs_against_k2_and_reference(band):
    """K2 pairs' plain version is K2's plain version on each pair
    (bitwise, any data), and ``dtw_score_pairs`` equals the reference's
    bitwise on dyadic data and within SCORE_TOL on continuous data,
    scores and distances, ragged on both sides (lengths 1 and full)."""
    rng = np.random.default_rng(70)
    for dyadic in (True, False):
        make = _dyadic if dyadic else (
            lambda r, n: np.clip(0.5 + 0.3 * np.sin(np.linspace(
                0, r.uniform(2, 9), n)) + 0.05 * r.normal(size=n), 0, 1)
            .astype(np.float32))
        bank = _bank(rng, make, 10, 40, 6)
        xl = np.asarray([25, 1, 12, 20, 7, 25], np.int32)
        xs = np.zeros((6, 25), np.float32)
        for i, l in enumerate(xl):
            xs[i, :l] = make(rng, int(l))
        got = tdtw.dtw_score_pairs(xs, bank.series, xl, bank.lengths,
                                   band=band, return_distances=True,
                                   device="cpu")
        want = rdtw.dtw_score_pairs(xs, bank.series, xl, bank.lengths,
                                    band=band, return_distances=True)
        for g, w in zip(got, want):
            if dyadic:
                np.testing.assert_array_equal(_np(g), np.asarray(w))
            else:
                np.testing.assert_allclose(_np(g), np.asarray(w),
                                           atol=SCORE_TOL)
        folds = [tdtw.query_moments(xs[i, :xl[i]]) for i in range(6)]
        args = (torch.tensor(xs), torch.tensor(xl),
                torch.tensor(bank.series.T.copy()),
                torch.tensor(bank.lengths),
                torch.tensor([f[0] for f in folds]),
                torch.tensor([f[1] for f in folds]))
        sp, dp = tscore.score_pairs_plain(*args, band=band)
        s2, d2 = tscore.score_bank_offline_plain(*args, band=band)
        kk = torch.arange(6)
        assert torch.equal(sp, s2[kk, kk]) and torch.equal(dp, d2[kk, kk])
        assert torch.equal(sp, got[0]) and torch.equal(dp, got[1])


def test_backtrack_matches_reference_rule():
    """The port's backtrack (comparisons in place of ``np.argmin``) gives
    the reference's path: ties included (integer-valued D has many), and
    NaN cells, where argmin takes the first NaN."""
    rng = np.random.default_rng(80)
    for t in range(40):
        D = rng.integers(0, 4, (int(rng.integers(1, 12)),
                                int(rng.integers(1, 12)))).astype(np.float32)
        if t % 2:
            D[rng.random(D.shape) < 0.2] = np.nan
        np.testing.assert_array_equal(tdtw.backtrack(D), rdtw.backtrack(D))
        path = rdtw.backtrack(D)
        y = rng.random(D.shape[1]).astype(np.float32)
        np.testing.assert_array_equal(tdtw.warp_to(y, path, D.shape[0]),
                                      rdtw.warp_to(y, path, D.shape[0]))


def test_as_tensor_is_contiguous():
    """What the kernels' pointer arithmetic needs: a contiguous copy of a
    transposed array (``dtw_score_pairs`` uploads ``ys.T``)."""
    from repro_torch.kernels.common import as_tensor
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = as_tensor(a.T, torch.float32, torch.device("cpu"))
    assert t.is_contiguous() and torch.equal(t, torch.tensor(a.T.copy()))
    a[0, 0] = 99.0
    assert t[0, 0] == 0.0
    u = as_tensor(t.t(), torch.float32, torch.device("cpu"))
    assert u.is_contiguous() and torch.equal(u, t.t())


def test_matrix_path_raises_without_a_card(monkeypatch):
    """With no CUDA device the default entry points raise, and nothing
    launches."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.linspace(0, 1, 9, dtype=np.float32)
    ys = np.stack([x, x[::-1]])
    before = (tmatrix.LIB.launches, tscore.PAIRS_LAUNCHES)
    for call in (lambda: tops.dtw_batched(x, ys),
                 lambda: tdtw.dtw_matrix_bank(x, ys),
                 lambda: tdtw.dtw_score_pairs(ys, ys),
                 lambda: tdtw.dtw_bank_init(ys),
                 lambda: tdtw.DtwBankState.hydrate(
                     tdtw.dtw_bank_init(ys, device="cpu").dehydrate())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert (tmatrix.LIB.launches, tscore.PAIRS_LAUNCHES) == before
