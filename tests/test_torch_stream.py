"""The port's scored streaming tick (plain PyTorch version of kernel K1)
against the reference's three formulations of the same tick.

On dyadic-grid data every DTW cost, path sum and moment sum is exact in
f32, so the comparison is bitwise: rows, finite-cell moments and open-end
scores.  On smooth data the distances stay bitwise (each cell is the same
``min(d + min(min(diag, vert), horiz), 3e38)``), and the moments and
scores differ only by rounding; they are held to the reference's own
2e-3 warp-tie tolerance (tests/test_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dtw as rdtw
from repro.core.database import pack_series
from repro_torch.core import dtw as tdtw
from repro_torch.kernels.dtw import stream as tstream


def _dyadic_series(rng, n, denom=8, hi=9):
    return (rng.integers(0, hi, n) / float(denom)).astype(np.float32)


def _smooth_series(rng, n):
    t = np.linspace(0, 1, n, dtype=np.float32)
    return np.clip(0.5 + 0.3 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
                   + 0.05 * rng.normal(size=n), 0, 1).astype(np.float32)


def _empty_state(j, m, k):
    return (np.full((j, m, k), 3.0e38, np.float32),
            np.zeros((3, j, m, k), np.float32), np.zeros(j, np.int32),
            np.zeros(j, np.float32), np.zeros(j, np.float32))


def _port_tick(state, bank, ch, nv, qlens, band):
    return tdtw.bank_extend_tick_scored_dispatch(
        *state, torch.tensor(bank.series.T.copy()),
        torch.tensor(bank.lengths), torch.tensor(ch), torch.tensor(nv),
        torch.tensor(qlens), band=band)


def _assert_tick_equal(port_out, ref_rows, ref_moms, ref_scores):
    rp = port_out[0].numpy()
    rr = np.asarray(ref_rows)
    finite = rr < 1e37
    assert (finite == (rp < 1e37)).all()
    np.testing.assert_array_equal(rp[finite], rr[finite])
    if ref_moms is not None:
        mr = np.asarray(ref_moms)
        fin3 = np.broadcast_to(finite[None], mr.shape)
        np.testing.assert_array_equal(port_out[1].numpy()[fin3], mr[fin3])
    np.testing.assert_array_equal(port_out[5].numpy(),
                                  np.asarray(ref_scores))


@pytest.mark.parametrize("ref", ["jnp", "pallas", "rows"])
@pytest.mark.parametrize("band", [None, 6])
def test_plain_tick_bitwise_vs_reference(ref, band):
    """Four ragged ticks (per-job nvalid in [0, C], ragged bank) from the
    empty state: the port's tick equals the reference's jnp wavefront
    (``bank_extend_tick_scored``), its Pallas kernel in interpret mode
    (block_k 4 forces reference-tile padding) and, on rows, the
    row-formulation ``_bank_extend_many``."""
    rng = np.random.default_rng(11 if band is None else 17)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(12, 30)))
                        for _ in range(7)])
    k, m = bank.series.shape
    j, c = 3, 8
    qlens = np.full((j,), 4 * c, np.int32)
    bank_t = jnp.asarray(bank.series.T)
    lengths = jnp.asarray(bank.lengths)
    st_ref = tuple(jnp.asarray(a) for a in _empty_state(j, m, k))
    st_port = tdtw.tick_state_from_numpy(*_empty_state(j, m, k),
                                         device="cpu")
    rows_h = jnp.full((j, k, m), rdtw._INF)
    ns_h = jnp.zeros((j,), jnp.int32)
    for _ in range(4):
        nv = rng.integers(0, c + 1, size=j).astype(np.int32)
        ch = (rng.integers(0, 9, (j, c)) / 8.0).astype(np.float32)
        args = (bank_t, lengths, jnp.asarray(ch), jnp.asarray(nv),
                jnp.asarray(qlens))
        if ref == "pallas":
            out_ref = rdtw.bank_extend_tick_scored_dispatch(
                *st_ref, *args, band=band, use_kernel=True, interpret=True,
                block_k=4)
        else:
            out_ref = rdtw.bank_extend_tick_scored(*st_ref, *args,
                                                   band=band)
        out = _port_tick(st_port, bank, ch, nv, qlens, band)
        if ref == "rows":
            rows_h, ns_h, _ = rdtw._bank_extend_many(
                rows_h, ns_h, jnp.asarray(bank.series), lengths,
                jnp.asarray(ch), jnp.asarray(nv), jnp.asarray(qlens), band,
                False)
            _assert_tick_equal(out, np.asarray(rows_h).transpose(0, 2, 1),
                               None, out_ref[5])
        else:
            _assert_tick_equal(out, out_ref[0], out_ref[1], out_ref[5])
        for a, b in zip(out[2:5], out_ref[2:5]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        st_ref, st_port = out_ref[:5], out[:5]


@pytest.mark.parametrize("band", [None, 6])
def test_plain_tick_resumes_reference_state(band):
    """Both ticks resume from the same mid-flight state: the reference
    advances three ticks, its state crosses over through
    ``tick_state_from_numpy``, and the next two ticks agree bitwise."""
    rng = np.random.default_rng(5)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(10, 26)))
                        for _ in range(6)])
    k, m = bank.series.shape
    j, c = 4, 16
    qlens = np.full((j,), 5 * c, np.int32)
    st = tuple(jnp.asarray(a) for a in _empty_state(j, m, k))

    def ref_tick(state):
        nv = rng.integers(0, c + 1, size=j).astype(np.int32)
        ch = (rng.integers(0, 9, (j, c)) / 8.0).astype(np.float32)
        return ch, nv, rdtw.bank_extend_tick_scored(
            *state, jnp.asarray(bank.series.T), jnp.asarray(bank.lengths),
            jnp.asarray(ch), jnp.asarray(nv), jnp.asarray(qlens), band=band)

    for _ in range(3):
        st = ref_tick(st)[2][:5]
    port = tdtw.tick_state_from_numpy(*[np.asarray(a) for a in st],
                                      device="cpu")
    for _ in range(2):
        ch, nv, out_ref = ref_tick(st)
        out = _port_tick(port, bank, ch, nv, qlens, band)
        _assert_tick_equal(out, out_ref[0], out_ref[1], out_ref[5])
        st, port = out_ref[:5], out[:5]


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_plain_tick_smooth_data_tolerance(ref):
    """Smooth real-valued data: distances bitwise, scores within the
    reference's 2e-3 warp-tie tolerance."""
    rng = np.random.default_rng(3)
    bank = pack_series([_smooth_series(rng, int(rng.integers(16, 40)))
                        for _ in range(5)])
    k, m = bank.series.shape
    j, c = 2, 8
    qlens = np.full((j,), 4 * c, np.int32)
    st_ref = tuple(jnp.asarray(a) for a in _empty_state(j, m, k))
    st_port = tdtw.tick_state_from_numpy(*_empty_state(j, m, k),
                                         device="cpu")
    for _ in range(4):
        ch = np.stack([_smooth_series(rng, c) for _ in range(j)])
        nv = np.full((j,), c, np.int32)
        args = (jnp.asarray(bank.series.T), jnp.asarray(bank.lengths),
                jnp.asarray(ch), jnp.asarray(nv), jnp.asarray(qlens))
        if ref == "pallas":
            out_ref = rdtw.bank_extend_tick_scored_dispatch(
                *st_ref, *args, use_kernel=True, interpret=True)
        else:
            out_ref = rdtw.bank_extend_tick_scored(*st_ref, *args)
        out = _port_tick(st_port, bank, ch, nv, qlens, None)
        if ref == "jnp":
            np.testing.assert_array_equal(out[0].numpy(),
                                          np.asarray(out_ref[0]))
        np.testing.assert_allclose(out[5].numpy(), np.asarray(out_ref[5]),
                                   atol=2e-3)
        st_ref, st_port = out_ref[:5], out[:5]


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the K1 wrapper runs the plain version and counts no
    kernel launch; the dispatch equals the plain tick bitwise."""
    rng = np.random.default_rng(0)
    bank = pack_series([_smooth_series(rng, 20) for _ in range(3)])
    k, m = bank.series.shape
    state = tdtw.tick_state_from_numpy(*_empty_state(2, m, k), device="cpu")
    args = (torch.tensor(bank.series.T.copy()), torch.tensor(bank.lengths),
            torch.tensor(np.stack([_smooth_series(rng, 8)] * 2)),
            torch.tensor([8, 5], dtype=torch.int32),
            torch.tensor([16, 16], dtype=torch.int32))
    before = tstream.LIB.launches
    a = tdtw.bank_extend_tick_scored_dispatch(*state, *args, band=4)
    b = tdtw.bank_extend_tick_scored(*state, *args, band=4)
    assert tstream.LIB.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
