"""The port's distance-only tick (plain PyTorch version of kernel K3)
against the reference's.

The reference computes the tick two ways: its jnp wavefront
(``core.dtw.bank_extend_tick``, the anti-diagonal formulation the port's
plain version shares cell for cell) and its Pallas kernel
(``kernels.dtw.stream_bank_extend_kernel``, run in interpret mode), which
solves each row with a min-plus scan, summing in another order.  On
dyadic-grid data every sum is exact in f32, so all three agree bitwise.
On random data the port stays bitwise with the jnp wavefront (the same
operations in the same order) and within the reference's own 1e-4 of
the Pallas kernel (tests/test_kernels.py).  The distance tick's rows are
also bitwise the scored tick's: every tick flavour updates the rows
identically."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dtw as rdtw
from repro.core.database import pack_series
from repro.kernels.dtw import stream_bank_extend_kernel
from repro_torch.core import dtw as tdtw
from repro_torch.kernels.dtw import stream as tstream

#: The reference's tolerance between its Pallas kernel's min-plus scan
#: and its row formulation on random data (tests/test_kernels.py).
PALLAS_TOL = 1e-4


def _series(rng, n, dyadic):
    if dyadic:
        return (rng.integers(0, 9, n) / 8.0).astype(np.float32)
    return rng.random(n).astype(np.float32)


def _setup(seed, dyadic, k=7, j=3, c=8):
    rng = np.random.default_rng(seed)
    bank = pack_series([_series(rng, int(rng.integers(12, 30)), dyadic)
                        for _ in range(k)])
    return rng, bank, j, c


def _chunk(rng, j, c, dyadic):
    nv = rng.integers(0, c + 1, size=j).astype(np.int32)
    ch = np.stack([_series(rng, c, dyadic) for _ in range(j)])
    return ch, nv


def _assert_rows(port, ref, tol):
    rp, rr = port.numpy(), np.asarray(ref)
    finite = rr < 1e37
    assert (finite == (rp < 1e37)).all()
    if tol == 0.0:
        np.testing.assert_array_equal(rp[finite], rr[finite])
    else:
        np.testing.assert_allclose(rp[finite], rr[finite], rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("band", [None, 6])
def test_distance_tick_vs_reference_wavefront(dyadic, band):
    """Four ragged ticks (per-job nvalid in [0, C], ragged bank): the
    port's ``bank_extend_tick`` equals the reference's, rows and ns,
    bitwise on dyadic and on random data."""
    rng, bank, j, c = _setup(3 if band is None else 9, dyadic)
    k, m = bank.series.shape
    qlens = np.full((j,), 4 * c, np.int32)
    rows_r = jnp.full((j, m, k), rdtw._INF)
    ns_r = jnp.zeros((j,), jnp.int32)
    rows_p = torch.full((j, m, k), tdtw._INF)
    ns_p = torch.zeros(j, dtype=torch.int32)
    bank_t = torch.tensor(bank.series.T.copy())
    lengths = torch.tensor(bank.lengths)
    for _ in range(4):
        ch, nv = _chunk(rng, j, c, dyadic)
        rows_r, ns_r = rdtw.bank_extend_tick(
            rows_r, ns_r, jnp.asarray(bank.series.T),
            jnp.asarray(bank.lengths), jnp.asarray(ch), jnp.asarray(nv),
            jnp.asarray(qlens), band=band)
        rows_p, ns_p = tdtw.bank_extend_tick_dispatch(
            rows_p, ns_p, bank_t, lengths, torch.tensor(ch),
            torch.tensor(nv), torch.tensor(qlens), band=band)
        _assert_rows(rows_p, rows_r, 0.0)
        np.testing.assert_array_equal(ns_p.numpy(), np.asarray(ns_r))


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("band,block_k", [(None, 128), (6, 128), (None, 4),
                                          (6, 4)])
def test_distance_tick_vs_reference_pallas_kernel(dyadic, band, block_k):
    """The plain K3 version against the reference's Pallas kernel in
    interpret mode (block_k 4 forces reference-tile padding): bitwise on
    dyadic data, PALLAS_TOL on random data."""
    rng, bank, j, c = _setup(0 if band is None else band + block_k, dyadic)
    k, m = bank.series.shape
    qlens = np.full((j,), 4 * c, np.int32)
    rows_k = jnp.full((j, k, m), rdtw._INF)
    ns_k = jnp.zeros((j,), jnp.int32)
    rows_p = torch.full((j, m, k), tdtw._INF)
    ns_p = torch.zeros(j, dtype=torch.int32)
    bank_t = torch.tensor(bank.series.T.copy())
    lengths = torch.tensor(bank.lengths)
    for _ in range(4):
        ch, nv = _chunk(rng, j, c, dyadic)
        rows_k, ns_k = stream_bank_extend_kernel(
            rows_k, ns_k, bank.series, bank.lengths, ch, nv, qlens,
            band=band, block_k=block_k, interpret=True)
        rows_p = tstream.stream_bank_extend_plain(
            rows_p, ns_p, bank_t, lengths, torch.tensor(ch),
            torch.tensor(nv), torch.tensor(qlens), band)
        ns_p = ns_p + torch.tensor(nv)
        _assert_rows(rows_p, np.asarray(rows_k).transpose(0, 2, 1),
                     0.0 if dyadic else PALLAS_TOL)
        np.testing.assert_array_equal(ns_p.numpy(), np.asarray(ns_k))


@pytest.mark.parametrize("band", [None, 6])
@pytest.mark.parametrize("nch", [3, 6, 4])
def test_distance_rows_bitwise_scored_rows(band, nch):
    """The distance tick's rows are bitwise the scored ticks' rows (K1's
    three channels, K4's six and four) on the same random inputs, resumed
    across ticks."""
    rng, bank, j, c = _setup(21 + nch, False)
    k, m = bank.series.shape
    qlens = torch.full((j,), 3 * c, dtype=torch.int32)
    bank_t = torch.tensor(bank.series.T.copy())
    lengths = torch.tensor(bank.lengths)
    rows_d = torch.full((j, m, k), tdtw._INF)
    ns_d = torch.zeros(j, dtype=torch.int32)
    state = tdtw.tick_state_from_numpy(
        np.full((j, m, k), 3.0e38, np.float32),
        np.zeros((nch, j, m, k), np.float32), np.zeros(j, np.int32),
        np.zeros(j, np.float32), np.zeros(j, np.float32), device="cpu",
        vstats=None if nch == 3 else np.zeros((j, 3), np.float32))
    for _ in range(3):
        ch, nv = _chunk(rng, j, c, False)
        args = (bank_t, lengths, torch.tensor(ch))
        tail = (torch.tensor(nv), qlens)
        rows_d, ns_d = tdtw.bank_extend_tick(rows_d, ns_d, *args, *tail,
                                             band=band)
        if nch == 3:
            out = tdtw.bank_extend_tick_scored(*state, *args, *tail,
                                               band=band)
            state = out[:5]
        else:
            fn = tdtw.bank_extend_tick_scored_var if nch == 6 \
                else tdtw.bank_extend_tick_scored_var_approx
            vch = torch.tensor(0.01 * rng.random((j, c)), dtype=torch.float32)
            out = fn(*state, *args, vch, *tail, band=band)
            state = out[:5] + (out[6],)
        assert torch.equal(rows_d, out[0])
        assert torch.equal(ns_d, out[2])


def test_k3_wrapper_cpu_route():
    """CPU tensors take the plain version without counting a launch, and
    a slot with no valid sample keeps its row."""
    rng, bank, j, c = _setup(5, True)
    k, m = bank.series.shape
    rows = torch.full((j, m, k), tdtw._INF)
    ns = torch.zeros(j, dtype=torch.int32)
    ch, nv = _chunk(rng, j, c, True)
    before = tstream.DIST_LAUNCHES
    out = tstream.stream_bank_extend(
        rows, ns, torch.tensor(bank.series.T.copy()),
        torch.tensor(bank.lengths), torch.tensor(ch), torch.tensor(nv),
        torch.full((j,), 32, dtype=torch.int32))
    assert tstream.DIST_LAUNCHES == before
    assert out.shape == rows.shape and out.dtype == torch.float32
    # slots with nvalid == 0 pass their row through unchanged
    for s in np.flatnonzero(nv == 0):
        assert torch.equal(out[s], rows[s])
