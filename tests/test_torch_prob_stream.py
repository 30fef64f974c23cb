"""The port's probabilistic streaming ticks (plain PyTorch version of
kernel K4, six channels exact and four approx) against the reference's
jnp wavefront and its Pallas kernel in interpret mode.

On dyadic-grid data with dyadic variances (k / 64) every DTW cost, path
sum and moment product is exact in f32, so rows, all moment channels,
scores and the (sv, svx, svxx) folds are compared bitwise.  The match
probabilities are not bitwise across implementations: the delta-method
variance ``var_r`` is a sum of terms of both signs, so one rounding
difference in a term (XLA may contract its products into fused
multiply-adds, the port rounds each product) moves sigma by a few ulps
times the cancellation, and the erfc implementations differ in the last
bits.  They are held to PROB_TOL = 2e-6 absolute (observed <= 1.2e-6).
At zero variance sigma is exactly 0 and they are bitwise the point rule.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dtw as rdtw
from repro.core.database import pack_series
from repro_torch.core import dtw as tdtw
from repro_torch.kernels.dtw import stream as tstream

#: Probability tolerance against the reference (see the module doc).
PROB_TOL = 2e-6
THR = 0.85


def _dyadic_series(rng, n):
    return (rng.integers(0, 9, n) / 8.0).astype(np.float32)


def _dyadic_vars(rng, shape):
    return (rng.integers(0, 5, shape) / 64.0).astype(np.float32)


def _smooth_series(rng, n):
    t = np.linspace(0, 1, n, dtype=np.float32)
    return np.clip(0.5 + 0.3 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
                   + 0.05 * rng.normal(size=n), 0, 1).astype(np.float32)


def _empty(j, m, k, nch):
    return (np.full((j, m, k), 3.0e38, np.float32),
            np.zeros((nch, j, m, k), np.float32), np.zeros(j, np.int32),
            np.zeros(j, np.float32), np.zeros(j, np.float32),
            np.zeros((j, 3), np.float32))


def _ref_tick(nch, pallas, state, bank, ch, vch, nv, qlens, band):
    args = (*state, jnp.asarray(bank.series.T), jnp.asarray(bank.lengths),
            jnp.asarray(ch), jnp.asarray(vch), jnp.asarray(nv),
            jnp.asarray(qlens))
    if nch == 6:
        return rdtw.bank_extend_tick_scored_var_dispatch(
            *args, band=band, threshold=THR, use_kernel=pallas,
            interpret=True if pallas else None, block_k=4)
    return rdtw.bank_extend_tick_scored_var_approx_dispatch(
        *args, band=band, threshold=THR, use_kernel=pallas,
        interpret=True if pallas else None, block_k=4)


def _port_tick(nch, state, bank, ch, vch, nv, qlens, band):
    fn = tdtw.bank_extend_tick_scored_var_dispatch if nch == 6 \
        else tdtw.bank_extend_tick_scored_var_approx_dispatch
    return fn(*state, torch.tensor(bank.series.T.copy()),
              torch.tensor(bank.lengths), torch.tensor(ch),
              torch.tensor(vch), torch.tensor(nv), torch.tensor(qlens),
              band=band, threshold=THR)


def _port_state(state):
    a = [np.asarray(x) for x in state]
    return tdtw.tick_state_from_numpy(*a[:5], device="cpu", vstats=a[5])


def _next_state(out):
    return tuple(out[:5]) + (out[6],)


def _assert_tick(out, ref, prob_tol):
    rr = np.asarray(ref[0])
    finite = rr < 1e37
    rp = out[0].numpy()
    assert (finite == (rp < 1e37)).all()
    np.testing.assert_array_equal(rp[finite], rr[finite])
    mr = np.asarray(ref[1])
    fin = np.broadcast_to(finite[None], mr.shape)
    np.testing.assert_array_equal(out[1].numpy()[fin], mr[fin])
    for i in (2, 3, 4, 5, 6):            # ns, sx, sxx, scores, vstats
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_allclose(out[7].numpy(), np.asarray(ref[7]),
                               rtol=0, atol=prob_tol)


@pytest.mark.parametrize("nch", [6, 4])
@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("band,c", [(None, 8), (6, 8), (None, 16), (6, 32)])
def test_var_tick_bitwise_vs_reference(nch, ref, band, c):
    """Four ragged ticks (per-job nvalid in [0, C], ragged bank, block_k
    4 forcing reference-tile padding in the Pallas kernel) from the empty
    state, in the tick layout [NCH, S, M, K] on both sides.  C = 32 is a
    chunk the kernel takes in two passes (16 rows a pass)."""
    seed = {None: 23, 6: 29}[band] + 100 * nch + c
    rng = np.random.default_rng(seed)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(12, 30)))
                        for _ in range(7)])
    k, m = bank.series.shape
    j = 3
    qlens = np.full((j,), 4 * c, np.int32)
    st_ref = tuple(jnp.asarray(a) for a in _empty(j, m, k, nch))
    st_port = _port_state(st_ref)
    for _ in range(4):
        nv = rng.integers(0, c + 1, size=j).astype(np.int32)
        ch = (rng.integers(0, 9, (j, c)) / 8.0).astype(np.float32)
        vch = _dyadic_vars(rng, (j, c))
        out_ref = _ref_tick(nch, ref == "pallas", st_ref, bank, ch, vch, nv,
                            qlens, band)
        out = _port_tick(nch, st_port, bank, ch, vch, nv, qlens, band)
        _assert_tick(out, out_ref, PROB_TOL)
        st_ref, st_port = _next_state(out_ref), _next_state(out)


@pytest.mark.parametrize("nch", [6, 4])
def test_var_tick_resumes_reference_state(nch):
    """The reference advances three ticks; its state, variance folds
    included, crosses over through ``tick_state_from_numpy`` and the next
    two ticks agree bitwise."""
    rng = np.random.default_rng(5 + nch)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(10, 26)))
                        for _ in range(6)])
    k, m = bank.series.shape
    j, c = 4, 16
    qlens = np.full((j,), 5 * c, np.int32)
    st = tuple(jnp.asarray(a) for a in _empty(j, m, k, nch))

    def draw():
        return (rng.integers(0, 9, (j, c)) / 8.0).astype(np.float32), \
            _dyadic_vars(rng, (j, c)), \
            rng.integers(0, c + 1, size=j).astype(np.int32)

    for _ in range(3):
        ch, vch, nv = draw()
        st = _next_state(_ref_tick(nch, False, st, bank, ch, vch, nv, qlens,
                                   6))
    port = _port_state(st)
    for _ in range(2):
        ch, vch, nv = draw()
        out_ref = _ref_tick(nch, False, st, bank, ch, vch, nv, qlens, 6)
        out = _port_tick(nch, port, bank, ch, vch, nv, qlens, 6)
        _assert_tick(out, out_ref, PROB_TOL)
        st, port = _next_state(out_ref), _next_state(out)


@pytest.mark.parametrize("nch", [6, 4])
def test_var_tick_zero_variance_reduces_bitwise(nch):
    """Zero variances: rows, the point channels and scores equal the
    port's point tick (K1's plain version) bitwise, the variance folds
    stay 0, and every probability is exactly 1{score >= threshold} —
    the same probabilities for both channel counts and the reference."""
    rng = np.random.default_rng(31)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(12, 30)))
                        for _ in range(7)])
    k, m = bank.series.shape
    j, c = 3, 8
    qlens = np.full((j,), 4 * c, np.int32)
    zero = _empty(j, m, k, nch)
    st_v = _port_state(zero)
    st_e = tdtw.tick_state_from_numpy(*_empty(j, m, k, 3)[:5],
                                      device="cpu")
    st_r = tuple(jnp.asarray(a) for a in zero)
    bank_t = torch.tensor(bank.series.T.copy())
    lengths = torch.tensor(bank.lengths)
    for _ in range(4):
        nv = rng.integers(0, c + 1, size=j).astype(np.int32)
        ch = (rng.integers(0, 9, (j, c)) / 8.0).astype(np.float32)
        vch = np.zeros((j, c), np.float32)
        out = _port_tick(nch, st_v, bank, ch, vch, nv, qlens, 6)
        pt = tdtw.bank_extend_tick_scored(
            *st_e, bank_t, lengths, torch.tensor(ch), torch.tensor(nv),
            torch.tensor(qlens), band=6)
        ref = _ref_tick(nch, False, st_r, bank, ch, vch, nv, qlens, 6)
        assert torch.equal(out[0], pt[0])
        assert torch.equal(out[1][:3], pt[1])
        assert torch.equal(out[5], pt[5])
        assert float(out[6].abs().max()) == 0.0
        pr = out[7].numpy()
        assert set(np.unique(pr)) <= {0.0, 1.0}
        np.testing.assert_array_equal(pr == 1.0, pt[5].numpy() >= THR)
        np.testing.assert_array_equal(pr, np.asarray(ref[7]))
        st_v, st_e, st_r = _next_state(out), pt[:5], _next_state(ref)


@pytest.mark.parametrize("nch", [6, 4])
def test_var_tick_chunking_invariance(nch):
    """Any chunking of one stream reproduces the one-shot solve bitwise
    (rows, every channel, folds, scores, probabilities), and the one-shot
    solve matches the reference's within PROB_TOL."""
    rng = np.random.default_rng(47 + nch)
    bank = pack_series([_dyadic_series(rng, int(rng.integers(12, 30)))
                        for _ in range(5)])
    k, m = bank.series.shape
    n = 24
    q = _dyadic_series(rng, n)
    v = _dyadic_vars(rng, n)

    def run(sizes):
        st = _port_state(_empty(1, m, k, nch))
        lo = 0
        for c in sizes:
            out = _port_tick(nch, st, bank, q[None, lo:lo + c],
                             v[None, lo:lo + c],
                             np.asarray([c], np.int32),
                             np.asarray([n], np.int32), 4)
            st = _next_state(out)
            lo += c
        return out

    whole = run([n])
    ref = _ref_tick(nch, False,
                    tuple(jnp.asarray(a) for a in _empty(1, m, k, nch)),
                    bank, q[None], v[None], np.asarray([n], np.int32),
                    np.asarray([n], np.int32), 4)
    _assert_tick(whole, ref, PROB_TOL)
    for sizes in ([1] * n, [5, 5, 5, 5, 4], [7, 17], [16, 8]):
        got = run(sizes)
        for a, b in zip(got, whole):
            assert torch.equal(a, b), sizes


@pytest.mark.parametrize("nch", [6, 4])
def test_var_tick_smooth_data_tolerance(nch):
    """Smooth data and continuous variances: rows bitwise against the
    jnp wavefront, scores within the reference's 2e-3 warp-tie tolerance
    (tests/test_kernels.py), probabilities within 5e-3 (the same moment
    rounding seen through the probability tail's slope), folds within
    f32 summation-order rounding."""
    rng = np.random.default_rng(3 + nch)
    bank = pack_series([_smooth_series(rng, int(rng.integers(16, 40)))
                        for _ in range(5)])
    k, m = bank.series.shape
    j, c = 2, 8
    qlens = np.full((j,), 4 * c, np.int32)
    st_ref = tuple(jnp.asarray(a) for a in _empty(j, m, k, nch))
    st_port = _port_state(st_ref)
    for _ in range(4):
        ch = np.stack([_smooth_series(rng, c) for _ in range(j)])
        vch = (0.01 * rng.random((j, c))).astype(np.float32)
        nv = np.full((j,), c, np.int32)
        out_ref = _ref_tick(nch, False, st_ref, bank, ch, vch, nv, qlens,
                            None)
        out = _port_tick(nch, st_port, bank, ch, vch, nv, qlens, None)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(out_ref[0]))
        np.testing.assert_allclose(out[5].numpy(), np.asarray(out_ref[5]),
                                   atol=2e-3)
        np.testing.assert_allclose(out[7].numpy(), np.asarray(out_ref[7]),
                                   atol=5e-3)
        np.testing.assert_allclose(out[6].numpy(), np.asarray(out_ref[6]),
                                   rtol=1e-6, atol=1e-7)
        st_ref, st_port = _next_state(out_ref), _next_state(out)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the K4 wrapper runs the plain version for both
    channel counts and counts no kernel launch; a slab of another width
    is refused."""
    rng = np.random.default_rng(0)
    bank = pack_series([_smooth_series(rng, 20) for _ in range(3)])
    k, m = bank.series.shape
    before = dict(tstream.VAR_LAUNCHES), tstream.LIB.launches
    ch = np.stack([_smooth_series(rng, 8)] * 2)
    vch = (0.01 * rng.random((2, 8))).astype(np.float32)
    for nch in (6, 4):
        st = _port_state(_empty(2, m, k, nch))
        args = (st[0], st[1], st[2], torch.tensor(bank.series.T.copy()),
                torch.tensor(bank.lengths), torch.tensor(ch),
                torch.tensor(vch), torch.tensor([8, 5], dtype=torch.int32),
                torch.tensor([16, 16], dtype=torch.int32))
        a = tstream.stream_bank_extend_scored_var(*args, band=4)
        b = tstream.stream_bank_extend_scored_var_plain(*args, band=4)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (dict(tstream.VAR_LAUNCHES), tstream.LIB.launches) == before
    with pytest.raises(ValueError, match="channels"):
        tstream.stream_bank_extend_scored_var(
            st[0], torch.zeros((3,) + tuple(st[0].shape)), *args[2:])
