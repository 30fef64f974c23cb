"""The port's batched IIR filter — K8's plain version through
``repro_torch.kernels.iir.lfilter_batched`` — against the reference's
``repro.kernels.iir.lfilter_batched`` (its Pallas kernel in interpret
mode) on the same numpy-seeded inputs.

Tolerance: bitwise.  The plain version fuses exactly the two steps that
the reference's compiled recurrence fuses (``b0 x + z0`` and
``b x - a y``), so the two filter alike even where the order-6 filter's
float32 ill-conditioning would turn one rounding into ~1e-3.
"""

import numpy as np
import pytest
import torch

from repro.core.filters import cheby1_design
from repro.kernels import iir as riir
from repro_torch.core import filters as tfilters
from repro_torch.kernels import iir as tiir
from repro_torch.kernels.iir import kernel as tkernel

#: tests/test_kernels.py's three IIR shapes, and the paper's order-6
#: filter over more series than one TPU lane tile (130 > 128).
SHAPES = [(6, 0.125, 3, 100), (4, 0.3, 130, 64), (2, 0.5, 1, 257),
          (6, 0.125, 130, 512)]


def _x(bsz, t):
    return np.random.default_rng(bsz * t).normal(size=(bsz, t)) \
        .astype(np.float32)


@pytest.mark.parametrize("order,cutoff,bsz,t", SHAPES)
def test_lfilter_batched_bitwise_reference(order, cutoff, bsz, t):
    """The port's entry point on the CPU against the reference's Pallas
    K8 in interpret mode: bitwise; both within the reference's 5e-3 of
    the float64 oracle."""
    b, a = cheby1_design(order, 1.0, cutoff)
    x = _x(bsz, t)
    want = np.asarray(riir.lfilter_batched(b, a, x))
    before = tkernel.LIB.launches
    got = tiir.lfilter_batched(b, a, x, device="cpu")
    assert tkernel.LIB.launches == before      # the plain version ran
    assert got.dtype == torch.float32 and got.shape == (bsz, t)
    assert np.array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), riir.lfilter_ref(b, a, x),
                               atol=5e-3)


@pytest.mark.parametrize("order,cutoff,bsz,t", SHAPES)
def test_oracle_copy_bitwise(order, cutoff, bsz, t):
    b, a = cheby1_design(order, 1.0, cutoff)
    x = _x(bsz, t)[:, :min(t, 128)]
    assert np.array_equal(tiir.lfilter_ref(b, a, x),
                          riir.lfilter_ref(b, a, x))


def _utilization(bsz, t, seed):
    """Utilization-like series in [0, 1]: a per-series level, square-ish
    map/reduce waves of random period, sampling noise (the recipe of
    chip_smoke.py's full-width K8 input)."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t, dtype=np.float32)[None, :]
    level = rng.uniform(0.2, 0.7, (bsz, 1)).astype(np.float32)
    period = rng.uniform(120, 900, (bsz, 1)).astype(np.float32)
    wave = np.sign(np.sin(2 * np.pi * tt / period)).astype(np.float32)
    return np.clip(level + 0.2 * wave + 0.08 * rng.standard_normal(
        (bsz, t), dtype=np.float32), 0, 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_hour_long_series_bitwise_reference(seed):
    """64 series of 3600 samples (an hour at 1 Hz, the full-width
    de-noise's length), the paper's order-6 filter: the port bitwise the
    reference's interpret-mode Pallas K8.  Over this length both drift
    from the float64 oracle beyond the reference's 5e-3 (set on series of
    64 to 512 samples) but stay within 1e-2, the tolerance chip_smoke.py
    holds K8 to against the oracle at full width."""
    b, a = cheby1_design(6, 1.0, 0.125)
    x = _utilization(64, 3600, seed)
    want = np.asarray(riir.lfilter_batched(b, a, x))
    got = tiir.lfilter_batched(b, a, x, device="cpu").numpy()
    assert np.array_equal(got, want)
    drift = float(np.abs(want - riir.lfilter_ref(b, a, x)).max())
    assert 5e-3 < drift <= 1e-2, drift


def test_unnormalised_coefficients():
    """(b, a) with a[0] != 1 are normalised in float64 first, as the
    reference does."""
    b, a = cheby1_design(4, 1.0, 0.3)
    b, a = 2.5 * b, 2.5 * a
    x = _x(5, 80)
    assert np.array_equal(tiir.lfilter_batched(b, a, x, device="cpu").numpy(),
                          np.asarray(riir.lfilter_batched(b, a, x)))


def test_host_filter_shares_the_plain_version():
    """``core.filters.lfilter`` (the host filter of the service and the
    matching phase) is K8's plain version: bitwise the entry point."""
    b, a = cheby1_design(6, 1.0, 0.125)
    x = _x(7, 300)
    assert torch.equal(tfilters.lfilter(b, a, x),
                       tiir.lfilter_batched(b, a, x, device="cpu"))


@pytest.mark.parametrize("b,a,x", [
    (np.ones(1), np.ones(1), np.zeros((2, 8), np.float32)),      # order 0
    (np.ones(3), np.ones(3), np.zeros(8, np.float32)),           # 1-D x
    (np.ones(3), np.ones(4), np.zeros((2, 8), np.float32)),      # b vs a
])
def test_rejects_what_the_kernel_does_not_take(b, a, x):
    with pytest.raises(ValueError):
        tiir.lfilter_batched(b, a, x, device="cpu")


def test_cuda_default_raises_without_a_card(monkeypatch):
    """With no CUDA device the default entry point raises; it never falls
    back to the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b, a = cheby1_design(6, 1.0, 0.125)
    before = tkernel.LIB.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        tiir.lfilter_batched(b, a, _x(2, 16))
    assert tkernel.LIB.launches == before
