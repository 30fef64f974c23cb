"""K2, K5 and K6: the offline verdict scorers — CUDA kernels, their
wrappers and their plain PyTorch versions, with the score tails they
share.

J complete queries are scored against the whole reference bank at the
closed alignment endpoint ``(xlen - 1, len_k - 1)``: the moment-carrying
DP runs from a fresh row over each query and the endpoint moments go
through a score tail.

* K2 (``repro/kernels/dtw/score.py::_score_kernel`` on the TPU): three
  point channels and :func:`corr_from_moments` -> ``[J, K]`` scores and
  endpoint distances.
* K2 pairs: K2 for P (query, reference) pairs, query p against
  reference p (:func:`score_pairs`, the engine of
  ``core.similarity.match_application``); bitwise K2 for the same pair.
* K5 and K6 (``_score_var_kernel``, exact and ``approx=True``): each
  query sample carries a measurement variance, the DP carries 6 (exact)
  or 4 (approx) channels, and :func:`prob_from_moments` or
  :func:`prob_from_moments_approx` turns the endpoint moments and the
  query's variance folds into match probabilities beside the scores.

:func:`score_bank_offline` and :func:`score_bank_offline_var` are the
wrappers: CUDA tensors launch ``csrc/score.cu`` (or raise), CPU tensors
take the plain versions, which are the streaming ticks' plain versions
run over the whole query from the empty state (``ns = 0``, band centres
from ``xlen``) and read at column ``len_k - 1``: the same per-cell
arithmetic as the kernels, so the DP agrees bitwise.  ``LIB.launches``
counts K2's launches, ``PAIRS_LAUNCHES`` K2 pairs' and
``VAR_LAUNCHES[nch]`` K5's (6) and K6's (4).

The tails are the reference's (``repro.core.dtw._corr_from_moments``,
``_prob_from_moments``, ``_prob_from_moments_approx``) with the same
operations in the same order as the kernels' ``csrc/prob_tail.cuh``.
Square roots go through float64 (PyTorch's float32 ``sqrt`` on the CPU
is not always correctly rounded; the float64 root rounded to float32
is), as does ``erfc`` (PyTorch's float32 ``erfc`` on the CPU is off by up
to ~1.5e-6), and no division is by a host scalar (on CUDA tensors
PyTorch turns that into a multiplication by the reciprocal).  ``erfc``
still differs from the kernel's ``erfcf`` and from ``jax.lax.erfc`` in
the last bits, so probabilities are compared to a tolerance, except at
zero variance, where sigma is exactly 0 and the probability is the point
rule.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..common import (KernelLib, check_kernel_device, check_launch,
                      check_tensor)
from .stream import (INF, _CSRC, stream_bank_extend_scored_plain,
                     stream_bank_extend_scored_var_plain)

__all__ = ["corr_from_moments", "prob_from_moments",
           "prob_from_moments_approx", "score_bank_offline",
           "score_bank_offline_plain", "score_bank_offline_var",
           "score_bank_offline_var_plain", "score_pairs",
           "score_pairs_plain", "LIB", "VAR_LAUNCHES", "PAIRS_LAUNCHES"]

#: Lanes of the kernels' warp wavefront: a panel spans 32 strips.
_LANES = 32

#: sqrt(2) rounded to float32, as ``jnp.sqrt(jnp.float32(2.0))`` gives it.
_SQRT2 = float(np.sqrt(np.float32(2.0)))

_P = ctypes.c_void_p
_I = ctypes.c_int

LIB = KernelLib(
    "dtw_score", os.path.join(_CSRC, "score.cu"),
    headers=(os.path.join(_CSRC, "dtw_sweep.cuh"),
             os.path.join(_CSRC, "prob_tail.cuh")),
    signatures={
        "dtw_score_strip": ([_I], ctypes.c_int),
        "dtw_score_offline": ([_P] * 9 + [_I] * 4 + [_P], ctypes.c_int),
        "dtw_score_offline_var": ([_P] * 12 + [_I] * 4 + [ctypes.c_float]
                                  + [_I, _P], ctypes.c_int),
        "dtw_score_pairs": ([_P] * 9 + [_I] * 3 + [_P], ctypes.c_int)})

#: K2 pairs launches (:func:`score_pairs`).  The wrapper adds one per
#: launch; a caller resets it to 0 before a run it audits.
PAIRS_LAUNCHES = 0

#: K5 (6 channels, the exact tail) and K6 (4 channels, the approx tail)
#: launches.  The wrapper adds one per launch; a caller resets them to 0
#: before a run it audits.
VAR_LAUNCHES = {6: 0, 4: 0}


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: PyTorch's float32 sqrt on
    the CPU is not always correctly rounded; float64 then float32 is (the
    IEEE result of the kernels' __fsqrt_rn and of the reference)."""
    return torch.sqrt(t.double()).float()


def corr_from_moments(sy, syy, sxy, sx, sxx, n):
    """Warp correlation from (centred) moment sums, elementwise over
    broadcast-compatible tensors — repro's ``_corr_from_moments``, the one
    score tail of the tick, the verdict and both kernels.  Degeneracy is
    judged relative to the cancellation scale: a variance within ~1e-5 of
    it is rounding noise, and the score is then 1.0 for an identical
    constant pair, else 0.0."""
    vx = torch.clamp_min(sxx - sx * sx / n, 0.0)
    vy = torch.clamp_min(syy - sy * sy / n, 0.0)
    cov = sxy - sx * sy / n
    denom = _sqrt(vx * vy)
    corr = torch.clamp(cov / torch.where(denom > 0, denom, 1.0), -1.0, 1.0)
    degx = vx <= 1e-5 * (sxx + sx * sx / n) + 1e-12
    degy = vy <= 1e-5 * (syy + sy * sy / n) + 1e-12
    both = degx & degy & ((sx - sy).abs() / n < 1e-6)
    return torch.where(degx | degy, torch.where(both, 1.0, 0.0), corr)


def _tail_core(sy, syy, sxy, sx, sxx, sv, n):
    """What both probability tails share (``TailCore`` in
    ``csrc/prob_tail.cuh``): the point correlation r, vx, vy, the
    covariance, safe_vx, the disattenuated r_hat and the delta-method
    derivatives a = dr/dsx, b = dr/dsxx, c = dr/dsxy."""
    r = corr_from_moments(sy, syy, sxy, sx, sxx, n)
    vx = torch.clamp_min(sxx - sx * sx / n, 0.0)
    vy = torch.clamp_min(syy - sy * sy / n, 0.0)
    cov = sxy - sx * sy / n
    denom = _sqrt(vx * vy)
    safe_vx = torch.where(vx > 0, vx, 1.0)
    # disattenuation: E[vx_obs] = vx_true + sv, cov unbiased.
    den = torch.minimum(torch.maximum(vx - sv, vx * 0.25), vx)
    g = torch.where(den > 0, _sqrt(vx / torch.where(den > 0, den, 1.0)),
                    1.0)
    r_hat = torch.clamp(r * g, -1.0, 1.0)
    c = torch.ones_like(denom) / torch.where(denom > 0, denom, 1.0)
    a = -c * sy / n + r * sx / (n * safe_vx)
    b = -r / (2.0 * safe_vx)
    return r, vx, vy, cov, safe_vx, r_hat, a, b, c


def _tail_prob(r_hat, a, b, c, sv, svx, svxx, svy, svxy, svyy, threshold):
    """Delta-method variance of r -> P[true correlation >= threshold];
    exactly the point rule ``r_hat >= threshold`` where sigma is 0."""
    var_r = (a * a * sv + 4.0 * a * b * svx + 4.0 * b * b * svxx
             + 2.0 * a * c * svy + 4.0 * b * c * svxy + c * c * svyy)
    sigma = _sqrt(torch.clamp_min(var_r, 0.0))
    thr = torch.tensor(threshold, dtype=torch.float32, device=r_hat.device)
    z = (r_hat - thr) / torch.where(sigma > 0, sigma, 1.0)
    # PyTorch's float32 erfc on the CPU is off by up to ~1.5e-6; the
    # float64 erfc rounded to float32 is within an ulp of the true value.
    w = -z / torch.full_like(z, _SQRT2)
    phi = 0.5 * torch.special.erfc(w.double()).float()
    point = (r_hat >= thr).to(phi.dtype)
    return torch.where(sigma > 0, phi, point)


def prob_from_moments(sy, syy, sxy, svy, svyy, svxy, sx, sxx, sv, svx,
                      svxx, n, threshold: float):
    """Match probability P[true warp correlation >= threshold] from the
    six carried moments and the query's variance folds, elementwise over
    broadcast-compatible tensors — repro's ``_prob_from_moments``, the
    exact tail of the tick and of every verdict.

    First-order error propagation of the per-sample variances through r
    (with the warp path held fixed) gives sigma_r; r is disattenuated by
    sqrt(vx / (vx - sv)), capped at 2x; P = Phi((r_hat - threshold) /
    sigma_r).  Zero variance makes sigma exactly 0 and P the point rule
    in {0, 1}."""
    _, _, _, _, _, r_hat, a, b, c = _tail_core(sy, syy, sxy, sx, sxx, sv, n)
    return _tail_prob(r_hat, a, b, c, sv, svx, svxx, svy, svxy, svyy,
                      threshold)


def prob_from_moments_approx(sy, syy, sxy, svy, sx, sxx, sv, svx, svxx, n,
                             threshold: float):
    """Approximate match probability from ONE carried variance channel
    (svy) — repro's ``_prob_from_moments_approx``, the approx serving
    tick's tail.  svxy and svyy are rebuilt from the folds through the
    warp regression line y ~ alpha + beta x, re-centred on the carried
    svy; the clamps (``sv_safe``, ``safe_vx``, ``max(., 0)``) keep
    constant traces finite.  Zero variance gives the exact tail's point
    rule bitwise."""
    _, vx, vy, cov, safe_vx, r_hat, a, b, c = _tail_core(
        sy, syy, sxy, sx, sxx, sv, n)
    beta = cov / safe_vx
    alpha = (sy - beta * sx) / n
    sv_safe = torch.where(sv > 0, sv, 1.0)
    resid = svy - (alpha * sv + beta * svx)
    svxy_hat = alpha * svx + beta * svxx + (svx / sv_safe) * resid
    sige2 = torch.clamp_min(vy - cov * cov / safe_vx, 0.0) / n
    svyy_hat = torch.clamp_min(
        alpha * alpha * sv + 2.0 * alpha * beta * svx
        + beta * beta * svxx
        + 2.0 * (alpha + beta * svx / sv_safe) * resid + sv * sige2,
        0.0)
    return _tail_prob(r_hat, a, b, c, sv, svx, svxx, svy, svxy_hat,
                      svyy_hat, threshold)


def _check_verdict(xs, xlens, bank_t, lengths, sx, sxx, band) -> None:
    """Raise unless the verdict's tensors are what the kernel's pointer
    arithmetic assumes."""
    dev = xs.device
    check_kernel_device(xs)
    j, n = xs.shape
    m, k = bank_t.shape
    check_tensor(xs, "xs", torch.float32, (j, n), dev)
    check_tensor(bank_t, "bank_t", torch.float32, (m, k), dev)
    check_tensor(xlens, "xlens", torch.int32, (j,), dev)
    check_tensor(lengths, "lengths", torch.int32, (k,), dev)
    check_tensor(sx, "sx", torch.float32, (j,), dev)
    check_tensor(sxx, "sxx", torch.float32, (j,), dev)
    if band is not None and band < 0:
        raise ValueError("band must be >= 0 (or None)")


def _edges(nch: int, pairs: int, n: int, m: int, dev) -> torch.Tensor:
    """The panel-edge buffer of the kernels' wavefront: [pairs, N, 1 +
    NCH] f32 (a panel's right edge column, distance and moment bases,
    for the next panel) when a reference can be longer than one panel of
    32 strips, else a 1-element stand-in that is never read."""
    if m > _LANES * LIB.get().dtw_score_strip(nch):
        return torch.empty((pairs, n, 1 + nch), dtype=torch.float32,
                           device=dev)
    return torch.empty((1,), dtype=torch.float32, device=dev)


def score_bank_offline(xs, xlens, bank_t, lengths, sx, sxx,
                       band: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-end scores and endpoint distances -> ``(scores, dists)``,
    both [J, K] f32.

    xs [J, N] f32 (padded; ``xlens`` [J] i32 true lengths), bank_t
    [M, K] f32 with lengths [K] i32, sx/sxx [J] f32 centred query folds.
    A query of length 0 scores 0.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if not xs.is_cuda:
        return score_bank_offline_plain(xs, xlens, bank_t, lengths, sx, sxx,
                                        band)
    _check_verdict(xs, xlens, bank_t, lengths, sx, sxx, band)
    dev = xs.device
    j, n = xs.shape
    m, k = bank_t.shape
    scores = torch.empty((j, k), dtype=torch.float32, device=dev)
    dists = torch.empty((j, k), dtype=torch.float32, device=dev)
    edges = _edges(3, j * k, n, m, dev)
    err = LIB.get().dtw_score_offline(
        xs.data_ptr(), xlens.data_ptr(), bank_t.data_ptr(),
        lengths.data_ptr(), sx.data_ptr(), sxx.data_ptr(),
        edges.data_ptr(), scores.data_ptr(), dists.data_ptr(), j, n, k,
        -1 if band is None else int(band),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("dtw_score_offline", err)
    LIB.launches += 1
    return scores, dists


def score_bank_offline_var(xs, xvars, xlens, bank_t, lengths, sx, sxx,
                           vstats, band: Optional[int] = None,
                           threshold: float = 0.9, approx: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """K5 (``approx=False``) and K6 (``approx=True``): closed-end scores,
    match probabilities and endpoint distances of uncertain queries ->
    ``(scores, probs, dists)``, each [J, K] f32.

    As :func:`score_bank_offline`, plus xvars [J, N] f32 per-sample
    variances and vstats [J, 3] f32 (sv, svx, svxx) folds; ``probs`` is
    P[true warp correlation >= ``threshold``] through the exact or the
    approx tail.  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not xs.is_cuda:
        return score_bank_offline_var_plain(xs, xvars, xlens, bank_t,
                                            lengths, sx, sxx, vstats, band,
                                            threshold, approx)
    _check_verdict(xs, xlens, bank_t, lengths, sx, sxx, band)
    dev = xs.device
    j, n = xs.shape
    m, k = bank_t.shape
    check_tensor(xvars, "xvars", torch.float32, (j, n), dev)
    check_tensor(vstats, "vstats", torch.float32, (j, 3), dev)
    nch = 4 if approx else 6
    scores, probs, dists = (torch.empty((j, k), dtype=torch.float32,
                                        device=dev) for _ in range(3))
    edges = _edges(nch, j * k, n, m, dev)
    err = LIB.get().dtw_score_offline_var(
        xs.data_ptr(), xvars.data_ptr(), xlens.data_ptr(),
        bank_t.data_ptr(), lengths.data_ptr(), sx.data_ptr(),
        sxx.data_ptr(), vstats.data_ptr(), edges.data_ptr(),
        scores.data_ptr(), probs.data_ptr(), dists.data_ptr(), j, n, k,
        -1 if band is None else int(band),
        float(np.float32(threshold)), int(approx),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("dtw_score_offline_var", err)
    VAR_LAUNCHES[nch] += 1
    return scores, probs, dists


def score_pairs(xs, xlens, ys_t, ylens, sx, sxx, band: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 pairs: closed-end score and endpoint distance of query p
    against reference p -> ``(scores, dists)``, both [P] f32.

    xs [P, N] f32 (padded; ``xlens`` [P] i32 true lengths), ys_t [M, P]
    f32 the references K-last (column p is reference p, padded; ``ylens``
    [P] i32), sx/sxx [P] f32 centred query folds.  Bitwise K2's result
    for the same pair.  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    global PAIRS_LAUNCHES
    if not xs.is_cuda:
        return score_pairs_plain(xs, xlens, ys_t, ylens, sx, sxx, band)
    _check_verdict(xs, xlens, ys_t, ylens, sx, sxx, band)
    dev = xs.device
    p, n = xs.shape
    m = ys_t.shape[0]
    if ys_t.shape[1] != p:
        raise ValueError(f"{p} queries but {ys_t.shape[1]} references")
    scores = torch.empty((p,), dtype=torch.float32, device=dev)
    dists = torch.empty((p,), dtype=torch.float32, device=dev)
    edges = _edges(3, p, n, m, dev)
    err = LIB.get().dtw_score_pairs(
        xs.data_ptr(), xlens.data_ptr(), ys_t.data_ptr(), ylens.data_ptr(),
        sx.data_ptr(), sxx.data_ptr(), edges.data_ptr(), scores.data_ptr(),
        dists.data_ptr(), p, n, -1 if band is None else int(band),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("dtw_score_pairs", err)
    PAIRS_LAUNCHES += 1
    return scores, dists


def score_pairs_plain(xs, xlens, ys_t, ylens, sx, sxx,
                      band: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`score_pairs` (same arguments and
    results), on whatever device the tensors are on: K2's plain version
    with a bank of one reference for each query."""
    p = xs.shape[0]
    m = ys_t.shape[0]
    dev = xs.device
    rows, moms = stream_bank_extend_scored_plain(
        torch.full((p, m, 1), INF, dtype=torch.float32, device=dev),
        torch.zeros((3, p, m, 1), dtype=torch.float32, device=dev),
        torch.zeros((p,), dtype=torch.int32, device=dev),
        ys_t.t()[:, :, None], ylens[:, None], xs, xlens, xlens, band)
    pp = torch.arange(p, device=dev)
    jend = (ylens - 1).long()
    dists, msel = rows[pp, jend, 0], moms[:, pp, jend, 0]
    nn = torch.clamp_min(xlens, 1).to(torch.float32)
    scores = corr_from_moments(msel[0], msel[1], msel[2], sx, sxx, nn)
    return torch.where(xlens > 0, scores, 0.0), dists


def _endpoint(rows, moms, lengths):
    """Distances [J, K] and moments [NCH, J, K] at column len_k - 1."""
    k = lengths.shape[0]
    jend = (lengths - 1).long()
    kk = torch.arange(k, device=rows.device)
    return rows[:, jend, kk], moms[:, :, jend, kk]


def score_bank_offline_plain(xs, xlens, bank_t, lengths, sx, sxx,
                             band: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`score_bank_offline` (same arguments
    and results), on whatever device the tensors are on."""
    j = xs.shape[0]
    m, k = bank_t.shape
    dev = xs.device
    rows, moms = stream_bank_extend_scored_plain(
        torch.full((j, m, k), INF, dtype=torch.float32, device=dev),
        torch.zeros((3, j, m, k), dtype=torch.float32, device=dev),
        torch.zeros((j,), dtype=torch.int32, device=dev), bank_t, lengths,
        xs, xlens, xlens, band)
    dists, msel = _endpoint(rows, moms, lengths)
    nn = torch.clamp_min(xlens, 1).to(torch.float32)[:, None]
    scores = corr_from_moments(msel[0], msel[1], msel[2], sx[:, None],
                               sxx[:, None], nn)
    return torch.where(xlens[:, None] > 0, scores, 0.0), dists


def score_bank_offline_var_plain(xs, xvars, xlens, bank_t, lengths, sx,
                                 sxx, vstats, band: Optional[int] = None,
                                 threshold: float = 0.9,
                                 approx: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch version of :func:`score_bank_offline_var` (same
    arguments and results), on whatever device the tensors are on."""
    j = xs.shape[0]
    m, k = bank_t.shape
    dev = xs.device
    nch = 4 if approx else 6
    rows, moms = stream_bank_extend_scored_var_plain(
        torch.full((j, m, k), INF, dtype=torch.float32, device=dev),
        torch.zeros((nch, j, m, k), dtype=torch.float32, device=dev),
        torch.zeros((j,), dtype=torch.int32, device=dev), bank_t, lengths,
        xs, xvars, xlens, xlens, band)
    dists, ms = _endpoint(rows, moms, lengths)
    nn = torch.clamp_min(xlens, 1).to(torch.float32)[:, None]
    sxj, sxxj = sx[:, None], sxx[:, None]
    sv, svx, svxx = (vstats[:, i:i + 1] for i in range(3))
    scores = corr_from_moments(ms[0], ms[1], ms[2], sxj, sxxj, nn)
    if approx:
        probs = prob_from_moments_approx(ms[0], ms[1], ms[2], ms[3], sxj,
                                         sxxj, sv, svx, svxx, nn, threshold)
    else:
        probs = prob_from_moments(ms[0], ms[1], ms[2], ms[3], ms[4], ms[5],
                                  sxj, sxxj, sv, svx, svxx, nn, threshold)
    live = xlens[:, None] > 0
    return (torch.where(live, scores, 0.0), torch.where(live, probs, 0.0),
            dists)
