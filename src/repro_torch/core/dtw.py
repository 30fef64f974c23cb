"""Dynamic Time Warping for the online tuning service (paper §3.1.2).

The paper's recurrence::

    D(i, j) = d(x_i, y_j) + min(D(i, j-1), D(i-1, j), D(i-1, j-1))

with ``d`` the absolute difference of utilization samples.  This module
holds the two device paths of the exact point-mode service, each a thin
layer over its hand kernel in ``kernels.dtw``:

* the **streaming tick** (:func:`bank_extend_tick_scored_dispatch`):
  every in-flight job's DP row advances by one chunk against the whole
  reference bank, carrying the warp-path correlation moments
  (sy, syy, sxy) along the path backtracking would pick, and reduces to
  an ``[S, K]`` open-end correlation (:func:`_moment_scores`).  State is
  K-last: rows ``[S, M, K]``, moms ``[3, S, M, K]``, bank ``[M, K]``.
* the **offline verdict** (:func:`dtw_score_bank_many`): complete
  queries scored at the closed alignment endpoint ``(N-1, len_k-1)``.

CUDA tensors go through kernels K1 and K2; CPU tensors through their
plain PyTorch versions.  :func:`bank_extend_tick_scored` is the plain tick
on any device, which is what the kernel tick is held against.

Conventions match ``repro.core.dtw``: rows saturate at ``_INF = 3e38``,
moments are centred by ``_MOM_SHIFT = 0.5``, the predecessor is chosen
diag, then vert, then horiz, and :func:`_corr_from_moments` pins
degenerate variances.  Padding: ``D[:, j]`` depends only on columns
``<= j``, so a bank may be padded with anything; the Sakoe-Chiba band is
re-derived per reference from its true length.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..kernels.dtw import score as _score
from ..kernels.dtw import stream as _stream

__all__ = ["bank_extend_tick_scored", "bank_extend_tick_scored_dispatch",
           "tick_state_from_numpy", "query_moments", "ScoreBankPlan",
           "build_score_plan", "dtw_score_bank_many", "dtw_score_bank"]

_INF = _stream.INF
_MOM_SHIFT = _stream.MOM_SHIFT

#: The one score tail (shared with the verdict kernel's plain version).
_corr_from_moments = _score.corr_from_moments

#: Chunks are padded up to the next power of two (>= _CHUNK_MIN), as the
#: reference does, so a tick's chunk width takes few distinct values.
_CHUNK_MIN = 8


def _chunk_bucket(c: int) -> int:
    return max(_CHUNK_MIN, 1 << (max(c, 1) - 1).bit_length())


def _moment_scores(rows, moms, ns, sx, sxx, lengths) -> torch.Tensor:
    """Open-end warp correlation per (job, reference) -> [S, K].

    Mask the DP row to true columns, take the open-end argmin (the best
    reference prefix; ``torch.argmin`` returns the first minimum, as
    ``jnp.argmin`` does), read the moments there and apply the score
    tail.  Slots with no samples score 0."""
    s, m, k = rows.shape
    colmask = torch.arange(m, device=rows.device)[:, None] < lengths[None, :]
    masked = torch.where(colmask[None], rows, _INF)
    j_end = torch.argmin(masked, dim=1)                            # [S, K]
    msel = torch.gather(moms, 2, j_end[None, :, None, :].expand(3, s, 1, k)
                        )[:, :, 0, :]                              # [3, S, K]
    n = torch.clamp_min(ns, 1).to(torch.float32)[:, None]
    out = _corr_from_moments(msel[0], msel[1], msel[2], sx[:, None],
                             sxx[:, None], n)
    return torch.where(ns[:, None] > 0, out, 0.0)


def _tick_tail(rows, moms, ns, sx, sxx, lengths, chunks, nvalid):
    """Query fold and open-end reduction around a chunk extend (kept out
    of the kernel, as in the reference): ``sx += Σ(x - 0.5)``,
    ``sxx += Σ(x - 0.5)²`` over the valid samples."""
    c = chunks.shape[1]
    xm = chunks - _MOM_SHIFT
    vmask = (torch.arange(c, device=chunks.device)[None, :]
             < nvalid[:, None]).to(torch.float32)
    sx2 = sx + torch.sum(xm * vmask, dim=1)
    sxx2 = sxx + torch.sum(xm * xm * vmask, dim=1)
    ns2 = ns + nvalid
    scores = _moment_scores(rows, moms, ns2, sx2, sxx2, lengths)
    return rows, moms, ns2, sx2, sxx2, scores


def bank_extend_tick_scored(rows, moms, ns, sx, sxx, bank_t, lengths,
                            chunks, nvalid, qlens,
                            band: Optional[int] = None):
    """Plain fused scoring tick on the tensors' device ->
    ``(rows, moms, ns, sx, sxx, scores [S, K])``."""
    rows2, moms2 = _stream.stream_bank_extend_scored_plain(
        rows, moms, ns, bank_t, lengths, chunks, nvalid, qlens, band)
    return _tick_tail(rows2, moms2, ns, sx, sxx, lengths, chunks, nvalid)


def bank_extend_tick_scored_dispatch(rows, moms, ns, sx, sxx, bank_t,
                                     lengths, chunks, nvalid, qlens,
                                     band: Optional[int] = None):
    """The service's fused scoring tick: kernel K1 for CUDA tensors (the
    plain version for CPU tensors), then the query fold and the open-end
    reduction.  Same arguments and 6-tuple as
    :func:`bank_extend_tick_scored`.

    rows [S, M, K] f32, moms [3, S, M, K] f32, ns [S] i32, sx/sxx [S]
    f32, bank_t [M, K] f32, lengths [K] i32, chunks [S, C] f32 (samples
    past ``nvalid[s]`` are ignored), qlens [S] i32 expected query lengths
    (the band centres need them)."""
    rows2, moms2 = _stream.stream_bank_extend_scored(
        rows, moms, ns, bank_t, lengths, chunks, nvalid, qlens, band)
    return _tick_tail(rows2, moms2, ns, sx, sxx, lengths, chunks, nvalid)


def tick_state_from_numpy(rows, moms, ns, sx, sxx,
                          device: Union[str, torch.device, None] = None):
    """Tick state as ``repro`` holds it (numpy: rows [S, M, K], moms
    [3, S, M, K], ns [S], sx/sxx [S]) -> the port's tensors on
    ``device`` (f32, f32, i32, f32, f32), so both ticks can resume from
    the same mid-flight state."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=dev)
    return (put(rows, torch.float32), put(moms, torch.float32),
            put(ns, torch.int32), put(sx, torch.float32),
            put(sxx, torch.float32))


# ---------------------------------------------------------------------------
# Offline (closed-end) scoring: the verdict path
# ---------------------------------------------------------------------------

def query_moments(x: np.ndarray) -> Tuple[np.float32, np.float32]:
    """Host-side centred query folds (sx, sxx), accumulated in float64
    from the unpadded samples, so a job's folds are bit-identical however
    its verdict is batched (what makes ``finish_many`` == sequential
    ``finish`` exact)."""
    xm = np.asarray(x, np.float64).reshape(-1) - _MOM_SHIFT
    return np.float32(xm.sum()), np.float32((xm * xm).sum())


def _pad_pow2(n: int, lo: int = 8) -> int:
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class ScoreBankPlan:
    """A reference bank uploaded for the verdict scorer: the K-last
    ``[M, K]`` series and ``[K]`` true lengths on one device.  (The
    reference's plan also sorts and tiles the bank for its jnp wavefront;
    the kernel needs neither, so the port's plan is the upload alone.)
    Build once per bank (``SeriesBank.score_plan`` caches it)."""
    k: int
    bank_t: torch.Tensor                 # [M, K] f32
    lengths: torch.Tensor                # [K] i32

    @property
    def device(self) -> torch.device:
        return self.bank_t.device


def build_score_plan(series, lengths=None,
                     device: Union[str, torch.device, None] = None
                     ) -> ScoreBankPlan:
    """Upload a [K, M] bank (true ``lengths``, default M) for
    :func:`dtw_score_bank_many`."""
    dev = resolve_device(device)
    series = np.asarray(series, np.float32)
    k, m = series.shape
    lengths = np.full((k,), m, np.int32) if lengths is None \
        else np.asarray(lengths, np.int32)
    return ScoreBankPlan(
        k=k,
        bank_t=torch.tensor(np.ascontiguousarray(series.T), device=dev),
        lengths=torch.tensor(lengths, dtype=torch.int32, device=dev))


def dtw_score_bank_many(xs, bank, lengths=None, xlens=None,
                        band: Optional[int] = None, sx=None, sxx=None, *,
                        xvars=None, vstats=None, threshold: float = 0.9,
                        prob_mode: str = "exact",
                        plan: Optional[ScoreBankPlan] = None,
                        device: Union[str, torch.device, None] = None,
                        return_distances: bool = False):
    """Closed-end warp correlations of J queries against a padded bank in
    one kernel launch -> f32 tensor [J, K] (and the DTW distances
    ``D(xlen_j - 1, len_k - 1)`` [J, K] with ``return_distances``).

    ``xs`` [J, N] (padded; ``xlens`` true lengths, default N), ``bank``
    [K, M] with ``lengths`` as everywhere else.  ``sx``/``sxx`` are the
    per-query folds (:func:`query_moments`), computed here when None.
    Runs on ``plan``'s device when a plan is given, else on ``device``
    (CUDA by default).  Variance mode (``xvars``, ``vstats``,
    ``prob_mode``; ``threshold`` only matters there) is not ported yet.
    """
    if xvars is not None or vstats is not None or prob_mode != "exact":
        raise NotImplementedError(
            "probabilistic scoring (xvars=, vstats=, prob_mode=) is not "
            "ported yet: ROADMAP.md queue 1 item 8")
    xs = np.asarray(xs, np.float32)
    if xs.ndim != 2:
        raise ValueError(f"xs must be [J, N], got shape {xs.shape}")
    j, n = xs.shape
    xlens = np.full((j,), n, np.int32) if xlens is None \
        else np.asarray(xlens, np.int32)
    series = np.asarray(bank, np.float32)
    k, m = series.shape
    if sx is None or sxx is None:
        folds = [query_moments(xs[i, :xlens[i]]) for i in range(j)]
        sx = np.asarray([f[0] for f in folds], np.float32)
        sxx = np.asarray([f[1] for f in folds], np.float32)
    if plan is None:
        plan = build_score_plan(series, lengths, device)
    elif plan.k != k:
        raise ValueError(
            f"ScoreBankPlan is for a {plan.k}-reference bank but {k} "
            "references were passed — plans are bank-specific")
    dev = plan.device
    if k == 0:
        z = torch.zeros((j, 0), dtype=torch.float32, device=dev)
        return (z, z) if return_distances else z
    scores, dists = _score.score_bank_offline(
        torch.tensor(xs, device=dev),
        torch.tensor(xlens, dtype=torch.int32, device=dev),
        plan.bank_t, plan.lengths,
        torch.tensor(np.asarray(sx, np.float32), device=dev),
        torch.tensor(np.asarray(sxx, np.float32), device=dev), band)
    return (scores, dists) if return_distances else scores


def dtw_score_bank(x, bank, lengths=None, band: Optional[int] = None, *,
                   plan: Optional[ScoreBankPlan] = None,
                   device: Union[str, torch.device, None] = None,
                   return_distances: bool = False):
    """One query against the whole bank -> f32 [K] closed-end warp
    correlations (the J == 1 row of :func:`dtw_score_bank_many`)."""
    x = np.asarray(x, np.float32).reshape(-1)
    out = dtw_score_bank_many(x[None], bank, lengths, None, band,
                              plan=plan, device=device,
                              return_distances=return_distances)
    return (out[0][0], out[1][0]) if return_distances else out[0]
