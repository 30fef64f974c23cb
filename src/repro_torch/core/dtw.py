"""Dynamic Time Warping for the online tuning service and the offline
matching phase (paper §3.1.2).

The paper's recurrence::

    D(i, j) = d(x_i, y_j) + min(D(i, j-1), D(i-1, j), D(i-1, j-1))

with ``d`` the absolute difference of utilization samples.  This module
holds the device paths of the service, each a thin layer over its hand
kernel in ``kernels.dtw``:

* the **distance-only tick** (:func:`bank_extend_tick_dispatch`): every
  in-flight job's DP row advances by one chunk, with no moments and no
  scores (``TuningService(score_in_flight=False)`` and the overload
  ladder's ``distance_only`` rung).  Its rows are bitwise the scored
  ticks' rows.
* the **streaming tick** (:func:`bank_extend_tick_scored_dispatch`):
  every in-flight job's DP row advances by one chunk against the whole
  reference bank, carrying the warp-path correlation moments
  (sy, syy, sxy) along the path backtracking would pick, and reduces to
  an ``[S, K]`` open-end correlation (:func:`_moment_scores`).  State is
  K-last: rows ``[S, M, K]``, moms ``[3, S, M, K]``, bank ``[M, K]``.
* the **probabilistic ticks** (:func:`bank_extend_tick_scored_var_dispatch`
  and :func:`bank_extend_tick_scored_var_approx_dispatch`): the same tick
  for uncertain samples.  Per-sample measurement variances ``vchunks``
  ride beside the samples, the slab carries six channels (exact: sy,
  syy, sxy, svy, svyy, svxy) or four (approx: sy, syy, sxy, svy), the
  path-independent folds ``vstats`` ``[S, 3]`` = (sv, svx, svxx) ride
  beside sx/sxx, and the tick also returns ``[S, K]`` match
  probabilities (:func:`_moment_scores_prob` or
  :func:`_moment_scores_prob_approx`).
* the **offline verdict** (:func:`dtw_score_bank_many`): complete
  queries scored at the closed alignment endpoint ``(N-1, len_k-1)``,
  with match probabilities when ``xvars`` is given; and for P
  (query, reference) pairs (:func:`dtw_score_pairs`).
* the **matrix path** of the offline matching phase: full accumulated-
  cost matrices (:func:`dtw_matrix`, :func:`dtw_matrix_banded`,
  :func:`dtw_matrix_bank`, :func:`dtw_matrix_pairs`), distances
  (:func:`dtw_distance_bank`), the streaming bank DP that a single
  in-flight job carries across chunks (:class:`DtwBankState`,
  :func:`dtw_bank_extend`), and the host backtrack into the warped
  series Y' (:func:`backtrack`, :func:`warp_to`, :func:`dtw_warp`).

CUDA tensors go through kernels K3 (distance tick), K1 (point tick), K4
(probabilistic ticks), K2 (point verdict, and its pairs entry), K5 and K6
(exact and approx probabilistic verdicts) and K7 (every matrix, row and
distance of the matrix path); CPU tensors through their plain PyTorch
versions.  Backtracking stays numpy on the host, as in the reference.  :func:`bank_extend_tick`, :func:`bank_extend_tick_scored`,
:func:`bank_extend_tick_scored_var` and
:func:`bank_extend_tick_scored_var_approx` are the plain ticks on any
device, which is what the kernel ticks are held against.

Conventions match ``repro.core.dtw``: rows saturate at ``_INF = 3e38``,
moments are centred by ``_MOM_SHIFT = 0.5``, the predecessor is chosen
diag, then vert, then horiz, and :func:`_corr_from_moments` pins
degenerate variances.  Padding: ``D[:, j]`` depends only on columns
``<= j``, so a bank may be padded with anything; the Sakoe-Chiba band is
re-derived per reference from its true length.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.common import as_tensor, resolve_device
from ..kernels.dtw import matrix as _matrix
from ..kernels.dtw import ops as _ops
from ..kernels.dtw import score as _score
from ..kernels.dtw import stream as _stream

__all__ = ["bank_extend_tick", "bank_extend_tick_dispatch",
           "bank_extend_tick_scored", "bank_extend_tick_scored_dispatch",
           "bank_extend_tick_scored_var",
           "bank_extend_tick_scored_var_dispatch",
           "bank_extend_tick_scored_var_approx",
           "bank_extend_tick_scored_var_approx_dispatch",
           "tick_state_from_numpy", "query_moments", "query_var_moments",
           "ScoreBankPlan", "build_score_plan", "dtw_score_bank_many",
           "dtw_score_bank", "cost_matrix", "dtw_matrix", "dtw_distance",
           "dtw_matrix_banded", "dtw_matrix_bank", "dtw_matrix_pairs",
           "dtw_distance_bank", "dtw_score_pairs", "DtwBankState",
           "dtw_bank_init", "dtw_bank_extend", "backtrack", "warp_to",
           "dtw_warp"]

_INF = _stream.INF
_MOM_SHIFT = _stream.MOM_SHIFT

#: The score tails (shared with the verdict kernels' plain versions).
_corr_from_moments = _score.corr_from_moments
_prob_from_moments = _score.prob_from_moments
_prob_from_moments_approx = _score.prob_from_moments_approx

#: Chunks are padded up to the next power of two (>= _CHUNK_MIN), as the
#: reference does, so a tick's chunk width takes few distinct values.
_CHUNK_MIN = 8


def _chunk_bucket(c: int) -> int:
    return max(_CHUNK_MIN, 1 << (max(c, 1) - 1).bit_length())


def _open_end_moments(rows, moms, lengths) -> torch.Tensor:
    """Moments at each (job, reference)'s open-end endpoint ->
    [NCH, S, K]: mask the DP row to true columns and take the argmin (the
    best reference prefix; ``torch.argmin`` returns the first minimum, as
    ``jnp.argmin`` does)."""
    s, m, k = rows.shape
    colmask = torch.arange(m, device=rows.device)[:, None] < lengths[None, :]
    masked = torch.where(colmask[None], rows, _INF)
    j_end = torch.argmin(masked, dim=1)                            # [S, K]
    nch = moms.shape[0]
    return torch.gather(moms, 2, j_end[None, :, None, :].expand(
        nch, s, 1, k))[:, :, 0, :]                                 # [NCH,S,K]


def _moment_scores(rows, moms, ns, sx, sxx, lengths) -> torch.Tensor:
    """Open-end warp correlation per (job, reference) -> [S, K], read
    from the first three moment channels.  Slots with no samples score
    0."""
    msel = _open_end_moments(rows, moms[:3], lengths)
    n = torch.clamp_min(ns, 1).to(torch.float32)[:, None]
    out = _corr_from_moments(msel[0], msel[1], msel[2], sx[:, None],
                             sxx[:, None], n)
    return torch.where(ns[:, None] > 0, out, 0.0)


def _moment_scores_prob(rows, moms, ns, sx, sxx, vstats, lengths,
                        threshold: float) -> torch.Tensor:
    """Open-end match probability per (job, reference) -> [S, K]: the
    same endpoint as :func:`_moment_scores`, all six channels of the
    [6, S, M, K] slab and the ``vstats`` [S, 3] folds through
    :func:`_prob_from_moments`.  Empty slots get 0 (no evidence)."""
    ms = _open_end_moments(rows, moms, lengths)
    n = torch.clamp_min(ns, 1).to(torch.float32)[:, None]
    sv, svx, svxx = (vstats[:, i:i + 1] for i in range(3))
    probs = _prob_from_moments(ms[0], ms[1], ms[2], ms[3], ms[4], ms[5],
                               sx[:, None], sxx[:, None], sv, svx, svxx, n,
                               threshold)
    return torch.where(ns[:, None] > 0, probs, 0.0)


def _moment_scores_prob_approx(rows, moms, ns, sx, sxx, vstats, lengths,
                               threshold: float) -> torch.Tensor:
    """The four-channel twin of :func:`_moment_scores_prob` through
    :func:`_prob_from_moments_approx`.  The first four channels of an
    exact six-channel slab give the same result (channel 3 is svy in
    both layouts)."""
    ms = _open_end_moments(rows, moms[:4], lengths)
    n = torch.clamp_min(ns, 1).to(torch.float32)[:, None]
    sv, svx, svxx = (vstats[:, i:i + 1] for i in range(3))
    probs = _prob_from_moments_approx(ms[0], ms[1], ms[2], ms[3],
                                      sx[:, None], sxx[:, None], sv, svx,
                                      svxx, n, threshold)
    return torch.where(ns[:, None] > 0, probs, 0.0)


def _centred_valid(chunks, nvalid):
    """The chunk's centred samples ``x - 0.5`` and the [S, C] f32 mask of
    its valid samples."""
    c = chunks.shape[1]
    vmask = (torch.arange(c, device=chunks.device)[None, :]
             < nvalid[:, None]).to(torch.float32)
    return chunks - _MOM_SHIFT, vmask


def _tick_tail(rows, moms, ns, sx, sxx, lengths, chunks, nvalid):
    """Query fold and open-end reduction around a chunk extend (kept out
    of the kernel, as in the reference): ``sx += Σ(x - 0.5)``,
    ``sxx += Σ(x - 0.5)²`` over the valid samples."""
    xm, vmask = _centred_valid(chunks, nvalid)
    sx2 = sx + torch.sum(xm * vmask, dim=1)
    sxx2 = sxx + torch.sum(xm * xm * vmask, dim=1)
    ns2 = ns + nvalid
    scores = _moment_scores(rows, moms, ns2, sx2, sxx2, lengths)
    return rows, moms, ns2, sx2, sxx2, scores


def bank_extend_tick(rows, ns, bank_t, lengths, chunks, nvalid, qlens,
                     band: Optional[int] = None):
    """Plain distance-only tick on the tensors' device -> ``(rows, ns)``.

    rows [S, M, K] f32, ns/nvalid/qlens [S] i32, bank_t [M, K] f32,
    lengths [K] i32, chunks [S, C] f32; the rows are bitwise those of
    :func:`bank_extend_tick_scored` on the same inputs."""
    rows2 = _stream.stream_bank_extend_plain(rows, ns, bank_t, lengths,
                                             chunks, nvalid, qlens, band)
    return rows2, ns + nvalid


def bank_extend_tick_dispatch(rows, ns, bank_t, lengths, chunks, nvalid,
                              qlens, band: Optional[int] = None):
    """The service's distance-only tick: kernel K3 for CUDA tensors (the
    plain version for CPU tensors).  Same arguments and pair as
    :func:`bank_extend_tick`."""
    rows2 = _stream.stream_bank_extend(rows, ns, bank_t, lengths, chunks,
                                       nvalid, qlens, band)
    return rows2, ns + nvalid


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


def _tick_tail_var(rows, moms, ns, sx, sxx, vstats, lengths, chunks,
                   vchunks, nvalid, threshold: float):
    """The probabilistic tick's tail: the point tail, plus the variance
    folds ``vstats += (Σv, Σv(x - 0.5), Σv(x - 0.5)²)`` over the valid
    samples and the open-end match probabilities (exact tail for a
    six-channel slab, approx for four) ->
    ``(rows, moms, ns, sx, sxx, scores, vstats, probs)``."""
    xm, vmask = _centred_valid(chunks, nvalid)
    vq = vchunks * vmask
    vstats2 = vstats + torch.stack(
        [torch.sum(vq, dim=1), torch.sum(vq * xm, dim=1),
         torch.sum(vq * xm * xm, dim=1)], dim=1)                  # [S, 3]
    rows, moms, ns2, sx2, sxx2, scores = _tick_tail(
        rows, moms, ns, sx, sxx, lengths, chunks, nvalid)
    prob_fn = _moment_scores_prob if moms.shape[0] == 6 \
        else _moment_scores_prob_approx
    probs = prob_fn(rows, moms, ns2, sx2, sxx2, vstats2, lengths, threshold)
    return rows, moms, ns2, sx2, sxx2, scores, vstats2, probs


def _check_nch(moms, nch: int, what: str) -> None:
    if moms.shape[0] != nch:
        raise ValueError(f"{what} needs a {nch}-channel moment slab, got "
                         f"{moms.shape[0]} channels")


def bank_extend_tick_scored_var(rows, moms, ns, sx, sxx, vstats, bank_t,
                                lengths, chunks, vchunks, nvalid, qlens,
                                band: Optional[int] = None,
                                threshold: float = 0.9):
    """Plain variance-carrying scoring tick on the tensors' device ->
    ``(rows, moms, ns, sx, sxx, scores, vstats, probs)``.

    As :func:`bank_extend_tick_scored` with moms [6, S, M, K] (sy, syy,
    sxy, svy, svyy, svxy), vstats [S, 3] (sv, svx, svxx) and vchunks
    [S, C] per-sample variances; ``probs`` [S, K] are the
    :func:`_prob_from_moments` match probabilities P[true warp
    correlation >= ``threshold``] at the open-end endpoints."""
    _check_nch(moms, 6, "the exact variance tick")
    rows2, moms2 = _stream.stream_bank_extend_scored_var_plain(
        rows, moms, ns, bank_t, lengths, chunks, vchunks, nvalid, qlens,
        band)
    return _tick_tail_var(rows2, moms2, ns, sx, sxx, vstats, lengths,
                          chunks, vchunks, nvalid, threshold)


def bank_extend_tick_scored_var_dispatch(rows, moms, ns, sx, sxx, vstats,
                                         bank_t, lengths, chunks, vchunks,
                                         nvalid, qlens,
                                         band: Optional[int] = None,
                                         threshold: float = 0.9):
    """The service's exact probabilistic tick: kernel K4 with six
    channels for CUDA tensors (the plain version for CPU tensors), then
    the tail.  Same arguments and 8-tuple as
    :func:`bank_extend_tick_scored_var`."""
    _check_nch(moms, 6, "the exact variance tick")
    rows2, moms2 = _stream.stream_bank_extend_scored_var(
        rows, moms, ns, bank_t, lengths, chunks, vchunks, nvalid, qlens,
        band)
    return _tick_tail_var(rows2, moms2, ns, sx, sxx, vstats, lengths,
                          chunks, vchunks, nvalid, threshold)


def bank_extend_tick_scored_var_approx(rows, moms, ns, sx, sxx, vstats,
                                       bank_t, lengths, chunks, vchunks,
                                       nvalid, qlens,
                                       band: Optional[int] = None,
                                       threshold: float = 0.9):
    """Plain approximate variance-carrying tick: as
    :func:`bank_extend_tick_scored_var` with a FOUR-channel slab
    [4, S, M, K] (sy, syy, sxy, svy) and the
    :func:`_prob_from_moments_approx` tail."""
    _check_nch(moms, 4, "the approx variance tick")
    rows2, moms2 = _stream.stream_bank_extend_scored_var_plain(
        rows, moms, ns, bank_t, lengths, chunks, vchunks, nvalid, qlens,
        band)
    return _tick_tail_var(rows2, moms2, ns, sx, sxx, vstats, lengths,
                          chunks, vchunks, nvalid, threshold)


def bank_extend_tick_scored_var_approx_dispatch(
        rows, moms, ns, sx, sxx, vstats, bank_t, lengths, chunks, vchunks,
        nvalid, qlens, band: Optional[int] = None, threshold: float = 0.9):
    """The service's approx probabilistic tick: kernel K4 with four
    channels for CUDA tensors (the plain version for CPU tensors), then
    the tail.  Same arguments and 8-tuple as
    :func:`bank_extend_tick_scored_var_approx`."""
    _check_nch(moms, 4, "the approx variance tick")
    rows2, moms2 = _stream.stream_bank_extend_scored_var(
        rows, moms, ns, bank_t, lengths, chunks, vchunks, nvalid, qlens,
        band)
    return _tick_tail_var(rows2, moms2, ns, sx, sxx, vstats, lengths,
                          chunks, vchunks, nvalid, threshold)


def tick_state_from_numpy(rows, moms, ns, sx, sxx,
                          device: Union[str, torch.device, None] = None,
                          vstats=None):
    """Tick state as ``repro`` holds it (numpy: rows [S, M, K], moms
    [NCH, S, M, K], ns [S], sx/sxx [S], and in variance mode vstats
    [S, 3]) -> the port's tensors on ``device`` (f32, f32, i32, f32,
    f32, f32), so both ticks can resume from the same mid-flight
    state."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=dev)
    out = (put(rows, torch.float32), put(moms, torch.float32),
           put(ns, torch.int32), put(sx, torch.float32),
           put(sxx, torch.float32))
    return out if vstats is None else out + (put(vstats, torch.float32),)


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


def query_var_moments(x: np.ndarray, v: np.ndarray
                      ) -> Tuple[np.float32, np.float32, np.float32]:
    """Host-side path-independent variance folds (sv, svx, svxx) of a
    query with per-sample variances ``v`` — the variance-mode companions
    of :func:`query_moments` (same float64 accumulation, same
    batch-invariance)."""
    xm = np.asarray(x, np.float64).reshape(-1) - _MOM_SHIFT
    vv = np.asarray(v, np.float64).reshape(-1)
    return (np.float32(vv.sum()), np.float32((vv * xm).sum()),
            np.float32((vv * xm * xm).sum()))


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
    (CUDA by default).

    Variance mode: ``xvars`` [J, N] per-sample measurement variances
    (``vstats`` [J, 3] = (sv, svx, svxx) folds optional, see
    :func:`query_var_moments`) makes the result ``(scores, probs)`` (plus
    dists with ``return_distances``), ``probs`` [J, K] being P[true warp
    correlation >= ``threshold``] through the exact six-channel tail
    (kernel K5) or, with ``prob_mode="approx"``, the single-proxy tail
    (kernel K6).  All-zero ``xvars`` reduce ``probs`` to the point rule
    ``scores >= threshold`` exactly.
    """
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
    if xvars is not None:
        xvars = np.asarray(xvars, np.float32)
        if xvars.shape != xs.shape:
            raise ValueError(f"xvars must match xs shape {xs.shape}, "
                             f"got {xvars.shape}")
        if vstats is None:
            vstats = np.asarray(
                [query_var_moments(xs[i, :xlens[i]], xvars[i, :xlens[i]])
                 for i in range(j)], np.float32)
        vstats = np.asarray(vstats, np.float32).reshape(j, 3)
    if prob_mode not in ("exact", "approx"):
        raise ValueError(f"prob_mode must be 'exact' or 'approx', "
                         f"got {prob_mode!r}")
    if plan is None:
        plan = build_score_plan(series, lengths, device)
    elif plan.k != k:
        raise ValueError(
            f"ScoreBankPlan is for a {plan.k}-reference bank but {k} "
            "references were passed — plans are bank-specific")
    dev = plan.device
    if k == 0:
        z = torch.zeros((j, 0), dtype=torch.float32, device=dev)
        out = (z, z) if xvars is not None else (z,)
        out = out + (z,) if return_distances else out
        return out if len(out) > 1 else out[0]
    args = (torch.tensor(xs, device=dev),
            torch.tensor(xlens, dtype=torch.int32, device=dev),
            plan.bank_t, plan.lengths,
            torch.tensor(np.asarray(sx, np.float32), device=dev),
            torch.tensor(np.asarray(sxx, np.float32), device=dev))
    if xvars is not None:
        x, xl, bank_t, lens, sxt, sxxt = args
        scores, probs, dists = _score.score_bank_offline_var(
            x, torch.tensor(xvars, device=dev), xl, bank_t, lens, sxt, sxxt,
            torch.tensor(vstats, device=dev), band, float(threshold),
            approx=prob_mode == "approx")
        return (scores, probs, dists) if return_distances \
            else (scores, probs)
    scores, dists = _score.score_bank_offline(*args, band)
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


# ---------------------------------------------------------------------------
# The offline matching phase: full matrices, distances, streaming bank DP,
# backtracking (paper Fig. 4-a/4-b, Eq. 1-3)
# ---------------------------------------------------------------------------

Device = Union[str, torch.device, None]
_F32, _I32 = torch.float32, torch.int32


def cost_matrix(x, y, device: Device = None) -> torch.Tensor:
    """Pairwise |x_i - y_j| (paper Eq. 2) -> f32 [N, M]."""
    dev = resolve_device(device)
    x, y = as_tensor(x, _F32, dev), as_tensor(y, _F32, dev)
    return (x[:, None] - y[None, :]).abs()


def _pair_matrix(x, y, band: Optional[int], device: Device) -> torch.Tensor:
    """[N, M] matrix of one pair through K7 (K = 1), band centred on the
    pair's full lengths."""
    dev = resolve_device(device)
    y = as_tensor(y, _F32, dev).reshape(1, -1)
    return _ops.dtw_batched(x, y, dev, band=band)[0]


def dtw_matrix(x, y, device: Device = None) -> torch.Tensor:
    """Full accumulated-cost matrix D — f32 [N, M] (paper Eq. 1)."""
    return _pair_matrix(x, y, None, device)


def dtw_distance(x, y, device: Device = None) -> torch.Tensor:
    """Similarity distance D(N, M) between two series (a 0-d tensor)."""
    return dtw_matrix(x, y, device)[-1, -1]


def dtw_matrix_banded(x, y, band: int, device: Device = None
                      ) -> torch.Tensor:
    """DTW restricted to the Sakoe-Chiba band |j - centre(i)| <= band;
    the full [N, M] matrix with 3e38 outside the band (so backtracking
    still works)."""
    return _pair_matrix(x, y, band, device)


def dtw_matrix_bank(x, bank, lengths=None, band: Optional[int] = None,
                    device: Device = None) -> torch.Tensor:
    """One query x [N] against a padded bank [K, M] -> D matrices
    [K, N, M], one K7 launch (``kernels.dtw.ops.dtw_batched``).

    ``lengths`` (int32 [K], true series lengths) is only consulted by the
    banded variant, whose band is centred on the query's padded length N
    and each reference's true length (the reference's geometry); callers
    slice ``D[k, :, :lengths[k]]`` before backtracking."""
    return _ops.dtw_batched(x, bank, device, lengths=lengths, band=band)


def dtw_matrix_pairs(xs, ys, xlens=None, ylens=None,
                     band: Optional[int] = None,
                     device: Device = None) -> torch.Tensor:
    """Pairwise batched DTW: queries xs [P, N] vs references ys [P, M] ->
    D matrices [P, N, M], one K7 launch for all P pairs; the band of pair
    p is centred on its true lengths ``xlens[p]`` and ``ylens[p]``."""
    return _ops.dtw_batched_pairs(xs, ys, device, xlens=xlens, ylens=ylens,
                                  band=band)


def dtw_distance_bank(x, bank, lengths=None, band: Optional[int] = None,
                      device: Device = None) -> torch.Tensor:
    """Distances D(N, len_k) of one query against the whole bank -> [K]:
    one K7 launch that writes only the last row, read at column
    ``lengths[k] - 1`` (``kernels.dtw.ops.dtw_distances``); the banded
    variant equals the scalar banded solve of each unpadded series."""
    return _ops.dtw_distances(x, bank, device, lengths=lengths, band=band)


def dtw_score_pairs(xs, ys, xlens=None, ylens=None,
                    band: Optional[int] = None, *,
                    return_distances: bool = False,
                    device: Device = None):
    """Pairwise closed-end warp correlations -> f32 [P]: query p vs
    reference p, ragged on both sides (the engine behind
    ``match_application``), one launch of K2's pairs entry; with
    ``return_distances`` also the DTW distances D(xlen_p, ylen_p)."""
    dev = resolve_device(device)
    xs = np.asarray(xs, np.float32)
    ys = np.asarray(ys, np.float32)
    p, n = xs.shape
    xl = np.full((p,), n, np.int32) if xlens is None \
        else np.asarray(xlens, np.int32)
    yl = np.full((p,), ys.shape[1], np.int32) if ylens is None \
        else np.asarray(ylens, np.int32)
    folds = [query_moments(xs[i, :xl[i]]) for i in range(p)]
    scores, dists = _score.score_pairs(
        as_tensor(xs, _F32, dev), as_tensor(xl, _I32, dev),
        as_tensor(ys.T, _F32, dev), as_tensor(yl, _I32, dev),
        as_tensor([f[0] for f in folds], _F32, dev),
        as_tensor([f[1] for f in folds], _F32, dev), band)
    return (scores, dists) if return_distances else scores


@dataclasses.dataclass(frozen=True)
class DtwBankState:
    """Streaming DP state of one query against a padded [K, M] bank.

    Immutable: :func:`dtw_bank_extend` returns a new state.  ``row`` holds
    D[n-1, :] per reference (all 3e38 before the first sample); ``n`` is
    the number of query samples consumed so far.  The tensors live on one
    device, the one K7 runs on.
    """
    row: torch.Tensor                 # [K, M] f32
    n: int                            # samples consumed
    bank: torch.Tensor                # [K, M] f32
    lengths: torch.Tensor             # [K] i32
    band: Optional[int] = None
    query_len: Optional[int] = None   # required (and fixed) when banded

    def __len__(self) -> int:
        return int(self.bank.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row.device

    def distances(self) -> torch.Tensor:
        """D(n, len_k) against every *complete* reference -> [K]
        (banded: once n == query_len; 3e38 before any sample arrived)."""
        return self.row.gather(1, (self.lengths.long() - 1)[:, None])[:, 0]

    def prefix_distances(self) -> torch.Tensor:
        """Open-end distances min_j D(n, j) over true columns -> [K]:
        the best alignment of the consumed prefix against any prefix of
        each reference, non-decreasing in ``n``."""
        m = self.row.shape[1]
        cols = torch.arange(m, device=self.row.device)[None, :]
        masked = torch.where(cols < self.lengths[:, None], self.row, _INF)
        return masked.amin(dim=1)

    def dehydrate(self) -> Dict[str, np.ndarray]:
        """Host-resident dict of the full streaming state (numpy leaves,
        the reference's keys and layout); :meth:`hydrate` reverses it
        exactly, here or in the reference."""
        meta = np.asarray([self.n,
                           -1 if self.band is None else self.band,
                           -1 if self.query_len is None
                           else self.query_len], np.int64)
        return {"row": self.row.cpu().numpy(),
                "bank": self.bank.cpu().numpy(),
                "lengths": self.lengths.cpu().numpy(), "meta": meta}

    @staticmethod
    def hydrate(tree: Dict[str, np.ndarray],
                device: Device = None) -> "DtwBankState":
        """Rebuild a :class:`DtwBankState` on ``device`` from
        :meth:`dehydrate` output — the port's or the reference's.  The
        round trip is bitwise: every leaf is stored verbatim."""
        dev = resolve_device(device)
        n, band, qlen = (int(v) for v in np.asarray(tree["meta"]))
        return DtwBankState(
            row=as_tensor(tree["row"], _F32, dev), n=n,
            bank=as_tensor(tree["bank"], _F32, dev),
            lengths=as_tensor(tree["lengths"], _I32, dev),
            band=None if band < 0 else band,
            query_len=None if qlen < 0 else qlen)


def dtw_bank_init(bank, lengths=None, band: Optional[int] = None,
                  query_len: Optional[int] = None,
                  device: Device = None) -> DtwBankState:
    """Fresh streaming state for one query against a padded [K, M] bank
    on ``device``.  ``query_len`` (the expected total query length) is
    required for the banded variant: the Sakoe-Chiba corridor of row i is
    placed relative to the full query."""
    dev = resolve_device(device)
    bank = as_tensor(bank, _F32, dev)
    k, m = bank.shape
    if band is not None and query_len is None:
        raise ValueError("banded streaming needs query_len (the band "
                         "geometry depends on the full query length)")
    return DtwBankState(row=torch.full((k, m), _INF, dtype=_F32, device=dev),
                        n=0, bank=bank,
                        lengths=_matrix.lengths_or_full(lengths, k, m, dev),
                        band=band, query_len=query_len)


def dtw_bank_extend(state: DtwBankState, chunk, collect_rows: bool = False
                    ) -> Tuple[DtwBankState, Optional[torch.Tensor]]:
    """Consume one chunk of query samples; one K7 launch resumed from the
    state's row.

    Returns ``(new_state, rows)`` where ``rows`` is the [c, K, M] stack of
    DP rows produced by this chunk (a view of the kernel's [K, c, M]
    output) when ``collect_rows``, else None.  Any chunking reproduces
    the one-shot matrix bitwise: every cell is the same update."""
    dev = state.device
    chunk = as_tensor(chunk, _F32, dev).reshape(-1)
    c = int(chunk.shape[0])
    k, m = state.row.shape
    if c == 0:
        return state, (torch.zeros((0, k, m), dtype=_F32, device=dev)
                       if collect_rows else None)
    qlens = torch.full((k,), state.query_len or 0, dtype=_I32, device=dev)
    rows, last = _matrix.dtw_rows(chunk, state.bank, qlens, state.lengths,
                                  row=state.row, n0=state.n,
                                  band=state.band,
                                  collect_rows=collect_rows)
    new = dataclasses.replace(state, row=last, n=state.n + c)
    return new, (rows.transpose(0, 1) if collect_rows else None)


# ---------------------------------------------------------------------------
# Backtracking / warping (numpy on the host; O(N+M), data-dependent)
# ---------------------------------------------------------------------------

def backtrack(D) -> np.ndarray:
    """Minimum-distance path through D from (0, 0) to (N-1, M-1) ->
    int64 [P, 2] of (i, j) pairs, non-decreasing in both coordinates.

    The predecessor is the one ``np.argmin`` of (diag, vert, horiz)
    picks in the reference: the first minimum, or the first NaN.  It is
    written as comparisons on the three scalars, which pick the same
    cell several times faster than building an array for ``argmin``."""
    D = np.asarray(D)
    n, m = D.shape
    i, j = n - 1, m - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            a, b, c = D[i - 1, j - 1], D[i - 1, j], D[i, j - 1]
            if a != a or (a <= b and a <= c):
                i, j = i - 1, j - 1
            elif b != b or b <= c:
                i -= 1
            else:
                j -= 1
        path.append((i, j))
    return np.asarray(path[::-1], dtype=np.int64)


def warp_to(y: np.ndarray, path: np.ndarray, n: int) -> np.ndarray:
    """Build Y' (length n, aligned with X) from Y by repeating elements
    along the DTW path (paper §3.1.2: Y' is made from Y by repeating some
    of its elements based on D(X, Y))."""
    yp = np.empty(n, dtype=np.asarray(y).dtype)
    for i, j in path:          # path is sorted by i; later pairs overwrite
        yp[i] = y[j]
    return yp


def dtw_warp(x: np.ndarray, y: np.ndarray, band: Optional[int] = None,
             device: Device = None) -> Tuple[np.ndarray, float]:
    """Full pipeline: DTW (K7 on ``device``) -> host backtrack -> warped
    Y' and distance D(N, M)."""
    D = _pair_matrix(np.asarray(x, np.float32), np.asarray(y, np.float32),
                     band, device).cpu().numpy()
    path = backtrack(D)
    return warp_to(np.asarray(y), path, len(np.asarray(x))), float(D[-1, -1])
