#!/usr/bin/env python3
"""On-card smoke test of ``repro_torch``, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. print the card and build the CUDA kernels from ``src/repro_torch``
   (``nvcc``, ``sm_90a``);
2. hold K1, the scored streaming tick, against its plain PyTorch version
   on the card: bitwise on dyadic-grid data, and on smooth data within
   the stated tolerance;
3. the same for K2, the verdict scorer;
4. the paper scenario: the exact point-mode ``TuningService`` matches
   exim traces against a wordcount/terasort bank while they run; every
   final verdict must be ``wordcount`` and every early decision must
   come at the reference's fraction;
5. the full-width run: S=256 in-flight jobs against a K=256 bank (M=360)
   for 24 ticks of 16 samples, then one batched verdict of 32 jobs,
   through both kernels (launch counts checked against the service's
   dispatch counters), one tick held against the plain version, and
   each kernel timed beside its plain version and its bound.

It prints the kernel table as one JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It needs no network
and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: Tolerances of the kernel-vs-plain checks.  Both sides do the same
#: IEEE float32 operations per cell (the kernels are built without FMA
#: contraction), so every check is expected to be exact; the smooth-data
#: tolerance only allows for a rounding difference in the score tail.
DYADIC_TOL = 0.0
SMOOTH_TOL = 1e-5

#: Early-decision fractions of the reference on the paper scenario
#: (BENCH_streaming.json rows stream_early_p0..p3).
REF_EARLY = (0.44, 0.50, 0.47, 0.75)

#: f32 arithmetic and compare operations per DP cell in csrc/dtw_sweep.cuh
#: (cost: sub, abs; recurrence: 3 min, add; selection: min, 2 compares;
#: moments: 6 adds, 2 muls), selects not counted.
OPS_PER_CELL = 17


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def card_peaks(name: str):
    """(memory bytes/s, f32 FLOP/s) of the named card (NVIDIA data
    sheets; the SXM part's figures for an unrecognised H100)."""
    if "PCIe" in name:
        return 2.0e12, 51.2e12
    if "NVL" in name:
        return 3.9e12, 60.0e12
    return 3.35e12, 67.0e12


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (after one warm-up
    call), from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class ErrLog:
    """Largest absolute kernel-vs-plain difference seen per kernel."""

    def __init__(self) -> None:
        self.err = {"K1": 0.0, "K2": 0.0}

    def diff(self, kernel: str, got: torch.Tensor, want: torch.Tensor,
             mask=None) -> float:
        g, w = got.double(), want.double()
        if mask is not None:
            g, w = g[mask], w[mask]
        e = float((g - w).abs().max()) if g.numel() else 0.0
        self.err[kernel] = max(self.err[kernel], e)
        return e


def _series(rng, n: int, dyadic: bool) -> np.ndarray:
    if dyadic:
        return (rng.integers(0, 9, n) / 8.0).astype(np.float32)
    t = np.linspace(0, 1, n)
    return np.clip(0.5 + 0.3 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
                   + 0.05 * rng.normal(size=n), 0, 1).astype(np.float32)


def _bank(rng, k: int, lo: int, hi: int, dyadic: bool):
    from repro_torch.core.database import pack_series
    return pack_series([_series(rng, int(rng.integers(lo, hi + 1)), dyadic)
                        for _ in range(k)])


def check_k1(dev, errs: ErrLog) -> None:
    """K1 against its plain version: ragged banks (K not a multiple of the
    block), ragged nvalid including 0, band None and 6, chunk widths 8,
    16 and 32 (32 takes two passes), four consecutive ticks each."""
    from repro_torch.core import dtw
    from repro_torch.kernels.dtw import stream
    cases = [(dy, band, c) for dy in (True, False) for band in (None, 6)
             for c in (8, 16, 32)]
    for i, (dyadic, band, c) in enumerate(cases):
        rng = np.random.default_rng(100 + i)
        s, k = 5, 133
        bank = _bank(rng, k, 12, 60, dyadic)
        m = bank.series.shape[1]
        bank_t = torch.tensor(bank.series.T.copy(), device=dev)
        lengths = torch.tensor(bank.lengths, device=dev)
        qlens = torch.full((s,), 4 * c, dtype=torch.int32, device=dev)
        state = dtw.tick_state_from_numpy(
            np.full((s, m, k), dtw._INF, np.float32),
            np.zeros((3, s, m, k), np.float32), np.zeros(s, np.int32),
            np.zeros(s, np.float32), np.zeros(s, np.float32), dev)
        st_k, st_p = state, tuple(t.clone() for t in state)
        tol = DYADIC_TOL if dyadic else SMOOTH_TOL
        for tick in range(4):
            nv = rng.integers(0, c + 1, size=s).astype(np.int32)
            nv[tick % s] = 0
            nv[(tick + 1) % s] = c
            ch = np.stack([_series(rng, c, dyadic) for _ in range(s)])
            args = (bank_t, lengths, torch.tensor(ch, device=dev),
                    torch.tensor(nv, device=dev), qlens)
            before = stream.LIB.launches
            out_k = dtw.bank_extend_tick_scored_dispatch(*st_k, *args,
                                                         band=band)
            out_p = dtw.bank_extend_tick_scored(*st_p, *args, band=band)
            torch.cuda.synchronize()
            assert stream.LIB.launches == before + 1, "K1 did not launch"
            fin = out_p[0] < 1e37
            assert torch.equal(fin, out_k[0] < 1e37), \
                f"K1 case {i} tick {tick}: saturated cells differ"
            e = max(errs.diff("K1", out_k[0], out_p[0], fin),
                    errs.diff("K1", out_k[1], out_p[1],
                              fin[None].expand_as(out_p[1])),
                    errs.diff("K1", out_k[5], out_p[5]))
            for a, b in zip(out_k[2:5], out_p[2:5]):
                assert torch.equal(a, b), "K1: ns/sx/sxx differ"
            assert e <= tol, (f"K1 case {i} (dyadic={dyadic}, band={band},"
                              f" C={c}) tick {tick}: max abs err {e}")
            st_k, st_p = out_k[:5], out_p[:5]
        print(f"[K1] dyadic={dyadic!s:5} band={band!s:4} C={c:2d}: "
              f"4 ticks agree (max abs err {errs.err['K1']:.3g}, "
              f"tol {tol:g})")


def check_k2(dev, errs: ErrLog) -> None:
    """K2 against its plain version: ragged banks, ragged query lengths
    (0, 1, < N and N), one-pass (N <= 16) and multi-pass queries, band
    None and 6."""
    from repro_torch.core import dtw
    from repro_torch.kernels.dtw import score
    cases = [(dy, band, n) for dy in (True, False) for band in (None, 6)
             for n in (12, 70)]
    for i, (dyadic, band, n) in enumerate(cases):
        rng = np.random.default_rng(200 + i)
        j, k = 6, 133
        bank = _bank(rng, k, 10, 60, dyadic)
        xlens = np.asarray([0, 1, n, n - 3, n // 2, 2], np.int32)
        xs = np.zeros((j, n), np.float32)
        for q, l in enumerate(xlens):
            xs[q, :l] = _series(rng, int(l), dyadic)
        folds = [dtw.query_moments(xs[q, :xlens[q]]) for q in range(j)]
        args = (torch.tensor(xs, device=dev),
                torch.tensor(xlens, device=dev),
                torch.tensor(bank.series.T.copy(), device=dev),
                torch.tensor(bank.lengths, device=dev),
                torch.tensor([f[0] for f in folds], device=dev),
                torch.tensor([f[1] for f in folds], device=dev))
        before = score.LIB.launches
        sk, dk = score.score_bank_offline(*args, band=band)
        sp, dp = score.score_bank_offline_plain(*args, band=band)
        torch.cuda.synchronize()
        assert score.LIB.launches == before + 1, "K2 did not launch"
        e = max(errs.diff("K2", sk, sp), errs.diff("K2", dk, dp))
        tol = DYADIC_TOL if dyadic else SMOOTH_TOL
        assert e <= tol, (f"K2 case {i} (dyadic={dyadic}, band={band}, "
                          f"N={n}): max abs err {e}")
        print(f"[K2] dyadic={dyadic!s:5} band={band!s:4} N={n:2d}: "
              f"scores and distances agree (max abs err {e:.3g}, "
              f"tol {tol:g})")


def paper_scenario(dev) -> list:
    """The reference's paper scenario (benchmarks/bench_streaming.py):
    exim traces matched WHILE they run against a preprocessed
    wordcount/terasort bank (2 apps x 4 parameter sets), monitored at
    4 Hz in 8-sample chunks."""
    from repro_torch import mrsim
    from repro_torch.core.database import SeriesBank, pack_series
    from repro_torch.core.filters import preprocess_bank
    from repro_torch.kernels.dtw import score, stream
    from repro_torch.serve.tuning import TuningService
    dt = 0.25
    series, labels = [], []
    for app in ("wordcount", "terasort"):
        for p in mrsim.paper_param_sets():
            series.append(mrsim.simulate_cpu_series(app, p, dt=dt))
            labels.append(app)
    packed = pack_series(series, labels=labels)
    bank = SeriesBank(preprocess_bank(packed.series, packed.lengths),
                      packed.lengths, packed.labels)
    fractions = []
    for j, p in enumerate(mrsim.paper_param_sets()):
        svc = TuningService(bank, band=16, threshold=0.85, margin=0.02,
                            stable_ticks=3, min_fraction=0.15,
                            denoise=True, device=dev)
        q = mrsim.simulate_cpu_series("exim", p, run=1, dt=dt)
        stream.LIB.launches = score.LIB.launches = 0
        svc.submit("exim", expected_len=len(q))
        early = None
        for chunk in mrsim.iter_cpu_series("exim", p, run=1, chunk=8,
                                           dt=dt):
            svc.push("exim", chunk)
            d = svc.tick().get("exim")
            early = early or d
        final = svc.finish("exim")
        assert (stream.LIB.launches, score.LIB.launches) == \
            (svc.dispatch_count, svc.offline_dispatch_count) == \
            (svc.ticks, 1), "paper scenario did not run on the kernels"
        frac = early.fraction_seen if early is not None else 1.0
        print(f"[paper] pset{j}: early={early.matched if early else None}"
              f"@{frac:.2f} (reference {REF_EARLY[j]:.2f}) "
              f"final={final.matched} wc={final.scores['wordcount']:.4f} "
              f"ts={final.scores['terasort']:.4f}")
        assert final.matched == "wordcount", final.scores
        assert early is not None and early.matched == "wordcount"
        fractions.append(round(frac, 2))
    assert tuple(fractions) == REF_EARLY, \
        f"early fractions {fractions} != reference {REF_EARLY}"
    return fractions


def throughput_bank(rng, k: int):
    """The reference's throughput bank (bench_streaming._throughput_bank):
    K sinusoid+noise references with lengths drawn from six buckets up to
    360 samples."""
    from repro_torch.core.database import pack_series
    buckets = (180, 220, 256, 300, 330, 360)
    series = []
    for i in range(k):
        n = buckets[int(rng.integers(len(buckets)))]
        t = np.linspace(0, 1, n, dtype=np.float32)
        s = (0.5 + 0.3 * np.sin(2 * np.pi * (2 + i % 5) * t)
             + 0.1 * rng.normal(size=n).astype(np.float32))
        series.append(np.clip(s, 0, 1).astype(np.float32))
    return pack_series(series, labels=[f"w{i % 16}" for i in range(k)])


def full_width(dev, errs: ErrLog, name: str, s_jobs: int = 256,
               k: int = 256, n_fin: int = 32, seed: int = 0) -> list:
    """S=256 jobs x K=256 references (M=360), 24 ticks of 16 samples,
    then one batched verdict of 32 jobs; returns the kernel table rows."""
    from repro_torch.core import dtw
    from repro_torch.kernels.dtw import score, stream
    from repro_torch.serve.tuning import TuningService
    c, n_ticks = 16, 24
    rng = np.random.default_rng(seed)
    bank = throughput_bank(rng, k)
    m = bank.series.shape[1]
    assert m == 360, m
    qlen = n_ticks * c
    queries = np.stack([np.clip(
        0.5 + 0.3 * np.sin(2 * np.pi * rng.uniform(1, 7)
                           * np.linspace(0, 1, qlen))
        + 0.1 * rng.normal(size=qlen), 0, 1) for _ in range(s_jobs)]
    ).astype(np.float32)
    svc = TuningService(bank, slots=s_jobs, device=dev)
    for i in range(s_jobs):
        svc.submit(f"job{i}", expected_len=qlen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stream.LIB.launches = score.LIB.launches = 0
    tick_s = []
    for t in range(n_ticks):
        for i in range(s_jobs):
            svc.push(f"job{i}", queries[i, t * c:(t + 1) * c])
        if t == n_ticks // 2:
            slot_of = [svc._jobs[f"job{i}"].slot for i in range(s_jobs)]
            snap = (svc._rows.clone(), svc._moms.clone(), svc._ns.clone(),
                    svc._sx.clone(), svc._sxx.clone())
        t0 = time.perf_counter()
        svc.tick()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        if t == n_ticks // 2:
            after = (svc._rows.clone(), svc._moms.clone(),
                     np.stack([svc._jobs[f"job{i}"].last_sims
                               for i in range(s_jobs)]))
    fin_ids = [f"job{i}" for i in range(n_fin)]
    t0 = time.perf_counter()
    verdicts = svc.finish_many(fin_ids)
    verdict_s = time.perf_counter() - t0
    launches = (stream.LIB.launches, score.LIB.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    in_use_gb = torch.cuda.memory_allocated() / 1e9
    assert launches == (svc.dispatch_count, svc.offline_dispatch_count), \
        (launches, svc.dispatch_count, svc.offline_dispatch_count)
    assert launches == (n_ticks, 1), launches
    for v in verdicts.values():
        assert np.isfinite(v.corr) and len(v.scores) == 16
    ms_tick = 1e3 * float(np.median(tick_s))
    print(f"[full] {s_jobs} jobs x K={k} x M={m}, C={c}: median "
          f"{ms_tick:.3f} ms/tick over {n_ticks} ticks (first "
          f"{1e3 * tick_s[0]:.3f} ms); verdict of {n_fin} jobs "
          f"{1e3 * verdict_s:.3f} ms; device memory in use "
          f"{in_use_gb:.3f} GB, peak {peak_gb:.3f} GB; "
          f"launches K1={launches[0]} K2={launches[1]} [{name}]")

    # one full-width tick against the plain version on the same inputs
    t = n_ticks // 2
    chunks = torch.zeros((svc.slot_capacity, c), device=dev)
    for i in range(s_jobs):
        chunks[slot_of[i]] = torch.tensor(queries[i, t * c:(t + 1) * c])
    nvalid = torch.full((s_jobs,), c, dtype=torch.int32, device=dev)
    qlens = torch.full((s_jobs,), qlen, dtype=torch.int32, device=dev)
    plain = dtw.bank_extend_tick_scored(*snap, svc._bank_t, svc._lengths,
                                        chunks, nvalid, qlens)
    fin = plain[0] < 1e37
    assert torch.equal(fin, after[0] < 1e37)
    sims = torch.tensor(after[2], device=dev)
    e = max(errs.diff("K1", after[0], plain[0], fin),
            errs.diff("K1", after[1], plain[1], fin[None].expand_as(plain[1])),
            errs.diff("K1", sims, plain[5][slot_of]))
    assert e <= SMOOTH_TOL, f"full-width tick: max abs err {e}"
    print(f"[full] tick {t} held against the plain version: max abs err "
          f"{e:.3g} (tol {SMOOTH_TOL:g})")

    # timings at the main path's shapes, kernel beside plain version
    mem_bps, f32_flops = card_peaks(name)
    args1 = (*snap[:3], svc._bank_t, svc._lengths, chunks, nvalid, qlens)
    k1_ms = cuda_ms(lambda: stream.stream_bank_extend_scored(*args1), 20)
    k1_plain = cuda_ms(lambda: stream.stream_bank_extend_scored_plain(
        *args1), 2)
    cells1 = int(nvalid.sum()) * m * k
    bytes1 = 2 * 4 * 4 * s_jobs * m * k + 4 * (m * k + k + s_jobs * c
                                               + 3 * s_jobs)
    b1 = (1e3 * bytes1 / mem_bps, 1e3 * OPS_PER_CELL * cells1 / f32_flops)
    queries_fin = [queries[i] for i in range(n_fin)]
    npad = dtw._pad_pow2(qlen)
    xs = torch.zeros((n_fin, npad), device=dev)
    xs[:, :qlen] = torch.tensor(np.stack(queries_fin))
    xlens = torch.full((n_fin,), qlen, dtype=torch.int32, device=dev)
    folds = [dtw.query_moments(q) for q in queries_fin]
    sx = torch.tensor([f[0] for f in folds], device=dev)
    sxx = torch.tensor([f[1] for f in folds], device=dev)
    args2 = (xs, xlens, svc._bank_t, svc._lengths, sx, sxx)
    sk, dk = score.score_bank_offline(*args2)
    sp, dp = score.score_bank_offline_plain(*args2)
    e2 = max(errs.diff("K2", sk, sp), errs.diff("K2", dk, dp))
    assert e2 <= SMOOTH_TOL, f"full-width verdict: max abs err {e2}"
    # the service's verdicts are the per-workload maxima of K2's scores
    labels = np.asarray(bank.labels)
    for i in range(n_fin):
        row = sk[i].double().cpu().numpy()
        for w, v in verdicts[f"job{i}"].scores.items():
            assert v == row[labels == w].max(), (i, w)
    k2_ms = cuda_ms(lambda: score.score_bank_offline(*args2), 5)
    k2_plain = cuda_ms(lambda: score.score_bank_offline_plain(*args2), 1)
    cells2 = int(xlens.sum()) * int(svc._lengths.sum())
    bytes2 = 4 * (n_fin * npad + 3 * n_fin + m * k + k + 2 * n_fin * k)
    b2 = (1e3 * bytes2 / mem_bps, 1e3 * OPS_PER_CELL * cells2 / f32_flops)
    print(f"[full] K1 {k1_ms:.4f} ms (plain {k1_plain:.2f} ms, bound "
          f"{max(b1):.4f} ms); K2 {k2_ms:.4f} ms (plain {k2_plain:.2f} ms,"
          f" bound {max(b2):.4f} ms) [{name}]")
    return [
        dict(name="K1 scored streaming tick", route="cuda",
             source="src/repro_torch/kernels/dtw/csrc/stream.cu",
             replaces="src/repro/kernels/dtw/stream.py:136",
             launches=launches[0], max_abs_err=errs.err["K1"], ms=k1_ms,
             plain_ms=k1_plain, bound_ms=max(b1),
             bound_by="bytes" if b1[0] >= b1[1] else "operations",
             library_ms=None),
        dict(name="K2 verdict scorer", route="cuda",
             source="src/repro_torch/kernels/dtw/csrc/score.cu",
             replaces="src/repro/kernels/dtw/score.py:42",
             launches=launches[1], max_abs_err=errs.err["K2"], ms=k2_ms,
             plain_ms=k2_plain, bound_ms=max(b2),
             bound_by="bytes" if b2[0] >= b2[1] else "operations",
             library_ms=None),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import common
    from repro_torch.kernels.dtw import score, stream
    name = card_line()
    print(f"[card] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    common.build([stream.LIB, score.LIB])
    print(f"[build] both kernels in {time.perf_counter() - t0:.1f} s")
    for lib in (stream.LIB, score.LIB):
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib.name}: {line.strip()}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = ErrLog()
    check_k1(dev, errs)
    check_k2(dev, errs)
    paper_scenario(dev)
    rows = full_width(dev, errs, name)
    print(json.dumps({"kernels": rows}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
