"""MapReduce CPU-utilization trace simulator.

Hadoop itself is out of scope for this reproduction, so the paper's
Table-1 experiment (WordCount / TeraSort / Exim-mainlog similarity) is
evaluated on traces generated with the same structure the paper measures:
a map phase executed in waves (``ceil(ceil(I/FS) / M)`` waves of task
sawtooth), a shuffle valley, and a reduce phase — with per-application CPU
intensities.  WordCount and Exim parsing are both per-line text tokenisers
(map-heavy, high CPU, small intermediate data); TeraSort is a sort
(IO-heavy map, long shuffle, merge-heavy reduce).  Measurement noise is
additive Gaussian plus occasional scheduler spikes, seeded per
(app, params) so experiments are deterministic.

The knobs are exactly the paper's four configuration parameters: number of
mappers M, number of reducers R, file-split size FS (MB), input size I (MB).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["AppProfile", "APPS", "JobParams", "simulate_cpu_series",
           "simulate_cpu_series_uncertain", "iter_cpu_series",
           "paper_param_sets"]


@dataclasses.dataclass(frozen=True)
class AppProfile:
    name: str
    map_cpu: float          # plateau CPU utilization during a map wave
    map_cost: float         # seconds of map work per MB per task slot
    shuffle_cpu: float      # CPU level during shuffle
    shuffle_ratio: float    # intermediate-data size relative to input
    reduce_cpu: float       # plateau CPU during reduce
    reduce_cost: float      # seconds of reduce work per MB of intermediate
    ramp: float             # seconds to ramp a wave up/down
    burstiness: float       # amplitude of within-wave oscillation


#: Three applications from the paper (§5).  WordCount and Exim share the
#: text-parse profile family; TeraSort is sort/shuffle dominated.
APPS: Dict[str, AppProfile] = {
    "wordcount": AppProfile("wordcount", map_cpu=0.88, map_cost=0.55,
                            shuffle_cpu=0.30, shuffle_ratio=0.18,
                            reduce_cpu=0.62, reduce_cost=0.65, ramp=3.0,
                            burstiness=0.06),
    "exim":      AppProfile("exim",      map_cpu=0.84, map_cost=0.60,
                            shuffle_cpu=0.33, shuffle_ratio=0.22,
                            reduce_cpu=0.58, reduce_cost=0.70, ramp=3.5,
                            burstiness=0.07),
    "terasort":  AppProfile("terasort",  map_cpu=0.46, map_cost=0.35,
                            shuffle_cpu=0.24, shuffle_ratio=1.0,
                            reduce_cpu=0.78, reduce_cost=1.25, ramp=5.0,
                            burstiness=0.12),
}


@dataclasses.dataclass(frozen=True)
class JobParams:
    """The paper's configuration parameters."""
    mappers: int      # M
    reducers: int     # R
    split_mb: int     # FS
    input_mb: int     # I

    def as_dict(self) -> Dict[str, int]:
        return {"M": self.mappers, "R": self.reducers,
                "FS": self.split_mb, "I": self.input_mb}


def paper_param_sets() -> List[JobParams]:
    """The four parameter sets of paper Table 1."""
    return [JobParams(11, 6, 20, 30), JobParams(21, 30, 10, 80),
            JobParams(32, 21, 30, 80), JobParams(42, 33, 20, 60)]


def _seed_for(app: str, p: JobParams, run: int) -> int:
    h = hashlib.sha256(f"{app}|{p}|{run}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def _wave(t: np.ndarray, start: float, dur: float, level: float,
          ramp: float, burst: float, freq: float, phase: float) -> np.ndarray:
    """A trapezoidal task wave with within-wave oscillation."""
    up = np.clip((t - start) / max(ramp, 1e-6), 0.0, 1.0)
    down = np.clip((start + dur - t) / max(ramp, 1e-6), 0.0, 1.0)
    env = np.minimum(up, down)
    osc = 1.0 + burst * np.sin(2 * np.pi * freq * (t - start) + phase)
    return level * env * osc


def simulate_cpu_series(app: str, params: JobParams, *, run: int = 0,
                        dt: float = 1.0, noise: float = 0.03) -> np.ndarray:
    """1 Hz CPU-utilization series for one job execution (values in [0,1])."""
    prof = APPS[app]
    rng = np.random.default_rng(_seed_for(app, params, run))

    tasks = max(1, int(np.ceil(params.input_mb / params.split_mb)))
    waves = max(1, int(np.ceil(tasks / params.mappers)))
    slots_last = tasks - (waves - 1) * params.mappers
    wave_dur = max(6.0, prof.map_cost * params.split_mb
                   * min(tasks, params.mappers) / max(params.mappers, 1)
                   + 2.0 * prof.ramp)
    gap = 0.25 * prof.ramp

    inter_mb = prof.shuffle_ratio * params.input_mb
    shuffle_dur = max(4.0, 0.15 * inter_mb + 0.2 * params.reducers)
    reduce_dur = max(6.0, prof.reduce_cost * inter_mb / max(params.reducers, 1)
                     + 2.0 * prof.ramp)

    total = waves * (wave_dur + gap) + shuffle_dur + reduce_dur + 10.0
    t = np.arange(0.0, total, dt)
    u = np.full_like(t, 0.04)                      # daemon background load

    # map waves
    cursor = 2.0
    for w in range(waves):
        frac = 1.0 if w < waves - 1 else slots_last / min(tasks, params.mappers)
        level = prof.map_cpu * (0.55 + 0.45 * frac)
        u += _wave(t, cursor, wave_dur, level, prof.ramp, prof.burstiness,
                   freq=0.08 + 0.01 * (w % 3), phase=rng.uniform(0, 2 * np.pi))
        cursor += wave_dur + gap

    # shuffle valley (network/disk bound)
    u += _wave(t, cursor, shuffle_dur, prof.shuffle_cpu, prof.ramp,
               0.5 * prof.burstiness, freq=0.05, phase=rng.uniform(0, 2 * np.pi))
    cursor += shuffle_dur

    # reduce phase
    u += _wave(t, cursor, reduce_dur, prof.reduce_cpu, prof.ramp,
               prof.burstiness, freq=0.06, phase=rng.uniform(0, 2 * np.pi))

    # measurement noise + occasional scheduler spikes
    u += rng.normal(0.0, noise, size=u.shape)
    spikes = rng.random(u.shape) < 0.01
    u = np.where(spikes, u + rng.uniform(0.1, 0.3, size=u.shape), u)
    return np.clip(u, 0.0, 1.0).astype(np.float32)


def simulate_cpu_series_uncertain(app: str, params: JobParams, *,
                                  run: int = 0, dt: float = 1.0,
                                  noise: float = 0.03
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Heteroscedastic-noise twin of :func:`simulate_cpu_series` ->
    ``(series, variance)``, both float32 [N].

    The per-sample noise standard deviation is not constant: a slow
    seeded envelope modulates it between ``0.25 * noise`` (a quiet
    monitoring agent) and ``~1.75 * noise`` (a contended one), the shape
    real SysStat pollers show when the node they share is loaded.  The
    returned ``variance`` is the TRUE per-sample noise variance (the
    envelope squared), what an uncertain-series matcher should be fed.
    Its own RNG stream (seed namespace ``"het|"``) leaves
    :func:`simulate_cpu_series` untouched.
    """
    clean = simulate_cpu_series(app, params, run=run, dt=dt, noise=0.0)
    n = clean.shape[0]
    h = hashlib.sha256(f"het|{app}|{params}|{run}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(h[:4], "little"))
    # slow envelope: a few random-phase sinusoids, normalized to
    # [0.25, ~1.75] x noise.
    t = np.arange(n, dtype=np.float64)
    env = np.zeros(n)
    for _ in range(3):
        f = rng.uniform(0.002, 0.02)
        env += rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * f * t
                                              + rng.uniform(0, 2 * np.pi))
    env = 0.25 + 1.5 * (env - env.min()) / max(float(np.ptp(env)), 1e-9)
    std = noise * env
    u = clean.astype(np.float64) + rng.normal(0.0, 1.0, size=n) * std
    var = (std * std).astype(np.float32)
    return np.clip(u, 0.0, 1.0).astype(np.float32), var


def iter_cpu_series(app: str, params: JobParams, *, run: int = 0,
                    chunk: int = 16, dt: float = 1.0, noise: float = 0.03):
    """Stream one job's CPU series in arrival order, ``chunk`` samples at a
    time (the last chunk may be shorter).

    This is the monitoring-agent view of :func:`simulate_cpu_series` — what
    a SysStat poller hands the online matching service tick by tick while
    the job executes.  Identical values and determinism: concatenating the
    chunks reproduces ``simulate_cpu_series(...)`` exactly.
    """
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    s = simulate_cpu_series(app, params, run=run, dt=dt, noise=noise)
    for lo in range(0, s.shape[0], chunk):
        yield s[lo: lo + chunk]
