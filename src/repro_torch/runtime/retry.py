"""Retry/backoff for transient dispatch failures.

A device dispatch in the serving hot path can fail transiently — a
kernel launch the CUDA runtime refused
(``kernels.common.KernelLaunchError``), an injected fault from
``runtime.chaos`` — and the service must degrade one tick, not die.
:func:`call_with_retry` wraps any callable with seeded exponential
backoff + jitter and an optional *fallback* callable tried once after
the retry budget is exhausted (the serving use: the same dispatch run
once more past the injected fault, so a degraded tick changes latency
but never decisions).

The policy is deterministic per seed (jitter comes from a private
``random.Random``) and the sleeper is injectable, so fault-injection
tests run at full speed with a no-op clock.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["CircuitBreaker", "DispatchFailure", "RetryPolicy",
           "call_with_retry"]


class DispatchFailure(RuntimeError):
    """A dispatch failed on every retry AND on the fallback (or there
    was no fallback).  ``__cause__`` carries the last underlying
    error."""


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff + jitter: attempt ``i`` (0-based retry) sleeps
    ``base_delay * 2**i * (1 + jitter * u)``, ``u ~ U[0, 1)`` from a
    seeded private stream — deterministic schedules for tests, decorrelated
    retries across a fleet in production."""

    max_retries: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.base_delay < 0 or self.max_delay < 0 or self.jitter < 0:
            raise ValueError("delays/jitter must be >= 0")
        self._rng = random.Random(self.seed)

    def delay(self, attempt: int) -> float:
        d = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        return d * (1.0 + self.jitter * self._rng.random())


def call_with_retry(fn: Callable, *, policy: RetryPolicy,
                    transient: Tuple[Type[BaseException], ...],
                    fallback: Optional[Callable] = None,
                    on_retry: Optional[Callable[[int, BaseException],
                                                None]] = None,
                    max_elapsed: Optional[float] = None,
                    clock: Callable[[], float] = time.monotonic):
    """Run ``fn()``; on a ``transient`` error retry up to
    ``policy.max_retries`` times with backoff, then try ``fallback()``
    once.  Returns ``(result, report)`` where ``report`` is a dict with
    ``retries`` (extra attempts consumed) and ``degraded`` (True when
    the fallback produced the result).  Non-transient errors propagate
    immediately; exhausting both paths raises :class:`DispatchFailure`.

    ``max_elapsed`` adds a total wall-clock deadline on top of the
    attempt budget: before sleeping for the next backoff, if
    ``clock() - start + delay`` would exceed the deadline, remaining
    retries are abandoned and the fallback is tried immediately.  The
    jitter stream is drawn exactly as without a deadline (the delay is
    computed, then discarded), so seeded schedules are unchanged
    whenever the deadline is not hit.
    """
    last: Optional[BaseException] = None
    start = clock() if max_elapsed is not None else 0.0
    retries = 0
    for attempt in range(policy.max_retries + 1):
        try:
            return fn(), {"retries": attempt, "degraded": False}
        except transient as e:        # noqa: PERF203 - retry loop
            last = e
            retries = attempt
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt < policy.max_retries:
                d = policy.delay(attempt)
                if (max_elapsed is not None
                        and clock() - start + d > max_elapsed):
                    break
                policy.sleep(d)
    else:
        retries = policy.max_retries
    if fallback is not None:
        try:
            return fallback(), {"retries": retries + 1,
                                "degraded": True}
        except transient as e:
            last = e
    raise DispatchFailure(
        f"dispatch failed after {retries + 1} attempts"
        + ("" if fallback is None else " + fallback")) from last


class CircuitBreaker:
    """Closed/open/half-open breaker around a primary (kernel) dispatch
    path with a pinned-equivalent fallback.

    The one-shot fallback degrades a single dispatch; under a
    *persistent* fault every tick still pays the full retry ladder
    before falling back.  The breaker remembers: after
    ``fail_threshold`` consecutive primary failures it OPENS and serves
    the fallback directly (no primary attempt, no retry ladder).  After
    ``cooldown`` fallback-served dispatches it goes HALF-OPEN and
    probes the primary at seeded intervals — one un-retried attempt per
    probe.  A successful probe re-closes the breaker (kernel path
    re-promoted); a failed probe re-opens it.  Because primary and
    fallback are bit-identical by construction, the breaker changes
    latency and counters, never decisions.

    State is JSON-serialisable via :meth:`state_dict` /
    :meth:`load_state` so a snapshot of a degraded service restores
    with the breaker still tripped.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, fail_threshold: int = 3, cooldown: int = 8,
                 probe_interval: int = 4, seed: int = 0):
        if fail_threshold < 1 or cooldown < 1 or probe_interval < 1:
            raise ValueError("breaker thresholds must be >= 1")
        self.fail_threshold = int(fail_threshold)
        self.cooldown = int(cooldown)
        self.probe_interval = int(probe_interval)
        self.seed = int(seed)
        self._rng = random.Random(seed)
        self.state = self.CLOSED
        self._fails = 0            # consecutive primary failures (closed)
        self._since_open = 0       # fallback dispatches since opening
        self._until_probe = 0      # half-open: dispatches until next probe
        self.opened_count = 0      # times the breaker tripped
        self.reclosed_count = 0    # times a probe re-promoted the kernel

    # -- decision -------------------------------------------------------
    def before_dispatch(self) -> str:
        """Route the next dispatch: ``"primary"`` (normal path, retries
        apply), ``"fallback"`` (skip the primary entirely) or
        ``"probe"`` (single un-retried primary attempt)."""
        if self.state == self.CLOSED:
            return "primary"
        if self.state == self.OPEN:
            self._since_open += 1
            if self._since_open >= self.cooldown:
                self.state = self.HALF_OPEN
                self._until_probe = self._rng.randint(1, self.probe_interval)
            return "fallback"
        # HALF_OPEN: count down to the next seeded probe slot.
        self._until_probe -= 1
        if self._until_probe <= 0:
            return "probe"
        return "fallback"

    # -- outcomes -------------------------------------------------------
    def record_success(self) -> None:
        """Primary (or probe) dispatch succeeded."""
        if self.state == self.HALF_OPEN:
            self.reclosed_count += 1
        self.state = self.CLOSED
        self._fails = 0
        self._since_open = 0
        self._until_probe = 0

    def record_failure(self) -> None:
        """Primary (or probe) dispatch exhausted its attempts."""
        if self.state == self.HALF_OPEN:
            self.state = self.OPEN
            self.opened_count += 1
            self._since_open = 0
            return
        self._fails += 1
        if self._fails >= self.fail_threshold:
            self.state = self.OPEN
            self.opened_count += 1
            self._fails = 0
            self._since_open = 0

    @property
    def engaged(self) -> bool:
        """True while the kernel path is demoted (open or half-open)."""
        return self.state != self.CLOSED

    # -- persistence ----------------------------------------------------
    def state_dict(self) -> dict:
        st = self._rng.getstate()
        return {"state": self.state, "fails": self._fails,
                "since_open": self._since_open,
                "until_probe": self._until_probe,
                "opened_count": self.opened_count,
                "reclosed_count": self.reclosed_count,
                "rng": [st[0], list(st[1]), st[2]]}

    def load_state(self, st: dict) -> None:
        self.state = str(st["state"])
        self._fails = int(st["fails"])
        self._since_open = int(st["since_open"])
        self._until_probe = int(st["until_probe"])
        self.opened_count = int(st["opened_count"])
        self.reclosed_count = int(st["reclosed_count"])
        r = st["rng"]
        self._rng.setstate((r[0], tuple(r[1]), r[2]))
