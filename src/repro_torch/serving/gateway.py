"""Fault-tolerant serving gateway over a ``SHRKS`` container, counterpart
of ``repro.serving.gateway``.

:class:`FaultTolerantGateway` fronts a :class:`RangeQueryBatcher`
(degraded mode on) on the batcher's device, with every knob injectable:

* **retry**: :class:`RetryPolicy`, exponential backoff with jitter on an
  injected clock, sleep and ``random.Random(seed)`` (drawn in the
  reference's order).  Only :class:`TransientError` is retried;
  corruption errors are permanent facts about bytes.
* **circuit breaker**: :class:`CircuitBreaker`, keyed per frame, with a
  half-open trial after ``recovery_s``.
* **deadlines**: ``serve(q, deadline_s=...)`` checks the clock before
  every decode attempt and every backoff sleep
  (:class:`DeadlineExceededError`).
* **backpressure**: beyond ``max_queue`` pending requests a query is shed
  to ``coarse_eps`` (flagged ``degraded``) or rejected with
  :class:`BackpressureError`.

An answer is assembled on the batcher's device (a float64 tensor in
``q.result``) from each frame's decoded prefix, with no read-back per
frame.  ``gw.frame_decode`` is the per-(frame, eps) decode step, the
hook that tests and ``--mode chaos`` wrap in a
:class:`repro_torch.testing.chaos.FlakyCallable`.
"""
from __future__ import annotations

import dataclasses
import random
import time
from collections import deque
from typing import Callable, Optional

import torch

from ..core.errors import (
    BackpressureError,
    CircuitOpenError,
    DeadlineExceededError,
    RangeCoverageError,
    ShrinkError,
    TransientError,
)
from .batching import RangeQuery, RangeQueryBatcher

__all__ = ["RetryPolicy", "CircuitBreaker", "FaultTolerantGateway"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter: attempt k (0-based) sleeps
    ``min(base * multiplier**k, max_delay) * (1 ± jitter)``."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.25  # fraction of the delay, uniform both ways

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_delay_s * self.multiplier**attempt, self.max_delay_s)
        return max(0.0, d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)))


class CircuitBreaker:
    """Per-key consecutive-failure breaker with a half-open recovery trial.

    ``failure_threshold`` consecutive failures open the circuit for
    ``recovery_s`` (on the injected clock); the first call after the
    window is allowed through as a trial — success closes the circuit,
    failure re-opens it for another window."""

    def __init__(
        self,
        failure_threshold: int = 3,
        recovery_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.recovery_s = recovery_s
        self._clock = clock
        self._failures: dict = {}
        self._opened_at: dict = {}

    def allow(self, key) -> bool:
        opened = self._opened_at.get(key)
        if opened is None:
            return True
        if self._clock() - opened >= self.recovery_s:
            # half-open: let one trial through; a failure re-opens
            del self._opened_at[key]
            self._failures[key] = self.failure_threshold - 1
            return True
        return False

    def record_success(self, key) -> None:
        self._failures.pop(key, None)
        self._opened_at.pop(key, None)

    def record_failure(self, key) -> None:
        n = self._failures.get(key, 0) + 1
        self._failures[key] = n
        if n >= self.failure_threshold:
            self._opened_at[key] = self._clock()

    def is_open(self, key) -> bool:
        opened = self._opened_at.get(key)
        return opened is not None and self._clock() - opened < self.recovery_s


class FaultTolerantGateway:
    """Hardened range-query service: bounded admission, retries with
    backoff, per-frame circuit breaking, deadlines, scoped degradation.
    ``device`` is the batcher's (default the card)."""

    def __init__(
        self,
        blob: bytes,
        retry: RetryPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        max_queue: int = 256,
        coarse_eps: Optional[float] = float("inf"),
        cache_frames: int = 32,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] | None = None,
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.batcher = RangeQueryBatcher(
            blob, cache_frames=cache_frames, degraded_ok=True, device=device
        )
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = (
            breaker if breaker is not None else CircuitBreaker(clock=clock)
        )
        self.max_queue = max_queue
        self.coarse_eps = coarse_eps
        self._clock = clock
        self._sleep = sleep if sleep is not None else time.sleep
        self._rng = random.Random(seed)
        self.queue: deque[RangeQuery] = deque()
        self._shed_qids: set[int] = set()
        self.completed: list[RangeQuery] = []
        # the injectable decode step: chaos tests wrap this in a
        # FlakyCallable to make it raise TransientError / run slow
        self.frame_decode: Callable = self.batcher._decoded_frame
        self.stats = {
            "queries": 0,
            "retries": 0,
            "transient_failures": 0,
            "breaker_opens": 0,
            "breaker_skips": 0,
            "deadline_exceeded": 0,
            "shed": 0,
            "rejected": 0,
            "degraded": 0,
            "errors": 0,
        }

    # -- admission ------------------------------------------------------ #
    def submit(self, q: RangeQuery) -> None:
        """Admit a query.  Beyond ``max_queue`` pending requests the query
        is *shed to coarse*: re-admitted at ``coarse_eps`` (it will be
        answered from segment-tier data, flagged degraded) — or rejected
        with :class:`BackpressureError` when no coarse tier is set."""
        if len(self.queue) >= self.max_queue:
            if self.coarse_eps is None:
                self.stats["rejected"] += 1
                raise BackpressureError(
                    f"admission queue full ({self.max_queue} pending)",
                    series_id=q.series_id,
                )
            q.eps = max(q.eps, self.coarse_eps)
            self._shed_qids.add(q.qid)
            self.stats["shed"] += 1
        self.queue.append(q)

    # -- serving --------------------------------------------------------- #
    def serve(self, q: RangeQuery, deadline_s: float | None = None) -> RangeQuery:
        """Serve one query end to end; failures land in ``q.error`` as the
        typed error's message (the exception type name prefixed), never an
        unhandled raise."""
        self.stats["queries"] += 1
        t_start = self._clock()
        try:
            self._serve_inner(q, t_start, deadline_s)
            if q.qid in self._shed_qids:
                q.degraded = True
            if q.degraded:
                self.stats["degraded"] += 1
        except ShrinkError as e:
            q.error = f"{type(e).__name__}: {e}"
            self.stats["errors"] += 1
        self.completed.append(q)
        return q

    def _serve_inner(
        self, q: RangeQuery, t_start: float, deadline_s: float | None
    ) -> None:
        touched = self.batcher.frames_overlapping(q.series_id, q.t0, q.t1)
        out = torch.empty(q.t1 - q.t0, dtype=torch.float64, device=self.batcher.device)
        achieved = 0.0
        degraded = False
        expected = q.t0
        for i, m in enumerate(touched):
            if m.t_lo > expected:
                raise RangeCoverageError(
                    f"gap in series {q.series_id} frames at sample {expected}",
                    series_id=q.series_id, frame_index=i,
                )
            vals, g, frame_degraded = self._decode_with_retry(
                m, q.eps, t_start, deadline_s
            )
            achieved = max(achieved, g)
            degraded = degraded or frame_degraded
            lo, hi = max(q.t0, m.t_lo), min(q.t1, m.t_hi)
            out[lo - q.t0 : hi - q.t0] = vals[lo - m.t_lo : hi - m.t_lo]
            expected = hi
        q.result = out
        q.achieved = achieved
        q.degraded = degraded

    def _check_deadline(
        self, t_start: float, deadline_s: float | None, doing: str
    ) -> None:
        if deadline_s is not None and self._clock() - t_start >= deadline_s:
            self.stats["deadline_exceeded"] += 1
            raise DeadlineExceededError(
                f"deadline of {deadline_s:g}s exceeded while {doing}"
            )

    def _decode_with_retry(
        self, meta, eps: float, t_start: float, deadline_s: float | None
    ):
        key = meta.offset
        if not self.breaker.allow(key):
            self.stats["breaker_skips"] += 1
            raise CircuitOpenError(
                f"circuit open for frame at offset {key}",
                series_id=meta.series_id, offset=key,
            )
        last: TransientError | None = None
        for attempt in range(self.retry.max_attempts):
            self._check_deadline(t_start, deadline_s, "decoding frame")
            try:
                result = self.frame_decode(meta, eps)
            except TransientError as e:
                self.stats["transient_failures"] += 1
                was_open = self.breaker.is_open(key)
                self.breaker.record_failure(key)
                if self.breaker.is_open(key) and not was_open:
                    self.stats["breaker_opens"] += 1
                last = e
                if attempt + 1 < self.retry.max_attempts:
                    self.stats["retries"] += 1
                    self._check_deadline(t_start, deadline_s, "backing off")
                    self._sleep(self.retry.delay_s(attempt, self._rng))
                continue
            # corruption errors propagate: they are permanent, retrying
            # cannot fix bytes, and the batcher has already degraded
            # everything degradable before raising
            self.breaker.record_success(key)
            return result
        raise last

    def run(self, deadline_s: float | None = None) -> list[RangeQuery]:
        """Drain the admission queue; each query gets its own deadline."""
        done = []
        while self.queue:
            done.append(self.serve(self.queue.popleft(), deadline_s=deadline_s))
        return done
