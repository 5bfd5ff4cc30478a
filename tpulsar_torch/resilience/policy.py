"""The shared bounded-retry / backoff / deadline / circuit-breaker
primitive — counterpart of tpulsar/resilience/policy.py (a copy).

One engine instead of the ad-hoc loops that had grown per layer (the
jobtracker's jittered lock-retry, the Moab manager's constant-wait
recovery loop, the downloader/uploader DB-state retries, the accel
per-DM retry-once): every retry decision in the codebase routes
through RetryPolicy/call(), so bounds, backoff and classification are
stated once and testable once.

Three pieces:

  RetryPolicy       declarative bounds: attempts, backoff curve,
                    jitter, per-attempt deadline, which exceptions
                    retry.  ``should_retry()`` serves the DB-state
                    loops (downloader/jobpool) whose attempt counter
                    lives in sqlite rather than in a Python loop.
  call()            run a callable under a policy (optionally through
                    a CircuitBreaker), with an injectable sleeper /
                    rng so tests never really sleep.
  run_with_deadline a watchdog that converts a HUNG call into a
                    classified DeadlineExceeded instead of an
                    unbounded stall (a hung device dispatch).  The abandoned call
                    keeps running on a daemon thread — the caller
                    gets control back, which is the point; a truly
                    wedged dispatch was never cancellable anyway.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable

from tpulsar_torch.obs import telemetry


class DeadlineExceeded(RuntimeError):
    """The watched call outlived its deadline: a hang, classified."""


class CircuitOpenError(RuntimeError):
    """The breaker is open: the dependency refused too many
    consecutive calls; skip the call instead of hammering it."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Declarative retry bounds.  backoff before attempt k (k >= 1) is
    ``min(backoff_max_s, backoff_base_s * backoff_mult**(k-1))``,
    scaled by a [0.5, 1.5) factor when jitter is on (the jobtracker's
    proven thundering-herd spread).  delay_first also sleeps before
    attempt 0 (the Moab recovery loop waits before its first showq)."""
    max_attempts: int = 3
    backoff_base_s: float = 0.0
    backoff_mult: float = 2.0
    backoff_max_s: float = 60.0
    jitter: bool = False
    delay_first: bool = False
    deadline_s: float = 0.0         # per-attempt watchdog; 0 = none
    retry_on: tuple[type, ...] = (Exception,)
    #: optional refinement: retry only when this predicate also holds
    #: (e.g. sqlite OperationalError message contains locked/busy)
    retryable: Callable[[BaseException], bool] | None = None

    def backoff_s(self, attempt: int,
                  rng: Callable[[], float] = random.random) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_mult ** attempt)
        return base * (0.5 + rng()) if self.jitter else base

    def should_retry(self, attempts_done: int) -> bool:
        """For loops whose attempt counter lives outside Python (the
        downloader's per-file DB rows): one more attempt allowed?"""
        return attempts_done < self.max_attempts

    def _is_retryable(self, exc: BaseException) -> bool:
        if not isinstance(exc, self.retry_on):
            return False
        return self.retryable is None or self.retryable(exc)


class CircuitBreaker:
    """Consecutive-failure breaker: after `failure_threshold` failures
    in a row the circuit opens for `cooloff_s`; while open, allow()
    is False (callers skip the doomed call — at full scale that is
    thousands of dispatches NOT sent to a poisoned session).  After
    the cooloff one trial call is allowed (half-open): success closes
    the circuit, failure re-opens it for another cooloff."""

    def __init__(self, failure_threshold: int = 5,
                 cooloff_s: float = 60.0, clock=time.monotonic,
                 name: str = ""):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooloff_s = cooloff_s
        self.name = name
        self._clock = clock
        self._fails = 0
        self._opened_at: float | None = None
        self._lock = threading.Lock()

    def _transition(self, state: str) -> None:
        """Telemetry on every state change: a counter (snapshot-
        visible) and a trace instant (timeline-visible) — circuit
        flips were previously invisible outside warning logs."""
        point = self.name or "unnamed"
        telemetry.circuit_transitions_total().inc(point=point,
                                                  state=state)
        telemetry.trace.instant("circuit_" + state, point=point)

    def allow(self) -> bool:
        with self._lock:
            if self._opened_at is None:
                return True
            return self._clock() - self._opened_at >= self.cooloff_s

    def record_success(self) -> None:
        with self._lock:
            was_open = self._opened_at is not None
            self._fails = 0
            self._opened_at = None
        if was_open:
            self._transition("closed")

    def record_failure(self) -> None:
        with self._lock:
            self._fails += 1
            opened = self._fails >= self.failure_threshold
            was_open = self._opened_at is not None
            if opened:
                self._opened_at = self._clock()
        if opened and not was_open:
            self._transition("open")
        elif opened and was_open:
            # the half-open trial call failed: a re-open, distinct
            # from the first trip (a session that keeps refusing its
            # trial calls reads differently from one bad burst)
            self._transition("reopen")

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
        return "half_open" if self.allow() else "open"


def run_with_deadline(fn: Callable, deadline_s: float,
                      label: str = ""):
    """Run fn(); if it has not returned within deadline_s, raise
    DeadlineExceeded.  deadline_s <= 0 calls fn() inline (no thread).

    The overdue call is ABANDONED on its daemon thread, not cancelled
    (a wedged device dispatch cannot be cancelled from Python): its
    eventual result is discarded.  This converts an unbounded stall
    into a failure the retry/rescue machinery can classify."""
    if deadline_s <= 0:
        return fn()
    out: list = []
    err: list = []

    def runner():
        try:
            out.append(fn())
        except BaseException as e:   # delivered to the waiting caller
            err.append(e)

    th = threading.Thread(target=runner, daemon=True,
                          name=f"deadline-{label or 'call'}")
    th.start()
    th.join(deadline_s)
    if th.is_alive():
        raise DeadlineExceeded(
            f"{label or 'call'} exceeded its {deadline_s:g} s "
            f"deadline (hung dispatch converted to a classified "
            f"failure; the stalled call was abandoned)")
    if err:
        raise err[0]
    return out[0]


def call(fn: Callable, policy: RetryPolicy, *,
         sleeper: Callable[[float], None] = time.sleep,
         rng: Callable[[], float] = random.random,
         breaker: CircuitBreaker | None = None,
         on_retry: Callable[[int, BaseException], None] | None = None,
         label: str = ""):
    """Run fn under the policy: up to max_attempts tries, backoff
    between them, per-attempt deadline when configured, breaker
    consulted/updated when provided.  Raises the last failure (or
    CircuitOpenError when the breaker refuses the call).  on_retry
    fires only when another attempt WILL follow — never after the
    terminal failure (a callback that resets state for 'the next
    attempt' must not run when there is none).

    label: telemetry point name — retries and backoff sleeps are
    accumulated per label into tpulsar_retry_attempts_total /
    tpulsar_backoff_seconds_total (unlabelled calls aggregate under
    the breaker's name, else 'unnamed').

    The breaker records ONE failure per failed CALL, not per attempt:
    its threshold counts consecutive refused operations, so a
    documented 'N consecutive refusals' threshold means N calls
    regardless of how many retries each call burned."""
    if policy.max_attempts < 1:
        raise ValueError(
            f"RetryPolicy.max_attempts must be >= 1, got "
            f"{policy.max_attempts}")
    point = label or (breaker.name if breaker is not None
                      and breaker.name else "") or "unnamed"
    last: BaseException | None = None
    for attempt in range(policy.max_attempts):
        if breaker is not None and not breaker.allow():
            raise CircuitOpenError(
                f"circuit open after {breaker.failure_threshold} "
                f"consecutive failures (cooloff "
                f"{breaker.cooloff_s:g} s)")
        if attempt > 0 or policy.delay_first:
            delay = policy.backoff_s(max(0, attempt - 1), rng=rng)
            if delay > 0:
                telemetry.backoff_seconds_total().inc(delay,
                                                      point=point)
            sleeper(delay)
        if attempt > 0:
            telemetry.retry_attempts_total().inc(point=point)
        try:
            result = run_with_deadline(fn, policy.deadline_s)
        except BaseException as e:
            if not policy._is_retryable(e):
                if breaker is not None:
                    breaker.record_failure()
                raise
            last = e
            if on_retry is not None and attempt + 1 < policy.max_attempts:
                on_retry(attempt, e)
            continue
        if breaker is not None:
            breaker.record_success()
        return result
    assert last is not None
    if breaker is not None:
        breaker.record_failure()
    raise last
