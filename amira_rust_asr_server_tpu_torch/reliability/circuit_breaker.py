"""Circuit breaker guarding the device inference path.

State machine parity with the reference (ref:
src/reliability/circuit_breaker.rs:14-302): CLOSED -> OPEN after
``failure_threshold`` failures within a sliding ``window_secs``; OPEN ->
HALF_OPEN after ``recovery_timeout``; HALF_OPEN -> CLOSED after
``success_threshold`` consecutive successes (any failure re-opens).
Unlike the reference — where the breaker exists but is commented out of
the live client (reliable_client.rs:7,68-74) — it is wired into the
serving path here.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Awaitable, Callable, Optional, TypeVar

from ..errors import CircuitOpenError

T = TypeVar("T")


class CircuitState(enum.Enum):
    CLOSED = 0
    HALF_OPEN = 1
    OPEN = 2


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5,
                 window_secs: float = 60.0,
                 recovery_timeout_secs: float = 30.0,
                 success_threshold: int = 3,
                 clock: Callable[[], float] = time.monotonic,
                 excluded_exceptions: tuple = ()):
        # excluded_exceptions pass through without counting as failures:
        # admission-control rejections (queue full) are load signals, not
        # device-health signals — counting them would trip the breaker on
        # an overloaded-but-healthy server and turn load shedding into a
        # full 30 s outage
        self.excluded_exceptions = excluded_exceptions
        self.failure_threshold = failure_threshold
        self.window_secs = window_secs
        self.recovery_timeout_secs = recovery_timeout_secs
        self.success_threshold = success_threshold
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CircuitState.CLOSED
        self._failures: list[float] = []  # sliding window timestamps
        self._opened_at: Optional[float] = None
        self._half_open_successes = 0
        # observability
        self.total_calls = 0
        self.total_failures = 0
        self.total_rejections = 0
        # optional hook fired on every state transition (wired to the
        # prometheus asr_circuit_breaker_state gauge by AppState)
        self.on_state_change: Optional[Callable[[CircuitState], None]] = None

    def _set_state(self, state: CircuitState) -> None:
        """Transition + notify (lock already held; hook must be cheap)."""
        if state is self._state:
            return
        self._state = state
        if self.on_state_change is not None:
            try:
                self.on_state_change(state)
            except Exception:  # noqa: BLE001 — metrics never break serving
                pass

    # ------------------------------------------------------------------
    @property
    def state(self) -> CircuitState:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> CircuitState:
        if self._state is CircuitState.OPEN:
            if (self._clock() - self._opened_at
                    >= self.recovery_timeout_secs):
                self._set_state(CircuitState.HALF_OPEN)
                self._half_open_successes = 0
        return self._state

    # ------------------------------------------------------------------
    def allow(self) -> bool:
        """Admission check; False when OPEN."""
        with self._lock:
            state = self._effective_state()
            if state is CircuitState.OPEN:
                self.total_rejections += 1
                return False
            return True

    def record_success(self) -> None:
        with self._lock:
            self.total_calls += 1
            if self._state is CircuitState.HALF_OPEN:
                self._half_open_successes += 1
                if self._half_open_successes >= self.success_threshold:
                    self._set_state(CircuitState.CLOSED)
                    self._failures.clear()

    def record_failure(self) -> None:
        with self._lock:
            now = self._clock()
            self.total_calls += 1
            self.total_failures += 1
            if self._state is CircuitState.HALF_OPEN:
                self._trip(now)
                return
            self._failures.append(now)
            cutoff = now - self.window_secs
            self._failures = [t for t in self._failures if t >= cutoff]
            if len(self._failures) >= self.failure_threshold:
                self._trip(now)

    def _trip(self, now: float) -> None:
        self._set_state(CircuitState.OPEN)
        self._opened_at = now

    def force_state(self, state: CircuitState) -> None:
        """Test hook (ref: circuit_breaker.rs:296-301)."""
        with self._lock:
            self._set_state(state)
            self._opened_at = self._clock()
            self._half_open_successes = 0

    # ------------------------------------------------------------------
    def call(self, fn: Callable[[], T]) -> T:
        """Wrap a sync call."""
        if not self.allow():
            raise CircuitOpenError("inference circuit is open")
        try:
            result = fn()
        except self.excluded_exceptions:
            raise
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    async def call_async(self, coro: Awaitable[T]) -> T:
        if not self.allow():
            raise CircuitOpenError("inference circuit is open")
        try:
            result = await coro
        except self.excluded_exceptions:
            raise
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._effective_state().name,
                "total_calls": self.total_calls,
                "total_failures": self.total_failures,
                "total_rejections": self.total_rejections,
                "window_failures": len(self._failures),
            }
