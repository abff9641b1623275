"""Circuit breaker: stop calling a failing dependency until it heals (the
port's copy of ``repro.resilience.breaker``).

Classic three-state machine guarding a serving scheduler's
degraded-tier hedge target:

    CLOSED      normal operation; outcomes recorded in a sliding
                window of the last ``window`` calls.  When the window
                holds >= ``min_calls`` outcomes and the failure rate
                reaches ``failure_threshold``, trip to OPEN.
    OPEN        calls are refused (``allow()`` is False) for
                ``reset_timeout_s``; after it elapses the next
                ``allow()`` transitions to HALF_OPEN and admits one
                probe.
    HALF_OPEN   exactly one in-flight probe: success -> CLOSED (window
                cleared), failure -> OPEN (timer restarted).

The breaker is clock-injected (monotonic seconds) so tests drive it
deterministically, and ``on_transition`` lets callers mirror state
into a metrics gauge.
"""
from __future__ import annotations

import collections
import time
from typing import Callable

__all__ = ["CircuitBreaker", "STATE_CLOSED", "STATE_OPEN", "STATE_HALF_OPEN"]

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

#: gauge encoding of breaker state (exported for dashboards/tests)
STATE_CODES = {STATE_CLOSED: 0.0, STATE_OPEN: 1.0, STATE_HALF_OPEN: 2.0}


class CircuitBreaker:
    """Sliding-window failure-rate breaker with clock injection."""

    def __init__(self, *, window: int = 16, failure_threshold: float = 0.5,
                 min_calls: int = 4, reset_timeout_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Callable[[str, str], None] | None = None):
        if window < 1:
            raise ValueError("window must be >= 1")
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError("failure_threshold must be in (0, 1]")
        self.window = int(window)
        self.failure_threshold = float(failure_threshold)
        self.min_calls = max(int(min_calls), 1)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._on_transition = on_transition
        self._state = STATE_CLOSED
        self._outcomes: collections.deque[bool] = collections.deque(
            maxlen=self.window)  # True = failure
        self._opened_at = 0.0
        self._probe_in_flight = False
        self.transitions = 0  # lifetime transition count

    # -- state -----------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def state_code(self) -> float:
        """Numeric encoding for the metrics gauge (0/1/2)."""
        return STATE_CODES[self._state]

    def _transition(self, new: str) -> None:
        if new == self._state:
            return
        old, self._state = self._state, new
        self.transitions += 1
        if new == STATE_OPEN:
            self._opened_at = self._clock()
            self._probe_in_flight = False
        elif new == STATE_CLOSED:
            self._outcomes.clear()
            self._probe_in_flight = False
        if self._on_transition is not None:
            self._on_transition(old, new)

    # -- call protocol ---------------------------------------------------

    def allow(self) -> bool:
        """May the caller attempt the guarded call right now?"""
        if self._state == STATE_CLOSED:
            return True
        if self._state == STATE_OPEN:
            if self._clock() - self._opened_at >= self.reset_timeout_s:
                self._transition(STATE_HALF_OPEN)
            else:
                return False
        # HALF_OPEN: admit exactly one probe at a time
        if self._probe_in_flight:
            return False
        self._probe_in_flight = True
        return True

    def record_success(self) -> None:
        if self._state == STATE_HALF_OPEN:
            self._transition(STATE_CLOSED)
            return
        self._outcomes.append(False)

    def record_failure(self) -> None:
        if self._state == STATE_HALF_OPEN:
            self._transition(STATE_OPEN)
            return
        self._outcomes.append(True)
        if (self._state == STATE_CLOSED
                and len(self._outcomes) >= self.min_calls):
            rate = sum(self._outcomes) / len(self._outcomes)
            if rate >= self.failure_threshold:
                self._transition(STATE_OPEN)

    def failure_rate(self) -> float:
        if not self._outcomes:
            return 0.0
        return sum(self._outcomes) / len(self._outcomes)
