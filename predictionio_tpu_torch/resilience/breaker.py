"""Circuit breaker per endpoint and DAO: closed → open → half-open.

Counterpart of the JAX package's ``resilience/breaker.py``. A breaker
guards one remote endpoint (the remote storage client keys one by
endpoint and DAO). While CLOSED every call passes; `failure_threshold`
failures in a row trip it OPEN, and calls then fail fast, touching no
socket, for `cooldown_s`. The first call after the cooldown is the
HALF-OPEN probe: its success closes the breaker, its failure opens it
for another cooldown. One probe flies at a time; an allowed call that
ends without a verdict from the endpoint gives its probe slot back
(`release_probe`).

Every transition lands on the metrics registry (the process default
unless one is given): ``resilience_breaker_state{endpoint,dao}`` (0
closed, 1 open, 2 half-open) and
``resilience_breaker_transitions_total{endpoint,dao,state}``, which
every server's ``GET /metrics`` shows. Standard library only.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


class CircuitOpenError(Exception):
    """A fail-fast refusal: the endpoint's breaker is open."""


class CircuitBreaker:
    def __init__(
        self,
        name: str,
        failure_threshold: int = 5,
        cooldown_s: float = 10.0,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
        dao: str = "",
    ):
        self.name = name
        self.dao = dao
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        if registry is None:
            from predictionio_tpu_torch.obs.registry import get_default_registry

            registry = get_default_registry()
        self._state_gauge = registry.gauge(
            "resilience_breaker_state",
            "circuit breaker state (0 closed, 1 open, 2 half-open)",
            ("endpoint", "dao"),  # label-bound: storage sources x DAOs
        )
        self._transitions = registry.counter(
            "resilience_breaker_transitions_total",
            "circuit breaker state transitions, by destination state",
            ("endpoint", "dao", "state"),  # label-bound: sources x DAOs x states
        )
        self._state_gauge.set(0.0, endpoint=name, dao=dao)

    @property
    def state(self) -> str:
        with self._lock:
            # a cooled-down open breaker reads half-open before any allow()
            if (
                self._state == OPEN
                and self._opened_at is not None
                and self._clock() - self._opened_at >= self.cooldown_s
            ):
                return HALF_OPEN
            return self._state

    def allow(self) -> bool:
        """Whether a call may go ahead (as the recovery probe, too)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if (
                    self._opened_at is not None
                    and self._clock() - self._opened_at >= self.cooldown_s
                ):
                    self._transition(HALF_OPEN)
                    self._probe_inflight = True
                    return True
                return False
            # HALF_OPEN: one probe at a time
            if not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def release_probe(self) -> None:
        """Give back an allowed call's probe slot without a verdict (its
        own deadline expired before any I/O, a local error aborted it);
        otherwise an exception between allow() and record_*() would hold
        the slot and keep the breaker failing fast for good."""
        with self._lock:
            self._probe_inflight = False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == HALF_OPEN:
                self._transition(OPEN)  # a failed probe: another cooldown
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._transition(OPEN)

    def _transition(self, to: str) -> None:
        # the caller holds self._lock
        self._state = to
        if to == OPEN:
            self._opened_at = self._clock()
        elif to == CLOSED:
            self._opened_at = None
            self._failures = 0
        try:
            self._state_gauge.set(_STATE_VALUE[to], endpoint=self.name, dao=self.dao)
            self._transitions.inc(endpoint=self.name, dao=self.dao, state=to)
        except Exception:
            pass  # a metrics hiccup never breaks the call path

    def call(self, fn: Callable, *args, **kwargs):
        """Gate on allow(), run, record the outcome."""
        if not self.allow():
            raise CircuitOpenError(f"circuit breaker {self.name} is open")
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def get_breaker(name: str, **kwargs) -> CircuitBreaker:
    """The process's breaker of that name (the remote client names one
    ``storage:<host>:<port>/<dao>``): every client in the process shares
    one view of the endpoint's health; `kwargs` configure only the first
    construction."""
    with _breakers_lock:
        b = _breakers.get(name)
        if b is None:
            b = _breakers[name] = CircuitBreaker(name, **kwargs)
        return b


def reset_breakers() -> None:
    """Drop every process breaker (tests)."""
    with _breakers_lock:
        _breakers.clear()
