"""Retry policy: exponential backoff with jitter under a deadline budget.

Counterpart of the JAX package's ``resilience/retry.py``, the same
schedule for the same seed. The policy is a value object:
`delay(attempt)` exposes the schedule (tests hold it draw for draw) and
`call(fn)` runs the loop: retry only the declared exception types, sleep
the jittered backoff between attempts, and stop early when the next
attempt could not finish before the deadline. Standard library only.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple, Type


@dataclass
class RetryPolicy:
    """`max_attempts` tries in all; attempt *i* (from 0) sleeps
    ``base_delay * multiplier**i``, capped at `max_delay`, before attempt
    *i+1*, times a jitter factor uniform in ``[1 - jitter, 1 + jitter]``
    drawn from `rng` (injectable, so that a schedule is reproducible)."""

    max_attempts: int = 3
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.5
    rng: random.Random = field(default_factory=random.Random, repr=False)

    def delay(self, attempt: int) -> float:
        d = min(self.base_delay * self.multiplier**attempt, self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self.rng.random() - 1.0)
        return max(0.0, d)

    def call(
        self,
        fn: Callable[[int], Any],
        retry_on: Tuple[Type[BaseException], ...],
        deadline: Optional[float] = None,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
    ) -> Any:
        """Run ``fn(attempt)`` until it returns, an error it may not retry
        escapes, the attempts run out, or the next attempt could not
        start before `deadline` (absolute ``time.monotonic()`` seconds:
        the caller's budget). The last retryable error re-raises."""
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.max_attempts)):
            try:
                return fn(attempt)
            except retry_on as e:
                last = e
                if attempt + 1 >= max(1, self.max_attempts):
                    break
                pause = self.delay(attempt)
                if deadline is not None:
                    budget = deadline - time.monotonic()
                    if budget <= 0 or pause >= budget:
                        break  # the next attempt could not finish in time
                if on_retry is not None:
                    try:
                        on_retry(attempt, e)
                    except Exception:
                        pass
                if pause > 0:
                    time.sleep(pause)
        assert last is not None
        raise last
