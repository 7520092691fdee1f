"""Weighted-fair queueing for the micro-batch dispatcher (deficit round
robin).

Counterpart of the JAX package's ``tenancy/fair.py``. One FIFO is how one
hog tenant starves everyone: 500 queued hog queries make every other
tenant's query wait 500 device slots. `FairQueue` keeps one sub-queue a
tenant, drained by deficit round robin: each visit to a tenant adds its
``weight`` to the tenant's deficit and serves queries while the deficit
covers them (a query costs 1), so over any window each backlogged tenant
gets device slots in proportion to its weight, however deep another's
backlog is.

It answers the part of ``queue.Queue`` the dispatcher's drain uses
(``put``, ``get(timeout=)``, ``get_nowait`` raising ``queue.Empty``,
``qsize``, ``empty``). With one stream (or none tenanted) it is a FIFO.
"""

from __future__ import annotations

import collections
import queue as _q
import threading
import time
from typing import Any, Callable, Optional

# a visit banks at most this much deficit: the burst a long-idle tenant
# can claim in one round
_MAX_DEFICIT = 64.0


class FairQueue:
    """Thread-safe DRR queue over items with a ``tenant`` attribute
    (``None``, or no attribute: the untenanted stream, weight 1)."""

    def __init__(self, weight_of: Optional[Callable[[Optional[str]], float]] = None):
        self._weight_of = weight_of
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._queues: dict[Optional[str], collections.deque] = {}  # guarded-by: _lock
        self._deficit: dict[Optional[str], float] = {}  # guarded-by: _lock
        # the rotation of tenants with queued items
        self._order: collections.deque = collections.deque()  # guarded-by: _lock
        self._size = 0  # guarded-by: _lock

    def _weight(self, tenant: Optional[str]) -> float:
        if self._weight_of is None:
            return 1.0
        try:
            w = float(self._weight_of(tenant))
        except Exception:  # noqa: BLE001 — a weight lookup never stops the drain
            return 1.0
        return w if w > 0 else 1.0

    def put(self, item: Any) -> None:
        tenant = getattr(item, "tenant", None)
        with self._not_empty:
            dq = self._queues.get(tenant)
            if dq is None:
                dq = self._queues[tenant] = collections.deque()
                self._deficit.setdefault(tenant, 0.0)
                self._order.append(tenant)
            dq.append(item)
            self._size += 1
            self._not_empty.notify()

    def qsize(self) -> int:
        with self._lock:
            return self._size

    def empty(self) -> bool:
        return self.qsize() == 0

    def depths(self) -> dict[str, int]:
        """Queued depth by tenant (the status surface)."""
        with self._lock:
            return {("(default)" if t is None else t): len(dq)
                    for t, dq in self._queues.items() if dq}

    def backlogged(self) -> set:
        """The tenant keys (None: untenanted) with queued items."""
        with self._lock:
            return {t for t, dq in self._queues.items() if dq}

    def get_nowait(self, skip: Optional[set] = None) -> Any:
        with self._lock:
            return self._pop_locked(skip)

    def get(self, timeout: Optional[float] = None, skip: Optional[set] = None) -> Any:
        """Pop the next item by DRR. `skip` names tenant keys whose items
        stay queued this call (the continuous-batching admission cap):
        when every backlogged tenant is skipped the call behaves as
        empty, so the assembling bucket keeps room for the other
        tenants' arrivals."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_empty:
            while True:
                if self._size:
                    try:
                        return self._pop_locked(skip)
                    except _q.Empty:
                        pass  # only skipped tenants queued: wait
                if deadline is None:
                    self._not_empty.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise _q.Empty
                    self._not_empty.wait(remaining)

    def _pop_locked(self, skip: Optional[set] = None) -> Any:
        if not self._size:
            raise _q.Empty
        if skip and all((t in skip) or not dq for t, dq in self._queues.items()):
            # nothing servable outside the skip set: the loop below would
            # rotate forever
            raise _q.Empty
        # DRR: a visit credits `weight`, serving one item debits 1; every
        # full rotation credits each backlogged tenant at least the least
        # weight, so some deficit crosses 1 within ceil(1 / min weight)
        # rotations. Skipped tenants rotate past without credit: a cap
        # must not bank priority for the capped tenant.
        while True:
            tenant = self._order[0]
            dq = self._queues.get(tenant)
            if not dq:
                # drained earlier: out of the rotation (an idle tenant
                # banks no deficit)
                self._order.popleft()
                self._queues.pop(tenant, None)
                self._deficit.pop(tenant, None)
                continue
            if skip and tenant in skip:
                self._order.rotate(-1)
                continue
            deficit = self._deficit[tenant]
            if deficit < 1.0:
                deficit = min(deficit + self._weight(tenant), _MAX_DEFICIT)
                self._deficit[tenant] = deficit
            if deficit >= 1.0:
                self._deficit[tenant] = deficit - 1.0
                item = dq.popleft()
                self._size -= 1
                if not dq:
                    self._order.popleft()
                    self._queues.pop(tenant, None)
                    self._deficit.pop(tenant, None)
                elif self._deficit[tenant] < 1.0:
                    self._order.rotate(-1)  # this visit's credit spent
                return item
            # a weight below 1 and the credit still short: rotate, the
            # credit stays
            self._order.rotate(-1)
