"""Per-tenant admission quotas: qps, concurrency, device-seconds.

Counterpart of the JAX package's ``tenancy/quota.py``. Enforcement is at
the query server's front door, before parsing, batching or device time.
An over-quota request is the tenant's doing, so it gets **429 +
Retry-After**, kept apart from the deadline and overload **503**s.

Three resources a tenant, each ``None`` for unlimited:

- ``qps``: a token bucket refilled at `qps`/s; one token an admitted
  request,
- ``max_concurrency``: the in-flight request cap,
- ``device_seconds_per_s``: a *post-paid* token bucket. Admission only
  needs a positive balance; the dispatcher debits each batch's measured
  device seconds afterwards (a query's device cost is known only once
  it ran), so a tenant that burned its budget is refused until the
  bucket refills.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional


class QuotaExceeded(Exception):
    """Admission refused: the tenant is over one of its quotas.
    `retry_after_s` is the earliest time the resource can admit again;
    it becomes the 429's Retry-After header."""

    def __init__(self, tenant_id: str, resource: str, retry_after_s: float):
        self.tenant_id = tenant_id
        self.resource = resource
        self.retry_after_s = max(0.0, retry_after_s)
        super().__init__(f"tenant {tenant_id!r} over {resource} quota; "
                         f"retry in {self.retry_after_s:.1f}s")


class TokenBucket:
    """A token bucket with an injectable clock. `debit` may push the
    balance negative: the device-seconds bucket is post-paid."""

    def __init__(self, rate_per_s: float, burst: float,
                 now_fn: Callable[[], float] = time.monotonic):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._now = now_fn
        self._tokens = self.burst
        self._last = self._now()

    def _refill_locked(self) -> None:
        now = self._now()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> float:
        """Take `n` tokens: 0.0 on success, else the seconds until `n`
        tokens are there."""
        self._refill_locked()
        if self._tokens >= n:
            self._tokens -= n
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return (n - self._tokens) / self.rate

    def balance(self) -> float:
        self._refill_locked()
        return self._tokens

    def debit(self, n: float) -> None:
        self._refill_locked()
        self._tokens -= n


class _TenantQuota:
    """One tenant's live quota state."""

    def __init__(self, now_fn: Callable[[], float]):
        self._now = now_fn
        self.qps_bucket: Optional[TokenBucket] = None
        self.device_bucket: Optional[TokenBucket] = None
        self.max_concurrency: Optional[int] = None
        self.inflight = 0
        self.rejected = {"qps": 0, "concurrency": 0, "device_seconds": 0}
        self.admitted = 0
        self.device_seconds = 0.0

    def configure(self, qps: Optional[float], max_concurrency: Optional[int],
                  device_seconds_per_s: Optional[float]) -> None:
        if qps:
            if self.qps_bucket is None or self.qps_bucket.rate != qps:
                # a burst of one second's allowance (at least 1): a steady
                # client at exactly `qps` never sees a spurious 429
                self.qps_bucket = TokenBucket(qps, max(qps, 1.0), self._now)
        else:
            self.qps_bucket = None
        if device_seconds_per_s:
            if (self.device_bucket is None
                    or self.device_bucket.rate != device_seconds_per_s):
                # a few seconds of headroom, so that one deep batch does not
                # trip the post-paid balance of an otherwise idle tenant
                self.device_bucket = TokenBucket(
                    device_seconds_per_s, max(4.0 * device_seconds_per_s, 0.5), self._now)
        else:
            self.device_bucket = None
        self.max_concurrency = max_concurrency or None


class QuotaEnforcer:
    """Admission control over all tenants. `admit` bumps the in-flight
    count or raises :class:`QuotaExceeded`; a successful admit must be
    paired with `release` (the handler does it in its ``finally``)."""

    def __init__(self, now_fn: Callable[[], float] = time.monotonic):
        self._now = now_fn
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantQuota] = {}  # guarded-by: _lock

    def configure(self, tenant) -> None:
        """Sync one tenant's quota knobs (idempotent: unchanged rates keep
        their balances, so a refresh cannot reset a hog)."""
        with self._lock:
            st = self._tenants.get(tenant.id)
            if st is None:
                st = self._tenants[tenant.id] = _TenantQuota(self._now)
            st.configure(tenant.qps, tenant.max_concurrency, tenant.device_seconds_per_s)

    def drop(self, tenant_id: str) -> None:
        with self._lock:
            self._tenants.pop(tenant_id, None)

    def admit(self, tenant_id: str) -> None:
        with self._lock:
            st = self._tenants.get(tenant_id)
            if st is None:
                st = self._tenants[tenant_id] = _TenantQuota(self._now)
            if st.max_concurrency is not None and st.inflight >= st.max_concurrency:
                st.rejected["concurrency"] += 1
                raise QuotaExceeded(tenant_id, "concurrency", 1.0)
            if st.device_bucket is not None and st.device_bucket.balance() <= 0.0:
                st.rejected["device_seconds"] += 1
                raise QuotaExceeded(
                    tenant_id, "device_seconds",
                    (0.05 - st.device_bucket.balance()) / st.device_bucket.rate)
            if st.qps_bucket is not None:
                wait = st.qps_bucket.try_take(1.0)
                if wait > 0:
                    st.rejected["qps"] += 1
                    raise QuotaExceeded(tenant_id, "qps", wait)
            st.inflight += 1
            st.admitted += 1

    def release(self, tenant_id: str) -> None:
        with self._lock:
            st = self._tenants.get(tenant_id)
            if st is not None and st.inflight > 0:
                st.inflight -= 1

    def charge_device(self, tenant_id: str, seconds: float) -> None:
        """The post-paid device-time debit (the dispatcher's, with each
        batch's measured device seconds split by tenant)."""
        if seconds <= 0:
            return
        with self._lock:
            st = self._tenants.get(tenant_id)
            if st is None:
                return
            st.device_seconds += seconds
            if st.device_bucket is not None:
                st.device_bucket.debit(seconds)

    def snapshot(self, tenant_id: Optional[str] = None) -> dict[str, Any]:
        """Quota state for /tenants."""
        with self._lock:
            items = ([(tenant_id, self._tenants.get(tenant_id))] if tenant_id is not None
                     else list(self._tenants.items()))
            out = {}
            for tid, st in items:
                if st is None:
                    continue
                out[tid] = {
                    "inflight": st.inflight,
                    "admitted": st.admitted,
                    "rejected": dict(st.rejected),
                    "device_seconds": round(st.device_seconds, 4),
                    "qps_tokens": (round(st.qps_bucket.balance(), 3)
                                   if st.qps_bucket else None),
                    "device_tokens": (round(st.device_bucket.balance(), 4)
                                      if st.device_bucket else None),
                    "max_concurrency": st.max_concurrency,
                }
            return out
