"""Engine multiplexer: one query server, many tenant runtimes.

Counterpart of the JAX package's ``tenancy/mux.py``. `TenantMux` is the
tenant-aware serving plane a query server attaches
(``QueryServer.attach_tenancy``). For each request it

1. **admits**: resolves the tenant record (a TTL-cached fold of the
   shared tenant store) and enforces its quotas (qps, concurrency,
   device-seconds → :class:`QuotaExceeded` → 429 + Retry-After, kept
   apart from the deadline 503s),
2. **routes**: takes the tenant's runtime from the LRU model cache under
   a lease (a miss is a transparent load), or the tenant's canary
   candidate while a rollout of its own is active (the sticky fraction of
   ``deploy/rollout.py``'s controller, driven through a host adapter),
3. **bookkeeps**: per-tenant serve histograms and counters under a
   ``tenant`` label bounded by `label_max` (the rest share
   ``OVERFLOW_LABEL``), the device seconds the dispatcher charges, and
   the tenant rollout's verdict windows.

A background ``tenant-sync`` thread refreshes the records, re-adopts
persisted mid-canary rollouts after a restart, prefetches newly promoted
versions into the cache and releases what deleted tenants held. Online
fold-in reaches one tenant's cached runtime through
``online.TenantApplyHost``. The knobs are ``PIO_TENANT_*``
(``utils/env.py`` ``TENANT_KEYS``). Runtimes are built on `device` (the
first CUDA device when None).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Optional

from predictionio_tpu_torch.tenancy.cache import ModelCache
from predictionio_tpu_torch.tenancy.quota import QuotaEnforcer, QuotaExceeded
from predictionio_tpu_torch.tenancy.tenants import Tenant, TenantStore
from predictionio_tpu_torch.utils.env import tenant_knob

log = logging.getLogger(__name__)

# the label tenants past `label_max` share, so that /metrics stays
# bounded however many tenants a fleet hosts
OVERFLOW_LABEL = "(other)"

_CACHE_GAUGES = ("tenant_cache_resident", "tenant_cache_hits_total",
                 "tenant_cache_misses_total", "tenant_cache_reloads_total",
                 "tenant_cache_evictions_total")


class UnknownTenant(KeyError):
    """No such (enabled) tenant: a 404 at the HTTP edge."""


class _TenantRolloutHost:
    """The QueryServer-shaped host one tenant's RolloutController drives:
    `storage`, `runtime` (the tenant's resident runtime, whose device the
    candidate is built on), `rollout`, `candidate`, and the attach and
    complete seam; a promote puts the candidate into the model cache."""

    def __init__(self, mux: "TenantMux", tenant_id: str):
        self._mux = mux
        self.tenant_id = tenant_id
        self.storage = mux.storage
        self.rollout = None
        self.candidate = None
        self._lock = threading.RLock()

    @property
    def runtime(self):
        return self._mux.cache.peek_runtime(self.tenant_id)

    def attach_rollout(self, controller, candidate) -> None:
        from predictionio_tpu_torch.workflow.server import RolloutConflict

        with self._lock:
            if self.rollout is not None and self.rollout.st.state in ("starting", "canary"):
                raise RolloutConflict(f"tenant {self.tenant_id}: rollout of "
                                      f"{self.rollout.st.version.id} is already active")
            self.candidate = candidate
            self.rollout = controller
        # the baseline serves half the verdict's comparison: it stays
        # resident for the whole bake
        self._mux.cache.pin(self.tenant_id, on=True)

    def complete_rollout(self, controller, promote: bool) -> None:
        with self._lock:
            if self.rollout is not controller:
                return  # a stale controller: a newer rollout replaced it
            candidate = self.candidate
            self.candidate = None
        if promote and candidate is not None:
            self._mux.cache.put_runtime(self.tenant_id, candidate,
                                        version_key=controller.st.version.id)
        self._mux.cache.pin(self.tenant_id, on=False)


class TenantMux:
    """The multiplexer one QueryServer owns. Thread-safe: handler and
    dispatcher threads call it."""

    def __init__(self, storage, metrics=None, cache_capacity: Optional[int] = None,
                 cache_hbm_bytes: Optional[float] = None, refresh_s: Optional[float] = None,
                 sync_s: Optional[float] = None, label_max: Optional[int] = None,
                 device: Optional[str] = None):
        from predictionio_tpu_torch.obs import get_default_registry

        self.storage = storage
        self.store = TenantStore(storage)
        self.cache = ModelCache(
            storage,
            capacity=int(cache_capacity if cache_capacity is not None
                         else tenant_knob("PIO_TENANT_CACHE_SIZE")),
            # a byte budget replaces the entry count when set (0: unset)
            hbm_bytes=(cache_hbm_bytes if cache_hbm_bytes is not None
                       else (tenant_knob("PIO_TENANT_CACHE_HBM_BYTES") or None)),
            device=device,
        )
        self.quota = QuotaEnforcer()
        self.refresh_s = (refresh_s if refresh_s is not None
                          else tenant_knob("PIO_TENANT_REFRESH_S"))
        self.sync_s = sync_s if sync_s is not None else tenant_knob("PIO_TENANT_SYNC_S")
        self._label_max = int(label_max if label_max is not None
                              else tenant_knob("PIO_TENANT_METRIC_MAX"))
        self._labels: set[str] = set()  # guarded-by: _lock
        self._lock = threading.RLock()
        self._tenants: dict[str, Tenant] = {}  # guarded-by: _lock
        self._refreshed_at = 0.0  # guarded-by: _lock
        self._hosts: dict[str, _TenantRolloutHost] = {}  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._resumed = False
        # consecutive re-adoption failures a tenant, capped so that a dead
        # baseline cannot keep the resume pass churning
        self._resume_attempts: dict[str, int] = {}
        # tenants seen deleted whose state is still to release; retried
        # until clean (a delete mid-canary defers to the sync pass, which
        # aborts the orphaned rollout off the serving path)
        self._removed_pending: set[str] = set()  # guarded-by: _lock
        self._last_compact = 0.0
        # online fold-in consumers a tenant, each folding into its
        # tenant's cached runtime through the conditional cache swap
        self._online: dict[str, Any] = {}

        self.metrics = metrics or get_default_registry()
        self._requests = self.metrics.counter(
            "tenant_requests_total", "queries served per tenant (label set bounded)",
            ("tenant", "outcome"),  # label-bound: PIO_TENANT_METRIC_MAX + (other)
        )
        self._serve_hist = self.metrics.histogram(
            "tenant_serve_seconds", "end-to-end serve time per tenant",
            ("tenant",),  # label-bound: PIO_TENANT_METRIC_MAX + (other)
        )
        self._quota_rejected = self.metrics.counter(
            "tenant_quota_rejected_total",
            "admissions refused per tenant and quota resource (429s)",
            ("tenant", "resource"),  # label-bound: the cap x literal resources
        )
        self._device_seconds = self.metrics.counter(
            "tenant_device_seconds_total", "device time charged per tenant",
            ("tenant",),  # label-bound: PIO_TENANT_METRIC_MAX + (other)
        )
        for name, fn in zip(_CACHE_GAUGES, (
                lambda: self.cache.stats()["resident"], lambda: self.cache.hits,
                lambda: self.cache.misses, lambda: self.cache.reloads,
                lambda: self.cache.evictions)):
            self.metrics.gauge_callback(name, "tenant model cache state", fn)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Start the background sync (refresh, rollout re-adoption,
        prefetch)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._sync_loop, name="tenant-sync",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for consumer in list(self._online.values()):
            consumer.stop()  # the consumer threads join with the mux
        self._online.clear()
        with self._lock:
            hosts = list(self._hosts.values())
        for host in hosts:
            if host.rollout is not None:
                host.rollout.stop()
        # freeze the cache gauges at their final values: the registry's
        # callbacks close over this mux and would keep it, and every
        # runtime in its cache, alive for the rest of the process
        try:
            stats = self.cache.stats()
            finals = (stats["resident"], self.cache.hits, self.cache.misses,
                      self.cache.reloads, self.cache.evictions)
            for name, val in zip(_CACHE_GAUGES, map(float, finals)):
                self.metrics.gauge_callback(name, "tenant model cache state",
                                            lambda v=val: v)
        except Exception:  # noqa: BLE001 — the stop goes on
            log.exception("cache gauge freeze on stop failed")

    def _sync_loop(self) -> None:
        # the first pass runs at once: a restarted server re-adopts its
        # persisted tenant canaries before traffic decides their fate
        while True:
            try:
                self.sync()
            except Exception:  # noqa: BLE001 — the next pass retries
                log.exception("tenant sync pass failed; retrying")
            if self._stop.wait(self.sync_s):
                return

    def sync(self) -> None:
        """One background pass: refresh the records, resume persisted
        rollouts once, prefetch promoted versions of resident tenants,
        finish deferred cleanups of deleted tenants, and (throttled)
        compact the tenant and rollout record folds."""
        ok = self.refresh(force=True)
        with self._lock:
            tenants = list(self._tenants.values())
        if not self._resumed and ok:
            # latched only after a clean pass over a good refresh: a
            # storage blip on the first sync must not use up the one
            # re-adoption; a tenant's failed resume is retried, at most
            # three times (a permanently unservable baseline would
            # otherwise fold records and fail a build every pass)
            failed = False
            for tenant in tenants:
                if self._resume_attempts.get(tenant.id, 0) >= 3:
                    continue
                try:
                    self._resume_rollout(tenant)
                    self._resume_attempts.pop(tenant.id, None)
                except Exception:  # noqa: BLE001 — counted, retried
                    n = self._resume_attempts.get(tenant.id, 0) + 1
                    self._resume_attempts[tenant.id] = n
                    if n >= 3:
                        log.error("tenant %s rollout re-adopt failed %d times; giving up "
                                  "until the next restart (the persisted record is kept: "
                                  "abort the rollout or delete the record to clear it)",
                                  tenant.id, n)
                    else:
                        failed = True
                    log.exception("tenant %s rollout re-adopt failed", tenant.id)
            self._resumed = not failed
        self.cache.sync(tenants)
        self._cleanup_removed(abort_active=True)
        # quota edits and rollout transitions pile up events that every
        # refresh re-folds; compaction itself re-reads them, so throttled
        if time.monotonic() - self._last_compact >= 600.0:
            self._last_compact = time.monotonic()
            try:
                from predictionio_tpu_torch.deploy.registry import (
                    ROLLOUT_ENTITY,
                    LifecycleRecordStore,
                )

                self.store.compact()
                LifecycleRecordStore(self.storage).compact_all(ROLLOUT_ENTITY)
            except Exception:  # noqa: BLE001 — the next pass retries
                log.exception("tenant record compaction failed")

    def _resume_rollout(self, tenant: Tenant) -> None:
        from predictionio_tpu_torch.deploy.registry import (
            ROLLOUT_ENTITY,
            LifecycleRecordStore,
        )
        from predictionio_tpu_torch.deploy.rollout import resume_rollout

        scope = f"tenant/{tenant.id}"
        with self._lock:
            host = self._hosts.get(tenant.id)
        if host is not None and host.rollout is not None:
            return
        # only a persisted mid-canary record justifies loading the model now
        rec = LifecycleRecordStore(self.storage).fold(ROLLOUT_ENTITY, scope).get(scope)
        if not rec or rec.get("state") != "canary":
            return
        host = self._host(tenant.id)
        # warm and pin the baseline first, as start_rollout does: a
        # baseline evicted mid-window would bias the verdict
        self.cache.warm_and_pin(tenant)
        try:
            controller = resume_rollout(host, scope=scope)
        except Exception:
            self.cache.pin(tenant.id, on=False)
            raise
        if controller is None:
            self.cache.pin(tenant.id, on=False)
        else:
            log.info("tenant %s: re-adopted mid-canary rollout of %s",
                     tenant.id, controller.st.version.id)

    # -- tenant records ------------------------------------------------------
    def refresh(self, force: bool = False) -> bool:
        """True when the tenant snapshot is fresh (or within its TTL),
        False when this pass could not reach storage."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._refreshed_at < self.refresh_s:
                return True
            self._refreshed_at = now
        try:
            tenants = {t.id: t for t in self.store.list()}
        except Exception:  # noqa: BLE001 — serve from the cached snapshot
            # admit() calls this inline at the TTL's end: a storage blip
            # must not drop a query whose model is resident
            log.warning("tenant refresh failed (storage down?); serving from the "
                        "cached tenant snapshot", exc_info=True)
            return False
        with self._lock:
            self._removed_pending |= set(self._tenants) - set(tenants)
            self._tenants = tenants
        if tenant_knob("PIO_TENANT_SLO_PRESETS"):
            # an availability and a latency objective a known tenant; a
            # no-op while the tenant set is unchanged, never failing
            try:
                from predictionio_tpu_torch.obs.monitor import get_monitor

                get_monitor().apply_tenant_presets(list(tenants))
            except Exception:  # noqa: BLE001
                log.debug("tenant SLO preset sync failed", exc_info=True)
        for t in tenants.values():
            self.quota.configure(t)
        self._cleanup_removed(abort_active=False)
        return True

    def _cleanup_removed(self, abort_active: bool) -> None:
        """Release what a deleted tenant held: its quota buckets (a
        recreate must not inherit a dead tenant's device-seconds debt),
        its resident runtime and its rollout host. A tenant deleted
        mid-canary makes no verdict progress (its traffic now 404s), so
        the sync pass (`abort_active`, off the serving path: an abort
        joins the verdict thread) aborts the orphaned rollout; until
        then the id stays pending."""
        with self._lock:
            pending = set(self._removed_pending)
        for tid in pending:
            with self._lock:
                recreated = tid in self._tenants
                host = self._hosts.get(tid)
            rollout = host.rollout if host is not None else None
            active = rollout is not None and rollout.st.state in ("starting", "canary")
            if active and not recreated:
                if not abort_active:
                    continue  # left to the sync pass
                try:
                    rollout.stop()
                    if rollout.st.state == "canary":
                        rollout.abort("tenant deleted")
                except Exception:  # noqa: BLE001 — retried
                    log.exception("abort of deleted tenant %s rollout failed; will retry",
                                  tid)
                    continue
            # a recreated tenant gets fresh state too
            self.quota.drop(tid)
            if not (recreated and active):
                # a recreate mid-canary keeps the resident baseline: the
                # rollout's pin is on that entry, and a rebuilt one would
                # be evictable for the rest of the bake
                self.cache.invalidate(tid)
            if recreated:
                with self._lock:
                    t = self._tenants.get(tid)
                if t is not None:
                    self.quota.configure(t)  # no unlimited window
            with self._lock:
                if not (recreated and active):
                    self._hosts.pop(tid, None)
                self._removed_pending.discard(tid)

    def tenant(self, tenant_id: str) -> Optional[Tenant]:
        self.refresh()
        with self._lock:
            return self._tenants.get(tenant_id)

    def tenant_weight(self, tenant_id: Optional[str]) -> float:
        """The fair scheduler's weight of a tenant (a cached read)."""
        if tenant_id is None:
            return 1.0
        with self._lock:
            t = self._tenants.get(tenant_id)
        return t.weight if t is not None else 1.0

    def label(self, tenant_id: str) -> str:
        """The bounded metric label: the first `label_max` tenants seen
        get their own value, the rest share the overflow label."""
        with self._lock:
            if tenant_id in self._labels:
                return tenant_id
            if len(self._labels) < self._label_max:
                self._labels.add(tenant_id)
                return tenant_id
        return OVERFLOW_LABEL

    # -- admission (quotas) --------------------------------------------------
    def admit(self, tenant_id: str) -> Tenant:
        """Resolve and quota-admit one request: UnknownTenant (404) or
        QuotaExceeded (429). A good admit holds a concurrency slot until
        `done`."""
        tenant = self.tenant(tenant_id)
        if tenant is None or not tenant.enabled:
            raise UnknownTenant(tenant_id)
        try:
            self.quota.admit(tenant_id)
        except QuotaExceeded as e:
            self._quota_rejected.inc(tenant=self.label(tenant_id), resource=e.resource)
            raise
        return tenant

    def done(self, tenant_id: str, lease) -> None:
        """The request's ``finally``: the cache lease and the concurrency
        slot go back."""
        if lease is not None:
            self.cache.release(lease)
        self.quota.release(tenant_id)

    # -- routing -------------------------------------------------------------
    def route(self, tenant: Tenant, raw_request: bytes, bucket=None):
        """→ (runtime, variant, cache lease). While the tenant has a
        rollout that is not shadow, its sticky fraction (by the body's
        crc32, or a gateway's `bucket`) goes to the candidate."""
        from predictionio_tpu_torch.deploy.rollout import sticky_candidate

        with self._lock:
            host = self._hosts.get(tenant.id)
        if host is not None:
            rollout, candidate = host.rollout, host.candidate
            if (candidate is not None and rollout is not None
                    and not rollout.config.shadow
                    and sticky_candidate(raw_request, rollout.config.fraction,
                                         bucket=bucket)):
                return candidate, "candidate", None
        entry = self.cache.acquire(tenant)
        return entry.runtime, "live", entry

    def is_candidate(self, runtime) -> bool:
        """Whether `runtime` is some tenant's canary candidate (the
        dispatcher's variant of a group)."""
        with self._lock:
            hosts = list(self._hosts.values())
        return any(host.candidate is runtime for host in hosts)

    # -- bookkeeping ---------------------------------------------------------
    def bookkeep(self, tenant_id: str, variant: str, seconds: float, error: bool) -> None:
        lbl = self.label(tenant_id)
        self._serve_hist.observe(seconds, tenant=lbl)
        self._requests.inc(tenant=lbl, outcome="error" if error else "ok")
        with self._lock:
            host = self._hosts.get(tenant_id)
        if host is not None and host.rollout is not None:
            host.rollout.record(variant, seconds, error)

    def charge_device_seconds(self, tenant_id: str, seconds: float) -> None:
        self.quota.charge_device(tenant_id, seconds)
        self._device_seconds.inc(seconds, tenant=self.label(tenant_id))

    # -- per-tenant online fold-in -------------------------------------------
    def attach_online(self, tenant_id: str, app_id: int, config=None,
                      channel_id: Optional[int] = None, consumer=None):
        """Attach a fold-in consumer for one tenant: `app_id`'s events
        fold into that tenant's cached runtime, no other tenant's. The
        tenant's model is warmed first, so that the consumer has a runtime
        to fold into. The port's consumer tails the app's default
        channel: another `channel_id` is refused."""
        from predictionio_tpu_torch.online import OnlineConsumer, TenantApplyHost

        if channel_id is not None:
            raise ValueError("the port's online consumer tails the default channel; "
                             f"channel_id={channel_id} is not supported")
        tenant = self.tenant(tenant_id)
        if tenant is None:
            raise UnknownTenant(tenant_id)
        if self.cache.peek_runtime(tenant_id) is None:
            self.cache.acquire_and_release(tenant)
        old = self._online.get(tenant_id)
        if old is not None:
            old.stop()
            if hasattr(old, "stopped") and not old.stopped():
                # a second writer of the same cursor record
                raise RuntimeError(f"tenant {tenant_id}: previous online consumer did "
                                   "not stop; refusing a second writer on its cursor")
        c = consumer or OnlineConsumer(self.storage, TenantApplyHost(self, tenant_id),
                                       app_id, config=config, metrics=self.metrics)
        self._online[tenant_id] = c
        c.start()
        return c

    def detach_online(self, tenant_id: str) -> bool:
        c = self._online.pop(tenant_id, None)
        if c is None:
            return False
        c.stop()
        return True

    def online_status(self, tenant_id: str) -> dict:
        c = self._online.get(tenant_id)
        if c is None:
            return {"state": "detached", "tenant": tenant_id}
        return dict(c.status(), state="attached", tenant=tenant_id)

    # -- per-tenant rollouts -------------------------------------------------
    def _host(self, tenant_id: str) -> _TenantRolloutHost:
        with self._lock:
            host = self._hosts.get(tenant_id)
            if host is None:
                host = self._hosts[tenant_id] = _TenantRolloutHost(self, tenant_id)
            return host

    def start_rollout(self, tenant_id: str, body: dict) -> dict:
        """Canary a registered version for one tenant; no other tenant's
        traffic moves. The version is `body`'s ``version``, else the
        variant's newest ``trained`` one."""
        from predictionio_tpu_torch.deploy.registry import ModelRegistry
        from predictionio_tpu_torch.deploy.rollout import RolloutConfig, RolloutController

        tenant = self.tenant(tenant_id)
        if tenant is None:
            raise UnknownTenant(tenant_id)
        registry = ModelRegistry(self.storage)
        vid = body.get("version")
        if vid:
            version = registry.get(vid)
            if version is None:
                raise ValueError(f"no model version {vid!r}")
        else:
            trained = registry.list(tenant.engine_id, tenant.engine_variant, status="trained")
            if not trained:
                raise ValueError(f"no trained model version for {tenant.engine_id}/"
                                 f"{tenant.engine_variant} — train first")
            version = trained[0]
        overrides = {k: body[k] for k in (
            "fraction", "window_s", "interval_s", "min_requests", "max_error_delta",
            "max_p99_ratio", "bake_s", "shadow", "min_agreement") if k in body}
        config = RolloutConfig.from_env(**overrides)
        if config.shadow:
            # nothing feeds a tenant rollout's agreement window (the mux
            # has no mirror path), so a shadow canary would never reach
            # min_requests and would pin its baseline for ever
            raise ValueError("tenant rollouts do not support shadow mode yet; "
                             "use a traffic fraction")
        host = self._host(tenant_id)
        controller = RolloutController(host, version, config, scope=f"tenant/{tenant_id}")
        # warm and pin the baseline before the (slow) candidate build;
        # unpinned again if the start fails and no other rollout holds it
        self.cache.warm_and_pin(tenant)
        try:
            controller.start()
        except Exception:
            active = host.rollout
            if active is None or active.st.state not in ("starting", "canary"):
                self.cache.pin(tenant_id, on=False)
            raise
        return controller.status()

    def rollout_status(self, tenant_id: str) -> dict:
        with self._lock:
            host = self._hosts.get(tenant_id)
        if host is None or host.rollout is None:
            return {"state": "none", "tenant": tenant_id}
        return dict(host.rollout.status(), tenant=tenant_id)

    def abort_rollout(self, tenant_id: str, reason: str) -> dict:
        from predictionio_tpu_torch.workflow.server import RolloutConflict

        with self._lock:
            host = self._hosts.get(tenant_id)
        rollout = host.rollout if host is not None else None
        if rollout is None or rollout.st.state != "canary":
            raise RolloutConflict(f"tenant {tenant_id}: no active rollout to abort")
        rollout.stop()
        if rollout.st.state != "canary":
            raise RolloutConflict(f"rollout already {rollout.st.state}; nothing to abort")
        rollout.abort(reason)
        return dict(rollout.status(), tenant=tenant_id)

    # -- reporting -----------------------------------------------------------
    def status(self) -> dict[str, Any]:
        self.refresh()
        with self._lock:
            tenants = dict(self._tenants)
            hosts = dict(self._hosts)
        quota = self.quota.snapshot()
        return {
            "tenants": {
                tid: {
                    **t.to_dict(),
                    "quota": quota.get(tid),
                    "rollout": (hosts[tid].rollout.st.state
                                if tid in hosts and hosts[tid].rollout is not None
                                else "none"),
                }
                for tid, t in tenants.items()
            },
            "cache": self.cache.stats(),
        }

    def tenant_status(self, tenant_id: str) -> dict[str, Any]:
        tenant = self.tenant(tenant_id)
        if tenant is None:
            raise UnknownTenant(tenant_id)
        cache = self.cache.stats()
        return {
            **tenant.to_dict(),
            "quota": self.quota.snapshot(tenant_id).get(tenant_id),
            "resident": tenant_id in cache["entries"],
            "rollout": self.rollout_status(tenant_id),
        }
