"""LRU model cache: many tenant runtimes resident on one query server.

Counterpart of the JAX package's ``tenancy/cache.py``. The cache holds up
to `capacity` built ``EngineRuntime``s keyed by tenant and rebuilds an
evicted one on demand (a miss is a model load, not an error). Driven by
the model version registry:

- each entry remembers the version it was built from; `sync` finds a
  promote and builds the new live version off the serving path,
  swapping it in without a miss,
- entries serving an active canary are **pinned** (a rollout's verdict
  windows need their baseline for the whole bake),
- a runtime with queries in flight (``refs > 0``) is never evicted: the
  dispatcher groups by runtime, and a query keeps its lease until its
  bookkeeping is done,
- eviction is LRU over the rest; with everything pinned or in flight the
  cache runs over capacity rather than failing admissions.

With `hbm_bytes` set, eviction is by measured device bytes instead of
entry count: LRU victims go until the resident bytes and one dispatch's
transient working set fit the budget. The bytes of a runtime are its
models' own (``ALSModel.resident_device_bytes``: the staged serving
state); a torch tensor is charged once per storage, so views of one
storage are not counted twice. One card: no sharded arithmetic.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)


class ModelLoadError(RuntimeError):
    """The tenant's model could not be resolved or built."""


def _array_device_bytes(x: Any, storages: set) -> Optional[float]:
    """Resident bytes of one array-like, or None when `x` is not one. A
    torch tensor is charged its storage's bytes the first time that
    storage is seen in the walk (0 after), so views share one charge; a
    numpy array its nbytes (an object array, host metadata, 0)."""
    storage_of = getattr(x, "untyped_storage", None)
    if callable(storage_of) and hasattr(x, "is_cuda"):
        st = storage_of()
        key = (str(x.device), st.data_ptr())
        if key in storages:
            return 0.0
        storages.add(key)
        return float(st.nbytes())
    n = getattr(x, "nbytes", None)
    if not isinstance(n, (int, float)):
        return None
    dt = getattr(x, "dtype", None)
    if dt is not None and getattr(dt, "kind", "") == "O":
        return 0.0
    return float(n)


def estimate_runtime_device_bytes(runtime: Any) -> float:
    """Resident device bytes of one runtime: its models' arrays, what
    sits in device memory between queries. A model that reports its own
    footprint (``resident_device_bytes``: the staged serving state, or
    the factor matrices once) is charged that; other objects are walked
    through dicts, lists, tuples and attributes. (The dispatch's
    transient working set is charged once against the budget by the
    cache, not per entry.)"""
    total = 0.0
    seen: set[int] = set()
    storages: set = set()

    def walk(x: Any) -> None:
        nonlocal total
        if id(x) in seen:
            return
        seen.add(id(x))
        fn = getattr(x, "resident_device_bytes", None)
        if callable(fn):
            try:
                total += float(fn())
                return
            except Exception:  # noqa: BLE001 — walk the object instead
                log.exception("resident_device_bytes hook failed")
        n = _array_device_bytes(x, storages)
        if n is not None:
            total += n
            return
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            d = getattr(x, "__dict__", None)
            if d is not None:
                for v in d.values():
                    walk(v)

    for model in getattr(runtime, "models", ()) or ():
        walk(model)
    return total


def serving_transient_bytes() -> float:
    """The largest output + temp working set the device profiler measured
    for a profiled executable (``memory_analysis_ok``: the serving verbs
    and the fold): the device memory a dispatch needs beyond the
    resident state. Read at eviction time, so it follows the profiles
    gathered so far."""
    try:
        from predictionio_tpu_torch.obs.devprof import get_profiler

        transient = 0.0
        for row in get_profiler().report().get("executables", ()):
            if row.get("memory_analysis_ok"):
                transient = max(transient, float(row.get("output_bytes") or 0.0)
                                + float(row.get("temp_bytes") or 0.0))
        return transient
    except Exception:  # noqa: BLE001 — a broken profile never stops eviction
        return 0.0


class CacheEntry:
    """One resident tenant runtime."""

    __slots__ = ("tenant_id", "version_key", "runtime", "refs", "pinned",
                 "last_used", "loaded_at", "device_bytes")

    def __init__(self, tenant_id: str, version_key: str, runtime: Any):
        self.tenant_id = tenant_id
        self.version_key = version_key
        self.runtime = runtime
        self.refs = 0
        self.pinned = False
        self.last_used = time.monotonic()
        self.loaded_at = time.monotonic()
        self.device_bytes = 0.0


class ModelCache:
    """Tenant id → runtime, bounded by `capacity` resident entries (or
    by `hbm_bytes` of measured device bytes). Runtimes are built on
    `device` (the first CUDA device when None)."""

    def __init__(self, storage, capacity: int = 4,
                 build: Optional[Callable[[Any], Any]] = None,
                 hbm_bytes: Optional[float] = None,
                 measure: Optional[Callable[[Any], float]] = None,
                 transient: Optional[Callable[[], float]] = None,
                 device: Optional[str] = None):
        self.storage = storage
        self.capacity = max(1, int(capacity))
        self.device = device
        self._build_fn = build
        self.hbm_bytes = float(hbm_bytes) if hbm_bytes else None
        self._measure = measure or estimate_runtime_device_bytes
        self._transient = transient or serving_transient_bytes
        self._lock = threading.Lock()
        self._entries: dict[str, CacheEntry] = {}  # guarded-by: _lock
        # a build lock a tenant: one build for a tenant's concurrent
        # misses, never blocking other tenants' hits
        self._load_locks: dict[str, threading.Lock] = {}  # guarded-by: _lock
        self._seen: set[str] = set()  # tenants ever loaded  # guarded-by: _lock
        self.hits = 0
        self.misses = 0
        self.reloads = 0
        self.evictions = 0

    # -- resolution ----------------------------------------------------------
    def resolve_version(self, tenant) -> tuple[str, Any]:
        """(version key, engine instance) the tenant serves: the
        registry's live version when there is one, else the newest
        COMPLETED instance of the tenant's variant."""
        from predictionio_tpu_torch.deploy.registry import ModelRegistry

        live = ModelRegistry(self.storage).live_version(tenant.engine_id, tenant.engine_variant)
        instances = self.storage.get_meta_data_engine_instances()
        if live is not None:
            inst = instances.get(live.instance_id)
            if inst is not None:
                return live.id, inst
            log.warning("tenant %s: live version %s references missing instance %s; "
                        "falling back to latest completed",
                        tenant.id, live.id, live.instance_id)
        inst = instances.get_latest_completed(
            tenant.engine_id, tenant.engine_version, tenant.engine_variant)
        if inst is None:
            raise ModelLoadError(
                f"tenant {tenant.id!r} has no servable model for "
                f"{tenant.engine_id}/{tenant.engine_variant} — train first")
        return f"inst:{inst.id}", inst

    def _build(self, instance) -> Any:
        if self._build_fn is not None:
            return self._build_fn(instance)
        from predictionio_tpu_torch.workflow.server import build_runtime

        return build_runtime(self.storage, instance, device=self.device)

    # -- the serving path ----------------------------------------------------
    def acquire(self, tenant) -> CacheEntry:
        """Hit or load the tenant's runtime and take a lease on it; the
        caller must `release` the entry once the query's bookkeeping is
        done."""
        with self._lock:
            entry = self._entries.get(tenant.id)
            if entry is not None:
                entry.refs += 1
                entry.last_used = time.monotonic()
                self.hits += 1
                return entry
            load_lock = self._load_locks.get(tenant.id)
            if load_lock is None:
                load_lock = self._load_locks[tenant.id] = threading.Lock()
        with load_lock:
            # another thread may have loaded it while this one waited
            with self._lock:
                entry = self._entries.get(tenant.id)
                if entry is not None:
                    entry.refs += 1
                    entry.last_used = time.monotonic()
                    self.hits += 1
                    return entry
                self.misses += 1
                if tenant.id in self._seen:
                    self.reloads += 1  # evicted earlier: a transparent reload
            version_key, instance = self.resolve_version(tenant)
            try:
                runtime = self._build(instance)
            except Exception as e:
                raise ModelLoadError(f"tenant {tenant.id!r} model load failed: {e}") from e
            nbytes = self._measure_safe(runtime)
            with self._lock:
                entry = CacheEntry(tenant.id, version_key, runtime)
                entry.refs = 1
                entry.device_bytes = nbytes
                self._entries[tenant.id] = entry
                self._seen.add(tenant.id)
                self._evict_locked()
                return entry

    def release(self, entry: CacheEntry) -> None:
        with self._lock:
            if entry.refs > 0:
                entry.refs -= 1

    def acquire_and_release(self, tenant) -> None:
        """Warm the tenant's entry without keeping a lease."""
        self.release(self.acquire(tenant))

    def warm_and_pin(self, tenant) -> None:
        """Warm and pin in one step: the entry is pinned while the lease
        still holds it, so the baseline of a rollout is never evictable
        between its warm-up and its pin."""
        entry = self.acquire(tenant)
        try:
            with self._lock:
                entry.pinned = True
                cur = self._entries.get(entry.tenant_id)
                if cur is not None and cur is not entry:
                    cur.pinned = True  # a concurrent swap replaced it
        finally:
            self.release(entry)

    # -- registry-driven prefetch, rollout and fold-in hooks -----------------
    def put_runtime(self, tenant_id: str, runtime: Any, version_key: str) -> None:
        """Swap in a built runtime (a rollout's promote: the candidate
        becomes the tenant's entry; the old one drains as its leases
        release)."""
        nbytes = self._measure_safe(runtime)
        with self._lock:
            old = self._entries.get(tenant_id)
            entry = CacheEntry(tenant_id, version_key, runtime)
            entry.device_bytes = nbytes
            if old is not None:
                entry.pinned = old.pinned
            self._entries[tenant_id] = entry
            self._seen.add(tenant_id)
            self._evict_locked()

    def peek_runtime(self, tenant_id: str):
        """The tenant's resident runtime without a lease (the online
        consumer's read point); None when not resident."""
        with self._lock:
            entry = self._entries.get(tenant_id)
            return entry.runtime if entry is not None else None

    def swap_runtime(self, tenant_id: str, expected: Any, runtime: Any) -> bool:
        """Conditional copy-on-write swap (online fold-in): the entry is
        replaced only if it still serves `expected` (a promote that
        landed mid-fold wins, and the caller retries on it). Leases stay
        on the old entry, so its queries drain; the pin and the version
        carry over. Device bytes are measured again (a fold grows the
        tables) and the budget is checked after the swap."""
        nbytes = self._measure_safe(runtime)
        with self._lock:
            old = self._entries.get(tenant_id)
            if old is None or old.runtime is not expected:
                return False
            entry = CacheEntry(tenant_id, old.version_key, runtime)
            entry.pinned = old.pinned
            entry.last_used = old.last_used
            entry.device_bytes = nbytes
            self._entries[tenant_id] = entry
            self._evict_locked()
            return True

    def pin(self, tenant_id: str, on: bool = True) -> None:
        with self._lock:
            entry = self._entries.get(tenant_id)
            if entry is not None:
                entry.pinned = on

    def invalidate(self, tenant_id: str) -> None:
        """Drop the tenant's entry and its bookkeeping (its build lock and
        its seen mark), which would otherwise grow with tenant churn."""
        with self._lock:
            self._entries.pop(tenant_id, None)
            self._load_locks.pop(tenant_id, None)
            self._seen.discard(tenant_id)

    def sync(self, tenants) -> int:
        """Prefetch on promote: for each resident tenant whose live
        version moved, build the new runtime off the serving path and
        swap it in. Returns how many were refreshed. (Only resident
        tenants: loading every tenant would defeat the bound.)"""
        refreshed = 0
        for tenant in tenants:
            with self._lock:
                entry = self._entries.get(tenant.id)
            if entry is None:
                continue
            try:
                version_key, instance = self.resolve_version(tenant)
            except ModelLoadError:
                continue  # nothing servable now: keep what is loaded
            if version_key == entry.version_key:
                continue
            try:
                runtime = self._build(instance)
            except Exception:  # noqa: BLE001 — the previous runtime serves on
                log.exception("tenant %s: prefetch of %s failed; serving the "
                              "previous runtime", tenant.id, version_key)
                continue
            self.put_runtime(tenant.id, runtime, version_key)
            refreshed += 1
        return refreshed

    # -- eviction ------------------------------------------------------------
    def _measure_safe(self, runtime: Any) -> float:
        if self.hbm_bytes is None:
            return 0.0
        try:
            return float(self._measure(runtime))
        except Exception:  # noqa: BLE001 — an unmeasured entry weighs 0
            log.exception("runtime device-bytes measurement failed")
            return 0.0

    def resident_bytes(self) -> float:
        with self._lock:
            return sum(e.device_bytes for e in self._entries.values())

    def _over_capacity_locked(self) -> bool:
        if self.hbm_bytes is not None:
            # the resident bytes plus ONE dispatch's transient set (the
            # dispatches share it), never evicting down to an empty cache
            # (one oversized model still serves, over the budget)
            try:
                transient = float(self._transient())
            except Exception:  # noqa: BLE001
                transient = 0.0
            return len(self._entries) > 1 and (
                sum(e.device_bytes for e in self._entries.values()) + transient
                > self.hbm_bytes)
        return len(self._entries) > self.capacity

    def _evict_locked(self) -> None:
        while self._over_capacity_locked():
            victims = [e for e in self._entries.values() if e.refs == 0 and not e.pinned]
            if not victims:
                # everything pinned or in flight: run over capacity (a
                # refused admission would turn a bound into an outage)
                return
            victim = min(victims, key=lambda e: e.last_used)
            del self._entries[victim.tenant_id]
            self.evictions += 1

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "capacity": self.capacity,
                "hbm_bytes": self.hbm_bytes,
                "resident_bytes": sum(e.device_bytes for e in self._entries.values()),
                "resident": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "reloads": self.reloads,
                "evictions": self.evictions,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "entries": {
                    tid: {
                        "version": e.version_key,
                        "refs": e.refs,
                        "pinned": e.pinned,
                        "bytes": e.device_bytes,
                        "idle_s": round(time.monotonic() - e.last_used, 1),
                    }
                    for tid, e in self._entries.items()
                },
            }
