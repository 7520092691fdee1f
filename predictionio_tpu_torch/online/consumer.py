"""Stream consumer: tail the event store, fold, publish, advance the
cursor.

Counterpart of the JAX package's ``online/consumer.py``. One background
thread a consumer; each tick:

1. **tail**: `find_since` on each of the store's revision streams (one
   a plain store; one a shard of a sharded store, filtered to that
   shard's primaries, so that a successor's copies fold once) from the
   durable cursor, one entry a stream. Revisions are assigned
   at insert, so no client-supplied event time reorders the fold.
2. **fold**: `ALSFoldIn.apply` re-solves every dirty user's (and new
   item's) row against the fixed opposite side into a new model and
   runtime.
3. **guard**: the folded factors are checked for drift against the
   last-trained baseline BEFORE they publish; a breach pauses fold-in
   and the last-good model keeps serving (the cursor stays, nothing is
   lost).
4. **publish**: the new runtime swaps in under the host's discipline
   (the query server's swap lock, or the tenant cache's conditional
   swap), only if the runtime is still the one the tick folded from (a
   reload or promote that landed mid-tick wins; the tick runs again on
   it).
5. **persist**: the cursor AND the cumulative counters go in ONE
   lifecycle-record append. A crash before it replays the tick (the
   re-solve is state-based, so the replay is idempotent) and the
   counters count each event once.

The consumer tails the app's default channel. A drift pause shows in
`status()` and the `online_paused` gauge, and raises the process
monitor's external alert ``online_drift_pause/<cursor id>`` (shown at
``GET /alerts`` and pushed through the alert sinks); `resume` resolves
it. A consumer beside a follower of the replicated event store names
its own cursor record (``OnlineConsumerConfig.name``, one a replica, on
the shared control storage) and may adopt, once, the record of an older
name (``migrate_from``; the adopted record carries ``migrated_from``).
A consumer of one tenant of a multi-tenant server publishes through
`TenantApplyHost`: the model cache's conditional swap of that tenant's
runtime (its cursor record ``online/<app>/tenant/<id>``).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from predictionio_tpu_torch.online.drift import DriftGuard
from predictionio_tpu_torch.online.foldin import ALSFoldIn, FoldInConfig
from predictionio_tpu_torch.utils.env import ONLINE_KEYS, env_float

log = logging.getLogger(__name__)

CURSOR_ENTITY = "pio_online_cursor"
DRIFT_ALERT = "online_drift_pause"

_COUNTERS = ("events_consumed", "events_folded", "users_folded",
             "items_folded", "ticks")

BATCH_LIMIT = 512  # events a tick
COMPACT_EVERY = 64  # compact the cursor record every N persisted ticks


def _env(name: str):
    return field(default_factory=lambda: env_float(name, ONLINE_KEYS[name]))


@dataclass
class OnlineConsumerConfig:
    tick_s: float = _env("PIO_ONLINE_TICK_S")
    foldin: FoldInConfig = field(default_factory=FoldInConfig)
    drift_threshold: float = _env("PIO_ONLINE_DRIFT_THRESHOLD")
    # a drift pause that has seen a retrain waits this long, then
    # resumes and lets the next fold probe drift again; 0 resumes on the
    # retrain itself
    drift_cooldown_s: float = _env("PIO_ONLINE_DRIFT_COOLDOWN_S")
    # with no persisted cursor, start at the store's latest revision
    # instead of its head (the history is already in the trained model)
    from_latest: bool = False
    # the cursor record's id, for one consumer a replica (default
    # online/<app>/<scope>)
    name: Optional[str] = None
    # a one-shot migration: with no record under this consumer's id,
    # adopt the record at this older id and persist it under the new one
    # with a `migrated_from` marker; later starts find the new record
    migrate_from: Optional[str] = None


class ServerApplyHost:
    """The query server's publish seam: the swap happens under its swap
    lock, only if the runtime is still the one the tick folded from."""

    scope = "server"

    def __init__(self, server):
        self.server = server

    def current(self):
        return self.server.runtime

    def swap(self, expected, new_runtime) -> bool:
        with self.server._swap_lock:  # noqa: SLF001 — the documented seam
            if self.server.runtime is not expected:
                return False
            self.server.runtime = new_runtime
            return True


class TenantApplyHost:
    """One tenant's publish seam in a `TenantMux`: the swap is
    ``ModelCache.swap_runtime``, conditional on the tenant still serving
    the runtime the tick folded from, lease-safe (queries in flight
    drain on the old entry) and unseen by the other tenants."""

    def __init__(self, mux, tenant_id: str):
        self.mux = mux
        self.tenant_id = tenant_id
        self.scope = f"tenant/{tenant_id}"

    def current(self):
        return self.mux.cache.peek_runtime(self.tenant_id)

    def swap(self, expected, new_runtime) -> bool:
        return self.mux.cache.swap_runtime(self.tenant_id, expected, new_runtime)


class OnlineConsumer:
    """Background event-stream consumer feeding one serving runtime."""

    thread_name = "online-consumer"

    def __init__(self, storage, host, app_id: int,
                 config: Optional[OnlineConsumerConfig] = None,
                 metrics=None):
        from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore
        from predictionio_tpu_torch.obs import get_default_registry

        self.storage = storage
        self.host = host
        self.app_id = app_id
        self.config = config or OnlineConsumerConfig()
        self.foldin = ALSFoldIn(self.config.foldin)
        self.guard = DriftGuard(threshold=self.config.drift_threshold)
        self._records = LifecycleRecordStore(storage)
        # one writer a record: a restarted consumer resumes the same one,
        # and each replica of a replicated tier names its own
        self.cursor_id = (self.config.name
                          or f"online/{app_id}/{getattr(host, 'scope', 'server')}")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._paused: Optional[str] = None  # guarded-by: _lock
        self._drift_paused = False  # clears on a retrain  # guarded-by: _lock
        # monotonic time of the retrain seen while drift-paused
        self._retrain_seen_at: Optional[float] = None
        self._last_runtime: Any = None
        self._ticks_persisted = 0
        self._last_error: Optional[str] = None
        # test seam: crash after the publish, before the persist
        self._crash_after_apply = False

        rec = self._records.fold(CURSOR_ENTITY, self.cursor_id).get(
            self.cursor_id) or {}
        self.migrated_from: Optional[str] = rec.get("migrated_from") or None
        adopt_legacy = False
        legacy_id = self.config.migrate_from
        if not rec and legacy_id and legacy_id != self.cursor_id:
            legacy = self._records.fold(CURSOR_ENTITY, legacy_id).get(legacy_id) or {}
            if legacy:
                rec, adopt_legacy, self.migrated_from = legacy, True, legacy_id
                log.info("adopting online cursor %s as %s (one-shot migration)",
                         legacy_id, self.cursor_id)
        self.cursor: dict[str, int] = {
            k: int(v) for k, v in (rec.get("cursor") or {}).items()}
        if not rec and self.config.from_latest:
            for key, stream_store, _shard in storage.get_events().revision_streams():
                self.cursor[key] = stream_store.latest_revision(app_id)
        self.counters: dict[str, int] = {k: int(rec.get(k, 0)) for k in _COUNTERS}
        # the baseline watermark: the trained instance the folds sit on
        # and the cursor when it was adopted. A runtime REBUILT from the
        # same instance dropped every fold since, so the cursor rewinds
        # there and the window re-folds (idempotent); a new instance (a
        # retrain) moves the watermark instead
        self._baseline_instance: Optional[str] = rec.get("baseline_instance") or None
        self._baseline_cursor: Optional[dict[str, int]] = {
            k: int(v) for k, v in (rec.get("baseline_cursor") or {}).items()
        } or None
        if adopt_legacy:
            # persisted under the new id at once: the next start finds it
            # and never reads the old id again (which stays for replicas
            # yet to migrate)
            self._records.append(CURSOR_ENTITY, self.cursor_id, {
                "cursor": dict(self.cursor), **self.counters,
                "scope": getattr(self.host, "scope", "server"),
                "app_id": self.app_id,
                "baseline_instance": self._baseline_instance,
                "baseline_cursor": dict(self._baseline_cursor or {}),
                "migrated_from": legacy_id,
                "updated_at": time.time(),
            })

        # the tick, drift and pause figures live here and `status()`
        # reads them back; the cumulative counts are `self.counters`,
        # persisted with the cursor. Per-consumer `scope` label: two
        # consumers on one family would mask each other
        self.metrics = metrics or get_default_registry()
        self._tick_hist = self.metrics.histogram(
            "online_fold_tick_seconds",
            "one consumer tick: tail read + fold solve + publish", ("scope",))
        self._drift_gauge = self.metrics.gauge(
            "online_drift_score",
            "score drift of the folded model from the last-trained baseline",
            ("scope",))
        self._paused_gauge = self.metrics.gauge(
            "online_paused", "1 while fold-in is paused (drift or operator)",
            ("scope",))

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name=self.thread_name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            if t.is_alive():
                # a wedged tick: the handle stays, so no replacement
                # starts a second writer on the cursor record
                log.error("online consumer %s did not stop within 10 s",
                          self.cursor_id)
            else:
                self._thread = None

    def stopped(self) -> bool:
        """No consumer thread runs: what a re-attach must check first."""
        t = self._thread
        return t is None or not t.is_alive()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the next tick retries
                self._last_error = "tick failed (see log)"
                log.exception("online fold tick failed; will retry")

    # -- pause / resume -----------------------------------------------------
    @property
    def paused(self) -> Optional[str]:
        return self._paused

    def pause(self, reason: str, by_drift: bool = False) -> None:
        with self._lock:
            self._paused = reason
            self._drift_paused = by_drift
            self._retrain_seen_at = None
        self._paused_gauge.set(1.0, scope=self.cursor_id)
        log.warning("online fold-in paused: %s", reason)

    @property
    def alert_name(self) -> str:
        """This consumer's drift-alert id: two consumers must not share
        one alert (resuming one would resolve the other's page)."""
        return f"{DRIFT_ALERT}/{self.cursor_id}"

    def resume(self) -> None:
        """Clear a pause; the cursor did not move, so the paused window
        folds next (idempotent). Resolves the drift alert."""
        with self._lock:
            self._paused = None
            self._drift_paused = False
            self._retrain_seen_at = None
        self._paused_gauge.set(0.0, scope=self.cursor_id)
        try:
            from predictionio_tpu_torch.obs.monitor import get_monitor

            get_monitor().resolve_alert(self.alert_name)
        except Exception:
            log.debug("drift alert resolve failed", exc_info=True)
        log.info("online fold-in resumed")

    def _raise_drift_alert(self, drift: float) -> None:
        try:
            from predictionio_tpu_torch.obs.monitor import get_monitor

            get_monitor().raise_alert(self.alert_name, {
                "scope": getattr(self.host, "scope", "server"),
                "drift": round(drift, 4),
                "threshold": self.guard.threshold,
                "cursor_id": self.cursor_id,
                "hint": "fold-in paused; retrain or POST /online/resume",
            })
        except Exception:
            log.exception("drift alert raise failed")

    # -- one tick -----------------------------------------------------------
    def _observe_runtime(self, runtime) -> None:
        """The host's runtime changed under the consumer: a start, a
        retrain, or a rebuild of the same instance."""
        _ix, model = self.foldin.find_model(runtime)
        if model is not None:
            self.guard.rebase(model.factors)
            self._drift_gauge.set(self.guard.last_drift, scope=self.cursor_id)
        inst_id = getattr(getattr(runtime, "instance", None), "id", None)
        if self._last_runtime is None:
            # a (re)start: the server kept its folds while the consumer
            # was down, so no rewind (it would double-count the counters)
            if inst_id != self._baseline_instance or self._baseline_cursor is None:
                self._baseline_instance = inst_id
                self._baseline_cursor = dict(self.cursor)
        elif (inst_id is not None and inst_id == self._baseline_instance
              and self._baseline_cursor is not None):
            log.info("runtime rebuilt from instance %s: rewinding cursor %s "
                     "to its baseline to re-fold", inst_id, self.cursor_id)
            self.cursor = dict(self._baseline_cursor)
        else:
            self._baseline_instance = inst_id
            self._baseline_cursor = dict(self.cursor)
        self._last_runtime = runtime
        if self._paused is not None and self._drift_paused:
            if self.config.drift_cooldown_s > 0:
                with self._lock:
                    self._retrain_seen_at = time.monotonic()
            else:
                self.resume()

    def tick(self) -> dict[str, Any]:
        """One consume-fold-publish-persist pass. Public, so tests and
        the console drive it without the thread."""
        t0 = time.perf_counter()
        runtime = self.host.current()
        if runtime is None:
            return {"idle": "no runtime"}
        if runtime is not self._last_runtime:
            self._observe_runtime(runtime)
        if (self._paused is not None and self._drift_paused
                and self._retrain_seen_at is not None
                and time.monotonic() - self._retrain_seen_at
                >= self.config.drift_cooldown_s):
            # the cool-down after a retrain is over: resume, and the next
            # fold probes drift against the rebased baseline
            self.resume()
        if self._paused is not None:
            return {"paused": self._paused}

        store = self.storage.get_events()
        new_cursor = dict(self.cursor)
        batch: list = []
        for key, stream_store, shard in store.revision_streams():
            events = stream_store.find_since(
                self.app_id, self.cursor.get(key, 0), limit=BATCH_LIMIT,
                shard=shard)
            for e in events:
                if e.revision is not None and e.revision > new_cursor.get(key, 0):
                    new_cursor[key] = e.revision
            batch.extend(events)
        if not batch:
            if self.foldin.pending_items:
                return self._pending_tick(runtime, t0)
            return {"idle": "no new events"}
        seen: set[str] = set()
        deduped = []
        for e in batch:
            if e.event_id and e.event_id in seen:
                continue
            if e.event_id:
                seen.add(e.event_id)
            deduped.append(e)
        relevant = [e for e in deduped if self.foldin._relevant(e)]

        result = (self.foldin.apply(self.storage, self.app_id, None, runtime,
                                    relevant)
                  if relevant else None)
        if result is None and self.foldin.pending_items:
            # a tick of irrelevant traffic must drain the carry too
            result = self.foldin.apply_pending(self.storage, self.app_id, None,
                                               runtime)
        stats = None
        if result is not None:
            new_runtime, new_model, stats = result
            verdict = self._guard_and_publish(runtime, new_runtime, new_model,
                                              stats)
            if verdict is not None:
                return verdict

        if self._crash_after_apply:
            raise RuntimeError("injected crash between apply and persist")

        # ONE record append carries the cursor and the counters
        folded = len(relevant) if stats else 0
        self.cursor = new_cursor
        self.counters["events_consumed"] += len(deduped)
        self.counters["events_folded"] += folded
        if stats is not None:
            self.counters["users_folded"] += stats.users_folded
            self.counters["items_folded"] += stats.items_folded
        self._persist()

        dt = time.perf_counter() - t0
        self._tick_hist.observe(dt, scope=self.cursor_id)
        self._last_error = None
        return {"consumed": len(deduped), "folded": folded,
                "stats": stats.to_dict() if stats else None, "seconds": dt}

    def _guard_and_publish(self, runtime, new_runtime, new_model,
                           stats) -> Optional[dict[str, Any]]:
        """Drift check, then the conditional swap; the fold's carry is
        committed only when it published. Returns the tick's early result
        on a pause or a lost race, None when published."""
        drift = self.guard.check(new_model.factors)
        self._drift_gauge.set(drift, scope=self.cursor_id)
        if drift > self.guard.threshold:
            reason = (f"score drift {drift:.3f} > threshold "
                      f"{self.guard.threshold:.3f}")
            self.pause(reason, by_drift=True)
            self._raise_drift_alert(drift)
            return {"paused": reason, "drift": drift}
        if not self.host.swap(runtime, new_runtime):
            # a reload swapped mid-tick: fold again on it next tick
            return {"retry": "runtime changed during fold"}
        self._last_runtime = new_runtime
        self.foldin.commit_pending(stats.pending_after)
        return None

    def _pending_tick(self, runtime, t0: float) -> dict[str, Any]:
        """An item-only pass draining the carry on an idle stream (the
        cursor and the consumed count stay; the solves are counted)."""
        result = self.foldin.apply_pending(self.storage, self.app_id, None,
                                           runtime)
        if result is None:
            return {"idle": "no new events"}
        new_runtime, new_model, stats = result
        verdict = self._guard_and_publish(runtime, new_runtime, new_model, stats)
        if verdict is not None:
            return verdict
        self.counters["items_folded"] += stats.items_folded
        self._persist()
        dt = time.perf_counter() - t0
        self._tick_hist.observe(dt, scope=self.cursor_id)
        return {"consumed": 0, "folded": 0, "stats": stats.to_dict(),
                "seconds": dt}

    def _persist(self) -> None:
        self.counters["ticks"] += 1
        props = {
            "cursor": dict(self.cursor), **self.counters,
            "scope": getattr(self.host, "scope", "server"),
            "app_id": self.app_id,
            "baseline_instance": self._baseline_instance,
            "baseline_cursor": dict(self._baseline_cursor or {}),
            "updated_at": time.time(),
        }
        self._records.append(CURSOR_ENTITY, self.cursor_id, props)
        self._ticks_persisted += 1
        if self._ticks_persisted % COMPACT_EVERY == 0:
            try:
                # one writer: compact at once (no quiescence wait)
                self._records.compact(CURSOR_ENTITY, self.cursor_id,
                                      min_age_s=0.0)
            except Exception:  # noqa: BLE001 — the fold stays correct
                log.exception("cursor record compaction failed")

    # -- reporting ----------------------------------------------------------
    def status(self) -> dict[str, Any]:
        scope = self.cursor_id
        return {
            "cursor_id": self.cursor_id,
            "app_id": self.app_id,
            "scope": getattr(self.host, "scope", "server"),
            "running": self._thread is not None,
            "paused": self._paused,
            "cursor": dict(self.cursor),
            "counters": dict(self.counters),
            "drift": round(self._drift_gauge.value(scope=scope), 4),
            "drift_threshold": self.guard.threshold,
            "drift_cooldown_s": self.config.drift_cooldown_s,
            "cooling_down": self._retrain_seen_at is not None,
            "migrated_from": self.migrated_from,
            "tick_s": self.config.tick_s,
            "ticks_timed": self._tick_hist.count_of(scope=scope),
            "tick_seconds_p50": self._tick_hist.quantile(0.5, scope=scope),
            "tick_seconds_p99": self._tick_hist.quantile(0.99, scope=scope),
            "last_error": self._last_error,
        }
