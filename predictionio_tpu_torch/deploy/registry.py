"""Lifecycle records and the model version registry: last-write-wins
field folds over a reserved event-store namespace.

Counterpart of the JAX package's ``deploy/registry.py``. A record is the
fold of ``$set`` events of one (entity type, entity id) in the app
``LIFECYCLE_APP_ID``, ordered by (event time, ``_seq``), each newer
field winning; status changes append, so a record's events are its
audit trail. ``LifecycleRecordStore`` is the record layer (the online
consumer's cursor, the job queue of ``scheduler.py`` and the versions
here build on it). ``ModelRegistry`` keeps ``ModelVersion`` records:
one per COMPLETED train, with its engine instance (the MODELDATA blob
key), the hash of its stage params, status ``trained|canary|live|
rolled_back|archived``, the live version at registration as its
``parent_version`` and the submitting job's id. Retention GC keeps
live and canary versions and the newest N others per engine variant.
The namespace, entity types, field names and the fold are the JAX
package's, so a record that either package writes into a shared store
is read by the other.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import itertools
import json
import logging
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from predictionio_tpu_torch.data.event import SET_EVENT, Event
from predictionio_tpu_torch.data.storage.base import EngineInstance, EventQuery

log = logging.getLogger(__name__)

# the reserved namespace: far above any app id a store assigns (sqlite
# table names take no minus sign)
LIFECYCLE_APP_ID = 2_000_000_000

VERSION_ENTITY = "pio_model_version"

# the canary rollout's state records, one per rollout scope
# (deploy/rollout.py), compacted with the versions
ROLLOUT_ENTITY = "pio_rollout"

VERSION_STATUSES = ("trained", "canary", "live", "rolled_back", "archived")

# process-monotonic tie-breaker of updates in one event-time tick
_seq = itertools.count()
_seq_lock = threading.Lock()


def _next_seq() -> int:
    with _seq_lock:
        return next(_seq)


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _fold_key(e: Event):
    return (e.event_time, e.properties.get("_seq", 0))


class LifecycleRecordStore:
    """entity → last-write-wins field fold over the reserved namespace."""

    def __init__(self, storage):
        self.storage = storage
        self._initialized = False

    def _events(self):
        store = self.storage.get_events()
        if not self._initialized:
            store.init_app(LIFECYCLE_APP_ID)
            self._initialized = True
        return store

    def _find(self, entity_type: str, entity_id: Optional[str]) -> list[Event]:
        return list(self._events().find(EventQuery(
            app_id=LIFECYCLE_APP_ID, entity_type=entity_type,
            entity_id=entity_id, event_names=[SET_EVENT],
        )))

    def append(self, entity_type: str, entity_id: str, props: dict) -> str:
        """Append one field update (a ``$set`` event); returns its id."""
        return self._events().insert(
            Event(event=SET_EVENT, entity_type=entity_type,
                  entity_id=entity_id,
                  properties=dict(props, _seq=_next_seq())),
            LIFECYCLE_APP_ID,
        )

    def discard(self, event_id: str) -> None:
        """Best-effort delete of one earlier update (heartbeat
        compaction); a failure leaves an extra event in the fold."""
        try:
            self._events().delete(event_id, LIFECYCLE_APP_ID)
        except Exception:  # noqa: BLE001 — the fold stays right
            log.debug("record compaction delete failed", exc_info=True)

    def fold(self, entity_type: str, entity_id: Optional[str] = None) -> dict:
        """entity_id → merged fields (the newest write of a field wins)."""
        out: dict[str, dict] = {}
        for e in sorted(self._find(entity_type, entity_id), key=_fold_key):
            out.setdefault(e.entity_id, {}).update(e.properties)
        for d in out.values():
            d.pop("_seq", None)
        return out

    def events(self, entity_type: str, entity_id: str) -> list[Event]:
        """One record's update events in a total order (event time,
        ``_seq``, event id): the claim read of ``scheduler.py``, where
        the first bid of a generation wins."""
        return sorted(self._find(entity_type, entity_id),
                      key=lambda e: (*_fold_key(e), e.event_id or ""))

    def compact(self, entity_type: str, entity_id: str, min_events: int = 2,
                min_age_s: float = 60.0) -> int:
        """Fold one record's events into one snapshot event and delete the
        older ones; returns how many went. The snapshot is appended
        before the deletes, so a crash between leaves the fold unchanged.
        A record updated within `min_age_s` is left alone: a write landing
        between this read and the snapshot would be outranked by it."""
        evs = self._find(entity_type, entity_id)
        if len(evs) < max(2, min_events):
            return 0
        if min_age_s > 0:
            newest = max(e.event_time for e in evs)
            if (_utcnow() - newest).total_seconds() < min_age_s:
                return 0
        merged: dict[str, Any] = {}
        for e in sorted(evs, key=_fold_key):
            merged.update(e.properties)
        merged.pop("_seq", None)
        self.append(entity_type, entity_id, merged)
        ids = [e.event_id for e in evs if e.event_id]
        if ids:
            self._events().delete_batch(ids, LIFECYCLE_APP_ID)
        return len(ids)

    def compact_all(self, entity_type: str, min_events: int = 8,
                    min_age_s: float = 60.0) -> int:
        """`compact` every record of `entity_type` with at least
        `min_events` events; returns how many events went."""
        counts: dict[str, int] = {}
        for e in self._find(entity_type, None):
            counts[e.entity_id] = counts.get(e.entity_id, 0) + 1
        removed = 0
        for entity_id, n in counts.items():
            if n >= max(2, min_events):
                try:
                    removed += self.compact(entity_type, entity_id,
                                            min_events=min_events,
                                            min_age_s=min_age_s)
                except Exception:  # noqa: BLE001 — the next sweep retries
                    log.exception("compaction of %s/%s failed (non-fatal)",
                                  entity_type, entity_id)
        return removed

    def purge(self, entity_type: str, entity_id: str) -> int:
        """Delete every event of one record; returns how many existed."""
        ids = [e.event_id for e in self._events().find(EventQuery(
            app_id=LIFECYCLE_APP_ID, entity_type=entity_type,
            entity_id=entity_id)) if e.event_id]
        if not ids:
            return 0
        return self._events().delete_batch(ids, LIFECYCLE_APP_ID)


# a record's fields in the JAX package's order (`models show` prints them)
_VERSION_FIELDS = ("id", "engine_id", "engine_version", "engine_variant",
                   "instance_id", "params_hash", "status", "created_at",
                   "updated_at", "parent_version", "train_metrics", "devprof",
                   "reason", "job_id")
_VERSION_OPTIONAL = ("parent_version", "reason", "job_id")
_VERSION_DICTS = ("train_metrics", "devprof")


@dataclass
class ModelVersion:
    """One trained-model record."""

    id: str
    engine_id: str
    engine_version: str
    engine_variant: str
    instance_id: str  # the engine instance (and its MODELDATA blob key)
    params_hash: str
    status: str = "trained"
    created_at: str = ""
    updated_at: str = ""
    parent_version: Optional[str] = None  # the live version at registration
    train_metrics: dict[str, Any] = field(default_factory=dict)
    devprof: dict[str, Any] = field(default_factory=dict)
    reason: Optional[str] = None  # why rolled_back or archived
    # the train job that registered it: a retried job adopts its version
    # instead of training again
    job_id: Optional[str] = None

    def to_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in _VERSION_FIELDS}

    @staticmethod
    def from_dict(d: dict) -> "ModelVersion":
        return ModelVersion(**{
            k: (d.get(k) or {}) if k in _VERSION_DICTS
            else d.get(k, None if k in _VERSION_OPTIONAL else "")
            for k in _VERSION_FIELDS})


def params_hash(instance: EngineInstance) -> str:
    """Hash of the instance's factory and stage-params strings: two
    versions with one hash were trained with the same params."""
    payload = json.dumps([
        instance.engine_factory, instance.data_source_params,
        instance.preparator_params, instance.algorithms_params,
        instance.serving_params,
    ], sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class ModelRegistry:
    """Versions: register, status changes, lineage and retention GC."""

    def __init__(self, storage):
        self.storage = storage
        self._store = LifecycleRecordStore(storage)

    def register(self, instance: EngineInstance,
                 train_metrics: Optional[dict] = None,
                 devprof: Optional[dict] = None,
                 job_id: Optional[str] = None) -> ModelVersion:
        """A COMPLETED train as a new ``trained`` version whose parent is
        the variant's live version (None without one). Without
        `train_metrics` it records the instance's stage timings."""
        if instance.status != "COMPLETED":
            raise ValueError(f"only COMPLETED instances register; "
                             f"{instance.id} is {instance.status}")
        live = self.live_version(instance.engine_id, instance.engine_variant)
        now = _utcnow().isoformat()
        metrics = dict(train_metrics or {})
        if not metrics and instance.env.get("stage_timings"):
            try:
                metrics["stage_timings"] = json.loads(
                    instance.env["stage_timings"])
            except (ValueError, TypeError):
                pass
        version = ModelVersion(
            id=f"mv-{uuid.uuid4().hex[:12]}",
            engine_id=instance.engine_id,
            engine_version=instance.engine_version,
            engine_variant=instance.engine_variant,
            instance_id=instance.id,
            params_hash=params_hash(instance),
            created_at=now, updated_at=now,
            parent_version=live.id if live else None,
            train_metrics=metrics, devprof=dict(devprof or {}),
            job_id=job_id,
        )
        self._store.append(VERSION_ENTITY, version.id, version.to_dict())
        return version

    def find_by_job(self, job_id: str) -> Optional[ModelVersion]:
        """The version a train job already registered, if any (the newest
        should a job ever have stamped two)."""
        if not job_id:
            return None
        hits = [v for v in self.list() if v.job_id == job_id]
        return hits[0] if hits else None

    def set_status(self, version_id: str, status: str,
                   reason: Optional[str] = None) -> ModelVersion:
        if status not in VERSION_STATUSES:
            raise ValueError(f"unknown version status {status!r} "
                             f"(known: {', '.join(VERSION_STATUSES)})")
        v = self.get(version_id)
        if v is None:
            raise KeyError(f"no model version {version_id}")
        self._store.append(VERSION_ENTITY, version_id, {
            "status": status, "updated_at": _utcnow().isoformat(),
            "reason": reason,
        })
        v.status, v.reason = status, reason
        return v

    def promote(self, version_id: str) -> ModelVersion:
        """Make `version_id` its variant's live version; the previous live
        one is archived (still in the lineage)."""
        v = self.get(version_id)
        if v is None:
            raise KeyError(f"no model version {version_id}")
        prev = self.live_version(v.engine_id, v.engine_variant)
        if prev is not None and prev.id != v.id:
            self.set_status(prev.id, "archived", reason=f"superseded by {v.id}")
        return self.set_status(version_id, "live")

    def rollback(self, version_id: str, reason: str) -> ModelVersion:
        return self.set_status(version_id, "rolled_back", reason=reason)

    def get(self, version_id: str) -> Optional[ModelVersion]:
        d = self._store.fold(VERSION_ENTITY, version_id).get(version_id)
        return ModelVersion.from_dict(d) if d else None

    def list(self, engine_id: Optional[str] = None,
             engine_variant: Optional[str] = None,
             status: Optional[str] = None) -> list[ModelVersion]:
        """Versions, newest first, filtered."""
        out = [ModelVersion.from_dict(d)
               for d in self._store.fold(VERSION_ENTITY).values()]
        out = [v for v in out
               if (engine_id is None or v.engine_id == engine_id)
               and (engine_variant is None or v.engine_variant == engine_variant)
               and (status is None or v.status == status)]
        out.sort(key=lambda v: v.created_at, reverse=True)
        return out

    def live_version(self, engine_id: str,
                     engine_variant: str) -> Optional[ModelVersion]:
        live = self.list(engine_id, engine_variant, status="live")
        return live[0] if live else None

    def lineage(self, version_id: str) -> list[ModelVersion]:
        """This version, then its parent, and so on (cycle-guarded)."""
        chain: list[ModelVersion] = []
        seen: set[str] = set()
        cur = self.get(version_id)
        while cur is not None and cur.id not in seen:
            chain.append(cur)
            seen.add(cur.id)
            cur = self.get(cur.parent_version) if cur.parent_version else None
        return chain

    def compact(self, min_events: int = 8, min_age_s: float = 60.0) -> int:
        """Compact the version and rollout records; returns events removed."""
        return sum(self._store.compact_all(entity, min_events=min_events,
                                           min_age_s=min_age_s)
                   for entity in (VERSION_ENTITY, ROLLOUT_ENTITY))

    def gc(self, keep: int = 5,
           delete_blobs: bool = False) -> list[ModelVersion]:
        """Drop all but the newest `keep` versions per (engine id,
        variant) that are neither live nor canary, then compact. With
        `delete_blobs`, a dropped version's MODELDATA blob goes too
        unless a kept version shares its instance. Returns the dropped."""
        if keep < 0:
            raise ValueError("keep must be >= 0")
        by_variant: dict[tuple[str, str], list[ModelVersion]] = {}
        for v in self.list():
            by_variant.setdefault((v.engine_id, v.engine_variant), []).append(v)
        collected: list[ModelVersion] = []
        survivors: list[ModelVersion] = []
        for versions in by_variant.values():
            serving = [v for v in versions if v.status in ("live", "canary")]
            disposable = [v for v in versions
                          if v.status not in ("live", "canary")]
            survivors += serving + disposable[:keep]  # newest first
            collected += disposable[keep:]
        kept_instances = {v.instance_id for v in survivors}
        models = self.storage.get_model_data_models()
        for v in collected:
            self._store.purge(VERSION_ENTITY, v.id)
            if delete_blobs and v.instance_id not in kept_instances:
                try:
                    models.delete(v.instance_id)
                except Exception:  # noqa: BLE001 — GC goes on
                    log.exception("model blob delete failed for %s "
                                  "(non-fatal)", v.instance_id)
        self.compact()
        return collected
