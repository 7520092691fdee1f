"""In-memory event store, app registry, engine and evaluation instances
and models.

Counterpart of the JAX package's ``data/storage/memory.py``, cut to what
the port calls: the event store's ``init_app``, ``insert``,
``insert_batch``, ``find`` and ``find_entities_batch``, the apps, the
engine- and evaluation-instance rows and the model blobs. One RLock per
store; events are kept per app with a per-entity index for serving-time
history reads. Channels, access keys and engine manifests are not
ported.
"""

from __future__ import annotations

import secrets
import threading
from dataclasses import replace
from typing import Iterator, Optional, Sequence

from predictionio_tpu_torch.data.event import Event, new_event_id
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    App,
    EngineInstance,
    EvaluationInstance,
    EventQuery,
    Model,
)


def _order_key(e: Event):
    return (e.event_time, e.event_id or "")


class MemoryEventStore(base.EventStore):
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.RLock()
        # app_id → {event_id: Event}
        self._ns: dict[int, dict[str, Event]] = {}
        # app_id → last store-assigned insert revision
        self._revisions: dict[int, int] = {}
        # app_id → {entity_id: {event_id}}
        self._by_entity: dict[int, dict[str, set]] = {}

    def init_app(self, app_id: int) -> bool:
        with self._lock:
            self._ns.setdefault(app_id, {})
        return True

    def insert(self, event: Event, app_id: int) -> str:
        with self._lock:
            table = self._ns.setdefault(app_id, {})
            index = self._by_entity.setdefault(app_id, {})
            eid = event.event_id or new_event_id()
            prev = table.get(eid)
            if prev is not None:  # overwrite: re-home the entity index
                index.get(prev.entity_id, set()).discard(eid)
            rev = self._revisions.get(app_id, 0) + 1
            self._revisions[app_id] = rev
            table[eid] = event.with_id(eid).with_revision(rev)
            index.setdefault(event.entity_id, set()).add(eid)
            return eid

    def insert_batch(self, events: Sequence[Event], app_id: int) -> list[str]:
        with self._lock:
            return [self.insert(e, app_id) for e in events]

    def find_entities_batch(
        self,
        app_id,
        entity_type,
        entity_ids,
        event_names=None,
        limit_per_entity=None,
    ) -> dict:
        """{entity_id: [events]} for many entities in one lock pass,
        each list newest first by (event_time, event_id), cut to
        `limit_per_entity`."""
        ev_set = set(event_names) if event_names is not None else None
        with self._lock:
            table = self._ns.get(app_id, {})
            index = self._by_entity.get(app_id, {})
            raw = {
                eid: [table[i] for i in index.get(eid, ()) if i in table]
                for eid in dict.fromkeys(entity_ids)
            }
        out = {}
        for eid, events in raw.items():
            events = [
                e for e in events
                if e.entity_type == entity_type
                and (ev_set is None or e.event in ev_set)
            ]
            events.sort(key=_order_key, reverse=True)
            out[eid] = (
                events[:limit_per_entity]
                if limit_per_entity is not None else events
            )
        return out

    def find(self, query: EventQuery) -> Iterator[Event]:
        """Events matching the filter, ordered by (event_time, event_id)."""
        with self._lock:
            events = list(self._ns.get(query.app_id, {}).values())
        events = [e for e in events if query.matches(e)]
        events.sort(key=_order_key)
        return iter(events)


class MemoryApps(base.Apps):
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.RLock()
        self._apps: dict[int, App] = {}
        self._next = 1

    def insert(self, app: App) -> Optional[int]:
        with self._lock:
            if self.get_by_name(app.name) is not None:
                return None
            app_id = app.id if app.id > 0 else self._next
            if app_id in self._apps:
                return None
            self._next = max(self._next, app_id) + 1
            self._apps[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> Optional[App]:
        return self._apps.get(app_id)

    def get_by_name(self, name: str) -> Optional[App]:
        for a in list(self._apps.values()):
            if a.name == name:
                return a
        return None

    def get_all(self) -> list[App]:
        return list(self._apps.values())


class MemoryEngineInstances(base.EngineInstances):
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.RLock()
        self._instances: dict[str, EngineInstance] = {}
        self._counter = 0

    def insert(self, i: EngineInstance) -> str:
        with self._lock:
            self._counter += 1
            iid = i.id or f"ei_{self._counter:08d}_{secrets.token_hex(4)}"
            self._instances[iid] = replace(i, id=iid)
            return iid

    def get(self, iid: str) -> Optional[EngineInstance]:
        return self._instances.get(iid)

    def get_all(self) -> list[EngineInstance]:
        return list(self._instances.values())

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        out = [
            i for i in list(self._instances.values())
            if i.status == "COMPLETED" and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def update(self, i: EngineInstance) -> bool:
        with self._lock:
            if i.id not in self._instances:
                return False
            self._instances[i.id] = i
            return True


class MemoryEvaluationInstances(base.EvaluationInstances):
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.RLock()
        self._instances: dict[str, EvaluationInstance] = {}
        self._counter = 0

    def insert(self, i: EvaluationInstance) -> str:
        with self._lock:
            self._counter += 1
            iid = i.id or f"evi_{self._counter:08d}_{secrets.token_hex(4)}"
            self._instances[iid] = replace(i, id=iid)
            return iid

    def get(self, iid: str) -> Optional[EvaluationInstance]:
        return self._instances.get(iid)

    def get_all(self) -> list[EvaluationInstance]:
        return list(self._instances.values())

    def update(self, i: EvaluationInstance) -> bool:
        with self._lock:
            if i.id not in self._instances:
                return False
            self._instances[i.id] = i
            return True


class MemoryModels(base.Models):
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.RLock()
        self._models: dict[str, Model] = {}

    def insert(self, m: Model) -> None:
        with self._lock:
            self._models[m.id] = m

    def get(self, mid: str) -> Optional[Model]:
        return self._models.get(mid)

    def delete(self, mid: str) -> None:
        with self._lock:
            self._models.pop(mid, None)
