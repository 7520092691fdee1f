"""In-memory event store, app registry, access keys, channels, engine
and evaluation instances, engine manifests and models.

Counterpart of the JAX package's ``data/storage/memory.py``, cut to what
the port calls: the event store's namespaces per app and channel with
``insert``, ``insert_batch``, ``get``, ``delete``, ``remove_app``,
``find`` (with the keyset cursor ``start_after`` and the partition
filter ``shard``), ``find_entities_batch``, the tail read by insert
revision (``latest_revision``, ``find_since``, which takes a ``shard``
too) and ``data_signature`` (count + a write version bumped at every
insert and delete), and the metadata
rows. One RLock per store; events are kept per namespace with a
per-entity index for history reads. A channel id of 0 is the default channel, as in the
sqlite store.
"""

from __future__ import annotations

import secrets
import threading
from dataclasses import replace
from typing import Iterator, Optional, Sequence

from predictionio_tpu_torch.data.event import Event, new_event_id
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    EventQuery,
    Model,
    StorageError,
)


def _order_key(e: Event):
    return (e.event_time, e.event_id or "")


def _ns(app_id: int, channel_id: Optional[int]) -> tuple[int, Optional[int]]:
    return (app_id, channel_id or None)


def _stored(event: Event, eid: str, rev: int) -> Event:
    """`event` with its id and revision, as `dataclasses.replace` gives
    it (a constructed Event's fields are normalized and validated
    already), without running the constructor again for each."""
    out = object.__new__(Event)
    out.__dict__.update(event.__dict__, event_id=eid, revision=rev)
    return out


class MemoryEventStore(base.EventStore):
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.RLock()
        # (app_id, channel_id) → {event_id: Event}
        self._ns: dict[tuple, dict[str, Event]] = {}
        # (app_id, channel_id) → last store-assigned insert revision
        self._revisions: dict[tuple, int] = {}
        # (app_id, channel_id) → {entity_id: {event_id}}
        self._by_entity: dict[tuple, dict[str, set]] = {}
        # (app_id, channel_id) → write version, bumped at every mutation
        self._versions: dict[tuple, int] = {}

    def init_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            self._ns.setdefault(_ns(app_id, channel_id), {})
        return True

    def remove_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            self._ns.pop(_ns(app_id, channel_id), None)
            self._by_entity.pop(_ns(app_id, channel_id), None)
        return True

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        key = _ns(app_id, channel_id)
        with self._lock:
            table = self._ns.setdefault(key, {})
            index = self._by_entity.setdefault(key, {})
            eid = event.event_id or new_event_id()
            prev = table.get(eid)
            if prev is not None:  # overwrite: re-home the entity index
                index.get(prev.entity_id, set()).discard(eid)
            rev = self._revisions.get(key, 0) + 1
            self._revisions[key] = rev
            table[eid] = _stored(event, eid, rev)
            index.setdefault(event.entity_id, set()).add(eid)
            self._versions[key] = self._versions.get(key, 0) + 1
            return eid

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list[str]:
        with self._lock:
            return [self.insert(e, app_id, channel_id) for e in events]

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        with self._lock:
            return self._ns.get(_ns(app_id, channel_id), {}).get(event_id)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        key = _ns(app_id, channel_id)
        with self._lock:
            prev = self._ns.get(key, {}).pop(event_id, None)
            if prev is not None:
                self._by_entity[key].get(prev.entity_id, set()).discard(event_id)
                self._versions[key] = self._versions.get(key, 0) + 1
            return prev is not None

    def data_signature(self, app_id: int,
                       channel_id: Optional[int] = None) -> str:
        """Count + write version: exact, in O(1) (the JAX memory
        store's)."""
        key = _ns(app_id, channel_id)
        with self._lock:
            return f"{len(self._ns.get(key, {}))}:{self._versions.get(key, 0)}"

    def find_entities_batch(
        self,
        app_id,
        entity_type,
        entity_ids,
        event_names=None,
        limit_per_entity=None,
        channel_id=None,
        reversed=True,
    ) -> dict:
        """{entity_id: [events]} for many entities in one lock pass,
        each list newest first by (event_time, event_id) unless
        `reversed` is false, cut to `limit_per_entity`."""
        ev_set = set(event_names) if event_names is not None else None
        key = _ns(app_id, channel_id)
        with self._lock:
            table = self._ns.get(key, {})
            index = self._by_entity.get(key, {})
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
            events.sort(key=_order_key, reverse=reversed)
            out[eid] = (
                events[:limit_per_entity]
                if limit_per_entity is not None else events
            )
        return out

    def latest_revision(self, app_id: int,
                        channel_id: Optional[int] = None) -> int:
        with self._lock:
            return self._revisions.get(_ns(app_id, channel_id), 0)

    def find_since(self, app_id: int, after_revision: int,
                   channel_id: Optional[int] = None,
                   limit: Optional[int] = None,
                   shard: Optional[tuple[int, int]] = None) -> list[Event]:
        """The namespace's events above the cursor in revision order, of
        partition `shard` only when one is given: an overwritten event
        carries its newest revision, a deleted one none."""
        with self._lock:
            out = [e for e in self._ns.get(_ns(app_id, channel_id), {}).values()
                   if e.revision > after_revision and (
                       shard is None
                       or base.shard_of(e.entity_id, shard[1]) == shard[0])]
        out.sort(key=lambda e: e.revision)
        return out[:limit] if limit is not None and limit >= 0 else out

    def find(self, query: EventQuery) -> Iterator[Event]:
        """Events matching the filter, ordered by (event_time, event_id),
        reversed and cut to the limit as the query says; an entity id
        reads that entity's events only."""
        key = _ns(query.app_id, query.channel_id)
        with self._lock:
            table = self._ns.get(key, {})
            if query.entity_id is not None:
                ids = self._by_entity.get(key, {}).get(query.entity_id, ())
                events = [table[i] for i in ids if i in table]
            else:
                events = list(table.values())
        events = [e for e in events if query.matches(e)]
        events.sort(key=_order_key, reverse=query.reversed)
        if query.limit is not None and query.limit >= 0:
            events = events[:query.limit]
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

    def update(self, app: App) -> bool:
        with self._lock:
            if app.id not in self._apps:
                return False
            self._apps[app.id] = app
            return True

    def delete(self, app_id: int) -> bool:
        with self._lock:
            return self._apps.pop(app_id, None) is not None


class MemoryAccessKeys(base.AccessKeys):
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.RLock()
        self._keys: dict[str, AccessKey] = {}

    def insert(self, k: AccessKey) -> Optional[str]:
        with self._lock:
            key = k.key or secrets.token_urlsafe(32)
            if key in self._keys:
                return None
            self._keys[key] = AccessKey(key, k.app_id, tuple(k.events))
            return key

    def get(self, key: str) -> Optional[AccessKey]:
        return self._keys.get(key)

    def get_all(self) -> list[AccessKey]:
        return list(self._keys.values())

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [k for k in list(self._keys.values()) if k.app_id == app_id]

    def update(self, k: AccessKey) -> bool:
        with self._lock:
            if k.key not in self._keys:
                return False
            self._keys[k.key] = k
            return True

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._keys.pop(key, None) is not None


class MemoryChannels(base.Channels):
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.RLock()
        self._channels: dict[int, Channel] = {}
        self._next = 1

    def insert(self, c: Channel) -> Optional[int]:
        if not Channel.is_valid_name(c.name):
            return None
        with self._lock:
            if any(x.app_id == c.app_id and x.name == c.name
                   for x in self._channels.values()):
                return None
            cid = c.id if c.id > 0 else self._next
            self._next = max(self._next, cid) + 1
            self._channels[cid] = Channel(cid, c.name, c.app_id)
            return cid

    def get(self, channel_id: int) -> Optional[Channel]:
        return self._channels.get(channel_id)

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [c for c in list(self._channels.values()) if c.app_id == app_id]

    def delete(self, channel_id: int) -> bool:
        with self._lock:
            return self._channels.pop(channel_id, None) is not None


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


class MemoryEngineManifests(base.EngineManifests):
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.RLock()
        self._manifests: dict[tuple[str, str], EngineManifest] = {}

    def insert(self, m: EngineManifest) -> None:
        with self._lock:
            self._manifests[(m.id, m.version)] = m

    def get(self, mid: str, version: str) -> Optional[EngineManifest]:
        return self._manifests.get((mid, version))

    def get_all(self) -> list[EngineManifest]:
        return list(self._manifests.values())

    def update(self, m: EngineManifest, upsert: bool = False) -> None:
        with self._lock:
            if (m.id, m.version) not in self._manifests and not upsert:
                raise StorageError(f"manifest {m.id} {m.version} not found")
            self._manifests[(m.id, m.version)] = m

    def delete(self, mid: str, version: str) -> None:
        with self._lock:
            self._manifests.pop((mid, version), None)


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
