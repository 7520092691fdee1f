"""Lifecycle records: last-write-wins field folds over a reserved
event-store namespace.

Counterpart of the JAX package's ``deploy/registry.py``, cut to its
record layer, ``LifecycleRecordStore`` (the online consumer's durable
cursor lives there). A record is the fold of ``$set`` events of one
(entity type, entity id) in the app ``LIFECYCLE_APP_ID``, ordered by
(event time, ``_seq``), each newer field winning. The namespace, the
event shape and the fold are the JAX package's, so a record that either
package writes into a shared store is read by the other. The model
registry, its versions, the job queue and the record verbs only they
call (``discard``, ``events``, ``compact_all``, ``purge``) are not
ported.
"""

from __future__ import annotations

import datetime as _dt
import itertools
import logging
import threading
from typing import Any, Optional

from predictionio_tpu_torch.data.event import SET_EVENT, Event
from predictionio_tpu_torch.data.storage.base import EventQuery

log = logging.getLogger(__name__)

# the reserved namespace: far above any app id a store assigns (sqlite
# table names take no minus sign)
LIFECYCLE_APP_ID = 2_000_000_000

# process-monotonic tie-breaker of updates in one event-time tick
_seq = itertools.count()
_seq_lock = threading.Lock()


def _next_seq() -> int:
    with _seq_lock:
        return next(_seq)


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

    def fold(self, entity_type: str, entity_id: Optional[str] = None) -> dict:
        """entity_id → merged fields (the newest write of a field wins)."""
        out: dict[str, dict] = {}
        for e in sorted(self._find(entity_type, entity_id), key=_fold_key):
            out.setdefault(e.entity_id, {}).update(e.properties)
        for d in out.values():
            d.pop("_seq", None)
        return out

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
            if (_dt.datetime.now(_dt.timezone.utc) - newest).total_seconds() < min_age_s:
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
