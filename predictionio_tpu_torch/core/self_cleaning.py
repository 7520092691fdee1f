"""Self-cleaning data source: a moving window over an app's events.

Counterpart of the JAX package's ``core/self_cleaning.py`` (reference
core/.../SelfCleaningDataSource.scala:24-318, the ActionML fork's
trait). A data source that mixes it in calls
``clean_persisted_events(ctx)`` before it reads, and the clean rewrites
the app's stored events in three steps:

(a) each entity's ``$set``/``$unset``/``$delete`` history of two or
    more events folds into one ``$set`` snapshot (``data/aggregator.py``,
    stamped with the entity's last update time; an entity the fold
    leaves empty gets none);
(b) exact duplicates among the other events (same name, entity, target
    and properties) go, the oldest one kept;
(c) the other events older than ``now - duration`` go.

The snapshots are inserted before anything is deleted, so a clean that
stops between the two leaves a fold that still gives the same
properties. The counters ``{compacted, deduplicated, aged_out}`` are the
JAX package's.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import re
from dataclasses import dataclass
from typing import Optional

from predictionio_tpu_torch.core.base import RuntimeContext
from predictionio_tpu_torch.data.aggregator import SPECIAL_EVENTS, aggregate_properties
from predictionio_tpu_torch.data.event import SET_EVENT, Event
from predictionio_tpu_torch.data.storage.base import EventQuery
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade

log = logging.getLogger(__name__)

_DURATION_RE = re.compile(r"^\s*(\d+)\s*(seconds?|minutes?|hours?|days?|weeks?)\s*$")
_UNIT_SECONDS = {"second": 1, "minute": 60, "hour": 3600, "day": 86400, "week": 604800}


def parse_duration(s: str) -> _dt.timedelta:
    """"4 days", "12 hours" → timedelta (the reference's Scala Duration
    strings of this shape)."""
    m = _DURATION_RE.match(s)
    if not m:
        raise ValueError(
            f"cannot parse duration {s!r} (expected e.g. '4 days', '12 hours')")
    n, unit = int(m.group(1)), m.group(2).rstrip("s")
    return _dt.timedelta(seconds=n * _UNIT_SECONDS[unit])


@dataclass(frozen=True)
class EventWindow:
    """Reference SelfCleaningDataSource.EventWindow:314."""

    duration: Optional[str] = None  # e.g. "4 days"; None: no age-out
    remove_duplicates: bool = False
    compress_properties: bool = False


class SelfCleaningDataSource:
    """Mixin for data sources: subclasses set `app_name` and
    `event_window` and call `clean_persisted_events(ctx)` first in
    `read_training`."""

    app_name: str
    event_window: Optional[EventWindow] = None

    def clean_persisted_events(self, ctx: RuntimeContext) -> dict[str, int]:
        """Apply the window to the app's stored events; returns the
        counters {compacted, deduplicated, aged_out}."""
        window = self.event_window
        stats = {"compacted": 0, "deduplicated": 0, "aged_out": 0}
        if window is None:
            return stats
        app_id, _ = EventStoreFacade(ctx.storage).app_name_to_id(self.app_name)
        store = ctx.storage.get_events()
        events = list(store.find(EventQuery(app_id=app_id)))
        if not events:
            return stats
        cutoff = None
        if window.duration is not None:
            cutoff = _dt.datetime.now(_dt.timezone.utc) - parse_duration(window.duration)

        special = [e for e in events if e.event in SPECIAL_EVENTS]
        regular = [e for e in events if e.event not in SPECIAL_EVENTS]
        to_delete: list[str] = []
        to_insert: list[Event] = []

        # (a) an entity's special-event history → one $set
        if window.compress_properties and special:
            by_entity: dict[tuple[str, str], list[Event]] = {}
            for e in special:
                by_entity.setdefault((e.entity_type, e.entity_id), []).append(e)
            for (etype, eid), evs in by_entity.items():
                if len(evs) <= 1:
                    continue
                pmap = aggregate_properties(evs).get(eid)
                to_delete.extend(e.event_id for e in evs if e.event_id)
                if pmap is not None:
                    to_insert.append(Event(
                        event=SET_EVENT, entity_type=etype, entity_id=eid,
                        properties=dict(pmap.to_dict()),
                        event_time=pmap.last_updated))
                stats["compacted"] += len(evs)

        # (b) exact duplicates of the other events (reference .distinct);
        # canonical JSON keeps list- and dict-valued properties hashable
        if window.remove_duplicates:
            seen: set[tuple] = set()
            for e in sorted(regular, key=lambda e: e.event_time):
                key = (e.event, e.entity_type, e.entity_id, e.target_entity_type,
                       e.target_entity_id, json.dumps(dict(e.properties), sort_keys=True))
                if key not in seen:
                    seen.add(key)
                elif e.event_id:
                    to_delete.append(e.event_id)
                    stats["deduplicated"] += 1

        # (c) the other events older than the window
        if cutoff is not None:
            already = set(to_delete)
            for e in regular:
                if e.event_time < cutoff and e.event_id and e.event_id not in already:
                    to_delete.append(e.event_id)
                    stats["aged_out"] += 1

        # snapshots first, then the replaced rows (the reference wipes only
        # after the cleaned data is persisted)
        if to_insert:
            store.insert_batch(to_insert, app_id)
        store.delete_batch(to_delete, app_id)
        log.info("self-cleaning %s: compacted=%d deduplicated=%d aged_out=%d",
                 self.app_name, stats["compacted"], stats["deduplicated"],
                 stats["aged_out"])
        return stats
