"""Property aggregation: $set/$unset/$delete event streams folded into
one PropertyMap per entity.

Counterpart of the JAX package's ``data/aggregator.py`` (reference
EventOp, PEventAggregator.scala:85-191, LEventAggregator.scala:29-145):
per field the newest event time wins (a tie goes to the later event of
the stream), an $unset removes the fields set at or before it, a
$delete clears the entity. The fold runs on the host over the store's
`find` order, (event_time, event_id), so equal-time events fold in the
same order in both packages.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Iterable, Optional

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import (
    DELETE_EVENT,
    SET_EVENT,
    UNSET_EVENT,
    Event,
)

SPECIAL_EVENTS = (SET_EVENT, UNSET_EVENT, DELETE_EVENT)


@dataclass
class _Prop:
    value: object
    t: _dt.datetime


@dataclass
class EventOp:
    """Fold state: field → (value, set time), field → unset time, the
    delete time, first and last seen times (reference EventOp,
    PEventAggregator.scala:85)."""

    set_props: dict[str, _Prop] = field(default_factory=dict)
    unset_props: dict[str, _dt.datetime] = field(default_factory=dict)
    delete_entity: Optional[_dt.datetime] = None
    first_updated: Optional[_dt.datetime] = None
    last_updated: Optional[_dt.datetime] = None

    @staticmethod
    def from_event(e: Event) -> "EventOp":
        op = EventOp(first_updated=e.event_time, last_updated=e.event_time)
        if e.event == SET_EVENT:
            op.set_props = {k: _Prop(v, e.event_time) for k, v in e.properties.items()}
        elif e.event == UNSET_EVENT:
            op.unset_props = {k: e.event_time for k in e.properties}
        elif e.event == DELETE_EVENT:
            op.delete_entity = e.event_time
        return op

    def merge(self, other: "EventOp") -> "EventOp":
        """Per field the newer time wins; a tie favors `other` (the
        reference's `if (x.t > y.t) x else y`)."""
        out = EventOp()
        out.set_props = dict(self.set_props)
        for k, p in other.set_props.items():
            mine = out.set_props.get(k)
            out.set_props[k] = p if (mine is None or not (mine.t > p.t)) else mine
        out.unset_props = dict(self.unset_props)
        for k, t in other.unset_props.items():
            mine_t = out.unset_props.get(k)
            out.unset_props[k] = t if (mine_t is None or t >= mine_t) else mine_t
        deletes = [d for d in (self.delete_entity, other.delete_entity) if d is not None]
        out.delete_entity = max(deletes) if deletes else None
        firsts = [t for t in (self.first_updated, other.first_updated) if t]
        lasts = [t for t in (self.last_updated, other.last_updated) if t]
        out.first_updated = min(firsts) if firsts else None
        out.last_updated = max(lasts) if lasts else None
        return out

    def to_property_map(self) -> Optional[PropertyMap]:
        """The fold's result: the delete applied, then the unsets, then
        the surviving sets; None for an entity deleted with nothing set
        after, or never set."""
        props = self.set_props
        if self.delete_entity is not None:
            props = {k: p for k, p in props.items() if p.t > self.delete_entity}
        live: dict[str, object] = {}
        for k, p in props.items():
            unset_t = self.unset_props.get(k)
            if unset_t is not None and unset_t >= p.t:
                continue
            live[k] = p.value
        if not live:
            if self.delete_entity is not None and not props:
                return None
            if not self.set_props:
                return None
        if self.first_updated is None or self.last_updated is None:
            raise ValueError("an EventOp with events has first and last times")
        return PropertyMap(live, self.first_updated, self.last_updated)


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """entity_id → PropertyMap of a stream's special events; other events
    are skipped (callers filter by entity type upstream)."""
    ops: dict[str, EventOp] = {}
    for e in events:
        if e.event not in SPECIAL_EVENTS:
            continue
        op = EventOp.from_event(e)
        prev = ops.get(e.entity_id)
        ops[e.entity_id] = op if prev is None else prev.merge(op)
    out: dict[str, PropertyMap] = {}
    for entity_id, op in ops.items():
        pm = op.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out


def aggregate_properties_of_entity(events: Iterable[Event]) -> Optional[PropertyMap]:
    """One entity's fold (reference LEvents.futureAggregatePropertiesOfEntity)."""
    op: Optional[EventOp] = None
    for e in events:
        if e.event not in SPECIAL_EVENTS:
            continue
        nxt = EventOp.from_event(e)
        op = nxt if op is None else op.merge(nxt)
    return op.to_property_map() if op is not None else None
