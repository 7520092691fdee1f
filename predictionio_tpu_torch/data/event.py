"""The behavioral event record, as far as the Universal Recommender
reads and writes it.

Counterpart of the JAX package's ``data/event.py`` (reference
Event.scala:39-57), cut to the fields the UR path uses: no tags,
prediction ids, creation times, special-event validation or JSON codec.
"""

from __future__ import annotations

import datetime as _dt
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Optional

UTC = _dt.timezone.utc


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def new_event_id() -> str:
    return uuid.uuid4().hex


@dataclass(frozen=True)
class Event:
    """One behavioral event: `entity` did `event` to `target_entity`."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: Mapping[str, Any] = field(default_factory=dict)
    event_time: _dt.datetime = field(default_factory=utcnow)
    event_id: Optional[str] = None
    # store-assigned insert sequence per app; None until stored
    revision: Optional[int] = None

    def __post_init__(self):
        for name in ("event", "entity_type", "entity_id"):
            if not getattr(self, name):
                raise ValueError(f"{name} must not be empty")
        if (self.target_entity_type is None) != (self.target_entity_id is None):
            raise ValueError(
                "targetEntityType and targetEntityId go together"
            )
        if self.event_time.tzinfo is None:
            object.__setattr__(
                self, "event_time", self.event_time.replace(tzinfo=UTC)
            )

    def with_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)

    def with_revision(self, revision: int) -> "Event":
        return replace(self, revision=revision)
