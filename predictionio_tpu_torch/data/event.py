"""The behavioral event record, its JSON codec and validation rules.

Counterpart of the JAX package's ``data/event.py`` (reference
Event.scala:39-163, EventJson4sSupport.scala:30-236): an immutable
record with reserved-name validation and the special property events
$set / $unset / $delete. ``properties`` is a plain dict here (the JAX
package's typed ``DataMap`` wrapper is not ported).
"""

from __future__ import annotations

import datetime as _dt
import json
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Optional

SET_EVENT = "$set"
UNSET_EVENT = "$unset"
DELETE_EVENT = "$delete"

UTC = _dt.timezone.utc


class ValidationError(ValueError):
    """An event that breaks the reserved-name or special-event rules."""


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def new_event_id() -> str:
    return uuid.uuid4().hex


def parse_time(value: Any) -> _dt.datetime:
    """An ISO-8601 string, epoch milliseconds or a datetime, as an aware
    datetime (UTC when no zone is given)."""
    if isinstance(value, _dt.datetime):
        return value if value.tzinfo else value.replace(tzinfo=UTC)
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return _dt.datetime.fromtimestamp(value / 1000.0, tz=UTC)
    if isinstance(value, str):
        dt = _dt.datetime.fromisoformat(value.replace("Z", "+00:00"))
        return dt if dt.tzinfo else dt.replace(tzinfo=UTC)
    raise ValidationError(f"cannot parse datetime from {value!r}")


def _iso(dt: _dt.datetime) -> str:
    return dt.astimezone(UTC).isoformat(timespec="milliseconds").replace("+00:00", "Z")


@dataclass(frozen=True)
class Event:
    """One behavioral event: `entity` did `event` to `target_entity`
    (reference Event.scala:39-57)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: Mapping[str, Any] = field(default_factory=dict)
    event_time: _dt.datetime = field(default_factory=utcnow)
    tags: tuple[str, ...] = ()
    pr_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=utcnow)
    event_id: Optional[str] = None
    # store-assigned insert sequence per app; None until stored
    revision: Optional[int] = None

    def __post_init__(self):
        if not isinstance(self.properties, dict):
            object.__setattr__(self, "properties", dict(self.properties))
        if isinstance(self.tags, list):
            object.__setattr__(self, "tags", tuple(self.tags))
        for name in ("event_time", "creation_time"):
            v = getattr(self, name)
            if v.tzinfo is None:
                object.__setattr__(self, name, v.replace(tzinfo=UTC))
        EventValidation.validate(self)

    def with_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)

    def with_revision(self, revision: int) -> "Event":
        return replace(self, revision=revision)

    # -- JSON codec (reference EventJson4sSupport.scala:30-236) -----------
    def to_json_dict(self, with_id: bool = True) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if with_id and self.event_id is not None:
            out["eventId"] = self.event_id
        out.update(event=self.event, entityType=self.entity_type,
                   entityId=self.entity_id)
        if self.target_entity_type is not None:
            out["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            out["targetEntityId"] = self.target_entity_id
        out["properties"] = dict(self.properties)
        out["eventTime"] = _iso(self.event_time)
        if self.tags:
            out["tags"] = list(self.tags)
        if self.pr_id is not None:
            out["prId"] = self.pr_id
        out["creationTime"] = _iso(self.creation_time)
        if self.revision is not None:
            out["revision"] = self.revision
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), separators=(",", ":"))

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "Event":
        try:
            event, entity_type, entity_id = d["event"], d["entityType"], d["entityId"]
        except KeyError as e:
            raise ValidationError(f"field {e.args[0]} is required") from None
        for req_name, req_val in (("event", event), ("entityType", entity_type),
                                  ("entityId", entity_id)):
            if not isinstance(req_val, str) or not req_val:
                raise ValidationError(f"field {req_name} must be a non-empty string")
        now = utcnow()
        return Event(
            event=event,
            entity_type=entity_type,
            entity_id=str(entity_id),
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=(
                str(d["targetEntityId"]) if d.get("targetEntityId") is not None else None
            ),
            properties=dict(d.get("properties") or {}),
            event_time=parse_time(d["eventTime"]) if d.get("eventTime") else now,
            tags=tuple(d.get("tags") or ()),
            pr_id=d.get("prId"),
            creation_time=parse_time(d["creationTime"]) if d.get("creationTime") else now,
            event_id=d.get("eventId"),
            revision=int(d["revision"]) if d.get("revision") is not None else None,
        )

    @staticmethod
    def from_json(s: str) -> "Event":
        d = json.loads(s)
        if not isinstance(d, dict):
            raise ValidationError("event JSON must be an object")
        return Event.from_json_dict(d)


class EventValidation:
    """Reserved-name rules (reference Event.scala:65-163): names starting
    with "$" or "pio_" are reserved, except the special events $set,
    $unset and $delete with their argument constraints and the builtin
    entity types."""

    SPECIAL_EVENTS = frozenset({SET_EVENT, UNSET_EVENT, DELETE_EVENT})
    # the JAX package's framework-internal entity types
    BUILTIN_ENTITY_TYPES = frozenset({
        "pio_pr", "pio_model_version", "pio_train_job", "pio_tenant",
        "pio_rollout", "pio_online_cursor", "pio_job_claim",
        "pio_fleet_worker", "pio_query_replica", "pio_election",
        "pio_election_bid", "pio_eval_run", "pio_eval_result",
        "pio_retrain_preset", "pio_settle_probe",
    })

    @staticmethod
    def is_reserved_prefix(name: str) -> bool:
        return name.startswith("$") or name.startswith("pio_")

    @classmethod
    def is_special_event(cls, name: str) -> bool:
        return name in cls.SPECIAL_EVENTS

    @classmethod
    def validate(cls, e: Event) -> None:
        for name, label in (("event", "event"), ("entity_type", "entityType"),
                            ("entity_id", "entityId")):
            if not getattr(e, name):
                raise ValidationError(f"{label} must not be empty")
        if e.target_entity_type is not None and not e.target_entity_type:
            raise ValidationError("targetEntityType must not be empty string")
        if e.target_entity_id is not None and not e.target_entity_id:
            raise ValidationError("targetEntityId must not be empty string")
        if e.target_entity_type is None and e.target_entity_id is not None:
            raise ValidationError(
                "targetEntityType must be specified when targetEntityId is"
            )
        if e.target_entity_type is not None and e.target_entity_id is None:
            raise ValidationError(
                "targetEntityId must be specified when targetEntityType is"
            )
        if cls.is_reserved_prefix(e.event) and not cls.is_special_event(e.event):
            raise ValidationError(
                f"event name {e.event!r} uses a reserved prefix ($ or pio_)"
            )
        if (cls.is_reserved_prefix(e.entity_type)
                and e.entity_type not in cls.BUILTIN_ENTITY_TYPES):
            raise ValidationError(f"entityType {e.entity_type!r} uses a reserved prefix")
        if (e.target_entity_type is not None
                and cls.is_reserved_prefix(e.target_entity_type)
                and e.target_entity_type not in cls.BUILTIN_ENTITY_TYPES):
            raise ValidationError(
                f"targetEntityType {e.target_entity_type!r} uses a reserved prefix"
            )
        if cls.is_special_event(e.event):
            if e.target_entity_type is not None or e.target_entity_id is not None:
                raise ValidationError(
                    f"special event {e.event} must not have targetEntity"
                )
            if e.event == UNSET_EVENT and not e.properties:
                raise ValidationError("$unset must have non-empty properties")
            if e.event == DELETE_EVENT and e.properties:
                raise ValidationError("$delete must not have properties")
