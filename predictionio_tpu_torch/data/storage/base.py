"""Event-store query filter, metadata records and the DAO interfaces.

Counterpart of the JAX package's ``data/storage/base.py``, cut to what
the port's train → deploy, eval and event-server paths call: the
``EventQuery`` filters by app, channel, time range, entity type and id,
event names, target entity type and id, with a limit, the reversed
order, the absent-target filter, the keyset cursor ``start_after`` and
the partitioned read ``shard`` (``shard_of``: crc32 of the entity id
mod n, the hash every store and the storage daemon agree on); the
records ``App``, ``AccessKey``, ``Channel``,
``EngineInstance``, ``EvaluationInstance``, ``EngineManifest`` and
``Model`` are the JAX package's field for field; the DAO interfaces are
those of events (one namespace per app and channel), apps, access keys,
channels, engine instances, evaluation instances, engine manifests and
models. ``StorageUnreachableError`` (and ``StorageCircuitOpenError``
under it) is the one storage failure that retry layers and the Event
Server's write-ahead spill treat as transient. The event store
tails by insert revision (``latest_revision``, ``find_since``,
``revision_streams``: the online consumer's read) over one stream a
plain store (the sharded store has one a shard). The derived reads are
the JAX package's: ``find_single_entity`` (newest first by default), the
property folds ``aggregate_properties`` (with ``required``) and
``aggregate_properties_of_entity`` over ``find``'s (event_time,
event_id) order, and ``data_signature``, the fingerprint that keys the
data view's cache (a scan here; the ported stores override it with
count + write version).
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Optional, Sequence

from predictionio_tpu_torch.data.aggregator import (
    SPECIAL_EVENTS,
    aggregate_properties,
    aggregate_properties_of_entity,
)
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event


def shard_of(entity_id: str, n_shards: int) -> int:
    """The entity's shard: crc32 of its id mod `n_shards`. Every store,
    the storage daemon and the JAX package agree on it, so partitioned
    readers are disjoint."""
    import zlib

    return zlib.crc32(entity_id.encode()) % n_shards


class StorageError(RuntimeError):
    pass


class StorageUnreachableError(StorageError):
    """A connectivity failure (the daemon down, a socket error): the only
    StorageError that retry layers treat as transient. Failures of the
    application (auth refused, a malformed query, a bug on the server)
    stay plain StorageErrors: deterministic, not worth a backoff, and no
    evidence that the store is down."""


class StorageCircuitOpenError(StorageUnreachableError):
    """A fail-fast refusal: the endpoint's circuit breaker is open. A
    StorageUnreachableError, so that every handler of the transient
    failure (the Event Server's spill) treats it as the outage it stands
    for, without a round trip."""


@dataclass(frozen=True)
class EventQuery:
    """Filter set of a find (reference LEvents.futureFind:164): events of
    the (app, channel) namespace with event time in [start_time,
    until_time), ordered by (event_time, event_id), descending when
    `reversed`, cut to `limit` (None or negative: all). `start_after` is
    a keyset cursor: only events strictly after that (event_time,
    event_id) in scan order (greater for a forward scan, less for a
    reversed one), so that pages are O(page) and stable under concurrent
    writes (the remote store's paged find). `shard` = (i, n) keeps the
    events whose entity is in partition i of n (`shard_of`): the n
    partitions are disjoint and complete, and each entity's events land
    in one of them."""

    app_id: int
    channel_id: Optional[int] = None
    start_time: Optional[_dt.datetime] = None
    until_time: Optional[_dt.datetime] = None
    entity_type: Optional[str] = None
    entity_id: Optional[str] = None
    event_names: Optional[Sequence[str]] = None
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    limit: Optional[int] = None
    reversed: bool = False
    # True: only events with neither target field (the target filters
    # are then ignored)
    filter_target_absent: bool = False
    start_after: Optional[tuple[_dt.datetime, str]] = None
    shard: Optional[tuple[int, int]] = None

    def shard_matches(self, entity_id: str) -> bool:
        if self.shard is None:
            return True
        idx, n = self.shard
        return shard_of(entity_id, n) == idx

    def matches(self, e: Event) -> bool:
        if not self.shard_matches(e.entity_id):
            return False
        if self.start_after is not None:
            key = (e.event_time, e.event_id or "")
            if (key >= self.start_after) if self.reversed else (key <= self.start_after):
                return False
        if self.start_time is not None and e.event_time < self.start_time:
            return False
        if self.until_time is not None and e.event_time >= self.until_time:
            return False
        if self.entity_type is not None and e.entity_type != self.entity_type:
            return False
        if self.entity_id is not None and e.entity_id != self.entity_id:
            return False
        if self.event_names is not None and e.event not in self.event_names:
            return False
        if self.filter_target_absent:
            return e.target_entity_type is None and e.target_entity_id is None
        if (self.target_entity_type is not None
                and e.target_entity_type != self.target_entity_type):
            return False
        if (self.target_entity_id is not None
                and e.target_entity_id != self.target_entity_id):
            return False
        return True


class EventStore(abc.ABC):
    """Event DAO: one instance serves every (app, channel) namespace; a
    channel id of None or 0 is the app's default channel."""

    @abc.abstractmethod
    def init_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Create the namespace (idempotent)."""

    @abc.abstractmethod
    def remove_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Drop every event of the namespace."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Insert one event; returns its event id."""

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    def write(self, events: Iterable[Event], app_id: int,
              channel_id: Optional[int] = None) -> int:
        """Bulk write path (reference PEvents.write:167); returns the
        events written."""
        return len(self.insert_batch(list(events), app_id, channel_id))

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        """The event of that id, or None."""

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        """Delete by id; returns whether it existed."""

    @abc.abstractmethod
    def find(self, query: EventQuery) -> Iterator[Event]:
        """Events matching the filter, in (event_time, event_id) order,
        reversed when the query says so."""

    def delete_batch(self, event_ids: Sequence[str], app_id: int,
                     channel_id: Optional[int] = None) -> int:
        """Delete each id; returns how many existed."""
        return sum(self.delete(eid, app_id, channel_id) for eid in event_ids)

    @abc.abstractmethod
    def find_entities_batch(
        self,
        app_id: int,
        entity_type: str,
        entity_ids: Sequence[str],
        event_names: Optional[Sequence[str]] = None,
        limit_per_entity: Optional[int] = None,
        channel_id: Optional[int] = None,
        reversed: bool = True,
    ) -> dict[str, list[Event]]:
        """{entity_id: [events]} newest first (oldest first when not
        `reversed`), cut to `limit_per_entity`: a serving micro-batch's
        history read in one store call. `channel_id` and `reversed` take
        the JAX package's names, so that its remote client's call reaches
        a port store through the daemon."""

    def find_edges(
        self,
        app_id: int,
        entity_type: str,
        target_entity_type: str,
        event_names: Sequence[str],
        entity_ids: Optional[Sequence[str]] = None,
        target_ids: Optional[Sequence[str]] = None,
        channel_id: Optional[int] = None,
    ) -> list[tuple[str, str, str, dict]]:
        """(entity id, target id, event, properties) of every `event_names`
        event from an `entity_type` entity to a `target_entity_type`
        target, for the entities in `entity_ids` or the targets in
        `target_ids` (exactly one of the two): grouped by that id in the
        order given, each group oldest first by (event_time, event_id).
        The online fold's history read, one store call a side. Default:
        one `find` an id."""
        by_target = target_ids is not None
        if by_target == (entity_ids is not None):
            raise ValueError("find_edges takes entity_ids or target_ids")
        out = []
        for i in dict.fromkeys(target_ids if by_target else entity_ids):
            out.extend(
                (e.entity_id, e.target_entity_id, e.event, e.properties)
                for e in self.find(EventQuery(
                    app_id=app_id, channel_id=channel_id,
                    event_names=list(event_names), entity_type=entity_type,
                    target_entity_type=target_entity_type,
                    **({"target_entity_id": i} if by_target else {"entity_id": i})))
                if e.target_entity_id is not None)
        return out

    # -- insert-revision tailing (the online consumer's read) ---------------
    def latest_revision(self, app_id: int,
                        channel_id: Optional[int] = None) -> int:
        """Highest store-assigned insert revision of the namespace (0 when
        empty). Default: a scan; the ported stores override it."""
        return max((e.revision for e in self.find(
            EventQuery(app_id=app_id, channel_id=channel_id))
            if e.revision is not None), default=0)

    def find_since(
        self,
        app_id: int,
        after_revision: int,
        channel_id: Optional[int] = None,
        limit: Optional[int] = None,
        shard: Optional[tuple[int, int]] = None,
    ) -> list[Event]:
        """Events with revision strictly above `after_revision`, in
        revision order, cut to `limit` (None or negative: all). Revisions
        are assigned at insert, so no client-supplied event time can
        reorder the tail. `shard` = (i, n) keeps partition i's events
        (the consumer's filter against a sharded store's replica copies).
        Default: a scan and a sort; the ported stores override it."""
        out = sorted(
            (e for e in self.find(EventQuery(app_id=app_id, channel_id=channel_id,
                                             shard=shard))
             if e.revision is not None and e.revision > after_revision),
            key=lambda e: e.revision)
        return out[:limit] if limit is not None and limit >= 0 else out

    def revision_streams(
        self,
    ) -> list[tuple[str, "EventStore", Optional[tuple[int, int]]]]:
        """The independently tailable revision streams as (key, store,
        shard filter) rows: one for a plain store, so a consumer's cursor
        is {"0": revision}; the sharded store has one a shard."""
        return [("0", self, None)]

    def data_signature(self, app_id: int,
                       channel_id: Optional[int] = None) -> str:
        """A fingerprint of the (app, channel) namespace that changes at
        every insert and delete: it keys the data view's cache
        (data/view.py). Default: an O(n) scan, the count and the xor of
        the ids' crc32s; the ported stores override it with count +
        write version."""
        import zlib

        n = 0
        acc = 0
        for e in self.find(EventQuery(app_id=app_id, channel_id=channel_id)):
            n += 1
            acc ^= zlib.crc32((e.event_id or "").encode())
        return f"{n}:{acc}"

    # -- derived reads --------------------------------------------------------
    def find_single_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        channel_id: Optional[int] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        limit: Optional[int] = None,
        reversed: bool = True,
    ) -> Iterator[Event]:
        """One entity's events, newest first by default: the serving-time
        read (reference LEvents.findSingleEntity:390)."""
        return self.find(EventQuery(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit, reversed=reversed,
        ))

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict[str, PropertyMap]:
        """entity_id → PropertyMap of the type's $set/$unset/$delete
        events, only entities holding every `required` field (reference
        LEvents.futureAggregateProperties:191)."""
        result = aggregate_properties(self.find(EventQuery(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            event_names=list(SPECIAL_EVENTS),
        )))
        if required:
            req = set(required)
            result = {k: v for k, v in result.items() if req.issubset(v.keyset())}
        return result

    def aggregate_properties_of_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> Optional[PropertyMap]:
        """One entity's PropertyMap, or None (reference
        LEvents.futureAggregatePropertiesOfEntity:234)."""
        return aggregate_properties_of_entity(self.find(EventQuery(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=list(SPECIAL_EVENTS),
        )))



# ---------------------------------------------------------------------------
# Metadata records + DAOs
# ---------------------------------------------------------------------------


@dataclass
class App:
    """Reference Apps.scala:29."""

    id: int
    name: str
    description: Optional[str] = None


@dataclass
class AccessKey:
    """Reference AccessKeys.scala:31: a key, its app and the event names
    it may write (empty: all)."""

    key: str
    app_id: int
    events: tuple[str, ...] = ()


@dataclass
class Channel:
    """Reference Channels.scala:29."""

    id: int
    name: str
    app_id: int

    NAME_CONSTRAINT = "must be non-empty, alphanumeric/-/_ only"

    @staticmethod
    def is_valid_name(s: str) -> bool:
        return bool(s) and all(c.isalnum() or c in "-_" for c in s)


@dataclass
class EngineInstance:
    """One train run's record (reference EngineInstances.scala:43)."""

    id: str
    status: str  # INIT | TRAINING | COMPLETED | ABORTED | INTERRUPTED
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    mesh_conf: dict[str, Any] = field(default_factory=dict)  # the JAX package's; {} here
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


@dataclass
class EvaluationInstance:
    """One evaluation run's record (reference EvaluationInstances.scala:39):
    INIT → EVALRUNNING → EVALCOMPLETED, or EVALABORTED."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclass
class EngineManifest:
    """Reference EngineManifests.scala:34: a registered engine build."""

    id: str
    version: str
    name: str
    description: Optional[str] = None
    files: tuple[str, ...] = ()
    engine_factory: str = ""


@dataclass
class Model:
    """Serialized model blob (reference Models.scala:30)."""

    id: str
    models: bytes


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]:
        """Insert; returns the assigned id (app.id == 0 → auto-assign),
        None when the name or id is taken."""

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, k: AccessKey) -> Optional[str]:
        """Insert (an empty key: a generated one); returns the key, None
        when it is taken."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, k: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, c: Channel) -> Optional[int]:
        """Insert; returns the assigned id, None for an invalid name or
        one the app already has."""

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str:
        """Insert; returns the assigned id."""

    @abc.abstractmethod
    def get(self, iid: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        """COMPLETED rows of the engine variant, newest start first."""

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    @abc.abstractmethod
    def update(self, i: EngineInstance) -> bool: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EvaluationInstance) -> str:
        """Insert; returns the assigned id."""

    @abc.abstractmethod
    def get(self, iid: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    def get_completed(self) -> list[EvaluationInstance]:
        """EVALCOMPLETED rows, newest start first (the dashboard's list)."""
        done = [i for i in self.get_all() if i.status == "EVALCOMPLETED"]
        return sorted(done, key=lambda i: i.start_time, reverse=True)

    @abc.abstractmethod
    def update(self, i: EvaluationInstance) -> bool: ...


class EngineManifests(abc.ABC):
    """Registered engine builds, keyed by (id, version)."""

    @abc.abstractmethod
    def insert(self, m: EngineManifest) -> None: ...

    @abc.abstractmethod
    def get(self, mid: str, version: str) -> Optional[EngineManifest]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineManifest]: ...

    @abc.abstractmethod
    def update(self, m: EngineManifest, upsert: bool = False) -> None:
        """Replace the row; a missing one is a StorageError unless
        `upsert`."""

    @abc.abstractmethod
    def delete(self, mid: str, version: str) -> None: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, m: Model) -> None: ...

    @abc.abstractmethod
    def get(self, mid: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, mid: str) -> None: ...
