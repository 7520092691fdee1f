"""Event-store query filter, metadata records and the DAO interfaces.

Counterpart of the JAX package's ``data/storage/base.py``, cut to what
the port's train → deploy and eval workflows call: the ``EventQuery``
filters by app, entity type, event names and target entity type (no
channel, entity id, time range, target id, limit, order, keyset cursor
or shards); the records ``App``, ``EngineInstance``,
``EvaluationInstance``, ``EngineManifest`` and ``Model`` are the JAX
package's field for field; the DAO interfaces are those of events,
apps, engine instances, evaluation instances and models. Access keys,
channels and property aggregation are not ported.
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Optional, Sequence

from predictionio_tpu_torch.data.event import Event


class StorageError(RuntimeError):
    pass


@dataclass(frozen=True)
class EventQuery:
    """Filter set of a find (reference LEvents.futureFind:164)."""

    app_id: int
    entity_type: Optional[str] = None
    event_names: Optional[Sequence[str]] = None
    target_entity_type: Optional[str] = None

    def matches(self, e: Event) -> bool:
        if self.entity_type is not None and e.entity_type != self.entity_type:
            return False
        if self.event_names is not None and e.event not in self.event_names:
            return False
        if (self.target_entity_type is not None
                and e.target_entity_type != self.target_entity_type):
            return False
        return True


class EventStore(abc.ABC):
    """Event DAO: one instance serves every app's namespace."""

    @abc.abstractmethod
    def init_app(self, app_id: int) -> bool:
        """Create the app's namespace (idempotent)."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int) -> str:
        """Insert one event; returns its event id."""

    def insert_batch(self, events: Sequence[Event], app_id: int) -> list[str]:
        return [self.insert(e, app_id) for e in events]

    def write(self, events: Iterable[Event], app_id: int) -> int:
        """Bulk write path (reference PEvents.write:167); returns the
        events written."""
        return len(self.insert_batch(list(events), app_id))

    @abc.abstractmethod
    def find(self, query: EventQuery) -> Iterator[Event]:
        """Events matching the filter, in (event_time, event_id) order."""

    @abc.abstractmethod
    def find_entities_batch(
        self,
        app_id: int,
        entity_type: str,
        entity_ids: Sequence[str],
        event_names: Optional[Sequence[str]] = None,
        limit_per_entity: Optional[int] = None,
    ) -> dict[str, list[Event]]:
        """{entity_id: [events]} newest first, cut to `limit_per_entity`:
        a serving micro-batch's history read in one store call."""


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

    @abc.abstractmethod
    def update(self, i: EvaluationInstance) -> bool: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, m: Model) -> None: ...

    @abc.abstractmethod
    def get(self, mid: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, mid: str) -> None: ...
