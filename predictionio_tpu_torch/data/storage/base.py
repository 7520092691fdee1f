"""Event-store query filter and app record.

Counterpart of the JAX package's ``data/storage/base.py`` (``EventQuery``
and ``App``), cut to the filters the UR path reads by: no channel,
entity id, time range, target filters, limit, order, keyset cursor or
shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from predictionio_tpu_torch.data.event import Event


class StorageError(RuntimeError):
    pass


@dataclass(frozen=True)
class EventQuery:
    """Filter set of a find (reference LEvents.futureFind:164)."""

    app_id: int
    entity_type: Optional[str] = None
    event_names: Optional[Sequence[str]] = None

    def matches(self, e: Event) -> bool:
        if self.entity_type is not None and e.entity_type != self.entity_type:
            return False
        if self.event_names is not None and e.event not in self.event_names:
            return False
        return True


@dataclass
class App:
    """Reference Apps.scala:29."""

    id: int
    name: str
    description: Optional[str] = None
