"""EventFrame: events packed into columns for training.

Counterpart of the JAX package's ``data/store/columnar.py``, cut to what
the UR path reads: ``from_events``, ``select``, ``where_event`` and
``n_entities``, over the event, entity and target columns (no times,
values or property tables).

Columns:
  event_code   int32   — index into `event_vocab`
  entity_idx   int32   — index into `entity_vocab`
  target_idx   int32   — index into `target_vocab`, -1 when absent
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.store.bimap import BiMap


@dataclass
class EventFrame:
    event_code: np.ndarray
    entity_idx: np.ndarray
    target_idx: np.ndarray
    event_vocab: BiMap  # event name → code
    entity_vocab: BiMap  # entity id → idx (first-seen order)
    target_vocab: BiMap  # target entity id → idx (first-seen order)

    def __len__(self) -> int:
        return int(self.event_code.shape[0])

    @property
    def n_entities(self) -> int:
        return len(self.entity_vocab)

    @staticmethod
    def from_events(events: Iterable[Event]) -> "EventFrame":
        """Pack an event stream into columns; vocabularies follow the
        stream's first-seen order."""
        names: list[str] = []
        entities: list[str] = []
        targets: list[Optional[str]] = []
        for e in events:
            names.append(e.event)
            entities.append(e.entity_id)
            targets.append(e.target_entity_id)
        event_vocab = BiMap.string_int(names)
        entity_vocab = BiMap.string_int(entities)
        target_vocab = BiMap.string_int(t for t in targets if t is not None)
        return EventFrame(
            event_code=event_vocab.map_array(names),
            entity_idx=entity_vocab.map_array(entities),
            target_idx=np.fromiter(
                (target_vocab.get(t, -1) if t is not None else -1
                 for t in targets),
                dtype=np.int32, count=len(targets),
            ),
            event_vocab=event_vocab,
            entity_vocab=entity_vocab,
            target_vocab=target_vocab,
        )

    def select(self, mask: np.ndarray) -> "EventFrame":
        return EventFrame(
            event_code=self.event_code[mask],
            entity_idx=self.entity_idx[mask],
            target_idx=self.target_idx[mask],
            event_vocab=self.event_vocab,
            entity_vocab=self.entity_vocab,
            target_vocab=self.target_vocab,
        )

    def where_event(self, *names: str) -> "EventFrame":
        codes = [self.event_vocab.get(n, -2) for n in names]
        return self.select(np.isin(self.event_code, codes))
