"""EventFrame: events packed into columns for training.

Counterpart of the JAX package's ``data/store/columnar.py`` (the
replacement of the reference's RDD read path, HBPEvents.scala:84-90):
training attributes are interned into numpy struct-of-arrays on the
host, and the (user, item, value) triples a DataSource needs come from
vectorized ops over them. Time filters and per-entity counts are not
ported.

Columns:
  event_code   int32   — index into `event_vocab`
  entity_idx   int32   — index into `entity_vocab`
  target_idx   int32   — index into `target_vocab`, -1 when absent
  time_ms      int64   — event time (epoch milliseconds)
  value        float32 — numeric payload of a named property (or a default)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.store.bimap import BiMap


def _float_prop(props, name: str) -> Optional[float]:
    """The property as a float; None when absent or null; an error when
    not a number (the JAX package's ``DataMap.get_opt(name, float)``)."""
    v = props.get(name)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise KeyError(f"value {v!r} is not of type float")
    return float(v)


@dataclass
class EventFrame:
    event_code: np.ndarray
    entity_idx: np.ndarray
    target_idx: np.ndarray
    time_ms: np.ndarray
    value: np.ndarray
    event_vocab: BiMap  # event name → code
    entity_vocab: BiMap  # entity id → idx (first-seen order)
    target_vocab: BiMap  # target entity id → idx (first-seen order)
    entity_type: Optional[str] = None
    target_entity_type: Optional[str] = None

    def __len__(self) -> int:
        return int(self.event_code.shape[0])

    @property
    def n_entities(self) -> int:
        return len(self.entity_vocab)

    @property
    def n_targets(self) -> int:
        return len(self.target_vocab)

    @staticmethod
    def from_events(
        events: Iterable[Event],
        value_prop: Optional[str] = None,
        default_value: float = 1.0,
    ) -> "EventFrame":
        """Pack an event stream into columns; vocabularies follow the
        stream's first-seen order. `value_prop` names the property taken
        as the value (e.g. "rating"); where it is missing, the default."""
        names: list[str] = []
        entities: list[str] = []
        targets: list[Optional[str]] = []
        times: list[int] = []
        values: list[float] = []
        etype: Optional[str] = None
        ttype: Optional[str] = None
        for e in events:
            names.append(e.event)
            entities.append(e.entity_id)
            targets.append(e.target_entity_id)
            times.append(int(e.event_time.timestamp() * 1000))
            v = _float_prop(e.properties, value_prop) if value_prop is not None else None
            values.append(default_value if v is None else v)
            etype = etype or e.entity_type
            ttype = ttype or e.target_entity_type
        return EventFrame.from_columns(
            names, entities, targets, np.asarray(times, dtype=np.int64),
            np.asarray(values, dtype=np.float32),
            entity_type=etype, target_entity_type=ttype,
        )

    @staticmethod
    def from_columns(
        event_names: Sequence[str],
        entity_ids: Sequence[str],
        target_ids: Sequence[Optional[str]],
        time_ms: np.ndarray,
        values: np.ndarray,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
    ) -> "EventFrame":
        """From raw columns, without Event objects (the sqlite columnar
        read's path)."""
        event_vocab = BiMap.string_int(event_names)
        entity_vocab = BiMap.string_int(entity_ids)
        target_vocab = BiMap.string_int(t for t in target_ids if t is not None)
        return EventFrame(
            event_code=event_vocab.map_array(event_names),
            entity_idx=entity_vocab.map_array(entity_ids),
            target_idx=np.fromiter(
                (target_vocab.get(t, -1) if t is not None else -1
                 for t in target_ids),
                dtype=np.int32, count=len(target_ids),
            ),
            time_ms=np.asarray(time_ms, dtype=np.int64),
            value=np.asarray(values, dtype=np.float32),
            event_vocab=event_vocab,
            entity_vocab=entity_vocab,
            target_vocab=target_vocab,
            entity_type=entity_type,
            target_entity_type=target_entity_type,
        )

    def select(self, mask: np.ndarray) -> "EventFrame":
        return EventFrame(
            event_code=self.event_code[mask],
            entity_idx=self.entity_idx[mask],
            target_idx=self.target_idx[mask],
            time_ms=self.time_ms[mask],
            value=self.value[mask],
            event_vocab=self.event_vocab,
            entity_vocab=self.entity_vocab,
            target_vocab=self.target_vocab,
            entity_type=self.entity_type,
            target_entity_type=self.target_entity_type,
        )

    def where_event(self, *names: str) -> "EventFrame":
        codes = [self.event_vocab.get(n, -2) for n in names]
        return self.select(np.isin(self.event_code, codes))

    def interactions(self, dedupe: str = "sum") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(entity_idx, target_idx, value) triples with valid targets,
        duplicate (entity, target) pairs combined: "sum" | "max" | "last".
        Sorted by (entity, target) except for "last" — the COO ratings
        matrix ALS trains on."""
        mask = self.target_idx >= 0
        rows = self.entity_idx[mask].astype(np.int64)
        cols = self.target_idx[mask].astype(np.int64)
        vals = self.value[mask]
        times = self.time_ms[mask]
        n_t = max(len(self.target_vocab), int(cols.max()) + 1 if len(cols) else 1)
        keys = rows * n_t + cols
        if dedupe == "last":
            order = np.argsort(times, kind="stable")
            keys, rows, cols, vals = keys[order], rows[order], cols[order], vals[order]
            _, last_idx = np.unique(keys[::-1], return_index=True)
            take = len(keys) - 1 - last_idx
            return rows[take].astype(np.int32), cols[take].astype(np.int32), vals[take]
        uniq, inv = np.unique(keys, return_inverse=True)
        if dedupe == "sum":
            agg = np.zeros(len(uniq), dtype=np.float64)
            np.add.at(agg, inv, vals.astype(np.float64))
        elif dedupe == "max":
            agg = np.full(len(uniq), -np.inf)
            np.maximum.at(agg, inv, vals)
        else:
            raise ValueError(f"unknown dedupe mode {dedupe!r}")
        return ((uniq // n_t).astype(np.int32), (uniq % n_t).astype(np.int32),
                agg.astype(np.float32))
