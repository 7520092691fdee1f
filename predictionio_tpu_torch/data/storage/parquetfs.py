"""Parquet-segment event store: the columnar filesystem backend.

Counterpart of the JAX package's ``data/storage/parquetfs.py`` (the role
of the reference's HDFS-parquet surfaces, view/DataView.scala:37-110, for
event data). Events land in immutable parquet segments per (app,
channel) namespace; deletes are tombstones; the training read
(``find_frame``) scans only the columns it needs straight into an
EventFrame. The schema (``_SCHEMA``, with its nullable ``revision``), the
codecs (``events_to_table``, ``table_to_events``, shared with ``console
export|import --format parquet``) and the layout are the JAX package's,
so either package reads the other's segments, tombstones and exports:

  app_{appId}[_{channelId}]/seg-{n:08d}.parquet
  app_{appId}[_{channelId}]/tombstones.json

Writes buffer in memory up to ``FLUSH_THRESHOLD`` events a namespace (a
read or ``flush`` writes the buffer out as one segment). A channel id of
0 is the default channel, as in the port's other stores (the JAX store
keeps a channel 0 buffer apart from the default one's, so that its reads
of channel 0 miss the default channel's unflushed events). A negative
``limit`` is no limit, as in the port's other stores (the JAX store's
``find`` cuts a negative limit as a slice does). A partitioned
read (``EventQuery.shard``, ``find_since``'s ``shard``) filters on the
host. ``find_entities_batch`` and ``find_edges`` are the base store's
per-entity reads, as in the JAX package.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import shutil
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from predictionio_tpu_torch.data.event import Event, new_event_id
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import EventQuery, EventStore
from predictionio_tpu_torch.data.store.columnar import EventFrame

_SCHEMA = pa.schema(
    [
        ("event_id", pa.string()),
        ("event", pa.string()),
        ("entity_type", pa.string()),
        ("entity_id", pa.string()),
        ("target_entity_type", pa.string()),
        ("target_entity_id", pa.string()),
        ("properties", pa.string()),  # JSON
        ("event_time_ms", pa.int64()),
        ("tags", pa.string()),  # JSON array
        ("pr_id", pa.string()),
        ("creation_time_ms", pa.int64()),
        # server-assigned insert revision: nullable — rows exported from
        # non-revision sources carry null
        ("revision", pa.int64()),
    ]
)

_UTC = _dt.timezone.utc


def _ms(t: _dt.datetime) -> int:
    return int(t.timestamp() * 1000)


def _from_ms(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, _UTC)


def events_to_table(events: Sequence[Event]) -> "pa.Table":
    """Encode events with the store's parquet schema — shared by the
    segment writer and `pio export --format parquet` (the reference's
    EventsToFile parquet mode, tools/.../export/EventsToFile.scala:42)."""
    return pa.Table.from_pydict(
        {
            "event_id": [e.event_id for e in events],
            "event": [e.event for e in events],
            "entity_type": [e.entity_type for e in events],
            "entity_id": [e.entity_id for e in events],
            "target_entity_type": [e.target_entity_type for e in events],
            "target_entity_id": [e.target_entity_id for e in events],
            "properties": [
                json.dumps(dict(e.properties)) for e in events
            ],
            "event_time_ms": [_ms(e.event_time) for e in events],
            "tags": [json.dumps(list(e.tags)) for e in events],
            "pr_id": [e.pr_id for e in events],
            "creation_time_ms": [_ms(e.creation_time) for e in events],
            "revision": [e.revision for e in events],
        },
        schema=_SCHEMA,
    )


def table_to_events(
    table: "pa.Table", on_error=None, with_index: bool = False
) -> Iterator[Event]:
    """Decode a schema-conforming parquet table back to events.

    `on_error(row_index, exc)` turns a malformed row into a warn-and-
    skip instead of killing the generator (pio import parity with the
    JSON path's per-line error handling). `with_index` yields
    (physical_row_index, event) so callers can report a consistent row
    numbering regardless of skips."""
    cols = {
        name: table.column(name).to_pylist() for name in table.schema.names
    }
    for i in range(table.num_rows):
        try:
            e = _row_to_event(cols, i)
        except Exception as exc:
            if on_error is None:
                raise
            on_error(i, exc)
            continue
        yield (i, e) if with_index else e


def _row_to_event(cols: dict, i: int) -> Event:
    rev = cols.get("revision")  # absent on pre-revision segment files
    return Event(
        event=cols["event"][i],
        entity_type=cols["entity_type"][i],
        entity_id=cols["entity_id"][i],
        target_entity_type=cols["target_entity_type"][i],
        target_entity_id=cols["target_entity_id"][i],
        properties=json.loads(cols["properties"][i]),
        event_time=_from_ms(cols["event_time_ms"][i]),
        tags=tuple(json.loads(cols["tags"][i])),
        pr_id=cols["pr_id"][i],
        creation_time=_from_ms(cols["creation_time_ms"][i]),
        event_id=cols["event_id"][i],
        revision=(
            int(rev[i]) if rev is not None and rev[i] is not None else None
        ),
    )


class ParquetFSEventStore(EventStore):
    FLUSH_THRESHOLD = 4096

    def __init__(self, config: dict):
        path = config.get("PATH")
        if not path:
            raise ValueError("parquetfs requires a PATH setting")
        self.base = path
        os.makedirs(self.base, exist_ok=True)
        self._lock = threading.RLock()
        # (app, ch) → list[Event] pending write
        self._buffers: dict[tuple[int, Optional[int]], list[Event]] = {}
        # (app, ch) → last server-assigned insert revision; seeded lazily
        # from the segment files' revision column so a restart continues
        # the sequence
        self._revisions: dict[tuple[int, Optional[int]], int] = {}

    # -- namespace plumbing ------------------------------------------------
    def _dir(self, app_id: int, channel_id: Optional[int]) -> str:
        name = f"app_{app_id}" + (f"_{channel_id}" if channel_id else "")
        return os.path.join(self.base, name)

    def _segments(self, d: str) -> list[str]:
        if not os.path.isdir(d):
            return []
        return sorted(
            os.path.join(d, f)
            for f in os.listdir(d)
            if f.startswith("seg-") and f.endswith(".parquet")
        )

    def _tombstones(self, d: str) -> set[str]:
        p = os.path.join(d, "tombstones.json")
        if os.path.exists(p):
            with open(p) as f:
                return set(json.load(f))
        return set()

    def _write_tombstones(self, d: str, stones: set[str]) -> None:
        with open(os.path.join(d, "tombstones.json"), "w") as f:
            json.dump(sorted(stones), f)

    # -- lifecycle ---------------------------------------------------------
    def init_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        os.makedirs(self._dir(app_id, channel_id), exist_ok=True)
        return True

    def remove_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        channel_id = channel_id or None  # channel 0 is the default one
        with self._lock:
            self._buffers.pop((app_id, channel_id), None)
            self._revisions.pop((app_id, channel_id), None)
            d = self._dir(app_id, channel_id)
            if os.path.isdir(d):
                shutil.rmtree(d)
            return True

    # -- writes ------------------------------------------------------------
    def insert(
        self, event: Event, app_id: int, channel_id: Optional[int] = None
    ) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def _seed_revisions(self, app_id: int, channel_id: Optional[int]) -> int:
        """Max revision across the namespace's segment files (0 when none
        carry the column). Caller holds the lock."""
        import pyarrow.compute as pc

        best = 0
        for seg in self._segments(self._dir(app_id, channel_id)):
            f = pq.ParquetFile(seg)
            if "revision" not in f.schema_arrow.names:
                continue
            mx = pc.max(f.read(columns=["revision"]).column("revision"))
            if mx.is_valid and int(mx.as_py()) > best:
                best = int(mx.as_py())
        return best

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> list[str]:
        with self._lock:
            key = (app_id, channel_id or None)
            if key not in self._revisions:
                self._revisions[key] = self._seed_revisions(
                    app_id, channel_id
                )
            rev = self._revisions[key]
            buf = self._buffers.setdefault(key, [])
            ids = []
            for e in events:
                if e.event_id is None:
                    e = e.with_id(new_event_id())
                rev += 1
                buf.append(e.with_revision(rev))
                ids.append(e.event_id)
            self._revisions[key] = rev
            if len(buf) >= self.FLUSH_THRESHOLD:
                self._flush(app_id, channel_id)
            return ids

    def _flush(self, app_id: int, channel_id: Optional[int]) -> None:
        buf = self._buffers.get((app_id, channel_id or None))
        if not buf:
            return
        d = self._dir(app_id, channel_id)
        os.makedirs(d, exist_ok=True)
        n = len(self._segments(d))
        pq.write_table(
            events_to_table(buf), os.path.join(d, f"seg-{n:08d}.parquet")
        )
        buf.clear()

    def flush(self) -> None:
        with self._lock:
            for app_id, channel_id in list(self._buffers):
                self._flush(app_id, channel_id)

    def delete(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> bool:
        return self.delete_batch([event_id], app_id, channel_id) == 1

    def delete_batch(
        self,
        event_ids,
        app_id: int,
        channel_id: Optional[int] = None,
    ) -> int:
        """One id-column scan + one tombstones.json write for the whole
        batch — SelfCleaningDataSource cleanup of a large store is O(N),
        not O(N·deletes)."""
        if not event_ids:
            return 0
        with self._lock:
            self._flush(app_id, channel_id)
            d = self._dir(app_id, channel_id)
            stones = self._tombstones(d)
            table = self._read_table(app_id, channel_id, columns=["event_id"])
            live = (
                set(table.column("event_id").to_pylist()) - stones
                if table is not None
                else set()
            )
            hits = [eid for eid in dict.fromkeys(event_ids) if eid in live]
            if hits:
                stones.update(hits)
                self._write_tombstones(d, stones)
            return len(hits)

    # -- reads -------------------------------------------------------------
    def _read_table(
        self, app_id: int, channel_id: Optional[int], columns=None
    ) -> Optional[pa.Table]:
        d = self._dir(app_id, channel_id)
        segs = self._segments(d)
        if not segs:
            return None
        tables = []
        for s in segs:
            names = pq.ParquetFile(s).schema_arrow.names
            cols = (
                [c for c in columns if c in names]
                if columns is not None
                else None
            )
            tables.append(pq.read_table(s, columns=cols))
        if len({t.schema for t in tables}) > 1:
            # pre-revision segment files next to new ones: unify by
            # promoting missing columns to nulls
            try:
                return pa.concat_tables(
                    tables, promote_options="default"
                )
            except TypeError:  # older pyarrow
                return pa.concat_tables(tables, promote=True)
        return pa.concat_tables(tables)

    def _iter_events(
        self, app_id: int, channel_id: Optional[int]
    ) -> Iterator[Event]:
        with self._lock:
            self._flush(app_id, channel_id)
            table = self._read_table(app_id, channel_id)
            stones = self._tombstones(self._dir(app_id, channel_id))
        if table is None:
            return
        if stones:
            import pyarrow.compute as pc

            # filter tombstoned rows BEFORE decoding (json.loads + Event
            # construction per dead row is pure waste)
            table = table.filter(
                pc.invert(
                    pc.is_in(
                        table.column("event_id"),
                        value_set=pa.array(sorted(stones)),
                    )
                )
            )
        yield from table_to_events(table)

    def get(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> Optional[Event]:
        for e in self._iter_events(app_id, channel_id):
            if e.event_id == event_id:
                return e
        return None

    def data_signature(self, app_id: int, channel_id: Optional[int] = None) -> str:
        """Metadata-cheap: one column scan of creation_time_ms + the
        tombstone count (no Event materialization)."""
        with self._lock:
            self._flush(app_id, channel_id)
            table = self._read_table(app_id, channel_id, ["creation_time_ms"])
            stones = self._tombstones(self._dir(app_id, channel_id))
        if table is None or table.num_rows == 0:
            return f"0:{len(stones)}:0"
        import pyarrow.compute as pc

        mx = pc.max(table.column("creation_time_ms")).as_py() or 0
        return f"{table.num_rows}:{len(stones)}:{mx}"

    def latest_revision(
        self, app_id: int, channel_id: Optional[int] = None
    ) -> int:
        with self._lock:
            key = (app_id, channel_id or None)
            if key not in self._revisions:
                self._revisions[key] = self._seed_revisions(
                    app_id, channel_id
                )
            return self._revisions[key]

    def find_since(
        self,
        app_id: int,
        after_revision: int,
        channel_id: Optional[int] = None,
        limit: Optional[int] = None,
        shard: Optional[tuple[int, int]] = None,
    ) -> list[Event]:
        """Revision range read at segment-file granularity: each file's
        revision column gates whether its rows decode at all — an idle
        consumer tick against a big namespace touches one thin column
        per file and materializes only the page's rows."""
        with self._lock:
            self._flush(app_id, channel_id)
            d = self._dir(app_id, channel_id)
            segs = self._segments(d)
            stones = self._tombstones(d)
        rows: list[Event] = []
        for seg in segs:
            f = pq.ParquetFile(seg)
            if "revision" not in f.schema_arrow.names:
                continue  # pre-revision rows are not tailable
            revs = f.read(columns=["revision"]).column("revision")
            # nulls → NaN, and NaN > cursor is False — one vectorized
            # compare over the thin column
            rev_np = revs.to_numpy(zero_copy_only=False).astype(np.float64)
            hit = np.nonzero(rev_np > after_revision)[0]
            if not len(hit):
                continue
            # decode ONLY the matching rows to Python objects: take()
            # before any to_pylist. The Arrow-level file read is still
            # whole-file (one row group per write_table, so row-group
            # pruning has nothing to prune) but stays columnar-C-speed;
            # the per-row Python cost — the part that dominated — is
            # bounded by the page.
            sub = pq.read_table(seg).take(hit)
            cols = {
                name: sub.column(name).to_pylist()
                for name in sub.schema.names
            }
            for i in range(sub.num_rows):
                e = _row_to_event(cols, i)
                if e.event_id in stones:
                    continue
                if shard is not None and base.shard_of(
                    e.entity_id, shard[1]
                ) != shard[0]:
                    continue
                rows.append(e)
        rows.sort(key=lambda e: e.revision)  # type: ignore[arg-type, return-value]
        if limit is not None and limit >= 0:
            rows = rows[:limit]
        return rows

    def find(self, query: EventQuery) -> Iterator[Event]:
        matches = (
            e
            for e in self._iter_events(query.app_id, query.channel_id)
            if query.matches(e)
        )
        ordered = sorted(
            matches,
            key=lambda e: (e.event_time, e.event_id or ""),
            reverse=query.reversed,
        )
        if query.limit is not None and query.limit >= 0:  # negative: all
            ordered = ordered[: query.limit]
        return iter(ordered)

    # -- columnar fast path (the training read) ----------------------------
    def find_frame(
        self,
        query: EventQuery,
        value_prop: Optional[str] = None,
        default_value: float = 1.0,
    ) -> EventFrame:
        """Column-projected scan → EventFrame. Only the filter/identity
        columns (+ properties when a value is extracted) leave disk."""
        with self._lock:
            self._flush(query.app_id, query.channel_id)
            columns = [
                "event_id", "event", "entity_type", "entity_id",
                "target_entity_id", "event_time_ms",
            ]
            if value_prop is not None:
                columns.append("properties")
            if query.target_entity_type is not None:
                columns.append("target_entity_type")
            table = self._read_table(query.app_id, query.channel_id, columns)
            stones = self._tombstones(self._dir(query.app_id, query.channel_id))
        if table is None or table.num_rows == 0:
            return EventFrame.from_events([])
        import pyarrow.compute as pc

        # the filters as Arrow kernels over the columns; a null matches no
        # filter value, and a null id is no tombstone
        def among(col: str, values) -> "pa.ChunkedArray":
            return pc.fill_null(pc.is_in(table.column(col), value_set=pa.array(
                sorted(values), pa.string())), False)

        keep = []
        if stones:
            keep.append(pc.invert(among("event_id", stones)))
        if query.start_time is not None:
            keep.append(pc.greater_equal(table.column("event_time_ms"),
                                         _ms(query.start_time)))
        if query.until_time is not None:
            keep.append(pc.less(table.column("event_time_ms"), _ms(query.until_time)))
        if query.event_names is not None:
            keep.append(among("event", query.event_names))
        if query.entity_type is not None:
            keep.append(among("entity_type", [query.entity_type]))
        if query.target_entity_type is not None:
            keep.append(among("target_entity_type", [query.target_entity_type]))
        if query.shard is not None:
            # one hash a distinct entity, looked up by each row's code
            sidx, n_sh = query.shard
            codes = pc.dictionary_encode(table.column("entity_id")).combine_chunks()
            in_shard = np.fromiter(
                (base.shard_of(e, n_sh) == sidx for e in codes.dictionary.to_pylist()),
                dtype=bool, count=len(codes.dictionary))
            keep.append(pa.array(in_shard[codes.indices.to_numpy()]))
        if keep:
            mask = keep[0]
            for k in keep[1:]:
                mask = pc.and_(mask, k)
            table = table.filter(mask)
        if value_prop is not None:
            def _val(raw: Optional[str]) -> float:
                if not raw:
                    return default_value
                v = json.loads(raw).get(value_prop)
                # 0 / 0.0 are legitimate values — only absence defaults
                return float(v) if isinstance(v, (int, float)) else default_value

            values = np.asarray([_val(p) for p in table.column("properties").to_pylist()],
                                dtype=np.float32)
        else:
            values = np.full(table.num_rows, default_value, dtype=np.float32)
        return EventFrame.from_columns(
            event_names=table.column("event").to_pylist(),
            entity_ids=table.column("entity_id").to_pylist(),
            target_ids=table.column("target_entity_id").to_pylist(),
            time_ms=table.column("event_time_ms").to_numpy(),
            values=values,
            entity_type=query.entity_type,
            target_entity_type=query.target_entity_type,
        )
