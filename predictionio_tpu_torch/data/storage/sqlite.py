"""SQLite storage: events, apps, access keys, channels, engine and
evaluation instances, engine manifests.

Counterpart of the JAX package's ``data/storage/sqlite.py`` (reference
jdbc/JDBCLEvents.scala, JDBCPEvents.scala, JDBCApps, JDBCAccessKeys,
JDBCChannels, JDBCEngineInstances, JDBCEvaluationInstances), cut to
what the port's train → deploy, eval and event-server paths call. The
tables, their columns and the revision bookkeeping are the JAX
package's, so a ``pio.db`` written by either package reads in the
other: one events table per app and channel,
``events_<appId>[_<channelId>]`` (reference JDBCUtils.eventTableName),
and the ``apps``, ``accesskeys``, ``channels``, ``engineinstances``,
``evaluationinstances`` and ``enginemanifests`` tables. A find's keyset
cursor (``start_after``) is an indexed range clause on (eventTime, id). The tail read by insert revision
(``find_since``, ``latest_revision``) goes through the table's
``idx_<table>_rev`` index and the ``pio_insert_revisions`` counter;
``data_signature`` is the row count with the ``pio_data_versions``
write version. A partitioned read (``EventQuery.shard``, ``find_since``'s
``shard``) filters in SQL through the ``pio_shard(entityId, n)``
function, the JAX package's. Model blobs are not ported.
"""

from __future__ import annotations

import datetime as _dt
import json
import secrets
import sqlite3
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import Event, new_event_id
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    EventQuery,
    StorageError,
)


# the properties column's encoding (the JAX package's json.dumps with
# these separators), one encoder for every row
_encode = json.JSONEncoder(separators=(",", ":")).encode


def _ms(dt: _dt.datetime) -> int:
    return int(dt.timestamp() * 1000)


def _from_ms(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc)


class SqliteClient:
    """One connection per source, shared by its DAOs; writers are
    serialized by `lock`. Journal and sync modes are the JAX package's;
    the page cache may grow to 256 MiB and sorts stay in memory, so that
    a million-event table's indexes and a training read's ORDER BY are
    not paged through the disk a few pages at a time."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.path = config.get("PATH", config.get("URL", ":memory:"))
        self.conn = sqlite3.connect(self.path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")
        self.conn.execute("PRAGMA cache_size=-262144")  # KiB
        self.conn.execute("PRAGMA temp_store=MEMORY")
        # the partitioned read's filter in SQL: crc32(entityId) % n, the
        # hash every store agrees on
        self.conn.create_function("pio_shard", 2, base.shard_of,
                                  deterministic=True)
        self.lock = threading.RLock()


class SqliteEventStore(base.EventStore):
    def __init__(self, config: Optional[dict] = None,
                 client: Optional[SqliteClient] = None):
        self._client = client or SqliteClient(config)
        self._known_tables: set[str] = set()

    @staticmethod
    def _table_name(app_id: int, channel_id: Optional[int] = None) -> str:
        # channel 0 and None are the default table, as the JAX package's
        return f"events_{app_id}" + (f"_{channel_id}" if channel_id else "")

    # the JAX package's write-version and insert-revision bookkeeping:
    # one row per events table in each
    _VERSIONS_DDL = (
        "CREATE TABLE IF NOT EXISTS pio_data_versions "
        "(tbl TEXT PRIMARY KEY, ver INTEGER NOT NULL)"
    )
    _REVISIONS_DDL = (
        "CREATE TABLE IF NOT EXISTS pio_insert_revisions "
        "(tbl TEXT PRIMARY KEY, rev INTEGER NOT NULL)"
    )

    def _next_revisions(self, name: str, n: int) -> int:
        """Advance the table's revision counter by `n`; returns the first
        assigned revision. The caller holds the client lock."""
        conn = self._client.conn
        conn.execute(
            "INSERT INTO pio_insert_revisions VALUES (?, ?) "
            "ON CONFLICT(tbl) DO UPDATE SET rev = rev + ?", (name, n, n),
        )
        (last,) = conn.execute(
            "SELECT rev FROM pio_insert_revisions WHERE tbl = ?", (name,)
        ).fetchone()
        return last - n + 1

    def _bump(self, name: str) -> None:
        self._client.conn.execute(
            "INSERT INTO pio_data_versions VALUES (?, 1) "
            "ON CONFLICT(tbl) DO UPDATE SET ver = ver + 1", (name,),
        )

    def _ensure_table(self, app_id: int, channel_id: Optional[int] = None) -> str:
        name = self._table_name(app_id, channel_id)
        if name in self._known_tables:
            return name
        with self._client.lock:
            conn = self._client.conn
            conn.execute(self._VERSIONS_DDL)
            conn.execute(self._REVISIONS_DDL)
            conn.execute(
                f"""CREATE TABLE IF NOT EXISTS {name} (
                    id TEXT PRIMARY KEY,
                    event TEXT NOT NULL,
                    entityType TEXT NOT NULL,
                    entityId TEXT NOT NULL,
                    targetEntityType TEXT,
                    targetEntityId TEXT,
                    properties TEXT,
                    eventTime INTEGER NOT NULL,
                    tags TEXT,
                    prId TEXT,
                    creationTime INTEGER NOT NULL,
                    revision INTEGER
                )"""
            )
            try:  # tables from before the revision column
                conn.execute(f"ALTER TABLE {name} ADD COLUMN revision INTEGER")
            except sqlite3.OperationalError:
                pass  # the column exists
            for sql in self._index_ddl(name):
                conn.execute(sql)
            conn.execute(
                "INSERT INTO pio_insert_revisions VALUES (?, "
                f"COALESCE((SELECT MAX(revision) FROM {name}), 0)) "
                "ON CONFLICT(tbl) DO NOTHING", (name,),
            )
            conn.commit()
        self._known_tables.add(name)
        return name

    @staticmethod
    def _index_ddl(name: str) -> list[str]:
        return [
            f"CREATE INDEX IF NOT EXISTS idx_{name}_time ON {name} (eventTime)",
            f"CREATE INDEX IF NOT EXISTS idx_{name}_entity ON {name} (entityType, entityId)",
            f"CREATE INDEX IF NOT EXISTS idx_{name}_rev ON {name} (revision)",
        ]

    def init_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._ensure_table(app_id, channel_id)
        return True

    def remove_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        name = self._table_name(app_id, channel_id)
        with self._client.lock:
            self._client.conn.execute(f"DROP TABLE IF EXISTS {name}")
            self._client.conn.commit()
        self._known_tables.discard(name)
        return True

    @staticmethod
    def _row(event: Event, eid: str, revision: int) -> tuple:
        return (
            eid, event.event, event.entity_type, event.entity_id,
            event.target_entity_type, event.target_entity_id,
            _encode(event.properties),
            _ms(event.event_time),
            json.dumps(list(event.tags)) if event.tags else None,
            event.pr_id, _ms(event.creation_time), revision,
        )

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list[str]:
        name = self._ensure_table(app_id, channel_id)
        ids = [e.event_id or new_event_id() for e in events]
        with self._client.lock:
            rev0 = self._next_revisions(name, len(events)) if events else 0
            self._client.conn.executemany(
                f"INSERT OR REPLACE INTO {name} VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                [self._row(e, eid, rev0 + i)
                 for i, (e, eid) in enumerate(zip(events, ids))],
            )
            self._bump(name)
            self._client.conn.commit()
        return ids

    # events per insert_batch (and commit) of a bulk write
    WRITE_CHUNK = 50_000

    def write(self, events: Iterable[Event], app_id: int,
              channel_id: Optional[int] = None) -> int:
        """The bulk write (reference PEvents.write:167): `insert_batch`es
        of WRITE_CHUNK events, each committed. Into an empty table the three
        secondary indexes are dropped first and built once at the end,
        which sorts the keys once instead of inserting a million random
        keys one by one; the table ends with the same indexes, and a
        write that fails rebuilds them too. Returns the events written."""
        name = self._ensure_table(app_id, channel_id)
        n = 0
        with self._client.lock:
            conn = self._client.conn
            bulk = conn.execute(f"SELECT 1 FROM {name} LIMIT 1").fetchone() is None
            if bulk:
                for suffix in ("time", "entity", "rev"):
                    conn.execute(f"DROP INDEX IF EXISTS idx_{name}_{suffix}")
            try:
                batch: list[Event] = []
                for e in events:
                    batch.append(e)
                    if len(batch) == self.WRITE_CHUNK:
                        n += len(self.insert_batch(batch, app_id, channel_id))
                        batch = []
                if batch:
                    n += len(self.insert_batch(batch, app_id, channel_id))
            finally:
                if bulk:
                    for sql in self._index_ddl(name):
                        conn.execute(sql)
                    conn.commit()
        return n

    # the table's columns in `_to_event`'s order
    _COLUMNS = ("id, event, entityType, entityId, targetEntityType, "
                "targetEntityId, properties, eventTime, tags, prId, "
                "creationTime, revision")

    @staticmethod
    def _to_event(row: tuple) -> Event:
        (eid, event, etype, entity_id, tetype, teid, props, etime, tags,
         pr_id, ctime, *rest) = row
        return Event(
            event=event, entity_type=etype, entity_id=entity_id,
            target_entity_type=tetype, target_entity_id=teid,
            properties=json.loads(props) if props else {},
            event_time=_from_ms(etime),
            tags=tuple(json.loads(tags)) if tags else (),
            pr_id=pr_id, creation_time=_from_ms(ctime), event_id=eid,
            revision=rest[0] if rest and rest[0] is not None else None,
        )

    @staticmethod
    def _where(query: EventQuery) -> tuple[str, list]:
        clauses, params = [], []
        if query.start_time is not None:
            clauses.append("eventTime >= ?")
            params.append(_ms(query.start_time))
        if query.until_time is not None:
            clauses.append("eventTime < ?")
            params.append(_ms(query.until_time))
        if query.entity_type is not None:
            clauses.append("entityType = ?")
            params.append(query.entity_type)
        if query.entity_id is not None:
            clauses.append("entityId = ?")
            params.append(query.entity_id)
        if query.event_names is not None:
            clauses.append(f"event IN ({','.join('?' for _ in query.event_names)})")
            params.extend(query.event_names)
        if query.filter_target_absent:
            clauses.append("targetEntityType IS NULL AND targetEntityId IS NULL")
        else:
            if query.target_entity_type is not None:
                clauses.append("targetEntityType = ?")
                params.append(query.target_entity_type)
            if query.target_entity_id is not None:
                clauses.append("targetEntityId = ?")
                params.append(query.target_entity_id)
        if query.start_after is not None:
            t, eid = query.start_after
            op = "<" if query.reversed else ">"
            clauses.append(f"(eventTime {op} ? OR (eventTime = ? AND id {op} ?))")
            params.extend([_ms(t), _ms(t), eid])
        if query.shard is not None:
            idx, n = query.shard
            clauses.append("pio_shard(entityId, ?) = ?")
            params.extend([int(n), int(idx)])
        return ("WHERE " + " AND ".join(clauses)) if clauses else "", params

    def find(self, query: EventQuery) -> Iterator[Event]:
        name = self._ensure_table(query.app_id, query.channel_id)
        where, params = self._where(query)
        order = "DESC" if query.reversed else "ASC"
        limit = (f" LIMIT {int(query.limit)}"
                 if query.limit is not None and query.limit >= 0 else "")
        sql = (f"SELECT * FROM {name} {where} "
               f"ORDER BY eventTime {order}, id {order}{limit}")
        with self._client.lock:
            rows = self._client.conn.execute(sql, params).fetchall()
        return (self._to_event(r) for r in rows)

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        name = self._ensure_table(app_id, channel_id)
        with self._client.lock:
            row = self._client.conn.execute(
                f"SELECT * FROM {name} WHERE id = ?", (event_id,)).fetchone()
        return self._to_event(row) if row else None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        name = self._ensure_table(app_id, channel_id)
        with self._client.lock:
            cur = self._client.conn.execute(
                f"DELETE FROM {name} WHERE id = ?", (event_id,))
            if cur.rowcount > 0:
                self._bump(name)
            self._client.conn.commit()
            return cur.rowcount > 0

    def data_signature(self, app_id: int,
                       channel_id: Optional[int] = None) -> str:
        """Count + the table's write version (``pio_data_versions``,
        bumped at every insert, replace and delete), as the JAX sqlite
        store gives it."""
        name = self._ensure_table(app_id, channel_id)
        with self._client.lock:
            (n,) = self._client.conn.execute(
                f"SELECT COUNT(*) FROM {name}").fetchone()
            row = self._client.conn.execute(
                "SELECT ver FROM pio_data_versions WHERE tbl = ?", (name,)
            ).fetchone()
        return f"{n}:{row[0] if row else 0}"

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
        """One indexed SELECT per entity, newest first unless `reversed`
        is false (the JAX package's per-entity `find_single_entity`
        loop)."""
        name = self._ensure_table(app_id, channel_id)
        clause, extra = "", []
        if event_names is not None:
            clause = f" AND event IN ({','.join('?' for _ in event_names)})"
            extra = list(event_names)
        limit = (f" LIMIT {int(limit_per_entity)}"
                 if limit_per_entity is not None and limit_per_entity >= 0 else "")
        order = "DESC" if reversed else "ASC"
        sql = (f"SELECT * FROM {name} WHERE entityType = ? AND entityId = ?"
               f"{clause} ORDER BY eventTime {order}, id {order}{limit}")
        out: dict[str, list[Event]] = {}
        with self._client.lock:
            for eid in dict.fromkeys(entity_ids):
                rows = self._client.conn.execute(
                    sql, [entity_type, eid, *extra]).fetchall()
                out[eid] = [self._to_event(r) for r in rows]
        return out

    def _one_step(self, sql: str, params) -> list:
        """The rows of `sql`, which selects ONE json_group_array, decoded:
        the statement steps once however many events it folds. A
        row-by-row fetch releases and retakes the interpreter lock at
        every row, and behind a server's busy threads each retake waits
        out a switch interval: a tick's 30,000 history rows then take
        minutes (the online consumer's reads)."""
        with self._client.lock:
            (blob,) = self._client.conn.execute(sql, params).fetchone()
        return json.loads(blob)

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
        """One SELECT a side, folded into one row (`_one_step`). The
        entity side looks its ids up through idx_<table>_entity; the
        target side has no index (the JAX tables have none), so it scans
        the table once (NOT INDEXED: the entity-type filter would
        otherwise walk the whole entity index row by row)."""
        by_target = target_ids is not None
        if by_target == (entity_ids is not None):
            raise ValueError("find_edges takes entity_ids or target_ids")
        ids = list(dict.fromkeys(target_ids if by_target else entity_ids))
        name = self._ensure_table(app_id, channel_id)
        col = "targetEntityId" if by_target else "entityId"
        # the properties go in as JSON, so the one decode builds their
        # dicts too (json() keeps each number's text as written)
        rows = self._one_step(
            "SELECT json_group_array(json_array(entityId, targetEntityId, "
            "event, json(COALESCE(NULLIF(properties, ''), '{}')), eventTime, "
            f"id)) FROM {name}"
            f"{' NOT INDEXED' if by_target else ''} WHERE entityType = ? "
            "AND targetEntityType = ? AND targetEntityId IS NOT NULL "
            "AND event IN (SELECT value FROM json_each(?)) "
            f"AND {col} IN (SELECT value FROM json_each(?))",
            (entity_type, target_entity_type, json.dumps(list(event_names)),
             json.dumps(ids)))
        pos = {i: n for n, i in enumerate(ids)}
        k = 1 if by_target else 0
        rows.sort(key=lambda r: (pos[r[k]], r[4], r[5]))
        return [(r[0], r[1], r[2], r[3]) for r in rows]

    def latest_revision(self, app_id: int,
                        channel_id: Optional[int] = None) -> int:
        name = self._ensure_table(app_id, channel_id)
        with self._client.lock:
            row = self._client.conn.execute(
                "SELECT rev FROM pio_insert_revisions WHERE tbl = ?", (name,)
            ).fetchone()
        return int(row[0]) if row else 0

    def find_since(
        self,
        app_id: int,
        after_revision: int,
        channel_id: Optional[int] = None,
        limit: Optional[int] = None,
        shard: Optional[tuple[int, int]] = None,
    ) -> list[Event]:
        """Indexed tail read: revision above the cursor (of partition
        `shard` only when one is given), in revision order, one page
        through idx_<table>_rev, folded into one row (`_one_step`)."""
        name = self._ensure_table(app_id, channel_id)
        lim = f" LIMIT {int(limit)}" if limit is not None and limit >= 0 else ""
        where, params = "revision > ?", [int(after_revision)]
        if shard is not None:
            where += " AND pio_shard(entityId, ?) = ?"
            params.extend([int(shard[1]), int(shard[0])])
        rows = self._one_step(
            f"SELECT json_group_array(json_array({self._COLUMNS})) FROM "
            f"(SELECT {self._COLUMNS} FROM {name} WHERE {where} "
            f"ORDER BY revision ASC{lim})", params)
        rows.sort(key=lambda r: r[-1])
        return [self._to_event(r) for r in rows]

    def find_frame(
        self,
        query: EventQuery,
        value_prop: Optional[str] = None,
        default_value: float = 1.0,
    ):
        """The columnar read: only the training columns, straight into
        arrays, with the numeric payload pulled out of the JSON
        properties by sqlite's json_extract; no Event is built (reference
        JDBCPEvents.scala:66-99). A training read takes most of the
        table, so it scans the table (NOT INDEXED) rather than look rows
        up one by one through the entity index, which sqlite otherwise
        picks for the entity-type filter."""
        from predictionio_tpu_torch.data.store.columnar import EventFrame

        name = self._ensure_table(query.app_id, query.channel_id)
        where, params = self._where(query)
        value_sel = (
            f"COALESCE(json_extract(properties, '$.\"{value_prop}\"'), ?)"
            if value_prop is not None else "?"
        )
        sql = (f"SELECT event, entityId, targetEntityId, eventTime, {value_sel} "
               f"FROM {name} NOT INDEXED {where} ORDER BY eventTime ASC, id ASC")
        with self._client.lock:
            rows = self._client.conn.execute(sql, [default_value] + params).fetchall()
        if not rows:
            return EventFrame.from_columns(
                [], [], [], np.zeros(0, np.int64), np.zeros(0, np.float32)
            )
        ev_names, entity_ids, target_ids, times, values = zip(*rows)
        return EventFrame.from_columns(
            ev_names, entity_ids, target_ids,
            np.asarray(times, dtype=np.int64),
            np.asarray(values, dtype=np.float32),
            entity_type=query.entity_type,
            target_entity_type=query.target_entity_type,
        )


class _MetaBase:
    """Table bootstrap shared by the metadata DAOs."""

    DDL: str = ""

    def __init__(self, config: Optional[dict] = None,
                 client: Optional[SqliteClient] = None):
        self._client = client or SqliteClient(config)
        with self._client.lock:
            self._client.conn.execute(self.DDL)
            self._client.conn.commit()

    def _exec(self, sql: str, params=()):
        with self._client.lock:
            try:
                cur = self._client.conn.execute(sql, params)
            except sqlite3.Error:
                # a failed statement must not leave its transaction holding
                # the database's write lock against other connections
                self._client.conn.rollback()
                raise
            self._client.conn.commit()
            return cur

    def _query(self, sql: str, params=()):
        with self._client.lock:
            return self._client.conn.execute(sql, params).fetchall()


class SqliteApps(_MetaBase, base.Apps):
    DDL = """CREATE TABLE IF NOT EXISTS apps (
        id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE NOT NULL,
        description TEXT)"""

    def insert(self, app: App) -> Optional[int]:
        try:
            if app.id > 0:
                self._exec("INSERT INTO apps (id, name, description) VALUES (?,?,?)",
                           (app.id, app.name, app.description))
                return app.id
            return self._exec("INSERT INTO apps (name, description) VALUES (?,?)",
                              (app.name, app.description)).lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, app_id: int) -> Optional[App]:
        rows = self._query("SELECT id, name, description FROM apps WHERE id=?", (app_id,))
        return App(*rows[0]) if rows else None

    def get_by_name(self, name: str) -> Optional[App]:
        rows = self._query("SELECT id, name, description FROM apps WHERE name=?", (name,))
        return App(*rows[0]) if rows else None

    def get_all(self) -> list[App]:
        return [App(*r) for r in self._query("SELECT id, name, description FROM apps")]

    def update(self, app: App) -> bool:
        return self._exec("UPDATE apps SET name=?, description=? WHERE id=?",
                          (app.name, app.description, app.id)).rowcount > 0

    def delete(self, app_id: int) -> bool:
        return self._exec("DELETE FROM apps WHERE id=?", (app_id,)).rowcount > 0


class SqliteAccessKeys(_MetaBase, base.AccessKeys):
    DDL = """CREATE TABLE IF NOT EXISTS accesskeys (
        accesskey TEXT PRIMARY KEY, appid INTEGER NOT NULL, events TEXT)"""

    def insert(self, k: AccessKey) -> Optional[str]:
        key = k.key or secrets.token_urlsafe(32)
        try:
            self._exec("INSERT INTO accesskeys VALUES (?,?,?)",
                       (key, k.app_id, json.dumps(list(k.events))))
        except sqlite3.IntegrityError:
            return None
        return key

    @staticmethod
    def _to_key(row) -> AccessKey:
        return AccessKey(row[0], row[1], tuple(json.loads(row[2]) if row[2] else ()))

    def get(self, key: str) -> Optional[AccessKey]:
        rows = self._query("SELECT * FROM accesskeys WHERE accesskey=?", (key,))
        return self._to_key(rows[0]) if rows else None

    def get_all(self) -> list[AccessKey]:
        return [self._to_key(r) for r in self._query("SELECT * FROM accesskeys")]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [self._to_key(r) for r in
                self._query("SELECT * FROM accesskeys WHERE appid=?", (app_id,))]

    def update(self, k: AccessKey) -> bool:
        return self._exec("UPDATE accesskeys SET appid=?, events=? WHERE accesskey=?",
                          (k.app_id, json.dumps(list(k.events)), k.key)).rowcount > 0

    def delete(self, key: str) -> bool:
        return self._exec("DELETE FROM accesskeys WHERE accesskey=?",
                          (key,)).rowcount > 0


class SqliteChannels(_MetaBase, base.Channels):
    DDL = """CREATE TABLE IF NOT EXISTS channels (
        id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT NOT NULL,
        appid INTEGER NOT NULL, UNIQUE(name, appid))"""

    def insert(self, c: Channel) -> Optional[int]:
        if not Channel.is_valid_name(c.name):
            return None
        try:
            return self._exec("INSERT INTO channels (name, appid) VALUES (?,?)",
                              (c.name, c.app_id)).lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, channel_id: int) -> Optional[Channel]:
        rows = self._query("SELECT id, name, appid FROM channels WHERE id=?",
                           (channel_id,))
        return Channel(*rows[0]) if rows else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [Channel(*r) for r in self._query(
            "SELECT id, name, appid FROM channels WHERE appid=?", (app_id,))]

    def delete(self, channel_id: int) -> bool:
        return self._exec("DELETE FROM channels WHERE id=?", (channel_id,)).rowcount > 0


class SqliteEngineInstances(_MetaBase, base.EngineInstances):
    DDL = """CREATE TABLE IF NOT EXISTS engineinstances (
        id TEXT PRIMARY KEY, status TEXT, startTime INTEGER, endTime INTEGER,
        engineId TEXT, engineVersion TEXT, engineVariant TEXT, engineFactory TEXT,
        batch TEXT, env TEXT, meshConf TEXT, dataSourceParams TEXT,
        preparatorParams TEXT, algorithmsParams TEXT, servingParams TEXT)"""

    def insert(self, i: EngineInstance) -> str:
        iid = i.id or f"ei_{secrets.token_hex(8)}"
        self._exec(
            "INSERT OR REPLACE INTO engineinstances VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (iid, i.status, _ms(i.start_time), _ms(i.end_time), i.engine_id,
             i.engine_version, i.engine_variant, i.engine_factory, i.batch,
             json.dumps(i.env), json.dumps(i.mesh_conf), i.data_source_params,
             i.preparator_params, i.algorithms_params, i.serving_params),
        )
        return iid

    @staticmethod
    def _to_instance(r) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1], start_time=_from_ms(r[2]), end_time=_from_ms(r[3]),
            engine_id=r[4], engine_version=r[5], engine_variant=r[6],
            engine_factory=r[7], batch=r[8], env=json.loads(r[9] or "{}"),
            mesh_conf=json.loads(r[10] or "{}"), data_source_params=r[11],
            preparator_params=r[12], algorithms_params=r[13], serving_params=r[14],
        )

    def get(self, iid: str) -> Optional[EngineInstance]:
        rows = self._query("SELECT * FROM engineinstances WHERE id=?", (iid,))
        return self._to_instance(rows[0]) if rows else None

    def get_all(self) -> list[EngineInstance]:
        return [self._to_instance(r) for r in self._query("SELECT * FROM engineinstances")]

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = self._query(
            """SELECT * FROM engineinstances WHERE status='COMPLETED'
               AND engineId=? AND engineVersion=? AND engineVariant=?
               ORDER BY startTime DESC""",
            (engine_id, engine_version, engine_variant),
        )
        return [self._to_instance(r) for r in rows]

    def update(self, i: EngineInstance) -> bool:
        if self.get(i.id) is None:
            return False
        self.insert(i)
        return True


class SqliteEvaluationInstances(_MetaBase, base.EvaluationInstances):
    DDL = """CREATE TABLE IF NOT EXISTS evaluationinstances (
        id TEXT PRIMARY KEY, status TEXT, startTime INTEGER, endTime INTEGER,
        evaluationClass TEXT, engineParamsGeneratorClass TEXT, batch TEXT,
        env TEXT, evaluatorResults TEXT, evaluatorResultsHTML TEXT,
        evaluatorResultsJSON TEXT)"""

    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or f"evi_{secrets.token_hex(8)}"
        self._exec(
            "INSERT OR REPLACE INTO evaluationinstances VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (iid, i.status, _ms(i.start_time), _ms(i.end_time), i.evaluation_class,
             i.engine_params_generator_class, i.batch, json.dumps(i.env),
             i.evaluator_results, i.evaluator_results_html, i.evaluator_results_json),
        )
        return iid

    @staticmethod
    def _to_instance(r) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1], start_time=_from_ms(r[2]), end_time=_from_ms(r[3]),
            evaluation_class=r[4], engine_params_generator_class=r[5], batch=r[6],
            env=json.loads(r[7] or "{}"), evaluator_results=r[8],
            evaluator_results_html=r[9], evaluator_results_json=r[10],
        )

    def get(self, iid: str) -> Optional[EvaluationInstance]:
        rows = self._query("SELECT * FROM evaluationinstances WHERE id=?", (iid,))
        return self._to_instance(rows[0]) if rows else None

    def get_all(self) -> list[EvaluationInstance]:
        return [self._to_instance(r)
                for r in self._query("SELECT * FROM evaluationinstances")]

    def update(self, i: EvaluationInstance) -> bool:
        if self.get(i.id) is None:
            return False
        self.insert(i)
        return True


class SqliteEngineManifests(_MetaBase, base.EngineManifests):
    DDL = """CREATE TABLE IF NOT EXISTS enginemanifests (
        id TEXT, version TEXT, name TEXT, description TEXT, files TEXT,
        engineFactory TEXT, PRIMARY KEY (id, version))"""

    def insert(self, m: EngineManifest) -> None:
        self._exec(
            "INSERT OR REPLACE INTO enginemanifests VALUES (?,?,?,?,?,?)",
            (m.id, m.version, m.name, m.description, json.dumps(list(m.files)),
             m.engine_factory),
        )

    @staticmethod
    def _to_manifest(r) -> EngineManifest:
        return EngineManifest(
            id=r[0], version=r[1], name=r[2], description=r[3],
            files=tuple(json.loads(r[4] or "[]")), engine_factory=r[5],
        )

    def get(self, mid: str, version: str) -> Optional[EngineManifest]:
        rows = self._query("SELECT * FROM enginemanifests WHERE id=? AND version=?",
                           (mid, version))
        return self._to_manifest(rows[0]) if rows else None

    def get_all(self) -> list[EngineManifest]:
        return [self._to_manifest(r) for r in self._query("SELECT * FROM enginemanifests")]

    def update(self, m: EngineManifest, upsert: bool = False) -> None:
        if not upsert and self.get(m.id, m.version) is None:
            raise StorageError(f"manifest {m.id} {m.version} not found")
        self.insert(m)

    def delete(self, mid: str, version: str) -> None:
        self._exec("DELETE FROM enginemanifests WHERE id=? AND version=?", (mid, version))
