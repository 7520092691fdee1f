"""PostgreSQL storage: events and the seven metadata DAOs.

Counterpart of the JAX package's ``data/storage/postgres.py`` (reference
jdbc/JDBCLEvents.scala:34, JDBCPEvents.scala:29 and the seven JDBC
metadata DAOs). The tables, their columns, the SQL text and the row
codecs are the JAX package's, so a database written by either package
reads in the other: one events table per app and channel,
``events_<appId>[_<channelId>]``, the ``pio_data_versions`` and
``pio_insert_revisions`` bookkeeping, and the ``apps``, ``accesskeys``,
``channels``, ``engineinstances``, ``evaluationinstances``,
``enginemanifests`` and ``models`` tables, in the Postgres dialect
(``%s`` parameters, IDENTITY keys with RETURNING, BYTEA blobs, INSERT …
ON CONFLICT upserts).

The driver is found at run time: psycopg2, else pg8000, else a
StorageError that names both. Configure with
``PIO_STORAGE_SOURCES_<NAME>_TYPE=postgres`` and ``_HOST``, ``_PORT``,
``_DBNAME``, ``_USERNAME``, ``_PASSWORD`` (or one ``_URL=postgresql://
user:pass@host:port/db``). ``_PGClient(conn=...)`` takes a DB-API
connection instead: the tests' sqlite-backed fake driver
(``tests/fake_pg.py``) goes in there.

A find reads keyset pages of ``FIND_PAGE`` rows on (eventTime, id);
``find_since`` pages by revision; ``find_frame`` pages by (eventTime, id)
and pulls the value out of the JSON properties on the host. Postgres
has no portable crc32, so a partitioned read (``EventQuery.shard``,
``find_since``'s ``shard``) filters each page on the host.
``find_entities_batch`` and ``find_edges`` are the base store's
per-entity reads, as in the JAX package.
"""

from __future__ import annotations

import dataclasses as _dcs
import datetime as _dt
import json
import threading
from typing import Any, Iterator, Optional

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
    Model,
    StorageError,
)
import secrets

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _ms(dt: _dt.datetime) -> int:
    return int(dt.timestamp() * 1000)


def _from_ms(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc)


def _pg(sql: str) -> str:
    """sqlite-style `?` placeholders → DB-API `%s` (keeps the query text
    side-by-side comparable with sqlite.py)."""
    return sql.replace("?", "%s")


def _load_driver():
    """psycopg2 or pg8000 — first importable wins."""
    try:
        import psycopg2  # type: ignore

        return "psycopg2", psycopg2
    except ImportError:
        pass
    try:
        import pg8000.dbapi  # type: ignore

        return "pg8000", pg8000.dbapi
    except ImportError:
        pass
    raise StorageError(
        "postgres backend needs a driver: install psycopg2 or pg8000"
    )


def _parse_url(url: str) -> dict:
    """postgres:// DSN → connect kwargs. urlsplit-based: percent-decoded
    credentials, IPv6 hosts, and query params (sslmode=…) passed through
    to the driver."""
    from urllib.parse import parse_qsl, unquote, urlsplit

    parts = urlsplit(url)
    if parts.scheme not in ("postgres", "postgresql"):
        raise StorageError(f"cannot parse postgres URL {url!r}")
    kw = dict(
        host=parts.hostname or "127.0.0.1",
        port=parts.port or 5432,
        database=(parts.path or "/pio").lstrip("/"),
        user=unquote(parts.username) if parts.username else "pio",
        password=unquote(parts.password) if parts.password else "",
    )
    kw.update(dict(parse_qsl(parts.query)))
    return kw


class _PGClient:
    """One shared connection + lock (reference jdbc/StorageClient pool
    role; a lock-serialized connection matches the daemon's single-writer
    discipline and keeps the DAO code identical to sqlite's)."""

    def __init__(self, config: Optional[dict] = None, conn: Any = None):
        config = config or {}
        self.lock = threading.RLock()
        if conn is not None:  # injected by tests (fake driver)
            self.conn = conn
            return
        _, driver = _load_driver()
        url = config.get("URL")
        if url:
            kw = _parse_url(url)
        else:
            kw = dict(
                host=config.get("HOST", "127.0.0.1"),
                port=int(config.get("PORT", "5432")),
                database=config.get("DBNAME", "pio"),
                user=config.get("USERNAME", "pio"),
                password=config.get("PASSWORD", ""),
            )
        try:
            self.conn = driver.connect(**kw)
        except Exception as e:  # connection-refused, auth, ...
            raise StorageError(
                f"cannot connect to postgres at {kw.get('host')}:{kw.get('port')}: {e}"
            ) from e

    def _rollback_quietly(self) -> None:
        try:
            self.conn.rollback()
        except Exception:
            pass

    def commit(self) -> None:
        """A server round trip plus an fsync on the far side."""
        self.conn.commit()

    def execute(self, sql: str, params: tuple = ()) -> Any:
        with self.lock:
            cur = self.conn.cursor()
            try:
                cur.execute(sql, params)
                self.commit()
            except Exception:
                # roll back so one failed statement can't leave the shared
                # connection in 'current transaction is aborted' and poison
                # every later DAO call
                self._rollback_quietly()
                raise
            return cur

    def query(self, sql: str, params: tuple = ()) -> list[tuple]:
        with self.lock:
            cur = self.conn.cursor()
            try:
                cur.execute(sql, params)
                rows = cur.fetchall()
                # close the read transaction — otherwise the connection
                # sits 'idle in transaction' until a server timeout kills it
                self.commit()
            except Exception:
                self._rollback_quietly()
                raise
            finally:
                cur.close()
            return rows

    def execute_returning(self, sql: str, params: tuple = ()) -> list[tuple]:
        """Writes that fetch (INSERT … RETURNING): fetch THEN commit — a
        plain query() would leave the row uncommitted, and a later rollback
        (e.g. after a duplicate-key insert) would silently discard it."""
        with self.lock:
            cur = self.conn.cursor()
            try:
                cur.execute(sql, params)
                rows = cur.fetchall()
                self.commit()
            except Exception:
                self._rollback_quietly()
                raise
            finally:
                cur.close()
            return rows

    def executemany(self, sql: str, rows: list[tuple]) -> None:
        with self.lock:
            cur = self.conn.cursor()
            try:
                cur.executemany(sql, rows)
                self.commit()
            except Exception:
                self._rollback_quietly()
                raise
            finally:
                cur.close()


def CLIENT_FACTORY(config: dict[str, str]) -> _PGClient:
    return _PGClient(config)


class PostgresEventStore(base.EventStore):
    """Events: one table per (app, channel) — events_{appId}[_{channelId}]
    (reference JDBCUtils.eventTableName layout)."""

    #: DB round trips release the GIL — sharded composites fan writes
    #: out concurrently instead of running them inline (sharded.py)
    IO_PARALLEL_WRITES = True

    def __init__(self, config: Optional[dict] = None, client: Optional[_PGClient] = None):
        self._client = client or _PGClient(config)
        self._known_tables: set[str] = set()

    def _table_name(self, app_id: int, channel_id: Optional[int]) -> str:
        return f"events_{app_id}" + (f"_{channel_id}" if channel_id else "")

    _VERSIONS_DDL = (
        "CREATE TABLE IF NOT EXISTS pio_data_versions "
        "(tbl TEXT PRIMARY KEY, ver BIGINT NOT NULL)"
    )

    # server-assigned insert revisions (as in sqlite): one monotonic
    # counter per events table, advanced under the client lock so the
    # tail order cannot be skewed by client-supplied event times. No RETURNING — the update+select
    # pair under the (reentrant) client lock works on every driver,
    # including old-sqlite fake_pg hosts.
    _REVISIONS_DDL = (
        "CREATE TABLE IF NOT EXISTS pio_insert_revisions "
        "(tbl TEXT PRIMARY KEY, rev BIGINT NOT NULL)"
    )

    def _next_revisions(self, name: str, n: int) -> int:
        """Advance the table's revision counter by `n`; returns the
        FIRST assigned revision."""
        with self._client.lock:
            self._client.execute(
                _pg(
                    "INSERT INTO pio_insert_revisions VALUES (?, ?) "
                    "ON CONFLICT (tbl) DO UPDATE SET "
                    "rev = pio_insert_revisions.rev + ?"
                ),
                (name, n, n),
            )
            rows = self._client.query(
                _pg("SELECT rev FROM pio_insert_revisions WHERE tbl = ?"),
                (name,),
            )
        return int(rows[0][0]) - n + 1

    def _bump(self, name: str) -> None:
        # exact write version: bumped on every mutation (incl. upsert
        # in-place updates) so data_signature cannot collide under
        # delete+replay or property rewrites
        self._client.execute(
            _pg(
                "INSERT INTO pio_data_versions VALUES (?, 1) "
                "ON CONFLICT (tbl) DO UPDATE SET ver = pio_data_versions.ver + 1"
            ),
            (name,),
        )

    def _ensure_table(self, app_id: int, channel_id: Optional[int]) -> str:
        name = self._table_name(app_id, channel_id)
        if name in self._known_tables:
            return name
        self._client.execute(self._VERSIONS_DDL)
        self._client.execute(self._REVISIONS_DDL)
        self._client.execute(
            f"""CREATE TABLE IF NOT EXISTS {name} (
                id TEXT PRIMARY KEY,
                event TEXT NOT NULL,
                entityType TEXT NOT NULL,
                entityId TEXT NOT NULL,
                targetEntityType TEXT,
                targetEntityId TEXT,
                properties TEXT,
                eventTime BIGINT NOT NULL,
                tags TEXT,
                prId TEXT,
                creationTime BIGINT NOT NULL,
                revision BIGINT)"""
        )
        # migrate pre-revision tables in place; existing rows keep NULL
        # revisions — only new inserts are tailable, which is what a
        # consumer attached mid-life wants (sqlite.py discipline)
        try:
            self._client.execute(
                f"ALTER TABLE {name} ADD COLUMN revision BIGINT"
            )
        except Exception:
            pass  # column already exists
        self._client.execute(
            f"CREATE INDEX IF NOT EXISTS {name}_time ON {name} (eventTime, id)"
        )
        self._client.execute(
            f"CREATE INDEX IF NOT EXISTS {name}_entity "
            f"ON {name} (entityType, entityId)"
        )
        self._client.execute(
            f"CREATE INDEX IF NOT EXISTS {name}_rev ON {name} (revision)"
        )
        # seed the counter from any revisions already present (a restart
        # must continue the sequence, never reuse it)
        self._client.execute(
            _pg(
                "INSERT INTO pio_insert_revisions VALUES (?, "
                f"COALESCE((SELECT MAX(revision) FROM {name}), 0)) "
                "ON CONFLICT (tbl) DO NOTHING"
            ),
            (name,),
        )
        self._known_tables.add(name)
        return name

    def init_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._ensure_table(app_id, channel_id)
        return True

    def remove_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        name = self._table_name(app_id, channel_id)
        self._client.execute(f"DROP TABLE IF EXISTS {name}")
        self._known_tables.discard(name)
        return True

    def close(self) -> None:
        # commit-only, like the sqlite backend: the registry shares one
        # _PGClient across every DAO of the source, so actually closing the
        # connection here would kill the metadata/model DAOs too
        with self._client.lock:
            try:
                self._client.commit()
            except Exception:
                pass

    def _row(self, event: Event, eid: str, revision: int) -> tuple:
        return (
            eid,
            event.event,
            event.entity_type,
            event.entity_id,
            event.target_entity_type,
            event.target_entity_id,
            json.dumps(dict(event.properties)),
            _ms(event.event_time),
            json.dumps(list(event.tags)) if event.tags else None,
            event.pr_id,
            _ms(event.creation_time),
            revision,
        )

    _UPSERT = (
        "INSERT INTO {t} VALUES (?,?,?,?,?,?,?,?,?,?,?,?) "
        "ON CONFLICT (id) DO UPDATE SET event=EXCLUDED.event, "
        "entityType=EXCLUDED.entityType, entityId=EXCLUDED.entityId, "
        "targetEntityType=EXCLUDED.targetEntityType, "
        "targetEntityId=EXCLUDED.targetEntityId, "
        "properties=EXCLUDED.properties, eventTime=EXCLUDED.eventTime, "
        "tags=EXCLUDED.tags, prId=EXCLUDED.prId, "
        "creationTime=EXCLUDED.creationTime, revision=EXCLUDED.revision"
    )

    def insert(
        self, event: Event, app_id: int, channel_id: Optional[int] = None
    ) -> str:
        name = self._ensure_table(app_id, channel_id)
        eid = event.event_id or new_event_id()
        # revision assignment and the row write share ONE client-lock
        # hold (sqlite.py discipline): released in between, a slower
        # writer's rows could commit AFTER a faster writer's higher
        # revisions became visible, and a tail consumer that advanced
        # past them would skip those events forever. NOTE the lock is
        # process-local — like the lock-serialized connection itself,
        # the revision sequence assumes one writer PROCESS per database
        # (multi-process deployments front postgres with the storage
        # daemon, which is that single writer).
        with self._client.lock:
            rev = self._next_revisions(name, 1)
            self._client.execute(
                _pg(self._UPSERT.format(t=name)),
                self._row(event, eid, rev),
            )
            self._bump(name)
        return eid

    def insert_batch(self, events, app_id, channel_id=None) -> list[str]:
        name = self._ensure_table(app_id, channel_id)
        eids = [e.event_id or new_event_id() for e in events]
        with self._client.lock:  # see insert(): assign+write atomically
            rev0 = self._next_revisions(name, len(events)) if events else 0
            self._client.executemany(
                _pg(self._UPSERT.format(t=name)),
                [
                    self._row(e, i, rev0 + k)
                    for k, (e, i) in enumerate(zip(events, eids))
                ],
            )
            self._bump(name)
        return eids

    def delete(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> bool:
        name = self._ensure_table(app_id, channel_id)
        cur = self._client.execute(
            _pg(f"DELETE FROM {name} WHERE id = ?"), (event_id,)
        )
        if cur.rowcount > 0:
            self._bump(name)
        return cur.rowcount > 0

    def delete_batch(self, event_ids, app_id, channel_id=None) -> int:
        name = self._ensure_table(app_id, channel_id)
        if not event_ids:
            return 0
        marks = ",".join("%s" for _ in event_ids)
        cur = self._client.execute(
            f"DELETE FROM {name} WHERE id IN ({marks})", tuple(event_ids)
        )
        if cur.rowcount > 0:
            self._bump(name)
        return cur.rowcount

    @staticmethod
    def _to_event(row: tuple) -> Event:
        (eid, event, etype, eidd, tetype, teid, props, etime, tags, pr_id,
         ctime, *rest) = row  # rest: revision (absent pre-migration)
        return Event(
            event=event,
            entity_type=etype,
            entity_id=eidd,
            target_entity_type=tetype,
            target_entity_id=teid,
            properties=json.loads(props) if props else {},
            event_time=_from_ms(etime),
            tags=tuple(json.loads(tags)) if tags else (),
            pr_id=pr_id,
            creation_time=_from_ms(ctime),
            event_id=eid,
            revision=(
                int(rest[0]) if rest and rest[0] is not None else None
            ),
        )

    def get(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> Optional[Event]:
        name = self._ensure_table(app_id, channel_id)
        rows = self._client.query(
            _pg(f"SELECT * FROM {name} WHERE id = ?"), (event_id,)
        )
        return self._to_event(rows[0]) if rows else None

    def _where(self, query: EventQuery) -> tuple[str, list]:
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
            marks = ",".join("?" for _ in query.event_names)
            clauses.append(f"event IN ({marks})")
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
            clauses.append(
                f"(eventTime {op} ? OR (eventTime = ? AND id {op} ?))"
            )
            params.extend([_ms(t), _ms(t), eid])
        return ("WHERE " + " AND ".join(clauses)) if clauses else "", params

    # page size for streamed find(): bounds host memory at train scale
    # while keeping per-page SQL overhead negligible; keyset pagination
    # (not OFFSET) so each page is O(page)
    FIND_PAGE = 10_000

    def find(self, query: EventQuery) -> Iterator[Event]:
        """Streamed iteration via keyset pagination on (eventTime, id).

        A fetchall of the whole result set would materialize a
        train-scale read (tens of millions of rows) in host RAM at once;
        a psycopg2 named cursor would pin the shared lock-serialized
        connection inside a long-lived transaction. Keyset pages commit
        between fetches, are driver-agnostic (pg8000 buffers client-side
        anyway), and reuse the same (eventTime, id) cursor contract the
        remote backend exposes (remote.py keyset paging)."""
        name = self._ensure_table(query.app_id, query.channel_id)
        order = "DESC" if query.reversed else "ASC"

        def gen():
            limit = (
                int(query.limit)
                if query.limit is not None and query.limit >= 0
                else None
            )
            if limit == 0:
                return
            # without a shard filter the SQL LIMIT can carry the budget;
            # with one, pages stay full-size and `limit` counts MATCHED
            # events host-side (postgres has no portable crc32 to push
            # the shard predicate into SQL — entityId filtering happens
            # here, row[3], before Event construction)
            matched = 0
            q = query
            while True:
                n = self.FIND_PAGE
                if query.shard is None and limit is not None:
                    n = min(n, limit - matched)
                    if n <= 0:
                        return
                where, params = self._where(q)
                rows = self._client.query(
                    _pg(
                        f"SELECT * FROM {name} {where} "
                        f"ORDER BY eventTime {order}, id {order} LIMIT {n}"
                    ),
                    tuple(params),
                )
                for r in rows:
                    if query.shard is not None and not query.shard_matches(
                        r[3]
                    ):
                        continue
                    yield self._to_event(r)
                    matched += 1
                    if limit is not None and matched >= limit:
                        return
                if len(rows) < n:
                    return
                last = rows[-1]  # (id, ..., eventTime at index 7, ...)
                q = _dcs.replace(
                    q, start_after=(_from_ms(last[7]), last[0])
                )

        return gen()

    def latest_revision(
        self, app_id: int, channel_id: Optional[int] = None
    ) -> int:
        name = self._ensure_table(app_id, channel_id)
        rows = self._client.query(
            _pg("SELECT rev FROM pio_insert_revisions WHERE tbl = ?"),
            (name,),
        )
        return int(rows[0][0]) if rows else 0

    def find_since(
        self,
        app_id: int,
        after_revision: int,
        channel_id: Optional[int] = None,
        limit: Optional[int] = None,
        shard: Optional[tuple[int, int]] = None,
    ) -> list[Event]:
        """Indexed tail read via {table}_rev: revision > cursor, paged
        by revision keyset so a shard filter (applied host-side — no
        portable crc32 in SQL) never under-delivers a LIMIT."""
        name = self._ensure_table(app_id, channel_id)
        out: list[Event] = []
        cursor = int(after_revision)
        while True:
            if limit is not None and 0 <= limit <= len(out):
                return out[:limit]
            n = self.FIND_PAGE
            if shard is None and limit is not None and limit >= 0:
                n = min(n, limit - len(out))
            rows = self._client.query(
                _pg(
                    f"SELECT * FROM {name} WHERE revision > ? "
                    f"ORDER BY revision ASC LIMIT {n}"
                ),
                (cursor,),
            )
            for r in rows:
                if shard is not None and base.shard_of(
                    r[3], shard[1]
                ) != shard[0]:
                    continue
                out.append(self._to_event(r))
                if limit is not None and 0 <= limit <= len(out):
                    return out
            if len(rows) < n:
                return out
            cursor = int(rows[-1][11])

    def data_signature(self, app_id: int, channel_id: Optional[int] = None) -> str:
        # count + exact write version (pio_data_versions): no collision
        # under delete+replayed-insert or in-place upsert rewrites
        name = self._ensure_table(app_id, channel_id)
        rows = self._client.query(f"SELECT COUNT(*) FROM {name}")
        ver = self._client.query(
            _pg("SELECT ver FROM pio_data_versions WHERE tbl = ?"), (name,)
        )
        return f"{rows[0][0]}:{ver[0][0] if ver else 0}"

    def find_frame(
        self,
        query: EventQuery,
        value_prop: Optional[str] = None,
        default_value: float = 1.0,
    ):
        """Columnar fast path for training reads: SELECT only the five
        training-relevant columns — no per-row Event/DataMap construction.
        The numeric payload is pulled from the JSON properties column
        host-side (dialect-neutral; sqlite's variant pushes json_extract
        into SQL — sqlite.py find_frame). Role: reference JDBCPEvents
        partitioned scan (JDBCPEvents.scala:66-99)."""
        import numpy as np

        from predictionio_tpu_torch.data.store.columnar import EventFrame

        name = self._ensure_table(query.app_id, query.channel_id)
        # stream keyset pages (same discipline as find()): a train-scale
        # read never materializes unfiltered in host RAM, and with a
        # shard filter each page is thinned server-call-by-server-call
        # instead of after one giant fetchall
        rows: list = []
        # frame pages always walk eventTime ASC; normalize `reversed` so
        # the start_after predicate from _where() paginates forward (a
        # reversed query would otherwise re-select the first page forever)
        q = _dcs.replace(query, reversed=False)
        while True:
            where, params = self._where(q)
            page = self._client.query(
                _pg(
                    f"SELECT event, entityId, targetEntityId, eventTime, "
                    f"properties, id FROM {name} {where} "
                    f"ORDER BY eventTime ASC, id ASC LIMIT {self.FIND_PAGE}"
                ),
                tuple(params),
            )
            if query.shard is not None:
                rows.extend(
                    r[:5] for r in page if query.shard_matches(r[1])
                )
            else:
                rows.extend(r[:5] for r in page)
            if len(page) < self.FIND_PAGE:
                break
            last = page[-1]
            q = _dcs.replace(
                q, start_after=(_from_ms(last[3]), last[5])
            )
        if not rows:
            return EventFrame.from_columns(
                [], [], [], np.zeros(0, np.int64), np.zeros(0, np.float32)
            )
        ev_names, entity_ids, target_ids, times, props = zip(*rows)
        if value_prop is None:
            values = np.full(len(rows), default_value, np.float32)
        else:
            def pull(p):
                if not p:
                    return default_value
                v = json.loads(p).get(value_prop)
                return default_value if v is None else float(v)

            values = np.asarray([pull(p) for p in props], np.float32)
        return EventFrame.from_columns(
            ev_names,
            entity_ids,
            target_ids,
            np.asarray(times, dtype=np.int64),
            values,
            entity_type=query.entity_type,
            target_entity_type=query.target_entity_type,
        )


class _MetaBase:
    """Shared table bootstrap for postgres metadata DAOs."""

    DDL: str = ""
    TABLE: str = ""

    def __init__(self, config: Optional[dict] = None, client: Optional[_PGClient] = None):
        self._client = client or _PGClient(config)
        self._client.execute(self.DDL)

    def _exec(self, sql: str, params=()):
        return self._client.execute(_pg(sql), tuple(params))

    def _query(self, sql: str, params=()):
        return self._client.query(_pg(sql), tuple(params))

    def _exec_returning(self, sql: str, params=()):
        return self._client.execute_returning(_pg(sql), tuple(params))

    def _integrity_error(self, e: Exception) -> bool:
        """Duplicate-key detection by SQLSTATE, not message text.

        psycopg2 exposes .pgcode; pg8000 a DatabaseError whose args dict
        carries the code under 'C'; the fake test driver wraps sqlite's
        IntegrityError. The SQLSTATE for unique_violation is 23505 — a
        generic 'unique' substring match would also swallow unrelated
        errors that merely NAME a unique index."""
        code = getattr(e, "pgcode", None)  # psycopg2
        if code is not None:
            return code == "23505"
        for a in getattr(e, "args", ()):  # pg8000: {'C': '23505', ...}
            if isinstance(a, dict) and a.get("C"):
                return a["C"] == "23505"
        if "23505" in repr(e):
            return True
        # fake driver (tests/fake_pg.py) wraps sqlite3.IntegrityError
        import sqlite3

        cause = e
        while cause is not None:
            if isinstance(cause, sqlite3.IntegrityError):
                return "unique" in str(cause).lower()
            cause = cause.__cause__
        return False


class PostgresApps(_MetaBase, base.Apps):
    TABLE = "apps"
    DDL = """CREATE TABLE IF NOT EXISTS apps (
        id INT GENERATED BY DEFAULT AS IDENTITY PRIMARY KEY,
        name TEXT UNIQUE NOT NULL, description TEXT)"""

    def _advance_sequence(self, table: str) -> None:
        """Explicit-id inserts bypass the IDENTITY counter; align it so a
        later auto-id insert can't collide with an explicitly-chosen id.
        No-op on the sqlite-backed fake driver (AUTOINCREMENT self-aligns,
        and pg_get_serial_sequence doesn't exist there)."""
        try:
            self._exec(
                f"SELECT setval(pg_get_serial_sequence('{table}','id'), "
                f"(SELECT COALESCE(MAX(id),1) FROM {table}))"
            )
        except Exception:
            with self._client.lock:
                self._client._rollback_quietly()

    def insert(self, app: App) -> Optional[int]:
        try:
            if app.id > 0:
                self._exec(
                    "INSERT INTO apps (id, name, description) VALUES (?,?,?)",
                    (app.id, app.name, app.description),
                )
                self._advance_sequence("apps")
                return app.id
            rows = self._exec_returning(
                "INSERT INTO apps (name, description) VALUES (?,?) RETURNING id",
                (app.name, app.description),
            )
            return rows[0][0]
        except Exception as e:
            if self._integrity_error(e):
                with self._client.lock:
                    self._client.conn.rollback()
                return None
            raise

    def get(self, app_id: int) -> Optional[App]:
        rows = self._query(
            "SELECT id, name, description FROM apps WHERE id=?", (app_id,)
        )
        return App(*rows[0]) if rows else None

    def get_by_name(self, name: str) -> Optional[App]:
        rows = self._query(
            "SELECT id, name, description FROM apps WHERE name=?", (name,)
        )
        return App(*rows[0]) if rows else None

    def get_all(self) -> list[App]:
        return [
            App(*r)
            for r in self._query("SELECT id, name, description FROM apps")
        ]

    def update(self, app: App) -> bool:
        cur = self._exec(
            "UPDATE apps SET name=?, description=? WHERE id=?",
            (app.name, app.description, app.id),
        )
        return cur.rowcount > 0

    def delete(self, app_id: int) -> bool:
        return self._exec("DELETE FROM apps WHERE id=?", (app_id,)).rowcount > 0


class PostgresAccessKeys(_MetaBase, base.AccessKeys):
    TABLE = "accesskeys"
    DDL = """CREATE TABLE IF NOT EXISTS accesskeys (
        accesskey TEXT PRIMARY KEY, appid INT NOT NULL, events TEXT)"""

    def insert(self, k: AccessKey) -> Optional[str]:
        key = k.key or secrets.token_urlsafe(32)
        try:
            self._exec(
                "INSERT INTO accesskeys VALUES (?,?,?)",
                (key, k.app_id, json.dumps(list(k.events))),
            )
            return key
        except Exception as e:
            if self._integrity_error(e):
                with self._client.lock:
                    self._client.conn.rollback()
                return None
            raise

    @staticmethod
    def _to_key(row) -> AccessKey:
        return AccessKey(
            row[0], row[1], tuple(json.loads(row[2]) if row[2] else [])
        )

    def get(self, key: str) -> Optional[AccessKey]:
        rows = self._query("SELECT * FROM accesskeys WHERE accesskey=?", (key,))
        return self._to_key(rows[0]) if rows else None

    def get_all(self) -> list[AccessKey]:
        return [self._to_key(r) for r in self._query("SELECT * FROM accesskeys")]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [
            self._to_key(r)
            for r in self._query(
                "SELECT * FROM accesskeys WHERE appid=?", (app_id,)
            )
        ]

    def update(self, k: AccessKey) -> bool:
        cur = self._exec(
            "UPDATE accesskeys SET appid=?, events=? WHERE accesskey=?",
            (k.app_id, json.dumps(list(k.events)), k.key),
        )
        return cur.rowcount > 0

    def delete(self, key: str) -> bool:
        return self._exec(
            "DELETE FROM accesskeys WHERE accesskey=?", (key,)
        ).rowcount > 0


class PostgresChannels(_MetaBase, base.Channels):
    TABLE = "channels"
    DDL = """CREATE TABLE IF NOT EXISTS channels (
        id INT GENERATED BY DEFAULT AS IDENTITY PRIMARY KEY,
        name TEXT NOT NULL, appid INT NOT NULL, UNIQUE(name, appid))"""

    def insert(self, c: Channel) -> Optional[int]:
        if not Channel.is_valid_name(c.name):
            return None
        try:
            rows = self._exec_returning(
                "INSERT INTO channels (name, appid) VALUES (?,?) RETURNING id",
                (c.name, c.app_id),
            )
            return rows[0][0]
        except Exception as e:
            if self._integrity_error(e):
                with self._client.lock:
                    self._client.conn.rollback()
                return None
            raise

    def get(self, channel_id: int) -> Optional[Channel]:
        rows = self._query(
            "SELECT id, name, appid FROM channels WHERE id=?", (channel_id,)
        )
        return Channel(*rows[0]) if rows else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [
            Channel(*r)
            for r in self._query(
                "SELECT id, name, appid FROM channels WHERE appid=?", (app_id,)
            )
        ]

    def delete(self, channel_id: int) -> bool:
        return self._exec(
            "DELETE FROM channels WHERE id=?", (channel_id,)
        ).rowcount > 0


class PostgresEngineInstances(_MetaBase, base.EngineInstances):
    TABLE = "engineinstances"
    DDL = """CREATE TABLE IF NOT EXISTS engineinstances (
        id TEXT PRIMARY KEY, status TEXT, startTime BIGINT, endTime BIGINT,
        engineId TEXT, engineVersion TEXT, engineVariant TEXT,
        engineFactory TEXT, batch TEXT, env TEXT, meshConf TEXT,
        dataSourceParams TEXT, preparatorParams TEXT, algorithmsParams TEXT,
        servingParams TEXT)"""

    _UPSERT = (
        "INSERT INTO engineinstances VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?) "
        "ON CONFLICT (id) DO UPDATE SET status=EXCLUDED.status, "
        "startTime=EXCLUDED.startTime, endTime=EXCLUDED.endTime, "
        "engineId=EXCLUDED.engineId, engineVersion=EXCLUDED.engineVersion, "
        "engineVariant=EXCLUDED.engineVariant, "
        "engineFactory=EXCLUDED.engineFactory, batch=EXCLUDED.batch, "
        "env=EXCLUDED.env, meshConf=EXCLUDED.meshConf, "
        "dataSourceParams=EXCLUDED.dataSourceParams, "
        "preparatorParams=EXCLUDED.preparatorParams, "
        "algorithmsParams=EXCLUDED.algorithmsParams, "
        "servingParams=EXCLUDED.servingParams"
    )

    def insert(self, i: EngineInstance) -> str:
        iid = i.id or f"ei_{secrets.token_hex(8)}"
        self._exec(
            self._UPSERT,
            (
                iid, i.status, _ms(i.start_time), _ms(i.end_time), i.engine_id,
                i.engine_version, i.engine_variant, i.engine_factory, i.batch,
                json.dumps(i.env), json.dumps(i.mesh_conf),
                i.data_source_params, i.preparator_params,
                i.algorithms_params, i.serving_params,
            ),
        )
        return iid

    @staticmethod
    def _to_instance(r) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1], start_time=_from_ms(r[2]),
            end_time=_from_ms(r[3]), engine_id=r[4], engine_version=r[5],
            engine_variant=r[6], engine_factory=r[7], batch=r[8],
            env=json.loads(r[9] or "{}"), mesh_conf=json.loads(r[10] or "{}"),
            data_source_params=r[11], preparator_params=r[12],
            algorithms_params=r[13], serving_params=r[14],
        )

    def get(self, iid: str) -> Optional[EngineInstance]:
        rows = self._query("SELECT * FROM engineinstances WHERE id=?", (iid,))
        return self._to_instance(rows[0]) if rows else None

    def get_all(self) -> list[EngineInstance]:
        return [
            self._to_instance(r)
            for r in self._query("SELECT * FROM engineinstances")
        ]

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = self._query(
            """SELECT * FROM engineinstances WHERE status='COMPLETED'
               AND engineId=? AND engineVersion=? AND engineVariant=?
               ORDER BY startTime DESC""",
            (engine_id, engine_version, engine_variant),
        )
        return [self._to_instance(r) for r in rows]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def update(self, i: EngineInstance) -> bool:
        if self.get(i.id) is None:
            return False
        self.insert(i)
        return True

    def delete(self, iid: str) -> bool:
        return self._exec(
            "DELETE FROM engineinstances WHERE id=?", (iid,)
        ).rowcount > 0


class PostgresEvaluationInstances(_MetaBase, base.EvaluationInstances):
    TABLE = "evaluationinstances"
    DDL = """CREATE TABLE IF NOT EXISTS evaluationinstances (
        id TEXT PRIMARY KEY, status TEXT, startTime BIGINT, endTime BIGINT,
        evaluationClass TEXT, engineParamsGeneratorClass TEXT, batch TEXT,
        env TEXT, evaluatorResults TEXT, evaluatorResultsHTML TEXT,
        evaluatorResultsJSON TEXT)"""

    _UPSERT = (
        "INSERT INTO evaluationinstances VALUES (?,?,?,?,?,?,?,?,?,?,?) "
        "ON CONFLICT (id) DO UPDATE SET status=EXCLUDED.status, "
        "startTime=EXCLUDED.startTime, endTime=EXCLUDED.endTime, "
        "evaluationClass=EXCLUDED.evaluationClass, "
        "engineParamsGeneratorClass=EXCLUDED.engineParamsGeneratorClass, "
        "batch=EXCLUDED.batch, env=EXCLUDED.env, "
        "evaluatorResults=EXCLUDED.evaluatorResults, "
        "evaluatorResultsHTML=EXCLUDED.evaluatorResultsHTML, "
        "evaluatorResultsJSON=EXCLUDED.evaluatorResultsJSON"
    )

    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or f"evi_{secrets.token_hex(8)}"
        self._exec(
            self._UPSERT,
            (
                iid, i.status, _ms(i.start_time), _ms(i.end_time),
                i.evaluation_class, i.engine_params_generator_class, i.batch,
                json.dumps(i.env), i.evaluator_results,
                i.evaluator_results_html, i.evaluator_results_json,
            ),
        )
        return iid

    @staticmethod
    def _to_instance(r) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1], start_time=_from_ms(r[2]),
            end_time=_from_ms(r[3]), evaluation_class=r[4],
            engine_params_generator_class=r[5], batch=r[6],
            env=json.loads(r[7] or "{}"), evaluator_results=r[8],
            evaluator_results_html=r[9], evaluator_results_json=r[10],
        )

    def get(self, iid: str) -> Optional[EvaluationInstance]:
        rows = self._query(
            "SELECT * FROM evaluationinstances WHERE id=?", (iid,)
        )
        return self._to_instance(rows[0]) if rows else None

    def get_all(self) -> list[EvaluationInstance]:
        return [
            self._to_instance(r)
            for r in self._query("SELECT * FROM evaluationinstances")
        ]

    def get_completed(self) -> list[EvaluationInstance]:
        rows = self._query(
            "SELECT * FROM evaluationinstances "
            "WHERE status='EVALCOMPLETED' ORDER BY startTime DESC"
        )
        return [self._to_instance(r) for r in rows]

    def update(self, i: EvaluationInstance) -> bool:
        if self.get(i.id) is None:
            return False
        self.insert(i)
        return True

    def delete(self, iid: str) -> bool:
        return self._exec(
            "DELETE FROM evaluationinstances WHERE id=?", (iid,)
        ).rowcount > 0


class PostgresEngineManifests(_MetaBase, base.EngineManifests):
    TABLE = "enginemanifests"
    DDL = """CREATE TABLE IF NOT EXISTS enginemanifests (
        id TEXT, version TEXT, name TEXT, description TEXT, files TEXT,
        engineFactory TEXT, PRIMARY KEY (id, version))"""

    def insert(self, m: EngineManifest) -> None:
        self._exec(
            "INSERT INTO enginemanifests VALUES (?,?,?,?,?,?) "
            "ON CONFLICT (id, version) DO UPDATE SET name=EXCLUDED.name, "
            "description=EXCLUDED.description, files=EXCLUDED.files, "
            "engineFactory=EXCLUDED.engineFactory",
            (
                m.id, m.version, m.name, m.description,
                json.dumps(list(m.files)), m.engine_factory,
            ),
        )

    @staticmethod
    def _to_manifest(r) -> EngineManifest:
        return EngineManifest(
            id=r[0], version=r[1], name=r[2], description=r[3],
            files=tuple(json.loads(r[4] or "[]")), engine_factory=r[5],
        )

    def get(self, mid: str, version: str) -> Optional[EngineManifest]:
        rows = self._query(
            "SELECT * FROM enginemanifests WHERE id=? AND version=?",
            (mid, version),
        )
        return self._to_manifest(rows[0]) if rows else None

    def get_all(self) -> list[EngineManifest]:
        return [
            self._to_manifest(r)
            for r in self._query("SELECT * FROM enginemanifests")
        ]

    def update(self, m: EngineManifest, upsert: bool = False) -> None:
        if not upsert and self.get(m.id, m.version) is None:
            raise StorageError(f"manifest {m.id} {m.version} not found")
        self.insert(m)

    def delete(self, mid: str, version: str) -> None:
        self._exec(
            "DELETE FROM enginemanifests WHERE id=? AND version=?",
            (mid, version),
        )


class PostgresModels(_MetaBase, base.Models):
    TABLE = "models"
    DDL = "CREATE TABLE IF NOT EXISTS models (id TEXT PRIMARY KEY, models BYTEA)"

    def insert(self, m: Model) -> None:
        self._exec(
            "INSERT INTO models VALUES (?,?) "
            "ON CONFLICT (id) DO UPDATE SET models=EXCLUDED.models",
            (m.id, m.models),
        )

    def get(self, mid: str) -> Optional[Model]:
        rows = self._query("SELECT id, models FROM models WHERE id=?", (mid,))
        return Model(rows[0][0], bytes(rows[0][1])) if rows else None

    def delete(self, mid: str) -> None:
        self._exec("DELETE FROM models WHERE id=?", (mid,))
