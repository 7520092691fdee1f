"""Client-server storage backend: the client half.

Configure with

  PIO_STORAGE_SOURCES_<NAME>_TYPE=remote
  PIO_STORAGE_SOURCES_<NAME>_HOST=<storage daemon host>
  PIO_STORAGE_SOURCES_<NAME>_PORT=<port>
  PIO_STORAGE_SOURCES_<NAME>_AUTH_KEY=<optional shared secret>

and any repository (METADATA, EVENTDATA, MODELDATA) may name it.
Counterpart of the JAX package's ``data/storage/remote.py``, with its
wire format (``wire.py``), request ids and headers, so that either
package's client talks to the other's daemon
(``data/api/storage_server.py``). It takes the reference's JDBC client
role (jdbc/JDBCLEvents.scala:34, JDBCPEvents.scala:29 and the JDBC
metadata DAOs): the Event Server, train, the deploy server and the
operator servers, each in its own process, share one app through the
daemon.

Transport: keep-alive HTTP connections of the standard library, one per
thread; ``ping`` takes a connection of its own. Every call is a
``storage.rpc`` span (``X-Request-ID`` and ``X-Parent-Span`` to the
daemon, whose server span parents under it) and the ``storage.rpc``
fault point (``corrupt`` garbles the answer). The events client also
reads a follower daemon's replica state (``replication_status``,
``replication_lag``, ``wait_for_revision``) through the ``replication``
DAO. Left out: the JAX package's lock-sanitizer hook on the blocking
call (``analysis/tsan.py``), which the port does not have. Standard
library only.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
import uuid
from typing import Any, Iterator, Optional, Sequence

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base, wire
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    EventQuery,
    Model,
    StorageCircuitOpenError,
    StorageError,
    StorageUnreachableError,
)
from predictionio_tpu_torch.obs import spans as _spans
from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.resilience import deadline as _deadline
from predictionio_tpu_torch.resilience import faults as _faults
from predictionio_tpu_torch.resilience.breaker import get_breaker
from predictionio_tpu_torch.resilience.retry import RetryPolicy
from predictionio_tpu_torch.utils.env import REMOTE_SOURCE_KEYS, storage_knob

# the transport failures a call retries and the breaker counts
_TRANSIENT = (http.client.HTTPException, OSError, _faults.FaultInjected)


def _setting(config: dict[str, str], key: str) -> str:
    return config.get(key) or REMOTE_SOURCE_KEYS[key]


class RemoteClient:
    """A thread-safe RPC client with one keep-alive connection a thread.

    Each call retries with exponential backoff and jitter, within the
    caller's propagated deadline when one is set, behind a breaker per
    DAO of the endpoint, shared by the process. While a breaker is open
    its DAO's calls fail fast with StorageCircuitOpenError (no socket
    touched); after the cooldown one probe call decides. Knobs, per
    source setting or environment: RETRY_ATTEMPTS /
    PIO_STORAGE_RETRY_ATTEMPTS, RETRY_BASE_DELAY /
    PIO_STORAGE_RETRY_BASE_DELAY, BREAKER_THRESHOLD /
    PIO_BREAKER_THRESHOLD, BREAKER_COOLDOWN / PIO_BREAKER_COOLDOWN (s).
    """

    def __init__(self, config: dict[str, str]):
        self.host = _setting(config, "HOST")
        self.port = int(_setting(config, "PORT"))
        self.auth_key = config.get("AUTH_KEY") or None
        self.timeout = float(_setting(config, "TIMEOUT"))
        self._local = threading.local()
        self.retry = RetryPolicy(
            max_attempts=int(config.get("RETRY_ATTEMPTS")
                             or storage_knob("PIO_STORAGE_RETRY_ATTEMPTS")),
            base_delay=float(config.get("RETRY_BASE_DELAY")
                             or storage_knob("PIO_STORAGE_RETRY_BASE_DELAY")),
        )
        # one breaker a DAO: an outage of the events path must not fail
        # the metadata path of the same daemon fast
        self._breaker_kwargs = dict(
            failure_threshold=int(config.get("BREAKER_THRESHOLD")
                                  or storage_knob("PIO_BREAKER_THRESHOLD")),
            cooldown_s=float(config.get("BREAKER_COOLDOWN")
                             or storage_knob("PIO_BREAKER_COOLDOWN")),
        )
        self._dao_breakers: dict = {}

    def breaker_for(self, dao: str):
        """The process breaker of one DAO of this endpoint, memoized here
        so that a call skips the process registry's lock (a racing first
        call resolves the same breaker twice)."""
        breaker = self._dao_breakers.get(dao)
        if breaker is None:
            breaker = self._dao_breakers[dao] = get_breaker(
                f"storage:{self.host}:{self.port}/{dao}", dao=dao, **self._breaker_kwargs)
        return breaker

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
            conn.connect()
            # the headers and the body are separate writes: with Nagle on,
            # the body waits for the daemon's delayed ACK on every call
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.conn = conn
        return conn

    def _drop_conn(self, conn) -> None:
        conn.close()
        self._local.conn = None

    def call(self, dao: str, method: str, *args: Any,
             _req_id: Optional[str] = None, **kwargs: Any) -> Any:
        req: dict[str, Any] = {
            "dao": dao,
            "method": method,
            "args": [wire.encode(a) for a in args],
            "kwargs": {k: wire.encode(v) for k, v in kwargs.items()},
        }
        # every write carries a request id, which the daemon dedupes on: a
        # retry after a lost response replays the recorded outcome instead
        # of applying the write again (no duplicate row; a re-run delete
        # does not see its own first run). The WAL replayer passes its own
        # id, so that a re-send after a restart dedupes too.
        if _req_id is not None:
            req["req_id"] = _req_id
        elif not method.startswith(("get", "find")):
            req["req_id"] = uuid.uuid4().hex
        body = json.dumps(req, separators=(",", ":")).encode()
        headers = {"Content-Type": "application/json"}
        if self.auth_key:
            headers["X-PIO-Storage-Key"] = self.auth_key
        breaker = self.breaker_for(dao)
        with _spans.get_default_recorder().span(
            "storage.rpc", dao=dao, method=method,
            server=f"storage-client:{self.host}:{self.port}",
        ) as sp:
            # the span set the trace id when none was current: the daemon
            # logs it as its request id and parents its span under this one
            headers["X-Request-ID"] = _tracing.current_trace_id()
            headers["X-Parent-Span"] = sp.span_id
            if not breaker.allow():
                sp.attrs["breaker_state"] = breaker.state
                raise StorageCircuitOpenError(
                    f"storage server {self.host}:{self.port}: circuit breaker open "
                    f"for the {dao} DAO (failing fast)")
            # allow() may have taken the half-open probe slot: every way out
            # records a verdict or releases the slot
            verdict_recorded = False
            try:
                rem = _deadline.remaining()
                if rem is not None:
                    if rem <= 0:
                        raise _deadline.DeadlineExceeded(
                            f"storage rpc {dao}.{method}: deadline expired before dispatch")
                    headers[_deadline.HEADER] = str(max(0, int(rem * 1000)))
                budget = time.monotonic() + min(self.timeout, rem) if rem is not None else None

                def _attempt(_i: int) -> Any:
                    action = _faults.fire("storage.rpc", corruptable=True)
                    conn = self._conn()
                    try:
                        conn.request("POST", "/rpc", body=body, headers=headers)
                        payload = json.loads(conn.getresponse().read())
                    except (http.client.HTTPException, OSError):
                        # a dead or idle-closed socket, or a lost response:
                        # the request id makes the retry safe either way
                        self._drop_conn(conn)
                        raise
                    if action == "corrupt":
                        raise StorageError(f"storage rpc {dao}.{method} failed: "
                                           "fault-injected corrupt response")
                    return payload

                def _on_retry(i: int, _e: BaseException) -> None:
                    sp.attrs["retried"] = True
                    sp.attrs["retries"] = i + 1

                try:
                    payload = self.retry.call(_attempt, retry_on=_TRANSIENT,
                                              deadline=budget, on_retry=_on_retry)
                except _TRANSIENT as e:
                    breaker.record_failure()
                    verdict_recorded = True
                    sp.attrs["breaker_state"] = breaker.state
                    raise StorageUnreachableError(
                        f"storage server {self.host}:{self.port} unreachable: {e}") from e
                # the endpoint answered: health, even if the answer is an
                # error of the application
                breaker.record_success()
                verdict_recorded = True
            finally:
                if not verdict_recorded:
                    # aborted without a word from the endpoint (deadline,
                    # injected corruption, a garbled answer)
                    breaker.release_probe()
            if not payload.get("ok"):
                if payload.get("shed"):
                    # the daemon refused the call because the caller's
                    # deadline expired in transit
                    raise _deadline.DeadlineExceeded(
                        f"storage rpc {dao}.{method}: {payload.get('error')}")
                raise StorageError(f"storage rpc {dao}.{method} failed: {payload.get('error')}")
            return wire.decode(payload.get("result"))

    def ping(self) -> bool:
        """Liveness on a short-lived connection of its own (probing through
        the pooled one can poison it for the next call when the peer is
        half dead), with a 2 s timeout; true only for a daemon's
        ``{"status": "alive"}``."""
        conn = http.client.HTTPConnection(self.host, self.port, timeout=2)
        try:
            conn.request("GET", "/health")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return False
            health = json.loads(body)
            return isinstance(health, dict) and health.get("status") == "alive"
        except (http.client.HTTPException, OSError, ValueError):
            return False
        finally:
            conn.close()


def CLIENT_FACTORY(config: dict[str, str]) -> RemoteClient:
    """The registry's one client a remote source."""
    return RemoteClient(config)


class _RemoteDao:
    DAO = ""

    def __init__(self, config: dict[str, str], client: Optional[RemoteClient] = None):
        self._client = client or RemoteClient(config)

    def _call(self, method: str, *args: Any, **kwargs: Any) -> Any:
        return self._client.call(self.DAO, method, *args, **kwargs)


class RemoteEventStore(_RemoteDao, base.EventStore):
    DAO = "events"

    # the daemon pages a find: a training read never becomes one JSON body
    # on either side (the reference's DAOs stream for the same reason)
    FIND_PAGE = 10_000

    # a write waits on the network with the interpreter lock released, so
    # a sharded store fans its per-shard writes out to its pool
    IO_PARALLEL_WRITES = True

    def init_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        return self._call("init_app", app_id, channel_id)

    def remove_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        return self._call("remove_app", app_id, channel_id)

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self._call("insert", event, app_id, channel_id)

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list[str]:
        return self._call("insert_batch", list(events), app_id, channel_id)

    def insert_with_req_id(self, event: Event, app_id: int, channel_id: Optional[int],
                           req_id: str) -> str:
        """Insert under the caller's request id: the WAL replayer's
        re-sends, across restarts too, replay the daemon's recorded
        outcome instead of adding a row."""
        return self._client.call(self.DAO, "insert", event, app_id, channel_id,
                                 _req_id=req_id)

    def insert_batch_with_req_id(self, events: Sequence[Event], app_id: int,
                                 channel_id: Optional[int], req_id: str) -> list[str]:
        """A bulk insert under one request id of the caller's: the WAL's
        batched replay, one RPC a chunk, exactly once."""
        return self._client.call(self.DAO, "insert_batch", list(events), app_id,
                                 channel_id, _req_id=req_id)

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        return self._call("get", event_id, app_id, channel_id)

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        return self._call("delete", event_id, app_id, channel_id)

    def delete_batch(self, event_ids: Sequence[str], app_id: int,
                     channel_id: Optional[int] = None) -> int:
        return self._call("delete_batch", list(event_ids), app_id, channel_id)

    def latest_revision(self, app_id: int, channel_id: Optional[int] = None) -> int:
        return self._call("latest_revision", app_id, channel_id)

    def find_since(self, app_id: int, after_revision: int, channel_id: Optional[int] = None,
                   limit: Optional[int] = None,
                   shard: Optional[tuple[int, int]] = None) -> list[Event]:
        """The revision tail, read by the daemon's store (sqlite's indexed
        range read, filtered to partition `shard` there when one is
        given); only the page crosses the wire."""
        return self._call("find_since", app_id, after_revision, channel_id=channel_id,
                          limit=limit, shard=list(shard) if shard is not None else None)

    def data_signature(self, app_id: int, channel_id: Optional[int] = None) -> str:
        return self._call("data_signature", app_id, channel_id)

    # -- a follower daemon's replica state --------------------------------
    def replication_status(self) -> dict:
        return self._client.call("replication", "replication_status")

    def replication_lag(self, app_id: int, channel_id: Optional[int] = None) -> dict:
        return self._client.call("replication", "replication_lag", app_id, channel_id)

    def wait_for_revision(self, app_id: int, revision: int, timeout_s: float = 5.0,
                          channel_id: Optional[int] = None) -> bool:
        """Read-your-writes against a follower daemon: wait (on the
        daemon) until its watermark reaches `revision`."""
        return self._client.call("replication", "wait_for_revision", app_id, revision,
                                 timeout_s, channel_id)

    def find_entities_batch(self, app_id: int, entity_type: str, entity_ids: Sequence[str],
                            event_names: Optional[Sequence[str]] = None,
                            limit_per_entity: Optional[int] = None,
                            channel_id: Optional[int] = None,
                            reversed: bool = True) -> dict[str, list[Event]]:
        """One RPC for the whole batch of entities: the daemon runs its
        store's bulk read."""
        return self._call(
            "find_entities_batch", app_id, entity_type, list(entity_ids),
            channel_id=channel_id,
            event_names=list(event_names) if event_names is not None else None,
            limit_per_entity=limit_per_entity, reversed=reversed)

    def find(self, query: EventQuery) -> Iterator[Event]:
        """Pages from the daemon, continued by keyset: the client sends
        back the last (event_time, event_id) it saw, which the daemon
        pushes into its store's query as ``EventQuery.start_after``. A
        page costs O(page) on the daemon (sqlite makes the cursor an
        indexed range clause) and the pages stay exact under concurrent
        writes, in both scan directions."""

        def _pages() -> Iterator[Event]:
            yielded = 0
            cursor: Optional[tuple] = None
            while True:
                want = self.FIND_PAGE
                if query.limit is not None and query.limit >= 0:
                    want = min(want, query.limit - yielded)
                    if want <= 0:
                        return
                kw: dict[str, Any] = {"_page": want}
                if cursor is not None:
                    kw["_after"] = {"t": cursor[0], "id": cursor[1]}
                page = self._call("find", query, **kw)
                events = page["events"]
                yield from events
                yielded += len(events)
                if not page["more"]:
                    return
                last = events[-1]
                cursor = (last.event_time, last.event_id or "")

        return _pages()


class RemoteApps(_RemoteDao, base.Apps):
    DAO = "apps"

    def insert(self, app: App) -> Optional[int]:
        return self._call("insert", app)

    def get(self, app_id: int) -> Optional[App]:
        return self._call("get", app_id)

    def get_by_name(self, name: str) -> Optional[App]:
        return self._call("get_by_name", name)

    def get_all(self) -> list[App]:
        return self._call("get_all")

    def update(self, app: App) -> bool:
        return self._call("update", app)

    def delete(self, app_id: int) -> bool:
        return self._call("delete", app_id)


class RemoteAccessKeys(_RemoteDao, base.AccessKeys):
    DAO = "access_keys"

    def insert(self, k: AccessKey) -> Optional[str]:
        return self._call("insert", k)

    def get(self, key: str) -> Optional[AccessKey]:
        return self._call("get", key)

    def get_all(self) -> list[AccessKey]:
        return self._call("get_all")

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return self._call("get_by_app_id", app_id)

    def update(self, k: AccessKey) -> bool:
        return self._call("update", k)

    def delete(self, key: str) -> bool:
        return self._call("delete", key)


class RemoteChannels(_RemoteDao, base.Channels):
    DAO = "channels"

    def insert(self, c: Channel) -> Optional[int]:
        return self._call("insert", c)

    def get(self, channel_id: int) -> Optional[Channel]:
        return self._call("get", channel_id)

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return self._call("get_by_app_id", app_id)

    def delete(self, channel_id: int) -> bool:
        return self._call("delete", channel_id)


class RemoteEngineInstances(_RemoteDao, base.EngineInstances):
    DAO = "engine_instances"

    def insert(self, i: EngineInstance) -> str:
        return self._call("insert", i)

    def get(self, iid: str) -> Optional[EngineInstance]:
        return self._call("get", iid)

    def get_all(self) -> list[EngineInstance]:
        return self._call("get_all")

    def get_latest_completed(self, engine_id: str, engine_version: str,
                             engine_variant: str) -> Optional[EngineInstance]:
        return self._call("get_latest_completed", engine_id, engine_version, engine_variant)

    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> list[EngineInstance]:
        return self._call("get_completed", engine_id, engine_version, engine_variant)

    def update(self, i: EngineInstance) -> bool:
        return self._call("update", i)


class RemoteEvaluationInstances(_RemoteDao, base.EvaluationInstances):
    DAO = "evaluation_instances"

    def insert(self, i: EvaluationInstance) -> str:
        return self._call("insert", i)

    def get(self, iid: str) -> Optional[EvaluationInstance]:
        return self._call("get", iid)

    def get_all(self) -> list[EvaluationInstance]:
        return self._call("get_all")

    def get_completed(self) -> list[EvaluationInstance]:
        return self._call("get_completed")

    def update(self, i: EvaluationInstance) -> bool:
        return self._call("update", i)


class RemoteEngineManifests(_RemoteDao, base.EngineManifests):
    DAO = "engine_manifests"

    def insert(self, m: EngineManifest) -> None:
        self._call("insert", m)

    def get(self, mid: str, version: str) -> Optional[EngineManifest]:
        return self._call("get", mid, version)

    def get_all(self) -> list[EngineManifest]:
        return self._call("get_all")

    def update(self, m: EngineManifest, upsert: bool = False) -> None:
        self._call("update", m, upsert)

    def delete(self, mid: str, version: str) -> None:
        self._call("delete", mid, version)


class RemoteModels(_RemoteDao, base.Models):
    DAO = "models"

    def insert(self, m: Model) -> None:
        self._call("insert", m)

    def get(self, mid: str) -> Optional[Model]:
        return self._call("get", mid)

    def delete(self, mid: str) -> None:
        self._call("delete", mid)
