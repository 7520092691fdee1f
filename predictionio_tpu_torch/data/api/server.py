"""Event Server: the threaded HTTP ingestion endpoint (default port 7070).

Counterpart of the JAX package's ``data/api/server.py`` (reference
data/.../api/EventServer.scala:52-640). Routes:

  GET    /                       → {"status": "alive"}
  POST   /events.json            → 201 {"eventId"} (auth, whitelist, blockers)
  GET    /events.json            → events by time, entity, event and target
                                   filters; limit 20 unless given, -1 all
  GET    /events/<id>.json       → one event
  DELETE /events/<id>.json       → delete it
  POST   /batch/events.json      → at most 50 events, per-event statuses
  GET    /stats.json             → hourly counts (with stats on)
  POST   /segments/seal          → {"sealedRows"}: seal the key's tail now
  POST   /segments/compact       → {"segmentsMerged"}: merge small segments
  GET    /segments/stats         → the segment store's shape (404 on a store
                                   without segments, 503 when it fails)
  POST/GET /webhooks/<name>.json → JSON connectors
  POST/GET /webhooks/<name>.form → form connectors
  GET    /metrics                → Prometheus text (requests, events)
  GET    /debug/traces           → retained request traces (?fleet=1:
                                   the process's fleet trace collector)
  GET    /debug/tsdb             → the process monitor's time-series history
  GET    /alerts                 → the process monitor's alert states (the
                                   JAX Event Server leaves this route out;
                                   the port mounts it as its other servers do)
  GET    /debug/profile          → the device profile (empty here)
  GET/POST /debug/faults         → the fault specs; POST installs or clears
                                   them (403 without PIO_FAULTS_ADMIN=1)

Auth (reference withAccessKey, EventServer.scala:90-128): the
``accessKey`` query parameter or the HTTP Basic user name; the
``channel`` parameter names one of the key's app's channels. A missing
or unknown key or channel is a 401, an event name the key does not
allow a 403. The server makes no device call. Every request is
counted, traced and access-logged by ``utils/http.py``'s middleware
into the server's registry (``server_registry``, label ``event``),
with ``events_ingested_total``.

An event POST (``/events.json``, ``/batch/events.json``, a webhook) whose
``X-PIO-Deadline`` already expired is shed before auth and storage: 503
with ``Retry-After`` and ``events_shed_total{reason="deadline"}``, except
while the write-ahead log holds spilled events (the POST would land in
it as a 202: one fsync'd append, cheaper than a client's retries).

Storage outages (the JAX server's write-ahead spill): when the store is
unreachable (``StorageUnreachableError``, a remote source's breaker open
or its retries spent) or the ``event.insert`` fault fires before the
write, the admitted event is appended to the ``EventWAL`` under
``wal_dir`` (``PIO_WAL_DIR``) and answered 202 with its ``walId`` and
the ``eventId`` it will be stored under (per event in a batch; the JAX
server answers the walId alone and stores the event under it, so a
write applied before a daemon's crash and then spilled lands twice
there, once here; over a sharded store the id is left to the store,
as the JAX server leaves it); with ``wal_dir`` None it is a 503 and
nothing is stored. The ``event-wal-replay`` thread replays the log in arrival
order once the store answers, batched under stable request ids (each
spilled event lands once), and counts ``event_wal_spilled_total``,
``event_wal_replayed_total`` and the ``event_wal_pending`` gauge. Access
keys and channel lists that were read once are served from a cache
while the store is unreachable, so that auth does not fail before the
spill; a key never seen is a 503. A batch that a sharded store lands
on some shards only (``PartialBatchWriteError``: a home shard down) is
answered by position, 201 with its ``eventId`` where it persisted and
503 "storage shard unavailable" where not, with nothing spilled (the
JAX server's answer). Any other ``/debug/*`` path answers 404 saying
it is not ported; log shipping is not ported. The server's registry is
sampled by the process monitor while it serves (``utils/http.py``).
"""

from __future__ import annotations

import base64
import datetime as _dt
import logging
import threading
from dataclasses import dataclass, field
from typing import Optional
from urllib.parse import parse_qsl, urlsplit

from predictionio_tpu_torch.data.api.plugins import PluginContext
from predictionio_tpu_torch.data.api.stats import Stats
from predictionio_tpu_torch.data.api.webhooks import (
    FORM_CONNECTORS,
    JSON_CONNECTORS,
    ConnectorException,
)
from predictionio_tpu_torch.data.event import (
    Event,
    EventValidation,
    ValidationError,
    new_event_id,
)
from predictionio_tpu_torch.data.storage.base import EventQuery, StorageUnreachableError
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.storage.sharded import PartialBatchWriteError
from predictionio_tpu_torch.obs import server_registry
from predictionio_tpu_torch.resilience import deadline as _deadline
from predictionio_tpu_torch.resilience import faults as _faults
from predictionio_tpu_torch.resilience.wal import EventWAL
from predictionio_tpu_torch.utils.env import storage_knob
from predictionio_tpu_torch.utils.http import (
    HttpError,
    JsonHandler,
    ServerProcess,
    ThreadedServer,
)

log = logging.getLogger(__name__)

MAX_EVENTS_PER_BATCH = 50  # reference EventServer.scala:68

# spilled events a replay RPC carries (the JAX server's replay sends 50):
# a replay competes with live ingest for the store, and its per-call cost
# (a commit, an ack fsync) is what bounds a drain after an outage
REPLAY_CHUNK = 500

# a storage write that fails so spills into the write-ahead log
_SPILLED = (StorageUnreachableError, _faults.FaultInjected)
_SPILL_MESSAGE = "storage unavailable; event accepted for replay"


def _default_wal_dir() -> str:
    return storage_knob("PIO_WAL_DIR")


@dataclass
class EventServerConfig:
    ip: str = "0.0.0.0"
    port: int = 7070
    stats: bool = False
    plugins: list = field(default_factory=list)
    # remote log shipping (reference CreateServer.scala:441-452 --log-url)
    log_url: Optional[str] = None
    # the write-ahead spill's directory; None: an outage is a 503
    wal_dir: Optional[str] = field(default_factory=_default_wal_dir)
    wal_replay_interval_s: float = 0.5


@dataclass
class AuthData:
    """Reference EventServer.scala AuthData: the key's app, the channel
    named by the request, the event names the key allows (empty: all)."""

    app_id: int
    channel_id: Optional[int]
    events: tuple[str, ...]


def _parse_iso(s: str) -> _dt.datetime:
    t = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
    return t if t.tzinfo else t.replace(tzinfo=_dt.timezone.utc)


class _Handler(JsonHandler):
    server: "_Server"

    # -- auth (reference EventServer.scala:90-128) -------------------------
    def _auth(self, query: dict[str, str]) -> AuthData:
        key = query.get("accessKey")
        if not key:
            header = self.headers.get("Authorization", "")
            if header.startswith("Basic "):
                try:
                    key = base64.b64decode(header[6:]).decode().split(":", 1)[0]
                except ValueError:
                    key = None
        if not key:
            raise HttpError(401, "Missing accessKey.")
        access_key = self.server.lookup_access_key(key)
        if access_key is None:
            raise HttpError(401, "Invalid accessKey.")
        channel_id: Optional[int] = None
        channel = query.get("channel")
        if channel:
            match = [c for c in self.server.lookup_channels(access_key.app_id)
                     if c.name == channel]
            if not match:
                raise HttpError(401, "Invalid channel.")
            channel_id = match[0].id
        return AuthData(access_key.app_id, channel_id, tuple(access_key.events))

    # -- the insert path ---------------------------------------------------
    def _admit_event(self, auth: AuthData, obj: dict) -> Event:
        """Validation, the key's whitelist and the input blockers:
        everything before the store, shared by the single and batch
        paths. An event the client sent without an id gets one here, so
        that a write the store applied but could not acknowledge (the
        daemon killed mid-call) and then spilled lands on the same row
        when replayed: the JAX server leaves the id to the store and
        the spill, and stores such an event twice. Over a store that
        evicts an explicit id from its other shards before the write
        (the sharded store: a broadcast a write, and a down shard
        would fail every batch) the id is left to the store, as the
        JAX server leaves it; such a store answers a shard outage with
        503s and spills nothing, so no write can land twice."""
        try:
            event = Event.from_json_dict(obj)
            EventValidation.validate(event)
        except ValidationError as e:
            raise HttpError(400, str(e))
        if auth.events and event.event not in auth.events:
            raise HttpError(403, f"{event.event!r} events are not allowed")
        try:
            self.server.plugin_context.run_blockers(
                obj, {"appId": auth.app_id, "channelId": auth.channel_id})
        except Exception as e:
            raise HttpError(403, f"event rejected: {e}")
        if event.event_id or getattr(self.server.storage.get_events(),
                                     "EVICTS_EXPLICIT_IDS", False):
            return event
        return event.with_id(new_event_id())

    def _after_insert(self, auth: AuthData, obj: dict, event: Event) -> None:
        self.server.plugin_context.run_sniffers(
            obj, {"appId": auth.app_id, "channelId": auth.channel_id})
        self.server.metrics.counter(
            "events_ingested_total", "events accepted into storage").inc()
        if self.server.stats is not None:
            self.server.stats.update(auth.app_id, 201, event)

    def _insert_event(self, auth: AuthData, obj: dict) -> None:
        """Admit and store one event: 201 with its eventId, or 202 with
        its WAL receipt when the store is unreachable or the
        ``event.insert`` fault fires (accepted means durable: replayed
        in order once the store answers)."""
        event = self._admit_event(auth, obj)
        try:
            _faults.fire("event.insert")
            event_id = self.server.storage.get_events().insert(
                event, auth.app_id, auth.channel_id)
        except _SPILLED as e:
            wal_id = self.server.spill(event, auth.app_id, auth.channel_id, e)
            self._respond(202, {"message": _SPILL_MESSAGE, "walId": wal_id,
                                "eventId": event.event_id})
            return
        self._after_insert(auth, obj, event)
        self._respond(201, {"eventId": event_id})

    def _maybe_shed_ingest(self, method: str, path: str) -> bool:
        """Shed an event POST whose X-PIO-Deadline already expired: 503 +
        Retry-After before auth, validation and storage are touched;
        except while the WAL holds spilled events, when the store is (or
        just was) down and the POST would land in the WAL as a 202."""
        if method != "POST" or not (
            path in ("/events.json", "/batch/events.json")
            or path.startswith("/webhooks/")
        ):
            return False
        if not _deadline.expired():
            return False
        wal = self.server.wal
        if wal is not None and wal.pending():
            return False  # spill mode: never shed what the WAL absorbs
        self.server.metrics.counter(
            "events_shed_total",
            "ingest POSTs refused before storage work, by reason",
            ("reason",),  # label-bound: literal shed-reason set
        ).inc(reason="deadline")
        self._respond(503, {"message": "deadline expired; event shed"},
                      headers={"Retry-After": "1"})
        return True

    # -- routes ------------------------------------------------------------
    def _route(self, method: str) -> None:
        self._drain_body()  # every path, so that keep-alive stays in step
        url = urlsplit(self.path)
        query = dict(parse_qsl(url.query))
        path = url.path.rstrip("/") or "/"
        if self._maybe_shed_ingest(method, path):
            return
        try:
            if path == "/" and method == "GET":
                self._respond(200, {"status": "alive"})
            elif path == "/events.json":
                auth = self._auth(query)
                if method == "POST":
                    obj = self._json_body()
                    if not isinstance(obj, dict):
                        raise HttpError(400, "event JSON must be an object")
                    self._insert_event(auth, obj)
                elif method == "GET":
                    self._get_events(auth, query)
                else:
                    raise HttpError(405, "method not allowed")
            elif path.startswith("/events/") and path.endswith(".json"):
                auth = self._auth(query)
                event_id = path[len("/events/"):-len(".json")]
                if method == "GET":
                    self._get_event(auth, event_id)
                elif method == "DELETE":
                    self._delete_event(auth, event_id)
                else:
                    raise HttpError(405, "method not allowed")
            elif path == "/batch/events.json" and method == "POST":
                self._post_batch(self._auth(query))
            elif path == "/stats.json" and method == "GET":
                auth = self._auth(query)
                if self.server.stats is None:
                    raise HttpError(404, "To see stats, launch Event Server with --stats")
                self._respond(200, self.server.stats.get(auth.app_id))
            elif path.startswith("/webhooks/"):
                self._webhooks(method, path, query)
            elif path == "/metrics" and method == "GET":
                self._serve_metrics()
            elif path == "/debug/traces" and method == "GET":
                self._serve_debug_traces()
            elif path == "/debug/tsdb" and method == "GET":
                self._serve_debug_tsdb()
            elif path == "/alerts" and method == "GET":
                self._serve_alerts()
            elif path == "/debug/profile" and method == "GET":
                self._serve_debug_profile()
            elif path == "/debug/faults" and method == "GET":
                self._serve_debug_faults()
            elif path == "/debug/faults" and method == "POST":
                self._serve_debug_faults_set()
            elif path == "/segments/seal" and method == "POST":
                self._segments_op("seal", self._auth(query))
            elif path == "/segments/compact" and method == "POST":
                self._segments_op("compact", self._auth(query))
            elif path == "/segments/stats" and method == "GET":
                self._segments_stats(self._auth(query))
            elif path.startswith("/debug/"):
                raise HttpError(404, f"{path} is not ported yet to the PyTorch port")
            else:
                raise HttpError(404, "Not Found")
        except HttpError as e:
            self._respond(e.status, {"message": e.message})
        except Exception:
            log.exception("internal error on %s %s", method, self.path)
            self._respond(500, {"message": "internal server error"})

    def _segments_store(self):
        """The segment store behind this server, or a 404: the surface
        exists only over segmentfs events."""
        events = self.server.storage.get_events()
        if not hasattr(events, "segment_stats"):
            raise HttpError(404, "event store backend has no segment surface (these "
                                 "endpoints need source type 'segmentfs')")
        return events

    def _segments_op(self, op: str, auth: AuthData) -> None:
        """POST /segments/seal|compact: seal the key's app and channel's
        tail now, or merge its small adjacent segments (the sealer runs on
        its own cadence); 200 {"sealedRows"} or {"segmentsMerged"}, 503
        when the operation fails."""
        events = self._segments_store()
        try:
            n = getattr(events, op)(auth.app_id, auth.channel_id)
        except Exception as e:  # noqa: BLE001 — answered as a 503
            raise HttpError(503, f"{op} failed: {e}")
        self._respond(200, {"sealedRows" if op == "seal" else "segmentsMerged": int(n)})

    def _segments_stats(self, auth: AuthData) -> None:
        """GET /segments/stats: the store's `segment_stats` for the key's
        app and channel (`console status --event-url` prints it)."""
        events = self._segments_store()
        try:
            st = events.segment_stats(auth.app_id, auth.channel_id)
        except Exception as e:  # noqa: BLE001 — answered as a 503
            raise HttpError(503, f"segment stats failed: {e}")
        self._respond(200, st)

    def _post_batch(self, auth: AuthData) -> None:
        """Per-event statuses in a 200 after one `insert_batch` of the
        admitted events (202 with a walId each when the batch spills; 201
        or 503 by position when a sharded store's batch is partial); a
        batch over MAX_EVENTS_PER_BATCH is a 400 for the whole (reference
        EventServer.scala:374-440)."""
        objs = self._json_body()
        if not isinstance(objs, list):
            raise HttpError(400, "batch events must be a JSON array")
        if len(objs) > MAX_EVENTS_PER_BATCH:
            raise HttpError(400, "Batch request must have less than or equal to "
                                 f"{MAX_EVENTS_PER_BATCH} events")
        results: list = [None] * len(objs)
        admitted: list[tuple[int, dict, Event]] = []
        for pos, obj in enumerate(objs):
            try:
                if not isinstance(obj, dict):
                    raise HttpError(400, "event JSON must be an object")
                admitted.append((pos, obj, self._admit_event(auth, obj)))
            except HttpError as e:
                results[pos] = {"status": e.status, "message": e.message}
        if admitted:
            try:
                _faults.fire("event.insert")
                ids = self.server.storage.get_events().insert_batch(
                    [e for _, _, e in admitted], auth.app_id, auth.channel_id)
            except PartialBatchWriteError as e:
                # a sharded store with a home shard down: a 201 for each
                # event that persisted and a 503 for the others, nothing
                # spilled (a blanket answer would invite a retry of the
                # whole batch, which duplicates the persisted events)
                for (pos, obj, event), eid in zip(admitted, e.ids):
                    if eid is None:
                        results[pos] = {"status": 503,
                                        "message": "storage shard unavailable"}
                    else:
                        results[pos] = {"status": 201, "eventId": eid}
                        self._after_insert(auth, obj, event)
            except _SPILLED as e:
                # a whole outage: every admitted event into the WAL under one
                # fsync, a 202 each (accepted and durable, not failed)
                try:
                    wal_ids = self.server.spill_batch(
                        [ev for _, _, ev in admitted], auth.app_id, auth.channel_id, e)
                    for (pos, _, event), wal_id in zip(admitted, wal_ids):
                        results[pos] = {"status": 202, "message": _SPILL_MESSAGE,
                                        "walId": wal_id, "eventId": event.event_id}
                except HttpError as he:
                    for pos, _, _ in admitted:
                        results[pos] = {"status": he.status, "message": he.message}
            except Exception as e:
                for pos, _, _ in admitted:
                    results[pos] = {"status": 503, "message": str(e)}
            else:
                for (pos, obj, event), eid in zip(admitted, ids):
                    results[pos] = {"status": 201, "eventId": eid}
                    self._after_insert(auth, obj, event)
        self._respond(200, results)

    def _get_event(self, auth: AuthData, event_id: str) -> None:
        event = self.server.storage.get_events().get(
            event_id, auth.app_id, auth.channel_id)
        if event is None:
            raise HttpError(404, "Not Found")
        self._respond(200, event.to_json_dict())

    def _delete_event(self, auth: AuthData, event_id: str) -> None:
        if not self.server.storage.get_events().delete(
                event_id, auth.app_id, auth.channel_id):
            raise HttpError(404, "Not Found")
        self._respond(200, {"message": "Found"})

    def _get_events(self, auth: AuthData, query: dict[str, str]) -> None:
        """Reference GET /events.json filters (EventServer.scala:300-372):
        20 events unless `limit` says otherwise (negative: all), 404 when
        none matches."""
        try:
            limit = int(query.get("limit", 20))
            q = EventQuery(
                app_id=auth.app_id,
                channel_id=auth.channel_id,
                start_time=(_parse_iso(query["startTime"])
                            if "startTime" in query else None),
                until_time=(_parse_iso(query["untilTime"])
                            if "untilTime" in query else None),
                entity_type=query.get("entityType"),
                entity_id=query.get("entityId"),
                event_names=[query["event"]] if "event" in query else None,
                target_entity_type=query.get("targetEntityType"),
                target_entity_id=query.get("targetEntityId"),
                limit=None if limit < 0 else limit,
                reversed=query.get("reversed") == "true",
            )
        except (ValueError, KeyError) as e:
            raise HttpError(400, f"invalid query parameter: {e}")
        events = [e.to_json_dict() for e in self.server.storage.get_events().find(q)]
        if not events:
            raise HttpError(404, "Not Found")
        self._respond(200, events)

    def _webhooks(self, method: str, path: str, query: dict[str, str]) -> None:
        """Reference api/Webhooks.scala:37-77: GET checks that the
        connector exists, POST stores the event it makes."""
        rest = path[len("/webhooks/"):]
        if rest.endswith(".json"):
            name, form = rest[:-len(".json")], False
        elif rest.endswith(".form"):
            name, form = rest[:-len(".form")], True
        else:
            raise HttpError(404, "Not Found")
        auth = self._auth(query)
        connector = (FORM_CONNECTORS if form else JSON_CONNECTORS).get(name)
        if method not in ("GET", "POST"):
            raise HttpError(405, "method not allowed")
        if connector is None:
            raise HttpError(404, f"webhook connection for {name} is not supported")
        if method == "GET":
            self._respond(200, {})
            return
        try:
            if form:
                event_json = connector.to_event_json_from_form(
                    dict(parse_qsl(self._raw_body.decode(), keep_blank_values=True)))
            else:
                payload = self._json_body()
                if not isinstance(payload, dict):
                    raise HttpError(400, "webhook payload must be a JSON object")
                event_json = connector.to_event_json(payload)
        except (ConnectorException, KeyError) as e:
            raise HttpError(400, str(e))
        self._insert_event(auth, {k: v for k, v in event_json.items() if v is not None})

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")


class _Server(ThreadedServer):
    def __init__(self, addr, storage: Storage, config: EventServerConfig):
        super().__init__(addr, _Handler)
        self.storage = storage
        self.stats = Stats() if config.stats else None
        self.plugin_context = PluginContext(config.plugins)
        self.metrics = server_registry()
        self.metrics_label = "event"
        # the stale-credential cache: keys and channel lists read once are
        # served while the store is unreachable (refreshed on every good
        # read); a key never seen stays a 503, since granting it unchecked
        # would bypass auth
        self._auth_cache_lock = threading.Lock()
        self._key_cache: dict = {}  # access key → AccessKey row
        self._channel_cache: dict[int, list] = {}  # app id → [Channel]
        self.wal: Optional[EventWAL] = EventWAL(config.wal_dir) if config.wal_dir else None
        if self.wal is not None:
            wal = self.wal
            self.metrics.gauge_callback(
                "event_wal_pending", "events spilled to the WAL and not yet replayed",
                lambda: float(wal.pending()))

    def lookup_access_key(self, key: str):
        """The key's row, through the stale-credential cache."""
        try:
            ak = self.storage.get_meta_data_access_keys().get(key)
        except _SPILLED as e:
            with self._auth_cache_lock:
                cached = self._key_cache.get(key)
            if cached is not None:
                return cached
            raise HttpError(503, f"storage unavailable, cannot authenticate: {e}")
        with self._auth_cache_lock:
            if ak is not None:
                self._key_cache[key] = ak
            else:
                self._key_cache.pop(key, None)  # a revocation wins
        return ak

    def lookup_channels(self, app_id: int) -> list:
        try:
            channels = self.storage.get_meta_data_channels().get_by_app_id(app_id)
        except _SPILLED as e:
            with self._auth_cache_lock:
                cached = self._channel_cache.get(app_id)
            if cached is not None:
                return cached
            raise HttpError(503, f"storage unavailable, cannot resolve channel: {e}")
        with self._auth_cache_lock:
            self._channel_cache[app_id] = channels
        return channels

    def spill(self, event: Event, app_id: int, channel_id: Optional[int],
              cause: Exception) -> str:
        """Spill one accepted event durably; returns its WAL receipt. A
        503 when spilling is off: an outage is then a loud one."""
        return self.spill_batch([event], app_id, channel_id, cause)[0]

    def spill_batch(self, events: list, app_id: int, channel_id: Optional[int],
                    cause: Exception) -> list[str]:
        """Spill a batch's accepted events durably, in order, under one
        fsync; their WAL receipts."""
        if self.wal is None:
            raise HttpError(503, f"storage unavailable: {cause}")
        wal_ids = self.wal.append_batch(events, app_id, channel_id)
        self.metrics.counter(
            "event_wal_spilled_total",
            "events spilled to the local WAL during storage outages").inc(len(wal_ids))
        log.warning("storage unreachable (%s); %d event(s) spilled to WAL as %s%s", cause,
                    len(wal_ids), wal_ids[0], " ..." if len(wal_ids) > 1 else "")
        return wal_ids


class EventServer(ServerProcess):
    """Start and stop the ingestion server (reference EventServerActor
    and Run, EventServer.scala:580-640); port 0 binds a free port. With a
    WAL, the ``event-wal-replay`` thread replays the spill every
    `wal_replay_interval_s` once the store answers."""

    _name = "event-server"

    def __init__(self, storage: Optional[Storage] = None,
                 config: Optional[EventServerConfig] = None):
        super().__init__()
        self.storage = storage or Storage()
        self.config = config or EventServerConfig()
        self._replay_stop: Optional[threading.Event] = None
        self._replay_thread: Optional[threading.Thread] = None

    def _make_server(self) -> _Server:
        return _Server((self.config.ip, self.config.port), self.storage, self.config)

    def start(self) -> int:
        port = super().start()
        if self._server is not None and self._server.wal is not None:
            self._replay_stop = threading.Event()
            self._replay_thread = threading.Thread(
                target=self._replay_loop, name="event-wal-replay", daemon=True)
            self._replay_thread.start()
        return port

    def stop(self) -> None:
        if self._replay_stop is not None:
            self._replay_stop.set()
            if self._replay_thread is not None:
                self._replay_thread.join(timeout=5)
            self._replay_stop = None
            self._replay_thread = None
        server = self._server
        super().stop()
        if server is not None and server.wal is not None:
            server.wal.close()

    def _replay_loop(self) -> None:
        stop = self._replay_stop
        while not stop.wait(self.config.wal_replay_interval_s):
            try:
                self.replay_wal_once()
            except Exception:
                log.exception("WAL replay pass failed; will retry")

    def replay_wal_once(self) -> int:
        """One ordered replay pass; returns the events that landed.
        Consecutive spills of one namespace land as bulk writes of up to
        REPLAY_CHUNK events: a remote store dedupes each on its stable
        request id, a sharded one each shard's group on an id derived
        from it, an embedded one overwrites by the event ids."""
        server = self._server
        if server is None or server.wal is None or not server.wal.pending():
            return 0
        store = self.storage.get_events()
        with_req_id = getattr(store, "insert_batch_with_req_id", None)

        def _insert_batch(events, app_id, channel_id, batch_req_id):
            if with_req_id is not None:
                with_req_id(events, app_id, channel_id, batch_req_id)
            else:
                store.insert_batch(events, app_id, channel_id)

        replayed, err = server.wal.replay_batched(_insert_batch, max_batch=REPLAY_CHUNK)
        if replayed:
            server.metrics.counter(
                "event_wal_replayed_total",
                "spilled events successfully replayed into storage").inc(replayed)
            log.info("WAL replay: %d event(s) landed", replayed)
        if err is not None:
            log.debug("WAL replay stopped (storage still down?): %s", err)
        return replayed
