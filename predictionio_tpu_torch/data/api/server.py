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
with ``Retry-After`` and ``events_shed_total{reason="deadline"}``. The
``event.insert`` fault point fires before each storage write; where the
JAX package spills a failed write into its write-ahead log and answers
202, the port has no WAL and answers 503 (per event in a batch), so an
expired POST is always shed. The WAL spill (it serves only backends that
can be unreachable, none of them ported), ``/segments/*``, the other
``/debug/*`` routes and log shipping are not ported: those routes answer
404 saying so. The server's registry is sampled by the process monitor
while it serves (``utils/http.py``).
"""

from __future__ import annotations

import base64
import datetime as _dt
import logging
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
from predictionio_tpu_torch.data.event import Event, EventValidation, ValidationError
from predictionio_tpu_torch.data.storage.base import EventQuery
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.obs import server_registry
from predictionio_tpu_torch.resilience import deadline as _deadline
from predictionio_tpu_torch.resilience import faults as _faults
from predictionio_tpu_torch.utils.http import (
    HttpError,
    JsonHandler,
    ServerProcess,
    ThreadedServer,
)

log = logging.getLogger(__name__)

MAX_EVENTS_PER_BATCH = 50  # reference EventServer.scala:68


@dataclass
class EventServerConfig:
    ip: str = "0.0.0.0"
    port: int = 7070
    stats: bool = False
    plugins: list = field(default_factory=list)


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
        storage = self.server.storage
        access_key = storage.get_meta_data_access_keys().get(key)
        if access_key is None:
            raise HttpError(401, "Invalid accessKey.")
        channel_id: Optional[int] = None
        channel = query.get("channel")
        if channel:
            match = [c for c in storage.get_meta_data_channels().get_by_app_id(
                access_key.app_id) if c.name == channel]
            if not match:
                raise HttpError(401, "Invalid channel.")
            channel_id = match[0].id
        return AuthData(access_key.app_id, channel_id, tuple(access_key.events))

    # -- the insert path ---------------------------------------------------
    def _admit_event(self, auth: AuthData, obj: dict) -> Event:
        """Validation, the key's whitelist and the input blockers:
        everything before the store, shared by the single and batch
        paths."""
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
        return event

    def _after_insert(self, auth: AuthData, obj: dict, event: Event) -> None:
        self.server.plugin_context.run_sniffers(
            obj, {"appId": auth.app_id, "channelId": auth.channel_id})
        self.server.metrics.counter(
            "events_ingested_total", "events accepted into storage").inc()
        if self.server.stats is not None:
            self.server.stats.update(auth.app_id, 201, event)

    def _insert_event(self, auth: AuthData, obj: dict) -> None:
        event = self._admit_event(auth, obj)
        try:
            _faults.fire("event.insert")
        except _faults.FaultInjected as e:
            # no write-ahead log to spill into: the event is not stored
            raise HttpError(503, f"storage unavailable; event not stored ({e})")
        event_id = self.server.storage.get_events().insert(
            event, auth.app_id, auth.channel_id)
        self._after_insert(auth, obj, event)
        self._respond(201, {"eventId": event_id})

    def _maybe_shed_ingest(self, method: str, path: str) -> bool:
        """Shed an event POST whose X-PIO-Deadline already expired: 503 +
        Retry-After before auth, validation and storage are touched. The
        JAX package keeps such a POST while its WAL holds spilled events;
        the port has no WAL, so it always sheds."""
        if method != "POST" or not (
            path in ("/events.json", "/batch/events.json")
            or path.startswith("/webhooks/")
        ):
            return False
        if not _deadline.expired():
            return False
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
            elif path.startswith(("/debug/", "/segments/")):
                raise HttpError(404, f"{path} is not ported yet to the PyTorch port")
            else:
                raise HttpError(404, "Not Found")
        except HttpError as e:
            self._respond(e.status, {"message": e.message})
        except Exception:
            log.exception("internal error on %s %s", method, self.path)
            self._respond(500, {"message": "internal server error"})

    def _post_batch(self, auth: AuthData) -> None:
        """Per-event statuses in a 200 after one `insert_batch` of the
        admitted events; a batch over MAX_EVENTS_PER_BATCH is a 400 for
        the whole (reference EventServer.scala:374-440)."""
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


class EventServer(ServerProcess):
    """Start and stop the ingestion server (reference EventServerActor
    and Run, EventServer.scala:580-640); port 0 binds a free port."""

    _name = "event-server"

    def __init__(self, storage: Optional[Storage] = None,
                 config: Optional[EventServerConfig] = None):
        super().__init__()
        self.storage = storage or Storage()
        self.config = config or EventServerConfig()

    def _make_server(self) -> _Server:
        return _Server((self.config.ip, self.config.port), self.storage, self.config)
