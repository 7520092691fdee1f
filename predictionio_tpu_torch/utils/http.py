"""Threaded-HTTP plumbing for the port's server processes: JSON
responses, eager body drain (an unread POST body desyncs HTTP/1.1
keep-alive), the body's JSON parse (malformed JSON answers 400), a
start/stop/port lifecycle, and the observability middleware and debug
routes every server mounts (the JAX package's ``utils/http.py``):

- every request is timed, given a trace id (its ``X-Request-ID`` when
  that is 1-128 characters of ``[A-Za-z0-9._:-]``, else a new one,
  echoed in the response), counted into the owning server's registry
  (``http_requests_total{server,method,path,status}``,
  ``http_request_seconds{server,path}``), access-logged as one JSON
  record and recorded as a ``server.request`` span, parented under the
  caller's ``X-Parent-Span`` when it sends one;
- ``GET /metrics`` (the server's registry merged with the process
  default, Prometheus text), ``GET /debug/traces`` (retained traces,
  one trace by ``?trace_id=``, ``&format=perfetto``),
  ``POST /debug/traces/capture``, ``GET /debug/profile`` (the device
  profiler's report) and ``POST /debug/profile/capture`` (a
  ``torch.profiler`` window written under ``PIO_PROFILE_CAPTURE_DIR``:
  403 without it, 409 while another runs, seconds in (0, 60]);
- ``X-PIO-Deadline`` (the caller's remaining budget in ms) becomes the
  request's ambient deadline (``resilience/deadline.py``), reset before
  the next request on a kept-alive connection;
- ``GET /debug/faults`` (the process's fault specs) and ``POST
  /debug/faults`` (install or clear specs; 403 unless
  ``PIO_FAULTS_ADMIN=1`` is set on the server);
- ``POST /telemetry/push`` (a push payload of ``obs/monitor/push.py``
  into the process monitor; 403 unless ``PIO_PUSH_INGEST=1`` is set on
  the server, 403 for a bad ``X-PIO-Push-Token``, 400 for a bad
  payload), on the servers that route it (the dashboard);
- ``GET /debug/tsdb`` (the process monitor's time-series history),
  ``GET /alerts`` (its SLO and external alert states) and ``GET
  /debug/traces?fleet=1`` (the assembled cross-process traces of the
  process's fleet trace collector; 503 where none runs).

``ServerProcess.start`` attaches the server's registry to the process
monitor (``obs/monitor``), whose sampler runs while a server is
attached, and ``stop`` detaches it; the last detach joins the monitor's
threads.

Servers opt into the counters by setting `metrics` (a MetricsRegistry)
and `metrics_label` on their ThreadedServer; trace ids and spans
propagate regardless. Standard library only: none of this loads torch.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qsl, urlsplit

from predictionio_tpu_torch.obs import devprof as _devprof
from predictionio_tpu_torch.obs import monitor as _monitor
from predictionio_tpu_torch.obs import registry as _obs_registry
from predictionio_tpu_torch.obs import spans as _obs_spans
from predictionio_tpu_torch.obs import tracing as _obs_tracing
from predictionio_tpu_torch.resilience import deadline as _deadline
from predictionio_tpu_torch.resilience import faults as _faults
from predictionio_tpu_torch.utils.env import env_flag, env_path, push_knob

log = logging.getLogger(__name__)


class HttpError(Exception):
    """Raise inside a handler to produce a JSON error response."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class JsonHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # status line, headers and body are separate socket writes: with
    # Nagle on, the later writes wait for the peer's delayed ACK
    disable_nagle_algorithm = True

    # client-supplied ids are echoed into response headers: a safe
    # charset and length only (a folded header would smuggle CRLF)
    _TRACE_ID_RE = re.compile(r"[A-Za-z0-9._:-]{1,128}")

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("%s " + fmt, self.address_string(), *args)

    def handle_one_request(self):
        self._raw_body = b""
        self._trace_token = None
        self._span_token = None
        self._deadline_token = None
        try:
            super().handle_one_request()
        finally:
            # keep-alive reuses this thread: the next request must not
            # inherit this one's trace id, span context or deadline
            if self._deadline_token is not None:
                _deadline.reset(self._deadline_token)
                self._deadline_token = None
            if self._span_token is not None:
                _obs_spans.reset_current_span(self._span_token)
                self._span_token = None
            if self._trace_token is not None:
                _obs_tracing.reset_trace_id(self._trace_token)
                self._trace_token = None

    def parse_request(self):
        ok = super().parse_request()
        if ok:
            self._t0 = time.perf_counter()
            self._start_wall = time.time()
            self._metrics_recorded = False
            tid = self.headers.get("X-Request-ID") or ""
            if not self._TRACE_ID_RE.fullmatch(tid):
                tid = _obs_tracing.new_request_id()
            self._trace_id = tid
            self._trace_token = _obs_tracing.set_trace_id(tid)
            # X-Parent-Span carries the caller's span id across the
            # process boundary (same rules as the trace id)
            psp = self.headers.get("X-Parent-Span") or ""
            self._parent_span = psp if self._TRACE_ID_RE.fullmatch(psp) else None
            self._span_id = _obs_spans.new_span_id()
            self._span_token = _obs_spans.set_current_span(self._span_id)
            # the caller's remaining budget becomes this request's ambient
            # deadline: the handlers shed work that can no longer finish
            dl = _deadline.parse_header(self.headers.get(_deadline.HEADER))
            if dl is not None:
                self._deadline_token = _deadline.set_deadline(dl)
        return ok

    # -- observability middleware ------------------------------------------
    def _route_label(self, path: str) -> str:
        """Collapse the per-event path segment so the metric label set
        stays bounded (/events/<id>.json → /events/{id}.json)."""
        parts = path.split("/")
        if len(parts) == 3 and parts[1] == "events" and parts[2].endswith(".json"):
            parts[2] = "{id}.json"
        return "/".join(parts)

    def _record_request(self, status: int) -> None:
        if getattr(self, "_metrics_recorded", True):
            return
        self._metrics_recorded = True
        duration = time.perf_counter() - self._t0
        label = getattr(self.server, "metrics_label", "http")
        real_path = self.path.split("?")[0].rstrip("/") or "/"
        route = self._route_label(real_path)
        # unmatched routes share one label value: a scanned port must not
        # mint a counter and a histogram child per distinct path
        metric_path = "(unmatched)" if status == 404 else route
        registry = getattr(self.server, "metrics", None)
        if registry is not None:
            registry.counter(
                "http_requests_total", "HTTP requests served",
                ("server", "method", "path", "status"),
            ).inc(server=label, method=self.command, path=metric_path, status=status)
            registry.histogram(
                "http_request_seconds",
                "request wall time, request line to response written",
                ("server", "path"),
            ).observe(duration, server=label, path=metric_path)
        _obs_tracing.log_access(
            server=label, method=self.command, path=real_path, status=status,
            duration_s=duration, trace_id=getattr(self, "_trace_id", None),
        )
        attrs = {"server": label, "method": self.command, "path": real_path,
                 "status": status}
        if route != real_path:
            attrs["route"] = route
        # the request's root span: finalize=True runs the tail-sampling
        # decision over every span this request's handling recorded
        _obs_spans.get_default_recorder().record(
            _obs_spans.Span(
                trace_id=self._trace_id,
                span_id=self._span_id,
                parent_span_id=getattr(self, "_parent_span", None),
                name="server.request",
                start=getattr(self, "_start_wall", time.time()),
                duration=duration,
                attrs=attrs,
                error=status >= 500,
            ),
            finalize=True,
        )

    def _serve_metrics(self) -> None:
        """GET /metrics: this server's registry merged with the
        process-default one (train stages, padding accounting)."""
        text = _obs_registry.render_merged(
            getattr(self.server, "metrics", None),
            _obs_registry.get_default_registry(),
        )
        self._respond(200, text, "text/plain; version=0.0.4")

    def _serve_debug_traces(self) -> None:
        """GET /debug/traces: the retained (tail-sampled) traces;
        `?trace_id=` one trace's spans, `&format=perfetto` Chrome
        trace-event JSON; `?capture=` a capture's traces; `?spans=1`
        the raw recent spans; `?min_duration_ms=` / `?error=1` filter
        the listing; `?fleet=1` the fleet collector's assembled traces."""
        qs = dict(parse_qsl(urlsplit(self.path).query))
        recorder = _obs_spans.get_default_recorder()
        if qs.get("spans") in ("1", "true", "yes"):
            try:
                since = float(qs.get("since", 0) or 0)
            except ValueError:
                since = 0.0
            self._respond(200, {"now": time.time(),
                                "spans": [s.to_dict() for s in recorder.recent(since)]})
            return
        if qs.get("fleet") in ("1", "true", "yes"):
            self._serve_fleet_traces(qs)
            return
        capture_id = qs.get("capture")
        if capture_id:
            cap = recorder.capture_status(capture_id)
            if cap is None:
                self._respond(404, {"message": f"no capture {capture_id}"})
            else:
                self._respond(200, cap)
            return
        trace_id = qs.get("trace_id")
        if qs.get("format") == "perfetto":
            export = recorder.perfetto_export(trace_id)
            if trace_id and not export["traceEvents"]:
                self._respond(404, {"message": f"no trace {trace_id}"})
            else:
                self._respond(200, export)
            return
        if trace_id:
            spans = recorder.get_trace(trace_id)
            if not spans:
                self._respond(404, {"message": f"no trace {trace_id}"})
            else:
                self._respond(200, {"trace_id": trace_id,
                                    "spans": [s.to_dict() for s in spans]})
            return
        try:
            limit = int(qs.get("limit", "50"))
        except ValueError:
            limit = 50
        try:
            min_ms = float(qs.get("min_duration_ms", 0) or 0)
        except ValueError:
            min_ms = 0.0
        error_only = qs.get("error") in ("1", "true", "yes")
        if min_ms > 0 or error_only:
            # filter the whole store, then apply the limit
            summaries = [s for s in recorder.summaries(limit=0)
                         if s["duration_ms"] >= min_ms and (not error_only or s["error"])]
            if limit:
                summaries = summaries[:limit]
        else:
            summaries = recorder.summaries(limit=limit)
        self._respond(200, {"traces": summaries, "sampling": recorder.config()})

    def _serve_fleet_traces(self, qs: dict) -> None:
        """GET /debug/traces?fleet=1: the assembled cross-process traces
        of this process's fleet trace collector: summaries, one stitched
        tree by `&trace_id=`, `&format=perfetto` for the Chrome
        trace-event export. 503 in a process that runs no collector."""
        collector = _monitor.get_monitor().collector
        if collector is None:
            self._respond(503, {
                "message": "no fleet trace collector runs in this process "
                           "(gateways, dashboards and `pio monitor` own one)"})
            return
        trace_id = qs.get("trace_id")
        if qs.get("format") == "perfetto":
            export = collector.perfetto_export(trace_id)
            if trace_id and not export["traceEvents"]:
                self._respond(404, {"message": f"no trace {trace_id}"})
            else:
                self._respond(200, export)
            return
        if trace_id:
            spans = collector.get_trace(trace_id)
            if not spans:
                self._respond(404, {"message": f"no trace {trace_id}"})
            else:
                self._respond(200, {"trace_id": trace_id, "spans": spans})
            return
        try:
            limit = int(qs.get("limit", "50"))
        except ValueError:
            limit = 50
        self._respond(200, {"traces": collector.summaries(limit=limit),
                            "collector": collector.status()})

    def _serve_debug_tsdb(self) -> None:
        """GET /debug/tsdb: the process monitor's time-series history. No
        parameters lists the series; `?name=` gives points (with
        `labels=k:v,...`, `window_s=`, `agg=rate|increase|quantile&q=`),
        `?expr=` evaluates an expression."""
        qs = dict(parse_qsl(urlsplit(self.path).query))
        self._respond(200, _monitor.get_monitor().tsdb_payload(qs))

    def _serve_alerts(self) -> None:
        """GET /alerts: the SLO engine's alert states (pending, firing,
        resolved per declared SLO, with live burn rates) and the external
        alerts."""
        self._respond(200, _monitor.get_monitor().alerts_payload())

    def _serve_traces_capture(self) -> None:
        """POST /debug/traces/capture {"n": N}: the dispatcher keeps the
        traces of the next N device batches whatever the sample rate.
        Returns the capture id for `GET /debug/traces?capture=<id>`."""
        body = self._json_body()
        n = 1
        if isinstance(body, dict) and "n" in body:
            try:
                n = int(body["n"])
            except (TypeError, ValueError):
                raise HttpError(400, "'n' must be an integer")
        if not 1 <= n <= 64:
            raise HttpError(400, "'n' must be in [1, 64]")
        capture_id = _obs_spans.get_default_recorder().arm_capture(n)
        self._respond(200, {"capture": capture_id, "batches": n})

    def _serve_debug_profile(self) -> None:
        """GET /debug/profile: the device profiler's report (empty but
        valid in a process that ran no device function)."""
        self._respond(200, _devprof.report())

    def _device_thread(self):
        """A `run_on` for `capture_trace`: runs a function on the thread
        that launches this server's device work. None here (the window
        opens on the handler's thread); a server with such a thread
        overrides it."""
        return None

    def _serve_profile_capture(self) -> None:
        """POST /debug/profile/capture {"seconds": 2.0}: a torch.profiler
        window written under PIO_PROFILE_CAPTURE_DIR. 403 unless the
        operator set that directory on the server; 409 while a capture
        runs or where torch is not loaded; 400 for seconds outside
        (0, 60]."""
        cap_dir = env_path("PIO_PROFILE_CAPTURE_DIR")
        if not cap_dir:
            self._respond(403, {
                "message": "profiler capture is disabled: set "
                           "PIO_PROFILE_CAPTURE_DIR on this server to enable it"})
            return
        body = self._json_body()
        seconds = 2.0
        if isinstance(body, dict) and "seconds" in body:
            try:
                seconds = float(body["seconds"])
            except (TypeError, ValueError):
                raise HttpError(400, "'seconds' must be a number")
        out_dir = os.path.join(cap_dir, time.strftime("capture-%Y%m%d-%H%M%S"))
        try:
            result = _devprof.capture_trace(out_dir, seconds, self._device_thread())
        except ValueError as e:
            raise HttpError(400, str(e))
        except RuntimeError as e:
            raise HttpError(409, str(e))
        self._respond(200, result)

    def _serve_debug_faults(self) -> None:
        """GET /debug/faults: the process's active fault specs (read-only,
        so ungated)."""
        self._respond(200, {"faults": _faults.specs()})

    def _serve_debug_faults_set(self) -> None:
        """POST /debug/faults {"set": "point:mode:prob[:param][,...]",
        "seed": N} and/or {"clear": "point" | true}: install or clear
        fault specs. 403 unless PIO_FAULTS_ADMIN=1 is set on the server
        process; the whole request is checked before anything changes,
        so a malformed `set` is a 400 that cleared nothing."""
        if not env_flag("PIO_FAULTS_ADMIN"):
            self._respond(403, {
                "message": "fault-injection admin is disabled: set "
                           "PIO_FAULTS_ADMIN=1 on this server to enable it"})
            return
        body = self._json_body()
        if not isinstance(body, dict):
            raise HttpError(400, "fault admin body must be a JSON object")
        spec_text = body.get("set")
        specs = []
        if spec_text:
            seed = body.get("seed")
            try:
                specs = _faults.parse_specs(
                    spec_text, int(seed) if seed is not None else None)
            except (_faults.FaultSpecError, TypeError, ValueError) as e:
                raise HttpError(400, str(e))
        clear = body.get("clear")
        if clear is True:
            _faults.clear()
        elif isinstance(clear, str):
            _faults.clear(clear)
        for spec in specs:
            _faults.install(spec)
        self._respond(200, {"faults": _faults.specs()})

    def _serve_telemetry_push(self) -> None:
        """POST /telemetry/push: one pushed payload from a short-lived
        process (series, spans and its devprof report) into the process
        monitor's TSDB, tagged ``instance`` and ``job_id``, and its trace
        collector. Guarded like /debug/faults: 403 unless the operator set
        PIO_PUSH_INGEST=1 on this server, so that a public server cannot
        be fed made-up series; 403 for a token that does not fit the
        payload's instance, 400 for a malformed payload."""
        from predictionio_tpu_torch.obs.monitor import push as _push

        if not push_knob("PIO_PUSH_INGEST"):
            self._respond(403, {
                "message": "telemetry push ingest is disabled: set "
                           "PIO_PUSH_INGEST=1 on this server to enable it"})
            return
        body = self._json_body()
        try:
            result = _push.ingest(body, token=self.headers.get(_push.TOKEN_HEADER))
        except _push.PushAuthError as e:
            raise HttpError(403, str(e))
        except _push.PushError as e:
            raise HttpError(400, str(e))
        self._respond(200, result)

    # -- bodies and responses ----------------------------------------------
    def _drain_body(self) -> bytes:
        """Read the whole request body, whatever the route does with it,
        and keep it as `_raw_body`."""
        length = int(self.headers.get("Content-Length") or 0)
        self._raw_body = self.rfile.read(length) if length else b""
        return self._raw_body

    def _json_body(self) -> Any:
        """The drained body as JSON (empty: None); malformed JSON is a
        400."""
        try:
            return json.loads(self._raw_body.decode() or "null")
        except json.JSONDecodeError as e:
            raise HttpError(400, f"invalid JSON: {e}")

    def _respond(
        self, status: int, body: Any, content_type: str = "application/json",
        headers: Optional[dict] = None,
    ) -> None:
        data = (
            body.encode() if isinstance(body, str) else json.dumps(body).encode()
        )
        self.send_response(status)
        self.send_header("Content-Type", f"{content_type}; charset=UTF-8")
        self.send_header("Content-Length", str(len(data)))
        trace_id = getattr(self, "_trace_id", None)
        if trace_id:
            self.send_header("X-Request-ID", trace_id)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        # account before the body write: a client that has read the last
        # byte may scrape at once, and must see this request counted
        self._record_request(status)
        self.wfile.write(data)


class ThreadedServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # the default listen backlog of 5 drops connections under the
    # concurrent bursts micro-batched serving expects
    request_queue_size = 128


class ServerProcess:
    """start/stop/port lifecycle. Subclasses implement
    `_make_server() -> ThreadedServer` and set `_name`."""

    _name = "http-server"

    def __init__(self):
        self._server: Optional[ThreadedServer] = None
        self._thread: Optional[threading.Thread] = None
        self._monitor_token: Optional[int] = None

    def _make_server(self) -> ThreadedServer:
        raise NotImplementedError

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("server not started")
        return self._server.server_address[1]

    def start(self) -> int:
        self._server = self._make_server()
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=self._name, daemon=True
        )
        self._thread.start()
        # the process monitor samples this server's registry while it
        # serves: its sampler starts with the first attached server and
        # is joined when the last one stops
        registry = getattr(self._server, "metrics", None)
        if registry is not None and self._monitor_token is None:
            self._monitor_token = _monitor.get_monitor().attach(
                getattr(self._server, "metrics_label", self._name), registry)
        return self.port

    def stop(self) -> None:
        if self._monitor_token is not None:
            _monitor.get_monitor().detach(self._monitor_token)
            self._monitor_token = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def serve_forever(self) -> None:
        """Start unless started, then block until stopped."""
        if self._server is None:
            self.start()
        thread = self._thread
        if thread is not None:
            thread.join()
