"""Threaded-HTTP plumbing for the port's server processes: JSON
responses, eager body drain (an unread POST body desyncs HTTP/1.1
keep-alive), the body's JSON parse (malformed JSON answers 400), and a
start/stop/port lifecycle. Standard library only."""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

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

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("%s " + fmt, self.address_string(), *args)

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
        self, status: int, body: Any, content_type: str = "application/json"
    ) -> None:
        data = (
            body.encode() if isinstance(body, str) else json.dumps(body).encode()
        )
        self.send_response(status)
        self.send_header("Content-Type", f"{content_type}; charset=UTF-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
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
        return self.port

    def stop(self) -> None:
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
