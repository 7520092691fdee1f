"""Remote log shipping: POST server log records to a collector URL.

Counterpart of the JAX package's ``utils/logship.py`` (the reference
deploy server's ``--log-url``, workflow/CreateServer.scala:441-452),
for every long-running server of the port (the query server, the Event
Server). Records queue up and a background thread ships them as
JSON-lines batches with the JAX package's fields (``ts``, ``level``,
``logger``, ``message`` and, inside a request, ``trace_id``):
best-effort, so a dead collector never blocks or crashes the serving
path.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import urllib.request

from predictionio_tpu_torch.obs.tracing import current_trace_id


class RemoteLogHandler(logging.Handler):
    """logging.Handler that ships records to `url` as JSON lines.

    Batch shipping: records queue up and a daemon thread POSTs up to
    `batch_size` of them every `flush_interval` seconds. Failures are
    dropped silently after one stderr note (best-effort by design)."""

    def __init__(
        self,
        url: str,
        level: int = logging.INFO,
        batch_size: int = 50,
        flush_interval: float = 2.0,
        max_buffer: int = 10_000,
    ):
        super().__init__(level=level)
        self.url = url
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self._q: queue.Queue = queue.Queue(maxsize=max_buffer)
        self._stop = threading.Event()
        self._warned = False
        self._thread = threading.Thread(
            target=self._loop, name="log-shipper", daemon=True
        )
        self._thread.start()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry = {
                "ts": record.created,
                "level": record.levelname,
                "logger": record.name,
                "message": self.format(record),
            }
            # emit() runs on the logging thread, which for server-side
            # records is the request handler thread — the tracing
            # contextvar still holds the request's id, so shipped records
            # correlate with the access log at the collector
            trace_id = current_trace_id()
            if trace_id:
                entry["trace_id"] = trace_id
            self._q.put_nowait(entry)
        except queue.Full:
            pass  # shedding is the correct failure mode for telemetry

    def _drain(self) -> list[dict]:
        out: list[dict] = []
        while len(out) < self.batch_size:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        return out

    def _ship(self, records: list[dict]) -> bool:
        body = "\n".join(json.dumps(r) for r in records).encode()
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={"Content-Type": "application/x-ndjson"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5):
                pass
            if self._warned:
                # a recovered collector logs its recovery (and re-arms
                # the one-shot warning for the next outage)
                self._warned = False
                logging.getLogger("pio.logship").info(
                    "log shipping to %s recovered", self.url
                )
            return True
        except Exception as e:
            if not self._warned:
                self._warned = True
                # NOT a predictionio_tpu_torch logger: the shipper is
                # typically attached there, and the warning would loop
                # back into the dead-collector queue via propagation
                logging.getLogger("pio.logship").warning(
                    "log shipping to %s failing (%s); further failures "
                    "are silent", self.url, e,
                )
            return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.flush_interval)
            records = self._drain()
            if records:
                self._ship(records)

    def close(self) -> None:
        self._stop.set()
        while True:  # flush everything pending, batch by batch…
            records = self._drain()
            if not records:
                break
            if not self._ship(records):
                break  # …but a dead collector must not block shutdown
        self._thread.join(timeout=2)
        super().close()


def attach_log_shipper(url: str, logger: logging.Logger | None = None) -> RemoteLogHandler:
    """Install a RemoteLogHandler on `logger` (root by default).

    Also lowers the logger's level to INFO when it would otherwise inherit
    the WARNING root default — --log-url promises INFO-level shipping, and
    without a logging config the records would be dropped at the logger
    before any handler sees them."""
    handler = RemoteLogHandler(url)
    handler.setFormatter(logging.Formatter("%(message)s"))
    target = logger or logging.getLogger()
    if target.getEffectiveLevel() > logging.INFO:
        target.setLevel(logging.INFO)
    target.addHandler(handler)
    return handler
