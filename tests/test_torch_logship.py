"""Log shipping (``--log-url``) on the port, against the JAX package's, on
the CPU.

- ``RemoteLogHandler`` ships JSON-lines records with the JAX fields
  (``ts``, ``level``, ``logger``, ``message``, and inside a request its
  ``trace_id``): the same logging calls through the port's and the JAX
  handler reach a collector as equal records; a recovered collector
  logs its recovery and re-arms the warning, as the JAX handler does.
- A dead or hanging collector never blocks: records shed at the buffer
  bound, ``close`` returns, and a query server that ships to one
  answers every query as the same server without shipping does, at a
  p99 of the same order.
- ``--log-url`` on both servers: the query server and the Event Server
  (in process and as ``console eventserver`` / ``console deploy``
  children) ship their access log to the collector.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.obs import tracing as jtracing  # noqa: E402
from predictionio_tpu.utils import logship as jlogship  # noqa: E402
from predictionio_tpu_torch.obs import tracing as ttracing  # noqa: E402
from predictionio_tpu_torch.utils import logship  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIELDS = {"ts", "level", "logger", "message"}


class _Collector(BaseHTTPRequestHandler):
    received: list = []
    bodies: list = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0))).decode()
        type(self).bodies.append((self.headers.get("Content-Type"), body))
        for line in body.splitlines():
            if line.strip():
                type(self).received.append(json.loads(line))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture(autouse=True)
def _package_logger_level():
    """`attach_log_shipper` lowers the package logger to INFO for good (as
    the JAX one does); later tests in this process get its level back."""
    logger = logging.getLogger("predictionio_tpu_torch")
    level = logger.level
    yield
    logger.setLevel(level)


@pytest.fixture()
def collector():
    _Collector.received, _Collector.bodies = [], []
    srv = HTTPServer(("127.0.0.1", 0), _Collector)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/logs", _Collector.received
    srv.shutdown()
    srv.server_close()


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


def _dead_url():
    """A localhost port with nothing listening."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}/logs"


@pytest.fixture()
def hanging_url():
    """A collector that accepts connections and never answers."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(64)
    yield f"http://127.0.0.1:{sock.getsockname()[1]}/logs"
    sock.close()


def _ship(mod, trace_mod, url, logger_name):
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.DEBUG)
    handler = mod.RemoteLogHandler(url, flush_interval=0.05)
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(handler)
    try:
        logger.debug("below the handler's level")
        logger.info("shipped %d", 1)
        with trace_mod.trace_context("trace-abc"):
            logger.warning("inside the request")
        logger.error("shipped %s", "two")
    finally:
        logger.removeHandler(handler)
        handler.close()  # flushes what is pending


def test_records_carry_the_jax_fields_and_trace_id(collector):
    url, received = collector
    _ship(jlogship, jtracing, url, "pio.test.ship")
    jax_records = list(received)
    received.clear()
    _ship(logship, ttracing, url, "pio.test.ship")
    assert len(received) == len(jax_records) == 3
    for got, want in zip(received, jax_records):
        assert set(got) == set(want) and FIELDS <= set(got)
        assert {k: v for k, v in got.items() if k != "ts"} == {
            k: v for k, v in want.items() if k != "ts"}
        assert isinstance(got["ts"], float)
    assert received[1]["trace_id"] == "trace-abc" and "trace_id" not in received[0]
    assert [r["level"] for r in received] == ["INFO", "WARNING", "ERROR"]
    assert {ct for ct, _ in _Collector.bodies} == {"application/x-ndjson"}


def test_recovery_rearms_the_warning(collector):
    url, _ = collector
    handler = logship.RemoteLogHandler(url, flush_interval=3600)
    notes = []

    class _Cap(logging.Handler):
        def emit(self, record):
            notes.append(record.getMessage())

    ship_logger = logging.getLogger("pio.logship")
    cap = _Cap()
    ship_logger.addHandler(cap)
    ship_logger.setLevel(logging.INFO)
    try:
        handler._warned = True
        assert handler._ship([{"message": "hello"}])
        assert handler._warned is False and any("recovered" in n for n in notes)
        handler.url = _dead_url()
        assert not handler._ship([{"message": "lost"}]) and handler._warned
        assert not handler._ship([{"message": "lost"}])
        assert sum("failing" in n for n in notes) == 1  # one warning an outage
    finally:
        ship_logger.removeHandler(cap)
        handler.close()


@pytest.mark.parametrize("kind", ["dead", "hanging"])
def test_a_dead_collector_never_blocks(kind, hanging_url):
    url = _dead_url() if kind == "dead" else hanging_url
    logger = logging.getLogger(f"pio.test.dead.{kind}")
    handler = logship.RemoteLogHandler(url, flush_interval=0.01, max_buffer=100)
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        for n in range(2_000):
            logger.info("record %d", n)
        assert time.perf_counter() - t0 < 2.0  # no emit waits on the network
        assert handler._q.qsize() <= 100  # shed at the bound
    finally:
        logger.removeHandler(handler)
        t0 = time.perf_counter()
        handler.close()
        # one failed batch ends the drain: a refused connection at once, a
        # hanging one at the ship timeout, plus the thread's join
        assert time.perf_counter() - t0 < (1.0 if kind == "dead" else 12.0)


def test_attach_lowers_the_logger_to_info(collector):
    url, received = collector
    logger = logging.getLogger("pio.test.attach")
    logger.setLevel(logging.WARNING)
    handler = logship.attach_log_shipper(url, logger)
    try:
        assert logger.level == logging.INFO
        logger.info("an info record")
    finally:
        logger.removeHandler(handler)
        handler.close()
    assert [r["message"] for r in received] == ["an info record"]


# -- the servers ------------------------------------------------------------------


def _factors(n_users=40, n_items=60, rank=4):
    from predictionio_tpu_torch import convert

    rng = np.random.default_rng(9)
    return convert.als_factors_from_numpy(
        rng.standard_normal((n_users, rank)).astype(np.float32),
        rng.standard_normal((n_items, rank)).astype(np.float32),
        [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)], {})


def _query_server(log_url=None):
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm, ALSAlgorithmParams, ALSModel)
    from predictionio_tpu_torch.workflow.server import QueryServer, QueryServerConfig

    srv = QueryServer(ALSAlgorithm(ALSAlgorithmParams(rank=4)),
                      ALSModel(_factors(), device="cpu"),
                      QueryServerConfig(ip="127.0.0.1", port=0, log_url=log_url))
    srv.start()
    return srv


def _post(port, path, body, timeout=30):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _answers(srv, queries):
    out, lat = [], []
    for q in queries:
        t0 = time.perf_counter()
        out.append(_post(srv.port, "/queries.json", q))
        lat.append(time.perf_counter() - t0)
    return out, sorted(lat)[int(0.99 * len(lat))]


def test_query_server_ships_its_access_log(collector):
    url, received = collector
    srv = _query_server(url)
    try:
        assert logging.getLogger("predictionio_tpu_torch").getEffectiveLevel() <= logging.INFO
        for u in range(5):
            assert _post(srv.port, "/queries.json", {"user": f"u{u}", "num": 3})[0] == 200
        assert _wait(lambda: sum('"/queries.json"' in r["message"] for r in received) >= 5)
    finally:
        srv.stop()
    access = [r for r in received if r["logger"] == "predictionio_tpu_torch.access"]
    assert access and all(FIELDS <= set(r) for r in access)
    line = json.loads(access[0]["message"])
    assert line["server"] and line["path"] == "/queries.json" and line["trace_id"]
    assert access[0]["trace_id"] == line["trace_id"]
    assert srv._log_shipper is None  # detached at stop
    assert not any(isinstance(h, logship.RemoteLogHandler)
                   for h in logging.getLogger("predictionio_tpu_torch").handlers)


def test_a_dead_collector_leaves_the_answers_and_p99(hanging_url):
    queries = [{"user": f"u{n % 40}", "num": 1 + n % 7} for n in range(150)]
    plain = _query_server()
    try:
        want, p99_plain = _answers(plain, queries)
    finally:
        plain.stop()
    for url in (_dead_url(), hanging_url):
        srv = _query_server(url)
        try:
            got, p99 = _answers(srv, queries)
        finally:
            srv.stop()
        assert got == want
        assert p99 < 3 * p99_plain + 0.05, (url, p99, p99_plain)


def test_event_server_ships_its_access_log(collector, tmp_path):
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig
    from predictionio_tpu_torch.data.storage import base as tbase
    from predictionio_tpu_torch.data.storage import registry as treg

    url, received = collector
    storage = treg.Storage(treg.StorageConfig.memory())
    app_id = storage.get_meta_data_apps().insert(tbase.App(0, "logs"))
    storage.get_events().init_app(app_id)
    storage.get_meta_data_access_keys().insert(tbase.AccessKey("KEY", app_id))
    srv = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None,
                                                 log_url=url))
    srv.start()
    try:
        status, body = _post(srv.port, "/events.json?accessKey=KEY", {
            "event": "rate", "entityType": "user", "entityId": "u1",
            "targetEntityType": "item", "targetEntityId": "i1",
            "properties": {"rating": 4}})
        assert status == 201 and body["eventId"]
        assert _wait(lambda: any('"/events.json"' in r["message"] for r in received))
    finally:
        srv.stop()


def _child(argv, env):
    return subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _banner_port(proc, pattern, timeout=120):
    import re

    deadline = time.time() + timeout
    lines = []
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        m = re.search(pattern, line)
        if m:
            return int(m.group(1))
    proc.kill()
    raise AssertionError("no banner:\n" + "".join(lines))


def test_console_log_url_on_both_servers(collector, tmp_path):
    """`console eventserver --log-url` and `console deploy --log-url` in
    processes of their own ship their access logs to the collector."""
    from predictionio_tpu_torch.tools import console

    url, received = collector
    env = {**os.environ, "PIO_FS_BASEDIR": str(tmp_path / "store"),
           "PIO_WAL_DIR": str(tmp_path / "wal")}
    env = {k: v for k, v in env.items() if not k.startswith("PIO_STORAGE_")}
    old = {k: os.environ.get(k) for k in env if k.startswith("PIO_")}
    os.environ.update({k: env[k] for k in ("PIO_FS_BASEDIR",)})
    try:
        assert console.main(["app", "new", "A", "--access-key", "KEYA"]) == 0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    blob = tmp_path / "f.npz"
    blob.write_bytes(_factors().to_bytes())
    procs = [_child(["eventserver", "--ip", "127.0.0.1", "--port", "0", "--log-url", url],
                    env),
             _child(["deploy", "--model", str(blob), "--ip", "127.0.0.1", "--port", "0",
                     "--device", "cpu", "--log-url", url], env)]
    try:
        es = _banner_port(procs[0], r"listening at http://[^:]+:(\d+)")
        dep = _banner_port(procs[1], r"on [^:]+:(\d+)")
        assert _post(es, "/events.json?accessKey=KEYA", {
            "event": "view", "entityType": "user", "entityId": "u1"})[0] == 201
        status, body = _post(dep, "/queries.json", {"user": "u3", "num": 2})
        assert status == 200 and len(body["item_scores"]) == 2
        assert _wait(lambda: {json.loads(r["message"]).get("path") for r in received
                              if r["logger"] == "predictionio_tpu_torch.access"}
                     >= {"/events.json", "/queries.json"}, timeout=20)
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=30)
