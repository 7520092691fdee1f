"""The port's fleet scrape and trace collector against the JAX package's:

- `parse_prometheus_text` and `parse_exemplar_lines` of the port's
  exposition (escaped labels, histograms, callback gauges, exemplars)
  equal the JAX parse; `parse_targets` parses alike;
- a `FleetScraper` over a port query server and a dead target writes
  `up` 1 and 0, the same series the JAX scraper writes, and backs off
  the dead target as the JAX scraper does;
- the same span fragments, polled over HTTP at the same `now`s, make the
  same trees in both collectors: a hedged trace, an orphan held then
  expired, a late root, the poll overlap deduplicated, a boring trace
  dropped; the same `since` cursors are sent;
- `/debug/traces?fleet=1` answers 503 with the JAX message without a
  collector, and the assembled trace of a query with one.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlsplit

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.obs import registry as jregistry  # noqa: E402
from predictionio_tpu.obs import spans as jspans  # noqa: E402
from predictionio_tpu.obs import tracing as jtracing  # noqa: E402
from predictionio_tpu.obs.monitor import collector as jcollector  # noqa: E402
from predictionio_tpu.obs.monitor import scrape as jscrape  # noqa: E402
from predictionio_tpu.obs.monitor import tsdb as jtsdb  # noqa: E402

from predictionio_tpu_torch.obs import registry as tregistry  # noqa: E402
from predictionio_tpu_torch.obs import spans as tspans  # noqa: E402
from predictionio_tpu_torch.obs import tracing as ttracing  # noqa: E402
from predictionio_tpu_torch.obs.monitor import collector as tcollector  # noqa: E402
from predictionio_tpu_torch.obs.monitor import get_monitor  # noqa: E402
from predictionio_tpu_torch.obs.monitor import scrape as tscrape  # noqa: E402
from predictionio_tpu_torch.obs.monitor import tsdb as ttsdb  # noqa: E402

T0 = 1_700_000_000.0


def _exposition(reg_mod, trace_mod):
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("http_requests_total", "HTTP requests served",
                    ("server", "method", "path", "status"))
    c.inc(server="query", method="POST", path="/queries.json", status=200)
    c.inc(2, server="event", method="POST", path='/odd"pa th\\\n,x=1', status=404)
    reg.gauge_callback("cuda_memory_allocated_bytes", "bytes", lambda: 1.5e9)
    reg.gauge("online_drift_score", "drift", ("scope",)).set(-0.25, scope="a b")
    h = reg.histogram("http_request_seconds", "wall", ("server", "path"))
    rng = np.random.default_rng(4)
    for n in range(30):
        with trace_mod.trace_context(f"trace-{n:02d}"):
            h.observe(float(rng.exponential(0.1)), server="query", path="/queries.json")
    return reg.render()


def test_exposition_parses_as_the_jax_parser_parses():
    text = _exposition(tregistry, ttracing)
    got = tscrape.parse_prometheus_text(text)
    assert got == jscrape.parse_prometheus_text(text)
    assert ("http_requests_total", {"server": "event", "method": "POST",
                                    "path": '/odd"pa th\\\n,x=1', "status": "404"}, 2.0) in got
    assert tscrape.parse_exemplar_lines(text) == jscrape.parse_exemplar_lines(text)
    assert len(tscrape.parse_exemplar_lines(text)) > 0
    # the JAX package's exposition parses alike in the port
    jtext = _exposition(jregistry, jtracing)
    assert tscrape.parse_prometheus_text(jtext) == jscrape.parse_prometheus_text(jtext)
    broken = "a_total{x=\"1\"} 2\nnot a sample\nb 3\n# comment\nc{y=\"2\"} +Inf\n"
    assert tscrape.parse_prometheus_text(broken) == jscrape.parse_prometheus_text(broken)


@pytest.mark.parametrize("text", [
    "query=http://h:8000,event=http://h:7070", "http://h:8000/", " q = http://x:1 ,, ",
    "", "a=http://u:1/p=q", "http://h:9000,b=https://k:443",
])
def test_parse_targets_equals_the_jax_parser(text):
    assert tscrape.parse_targets(text) == jscrape.parse_targets(text)


@pytest.fixture
def query_server(monkeypatch):
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        ALSModel,
    )
    from predictionio_tpu_torch.workflow.server import QueryServer, QueryServerConfig

    rng = np.random.default_rng(3)
    factors = convert.als_factors_from_numpy(
        rng.standard_normal((8, 3)).astype(np.float32),
        rng.standard_normal((11, 3)).astype(np.float32),
        [f"u{i}" for i in range(8)], [f"i{i}" for i in range(11)], {})
    srv = QueryServer(ALSAlgorithm(ALSAlgorithmParams(rank=3)), ALSModel(factors, device="cpu"),
                      QueryServerConfig(ip="127.0.0.1", port=0))
    srv.start()
    monkeypatch.setattr(tspans.get_default_recorder(), "sample_rate", 0.0)
    yield srv
    srv.stop()


def _query(port, user, rid):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps({"user": user, "num": 3}).encode(),
        headers={"Content-Type": "application/json", "X-Request-ID": rid}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def _keys(db):
    return sorted((r["name"], tuple(sorted(r["labels"].items())))
                  for r in db.summary()["series"]
                  if r["name"] not in ("scrape_duration_seconds",))


def test_scraper_writes_up_and_the_jax_series(query_server):
    port = query_server.port
    for n in range(3):
        assert _query(port, f"u{n}", f"s{n}") == 200
    targets = [("query", f"http://127.0.0.1:{port}"), ("dead", "http://127.0.0.1:1")]
    warm = tscrape.FleetScraper(ttsdb.TSDB(), targets, interval_s=60, timeout_s=5)
    assert warm.scrape_once() == {"query": True, "dead": False}
    dbs = [jtsdb.TSDB(), ttsdb.TSDB()]
    scrapers = [jscrape.FleetScraper(dbs[0], targets, interval_s=60, timeout_s=5),
                tscrape.FleetScraper(dbs[1], targets, interval_s=60, timeout_s=5)]
    ups = [s.scrape_once(now=T0) for s in scrapers]
    assert ups[1] == ups[0] == {"query": True, "dead": False}
    for db in dbs:
        assert db.latest("up", {"instance": "query"}) == 1.0
        assert db.latest("up", {"instance": "dead"}) == 0.0
    assert _keys(dbs[1]) == _keys(dbs[0])
    assert any(s.labels_dict().get("instance") == "query"
               for s in dbs[1].matching("http_requests_total"))
    # the dead target backs off alike: the next tick writes up 0 with no
    # request, and each says how long it waits
    for s in scrapers:
        assert s.scrape_once(now=T0 + 1.0)["dead"] is False
    assert scrapers[1].backoff_remaining("dead", T0 + 1.0) == \
        scrapers[0].backoff_remaining("dead", T0 + 1.0) > 0
    assert [r["up"] for r in scrapers[1].status()] == [True, False]
    assert dbs[1].range("up", {"instance": "dead"}) == dbs[0].range("up", {"instance": "dead"})
    t0 = time.perf_counter()
    scrapers[1].interval_s = 30.0
    scrapers[1].start()
    scrapers[1].stop()  # an event wait: the stop is prompt
    assert time.perf_counter() - t0 < 10.0 and scrapers[1]._thread is None


def _span(mod, tid, sid, name, parent=None, start=T0, dur=0.01, attrs=None, error=False):
    return mod.Span(trace_id=tid, span_id=sid, name=name, parent_span_id=parent, start=start,
                    duration=dur, attrs=dict(attrs or {}), error=error).to_dict()


# what each target's dump holds at each poll: (target, poll) -> spans
def _script():
    s = lambda *a, **k: _span(tspans, *a, **k)  # noqa: E731
    return {
        ("gw", 0): [s("hedged", "g1", "gateway.request", start=T0, dur=0.05),
                    s("hedged", "a1", "gateway.attempt", "g1", attrs={"kind": "primary"}),
                    s("hedged", "a2", "gateway.attempt", "g1", attrs={"kind": "hedge"}),
                    s("boring", "b1", "server.request", start=T0, dur=0.001,
                      attrs={"server": "query"})],
        ("replica", 0): [s("hedged", "r1", "server.request", "a2",
                           attrs={"server": "query", "path": "/queries.json"}),
                         s("late", "l2", "batch.device_dispatch", "l1", dur=0.02),
                         s("orphan", "o1", "server.request", "gone")],
        ("replica", 1): [s("hedged", "r1", "server.request", "a2",  # the overlap
                           attrs={"server": "query", "path": "/queries.json"}),
                         s("err", "e1", "server.request", attrs={"server": "query"},
                           error=True)],
        ("gw", 1): [s("late", "l1", "server.request", start=T0 + 1, dur=0.4,
                      attrs={"server": "query"})],
        ("gw", 2): [], ("replica", 2): [s("orphan", "o2", "batch.assemble", "gone")],
        ("gw", 3): [], ("replica", 3): [],
    }


class _Dumps(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        url = urlsplit(self.path)
        target = url.path.split("/")[1]
        self.server.sinces.append((target, dict(parse_qsl(url.query))["since"]))
        key = (target, self.server.poll)
        if key not in self.server.script:
            self.send_response(500)
            self.end_headers()
            return
        body = json.dumps({"now": T0 + 10.0 * self.server.poll,
                           "spans": self.server.script[key]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _collect(col_mod, spans_mod):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Dumps)
    srv.script, srv.poll, srv.sinces = _script(), 0, []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    recorder = spans_mod.SpanRecorder()
    recorder.record(spans_mod.Span(trace_id="local", span_id="x1", name="server.request",
                                   start=T0, duration=0.5, attrs={"server": "dashboard"}))
    col = col_mod.TraceCollector(
        targets=[("gw", f"{base}/gw"), ("replica", f"{base}/replica"),
                 ("down", f"{base}/down")],
        recorder=recorder, interval_s=1.0, hold_s=15.0, slow_ms=100.0, timeout_s=5)
    steps = []
    try:
        for poll in range(4):
            srv.poll = poll
            n = col.collect_once(now=T0 + 10.0 * poll)
            status = col.status()
            status.pop("pushed_spans", None)
            steps.append((n, status, col.summaries(limit=0),
                          {tid: col.get_trace(tid) for tid in
                           ("hedged", "late", "orphan", "boring", "err", "local")}))
        export = col.perfetto_export()
        one = col.perfetto_export("hedged")
        slowest = col.slowest(limit=2)
    finally:
        srv.shutdown()
        srv.server_close()
    return steps, srv.sinces, export, one, slowest


def test_collectors_stitch_the_same_trees():
    want = _collect(jcollector, jspans)
    got = _collect(tcollector, tspans)
    assert got == want
    steps = got[0]
    final = {s["trace_id"]: s for s in steps[-1][2]}
    assert final["hedged"]["kept"] == "hedged" and final["hedged"]["spans"] == 4
    assert final["late"]["kept"] == "slow" and final["err"]["kept"] == "error"
    assert final["local"]["kept"] == "slow"
    assert "orphan" not in final and "boring" not in final
    assert steps[-1][1]["expired_orphans"] == 1 and steps[-1][1]["poll_errors"] == 4


def _request(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_fleet_traces_route(query_server, tmp_path):
    from predictionio_tpu.data.api.server import EventServer as JEventServer
    from predictionio_tpu.data.api.server import EventServerConfig as JConfig
    from predictionio_tpu.data.storage.registry import SourceConfig as JSourceConfig
    from predictionio_tpu.data.storage.registry import Storage as JStorage
    from predictionio_tpu.data.storage.registry import StorageConfig as JStorageConfig

    port = query_server.port
    mon = get_monitor()
    assert mon.collector is None
    status, body = _request(port, "/debug/traces?fleet=1")
    jsrv = JEventServer(JStorage(JStorageConfig(
        sources={"S": JSourceConfig("S", "memory", {})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"})),
        JConfig(ip="127.0.0.1", port=0, wal_dir=None))
    jport = jsrv.start()
    try:
        assert (status, body) == _request(jport, "/debug/traces?fleet=1")
    finally:
        jsrv.stop()
    assert status == 503
    col = tcollector.TraceCollector(targets=[("query", f"http://127.0.0.1:{port}")],
                                    interval_s=1.0, slow_ms=0.0)
    mon.set_collector(col)
    try:
        assert _query(port, "u1", "fleet-q1") == 200
        assert col.collect_once() > 0
        status, body = _request(port, "/debug/traces?fleet=1&trace_id=fleet-q1")
        names = {s["name"] for s in body["spans"]}
        assert status == 200 and {"server.request", "batch.device_dispatch"} <= names
        status, body = _request(port, "/debug/traces?fleet=1")
        assert status == 200 and "fleet-q1" in [t["trace_id"] for t in body["traces"]]
        assert body["collector"]["targets"] == 1
        status, body = _request(port, "/debug/traces?fleet=1&trace_id=fleet-q1&format=perfetto")
        assert status == 200 and any(e.get("name") == "server.request"
                                     for e in body["traceEvents"])
        assert _request(port, "/debug/traces?fleet=1&trace_id=nope")[0] == 404
    finally:
        mon.set_collector(None)
