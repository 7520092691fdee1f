"""The port's metrics exposition, request tracing and debug routes,
against the JAX package.

- The registry: the same sequence of operations (labeled counters,
  gauges, a callback gauge, histograms with their own buckets and lower
  bound, observations under a trace id that leave exemplars) renders
  byte for byte the JAX registry's text, and snapshots equal;
  ``render_merged`` the same.
- ``X-Request-ID``: an id of the JAX package's charset and length is
  echoed, any other replaced by a fresh one.
- ``/metrics``, ``/debug/traces`` and ``/debug/profile`` on the port's
  Event Server and query server: the Event Server's request and event
  counters equal the JAX Event Server's after the same requests; the
  query server's request histogram, the traces' filters and the
  Perfetto export, the trace capture (409 without a dispatcher), the
  routes left out saying so.
- The console's ``metrics``, ``trace`` and ``profile`` over a running
  port server print what the JAX console prints over it.
"""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.obs import registry as jregistry  # noqa: E402
from predictionio_tpu.obs import tracing as jtracing  # noqa: E402
from predictionio_tpu_torch.obs import registry, spans, tracing  # noqa: E402


def _operate(reg_mod, trace_mod):
    """One sequence of registry operations in either package."""
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("http_requests_total", "HTTP requests served",
                    ("server", "method", "path", "status"))
    c.inc(server="query", method="POST", path="/queries.json", status=200)
    c.inc(3, server="query", method="GET", path="/metrics", status=200)
    c.inc(server="event", method="POST", path='/odd"path\\\n', status=404)
    reg.counter("plain_total", "")  # an empty unlabeled family renders 0
    g = reg.gauge("online_drift_score", "score drift", ("scope",))
    g.set(0.25, scope="a")
    g.set(1e20, scope="b")
    g.set(0.75, scope="a")
    reg.gauge_callback("live_bytes", "bytes now", lambda: 1234.5)
    reg.gauge_callback("broken", "a failing callback", lambda: 1 / 0)
    h = reg.histogram("http_request_seconds", "request wall time", ("server", "path"))
    b = reg.histogram("batch_size", "queries a batch", buckets=(1, 2, 4, 8, 16, 32, 64, 128),
                      lower_bound=1)
    rng = np.random.default_rng(7)
    for n in range(60):
        v = float(rng.exponential(0.02))
        if n % 5 == 0:
            with trace_mod.trace_context(f"trace-{n:03d}"):
                h.observe(v, server="query", path="/queries.json")
                h.observe(v / 3, server="query", path="/metrics")
        else:
            h.observe(v, server="event", path="/events.json")
        b.observe(int(rng.integers(1, 100)))
    h.observe(float("inf"), server="event", path="/events.json")
    return reg


def test_registry_text_is_the_jax_registry_text(monkeypatch):
    monkeypatch.setattr(registry.time, "time", lambda: 1_700_000_000.125)
    monkeypatch.setattr(jregistry.time, "time", lambda: 1_700_000_000.125)
    reg, jreg = _operate(registry, tracing), _operate(jregistry, jtracing)
    text = reg.render()
    assert text == jreg.render()
    assert "# EXEMPLAR http_request_seconds trace-" in text
    assert 'path="/odd\\"path\\\\\\n"' in text
    assert reg.snapshot() == jreg.snapshot()
    other, jother = registry.MetricsRegistry(), jregistry.MetricsRegistry()
    other.counter("http_requests_total", "another", ("x",)).inc(x=1)
    jother.counter("http_requests_total", "another", ("x",)).inc(x=1)
    other.counter("only_here", "").inc()
    jother.counter("only_here", "").inc()
    assert registry.render_merged(reg, None, other) == jregistry.render_merged(jreg, None, jother)


def test_registry_refuses_a_different_redeclaration():
    reg = registry.MetricsRegistry()
    reg.histogram("h", "", buckets=(1, 2))
    with pytest.raises(ValueError):
        reg.histogram("h", "", buckets=(1, 3))
    with pytest.raises(ValueError):
        reg.counter("h", "")
    with pytest.raises(ValueError):
        reg.gauge_callback("g", "", lambda: 1.0).callback and reg.gauge("g", "", ("l",))
    fam = reg.gauge_callback("cb", "", lambda: 1.0)
    reg.gauge_callback("cb", "", lambda: 2.0)  # the newest callback wins
    assert fam.value() == 2.0


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------


def _request(port, path, method="GET", body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method, headers=headers or {},
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers


def _event_servers(tmp_path):
    from predictionio_tpu.data.api.server import (
        EventServer as JServer,
        EventServerConfig as JConfig,
    )
    from predictionio_tpu.data.storage import base as jbase
    from predictionio_tpu.data.storage import registry as jreg
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig
    from predictionio_tpu_torch.data.storage import base as tbase
    from predictionio_tpu_torch.data.storage import registry as treg

    servers = []
    for name, reg, base, server, config in (
            ("jax", jreg, jbase, JServer, JConfig(ip="127.0.0.1", port=0, wal_dir=None)),
            ("port", treg, tbase, EventServer, EventServerConfig(ip="127.0.0.1", port=0))):
        storage = reg.Storage(reg.StorageConfig(
            sources={"S": reg.SourceConfig("S", "memory", {})},
            repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
        app_id = storage.get_meta_data_apps().insert(base.App(id=0, name="obsapp"))
        storage.get_events().init_app(app_id)
        storage.get_meta_data_access_keys().insert(
            base.AccessKey(key="KEY", app_id=app_id, events=()))
        servers.append(server(storage, config))
    return servers


EVENT = {"event": "rate", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "i1",
         "properties": {"rating": 4}, "eventTime": "2024-01-01T00:00:00.000Z"}


def _counter_lines(text, names):
    return sorted(line for line in text.splitlines()
                  if line.split("{")[0].split(" ")[0] in names)


def test_event_server_metrics_equal_the_jax_servers(tmp_path):
    jsrv, tsrv = _event_servers(tmp_path)
    ports = jsrv.start(), tsrv.start()
    try:
        texts = []
        for port in ports:
            for _ in range(3):
                assert _request(port, "/events.json?accessKey=KEY", "POST", EVENT)[0] == 201
            assert _request(port, "/batch/events.json?accessKey=KEY", "POST",
                            [EVENT, EVENT])[0] == 200
            assert _request(port, "/events.json?accessKey=NOPE", "POST", EVENT)[0] == 401
            assert _request(port, "/nowhere")[0] == 404
            assert _request(port, "/events/abc.json?accessKey=KEY")[0] == 404
            status, text, headers = _request(port, "/metrics")
            assert status == 200 and headers["Content-Type"].startswith("text/plain")
            texts.append(text)
        names = {"http_requests_total", "events_ingested_total"}
        assert _counter_lines(texts[1], names) == _counter_lines(texts[0], names)
        assert "events_ingested_total 5" in texts[1]
        status, body, _ = _request(ports[1], "/debug/profile")
        assert status == 200 and json.loads(body)["totals"]["invocations"] >= 0
        status, body, _ = _request(ports[1], "/debug/traces")
        assert status == 200 and "sampling" in json.loads(body)
        for left_out in ("/debug/faults", "/debug/tsdb", "/segments/stats"):
            status, body, _ = _request(ports[1], left_out)
            assert status == 404 and "not ported" in json.loads(body)["message"]
    finally:
        jsrv.stop()
        tsrv.stop()


@pytest.mark.parametrize("rid, echoed", [
    ("abc-123_x.y:z", True),
    ("x" * 128, True),
    ("x" * 129, False),
    ("bad id", False),
    ("semi;colon", False),
    ("", False),
])
def test_request_id_sanitising(tmp_path, rid, echoed):
    _, tsrv = _event_servers(tmp_path)
    port = tsrv.start()
    try:
        _, _, headers = _request(port, "/", headers={"X-Request-ID": rid} if rid else {})
    finally:
        tsrv.stop()
    got = headers["X-Request-ID"]
    if echoed:
        assert got == rid
    else:
        assert re.fullmatch(r"[0-9a-f]{32}", got)


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

    def make(micro_batch=True):
        srv = QueryServer(ALSAlgorithm(ALSAlgorithmParams(rank=3)),
                          ALSModel(factors, device="cpu"),
                          QueryServerConfig(ip="127.0.0.1", port=0, micro_batch=micro_batch))
        srv.start()
        made.append(srv)
        return srv.port

    made = []
    monkeypatch.setattr(spans.get_default_recorder(), "sample_rate", 0.0)
    yield make
    for srv in made:
        srv.stop()


def _query(port, user, rid):
    return _request(port, "/queries.json", "POST", {"user": user, "num": 3},
                    {"Content-Type": "application/json", "X-Request-ID": rid})


def test_query_server_routes(query_server):
    port = query_server()
    for n in range(5):
        assert _query(port, f"u{n}", f"q{n}")[0] == 200
    assert _request(port, "/queries.json", "POST", {"user": 5})[0] == 400
    status, text, _ = _request(port, "/metrics")
    assert status == 200
    assert ('http_request_seconds_count{server="query",path="/queries.json"} 6' in text)
    assert ('http_requests_total{server="query",method="POST",path="/queries.json",'
            'status="200"} 5' in text)
    assert "serve_seconds_count 5" in text and "predict_seconds_count" in text
    # sampled out at rate 0; an armed capture keeps the next batch
    status, body, _ = _request(port, "/debug/traces/capture", "POST", {"n": 1})
    capture = json.loads(body)["capture"]
    assert status == 200
    assert _request(port, "/debug/traces/capture", "POST", {"n": 65})[0] == 400
    assert _query(port, "u1", "kept-1")[0] == 200
    status, body, _ = _request(port, f"/debug/traces?capture={capture}")
    cap = json.loads(body)
    assert cap["done"] and [t["trace_id"] for t in cap["traces"]] == ["kept-1"]
    status, body, _ = _request(port, "/debug/traces?trace_id=kept-1&format=perfetto")
    names = [e["name"] for e in json.loads(body)["traceEvents"] if e["ph"] == "X"]
    assert status == 200 and "server.request" in names and "batch.device_dispatch" in names
    assert _request(port, "/debug/traces?trace_id=q1")[0] == 404
    status, body, _ = _request(port, "/debug/traces?min_duration_ms=100000")
    assert status == 200 and json.loads(body)["traces"] == []
    status, body, _ = _request(port, "/debug/traces?spans=1")
    assert any(s["trace_id"] == "q3" for s in json.loads(body)["spans"])
    status, body, _ = _request(port, "/debug/profile")
    rows = {r["name"]: r for r in json.loads(body)["executables"]}
    assert rows["als.recommend_serving"]["invocations"] >= 6
    for left_out in ("/debug/tsdb", "/debug/faults", "/alerts"):
        status, body, _ = _request(port, left_out)
        assert status == 404 and "not ported" in json.loads(body)["message"]


def test_trace_capture_needs_a_dispatcher(query_server):
    port = query_server(micro_batch=False)
    assert _query(port, "u2", "direct")[0] == 200
    status, body, _ = _request(port, "/debug/traces/capture", "POST", {"n": 1})
    assert status == 409 and "no dispatcher" in json.loads(body)["message"]


# ---------------------------------------------------------------------------
# the console
# ---------------------------------------------------------------------------


def _console(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr().out
    return code, out


def test_console_verbs_print_what_the_jax_console_prints(query_server, capsys, tmp_path):
    from predictionio_tpu.tools import console as jconsole
    from predictionio_tpu_torch.tools import console

    port = query_server()
    url = f"http://127.0.0.1:{port}"
    _request(port, "/debug/traces/capture", "POST", {"n": 2})
    for n in range(2):
        assert _query(port, f"u{n}", f"console-{n}")[0] == 200
    for argv in (["profile", "list", "--url", url],
                 ["profile", "show", "als.recommend_serving", "--url", url],
                 ["trace", "list", "--url", url],
                 ["trace", "show", "console-1", "--url", url]):
        got = _console(console.main, argv, capsys)
        want = _console(jconsole.main, argv, capsys)
        assert got == want and got[0] == 0, argv
    assert "als.recommend_serving" in got[1] or "server.request" in got[1]
    code, out = _console(console.main, ["trace", "export", "console-0", "--url", url,
                                        "--output", str(tmp_path / "t.json")], capsys)
    assert code == 0 and json.load(open(tmp_path / "t.json"))["traceEvents"]
    assert console.main(["trace", "show", "nope", "--url", url]) == 1
    assert console.main(["profile", "show", "nope", "--url", url]) == 1
    code, out = _console(console.main, ["metrics", "--url", f"{url}/metrics"], capsys)
    assert code == 0 and "# TYPE http_requests_total counter" in out
    code, out = _console(console.main, ["metrics"], capsys)
    assert code == 0 and "batch_padding_ratio" in out
    code, out = _console(console.main, ["profile", "list"], capsys)
    assert code == 0 and "als.recommend_serving" in out
