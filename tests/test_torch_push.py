"""The port's push telemetry against the JAX package's, on the same inputs
with explicit times (nothing sleeps for a result):

- tokens: `issue_push_token` gives the JAX HMAC, and `verify_push_token`
  accepts and refuses alike;
- payloads: the same registry operations and spans build the same
  payload; a payload either package built, ingested by each, writes the
  same series with the same labels and times and answers the same dict;
  malformed payloads fail with the same messages; the span rate limit
  admits the same counts at pinned times; pushed spans assemble alike;
- spools: the same file names and bytes, the same trim; a spool ships to
  the other package's ingest with each file's own token, stays when the
  ingest is down and drops files that do not parse;
- the route: `POST /telemetry/push` answers as the JAX route does (403
  disabled, 403 without or with a wrong token, 400, 200), and the
  dashboard without scrape targets is a push sink;
- the scheduler ships a dead child's spool once and leaves a live one's;
  a train child on the CPU pushes its stage series, its devprof report
  and its `train.*` spans through the dashboard with no poll.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

import predictionio_tpu.obs.monitor as jmon  # noqa: E402
from predictionio_tpu.obs import registry as jregistry  # noqa: E402
from predictionio_tpu.obs import spans as jspans  # noqa: E402
from predictionio_tpu.obs.monitor import push as jpush  # noqa: E402
from predictionio_tpu.obs.monitor.collector import TraceCollector as JCollector  # noqa: E402
from predictionio_tpu.utils import http as jhttp  # noqa: E402

import predictionio_tpu_torch.obs.monitor as tmon  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App, Event  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.deploy.scheduler import (  # noqa: E402
    JobQueue,
    SchedulerConfig,
    TrainScheduler,
)
from predictionio_tpu_torch.obs import registry as tregistry  # noqa: E402
from predictionio_tpu_torch.obs import spans as tspans  # noqa: E402
from predictionio_tpu_torch.obs.monitor import push as tpush  # noqa: E402
from predictionio_tpu_torch.obs.monitor.collector import TraceCollector as TCollector  # noqa: E402
from predictionio_tpu_torch.tools import dashboard as tdashboard  # noqa: E402

T0 = 1_700_000_000.0
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)
SECRET = "push-secret"
PKG = {"jax": (jpush, jmon, jregistry, jspans, JCollector),
       "port": (tpush, tmon, tregistry, tspans, TCollector)}


@pytest.fixture(autouse=True)
def _push_env(monkeypatch):
    for k in ("PIO_PUSH_URL", "PIO_PUSH_SPOOL", "PIO_PUSH_INGEST", "PIO_PUSH_TOKEN",
              "PIO_PUSH_SPAN_RATE", "PIO_PUSH_SPAN_BURST", "PIO_TSDB_DIR"):
        monkeypatch.delenv(k, raising=False)
    for mod in (jpush, tpush):
        mod._span_buckets.clear()
    yield
    for mod in (jpush, tpush):
        mod._span_buckets.clear()


def _monitor(pkg):
    mon = PKG[pkg][1].Monitor()
    mon.set_collector(PKG[pkg][4](targets=[], interval_s=3600))
    return mon


def _tsdb_rows(mon):
    with mon.tsdb._lock:
        return sorted((s.name, s.labels, s.kind, list(s.points))
                      for s in mon.tsdb._series.values())


def _span_dicts(pkg, n=3, trace="t1", prefix="s", rooted=True):
    Span = PKG[pkg][3].Span
    rows = []
    for i in range(n):
        parent = None if (rooted and i == 0) else f"{prefix}0"
        rows.append(Span(trace_id=trace, span_id=f"{prefix}{i}", name="train" if i == 0
                         else f"train.s{i}", parent_span_id=parent, start=T0 + i,
                         duration=0.001 * (i + 1), attrs={"i": i}).to_dict())
    return rows


def _registry(pkg, seed=4):
    """The same counter, gauge and histogram operations in either
    package's registry."""
    rng = np.random.default_rng(seed)
    reg = PKG[pkg][2].MetricsRegistry()
    c = reg.counter("jobs_total", "jobs", ("status",))
    g = reg.gauge("queue_depth", "depth", ())
    h = reg.histogram("stage_seconds", "stage", ("stage",))
    for v in rng.integers(1, 5, 6):
        c.inc(float(v), status="ok")
    c.inc(2.0, status="failed")
    g.set(float(rng.integers(0, 9)))
    for v in rng.gamma(2.0, 0.1, 40):
        h.observe(float(v), stage="read")
    return reg


def _payload(pkg, monkeypatch, instance="w1", job_id="job-1", devprof=None):
    push, _mon, registry, spans, _col = PKG[pkg]
    monkeypatch.setattr(registry, "get_default_registry",
                        lambda: registry.MetricsRegistry())
    rec = spans.SpanRecorder()
    for d in _span_dicts(pkg):
        rec.record(spans.Span(trace_id=d["trace_id"], span_id=d["span_id"],
                              name=d["name"], parent_span_id=d["parent_span_id"],
                              start=d["start"], duration=d["duration_ms"] / 1e3,
                              attrs=d["attrs"]))
    out = push.build_payload(instance, job_id=job_id, registries=[_registry(pkg)],
                             recorder=rec, now=T0, include_devprof=False)
    if devprof is not None:
        out["devprof"] = devprof
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- tokens and payloads -------------------------------------------------------------


def test_push_tokens_are_the_jax_hmac():
    rng = np.random.default_rng(9)
    for i in range(20):
        instance = f"host-{rng.integers(1 << 30)}:{i}"
        secret = rng.bytes(12).hex()
        tok = tpush.issue_push_token(instance, secret)
        assert tok == jpush.issue_push_token(instance, secret)
        for other_inst, other_secret, token in ((instance, secret, tok),
                                                (instance + "x", secret, tok),
                                                (instance, secret + "x", tok),
                                                (instance, secret, None),
                                                (instance, secret, "")):
            assert tpush.verify_push_token(other_inst, token, other_secret) == \
                jpush.verify_push_token(other_inst, token, other_secret)
    assert tpush.verify_push_token("a", tpush.issue_push_token("a", "s"), "s")
    assert (tpush.PUSH_ROUTE, tpush.TOKEN_HEADER, tpush.PAYLOAD_VERSION) == \
        (jpush.PUSH_ROUTE, jpush.TOKEN_HEADER, jpush.PAYLOAD_VERSION)


def test_the_same_operations_build_the_same_payload(monkeypatch):
    payloads = {pkg: _payload(pkg, monkeypatch) for pkg in PKG}
    for p in payloads.values():
        p["series"].sort(key=lambda r: (r["name"], sorted(r["labels"].items())))
    assert payloads["port"] == payloads["jax"]
    names = {r["name"] for r in payloads["port"]["series"]}
    assert {"jobs_total", "queue_depth", "stage_seconds_count",
            "stage_seconds_bucket"} <= names
    assert len(payloads["port"]["spans"]) == 3 and payloads["port"]["job_id"] == "job-1"


def test_build_payload_carries_the_devprof_report_when_it_has_executables(monkeypatch):
    from predictionio_tpu_torch.obs import devprof

    monkeypatch.setattr(devprof, "report", lambda: {"executables": []})
    assert "devprof" not in tpush.build_payload("w", now=T0)
    rep = {"executables": [{"name": "ops.dense_row_pass", "invocations": 20}]}
    monkeypatch.setattr(devprof, "report", lambda: rep)
    assert tpush.build_payload("w", now=T0)["devprof"] == rep
    assert "devprof" not in tpush.build_payload("w", now=T0, include_devprof=False)


@pytest.mark.parametrize("made_by", ["jax", "port"])
def test_a_payload_ingests_alike_in_both(made_by, monkeypatch):
    """A payload either package built lands as the same series (tagged
    instance and job_id, at the sampled time), the same freshness point,
    devprof report and spans, with the same answer dict."""
    devprof = {"executables": [{"name": "ops.dense_row_pass", "invocations": 20},
                               {"name": "ops.dense_col_pass", "invocations": 20}]}
    payload = _payload(made_by, monkeypatch, devprof=devprof)
    got = {}
    for pkg in PKG:
        mon = _monitor(pkg)
        answer = PKG[pkg][0].ingest(json.loads(json.dumps(payload)), monitor=mon,
                                    now=T0 + 30.0)
        st = mon.collector.status()
        got[pkg] = (answer, _tsdb_rows(mon), mon.push_reports,
                    [(r["instance"], r["devprof"]) for r in mon.push_status()],
                    mon.collector.summaries(), st["pushed_spans"], st["polls"])
    assert got["port"] == got["jax"]
    answer, rows, reports, status, summaries, pushed, polls = got["port"]
    assert answer == {"ok": True, "instance": "w1", "series_written": len(payload["series"]),
                      "spans_ingested": 3, "spans_dropped": 0}
    assert ("telemetry_last_push_age_seconds", (("instance", "w1"),), "gauge",
            [(T0 + 30.0, 30.0)]) in rows
    jobs = [r for r in rows if r[0] == "jobs_total"]
    assert jobs and all(dict(r[1])["job_id"] == "job-1" and r[3][0][0] == T0 for r in jobs)
    assert reports == {"w1": devprof} and status == [("w1", True)]
    assert summaries[0]["kept"] == "pushed" and pushed == 3 and polls == 0


def test_malformed_payloads_fail_alike():
    for bad in (None, [], "x", {"v": 99}, {"v": 1, "series": "nope", "spans": []},
                {"v": 1, "series": [], "spans": "x"}):
        errors = {}
        for pkg in PKG:
            with pytest.raises(PKG[pkg][0].PushError) as e:
                PKG[pkg][0].ingest(bad, monitor=_monitor(pkg), now=T0)
            errors[pkg] = str(e.value)
        assert errors["port"] == errors["jax"]


def test_odd_rows_and_future_clocks_alike():
    payload = {"v": 1, "instance": "", "sampled_at": T0 + 9999.0,
               "series": [{"name": "g", "value": 1.0}, {"name": ""}, "x",
                          {"name": "h", "value": "nan?"},
                          {"name": "c", "labels": {"a": 1}, "value": 2, "kind": "counter"}],
               "spans": ["x", {"trace_id": "t"}]}
    got = {}
    for pkg in PKG:
        mon = _monitor(pkg)
        got[pkg] = (PKG[pkg][0].ingest(dict(payload), monitor=mon, now=T0), _tsdb_rows(mon))
    assert got["port"] == got["jax"]
    assert got["port"][0]["instance"] == "(unknown)" and got["port"][0]["series_written"] == 2
    assert all(pt[0] <= T0 + 1.0 for r in got["port"][1] for pt in r[3])


def test_tokens_are_enforced_alike(monkeypatch):
    monkeypatch.setenv("PIO_PUSH_TOKEN", SECRET)
    payload = {"v": 1, "instance": "w1", "sampled_at": T0,
               "series": [{"name": "g", "value": 1.0}], "spans": []}
    for token in (None, "", "bogus", jpush.issue_push_token("w2", SECRET)):
        msgs = {}
        for pkg in PKG:
            with pytest.raises(PKG[pkg][0].PushAuthError) as e:
                PKG[pkg][0].ingest(dict(payload), monitor=_monitor(pkg), now=T0, token=token)
            msgs[pkg] = str(e.value)
        assert msgs["port"] == msgs["jax"]
    good = tpush.issue_push_token("w1", SECRET)
    assert tpush.ingest(dict(payload), monitor=_monitor("port"), now=T0,
                        token=good)["series_written"] == 1


@pytest.mark.parametrize("rate,burst", [("0.0001", "3"), ("1.0", "2"), ("0", "5")])
def test_the_span_rate_limit_admits_alike(monkeypatch, rate, burst):
    monkeypatch.setenv("PIO_PUSH_SPAN_RATE", rate)
    monkeypatch.setenv("PIO_PUSH_SPAN_BURST", burst)
    rng = np.random.default_rng(int(float(rate) * 100) + int(burst))
    pushes = [(f"w{rng.integers(2)}", int(rng.integers(0, 6)), T0 + float(t))
              for t in np.cumsum(rng.uniform(0.0, 1.5, 24))]
    got = {}
    for pkg in PKG:
        mon = _monitor(pkg)
        out = []
        for i, (instance, n, now) in enumerate(pushes):
            spans = [dict(d, trace_id=f"t{i}", span_id=f"{i}.{j}")
                     for j, d in enumerate(_span_dicts(pkg, n=max(n, 1)))][:n]
            a = PKG[pkg][0].ingest({"v": 1, "instance": instance, "sampled_at": now,
                                    "series": [], "spans": spans}, monitor=mon, now=now)
            out.append((a["spans_ingested"], a["spans_dropped"]))
        got[pkg] = out
    assert got["port"] == got["jax"]
    dropped = sum(d for _i, d in got["port"])
    assert (dropped == 0) == (rate == "0")
    if dropped:
        text = tregistry.render_families([tpush._dropped_counter()])
        assert 'telemetry_push_dropped_total{kind="span"}' in text


# -- spools and shipping --------------------------------------------------------------


def test_spool_files_and_trim_alike(tmp_path, monkeypatch):
    payload = _payload("port", monkeypatch)
    for pkg in PKG:
        for seq in range(1, 8):
            PKG[pkg][0].spool_payload(str(tmp_path / pkg), dict(payload, sampled_at=T0 + seq),
                                      seq)
    files = {pkg: {n: (tmp_path / pkg / n).read_bytes()
                   for n in sorted(os.listdir(tmp_path / pkg))} for pkg in PKG}
    assert files["port"] == files["jax"] and len(files["port"]) == 7
    assert list(files["port"]) == sorted(files["port"])
    size = len(next(iter(files["port"].values())))
    dropped = {pkg: PKG[pkg][0].trim_spool(str(tmp_path / pkg), 3 * size + 10) for pkg in PKG}
    assert dropped == {"jax": 4, "port": 4}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


class _JaxIngest(jhttp.JsonHandler):
    def do_POST(self):
        self._drain_body()
        try:
            if self.path.split("?")[0] == jpush.PUSH_ROUTE:
                self._serve_telemetry_push()
            else:
                raise jhttp.HttpError(404, "Not Found")
        except jhttp.HttpError as e:
            self._respond(e.status, {"message": e.message})


def _jax_ingest_server(port=0):
    srv = jhttp.ThreadedServer(("127.0.0.1", port), _JaxIngest)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _port_storage(path):
    path.mkdir(parents=True, exist_ok=True)
    sources = {"S": SourceConfig("S", "sqlite", {"PATH": str(path / "pio.db")}),
               "F": SourceConfig("F", "localfs", {"PATH": str(path)})}
    return Storage(StorageConfig(sources=sources, repositories={
        "METADATA": "S", "EVENTDATA": "S", "MODELDATA": "F"}))


@pytest.fixture
def sinks(tmp_path, monkeypatch):
    """A JAX ingest and the port's dashboard as a push sink (no scrape
    targets), each over a fresh monitor of its package."""
    monkeypatch.setenv("PIO_PUSH_INGEST", "1")
    monkeypatch.setenv("PIO_PUSH_TOKEN", SECRET)
    monkeypatch.setenv("PIO_TRACE_COLLECT", "1")
    jm = _monitor("jax")
    monkeypatch.setattr(jmon, "_monitor", jm)
    monkeypatch.setattr(tmon, "_monitor", tmon.Monitor())
    jsrv, jbase = _jax_ingest_server()
    dash = tdashboard.Dashboard(_port_storage(tmp_path / "dash"), ip="127.0.0.1", port=0,
                                monitor_targets="")
    tbase = f"http://127.0.0.1:{dash.start()}"
    try:
        yield {"jax": (jbase, jm), "port": (tbase, tmon.get_monitor())}
    finally:
        dash.stop()
        jsrv.shutdown()
        jsrv.server_close()


@pytest.mark.parametrize("spooler", ["jax", "port"])
def test_a_spool_ships_to_either_ingest_with_each_files_token(tmp_path, monkeypatch, sinks,
                                                              spooler):
    push = PKG[spooler][0]
    for receiver, (base, mon) in sinks.items():
        spool = str(tmp_path / f"{spooler}-to-{receiver}")
        for seq, inst in enumerate(("wA", "wB", "wA"), 1):
            push.spool_payload(spool, {"v": 1, "instance": inst, "sampled_at": T0 + seq,
                                       "series": [{"name": "g", "value": float(seq)}],
                                       "spans": []}, seq)
        assert push.ship_spool(spool, base + "/", deadline_s=10.0) == 3
        assert os.listdir(spool) == []
        rows = {(dict(s.labels)["instance"], tuple(s.points)) for s in mon.tsdb.matching("g")}
        assert rows == {("wA", ((T0 + 1, 1.0), (T0 + 3, 3.0))), ("wB", ((T0 + 2, 2.0),))}


def test_a_spool_stays_while_the_ingest_is_down_and_poison_goes(tmp_path, sinks):
    spool = str(tmp_path / "spool")
    tpush.spool_payload(spool, tpush.build_payload("w3", now=T0), 1)
    down = f"http://127.0.0.1:{_free_port()}"
    assert tpush.ship_spool(spool, down, deadline_s=0.3) == 0
    assert len(os.listdir(spool)) == 1
    with open(os.path.join(spool, "000-bad.json"), "w") as f:
        f.write("{not json")
    assert tpush.ship_spool(spool, sinks["port"][0]) == 1
    assert os.listdir(spool) == []
    assert tpush.ship_spool(str(tmp_path / "none"), sinks["port"][0]) == 0
    assert tpush.ship_spool(spool, "") == 0


def test_the_shipper_spools_ships_and_joins(tmp_path, sinks):
    base, mon = sinks["port"]
    reg = tregistry.MetricsRegistry()
    reg.counter("pushed_total", "t", ()).inc(7)
    sh = tpush.TelemetryShipper(str(tmp_path / "spool"), url=base, instance="w4",
                                job_id="j4", interval_s=30.0, registries=[reg],
                                recorder=tspans.SpanRecorder())
    assert sh.spool_once(now=T0) is not None and sh.ship() == 1
    sh.start()
    sh.stop()
    assert not any(t.name == tpush.TelemetryShipper.thread_name
                   for t in threading.enumerate())
    assert sh.shipped >= 2 and os.listdir(tmp_path / "spool") == []
    (s,) = mon.tsdb.matching("pushed_total", {"instance": "w4"})
    assert s.labels_dict()["job_id"] == "j4" and s.points[0] == (T0, 7.0)
    assert [r["instance"] for r in mon.push_status()] == ["w4"]


def test_from_env_alike(tmp_path, monkeypatch):
    assert tpush.TelemetryShipper.from_env() is None is jpush.TelemetryShipper.from_env()
    monkeypatch.setenv("PIO_PUSH_URL", "http://127.0.0.1:1/")
    monkeypatch.setenv("PIO_PUSH_SPOOL", str(tmp_path / "sp"))
    monkeypatch.setenv("PIO_PUSH_INTERVAL_S", "0.5")
    monkeypatch.setenv("PIO_PUSH_SPOOL_MAX_BYTES", "4096")
    shippers = [m.TelemetryShipper.from_env(instance="i", job_id="j7") for m in (jpush, tpush)]
    keys = ("spool_dir", "url", "instance", "job_id", "interval_s", "deadline_s",
            "timeout_s", "spool_max_bytes")
    assert [getattr(shippers[1], k) for k in keys] == [getattr(shippers[0], k) for k in keys]
    assert shippers[1].url == "http://127.0.0.1:1" and shippers[1].spool_max_bytes == 4096


# -- the route -------------------------------------------------------------------------


def _post(base, payload, headers=None):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(base + "/telemetry/push", data=data, method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_the_route_answers_as_the_jax_route(sinks, monkeypatch):
    payload = tpush.build_payload("w1", now=T0, include_devprof=False)
    good = {tpush.TOKEN_HEADER: tpush.issue_push_token("w1", SECRET)}
    cases = [(payload, {}), (payload, {tpush.TOKEN_HEADER: "bogus"}),
             (payload, {tpush.TOKEN_HEADER: tpush.issue_push_token("w2", SECRET)}),
             ({"v": 99}, good), (b"{not json", good), (payload, good)]
    answers = {pkg: [_post(base, p, h) for p, h in cases] for pkg, (base, _m) in sinks.items()}
    assert answers["port"] == answers["jax"]
    assert [s for s, _b in answers["port"]] == [403, 403, 403, 400, 400, 200]
    monkeypatch.delenv("PIO_PUSH_INGEST")
    answers = {pkg: _post(base, payload, good) for pkg, (base, _m) in sinks.items()}
    assert answers["port"] == answers["jax"] and answers["port"][0] == 403
    assert "PIO_PUSH_INGEST" in answers["port"][1]["message"]


def test_the_dashboard_is_a_push_sink_without_targets(sinks):
    base, mon = sinks["port"]
    payload = tpush.build_payload("w9", job_id="j9", now=T0, include_devprof=False,
                                  recorder=tspans.SpanRecorder())
    payload["spans"] = _span_dicts("port", n=4, trace="tr9")
    status, body = _post(base, payload, {tpush.TOKEN_HEADER: tpush.issue_push_token("w9", SECRET)})
    assert status == 200 and body["spans_ingested"] == 4
    with urllib.request.urlopen(base + "/debug/traces?fleet=1", timeout=10) as r:
        fleet = json.loads(r.read().decode())
    assert fleet["collector"]["polls"] == 0 and fleet["collector"]["pushed_spans"] == 4
    assert [(t["trace_id"], t["kept"]) for t in fleet["traces"]] == [("tr9", "pushed")]
    assert mon.tsdb.matching("telemetry_last_push_age_seconds", {"instance": "w9"})
    # no thread polls for the sink's collector
    assert not any(t.name == "trace-collector" for t in threading.enumerate())


# -- the scheduler and the train child --------------------------------------------------


def test_the_scheduler_ships_an_orphan_spool_once(tmp_path, sinks):
    base, mon = sinks["port"]
    cfg = SchedulerConfig(log_dir=str(tmp_path / "logs"), device="cpu",
                          child_env={"PIO_PUSH_URL": base, "PIO_PUSH_TOKEN": SECRET})
    sched = TrainScheduler(_port_storage(tmp_path / "store"), cfg)
    dead = os.path.join(cfg.log_dir, "job-dead.spool")
    live = os.path.join(cfg.log_dir, "job-live.spool")
    for i, (d, push) in enumerate(((dead, tpush), (dead, jpush), (live, tpush))):
        push.spool_payload(d, {"v": 1, "instance": f"child-{i}", "sampled_at": T0 + i,
                               "series": [{"name": "g", "value": float(i)}],
                               "spans": []}, i)
    with sched._child_lock:
        sched._children["job-live"] = object()
    try:
        assert sched.ship_orphan_spools() == 2
        assert sched.ship_orphan_spools() == 0
    finally:
        with sched._child_lock:
            sched._children.pop("job-live")
    assert not os.path.exists(dead) and len(os.listdir(live)) == 1
    assert sorted(dict(s.labels)["instance"] for s in mon.tsdb.matching("g")) == \
        ["child-0", "child-1"]
    assert sched._push_spool_dir("j", {"PIO_PUSH_URL": base}) == \
        os.path.join(cfg.log_dir, "j.spool")
    assert sched._push_spool_dir("j", {"PIO_PUSH_URL": base, "PIO_PUSH_SPOOL": "/s"}) is None
    assert sched._push_spool_dir("j", {}) is None


def test_concurrent_sweeps_ship_each_payload_once(tmp_path, sinks):
    """The scheduler ships one spool at a time: four sweeps racing over a
    dead child's spool post each of its payloads once."""
    base, mon = sinks["port"]
    cfg = SchedulerConfig(log_dir=str(tmp_path / "logs"), device="cpu",
                          child_env={"PIO_PUSH_URL": base})
    sched = TrainScheduler(_port_storage(tmp_path / "store"), cfg)
    spool = os.path.join(cfg.log_dir, "job-dead.spool")
    for i in range(24):
        tpush.spool_payload(spool, {"v": 1, "instance": "child", "sampled_at": T0 + i,
                                    "series": [{"name": "g", "value": float(i)}],
                                    "spans": []}, i)
    got, threads = [], []
    for _ in range(4):
        threads.append(threading.Thread(target=lambda: got.append(sched.ship_orphan_spools())))
        threads[-1].start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sum(got) == 24 and not os.path.exists(spool)
    (s,) = mon.tsdb.matching("g", {"instance": "child"})
    assert [v for _t, v in s.points] == [float(i) for i in range(24)]


def _seed_app(storage, n_users=30, n_items=20, n_events=300, seed=0):
    app_id = storage.get_meta_data_apps().insert(App(id=0, name="pushapp"))
    storage.get_events().init_app(app_id)
    rng = np.random.RandomState(seed)
    keys = rng.choice(n_users * n_items, n_events, replace=False)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{k // n_items}",
              target_entity_type="item", target_entity_id=f"i{k % n_items}",
              properties={"rating": float(rng.randint(1, 6))})
        for k in keys], app_id)


def test_a_train_child_pushes_its_telemetry_with_no_poll(tmp_path, sinks):
    """A train job's child on the CPU: its stage series, its devprof
    report and its `train.*` spans reach the dashboard by push, with the
    scheduler's spool, the child's token and no poll."""
    base, mon = sinks["port"]
    storage = _port_storage(tmp_path / "store")
    _seed_app(storage)
    variant = {"id": "push", "engineFactory":
               "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
               "datasource": {"params": {"app_name": "pushapp", "event_names": ["rate"]}},
               "algorithms": [{"name": "als", "params": {"rank": 4, "num_iterations": 3}}]}
    q = JobQueue(storage)
    job = q.submit(variant)
    cfg = SchedulerConfig(
        poll_interval_s=0.1, heartbeat_interval_s=0.2, stale_after_s=1.0,
        log_dir=str(tmp_path / "logs"), device="cpu",
        child_env={"PYTHONPATH": os.pathsep.join([REPO_DIR, TESTS_DIR]),
                   "PIO_PUSH_URL": base, "PIO_PUSH_TOKEN": SECRET})
    t0 = time.monotonic()
    assert TrainScheduler(storage, cfg).run_pending_once() == 1
    assert q.get(job.id).status == "completed", open(q.get(job.id).log_path).read()
    assert time.monotonic() - t0 < 120
    stage = mon.tsdb.matching("train_stage_seconds_count", {"job_id": job.id})
    assert {s.labels_dict()["stage"] for s in stage} >= {"read", "prepare", "train", "persist"}
    instance = stage[0].labels_dict()["instance"]
    assert mon.tsdb.matching("telemetry_last_push_age_seconds", {"instance": instance})
    assert {"instance": instance, "devprof": True}.items() <= \
        [r for r in mon.push_status() if r["instance"] == instance][0].items()
    rows = {r["name"]: r for r in mon.push_reports[instance]["executables"]}
    assert rows["als.train_windowed"]["invocations"] == 1
    st = mon.collector.status()
    assert st["polls"] == 0 and st["pushed_spans"] >= 5
    # kept at once: "slow" when the train ran past the collector's slow
    # bar, else "pushed"
    train = [t for t in mon.collector.summaries() if t["root"] == "train"]
    assert train and train[0]["kept"] in ("pushed", "slow") and train[0]["spans"] >= 5
    assert not os.path.exists(os.path.join(cfg.log_dir, f"{job.id}.spool"))
