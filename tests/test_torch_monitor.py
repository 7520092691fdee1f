"""The port's monitoring plane against the JAX package's, on the same
inputs with explicit times (nothing sleeps for a result):

- the TSDB: the same points (counter resets, out-of-order arrivals, the
  ring's capacity, the series cap) give equal `increase`, `rate`,
  `quantile_over_time`, `range`, `latest_point` and `summary`;
  `sample_families` of the same registry operations writes equal series;
- expressions: each text evaluates to equal rows, or fails with the same
  `ExprError` message;
- recording rules: equal derived series;
- SLOs: the same spec set through both engines at the same sequence of
  `now`s gives equal states, burn rates and transitions; the spec
  validations fail alike;
- the monitor's `alerts_payload` (with an external alert) and
  `tsdb_payload` agree, timestamps aside;
- a snapshot written by either package loads in the other;
- the exec notifier's alert JSON carries the JAX notifier's keys;
- the last detach joins every thread of the plane at once.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import predictionio_tpu.obs.monitor as jmon  # noqa: E402
from predictionio_tpu.obs import registry as jregistry  # noqa: E402
from predictionio_tpu.obs.monitor import expr as jexpr  # noqa: E402
from predictionio_tpu.obs.monitor import slo as jslo  # noqa: E402
from predictionio_tpu.obs.monitor import tsdb as jtsdb  # noqa: E402

import predictionio_tpu_torch.obs.monitor as tmon  # noqa: E402
from predictionio_tpu_torch.obs import registry as tregistry  # noqa: E402
from predictionio_tpu_torch.obs.monitor import expr as texpr  # noqa: E402
from predictionio_tpu_torch.obs.monitor import slo as tslo  # noqa: E402
from predictionio_tpu_torch.obs.monitor import tsdb as ttsdb  # noqa: E402

T0 = 1_700_000_000.0
PKGS = ((jtsdb, jexpr, jslo), (ttsdb, texpr, tslo))


def _stream(seed=5, n=120):
    """A seeded point stream: (name, labels, value, kind, t). Counters
    grow with resets, gauges wander, some points arrive out of order."""
    rng = np.random.default_rng(seed)
    out = []
    counters = {}
    series = [
        ("http_requests_total", {"server": "query", "path": "/queries.json", "status": "200"}),
        ("http_requests_total", {"server": "query", "path": "/queries.json", "status": "500"}),
        ("http_requests_total", {"server": "event", "path": "/events.json", "status": "201",
                                 "instance": "ev"}),
        ("http_requests_total", {"server": "query", "path": "/queries.json", "status": "200",
                                 "instance": "q1"}),
        ("http_requests_total", {"server": "query", "path": "/queries.json", "status": "503",
                                 "instance": "q1"}),
    ]
    for i in range(n):
        t = T0 + 2.0 * i
        for name, labels in series:
            key = (name, tuple(sorted(labels.items())))
            v = counters.get(key, 0.0) + float(rng.integers(0, 20))
            if rng.random() < 0.04:
                v = float(rng.integers(0, 5))  # a restart: the counter resets
            counters[key] = v
            out.append((name, labels, v, "counter", t))
        out.append(("up", {"instance": "q1"}, float(rng.random() < 0.9), "gauge", t))
        out.append(("up", {"instance": "ev"}, float(rng.random() < 0.7), "gauge", t))
        out.append(("p99_ms", {"route": "/q"}, float(rng.gamma(2.0, 30.0)), "gauge", t))
        out.append(("p99_ms", {"route": "/e"}, float(rng.gamma(2.0, 10.0)), "gauge", t))
        if i % 17 == 5:  # late arrival: older than the newest point
            out.append(("p99_ms", {"route": "/q"}, 1.0, "gauge", t - 3.0))
    return out


def _latency_stream(db, edges=(0.05, 0.1, 0.25, 0.5, 1.0), n=90, slow_after=45, seed=9):
    """Cumulative request-histogram buckets for one route, as the sampler
    writes them, slow from `slow_after` on."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(len(edges) + 1)
    lbl = {"server": "query", "path": "/queries.json"}
    for i in range(n):
        t = T0 + 2.0 * i
        scale = 0.4 if i >= slow_after else 0.03
        obs = rng.exponential(scale, size=int(rng.integers(5, 30)))
        for v in obs:
            counts[int(np.searchsorted(edges, v))] += 1
        cum = np.cumsum(counts)
        for e, c in zip(edges, cum):
            db.add("http_request_seconds_bucket", {**lbl, "le": repr(float(e))}, float(c),
                   "counter", t)
        db.add("http_request_seconds_bucket", {**lbl, "le": "+Inf"}, float(cum[-1]),
               "counter", t)
        db.add("http_request_seconds_count", lbl, float(cum[-1]), "counter", t)


def _fed(tsdb_mod, capacity=40, max_series=12):
    db = tsdb_mod.TSDB(capacity=capacity, max_series=max_series)
    for name, labels, v, kind, t in _stream():
        db.add(name, labels, v, kind, t)
    _latency_stream(db)
    return db


def test_tsdb_queries_equal_the_jax_tsdb():
    dbs = [_fed(m[0]) for m in PKGS]
    # the series cap held on both: extra series dropped and counted
    assert dbs[0].dropped_series == dbs[1].dropped_series > 0
    assert dbs[1].summary() == dbs[0].summary()
    assert dbs[1].series_count() == dbs[0].series_count() == 12
    for now in (T0 + 100.0, T0 + 200.5, T0 + 238.0, T0 + 300.0):
        for name, match in (("http_requests_total", None),
                            ("http_requests_total", {"status": "200"}),
                            ("http_requests_total", {"instance": "q1"}),
                            ("up", None), ("p99_ms", {"route": "/q"}), ("nothing", None)):
            for window in (None, 1.0, 10.0, 30.0, 75.0, 1000.0):
                got = [db.increase(name, match, window, now) for db in dbs]
                assert got[1] == got[0], (name, match, window, now)
                if window:
                    assert dbs[1].rate(name, match, window, now) == dbs[0].rate(
                        name, match, window, now)
                for q in (0.0, 0.5, 0.99, 1.0):
                    assert dbs[1].quantile_over_time(name, q, match, window, now) == \
                        dbs[0].quantile_over_time(name, q, match, window, now)
                assert dbs[1].range(name, match, window, now) == dbs[0].range(
                    name, match, window, now)
            assert dbs[1].latest_point(name, match) == dbs[0].latest_point(name, match)
    assert dbs[1].summary(limit=3) == dbs[0].summary(limit=3)


def test_device_seconds_rate_equals_the_jax_tsdb_over_one_window():
    """The device-seconds counter as the sampler writes it (a point a
    0.25 s tick, idle, then busy, then idle), read as a route reads it:
    at a `now` between two ticks, the newer one not written yet.
    `rate(...[5s])` is the JAX TSDB's at every such `now`, and is (the
    newest point - the last point before now - 5 s) / 5: the window over
    which a reader holds devprof's own counter (chip_smoke.py's monitor
    phase, (b))."""
    rng = np.random.default_rng(28)
    dbs = [(tsdb_mod.TSDB(capacity=720), expr_mod) for tsdb_mod, expr_mod, _ in PKGS]
    text = "rate(devprof_device_seconds_total[5s])"
    points, v = [], 0.0
    for i in range(120):
        t = T0 + 0.25 * i + float(rng.uniform(0, 0.002))  # tick jitter
        if 30 <= i < 70:
            v += float(rng.uniform(0.0, 0.03))
        points.append((t, v))
        for db, _ in dbs:
            db.add("devprof_device_seconds_total", {}, v, "counter", t)
        now = t + float(rng.uniform(0.01, 0.24))  # before the next tick
        got = [expr.evaluate_rows(db, text, now=now) for db, expr in dbs]
        assert got[1] == got[0], now
        assert [db.rate("devprof_device_seconds_total", None, 5.0, now)
                for db, _ in dbs] == [got[0][0]["value"]] * 2
        base = [val for tp, val in points if tp < now - 5.0]
        want = (v - base[-1]) / 5.0 if base else v / 5.0
        assert got[1][0]["value"] == pytest.approx(want, rel=1e-12, abs=1e-15), i
    assert max(r for r in [(points[k][1] - points[k - 20][1]) / 5.0
                           for k in range(20, 120)]) > 0.05  # the busy stretch


def test_tsdb_ring_capacity_and_reset_semantics():
    """The ring keeps the newest `capacity` points and the reset-aware
    increase reads a restart's post-reset value as the delta, in both."""
    for mod in (jtsdb, ttsdb):
        db = mod.TSDB(capacity=5, max_series=2)
        for i, v in enumerate((1, 5, 9, 2, 4, 10, 3)):
            db.add("c_total", {}, v, "counter", T0 + i)
        (s,) = db.matching("c_total")
        assert [v for _t, v in db.points(s)] == [9.0, 2.0, 4.0, 10.0, 3.0]
        assert db.increase("c_total") == 2 + 2 + 6 + 3
        assert db.add("a", {}, 1, t=T0) and not db.add("b", {}, 1, t=T0)
        assert db.dropped_series == 1
    assert ttsdb.increase_of([(0, 3), (1, 1), (2, 4)]) == jtsdb.increase_of(
        [(0, 3), (1, 1), (2, 4)])


def _registry_ops(reg_mod):
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("http_requests_total", "HTTP requests served",
                    ("server", "method", "path", "status"))
    h = reg.histogram("http_request_seconds", "request wall time", ("server", "path"))
    g = reg.gauge("online_drift_score", "drift", ("scope",))
    reg.gauge_callback("cuda_memory_allocated_bytes", "bytes", lambda: 4096.0)
    rng = np.random.default_rng(2)
    for n in range(40):
        c.inc(server="query", method="POST", path="/queries.json", status=200 + 300 * (n % 7 == 0))
        h.observe(float(rng.exponential(0.05)), server="query", path="/queries.json")
    g.set(0.5, scope="server")
    return reg


def test_sample_families_writes_the_jax_series():
    """Two registries mounting the same callback gauge: written once."""
    dbs = []
    for tsdb_mod, reg_mod in ((jtsdb, jregistry), (ttsdb, tregistry)):
        a, b = _registry_ops(reg_mod), _registry_ops(reg_mod)
        db = tsdb_mod.TSDB()
        n = tsdb_mod.sample_families(db, a.families() + b.families(), now=T0)
        n2 = tsdb_mod.sample_families(db, a.families(), {"instance": "x"}, now=T0 + 5)
        dbs.append((db.summary(), n, n2))
    assert dbs[1] == dbs[0]
    rows = [r for r in dbs[1][0]["series"] if r["name"] == "cuda_memory_allocated_bytes"]
    assert len(rows) == 2 and rows[0]["points"] == 1  # once a pass, plus the tagged one


EXPRS = [
    'up{instance="q1"}',
    "up",
    "rate(http_requests_total[30s])",
    'increase(http_requests_total{status="500"}[1m])',
    "quantile_over_time(0.9, p99_ms[100s])",
    "sum(rate(http_requests_total[60s]))",
    "sum by (status) (increase(http_requests_total[2m]))",
    "max by (instance) (up)",
    "count(up)",
    "avg(p99_ms)",
    "min by (route) (p99_ms)",
    'sum(increase(http_requests_total{status="500"}[1m])) / '
    "sum(increase(http_requests_total[1m]))",
    "sum by (instance) (rate(http_requests_total[1m])) * 60",
    "-up + 1",
    "2 * (3 + 4) / 7 - 1",
    "rate(http_requests_total[30s] offset 1m)",
    "increase(http_requests_total[40s] offset 30s) - increase(http_requests_total[40s])",
    "quantile_over_time(0.5, p99_ms[1m] offset 20s)",
    "up offset 10s",
    "sum(http_request_seconds_count) / 0",
    "nothing_here",
]
BAD_EXPRS = ["", "rate(1)", "sum by (1) (up)", "up{instance=q1}", "rate(up[5x])",
             "quantile_over_time(up[5m])", "(up", "up )", "up offset x", "up $",
             "rate(sum(up)[5m])", "up[5m]", 'up{a="b" c}', "sum by (a b) (up)", "up - -"]


@pytest.mark.parametrize("text", EXPRS)
def test_expression_rows_equal_the_jax_evaluator(text):
    dbs = [_fed(m[0], capacity=80, max_series=40) for m in PKGS]
    for now in (T0 + 150.0, T0 + 238.0):
        for window in (300.0, 20.0):
            want = jexpr.evaluate_rows(dbs[0], text, now, window)
            assert texpr.evaluate_rows(dbs[1], text, now, window) == want, (text, now)
            assert texpr.evaluate(dbs[1], text, now, window) == jexpr.evaluate(
                dbs[0], text, now, window)


@pytest.mark.parametrize("text", BAD_EXPRS)
def test_expression_errors_equal_the_jax_evaluator(text):
    db = ttsdb.TSDB()
    with pytest.raises(jexpr.ExprError) as want:
        jexpr.evaluate(jtsdb.TSDB(), text, T0)
    with pytest.raises(texpr.ExprError) as got:
        texpr.evaluate(db, text, T0)
    assert str(got.value) == str(want.value)


RULES = [
    {"record": "req_rate", "kind": "rate", "source": "http_requests_total",
     "match": {"server": "query"}, "window_s": 30},
    {"record": "err_ratio", "kind": "error_ratio", "source": "http_requests_total",
     "labels": {"slo": "avail"}, "window_s": 60},
    {"record": "err_ratio_503", "kind": "error_ratio", "source": "http_requests_total",
     "bad_values": ["503"], "window_s": 60},
    {"record": "p90", "kind": "quantile", "source": "http_request_seconds", "q": 0.9,
     "window_s": 20},
    {"record": "by_inst", "kind": "expr",
     "expr": "sum by (instance) (rate(http_requests_total[1m]))", "labels": {"rule": "x"}},
    {"record": "none_yet", "kind": "rate", "source": "missing_total"},
]


def test_recording_rules_write_the_jax_series():
    out = []
    for tsdb_mod, _e, _s in PKGS:
        db = _fed(tsdb_mod, capacity=80, max_series=60)
        rules = tsdb_mod.load_recording_rules(json.dumps(RULES))
        assert [r.to_dict() for r in rules] == [
            jtsdb.RecordingRule.from_dict(d).to_dict() for d in RULES]
        written = [tsdb_mod.evaluate_rules(db, rules, T0 + t) for t in (60.0, 120.0, 179.0)]
        out.append((written, db.summary()))
    assert out[1] == out[0]
    assert sum(out[1][0]) > 0


SPECS = [
    {"name": "avail", "kind": "availability", "objective": 0.9, "fast_window_s": 10,
     "window_s": 40, "burn_threshold": 1.0, "for_s": 4, "resolve_s": 6},
    {"name": "lat", "kind": "latency", "objective": 0.95, "threshold_ms": 250,
     "fast_window_s": 8, "window_s": 30, "burn_threshold": 2.0, "for_s": 2},
    {"name": "up_q1", "kind": "up", "instance": "q1", "objective": 0.95,
     "fast_window_s": 10, "window_s": 20, "burn_threshold": 1.5},
    {"name": "fleet_up", "kind": "up", "aggregate": "mean", "objective": 0.9,
     "fast_window_s": 10, "window_s": 30, "burn_threshold": 1.0},
    {"name": "fleet_avail", "kind": "availability", "aggregate": "sum", "objective": 0.99,
     "fast_window_s": 6, "window_s": 12, "burn_threshold": 1.0, "min_samples": 10},
    {"name": "fleet_mean", "kind": "availability", "aggregate": "mean", "objective": 0.99,
     "fast_window_s": 6, "window_s": 12, "burn_threshold": 1.0},
    {"name": "expr_slo", "kind": "expr", "objective": 0.9,
     "expr": 'sum(increase(http_requests_total{status="500"}[$window])) / '
             "sum(increase(http_requests_total[$window]))",
     "fast_window_s": 10, "window_s": 30, "burn_threshold": 1.0,
     "extra_pairs": [{"fast_window_s": 20, "window_s": 60, "burn_threshold": 0.5}]},
    {"name": "ladder", "kind": "availability", "objective": 0.999, "fast_window_s": 4,
     "window_s": 8, "burn_threshold": 100.0, "extra_pairs": [[10, 30, 1.0]]},
]


def _engine_run(tsdb_mod, slo_mod, reg_mod):
    db = _fed(tsdb_mod, capacity=200, max_series=64)
    seen = []
    eng = slo_mod.SLOEngine(db, slo_mod.load_slos(json.dumps(SPECS)), interval_s=60,
                            registry=reg_mod.MetricsRegistry(),
                            on_transition=lambda p, a, b: seen.append((p["slo"], a, b)))
    states = []
    for i in range(0, 120, 3):
        now = T0 + 2.0 * i + 0.5
        if i == 60:  # the recorded fast path, half way
            slo_mod.record_slo_ratios(db, eng.specs(), now)
            eng.recorded_max_age_s = 1.0
        eng.evaluate_once(now)
        states.append(eng.payload())
    return states, seen, [list(eng.history(s["name"])) for s in SPECS]


def test_slo_engine_equals_the_jax_engine():
    want = _engine_run(jtsdb, jslo, jregistry)
    got = _engine_run(ttsdb, tslo, tregistry)
    assert got == want
    states, seen, _ = got
    # the run drives real transitions: pending, firing and resolved all occur
    assert {b for _n, _a, b in seen} >= {"pending", "firing", "resolved"}


@pytest.mark.parametrize("spec", [
    {"name": ""}, {"name": "a", "kind": "nope"}, {"name": "a", "objective": 1.0},
    {"name": "a", "fast_window_s": 0}, {"name": "a", "fast_window_s": 50, "window_s": 10},
    {"name": "a", "aggregate": "max"}, {"name": "a", "kind": "up"},
    {"name": "a", "kind": "expr"}, {"name": "a", "kind": "expr", "expr": "rate(1)"},
    {"name": "a", "extra_pairs": [{"fast_window_s": 1, "bogus": 2}]},
    {"name": "a", "extra_pairs": [[1, 2]]}, {"name": "a", "extra_pairs": [[0, 2, 1]]},
    {"name": "a", "extra_pairs": [[5, 2, 1]]}, {"name": "a", "colour": "red"},
])
def test_slo_spec_validation_equals_the_jax_spec(spec):
    with pytest.raises(ValueError) as want:
        jslo.SLOSpec.from_dict(spec)
    with pytest.raises(ValueError) as got:
        tslo.SLOSpec.from_dict(spec)
    assert str(got.value) == str(want.value)
    # load_slos logs and gives [] for the same text
    assert tslo.load_slos(json.dumps([spec])) == [] == jslo.load_slos(json.dumps([spec]))


def test_error_fraction_equals_the_jax_function():
    dbs = [_fed(m[0], capacity=200, max_series=64) for m in PKGS]
    for d in SPECS:
        specs = (jslo.SLOSpec.from_dict(d), tslo.SLOSpec.from_dict(d))
        assert specs[1].to_dict() == specs[0].to_dict()
        assert specs[1].burn_pairs == specs[0].burn_pairs
        for now in (T0 + 50.0, T0 + 151.0, T0 + 239.0):
            for window in (4.0, 10.0, 60.0):
                assert tslo.error_fraction(dbs[1], specs[1], window, now) == \
                    jslo.error_fraction(dbs[0], specs[0], window, now)


def _monitor(mod, monkeypatch):
    monkeypatch.delenv("PIO_SLOS", raising=False)
    monkeypatch.delenv("PIO_TSDB_SNAPSHOT", raising=False)
    monkeypatch.delenv("PIO_ALERT_EXEC", raising=False)
    monkeypatch.delenv("PIO_ALERT_WEBHOOK", raising=False)
    mon = mod.Monitor()
    # firing rows carry exemplars of the process-default registries, which
    # other tests in this process fill differently: none here
    monkeypatch.setattr(mon, "exemplars", lambda *a, **k: [])
    return mon


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("since", "last_t", "ts")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def test_monitor_payloads_equal_the_jax_monitor(monkeypatch):
    mons = [_monitor(jmon, monkeypatch), _monitor(tmon, monkeypatch)]
    now = time.time()
    for mon, (tsdb_mod, _e, slo_mod), reg_mod in zip(mons, PKGS, (jregistry, tregistry)):
        for name, labels, v, kind, t in _stream(n=60):
            mon.tsdb.add(name, labels, v, kind, now - 130.0 + (t - T0))
        specs = [slo_mod.SLOSpec.from_dict(d) for d in SPECS[:4]]
        mon.set_slos(specs)  # nothing attached: the engine does not start
        assert mon.engine is None
    empty = [m.alerts_payload() for m in mons]
    assert empty[1] == empty[0] and empty[1]["message"].startswith("no SLO engine")
    for mon, (tsdb_mod, _e, slo_mod), reg_mod in zip(mons, PKGS, (jregistry, tregistry)):
        mon._engine = slo_mod.SLOEngine(mon.tsdb, mon._slos, interval_s=60,
                                        registry=reg_mod.MetricsRegistry(),
                                        on_transition=mon._on_transition)
        mon.raise_alert("online_drift_pause/c1", {"drift": 2.5, "threshold": 1.0})
        for k in range(4):
            mon._engine.evaluate_once(now - 30.0 + 10.0 * k)
    got = [_strip_times(m.alerts_payload()) for m in mons]
    assert got[1] == got[0]
    assert "online_drift_pause/c1" in got[1]["firing"]
    for mon in mons:
        mon.resolve_alert("online_drift_pause/c1")
    assert [_strip_times(m.alerts_payload()) for m in mons][1] == _strip_times(
        mons[0].alerts_payload())
    for qs in ({}, {"limit": "4"}, {"name": "up"}, {"name": "up", "labels": "instance:q1"},
               {"name": "http_requests_total", "labels": "status=200,server:query",
                "window_s": "50"},
               {"name": "http_requests_total", "agg": "rate", "window_s": "300"},
               {"name": "http_requests_total", "agg": "increase"},
               {"name": "p99_ms", "agg": "quantile", "q": "0.5"},
               {"name": "p99_ms", "agg": "quantile", "q": "x", "window_s": "bad"},
               {"expr": "sum by (instance) (up)"},
               {"expr": "rate(http_requests_total[1m]", "window_s": "60"},
               {"expr": "sum(increase(http_requests_total[2m]))", "window_s": "z"}):
        assert _strip_times(mons[1].tsdb_payload(qs)) == _strip_times(
            mons[0].tsdb_payload(qs)), qs


def test_snapshots_load_across_packages(tmp_path):
    """The state that crosses over: a snapshot written by either package
    loads in the other with equal series."""
    for src, dst in ((jtsdb, ttsdb), (ttsdb, jtsdb)):
        db = _fed(src, capacity=30, max_series=40)
        path = str(tmp_path / f"{src.__name__}.json")
        assert src.save_snapshot(db, path) > 0
        other = dst.TSDB(capacity=30, max_series=40)
        assert dst.load_snapshot(other, path) == db.series_count()
        assert _strip_times(other.summary()) == _strip_times(db.summary())
        for s in db.matching("http_requests_total"):
            assert other.range(s.name, s.labels_dict()) == db.range(s.name, s.labels_dict())
    bad = tmp_path / "corrupt.json"
    bad.write_text('{"v": 1, "series": [')
    assert ttsdb.load_snapshot(ttsdb.TSDB(), str(bad)) == 0
    assert ttsdb.load_snapshot(ttsdb.TSDB(), str(tmp_path / "missing.json")) == 0


def test_snapshot_writer_survives_a_monitor_restart(tmp_path, monkeypatch):
    path = tmp_path / "snap.json"
    monkeypatch.setenv("PIO_TSDB_SNAPSHOT", str(path))
    mon = tmon.Monitor()
    mon.sampler_interval_s = 3600.0
    token = mon.attach("query", tregistry.MetricsRegistry())
    mon.tsdb.add("up", {"instance": "q"}, 1.0, t=T0)
    mon.detach(token)  # the final snapshot
    again = tmon.Monitor()
    assert again.tsdb.latest_point("up", {"instance": "q"}) == (T0, 1.0)


_SINK = ("import json, os, sys; "
         "open(sys.argv[1], 'a').write(json.dumps([json.loads(sys.stdin.read()), "
         "json.loads(os.environ['PIO_ALERT_JSON'])]) + '\\n')")


def test_exec_notifier_gets_the_jax_keys(tmp_path, monkeypatch):
    outs = []
    for mod, (tsdb_mod, _e, slo_mod), reg_mod in zip((jmon, tmon), PKGS,
                                                     (jregistry, tregistry)):
        out = tmp_path / f"{mod.__name__}.jsonl"
        monkeypatch.setenv("PIO_ALERT_EXEC", f"{sys.executable} -c \"{_SINK}\" {out}")
        mon = mod.Monitor()
        assert mon.notifier.active()
        # the evidence comes from the process-default registries, which
        # other tests in this process fill differently: none here
        monkeypatch.setattr(mon, "exemplars", lambda *a, **k: [])
        now = time.time()
        db = mon.tsdb
        for k in range(12):  # every request a 500: the availability SLO burns
            db.add("http_requests_total", {"server": "query", "path": "/queries.json",
                                           "status": "500"}, 10.0 * k, "counter",
                   now - 60.0 + 5 * k)
        spec = slo_mod.SLOSpec(name="avail", objective=0.9, fast_window_s=20, window_s=40,
                               burn_threshold=1.0)
        eng = slo_mod.SLOEngine(db, [spec], interval_s=60, registry=reg_mod.MetricsRegistry(),
                                on_transition=mon._on_transition)
        eng.evaluate_once(now)
        eng.evaluate_once(now + 1)  # pending → firing: notified
        mon.raise_alert("online_drift_pause/c", {"drift": 3.0})
        mon.notifier.close(timeout=30)
        mon.resolve_alert("online_drift_pause/c")
        mon.notifier.close(timeout=30)
        rows = [json.loads(line) for line in out.read_text().splitlines()]
        for stdin_row, env_row in rows:
            assert stdin_row == env_row
        outs.append(sorted((r[0]["slo"], r[0]["transition"], tuple(sorted(r[0])))
                           for r in rows))
    assert outs[1] == outs[0]
    assert [t for _s, t, _k in outs[1]] == ["pending->firing", "firing->resolved",
                                            "inactive->firing"]


def test_last_detach_leaves_no_monitor_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TSDB_SNAPSHOT", str(tmp_path / "s.json"))
    mon = tmon.Monitor()
    mon.sampler_interval_s, mon.slo_interval_s = 5.0, 5.0
    mon.set_slos([tslo.SLOSpec(name="a")])
    tokens = [mon.attach(label, tregistry.MetricsRegistry()) for label in ("a", "b")]
    threads = [mon._sampler._thread, mon._engine._thread, mon._snapshotter._thread]
    assert all(t.is_alive() for t in threads)
    assert {t.name for t in threads} <= set(tmon.THREAD_NAMES)
    assert mon.attached_count == 2
    mon.detach(tokens[0])
    assert all(t.is_alive() for t in threads) and mon.attached_count == 1
    t0 = time.perf_counter()
    mon.detach(tokens[1])
    assert time.perf_counter() - t0 < 2.0  # an event wait, not a 5 s sleep
    assert not any(t.is_alive() for t in threads)
    assert mon._sampler is None and mon._engine is None and mon._snapshotter is None
    mon.detach(None)


def test_disabled_plane_and_the_refused_durable_tier(monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_TSDB", "0")
    mon = tmon.Monitor()
    assert mon.attach("q", tregistry.MetricsRegistry()) is None
    assert mon.tsdb_payload({}) == {"enabled": False, "series": []}
    assert mon.alerts_payload()["message"] == "monitoring disabled (PIO_TSDB=0)"
    # a set PIO_TSDB_DIR is no longer refused: it builds the durable tier
    monkeypatch.delenv("PIO_TSDB")
    monkeypatch.setenv("PIO_TSDB_DIR", str(tmp_path))
    mon = tmon.Monitor()
    assert isinstance(mon.tsdb, tmon.DurableTSDB) and mon.snapshot_path is None
    assert mon.tsdb_payload({})["durable"]["dir"] == str(tmp_path)
    mon.tsdb.stop()


def test_notifier_drops_past_its_inflight_bound():
    reg = tregistry.MetricsRegistry()
    from predictionio_tpu_torch.obs.monitor import notify

    n = notify.AlertNotifier(exec_cmd=f"{sys.executable} -c \"import time; time.sleep(1)\"",
                             registry=reg)
    for _ in range(notify.MAX_INFLIGHT + 2):
        n.notify({"slo": "x"})
    n.close(timeout=30)
    c = reg.counter("alert_notifications_total", "", ("sink", "outcome"))
    assert c.value(sink="(any)", outcome="dropped_inflight") == 2
    assert c.value(sink="exec", outcome="ok") == notify.MAX_INFLIGHT
    assert not any(t.name == "alert-notify" and t.is_alive() for t in threading.enumerate())
