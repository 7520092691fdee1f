"""The port's spans (``obs/spans.py``) and the spans of its train and
query paths, against the JAX package's recorder.

- The recorder: nesting (trace and parent ids), an explicit remote
  parent, an exception marking the span errored; tail retention at
  sample rates 0 and 1 with errored and slow traces always kept, the
  cap on retained traces; ``arm_capture`` keeping a sampled-out batch;
  ``perfetto_export``; ``bridge``/``unbridge`` into a registry
  histogram. The same sequence of spans in both packages' recorders
  gives the same retained summaries (ids and times aside).
- ``run_train`` records the root ``train`` span and its stage spans,
  ``train_stage_seconds{stage}`` from them and ``train_runs_total``,
  as the JAX package's does.
- A query through the port's server: its trace holds
  ``server.request`` and the dispatcher's ``batch.queue_wait``,
  ``batch.assemble`` and ``batch.device_dispatch``; the queue-wait
  bridge feeds ``batch_queue_wait_seconds`` while the server runs.
"""

import json
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.obs import spans as jspans  # noqa: E402
from predictionio_tpu.obs import tracing as jtracing  # noqa: E402
from predictionio_tpu_torch.obs import get_default_registry, spans, tracing  # noqa: E402
from predictionio_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402


def test_nested_spans_share_the_trace_and_link_parents():
    rec = spans.SpanRecorder(sample_rate=1.0)
    with rec.span("outer", server="t") as outer:
        assert tracing.current_trace_id() == outer.trace_id
        with rec.span("inner", k=1) as inner:
            assert spans.current_span_id() == inner.span_id
    assert tracing.current_trace_id() is None and spans.current_span_id() is None
    got = rec.get_trace(outer.trace_id)
    assert [s.name for s in got] == ["outer", "inner"]
    assert got[1].parent_span_id == outer.span_id and got[0].parent_span_id is None
    assert got[1].attrs == {"k": 1}
    with rec.span("remote", trace_id="abc", parent_span_id="feed") as sp:
        pass
    assert sp.trace_id == "abc" and rec.get_trace("abc")[0].parent_span_id == "feed"


def test_an_exception_marks_the_span_errored_and_keeps_its_trace():
    rec = spans.SpanRecorder(sample_rate=0.0)
    with pytest.raises(KeyError):
        with rec.span("fails") as sp:
            raise KeyError("x")
    assert sp.error and rec.summaries()[0]["kept"] == "error"


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_tail_retention(rate):
    rec = spans.SpanRecorder(sample_rate=rate, slow_ms=50.0, max_traces=8)
    with rec.span("boring"):
        pass
    slow = spans.Span(trace_id="slow", span_id="s1", name="slow", duration=0.2)
    rec.record(slow, finalize=True)
    err = spans.Span(trace_id="err", span_id="e1", name="err", error=True)
    rec.record(err, finalize=True)
    kept = {s["root"]: s["kept"] for s in rec.summaries(limit=0)}
    assert kept.pop("slow") == "slow" and kept.pop("err") == "error"
    assert kept == ({"boring": "sampled"} if rate else {})
    for n in range(20):
        rec.record(spans.Span(trace_id=f"t{n}", span_id=f"x{n}", name="e", error=True),
                   finalize=True)
    assert len(rec.summaries(limit=0)) == 8  # the oldest evicted past the cap


def test_arm_capture_keeps_a_sampled_out_batch():
    rec = spans.SpanRecorder(sample_rate=0.0)
    cap = rec.arm_capture(1)
    assert rec.consume_capture() == cap and rec.consume_capture() is None
    rec.force_keep("q1", cap)
    rec.record(spans.Span(trace_id="q1", span_id="a", name="server.request"),
               finalize=True)
    status = rec.capture_status(cap)
    assert status["done"] and [t["trace_id"] for t in status["traces"]] == ["q1"]
    assert status["traces"][0]["kept"] == f"capture:{cap}"
    assert rec.capture_status("nope") is None


def test_perfetto_export():
    rec = spans.SpanRecorder(sample_rate=1.0)
    with rec.span("root", server="query") as root:
        with rec.span("child"):
            pass
    export = rec.perfetto_export(root.trace_id)
    meta = [e for e in export["traceEvents"] if e["ph"] == "M"]
    events = [e for e in export["traceEvents"] if e["ph"] == "X"]
    assert [m["args"]["name"] for m in meta] == ["query", "child"]
    assert [(e["name"], e["tid"]) for e in events] == [("root", 0), ("child", 1)]
    assert events[1]["args"]["parent_span_id"] == root.span_id
    assert export["displayTimeUnit"] == "ms"
    assert rec.perfetto_export("missing")["traceEvents"] == []


def test_bridge_feeds_a_histogram_until_unbridged():
    rec = spans.SpanRecorder(sample_rate=0.0)
    hist = MetricsRegistry().histogram("stage_seconds", "", ())
    observe = lambda sp: hist.observe(sp.duration)  # noqa: E731
    rec.bridge("stage", observe)
    for _ in range(3):
        with rec.span("stage"):
            pass
    rec.unbridge("stage", lambda sp: None)  # another callback: kept
    with rec.span("stage"):
        pass
    rec.unbridge("stage", observe)
    with rec.span("stage"):
        pass
    assert hist.count == 4


def _scripted(mod_spans, mod_tracing):
    """One sequence of spans into a fresh recorder of either package."""
    rec = mod_spans.SpanRecorder(sample_rate=0.0, slow_ms=100.0, max_traces=4)
    with mod_tracing.trace_context("t-ok"):
        with rec.span("server.request", server="query", path="/q"):
            with rec.span("batch.device_dispatch", batch_size=3):
                pass
    with mod_tracing.trace_context("t-err"):
        with pytest.raises(RuntimeError):
            with rec.span("server.request", server="query", path="/q"):
                raise RuntimeError
    rec.record(mod_spans.Span(trace_id="t-slow", span_id="s", name="train",
                              duration=0.5, attrs={"server": "train"}), finalize=True)
    cap = rec.arm_capture(1)
    rec.consume_capture()
    rec.force_keep("t-cap", cap)
    rec.record(mod_spans.Span(trace_id="t-cap", span_id="c", name="server.request"),
               finalize=True)
    drop = ("start", "duration_ms", "kept")
    return [{k: v for k, v in s.items() if k not in drop} for s in rec.summaries(limit=0)]


def test_retained_summaries_match_jax():
    assert _scripted(spans, tracing) == _scripted(jspans, jtracing)


# ---------------------------------------------------------------------------
# the train's spans
# ---------------------------------------------------------------------------


def _seeded_storage():
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import (
        SourceConfig,
        Storage,
        StorageConfig,
    )

    storage = Storage(StorageConfig(
        sources={"MEM": SourceConfig("MEM", "memory", {})},
        repositories={"METADATA": "MEM", "EVENTDATA": "MEM", "MODELDATA": "MEM"}))
    app_id = storage.get_meta_data_apps().insert(App(0, "spanapp"))
    events = storage.get_events()
    events.init_app(app_id)
    rng = np.random.RandomState(1)
    events.insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{rng.randint(15)}",
              properties={"rating": float(rng.randint(1, 6))})
        for u in range(10) for _ in range(8)], app_id)
    return storage


def test_run_train_records_its_spans_and_counters():
    from predictionio_tpu_torch.workflow.core import run_train, stage_timings

    recorder = spans.get_default_recorder()
    rate, recorder.sample_rate = recorder.sample_rate, 1.0
    reg = get_default_registry()
    stage_hist = reg.histogram(
        "train_stage_seconds",
        "train workflow stage durations (read/prepare/train/persist)", ("stage",))
    before = {s: stage_hist.count_of(stage=s) for s in ("read", "prepare", "train", "persist")}
    runs = reg.counter("train_runs_total", "train workflows by final status", ("status",))
    completed = runs.value(status="COMPLETED")
    try:
        inst = run_train(_seeded_storage(), {
            "id": "spans", "engineFactory":
                "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
            "datasource": {"params": {"app_name": "spanapp"}},
            "algorithms": [{"name": "als", "params": {"rank": 3, "num_iterations": 2}}],
        }, device="cpu")
    finally:
        recorder.sample_rate = rate
    assert inst.status == "COMPLETED"
    [tree] = [t for t in (recorder.get_trace(s["trace_id"])
                          for s in recorder.summaries(limit=0) if s["root"] == "train")
              if any(sp.attrs.get("instance_id") == inst.id for sp in t)]
    by_name = {s.name: s for s in tree}
    assert {"train", "train.read", "train.prepare", "train.train", "train.algorithm",
            "train.persist"} <= set(by_name)
    root = by_name["train"]
    assert root.attrs["instance_id"] == inst.id and root.parent_span_id is None
    for stage in ("train.read", "train.prepare", "train.train", "train.persist"):
        assert by_name[stage].parent_span_id == root.span_id
    assert by_name["train.algorithm"].parent_span_id == by_name["train.train"].span_id
    assert by_name["train.algorithm"].attrs["algorithm"] == "ALSAlgorithm"
    assert by_name["train.train"].attrs["device_seconds"] > 0  # the profiled loop
    timings = stage_timings(inst)
    for stage in ("read", "prepare", "train", "persist"):
        assert stage_hist.count_of(stage=stage) == before[stage] + 1
        assert timings[stage] == round(by_name[f"train.{stage}"].duration, 4)
    assert runs.value(status="COMPLETED") == completed + 1


# ---------------------------------------------------------------------------
# a query's spans through the port's server
# ---------------------------------------------------------------------------


def test_query_trace_holds_the_request_and_its_batch(monkeypatch):
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        ALSModel,
    )
    from predictionio_tpu_torch.workflow.server import QueryServer, QueryServerConfig

    rng = np.random.default_rng(2)
    factors = convert.als_factors_from_numpy(
        rng.standard_normal((6, 3)).astype(np.float32),
        rng.standard_normal((9, 3)).astype(np.float32),
        [f"u{i}" for i in range(6)], [f"i{i}" for i in range(9)], {})
    recorder = spans.get_default_recorder()
    monkeypatch.setattr(recorder, "sample_rate", 1.0)
    srv = QueryServer(ALSAlgorithm(ALSAlgorithmParams(rank=3)), ALSModel(factors, device="cpu"),
                      QueryServerConfig(ip="127.0.0.1", port=0))
    port = srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json", method="POST",
            data=json.dumps({"user": "u1", "num": 3}).encode(),
            headers={"Content-Type": "application/json", "X-Request-ID": "span-test-1",
                     "X-Parent-Span": "caller00"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.headers["X-Request-ID"] == "span-test-1"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/traces?trace_id=span-test-1", timeout=10) as r:
            got = json.loads(r.read())["spans"]
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10
                                      ).read().decode()
    finally:
        srv.stop()
    by_name = {s["name"]: s for s in got}
    assert set(by_name) == {"server.request", "batch.queue_wait", "batch.assemble",
                            "batch.device_dispatch"}
    request = by_name["server.request"]
    assert request["parent_span_id"] == "caller00"
    assert request["attrs"]["path"] == "/queries.json" and request["attrs"]["status"] == 200
    for name in ("batch.queue_wait", "batch.assemble", "batch.device_dispatch"):
        assert by_name[name]["parent_span_id"] == request["span_id"]
        assert by_name[name]["attrs"] == {"server": "query", "batch_size": 1}
    assert "batch_queue_wait_seconds_count 1" in text
    assert "batch_size_count 1" in text
    # the stopped server's bridge is gone: a queue-wait span feeds nothing
    assert "batch.queue_wait" not in recorder._bridges
