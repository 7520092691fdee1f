"""The port's device profiler (``obs/devprof.py``) against the JAX
package's (its tests/test_devprof.py cases that have a torch meaning).

- The degradation contract: ``PIO_DEVPROF=0`` is a passthrough read at
  each call; the wrapped function runs once and its exception propagates
  once; a failed first call does not poison its signature; a call whose
  CUDA events cannot be recorded degrades to an unprofiled call counted
  in ``timing_errors``, and raises under ``PIO_DEVPROF_STRICT=1``.
- Peaks: the environment overrides, an unknown platform gives no MFU,
  the clamp at 1.0 beside the raw ratios, the H100 row keyed on the
  card's name.
- Nested calls pass through untimed; ``scale_by`` multiplies the cost;
  external seconds; the gauges render.
- ``record_batch_padding``: ``padding_summary`` and the registry's text
  equal the JAX package's after the same sequence.
- The same small dense ALS train and three served batches in each
  package (memory storage, ``run_train``, the deployed runtime's
  ``batch_predict``) list the same executables with the same calls.
- ``/debug/profile`` and ``/metrics`` on a CPU-deployed port engine
  behind the query server; the capture's 403, 409 and its bounds; the
  capture's window opens and closes on the dispatcher's thread, and the
  dispatcher's ``call`` runs between batches, propagates errors and is
  dropped when its caller stops waiting.
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from predictionio_tpu.obs import devprof as jdevprof  # noqa: E402
from predictionio_tpu.obs.registry import MetricsRegistry as JRegistry  # noqa: E402
from predictionio_tpu_torch.obs import costs, devprof  # noqa: E402
from predictionio_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_profiler(monkeypatch):
    monkeypatch.delenv("PIO_DEVPROF", raising=False)
    monkeypatch.delenv("PIO_DEVPROF_STRICT", raising=False)
    for key in ("PIO_PEAK_FLOPS", "PIO_PEAK_FLOPS_F32", "PIO_PEAK_FLOPS_INT8",
                "PIO_PEAK_HBM_BPS"):
        monkeypatch.delenv(key, raising=False)
    devprof.get_profiler().clear()
    yield
    devprof.get_profiler().clear()


def _work(args, kwargs):
    return costs.Work({"f32": 123.0}, 456.0)


# ---------------------------------------------------------------------------
# the degradation contract
# ---------------------------------------------------------------------------


def test_disabled_via_env_is_pure_passthrough(monkeypatch):
    calls = []
    wrapped = devprof.instrument("t.disabled", lambda x: calls.append(x) or x * 2)
    monkeypatch.setenv("PIO_DEVPROF", "0")
    assert wrapped(torch.ones(2)).tolist() == [2.0, 2.0]
    assert devprof.get_profiler().executable("t.disabled") is None
    monkeypatch.setenv("PIO_DEVPROF", "1")  # read at each call
    wrapped(torch.ones(2))
    assert devprof.get_profiler().executable("t.disabled")["invocations"] == 1
    assert len(calls) == 2


def test_wrapped_function_exception_propagates_once():
    calls = {"n": 0}

    def boom(x):
        calls["n"] += 1
        raise ValueError("query-level contract violation")

    wrapped = devprof.instrument("t.boom", boom, cost=_work)
    with pytest.raises(ValueError):
        wrapped(torch.zeros(1))
    assert calls["n"] == 1
    rec = devprof.get_profiler().executable("t.boom")
    assert rec["invocations"] == 0 and rec["signatures"] == 0


def test_failed_first_call_does_not_poison_signature():
    state = {"fail": True}

    def flaky(x):
        if state["fail"]:
            raise RuntimeError("transient")
        return x + 1

    wrapped = devprof.instrument("t.flaky", flaky, cost=_work)
    with pytest.raises(RuntimeError):
        wrapped(torch.zeros(3))
    state["fail"] = False
    wrapped(torch.zeros(3))
    prof = devprof.get_profiler().executable("t.flaky")
    assert prof["invocations"] == 1  # the failed call never accounted
    assert prof["flops_total"] == 123.0 and prof["cost_analysis_ok"]
    assert prof["signatures"] == 1 and prof["argument_bytes"] == 12.0


class _CudaLike:
    """Stands in for a CUDA device where there is none."""

    type = "cuda"


def test_cuda_events_that_cannot_be_recorded(monkeypatch):
    """A CUDA call whose events fail is an unprofiled call counted in
    timing_errors; strict mode raises instead of hiding it."""
    def no_events(*a, **k):
        raise RuntimeError("no CUDA events here")

    monkeypatch.setattr(devprof, "_call_device", lambda call: _CudaLike())
    monkeypatch.setattr(torch.cuda, "current_stream", no_events)
    calls = []
    wrapped = devprof.instrument("t.events", lambda x: calls.append(1) or x, cost=_work)
    assert wrapped(5) == 5
    prof = devprof.get_profiler().executable("t.events")
    assert prof["timing_errors"] == 1 and prof["invocations"] == 0
    assert "no CUDA events" in prof["last_error"]
    monkeypatch.setenv("PIO_DEVPROF_STRICT", "1")
    with pytest.raises(devprof.DevprofError, match="no CUDA events"):
        wrapped(5)
    assert len(calls) == 1  # strict mode refused before the call ran


def test_cpu_calls_time_on_the_host_clock():
    wrapped = devprof.instrument("t.cpu", lambda x: x @ x, cost=_work,
                                 dtype_of=lambda a, kw: "f32")
    for _ in range(3):
        wrapped(torch.ones((64, 64)))
    prof = devprof.get_profiler().executable("t.cpu")
    assert prof["invocations"] == 3 and prof["device_seconds"] > 0
    assert prof["dtype"] == "f32" and prof["dtypes"]["f32"]["invocations"] == 3
    assert prof["timing_errors"] == 0


# ---------------------------------------------------------------------------
# peaks
# ---------------------------------------------------------------------------


def test_platform_missing_from_peak_table_yields_no_mfu(monkeypatch):
    monkeypatch.setattr(devprof, "PEAK_TABLE", {})
    info = devprof.platform_info()
    assert info["peak_flops"] is None and info["peak_source"] == "none"
    assert devprof.mfu(1e9, 1.0) is None
    wrapped = devprof.instrument("t.nopeak", lambda x: x, cost=_work)
    wrapped(torch.ones(1))
    prof = devprof.get_profiler().executable("t.nopeak")
    assert prof["invocations"] == 1
    assert "mfu" not in prof and "mfu_raw" not in prof


def test_env_peak_override(monkeypatch):
    monkeypatch.setenv("PIO_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("PIO_PEAK_HBM_BPS", "1e11")
    info = devprof.platform_info()
    assert info["peak_flops"] == 1e12 and info["peak_source"] == "env"
    assert devprof.mfu(5e11, 1.0) == 0.5
    assert devprof.hbm_fraction(5e10, 1.0) == 0.5
    assert devprof.mfu(5e13, 1.0) == 1.0  # clamped
    assert devprof.platform_info("f32")["peak_flops"] == 1e12  # pins every type


def test_raw_ratios_show_an_overcount(monkeypatch):
    monkeypatch.setenv("PIO_PEAK_FLOPS", "1")
    monkeypatch.setenv("PIO_PEAK_HBM_BPS", "1")
    wrapped = devprof.instrument("t.over", lambda x: x,
                                 cost=lambda a, kw: costs.Work({"bf16": 1e12}, 1e12))
    wrapped(torch.ones(1))
    prof = devprof.get_profiler().executable("t.over")
    assert prof["mfu"] == 1.0 and prof["mfu_raw"] > 1.0
    assert prof["hbm_fraction_of_roof"] == 1.0 and prof["hbm_fraction_of_roof_raw"] > 1.0


def test_h100_row_keyed_on_the_card_name(monkeypatch):
    def info_for(name):
        monkeypatch.setattr(devprof, "_device_identity", lambda: ("gpu", name))
        return devprof.platform_info(), devprof.platform_info("f32"), devprof.platform_info("int8")

    base, f32, int8 = info_for("NVIDIA H100 80GB HBM3")
    assert (base["peak_flops"], base["peak_hbm_bps"], base["peak_source"]) == (
        989e12, 3.35e12, "table")
    assert (f32["peak_flops"], int8["peak_flops"]) == (67e12, 1979e12)
    other, _, _ = info_for("NVIDIA H100 PCIe")
    assert other["peak_flops"] is None and other["peak_source"] == "none"


# ---------------------------------------------------------------------------
# nesting, scaling, external seconds, gauges
# ---------------------------------------------------------------------------


def test_nested_dispatch_passes_through_untimed():
    inner = devprof.instrument("t.inner", lambda a: a * 2, cost=_work)
    outer = devprof.instrument("t.outer", lambda a: inner(a) + 1, cost=_work)
    assert outer(torch.ones(4)).tolist() == [3.0] * 4
    assert devprof.get_profiler().executable("t.inner") is None
    assert devprof.get_profiler().executable("t.outer")["flops_total"] == 123.0
    inner(torch.ones(4))  # a top-level call records
    assert devprof.get_profiler().executable("t.inner")["invocations"] == 1


def test_scale_by_iterations_multiplies_the_cost():
    def loop(x, *, iterations):
        for _ in range(iterations):
            x = x + 1
        return x

    wrapped = devprof.instrument("t.loop", loop, scale_by="iterations", cost=_work)
    wrapped(torch.zeros(2), iterations=5)
    prof = devprof.get_profiler().executable("t.loop")
    assert prof["flops_total"] == 5 * 123.0 and prof["bytes_total"] == 5 * 456.0
    assert prof["flops_per_call"] == 123.0 and prof["flops_scaled_by"] == "iterations"


def test_external_seconds_attribution():
    devprof.get_profiler().record_external("t.dispatcher", 0.25, 3)
    prof = devprof.get_profiler().executable("t.dispatcher")
    assert prof["device_seconds"] == pytest.approx(0.25)
    assert prof["invocations"] == 3


def test_devprof_gauges_render_on_registry():
    wrapped = devprof.instrument("t.gauge", lambda a: a + 1, cost=_work)
    wrapped(torch.ones((8, 8)))
    reg = MetricsRegistry()
    devprof.install_devprof_gauges(reg)
    text = reg.render()
    assert "devprof_executables 1" in text
    assert "devprof_invocations_total 1" in text
    assert "devprof_flops_total 123" in text
    assert "devprof_device_seconds_total" in text
    rep = devprof.report()
    assert rep["totals"]["invocations"] == 1
    assert rep["executables"][0]["name"] == "t.gauge"
    assert set(rep) == {"platform", "executables", "totals", "padding"}


def test_training_flops_are_obs_costs_per_iteration(monkeypatch):
    """The dense loop's count is obs.costs' iteration times the
    iterations, its nested passes untimed."""
    from predictionio_tpu_torch.models import als

    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 40, 400)
    cols = rng.integers(0, 30, 400)
    key = np.unique(rows * 30 + cols)
    params = als.ALSParams(rank=4, iterations=3)
    als.train(key // 30, key % 30, np.ones(len(key), np.float32) * 2.0, 40, 30, params,
              device="cpu")
    prof = devprof.get_profiler().executable("als.train_dense")
    per = costs.dense_train_iteration(2048, 256, 4, params.cg_iterations, "int8", True)
    assert prof["invocations"] == 1 and prof["flops_total"] == per.flops * 3
    assert prof["dtype"] == "bf16"
    assert devprof.get_profiler().executable("ops.dense_row_pass") is None


# ---------------------------------------------------------------------------
# padding accounting, against the JAX package
# ---------------------------------------------------------------------------

PADDING_SEQUENCE = [(5, 8, 8000.0), (8, 8, 1000.0), (3, 0, 0.0), (10, 8, 100.0),
                    (1, 64, 640.0), (33, 64, 0.0)]


def test_record_batch_padding_and_summary_match_jax():
    reg, jreg = MetricsRegistry(), JRegistry()
    for real, padded, flops in PADDING_SEQUENCE:
        devprof.record_batch_padding(real, padded, flops=flops, registry=reg)
        jdevprof.record_batch_padding(real, padded, flops=flops, registry=jreg)
    s = devprof.padding_summary(registry=reg)
    assert s == jdevprof.padding_summary(registry=jreg)
    assert s["batches"] == 5 and s["rows_real"] == 55 and s["rows_padded"] == 152
    assert reg.render() == jreg.render()


# ---------------------------------------------------------------------------
# a small train and three served batches in each package
# ---------------------------------------------------------------------------


def _events(event_cls):
    rng = np.random.RandomState(0)
    return [event_cls(event="rate", entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id=f"i{rng.randint(20)}",
                      properties={"rating": float(rng.randint(1, 6))})
            for u in range(12) for _ in range(15)]


def _train_and_serve(pkg, prof_module, **device):
    import importlib

    reg = importlib.import_module(f"{pkg}.data.storage.registry")
    base = importlib.import_module(f"{pkg}.data.storage.base")
    event = importlib.import_module(f"{pkg}.data.event")
    core = importlib.import_module(f"{pkg}.workflow.core")
    server = importlib.import_module(f"{pkg}.workflow.server")
    engine = importlib.import_module(f"{pkg}.engines.recommendation.engine")
    storage = reg.Storage(reg.StorageConfig(
        sources={"MEM": reg.SourceConfig("MEM", "memory", {})},
        repositories={"METADATA": "MEM", "EVENTDATA": "MEM", "MODELDATA": "MEM"}))
    app_id = storage.get_meta_data_apps().insert(base.App(0, "profapp"))
    events = storage.get_events()
    events.init_app(app_id)
    events.insert_batch(_events(event.Event), app_id)
    variant = {"id": "profrec",
               "engineFactory": f"{pkg}.engines.recommendation.RecommendationEngine",
               "datasource": {"params": {"app_name": "profapp"}},
               "algorithms": [{"name": "als", "params": {"rank": 4, "num_iterations": 3}}]}
    prof_module.get_profiler().clear()
    core.run_train(storage, variant, **device)
    runtime = server.latest_completed_runtime(storage, "profrec", "0", "profrec", **device)
    algo, model = runtime.algorithms[0], runtime.models[0]
    for b in (1, 3, 5):
        algo.batch_predict(None, model, [(i, engine.Query(user=f"u{i}", num=4))
                                         for i in range(b)])
    rep = prof_module.report()
    return {r["name"]: r["invocations"] for r in rep["executables"]}, rep["padding"]


def test_same_train_and_serve_lists_the_same_executables(monkeypatch):
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    got, got_pad = _train_and_serve("predictionio_tpu_torch", devprof, device="cpu")
    want, want_pad = _train_and_serve("predictionio_tpu", jdevprof)
    jdevprof.get_profiler().clear()
    assert got == want
    assert got == {"ops.densify": 1, "als.train_dense": 1, "als.recommend_serving": 9}
    # warmup's ladder and the three batches: the same padding rows
    for key in ("batches", "rows_real", "rows_padded", "mean_padding_ratio"):
        assert got_pad[key] == want_pad[key]


# ---------------------------------------------------------------------------
# the query server: /debug/profile, /metrics and the capture
# ---------------------------------------------------------------------------


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read().decode())


@pytest.fixture
def served():
    """A CPU-deployed port ALS engine behind the query server."""
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        ALSModel,
    )
    from predictionio_tpu_torch.workflow.server import QueryServer, QueryServerConfig

    rng = np.random.default_rng(1)
    factors = convert.als_factors_from_numpy(
        rng.standard_normal((12, 4)).astype(np.float32),
        rng.standard_normal((20, 4)).astype(np.float32),
        [f"u{i}" for i in range(12)], [f"i{i}" for i in range(20)], {})
    srv = QueryServer(ALSAlgorithm(ALSAlgorithmParams(rank=4)),
                      ALSModel(factors, device="cpu"),
                      QueryServerConfig(ip="127.0.0.1", port=0))
    port = srv.start()
    yield port
    srv.stop()


def test_query_server_debug_profile_acceptance(served, monkeypatch):
    threads = [threading.Thread(target=_post, args=(served, "/queries.json",
                                                    {"user": f"u{u % 12}", "num": 5}))
               for u in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rep = json.loads(_get(served, "/debug/profile"))
    assert rep["platform"]["platform"] == "cpu" and rep["platform"]["peak_source"] == "table"
    execs = [e for e in rep["executables"] if e["flops_total"] > 0]
    assert [e["name"] for e in execs] == ["als.recommend_serving"]
    for e in execs:
        assert 0 < e["mfu"] <= 1.0 and e["dtype"] == "f32" and e["memory_analysis_ok"] is False
    assert rep["padding"]["batches"] > 0
    assert rep["padding"]["rows_padded"] >= rep["padding"]["rows_real"]
    text = _get(served, "/metrics")
    assert "batch_padding_ratio_count" in text
    assert "devprof_invocations_total" in text
    assert "cuda_memory_allocated_bytes 0" in text  # no CUDA in this process

    monkeypatch.delenv("PIO_PROFILE_CAPTURE_DIR", raising=False)
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(served, "/debug/profile/capture", {})
    assert exc.value.code == 403


def test_capture_bounds_and_serializes(served, monkeypatch, tmp_path):
    with pytest.raises(ValueError):
        devprof.capture_trace(str(tmp_path), 0.0)
    with pytest.raises(ValueError):
        devprof.capture_trace(str(tmp_path), 61.0)
    monkeypatch.setenv("PIO_PROFILE_CAPTURE_DIR", str(tmp_path))
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(served, "/debug/profile/capture", {"seconds": 0})
    assert exc.value.code == 400
    assert devprof._capture_lock.acquire(blocking=False)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(served, "/debug/profile/capture", {"seconds": 0.2})
        assert exc.value.code == 409
    finally:
        devprof._capture_lock.release()
    status, body = _post(served, "/debug/profile/capture", {"seconds": 0.2})
    assert status == 200 and body["seconds"] == 0.2
    assert body["trace"].startswith(str(tmp_path)) and json.load(open(body["trace"]))
    assert body["device_events"] == 0  # CPU only here


def test_capture_window_runs_on_the_dispatcher_thread(served, monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_PROFILE_CAPTURE_DIR", str(tmp_path))
    status, body = _post(served, "/debug/profile/capture", {"seconds": 0.2})
    assert status == 200 and body["thread"] == "query-batcher"
    # called directly, without a thread to run on, it opens on the caller's
    body = devprof.capture_trace(str(tmp_path / "direct"), 0.1)
    assert body["thread"] == threading.current_thread().name


def test_dispatcher_call_between_batches():
    from predictionio_tpu_torch.workflow.server import _BatchDispatcher

    seen = []

    class Owner:
        batch_size_hist = type("H", (), {"observe": lambda self, n: None})()

        def predict_batch(self, queries, runtime):
            seen.append(("batch", threading.current_thread().name, list(queries)))
            return [q * 2 for q in queries]

        def count_batch(self, seconds, n):
            pass

    d = _BatchDispatcher(Owner(), window_ms=1.0, max_batch=8, max_window_ms=1.0)
    try:
        assert d.submit(3, runtime=None) == 6
        assert d.call(lambda: threading.current_thread().name) == "query-batcher"
        with pytest.raises(KeyError):
            d.call(lambda: {}["missing"])
        # a call that waits keeps the thread; the next one's caller gives up
        # and it never runs
        gate, ran = threading.Event(), []
        holder = threading.Thread(target=d.call, args=(gate.wait,))
        holder.start()
        with pytest.raises(TimeoutError):
            d.call(lambda: ran.append(1), timeout=0.05)
        gate.set()
        holder.join(timeout=5)
        assert d.submit(4, runtime=None) == 8 and ran == []
        assert [s[1] for s in seen] == ["query-batcher", "query-batcher"]
    finally:
        d.stop()


def test_capture_refuses_without_torch(monkeypatch, tmp_path):
    monkeypatch.delitem(sys.modules, "torch")
    with pytest.raises(RuntimeError, match="torch is not loaded"):
        devprof.capture_trace(str(tmp_path), 0.5)
    assert devprof.platform_info()["platform"] is None
