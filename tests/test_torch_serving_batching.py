"""The port's query-server dispatcher and serving path on the CPU.

- The JAX package's tests/test_serving_batching.py:67-123 on the port's
  ``_BatchDispatcher``: the batching mode is validated; in continuous
  mode arrivals that trickle in while a slow batch flies join one
  assembling batch, where a short window fragments them; the retirement
  signal counts. And tests/test_resilience.py:436-509: a query whose
  waiter gave up, or whose deadline passed in the queue, never reaches
  the device and is counted as shed.
- Pipelining: a real ALS server at continuous/4, continuous/1 and
  windowed/1 gives every one of 320 concurrent queries the same answer,
  equal to the model's own predict.
- A profiler capture at depth 4 opens and closes its window on
  ``query-batcher``, which runs every batch while the window is open;
  before and after, the pool's workers run them.
- The handler: an expired ``X-PIO-Deadline`` is a 503 with
  ``Retry-After`` before any device work, counted in
  ``queries_shed_total{reason="deadline"}``; a 50 ms deadline under a
  200 ms ``dispatch.device`` delay is a 503 well before the delay ends,
  and the next query is answered; a serve failure stays with its query
  (one device call, the others answered); output blockers rewrite the
  answer and a failing sniffer does not reach the client.
- Feedback: answers posted to the port's Event Server as ``predict``
  events of ``pio_pr`` with the fields the JAX server's feedback posts
  (the JAX method posting to the same Event Server).
- ``queries_shed_total`` and the three variant families render as the
  JAX server's registry renders them; 48 clients under a short switch
  interval lose no batch or query count.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.workflow import server as jserver  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from predictionio_tpu_torch.engines.recommendation.engine import (  # noqa: E402
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    Query,
)
from predictionio_tpu_torch.resilience import faults  # noqa: E402
from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded  # noqa: E402
from predictionio_tpu_torch.workflow import server as S  # noqa: E402
from predictionio_tpu_torch.workflow.server import (  # noqa: E402
    QueryServer,
    QueryServerConfig,
    _to_jsonable,
)


@pytest.fixture(autouse=True)
def _inert_faults():
    faults.clear()
    yield
    faults.clear()


class _Hist:
    def observe(self, *a, **k):
        pass


class _Owner:
    batch_size_hist = _Hist()

    def __init__(self):
        self.shed = []

    def count_batch(self, seconds, n):
        pass

    def count_shed(self, reason):
        self.shed.append(reason)


class _Serving:
    def supplement(self, q):
        return q

    def serve(self, q, preds):
        return preds[0]


def _runtime(device_s=0.0, dispatched=None):
    class _Algo:
        serving_context = None

        def batch_predict(self, ctx, model, queries):
            if dispatched is not None:
                dispatched.extend(q for _, q in queries)
            if device_s:
                time.sleep(device_s)
            return [(i, i) for i, _ in queries]

    return types.SimpleNamespace(algorithms=[_Algo()], models=[None], serving=_Serving())


def _record_batches(d):
    sizes = []
    orig = d._run_group

    def wrap(rt, group):
        sizes.append(len(group))
        return orig(rt, group)

    d._run_group = wrap
    return sizes


def test_batching_mode_validated():
    with pytest.raises(ValueError):
        S._BatchDispatcher(_Owner(), 2.0, 64, 60.0, 1, batching="bogus")
    assert QueryServerConfig().batching == "continuous"
    assert QueryServerConfig().pipeline_depth == 4


def test_continuous_coalesces_arrivals_into_inflight_bucket():
    """With one slow batch in flight, arrivals trickling in join ONE
    assembling batch that dispatches on retirement; the windowed drain
    at a short max_window splits the same stream into fragments."""

    def run(mode, max_window_ms):
        d = S._BatchDispatcher(_Owner(), 1.0, 64, max_window_ms, 1, batching=mode)
        sizes = _record_batches(d)
        rt = _runtime(device_s=0.25)
        threads = [threading.Thread(target=lambda: d.submit(object(), rt, timeout=10))]
        threads[0].start()
        time.sleep(0.05)  # batch A is now in flight (sleeping)
        for _ in range(10):
            t = threading.Thread(target=lambda: d.submit(object(), rt, timeout=10))
            t.start()
            threads.append(t)
            time.sleep(0.015)  # trickle while A flies
        for t in threads:
            t.join()
        d.stop()
        return sizes

    cont = run("continuous", 30.0)
    # batch A (1 query) + ONE coalesced batch for the trickle (a straggler
    # batch can appear if the last arrival lands after the retirement)
    assert cont[0] == 1
    assert len(cont) <= 3, cont
    assert max(cont[1:]) >= 8, cont
    windowed = run("windowed", 30.0)
    assert len(windowed) >= len(cont), (windowed, cont)


def test_continuous_retirement_signal_counts():
    d = S._BatchDispatcher(_Owner(), 1.0, 8, 30.0, 2, batching="continuous")
    rt = _runtime()
    for _ in range(3):
        assert d.submit(object(), rt, timeout=5) == 0
    assert d._retired >= 1
    d.stop()


def test_submit_timeout_marks_cancelled_and_skips_dispatch():
    dispatched, owner = [], _Owner()
    d = S._BatchDispatcher(owner, window_ms=2.0, max_batch=8, max_window_ms=30.0,
                           pipeline_depth=1)
    try:
        rt = _runtime(device_s=0.2, dispatched=dispatched)
        # occupy the one pipeline slot so the victim stays queued
        t = threading.Thread(target=lambda: d.submit("warm", rt))
        t.start()
        time.sleep(0.05)
        with pytest.raises(DeadlineExceeded):
            d.submit("victim", rt, timeout=0.05)
        t.join()
        time.sleep(0.4)  # the drain loop passes the victim by
        assert "warm" in dispatched and "victim" not in dispatched
        assert "cancelled" in owner.shed
    finally:
        d.stop()


def test_expired_deadline_shed_at_drain_time():
    dispatched, owner = [], _Owner()
    d = S._BatchDispatcher(owner, window_ms=2.0, max_batch=8, max_window_ms=30.0,
                           pipeline_depth=1)
    try:
        rt = _runtime(device_s=0.1, dispatched=dispatched)
        t = threading.Thread(target=lambda: d.submit("warm", rt))
        t.start()
        time.sleep(0.03)
        # the waiter gets DeadlineExceeded and the device never sees the
        # query; the reason depends on who noticed first
        with pytest.raises(DeadlineExceeded):
            d.submit("expired", rt, deadline=time.monotonic() - 0.01)
        t.join()
        time.sleep(0.3)
        assert "expired" not in dispatched
        assert owner.shed and set(owner.shed) <= {"cancelled", "expired_in_queue"}
    finally:
        d.stop()


def test_serve_failure_stays_with_its_query():
    calls = []

    class Serving(_Serving):
        def serve(self, q, preds):
            if q == "bad":
                raise RuntimeError("serve broke")
            return preds[0]

    rt = _runtime(dispatched=calls)
    rt.serving = Serving()
    d = S._BatchDispatcher(_Owner(), 50.0, 8, 50.0, 1, batching="windowed")
    out = {}
    try:
        def ask(q):
            try:
                out[q] = d.submit(q, rt, timeout=5)
            except RuntimeError as e:
                out[q] = str(e)

        threads = [threading.Thread(target=ask, args=(q,)) for q in ("a", "bad", "c")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        d.stop()
    assert out["bad"] == "serve broke" and out["a"] != "serve broke"
    assert sorted(calls) == ["a", "bad", "c"]  # one device call each, no retry


# ---------------------------------------------------------------------------
# a real ALS server on the CPU
# ---------------------------------------------------------------------------

N_USERS, N_ITEMS, RANK = 40, 300, 6


def _factors(seed=9):
    rng = np.random.default_rng(seed)
    return convert.als_factors_from_numpy(
        rng.standard_normal((N_USERS, RANK)).astype(np.float32),
        rng.standard_normal((N_ITEMS, RANK)).astype(np.float32),
        [f"u{i}" for i in range(N_USERS)], [f"i{i}" for i in range(N_ITEMS)], {})


def _server(factors, **config):
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=RANK))
    srv = QueryServer(algo, ALSModel(factors, device="cpu"),
                      QueryServerConfig(ip="127.0.0.1", port=0, **config))
    srv.start()
    return srv


def _post(port, path, body, headers=None, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), e.headers


def _metrics(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        return r.read().decode()


def _bodies(n, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = {"user": f"u{int(rng.integers(N_USERS))}", "num": int(rng.integers(1, 30))}
        if rng.random() < 0.3:
            q["blacklist"] = [f"i{int(x)}" for x in rng.integers(0, N_ITEMS, 5)]
        out.append(q)
    return out


def _hammer(port, bodies, n_clients=16):
    out = {}
    lock = threading.Lock()

    def client(c):
        for n in range(c, len(bodies), n_clients):
            status, body, _ = _post(port, "/queries.json", bodies[n])
            with lock:
                out[n] = (status, body)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


def test_pipelined_answers_equal_serial_answers():
    factors, bodies = _factors(), _bodies(320)
    model = ALSModel(factors, device="cpu")
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=RANK))
    want = [_to_jsonable(algo.predict(model, Query(**q))) for q in bodies]
    for batching, depth in (("continuous", 4), ("continuous", 1), ("windowed", 1)):
        srv = _server(factors, batching=batching, pipeline_depth=depth)
        try:
            got = _hammer(srv.port, bodies)
            st = srv.status()
        finally:
            srv.stop()
        assert [got[n] for n in range(len(bodies))] == [(200, w) for w in want], batching
        assert st["requests"] == len(bodies) and 0 < st["batches"] <= len(bodies)


def test_profiler_capture_at_depth_4_runs_on_the_dispatcher(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_PROFILE_CAPTURE_DIR", str(tmp_path))
    srv = _server(_factors(), pipeline_depth=4)
    seen = []
    algo, d = srv.runtime.algorithms[0], srv.dispatcher
    orig = algo.batch_predict

    def spy(ctx, model, queries):
        seen.append((threading.current_thread().name, d._serial))
        return orig(ctx, model, queries)

    algo.batch_predict = spy
    stop = threading.Event()

    def load(c):
        n = 0
        while not stop.is_set():
            _post(srv.port, "/queries.json", {"user": f"u{(c * 7 + n) % N_USERS}", "num": 5})
            n += 1

    threads = [threading.Thread(target=load, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        status, body, _ = _post(srv.port, "/debug/profile/capture", {"seconds": 0.5})
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        srv.stop()
    assert status == 200 and body["thread"] == "query-batcher", body
    inside = [name for name, serial in seen if serial]
    outside = [name for name, serial in seen if not serial]
    assert inside and set(inside) == {"query-batcher"}
    assert outside and all(n.startswith("query-batch_") for n in outside)


def test_expired_deadline_is_shed_before_any_device_work():
    srv = _server(_factors())
    try:
        before = srv.status()["batches"]
        for _ in range(10):
            status, body, headers = _post(srv.port, "/queries.json", {"user": "u1", "num": 3},
                                          {"X-PIO-Deadline": "0"})
            assert status == 503 and headers["Retry-After"] == "1"
            assert body == {"message": "deadline expired; request shed"}
        assert srv.status()["batches"] == before
        assert 'queries_shed_total{reason="deadline"} 10' in _metrics(srv.port)
        # a deadline in the future serves
        assert _post(srv.port, "/queries.json", {"user": "u1", "num": 3},
                     {"X-PIO-Deadline": "30000"})[0] == 200
        # a slow device: the 50 ms budget is a 503 well before the 200 ms
        faults.install(faults.FaultSpec("dispatch.device", "delay", 1.0, param=0.2))
        t0 = time.perf_counter()
        status, body, headers = _post(srv.port, "/queries.json", {"user": "u2", "num": 3},
                                      {"X-PIO-Deadline": "50"})
        shed_s = time.perf_counter() - t0
        assert status == 503 and headers["Retry-After"] == "1", body
        assert shed_s < 0.2, shed_s
        status, body, _ = _post(srv.port, "/queries.json", {"user": "u2", "num": 3})
        model = ALSModel(srv.runtime.models[0].factors, device="cpu")
        want = _to_jsonable(ALSAlgorithm(ALSAlgorithmParams(rank=RANK)).predict(
            model, Query(user="u2", num=3)))
        assert status == 200 and body == want
    finally:
        srv.stop()


class _Blocker:
    plugin_type = "outputblocker"

    def process(self, query, result, ctx):
        return dict(result, stamped=query["user"])


class _Sniffer:
    plugin_type = "outputsniffer"

    def __init__(self):
        self.seen = []

    def process(self, query, result, ctx):
        self.seen.append(result)
        raise RuntimeError("sniffer broke")


def test_output_blockers_and_sniffers():
    sniffer = _Sniffer()
    srv = _server(_factors(), plugins=[_Blocker(), sniffer])
    try:
        status, body, _ = _post(srv.port, "/queries.json", {"user": "u3", "num": 2})
    finally:
        srv.stop()
    assert status == 200 and body["stamped"] == "u3" and len(body["item_scores"]) == 2
    assert sniffer.seen == [body]


def test_feedback_events_carry_the_jax_fields(tmp_path):
    storage = treg.Storage(treg.StorageConfig(
        sources={"S": treg.SourceConfig("S", "memory", {})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
    app_id = storage.get_meta_data_apps().insert(tbase.App(id=0, name="fbapp"))
    storage.get_events().init_app(app_id)
    storage.get_meta_data_access_keys().insert(
        tbase.AccessKey(key="FBKEY", app_id=app_id, events=()))
    es = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    es_port = es.start()
    url = f"http://127.0.0.1:{es_port}"
    srv = _server(_factors(), feedback=True, event_server_url=url, access_key="FBKEY")
    srv.runtime.instance = types.SimpleNamespace(id="inst-fb")
    try:
        answers = [_post(srv.port, "/queries.json", {"user": f"u{n}", "num": 2})[1]
                   for n in range(5)]
        # the JAX server's feedback method, posting the first query's answer
        jself = types.SimpleNamespace(
            config=types.SimpleNamespace(feedback=True, event_server_url=url,
                                         access_key="FBKEY"),
            runtime=types.SimpleNamespace(instance=types.SimpleNamespace(id="inst-fb")),
            _feedback_lock=threading.Lock(), _feedback_threads=set())
        jserver.QueryServer.feedback_async(jself, {"user": "u0", "num": 2}, answers[0])
        for t in list(jself._feedback_threads):
            t.join(timeout=10)
    finally:
        srv.stop()  # joins the feedback threads
        es.stop()
    events = list(storage.get_events().find(tbase.EventQuery(app_id=app_id)))

    def key(query, answer):
        return ("predict", "pio_pr", "inst-fb", "inst-fb",
                json.dumps({"query": query, "prediction": answer}, sort_keys=True))

    got = Counter((e.event, e.entity_type, e.entity_id, e.pr_id,
                   json.dumps(e.properties, sort_keys=True)) for e in events)
    want = Counter(key({"user": f"u{n}", "num": 2}, a) for n, a in enumerate(answers))
    want[key({"user": "u0", "num": 2}, answers[0])] += 1  # the JAX post's
    assert got == want


def test_counts_hold_under_a_stress():
    """48 clients against depth 4 with a short switch interval: every
    device batch the algorithm ran is booked once, and the batch sizes
    sum to the queries (a lost update of a shared count breaks either)."""
    import sys

    srv = _server(_factors(), pipeline_depth=4)
    algo = srv.runtime.algorithms[0]
    orig, ran, lock = algo.batch_predict, [], threading.Lock()

    def spy(ctx, model, queries):
        with lock:
            ran.append(len(queries))
        return orig(ctx, model, queries)

    algo.batch_predict = spy
    bodies = _bodies(480, seed=8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _hammer(srv.port, bodies, n_clients=48)
        st = srv.status()
    finally:
        sys.setswitchinterval(interval)
        srv.stop()
    assert len(got) == len(bodies) and all(s == 200 for s, _ in got.values())
    assert st["batches"] == len(ran) and sum(ran) == st["requests"] == len(bodies)
    assert srv.batch_size_hist.count == len(ran)


def test_shed_and_variant_metrics_render_as_the_jax_servers():
    """The same sheds and variant bookings on the port's server and on a
    JAX server (no dispatcher) render the same exposition lines."""
    jsrv = jserver.QueryServer(None, types.SimpleNamespace(instance=None),
                               jserver.QueryServerConfig(micro_batch=False))
    tsrv = QueryServer(ALSAlgorithm(ALSAlgorithmParams(rank=2)), None,
                       QueryServerConfig(micro_batch=False))
    for srv in (jsrv, tsrv):
        for reason in ("deadline", "deadline", "cancelled", "expired_in_queue"):
            srv.count_shed(reason)
        for variant, seconds, error in (("live", 0.004, False), ("live", 0.2, True),
                                        ("candidate", 0.03, False),
                                        ("candidate", 1.5, True)):
            srv.bookkeep_variant(variant, seconds, error)
    names = ("queries_shed_total", "variant_serve_seconds", "variant_requests_total",
             "variant_errors_total")

    def lines(text):
        return [ln for ln in text.splitlines()
                if any(ln.split("{")[0].split(" ")[0].startswith(n) or f" {n} " in ln
                       for n in names)]

    got, want = lines(tsrv.metrics.render()), lines(jsrv.metrics.render())
    jsrv.stop()  # unbridges its queue-wait span
    assert got == want and len(got) > 20
