"""The port's multi-tenant query server end to end on the CPU, against
the JAX package's.

The 13 cases of the JAX package's tests/test_tenancy_e2e.py on the
port's `QueryServer` with a `TenantMux`: routing by path and by the
``X-PIO-Tenant`` header (an unknown tenant a 404, the untenanted route
still serving, ``GET /tenants``), the 429 of a quota kept apart from the
deadline 503, an evicted model reloaded transparently, a hog that
cannot starve a good tenant at the dispatcher, the tenant fault scope, a
per-tenant rollout and its abort, a server-scope canary re-adopted after
a restart, the default scope still flipping a live version to canary,
the per-query fallback charging device seconds, a tenant resume that
survives another tenant's promote of the shared version, a resume that
declines a rolled-back version and retires its record, a recreate
mid-canary that keeps the pinned baseline, and the deadline floor.

The JAX side trains the JAX test's engine on the CPU (``run_train``) and
serves it as its own tests do; the port serves the same factors
(``convert.load_jax_als_blob``, persisted as a port instance), so each
tenant's answers equal the JAX server's: the same items in the same
order, scores within 1e-6 (relative and absolute). The
resume cases call the mux's sync pass before the mux's thread starts
and wait on events, never on sleeps.
"""

import datetime as dt
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App as JApp  # noqa: E402
from predictionio_tpu.data.storage.registry import SourceConfig as JSourceConfig  # noqa: E402
from predictionio_tpu.data.storage.registry import Storage as JStorage  # noqa: E402
from predictionio_tpu.data.storage.registry import StorageConfig as JStorageConfig  # noqa: E402
from predictionio_tpu.obs.registry import MetricsRegistry as JRegistry  # noqa: E402
from predictionio_tpu.tenancy import Tenant as JTenant  # noqa: E402
from predictionio_tpu.tenancy import TenantMux as JTenantMux  # noqa: E402
from predictionio_tpu.tenancy import TenantStore as JTenantStore  # noqa: E402
from predictionio_tpu.workflow import core as jcore  # noqa: E402
from predictionio_tpu.workflow import server as jserver  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.controller import resolve_engine, serialize_models  # noqa: E402
from predictionio_tpu_torch.controller.params import params_to_json  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.storage.base import EngineInstance, Model  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.deploy.registry import ModelRegistry  # noqa: E402
from predictionio_tpu_torch.engines.recommendation.engine import (  # noqa: E402
    ALSModel,
    RecommendationEngine,
)
from predictionio_tpu_torch.resilience import faults  # noqa: E402
from predictionio_tpu_torch.tenancy import Tenant, TenantMux, TenantStore  # noqa: E402
from predictionio_tpu_torch.workflow.server import (  # noqa: E402
    QueryServer,
    QueryServerConfig,
    _BatchDispatcher,
    _Pending,
    latest_completed_runtime,
)

PORT_FACTORY = "predictionio_tpu_torch.engines.recommendation.RecommendationEngine"
JAX_FACTORY = "predictionio_tpu.engines.recommendation.RecommendationEngine"


def _variant(engine_id, factory, rank=8):
    return {"id": engine_id, "engineFactory": factory,
            "datasource": {"params": {"app_name": "mtapp"}},
            "algorithms": [{"name": "als", "params": {"rank": rank, "num_iterations": 6}}]}


def _config(path):
    return ({"SQL": ("sqlite", {"PATH": str(path / "pio.db")}),
             "FS": ("localfs", {"PATH": str(path)})},
            {"METADATA": "SQL", "EVENTDATA": "SQL", "MODELDATA": "FS"})


def _jax_storage(path):
    path.mkdir(parents=True, exist_ok=True)
    sources, repos = _config(path)
    return JStorage(JStorageConfig(
        sources={n: JSourceConfig(n, t, s) for n, (t, s) in sources.items()},
        repositories=repos))


def _storage(path):
    path.mkdir(parents=True, exist_ok=True)
    sources, repos = _config(path)
    return Storage(StorageConfig(
        sources={n: SourceConfig(n, t, s) for n, (t, s) in sources.items()},
        repositories=repos))


def _seed_jax(storage, n_users=8):
    """The JAX test's events."""
    app_id = storage.get_meta_data_apps().insert(JApp(id=0, name="mtapp"))
    events = storage.get_events()
    events.init_app(app_id)
    rng = np.random.RandomState(0)
    batch = []
    for u in range(n_users):
        for _ in range(20):
            i = rng.randint(0, 5) + (u % 2) * 5
            batch.append(JEvent(event="rate", entity_type="user", entity_id=f"u{u}",
                                target_entity_type="item", target_entity_id=f"i{i}",
                                properties={"rating": 5.0}))
    events.insert_batch(batch, app_id)


def _persist_factors(storage, engine_id, factors, rank):
    """A COMPLETED port instance of `engine_id` holding `factors`, persisted
    as ``run_train`` persists one; no train runs."""
    engine = resolve_engine(RecommendationEngine)
    ep = engine.params_from_variant_json(_variant(engine_id, PORT_FACTORY, rank))

    def stage(pair):
        name, params = pair
        return json.dumps({"name": name, "params": json.loads(params_to_json(params))},
                          sort_keys=True)

    now = dt.datetime.now(dt.timezone.utc)
    inst = EngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now, engine_id=engine_id,
        engine_version="0", engine_variant=engine_id, engine_factory=PORT_FACTORY,
        data_source_params=stage(ep.data_source_params),
        preparator_params=stage(ep.preparator_params),
        algorithms_params=json.dumps([{"name": n, "params": json.loads(params_to_json(p))}
                                      for n, p in ep.algorithm_params_list]),
        serving_params=stage(ep.serving_params))
    inst.id = storage.get_meta_data_engine_instances().insert(inst)
    ctx = RuntimeContext(storage=storage, device="cpu")
    persisted = engine.make_serializable_models(ctx, [ALSModel(factors, device="cpu")], ep,
                                                inst.id)
    storage.get_model_data_models().insert(Model(id=inst.id, models=serialize_models(persisted)))
    return inst


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The JAX storage with the JAX test's engine trained on the CPU (and
    a rank-4 second engine), and a port storage holding the same factors
    as port instances of the same engine ids."""
    tmp = tmp_path_factory.mktemp("tenancy_e2e")
    jst = _jax_storage(tmp / "jax")
    _seed_jax(jst)
    for engine_id, rank in (("mtsrv", 8), ("mtsml", 4)):
        jcore.run_train(jst, _variant(engine_id, JAX_FACTORY, rank))
    st = _storage(tmp / "port")
    for engine_id, rank in (("mtsrv", 8), ("mtsml", 4)):
        jm = jserver.latest_completed_runtime(jst, engine_id, "0", engine_id).models[0]
        _persist_factors(st, engine_id, convert.load_jax_als_blob(jm.factors.to_bytes()), rank)
    return st, jst


@pytest.fixture(scope="module")
def mt_storage(stores):
    return stores[0]


@pytest.fixture(autouse=True)
def _inert_faults():
    faults.clear()
    yield
    faults.clear()


def _mux(storage, metrics, cache_capacity=2):
    return TenantMux(storage, metrics=metrics, cache_capacity=cache_capacity, refresh_s=0.0,
                     sync_s=3600.0, device="cpu")


def _attach(srv, mux):
    """Attach `mux` and wait for its thread's first sync pass to end (an
    event, so that the test's own sync calls never race it)."""
    first = threading.Event()
    sync = mux.sync

    def once():
        try:
            sync()
        finally:
            first.set()

    mux.sync = once
    srv.attach_tenancy(mux)
    assert first.wait(60), "the mux's first sync pass did not end"
    mux.sync = sync


def _make_server(storage, cache_capacity=2, attach=True):
    runtime = latest_completed_runtime(storage, "mtsrv", "0", "mtsrv", device="cpu")
    srv = QueryServer(runtime=runtime, storage=storage,
                      config=QueryServerConfig(ip="127.0.0.1", port=0))
    mux = _mux(storage, srv.metrics, cache_capacity)
    if attach:
        _attach(srv, mux)
    return srv, mux


@pytest.fixture()
def served(mt_storage):
    store = TenantStore(mt_storage)
    store.upsert(Tenant(id="t1", engine_id="mtsrv"))
    store.upsert(Tenant(id="t2", engine_id="mtsrv"))
    srv, mux = _make_server(mt_storage)
    port = srv.start()
    yield mt_storage, srv, mux, port
    srv.stop()


def post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read().decode() or "null")


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read().decode())


# ---------------------------------------------------------------------------
# routing and the control surface
# ---------------------------------------------------------------------------


QUERIES = [({"user": "u0", "num": 3}, "t1", "path"), ({"user": "u1", "num": 2}, "t2", "header"),
           ({"user": "u3", "num": 10}, "t3", "path"), ({"user": "u4", "num": 5}, "t3", "header"),
           ({"user": "u5", "num": 4, "blacklist": ["i1", "i6"]}, "t1", "header"),
           ({"user": "nobody", "num": 4}, "t3", "path")]


def _ask(port, body, tenant, form):
    if form == "path":
        return post(port, f"/tenants/{tenant}/queries.json", body)
    return post(port, "/queries.json", body, headers={"X-PIO-Tenant": tenant})


def _same_answer(got, want):
    """The same items in the same order, scores within 1e-6 (relative, and
    absolute for scores near 0: the f32 dot products of torch and XLA on
    the CPU may round the last bits apart)."""
    assert [s["item"] for s in got["item_scores"]] == [s["item"] for s in want["item_scores"]]
    np.testing.assert_allclose([s["score"] for s in got["item_scores"]],
                               [s["score"] for s in want["item_scores"]], rtol=1e-6,
                               atol=1e-6)


def test_tenant_routing_paths_and_header(served, stores):
    storage, srv, mux, port = served
    _, jst = stores
    TenantStore(storage).upsert(Tenant(id="t3", engine_id="mtsml"))
    status, _, body = post(port, "/tenants/t1/queries.json", {"user": "u0", "num": 3})
    assert status == 200 and len(body["item_scores"]) == 3
    status, _, body = post(port, "/queries.json", {"user": "u1", "num": 2},
                           headers={"X-PIO-Tenant": "t2"})
    assert status == 200 and len(body["item_scores"]) == 2
    assert post(port, "/tenants/ghost/queries.json", {"user": "u0"})[0] == 404
    status, _, body = post(port, "/queries.json", {"user": "u0", "num": 2})
    assert status == 200 and len(body["item_scores"]) == 2
    status, body = get(port, "/tenants")
    assert status == 200 and {"t1", "t2"} <= set(body["tenants"])
    assert body["cache"]["resident"] >= 1
    status, body = get(port, "/tenants/t1")
    assert status == 200 and body["resident"]
    assert srv.metrics.histogram("tenant_serve_seconds", labelnames=("tenant",)).count_of(
        tenant="t1") >= 1
    # each tenant's answers are the JAX server's over the same factors
    jstore = JTenantStore(jst)
    for tid, engine_id in (("t1", "mtsrv"), ("t2", "mtsrv"), ("t3", "mtsml")):
        jstore.upsert(JTenant(id=tid, engine_id=engine_id))
    jsrv = jserver.QueryServer(jst, jserver.latest_completed_runtime(jst, "mtsrv", "0", "mtsrv"),
                               jserver.QueryServerConfig(ip="127.0.0.1", port=0))
    jsrv.attach_tenancy(JTenantMux(jst, metrics=JRegistry(), cache_capacity=2, refresh_s=0.0,
                                   sync_s=3600.0))
    jport = jsrv.start()
    try:
        for body, tenant, form in QUERIES:
            got, want = _ask(port, body, tenant, form), _ask(jport, body, tenant, form)
            assert got[0] == want[0] == 200, (body, tenant)
            _same_answer(got[2], want[2])
        assert post(port, "/tenants/t3/queries.json", {"user": "u3", "num": 3})[2] != post(
            port, "/tenants/t1/queries.json", {"user": "u3", "num": 3})[2]
    finally:
        jsrv.stop()


def test_quota_429_distinct_from_deadline_503(served):
    storage, srv, mux, port = served
    TenantStore(storage).upsert(Tenant(id="tq", engine_id="mtsrv", qps=1.0))
    mux.cache.acquire_and_release(mux.tenant("tq"))  # a warm model: no load in the window
    assert post(port, "/tenants/tq/queries.json", {"user": "u0", "num": 1})[0] == 200
    status, headers, body = post(port, "/tenants/tq/queries.json", {"user": "u0", "num": 1})
    assert status == 429
    assert int(headers.get("Retry-After", "0")) >= 1 and "quota" in body["message"]
    status, headers, _ = post(port, "/tenants/t1/queries.json", {"user": "u0"},
                              headers={"X-PIO-Deadline": "0"})
    assert status == 503 and headers.get("Retry-After") == "1"
    assert srv.metrics.counter("tenant_quota_rejected_total",
                               labelnames=("tenant", "resource")).value(
        tenant="tq", resource="qps") >= 1


def test_evicted_model_transparently_reloads(mt_storage):
    TenantStore(mt_storage).upsert(Tenant(id="t1", engine_id="mtsrv"))
    TenantStore(mt_storage).upsert(Tenant(id="t2", engine_id="mtsrv"))
    srv, mux = _make_server(mt_storage, cache_capacity=1)
    port = srv.start()
    try:
        answers = []
        for tid, user in (("t1", "u0"), ("t2", "u1"), ("t1", "u0"), ("t1", "u0")):
            status, _, body = post(port, f"/tenants/{tid}/queries.json",
                                   {"user": user, "num": 1})
            assert status == 200
            answers.append(body)
        assert answers[0] == answers[2] == answers[3]  # reloaded: the same answer
        s = mux.cache.stats()
        assert s["capacity"] == 1 and s["evictions"] >= 2
        assert s["reloads"] >= 1 and s["hits"] >= 1
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# fairness under a hog, at the dispatcher; the fallback's charges
# ---------------------------------------------------------------------------


class _Hist:
    def observe(self, *a, **k):
        pass


class _Serving:
    def supplement(self, q):
        return q

    def serve(self, q, preds):
        return preds[0]


class _RT:  # one runtime object a tenant, as the model cache gives
    def __init__(self, algo):
        self.algorithms = [algo]
        self.models = [None]
        self.serving = _Serving()


class _Owner:
    batch_size_hist = _Hist()

    def __init__(self):
        self.charges: dict = {}

    def count_batch(self, *_a):
        pass

    def tenant_weight(self, _t):
        return 1.0

    def charge_device_seconds(self, tid, s):
        self.charges[tid] = self.charges.get(tid, 0.0) + s


def test_hog_tenant_cannot_starve_good_tenant_dispatch():
    """80 queued hog queries and 8 of a good tenant on one dispatcher:
    under DRR every good answer lands before the hog's median answer
    (under a FIFO they would land after the hog's last)."""
    from concurrent.futures import Future

    class _SlowAlgo:
        serving_context = None

        def batch_predict(self, ctx, model, queries):
            time.sleep(0.02)  # the device is busy 20 ms a batch
            return [(i, q) for i, q in queries]

    hog_rt, good_rt = _RT(_SlowAlgo()), _RT(_SlowAlgo())
    disp = _BatchDispatcher(_Owner(), window_ms=2.0, max_batch=8, max_window_ms=20.0,
                            pipeline_depth=1)
    try:
        done: dict = {}
        t_start = time.perf_counter()

        def enqueue(tenant, rt, i):
            fut: Future = Future()
            fut.add_done_callback(lambda _f, k=(tenant, i): done.setdefault(
                k, time.perf_counter() - t_start))
            disp._queue.put(_Pending(f"{tenant}-{i}", rt, fut, time.perf_counter(),
                                     (None, None), None, tenant))
            return fut

        hog = [enqueue("hog", hog_rt, i) for i in range(80)]
        good = [enqueue("good", good_rt, i) for i in range(8)]
        for f in hog + good:
            f.result(timeout=60)
        good_last = max(done[("good", i)] for i in range(8))
        hog_median = sorted(done[("hog", i)] for i in range(80))[40]
        assert good_last < hog_median, (
            f"good tenant finished at {good_last:.3f}s, after the hog's median "
            f"{hog_median:.3f}s — starved")
    finally:
        disp.stop()


def test_fallback_path_still_charges_device_seconds():
    """A tenant whose queries fail every batch (the port's per-query
    retry is a one-query batch) is still charged device seconds for the
    retries, on the host clock on the CPU."""
    from concurrent.futures import Future

    class _PoisonAlgo:
        serving_context = None

        def batch_predict(self, ctx, model, queries):
            if len(queries) > 1:
                raise RuntimeError("poison batch")
            time.sleep(0.005)  # real per-query device work
            return [(i, q) for i, q in queries]

    owner = _Owner()
    disp = _BatchDispatcher(owner, window_ms=50.0, max_batch=8, max_window_ms=50.0,
                            pipeline_depth=1, batching="windowed")
    try:
        rt, futs = _RT(_PoisonAlgo()), []
        for i in range(4):
            fut: Future = Future()
            disp._queue.put(_Pending(f"q{i}", rt, fut, time.perf_counter(), (None, None),
                                     None, "acme"))
            futs.append(fut)
        for f in futs:
            assert f.result(timeout=30) is not None
        assert owner.charges.get("acme", 0.0) >= 4 * 0.005
    finally:
        disp.stop()


# ---------------------------------------------------------------------------
# the tenant fault scope
# ---------------------------------------------------------------------------


def test_per_tenant_fault_scope(served):
    _, _, _, port = served
    faults.install(faults.parse_spec("dispatch.device@tenant/t1:error:1.0"))
    try:
        assert post(port, "/tenants/t1/queries.json", {"user": "u0", "num": 1})[0] == 500
        assert post(port, "/tenants/t2/queries.json", {"user": "u1", "num": 1})[0] == 200
        assert post(port, "/queries.json", {"user": "u1", "num": 1})[0] == 200
    finally:
        faults.clear()


# ---------------------------------------------------------------------------
# per-tenant rollouts and restart re-adoption
# ---------------------------------------------------------------------------

HOLD = {"min_requests": 10**9, "bake_s": 3600.0, "interval_s": 60.0}


def test_per_tenant_rollout_and_abort(served):
    storage, srv, mux, port = served
    version = ModelRegistry(storage).register(srv.runtime.instance)
    status, _, body = post(port, "/tenants/t1/rollout/start",
                           {"version": version.id, "fraction": 1.0, **HOLD})
    assert status == 200 and body["state"] == "canary"
    assert post(port, "/tenants/t1/queries.json", {"user": "u0", "num": 1})[0] == 200
    status, body = get(port, "/tenants/t1/rollout/status")
    assert status == 200 and body["state"] == "canary"
    assert body["candidate"]["count"] >= 1
    assert get(port, "/tenants/t2/rollout")[1] == {"state": "none", "tenant": "t2"}
    assert post(port, "/tenants/t1/rollout/start", {"version": version.id})[0] == 409
    status, _, body = post(port, "/tenants/t1/rollout/abort", {"reason": "test cleanup"})
    assert status == 200 and body["state"] == "aborted"
    assert ModelRegistry(storage).get(version.id).status == "rolled_back"
    assert post(port, "/tenants/t1/rollout/abort", {})[0] == 409
    assert post(port, "/tenants/t1/queries.json", {"user": "u0", "num": 1})[0] == 200


def test_rollout_survives_server_restart(mt_storage):
    """A query server restarted mid-canary re-adopts the persisted
    rollout: the same version, bake progress credited from the original
    wall-clock start."""
    def server():
        return QueryServer(
            runtime=latest_completed_runtime(mt_storage, "mtsrv", "0", "mtsrv", device="cpu"),
            storage=mt_storage, config=QueryServerConfig(ip="127.0.0.1", port=0))

    srv1 = server()
    srv1.start()
    version = ModelRegistry(mt_storage).register(srv1.runtime.instance)
    srv1.start_rollout({"version": version.id, "fraction": 0.5, **HOLD})
    assert srv1.rollout is not None and srv1.rollout.st.state == "canary"
    time.sleep(0.3)  # bake progress to carry over
    srv1.stop()
    srv2 = server()
    port2 = srv2.start()
    try:
        rollout = srv2.rollout
        assert rollout is not None and rollout.st.state == "canary"
        assert rollout.st.version.id == version.id and rollout.config.fraction == 0.5
        assert time.monotonic() - rollout.st.started_at >= 0.3
        assert srv2.candidate is not None
        assert post(port2, "/queries.json", {"user": "u0", "num": 1})[0] == 200
        srv2.abort_rollout("test cleanup")
    finally:
        srv2.stop()
    srv3 = server()
    srv3.start()
    try:
        assert srv3.rollout is None
    finally:
        srv3.stop()


def test_default_scope_start_still_flips_live_version_to_canary(mt_storage):
    srv = QueryServer(
        runtime=latest_completed_runtime(mt_storage, "mtsrv", "0", "mtsrv", device="cpu"),
        storage=mt_storage, config=QueryServerConfig(ip="127.0.0.1", port=0))
    srv.start()
    try:
        registry = ModelRegistry(mt_storage)
        version = registry.register(srv.runtime.instance)
        registry.promote(version.id)
        srv.start_rollout({"version": version.id, "fraction": 0.5, **HOLD})
        assert registry.get(version.id).status == "canary"
        srv.abort_rollout("test cleanup")
    finally:
        srv.stop()


def test_tenant_resume_survives_shared_version_promote(mt_storage):
    """Another tenant promoting the shared version mid-bake does not
    cancel this tenant's re-adoption after a restart, and the resumed
    start leaves the live pointer live."""
    store = TenantStore(mt_storage)
    store.upsert(Tenant(id="ta", engine_id="mtsrv"))
    srv, _mux = _make_server(mt_storage)
    port = srv.start()
    version = ModelRegistry(mt_storage).register(srv.runtime.instance)
    status, _, _ = post(port, "/tenants/ta/rollout/start",
                        {"version": version.id, "fraction": 1.0, **HOLD})
    assert status == 200
    srv.stop()
    ModelRegistry(mt_storage).promote(version.id)
    srv2, mux2 = _make_server(mt_storage, attach=False)
    mux2.sync()  # the one resume pass, before the mux's thread exists
    host = mux2._hosts.get("ta")
    try:
        assert host is not None and host.rollout is not None, (
            "shared-version promote cancelled the tenant's re-adoption")
        assert host.rollout.st.state == "canary"
        assert ModelRegistry(mt_storage).get(version.id).status == "live"
        _attach(srv2, mux2)
        srv2.start()
        assert mux2._hosts["ta"] is host  # the thread's pass resumed nothing again
    finally:
        host = mux2._hosts.get("ta")
        if host is not None and host.rollout is not None:
            host.rollout.stop()
            host.rollout.abort("test cleanup")
        srv2.stop()
        mux2.stop()
        store.delete("ta")


def test_tenant_resume_declines_rolled_back_and_retires_record(mt_storage):
    from predictionio_tpu_torch.deploy.registry import ROLLOUT_ENTITY, LifecycleRecordStore

    store = TenantStore(mt_storage)
    store.upsert(Tenant(id="tb", engine_id="mtsrv"))
    srv, _mux = _make_server(mt_storage)
    port = srv.start()
    version = ModelRegistry(mt_storage).register(srv.runtime.instance)
    status, _, _ = post(port, "/tenants/tb/rollout/start",
                        {"version": version.id, "fraction": 1.0, **HOLD})
    assert status == 200
    srv.stop()
    ModelRegistry(mt_storage).rollback(version.id, "judged bad elsewhere")
    srv2, mux2 = _make_server(mt_storage, attach=False)
    try:
        mux2.sync()
        rec = LifecycleRecordStore(mt_storage).fold(ROLLOUT_ENTITY, "tenant/tb").get("tenant/tb")
        host = mux2._hosts.get("tb")
        assert host is None or host.rollout is None
        assert rec and rec.get("state") == "aborted"
        assert "not resumed" in rec.get("verdict_reason", "")
        assert "tb" not in mux2.cache.stats()["entries"] or not mux2.cache.stats()[
            "entries"]["tb"]["pinned"]
    finally:
        srv2.stop()
        mux2.stop()
        store.delete("tb")


def test_recreate_mid_canary_keeps_pinned_baseline(served):
    storage, srv, mux, port = served
    version = ModelRegistry(storage).register(srv.runtime.instance)
    status, _, _ = post(port, "/tenants/t1/rollout/start",
                        {"version": version.id, "fraction": 0.5, **HOLD})
    assert status == 200
    baseline = mux.cache._entries.get("t1")
    assert baseline is not None and baseline.pinned
    store = TenantStore(storage)
    store.delete("t1")
    mux.refresh(force=True)  # the delete seen; the abort deferred (active)
    store.upsert(Tenant(id="t1", engine_id="mtsrv"))
    mux.refresh(force=True)  # the recreate lands before the sync pass
    mux.sync()
    try:
        entry = mux.cache._entries.get("t1")
        assert entry is baseline, "recreate dropped the resident baseline"
        assert entry.pinned, "recreate unpinned the baking rollout's baseline"
        host = mux._hosts.get("t1")
        assert host is not None and host.rollout is not None
        assert host.rollout.st.state == "canary"
    finally:
        host = mux._hosts.get("t1")
        if host is not None and host.rollout is not None:
            host.rollout.stop()
            host.rollout.abort("test cleanup")


def test_tenant_deadline_floor_clamps_at_admit(served):
    storage, srv, mux, port = served
    TenantStore(storage).upsert(Tenant(id="tfloor", engine_id="mtsrv", deadline_floor_ms=1.0))
    status, headers, _ = post(port, "/tenants/tfloor/queries.json", {"user": "u0", "num": 1})
    assert status == 503 and headers.get("Retry-After") == "1"
    TenantStore(storage).set_quota("tfloor", deadline_floor_ms=30_000)
    assert post(port, "/tenants/tfloor/queries.json", {"user": "u0", "num": 1})[0] == 200
    status, _, _ = post(port, "/tenants/tfloor/queries.json", {"user": "u0"},
                        headers={"X-PIO-Deadline": "0"})
    assert status == 503
    assert post(port, "/tenants/t1/queries.json", {"user": "u0", "num": 1})[0] == 200


def test_prefetch_tenants_warms_the_cache_and_releases_the_slots(mt_storage):
    """`prefetch_tenants` (the JAX server's scale-up hint) loads each known
    tenant's runtime off the serving path, skips unknown ones, and gives
    back every concurrency slot its admits took; a server without a mux
    takes none."""
    TenantStore(mt_storage).upsert(Tenant(id="tp", engine_id="mtsml", max_concurrency=1))
    srv, mux = _make_server(mt_storage, cache_capacity=4)
    srv.start()
    try:
        assert srv.prefetch_tenants(["tp", "ghost"]) == ["tp", "ghost"]
        with srv._prefetch_lock:
            warming = list(srv._prefetch_threads)
        for t in warming:
            t.join(timeout=60)
        assert "tp" in mux.cache.stats()["entries"]
        assert mux.quota.snapshot("tp")["tp"]["inflight"] == 0
        assert srv.prefetch_tenants([]) == []
    finally:
        srv.stop()
    bare = QueryServer(
        runtime=latest_completed_runtime(mt_storage, "mtsrv", "0", "mtsrv", device="cpu"),
        storage=mt_storage, config=QueryServerConfig(ip="127.0.0.1", port=0))
    assert bare.prefetch_tenants(["tp"]) == []
