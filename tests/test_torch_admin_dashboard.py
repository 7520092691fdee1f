"""The port's admin server and dashboard against the JAX package's.

- The port's and the JAX `AdminServer` over one sqlite store answer
  `/`, `/cmd/app`, `/jobs` (with its filters, one job, its missing log),
  `/models` (filters, one version with its lineage, promote and
  rollback), `/online`, `/rollout` and the refusals (`POST /rollout`
  without PIO_ROLLOUT_PROXY, malformed app bodies, unknown routes) with
  equal statuses and bodies; app creation and deletion alike.
- `/tenants*` (list, one tenant, create or update, quota, delete, and
  the 404s for an unknown tenant and the 400s for malformed bodies)
  answer as the JAX admin server does over a store seeded alike, and
  leave the same records; `/evals*` answer as the JAX admin server does.
- The dashboard renders every section: the completed evaluation
  instances with their reports, alerts, fleet (scraping the admin
  server), fleet traces, the TSDB explorer (`?series=`, `?expr=`, a bad
  expression), the model lifecycle, online learning, and the tenants
  panel (escaped); `POST /telemetry/push` answers 403
  without PIO_PUSH_INGEST; its sparklines are the JAX dashboard's.
"""

import datetime as dt
import json
import urllib.error
import urllib.request

import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.storage.registry import SourceConfig as JSourceConfig  # noqa: E402
from predictionio_tpu.data.storage.registry import Storage as JStorage  # noqa: E402
from predictionio_tpu.data.storage.registry import StorageConfig as JStorageConfig  # noqa: E402
from predictionio_tpu.tools import admin as jadmin  # noqa: E402
from predictionio_tpu.tenancy import tenants as jtenants  # noqa: E402
from predictionio_tpu.tools import dashboard as jdashboard  # noqa: E402

from predictionio_tpu_torch.data.storage.base import EngineInstance, EvaluationInstance  # noqa: E402,E501
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore, ModelRegistry  # noqa: E402,E501
from predictionio_tpu_torch.deploy.scheduler import JobQueue  # noqa: E402
from predictionio_tpu_torch.obs.monitor import SLOSpec, get_monitor  # noqa: E402
from predictionio_tpu_torch.online.consumer import CURSOR_ENTITY  # noqa: E402
from predictionio_tpu_torch.tenancy import tenants  # noqa: E402
from predictionio_tpu_torch.tenancy.tenants import Tenant, TenantStore  # noqa: E402
from predictionio_tpu_torch.tools import admin, common, dashboard  # noqa: E402

REC = "predictionio_tpu_torch.engines.recommendation.RecommendationEngine"


def _config(path):
    return dict(sources={"TESTSQL": ("sqlite", {"PATH": str(path / "pio.db")}),
                         "TESTFS": ("localfs", {"PATH": str(path)})},
                repositories={"METADATA": "TESTSQL", "EVENTDATA": "TESTSQL",
                              "MODELDATA": "TESTFS"})


def _storages(path):
    path.mkdir(parents=True, exist_ok=True)
    c = _config(path)
    return (Storage(StorageConfig(
                sources={n: SourceConfig(n, t, s) for n, (t, s) in c["sources"].items()},
                repositories=c["repositories"])),
            JStorage(JStorageConfig(
                sources={n: JSourceConfig(n, t, s) for n, (t, s) in c["sources"].items()},
                repositories=c["repositories"])))


def _instance(iid, variant):
    now = dt.datetime.now(dt.timezone.utc)
    return EngineInstance(id=iid, status="COMPLETED", start_time=now, end_time=now,
                          engine_id=variant, engine_version="0", engine_variant=variant,
                          engine_factory=REC,
                          algorithms_params=json.dumps([{"name": "als",
                                                         "params": {"rank": 3}}]))


def _seed(ts):
    common.create_app(ts, "shop", description="the shop", access_key="KEY1")
    common.create_app(ts, "blog", access_key="KEY2")
    queue = JobQueue(ts)
    variant = {"id": "rec", "engineFactory": REC,
               "datasource": {"params": {"app_name": "shop"}}}
    jobs = [queue.submit(variant, timeout_s=60, max_attempts=2),
            queue.submit(dict(variant, id="rec2"), period_s=3600)]
    reg = ModelRegistry(ts)
    v1 = reg.register(_instance("i1", "rec"), job_id=jobs[0].id)
    reg.promote(v1.id)
    v2 = reg.register(_instance("i2", "rec"))
    reg.set_status(v2.id, "canary")
    v3 = reg.register(_instance("i3", "rec2"))
    LifecycleRecordStore(ts).append(CURSOR_ENTITY, "server:1", {
        "cursor": {"0": 12}, "events_consumed": 40, "events_folded": 30,
        "users_folded": 7, "items_folded": 2, "ticks": 9, "app_id": 1})
    return jobs, (v1, v2, v3)


def req(port, path, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                               headers={"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            raw = resp.read().decode()
            return resp.status, raw
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture
def admins(tmp_path):
    ts, js = _storages(tmp_path / "store")
    seeded = _seed(ts)
    servers = [jadmin.AdminServer(js, ip="127.0.0.1", port=0),
               admin.AdminServer(ts, ip="127.0.0.1", port=0)]
    ports = [s.start() for s in servers]
    yield ports, seeded, ts
    for s in servers:
        s.stop()


def test_admin_servers_answer_alike(admins, monkeypatch):
    monkeypatch.delenv("PIO_ROLLOUT_PROXY", raising=False)
    (jport, tport), (jobs, versions), _ts = admins
    v1, v2, v3 = versions
    paths = ["/", "/cmd/app", "/jobs", "/jobs?status=queued", "/jobs?status=failed",
             f"/jobs/{jobs[0].id}", f"/jobs/{jobs[0].id}/logs", "/jobs/nope",
             f"/jobs/{jobs[0].id}/nope", "/models", "/models?status=live",
             "/models?engine=rec2", f"/models/{v2.id}", "/models/nope", "/online",
             "/rollout", "/nowhere"]
    for path in paths:
        assert req(tport, path) == req(jport, path), path
    # changes through the port server, read back alike by both
    for path, body in ((f"/models/{v3.id}/promote", {}),
                       (f"/models/{v2.id}/rollback", {"reason": "bad canary"})):
        status, raw = req(tport, path, "POST", body)
        vid = path.split("/")[2]
        assert status == 200 and json.loads(raw)["id"] == vid
        for view in ("/models", "/rollout", f"/models/{vid}"):
            assert req(tport, view) == req(jport, view), view
    # refusals change nothing: both answer alike
    for path, body in (("/models/nope/promote", {}), (f"/models/{v1.id}/nope", {}),
                       ("/rollout", {"url": "http://127.0.0.1:1", "action": "status"}),
                       ("/nowhere", {})):
        assert req(tport, path, "POST", body) == req(jport, path, "POST", body), path
    assert req(tport, "/rollout") == req(jport, "/rollout")
    assert json.loads(req(tport, "/rollout")[1])["live"][0]["id"] == v3.id


def test_admin_app_routes_alike(tmp_path):
    out = []
    for pkg_admin, which in ((jadmin, 1), (admin, 0)):
        ts, js = _storages(tmp_path / f"s{which}")
        srv = pkg_admin.AdminServer(js if pkg_admin is jadmin else ts, ip="127.0.0.1", port=0)
        port = srv.start()
        try:
            steps = []
            for body in ({"name": "a1", "id": 42, "description": "d"}, {"name": "a1"},
                         {"id": 3}, {"name": "a2", "id": "7"}, {"name": "a3", "id": 42},
                         "nope"):
                status, raw = req(port, "/cmd/app", "POST", body)
                got = json.loads(raw)
                got.pop("accessKey", None)
                steps.append((status, got))
            listing = json.loads(req(port, "/cmd/app")[1])
            steps.append([(a["name"], a["id"], a["description"], len(a["accessKeys"]))
                          for a in listing])
            for path in ("/cmd/app/a1/data", "/cmd/app/zz/data", "/cmd/app/a1/x/y",
                         "/cmd/app/a1", "/cmd/app/a1", "/other"):
                steps.append((path, req(port, path, "DELETE")))
            steps.append(req(port, "/jobs", "POST", {"nope": 1}))
            steps.append(req(port, "/jobs", "POST", {"variant": {"id": "x"},
                                                     "max_attempts": "z"}))
        finally:
            srv.stop()
        out.append(steps)
    assert out[0] == out[1]
    assert out[0][0][0] == 201 and out[0][1][0] == 409


def _untimed(raw):
    """A tenant answer without its write times."""
    body = json.loads(raw)
    for row in body if isinstance(body, list) else [body]:
        if isinstance(row, dict):
            row.pop("created_at", None)
            row.pop("updated_at", None)
    return body


@pytest.mark.parametrize("method, path, body", [
    ("GET", "/tenants", None), ("GET", "/tenants/t1", None),
    ("GET", "/tenants/ghost", None), ("GET", "/tenants/t1/x", None),
    ("POST", "/tenants", {"id": "t2", "engine_id": "rec", "qps": 3, "weight": 2}),
    ("POST", "/tenants", {"id": "t1", "engine_id": "rec", "description": "again"}),
    ("POST", "/tenants", {"id": "bad/id", "engine_id": "rec"}), ("POST", "/tenants", [1]),
    ("POST", "/tenants/t1/quota", {"qps": 9, "max_concurrency": 2, "other": 1}),
    ("POST", "/tenants/t1/quota", {"weight": 0}), ("POST", "/tenants/t1/quota", {}),
    ("POST", "/tenants/ghost/quota", {"qps": 1}), ("POST", "/tenants/t1/x", {}),
    ("DELETE", "/tenants/t1", None), ("DELETE", "/tenants/ghost", None),
])
def test_tenants_and_evals_are_not_ported(tmp_path, method, path, body):
    """The tenant routes, ported: each answers as the JAX admin server
    does over a store seeded alike, and both leave the same records."""
    out = []
    for pkg, which in ((jadmin, "jax"), (admin, "port")):
        ts, js = _storages(tmp_path / which)
        records = jtenants if pkg is jadmin else tenants
        store = records.TenantStore(ts if pkg is admin else js)
        store.upsert(records.Tenant(id="t1", engine_id="rec", qps=5.0,
                                    description="<b>one</b>"))
        store.upsert(records.Tenant(id="t0", engine_id="other", max_concurrency=4))
        srv = pkg.AdminServer(ts if pkg is admin else js, ip="127.0.0.1", port=0)
        port = srv.start()
        try:
            status, raw = req(port, path, method, body)
            out.append((status, _untimed(raw), _untimed(req(port, "/tenants")[1])))
        finally:
            srv.stop()
    assert out[0] == out[1]


@pytest.mark.parametrize("path", ["/evals", "/evals?status=completed", "/evals/run-1",
                                  "/evals/run-1/x"])
def test_evals_answer_as_the_jax_admin_server(admins, path):
    """`GET /evals*` is ported: both servers over the same records give
    the same status and body (an empty listing, a 404 for an unknown
    run)."""
    (jport, tport), _seeded, _ts = admins
    assert req(tport, path) == req(jport, path)


def test_dashboard_sections_render(admins, tmp_path, monkeypatch):
    (_jport, tport), _seeded, ts = admins
    now = dt.datetime.now(dt.timezone.utc)
    ts.get_meta_data_evaluation_instances().insert(EvaluationInstance(
        id="ev1", status="EVALCOMPLETED", start_time=now, end_time=now,
        evaluation_class="mod.MyEval", evaluator_results="Precision@10 0.25",
        evaluator_results_html="<p>report</p>", evaluator_results_json='{"best": 1}'))
    ts.get_meta_data_evaluation_instances().insert(EvaluationInstance(
        id="ev2", status="EVALRUNNING", start_time=now, end_time=now))
    monkeypatch.setenv("PIO_TRACE_COLLECT", "1")
    mon = get_monitor()
    saved = list(mon._slos)
    dash = dashboard.Dashboard(ts, ip="127.0.0.1", port=0,
                               monitor_targets=f"admin=http://127.0.0.1:{tport}",
                               scrape_interval_s=30.0)
    port = dash.start()
    try:
        status, page = req(port, "/")
        assert "(no tenants registered)" in page
        TenantStore(ts).upsert(Tenant(id="acme", engine_id="rec", qps=5.0,
                                      description="<i>acme</i>"))
        mon.set_slos([SLOSpec(name="avail_<b>", objective=0.99)])
        dash._scraper.scrape_once()
        status, page = req(port, "/")
        assert status == 200
        for section in ("Completed evaluations", "<h1>Alerts</h1>", "<h1>Fleet</h1>",
                        "<h1>Fleet traces</h1>", "<h1>TSDB explorer</h1>",
                        "<h1>Model lifecycle</h1>", "<h1>Online learning</h1>",
                        "<h1>Fleet evaluations</h1>", "<h1>Tenants</h1>"):
            assert section in page, section
        assert "ev1" in page and "ev2" not in page and "Precision@10 0.25" in page
        assert "avail_&lt;b&gt;" in page and "<b>up</b>" in page and "server:1" in page
        assert "not ported" not in page
        assert ("<td>acme</td><td>rec/rec</td><td>1</td><td>5.0</td><td>∞</td><td>∞</td>"
                "<td>yes</td><td>&lt;i&gt;acme&lt;/i&gt;</td>") in page
        assert "(no eval runs recorded)" in page
        assert req(port, "/engine_instances/ev1.html") == (200, "<p>report</p>")
        assert req(port, "/engine_instances/ev1.json") == (200, '{"best": 1}')
        assert req(port, "/engine_instances/nope.html")[0] == 404
        status, page = req(port, "/?series=up&match=instance=admin")
        assert status == 200 and "instance=admin" in page
        assert "▁" in page or "█" in page
        status, page = req(port, "/?expr=sum+by+(instance)+(up)")
        assert status == 200 and "instance=admin" in page
        status, page = req(port, "/?expr=rate(")
        assert status == 200 and "expression error" in page
        status, page = req(port, "/?series=nothing_here")
        assert "no series named" in page
        monkeypatch.delenv("PIO_PUSH_INGEST", raising=False)
        status, raw = req(port, "/telemetry/push", "POST", {})
        assert status == 403 and "PIO_PUSH_INGEST" in json.loads(raw)["message"]
        status, raw = req(port, "/debug/traces?fleet=1")
        assert status == 200 and json.loads(raw)["collector"]["targets"] == 1
        status, raw = req(port, "/alerts")
        assert status == 200 and json.loads(raw)["slos"][0]["slo"] == "avail_<b>"
    finally:
        mon.set_slos(saved)
        dash.stop()
    assert mon.collector is None


@pytest.mark.parametrize("values", [[], [0.0], [1, 2, 3, None, 5], [0.5] * 50,
                                    [-1.0, 0.0, 2.0], [None, None]])
def test_sparklines_equal_the_jax_dashboard(values):
    assert dashboard._Handler._sparkline(values) == jdashboard._Handler._sparkline(values)
