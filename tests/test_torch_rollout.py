"""The port's canary rollout on the CPU, against the JAX package.

- Exact parity of the pure parts: ``route_bucket`` and
  ``sticky_candidate`` over seeded bodies, fractions and gateway
  buckets; ``verdict`` (action and reason string) over seeded window
  stats and configs; ``RolloutConfig.from_env`` over environments and
  overrides (the bool spellings, malformed numbers, the bad-fraction
  error); ``VariantWindow.stats`` under one patched clock.
- The JAX package's tests/test_rollout_e2e.py on the port, over a small
  ALS app trained on the CPU behind a ``QueryServer``: a candidate
  failed by ``dispatch.device@candidate`` rolls back with zero dropped
  queries; a ``model.load`` fault at start leaves live serving; a
  healthy canary promotes through a zero-drop swap; shadow mode mirrors
  and promotes on agreement; an operator abort detaches the candidate.
- Three more: a server restarted mid-canary re-adopts it (same version,
  same ``started_wall``) and ``console rollout abort`` ends it; a
  version whose instance names the JAX package's engine is a 400
  "canary start failed" while live serving goes on; the port's
  ``pio_rollout`` records fold to the same dicts under the JAX
  ``LifecycleRecordStore`` over the same sqlite file.
- ``console rollout start|status|abort`` against a port server print
  what the JAX console prints, with the same exit codes.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.deploy import registry as jreg  # noqa: E402
from predictionio_tpu.deploy import rollout as jrollout  # noqa: E402
from predictionio_tpu.workflow import core as jcore  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.deploy import rollout  # noqa: E402
from predictionio_tpu_torch.deploy.registry import (  # noqa: E402
    ROLLOUT_ENTITY,
    LifecycleRecordStore,
    ModelRegistry,
)
from predictionio_tpu_torch.resilience import faults  # noqa: E402
from predictionio_tpu_torch.tools import console  # noqa: E402
from predictionio_tpu_torch.workflow.core import run_train  # noqa: E402
from predictionio_tpu_torch.workflow.server import (  # noqa: E402
    QueryServer,
    QueryServerConfig,
    build_runtime,
)

# ---------------------------------------------------------------------------
# the pure parts
# ---------------------------------------------------------------------------


def test_route_bucket_and_sticky_candidate_equal_jax():
    rng = np.random.default_rng(5)
    for n in range(400):
        body = json.dumps({"user": f"u{int(rng.integers(1000))}",
                           "num": int(rng.integers(1, 50))}).encode()
        if n % 7 == 0:
            body = bytes(rng.integers(0, 256, int(rng.integers(0, 40))).tolist())
        assert rollout.route_bucket(body) == jrollout.route_bucket(body)
        for fraction in (0.0001, 0.1, 0.25, float(rng.random()), 1.0):
            bucket = None if n % 3 else int(rng.integers(0, 10_000))
            assert (rollout.sticky_candidate(body, fraction, bucket=bucket)
                    == jrollout.sticky_candidate(body, fraction, bucket=bucket))


def _stats(rng, shadow):
    count = int(rng.integers(0, 60))
    out = {"count": count, "errors": 0, "error_rate": float(rng.choice([0.0, rng.random()])),
           "p50_ms": 0.0, "p99_ms": float(rng.choice([0.0, rng.random() * 100]))}
    if shadow and rng.random() < 0.8:
        out["shadow_count"] = int(rng.integers(0, 60))
        out["agreement"] = float(rng.choice([1.0, rng.random()]))
    return out


def test_verdict_equals_jax():
    rng = np.random.default_rng(11)
    actions = set()
    for _ in range(3000):
        shadow = bool(rng.random() < 0.4)
        kw = dict(min_requests=int(rng.integers(0, 40)),
                  max_error_delta=float(rng.random() * 0.3),
                  max_p99_ratio=float(rng.random() * 4 + 0.5),
                  bake_s=float(rng.random() * 60), shadow=shadow,
                  min_agreement=float(rng.random()))
        live, cand = _stats(rng, False), _stats(rng, shadow)
        elapsed = float(rng.random() * 90)
        got = rollout.verdict(live, cand, rollout.RolloutConfig(**kw), elapsed)
        assert got == jrollout.verdict(live, cand, jrollout.RolloutConfig(**kw), elapsed)
        actions.add(got[0])
    assert actions == {"wait", "promote", "rollback"}


ENVS = [
    {},
    {"PIO_ROLLOUT_FRACTION": "0.3", "PIO_ROLLOUT_BAKE_S": "5", "PIO_ROLLOUT_SHADOW": "yes"},
    {"PIO_ROLLOUT_MIN_REQUESTS": "7.9", "PIO_ROLLOUT_WINDOW_S": "bad",
     "PIO_ROLLOUT_SHADOW": "maybe", "PIO_ROLLOUT_MAX_P99_RATIO": ""},
    {"PIO_ROLLOUT_FRACTION": "0"},
    {"PIO_ROLLOUT_FRACTION": "1.5"},
    {"PIO_ROLLOUT_INTERVAL_S": "0.25", "PIO_ROLLOUT_MIN_AGREEMENT": "0.99",
     "PIO_ROLLOUT_MAX_ERROR_DELTA": "1e-2", "PIO_ROLLOUT_SHADOW": "OFF"},
]
OVERRIDES = [
    {}, {"shadow": "false"}, {"shadow": "TRUE"}, {"shadow": " on "}, {"shadow": 0},
    {"shadow": 1}, {"shadow": None, "fraction": None}, {"fraction": "0.5"},
    {"fraction": 0}, {"fraction": -0.1}, {"fraction": 2}, {"min_requests": 3.7},
    {"bake_s": "12", "window_s": 3, "interval_s": 0.1}, {"fraction": "x"},
]


def _config(module, env, overrides):
    try:
        return module.RolloutConfig.from_env(env, **overrides).to_dict()
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("env", ENVS)
def test_config_from_env_equals_jax(env):
    for overrides in OVERRIDES:
        assert _config(rollout, env, overrides) == _config(jrollout, env, overrides)
    assert _config(rollout, {}, {"fraction": 0}) == (
        "ValueError", "fraction must be in (0, 1], got 0.0")


def test_variant_window_stats_equal_jax(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    rng = np.random.default_rng(3)
    windows = rollout.VariantWindow(5.0), jrollout.VariantWindow(5.0)
    for n in range(300):
        clock[0] += float(rng.random() * 0.1)
        d, err = float(rng.random() * 0.05), bool(rng.random() < 0.2)
        tid = f"t{n}" if n % 4 else None
        agree = bool(rng.random() < 0.9)
        for w in windows:
            w.add(d, err, trace_id=tid)
            if n % 3 == 0:
                w.add_agreement(agree)
        if n % 25 == 0:
            assert windows[0].stats() == windows[1].stats()
    clock[0] += 4.0
    assert windows[0].stats() == windows[1].stats()
    clock[0] += 10.0
    assert windows[0].stats() == windows[1].stats() == {
        "count": 0, "errors": 0, "error_rate": 0.0, "p50_ms": 0.0, "p99_ms": 0.0}


# ---------------------------------------------------------------------------
# the canary end to end (JAX: tests/test_rollout_e2e.py)
# ---------------------------------------------------------------------------

REC = "predictionio_tpu_torch.engines.recommendation.RecommendationEngine"
VARIANT = {
    "id": "roll",
    "engineFactory": REC,
    "datasource": {"params": {"app_name": "rollapp"}},
    "algorithms": [{"name": "als", "params": {"rank": 8, "num_iterations": 4}}],
}


def _sources(path):
    return ({"TESTSQL": ("sqlite", {"PATH": str(path / "pio.db")}),
             "TESTFS": ("localfs", {"PATH": str(path)})},
            {"METADATA": "TESTSQL", "EVENTDATA": "TESTSQL", "MODELDATA": "TESTFS"})


def _storage(path):
    path.mkdir(parents=True, exist_ok=True)
    sources, repos = _sources(path)
    return Storage(StorageConfig(
        sources={n: SourceConfig(n, t, s) for n, (t, s) in sources.items()},
        repositories=repos))


def _jax_storage(path):
    sources, repos = _sources(path)
    return JStorage(JStorageConfig(
        sources={n: JSourceConfig(n, t, s) for n, (t, s) in sources.items()},
        repositories=repos))


def _seed(storage, n_users=8, seed=0):
    app_id = storage.get_meta_data_apps().insert(App(id=0, name="rollapp"))
    storage.get_events().init_app(app_id)
    rng = np.random.RandomState(seed)
    batch = []
    for u in range(n_users):
        for _ in range(20):
            i = rng.randint(0, 5) + (u % 2) * 5
            batch.append(Event(event="rate", entity_type="user", entity_id=f"u{u}",
                               target_entity_type="item", target_entity_id=f"i{i}",
                               properties={"rating": 5.0}))
    storage.get_events().insert_batch(batch, app_id)
    return app_id


def _post(port, path, body, timeout=20):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "null")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=20) as r:
        return r.status, json.loads(r.read().decode())


def _server(storage, instance):
    srv = QueryServer(runtime=build_runtime(storage, instance, device="cpu"),
                      storage=storage,
                      config=QueryServerConfig(ip="127.0.0.1", port=0, batch_window_ms=1.0))
    return srv, srv.start()


@pytest.fixture()
def served(tmp_path):
    """A live query server (model A) and a registered `trained` version
    (model B) to canary."""
    storage = _storage(tmp_path / "store")
    _seed(storage)
    inst_a = run_train(storage, VARIANT, device="cpu")
    inst_b = run_train(storage, VARIANT, device="cpu")
    version_b = ModelRegistry(storage).register(inst_b)
    srv, port = _server(storage, inst_a)
    made = [srv]
    yield storage, srv, port, version_b, inst_a, made
    faults.clear()
    for s in made:
        s.stop()


class Hammer:
    """Closed-loop clients recording every (status, body): every query
    must come back as an HTTP response, never a transport error."""

    def __init__(self, port, n_clients=8):
        self.port = port
        self.n_clients = n_clients
        self.results: list = []
        self.transport_errors: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list = []

    def _run(self, cid):
        i = 0
        while not self._stop.is_set():
            i += 1
            try:
                # vary user and num: routing hashes the body, so the body
                # space must be wide enough for a fraction to catch a share
                status, body = _post(self.port, "/queries.json", {
                    "user": f"u{(cid * 131 + i) % 8}", "num": (cid * 17 + i) % 50 + 1})
                with self._lock:
                    self.results.append((status, body))
            except Exception as e:  # noqa: BLE001 — dropped: no HTTP response
                with self._lock:
                    self.transport_errors.append(repr(e))

    def __enter__(self):
        for c in range(self.n_clients):
            t = threading.Thread(target=self._run, args=(c,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)

    def snapshot(self):
        with self._lock:
            return list(self.results), list(self.transport_errors)


def _wait_for(predicate, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _state(port):
    return _get(port, "/rollout/status")[1]["state"]


def test_faulted_candidate_rolls_back_zero_dropped(served):
    storage, srv, port, version_b, _, _ = served
    faults.install(faults.FaultSpec("dispatch.device", "error", 1.0, scope="candidate"))
    with Hammer(port) as hammer:
        time.sleep(0.3)  # live-only traffic across the canary's start
        status, body = _post(port, "/rollout/start", {
            "version": version_b.id, "fraction": 0.1, "interval_s": 0.2,
            "window_s": 20.0, "min_requests": 5, "bake_s": 120.0,
            "max_error_delta": 0.2})
        assert status == 200, body
        assert body["state"] == "canary"
        assert ModelRegistry(storage).get(version_b.id).status == "canary"
        _wait_for(lambda: _state(port) == "rolled_back", timeout=90,
                  what="automatic rollback")
        time.sleep(0.5)  # traffic across the rollback
    results, transport_errors = hammer.snapshot()
    _, st = _get(port, "/rollout/status")
    assert st["state"] == "rolled_back" and "error-rate" in st["reason"]
    assert ModelRegistry(storage).get(version_b.id).status == "rolled_back"
    assert ModelRegistry(storage).get(version_b.id).reason
    assert transport_errors == []
    assert len(results) > 50
    bad = [(s, b) for s, b in results if s != 200]
    assert all(s == 500 and "injected" in (b or {}).get("message", "") for s, b in bad), bad[:3]
    assert any(s == 200 for s, _ in results)
    assert st["candidate"]["count"] >= 5 and st["candidate"]["error_rate"] > 0.2
    # the spec is still installed, but no candidate exists any more
    assert _post(port, "/queries.json", {"user": "u1", "num": 3})[0] == 200


def test_canary_start_failure_leaves_live_serving(served):
    storage, srv, port, version_b, _, _ = served
    faults.install(faults.FaultSpec("model.load", "error", 1.0))
    with Hammer(port, n_clients=4) as hammer:
        time.sleep(0.2)
        status, body = _post(port, "/rollout/start", {"version": version_b.id,
                                                      "fraction": 0.5})
        assert status == 400 and "canary start failed" in body["message"]
        time.sleep(0.3)
    results, transport_errors = hammer.snapshot()
    assert transport_errors == []
    assert results and all(s == 200 for s, _ in results)
    assert _state(port) == "none" and srv.candidate is None
    assert ModelRegistry(storage).get(version_b.id).status == "trained"


def test_healthy_canary_promotes_with_zero_drop_hot_swap(served):
    storage, srv, port, version_b, _, _ = served
    old_instance = srv.runtime.instance.id
    with Hammer(port) as hammer:
        status, body = _post(port, "/rollout/start", {
            "version": version_b.id, "fraction": 0.4, "interval_s": 0.2,
            "window_s": 20.0, "min_requests": 5, "bake_s": 1.5})
        assert status == 200, body
        _wait_for(lambda: _state(port) == "promoted", timeout=90, what="automatic promote")
        time.sleep(0.5)  # traffic across the swap
    results, transport_errors = hammer.snapshot()
    assert transport_errors == []
    assert results and all(s == 200 for s, _ in results), [
        r for r in results if r[0] != 200][:3]
    assert srv.runtime.instance.id == version_b.instance_id != old_instance
    assert srv.candidate is None
    assert ModelRegistry(storage).get(version_b.id).status == "live"
    # per-variant metrics landed under the variant label
    hist = srv.metrics.histogram("variant_serve_seconds", labelnames=("variant",))
    assert hist.count_of(variant="candidate") > 0 and hist.count_of(variant="live") > 0
    # the candidate was built on the live model's device
    assert str(srv.runtime.models[0].device) == "cpu"


def test_shadow_mode_mirrors_and_promotes_on_agreement(served):
    storage, srv, port, version_b, inst_a, made = served
    # the same factors under another version: every mirror agrees
    version_a = ModelRegistry(storage).register(inst_a)
    with Hammer(port) as hammer:
        status, body = _post(port, "/rollout/start", {
            "version": version_a.id, "fraction": 0.5, "interval_s": 0.2,
            "window_s": 20.0, "min_requests": 5, "bake_s": 1.5, "shadow": True})
        assert status == 200, body
        _wait_for(lambda: _state(port) == "promoted", timeout=90, what="shadow promote")
    results, transport_errors = hammer.snapshot()
    assert transport_errors == []
    assert results and all(s == 200 for s, _ in results)
    _, st = _get(port, "/rollout/status")
    assert st["candidate"].get("shadow_count", 0) >= 5
    assert st["candidate"]["agreement"] == 1.0  # the same blob, the same answers
    assert ModelRegistry(storage).get(version_a.id).status == "live"
    # live served every real query: no candidate-routed request was booked
    hist = srv.metrics.histogram("variant_serve_seconds", labelnames=("variant",))
    assert hist.count_of(variant="candidate") == 0


def test_operator_abort_detaches_candidate(served):
    storage, srv, port, version_b, _, _ = served
    status, body = _post(port, "/rollout/start", {
        "version": version_b.id, "fraction": 0.2, "bake_s": 300.0})
    assert status == 200, body
    # a second start conflicts while one is active
    assert _post(port, "/rollout/start", {"version": version_b.id})[0] == 409
    # so does a reload
    assert _post(port, "/reload", {})[0] == 409
    status, body = _post(port, "/rollout/abort", {"reason": "bad vibes"})
    assert status == 200 and body["state"] == "aborted"
    assert srv.candidate is None
    assert ModelRegistry(storage).get(version_b.id).status == "rolled_back"
    assert _post(port, "/rollout/abort", {})[0] == 409  # nothing to abort now
    assert _post(port, "/rollout/start", {"version": "mv-missing"})[0] == 400


def test_restart_resumes_the_canary_and_console_aborts_it(served, capsys):
    storage, srv, port, version_b, inst_a, made = served
    status, body = _post(port, "/rollout/start", {
        "version": version_b.id, "fraction": 0.3, "bake_s": 600.0})
    assert status == 200 and body["state"] == "canary"
    started_wall = body["started_wall"]
    srv.stop()
    srv2, port2 = _server(storage, inst_a)
    made.append(srv2)
    _, st = _get(port2, "/rollout/status")
    assert st["state"] == "canary" and st["version"]["id"] == version_b.id
    assert st["started_wall"] == started_wall and st["elapsed_s"] >= 0
    assert st["config"]["bake_s"] == 600.0 and srv2.candidate is not None
    for _ in range(20):
        assert _post(port2, "/queries.json", {"user": "u3", "num": 4})[0] == 200
    capsys.readouterr()
    code = console.main(["rollout", "abort", "--url", f"http://127.0.0.1:{port2}",
                         "--reason", "restart test"])
    out = capsys.readouterr().out
    assert code == 0 and "[INFO] rollout state: aborted" in out, out
    assert f"[INFO]   version: {version_b.id} (roll/roll)" in out
    assert srv2.candidate is None
    assert ModelRegistry(storage).get(version_b.id).status == "rolled_back"
    assert console.main(["rollout", "status", "--url", f"http://127.0.0.1:{port2}"]) == 0
    assert "rollout state: aborted" in capsys.readouterr().out


def test_jax_engine_version_is_refused_and_live_serving_goes_on(served, tmp_path):
    storage, srv, port, _, _, _ = served
    js = _jax_storage(tmp_path / "store")
    jinst = jcore.run_train(js, dict(
        VARIANT, engineFactory="predictionio_tpu.engines.recommendation.RecommendationEngine"))
    version = ModelRegistry(storage).register(
        storage.get_meta_data_engine_instances().get(jinst.id))
    with Hammer(port, n_clients=4) as hammer:
        time.sleep(0.2)
        status, body = _post(port, "/rollout/start", {"version": version.id})
        time.sleep(0.3)
    assert status == 400 and "canary start failed" in body["message"]
    assert "JAX package" in body["message"]
    results, transport_errors = hammer.snapshot()
    assert transport_errors == [] and results and all(s == 200 for s, _ in results)
    assert _state(port) == "none" and srv.candidate is None
    assert ModelRegistry(storage).get(version.id).status == "trained"


def test_rollout_records_fold_the_same_under_jax(served, tmp_path):
    storage, srv, port, version_b, inst_a, _ = served
    version_a = ModelRegistry(storage).register(inst_a)
    for version, end in ((version_b, "/rollout/abort"), (version_a, None)):
        status, body = _post(port, "/rollout/start", {
            "version": version.id, "fraction": 0.5, "interval_s": 0.1,
            "min_requests": 1, "bake_s": 0.3 if end is None else 300.0})
        assert status == 200, body
        if end:
            assert _post(port, end, {"reason": "records"})[0] == 200
        else:
            for _ in range(10):
                _post(port, "/queries.json", {"user": "u2", "num": 2})
            _wait_for(lambda: _state(port) == "promoted", what="promote")
    js = _jax_storage(tmp_path / "store")
    ours = LifecycleRecordStore(storage).fold(ROLLOUT_ENTITY)
    theirs = jreg.LifecycleRecordStore(js).fold(jreg.ROLLOUT_ENTITY)
    assert ours == theirs and list(ours) == ["roll/roll"]
    rec = ours["roll/roll"]
    assert rec["state"] == "promoted" and rec["version_id"] == version_a.id
    assert set(rec) == {"state", "version_id", "config", "started_wall", "verdict_reason"}
    assert [v.to_dict() for v in jreg.ModelRegistry(js).list()] == [
        v.to_dict() for v in ModelRegistry(storage).list()]
    # the registry statuses the JAX package reads
    assert jreg.ModelRegistry(js).get(version_a.id).status == "live"
    assert jreg.ModelRegistry(js).get(version_b.id).status == "rolled_back"


def test_console_rollout_verbs_print_what_the_jax_console_prints(served, capsys):
    from predictionio_tpu.tools import console as jconsole

    storage, srv, port, version_b, _, _ = served
    url = ["--url", f"http://127.0.0.1:{port}"]

    def both(argv):
        out = []
        for main in (console.main, jconsole.main):
            code = main(argv + url)
            captured = capsys.readouterr()
            out.append((code, captured.out, captured.err.splitlines()[-1:] if code else []))
        return out

    got, want = both(["rollout", "status"])
    assert got == want == (0, "[INFO] rollout state: none\n", [])
    got, want = both(["rollout", "abort"])
    assert got == want and got[0] == 1 and "(409)" in got[2][0]
    # a start with no traffic and no verdict tick meanwhile: a static status
    assert console.main(["rollout", "start", "--version", version_b.id, "--fraction",
                         "0.2", "--bake-s", "300", "--min-requests", "7", *url]) == 0
    started = capsys.readouterr().out
    assert "[INFO] rollout state: canary" in started and "traffic: 20%" in started
    _, st = _get(port, "/rollout/status")
    assert st["config"]["min_requests"] == 7 and st["config"]["bake_s"] == 300.0
    got, want = both(["rollout", "status"])
    assert got == want and f"version: {version_b.id} (roll/roll)" in got[1]
    got, want = both(["rollout", "start", "--version", version_b.id])
    assert got == want and got[0] == 1 and "(409)" in got[2][0]
    assert console.main(["rollout", "abort", "--reason", "console", *url]) == 0
    assert "verdict: wait — console" in capsys.readouterr().out


def test_offline_prior_stretches_the_bake_of_a_worse_candidate(served, monkeypatch):
    """The JAX package's offline prior (deploy/rollout.py's start): a
    candidate whose lineage-linked eval score is below live's gets its
    bake stretched by PIO_TUNE_STRICT_BAKE (2 by default); a better one,
    or any with PIO_TUNE_PRIOR=0, keeps the bake it asked for."""
    from predictionio_tpu_torch.evalfleet.records import EvalRecordStore

    storage, srv, port, version_b, inst_a, _ = served
    monkeypatch.delenv("PIO_TUNE_PRIOR", raising=False)
    monkeypatch.delenv("PIO_TUNE_STRICT_BAKE", raising=False)
    registry = ModelRegistry(storage)
    live = registry.register(inst_a)
    registry.promote(live.id)
    rec = EvalRecordStore(storage)

    def linked(version_id, score):
        run = rec.create_run(live.engine_id, {"metric": "map@5"}, 1, 1, 1, "MAPAtK@5")
        rec.update_run(run.id, status="completed", winner_score=score)
        rec.link_model_version(run.id, version_id)
        time.sleep(0.01)

    def bake_of(version_id):
        status, body = _post(port, "/rollout/start", {
            "version": version_id, "fraction": 0.2, "bake_s": 300.0})
        assert status == 200, body
        bake = _get(port, "/rollout/status")[1]["config"]["bake_s"]
        assert _post(port, "/rollout/abort", {})[0] == 200
        return bake

    linked(live.id, 0.8)
    linked(version_b.id, 0.2)
    assert bake_of(version_b.id) == 600.0
    monkeypatch.setenv("PIO_TUNE_PRIOR", "0")
    worse = registry.register(inst_a)
    linked(worse.id, 0.1)
    assert bake_of(worse.id) == 300.0
    monkeypatch.delenv("PIO_TUNE_PRIOR")
    better = registry.register(inst_a)
    linked(better.id, 0.9)
    assert bake_of(better.id) == 300.0
