"""The port's resilience modules on the CPU, against the JAX package.

- ``resilience/deadline.py``: ``parse_header`` (valid and garbage
  headers), ``header_value``, ``expired`` and ``deadline_scope`` equal
  the JAX functions' under one patched clock. Exact.
- ``resilience/faults.py``: ``parse_specs`` gives the same specs for
  valid strings and the same error type and message for invalid ones;
  one seed draws the same fire sequence in both registries; scoped and
  ``scoped_only`` matching, ``corrupt`` where a site can and cannot
  take it, ``delay``, the environment's load (and its bad seed).
- ``GET|POST /debug/faults`` on both packages' Event Servers and the
  port's query server: the same statuses and bodies, 403 without
  ``PIO_FAULTS_ADMIN``, a malformed ``set`` a 400 that cleared nothing.
- The Event Server's shed: a POST with ``X-PIO-Deadline: 0`` is a 503
  with ``Retry-After`` and ``events_shed_total{reason="deadline"}`` in
  both packages, and stores no row; the next request on the same
  kept-alive connection carries no deadline. The ``event.insert``
  fault without a write-ahead log (``wal_dir=None``): 503 (per event in
  a batch) and no row in both packages; with one, 202 with a ``walId``
  in both, each spilled event replayed once, and an expired POST kept
  (not shed) while the log holds pending events.
- The ``online.fold`` seam: ``corrupt`` scrambles the folded rows as the
  JAX fold does, ``error`` fails the fold.
- ``console faults list|set|clear``, on this process's registry and on a
  server's through ``--url``, print what the JAX console prints.
"""

import http.client
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.api import server as jes  # noqa: E402
from predictionio_tpu.data.storage import base as jbase  # noqa: E402
from predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from predictionio_tpu.resilience import deadline as jdeadline  # noqa: E402
from predictionio_tpu.resilience import faults as jfaults  # noqa: E402
from predictionio_tpu_torch.data.api import server as tes  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from predictionio_tpu_torch.resilience import deadline  # noqa: E402
from predictionio_tpu_torch.resilience import faults  # noqa: E402


@pytest.fixture(autouse=True)
def _inert_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

HEADERS = ["0", "1", "250", "1500.5", "-3", "1e11", "-1e11", "", None, "abc",
           "1e12", "-1e12", "inf", "-inf", "nan", " 12 ", "0x10", "5ms", "1_000"]


@pytest.mark.parametrize("value", HEADERS)
def test_parse_header_equals_jax(monkeypatch, value):
    monkeypatch.setattr(time, "monotonic", lambda: 5000.0)
    assert deadline.parse_header(value) == jdeadline.parse_header(value)


def test_header_value_expired_and_scope_equal_jax(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    for at in (None, 99.0, 100.0, 100.0004, 100.25, 160.0):
        assert deadline.header_value(at) == jdeadline.header_value(at)
        with deadline.deadline_scope(at), jdeadline.deadline_scope(at):
            assert deadline.current() == jdeadline.current() == at
            assert deadline.expired() == jdeadline.expired()
            assert deadline.remaining() == jdeadline.remaining()
            assert deadline.header_value() == jdeadline.header_value()
        assert deadline.current() is None
    assert deadline.from_budget(2.5) == jdeadline.from_budget(2.5) == 102.5
    token = deadline.set_deadline(99.5)
    assert deadline.expired()
    deadline.reset(token)
    assert not deadline.expired()


# ---------------------------------------------------------------------------
# the fault registry
# ---------------------------------------------------------------------------

SPECS = [
    "dispatch.device:error:1.0", "dispatch.device@candidate:error:0.5",
    "event.insert:delay:0.3:0.02", "online.fold:corrupt:1", "model.load:error:0",
    "storage.rpc:error:0.2, event.insert:error:1.0", " , dispatch.device:delay:1:0",
    "", "bogus:error:1.0", "dispatch.device:explode:1.0", "dispatch.device:error:1.5",
    "dispatch.device:error:-0.1", "dispatch.device:delay:1.0:-1", "dispatch.device:error",
    "dispatch.device:error:x", "a:b:c:d:e", "dispatch.device:delay:1.0:fast",
    "dispatch.device@:error:1.0", "@candidate:error:1.0",
]


def _parsed(module, text, seed):
    try:
        return [s.to_dict() for s in module.parse_specs(text, seed)]
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e), isinstance(e, ValueError))


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("seed", [None, 7])
def test_parse_specs_equals_jax(text, seed):
    assert _parsed(faults, text, seed) == _parsed(jfaults, text, seed)


def _draws(module, spec_text, n=300, **fire):
    reg = module.FaultRegistry()
    for spec in module.parse_specs(spec_text, 1234):
        reg.install(spec)
    out = []
    for _ in range(n):
        try:
            out.append(reg.fire("dispatch.device", **fire))
        except module.FaultInjected as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("spec, fire", [
    ("dispatch.device:error:0.37", {}),
    ("dispatch.device:corrupt:0.5", {"corruptable": True}),
    ("dispatch.device:corrupt:0.5", {}),
    ("dispatch.device@candidate:error:0.6", {"scope": "candidate"}),
    ("dispatch.device@candidate:error:0.6", {"scope": "live"}),
    ("dispatch.device:error:0.6", {"scope": "candidate", "scoped_only": True}),
    ("dispatch.device:error:0.3,dispatch.device@candidate:error:0.8",
     {"scope": "candidate"}),
    ("dispatch.device:error:0.3,dispatch.device@candidate:error:0.8",
     {"scope": "live"}),
])
def test_one_seed_draws_the_same_faults_as_jax(spec, fire):
    got = _draws(faults, spec, **fire)
    assert got == _draws(jfaults, spec, **fire)
    assert len(set(got)) > 1 or "live" in str(fire) or "scoped_only" in fire


def test_registry_scope_clear_and_inert():
    reg = faults.FaultRegistry()
    assert not reg.active() and reg.fire("dispatch.device") is None
    reg.install(faults.FaultSpec("dispatch.device", "error", 1.0, scope="candidate"))
    assert reg.fire("dispatch.device") is None  # no scope-less spec
    assert reg.fire("dispatch.device", scope="live") is None
    with pytest.raises(faults.FaultInjected):
        reg.fire("dispatch.device", scope="candidate", scoped_only=True)
    reg.install(faults.FaultSpec("dispatch.device", "delay", 1.0, param=0.0))
    assert reg.fire("dispatch.device", scope="live") == "delay"
    assert reg.fire("dispatch.device", scope="live", scoped_only=True) is None
    reg.clear("dispatch.device@candidate")
    assert [s["scope"] for s in reg.specs()] == [None]
    reg.clear()
    assert reg.specs() == [] and not reg.active()


def test_corrupt_only_where_the_site_can_and_delay_sleeps():
    faults.install(faults.FaultSpec("online.fold", "corrupt", 1.0))
    assert faults.fire("online.fold", corruptable=True) == "corrupt"
    with pytest.raises(faults.FaultInjected, match="injected corrupt fault"):
        faults.fire("online.fold")
    faults.install(faults.FaultSpec("model.load", "delay", 1.0, param=0.05))
    t0 = time.perf_counter()
    assert faults.fire("model.load") == "delay"
    assert time.perf_counter() - t0 >= 0.05


def test_environment_load_equals_jax():
    env = {"PIO_FAULTS": "event.insert:error:0.5,dispatch.device@candidate:delay:1:0.01",
           "PIO_FAULTS_SEED": "9"}
    regs = faults.FaultRegistry(), jfaults.FaultRegistry()
    for reg in regs:
        reg.configure_from_env(env)
    assert regs[0].specs() == regs[1].specs()
    for module in (faults, jfaults):
        with pytest.raises(module.FaultSpecError, match="PIO_FAULTS_SEED must be an integer"):
            module.FaultRegistry().configure_from_env({"PIO_FAULTS": "model.load:error:1",
                                                       "PIO_FAULTS_SEED": "x"})
        reg = module.FaultRegistry()
        reg.configure_from_env({"PIO_FAULTS": ""})
        assert not reg.active()


# ---------------------------------------------------------------------------
# the servers' routes
# ---------------------------------------------------------------------------


def _request(port, path, method="GET", body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        headers={"Content-Type": "application/json", **(headers or {})},
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode() or "null"), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "null"), e.headers


def _event_servers():
    """The JAX Event Server (no WAL) and the port's, each over a memory
    store with app 1 and access key KEY."""
    out = []
    for reg, base, module, cfg in (
            (jreg, jbase, jes, {"wal_dir": None}), (treg, tbase, tes, {"wal_dir": None})):
        storage = reg.Storage(reg.StorageConfig(
            sources={"S": reg.SourceConfig("S", "memory", {})},
            repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
        app_id = storage.get_meta_data_apps().insert(base.App(id=0, name="resapp"))
        storage.get_events().init_app(app_id)
        storage.get_meta_data_access_keys().insert(
            base.AccessKey(key="KEY", app_id=app_id, events=()))
        srv = module.EventServer(storage, module.EventServerConfig(
            ip="127.0.0.1", port=0, **cfg))
        srv.start()
        out.append((srv, storage, app_id))
    return out


@pytest.fixture
def event_servers():
    servers = _event_servers()
    yield servers
    for srv, _, _ in servers:
        srv.stop()


FAULT_SCRIPT = [
    ("GET", None),
    ("POST", {"set": "event.insert:error:0.5"}),
    ("POST", {"set": "dispatch.device@candidate:error:1.0", "seed": 3}),
    ("GET", None),
    ("POST", {"clear": "event.insert", "set": "bogus:error:1"}),  # 400: nothing cleared
    ("GET", None),
    ("POST", {"set": "model.load:error:1", "seed": "x"}),
    ("POST", [1, 2]),
    ("POST", {"clear": "event.insert"}),
    ("POST", {"clear": True, "set": "online.fold:corrupt:1"}),
    ("POST", {"clear": True}),
    ("GET", None),
]


def _play_faults(port):
    out = []
    for method, body in FAULT_SCRIPT:
        status, got, _ = _request(port, "/debug/faults", method, body)
        out.append((status, got))
    return out


def test_debug_faults_on_both_event_servers(event_servers, monkeypatch):
    (jsrv, _, _), (tsrv, _, _) = event_servers
    # without PIO_FAULTS_ADMIN: reads only
    monkeypatch.delenv("PIO_FAULTS_ADMIN", raising=False)
    for srv in (jsrv, tsrv):
        assert _request(srv.port, "/debug/faults")[:2] == (200, {"faults": []})
        status, body, _ = _request(srv.port, "/debug/faults", "POST",
                                   {"set": "event.insert:error:1"})
        assert status == 403 and "PIO_FAULTS_ADMIN=1" in body["message"]
    assert faults.specs() == [] and jfaults.specs() == []
    monkeypatch.setenv("PIO_FAULTS_ADMIN", "1")
    want = _play_faults(jsrv.port)
    got = _play_faults(tsrv.port)
    assert [s for s, _ in got] == [200, 200, 200, 200, 400, 200, 400, 400, 200, 200, 200, 200]
    assert got == want


def test_debug_faults_on_the_query_server(monkeypatch):
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm, ALSAlgorithmParams, ALSModel)
    from predictionio_tpu_torch.workflow.server import QueryServer, QueryServerConfig

    rng = np.random.default_rng(4)
    factors = convert.als_factors_from_numpy(
        rng.standard_normal((4, 2)).astype(np.float32),
        rng.standard_normal((5, 2)).astype(np.float32),
        [f"u{i}" for i in range(4)], [f"i{i}" for i in range(5)], {})
    srv = QueryServer(ALSAlgorithm(ALSAlgorithmParams(rank=2)), ALSModel(factors, device="cpu"),
                      QueryServerConfig(ip="127.0.0.1", port=0))
    port = srv.start()
    try:
        monkeypatch.delenv("PIO_FAULTS_ADMIN", raising=False)
        assert _request(port, "/debug/faults", "POST", {"clear": True})[0] == 403
        monkeypatch.setenv("PIO_FAULTS_ADMIN", "1")
        status, body, _ = _request(port, "/debug/faults", "POST",
                                   {"set": "dispatch.device:error:1.0"})
        assert status == 200 and body["faults"][0]["point"] == "dispatch.device"
        # a scope-less spec fails the batch; its per-query retry passes
        status, body, _ = _request(port, "/queries.json", "POST", {"user": "u1", "num": 2})
        assert status == 200 and len(body["item_scores"]) == 2
        status, body, _ = _request(port, "/debug/faults", "POST",
                                   {"set": "dispatch.device@live:error:1.0"})
        status, body, _ = _request(port, "/queries.json", "POST", {"user": "u1", "num": 2})
        assert status == 500 and "injected error fault" in body["message"]
        assert _request(port, "/debug/faults", "POST", {"clear": True})[1] == {"faults": []}
        assert _request(port, "/queries.json", "POST", {"user": "u1", "num": 2})[0] == 200
    finally:
        srv.stop()


EVENT = {"event": "rate", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "i1",
         "properties": {"rating": 4}, "eventTime": "2024-01-01T00:00:00.000Z"}


def _shed_lines(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        text = r.read().decode()
    return sorted(line for line in text.splitlines()
                  if line.startswith(("events_shed_total", "# HELP events_shed",
                                      "# TYPE events_shed")))


def test_event_server_sheds_expired_posts_like_jax(event_servers):
    results = []
    for srv, storage, app_id in event_servers:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        seen = []
        try:
            for path, body, headers in (
                    ("/events.json?accessKey=KEY", EVENT, {"X-PIO-Deadline": "0"}),
                    ("/batch/events.json?accessKey=KEY", [EVENT, EVENT],
                     {"X-PIO-Deadline": "-5"}),
                    ("/webhooks/segmentio.json?accessKey=KEY", {}, {"X-PIO-Deadline": "0"}),
                    ("/events.json?accessKey=NOPE", EVENT, {"X-PIO-Deadline": "0"}),
                    # the same kept-alive connection: no deadline carries over
                    ("/events.json?accessKey=KEY", EVENT, {}),
                    ("/events.json?accessKey=KEY", EVENT, {"X-PIO-Deadline": "60000"}),
                    ("/events.json?accessKey=KEY", EVENT, {"X-PIO-Deadline": "garbage"})):
                conn.request("POST", path, body=json.dumps(body),
                             headers={"Content-Type": "application/json", **headers})
                resp = conn.getresponse()
                payload = json.loads(resp.read().decode())
                seen.append((resp.status, resp.getheader("Retry-After"),
                             payload.get("message") if resp.status != 201 else None))
        finally:
            conn.close()
        rows = list(storage.get_events().find(
            (jbase if srv.__class__ is jes.EventServer else tbase).EventQuery(app_id=app_id)))
        results.append((seen, len(rows), _shed_lines(srv.port)))
    assert results[1] == results[0]
    seen, rows, lines = results[1]
    assert [s[0] for s in seen] == [503, 503, 503, 503, 201, 201, 201]
    assert seen[0] == (503, "1", "deadline expired; event shed")
    assert rows == 3
    assert 'events_shed_total{reason="deadline"} 4' in lines


def test_event_insert_fault_stores_nothing(event_servers):
    """Without a write-ahead log the fault is a 503, per event in a
    batch, and no row: the JAX server's answers."""
    results = []
    for srv, storage, app_id in event_servers:
        for module in (faults, jfaults):
            module.install(module.FaultSpec("event.insert", "error", 1.0))
        single = _request(srv.port, "/events.json?accessKey=KEY", "POST", EVENT)[:2]
        batch = _request(srv.port, "/batch/events.json?accessKey=KEY", "POST",
                         [EVENT, dict(EVENT, event="$bad")])[:2]
        query = (jbase if srv.__class__ is jes.EventServer else tbase).EventQuery
        rows = list(storage.get_events().find(query(app_id=app_id)))
        for module in (faults, jfaults):
            module.clear()
        after = _request(srv.port, "/events.json?accessKey=KEY", "POST", EVENT)[0]
        results.append((single, batch, rows, after))
    assert results[1] == results[0]
    (status, body), (bstatus, bbody), rows, after = results[1]
    assert status == 503 and body["message"].startswith("storage unavailable")
    assert bstatus == 200 and [r["status"] for r in bbody] == [503, 400]
    assert rows == [] and after == 201


def _wal_servers(tmp_path):
    """Both packages' Event Servers with a write-ahead log under
    `tmp_path` (replayed only when a test says so), each over a memory
    store with app 1 and access key KEY."""
    out = []
    for name, reg, base, module in (("jax", jreg, jbase, jes), ("port", treg, tbase, tes)):
        storage = reg.Storage(reg.StorageConfig(
            sources={"S": reg.SourceConfig("S", "memory", {})},
            repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
        app_id = storage.get_meta_data_apps().insert(base.App(id=0, name="walapp"))
        storage.get_events().init_app(app_id)
        storage.get_meta_data_access_keys().insert(
            base.AccessKey(key="KEY", app_id=app_id, events=()))
        srv = module.EventServer(storage, module.EventServerConfig(
            ip="127.0.0.1", port=0, wal_dir=str(tmp_path / name / "wal"),
            wal_replay_interval_s=3600.0))
        srv.start()
        out.append((srv, storage, app_id, base))
    return out


def _metric(port, name):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
    return None


def test_event_insert_fault_spills_and_replays_once(tmp_path):
    """With a write-ahead log the fault is a 202 with a walId (per event
    in a batch), in both packages; once cleared, one replay pass lands
    every spilled event once, under its walId as the event id, and a
    second pass lands nothing."""
    servers = _wal_servers(tmp_path)
    try:
        results = []
        for srv, storage, app_id, base in servers:
            for module in (faults, jfaults):
                module.install(module.FaultSpec("event.insert", "error", 1.0))
            answers = [_request(srv.port, "/events.json?accessKey=KEY", "POST",
                                dict(EVENT, entityId=f"u{n}"))[:2] for n in range(3)]
            answers.append(_request(srv.port, "/batch/events.json?accessKey=KEY", "POST",
                                    [dict(EVENT, entityId="u3"), dict(EVENT, event="$bad"),
                                     dict(EVENT, entityId="u4")])[:2])
            pending = _metric(srv.port, "event_wal_pending")
            stored = list(storage.get_events().find(base.EventQuery(app_id=app_id)))
            for module in (faults, jfaults):
                module.clear()
            first, second = srv.replay_wal_once(), srv.replay_wal_once()
            rows = list(storage.get_events().find(base.EventQuery(app_id=app_id)))
            # the id a 202 acknowledges: the port answers the id it stores the
            # event under, the JAX server the walId it stores it under
            acked = [b.get("eventId", b["walId"]) for _, b in answers[:3]]
            acked += [r.get("eventId", r["walId"]) for r in answers[3][1] if r["status"] == 202]
            results.append({
                "statuses": [s for s, _ in answers[:3]] + [[r["status"] for r in answers[3][1]]],
                "messages": [b["message"] for _, b in answers[:3]],
                "pending": pending, "stored": len(stored), "replayed": (first, second),
                "ids": sorted(e.event_id for e in rows) == sorted(acked),
                "entities": sorted(e.entity_id for e in rows),
                "spilled": _metric(srv.port, "event_wal_spilled_total"),
                "replayed_total": _metric(srv.port, "event_wal_replayed_total"),
                "left": _metric(srv.port, "event_wal_pending"),
            })
        assert results[1] == results[0]
        got = results[1]
        assert got["statuses"] == [202, 202, 202, [202, 400, 202]]
        assert got["pending"] == 5 and got["stored"] == 0
        assert got["replayed"] == (5, 0) and got["ids"]
        assert got["entities"] == [f"u{n}" for n in range(5)]
        assert got["spilled"] == got["replayed_total"] == 5 and got["left"] == 0
    finally:
        for srv, *_ in servers:
            srv.stop()


def test_expired_post_is_kept_while_the_wal_is_pending(tmp_path):
    """An expired POST is shed, except while the write-ahead log holds
    spilled events: then it is spilled too (202), as in the JAX server."""
    servers = _wal_servers(tmp_path)
    try:
        results = []
        for srv, storage, app_id, base in servers:
            for module in (faults, jfaults):
                module.install(module.FaultSpec("event.insert", "error", 1.0))
            seen = [_request(srv.port, "/events.json?accessKey=KEY", "POST", EVENT)[0]]
            seen.append(_request(srv.port, "/events.json?accessKey=KEY", "POST", EVENT,
                                 {"X-PIO-Deadline": "0"})[0])
            for module in (faults, jfaults):
                module.clear()
            seen.append(srv.replay_wal_once())
            seen.append(_request(srv.port, "/events.json?accessKey=KEY", "POST", EVENT,
                                 {"X-PIO-Deadline": "0"})[0])
            rows = list(storage.get_events().find(base.EventQuery(app_id=app_id)))
            results.append((seen, len(rows), _shed_lines(srv.port)))
        assert results[1] == results[0]
        seen, rows, lines = results[1]
        assert seen == [202, 202, 2, 503] and rows == 2
        assert 'events_shed_total{reason="deadline"} 1' in lines
    finally:
        for srv, *_ in servers:
            srv.stop()


# ---------------------------------------------------------------------------
# the fold-in seam
# ---------------------------------------------------------------------------


def test_online_fold_corrupt_and_error_as_in_jax():
    from predictionio_tpu.data.event import Event as JEvent
    from predictionio_tpu.data.storage.memory import MemoryEventStore as JMemory
    from predictionio_tpu.engines.recommendation import engine as jeng
    from predictionio_tpu.models import als as jals
    from predictionio_tpu.online import foldin as jfoldin
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.memory import MemoryEventStore
    from predictionio_tpu_torch.engines.recommendation import engine as teng
    from predictionio_tpu_torch.models import als as tals
    from predictionio_tpu_torch.online import ALSFoldIn, FoldInConfig
    from test_torch_online import (
        _compare_folds, _fold_rows, _fold_setup, _relevant_events)

    class _S:
        def __init__(self, store):
            self.store = store

        def get_events(self):
            return self.store

    def folds():
        rows, tick = _fold_rows()
        t_store, j_store = MemoryEventStore(), JMemory()
        t_rt = _fold_setup(tals, teng, Event, t_store, rows + tick)
        j_rt = _fold_setup(jals, jeng, JEvent, j_store, rows + tick)
        first = f"e{len(rows):06d}"
        cfg = dict(max_items_per_tick=2, grow_chunk=4)
        return ((ALSFoldIn(FoldInConfig(**cfg)), _S(t_store), t_rt,
                 _relevant_events(t_store, first)),
                (jfoldin.ALSFoldIn(jfoldin.FoldInConfig(**cfg)), _S(j_store), j_rt,
                 _relevant_events(j_store, first)))

    (tf, ts, trt, tev), (jf, js, jrt, jev) = folds()
    clean = tf.apply(ts, 1, None, trt, tev)
    for module in (faults, jfaults):
        module.install(module.FaultSpec("online.fold", "corrupt", 1.0))
    (tf, ts, trt, tev), (jf, js, jrt, jev) = folds()
    got, want = tf.apply(ts, 1, None, trt, tev), jf.apply(js, 1, None, jrt, jev)
    _compare_folds(got, want)
    vocab = got[1].factors.user_vocab.to_dict()
    rows = [vocab[u] for u in ("u1", "nu0")]
    np.testing.assert_allclose(got[1].factors.user_factors[rows],
                               clean[1].factors.user_factors[rows] * 40.0 + 7.0,
                               rtol=1e-5, atol=1e-4)
    for module in (faults, jfaults):
        module.install(module.FaultSpec("online.fold", "error", 1.0))
    (tf, ts, trt, tev), _ = folds()
    with pytest.raises(faults.FaultInjected, match="online.fold"):
        tf.apply(ts, 1, None, trt, tev)


def _console(main, argv, capsys):
    code = main(argv)
    captured = capsys.readouterr()
    return code, captured.out, captured.err.splitlines()[-1:] if code else []


def test_console_faults_verbs_print_what_the_jax_console_prints(
        event_servers, capsys, monkeypatch):
    from predictionio_tpu.tools import console as jconsole
    from predictionio_tpu_torch.tools import console

    script = [["faults", "list"], ["faults", "set", "event.insert:error:0.5"],
              ["faults", "set", "dispatch.device@candidate:delay:1:0.2", "--seed", "4"],
              ["faults", "list"], ["faults", "set", "bogus:error:1"],
              ["faults", "clear", "event.insert"], ["faults", "list"],
              ["faults", "clear"], ["faults", "list"]]
    # this process's registry, each console its own package's
    for argv in script:
        got = _console(console.main, argv, capsys)
        want = _console(jconsole.main, argv, capsys)
        assert got == want, argv
    assert got[0] == 0 and "registry inert" in got[1]
    # a running server's, through its POST /debug/faults
    (_, _, _), (tsrv, _, _) = event_servers
    url = ["--url", f"http://127.0.0.1:{tsrv.port}"]
    monkeypatch.delenv("PIO_FAULTS_ADMIN", raising=False)
    refused = _console(console.main, ["faults", "set", "event.insert:error:1", *url], capsys)
    assert refused == _console(jconsole.main, ["faults", "set", "event.insert:error:1", *url],
                               capsys)
    assert refused[0] == 1 and "fault admin refused (403)" in refused[2][0]
    monkeypatch.setenv("PIO_FAULTS_ADMIN", "1")
    outs = []
    for main in (console.main, jconsole.main):
        outs.append([_console(main, argv + url, capsys)
                     for argv in script if argv[1] != "set" or "bogus" not in argv[2]])
    assert outs[0] == outs[1]
    assert "[INFO]   dispatch.device@candidate: delay p=1.0 param=0.2 seed=4" in outs[0][3][1]
