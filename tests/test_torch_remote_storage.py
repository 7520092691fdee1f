"""The port's client-server storage backend on the CPU, against the JAX
package's: the wire codec, the storage daemon, the remote client and the
Event Server's storage-outage path.

- ``data/storage/wire.py``: every record type and event round-trips,
  datetimes to the microsecond, and each package decodes the other's
  encoding to the same values.
- Cross-package interop: one script of DAO calls (apps, access keys,
  channels, engine and evaluation instances, engine manifests, models,
  events with their reads) through the port's client against the JAX
  daemon, the JAX client against the port's daemon, and each package's
  client against its own daemon: the same answers in all four.
- The daemon and the client (the JAX tests/test_remote_storage.py and
  tests/test_resilience.py cases): paging across pages and a limit over
  pages, the reversed keyset, pages exact under a concurrent insert, a
  lost response deduped on retry, a stale kept-alive socket retried, a
  concurrent same-``req_id`` write applied once, ``ping``, an expired
  deadline shed as ``DeadlineExceeded``, a probe released after a local
  deadline, the breakers isolated per DAO with the ``dao`` label, the
  ``storage.rpc`` fault and its client span under which the daemon's
  server span parents, auth by ``X-PIO-Storage-Key``, the allow-list.
- The Event Server over a remote store, on the port and on the JAX
  server side by side (the JAX tests/test_chaos_e2e.py cases): the
  injected outage spills (202) and replays once; a daemon SIGKILLed
  mid-ingest and restarted on its port loses and duplicates nothing;
  the breaker opens, fails fast and closes through its probe; a write
  the daemon applied but could not acknowledge, then spilled and
  replayed, lands once on the port (the Event Server gives the event its
  id before the write) and twice on the JAX server.
"""

import concurrent.futures
import dataclasses
import datetime as dt
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

pytest.importorskip("jax")

from predictionio_tpu.data import event as jevent  # noqa: E402
from predictionio_tpu.data.api import server as jes  # noqa: E402
from predictionio_tpu.data.api import storage_server as jss  # noqa: E402
from predictionio_tpu.data.storage import base as jbase  # noqa: E402
from predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from predictionio_tpu.data.storage import remote as jremote  # noqa: E402
from predictionio_tpu.data.storage import wire as jwire  # noqa: E402
from predictionio_tpu.resilience import breaker as jbreaker  # noqa: E402
from predictionio_tpu.resilience import faults as jfaults  # noqa: E402
from predictionio_tpu_torch.data import event as tevent  # noqa: E402
from predictionio_tpu_torch.data.api import server as tes  # noqa: E402
from predictionio_tpu_torch.data.api import storage_server as tss  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from predictionio_tpu_torch.data.storage import remote as tremote  # noqa: E402
from predictionio_tpu_torch.data.storage import wire  # noqa: E402
from predictionio_tpu_torch.obs import spans  # noqa: E402
from predictionio_tpu_torch.obs.registry import get_default_registry  # noqa: E402
from predictionio_tpu_torch.resilience import breaker  # noqa: E402
from predictionio_tpu_torch.resilience import deadline  # noqa: E402
from predictionio_tpu_torch.resilience import faults  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T0 = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)

# package name → (event, base, registry, daemon, client module)
PKG = {"port": (tevent, tbase, treg, tss, tremote),
       "jax": (jevent, jbase, jreg, jss, jremote)}


@pytest.fixture(autouse=True)
def _clean_faults_and_breakers():
    for module in (faults, jfaults):
        module.clear()
    for module in (breaker, jbreaker):
        module.reset_breakers()
    yield
    for module in (faults, jfaults):
        module.clear()
    for module in (breaker, jbreaker):
        module.reset_breakers()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _daemon_storage(pkg, path):
    reg = PKG[pkg][2]
    path.mkdir(parents=True, exist_ok=True)
    return reg.Storage(reg.StorageConfig(
        sources={"SQL": reg.SourceConfig("SQL", "sqlite", {"PATH": str(path / "pio.db")}),
                 "FS": reg.SourceConfig("FS", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "SQL", "EVENTDATA": "SQL", "MODELDATA": "FS"}))


def _daemon(pkg, path, **kw):
    return PKG[pkg][3].StorageServer(_daemon_storage(pkg, path), host="127.0.0.1",
                                     port=kw.pop("port", 0), **kw).start()


def _remote(pkg, port, **settings):
    """A `pkg` Storage whose every repository is the daemon on `port`."""
    reg = PKG[pkg][2]
    return reg.Storage(reg.StorageConfig(
        sources={"R": reg.SourceConfig("R", "remote", {"HOST": "127.0.0.1",
                                                       "PORT": str(port), **settings})},
        repositories={"METADATA": "R", "EVENTDATA": "R", "MODELDATA": "R"}))


def _store(port, **settings):
    return tremote.RemoteEventStore({"HOST": "127.0.0.1", "PORT": str(port), **settings})


def _views(event_cls, n, t0=T0):
    return [event_cls(event="view", entity_type="user", entity_id=f"u{i:03d}",
                      event_time=t0 + dt.timedelta(seconds=i)) for i in range(n)]


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------


def _records(pkg):
    ev, base = PKG[pkg][0], PKG[pkg][1]
    t = dt.datetime(2021, 6, 1, 12, 0, 0, 123456, tzinfo=dt.timezone.utc)
    return [
        ev.Event(event="buy", entity_type="user", entity_id="u1", target_entity_type="item",
                 target_entity_id="i1", properties={"qty": 2, "tags": ["a"]},
                 event_time=t, creation_time=t, event_id="e1", tags=("x",), pr_id="p"),
        base.EventQuery(app_id=3, channel_id=4, start_time=t, until_time=t,
                        entity_type="user", entity_id="u1", event_names=["buy", "view"],
                        target_entity_type="item", target_entity_id="i1", limit=5,
                        reversed=True, start_after=(t, "e9")),
        base.App(id=1, name="a", description="d"),
        base.AccessKey(key="k", app_id=1, events=("buy",)),
        base.Channel(id=2, name="c", app_id=1),
        base.EngineInstance(id="i", status="COMPLETED", start_time=t, end_time=t,
                            engine_id="e", engine_version="v", engine_variant="var",
                            engine_factory="f", batch="b", env={"A": "1"},
                            data_source_params="{}", algorithms_params="[]"),
        base.EvaluationInstance(id="ev", status="EVALCOMPLETED", start_time=t, end_time=t,
                                evaluation_class="C", evaluator_results="r"),
        base.EngineManifest(id="m", version="1", name="n", description=None,
                            files=("a.py", "b.py"), engine_factory="f"),
        base.Model(id="mid", models=b"\x00blob\xff"),
        [t, b"\x01", {"k": (1, 2.5, None, True)}],
    ]


def _plain(v):
    if dataclasses.is_dataclass(v):
        d = {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if "properties" in d and hasattr(v.properties, "to_dict"):
            d["properties"] = v.properties.to_dict()
        d.pop("shard", None)  # None throughout the records here
        return d
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def test_wire_round_trips_and_crosses_packages():
    mine, theirs = _records("port"), _records("jax")
    for t_rec, j_rec in zip(mine, theirs):
        enc, jenc = wire.encode(t_rec), jwire.encode(j_rec)
        assert json.loads(json.dumps(enc)) == json.loads(json.dumps(jenc))  # the same bytes
        assert _plain(wire.decode(enc)) == _plain(t_rec)
        assert _plain(wire.decode(jenc)) == _plain(t_rec)  # theirs decoded here
        assert _plain(jwire.decode(enc)) == _plain(j_rec)  # ours decoded there
    ev = wire.decode(wire.encode(mine[0]))
    assert ev.event_time.microsecond == 123456 and ev.creation_time == mine[0].creation_time
    # the shard filter crosses in both directions
    q = wire.decode(jwire.encode(jbase.EventQuery(app_id=1, shard=(0, 2))))
    assert q.shard == (0, 2)
    assert jwire.decode(wire.encode(q)).shard == (0, 2)
    assert json.dumps(wire.encode(q)) == json.dumps(jwire.encode(
        jbase.EventQuery(app_id=1, shard=(0, 2))))
    with pytest.raises(TypeError, match="cannot encode"):
        wire.encode(object())


# ---------------------------------------------------------------------------
# cross-package interop: one DAO script through four client/daemon pairs
# ---------------------------------------------------------------------------


def _dao_script(pkg, storage):
    ev, base = PKG[pkg][0], PKG[pkg][1]
    t = dt.datetime(2024, 3, 1, 0, 0, 0, 250000, tzinfo=dt.timezone.utc)
    out = []
    apps = storage.get_meta_data_apps()
    out += [apps.insert(base.App(0, "one", "first")), apps.insert(base.App(0, "two")),
            apps.insert(base.App(0, "one")), apps.get(1), apps.get_by_name("two"),
            apps.update(base.App(2, "two", "renamed")), apps.get_all(), apps.delete(9)]
    keys = storage.get_meta_data_access_keys()
    out += [keys.insert(base.AccessKey("K1", 1, ("buy",))),
            keys.insert(base.AccessKey("K2", 2)), keys.get("K1"), keys.get_by_app_id(1),
            keys.update(base.AccessKey("K2", 2, ("view",))), keys.get_all(),
            keys.delete("K2"), keys.get("K2")]
    chans = storage.get_meta_data_channels()
    out += [chans.insert(base.Channel(0, "hold", 1)), chans.insert(base.Channel(0, "bad name", 1)),
            chans.get_by_app_id(1), chans.get(1)]
    inst = storage.get_meta_data_engine_instances()
    rows = [base.EngineInstance(id=f"ei{n}", status=s, start_time=t + dt.timedelta(hours=n),
                                end_time=t, engine_id="e", engine_version="1",
                                engine_variant="v", engine_factory="f", env={"n": str(n)})
            for n, s in enumerate(("COMPLETED", "TRAINING", "COMPLETED"))]
    out += [inst.insert(r) for r in rows]
    out += [inst.get("ei1"), inst.get_completed("e", "1", "v"),
            inst.get_latest_completed("e", "1", "v"), inst.update(rows[1]), len(inst.get_all())]
    evals = storage.get_meta_data_evaluation_instances()
    out += [evals.insert(base.EvaluationInstance(id="ev1", status="EVALCOMPLETED",
                                                 start_time=t, end_time=t)),
            evals.get("ev1"), evals.get_completed()]
    man = storage.get_meta_data_engine_manifests()
    m = base.EngineManifest(id="m", version="1", name="n", files=("a.py",), engine_factory="f")
    man.insert(m)
    man.update(dataclasses.replace(m, name="n2"))
    man.update(dataclasses.replace(m, version="2"), True)
    out += [man.get("m", "1"), sorted((x.id, x.version) for x in man.get_all())]
    man.delete("m", "2")
    out += [man.get("m", "2")]
    models = storage.get_model_data_models()
    models.insert(base.Model("blob1", b"\x00\x01\xfe"))
    out += [models.get("blob1"), models.get("none")]
    models.delete("blob1")
    out += [models.get("blob1")]
    events = storage.get_events()
    out += [events.init_app(1), events.init_app(1, 1)]
    batch = [ev.Event(event="rate" if n % 3 else "buy", entity_type="user",
                      entity_id=f"u{n % 4}", target_entity_type="item",
                      target_entity_id=f"i{n % 5}", properties={"rating": n % 5},
                      event_time=t + dt.timedelta(milliseconds=7 * n), event_id=f"e{n:02d}")
             for n in range(12)]
    out += [events.insert_batch(batch[:10], 1), events.insert(batch[10], 1),
            events.insert(batch[11], 1, 1)]
    q = base.EventQuery
    out += [events.find(q(app_id=1)), events.find(q(app_id=1, reversed=True, limit=4)),
            events.find(q(app_id=1, entity_id="u1", event_names=["rate"])),
            events.find(q(app_id=1, start_after=(batch[4].event_time, "e04"))),
            events.find(q(app_id=1, reversed=True, start_after=(batch[4].event_time, "e04"))),
            events.find(q(app_id=1, channel_id=1)), events.get("e03", 1), events.get("zz", 1),
            events.latest_revision(1), events.find_since(1, 8),
            events.find_entities_batch(1, "user", ["u2", "u0"], event_names=["rate"],
                                       limit_per_entity=2),
            events.data_signature(1), events.delete("e05", 1), events.delete("e05", 1),
            events.delete_batch(["e06", "e07", "nope"], 1), len(list(events.find(q(app_id=1)))),
            events.remove_app(1, 1), list(events.find(q(app_id=1, channel_id=1)))]
    return [_plain(list(x) if hasattr(x, "__next__") else x) for x in out]


def _events_plain(answers):
    """Event answers as their JSON dicts without creation times (which
    each store stamps at insert)."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items() if k != "creation_time"}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v
    return strip(answers)


def test_dao_script_is_answered_alike_across_packages(tmp_path):
    results = {}
    for client_pkg in ("port", "jax"):
        for daemon_pkg in ("port", "jax"):
            daemon = _daemon(daemon_pkg, tmp_path / f"{client_pkg}-{daemon_pkg}")
            try:
                storage = _remote(client_pkg, daemon.port)
                results[client_pkg, daemon_pkg] = _events_plain(_dao_script(client_pkg, storage))
            finally:
                daemon.shutdown()
    want = results["jax", "jax"]
    assert results["port", "jax"] == want  # the port's client, the JAX daemon
    assert results["jax", "port"] == want  # the JAX client, the port's daemon
    assert results["port", "port"] == want
    assert want[0:3] == [1, 2, None] and len(want) == 60


# ---------------------------------------------------------------------------
# the daemon and the client
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("daemon_pkg", ["port", "jax"])
def test_find_pages_across_rpc_calls(tmp_path, daemon_pkg):
    daemon = _daemon(daemon_pkg, tmp_path, find_page_size=7)
    try:
        store = _store(daemon.port)
        store.init_app(1)
        store.insert_batch(_views(tevent.Event, 25), 1)
        calls = {"n": 0}
        orig = store._client.call

        def counting(dao, method, *a, **kw):
            calls["n"] += method == "find"
            return orig(dao, method, *a, **kw)

        store._client.call = counting
        got = [e.entity_id for e in store.find(tbase.EventQuery(app_id=1))]
        assert got == [f"u{i:03d}" for i in range(25)] and calls["n"] == 4
        calls["n"] = 0
        assert len(list(store.find(tbase.EventQuery(app_id=1, limit=10)))) == 10
        assert calls["n"] == 2
        got = [e.entity_id for e in store.find(tbase.EventQuery(app_id=1, reversed=True))]
        assert got == [f"u{i:03d}" for i in reversed(range(25))]
        # FIND_PAGE bounds each request from the client side too
        store.FIND_PAGE = 3
        calls["n"] = 0
        assert len(list(store.find(tbase.EventQuery(app_id=1)))) == 25 and calls["n"] == 9
    finally:
        daemon.shutdown()


def test_paged_find_exact_under_a_concurrent_insert(tmp_path):
    daemon = _daemon("port", tmp_path, find_page_size=5)
    try:
        store = _store(daemon.port)
        store.init_app(1)
        store.insert_batch(_views(tevent.Event, 17), 1)
        orig, pages = store._client.call, {"n": 0}

        def interfering(dao, method, *a, **kw):
            result = orig(dao, method, *a, **kw)
            if method == "find":
                pages["n"] += 1
                if pages["n"] == 1:  # an earlier event lands between pages
                    orig("events", "insert", tevent.Event(
                        event="view", entity_type="user", entity_id="early",
                        event_time=T0 - dt.timedelta(hours=1)), 1, None)
            return result

        store._client.call = interfering
        got = [e.entity_id for e in store.find(tbase.EventQuery(app_id=1))]
        assert len(got) == len(set(got)) and {f"u{i:03d}" for i in range(17)} <= set(got)
    finally:
        daemon.shutdown()


def test_event_datetimes_cross_the_daemon_to_the_microsecond(tmp_path):
    """Through the daemon's memory store the microseconds survive (the
    public JSON form would cut them to milliseconds)."""
    storage = treg.Storage(treg.StorageConfig.memory())
    daemon = tss.StorageServer(storage, host="127.0.0.1", port=0).start()
    try:
        store = _store(daemon.port)
        t = dt.datetime(2021, 6, 1, 12, 0, 0, 123456, tzinfo=dt.timezone.utc)
        store.insert(tevent.Event(event="buy", entity_type="user", entity_id="u1",
                                  event_time=t, creation_time=t, event_id="e1"), 1)
        [got] = list(store.find(tbase.EventQuery(app_id=1)))
        assert got.event_time == t and got.creation_time == t
        # the keyset cursor compares at that precision too
        later = dataclasses.replace(got, event_id="e2",
                                    event_time=t + dt.timedelta(microseconds=1))
        store.insert(later, 1)
        q = tbase.EventQuery(app_id=1, start_after=(t, "e1"))
        assert [e.event_id for e in store.find(q)] == ["e2"]
    finally:
        daemon.shutdown()


class _FlakyResponse:
    """Delivers the request (the daemon applies it), then loses the
    response."""

    def __init__(self, real):
        self.real = real

    def request(self, *a, **kw):
        self.real.request(*a, **kw)

    def getresponse(self):
        self.real.getresponse().read()
        raise http.client.HTTPException("connection lost mid-response")

    def close(self):
        self.real.close()


class _IdleClosed:
    """A reused socket the daemon closed: the request never arrives."""

    def request(self, *a, **kw):
        pass

    def getresponse(self):
        raise http.client.RemoteDisconnected("Remote end closed connection without response")

    def close(self):
        pass


@pytest.mark.parametrize("daemon_pkg", ["port", "jax"])
def test_lost_response_and_stale_socket_retry_once(tmp_path, daemon_pkg):
    daemon = _daemon(daemon_pkg, tmp_path)
    try:
        store = _store(daemon.port)
        store.init_app(1)
        client = store._client
        client._local.conn = _FlakyResponse(client._conn())
        eid = store.insert(tevent.Event(event="buy", entity_type="user", entity_id="once"), 1)
        client._local.conn = _IdleClosed()
        store.insert(tevent.Event(event="buy", entity_type="user", entity_id="retry-me"), 1)
        got = list(store.find(tbase.EventQuery(app_id=1)))
        assert sorted(e.entity_id for e in got) == ["once", "retry-me"]
        assert eid in {e.event_id for e in got}  # the replayed id is the applied one
    finally:
        daemon.shutdown()


@pytest.mark.parametrize("daemon_pkg", ["port", "jax"])
def test_concurrent_same_req_id_applies_once(tmp_path, daemon_pkg):
    daemon = _daemon(daemon_pkg, tmp_path)
    try:
        store = _store(daemon.port)
        store.init_app(1)
        body = json.dumps({
            "dao": "events", "method": "insert", "req_id": "fixed-req-id",
            "args": [wire.encode(tevent.Event(event="buy", entity_type="user",
                                              entity_id="racer")), 1, None],
            "kwargs": {}}).encode()

        def fire(_):
            conn = http.client.HTTPConnection("127.0.0.1", daemon.port, timeout=30)
            conn.request("POST", "/rpc", body=body, headers={"Content-Type": "application/json"})
            out = json.loads(conn.getresponse().read())
            conn.close()
            return out

        with concurrent.futures.ThreadPoolExecutor(max_workers=20) as ex:
            results = list(ex.map(fire, range(20)))
        assert len({r["result"] for r in results if r["ok"]}) == 1
        assert [e.entity_id for e in store.find(tbase.EventQuery(app_id=1))] == ["racer"]
    finally:
        daemon.shutdown()


def test_ping_takes_only_a_daemon(tmp_path):
    daemon = _daemon("port", tmp_path)
    try:
        assert tremote.RemoteClient({"HOST": "127.0.0.1", "PORT": str(daemon.port)}).ping()
    finally:
        daemon.shutdown()
    import http.server
    import threading

    class NotFound(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(404)
            self.send_header("Content-Length", "4")
            self.end_headers()
            self.wfile.write(b"nope")

        def log_message(self, *a):
            pass

    impostor = http.server.HTTPServer(("127.0.0.1", 0), NotFound)
    threading.Thread(target=impostor.serve_forever, daemon=True).start()
    try:
        port = impostor.server_address[1]
        assert not tremote.RemoteClient({"HOST": "127.0.0.1", "PORT": str(port)}).ping()
    finally:
        impostor.shutdown()
    dead = tremote.RemoteClient({"HOST": "127.0.0.1", "PORT": str(_free_port())})
    assert dead.ping() is False


@pytest.mark.parametrize("daemon_pkg", ["port", "jax"])
def test_expired_deadline_is_shed_and_releases_the_probe(tmp_path, daemon_pkg):
    daemon = _daemon(daemon_pkg, tmp_path)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", daemon.port, timeout=5)
        conn.request("POST", "/rpc", body=json.dumps(
            {"dao": "events", "method": "init_app", "args": [1], "kwargs": {}}).encode(),
            headers={"Content-Type": "application/json", "X-PIO-Deadline": "0"})
        payload = json.loads(conn.getresponse().read())
        conn.close()
        assert payload == {"ok": False, "shed": True, "error": "deadline expired; rpc shed"}
        store = _store(daemon.port, RETRY_ATTEMPTS="1", BREAKER_THRESHOLD="1",
                       BREAKER_COOLDOWN="0.0")
        b = store._client.breaker_for("events")
        faults.install(faults.FaultSpec("storage.rpc", "error", 1.0))
        with pytest.raises(tbase.StorageUnreachableError):
            store.init_app(1)
        faults.clear()
        assert b.state in ("open", "half_open")
        # the probe's own deadline expired before any I/O: it is released
        with deadline.deadline_scope(deadline.from_budget(-1.0)):
            with pytest.raises(deadline.DeadlineExceeded):
                store.init_app(1)
        assert store.init_app(1) is True and b.state == "closed"
    finally:
        daemon.shutdown()


def test_breakers_are_per_dao(tmp_path):
    daemon = _daemon("jax", tmp_path)
    try:
        storage = _remote("port", daemon.port, RETRY_ATTEMPTS="1", BREAKER_THRESHOLD="2",
                          BREAKER_COOLDOWN="60")
        apps, events = storage.get_meta_data_apps(), storage.get_events()
        app_id = apps.insert(tbase.App(0, "daoapp"))
        events.init_app(app_id)
        client = events._client
        assert client is apps._client  # one client a source
        ev_b, meta_b = client.breaker_for("events"), client.breaker_for("apps")
        assert ev_b is not meta_b
        ev_b.record_failure()
        ev_b.record_failure()
        with pytest.raises(tbase.StorageCircuitOpenError, match="for the events DAO"):
            events.init_app(app_id)
        assert apps.get(app_id).name == "daoapp" and meta_b.state == "closed"
        gauge = get_default_registry().gauge("resilience_breaker_state", "",
                                             ("endpoint", "dao"))
        ep = f"storage:127.0.0.1:{daemon.port}"
        assert gauge.value(endpoint=f"{ep}/events", dao="events") == 1.0
        assert gauge.value(endpoint=f"{ep}/apps", dao="apps") == 0.0
    finally:
        daemon.shutdown()


def test_rpc_fault_corrupt_span_and_parenting(tmp_path):
    """`storage.rpc:corrupt` garbles an answer into a StorageError (no
    breaker verdict); each call is a storage.rpc client span whose id
    the daemon's server.request span names as its parent, in one trace."""
    daemon = _daemon("port", tmp_path)
    rec = spans.get_default_recorder()
    try:
        store = _store(daemon.port)
        faults.install(faults.FaultSpec("storage.rpc", "corrupt", 1.0))
        with pytest.raises(tbase.StorageError, match="fault-injected corrupt response"):
            store.init_app(1)
        assert store._client.breaker_for("events").state == "closed"
        faults.clear()
        t_mark = time.time() - 1
        with rec.span("caller") as root:
            assert store.init_app(1) is True
        deadline_at = time.time() + 5
        while time.time() < deadline_at:
            got = [s for s in rec.recent(t_mark) if s.trace_id == root.trace_id]
            if any(s.name == "server.request" for s in got):
                break
            time.sleep(0.02)
        by_name = {s.name: s for s in got}
        client, server = by_name["storage.rpc"], by_name["server.request"]
        assert client.parent_span_id == root.span_id
        assert server.parent_span_id == client.span_id
        assert client.attrs["dao"] == "events" and client.attrs["method"] == "init_app"
        assert server.attrs["server"] == "storage" and server.attrs["path"] == "/rpc"
    finally:
        daemon.shutdown()


def test_auth_key_and_allow_list(tmp_path):
    daemon = tss.StorageServer(_daemon_storage("port", tmp_path), host="127.0.0.1", port=0,
                               auth_key="s3cret").start()
    try:
        with pytest.raises(tbase.StorageError, match="bad storage key"):
            _store(daemon.port).init_app(1)
        assert _store(daemon.port, AUTH_KEY="s3cret").init_app(1) is True
        client = tremote.RemoteClient({"HOST": "127.0.0.1", "PORT": str(daemon.port),
                                       "AUTH_KEY": "s3cret"})
        for dao, method in (("events", "close"), ("replication", "close"), ("x", "get")):
            with pytest.raises(tbase.StorageError, match=f"unknown rpc {dao}.{method}"):
                client.call(dao, method)
        # the replication DAO routes through the events getter, as the JAX
        # daemon's does: a sqlite store has no replica method to run
        with pytest.raises(tbase.StorageError,
                           match="rpc replication.promote failed: AttributeError"):
            client.call("replication", "promote", 2)
        assert client.ping()
        with urllib.request.urlopen(f"http://127.0.0.1:{daemon.port}/metrics", timeout=5) as r:
            text = r.read().decode()
        assert 'storage_rpc_total{dao="events",method="init_app"} 1' in text
    finally:
        daemon.shutdown()


# ---------------------------------------------------------------------------
# the Event Server over a remote store: outages, side by side with JAX's
# ---------------------------------------------------------------------------

FAST = {"RETRY_ATTEMPTS": "2", "RETRY_BASE_DELAY": "0.01", "BREAKER_THRESHOLD": "2",
        "BREAKER_COOLDOWN": "0.3"}


def _post(port, key, body, batch=False):
    path = "/batch/events.json" if batch else "/events.json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}?accessKey={key}",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "null")


def _metrics(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        return r.read().decode()


def _value(text, prefix, **labels):
    """The sample of the first line that starts with `prefix` and holds
    every `labels` pair, or None."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    for line in text.splitlines():
        if line.startswith(prefix) and all(w in line for w in want):
            return float(line.rsplit(" ", 1)[1])
    return None


def _buy(entity):
    return {"event": "buy", "entityType": "user", "entityId": entity,
            "targetEntityType": "item", "targetEntityId": "i1"}


def _event_server(pkg, storage, wal):
    module = {"port": tes, "jax": jes}[pkg]
    base = PKG[pkg][1]
    app_id = storage.get_meta_data_apps().insert(base.App(0, "chaos"))
    storage.get_events().init_app(app_id)
    storage.get_meta_data_access_keys().insert(base.AccessKey(key="CK", app_id=app_id))
    srv = module.EventServer(storage, module.EventServerConfig(
        ip="127.0.0.1", port=0, wal_dir=str(wal), wal_replay_interval_s=0.1))
    return srv, srv.start(), app_id


def _drained(port, want, timeout=20.0):
    deadline_at = time.time() + timeout
    text = ""
    while time.time() < deadline_at:
        text = _metrics(port)
        if _value(text, "event_wal_replayed_total ") == want:
            return text
        time.sleep(0.1)
    raise AssertionError(f"not drained to {want}:\n{text}")


def _injected_outage(pkg, tmp_path):
    daemon = _daemon(pkg, tmp_path / "store")
    storage = _remote(pkg, daemon.port, **FAST)
    srv, port, app_id = _event_server(pkg, storage, tmp_path / "wal")
    try:
        first = _post(port, "CK", _buy("u-ok"))[0]
        for module in (faults, jfaults):
            module.install(module.FaultSpec("storage.rpc", "error", 1.0))
        spilled = [_post(port, "CK", _buy(f"u-spill-{i}")) for i in range(5)]
        spilled_batch = _post(port, "CK", [_buy("u-b0"), _buy("u-b1")], batch=True)
        text = _metrics(port)
        state = _value(text, "resilience_breaker_state{", dao="events",
                       endpoint=f"storage:127.0.0.1:{daemon.port}/events")
        for module in (faults, jfaults):
            module.clear()
        text = _drained(port, 7)
        rows = list(storage.get_events().find(PKG[pkg][1].EventQuery(app_id=app_id)))
        return {"first": first, "spilled": [s for s, _ in spilled],
                "wal_ids": all(b.get("walId") for _, b in spilled),
                "batch": [r["status"] for r in spilled_batch[1]],
                "breaker_open": state in (1.0, 2.0),
                "spilled_total": _value(text, "event_wal_spilled_total "),
                "pending": _value(text, "event_wal_pending "),
                "entities": sorted(e.entity_id for e in rows)}
    finally:
        srv.stop()
        daemon.shutdown()


def test_injected_outage_spills_and_replays_like_jax(tmp_path):
    got = _injected_outage("port", tmp_path / "port")
    want = _injected_outage("jax", tmp_path / "jax")
    assert got == want
    assert got["spilled"] == [202] * 5 and got["batch"] == [202, 202] and got["wal_ids"]
    assert got["breaker_open"] and got["spilled_total"] == 7 and got["pending"] == 0
    assert got["entities"] == sorted(["u-ok", "u-b0", "u-b1"]
                                     + [f"u-spill-{i}" for i in range(5)])


def _spawn_daemon(pkg, path, port):
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_SQL_PATH": str(path / "shared.db"),
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
           "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(path),
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS"}
    argv = (["-m", "predictionio_tpu_torch.tools.console", "storageserver", "--ip", "127.0.0.1"]
            if pkg == "port" else ["-m", "predictionio_tpu.data.api.storage_server",
                                   "--host", "127.0.0.1"])
    proc = subprocess.Popen([sys.executable, *argv, "--port", str(port)], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    client = tremote.RemoteClient({"HOST": "127.0.0.1", "PORT": str(port)})
    deadline_at = time.time() + 60
    while time.time() < deadline_at:
        if client.ping():
            return proc
        assert proc.poll() is None, f"the {pkg} daemon exited {proc.returncode}"
        time.sleep(0.1)
    proc.kill()
    raise TimeoutError(f"the {pkg} daemon on :{port} never became healthy")


def _killed_daemon(pkg, tmp_path):
    tmp_path.mkdir(parents=True)
    port = _free_port()
    proc = _spawn_daemon(pkg, tmp_path, port)
    srv = None
    try:
        storage = _remote(pkg, port, **FAST)
        srv, es_port, app_id = _event_server(pkg, storage, tmp_path / "wal")
        live = [_post(es_port, "CK", _buy(f"u-live-{i}"))[0] for i in range(5)]
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        outage = [_post(es_port, "CK", _buy(f"u-out-{i}")) for i in range(5)]
        batch = _post(es_port, "CK", [_buy("u-ob0"), _buy("u-ob1")], batch=True)
        text = _metrics(es_port)
        endpoint = f"storage:127.0.0.1:{port}/events"
        opened = _value(text, "resilience_breaker_state{", dao="events", endpoint=endpoint)
        pending = _value(text, "event_wal_pending ")
        proc = _spawn_daemon(pkg, tmp_path, port)
        text = _drained(es_port, 7)
        rows = list(storage.get_events().find(PKG[pkg][1].EventQuery(app_id=app_id)))
        closed = _value(text, "resilience_breaker_transitions_total{", dao="events",
                        endpoint=endpoint, state="closed")
        return {"live": live, "outage": [s for s, _ in outage],
                "batch": [r["status"] for r in batch[1]], "opened": opened in (1.0, 2.0),
                "pending": pending, "closed": closed,
                "ids": sorted(e.entity_id for e in rows),
                "unique": len({e.event_id for e in rows}) == len(rows)}
    finally:
        if srv is not None:
            srv.stop()
        proc.kill()
        proc.wait(timeout=10)


def test_killed_daemon_mid_ingest_loses_and_duplicates_nothing(tmp_path):
    got = _killed_daemon("port", tmp_path / "port")
    want = _killed_daemon("jax", tmp_path / "jax")
    assert got == want
    assert got["live"] == [201] * 5 and got["outage"] == [202] * 5
    assert got["batch"] == [202, 202] and got["opened"] and got["pending"] == 7
    assert got["closed"] >= 1 and got["unique"]
    assert got["ids"] == sorted([f"u-live-{i}" for i in range(5)]
                                + [f"u-out-{i}" for i in range(5)] + ["u-ob0", "u-ob1"])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_breaker_opens_fails_fast_and_recovers(tmp_path, pkg):
    port = _free_port()
    daemon = _daemon(pkg, tmp_path, port=port)
    mod = PKG[pkg][4]
    store = mod.RemoteEventStore({"HOST": "127.0.0.1", "PORT": str(port), **FAST,
                                  "BREAKER_COOLDOWN": "0.4"})
    store.init_app(1)
    daemon.shutdown()
    conn = getattr(store._client._local, "conn", None)
    if conn is not None:  # the in-process daemon's kept-alive socket
        conn.close()
        store._client._local.conn = None
    b = store._client.breaker_for("events")
    base = PKG[pkg][1]
    for _ in range(2):
        with pytest.raises(base.StorageUnreachableError):
            store.init_app(1)
    assert b.state == "open"
    t0 = time.perf_counter()
    with pytest.raises(base.StorageCircuitOpenError):
        store.init_app(1)
    assert time.perf_counter() - t0 < 0.05
    daemon2 = _daemon(pkg, tmp_path, port=port)
    try:
        time.sleep(0.45)
        assert b.state == "half_open"
        assert store.init_app(1) is True and b.state == "closed"
    finally:
        daemon2.shutdown()


def _applied_then_spilled(pkg, tmp_path):
    """One POST whose insert the daemon applies while its answer is lost,
    and whose retry finds the daemon unreachable: spilled (202), then
    replayed. Returns the 202 and the rows of that entity."""
    daemon = _daemon(pkg, tmp_path / "store")
    storage = _remote(pkg, daemon.port, RETRY_ATTEMPTS="2", RETRY_BASE_DELAY="0.01",
                      BREAKER_THRESHOLD="5", BREAKER_COOLDOWN="0.3")
    srv, port, app_id = _event_server(pkg, storage, tmp_path / "wal")
    client_cls = PKG[pkg][4].RemoteClient
    real_conn = client_cls._conn
    lost = []

    class InsertLost:
        """Passes calls through until an insert, which the daemon applies
        and whose answer is lost; the daemon is gone after it."""

        def __init__(self, real):
            self.real, self.insert = real, False

        def request(self, method, path, body=None, headers=None):
            self.insert = b'"method":"insert"' in body
            self.real.request(method, path, body=body, headers=headers)

        def getresponse(self):
            if self.insert:
                self.real.getresponse().read()
                lost.append(True)
                raise http.client.HTTPException("connection lost mid-response")
            return self.real.getresponse()

        def close(self):
            self.real.close()

    def lossy(self):
        if lost:
            raise ConnectionRefusedError("the daemon is gone")
        return InsertLost(real_conn(self))

    try:
        _post(port, "CK", _buy("warm"))  # the key is cached
        client_cls._conn = lossy
        try:
            status, body = _post(port, "CK", _buy("once"))
        finally:
            client_cls._conn = real_conn
        assert lost == [True]
        _drained(port, 1)
        rows = [e for e in storage.get_events().find(PKG[pkg][1].EventQuery(app_id=app_id))
                if e.entity_id == "once"]
        return status, body, rows
    finally:
        srv.stop()
        daemon.shutdown()


def test_a_write_applied_then_spilled_lands_once(tmp_path):
    status, body, rows = _applied_then_spilled("port", tmp_path / "port")
    assert status == 202 and body["walId"] and body["eventId"]
    assert [e.event_id for e in rows] == [body["eventId"]]
    # the reference stores the applied row and the replayed one
    jstatus, jbody, jrows = _applied_then_spilled("jax", tmp_path / "jax")
    assert jstatus == 202 and "eventId" not in jbody
    assert len(jrows) == 2 and jbody["walId"] in {e.event_id for e in jrows}
