"""The online fold-in slice on the CPU: events POSTed to the port's Event
Server fold into a served model between retrains, against the JAX
package.

The served model is trained by the port (``run_train``, the windowed
path on the CPU) over two taste clusters (even users rate items 0-4,
odd users 5-9) in sqlite storage, deployed by ``build_runtime`` behind
the port's ``QueryServer`` with a consumer attached (``from_latest``),
as the JAX package's tests/test_online_e2e.py serves its own.

- The JAX package's e2e cases on the port (test_online_e2e.py:112-300,
  388-560): a new user personalized without a retrain; a new item
  folded; the item carry over ticks, kept through a lost publish; the
  pause and resume routes and the console's ``online`` verbs; a crash
  before the persist replayed once; a drift breach (a threshold of 0)
  pauses and leaves the last-good model serving; ``reload()`` to a
  retrained instance rebases and resumes; a same-instance rebuild
  refolds; a fresh consumer resumes at the persisted cursor.
- The whole slice against the JAX slice: the same events go to the
  port through its Event Server and to the JAX package's store; each
  consumer ticks until idle over the same trained factors (the port's,
  carried across). Vocabularies equal, factors within rtol 1e-4 and
  atol 1e-5 (the ``fold_in_rows`` bar), counters equal, and every
  answer of the port's server names the JAX predict's items outside
  ties (scores within 1e-4 of each other), scores within atol 1e-4.
- A stress test: eight query threads at a short switch interval while
  the consumer folds twelve ticks; every query answers and no served
  state's tensors change after their publish.
"""

import dataclasses
import datetime as dt
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.data.store.bimap import BiMap as JBiMap  # noqa: E402
from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu.obs.registry import MetricsRegistry as JMetrics  # noqa: E402
from predictionio_tpu.online import (  # noqa: E402
    OnlineConsumer as JConsumer,
    OnlineConsumerConfig as JConfig,
)
from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.models import als as tals  # noqa: E402
from predictionio_tpu_torch.online import (  # noqa: E402
    OnlineConsumer,
    OnlineConsumerConfig,
    ServerApplyHost,
)
from predictionio_tpu_torch.tools import common, console  # noqa: E402
from predictionio_tpu_torch.workflow.core import run_train  # noqa: E402
from predictionio_tpu_torch.workflow.server import (  # noqa: E402
    QueryServer,
    QueryServerConfig,
    build_runtime,
)

APP = "onlapp"
RANK, ITERS = 8, 4
VARIANT = {
    "id": "onl",
    "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
    "datasource": {"params": {"app_name": APP}},
    "algorithms": [{"name": "als", "params": {"rank": RANK, "num_iterations": ITERS}}],
}
T0 = dt.datetime(2024, 7, 1, tzinfo=dt.timezone.utc)
N_SEED_USERS, N_SEED_EVENTS = 8, 20
SCORE_ATOL = 1e-4


def _rate(uid, items, rating=5.0, first=0, make=Event):
    return [make(event="rate", entity_type="user", entity_id=uid,
                 target_entity_type="item", target_entity_id=i,
                 properties={"rating": rating},
                 event_time=T0 + dt.timedelta(seconds=first + n),
                 event_id=f"{uid}-{first + n:06d}")
            for n, i in enumerate(items)]


def _seed_rows(seed=0):
    rng = np.random.RandomState(seed)
    return [(f"u{u}", f"i{rng.randint(0, 5) + (u % 2) * 5}")
            for u in range(N_SEED_USERS) for _ in range(N_SEED_EVENTS)]


def _storage(path):
    path.mkdir(parents=True, exist_ok=True)
    return Storage(StorageConfig(
        sources={"SQL": SourceConfig("SQL", "sqlite", {"PATH": str(path / "pio.db")}),
                 "FS": SourceConfig("FS", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "SQL", "EVENTDATA": "SQL", "MODELDATA": "FS"}))


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "null")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read().decode())


def _query(port, user, num=5):
    status, body = _post(port, "/queries.json", {"user": user, "num": num})
    assert status == 200, body
    return body["item_scores"]


@dataclasses.dataclass
class Served:
    storage: Storage
    server: QueryServer
    port: int
    app_id: int
    key: str

    def insert(self, events):
        self.storage.get_events().insert_batch(events, self.app_id)

    def attach(self, **cfg):
        consumer = self.server.attach_online(
            self.app_id, OnlineConsumerConfig(**{"tick_s": 60, "from_latest": True, **cfg}))
        consumer.stop()  # ticks driven by the test
        return consumer


@pytest.fixture()
def served(tmp_path):
    storage = _storage(tmp_path / "store")
    app, key = common.create_app(storage, APP)
    seed = [e for n, (u, i) in enumerate(_seed_rows())
            for e in _rate(u, [i], first=n)]
    storage.get_events().insert_batch(seed, app.id)
    inst = run_train(storage, VARIANT, device="cpu")
    runtime = build_runtime(storage, inst, device="cpu")
    srv = QueryServer(runtime=runtime, storage=storage, config=QueryServerConfig(
        ip="127.0.0.1", port=0, batch_window_ms=1.0))
    port = srv.start()
    try:
        yield Served(storage, srv, port, app.id, key)
    finally:
        srv.stop()


def _model(srv):
    return srv.runtime.models[0]


# ---------------------------------------------------------------------------
# the JAX package's e2e cases on the port
# ---------------------------------------------------------------------------


def test_new_user_personalized_without_retrain(served):
    """Events POSTed to the Event Server reach the running consumer's
    fold; the new user's first non-empty answer is its own top-k from
    the odd cluster it rated."""
    served.server.attach_online(
        served.app_id, OnlineConsumerConfig(tick_s=0.05, from_latest=True))
    assert _query(served.port, "newbie") == []  # unknown before the fold
    es = EventServer(served.storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    es_port = es.start()
    try:
        body = [e.to_json_dict() for e in _rate("newbie", ["i5", "i6", "i7"], first=10_000)]
        status, out = _post(es_port, f"/batch/events.json?accessKey={served.key}", body)
        assert status == 200 and [r["status"] for r in out] == [201] * 3
    finally:
        es.stop()
    deadline = time.monotonic() + 30.0
    scores = []
    while time.monotonic() < deadline and not scores:
        scores = _query(served.port, "newbie")
        time.sleep(0.02)
    assert scores, "the new user never reached serving"
    assert {s["item"] for s in scores[:3]} <= {f"i{j}" for j in range(5, 10)}, scores
    st = _get(served.port, "/online/status")[1]
    assert st["state"] == "attached" and st["running"]
    assert st["counters"]["events_folded"] >= 3 and st["counters"]["users_folded"] >= 1


def test_new_item_folds_symmetrically(served):
    consumer = served.attach()
    served.insert([e for u in ("u1", "u3", "u5") for e in _rate(u, ["fresh"], first=10_000)])
    out = consumer.tick()
    assert out["stats"]["items_added"] == 1 and out["stats"]["items_folded"] == 1
    model = _model(served.server)
    row = model.factors.item_vocab("fresh")
    assert np.abs(model.factors.item_factors[row]).sum() > 0
    assert row < model.serving_state().n_items  # live in the published slab


def test_new_item_overflow_carries_and_survives_a_lost_publish(served):
    consumer = served.attach()
    consumer.foldin.config = dataclasses.replace(consumer.foldin.config,
                                                 max_items_per_tick=2)
    served.insert(_rate("u1", [f"bulk{j}" for j in range(5)], first=10_000))
    out = consumer.tick()
    assert out["stats"]["items_added"] == 5 and out["stats"]["items_folded"] == 2
    pending = consumer.foldin.pending_items
    assert len(pending) == 3
    # a publish lost to a concurrent swap keeps the carry
    swap = consumer.host.swap
    consumer.host.swap = lambda old, new: False
    assert consumer.tick() == {"retry": "runtime changed during fold"}
    assert consumer.foldin.pending_items == pending
    consumer.host.swap = swap
    # irrelevant traffic drains it too, then idle ticks
    served.insert([Event(event="$set", entity_type="user", entity_id="u1",
                         properties={"plan": "pro"})])
    folded = 2 + consumer.tick()["stats"]["items_folded"]
    for _ in range(3):
        out = consumer.tick()
        if out.get("stats"):
            folded += out["stats"]["items_folded"]
    assert folded == 5 and consumer.foldin.pending_items == []
    assert consumer.tick() == {"idle": "no new events"}
    model = _model(served.server)
    for j in range(5):
        assert np.abs(model.factors.item_factors[model.factors.item_vocab(f"bulk{j}")]).sum() > 0
    # every live row published: the carried slab equals a restage
    sv, want = model.serving_state(), tals.stage_serving(model.factors, device="cpu")
    assert sv.n_items == want.n_items
    for f in ("users", "items", "item_inv_norm"):
        assert getattr(sv, f).equal(getattr(want, f)), f


def test_pause_resume_routes_and_console(served, capsys):
    served.attach()
    url = f"http://127.0.0.1:{served.port}"
    status, st = _post(served.port, "/online/pause", {"reason": "ops"})
    assert status == 200 and st["paused"] == "ops"
    assert console.main(["online", "status", "--url", url]) == 0
    assert "paused: ops" in capsys.readouterr().out
    assert console.main(["online", "resume", "--url", url]) == 0
    assert _get(served.port, "/online/status")[1]["paused"] is None
    assert console.main(["online", "pause", "--url", url, "--reason", "hold"]) == 0
    assert served.server.online.paused == "hold"
    served.server.online.stop()
    served.server.online = None
    assert _post(served.port, "/online/pause", {})[0] == 404
    assert _get(served.port, "/online/status")[1] == {"state": "detached"}
    with pytest.raises(SystemExit):
        console.main(["online", "resume", "--url", url])


def test_killed_mid_tick_no_loss_no_double_apply(served):
    cfg = OnlineConsumerConfig(tick_s=60, from_latest=True)
    c1 = OnlineConsumer(served.storage, ServerApplyHost(served.server), served.app_id, cfg)
    served.insert(_rate("crash-a", ["i5", "i6"], first=10_000))
    assert c1.tick()["folded"] == 2
    served.insert(_rate("crash-b", ["i7", "i8", "i9"], first=20_000))
    c1._crash_after_apply = True
    with pytest.raises(RuntimeError):
        c1.tick()
    assert _query(served.port, "crash-b", 3)  # the fold reached serving ...
    c2 = OnlineConsumer(served.storage, ServerApplyHost(served.server), served.app_id, cfg)
    assert c2.counters["events_folded"] == 2  # ... but was never counted
    assert c2.tick()["folded"] == 3
    assert c2.counters["events_folded"] == c2.counters["events_consumed"] == 5
    assert c2.tick() == {"idle": "no new events"}
    assert c2.counters["events_folded"] == 5
    assert _query(served.port, "crash-b", 3)


def _existing_users_rate(served, first, rating=3.0):
    served.insert([e for u in range(N_SEED_USERS)
                   for e in _rate(f"u{u}", ["i2"], rating, first=first + u)])


def test_drift_breach_pauses_and_serves_the_last_good_model(served):
    consumer = served.attach(drift_threshold=0.0)
    before = served.server.runtime
    answers = _query(served.port, "u1", 10)
    _existing_users_rate(served, 10_000)
    out = consumer.tick()
    assert "paused" in out and out["drift"] > 0.0
    assert served.server.runtime is before  # last-good still serving
    assert _query(served.port, "u1", 10) == answers
    assert consumer.counters["events_consumed"] == 0 and consumer.cursor == {
        "0": served.storage.get_events().latest_revision(served.app_id) - N_SEED_USERS}
    assert consumer.tick() == {"paused": out["paused"]}
    # an operator resume with a sane threshold folds the held window
    consumer.guard.threshold = 1e9
    consumer.resume()
    assert consumer.tick()["folded"] == N_SEED_USERS
    assert served.server.runtime is not before


def test_reload_to_a_retrained_instance_rebases_and_resumes(served):
    consumer = served.attach(drift_threshold=0.0)
    _existing_users_rate(served, 10_000)
    assert "paused" in consumer.tick()
    old_baseline = consumer.guard._baseline
    consumer.guard.threshold = 1e9  # the retrain must not re-pause
    run_train(served.storage, VARIANT, device="cpu")
    served.server.reload()
    out = consumer.tick()
    assert consumer.paused is None and out["folded"] == N_SEED_USERS
    assert consumer.guard._baseline is not old_baseline
    # an operator pause stays through a retrain
    consumer.pause("operator hold")
    run_train(served.storage, VARIANT, device="cpu")
    assert _get(served.port, "/reload")[0] == 200
    assert consumer.tick() == {"paused": "operator hold"}


def test_same_instance_rebuild_refolds(served):
    consumer = served.attach()
    served.insert(_rate("phoenix", ["i5", "i6"], first=10_000))
    assert consumer.tick()["folded"] == 2
    assert _query(served.port, "phoenix", 3)
    status, _ = _post(served.port, "/reload", {})  # the same instance again
    assert status == 200
    assert _query(served.port, "phoenix", 3) == []  # the fold is gone ...
    assert consumer.tick()["folded"] == 2  # ... until the rewind refolds it
    assert _query(served.port, "phoenix", 3)


def test_fresh_consumer_resumes_at_the_persisted_cursor(served, capsys):
    consumer = served.attach()
    served.insert(_rate("r1", ["i1", "i2"], first=10_000))
    assert consumer.tick()["folded"] == 2
    counters, cursor = dict(consumer.counters), dict(consumer.cursor)
    fresh = served.attach()
    assert fresh is not consumer and fresh.cursor == cursor
    assert fresh.tick() == {"idle": "no new events"}
    assert fresh.counters == counters
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(console, "Storage", lambda: served.storage)
        assert console.main(["online", "cursors"]) == 0
    out = capsys.readouterr().out
    assert f"online/{served.app_id}/server:" in out and "events_folded: 2" in out


# ---------------------------------------------------------------------------
# the whole slice against the JAX slice
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Runtime:
    models: list
    instance: object = None


class _Host:
    scope = "server"

    def __init__(self, runtime):
        self.runtime = runtime

    def current(self):
        return self.runtime

    def swap(self, old, new):
        assert self.runtime is old
        self.runtime = new
        return True


def _tick_events():
    """New users on the clusters, old users' new ratings, new items with
    more than a tick's carry (6 > 4), a buy and irrelevant traffic."""
    evs = []
    for n in range(6):
        evs += _rate(f"new{n}", [f"i{5 * (n % 2) + j}" for j in range(3)],
                     float(1 + n % 5), first=10_000 + 10 * n)
    for u in range(0, N_SEED_USERS, 2):
        evs += _rate(f"u{u}", ["i7", "i8"], 2.0, first=20_000 + 10 * u)
    for n in range(6):
        evs += _rate(f"u{n % 4 + 1}", [f"fresh{n}"], 4.0, first=30_000 + n)
    evs.append(dataclasses.replace(_rate("u2", ["fresh0"], first=40_000)[0],
                                   event="buy", properties={}))
    evs.append(Event(event="$set", entity_type="user", entity_id="u3",
                     properties={"plan": "pro"}, event_time=T0, event_id="set-1"))
    return evs


def _ranked_equal(got, want):
    """The same items outside ties, scores within SCORE_ATOL."""
    assert len(got) == len(want)
    gs = np.array([s["score"] for s in got])
    ws = np.array([s.score for s in want])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_ATOL)
    for n, (g, w) in enumerate(zip(got, want)):
        tied = np.abs(ws - ws[n]) <= SCORE_ATOL
        if tied.sum() == 1:
            assert g["item"] == w.item, (n, got, want)
    assert sorted(s["item"] for s in got if not _tied(ws, got, s)) == sorted(
        s.item for s in want if not _tied(ws, None, s))


def _tied(ws, got, s):
    score = s["score"] if got is not None else s.score
    return int((np.abs(ws - score) <= SCORE_ATOL).sum()) > 1


def test_slice_matches_the_jax_slice(served, tmp_path):
    consumer = served.attach()
    consumer.foldin.config = dataclasses.replace(consumer.foldin.config,
                                                 max_items_per_tick=4)
    # the JAX slice: its own store holding the same seed, the port's
    # trained factors carried across, its consumer over a plain host
    js = JStorage(JStorageConfig(
        sources={"M": JSourceConfig("M", "memory", {})},
        repositories={"METADATA": "M", "EVENTDATA": "M", "MODELDATA": "M"}))
    jstore = js.get_events()
    jstore.init_app(served.app_id)
    jstore.insert_batch([e for n, (u, i) in enumerate(_seed_rows())
                         for e in _rate(u, [i], first=n, make=JEvent)], served.app_id)
    f = _model(served.server).factors
    jf = jals.ALSFactors(
        user_factors=f.user_factors.copy(), item_factors=f.item_factors.copy(),
        user_vocab=JBiMap(f.user_vocab.to_dict()), item_vocab=JBiMap(f.item_vocab.to_dict()),
        params=jals.ALSParams(**{k: v for k, v in f.params.__dict__.items()}))
    jhost = _Host(_Runtime([jeng.ALSModel(jf)]))
    jconsumer = JConsumer(js, jhost, served.app_id,
                          JConfig(tick_s=60, from_latest=True, foldin=dataclasses.replace(
                              JConfig().foldin, max_items_per_tick=4)),
                          metrics=JMetrics())

    events = _tick_events()
    es = EventServer(served.storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    es_port = es.start()
    try:
        status, out = _post(es_port, f"/batch/events.json?accessKey={served.key}",
                            [e.to_json_dict() for e in events])
    finally:
        es.stop()
    assert status == 200 and [r["status"] for r in out] == [201] * len(events)
    jstore.insert_batch([JEvent.from_json_dict(e.to_json_dict()) for e in events],
                        served.app_id)

    ticks = 0
    while ticks < 10:
        got, want = consumer.tick(), jconsumer.tick()
        ticks += 1
        assert got.get("stats") == want.get("stats") and got.get("folded") == want.get("folded")
        if got == {"idle": "no new events"}:
            assert want == got
            break
    assert ticks == 3  # the fold, the carry's last two items, idle
    assert consumer.counters == jconsumer.counters
    assert consumer.cursor == jconsumer.cursor
    tm, jm = _model(served.server), jhost.runtime.models[0]
    assert list(tm.factors.user_vocab.items()) == list(jm.factors.user_vocab.items())
    assert list(tm.factors.item_vocab.items()) == list(jm.factors.item_vocab.items())
    np.testing.assert_allclose(tm.factors.user_factors, jm.factors.user_factors,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.factors.item_factors, jm.factors.item_factors,
                               rtol=1e-4, atol=1e-5)

    jalgo = jeng.ALSAlgorithm(jeng.ALSAlgorithmParams(rank=RANK, num_iterations=ITERS))
    users = [f"new{n}" for n in range(6)] + [f"u{u}" for u in range(N_SEED_USERS)]
    for user in users:
        got = _query(served.port, user, 10)
        want = jalgo.predict(jm, jeng.Query(user=user, num=10)).item_scores
        assert got, user
        _ranked_equal(got, want)


def test_queries_during_folds_stress(served):
    """Eight query threads (more than this host's share of cores) with a
    short switch interval while the consumer folds tick after tick: every
    query answers, and no published state's tensors change after publish
    (copy-on-write), checked on every state the server served."""
    import sys
    import threading

    consumer = served.attach()
    states = []  # (state, its tensors' bytes when first seen)
    stop = threading.Event()
    errors = []

    def query(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                _query(served.port, f"u{int(rng.integers(N_SEED_USERS))}", 5)
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=query, args=(s,), daemon=True) for s in range(8)]
    try:
        for t in threads:
            t.start()
        for n in range(12):
            served.insert(_rate(f"s{n}", ["i1", "i6", f"si{n}"], first=50_000 + 10 * n)
                          + _rate(f"u{n % N_SEED_USERS}", [f"si{n}"], first=60_000 + n))
            assert consumer.tick().get("stats") is not None
            sv = _model(served.server)._serving_state
            states.append((sv, [t.clone() for t in (sv.users, sv.items, sv.item_inv_norm)]))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len({id(sv) for sv, _ in states}) == len(states)
    for sv, saved in states:
        for now, then in zip((sv.users, sv.items, sv.item_inv_norm), saved):
            assert now.equal(then)
    assert consumer.counters["events_folded"] == 12 * 4
