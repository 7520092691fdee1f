"""The Universal Recommender end to end on the port, against the JAX
package: the same events (tests/test_universal.py's `ur_storage` cohorts,
with explicit event times and ids so that both stores order them, and so
build their vocabularies, the same way) go into both packages' memory
stores; each package reads, trains and serves on the CPU.

Tables are held to the LLR tolerance of tests/test_torch_cco.py; answers
must name the same items with scores within rtol 1e-5.
"""

import datetime as dt
import http.client
import json
import pickle

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App as JApp  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage as JStorage,
    StorageConfig,
)
from predictionio_tpu.engines.universal import engine as jeng  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import Storage, StorageConfig as TStorageConfig  # noqa: E402
from predictionio_tpu_torch.engines.universal import engine as teng  # noqa: E402
from predictionio_tpu_torch.workflow import server as tserver  # noqa: E402
from test_torch_cco import assert_correlators_close  # noqa: E402

APP = "urapp"
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


def _events():
    """(event, user, target) rows: even users buy items 0-3 and view
    accessories a0-a1; odd users buy 4-7 and view a2-a3."""
    rng = np.random.RandomState(17)
    rows = []
    for u in range(20):
        g = u % 2
        for _ in range(6):
            rows.append(("buy", f"u{u}", f"i{rng.randint(0, 4) + g * 4}"))
        for _ in range(4):
            rows.append(("view", f"u{u}", f"a{rng.randint(0, 2) + g * 2}"))
    return rows


LURKER = [("view", "lurker", "a0"), ("view", "lurker", "a1")]


def _insert(store, app_id, make, rows, first):
    store.insert_batch([
        make(event=e, entity_type="user", entity_id=u,
             target_entity_type="item", target_entity_id=t,
             event_time=T0 + dt.timedelta(seconds=first + n),
             event_id=f"e{first + n:06d}")
        for n, (e, u, t) in enumerate(rows)
    ], app_id)


class _Pair:
    """Both packages' stores with the same events, trained."""

    def __init__(self, algo_params=None):
        algo_params = algo_params or {}
        self.jstorage = JStorage(StorageConfig(
            sources={"MEM": SourceConfig("MEM", "memory", {})},
            repositories={"METADATA": "MEM", "EVENTDATA": "MEM",
                          "MODELDATA": "MEM"},
        ))
        self.tstorage = Storage(TStorageConfig.memory())
        self.japp = self.jstorage.get_meta_data_apps().insert(JApp(0, APP))
        self.tapp = self.tstorage.get_meta_data_apps().insert(App(0, APP))
        self.jstorage.get_events().init_app(self.japp)
        self.tstorage.get_events().init_app(self.tapp)
        self.add(_events(), 0)
        indicators = ("buy", "view")
        jtd = jeng.URDataSource(jeng.DataSourceParams(APP, indicators)
                                ).read_training(JContext(storage=self.jstorage))
        ttd = teng.URDataSource(teng.DataSourceParams(APP, indicators)
                                ).read_training(RuntimeContext(storage=self.tstorage))
        self.jtd, self.ttd = jtd, ttd
        params = dict(app_name=APP, max_correlators_per_item=10, **algo_params)
        self.jalg = jeng.URAlgorithm(jeng.URAlgorithmParams(**params))
        self.talg = teng.URAlgorithm(teng.URAlgorithmParams(**params))
        self.jmodel = self.jalg.train(JContext(storage=self.jstorage), jtd)
        self.tmodel = self.talg.train(
            RuntimeContext(storage=self.tstorage, device="cpu"), ttd)
        self.jalg.set_serving_context(JContext(storage=self.jstorage, mode="serve"))
        self.talg.set_serving_context(
            RuntimeContext(storage=self.tstorage, mode="serve", device="cpu"))

    def add(self, rows, first):
        _insert(self.jstorage.get_events(), self.japp, JEvent, rows, first)
        _insert(self.tstorage.get_events(), self.tapp, Event, rows, first)


@pytest.fixture(scope="module")
def pair():
    p = _Pair()
    p.add(LURKER, 1000)  # a view-only user, after the train
    return p


def _answers_match(jpred, tpred):
    assert [s.item for s in tpred.item_scores] == [s.item for s in jpred.item_scores]
    np.testing.assert_allclose([s.score for s in tpred.item_scores],
                               [s.score for s in jpred.item_scores], rtol=1e-5)


def test_training_data_matches(pair):
    j, t = pair.jtd, pair.ttd
    assert t.n_users == j.n_users
    assert t.user_vocab.to_dict() == j.user_vocab.to_dict()
    for ji, ti in zip(j.indicators, t.indicators):
        assert ti.name == ji.name
        assert ti.target_vocab.to_dict() == ji.target_vocab.to_dict()
        assert np.array_equal(ti.rows, ji.rows) and np.array_equal(ti.cols, ji.cols)


def test_tables_match(pair):
    jm, tm = pair.jmodel, pair.tmodel
    assert tm.item_vocab.to_dict() == jm.item_vocab.to_dict()
    assert tm.primary_indicator == jm.primary_indicator
    assert [m.name for m in tm.indicator_models] == [m.name for m in jm.indicator_models]
    for jmi, tmi in zip(jm.indicator_models, tm.indicator_models):
        assert tmi.target_vocab.to_dict() == jmi.target_vocab.to_dict()
        assert_correlators_close((jmi.correlator_scores, jmi.correlator_idx),
                                 (tmi.correlator_scores, tmi.correlator_idx),
                                 pair.jtd.n_users)
    assert tm.device == torch.device("cpu")


# tests/test_universal.py's TestUniversalRecommender cases
CASES = {
    "recommends_cohort_items": dict(user="u0", num=4, exclude_seen=False),
    "exclude_seen_primary": dict(user="u0", num=8, exclude_seen=True),
    "secondary_indicator_contributes": dict(user="lurker", num=4),
    "unknown_user_empty": dict(user="ghost"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_answers_match_jax(pair, case):
    q = CASES[case]
    jpred = pair.jalg.predict(pair.jmodel, jeng.Query(**q))
    tpred = pair.talg.predict(pair.tmodel, teng.Query(**q))
    _answers_match(jpred, tpred)
    items = {s.item for s in tpred.item_scores}
    if case == "unknown_user_empty":
        assert items == set()
    elif case == "exclude_seen_primary":
        seen = {t for e, u, t in _events() if u == "u0" and e == "buy"}
        assert items and not items & seen
    else:
        assert items and items <= {"i0", "i1", "i2", "i3"}, items


def test_secondary_only_indicators_with_exclude_seen():
    """Keeping only the secondary indicator still filters seen items in
    the PRIMARY item space."""
    p = _Pair({"indicators": ("view",)})
    for q in (dict(user="u0", num=8), dict(user="u0", num=8, exclude_seen=False)):
        jpred = p.jalg.predict(p.jmodel, jeng.Query(**q))
        tpred = p.talg.predict(p.tmodel, teng.Query(**q))
        _answers_match(jpred, tpred)
        assert tpred.item_scores
    seen = {t for e, u, t in _events() if u == "u0" and e == "buy"}
    first = p.talg.predict(p.tmodel, teng.Query(user="u0", num=8))
    assert not {s.item for s in first.item_scores} & seen


def test_batch_predict_equals_predict(pair):
    """The batched path (blacklists, overflow-free) answers each query as
    a lone predict does, and as the JAX package does."""
    queries = [teng.Query(user=f"u{n}", num=3 + n % 4,
                          blacklist=["i1", "i5"] if n % 3 == 0 else None,
                          exclude_seen=n % 2 == 0) for n in range(12)]
    batch = pair.talg.batch_predict(None, pair.tmodel, list(enumerate(queries)))
    for (n, got), q in zip(batch, queries):
        assert got == pair.talg.predict(pair.tmodel, q)
        _answers_match(pair.jalg.predict(pair.jmodel, jeng.Query(**vars(q))), got)


def test_ur_model_from_numpy_serves_like_jax(pair):
    jm = pair.jmodel
    model = convert.ur_model_from_numpy(
        jm.item_vocab.to_dict(), jm.primary_indicator,
        [(m.name, m.correlator_scores, m.correlator_idx, m.target_vocab.to_dict())
         for m in jm.indicator_models],
        device="cpu",
    )
    for q in ({"user": "u0", "num": 4, "exclude_seen": False},
              {"user": "u3", "num": 8, "blacklist": ["i4"]}):
        _answers_match(pair.jalg.predict(jm, jeng.Query(**q)),
                       pair.talg.predict(model, teng.Query(**q)))
    with pytest.raises(ValueError):
        convert.ur_model_from_numpy({"i0": 0}, "buy", [], device="cpu")


def test_query_server_round_trip(pair):
    server = tserver.QueryServer(
        pair.talg, pair.tmodel, tserver.QueryServerConfig(ip="127.0.0.1", port=0)
    )
    port = server.start()
    try:
        q = {"user": "u1", "num": 4, "blacklist": ["i5"], "exclude_seen": False}
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/queries.json", body=json.dumps(q))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.request("POST", "/queries.json", body=json.dumps({"user": "u1", "whitelist": []}))
        bad = conn.getresponse()
        bad.read()
        conn.close()
    finally:
        server.stop()
    assert resp.status == 200
    expected = tserver._to_jsonable(pair.talg.predict(pair.tmodel, teng.Query(**q)))
    assert body == expected and body["item_scores"]
    assert bad.status == 400  # an ALS-only field is not a UR query field
    jbody = pair.jalg.predict(pair.jmodel, jeng.Query(**q))
    assert [s["item"] for s in body["item_scores"]] == [s.item for s in jbody.item_scores]


def test_model_pickles_without_device_state(pair):
    pair.tmodel.device_tables()
    clone = pickle.loads(pickle.dumps(pair.tmodel))
    # the device is the deploy's, bound after unpickling, never the pickled one
    assert clone._device_tables is None and clone.device is None
    assert "_device_tables" not in pair.tmodel.__getstate__()
    assert "device" not in pair.tmodel.__getstate__()
    with pytest.raises(RuntimeError, match="no device"):
        clone.device_tables()
    clone.bind_device("cpu")
    assert clone.device == torch.device("cpu")


def test_event_window_cleans_then_trains_like_jax():
    """The event window is ported (tests/test_universal.py's
    `test_self_cleaning_window_wired`, held to the JAX package): both
    packages' stores get the same events plus duplicates and events older
    than the window; each data source cleans, then reads, then trains.
    The counters, the surviving events, the training data and the tables
    must be the JAX package's."""
    p = _Pair.__new__(_Pair)
    p.jstorage = JStorage(StorageConfig(
        sources={"MEM": SourceConfig("MEM", "memory", {})},
        repositories={"METADATA": "MEM", "EVENTDATA": "MEM", "MODELDATA": "MEM"}))
    p.tstorage = Storage(TStorageConfig.memory())
    p.japp = p.jstorage.get_meta_data_apps().insert(JApp(0, APP))
    p.tapp = p.tstorage.get_meta_data_apps().insert(App(0, APP))
    p.jstorage.get_events().init_app(p.japp)
    p.tstorage.get_events().init_app(p.tapp)
    rows = _events()
    p.add(rows, 0)
    p.add(rows[::7], 500)  # exact duplicates, later
    # the window reaches back to T0 - 30 days; these are older
    now = dt.datetime.now(dt.timezone.utc)
    window = {"duration": f"{(now - T0).days + 30} days", "remove_duplicates": True}
    old = [("buy", f"u{u}", f"gone{u}") for u in range(0, 20, 3)]
    for store, app_id, make in ((p.jstorage.get_events(), p.japp, JEvent),
                                (p.tstorage.get_events(), p.tapp, Event)):
        store.insert_batch([
            make(event=e, entity_type="user", entity_id=u, target_entity_type="item",
                 target_entity_id=t, event_time=T0 - dt.timedelta(days=90, seconds=n),
                 event_id=f"old{n:03d}")
            for n, (e, u, t) in enumerate(old)], app_id)
    jds = jeng.URDataSource(jeng.DataSourceParams(APP, ("buy", "view"), event_window=window))
    tds = teng.URDataSource(teng.DataSourceParams(APP, ("buy", "view"), event_window=window))
    assert tds.event_window == teng.EventWindow(**window)
    jtd = jds.read_training(JContext(storage=p.jstorage))
    ttd = tds.read_training(RuntimeContext(storage=p.tstorage))

    def left(storage, app_id):
        from predictionio_tpu_torch.data.storage.base import EventQuery

        return sorted(e.event_id for e in storage.get_events().find(EventQuery(app_id=app_id)))

    from predictionio_tpu.data.storage.base import EventQuery as JQuery

    jleft = sorted(e.event_id for e in p.jstorage.get_events().find(JQuery(app_id=p.japp)))
    assert left(p.tstorage, p.tapp) == jleft
    assert len(jleft) == len(set(rows)) and not any(i.startswith("old") for i in jleft)
    p.jtd, p.ttd = jtd, ttd
    test_training_data_matches(p)
    params = dict(app_name=APP, max_correlators_per_item=10)
    p.jalg = jeng.URAlgorithm(jeng.URAlgorithmParams(**params))
    p.talg = teng.URAlgorithm(teng.URAlgorithmParams(**params))
    p.jmodel = p.jalg.train(JContext(storage=p.jstorage), jtd)
    p.tmodel = p.talg.train(RuntimeContext(storage=p.tstorage, device="cpu"), ttd)
    test_tables_match(p)
    # a second clean finds nothing left to do in either package
    assert tds.clean_persisted_events(RuntimeContext(storage=p.tstorage)) == \
        jds.clean_persisted_events(JContext(storage=p.jstorage)) == \
        {"compacted": 0, "deduplicated": 0, "aged_out": 0}


def test_model_without_device_needs_the_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.URModel(pair.tmodel.item_vocab, pair.tmodel.indicator_models, "buy")


def _random_tables(rng, n_items=300, sizes=((300, 12), (150, 7))):
    """Per indicator: (I, T) correlator ids (-1 padded at random) and
    LLR-like scores, and its target-vocab size."""
    tables = []
    for j, t in sizes:
        idx = rng.randint(0, j, size=(n_items, t)).astype(np.int32)
        idx[rng.rand(n_items, t) < 0.2] = -1
        sc = (rng.rand(n_items, t) * 30).astype(np.float32)
        tables.append((idx, sc, j))
    return tables


def test_history_scores_do_not_depend_on_the_batch():
    """models/cco.py `history_scores`: each query's row of a B = 64 batch
    is bit-equal to the same query scored alone (B = 1), at the padded
    width and at n_items."""
    from predictionio_tpu_torch.models import cco

    rng = np.random.RandomState(31)
    tables = _random_tables(rng)
    hists = []
    for j, h in ((300, 20), (150, 9)):
        x = rng.randint(0, j, size=(64, h)).astype(np.int32)
        x[rng.rand(64, h) < 0.3] = -1
        x[5] = -1  # a user with no history in this indicator
        hists.append(x)
    idx = tuple(torch.from_numpy(t[0]) for t in tables)
    sc = tuple(torch.from_numpy(t[1]) for t in tables)
    js = tuple(t[2] for t in tables)
    for width in (300, cco.pad_items(300)):
        full = cco.history_scores(idx, sc, tuple(torch.from_numpy(h) for h in hists),
                                  js, width)
        assert full.shape == (64, width)
        for b in range(64):
            one = cco.history_scores(idx, sc, tuple(torch.from_numpy(h[b:b + 1])
                                                    for h in hists), js, width)
            assert torch.equal(one[0], full[b]), b
    # the host reference of one query agrees within f32 rounding
    want = sum(cco.score_history(t[0], t[1], h[3][h[3] >= 0]) for t, h in zip(tables, hists))
    np.testing.assert_allclose(full[3, :300].numpy(), want, rtol=1e-6)


def test_served_scores_do_not_depend_on_the_batch(pair):
    """The UR's answers through `batch_predict`: 64 queries in one batch
    (B = 64 on the device path) equal each query answered alone (B = 1),
    scores bit for bit, on the CPU; `batch_score_topk` the same."""
    from predictionio_tpu_torch.models import cco

    users = [f"u{n}" for n in range(20)] + ["lurker", "ghost"]
    queries = [teng.Query(user=users[n % len(users)], num=1 + n % 9,
                          blacklist=["i1", "i6"] if n % 5 == 0 else None,
                          exclude_seen=n % 3 != 0) for n in range(64)]
    batch = pair.talg.batch_predict(None, pair.tmodel, list(enumerate(queries)))
    assert len(batch) == 64
    for (n, got), q in zip(batch, queries):
        alone = pair.talg.batch_predict(None, pair.tmodel, [(0, q)])[0][1]
        assert [(s.item, s.score) for s in got.item_scores] == \
            [(s.item, s.score) for s in alone.item_scores], n

    rng = np.random.RandomState(5)
    tables = _random_tables(rng)
    hists = [np.where(rng.rand(64, 10) < 0.3, -1,
                      rng.randint(0, j, size=(64, 10))).astype(np.int32)
             for _, _, j in tables]
    exclude = np.where(rng.rand(64, 6) < 0.5, -1,
                       rng.randint(0, 300, size=(64, 6))).astype(np.int32)
    vals, idx = cco.batch_score_topk(tables, hists, exclude, k=16, device="cpu")
    for b in range(64):
        v1, i1 = cco.batch_score_topk(tables, [h[b:b + 1] for h in hists],
                                      exclude[b:b + 1], k=16, device="cpu")
        assert np.array_equal(v1[0], vals[b]) and np.array_equal(i1[0], idx[b]), b
