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


def test_self_cleaning_is_not_ported():
    with pytest.raises(NotImplementedError):
        teng.URDataSource(teng.DataSourceParams(APP, event_window={"duration": "1 day"}))


def test_model_without_device_needs_the_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.URModel(pair.tmodel.item_vocab, pair.tmodel.indicator_models, "buy")
