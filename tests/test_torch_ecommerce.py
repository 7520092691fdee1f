"""The e-commerce template on the port against the JAX package.

Events of the JAX package's tests/test_templates.py ``ecomm_storage``
fixture (8 items in two categories, 12 users viewing one half), with
explicit ids and distinct times, go into both packages' sqlite storage.
The JAX package trains; its factors are carried into the port
(``convert.ecomm_model_from_numpy``), and each of the JAX package's
``TestECommerce`` cases runs through both algorithms, each reading its
own package's store live: the answers' item ids equal and scores within
rtol 1e-6 (both rank with the same numpy calls), and the case's own
assertion holds on the port's answer. The new user's views in the
unknown-user case carry distinct times, so the newest-first basis read
is one order in both packages.

Also: a whole CPU train by variant from the same seeded start factors
on a larger app (60 users x 40 items; the fixture's 8 items are too few
for the implicit solves to stay within f32 noise of each other), held
within rtol = atol = 1e-4 as tests/test_torch_workflow.py holds the
recommendation template's; ``QueryServer.predict_batch`` handing
``batch_predict`` the deploy's serving context, with its storage (this
failed before the server passed it); the reference quirk that a failing
store read serves unfiltered; the model's pickling and device binding.
"""

import dataclasses
import datetime as dt
import json
import pickle
import urllib.request

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App as JApp  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.engines.ecommerce import engine as jec  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu.workflow import core as jcore  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.engines.ecommerce import engine as tec  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402
from predictionio_tpu_torch.workflow import core as tcore  # noqa: E402
from predictionio_tpu_torch.workflow import server as tserver  # noqa: E402

APP = "ecapp"
TRAIN_APP = "ectrain"
T0 = dt.datetime(2024, 9, 1, tzinfo=dt.timezone.utc)
ALGO = {"name": "ecomm", "params": {"app_name": APP, "rank": 8, "num_iterations": 8,
                                    "unseen_only": False}}
VARIANT = {
    "id": "ec",
    "engineFactory": "predictionio_tpu.engines.ecommerce.ECommerceEngine",
    "datasource": {"params": {"app_name": APP}},
    "algorithms": [ALGO],
}


def _fixture_rows():
    """test_templates.py's ecomm_storage: (event, entity type, id, target,
    properties)."""
    rows = [("$set", "item", f"i{i}", None,
             {"categories": ["tools" if i < 4 else "toys"]}) for i in range(8)]
    rng = np.random.RandomState(13)
    for u in range(12):
        for _ in range(20):
            rows.append(("view", "user", f"u{u}", f"i{rng.randint(0, 4) + (u % 2) * 4}", {}))
    return rows


def _train_rows():
    """60 users, 40 items in 4 categories; views, buys and rates."""
    rng = np.random.RandomState(14)
    rows = [("$set", "item", f"i{i}", None, {"categories": [f"c{i % 4}", f"h{i // 20}"]})
            for i in range(40)]
    for u in range(60):
        items = rng.choice(20, 12, replace=False) + (u % 2) * 20
        for i in items:
            ev = ("view", "buy", "rate")[rng.randint(3)]
            rows.append((ev, "user", f"u{u}", f"i{i}",
                         {"rating": int(rng.randint(1, 6))} if ev == "rate" else {}))
    return rows


def _events(make, rows, first=0):
    return [make(event=e, entity_type=et, entity_id=eid,
                 target_entity_type="item" if tgt else None, target_entity_id=tgt,
                 properties=props, event_time=T0 + dt.timedelta(seconds=first + n),
                 creation_time=T0, event_id=f"c{first + n:05d}")
            for n, (e, et, eid, tgt, props) in enumerate(rows)]


def _storage(storage_cls, config_cls, source_cls, path):
    path.mkdir(parents=True, exist_ok=True)
    return storage_cls(config_cls(
        sources={"S": source_cls("S", "sqlite", {"PATH": str(path / "pio.db")}),
                 "F": source_cls("F", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "F"}))


def _seed(storage, app_cls, make):
    ids = {}
    for name, rows in ((APP, _fixture_rows()), (TRAIN_APP, _train_rows())):
        app_id = storage.get_meta_data_apps().insert(app_cls(0, name))
        storage.get_events().init_app(app_id)
        storage.get_events().insert_batch(_events(make, rows), app_id)
        ids[name] = app_id
    return storage, ids


def _insert_both(pair, rows, first):
    (ts, tids), (js, jids) = pair.port, pair.jax
    ts.get_events().insert_batch(_events(Event, rows, first), tids[APP])
    js.get_events().insert_batch(_events(JEvent, rows, first), jids[APP])


@pytest.fixture()
def pair(tmp_path):
    """Both packages' storage with the same events; the JAX package's
    trained model, and the port's model carried from its factors."""
    port = _seed(_storage(Storage, StorageConfig, SourceConfig, tmp_path / "port"), App, Event)
    jax = _seed(_storage(JStorage, JStorageConfig, JSourceConfig, tmp_path / "jax"), JApp,
                JEvent)
    return dataclasses.make_dataclass("Pair", ["port", "jax"])(port, jax)


def _deploy(pair, **algo_params):
    """(port algorithm, port model, JAX algorithm, JAX model), each
    algorithm reading its own package's store."""
    js = pair.jax[0]
    variant = {**VARIANT, "algorithms": [
        {"name": "ecomm", "params": {**ALGO["params"], **algo_params}}]}
    inst = jcore.run_train(js, variant)
    engine, ep, [jm] = jcore.prepare_deploy_models(js, inst)
    jalg = engine.make_algorithms(ep)[0]
    jalg.set_serving_context(JContext(storage=js, mode="serve"))
    f = jm.factors
    inv_u, inv_i = f.user_vocab.inverse(), f.item_vocab.inverse()
    tm = convert.ecomm_model_from_numpy(
        f.item_factors, f.user_factors, [inv_u(n) for n in range(len(f.user_vocab))],
        [inv_i(n) for n in range(len(f.item_vocab))], {}, item_categories=jm.item_categories,
        device="cpu")
    talg = tec.ECommAlgorithm(tec.ECommAlgorithmParams(**{**ALGO["params"], **algo_params}))
    talg.set_serving_context(RuntimeContext(storage=pair.port[0], mode="serve", device="cpu"))
    return talg, tm, jalg, jm


def _same(ours, ref):
    assert [s.item for s in ours.item_scores] == [s.item for s in ref.item_scores]
    np.testing.assert_allclose([s.score for s in ours.item_scores],
                               [s.score for s in ref.item_scores], rtol=1e-6)


def _both(dep, **q):
    talg, tm, jalg, jm = dep
    got = talg.predict(tm, tec.Query(**q))
    _same(got, jalg.predict(jm, jec.Query(**q)))
    return {s.item for s in got.item_scores}


def test_training_data_matches_jax(pair):
    for app in (APP, TRAIN_APP):
        got = tec.ECommerceDataSource(tec.DataSourceParams(app)).read_training(
            RuntimeContext(storage=pair.port[0], device="cpu"))
        want = jec.ECommerceDataSource(jec.DataSourceParams(app)).read_training(
            JContext(storage=pair.jax[0]))
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
            assert getattr(got, f).dtype == getattr(want, f).dtype
        assert got.item_vocab.to_dict() == want.item_vocab.to_dict()
        assert got.user_vocab.to_dict() == want.user_vocab.to_dict()
        assert got.item_categories == want.item_categories and got.item_categories


def test_basic_recommendation(pair):
    items = _both(_deploy(pair), user="u0", num=4)
    assert len(items & {"i0", "i1", "i2", "i3"}) >= 3


def test_category_filter(pair):
    items = _both(_deploy(pair), user="u0", num=8, categories=["toys"])
    assert items and items <= {"i4", "i5", "i6", "i7"}


def test_unseen_only_filters_seen(pair):
    dep = _deploy(pair, unseen_only=True)
    talg, _, jalg, _ = dep
    seen = talg._seen_items(talg.serving_context, "u0")
    assert seen and seen == jalg._seen_items(jalg.serving_context, "u0")
    items = _both(dep, user="u0", num=8)
    assert not (items & seen)


def test_unavailable_items_constraint(pair):
    _insert_both(pair, [("$set", "constraint", "unavailableItems", None,
                         {"items": ["i0", "i1"]})], first=9000)
    dep = _deploy(pair)
    assert dep[0]._unavailable_items(dep[0].serving_context) == {"i0", "i1"}
    items = _both(dep, user="u0", num=8)
    assert items and not (items & {"i0", "i1"})
    # a later $set replaces the list at the next query
    _insert_both(pair, [("$set", "constraint", "unavailableItems", None,
                         {"items": ["i2"]})], first=9001)
    items = _both(dep, user="u0", num=8)
    assert "i2" not in items and {"i0", "i1"} <= items


def test_unknown_user_falls_back_to_recent_views(pair):
    dep = _deploy(pair)  # trained first; the new user's views come after
    _insert_both(pair, [("view", "user", "newbie", "i5", {}),
                        ("view", "user", "newbie", "i6", {})], first=9100)
    talg, tm, jalg, jm = dep
    assert talg._recent_item_rows(talg.serving_context, "newbie", tm) == \
        jalg._recent_item_rows(jalg.serving_context, "newbie", jm)
    items = _both(dep, user="newbie", num=3)
    assert items and "i5" not in items and "i6" not in items
    assert len(items & {"i4", "i7"}) >= 1, items


def test_batch_predict_honors_eval_ctx(pair):
    talg, tm, jalg, jm = _deploy(pair, unseen_only=True)
    tctx = RuntimeContext(storage=pair.port[0], mode="eval", device="cpu")
    jctx = JContext(storage=pair.jax[0], mode="eval")
    unbound = tec.ECommAlgorithm(talg.params)  # no serving context: ctx is the caller's
    qs = [(0, tec.Query(user="u0", num=8)), (1, tec.Query(user="u3", num=2,
                                                          blacklist=["i4"]))]
    got = dict(unbound.batch_predict(tctx, tm, qs))
    want = dict(jalg.batch_predict(jctx, jm, [(n, jec.Query(**dataclasses.asdict(q)))
                                              for n, q in qs]))
    for n in (0, 1):
        _same(got[n], want[n])
    seen = talg._seen_items(tctx, "u0")
    assert seen and not ({s.item for s in got[0].item_scores} & seen)


def test_totally_unknown_user_empty(pair):
    dep = _deploy(pair)
    assert _both(dep, user="ghost") == set()


@pytest.mark.parametrize("q", [
    dict(user="u1", num=3, whitelist=["i4", "i6", "i1", "nope"]),
    dict(user="u2", num=8, blacklist=["i0", "i2", "zzz"]),
    dict(user="u5", num=8, categories=["tools", "toys"], whitelist=["i2", "i7"]),
    dict(user="u6", num=20),
    dict(user="u7", num=0),
    dict(user="u8", num=5, categories=["none-such"]),
])
def test_filters_match_jax(pair, q):
    items = _both(_deploy(pair), **q)
    assert not items & set(q.get("blacklist", []))
    if "whitelist" in q:
        assert items <= set(q["whitelist"])


def test_category_filter_without_categories_raises(pair):
    talg, tm, jalg, jm = _deploy(pair)
    tm.item_categories = None
    tm._cat_index = None
    with pytest.raises(ValueError, match="categories"):
        talg.predict(tm, tec.Query(user="u0", categories=["toys"]))


def test_failing_store_read_serves_unfiltered(pair, monkeypatch, caplog):
    """The JAX package's quirk, kept: a store read that raises is logged
    and the query is served without that filter."""
    _insert_both(pair, [("$set", "constraint", "unavailableItems", None,
                         {"items": ["i0", "i1"]})], first=9200)
    talg, tm, jalg, jm = _deploy(pair, unseen_only=True)
    filtered = {s.item for s in talg.predict(tm, tec.Query(user="u0", num=8)).item_scores}
    assert not filtered & {"i0", "i1"}
    store = pair.port[0].get_events()

    def broken(*a, **k):
        raise RuntimeError("store down")

    monkeypatch.setattr(store, "find", broken)
    got = talg.predict(tm, tec.Query(user="u0", num=8))
    jbroken = JContext(storage=None, mode="serve")
    want = jalg.predict_with_ctx(jbroken, jm, jec.Query(user="u0", num=8))
    _same(got, want)  # unfiltered, as with no store at all
    assert {"i0", "i1"} <= {s.item for s in got.item_scores}
    assert "lookup failed" in caplog.text
    assert talg.predict(tm, tec.Query(user="newbie", num=3)).item_scores == []


def test_model_pickles_without_device_and_binds(pair):
    talg, tm, _, _ = _deploy(pair)
    tm.category_index()
    back = pickle.loads(pickle.dumps(tm))
    assert back.device is None and back._cat_index is None
    assert set(tm.__getstate__()) == {"factors", "item_categories"}
    back.bind_device("cpu")
    assert back.device == torch.device("cpu")
    q = tec.Query(user="u3", num=5, categories=["toys"])
    assert talg.predict(back, q) == talg.predict(tm, q)


# -- a whole CPU train, and the deploy server -------------------------------------

PORT_VARIANT = {
    "id": "ec-train",
    "engineFactory": "predictionio_tpu_torch.engines.ecommerce.ECommerceEngine",
    "datasource": {"params": {"app_name": TRAIN_APP}},
    "algorithms": [{"name": "ecomm", "params": {
        "app_name": TRAIN_APP, "rank": 6, "num_iterations": 4, "lambda_": 0.05,
        "unseen_only": True, "seen_events": ["view", "buy", "rate"]}}],
}


def _init(n_users, n_items, rank):
    rng = np.random.default_rng(23 + rank)
    return ((rng.standard_normal((n_users, rank)) / np.sqrt(rank)).astype(np.float32),
            (rng.standard_normal((n_items, rank)) / np.sqrt(rank)).astype(np.float32))


def test_whole_train_matches_jax(pair, monkeypatch):
    monkeypatch.setenv("PIO_DENSE_ALS", "0")
    port_train, jax_train = tals.train, jals.train
    monkeypatch.setattr(tals, "train", lambda r, c, v, nu, ni, p, **kw: port_train(
        r, c, v, nu, ni, p, **dict(kw, init_factors=_init(nu, ni, p.rank))))
    monkeypatch.setattr(jals, "train", lambda r, c, v, nu, ni, p, **kw: jax_train(
        r, c, v, nu, ni, p, **dict(kw, init_factors=_init(nu, ni, p.rank))))
    (ts, _), (js, _) = pair.port, pair.jax
    tinst = tcore.run_train(ts, PORT_VARIANT, device="cpu")
    jinst = jcore.run_train(js, {**PORT_VARIANT, "engineFactory":
                                 "predictionio_tpu.engines.ecommerce.ECommerceEngine"})
    te, tep, [tm] = tcore.prepare_deploy_models(ts, tinst, device="cpu")
    _, _, [jm] = jcore.prepare_deploy_models(js, jinst)
    assert type(tm) is tec.ECommModel and tm.device == torch.device("cpu")
    assert tm.item_categories == jm.item_categories
    for side in ("user_factors", "item_factors"):
        np.testing.assert_allclose(getattr(tm.factors, side), getattr(jm.factors, side),
                                   rtol=1e-4, atol=1e-4)
    # the JAX algorithm on the port's factors answers as the port does
    talg = te.make_algorithms(tep)[0]
    talg.set_serving_context(RuntimeContext(storage=ts, mode="serve", device="cpu"))
    jalg = jec.ECommAlgorithm(jec.ECommAlgorithmParams(**PORT_VARIANT["algorithms"][0]["params"]))
    jalg.set_serving_context(JContext(storage=js, mode="serve"))
    on_ours = jec.ECommModel(jals.ALSFactors(
        user_factors=tm.factors.user_factors, item_factors=tm.factors.item_factors,
        user_vocab=jm.factors.user_vocab, item_vocab=jm.factors.item_vocab), tm.item_categories)
    for q in (dict(user="u0", num=5), dict(user="u1", num=5, categories=["c1"]),
              dict(user="u2", num=30)):
        got = talg.predict(tm, tec.Query(**q))
        _same(got, jalg.predict(on_ours, jec.Query(**q)))
        assert got.item_scores


class _CtxSpy(tec.ECommAlgorithm):
    seen_ctx: list = []

    def batch_predict(self, ctx, model, queries):
        _CtxSpy.seen_ctx.append(ctx)
        return super().batch_predict(ctx, model, queries)


def test_query_server_passes_the_serving_context(pair, monkeypatch):
    """`predict_batch` hands `batch_predict` the deploy's serving context,
    whose storage the live filters read: seen items never come back,
    over the micro-batched HTTP path too."""
    (ts, _), _ = pair.port, pair.jax
    inst = tcore.run_train(ts, PORT_VARIANT, device="cpu")
    rt = tserver.build_runtime(ts, inst, device="cpu")
    spy = _CtxSpy(rt.algorithms[0].params)
    spy.set_serving_context(rt.algorithms[0].serving_context)
    rt.algorithms[0] = spy
    server = tserver.QueryServer(runtime=rt, storage=ts,
                                 config=tserver.QueryServerConfig(ip="127.0.0.1", port=0))
    qs = [tec.Query(user=f"u{n}", num=12) for n in range(6)]
    _CtxSpy.seen_ctx.clear()
    answers = server.predict_batch(qs, rt)
    [ctx] = _CtxSpy.seen_ctx
    assert ctx is spy.serving_context and ctx.storage is ts
    for q, a in zip(qs, answers):
        seen = spy._seen_items(ctx, q.user)
        items = {s.item for s in a.item_scores}
        assert seen and items and not items & seen
        assert a == spy.predict_with_ctx(ctx, rt.models[0], q)
    port = server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json",
            data=json.dumps({"user": "u4", "num": 12}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.loads(r.read())
    finally:
        server.stop()
    assert body == tserver._to_jsonable(answers[4])
