"""The similar-product template on the port against the JAX package.

Events of the JAX package's tests/test_templates.py ``similar_storage``
fixture (items 0-4 co-viewed by even users, 5-9 by odd users, likes and
dislikes mirroring them), with explicit ids and times, go into both
packages' sqlite storage.

- ``TrainingData``: equal exactly (views summed, likes signed ±1 with the
  latest event of a pair winning).
- Answers from carried JAX factors (``convert.similar_model_from_numpy``)
  on the CPU: at ``serve_dtype`` f32 the host route, item ids equal and
  scores within rtol 1e-6 (tests/test_torch_recommendation_slice.py's
  `_same`); bf16 and int8 through the selector's plain version against
  the JAX package's fused route, ids equal, scores within rtol 1e-5 (the
  bar of tests/test_torch_als_serving.py's basket cosine); the f32
  selector route (the card's) against the host formula within 1e-5
  absolute, ids equal outside near-ties.
- ``SumScoreServing`` sums as the JAX one does.
- A whole CPU train by variant (``run_train`` → ``prepare_deploy_models``)
  from the same seeded start factors in both packages (the windowed
  path), on a second app of 60 users x 40 items (on the fixture's 10
  items the implicit solves are so ill-conditioned that the packages'
  f32 rounding differences, 1e-5 after one iteration, grow to 1e-1 over
  8): factors within rtol = atol
  = 1e-4, the bar of tests/test_torch_workflow.py, and the answers of the
  JAX engine on the port's deployed factors equal to the port's.
- The model pickles without its device or staged state and serves where
  it is bound; ``shard_serving`` true is refused.
"""

import dataclasses
import datetime as dt
import pickle

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App as JApp  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.data.store.bimap import BiMap as JBiMap  # noqa: E402
from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.engines.similarproduct import engine as jsim  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu.workflow import core as jcore  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.controller import ParamsError, extract_params  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.engines.similarproduct import engine as tsim  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402
from predictionio_tpu_torch.ops import recommend as rec  # noqa: E402
from predictionio_tpu_torch.workflow import core as tcore  # noqa: E402

APP = "simapp"
TRAIN_APP = "simtrain"
T0 = dt.datetime(2024, 8, 1, tzinfo=dt.timezone.utc)
VARIANT = {
    "id": "sim",
    "engineFactory": "predictionio_tpu_torch.engines.similarproduct.SimilarProductEngine",
    "datasource": {"params": {"app_name": TRAIN_APP}},
    "algorithms": [
        {"name": "als", "params": {"rank": 6, "num_iterations": 4, "lambda_": 0.05}},
        {"name": "like", "params": {"rank": 4, "num_iterations": 4, "lambda_": 0.05}},
    ],
    "serving": {"name": "sum"},
}
J_VARIANT = {**VARIANT, "engineFactory":
             "predictionio_tpu.engines.similarproduct.SimilarProductEngine"}


def _rows():
    """test_templates.py's similar_storage events, then a second like or
    dislike on some pairs (the latest wins)."""
    rng = np.random.RandomState(11)
    rows = []
    for u in range(20):
        group = u % 2
        for _ in range(25):
            rows.append(("view", f"u{u}", f"i{rng.randint(0, 5) + group * 5}"))
        rows.append(("like", f"u{u}", f"i{group * 5}"))
        rows.append(("dislike", f"u{u}", f"i{(1 - group) * 5}"))
    for u in range(0, 20, 3):
        rows.append(("dislike" if u % 2 else "like", f"u{u}", f"i{(u % 2) * 5}"))
    return rows


def _train_rows():
    """60 users in two cohorts over 40 items (0-19, 20-39): 12 items of
    their cohort viewed once or twice, liked when viewed twice and
    disliked when viewed once, for 4 of them."""
    rng = np.random.RandomState(12)
    rows = []
    for u in range(60):
        items = rng.choice(20, 12, replace=False) + (u % 2) * 20
        counts = rng.randint(1, 3, 12)
        for i, n in zip(items, counts):
            rows += [("view", f"u{u}", f"i{i}")] * int(n)
        for i, n in zip(items[:4], counts[:4]):
            rows.append(("like" if n == 2 else "dislike", f"u{u}", f"i{i}"))
    order = rng.permutation(len(rows))
    return [rows[n] for n in order]


def _events(make, rows):
    return [make(event=e, entity_type="user", entity_id=u, target_entity_type="item",
                 target_entity_id=i, event_time=T0 + dt.timedelta(seconds=n),
                 creation_time=T0, event_id=f"s{n:05d}")
            for n, (e, u, i) in enumerate(rows)]


def _storage(storage_cls, config_cls, source_cls, path):
    path.mkdir(parents=True, exist_ok=True)
    return storage_cls(config_cls(
        sources={"S": source_cls("S", "sqlite", {"PATH": str(path / "pio.db")}),
                 "F": source_cls("F", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "F"}))


def _seed(storage, app_cls, make):
    for name, rows in ((APP, _rows()), (TRAIN_APP, _train_rows())):
        app_id = storage.get_meta_data_apps().insert(app_cls(0, name))
        storage.get_events().init_app(app_id)
        storage.get_events().insert_batch(_events(make, rows), app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("sim")
    return (_seed(_storage(Storage, StorageConfig, SourceConfig, base / "port"), App, Event),
            _seed(_storage(JStorage, JStorageConfig, JSourceConfig, base / "jax"), JApp,
                  JEvent))


def test_training_data_matches_jax(stores):
    ts, js = stores
    got = tsim.SimilarProductDataSource(tsim.DataSourceParams(APP)).read_training(
        RuntimeContext(storage=ts, device="cpu"))
    want = jsim.SimilarProductDataSource(jsim.DataSourceParams(APP)).read_training(
        JContext(storage=js))
    for f in ("rows", "cols", "vals", "like_rows", "like_cols", "like_vals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items) == (20, 10)
    assert got.user_vocab.to_dict() == want.user_vocab.to_dict()
    assert got.item_vocab.to_dict() == want.item_vocab.to_dict()
    assert set(got.like_vals.tolist()) == {-1.0, 1.0} and len(got.like_rows) == 40
    assert got.vals.max() > 1  # repeated views summed


# -- answers from carried JAX factors ------------------------------------------

I, K = 300, 8


def _jax_model(serve_dtype, seed=3):
    rng = np.random.default_rng(seed)
    itf = rng.standard_normal((I, K)).astype(np.float32)
    itf[7] = 0.0  # a zero row: its cosine is 0
    uf = rng.standard_normal((5, K)).astype(np.float32)
    f = jals.ALSFactors(user_factors=uf, item_factors=itf,
                        user_vocab=JBiMap({f"u{n}": n for n in range(5)}),
                        item_vocab=JBiMap({f"i{n}": n for n in range(I)}))
    return jsim.SimilarModel(f, serve_dtype=serve_dtype)


def _port_model(jm, device="cpu"):
    f = jm.factors
    inv_u, inv_i = f.user_vocab.inverse(), f.item_vocab.inverse()
    return convert.similar_model_from_numpy(
        f.item_factors, f.user_factors, [inv_u(n) for n in range(len(f.user_vocab))],
        [inv_i(n) for n in range(len(f.item_vocab))],
        {k: v for k, v in dataclasses.asdict(f.params).items()
         if k in {g.name for g in dataclasses.fields(tals.ALSParams)}},
        serve_dtype=jm.serve_dtype, device=device)


QUERIES = [
    dict(items=["i1"], num=5),
    dict(items=["i1", "i2", "i250"], num=10),
    dict(items=["i3", "i3", "nope"], num=20),
    dict(items=["nope"], num=5),
    dict(items=[], num=5),
    dict(items=["i4", "i5"], num=8, blacklist=["i6", "i9", "i100", "zzz"]),
    dict(items=["i10"], num=6, whitelist=[f"i{n}" for n in range(0, 300, 7)] + ["x"]),
    dict(items=["i11", "i12"], num=4, whitelist=["i11", "i13", "i14"], blacklist=["i13"]),
    dict(items=["i20"], num=400),
    dict(items=["i7", "i8"], num=12),
]


def _answers(alg, model, make_query, queries):
    return [alg.predict(model, make_query(**q)) for q in queries]


def _same(ours, ref, rtol):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert [s.item for s in a.item_scores] == [s.item for s in b.item_scores]
        np.testing.assert_allclose([s.score for s in a.item_scores],
                                   [s.score for s in b.item_scores], rtol=rtol)


@pytest.mark.parametrize("algo", ["ALSSimilarAlgorithm", "LikeAlgorithm"])
@pytest.mark.parametrize("serve_dtype", ["f32", "bf16", "int8"])
def test_answers_match_jax(serve_dtype, algo):
    jm = _jax_model(serve_dtype)
    tm = _port_model(jm)
    assert tm.host_ranked() == (serve_dtype == "f32")
    jalg = getattr(jsim, algo)(jsim.ALSSimilarParams(serve_dtype=serve_dtype))
    talg = getattr(tsim, algo)(tsim.ALSSimilarParams(serve_dtype=serve_dtype))
    before = rec.LAUNCHES
    ours = _answers(talg, tm, tsim.Query, QUERIES)
    assert rec.LAUNCHES == before  # the plain version on CPU tensors
    ref = _answers(jalg, jm, jsim.Query, QUERIES)
    _same(ours, ref, rtol=1e-6 if serve_dtype == "f32" else 1e-5)
    assert ours[3].item_scores == [] and ours[4].item_scores == []
    assert len(ours[8].item_scores) == I - 1
    for q, a in zip(QUERIES, ours):
        items = {s.item for s in a.item_scores}
        assert not items & set(q["items"])
        assert not items & set(q.get("blacklist", []))
        if "whitelist" in q:
            assert items <= set(q["whitelist"])


def test_f32_selector_route_equals_the_host_formula(monkeypatch):
    """The route the card takes at f32 (the fused selector with the
    inverse norms as scales, scores times |q|), run here through its
    plain version: the host formula's items and scores within 1e-5."""
    jm = _jax_model("f32")
    host = _answers(tsim.ALSSimilarAlgorithm(tsim.ALSSimilarParams()), _port_model(jm),
                    tsim.Query, QUERIES)
    monkeypatch.setattr(tsim.SimilarModel, "host_ranked", lambda self: False)
    tm = _port_model(jm)
    kernel = _answers(tsim.ALSSimilarAlgorithm(tsim.ALSSimilarParams()), tm, tsim.Query,
                      QUERIES)
    assert tm._serving_state is not None and tm._serving_state.dtype == "f32"
    normed = tm.normed_item_factors()
    for q, a, b in zip(QUERIES, kernel, host):
        assert len(a.item_scores) == len(b.item_scores)
        ga = np.array([s.score for s in a.item_scores])
        gb = np.array([s.score for s in b.item_scores])
        np.testing.assert_allclose(ga, gb, rtol=0, atol=1e-5)
        ia, ib = [s.item for s in a.item_scores], [s.item for s in b.item_scores]
        near = {i for i, s in zip(ia + ib, list(ga) + list(gb))
                if np.min(np.abs(gb - s)) < 1e-5 and np.sum(np.abs(gb - s) < 1e-5) > 1}
        assert [i for i in ia if i not in near] == [i for i in ib if i not in near]
        known = [tm.factors.item_vocab.get(i) for i in q["items"]]
        known = [k for k in known if k is not None]
        if known:  # the host formula itself
            want = normed @ normed[known].mean(axis=0)
            for s in a.item_scores:
                assert abs(s.score - want[tm.factors.item_vocab.get(s.item)]) <= 1e-5


def test_sum_serving_matches_jax():
    jm = _jax_model("f32")
    tm = _port_model(jm)
    q = dict(items=["i1", "i2"], num=7)
    tpreds = [tsim.ALSSimilarAlgorithm(tsim.ALSSimilarParams()).predict(tm, tsim.Query(**q)),
              tsim.LikeAlgorithm(tsim.ALSSimilarParams()).predict(
                  _port_model(_jax_model("f32", seed=9)), tsim.Query(**q))]
    jpreds = [jsim.ALSSimilarAlgorithm(jsim.ALSSimilarParams()).predict(jm, jsim.Query(**q)),
              jsim.LikeAlgorithm(jsim.ALSSimilarParams()).predict(
                  _jax_model("f32", seed=9), jsim.Query(**q))]
    got = tsim.SumScoreServing().serve(tsim.Query(**q), tpreds)
    want = jsim.SumScoreServing().serve(jsim.Query(**q), jpreds)
    _same([got], [want], rtol=1e-6)
    assert len(got.item_scores) == 7
    sums = {}
    for p in tpreds:
        for s in p.item_scores:
            sums[s.item] = sums.get(s.item, 0.0) + s.score
    assert got.item_scores[0].score == max(sums.values())


# -- a whole CPU train by variant ------------------------------------------------


def _init(n_users, n_items, rank):
    rng = np.random.default_rng(17 + rank)
    return ((rng.standard_normal((n_users, rank)) / np.sqrt(rank)).astype(np.float32),
            (rng.standard_normal((n_items, rank)) / np.sqrt(rank)).astype(np.float32))


@pytest.fixture(scope="module")
def trained(stores):
    ts, js = stores
    mp = pytest.MonkeyPatch()
    mp.setenv("PIO_DENSE_ALS", "0")
    port_train, jax_train = tals.train, jals.train
    mp.setattr(tals, "train", lambda r, c, v, nu, ni, p, **kw: port_train(
        r, c, v, nu, ni, p, **dict(kw, init_factors=_init(nu, ni, p.rank))))
    mp.setattr(jals, "train", lambda r, c, v, nu, ni, p, **kw: jax_train(
        r, c, v, nu, ni, p, **dict(kw, init_factors=_init(nu, ni, p.rank))))
    try:
        jinst = jcore.run_train(js, J_VARIANT)
        tinst = tcore.run_train(ts, VARIANT, device="cpu")
        jdeploy = jcore.prepare_deploy_models(
            js, js.get_meta_data_engine_instances().get(jinst.id))
        tdeploy = tcore.prepare_deploy_models(
            ts, ts.get_meta_data_engine_instances().get(tinst.id), device="cpu")
    finally:
        mp.undo()
    return jdeploy, tdeploy


def test_trained_factors_match_jax(trained):
    (_, _, jmodels), (_, _, tmodels) = trained
    assert [type(m) for m in tmodels] == [tsim.SimilarModel] * 2
    for jm, tm in zip(jmodels, tmodels):
        assert tm.device == torch.device("cpu") and tm._serving_state is None
        assert tm.factors.item_vocab.to_dict() == jm.factors.item_vocab.to_dict()
        for side in ("user_factors", "item_factors"):
            np.testing.assert_allclose(getattr(tm.factors, side), getattr(jm.factors, side),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("items", [["i0", "i1"], ["i26"], ["i0", "i25"], ["nope"]])
def test_trained_answers_match_jax(trained, items):
    (je, jep, jmodels), (te, tep, tmodels) = trained
    talgs, jalgs = te.make_algorithms(tep), je.make_algorithms(jep)
    tq = tsim.Query(items=items, num=4)
    tpreds = [a.predict(m, tq) for a, m in zip(talgs, tmodels)]
    got = te.make_serving(tep).serve(tq, tpreds)
    assert type(te.make_serving(tep)).__name__ == "SumScoreServing"
    # the JAX engine on the port's deployed factors
    jq = jsim.Query(items=items, num=4)
    on_ours = [a.predict(jsim.SimilarModel(jals.ALSFactors(
        user_factors=m.factors.user_factors, item_factors=m.factors.item_factors,
        user_vocab=JBiMap(m.factors.user_vocab.to_dict()),
        item_vocab=JBiMap(m.factors.item_vocab.to_dict()))), jq)
        for a, m in zip(jalgs, tmodels)]
    _same(tpreds, on_ours, rtol=1e-5)
    _same([got], [je.make_serving(jep).serve(jq, on_ours)], rtol=1e-5)
    if items == ["nope"]:
        assert got.item_scores == []
    else:
        assert not {s.item for s in got.item_scores} & set(items)
    if items == ["i0", "i1"]:  # co-view structure: the cohort's items
        als_items = {s.item for s in tpreds[0].item_scores}
        assert len(als_items & {f"i{n}" for n in range(20)}) >= 3, als_items


def test_model_pickles_without_device_and_binds(trained):
    (_, _, _), (te, tep, tmodels) = trained
    tm = tmodels[0]
    alg = te.make_algorithms(tep)[0]
    alg.warmup(tm)
    blob = pickle.dumps(tm)
    back = pickle.loads(blob)
    assert back.device is None and back._serving_state is None
    with pytest.raises(RuntimeError, match="no device"):
        back.serving_state()
    back.bind_device("cpu")
    assert back.device == torch.device("cpu")
    assert back.serving_state().n_items == 40
    q = tsim.Query(items=["i2"], num=3)
    assert alg.predict(back, q) == alg.predict(tm, q)
    assert set(vars(back)) >= {"factors", "serve_dtype", "device"}
    assert set(tm.__getstate__()) == {"factors", "serve_dtype"}


def test_shard_serving_is_refused():
    extract_params(tsim.ALSSimilarParams, {"rank": 4, "shard_serving": False})
    with pytest.raises(ParamsError, match="shard_serving is not ported"):
        extract_params(tsim.ALSSimilarParams, {"rank": 4, "shard_serving": True})
    with pytest.raises(ParamsError, match="not ported"):
        tsim.SimilarProductEngine().apply().params_from_variant_json(
            {**VARIANT, "algorithms": [{"name": "als", "params": {"shard_serving": True}}]})


def test_like_algorithm_needs_likes():
    td = tsim.TrainingData(
        rows=np.array([0], np.int32), cols=np.array([0], np.int32),
        vals=np.array([1.0], np.float32), like_rows=np.zeros(0, np.int32),
        like_cols=np.zeros(0, np.int32), like_vals=np.zeros(0, np.float32),
        n_users=1, n_items=1, user_vocab=None, item_vocab=None)
    with pytest.raises(ValueError, match="like/dislike"):
        tsim.LikeAlgorithm(tsim.ALSSimilarParams()).train(RuntimeContext(device="cpu"), td)
