"""Storage-backed train → deploy → query on the port, against the JAX
package (its tests/test_recommendation_e2e.py loop).

The same seeded events (explicit ids and times, so that both stores order
them the same way) go into both packages' sqlite + localfs storage, wired
as the JAX package's tests wire it (tests/conftest.py's
``fresh_storage``). Each package runs ``run_train`` from an engine
variant, ``prepare_deploy_models`` and the engine's predict, on the dense
path (``PIO_DENSE_ALS=1``) and on the windowed one (``PIO_DENSE_ALS=0``),
both trains from the same seeded start factors.

- ``TrainingData`` read from storage: equal exactly.
- Factors, windowed: within rtol = atol = 1e-4, the bar of
  tests/test_torch_train_slice.py (f32 sums in another order, carried
  through the alternating iterations). Dense (int8 storage): each
  iteration, started from the JAX package's state of the one before,
  within rtol = atol = 2e-3 of the JAX iteration, the bar of
  tests/test_torch_als_train.py. The whole dense run is not held
  elementwise: the factors enter each pass rounded to bf16, one rounding
  that an f32-noise difference flips in the first iteration (8.3e-4 on
  this data) grows through the loop (ROADMAP, Queue 3: "bf16 operands
  make int8 trains sensitive").
- Top-N answers, windowed: the same item ids as the JAX package's
  end-to-end answers, compared as sets among items whose scores lie
  within 1e-3 of the list's last score (near-ties may swap under the
  factor tolerance), and scores within atol 1e-3. Both paths: the same
  item ids as the JAX engine's predict on the port's deployed factors,
  scores within rtol 1e-5 (tests/test_torch_train_slice.py's serving
  bar). Blacklists, whitelists, an unknown user and ``batch_predict``
  equal the lone predict's answers exactly.
- The instance rows' stage-params JSON: equal (the JAX ALS params also
  carry its one field the port has not ported, at its default; it is
  dropped before comparing).

The Universal Recommender trains and deploys by variant the same way
(tables within the LLR tolerance of tests/test_torch_cco.py, answers
with the same items and scores within rtol 1e-5). The rest: the console
loop over HTTP on the CPU, the device a deployed model serves on, and
the refusals (a JAX factory path, a JAX-pickled blob, unported fields).
"""

import dataclasses
import datetime as dt
import http.client
import json
import os

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
from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu.workflow import core as jcore  # noqa: E402
from predictionio_tpu_torch.controller import ParamsError, deserialize_models  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App, StorageError  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402
from predictionio_tpu_torch.engines.universal import engine as tur  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402
from predictionio_tpu_torch.tools import console  # noqa: E402
from predictionio_tpu_torch.workflow import core as tcore  # noqa: E402
from predictionio_tpu_torch.workflow.server import _to_jsonable  # noqa: E402
from test_torch_cco import assert_correlators_close  # noqa: E402

APP = "wfapp"
RANK, ITERS = 6, 4
T0 = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)
ALGO = {"name": "als", "params": {"rank": RANK, "num_iterations": ITERS,
                                  "lambda_": 0.05}}
VARIANT = {
    "id": "rec-wf",
    "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
    "datasource": {"params": {"app_name": APP, "event_names": ["rate", "buy"]}},
    "algorithms": [ALGO],
}
J_VARIANT = {**VARIANT, "engineFactory":
             "predictionio_tpu.engines.recommendation.RecommendationEngine"}
_JAX_ONLY_ALS = {"shard_serving": False}
_PORT_TRAIN = tals.train  # before any test wraps it


def _rows():
    """(event, user, item, rating) rows: two cohorts with disjoint item
    groups, two repeated pairs a user (summed), and a weak cross-group buy."""
    rng = np.random.RandomState(7)
    rows = []
    for u in range(40):
        group = u % 2
        items = rng.choice(12, 10, replace=False) + group * 12
        rated = [("rate", f"u{u}", f"i{i}", float(rng.randint(1, 6))) for i in items]
        rows += rated + [rated[k][:3] + (1.0,) for k in (0, 3)]
        rows.append(("buy", f"u{u}", f"i{(1 - group) * 12 + u % 12}", None))
    return rows


def _events(make, rows, first=0):
    return [
        make(event=e, entity_type="user", entity_id=u,
             target_entity_type="item", target_entity_id=i,
             properties={} if r is None else {"rating": r},
             event_time=T0 + dt.timedelta(seconds=first + n), creation_time=T0,
             event_id=f"e{first + n:06d}")
        for n, (e, u, i, r) in enumerate(rows)
    ]


def _jax_storage(path):
    """tests/conftest.py's fresh_storage wiring, under `path`."""
    path.mkdir(parents=True, exist_ok=True)
    return JStorage(JStorageConfig(
        sources={"TESTSQL": JSourceConfig("TESTSQL", "sqlite", {"PATH": str(path / "pio.db")}),
                 "TESTFS": JSourceConfig("TESTFS", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "TESTSQL", "EVENTDATA": "TESTSQL", "MODELDATA": "TESTFS"},
    ))


def _port_storage(path):
    path.mkdir(parents=True, exist_ok=True)
    return Storage(StorageConfig(
        sources={"TESTSQL": SourceConfig("TESTSQL", "sqlite", {"PATH": str(path / "pio.db")}),
                 "TESTFS": SourceConfig("TESTFS", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "TESTSQL", "EVENTDATA": "TESTSQL", "MODELDATA": "TESTFS"},
    ))


def _seed(storage, app_cls, event_cls, app, rows):
    path_id = storage.get_meta_data_apps().insert(app_cls(0, app))
    storage.get_events().init_app(path_id)
    storage.get_events().insert_batch(_events(event_cls, rows), path_id)
    return storage


def _init(n_users, n_items, rank):
    rng = np.random.default_rng(11)
    return ((rng.standard_normal((n_users, rank)) / np.sqrt(rank)).astype(np.float32),
            (rng.standard_normal((n_items, rank)) / np.sqrt(rank)).astype(np.float32))


def _same_start(mp):
    """Both packages' ALS trains start from `_init`'s factors."""
    paths = []

    def port_train(rows, cols, vals, n_users, n_items, params, init_factors=None, **kw):
        return _PORT_TRAIN(rows, cols, vals, n_users, n_items, params,
                    init_factors=_init(n_users, n_items, params.rank), **kw)

    mp.setattr(tals, "train", port_train)
    mp.setattr(jeng.ALSAlgorithm, "_warm_start_init",
               lambda self, ctx, pd, p: _init(pd.n_users, pd.n_items, p.rank))
    for name in ("_train_dense", "_train_windowed", "_train_scatter"):
        fn = getattr(tals, name)
        mp.setattr(tals, name, lambda *a, _f=fn, _n=name, **k: (paths.append(_n), _f(*a, **k))[1])
    return paths


@pytest.fixture(scope="module", params=["dense", "windowed"])
def loop(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("PIO_DENSE_ALS", "1" if request.param == "dense" else "0")
    mp.setenv("PIO_PALLAS_DENSE", "interpret")  # the JAX dense kernel itself
    paths = _same_start(mp)
    base = tmp_path_factory.mktemp(f"loop_{request.param}")
    rows = _rows()
    js = _seed(_jax_storage(base / "jax"), JApp, JEvent, APP, rows)
    ts = _seed(_port_storage(base / "port"), App, Event, APP, rows)
    jinst = jcore.run_train(js, J_VARIANT)
    tinst = tcore.run_train(ts, VARIANT, device="cpu")
    # deploy loads the model: no train may run
    mp.setattr(teng.ALSAlgorithm, "train", lambda *a: pytest.fail("deploy trained"))
    jdeploy = jcore.prepare_deploy_models(js, js.get_meta_data_engine_instances().get(jinst.id))
    tdeploy = tcore.prepare_deploy_models(
        ts, ts.get_meta_data_engine_instances().get(tinst.id), device="cpu")
    mp.undo()
    return dataclasses.make_dataclass("Loop", ["mode", "paths", "js", "ts", "jinst",
                                               "tinst", "jdeploy", "tdeploy"])(
        request.param, paths, js, ts, jinst, tinst, jdeploy, tdeploy)


def test_training_data_matches_jax(loop, monkeypatch):
    jtd = jeng.RecommendationDataSource(jeng.DataSourceParams(APP)).read_training(
        JContext(storage=loop.js))
    ttd = teng.RecommendationDataSource(teng.DataSourceParams(APP)).read_training(
        RuntimeContext(storage=loop.ts, device="cpu"))
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ttd, f), getattr(jtd, f))
        assert getattr(ttd, f).dtype == getattr(jtd, f).dtype
    assert (ttd.n_users, ttd.n_items) == (jtd.n_users, jtd.n_items) == (40, 24)
    assert ttd.user_vocab.to_dict() == jtd.user_vocab.to_dict()
    assert ttd.item_vocab.to_dict() == jtd.item_vocab.to_dict()
    assert len(ttd.rows) < len(_rows())  # repeated pairs were summed
    monkeypatch.setenv("PIO_DENSE_ALS", "1" if loop.mode == "dense" else "0")
    jp = jals.ALSParams(rank=RANK)
    assert jals.dense_eligible(jtd.rows, jtd.cols, jtd.vals, jtd.n_users,
                               jtd.n_items, jp) == (loop.mode == "dense")
    assert loop.paths == [f"_train_{loop.mode}"]


def _read(loop):
    return teng.RecommendationDataSource(teng.DataSourceParams(APP)).read_training(
        RuntimeContext(storage=loop.ts, device="cpu"))


def test_factors_match_jax(loop):
    (_, _, [jm]), (_, _, [tm]) = loop.jdeploy, loop.tdeploy
    assert isinstance(tm, teng.ALSModel) and tm.device == torch.device("cpu")
    assert tm.factors.user_vocab.to_dict() == jm.factors.user_vocab.to_dict()
    for side in ("user_factors", "item_factors"):
        assert np.all(np.isfinite(getattr(tm.factors, side)))
    if loop.mode == "windowed":
        for side in ("user_factors", "item_factors"):
            np.testing.assert_allclose(getattr(tm.factors, side),
                                       getattr(jm.factors, side), rtol=1e-4, atol=1e-4)
        return
    td = _read(loop)
    jp = jals.ALSParams(rank=RANK, iterations=1, lambda_=0.05)
    tp = tals.ALSParams(rank=RANK, iterations=1, lambda_=0.05)
    state = _init(td.n_users, td.n_items, RANK)
    for _ in range(ITERS):
        ref = jals.train(td.rows, td.cols, td.vals, td.n_users, td.n_items, jp,
                         init_factors=state)
        got = _PORT_TRAIN(td.rows, td.cols, td.vals, td.n_users, td.n_items, tp,
                          init_factors=state, device="cpu")
        for side in ("user_factors", "item_factors"):
            np.testing.assert_allclose(getattr(got, side), getattr(ref, side),
                                       rtol=2e-3, atol=2e-3)
        state = (ref.user_factors, ref.item_factors)


def test_instance_rows_match_jax(loop):
    j = loop.js.get_meta_data_engine_instances().get(loop.jinst.id)
    t = loop.ts.get_meta_data_engine_instances().get(loop.tinst.id)
    assert t.status == j.status == "COMPLETED"
    for f in ("data_source_params", "preparator_params", "serving_params",
              "engine_id", "engine_variant", "engine_version", "batch"):
        assert getattr(t, f) == getattr(j, f), f
    jalgos = json.loads(j.algorithms_params)
    for a in jalgos:
        assert {k: a["params"].pop(k) for k in _JAX_ONLY_ALS} == _JAX_ONLY_ALS
    assert json.loads(t.algorithms_params) == jalgos
    assert set(tcore.stage_timings(t)) == {"read", "prepare", "train", "persist"}
    [blob_model] = deserialize_models(loop.ts.get_model_data_models().get(t.id).models)
    assert type(blob_model) is teng.ALSModel


def _assert_topn_match(got, want, tol=1e-3):
    gi = [s.item for s in got.item_scores]
    wi = [s.item for s in want.item_scores]
    gs = np.array([s.score for s in got.item_scores])
    ws = np.array([s.score for s in want.item_scores])
    assert len(gi) == len(wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)
    if gi:
        boundary = {i for i, s in zip(gi + wi, list(gs) + list(ws))
                    if abs(s - ws[-1]) <= tol}
        assert set(gi) - boundary == set(wi) - boundary, (gi, wi)


QUERIES = {
    "cohort": dict(user="u0", num=5),
    "all_items": dict(user="u3", num=30),
    "blacklist": dict(user="u0", num=8, blacklist=["i0", "i1", "nope"]),
    "whitelist": dict(user="u1", num=8, whitelist=["i5", "i6", "i20"]),
    "unknown": dict(user="nobody", num=5),
}


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_answers_match_jax(loop, case):
    q = QUERIES[case]
    (je, jep, [jm]), (te, tep, [tm]) = loop.jdeploy, loop.tdeploy
    jalg, talg = je.make_algorithms(jep)[0], te.make_algorithms(tep)[0]
    jserv, tserv = je.make_serving(jep), te.make_serving(tep)
    tq = tserv.supplement(teng.Query(**q))
    got = tserv.serve(tq, [talg.predict(tm, tq)])
    if loop.mode == "windowed":
        want = jserv.serve(jeng.Query(**q), [jalg.predict(jm, jeng.Query(**q))])
        _assert_topn_match(got, want)
    # the JAX engine on the port's deployed factors
    on_ours = jalg.predict(_jax_model(tm), jeng.Query(**q))
    assert [s.item for s in got.item_scores] == [s.item for s in on_ours.item_scores]
    np.testing.assert_allclose([s.score for s in got.item_scores],
                               [s.score for s in on_ours.item_scores], rtol=1e-5)
    items = {s.item for s in got.item_scores}
    if case == "unknown":
        assert items == set()
    elif case == "blacklist":
        assert items and not items & {"i0", "i1"}
    elif case == "whitelist":
        assert items == {"i5", "i6", "i20"}
    elif case == "cohort":
        assert len(items & {f"i{n}" for n in range(12)}) >= 4, items


def _jax_model(tm):
    from predictionio_tpu.data.store.bimap import BiMap as JBiMap

    f = tm.factors
    return jeng.ALSModel(jals.ALSFactors(
        user_factors=f.user_factors, item_factors=f.item_factors,
        user_vocab=JBiMap(f.user_vocab.to_dict()),
        item_vocab=JBiMap(f.item_vocab.to_dict())))


def test_batch_predict_equals_single(loop):
    te, tep, [tm] = loop.tdeploy
    talg = te.make_algorithms(tep)[0]
    queries = [teng.Query(**q) for q in QUERIES.values()] + [
        teng.Query(user=f"u{n}", num=3 + n) for n in range(6)]
    batch = dict(talg.batch_predict(None, tm, list(enumerate(queries))))
    for n, q in enumerate(queries):
        assert batch[n] == talg.predict(tm, q)


# -- the console loop over HTTP -------------------------------------------


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/queries.json", body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _status(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def test_console_app_import_train_deploy_query(tmp_path, monkeypatch):
    """`app new`, `import`, `train --engine-json`, `deploy --engine-json`
    on the CPU over PIO_FS_BASEDIR; the served answers equal the engine's
    own on the rehydrated model."""
    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    events = tmp_path / "events.jsonl"
    events.write_text("\n".join(e.to_json() for e in _events(Event, _rows())) + "\n\n")
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps(VARIANT))
    assert console.main(["app", "new", APP]) == 0
    with pytest.raises(SystemExit, match="already exists"):
        console.main(["app", "new", APP])
    assert console.main(["import", "--app", APP, "--input", str(events)]) == 0
    assert console.main(["train", "--engine-json", str(variant), "--device", "cpu"]) == 0
    storage = Storage()
    [inst] = storage.get_meta_data_engine_instances().get_all()
    assert inst.status == "COMPLETED"
    args = console._parser().parse_args(
        ["deploy", "--engine-json", str(variant), "--ip", "127.0.0.1",
         "--port", "0", "--device", "cpu"])
    server = console.build_server(args)
    port = server.start()
    try:
        answers = [_post(port, q) for q in QUERIES.values()]
        bad = _post(port, {"user": "u1", "num": "3"})
        status = _status(port)
    finally:
        server.stop()
    engine, ep, [model] = tcore.prepare_deploy_models(storage, inst, device="cpu")
    algo = engine.make_algorithms(ep)[0]
    for (code, body), q in zip(answers, QUERIES.values()):
        assert code == 200
        assert body == _to_jsonable(algo.predict(model, teng.Query(**q)))
    assert bad[0] == 400
    assert status["engine_instance"] == inst.id and status["device"] == "cpu"
    assert status["requests"] == status["batches"] == len(QUERIES)  # the 400 never ran
    assert status["kernel_launches"] == 0  # the CPU runs the plain versions
    bad_line = tmp_path / "bad.jsonl"
    bad_line.write_text('{"event": "rate"}\n')
    with pytest.raises(SystemExit, match="line 1"):
        console.main(["import", "--app", APP, "--input", str(bad_line)])


# -- the Universal Recommender by variant ------------------------------------

UR_APP = "urwf"
UR_VARIANT = {
    "id": "ur-wf",
    "engineFactory": "predictionio_tpu_torch.engines.universal.UniversalRecommenderEngine",
    "datasource": {"params": {"app_name": UR_APP, "indicators": ["buy", "view"]}},
    "algorithms": [{"name": "ur", "params": {"app_name": UR_APP,
                                             "max_correlators_per_item": 10}}],
}


def _ur_rows():
    rng = np.random.RandomState(17)
    rows = []
    for u in range(20):
        g = u % 2
        rows += [("buy", f"u{u}", f"i{rng.randint(0, 4) + g * 4}", None) for _ in range(6)]
        rows += [("view", f"u{u}", f"a{rng.randint(0, 2) + g * 2}", None) for _ in range(4)]
    return rows + [("view", "lurker", "a0", None), ("view", "lurker", "a1", None)]


@pytest.fixture(scope="module")
def ur_loop(tmp_path_factory):
    base = tmp_path_factory.mktemp("ur")
    js = _seed(_jax_storage(base / "jax"), JApp, JEvent, UR_APP, _ur_rows())
    ts = _seed(_port_storage(base / "port"), App, Event, UR_APP, _ur_rows())
    jinst = jcore.run_train(js, {**UR_VARIANT, "engineFactory":
                                 "predictionio_tpu.engines.universal.UniversalRecommenderEngine"})
    tinst = tcore.run_train(ts, UR_VARIANT, device="cpu")
    return js, ts, jinst, tinst


def test_ur_by_variant_matches_jax(ur_loop):
    js, ts, jinst, tinst = ur_loop
    je, jep, [jm] = jcore.prepare_deploy_models(js, jinst)
    te, tep, [tm] = tcore.prepare_deploy_models(ts, tinst, device="cpu")
    assert type(tm) is tur.URModel and tm.device == torch.device("cpu")
    for jmi, tmi in zip(jm.indicator_models, tm.indicator_models):
        assert tmi.target_vocab.to_dict() == jmi.target_vocab.to_dict()
        assert_correlators_close((jmi.correlator_scores, jmi.correlator_idx),
                                 (tmi.correlator_scores, tmi.correlator_idx), 21)
    jalg, talg = je.make_algorithms(jep)[0], te.make_algorithms(tep)[0]
    jalg.set_serving_context(JContext(storage=js, mode="serve"))
    talg.set_serving_context(RuntimeContext(storage=ts, mode="serve", device="cpu"))
    for q in (dict(user="u0", num=4, exclude_seen=False), dict(user="u1", num=8),
              dict(user="lurker", num=4), dict(user="ghost"),
              dict(user="u2", num=5, blacklist=["i1"])):
        want = jalg.predict(jm, jur_query(q))
        got = talg.predict(tm, tur.Query(**q))
        assert [s.item for s in got.item_scores] == [s.item for s in want.item_scores]
        np.testing.assert_allclose([s.score for s in got.item_scores],
                                   [s.score for s in want.item_scores], rtol=1e-5)
    assert json.loads(ts.get_meta_data_engine_instances().get(tinst.id).algorithms_params) \
        == json.loads(js.get_meta_data_engine_instances().get(jinst.id).algorithms_params)


def jur_query(q):
    from predictionio_tpu.engines.universal import engine as jur

    return jur.Query(**q)


def test_ur_model_device_comes_from_the_deploy(tmp_path, monkeypatch):
    """A UR blob whose model state names "cuda:0" (as the port pickled it
    before the fix) deploys on the CPU when the deploy asks for the CPU;
    with no device named it needs the card."""
    ts = _seed(_port_storage(tmp_path), App, Event, UR_APP, _ur_rows())
    getstate = tur.URModel.__getstate__
    monkeypatch.setattr(tur.URModel, "__getstate__",
                        lambda self: {**getstate(self), "device": "cuda:0"})
    inst = tcore.run_train(ts, UR_VARIANT, device="cpu")
    monkeypatch.undo()
    _, _, [model] = tcore.prepare_deploy_models(ts, inst, device="cpu")
    assert model.device == torch.device("cpu")
    assert all(t[0].device.type == "cpu" for t in model.device_tables())
    if torch.cuda.is_available():
        _, _, [model] = tcore.prepare_deploy_models(ts, inst)
        assert model.device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcore.prepare_deploy_models(ts, inst)


# -- refusals ------------------------------------------------------------------


def test_jax_factory_and_blob_are_refused(tmp_path):
    """A JAX engineFactory is refused before any row is written; a blob the
    JAX package trained into shared storage is refused at deploy, naming
    its class."""
    js = _seed(_jax_storage(tmp_path), JApp, JEvent, APP, _rows())
    ts = _port_storage(tmp_path)
    with pytest.raises(ParamsError, match="JAX package"):
        tcore.run_train(ts, J_VARIANT, device="cpu")
    assert ts.get_meta_data_engine_instances().get_all() == []
    jinst = jcore.run_train(js, {**J_VARIANT, "algorithms": [
        {"name": "als", "params": {"rank": 4, "num_iterations": 1}}]})
    row = ts.get_meta_data_engine_instances().get(jinst.id)
    assert row.status == "COMPLETED"
    with pytest.raises(ParamsError, match="JAX package"):
        tcore.prepare_deploy_models(ts, row, device="cpu")
    with pytest.raises(Exception, match=r"predictionio_tpu\.engines\.recommendation\.engine\.ALSModel"):
        tcore.prepare_deploy_models(
            ts, row, engine=teng.RecommendationEngine().apply(),
            engine_params=teng.RecommendationEngine().apply().params_from_variant_json(
                {**VARIANT, "algorithms": [{"name": "als", "params": {"rank": 4}}]}),
            device="cpu")


@pytest.mark.parametrize("params", [
    {"app_name": APP, "read_item_categories": True},
    {"app_name": APP, "use_data_view": True},
])
def test_unported_variant_options_are_refused(tmp_path, params):
    """Sharded serving is refused, in the recommendation template and in
    the similar-product one, before any row is written. The two
    datasource options in `params` were refused too until item
    properties and the data view were ported; with either the variant
    trains."""
    ts = _port_storage(tmp_path)
    with pytest.raises(ParamsError, match="not ported"):
        tcore.run_train(ts, {**VARIANT, "datasource": {"params": params}, "algorithms": [
            {"name": "als", "params": {"shard_serving": True}}]}, device="cpu")
    with pytest.raises(ParamsError, match="not ported"):
        tcore.run_train(ts, {
            "id": "sim", "datasource": {"params": {"app_name": APP}},
            "engineFactory": "predictionio_tpu_torch.engines.similarproduct.SimilarProductEngine",
            "algorithms": [{"name": "als", "params": {"shard_serving": True}}]}, device="cpu")
    assert ts.get_meta_data_engine_instances().get_all() == []
    _seed(ts, App, Event, APP, _rows())
    params = dict(params, data_view_dir=str(tmp_path / "view"))
    inst = tcore.run_train(ts, {**VARIANT, "datasource": {"params": params}}, device="cpu")
    assert inst.status == "COMPLETED"


def test_failed_train_is_aborted_with_partial_timings(tmp_path):
    ts = _port_storage(tmp_path)
    variant = {**VARIANT, "datasource": {"params": {"app_name": "missing"}}}
    with pytest.raises(StorageError, match="Invalid app name"):
        tcore.run_train(ts, variant, device="cpu")
    [row] = ts.get_meta_data_engine_instances().get_all()
    assert row.status == "ABORTED" and tcore.stage_timings(row) == {}
    assert ts.get_model_data_models().get(row.id) is None


def test_run_train_and_deploy_on_memory_storage(monkeypatch):
    """The same loop over the in-memory store: the engine-instance rows
    and the model blob live in this process."""
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    ts = _seed(Storage(StorageConfig.memory()), App, Event, APP, _rows())
    inst = tcore.run_train(ts, VARIANT, device="cpu")
    instances = ts.get_meta_data_engine_instances()
    assert instances.get_latest_completed("rec-wf", "0", "rec-wf").id == inst.id
    engine, ep, [model] = tcore.prepare_deploy_models(ts, inst, device="cpu")
    answer = engine.make_algorithms(ep)[0].predict(model, teng.Query(user="u0", num=5))
    assert len(answer.item_scores) == 5
    assert instances.get_completed("rec-wf", "1", "rec-wf") == []
