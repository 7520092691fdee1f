"""The regression template on the port against the JAX package's.

Both packages' sqlite stores get the same seeded ``$set`` events (120
points, three features, a linear target plus noise, explicit ids and
times).

- ``read_training`` and ``read_eval``'s folds equal exactly.
- ``run_train`` → ``prepare_deploy_models`` → predict against the JAX
  engine: weights within rtol 1e-4, the intercept within rtol 1e-3 (the
  JAX package's grid bars, tests/test_grid_eval.py:63-64), the same
  predictions from the same weights.
- ``RegressionAverageServing``: the JAX class raises TypeError on one
  PredictedResult (its inherited serve sums the objects); the port's
  answers the mean of the predictions' values.
- The port's ``QueryServer`` takes a bare JSON array and
  ``{"features": [...]}`` through the engine's query serializer and
  answers a bare number; what the serializer rejects answers 400 (also
  features that are not numbers, where the JAX package's serializer
  raises TypeError).
- ``run_evaluation`` of an l2 grid (4 folds) through ``_batch_eval_grid``,
  one ``train_grid`` a fold: each point's MeanSquareError within rtol
  1e-4 of the MSE of the JAX package's ridge trained on the JAX
  package's folds, and the lowest MSE is the best point.
- The model pickles (no device).
"""

import datetime as dt
import json
import pickle
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App as JApp  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.engines.regression import engine as jreg  # noqa: E402
from predictionio_tpu.models import linreg as jlinreg  # noqa: E402
from predictionio_tpu.workflow import core as jcore  # noqa: E402
from predictionio_tpu_torch.controller import EngineParams, Evaluation  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.engines.regression import engine as treg  # noqa: E402
from predictionio_tpu_torch.workflow import core as tcore  # noqa: E402
from predictionio_tpu_torch.workflow import server as tserver  # noqa: E402
from predictionio_tpu_torch.workflow.evaluation import run_evaluation  # noqa: E402

APP = "regapp"
T0 = dt.datetime(2024, 9, 2, tzinfo=dt.timezone.utc)
DS = {"app_name": APP}
VARIANT = {"id": "reg",
           "engineFactory": "predictionio_tpu_torch.engines.regression.RegressionEngine",
           "datasource": {"params": DS},
           "algorithms": [{"name": "ridge", "params": {"l2": 1e-3}}]}
J_VARIANT = {**VARIANT, "engineFactory":
             "predictionio_tpu.engines.regression.engine.RegressionEngine"}


def _rows():
    rng = np.random.default_rng(31)
    rows = []
    for n in range(120):
        x = np.round(rng.normal([2.0, -1.0, 5.0], [1.0, 2.0, 0.5]), 4)
        y = 1.5 * x[0] - 0.7 * x[1] + 0.2 * x[2] + 3.0 + 0.1 * rng.standard_normal()
        rows.append((f"p{n:03d}", {"x0": float(x[0]), "x1": float(x[1]), "x2": float(x[2]),
                                   "y": round(float(y), 4)}))
    return rows


def _storage(storage_cls, config_cls, source_cls, app_cls, make, path):
    path.mkdir(parents=True, exist_ok=True)
    storage = storage_cls(config_cls(
        sources={"S": source_cls("S", "sqlite", {"PATH": str(path / "pio.db")}),
                 "F": source_cls("F", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "F"}))
    app_id = storage.get_meta_data_apps().insert(app_cls(0, APP))
    storage.get_events().init_app(app_id)
    storage.get_events().insert_batch(
        [make(event="$set", entity_type="point", entity_id=e, properties=p,
              event_time=T0 + dt.timedelta(seconds=n), creation_time=T0, event_id=f"r{n:04d}")
         for n, (e, p) in enumerate(_rows())], app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("reg")
    return (_storage(Storage, StorageConfig, SourceConfig, App, Event, base / "port"),
            _storage(JStorage, JStorageConfig, JSourceConfig, JApp, JEvent, base / "jax"))


def test_training_data_and_folds_match_jax(stores):
    ts, js = stores
    tds = treg.RegressionDataSource(treg.DataSourceParams(**DS, eval_k=4))
    jds = jreg.RegressionDataSource(jreg.DataSourceParams(**DS, eval_k=4))
    got = tds.read_training(RuntimeContext(storage=ts, device="cpu"))
    want = jds.read_training(JContext(storage=js))
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.targets, want.targets)
    assert got.features.shape == (120, 3) and got.targets.dtype == np.float32
    for (ttd, tei, tqa), (jtd, jei, jqa) in zip(
            tds.read_eval(RuntimeContext(storage=ts, device="cpu")),
            jds.read_eval(JContext(storage=js))):
        np.testing.assert_array_equal(ttd.features, jtd.features)
        np.testing.assert_array_equal(ttd.targets, jtd.targets)
        assert tei.fold == jei.fold
        assert [(q.features, a.value) for q, a in tqa] == [(q.features, a.value)
                                                           for q, a in jqa]


@pytest.fixture(scope="module")
def deployed(stores):
    ts, js = stores
    tinst = tcore.run_train(ts, VARIANT, device="cpu")
    jinst = jcore.run_train(js, J_VARIANT)
    return (tcore.prepare_deploy_models(ts, tinst, device="cpu"),
            jcore.prepare_deploy_models(js, jinst), tinst)


def test_trained_engine_matches_jax(deployed):
    (te, tep, [tm]), (je, jep, [jm]), _ = deployed
    np.testing.assert_allclose(tm.model.weights, jm.model.weights, rtol=1e-4)
    assert tm.model.intercept == pytest.approx(jm.model.intercept, rel=1e-3)
    [talg], [jalg] = te.make_algorithms(tep), je.make_algorithms(jep)
    same = treg.RidgeModel(model=treg.linreg.LinearRegressionModel(
        jm.model.weights, jm.model.intercept))
    qs = [[1.0, 2.0, 3.0], [0.5, -4.0, 5.5], [2.0, -1.0, 5.0]]
    for q in qs:
        assert talg.predict(same, treg.Query(q)) == treg.PredictedResult(
            jalg.predict(jm, jreg.Query(q)).value)
    got = talg.batch_predict(None, tm, list(enumerate(treg.Query(q) for q in qs)))
    assert [p.value for _, p in got] == [talg.predict(tm, treg.Query(q)).value for q in qs]
    assert isinstance(talg.query_serializer(), treg.VectorQuerySerializer)


def test_average_serving_repairs_the_jax_crash():
    with pytest.raises(TypeError):
        jreg.RegressionAverageServing().serve(None, [jreg.PredictedResult(1.0)])
    one = treg.RegressionAverageServing().serve(None, [treg.PredictedResult(1.25)])
    assert one == treg.PredictedResult(1.25)
    two = treg.RegressionAverageServing().serve(
        None, [treg.PredictedResult(1.0), treg.PredictedResult(2.0)])
    assert two == treg.PredictedResult(1.5)


def _post(port, raw):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json", data=raw.encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_query_server_takes_bare_arrays(stores, deployed):
    ts, _ = stores
    *_, inst = deployed
    rt = tserver.build_runtime(ts, inst, device="cpu")
    assert isinstance(rt.query_serializer, treg.VectorQuerySerializer)
    server = tserver.QueryServer(runtime=rt, storage=ts,
                                 config=tserver.QueryServerConfig(ip="127.0.0.1", port=0))
    port = server.start()
    try:
        for q in ([1.0, 2.0, 3.0], [0.25, -1.5, 4.75]):
            want = rt.models[0].model.predict(np.asarray(q, np.float32))[0]
            for body in (json.dumps(q), json.dumps({"features": q})):
                status, got = _post(port, body)
                assert status == 200 and got == float(want), body
        for bad in ('{"x": [1, 2, 3]}', '"text"', "7", "null", '[1.0, "a", 2.0]',
                    '{"features": 3}', '[1.0, null, 2.0]', '[[1.0], 2.0, 3.0]'):
            status, got = _post(port, bad)
            assert status == 400 and got["message"].startswith(
                "query serializer rejected:"), bad
        status, got = _post(port, "[1.0,")
        assert status == 400 and got["message"].startswith("invalid query JSON")
    finally:
        server.stop()


def test_grid_evaluation_matches_jax_ridge(stores, monkeypatch):
    ts, js = stores
    l2s = [1e-6, 1e-1, 10.0]
    calls = []
    real = treg.RidgeAlgorithm.train_grid
    monkeypatch.setattr(treg.RidgeAlgorithm, "train_grid",
                        lambda self, ctx, pd, pl: calls.append(len(pl)) or real(self, ctx, pd, pl))
    dsp = treg.DataSourceParams(**DS, eval_k=4)
    grid = [EngineParams(data_source_params=("", dsp),
                         algorithm_params_list=(("ridge", treg.RidgeParams(l2=l2)),))
            for l2 in l2s]

    class RegEval(Evaluation):
        engine = treg.RegressionEngine().apply()
        metric = treg.MeanSquareError()

    inst, res = run_evaluation(ts, RegEval(), grid, device="cpu")
    assert inst.status == "EVALCOMPLETED" and calls == [3] * 4
    # the JAX package's ridge on its own folds (its engine's serving raises)
    sq = [[] for _ in l2s]
    for td, _ei, qa in jreg.RegressionDataSource(
            jreg.DataSourceParams(**DS, eval_k=4)).read_eval(JContext(storage=js)):
        models = jlinreg.train_linear_regression_grid(td.features, td.targets, l2s)
        x = np.asarray([q.features for q, _ in qa], np.float32)
        for g, m in enumerate(models):
            sq[g] += [(float(p) - a.value) ** 2 for p, (_, a) in zip(m.predict(x), qa)]
    want = [float(np.mean(s)) for s in sq]
    got = [s.score for s in res.engine_params_scores]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert res.best_index == int(np.argmin(got)) and got[2] > got[0]


def test_model_pickles(deployed):
    (_, _, [tm]), _, _ = deployed
    back = pickle.loads(pickle.dumps(tm))
    x = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    np.testing.assert_array_equal(back.model.predict(x), tm.model.predict(x))
