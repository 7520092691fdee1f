"""The classification template on the port against the JAX package's.

Both packages' sqlite stores get the same seeded ``$set`` events (150
users in three plans, four non-negative attributes, later ``$set``s
overwriting some, explicit ids and times).

- ``read_training`` and ``read_eval``'s folds equal exactly.
- ``run_train`` → ``prepare_deploy_models`` → predict for ``naive`` and
  ``logreg`` against the JAX engine: naive Bayes arrays within rtol 1e-5,
  logistic regression weights within rtol 1e-4, atol 1e-5·max|w| (the
  JAX package's grid bars), answers equal outside near-ties (top-two
  score margin ≤ 1e-4). ``randomforest`` the same with the JAX package's
  draws fed to the port's grower: trees equal, answers equal.
- The models pickle without a device (the blob holds none); deploy binds
  them.
- The three-algorithm variant (``FirstServing``) behind the port's
  ``QueryServer``: answers over HTTP equal the forest's; a non-object
  query (this engine has no serializer) answers 400.
- ``run_evaluation`` of an NB λ grid and an LR grid (3 folds) through
  ``_batch_eval_grid``, one ``train_grid`` a fold, against the JAX
  package's evaluation: the same Accuracy per point.
"""

import datetime as dt
import json
import pickle
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from predictionio_tpu.controller import Evaluation as JEvaluation  # noqa: E402
from predictionio_tpu.controller import EngineParams as JEngineParams  # noqa: E402
from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App as JApp  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.engines.classification import engine as jcls  # noqa: E402
from predictionio_tpu.workflow import core as jcore  # noqa: E402
from predictionio_tpu.workflow.evaluation import run_evaluation as jrun_eval  # noqa: E402
from predictionio_tpu_torch.controller import EngineParams, Evaluation  # noqa: E402
from predictionio_tpu_torch.controller.persistent import (  # noqa: E402
    deserialize_models,
    serialize_models,
)
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.engines.classification import engine as tcls  # noqa: E402
from predictionio_tpu_torch.models import forest as tforest  # noqa: E402
from predictionio_tpu_torch.workflow import core as tcore  # noqa: E402
from predictionio_tpu_torch.workflow import server as tserver  # noqa: E402
from predictionio_tpu_torch.workflow.evaluation import run_evaluation  # noqa: E402

APP = "clsapp"
ATTRS = ["attr0", "attr1", "attr2", "attr3"]
T0 = dt.datetime(2024, 9, 1, tzinfo=dt.timezone.utc)
DS = {"app_name": APP, "attrs": ATTRS, "label_attr": "plan"}
VARIANT = {"id": "cls",
           "engineFactory": "predictionio_tpu_torch.engines.classification.ClassificationEngine",
           "datasource": {"params": DS}}
J_VARIANT = {**VARIANT, "engineFactory":
             "predictionio_tpu.engines.classification.ClassificationEngine"}
ALGOS = {"naive": {"lambda_": 1.0}, "logreg": {"iterations": 150},
         "randomforest": {"num_trees": 6, "max_depth": 4}}


def _rows():
    """(user, properties) $set events: three plans with class-dependent
    attribute levels, then 30 later $sets overwriting one attribute."""
    rng = np.random.default_rng(21)
    plans = ["free", "basic", "premium"]
    level = np.array([[1.0, 6.0, 2.0, 1.0], [4.0, 3.0, 4.0, 1.5], [8.0, 1.0, 6.0, 2.0]])
    rows = []
    for u, c in enumerate(rng.permutation(np.arange(150) % 3)):
        vals = np.abs(level[c] + 1.5 * rng.standard_normal(4))
        rows.append((f"u{u:03d}", {**{a: round(float(v), 4) for a, v in zip(ATTRS, vals)},
                                   "plan": plans[c]}))
    for u in rng.choice(150, 30, replace=False):
        rows.append((f"u{u:03d}", {"attr3": round(float(rng.random() * 3), 4)}))
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
        [make(event="$set", entity_type="user", entity_id=u, properties=p,
              event_time=T0 + dt.timedelta(seconds=n), creation_time=T0, event_id=f"c{n:04d}")
         for n, (u, p) in enumerate(_rows())], app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("cls")
    return (_storage(Storage, StorageConfig, SourceConfig, App, Event, base / "port"),
            _storage(JStorage, JStorageConfig, JSourceConfig, JApp, JEvent, base / "jax"))


def test_training_data_and_folds_match_jax(stores):
    ts, js = stores
    tds = tcls.ClassificationDataSource(tcls.DataSourceParams(**DS, eval_k=3))
    jds = jcls.ClassificationDataSource(jcls.DataSourceParams(**DS, eval_k=3))
    got = tds.read_training(RuntimeContext(storage=ts, device="cpu"))
    want = jds.read_training(JContext(storage=js))
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.features.dtype == np.float32 and got.labels.dtype == np.int32
    assert got.label_vocab == want.label_vocab == ("basic", "free", "premium")
    assert got.features.shape == (150, 4)
    for (ttd, tei, tqa), (jtd, jei, jqa) in zip(
            tds.read_eval(RuntimeContext(storage=ts, device="cpu")),
            jds.read_eval(JContext(storage=js))):
        np.testing.assert_array_equal(ttd.features, jtd.features)
        np.testing.assert_array_equal(ttd.labels, jtd.labels)
        assert tei.fold == jei.fold
        assert [(q.features, a.label) for q, a in tqa] == [(q.features, a.label)
                                                           for q, a in jqa]


def _jax_draws(n_trees, n, d, depth, k, seed, device):
    """The JAX package's forest draws, in `forest.draw_forest`'s signature
    (tests/test_torch_forest.py)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_trees)
    boot = np.stack([np.asarray(jax.random.poisson(jax.random.fold_in(key, 0), 1.0, (n,)))
                     for key in keys]).astype(np.float32)
    uniforms = [None if k >= d else torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(jax.random.fold_in(key, level + 1), (2 ** level, d)))
        for key in keys])).to(device) for level in range(depth)]
    return torch.from_numpy(boot).to(device), uniforms


@pytest.fixture(scope="module")
def deployed(stores):
    """Each algorithm trained by variant and deployed, in both packages;
    the port's forest draws are the JAX package's."""
    ts, js = stores
    mp = pytest.MonkeyPatch()
    mp.setattr(tforest, "draw_forest", _jax_draws)
    out = {}
    try:
        for name, params in ALGOS.items():
            algos = [{"name": name, "params": params}]
            tinst = tcore.run_train(ts, {**VARIANT, "algorithms": algos}, device="cpu")
            jinst = jcore.run_train(js, {**J_VARIANT, "algorithms": algos})
            out[name] = (tcore.prepare_deploy_models(ts, tinst, device="cpu"),
                         jcore.prepare_deploy_models(js, jinst), tinst)
    finally:
        mp.undo()
    return out


def _queries(n=60, seed=22):
    rng = np.random.default_rng(seed)
    return [list(np.round(np.abs(rng.normal(4.0, 3.0, 4)), 3)) for _ in range(n)]


@pytest.mark.parametrize("name", list(ALGOS))
def test_trained_engine_matches_jax(deployed, name):
    (te, tep, [tm]), (je, jep, [jm]), _ = deployed[name]
    assert tm.device == torch.device("cpu") and tm.label_vocab == jm.label_vocab
    if name == "naive":
        np.testing.assert_allclose(tm.model.log_prior, jm.model.log_prior, rtol=1e-5)
        np.testing.assert_allclose(tm.model.log_likelihood, jm.model.log_likelihood, rtol=1e-5)
    elif name == "logreg":
        w = jm.model.weights
        np.testing.assert_allclose(tm.model.weights, w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
    else:
        for f in ("features", "routes_f", "routes_t", "bin_edges"):
            np.testing.assert_array_equal(getattr(tm.model, f), getattr(jm.model, f))
        np.testing.assert_allclose(tm.model.leaf_proba, jm.model.leaf_proba, atol=1e-6)
    [talg], [jalg] = te.make_algorithms(tep), je.make_algorithms(jep)
    qs = _queries()
    x = np.asarray(qs, np.float32)
    scores = (jm.model.predict_proba(x) if name == "randomforest"
              else jm.model.predict_scores(x))
    top2 = np.sort(scores, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.mean() > 0.9
    got = talg.batch_predict(None, tm, list(enumerate(tcls.Query(q) for q in qs)))
    want = jalg.batch_predict(None, jm, list(enumerate(jcls.Query(q) for q in qs)))
    assert [p.label for _, p in got] == [talg.predict(tm, tcls.Query(q)).label for q in qs]
    for ok, (_, g), (_, w) in zip(clear, got, want):
        if ok:
            assert g.label == w.label


@pytest.mark.parametrize("name", list(ALGOS))
def test_models_pickle_without_a_device(stores, deployed, name):
    ts, _ = stores
    *_, inst = deployed[name]
    [m] = deserialize_models(ts.get_model_data_models().get(inst.id).models)
    assert m.device is None and m.model._staged is None
    with pytest.raises(RuntimeError, match="bind_device"):
        tcls.NaiveBayesAlgorithm(tcls.NaiveBayesParams()).predict(m, tcls.Query([1.0] * 4))
    m.bind_device("cpu")
    (_, _, [deployed_m]), _, _ = deployed[name]
    q = np.asarray(_queries(10), np.float32)
    np.testing.assert_array_equal(m.model.predict(q), deployed_m.model.predict(q))
    assert pickle.loads(serialize_models([deployed_m]))[0].device is None


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_three_algorithm_variant_serves_the_forest(stores):
    ts, _ = stores
    variant = {**VARIANT, "algorithms": [{"name": n, "params": ALGOS[n]}
                                         for n in ("randomforest", "logreg", "naive")]}
    inst = tcore.run_train(ts, variant, device="cpu")
    rt = tserver.build_runtime(ts, inst, device="cpu")
    assert rt.query_serializer is None
    server = tserver.QueryServer(runtime=rt, storage=ts,
                                 config=tserver.QueryServerConfig(ip="127.0.0.1", port=0))
    port = server.start()
    try:
        for q in _queries(12, seed=23):
            status, body = _post(port, {"features": q})
            want = rt.algorithms[0].predict(rt.models[0], tcls.Query(q))
            assert status == 200 and body == {"label": want.label}
        for bad in ([1.0, 2.0, 3.0, 4.0], 7, "x", None):
            status, body = _post(port, bad)
            assert status == 400 and body["message"] == "query must be a JSON object"
        assert _post(port, {"features": [1.0], "extra": 1})[0] == 400
    finally:
        server.stop()


def _grid(mod, algo, params_cls, points, eval_k=3):
    dsp = mod.DataSourceParams(**DS, eval_k=eval_k)
    return [(EngineParams if mod is tcls else JEngineParams)(
        data_source_params=("", dsp), algorithm_params_list=((algo, params_cls(**p)),))
        for p in points]


@pytest.mark.parametrize("algo,points", [
    ("naive", [{"lambda_": lam} for lam in (0.5, 1.0, 2.0, 4.0)]),
    ("logreg", [{"lr": 0.3, "l2": 1e-4, "iterations": 80},
                {"lr": 0.5, "l2": 1e-3, "iterations": 80},
                {"lr": 0.8, "l2": 1e-2, "iterations": 80}]),
])
def test_grid_evaluation_matches_jax(stores, monkeypatch, algo, points):
    ts, js = stores
    tparams = {"naive": tcls.NaiveBayesParams, "logreg": tcls.LogisticRegressionParams}[algo]
    jparams = {"naive": jcls.NaiveBayesParams, "logreg": jcls.LogisticRegressionParams}[algo]
    calls = []
    algo_cls = type(tcls.ClassificationEngine().apply().make_algorithms(
        _grid(tcls, algo, tparams, points[:1])[0])[0])
    real = algo_cls.train_grid
    monkeypatch.setattr(algo_cls, "train_grid",
                        lambda self, ctx, pd, pl: calls.append(len(pl)) or real(self, ctx, pd, pl))

    class TEval(Evaluation):
        engine = tcls.ClassificationEngine().apply()
        metric = tcls.Accuracy()

    class JEval(JEvaluation):
        engine = jcls.ClassificationEngine().apply()
        metric = jcls.Accuracy()

    tinst, tres = run_evaluation(ts, TEval(), _grid(tcls, algo, tparams, points), device="cpu")
    _, jres = jrun_eval(js, JEval(), _grid(jcls, algo, jparams, points))
    assert tinst.status == "EVALCOMPLETED" and tinst.env["grid_points"] == str(len(points))
    assert calls == [len(points)] * 3  # one train_grid a fold, every point in it
    got = [s.score for s in tres.engine_params_scores]
    want = [s.score for s in jres.engine_params_scores]
    np.testing.assert_allclose(got, want, atol=2 / 150)  # at most one near-tie apart
    assert all(g > 0.5 for g in got)
