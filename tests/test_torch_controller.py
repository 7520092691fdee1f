"""The port's DASE controller against the JAX package's.

- Params: the same variant JSON goes through both packages'
  ``extract_params`` / ``params_to_json`` and
  ``Engine.params_from_variant_json``; both accept it with the same JSON,
  or both refuse it (unknown, missing and wrong-typed fields).
- The port refuses what it must not take from the JAX package: an
  ``engineFactory`` path into it (``load_symbol``) and a pickled blob of
  its classes (``deserialize_models``), each without importing it, and
  the JAX fields it has not ported (a ``ParamsError`` saying so).
- A model that does not pickle raises at ``serialize_models``, naming its
  class; it is never stored as retrain-on-deploy.

No tolerance: every comparison here is exact.
"""

import json
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.controller import params as jparams  # noqa: E402
from predictionio_tpu.engines.ecommerce import engine as jec  # noqa: E402
from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu.engines.similarproduct import engine as jsim  # noqa: E402
from predictionio_tpu.engines.universal import engine as jur  # noqa: E402
from predictionio_tpu_torch.controller import (  # noqa: E402
    AverageServing,
    EmptyParams,
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    ParamsError,
    RetrainOnDeploy,
    SimpleEngine,
    deserialize_models,
    extract_params,
    load_symbol,
    params_class_of,
    params_to_json,
    resolve_engine,
    serialize_models,
)
from predictionio_tpu_torch.controller.persistent import ModelSerializationError  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext, WorkflowParams, doer  # noqa: E402
from predictionio_tpu_torch.engines.ecommerce import engine as tec  # noqa: E402
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402
from predictionio_tpu_torch.engines.similarproduct import engine as tsim  # noqa: E402
from predictionio_tpu_torch.engines.universal import engine as tur  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (params class name, JSON object): each case must get the same outcome
# from both packages
PARAMS_CASES = {
    "als_defaults": ("ALSAlgorithmParams", {}),
    "als_null": ("ALSAlgorithmParams", None),
    "als_full": ("ALSAlgorithmParams", {
        "rank": 8, "num_iterations": 5, "lambda_": 0.05, "alpha": 2,
        "implicit_prefs": False, "cg_iterations": 4, "seed": 11,
        "serve_dtype": "bf16"}),
    "als_unknown": ("ALSAlgorithmParams", {"rank": 8, "ranks": 9}),
    "als_wrong_int": ("ALSAlgorithmParams", {"rank": "8"}),
    "als_bool_as_int": ("ALSAlgorithmParams", {"rank": True}),
    "als_wrong_bool": ("ALSAlgorithmParams", {"implicit_prefs": 1}),
    "als_wrong_float": ("ALSAlgorithmParams", {"lambda_": "0.1"}),
    "als_not_object": ("ALSAlgorithmParams", [1, 2]),
    "ds_minimal": ("DataSourceParams", {"app_name": "a"}),
    "ds_full": ("DataSourceParams", {
        "app_name": "a", "event_names": ["rate", "buy", "view"],
        "rate_event": "rate", "eval_k": 0, "goal_threshold": 3.5,
        "eval_num": 10, "read_item_categories": False,
        "use_data_view": False, "data_view_dir": None}),
    "ds_missing": ("DataSourceParams", {"event_names": ["rate"]}),
    "ds_wrong_list": ("DataSourceParams", {"app_name": "a", "event_names": "rate"}),
    "ds_wrong_elem": ("DataSourceParams", {"app_name": "a", "event_names": [1]}),
    "ds_wrong_optional": ("DataSourceParams", {"app_name": "a", "data_view_dir": 3}),
    "ds_unknown": ("DataSourceParams", {"app_name": "a", "channel": "c"}),
    "ur_ds": ("URDataSourceParams", {"app_name": "a", "indicators": ["buy", "view"]}),
    "ur_algo": ("URAlgorithmParams", {"app_name": "a", "max_correlators_per_item": 20,
                                      "indicators": None}),
    "ur_algo_missing": ("URAlgorithmParams", {"max_query_events": 3}),
    "ur_algo_wrong": ("URAlgorithmParams", {"app_name": "a", "indicators": "buy"}),
    "sim_defaults": ("ALSSimilarParams", {}),
    "sim_full": ("ALSSimilarParams", {
        "rank": 12, "num_iterations": 5, "lambda_": 0.1, "alpha": 2.0, "seed": 4,
        "shard_serving": False, "serve_dtype": "int8"}),
    "sim_wrong": ("ALSSimilarParams", {"rank": 1.5}),
    "sim_ds": ("SimDataSourceParams", {"app_name": "a", "view_event": "rate"}),
    "sim_ds_missing": ("SimDataSourceParams", {"view_event": "rate"}),
    "ec_ds": ("ECommDataSourceParams", {"app_name": "a", "event_names": ["rate"]}),
    "ec_algo": ("ECommAlgorithmParams", {
        "app_name": "a", "unseen_only": True, "seen_events": ["rate", "view"],
        "similar_events": ["view"], "rank": 8}),
    "ec_algo_wrong_list": ("ECommAlgorithmParams", {"app_name": "a", "seen_events": "rate"}),
    "ec_algo_missing": ("ECommAlgorithmParams", {"unseen_only": True}),
    "empty_params": ("EmptyParams", {}),
    "empty_params_given": ("EmptyParams", {"x": 1}),
}

CLASSES = {
    "ALSAlgorithmParams": (jeng.ALSAlgorithmParams, teng.ALSAlgorithmParams),
    "DataSourceParams": (jeng.DataSourceParams, teng.DataSourceParams),
    "URDataSourceParams": (jur.DataSourceParams, tur.DataSourceParams),
    "URAlgorithmParams": (jur.URAlgorithmParams, tur.URAlgorithmParams),
    "ALSSimilarParams": (jsim.ALSSimilarParams, tsim.ALSSimilarParams),
    "SimDataSourceParams": (jsim.DataSourceParams, tsim.DataSourceParams),
    "ECommDataSourceParams": (jec.DataSourceParams, tec.DataSourceParams),
    "ECommAlgorithmParams": (jec.ECommAlgorithmParams, tec.ECommAlgorithmParams),
    "EmptyParams": (jparams.EmptyParams, EmptyParams),
}

_JAX_ONLY_ALS = {"shard_serving": False}


def _outcome(extract, to_json, err, cls, obj):
    try:
        p = extract(cls, obj)
    except err:
        return "refused"
    return json.loads(to_json(p))


@pytest.mark.parametrize("case", sorted(PARAMS_CASES))
def test_extract_params_matches_jax(case):
    """Both packages accept the params with the same JSON, or both refuse
    them. The JAX ALS params JSON also carries its field the port has
    not ported (`shard_serving`), at its default; it is dropped before
    comparing."""
    name, obj = PARAMS_CASES[case]
    jcls, tcls = CLASSES[name]
    want = _outcome(jparams.extract_params, jparams.params_to_json,
                    jparams.ParamsError, jcls, obj)
    got = _outcome(extract_params, params_to_json, ParamsError, tcls, obj)
    if name == "ALSAlgorithmParams" and want != "refused":
        assert {k: want.pop(k) for k in _JAX_ONLY_ALS} == _JAX_ONLY_ALS
    assert got == want


VARIANT = {
    "id": "rec",
    "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
    "datasource": {"params": {"app_name": "app", "event_names": ["rate"]}},
    "algorithms": [{"name": "als", "params": {"rank": 6, "num_iterations": 3}}],
}


def test_params_from_variant_json_matches_jax():
    tep = teng.RecommendationEngine().apply().params_from_variant_json(VARIANT)
    jep = jeng.RecommendationEngine().apply().params_from_variant_json(VARIANT)
    for stage in ("data_source_params", "preparator_params", "serving_params"):
        (tn, tp), (jn, jp) = getattr(tep, stage), getattr(jep, stage)
        assert tn == jn and params_to_json(tp) == jparams.params_to_json(jp)
    [(tn, tp)], [(jn, jp)] = tep.algorithm_params_list, jep.algorithm_params_list
    want = json.loads(jparams.params_to_json(jp))
    for k in _JAX_ONLY_ALS:
        want.pop(k)
    assert tn == jn == "als" and json.loads(params_to_json(tp)) == want
    # no algorithms: the single bound one with defaults, as in the JAX package
    bare = teng.RecommendationEngine().apply().params_from_variant_json(
        {"id": "x", "engineFactory": "f", "datasource": VARIANT["datasource"]})
    assert bare.algorithm_params_list == (("als", teng.ALSAlgorithmParams()),)
    with pytest.raises(ParamsError, match="not bound"):
        teng.RecommendationEngine().apply().params_from_variant_json(
            {**VARIANT, "algorithms": [{"name": "mlp"}]})


@pytest.mark.parametrize("field", sorted(teng.ALSAlgorithmParams.NOT_PORTED))
def test_unported_als_fields_are_refused(field):
    value = 0 if field == "checkpoint_every" else False
    with pytest.raises(ParamsError, match=rf"\['{field}'\].*not ported"):
        extract_params(teng.ALSAlgorithmParams, {"rank": 4, field: value})
    # the JAX package has the field
    jparams.extract_params(jeng.ALSAlgorithmParams, {"rank": 4, field: value})
    variant = {**VARIANT, "algorithms": [{"name": "als", "params": {field: value}}]}
    with pytest.raises(ParamsError, match="not ported"):
        teng.RecommendationEngine().apply().params_from_variant_json(variant)


@pytest.mark.parametrize("field", ["read_item_categories", "use_data_view"])
def test_unported_datasource_options_are_refused(field):
    """Both options were refused until item properties and the data view
    were ported; now each reads as the JAX package reads it, on and off."""
    for value in (False, True):
        obj = {"app_name": "a", field: value}
        got = params_to_json(extract_params(teng.DataSourceParams, obj))
        want = jparams.params_to_json(jparams.extract_params(jeng.DataSourceParams, obj))
        assert json.loads(got) == json.loads(want)
        assert json.loads(got)[field] is value


@pytest.mark.parametrize("eval_k", [0, -1])
def test_eval_is_refused_at_read_eval(eval_k):
    """Evaluation is ported: `read_eval` refuses only what the JAX
    package's refuses, a data source without folds (eval_k <= 0), before
    it reads anything."""
    for eng in (teng, jeng):
        ds = eng.RecommendationDataSource(eng.DataSourceParams("a", eval_k=eval_k))
        with pytest.raises(ValueError, match="eval_k > 0"):
            ds.read_eval(None)
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage, StorageConfig

    storage = Storage(StorageConfig.memory())
    app_id = storage.get_meta_data_apps().insert(App(0, "a"))
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{n % 4}",
              target_entity_type="item", target_entity_id=f"i{n}",
              properties={"rating": 5.0}) for n in range(9)], app_id)
    ds = teng.RecommendationDataSource(teng.DataSourceParams("a", eval_k=3))
    folds = ds.read_eval(RuntimeContext(storage=storage, device="cpu"))
    assert [ei.fold for _, ei, _ in folds] == [0, 1, 2]
    assert sum(len(td.rows) for td, _, _ in folds) == 2 * 9


@pytest.mark.parametrize("path", [
    "predictionio_tpu.engines.recommendation.RecommendationEngine",
    "predictionio_tpu.engines.recommendation.engine:RecommendationEngine",
    "predictionio_tpu.Thing",
])
def test_load_symbol_refuses_the_jax_package(path):
    with pytest.raises(ParamsError, match="JAX package") as e:
        load_symbol(path)
    assert path in str(e.value)


def test_load_symbol_resolves_the_port():
    assert load_symbol(VARIANT["engineFactory"]) is teng.RecommendationEngine
    assert load_symbol(
        "predictionio_tpu_torch.engines.universal.engine:UniversalRecommenderEngine"
    ) is tur.UniversalRecommenderEngine
    with pytest.raises(ParamsError, match="no symbol"):
        load_symbol("predictionio_tpu_torch.controller.Nope")
    with pytest.raises(ParamsError, match="not an importable path"):
        load_symbol("Nope")


def _jax_model_blob():
    from predictionio_tpu.controller.persistent import serialize_models as jser
    from predictionio_tpu.data.store.bimap import BiMap as JBiMap
    from predictionio_tpu.models import als as jals

    f = jals.ALSFactors(
        user_factors=np.ones((2, 3), np.float32),
        item_factors=np.ones((4, 3), np.float32),
        user_vocab=JBiMap({"a": 0, "b": 1}),
        item_vocab=JBiMap({f"i{n}": n for n in range(4)}),
    )
    return jser([jeng.ALSModel(f)])


def test_deserialize_refuses_a_jax_blob():
    with pytest.raises(pickle.UnpicklingError,
                       match=r"predictionio_tpu\.engines\.recommendation\.engine\.ALSModel"):
        deserialize_models(_jax_model_blob())


def test_refusals_import_nothing_of_the_jax_package(tmp_path):
    """In a fresh process: refusing a JAX factory path and a JAX blob
    leaves the JAX package (and jax) unimported."""
    blob = tmp_path / "blob.pkl"
    blob.write_bytes(_jax_model_blob())
    code = (
        "import pickle, sys, json\n"
        "from predictionio_tpu_torch.controller import ParamsError, "
        "deserialize_models, load_symbol\n"
        "out = []\n"
        "try:\n"
        "    load_symbol('predictionio_tpu.engines.recommendation.RecommendationEngine')\n"
        "except ParamsError:\n"
        "    out.append('factory refused')\n"
        f"data = open({str(blob)!r}, 'rb').read()\n"
        "try:\n"
        "    deserialize_models(data)\n"
        "except pickle.UnpicklingError as e:\n"
        "    out.append(str(e).split(',')[0])\n"
        "out.append(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('predictionio_tpu', 'jax', 'jaxlib')))\n"
        "print(json.dumps(out))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    factory, blob_msg, loaded = json.loads(run.stdout.strip().splitlines()[-1])
    assert factory == "factory refused"
    assert "predictionio_tpu.engines.recommendation.engine.ALSModel" in blob_msg
    assert loaded == []


class _Unpicklable:
    def __init__(self):
        self.lock = threading.Lock()


def test_serialize_models_never_degrades_to_retrain():
    with pytest.raises(ModelSerializationError, match=r"#1 \(.*_Unpicklable\)"):
        serialize_models([1, _Unpicklable()])
    # the JAX package turns the same model into RetrainOnDeploy
    from predictionio_tpu.controller.persistent import deserialize_models as jdes
    from predictionio_tpu.controller.persistent import serialize_models as jser

    assert type(jdes(jser([_Unpicklable()]))[0]).__name__ == "RetrainOnDeploy"
    assert deserialize_models(serialize_models([None, {"a": 1}])) == [
        RetrainOnDeploy(algo_index=0), {"a": 1}]


def test_als_model_pickles_factors_only():
    from predictionio_tpu_torch import convert

    f = convert.als_factors_from_numpy(
        np.ones((2, 3), np.float32), np.ones((4, 3), np.float32),
        ["a", "b"], ["w", "x", "y", "z"], {})
    m = teng.ALSModel(f, serve_dtype="bf16", device="cpu")
    m.serving_state()
    assert set(m.__getstate__()) == {"factors", "item_categories", "serve_dtype"}
    [clone] = deserialize_models(serialize_models([m]))
    assert isinstance(clone, teng.ALSModel) and clone.serve_dtype == "bf16"
    assert clone.device is None and clone._serving_state is None
    np.testing.assert_array_equal(clone.factors.item_factors, f.item_factors)
    with pytest.raises(RuntimeError, match="no device"):
        clone.serving_state()
    clone.bind_device("cpu")
    assert clone.serving_state() is not None


# -- engine plumbing ---------------------------------------------------------


class _DS:
    def __init__(self, params: teng.DataSourceParams):
        self.params = params

    def read_training(self, ctx):
        return [1.0, 2.0, 3.0]


class _Algo:
    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def train(self, ctx, pd):
        return sum(pd) * self.scale

    def predict(self, model, query: float):
        return model + query


def test_engine_train_records_stage_timings_and_stops():
    engine = Engine(_DS, IdentityPreparator, {"a": _Algo}, FirstServing)
    ep = engine.params_from_variant_json(
        {"datasource": {"params": {"app_name": "x"}}, "algorithms": [{"name": "a"}]})
    ctx = RuntimeContext(device="cpu")
    assert engine.train(ctx, ep) == [6.0]
    assert set(ctx.stage_timings) == {"read", "prepare", "train"}
    from predictionio_tpu_torch.core.base import StopAfterReadInterruption

    with pytest.raises(StopAfterReadInterruption):
        engine.train(RuntimeContext(workflow_params=WorkflowParams(
            stop_after_read=True)), ep)
    assert engine.prepare_deploy(ctx, ep, [RetrainOnDeploy(0)]) == [6.0]


def test_factories_servings_and_doer():
    class F(EngineFactory):
        def apply(self):
            return SimpleEngine(_DS, _Algo)

    for f in (F, F(), lambda: F().apply(), F().apply()):
        assert isinstance(resolve_engine(f), Engine)
    with pytest.raises(ParamsError):
        resolve_engine(42)
    assert FirstServing().serve(None, [3, 4]) == 3
    assert AverageServing().serve(None, [3, 4]) == 3.5
    assert params_class_of(teng.ALSAlgorithm) is teng.ALSAlgorithmParams
    assert params_class_of(_Algo) is None
    assert doer(_Algo, EmptyParams()).scale == 1.0
    assert isinstance(doer(teng.ALSAlgorithm, teng.ALSAlgorithmParams()), teng.ALSAlgorithm)
