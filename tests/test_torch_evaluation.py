"""Port parity for the evaluation controller: metrics, the
MetricEvaluator and best.json, FastEvalEngine's prefix caches, and
``run_evaluation``'s instance lifecycle on memory and sqlite storage.

Each case feeds the same numpy-seeded (query, predicted, actual) sets or
the same toy engine to the JAX package's classes and the port's, and
holds the port to the JAX package's values exactly: these are host
reductions in the same order, with no device arithmetic. The evaluation
instance rows written by one package are read by the other's sqlite DAO.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu import controller as jc  # noqa: E402
from predictionio_tpu.controller import fast_eval as jfast  # noqa: E402
from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.core.base import WorkflowParams as JWorkflowParams  # noqa: E402
from predictionio_tpu.data.storage import sqlite as jsqlite  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.workflow import evaluation as jwf  # noqa: E402
from predictionio_tpu_torch import controller as tc  # noqa: E402
from predictionio_tpu_torch.controller import fast_eval as tfast  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.core.base import WorkflowParams  # noqa: E402
from predictionio_tpu_torch.data.storage import sqlite as tsqlite  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.workflow import evaluation as twf  # noqa: E402

PKGS = {"jax": jc, "port": tc}


def _qpa_sets(seed=0, n_sets=3, per_set=40):
    """[(eval info, [(q, p, a)])] with integer q, float p and a."""
    rng = np.random.default_rng(seed)
    return [
        (f"fold{f}", [(int(q), float(p), float(a)) for q, p, a in zip(
            rng.integers(0, 9, per_set), rng.standard_normal(per_set),
            rng.standard_normal(per_set))])
        for f in range(n_sets)
    ]


def _score(q, p, a):
    return p * a + q


def _opt_score(q, p, a):
    return None if q % 3 == 0 else p - a


def _metric(pkg, kind):
    """A metric of `kind` from `pkg`'s classes, scoring tuples alike."""
    c = PKGS[pkg]
    if kind == "zero":
        return c.ZeroMetric()
    base = {"average": c.AverageMetric, "option_average": c.OptionAverageMetric,
            "stdev": c.StdevMetric, "option_stdev": c.OptionStdevMetric,
            "sum": c.SumMetric}[kind]
    one = _opt_score if kind.startswith("option") else _score
    return type(f"M_{kind}", (base,), {"calculate_one": lambda self, q, p, a: one(q, p, a)})()


KINDS = ["average", "option_average", "stdev", "option_stdev", "sum", "zero"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_metric_values_match_jax(kind, seed):
    data = _qpa_sets(seed)
    j = _metric("jax", kind).calculate(JContext(), data)
    t = _metric("port", kind).calculate(RuntimeContext(device="cpu"), data)
    assert type(t) is type(j) is float
    assert t == j


@pytest.mark.parametrize("kind", KINDS[:4])
def test_empty_metrics_are_nan(kind):
    j = _metric("jax", kind).calculate(JContext(), [("f", [])])
    t = _metric("port", kind).calculate(RuntimeContext(device="cpu"), [("f", [])])
    assert math.isnan(t) and math.isnan(j)


PAIRS = [(0.1, 0.2), (0.2, 0.1), (0.3, 0.3), (float("nan"), 0.1),
         (0.1, float("nan")), (float("nan"), float("nan")), (-1.0, 2.0)]


@pytest.mark.parametrize("higher", [True, False])
def test_compare_keeps_direction_and_nan_loses(higher):
    j, t = jc.Metric(), tc.Metric()
    j.higher_is_better = t.higher_is_better = higher
    got = [t.compare(a, b) for a, b in PAIRS]
    assert got == [j.compare(a, b) for a, b in PAIRS]
    assert got[3] == -1 and got[4] == 1 and got[5] == 0  # NaN never wins
    assert got[0] == (-1 if higher else 1)


@pytest.mark.parametrize("x", [1, 0.5, float("nan"), None, "1", True, np.float64(2.0)])
def test_is_defined_number_matches_jax(x):
    from predictionio_tpu.controller.metrics import is_defined_number as j
    from predictionio_tpu_torch.controller.metrics import is_defined_number as t

    assert t(x) == j(x)


@dataclasses.dataclass(frozen=True)
class AlgoParams:
    w: float = 1.0
    shift: int = 0


@dataclasses.dataclass(frozen=True)
class DSParams:
    n_folds: int = 2
    seed: int = 0


def _engine_params(pkg, points, ds=DSParams()):
    return [PKGS[pkg].EngineParams(data_source_params=("", ds),
                                   algorithm_params_list=(("toy", AlgoParams(*p)),))
            for p in points]


class _ScoreMetric:
    """Scores a grid point by the number that stands as its eval data."""

    def calculate(self, ctx, data):
        return data


def _evaluator(pkg, higher=True, output_path=None):
    c = PKGS[pkg]
    metric = type("Picked", (_ScoreMetric, c.Metric), {"higher_is_better": higher})()
    other = type("Other", (_ScoreMetric, c.Metric), {})()
    return c.MetricEvaluator(metric, [other], output_path=output_path)


@pytest.mark.parametrize("higher", [True, False])
@pytest.mark.parametrize("scores", [
    [0.1, 0.3, 0.2, 0.3],
    [float("nan"), 0.2, float("nan"), 0.05],
    [float("nan"), float("nan")],
])
def test_metric_evaluator_best_and_json_match_jax(tmp_path, higher, scores):
    points = [(float(n), n) for n in range(len(scores))]
    res = {}
    for pkg in PKGS:
        ev = _evaluator(pkg, higher, output_path=str(tmp_path / f"{pkg}.json"))
        data = list(zip(_engine_params(pkg, points), scores))
        ctx = JContext() if pkg == "jax" else RuntimeContext(device="cpu")
        wp = JWorkflowParams() if pkg == "jax" else WorkflowParams()
        res[pkg] = ev.evaluate(ctx, None, data, wp)
    j, t = res["jax"], res["port"]
    assert t.best_index == j.best_index
    defined = [n for n, s in enumerate(scores) if not math.isnan(s)]
    if defined:  # NaN never wins
        pick = (max if higher else min)(defined, key=lambda n: scores[n])
        assert t.best_index == pick
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert t.to_one_liner() == j.to_one_liner()
    assert t.to_html() == j.to_html()
    # best.json: the winner's params as an engine-variant fragment
    best = json.loads((tmp_path / "port.json").read_text())
    assert best == json.loads((tmp_path / "jax.json").read_text())
    assert best["algorithms"] == [{"name": "toy", "params": dataclasses.asdict(
        AlgoParams(*points[t.best_index]))}]


def test_metric_evaluator_refuses_an_empty_grid():
    with pytest.raises(ValueError, match="empty engine_eval_data_set"):
        _evaluator("port").evaluate(RuntimeContext(device="cpu"), None, [],
                                    WorkflowParams())


def test_evaluation_builds_its_evaluator(tmp_path):
    class E(tc.Evaluation):
        engine = object()
        metric = tc.ZeroMetric()
        output_path = str(tmp_path / "best.json")

    ev = E().get_evaluator()
    assert isinstance(ev, tc.MetricEvaluator) and ev.output_path == E.output_path
    with pytest.raises(ValueError, match="metric"):
        tc.Evaluation().get_evaluator()
    with pytest.raises(ValueError, match="engine"):
        tc.Evaluation().get_engine()


# -- a toy engine in each package ----------------------------------------


def _toy_engine(pkg, fast=False, raising=False):
    """DataSource: `n_folds` eval sets of seeded integer queries, actual =
    q mod 5. Preparator: adds 1. Algorithm: predicts w·q + shift + the
    fold's prepared sum mod 5. Serving: first."""
    c = PKGS[pkg]

    class DS(c.DataSource):
        def __init__(self, params: DSParams):
            self.params = params

        def read_training(self, ctx):
            return np.zeros(1)

        def read_eval(self, ctx):
            if raising:
                raise RuntimeError("data source failed")
            rng = np.random.default_rng(self.params.seed)
            return [(rng.integers(0, 9, 5), {"fold": f},
                     [(int(q), int(q) % 5) for q in rng.integers(0, 50, 12)])
                    for f in range(self.params.n_folds)]

    class Prep(c.Preparator):
        def prepare(self, ctx, td):
            return td + 1

    class Algo(c.Algorithm):
        def __init__(self, params: AlgoParams):
            self.params = params

        def train(self, ctx, pd):
            return int(pd.sum())

        def predict(self, model, query):
            return self.params.w * query + self.params.shift + model % 5

    cls = tfast.FastEvalEngine if pkg == "port" else jfast.FastEvalEngine
    if not fast:
        cls = c.Engine
    return cls(DS, Prep, {"toy": Algo}, c.FirstServing)


class _Hit:
    def calculate_one(self, q, p, a):
        return float(int(p) % 5 == a)


def _hit_metric(pkg):
    return type("Hit", (_Hit, PKGS[pkg].AverageMetric), {})()


POINTS = [(1.0, 0), (1.0, 1), (2.0, 0), (1.0, 0), (2.0, 3)]


def test_fast_eval_counts_and_results_match_jax():
    out, counts = {}, {}
    for pkg in PKGS:
        engine = _toy_engine(pkg, fast=True)
        ctx = JContext() if pkg == "jax" else RuntimeContext(device="cpu")
        eps = _engine_params(pkg, POINTS) + _engine_params(pkg, POINTS[:2], DSParams(3, 1))
        out[pkg] = engine.batch_eval(ctx, eps)
        counts[pkg] = dict(engine.compute_counts)
    assert counts["port"] == counts["jax"] == {"datasource": 2, "preparator": 2,
                                               "algorithms": 6}
    for (tep, tres), (jep, jres) in zip(out["port"], out["jax"]):
        assert tep.algorithm_params_list == jep.algorithm_params_list
        assert [(ei, [(q, float(p), a) for q, p, a in qpa]) for ei, qpa in tres] == \
            [(ei, [(q, float(p), a) for q, p, a in qpa]) for ei, qpa in jres]


def test_fast_eval_clear_caches_recomputes():
    engine = _toy_engine("port", fast=True)
    ctx = RuntimeContext(device="cpu")
    engine.batch_eval(ctx, _engine_params("port", POINTS[:2]))
    engine.clear_caches()
    engine.batch_eval(ctx, _engine_params("port", POINTS[:2]))
    assert engine.compute_counts == {"datasource": 2, "preparator": 2, "algorithms": 4}


def test_engine_eval_selects_folds():
    engine = _toy_engine("port")
    ctx = RuntimeContext(device="cpu")
    [ep] = _engine_params("port", POINTS[:1], DSParams(4, 2))
    every = engine.eval(ctx, ep)
    assert [ei["fold"] for ei, _ in every] == [0, 1, 2, 3]
    some = engine.eval(ctx, ep, fold_indices=[3, 1, 1])
    assert some == [every[1], every[3]]
    assert engine.batch_eval(ctx, [ep], fold_indices=[2]) == [(ep, [every[2]])]
    with pytest.raises(ValueError, match="out of range"):
        engine.eval(ctx, ep, fold_indices=[4])


# -- run_evaluation: the instance lifecycle --------------------------------


def _storages(tmp_path, kind):
    from predictionio_tpu.data.storage.registry import SourceConfig as JSourceConfig

    def cfg(mod_cfg, src, pkg):
        settings = {"PATH": str(tmp_path / f"{pkg}.db")} if kind == "sqlite" else {}
        return mod_cfg(sources={"DB": src("DB", kind, settings)},
                       repositories={r: "DB" for r in ("METADATA", "EVENTDATA", "MODELDATA")})

    return (JStorage(cfg(JStorageConfig, JSourceConfig, "jax")),
            Storage(cfg(StorageConfig, SourceConfig, "port")))


def _evaluation(pkg, **kw):
    c = PKGS[pkg]
    return type(f"ToyEval_{pkg}", (c.Evaluation,), {
        "engine": _toy_engine(pkg, **kw), "metric": _hit_metric(pkg)})()


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_run_evaluation_completes_like_jax(tmp_path, kind):
    js, ts = _storages(tmp_path, kind)
    jinst, jres = jwf.run_evaluation(js, _evaluation("jax"), _engine_params("jax", POINTS))
    tinst, tres = twf.run_evaluation(ts, _evaluation("port"), _engine_params("port", POINTS),
                                     device="cpu")
    [row] = ts.get_meta_data_evaluation_instances().get_all()
    assert row.id == tinst.id and row.status == tinst.status == jinst.status == "EVALCOMPLETED"
    assert row.evaluation_class.endswith("ToyEval_port")
    assert row.evaluator_results == jinst.evaluator_results == tres.to_one_liner()
    assert json.loads(row.evaluator_results_json) == json.loads(jinst.evaluator_results_json)
    assert row.evaluator_results_html == jinst.evaluator_results_html
    assert set(row.env) == set(jinst.env) == {"eval_wall_sec", "grid_points"}
    assert row.env["grid_points"] == "5" and float(row.env["eval_wall_sec"]) >= 0
    assert tres.best_index == jres.best_index
    assert row.end_time >= row.start_time


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_run_evaluation_aborts_on_a_failing_data_source(tmp_path, kind):
    js, ts = _storages(tmp_path, kind)
    for pkg, wf, st in (("jax", jwf, js), ("port", twf, ts)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        with pytest.raises(RuntimeError, match="data source failed"):
            wf.run_evaluation(st, _evaluation(pkg, raising=True),
                              _engine_params(pkg, POINTS), **kw)
        [row] = st.get_meta_data_evaluation_instances().get_all()
        assert row.status == "EVALABORTED" and row.evaluator_results == ""


def test_run_evaluation_needs_engine_params():
    ts = Storage(StorageConfig.memory())
    with pytest.raises(ValueError, match="no engine params"):
        twf.run_evaluation(ts, _evaluation("port"), [], device="cpu")
    assert ts.get_meta_data_evaluation_instances().get_all() == []
    ev = _evaluation("port")
    ev.engine_params_list = _engine_params("port", POINTS[:2])  # the evaluation's own grid
    inst, _ = twf.run_evaluation(ts, ev, device="cpu")
    assert inst.env["grid_points"] == "2"


def test_no_save_result_stores_no_results():
    from predictionio_tpu_torch.core.base import BaseEvaluatorResult

    class Quiet(BaseEvaluatorResult):
        no_save = True

        def to_one_liner(self):
            return "quiet"

    class QuietEvaluator(tc.MetricEvaluator):
        def evaluate(self, *a):
            return Quiet()

    ev = _evaluation("port")
    ev.evaluator = QuietEvaluator(_hit_metric("port"))
    ts = Storage(StorageConfig.memory())
    inst, res = twf.run_evaluation(ts, ev, _engine_params("port", POINTS), device="cpu")
    assert inst.status == "EVALCOMPLETED" and res.to_one_liner() == "quiet"
    assert inst.evaluator_results == inst.evaluator_results_json == ""


def test_sqlite_rows_read_across_packages(tmp_path):
    """The port's evaluationinstances table is the JAX package's: a row
    written by either reads back field for field in the other."""
    from predictionio_tpu.data.storage.base import EvaluationInstance as JRow
    from predictionio_tpu_torch.data.storage.base import EvaluationInstance as TRow
    import datetime as dt

    path = {"PATH": str(tmp_path / "pio.db")}
    j, t = jsqlite.SqliteEvaluationInstances(path), tsqlite.SqliteEvaluationInstances(path)
    t0 = dt.datetime(2024, 5, 1, 12, 0, 0, 123000, tzinfo=dt.timezone.utc)
    fields = dict(status="EVALCOMPLETED", start_time=t0, end_time=t0 + dt.timedelta(seconds=3),
                  evaluation_class="a.B", engine_params_generator_class="a.G", batch="b1",
                  env={"grid_points": "8"}, evaluator_results="one",
                  evaluator_results_html="<p>", evaluator_results_json="{}")
    tid = t.insert(TRow(id="", **fields))
    jid = j.insert(JRow(id="jx", **{**fields, "status": "EVALRUNNING"}))
    assert dataclasses.asdict(j.get(tid)) == dataclasses.asdict(t.get(tid))
    assert dataclasses.asdict(t.get(jid)) == dataclasses.asdict(j.get(jid))
    assert sorted(r.id for r in t.get_all()) == sorted([tid, jid])
    row = t.get(jid)
    row.status = "EVALCOMPLETED"
    assert t.update(row) and j.get(jid).status == "EVALCOMPLETED"
    assert not t.update(TRow(id="missing", **fields))
