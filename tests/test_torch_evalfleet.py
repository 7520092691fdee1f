"""The port's fleet evaluation and tuning loop (evalfleet/) against the
JAX package's: tests/test_evalfleet.py's cases on the port, each held to
the JAX function where one computes the same thing.

- The param-space language: expanded points and groups equal the JAX
  package's for the same spec; a spec file round-trips through both.
- Metrics: the names and classes resolve alike; partials, combined,
  equal the full calculation and the JAX package's partials.
- Records: idempotent partials, fold merge, filters, lineage, gc,
  compaction, purge; each package reads the runs, results, presets and
  links the other writes into one sqlite file.
- The eval driver: the grid engine's run (shards in this process) reproduces
  the sequential MetricEvaluator to 1e-5 and the JAX driver's scores
  exactly; the recommendation template's run (ALS on the CPU, the JAX
  package's start factors) equals the port's sequential evaluation to
  1e-5 and the JAX driver's scores within 0.01, with the same winner.
- Shards as scheduler subprocesses (children on the CPU): a two-member
  fleet survives a member's crash mid-shard; `tune` parks the winner and
  the next periodic retrain trains it and stamps the lineage link.
- The offline prior, the adaptive settle window and `GET /evals*`.
"""

import json
import math
import os
import threading
import time

import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.deploy import scheduler as jsched  # noqa: E402
from predictionio_tpu.evalfleet import driver as jdriver  # noqa: E402
from predictionio_tpu.evalfleet import records as jrecords  # noqa: E402
from predictionio_tpu.evalfleet import specs as jspecs  # noqa: E402
from predictionio_tpu.evalfleet import tuning as jtuning  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.deploy.scheduler import (  # noqa: E402
    JobQueue,
    SchedulerConfig,
    storage_config_to_json,
)
from predictionio_tpu_torch.evalfleet.driver import (  # noqa: E402
    EVAL_DRIVER_THREAD,
    EvalDriver,
    EvalDriverConfig,
)
from predictionio_tpu_torch.evalfleet.records import EvalRecordStore  # noqa: E402
from predictionio_tpu_torch.evalfleet.specs import (  # noqa: E402
    EvalSpec,
    HeldOutRMSE,
    MAPAtK,
    NDCGAtK,
    ParamAxis,
    PrecisionAtK,
    combine_partials,
    expand_points,
    group_points,
    metric_finalize,
    metric_partial,
    point_fragment,
    resolve_metric,
)
from predictionio_tpu_torch.evalfleet.tuning import (  # noqa: E402
    PresetStore,
    RetrainPreset,
    apply_preset,
    offline_prior_multiplier,
    park_winner,
    tune,
)
from predictionio_tpu_torch.fleet.coordinator import (  # noqa: E402
    FleetConfig,
    FleetMember,
    measure_write_visibility_skew,
)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)

GRID_VARIANT = {
    "id": "grid",
    "engineFactory": "torch_sample_engine.GridEngineFactory",
    "datasource": {"params": {"folds": 2, "queries": 4}},
    "preparator": {"params": {"id": 1}},
    "algorithms": [{"name": "grid", "params": {"weight": 0.0}}],
    "serving": {},
}
JAX_FACTORY = "sample_engine.GridEngineFactory"

WEIGHTS = [0.05, 0.15, 0.25, 0.37, 0.45, 0.55, 0.65, 0.75]
BEST_INDEX = 3  # weight 0.37, the grid algorithm's best


def _grid_dict(weights=WEIGHTS, folds=2, sleep_s=0.0, jax=False):
    variant = json.loads(json.dumps(GRID_VARIANT))
    if sleep_s:
        variant["datasource"]["params"]["sleep_s"] = sleep_s
    if jax:
        variant["engineFactory"] = JAX_FACTORY
        variant["preparator"] = {"params": {"id": 1}}
    return {"variant": variant,
            "axes": [{"path": "algorithms.0.params.weight", "values": list(weights)}],
            "metric": {"class": ("sample_engine" if jax else "torch_sample_engine")
                       + ".GridScore"},
            "folds": folds}


def _grid_spec(weights=WEIGHTS, folds=2, sleep_s=0.0):
    return EvalSpec.from_dict(_grid_dict(weights, folds, sleep_s))


def _config(path):
    return {"sources": {"S": ("sqlite", {"PATH": str(path / "pio.db")}),
                        "F": ("localfs", {"PATH": str(path)})},
            "repositories": {"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "F"}}


def _port_storage(path):
    path.mkdir(parents=True, exist_ok=True)
    c = _config(path)
    return Storage(StorageConfig(
        sources={n: SourceConfig(n, t, s) for n, (t, s) in c["sources"].items()},
        repositories=c["repositories"]))


def _jax_storage(path):
    path.mkdir(parents=True, exist_ok=True)
    c = _config(path)
    return JStorage(JStorageConfig(
        sources={n: JSourceConfig(n, t, s) for n, (t, s) in c["sources"].items()},
        repositories=c["repositories"]))


@pytest.fixture()
def mem_storage():
    return Storage(StorageConfig.memory())


@pytest.fixture()
def fresh_storage(tmp_path):
    return _port_storage(tmp_path / "store")


def _scheduler_config(tmp_path, **kw) -> SchedulerConfig:
    cfg = SchedulerConfig(
        poll_interval_s=0.1, heartbeat_interval_s=0.2, stale_after_s=1.0,
        log_dir=str(tmp_path / "job-logs"), device="cpu",
        child_env={"PYTHONPATH": os.pathsep.join([REPO_DIR, TESTS_DIR])})
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _wait_for(predicate, timeout=60.0, interval=0.1, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def _run_shards_inprocess(storage, driver, run, tmp_path, device="cpu"):
    """Run every shard of `run` through the eval worker's main() in this
    process: the subprocess contract without the subprocess."""
    from predictionio_tpu_torch.evalfleet import worker as eval_worker

    for job_id in list(run.shards):
        job = driver.queue.get(job_id)
        spec_path = tmp_path / f"{job_id}.spec.json"
        spec_path.write_text(json.dumps({
            "job_id": job_id, "storage": storage_config_to_json(storage.config),
            "variant": job.variant, "result_path": str(tmp_path / f"{job_id}.result.json"),
            "device": device}))
        assert eval_worker.main(["worker", str(spec_path)]) == 0, job_id


def _run_jax_shards_inprocess(storage, driver, run, tmp_path):
    from predictionio_tpu.evalfleet import worker as jworker

    for job_id in list(run.shards):
        job = driver.queue.get(job_id)
        spec_path = tmp_path / f"j{job_id}.spec.json"
        spec_path.write_text(json.dumps({
            "job_id": job_id, "storage": jsched.storage_config_to_json(storage.config),
            "variant": job.variant,
            "result_path": str(tmp_path / f"j{job_id}.result.json")}))
        assert jworker.main(["worker", str(spec_path)]) == 0, job_id


# ---------------------------------------------------------------------------
# the param-space language and the metric specs
# ---------------------------------------------------------------------------


class TestSpecDSL:
    def test_expand_points_axis_major_and_isolated(self):
        d = {"variant": dict(GRID_VARIANT),
             "axes": [{"path": "algorithms.0.params.weight", "values": [0.1, 0.2]},
                      {"path": "datasource.params.queries", "values": [4, 8, 16]}]}
        points = expand_points(EvalSpec.from_dict(d))
        assert points == jspecs.expand_points(jspecs.EvalSpec.from_dict(d))
        assert len(points) == 6
        assert [p["algorithms"][0]["params"]["weight"] for p in points] == \
            [0.1, 0.1, 0.1, 0.2, 0.2, 0.2]
        assert [p["datasource"]["params"]["queries"] for p in points] == \
            [4, 8, 16, 4, 8, 16]
        points[0]["algorithms"][0]["params"]["weight"] = 99
        assert points[3]["algorithms"][0]["params"]["weight"] == 0.2
        assert GRID_VARIANT["algorithms"][0]["params"]["weight"] == 0.0

    def test_range_expansion(self):
        for r in ({"from": 0.0, "to": 1.0, "steps": 5},
                  {"from": 0.01, "to": 1.0, "steps": 3, "scale": "log"},
                  {"from": 2.0, "to": 9.0, "steps": 1}):
            d = {"path": "algorithms.0.params.w", "range": r}
            assert ParamAxis.from_dict(d).values == jspecs.ParamAxis.from_dict(d).values
        lin = ParamAxis.from_dict({"path": "algorithms.0.params.w",
                                   "range": {"from": 0.0, "to": 1.0, "steps": 5}})
        assert lin.values == pytest.approx([0.0, 0.25, 0.5, 0.75, 1.0])
        log = ParamAxis.from_dict({"path": "algorithms.0.params.w",
                                   "range": {"from": 0.01, "to": 1.0, "steps": 3,
                                             "scale": "log"}})
        assert log.values == pytest.approx([0.01, 0.1, 1.0])
        with pytest.raises(ValueError):
            ParamAxis.from_dict({"path": "algorithms.0.params.w",
                                 "range": {"from": -1, "to": 1, "steps": 2, "scale": "log"}})

    def test_axis_validation(self):
        for bad in ({"path": "engineFactory", "values": [1]},
                    {"path": "serving.params.x"},
                    {"path": "serving.params.x", "values": []}):
            with pytest.raises(ValueError):
                ParamAxis.from_dict(bad)
            with pytest.raises(ValueError):
                jspecs.ParamAxis.from_dict(bad)

    def test_set_path_errors(self):
        spec = EvalSpec(variant=dict(GRID_VARIANT),
                        axes=[ParamAxis("algorithms.5.params.weight", [1])])
        with pytest.raises(ValueError, match="out of range"):
            expand_points(spec)
        spec = EvalSpec(variant=dict(GRID_VARIANT, serving={"params": 3}),
                        axes=[ParamAxis("serving.params.x", [1])])
        with pytest.raises(ValueError, match="scalar"):
            expand_points(spec)

    def test_group_points_by_grid_compatibility(self):
        assert group_points(expand_points(_grid_spec([0.1, 0.2, 0.3], 0))) == [[0, 1, 2]]
        d = {"variant": dict(GRID_VARIANT),
             "axes": [{"path": "algorithms.0.params.weight", "values": [0.1, 0.2]},
                      {"path": "datasource.params.queries", "values": [4, 8]}]}
        groups = group_points(expand_points(EvalSpec.from_dict(d)))
        assert sorted(groups) == [[0, 2], [1, 3]]
        assert groups == jspecs.group_points(jspecs.expand_points(jspecs.EvalSpec.from_dict(d)))
        two = dict(GRID_VARIANT, algorithms=[{"name": "grid"}, {"name": "grid"}])
        assert group_points([two, two]) == [[0], [1]] or group_points([two, two]) == [[0, 1]]
        assert group_points([two, two]) == jspecs.group_points([two, two])

    def test_point_fragment_strips_non_stage_keys(self):
        point = expand_points(_grid_spec(folds=0))[0]
        frag = point_fragment(point)
        assert set(frag) <= {"datasource", "preparator", "algorithms", "serving"}
        assert "engineFactory" not in frag
        assert frag == jspecs.point_fragment(point)

    def test_spec_roundtrip(self, tmp_path):
        spec = _grid_spec()
        path = tmp_path / "eval.json"
        path.write_text(json.dumps(spec.to_dict()))
        assert EvalSpec.load(str(path)).to_dict() == spec.to_dict()
        # the JAX package reads the port's spec file as written
        assert jspecs.EvalSpec.load(str(path)).to_dict() == spec.to_dict()

    def test_spec_requires_engine_factory(self):
        with pytest.raises(ValueError):
            EvalSpec(variant={"id": "x"})
        with pytest.raises(ValueError):
            EvalSpec(variant=dict(GRID_VARIANT), folds=-1)


class TestMetrics:
    def test_resolve_by_name_and_class(self):
        m = resolve_metric("map@5")
        assert isinstance(m, MAPAtK) and m.k == 5
        m = resolve_metric({"name": "precision", "k": 3})
        assert isinstance(m, PrecisionAtK) and m.k == 3
        m = resolve_metric({"name": "ndcg@7"})
        assert isinstance(m, NDCGAtK) and m.k == 7
        m = resolve_metric("rmse")
        assert isinstance(m, HeldOutRMSE) and not m.higher_is_better
        assert resolve_metric({"class": "torch_sample_engine.GridScore"}).header() == "GridScore"
        for spec in ("map@5", {"name": "precision", "k": 3}, "ndcg@7", "rmse@3"):
            assert resolve_metric(spec).header() == jspecs.resolve_metric(spec).header()
        with pytest.raises(ValueError):
            resolve_metric("nope")
        with pytest.raises(ValueError):
            resolve_metric(42)
        with pytest.raises(Exception, match="JAX package"):
            resolve_metric({"class": "predictionio_tpu.evalfleet.specs.MAPAtK"})

    def test_ranking_metrics(self):
        data = [(None, [(None, {"items": ["a", "b", "x", "c"]}, {"items": ["a", "c", "d"]}),
                        (None, {"items": [("c", 0.9), {"item": "q"}]}, {"items": ["c"]}),
                        (None, {"items": []}, {"items": []})])]
        for name in ("precision@4", "map@4", "ndcg@4", "precision@1", "map@2"):
            m, jm = resolve_metric(name), jspecs.resolve_metric(name)
            got = [m.calculate_one(q, p, a) for q, p, a in data[0][1]]
            want = [jm.calculate_one(q, p, a) for q, p, a in data[0][1]]
            assert repr(got) == repr(want), name  # nan where nothing is defined
        one = data[:1]
        one = [(None, one[0][1][:1])]
        assert resolve_metric("precision@4").calculate(None, one) == pytest.approx(2 / 4)
        assert resolve_metric("map@4").calculate(None, one) == pytest.approx(1.5 / 3)
        dcg = 1 / math.log2(2) + 1 / math.log2(5)
        idcg = sum(1 / math.log2(i + 2) for i in range(3))
        assert resolve_metric("ndcg@4").calculate(None, one) == pytest.approx(dcg / idcg)

    def test_rmse_partials_pool_exactly(self):
        fold_a = [(None, [(None, {"rating": 3.0}, {"rating": 1.0})])]
        fold_b = [(None, [(None, {"rating": 5.0}, {"rating": 4.0}),
                          (None, {"rating": 2.0}, {"rating": 2.0}),
                          (None, {"rating": None}, {"rating": 2.0})])]
        m = HeldOutRMSE()
        parts = [metric_partial(m, None, fold_a), metric_partial(m, None, fold_b)]
        jm = jspecs.HeldOutRMSE()
        assert parts == [jspecs.metric_partial(jm, None, fold_a),
                         jspecs.metric_partial(jm, None, fold_b)]
        total, count = combine_partials(parts)
        combined = metric_finalize(m, total, count)
        assert combined == pytest.approx(m.calculate(None, fold_a + fold_b), abs=1e-12)
        per_fold_mean = (m.calculate(None, fold_a) + m.calculate(None, fold_b)) / 2
        assert abs(combined - per_fold_mean) > 1e-6

    def test_average_metric_partials_match_full_calculation(self):
        from predictionio_tpu_torch.controller.metrics import ZeroMetric

        data = [(None, [(None, {"items": ["a"]}, {"items": ["a", "b"]})]),
                (None, [(None, {"items": ["b", "c"]}, {"items": ["c"]}),
                        (None, {"items": ["d"]}, {"items": ["c"]})])]
        for name in ("precision@2", "map@2", "ndcg@2"):
            m = resolve_metric(name)
            parts = [metric_partial(m, None, [fold]) for fold in data]
            assert parts == [jspecs.metric_partial(jspecs.resolve_metric(name), None, [fold])
                             for fold in data]
            total, count = combine_partials(parts)
            assert metric_finalize(m, total, count) == pytest.approx(
                m.calculate(None, data), abs=1e-12)
        # a metric without per-tuple scores degrades to one count a fold
        assert metric_partial(ZeroMetric(), None, data) == {"sum": 0.0, "count": 1}


# ---------------------------------------------------------------------------
# durable records
# ---------------------------------------------------------------------------


class TestEvalRecords:
    def test_partials_idempotent_and_folds_merge(self, mem_storage):
        rec = EvalRecordStore(mem_storage)
        run = rec.create_run("eng", {}, 2, 1, 2, "GridScore")
        rec.record_partial(run.id, 0, 0, {"sum": 1.0, "count": 2})
        rec.record_partial(run.id, 0, 0, {"sum": 1.5, "count": 2}, params={"algorithms": []})
        rec.record_partial(run.id, 0, 1, {"sum": 2.0, "count": 2})
        results = rec.results(run.id)
        assert set(results) == {0}
        partials = rec.point_partials(results[0])
        assert set(partials) == {"fold_0", "fold_1"}
        assert partials["fold_0"] == {"sum": 1.5, "count": 2}
        assert results[0]["params"] == {"algorithms": []}

    def test_run_crud_and_filters(self, mem_storage):
        rec = EvalRecordStore(mem_storage)
        a = rec.create_run("e1", {}, 1, 1, 1, "m", tenant="acme")
        time.sleep(0.01)
        b = rec.create_run("e2", {}, 1, 1, 1, "m")
        rec.update_run(b.id, status="completed", winner_index=0)
        got = rec.get_run(b.id)
        assert got.status == "completed" and got.winner_index == 0
        assert [r.id for r in rec.list_runs()] == [b.id, a.id]
        assert [r.id for r in rec.list_runs(engine_id="e1")] == [a.id]
        assert [r.id for r in rec.list_runs(status="completed")] == [b.id]
        assert [r.id for r in rec.list_runs(tenant="acme")] == [a.id]
        assert rec.get_run("eval-nope") is None

    def test_lineage_link(self, mem_storage):
        rec = EvalRecordStore(mem_storage)
        run = rec.create_run("eng", {}, 1, 1, 1, "m")
        rec.link_model_version(run.id, "mv-1", job_id="job-x")
        rec.link_model_version(run.id, "mv-2", job_id="job-y")
        got = rec.get_run(run.id)
        assert set(got.links) == {"mv-1", "mv-2"}
        assert got.links["mv-1"]["job_id"] == "job-x"
        assert got.winner_model_version == "mv-2"
        assert "links" in got.to_dict()

    def test_gc_keeps_running_and_newest(self, mem_storage):
        rec = EvalRecordStore(mem_storage)
        runs = []
        for i in range(4):
            r = rec.create_run(f"e{i}", {}, 1, 1, 1, "m")
            rec.record_partial(r.id, 0, None, {"sum": 1, "count": 1})
            runs.append(r)
            time.sleep(0.01)
        rec.update_run(runs[0].id, status="completed")
        rec.update_run(runs[1].id, status="failed")
        rec.update_run(runs[3].id, status="completed")
        assert rec.gc(keep=2) > 0
        left = {r.id for r in rec.list_runs()}
        assert runs[2].id in left and runs[0].id not in left
        assert runs[1].id in left and runs[3].id in left
        assert rec.results(runs[0].id) == {}
        for _ in range(8):
            rec.update_run(runs[3].id, winner_score=0.5)
        assert rec.compact(min_age_s=0.0) >= 8
        assert rec.get_run(runs[3].id).winner_score == 0.5

    def test_purge_run_drops_results(self, mem_storage):
        rec = EvalRecordStore(mem_storage)
        run = rec.create_run("eng", {}, 2, 1, 1, "m")
        rec.record_partial(run.id, 0, None, {"sum": 1, "count": 1})
        rec.record_partial(run.id, 1, None, {"sum": 2, "count": 1})
        assert rec.purge_run(run.id) >= 3
        assert rec.get_run(run.id) is None
        assert rec.results(run.id) == {}


def test_each_package_reads_the_others_eval_records(tmp_path):
    """Runs, results, lineage links and presets written by one package
    into a sqlite file are read by the other, field for field."""
    ts, js = _port_storage(tmp_path / "s"), _jax_storage(tmp_path / "s")
    mine, theirs = EvalRecordStore(ts), jrecords.EvalRecordStore(js)
    a = mine.create_run("e1", {"metric": "map@5"}, 2, 1, 2, "MAPAtK@5", tenant="t1")
    mine.record_partial(a.id, 0, 1, {"primary": {"sum": 1.0, "count": 2}}, params={"x": 1})
    mine.update_run(a.id, status="completed", winner_index=0, winner_score=0.5,
                    winner_params={"algorithms": [{"name": "als"}]})
    mine.link_model_version(a.id, "mv-a", job_id="job-a")
    time.sleep(0.01)
    b = theirs.create_run("e2", {"metric": "rmse"}, 1, 1, 1, "HeldOutRMSE",
                          higher_is_better=False)
    theirs.record_partial(b.id, 0, None, {"primary": {"sum": 4.0, "count": 1}})
    theirs.link_model_version(b.id, "mv-b", job_id="job-b")
    for reader in (mine, theirs):
        assert [r.id for r in reader.list_runs()] == [b.id, a.id]
    assert theirs.get_run(a.id).to_dict() == mine.get_run(a.id).to_dict()
    assert mine.get_run(b.id).to_dict() == theirs.get_run(b.id).to_dict()
    assert mine.get_run(b.id).higher_is_better is False
    assert theirs.get_run(a.id).links["mv-a"]["job_id"] == "job-a"
    assert theirs.results(a.id) == mine.results(a.id)
    assert mine.results(b.id) == theirs.results(b.id)
    PresetStore(ts).park(RetrainPreset(engine_id="e1", params={"serving": {}},
                                       run_id=a.id, metric_header="MAPAtK@5", score=0.5))
    jtuning.PresetStore(js).park(jtuning.RetrainPreset(
        engine_id="e1", params={"serving": {"x": 1}}, tenant="t1", run_id=b.id))
    assert jtuning.PresetStore(js).get("e1").to_dict() == PresetStore(ts).get("e1").to_dict()
    assert PresetStore(ts).get("e1", tenant="t1").to_dict() == \
        jtuning.PresetStore(js).get("e1", tenant="t1").to_dict()


# ---------------------------------------------------------------------------
# the eval driver
# ---------------------------------------------------------------------------


class TestEvalDriver:
    def test_fleet_parity_with_sequential_metric_evaluator(self, fresh_storage, tmp_path):
        """The grid-grouped fleet run (fold shards, combinable partials,
        durable records) gives the sequential MetricEvaluator's per-point
        scores to 1e-5, and the JAX driver's on the same spec exactly."""
        from predictionio_tpu_torch.controller.evaluation import MetricEvaluator
        from predictionio_tpu_torch.core.base import RuntimeContext, WorkflowParams

        import torch_sample_engine

        spec = _grid_spec(weights=WEIGHTS[:6])
        driver = EvalDriver(fresh_storage)
        run = driver.submit(spec)
        assert run.num_points == 6 and run.num_groups == 1 and len(run.shards) == 2
        _run_shards_inprocess(fresh_storage, driver, run, tmp_path)
        run = driver.poll_once(run.id)
        assert run.status == "completed"

        engine = torch_sample_engine.GridEngineFactory().apply()
        eps = [engine.params_from_variant_json(p) for p in expand_points(spec)]
        ctx = RuntimeContext(storage=fresh_storage, mode="eval", device="cpu")
        seq = MetricEvaluator(torch_sample_engine.GridScore()).evaluate(
            ctx, None, engine.batch_eval(ctx, eps), WorkflowParams())
        fleet = driver.scores(run)
        assert all(s["complete"] for s in fleet)
        for got, ref in zip(fleet, seq.engine_params_scores):
            assert got["score"] == pytest.approx(ref.score, abs=1e-5)
        assert run.winner_index == seq.best_index == BEST_INDEX
        assert run.winner_params["algorithms"][0]["params"]["weight"] == pytest.approx(0.37)

        js = _jax_storage(tmp_path / "jax")
        jd = jdriver.EvalDriver(js)
        jrun = jd.submit(jspecs.EvalSpec.from_dict(_grid_dict(WEIGHTS[:6], jax=True)))
        _run_jax_shards_inprocess(js, jd, jrun, tmp_path)
        jrun = jd.poll_once(jrun.id)
        assert [s["score"] for s in fleet] == [s["score"] for s in jd.scores(jrun)]
        assert (run.winner_index, run.winner_score) == (jrun.winner_index, jrun.winner_score)

    def test_grid_group_trains_one_program_per_fold(self, fresh_storage):
        import torch_sample_engine

        from predictionio_tpu_torch.core.base import RuntimeContext

        engine = torch_sample_engine.GridEngineFactory().apply()
        eps = [engine.params_from_variant_json(p) for p in expand_points(_grid_spec())]
        ctx = RuntimeContext(storage=fresh_storage, mode="eval", device="cpu")
        out = engine.batch_eval(ctx, eps, fold_indices=[1])
        assert len(out) == len(eps)
        for _ep, data in out:
            assert len(data) == 1
            info, qpas = data[0]
            assert info.id == 1
            assert all(p.grid_size == len(eps) for _q, p, _a in qpas)
        with pytest.raises(ValueError):
            engine.batch_eval(ctx, eps, fold_indices=[5])

    def test_redispatch_and_exhaustion(self, fresh_storage, tmp_path):
        driver = EvalDriver(fresh_storage,
                            EvalDriverConfig(poll_interval_s=0.05, redispatch_limit=1))
        run = driver.submit(_grid_spec(weights=[0.1, 0.2], folds=0))
        assert len(run.shards) == 1
        (job_id,) = run.shards
        queue = JobQueue(fresh_storage)
        assert queue.get(job_id).kind == "eval"
        queue.update(job_id, status="failed", last_error="boom")
        run = driver.poll_once(run.id)
        assert run.status == "running" and len(run.shards) == 2
        assert run.shards[job_id]["redispatched"] == 1
        new_id = next(j for j in run.shards if j != job_id)
        assert queue.get(new_id).status == "queued"
        queue.update(new_id, status="failed", last_error="boom again")
        run = driver.poll_once(run.id)
        assert run.status == "failed" and "exhausted" in run.last_error
        _run_shards_inprocess(fresh_storage, driver, type(run)(
            id=run.id, engine_id=run.engine_id, shards={new_id: run.shards[new_id]}), tmp_path)
        assert all(s["complete"] for s in driver.scores(driver.records.get_run(run.id)))

    def test_driver_thread_start_stop_joins(self, mem_storage):
        rec = EvalRecordStore(mem_storage)
        run = rec.create_run("eng", {"metric": "map"}, 1, 1, 1, "MAPAtK@10")
        driver = EvalDriver(mem_storage, EvalDriverConfig(poll_interval_s=0.05))
        driver.start(run.id)
        with pytest.raises(RuntimeError):  # one poll thread at a time
            driver.start(run.id)
        rec.record_partial(run.id, 0, None, {"primary": {"sum": 1.0, "count": 2}})
        _wait_for(lambda: (rec.get_run(run.id) or run).status == "completed",
                  timeout=10, what="empty run to finalize")
        driver.stop()
        assert not any(t.name == EVAL_DRIVER_THREAD and t.is_alive()
                       for t in threading.enumerate())

    def test_status_payload(self, fresh_storage, tmp_path):
        driver = EvalDriver(fresh_storage)
        run = driver.submit(_grid_spec(weights=[0.3, 0.4], folds=2))
        st = driver.status(run.id)
        assert st["points_total"] == 2 and st["points_done"] == 0
        assert len(st["shards"]) == 2
        assert {s["status"] for s in st["shards"]} == {"queued"}
        _run_shards_inprocess(fresh_storage, driver, run, tmp_path)
        st = driver.status(run.id)
        assert st["points_done"] == 2 and all(s["complete"] for s in st["points"])
        with pytest.raises(KeyError):
            driver.status("eval-nope")


def test_eval_shard_without_the_device_fails_and_trains_nothing(fresh_storage, tmp_path,
                                                               monkeypatch):
    """A shard whose device is missing exits with the scheduler's train
    failure code and records no partial: it never falls back to the CPU."""
    import torch

    from predictionio_tpu_torch.deploy.scheduler import EXIT_TRAIN_FAILED
    from predictionio_tpu_torch.evalfleet import worker as eval_worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    driver = EvalDriver(fresh_storage)
    run = driver.submit(_grid_spec(weights=[0.3], folds=0))
    (job_id,) = run.shards
    spec_path = tmp_path / "shard.json"
    spec_path.write_text(json.dumps({
        "job_id": job_id, "storage": storage_config_to_json(fresh_storage.config),
        "variant": driver.queue.get(job_id).variant,
        "result_path": str(tmp_path / "r.json"), "device": None}))
    assert eval_worker.main(["worker", str(spec_path)]) == EXIT_TRAIN_FAILED
    assert driver.records.results(run.id) == {}


# the recommendation template through the fleet, against the JAX driver


REC_APP = "fleetrec"


def _rec_dict(jax):
    pkg = "predictionio_tpu" if jax else "predictionio_tpu_torch"
    return {
        "variant": {
            "id": "fleetrec",
            "engineFactory": f"{pkg}.engines.recommendation.RecommendationEngine",
            "datasource": {"params": {"app_name": REC_APP, "eval_k": 3, "eval_num": 10,
                                      "goal_threshold": 4.0}},
            "algorithms": [{"name": "als", "params": {"rank": 4, "num_iterations": 4,
                                                      "lambda_": 0.01}}],
        },
        "axes": [{"path": "algorithms.0.params.rank", "values": [4, 8]},
                 {"path": "algorithms.0.params.lambda_", "values": [0.01, 1.0]}],
        "metric": {"class": f"{pkg}.engines.recommendation.engine.PrecisionAtK",
                   "params": {"k": 5}},
        "otherMetrics": ["precision@5"],
        "folds": 3,
    }


def test_recommendation_fleet_run_matches_sequential_and_jax(tmp_path, monkeypatch):
    """tests/test_torch_eval_slice.py's data and grid as an EvalSpec:
    the port's fleet run (shards in this process, ALS on the CPU from the
    JAX package's start factors) equals the port's sequential
    `run_evaluation` to 1e-5 a point, and the JAX driver's run within
    0.01 (the eval slice's bar), with the same winner."""
    from predictionio_tpu.data.event import Event as JEvent
    from predictionio_tpu.data.storage.base import App as JApp
    from predictionio_tpu_torch import controller as tc
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.engines.recommendation import engine as teng
    from predictionio_tpu_torch.models import als as tals
    from predictionio_tpu_torch.workflow import evaluation as twf
    from test_torch_als_grid import jax_init
    from test_torch_eval_slice import _events, _rows

    monkeypatch.setattr(tals, "_seeded_init", jax_init)
    ts, js = _port_storage(tmp_path / "port"), _jax_storage(tmp_path / "jax")
    for storage, app_cls, ev in ((ts, App, Event), (js, JApp, JEvent)):
        app_id = storage.get_meta_data_apps().insert(app_cls(0, REC_APP))
        storage.get_events().init_app(app_id)
        storage.get_events().insert_batch(_events(ev, _rows()), app_id)

    spec = EvalSpec.from_dict(_rec_dict(jax=False))
    driver = EvalDriver(ts)
    run = driver.submit(spec)
    assert run.num_points == 4 and run.num_groups == 1 and len(run.shards) == 3
    _run_shards_inprocess(ts, driver, run, tmp_path)
    run = driver.poll_once(run.id)
    assert run.status == "completed"
    fleet = [s["score"] for s in driver.scores(run)]
    others = [r["fold_0"]["others"][0]["header"] for r in driver.records.results(run.id).values()]
    assert others == ["PrecisionAtK@5"] * 4

    engine = teng.RecommendationEngine().apply()
    eps = [engine.params_from_variant_json(p) for p in expand_points(spec)]
    evaluation = type("RecEval", (tc.Evaluation,), {
        "engine": engine, "metric": teng.PrecisionAtK(k=5)})()
    _inst, seq = twf.run_evaluation(ts, evaluation, eps, device="cpu")
    for got, ref in zip(fleet, seq.engine_params_scores):
        assert got == pytest.approx(ref.score, abs=1e-5)
    assert run.winner_index == seq.best_index

    jd = jdriver.EvalDriver(js)
    jrun = jd.submit(jspecs.EvalSpec.from_dict(_rec_dict(jax=True)))
    _run_jax_shards_inprocess(js, jd, jrun, tmp_path)
    jrun = jd.poll_once(jrun.id)
    assert jrun.status == "completed"
    jfleet = [s["score"] for s in jd.scores(jrun)]
    assert fleet == pytest.approx(jfleet, abs=0.01)
    assert run.winner_index == jrun.winner_index
    assert max(fleet) > 2 * min(fleet)  # the grid matters on this data


# ---------------------------------------------------------------------------
# a two-member fleet, a member killed mid-shard
# ---------------------------------------------------------------------------


class TestChaosFleetEval:
    def test_kill9_mid_shard_converges_exactly_once(self, fresh_storage, tmp_path):
        """Two members, an 8-point grid in two fold shards; the member
        that owns a running shard is killed while the shard sleeps in
        read_eval. The survivor steals the stale claim and re-runs it;
        every point converges to exactly one result record."""
        spec = _grid_spec(weights=WEIGHTS, folds=2, sleep_s=0.6)
        members = [FleetMember(fresh_storage,
                               scheduler_config=_scheduler_config(tmp_path / f"w{i}"),
                               fleet_config=FleetConfig(heartbeat_interval_s=0.1,
                                                        adaptive_settle=False))
                   for i in range(2)]
        driver = EvalDriver(fresh_storage, EvalDriverConfig(poll_interval_s=0.2))
        queue = JobQueue(fresh_storage)
        for m in members:
            m.start()
        victim = None
        try:
            run = driver.submit(spec)
            assert run.num_points == 8 and len(run.shards) == 2

            def running_jobs():
                return [j for j in queue.list()
                        if j.id in run.shards and j.status == "running"]

            _wait_for(running_jobs, timeout=60, what="a shard to start running")
            owner = running_jobs()[0].worker_id
            victim = next(m for m in members if m.worker_id == owner)
            victim.stop(kill_child=True)
            run = driver.wait(run.id, timeout_s=180)
            assert run.status == "completed", run.last_error
        finally:
            for m in members:
                if m is not victim:
                    m.stop()
        results = driver.records.results(run.id)
        assert sorted(results) == list(range(8))
        for rec in results.values():
            assert set(driver.records.point_partials(rec)) == {"fold_0", "fold_1"}
        assert run.winner_index == BEST_INDEX
        attempts = [queue.get(j).attempt for j in run.shards]
        generations = [queue.get(j).generation for j in run.shards]
        assert max(attempts) >= 1 or max(generations) >= 2


# ---------------------------------------------------------------------------
# the tuning loop
# ---------------------------------------------------------------------------


class TestTuningLoop:
    def test_tune_parks_winner_and_next_retrain_trains_it(self, fresh_storage, tmp_path):
        """`tune` end to end: a fleet run, the winner parked as a preset,
        the next periodic retrain trains it and stamps the lineage link;
        the JAX package reads the preset and the link."""
        spec = _grid_spec(weights=[0.1, 0.37, 0.7], folds=0)
        member = FleetMember(fresh_storage, scheduler_config=_scheduler_config(tmp_path),
                             fleet_config=FleetConfig(heartbeat_interval_s=0.1,
                                                      adaptive_settle=False))
        member.start()
        try:
            driver = EvalDriver(fresh_storage, EvalDriverConfig(poll_interval_s=0.2))
            run, preset = tune(fresh_storage, spec, timeout_s=120, driver=driver)
            assert run.status == "completed" and preset is not None
            assert preset.params["algorithms"][0]["params"]["weight"] == pytest.approx(0.37)
            assert PresetStore(fresh_storage).get("grid").run_id == run.id

            queue = JobQueue(fresh_storage)
            job = queue.submit(dict(GRID_VARIANT), period_s=0.2, timeout_s=120)
            _wait_for(lambda: queue.get(job.id).status == "completed", timeout=120,
                      what="periodic train job")

            def next_job():
                return [j for j in queue.list() if j.id != job.id and j.kind == "train"]

            _wait_for(next_job, timeout=10, what="next periodic job")
            nxt = next_job()[0]
            assert nxt.variant["algorithms"][0]["params"]["weight"] == pytest.approx(0.37)
            assert nxt.variant["evalRun"] == run.id
            _wait_for(lambda: queue.get(nxt.id).status == "completed", timeout=120,
                      what="winner retrain job")
        finally:
            member.stop()
        done = JobQueue(fresh_storage).get(nxt.id)
        assert done.model_version
        linked = EvalRecordStore(fresh_storage).get_run(run.id)
        assert done.model_version in linked.links and linked.winner_model_version
        assert linked.links[done.model_version]["job_id"] == nxt.id
        js = _jax_storage(tmp_path / "store")
        assert jtuning.PresetStore(js).get("grid").run_id == run.id
        assert done.model_version in jrecords.EvalRecordStore(js).get_run(run.id).links

    def test_preset_tenant_scoping(self, mem_storage):
        store = PresetStore(mem_storage)
        store.park(RetrainPreset(engine_id="e", params={"serving": {}}, run_id="eval-g"))
        store.park(RetrainPreset(engine_id="e", params={"serving": {}}, tenant="acme",
                                 run_id="eval-t"))
        assert store.get("e").run_id == "eval-g"
        assert store.get("e", tenant="acme").run_id == "eval-t"
        assert store.get("e", tenant="other").run_id == "eval-g"
        assert [p.run_id for p in store.list()] == ["eval-t", "eval-g"]
        assert store.clear("e", tenant="acme") > 0
        assert store.get("e", tenant="acme").run_id == "eval-g"

    def test_apply_preset_overlay_and_marker(self, mem_storage):
        variant = dict(GRID_VARIANT)
        assert apply_preset(mem_storage, variant, "grid") is variant
        PresetStore(mem_storage).park(RetrainPreset(
            engine_id="grid",
            params={"algorithms": [{"name": "grid", "params": {"weight": 0.37}}]},
            run_id="eval-w"))
        merged = apply_preset(mem_storage, variant, "grid")
        assert merged["algorithms"][0]["params"]["weight"] == 0.37
        assert merged["evalRun"] == "eval-w"
        assert merged["datasource"] == variant["datasource"]
        assert merged["engineFactory"] == variant["engineFactory"]
        assert "evalRun" not in variant

    def test_park_winner_requires_completed_run(self, mem_storage):
        rec = EvalRecordStore(mem_storage)
        run = rec.create_run("e", {}, 1, 1, 1, "m")
        with pytest.raises(ValueError):
            park_winner(mem_storage, run)


class TestOfflinePrior:
    def _runs(self, storage, cand_score, live_score, metric="map@5", live_metric=None):
        rec = EvalRecordStore(storage)
        live_run = rec.create_run("e", {"metric": live_metric or metric}, 1, 1, 1,
                                  resolve_metric(live_metric or metric).header())
        rec.update_run(live_run.id, status="completed", winner_score=live_score)
        rec.link_model_version(live_run.id, "mv-live")
        time.sleep(0.01)
        cand_run = rec.create_run("e", {"metric": metric}, 1, 1, 1,
                                  resolve_metric(metric).header())
        rec.update_run(cand_run.id, status="completed", winner_score=cand_score)
        rec.link_model_version(cand_run.id, "mv-cand")
        return rec

    def test_worse_candidate_stretches_bake(self, mem_storage, monkeypatch):
        monkeypatch.setenv("PIO_TUNE_STRICT_BAKE", "3.0")
        self._runs(mem_storage, cand_score=0.2, live_score=0.8)
        mult, reason = offline_prior_multiplier(mem_storage, "e", "mv-cand", "mv-live")
        assert mult == 3.0 and "worse than live" in reason

    def test_better_or_equal_candidate_keeps_bake(self, mem_storage):
        self._runs(mem_storage, cand_score=0.9, live_score=0.8)
        assert offline_prior_multiplier(mem_storage, "e", "mv-cand", "mv-live") == (1.0, None)
        rec = EvalRecordStore(mem_storage)
        # lower is better for RMSE: a lower candidate is not worse
        rmse = rec.create_run("r", {"metric": "rmse"}, 1, 1, 1, "HeldOutRMSE")
        rec.update_run(rmse.id, status="completed", winner_score=0.5)
        rec.link_model_version(rmse.id, "mv-c")
        time.sleep(0.01)
        live = rec.create_run("r", {"metric": "rmse"}, 1, 1, 1, "HeldOutRMSE")
        rec.update_run(live.id, status="completed", winner_score=0.9)
        rec.link_model_version(live.id, "mv-l")
        assert offline_prior_multiplier(mem_storage, "r", "mv-c", "mv-l") == (1.0, None)

    def test_missing_evidence_is_neutral(self, mem_storage):
        assert offline_prior_multiplier(mem_storage, "e", "mv-cand", "mv-live") == (1.0, None)
        assert offline_prior_multiplier(mem_storage, "e", "mv-cand", None) == (1.0, None)

    def test_metric_mismatch_is_neutral(self, mem_storage):
        self._runs(mem_storage, cand_score=0.2, live_score=0.8,
                   metric="map@5", live_metric="ndcg@5")
        assert offline_prior_multiplier(mem_storage, "e", "mv-cand", "mv-live") == (1.0, None)

    def test_flag_off_disables_prior(self, mem_storage, monkeypatch):
        monkeypatch.setenv("PIO_TUNE_PRIOR", "0")
        self._runs(mem_storage, cand_score=0.2, live_score=0.8)
        assert offline_prior_multiplier(mem_storage, "e", "mv-cand", "mv-live") == (1.0, None)


# ---------------------------------------------------------------------------
# the adaptive claim settle window
# ---------------------------------------------------------------------------


class TestAdaptiveSettle:
    def test_pinned_env_wins(self, mem_storage, monkeypatch):
        monkeypatch.setenv("PIO_CAS_SETTLE_S", "0.75")
        m = FleetMember(mem_storage)
        m._adapt_claim_settle()
        assert m.scheduler.config.claim_settle_s == 0.75

    def test_bad_pin_keeps_default(self, mem_storage, monkeypatch):
        monkeypatch.setenv("PIO_CAS_SETTLE_S", "fast")
        m = FleetMember(mem_storage)
        before = m.scheduler.config.claim_settle_s
        m._adapt_claim_settle()
        assert m.scheduler.config.claim_settle_s == before

    def test_adaptive_clamps_to_floor(self, mem_storage, monkeypatch):
        monkeypatch.delenv("PIO_CAS_SETTLE_S", raising=False)
        from predictionio_tpu_torch.fleet import coordinator as coord

        # a store whose writes are visible at once: the floor clamp holds
        monkeypatch.setattr(coord, "measure_write_visibility_skew", lambda s: 0.0)
        m = FleetMember(mem_storage)
        m._adapt_claim_settle()
        assert m.scheduler.config.claim_settle_s == pytest.approx(0.02)

    def test_adaptive_clamps_to_ceiling(self, mem_storage, monkeypatch):
        monkeypatch.delenv("PIO_CAS_SETTLE_S", raising=False)
        from predictionio_tpu_torch.fleet import coordinator as coord

        monkeypatch.setattr(coord, "measure_write_visibility_skew", lambda s: 100.0)
        m = FleetMember(mem_storage)
        m._adapt_claim_settle()
        assert m.scheduler.config.claim_settle_s == pytest.approx(2.0)

    def test_disabled_keeps_configured_default(self, mem_storage, monkeypatch):
        monkeypatch.delenv("PIO_CAS_SETTLE_S", raising=False)
        m = FleetMember(mem_storage, fleet_config=FleetConfig(adaptive_settle=False))
        before = m.scheduler.config.claim_settle_s
        m._adapt_claim_settle()
        assert m.scheduler.config.claim_settle_s == before == 0.25

    def test_probe_measures_and_cleans_up(self, mem_storage):
        from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore

        assert measure_write_visibility_skew(mem_storage, probes=2) >= 0.0
        assert LifecycleRecordStore(mem_storage).fold("pio_settle_probe") == {}


# ---------------------------------------------------------------------------
# GET /evals*
# ---------------------------------------------------------------------------


class TestAdminEvals:
    @pytest.fixture()
    def admin(self, fresh_storage, tmp_path):
        from predictionio_tpu.tools.admin import AdminServer as JAdminServer
        from predictionio_tpu_torch.tools.admin import AdminServer

        srv = AdminServer(fresh_storage, ip="127.0.0.1", port=0)
        jsrv = JAdminServer(_jax_storage(tmp_path / "store"), ip="127.0.0.1", port=0)
        ports = srv.start(), jsrv.start()
        yield fresh_storage, ports
        srv.stop()
        jsrv.stop()

    @staticmethod
    def _get(port, path):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"null")

    def test_list_and_detail(self, admin):
        """The port's admin server answers as the JAX one does over the
        same sqlite file."""
        storage, (port, jport) = admin
        run = EvalDriver(storage).submit(_grid_spec(weights=[0.3, 0.4], folds=2),
                                         tenant="acme")
        status, listing = self._get(port, "/evals")
        assert status == 200 and [r["id"] for r in listing] == [run.id]
        assert listing[0]["tenant"] == "acme"
        assert listing == self._get(jport, "/evals")[1]
        status, listing = self._get(port, "/evals?tenant=other")
        assert status == 200 and listing == []
        status, detail = self._get(port, f"/evals/{run.id}")
        assert status == 200 and detail["points_total"] == 2 and len(detail["shards"]) == 2
        assert detail == self._get(jport, f"/evals/{run.id}")[1]
        assert self._get(port, "/evals/eval-nope")[0] == 404
        assert self._get(port, "/evals/a/b")[0] == 404


# ---------------------------------------------------------------------------
# the console: eval run SPEC, eval list|show|status|gc, tune, fleet status
# ---------------------------------------------------------------------------


def _run_cli(main, argv, capsys):
    try:
        code = main(argv)
        extra = ""
    except SystemExit as e:
        code, extra = (1, f"{e.code}\n") if isinstance(e.code, str) else (e.code, "")
    out, err = capsys.readouterr()
    return code, out, err + extra


def _jax_cli(argv):
    from predictionio_tpu.tools import console as jconsole

    JStorage.set_instance(None)
    try:
        return jconsole.main(argv)
    finally:
        JStorage.set_instance(None)


def test_console_fleet_verbs_print_as_the_jax_console(tmp_path, monkeypatch, capsys):
    """`eval run SPEC --local-workers 2` (two fleet members, shard
    children on the CPU), `eval list|show|status`, `tune`, `fleet status`
    and `eval gc` over the port's storage; the JAX console prints the
    same listings over the same store."""
    import re

    from predictionio_tpu_torch.tools import console

    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "pio"))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([REPO_DIR, TESTS_DIR]))
    monkeypatch.setenv("PIO_EVAL_POLL_S", "0.2")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(_grid_dict(weights=[0.1, 0.37, 0.6], folds=2)))
    code, out, err = _run_cli(console.main, ["eval", "run", str(spec), "--local-workers", "2",
                                             "--device", "cpu", "--timeout", "180"], capsys)
    assert code == 0, err
    run_id = re.search(r"eval-[0-9a-f]{12}", out).group()
    assert "3 points, 2 shard jobs queued" in out and "winner     point 1" in out
    for argv in (["eval", "list"], ["eval", "list", "--status", "completed"],
                 ["eval", "show", run_id], ["eval", "status", run_id]):
        got = _run_cli(console.main, argv, capsys)
        assert got[0] == 0 and got == _run_cli(_jax_cli, argv, capsys), argv
    code, out, _ = _run_cli(console.main, ["eval", "status", run_id], capsys)
    assert "progress   3/3 points" in out and out.count("completed") == 3  # + 2 shards

    code, out, err = _run_cli(console.main, ["tune", str(spec), "--local-workers", "1",
                                             "--device", "cpu", "--timeout", "180"], capsys)
    assert code == 0, err
    assert "winner point 1" in out and "parked as global retrain preset for engine grid" in out
    assert PresetStore(Storage()).get("grid").params["algorithms"][0]["params"]["weight"] \
        == pytest.approx(0.37)
    code, out, _ = _run_cli(console.main, ["fleet", "status"], capsys)
    status = json.loads(out)
    assert status["workers"] == [] and status["jobs"] == {"completed": 4}  # 2 runs x 2

    code, out, _ = _run_cli(console.main, ["eval", "gc", "--keep", "1", "--now"], capsys)
    assert code == 0 and out.startswith("[INFO] Eval GC:")
    code, out, _ = _run_cli(console.main, ["eval", "list"], capsys)
    assert run_id not in out and out.count("eval-") == 1
    assert _run_cli(console.main, ["eval", "show", run_id], capsys)[0] == 1
