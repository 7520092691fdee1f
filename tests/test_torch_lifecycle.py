"""The model lifecycle on the port: versions, warm start, the train-job
queue and its worker, against the JAX package.

- ``warm_start_factors``: bit-equal to the JAX function on the same
  parent and vocabularies (surviving, new and dropped ids; a parent of
  larger and of smaller rank; an empty parent).
- ``ModelRegistry``: the cases of the JAX package's
  tests/test_lifecycle.py ``TestModelRegistry`` and ``TestFoldCompaction``
  on the port's sqlite + localfs storage; then, over one store, a
  version either package registered is read, promoted and listed by the
  other, and ``params_hash`` is the same function in both (the same
  variant trained by each package's ``run_train`` hashes the same
  stage strings but two by design: the factory path, and the JAX
  package's ``shard_serving`` key).
- ``JobQueue``: the ``TestJobQueue`` cases; a job either package
  submitted is listed with the same fields by the other; a kind other
  than ``train`` is refused.
- ``TrainScheduler`` and the worker: the ``TestSchedulerSubprocess`` and
  ``TestSchedulerConcurrency`` cases with the child on the CPU
  (``SchedulerConfig.device``), training the recommendation template
  (tests/torch_sample_engine.py adds a data source that stalls or
  fails) on a few hundred events; a retried job adopts the version its
  earlier attempt registered; a child with no device named and no card
  fails its job.
- Warm start through the engine: ``_warm_start_init`` is None without a
  live version, for a live version of another rank and without an
  instance id, else ``warm_start_factors`` of the live blob; variants
  with ``warm_start``/``checkpoint_every`` train, ``shard_serving`` is
  still refused.
- Console: ``models list|show|promote|rollback|gc`` and ``jobs
  submit|list|show|logs|gc|worker --once --device cpu``, whose listings
  the JAX console prints alike over the same storage.
"""

import datetime as dt
import json
import os
import re
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.storage.base import EngineInstance as JInstance  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.data.store.bimap import BiMap as JBiMap  # noqa: E402
from predictionio_tpu.deploy import registry as jreg  # noqa: E402
from predictionio_tpu.deploy import scheduler as jsched  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu.workflow import core as jcore  # noqa: E402
from predictionio_tpu_torch.controller import ParamsError  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App, EngineInstance, Model  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.data.store.bimap import BiMap  # noqa: E402
from predictionio_tpu_torch.deploy.registry import (  # noqa: E402
    LIFECYCLE_APP_ID,
    VERSION_ENTITY,
    LifecycleRecordStore,
    ModelRegistry,
    params_hash,
)
from predictionio_tpu_torch.deploy.scheduler import (  # noqa: E402
    JobQueue,
    SchedulerConfig,
    TrainScheduler,
    storage_config_from_json,
    storage_config_to_json,
)
from predictionio_tpu_torch.data.storage.base import EventQuery  # noqa: E402
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402
from predictionio_tpu_torch.models import als  # noqa: E402
from predictionio_tpu_torch.tools import console  # noqa: E402
from predictionio_tpu_torch.workflow import core as tcore  # noqa: E402

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)
APP = "lcapp"
REC = "predictionio_tpu_torch.engines.recommendation.RecommendationEngine"
SLOW = "torch_sample_engine.SlowRecommendationEngine"
ALGO = {"name": "als", "params": {"rank": 4, "num_iterations": 3}}
VARIANT = {"id": "lc", "engineFactory": REC,
           "datasource": {"params": {"app_name": APP, "event_names": ["rate"]}},
           "algorithms": [ALGO]}


def _slow(sleep_s=0.0, engine="lcslow", **extra):
    return {"id": engine, "engineFactory": SLOW,
            "datasource": {"params": {"app_name": APP, "event_names": ["rate"],
                                      "sleep_s": sleep_s, **extra}},
            "algorithms": [ALGO]}


def _config(path):
    return dict(
        sources={"TESTSQL": ("sqlite", {"PATH": str(path / "pio.db")}),
                 "TESTFS": ("localfs", {"PATH": str(path)})},
        repositories={"METADATA": "TESTSQL", "EVENTDATA": "TESTSQL",
                      "MODELDATA": "TESTFS"})


def _storage(path):
    """tests/conftest.py's fresh_storage wiring, under `path`, on the port."""
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


@pytest.fixture
def storage(tmp_path):
    return _storage(tmp_path / "store")


def _seed_app(storage, n_users=30, n_items=20, n_events=300, seed=0):
    """`n_events` rate events of unique (user, item) pairs in app APP."""
    app_id = storage.get_meta_data_apps().insert(App(id=0, name=APP))
    storage.get_events().init_app(app_id)
    rng = np.random.RandomState(seed)
    keys = rng.choice(n_users * n_items, n_events, replace=False)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{k // n_items}",
              target_entity_type="item", target_entity_id=f"i{k % n_items}",
              properties={"rating": float(rng.randint(1, 6))})
        for k in keys], app_id)
    return app_id


def _instance(iid, variant="lc", status="COMPLETED", cls=EngineInstance):
    now = dt.datetime.now(dt.timezone.utc)
    return cls(id=iid, status=status, start_time=now, end_time=now,
               engine_id=variant, engine_version="0", engine_variant=variant,
               engine_factory=REC,
               algorithms_params=json.dumps([{"name": "als", "params": {"rank": 3}}]))


def _scheduler_config(tmp_path, **kw):
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


# ---------------------------------------------------------------------------
# warm_start_factors
# ---------------------------------------------------------------------------


def _vocab_cases():
    """case → (parent user ids, parent item ids, parent rank, new user
    ids, new item ids, rank)."""
    users = [f"u{n}" for n in range(12)]
    items = [f"i{n}" for n in range(9)]
    new_users = ["u11", "x1", "u3", "u0", "x2", "u7", "u5"]  # survivors, new, reordered
    new_items = ["i8", "i2", "y1", "i0", "y2", "y3"]
    return {
        "survivors_new_dropped": (users, items, 6, new_users, new_items, 6),
        "larger_parent_rank": (users, items, 9, new_users, new_items, 6),
        "smaller_parent_rank": (users, items, 4, new_users, new_items, 6),
        "empty_parent": ([], [], 6, new_users, new_items, 6),
    }


@pytest.mark.parametrize("case", sorted(_vocab_cases()))
def test_warm_start_factors_bit_equal_to_jax(case):
    users, items, k_parent, new_users, new_items, rank = _vocab_cases()[case]
    rng = np.random.default_rng(3)
    uf = rng.standard_normal((len(users), k_parent)).astype(np.float32)
    itf = rng.standard_normal((len(items), k_parent)).astype(np.float32)

    def parent(mod, bimap):
        return mod.ALSFactors(uf, itf, bimap.string_int(users), bimap.string_int(items),
                              mod.ALSParams(rank=k_parent))

    got = als.warm_start_factors(parent(als, BiMap), BiMap.string_int(new_users),
                                 BiMap.string_int(new_items), als.ALSParams(rank=rank, seed=7))
    want = jals.warm_start_factors(parent(jals, JBiMap), JBiMap.string_int(new_users),
                                   JBiMap.string_int(new_items),
                                   jals.ALSParams(rank=rank, seed=7))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    k = min(rank, k_parent) if users else 0
    if k:  # a survivor copies its parent row
        np.testing.assert_array_equal(got[0][2, :k], uf[3, :k])
        np.testing.assert_array_equal(got[1][0, :k], itf[8, :k])


# ---------------------------------------------------------------------------
# the registry (JAX: TestModelRegistry, TestFoldCompaction)
# ---------------------------------------------------------------------------


class TestModelRegistry:
    def test_register_requires_completed(self, storage):
        with pytest.raises(ValueError):
            ModelRegistry(storage).register(_instance("i0", status="ABORTED"))

    def test_crud_and_status_transitions(self, storage):
        reg = ModelRegistry(storage)
        v1 = reg.register(_instance("i1"))
        assert v1.status == "trained" and v1.parent_version is None
        assert reg.get(v1.id).to_dict() == v1.to_dict()
        assert reg.get("mv-nope") is None
        reg.promote(v1.id)
        assert reg.get(v1.id).status == "live"
        assert reg.live_version("lc", "lc").id == v1.id
        v2 = reg.register(_instance("i2"))
        assert v2.parent_version == v1.id
        assert [v.id for v in reg.lineage(v2.id)] == [v2.id, v1.id]
        reg.promote(v2.id)
        assert reg.get(v1.id).status == "archived"
        assert reg.live_version("lc", "lc").id == v2.id
        reg.rollback(v2.id, "bad p99")
        assert reg.get(v2.id).status == "rolled_back"
        assert reg.get(v2.id).reason == "bad p99"
        with pytest.raises(ValueError):
            reg.set_status(v1.id, "bogus")
        with pytest.raises(KeyError):
            reg.set_status("mv-nope", "live")

    def test_list_filters(self, storage):
        reg = ModelRegistry(storage)
        a = reg.register(_instance("ia", variant="va"))
        b = reg.register(_instance("ib", variant="vb"))
        reg.promote(b.id)
        assert {v.id for v in reg.list()} == {a.id, b.id}
        assert [v.id for v in reg.list(engine_id="va")] == [a.id]
        assert [v.id for v in reg.list(status="live")] == [b.id]

    def test_gc_retention(self, storage):
        reg = ModelRegistry(storage)
        models = storage.get_model_data_models()
        versions = []
        for i in range(5):
            models.insert(Model(id=f"g{i}", models=b"blob"))
            versions.append(reg.register(_instance(f"g{i}")))
            time.sleep(0.002)  # distinct created_at ordering
        reg.promote(versions[0].id)
        collected = reg.gc(keep=2, delete_blobs=True)
        assert {v.id for v in collected} == {versions[1].id, versions[2].id}
        assert {v.id for v in reg.list()} == {versions[0].id, versions[3].id,
                                              versions[4].id}
        assert models.get("g1") is None and models.get("g2") is None
        assert models.get("g0") is not None


class TestFoldCompaction:
    def _n_events(self, storage, entity_id):
        return len(list(storage.get_events().find(EventQuery(
            app_id=LIFECYCLE_APP_ID, entity_type=VERSION_ENTITY, entity_id=entity_id))))

    def test_compact_preserves_fold_and_bounds_events(self, storage):
        reg = ModelRegistry(storage)
        v = reg.register(_instance("ci1"))
        for i in range(6):
            reg.set_status(v.id, "archived" if i % 2 else "trained", reason=f"r{i}")
        before = reg.get(v.id).to_dict()
        assert self._n_events(storage, v.id) >= 7
        store = LifecycleRecordStore(storage)
        assert store.compact(VERSION_ENTITY, v.id) == 0  # still hot
        assert store.compact(VERSION_ENTITY, v.id, min_age_s=0.0) >= 7
        assert self._n_events(storage, v.id) == 1
        assert reg.get(v.id).to_dict() == before
        reg.set_status(v.id, "live")
        assert reg.get(v.id).status == "live"

    def test_gc_runs_compaction(self, storage):
        reg = ModelRegistry(storage)
        v = reg.register(_instance("ci2"))
        for i in range(10):
            reg.set_status(v.id, "trained", reason=f"r{i}")
        assert self._n_events(storage, v.id) >= 11
        reg.gc(keep=5)
        assert self._n_events(storage, v.id) >= 11
        reg.compact(min_age_s=0.0)
        assert self._n_events(storage, v.id) == 1
        assert reg.get(v.id).reason == "r9"

    def test_compact_below_threshold_is_noop(self, storage):
        v = ModelRegistry(storage).register(_instance("ci3"))
        assert LifecycleRecordStore(storage).compact_all(VERSION_ENTITY, min_events=8) == 0
        assert self._n_events(storage, v.id) == 1


# ---------------------------------------------------------------------------
# records across packages
# ---------------------------------------------------------------------------


def _next_ms():
    """Wait until the wall clock's millisecond changes. The stores keep
    event times in milliseconds, and each package's `_seq` orders only
    its own writes: a port write and a JAX write in one millisecond fold
    in either order. After this, the next write lands in a later
    millisecond than every write before the call."""
    now = int(time.time() * 1000)
    while int(time.time() * 1000) == now:
        time.sleep(0.0002)


def test_port_version_is_read_promoted_and_listed_by_jax(tmp_path):
    ts, js = _storage(tmp_path / "s"), _jax_storage(tmp_path / "s")
    reg, jr = ModelRegistry(ts), jreg.ModelRegistry(js)
    v1 = reg.register(_instance("p1"), job_id="job-1")
    assert jr.get(v1.id).to_dict() == v1.to_dict()
    _next_ms()
    jr.promote(v1.id)
    _next_ms()
    v2 = reg.register(_instance("p2"))
    assert reg.get(v1.id).status == "live" and v2.parent_version == v1.id
    assert [v.to_dict() for v in jr.list()] == [v.to_dict() for v in reg.list()]
    assert [v.id for v in jr.lineage(v2.id)] == [v2.id, v1.id]
    assert jr.find_by_job("job-1").id == v1.id


def test_jax_version_is_read_promoted_and_listed_by_port(tmp_path):
    ts, js = _storage(tmp_path / "s"), _jax_storage(tmp_path / "s")
    reg, jr = ModelRegistry(ts), jreg.ModelRegistry(js)
    v1 = jr.register(_instance("j1", cls=JInstance), job_id="job-2")
    assert reg.get(v1.id).to_dict() == v1.to_dict()
    _next_ms()
    reg.promote(v1.id)
    _next_ms()
    v2 = jr.register(_instance("j2", cls=JInstance))
    assert jr.get(v1.id).status == "live" and v2.parent_version == v1.id
    assert [v.to_dict() for v in reg.list()] == [v.to_dict() for v in jr.list()]
    assert reg.find_by_job("job-2").id == v1.id
    _next_ms()
    reg.rollback(v2.id, "port says no")
    assert jr.get(v2.id).reason == "port says no"


def test_params_hash_across_packages(tmp_path):
    """The same variant through each package's run_train: the port's
    params_hash of its row equals the JAX function's on that row read by
    the JAX store, and the two rows' hashed strings are equal but for the
    factory path and the JAX-only ``shard_serving`` key; with those two
    mapped, the hashes agree."""
    ts, js = _storage(tmp_path / "s"), _jax_storage(tmp_path / "s")
    _seed_app(ts)
    variant = dict(VARIANT, algorithms=[{"name": "als", "params": {
        "rank": 4, "num_iterations": 2, "checkpoint_every": 1, "warm_start": True}}])
    jvariant = dict(variant, engineFactory="predictionio_tpu.engines.recommendation."
                                           "RecommendationEngine")
    tinst = tcore.run_train(ts, variant, device="cpu")
    jinst = jcore.run_train(js, jvariant)
    t_row = js.get_meta_data_engine_instances().get(tinst.id)
    assert params_hash(tinst) == jreg.params_hash(t_row)
    for f in ("data_source_params", "preparator_params", "serving_params"):
        assert getattr(tinst, f) == getattr(jinst, f), f
    jalgos = json.loads(jinst.algorithms_params)
    assert jalgos[0]["params"].pop("shard_serving") is False
    assert json.loads(tinst.algorithms_params) == jalgos
    mapped = ts.get_meta_data_engine_instances().get(tinst.id)
    mapped.engine_factory = jinst.engine_factory
    mapped.algorithms_params = jinst.algorithms_params
    assert params_hash(mapped) == jreg.params_hash(jinst)
    assert params_hash(tinst) != jreg.params_hash(jinst)  # the factory differs


# ---------------------------------------------------------------------------
# the job queue (JAX: TestJobQueue)
# ---------------------------------------------------------------------------


class TestJobQueue:
    def test_storage_config_roundtrip(self, storage):
        restored = storage_config_from_json(storage_config_to_json(storage.config))
        assert restored.repositories == storage.config.repositories
        assert set(restored.sources) == set(storage.config.sources)
        src = next(iter(restored.sources.values()))
        assert src.type == storage.config.sources[src.name].type

    def test_submit_and_backoff_gate(self, storage):
        q = JobQueue(storage)
        with pytest.raises(ValueError):
            q.submit({"id": "x"})
        j = q.submit(VARIANT, timeout_s=9, period_s=60)
        got = q.get(j.id)
        assert got.status == "queued" and got.timeout_s == 9
        assert got.variant == VARIANT and got.period_s == 60
        assert [x.id for x in q.claimable()] == [j.id]
        q.update(j.id, not_before=time.time() + 3600)
        assert q.claimable() == []

    def test_gc_keeps_active_and_newest_terminal(self, storage):
        q = JobQueue(storage)
        jobs = []
        for _ in range(5):
            jobs.append(q.submit(VARIANT))
            time.sleep(0.002)
        q.update(jobs[0].id, status="completed")
        q.update(jobs[1].id, status="failed")
        q.update(jobs[2].id, status="completed")
        q.update(jobs[3].id, status="running")
        assert q.gc(keep=1) == [jobs[0].id, jobs[1].id]
        assert {j.id for j in q.list()} == {jobs[2].id, jobs[3].id, jobs[4].id}

    def test_queue_survives_reopen(self, storage):
        j = JobQueue(storage).submit(VARIANT)
        assert JobQueue(storage).get(j.id).variant == VARIANT

    def test_other_kinds_are_not_ported(self, storage):
        """"train" and "eval" are the job kinds, as in the JAX package."""
        with pytest.raises(ValueError, match="unknown job kind 'serve'"):
            JobQueue(storage).submit(VARIANT, kind="serve")
        assert JobQueue(storage).submit(VARIANT, kind="eval").kind == "eval"


def test_jobs_are_listed_alike_by_both_queues(tmp_path):
    ts, js = _storage(tmp_path / "s"), _jax_storage(tmp_path / "s")
    q, jq = JobQueue(ts), jsched.JobQueue(js)
    mine = q.submit(VARIANT, timeout_s=30, period_s=3600, max_attempts=2)
    theirs = jq.submit(dict(VARIANT, id="jlc"), tenant="t1")
    q.update(mine.id, status="running", attempt=1, heartbeat_at=12.5)
    assert {j.id: j.to_dict() for j in jq.list()} == {j.id: j.to_dict() for j in q.list()}
    assert jq.get(mine.id).to_dict() == q.get(mine.id).to_dict()
    assert q.get(theirs.id).tenant == "t1" and q.get(theirs.id).kind == "train"
    # an eval shard of the port's engine is claimable here; one of the JAX
    # package's engine stays in the queue for a JAX worker
    shard = jq.submit(dict(VARIANT, id="shard"), kind="eval")
    jq.submit(dict(VARIANT, id="jshard", engineFactory="predictionio_tpu.engines."
                   "recommendation.RecommendationEngine"), kind="eval")
    sched = TrainScheduler(ts, SchedulerConfig(device="cpu"))
    assert {j.id: j.kind for j in sched._claimable()} == {
        theirs.id: "train", shard.id: "eval"}  # `mine` is running


def test_jax_engine_jobs_stay_queued_for_a_jax_worker(tmp_path):
    ts, js = _storage(tmp_path / "s"), _jax_storage(tmp_path / "s")
    jax_variant = dict(VARIANT, id="jlc",
                       engineFactory="predictionio_tpu.engines.recommendation."
                                     "RecommendationEngine")
    theirs = jsched.JobQueue(js).submit(jax_variant)
    sched = TrainScheduler(ts, _scheduler_config(tmp_path))
    assert sched.run_pending_once() == 0
    left = JobQueue(ts).get(theirs.id)
    assert left.status == "queued" and left.attempt == 0 and left.generation == 0
    assert [j.id for j in jsched.JobQueue(js).claimable()] == [theirs.id]


# ---------------------------------------------------------------------------
# the scheduler and its subprocess (JAX: TestSchedulerSubprocess,
# TestSchedulerConcurrency)
# ---------------------------------------------------------------------------


class TestSchedulerSubprocess:
    def test_job_trains_and_registers_version(self, storage, tmp_path, capsys):
        _seed_app(storage)
        q = JobQueue(storage)
        job = q.submit(VARIANT)
        sched = TrainScheduler(storage, _scheduler_config(tmp_path))
        sched.start()
        try:
            _wait_for(lambda: q.get(job.id).status == "completed", timeout=90,
                      what="job completion")
        finally:
            sched.stop()
        done = q.get(job.id)
        assert done.instance_id and done.model_version and done.attempt == 1
        assert done.log_path and os.path.exists(done.log_path)
        inst = storage.get_meta_data_engine_instances().get(done.instance_id)
        assert inst is not None and inst.status == "COMPLETED"
        version = ModelRegistry(storage).get(done.model_version)
        assert version.status == "trained" and version.instance_id == done.instance_id
        assert version.job_id == job.id
        assert set(version.train_metrics["stage_timings"]) == {
            "read", "prepare", "train", "persist"}
        with open(done.log_path) as f:
            text = f.read()
        assert "ALS train staged StagedWindowedTrain" in text
        assert re.search(r"kernel launches: dense row 0, col 0; windowed partials 0, "
                         r"combine 0", text)  # the CPU runs the plain versions

    def test_job_version_carries_the_device_profile(self, storage, tmp_path):
        """The worker registers the child's device profile with the
        version: the windowed train's loop, one call, on the CPU here."""
        _seed_app(storage)
        q = JobQueue(storage)
        job = q.submit(VARIANT)
        assert TrainScheduler(storage, _scheduler_config(tmp_path)).run_pending_once() == 1
        version = ModelRegistry(storage).get(q.get(job.id).model_version)
        prof = version.devprof
        rows = {r["name"]: r for r in prof["executables"]}
        assert rows["als.train_windowed"]["invocations"] == 1
        assert rows["als.train_windowed"]["flops_total"] > 0
        assert rows["als.train_windowed"]["device_seconds"] > 0
        assert prof["platform"]["platform"] == "cpu"
        assert set(prof) == {"platform", "executables", "totals", "padding"}

    def test_worker_crash_requeues_and_completes(self, storage, tmp_path):
        _seed_app(storage)
        q = JobQueue(storage)
        job = q.submit(_slow(2.0), max_attempts=3)
        cfg = _scheduler_config(tmp_path)
        sched1 = TrainScheduler(storage, cfg)
        sched1.start()
        try:
            _wait_for(lambda: q.get(job.id).status == "running", timeout=30,
                      what="job to start")
            time.sleep(0.5)
        finally:
            sched1.stop(kill_child=True)
        assert q.get(job.id).status == "running"  # nobody cleaned up
        time.sleep(cfg.stale_after_s + 0.2)
        sched2 = TrainScheduler(storage, cfg)
        assert sched2.resume_orphans() == [job.id]
        assert q.get(job.id).status == "queued"
        sched2.start()
        try:
            _wait_for(lambda: q.get(job.id).status == "completed", timeout=120,
                      what="re-queued job completion")
        finally:
            sched2.stop()
        done = q.get(job.id)
        assert done.attempt == 2 and done.model_version
        assert [v.id for v in ModelRegistry(storage).list()
                if v.job_id == job.id] == [done.model_version]

    def test_timeout_kills_and_fails_after_attempts(self, storage, tmp_path):
        _seed_app(storage)
        q = JobQueue(storage)
        job = q.submit(_slow(30.0), timeout_s=3.0, max_attempts=1)
        sched = TrainScheduler(storage, _scheduler_config(tmp_path))
        assert sched.run_pending_once() == 1
        done = q.get(job.id)
        assert done.status == "failed" and "timeout" in (done.last_error or "")
        assert ModelRegistry(storage).list() == []

    def test_train_failure_fails_fast_no_retry(self, storage, tmp_path):
        _seed_app(storage)
        q = JobQueue(storage)
        job = q.submit(_slow(error=True), max_attempts=3)
        TrainScheduler(storage, _scheduler_config(tmp_path)).run_pending_once()
        done = q.get(job.id)
        assert done.status == "failed" and done.attempt == 1
        with open(done.log_path, errors="replace") as f:
            assert "dirty" in f.read()

    def test_periodic_retrain_enqueues_next_run(self, storage, tmp_path):
        _seed_app(storage)
        q = JobQueue(storage)
        job = q.submit(VARIANT, period_s=3600.0)
        TrainScheduler(storage, _scheduler_config(tmp_path)).run_pending_once()
        assert q.get(job.id).status == "completed"
        [nxt] = q.list(status="queued")
        assert nxt.variant == VARIANT and nxt.period_s == 3600.0
        assert nxt.not_before > time.time() + 3000
        assert q.claimable() == []

    def test_child_without_a_card_fails_its_job(self, storage, tmp_path):
        """With no device in its spec the child resolves the first CUDA
        device; without one it exits as a train failure, never falling
        back to the CPU, and the job fails at once."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        _seed_app(storage)
        q = JobQueue(storage)
        job = q.submit(VARIANT, max_attempts=3)
        TrainScheduler(storage, _scheduler_config(tmp_path, device=None)).run_pending_once()
        done = q.get(job.id)
        assert done.status == "failed" and done.attempt == 1
        assert ModelRegistry(storage).list() == []
        with open(done.log_path) as f:
            assert "no CUDA device is available" in f.read()

    def test_retried_job_adopts_its_version(self, storage, tmp_path):
        """A retry of a job whose earlier attempt registered a version
        (and lost only its receipt) adopts it: no second train, no second
        version."""
        _seed_app(storage)
        q = JobQueue(storage)
        job = q.submit(VARIANT)
        inst = tcore.run_train(storage, VARIANT, device="cpu")
        v = ModelRegistry(storage).register(inst, job_id=job.id)
        TrainScheduler(storage, _scheduler_config(tmp_path)).run_pending_once()
        done = q.get(job.id)
        assert done.status == "completed"
        assert (done.model_version, done.instance_id) == (v.id, inst.id)
        assert len(ModelRegistry(storage).list()) == 1
        assert len(storage.get_meta_data_engine_instances().get_all()) == 1
        with open(done.log_path) as f:
            assert "adopting already-registered version" in f.read()


class TestSchedulerConcurrency:
    def test_two_engines_run_concurrently(self, storage, tmp_path):
        _seed_app(storage)
        q = JobQueue(storage)
        ja, jb = q.submit(_slow(3.0, "lcslowa")), q.submit(_slow(3.0, "lcslowb"))
        sched = TrainScheduler(storage, _scheduler_config(tmp_path, max_concurrent=2))
        sched.start()
        try:
            _wait_for(lambda: len(q.list(status="running")) == 2, timeout=60,
                      what="both engines training concurrently")
            _wait_for(lambda: all(q.get(j.id).status == "completed" for j in (ja, jb)),
                      timeout=120, what="both jobs completing")
        finally:
            sched.stop()

    def test_same_engine_serializes(self, storage, tmp_path):
        _seed_app(storage)
        q = JobQueue(storage)
        j1, j2 = q.submit(_slow(1.0)), q.submit(_slow(1.0))
        sched = TrainScheduler(storage, _scheduler_config(tmp_path, max_concurrent=2))
        max_running = 0
        sched.start()
        try:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                max_running = max(max_running, len(q.list(status="running")))
                if all(q.get(j.id).status == "completed" for j in (j1, j2)):
                    break
                time.sleep(0.05)
        finally:
            sched.stop()
        assert all(q.get(j.id).status == "completed" for j in (j1, j2))
        assert max_running <= 1, f"same-engine jobs overlapped ({max_running})"


# ---------------------------------------------------------------------------
# warm start through the engine
# ---------------------------------------------------------------------------


def _td(storage):
    return teng.RecommendationDataSource(teng.DataSourceParams(APP, event_names=("rate",))
                                         ).read_training(RuntimeContext(storage=storage,
                                                                        device="cpu"))


def _warm_ctx(storage, rank=4, with_instance=True):
    """A train context like run_train's: an INIT instance row of the
    variant."""
    inst = _instance("", variant="lc", status="INIT")
    inst.id = storage.get_meta_data_engine_instances().insert(inst)
    return RuntimeContext(storage=storage, device="cpu",
                          instance_id=inst.id if with_instance else "")


def test_warm_start_init_answers_none_or_the_live_factors(storage, caplog):
    _seed_app(storage)
    td = _td(storage)
    algo = teng.ALSAlgorithm(teng.ALSAlgorithmParams(rank=4, warm_start=True))
    p4 = als.ALSParams(rank=4)
    assert algo._warm_start_init(_warm_ctx(storage), td, p4) is None  # no live version
    parent = tcore.run_train(storage, VARIANT, device="cpu")
    v = ModelRegistry(storage).register(parent)
    assert algo._warm_start_init(_warm_ctx(storage), td, p4) is None  # trained, not live
    ModelRegistry(storage).promote(v.id)
    assert algo._warm_start_init(_warm_ctx(storage), td, als.ALSParams(rank=5)) is None
    assert algo._warm_start_init(_warm_ctx(storage, with_instance=False), td, p4) is None
    cold = teng.ALSAlgorithm(teng.ALSAlgorithmParams(rank=4))
    assert cold._warm_start_init(_warm_ctx(storage), td, p4) is None
    with caplog.at_level("INFO"):
        got = algo._warm_start_init(_warm_ctx(storage), td, p4)
    assert f"warm-starting train from live version {v.id}" in caplog.text
    [model] = tcore.deserialize_models(
        storage.get_model_data_models().get(parent.id).models)
    want = als.warm_start_factors(model.factors, td.user_vocab, td.item_vocab, p4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a broken live blob: a cold start, logged at WARNING
    storage.get_model_data_models().insert(Model(id=parent.id, models=b"junk"))
    with caplog.at_level("WARNING"):
        assert algo._warm_start_init(_warm_ctx(storage), td, p4) is None
    assert "warm start unavailable; using cold init" in caplog.text


def test_lifecycle_params_train_and_shard_serving_is_refused(storage):
    _seed_app(storage)
    variant = dict(VARIANT, algorithms=[{"name": "als", "params": {
        "rank": 4, "num_iterations": 2, "checkpoint_every": 1, "warm_start": True}}])
    inst = tcore.run_train(storage, variant, device="cpu")
    assert inst.status == "COMPLETED"
    assert teng.ALSAlgorithmParams.NOT_PORTED == ("shard_serving",)
    with pytest.raises(ParamsError, match="not ported"):
        tcore.run_train(storage, dict(VARIANT, algorithms=[
            {"name": "als", "params": {"shard_serving": True}}]), device="cpu")


# ---------------------------------------------------------------------------
# console
# ---------------------------------------------------------------------------


def _run(main, argv, capsys):
    try:
        code = main(argv)
        extra = ""
    except SystemExit as e:
        code, extra = (1, f"{e.code}\n") if isinstance(e.code, str) else (e.code, "")
    out, err = capsys.readouterr()
    return code, out, err + extra


def _jax_main(argv):
    from predictionio_tpu.tools import console as jconsole

    JStorage.set_instance(None)
    try:
        return jconsole.main(argv)
    finally:
        JStorage.set_instance(None)


def test_console_jobs_and_models(tmp_path, monkeypatch, capsys):
    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)
    base = tmp_path / "pio"
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    monkeypatch.setenv("PYTHONPATH", REPO_DIR)
    _seed_app(Storage())
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(VARIANT))
    logs = str(tmp_path / "jobs")
    ids = []
    for _ in range(2):
        code, out, _ = _run(console.main, ["jobs", "submit", "--variant",
                                           str(engine_json)], capsys)
        assert code == 0 and "[INFO] submitted train job job-" in out
        ids.append(re.search(r"job-[0-9a-f]{12}", out).group())
    code, out, _ = _run(console.main, ["jobs", "worker", "--once", "--device", "cpu",
                                       "--log-dir", logs], capsys)
    assert (code, out) == (0, "[INFO] ran 2 pending job(s)\n")
    code, out, _ = _run(console.main, ["jobs", "list"], capsys)
    assert code == 0 and out.count("[completed]") == 2
    assert _run(_jax_main, ["jobs", "list"], capsys) == (0, out, "")
    code, out, _ = _run(console.main, ["jobs", "show", ids[0]], capsys)
    assert json.loads(out)["status"] == "completed"
    code, out, _ = _run(console.main, ["jobs", "logs", ids[0]], capsys)
    assert code == 0 and "--- attempt 1" in out and "→ model version mv-" in out
    code, out, err = _run(console.main, ["jobs", "show", "job-nope"], capsys)
    assert code == 1 and "[ERROR] no job 'job-nope'" in err

    code, out, _ = _run(console.main, ["models", "list"], capsys)
    assert code == 0 and out.count("[trained]") == 2
    assert _run(_jax_main, ["models", "list"], capsys) == (0, out, "")
    v_old, v_new = re.findall(r"mv-[0-9a-f]{12}", out)[::-1]  # newest first
    code, out, _ = _run(console.main, ["models", "promote", v_old], capsys)
    assert (code, out) == (0, f"[INFO] {v_old} is now live\n")
    code, out, _ = _run(console.main, ["models", "list", "--status", "live"], capsys)
    assert v_old in out and v_new not in out
    code, out, _ = _run(console.main, ["models", "rollback", v_new, "--reason",
                                       "bad"], capsys)
    assert (code, out) == (0, f"[INFO] {v_new} marked rolled_back\n")
    code, out, _ = _run(console.main, ["models", "show", v_new], capsys)
    assert json.loads(out)["reason"] == "bad"
    assert _run(_jax_main, ["models", "show", v_new], capsys) == (0, out, "")
    code, out, _ = _run(console.main, ["models", "gc", "--keep", "0"], capsys)
    assert (code, out) == (0, f"[INFO] collected 1 version(s): {v_new}\n")
    code, out, _ = _run(console.main, ["jobs", "gc", "--keep", "1"], capsys)
    assert (code, out) == (0, f"[INFO] purged 1 terminal job record(s): {ids[0]}\n")
    code, out, err = _run(console.main, ["models", "show", "mv-nope"], capsys)
    assert code == 1 and "no model version 'mv-nope'" in err
