"""The port's fleet coordinator (fleet/coordinator.py) and the scheduler's
fleet-safe claims: tests/test_fleet_coordinator.py's cases that need no
multi-host wiring, on the port's queue and scheduler, plus the refusals
of the parts not ported and the worker records read across packages.
No torch is loaded by the modules under test; the supervisions here are
faked, so no job runs."""

import tempfile
import threading
import time

import pytest

from predictionio_tpu_torch.data.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.deploy.scheduler import JobQueue, SchedulerConfig, TrainScheduler
from predictionio_tpu_torch.fleet import (
    FleetConfig,
    FleetMember,
    WorkerInfo,
    WorkerRegistry,
    fleet_status,
)


@pytest.fixture()
def storage():
    return Storage(StorageConfig.memory())


VARIANT = {"id": "eng", "engineFactory": "tests.sample_engine.factory"}


class TestCasClaims:
    def test_single_claim_wins_and_writes_generation(self, storage):
        queue = JobQueue(storage)
        job = queue.submit(VARIANT)
        token = queue.claim(job, "w1")
        assert token is not None
        queue.update(job.id, status="running", worker_id="w1", generation=1,
                     claim_token=token, heartbeat_at=time.time())
        cur = queue.get(job.id)
        assert cur.generation == 1 and cur.claim_token == token
        assert queue.is_owner(cur)

    def test_two_concurrent_claims_one_winner(self, storage):
        """Two workers bid the same generation at once, each waiting out
        the settle window: exactly one wins, and both agree which."""
        queue_a, queue_b = JobQueue(storage), JobQueue(storage)
        job = queue_a.submit(VARIANT)
        barrier = threading.Barrier(2)
        results = {}

        def claim(name, q):
            snapshot = q.get(job.id)
            barrier.wait()
            results[name] = q.claim(snapshot, name, settle_s=0.15)

        threads = [threading.Thread(target=claim, args=(n, q))
                   for n, q in (("a", queue_a), ("b", queue_b))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wins = [n for n, tok in results.items() if tok is not None]
        assert len(wins) == 1, results
        assert queue_a.claim_winner(job.id, 1) == results[wins[0]]
        assert queue_b.claim_winner(job.id, 1) == results[wins[0]]

    def test_stale_bid_generation_never_rewins(self, storage):
        queue = JobQueue(storage)
        job = queue.submit(VARIANT)
        t1 = queue.claim(job, "w1")
        assert t1 is not None
        queue.update(job.id, status="running", generation=1, claim_token=t1)
        queue.update(job.id, status="queued", generation=2, claim_token=None)
        t2 = queue.claim(queue.get(job.id), "w2")
        assert t2 is not None and t2 != t1
        assert queue.claim_winner(job.id, 3) == t2

    def test_claim_on_stale_snapshot_loses(self, storage):
        queue = JobQueue(storage)
        job = queue.submit(VARIANT)
        stale = queue.get(job.id)
        t1 = queue.claim(stale, "w1")
        assert t1 is not None
        queue.update(job.id, status="running", generation=1, claim_token=t1)
        assert queue.claim(stale, "w2") is None

    def test_fenced_heartbeat_detects_steal(self, storage):
        queue = JobQueue(storage)
        job = queue.submit(VARIANT)
        t1 = queue.claim(job, "w1")
        queue.update(job.id, status="running", generation=1, claim_token=t1,
                     heartbeat_at=time.time())
        eid, owned = queue.heartbeat_fenced(job.id, None, t1)
        assert owned and eid
        t2 = queue.claim(queue.get(job.id), "w2", intent="steal")
        assert t2 is not None
        queue.update(job.id, status="queued", generation=2, claim_token=None)
        _, owned = queue.heartbeat_fenced(job.id, eid, t1)
        assert not owned

    def test_purge_drops_claim_records(self, storage):
        queue = JobQueue(storage)
        job = queue.submit(VARIANT)
        queue.claim(job, "w1")
        assert queue.purge(job.id) >= 2
        assert queue.get(job.id) is None
        assert queue.claim_winner(job.id, 1) is None


class TestSchedulerRace:
    def _scheduler(self, storage, ran, name):
        s = TrainScheduler(storage, SchedulerConfig(claim_settle_s=0.15, poll_interval_s=0.05))
        s.worker_id = name
        s.peer_probe = lambda: 1  # peers: pay the settle window

        def fake_supervise(job, spec, result, log_path):
            ran.append((name, job.id))
            s.queue.update(job.id, status="completed", finished_at="now", claim_token=None)

        s._supervise = fake_supervise
        return s

    def test_two_schedulers_one_queue_no_double_supervision(self, storage):
        """Two schedulers drain one queue at once: every job is
        supervised by exactly one of them."""
        queue = JobQueue(storage)
        jobs = [queue.submit(VARIANT) for _ in range(4)]
        ran: list = []
        s1, s2 = self._scheduler(storage, ran, "w1"), self._scheduler(storage, ran, "w2")
        barrier = threading.Barrier(2)

        def drain(s):
            barrier.wait()
            for _ in range(8):
                s.run_pending_once()
                time.sleep(0.1)

        threads = [threading.Thread(target=drain, args=(s,)) for s in (s1, s2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        supervised = [job_id for _, job_id in ran]
        assert sorted(supervised) == sorted(j.id for j in jobs), ran
        assert len(supervised) == len(set(supervised)), f"double supervision: {ran}"

    def test_orphan_steal_is_single_winner(self, storage):
        queue = JobQueue(storage)
        job = queue.submit(VARIANT)
        t1 = queue.claim(job, "dead-worker")
        queue.update(job.id, status="running", generation=1, claim_token=t1,
                     worker_id="dead-worker", heartbeat_at=time.time() - 1000, attempt=1)
        cfg = SchedulerConfig(claim_settle_s=0.15, stale_after_s=5.0)
        s1, s2 = TrainScheduler(storage, cfg), TrainScheduler(storage, cfg)
        for s in (s1, s2):
            s.peer_probe = lambda: 1
        results = {}
        barrier = threading.Barrier(2)

        def resume(name, s):
            barrier.wait()
            results[name] = s.resume_orphans()

        threads = [threading.Thread(target=resume, args=(n, s))
                   for n, s in (("a", s1), ("b", s2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results["a"] + results["b"] == [job.id], results
        cur = queue.get(job.id)
        assert cur.status == "queued" and cur.generation == 2 and cur.attempt == 1


class TestWorkerFleet:
    def test_worker_registry_liveness(self, storage):
        reg = WorkerRegistry(storage)
        reg.upsert(WorkerInfo(id="w1", heartbeat_at=time.time()))
        reg.upsert(WorkerInfo(id="w2", heartbeat_at=time.time() - 1000))
        assert [w.id for w in reg.live(stale_after_s=10)] == ["w1"]
        assert reg.gc(stale_after_s=60) == ["w2"]
        assert [w.id for w in reg.list()] == ["w1"]

    def test_fleet_member_lifecycle_and_peers(self, storage):
        def member():
            return FleetMember(storage, scheduler_config=SchedulerConfig(poll_interval_s=0.05),
                               fleet_config=FleetConfig(heartbeat_interval_s=0.05))

        m1, m2 = member(), member()
        m1.start()
        try:
            m2.start()
            try:
                deadline = time.time() + 5
                while time.time() < deadline and not m1.peers():
                    time.sleep(0.05)
                assert [w.id for w in m1.peers()] == [m2.worker_id]
                m1._peer_cache = (0.0, 0)
                assert m1.live_peer_count() >= 1
                assert m1.scheduler._claim_settle() > 0
                status = fleet_status(storage)
                assert status["live_workers"] == 2
                assert {w["capacity"] for w in status["workers"]} == {1}
            finally:
                m2.stop()
        finally:
            m1.stop()
        assert fleet_status(storage)["workers"] == []
        m3 = FleetMember(storage)
        m3.start()
        try:
            assert m3.scheduler._claim_settle() == 0.0  # a lone worker does not wait
        finally:
            m3.stop()

    def test_crashed_member_leaves_stale_record(self, storage):
        m = FleetMember(storage, fleet_config=FleetConfig(heartbeat_interval_s=0.05))
        m.start()
        m.stop(kill_child=True)
        workers = fleet_status(storage, stale_after_s=0.0)["workers"]
        assert [w["id"] for w in workers] == [m.worker_id]
        assert workers[0]["live"] is False


class TestClaimWedgeRecovery:
    def test_dead_winning_bid_unwedges(self, storage):
        queue = JobQueue(storage)
        job = queue.submit(VARIANT)
        assert queue.claim(job, "dead-worker") is not None
        assert queue.get(job.id).status == "queued"
        assert queue.claim(queue.get(job.id), "w2") is None
        s = TrainScheduler(storage, SchedulerConfig(stale_after_s=0.05))
        time.sleep(0.1)
        s.resume_orphans()
        cur = queue.get(job.id)
        assert cur.status == "queued" and cur.generation == 2
        assert queue.claim(cur, "w3") is not None

    def test_live_bid_not_unwedged(self, storage):
        queue = JobQueue(storage)
        job = queue.submit(VARIANT)
        queue.claim(job, "live-worker")
        TrainScheduler(storage, SchedulerConfig(stale_after_s=30.0)).resume_orphans()
        assert queue.get(job.id).generation == 0


class TestEngineSerializationAcrossWorkers:
    def test_second_worker_yields_while_engine_trains_elsewhere(self, storage):
        queue = JobQueue(storage)
        job1, job2 = queue.submit(VARIANT), queue.submit(VARIANT)
        t1 = queue.claim(job1, "workerA", fields=dict(
            status="running", worker_id="workerA", started_at="2026-01-01T00:00:00",
            heartbeat_at=time.time(), attempt=1))
        assert t1 is not None
        s = TrainScheduler(storage, SchedulerConfig(poll_interval_s=0.05))
        supervised = []
        s._supervise = lambda *a, **k: supervised.append(a)
        s._run_job(queue.get(job2.id))
        assert supervised == []
        cur = queue.get(job2.id)
        assert cur.status == "queued" and cur.attempt == 0 and cur.claim_token is None
        queue.update(job1.id, status="completed", claim_token=None)
        time.sleep(0.06)
        s._supervise = lambda *a, **k: supervised.append("ran")
        s._run_job(queue.get(job2.id))
        assert supervised == ["ran"]

    def test_eval_shards_of_one_engine_run_side_by_side(self, storage):
        """Eval shards skip the engine serialization: a shard is claimed
        while a train job (and another shard) of its engine runs."""
        queue = JobQueue(storage)
        train = queue.submit(VARIANT)
        queue.claim(train, "workerA", fields=dict(
            status="running", worker_id="workerA", started_at="2026-01-01T00:00:00",
            heartbeat_at=time.time(), attempt=1))
        shards = [queue.submit(VARIANT, kind="eval") for _ in range(2)]
        s = TrainScheduler(storage, SchedulerConfig(max_concurrent=2))
        supervised = []
        s._supervise = lambda job, *a: supervised.append(job.id)
        for shard in shards:
            s._run_job(queue.get(shard.id))
        assert supervised == [j.id for j in shards]

    def test_heartbeat_resurrection_keeps_identity(self, storage):
        reg = WorkerRegistry(storage)
        reg.upsert(WorkerInfo(id="w1", heartbeat_at=time.time()))
        reg.remove("w1")
        reg.heartbeat("w1", None, 0)
        assert [w.id for w in reg.list()] == ["w1"]


class TestWorkerDeviceInfo:
    """`fleet status` scrapes each live worker's advertised /metrics for
    its device gauges (the port's cuda_* families)."""

    @staticmethod
    def _metrics_server(body: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    def test_device_families_allowlisted_and_summed(self):
        from predictionio_tpu_torch.fleet.coordinator import worker_device_info

        srv = self._metrics_server(
            'cuda_memory_allocated_bytes{device="0"} 1000\n'
            'cuda_memory_allocated_bytes{device="1"} 2345\n'
            "cuda_kernel_build_count 3\n"
            "jax_jit_compile_count 5\n"  # another package's family
            "http_requests_total 999\n")
        try:
            info = worker_device_info(f"http://127.0.0.1:{srv.server_port}/metrics")
        finally:
            srv.shutdown()
        assert info == {"cuda_memory_allocated_bytes": 3345.0, "cuda_kernel_build_count": 3.0}

    def test_unreachable_worker_yields_none(self):
        from predictionio_tpu_torch.fleet.coordinator import worker_device_info

        assert worker_device_info("http://127.0.0.1:1/metrics") is None

    def test_fleet_status_attaches_device_info(self, storage, monkeypatch):
        srv = self._metrics_server("cuda_kernel_build_count 7\n")
        monkeypatch.setenv("PIO_WORKER_METRICS_URL",
                           f"http://127.0.0.1:{srv.server_port}/metrics")
        m = FleetMember(storage, fleet_config=FleetConfig(heartbeat_interval_s=0.05))
        m.start()
        try:
            rows = fleet_status(storage)["workers"]
            assert rows[0]["device_info"] == {"cuda_kernel_build_count": 7.0}
            rows = fleet_status(storage, probe_devices=False)["workers"]
            assert "device_info" not in rows[0]
        finally:
            m.stop()
            srv.shutdown()


@pytest.mark.parametrize("env", [
    {"PIO_FLEET_COORDINATOR": "10.0.0.1:1234"},
    {"PIO_FLEET_NUM_PROCESSES": "4"},
    {"PIO_PUSH_URL": "http://127.0.0.1:1/telemetry/push"},
    {"PIO_PUSH_SPOOL": "/var/spool/pio"},
])
def test_multi_host_and_push_settings_are_refused(storage, monkeypatch, env, tmp_path):
    """The member refuses the JAX package's multi-host settings rather
    than ignore them; one process of one (the single-host default) is no
    multi-host setting. The push settings are honoured: the started
    member runs a telemetry shipper as `fleet-<worker id>`, which its
    stop joins."""
    for k in ("PIO_FLEET_COORDINATOR", "PIO_FLEET_NUM_PROCESSES", "PIO_PUSH_URL",
              "PIO_PUSH_SPOOL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_FLEET_NUM_PROCESSES", "1")
    FleetMember(storage)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if not any(k.startswith("PIO_PUSH_") for k in env):
        with pytest.raises(NotImplementedError, match="not ported"):
            FleetMember(storage)
        return
    if "PIO_PUSH_SPOOL" in env:
        monkeypatch.setenv("PIO_PUSH_SPOOL", str(tmp_path / "spool"))
    else:  # the shipper's default spool lies under the temporary directory
        monkeypatch.setenv("TMPDIR", str(tmp_path))
        monkeypatch.setattr(tempfile, "tempdir", None)
    m = FleetMember(storage, fleet_config=FleetConfig(heartbeat_interval_s=0.05))
    m.start()
    try:
        assert m._shipper is not None and m._shipper.instance == f"fleet-{m.worker_id}"
        assert any(t.name == "telemetry-shipper" for t in threading.enumerate())
    finally:
        m.stop()
    assert m._shipper is None
    assert not any(t.name == "telemetry-shipper" for t in threading.enumerate())


def test_a_distributed_config_is_refused(storage):
    with pytest.raises(NotImplementedError, match="multi-host"):
        FleetMember(storage, fleet_config=FleetConfig(distributed=object()))


def test_worker_records_read_across_packages(tmp_path):
    """A port member's worker record is the JAX package's: the JAX
    `fleet_status` over the same sqlite file lists it live, and the
    port's lists a JAX record."""
    pytest.importorskip("jax")
    from predictionio_tpu.data.storage.registry import (
        SourceConfig as JSourceConfig,
        Storage as JStorage,
        StorageConfig as JStorageConfig,
    )
    from predictionio_tpu.fleet import coordinator as jcoord
    from predictionio_tpu_torch.data.storage.registry import SourceConfig

    path = tmp_path / "pio.db"
    ts = Storage(StorageConfig(sources={"S": SourceConfig("S", "sqlite", {"PATH": str(path)})},
                               repositories={"METADATA": "S", "EVENTDATA": "S",
                                             "MODELDATA": "S"}))
    js = JStorage(JStorageConfig(sources={"S": JSourceConfig("S", "sqlite", {"PATH": str(path)})},
                                 repositories={"METADATA": "S", "EVENTDATA": "S",
                                               "MODELDATA": "S"}))
    m = FleetMember(ts, fleet_config=FleetConfig(heartbeat_interval_s=0.05,
                                                 adaptive_settle=False))
    m.start()
    try:
        jcoord.WorkerRegistry(js).upsert(jcoord.WorkerInfo(id="jax-w", host="h",
                                                           heartbeat_at=time.time()))
        jrows = {w["id"]: w for w in jcoord.fleet_status(js, probe_devices=False)["workers"]}
        trows = {w["id"]: w for w in fleet_status(ts, probe_devices=False)["workers"]}
        assert set(jrows) == set(trows) == {m.worker_id, "jax-w"}
        beat = ("heartbeat_at", "heartbeat_age_s")  # the member beats meanwhile
        for wid in trows:
            assert {k: v for k, v in trows[wid].items() if k not in beat} == \
                {k: v for k, v in jrows[wid].items() if k not in beat}
        assert trows[m.worker_id]["live"] and trows[m.worker_id]["pid"] > 0
    finally:
        m.stop()
