"""The JAX package's chaos test of the replicated event store
(``tests/test_replication_e2e.py``) on the port: a port primary storage
daemon, a subprocess with its shipper at MIN_ACKS 1, is SIGKILLed
mid-ingest under four writers while a fold-in consumer tails follower A.
An elected follower must hold every acknowledged event once, the zombie
primary's epoch must be fenced on both survivors, and the consumer must
resume exactly once on the follower, with ``replication_ship_total`` and
``replication_lag_revisions`` observable throughout. Each wait has a
deadline of its own."""

import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from predictionio_tpu_torch.data.api.storage_server import StorageServer
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import StorageError
from predictionio_tpu_torch.data.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.data.storage.replication import (
    FollowerLink,
    ReplicaReadStorage,
    ReplicationConfig,
    SegmentShipper,
    elect_and_promote,
)
from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore
from predictionio_tpu_torch.obs.registry import get_default_registry
from predictionio_tpu_torch.online.consumer import (
    OnlineConsumer,
    OnlineConsumerConfig,
)
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.resilience.breaker import reset_breakers

REPO = Path(__file__).resolve().parent.parent
APP = 3


@pytest.fixture(autouse=True)
def _clean_faults_and_breakers():
    faults.clear()
    reset_breakers()
    yield
    faults.clear()
    reset_breakers()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_health(port, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/health", timeout=2
            ) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"storage daemon on :{port} never became healthy")


def _metrics(port: int) -> str:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=5
    ) as r:
        return r.read().decode()


def _spawn_primary(tmp_path, port, follower_ports):
    """The port's primary storage daemon in a subprocess: segmentfs
    events sealed every 200 (segments ship during the test as well as
    WAL frames) and the shipper at MIN_ACKS 1, so that every acknowledged
    insert reached a follower before the client saw the ack."""
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
        "PIO_STORAGE_SOURCES_SEG_TYPE": "segmentfs",
        "PIO_STORAGE_SOURCES_SEG_PATH": str(tmp_path / "primary"),
        "PIO_STORAGE_SOURCES_SEG_SEAL_EVENTS": "200",
        "PIO_STORAGE_SOURCES_SEG_SEAL_INTERVAL_S": "0.05",
        "PIO_STORAGE_SOURCES_SEG_SEAL_AGE_S": "0.05",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SEG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_REPL_FOLLOWERS": ",".join(
            f"127.0.0.1:{p}" for p in follower_ports
        ),
        "PIO_REPL_MIN_ACKS": "1",
        "PIO_REPL_SHIP_INTERVAL_S": "0.05",
        "PIO_REPL_EPOCH": "1",
    })
    return subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.data.api.storage_server",
         "--host", "127.0.0.1", "--port", str(port)],
        env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )


def _follower_storage(tmp_path, name) -> Storage:
    return Storage(StorageConfig(
        sources={
            "REP": SourceConfig("REP", "segmentfs-replica", {
                "PATH": str(tmp_path / name),
                "SEAL_INTERVAL_S": "3600",
            }),
            "M": SourceConfig("M", "memory", {}),
        },
        repositories={
            "METADATA": "M", "EVENTDATA": "REP", "MODELDATA": "M",
        },
    ))


def _remote_storage(port: int) -> Storage:
    return Storage(StorageConfig(
        sources={
            "RMT": SourceConfig("RMT", "remote", {
                "HOST": "127.0.0.1", "PORT": str(port),
                "RETRY_ATTEMPTS": "2", "RETRY_BASE_DELAY": "0.01",
                "BREAKER_THRESHOLD": "2", "BREAKER_COOLDOWN": "0.3",
            }),
        },
        repositories={
            "METADATA": "RMT", "EVENTDATA": "RMT", "MODELDATA": "RMT",
        },
    ))


def _mem_storage() -> Storage:
    return Storage(StorageConfig(
        sources={"M": SourceConfig("M", "memory", {})},
        repositories={
            "METADATA": "M", "EVENTDATA": "M", "MODELDATA": "M",
        },
    ))


class _StubHost:
    scope = "server"

    def __init__(self):
        self.runtime = object()

    def current(self):
        return self.runtime

    def swap(self, old, new):
        if self.runtime is old:
            self.runtime = new
            return True
        return False


BATCH = 16


def _hammer(port, writer_id, acked, stop):
    """One writer: acked batch inserts until the primary dies. An
    insert_batch that returns acked the WHOLE batch (min_acks=1 held it
    until a follower applied the frame); ids of a raised batch are
    un-acked — the zero-loss contract covers only ids appended to
    `acked` BEFORE the exception."""
    store = _remote_storage(port).get_events()
    k = 0
    while not stop.is_set():
        eids = [f"w{writer_id}-{k + j}" for j in range(BATCH)]
        try:
            store.insert_batch([Event(
                event="rate", entity_type="user", entity_id=eid,
                target_entity_type="item", target_entity_id=f"i{k % 7}",
                properties={"rating": float(k % 5 + 1)},
            ) for eid in eids], APP)
        except Exception:
            return  # primary gone (or under-replicated ack) — stop
        acked.extend(eids)
        k += BATCH


def test_primary_kill9_failover_zero_loss(tmp_path):
    p_primary, p_a, p_b = _free_port(), _free_port(), _free_port()
    storage_a = _follower_storage(tmp_path, "replicaA")
    storage_b = _follower_storage(tmp_path, "replicaB")
    store_a, store_b = storage_a.get_events(), storage_b.get_events()
    store_a.init_app(APP)
    store_b.init_app(APP)
    srv_a = StorageServer(storage_a, host="127.0.0.1", port=p_a).start()
    srv_b = StorageServer(storage_b, host="127.0.0.1", port=p_b).start()
    proc = _spawn_primary(tmp_path, p_primary, [p_a, p_b])
    consumer = None
    consumer2 = None
    try:
        _wait_health(p_primary)
        ctl = _mem_storage()
        records = LifecycleRecordStore(ctl)

        # a live fold-in consumer reading from follower A (a cursor named
        # for the replica; the cursor records stay on control)
        consumer = OnlineConsumer(
            ReplicaReadStorage(ctl, store_a, [APP]), _StubHost(), APP,
            OnlineConsumerConfig(
                tick_s=3600, name=f"online/{APP}/replica-a"
            ),
        )

        # multi-writer hammer against the primary daemon
        acked: list[str] = []
        stop = threading.Event()
        writers = [
            threading.Thread(
                target=_hammer, args=(p_primary, w, acked, stop),
                daemon=True,
            )
            for w in range(4)
        ]
        for t in writers:
            t.start()
        deadline = time.time() + 40
        while len(acked) < 600 and time.time() < deadline:
            time.sleep(0.05)
            consumer.tick()  # consuming WHILE the hammer runs
        assert len(acked) >= 600, "hammer never reached takeoff"
        # replication is observable on the primary's /metrics while it
        # is still alive — WAL frames (sync hook) must have shipped, and
        # with SEAL_EVENTS=200 whole segments must have shipped too
        m = _metrics(p_primary)
        assert "replication_ship_total" in m
        assert 'kind="wal"' in m and 'kind="segment"' in m

        # ---- kill -9 mid-ingest, writers still hammering -----------------
        proc.kill()
        proc.wait(timeout=10)
        stop.set()
        for t in writers:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in writers), "a writer hung"
        n_acked = len(acked)
        assert n_acked >= 600

        # ---- fenced failover: both followers stand concurrently ----------
        link_a = FollowerLink(f"127.0.0.1:{p_a}", timeout_s=10.0)
        link_b = FollowerLink(f"127.0.0.1:{p_b}", timeout_s=10.0)
        dead = FollowerLink(f"127.0.0.1:{p_primary}", timeout_s=10.0)
        results = {}
        barrier = threading.Barrier(2)

        def _stand(name, store, peers):
            barrier.wait()
            results[name] = elect_and_promote(
                records, store, name, peers=peers, settle_s=0.3
            )

        ca = threading.Thread(
            target=_stand, args=("replica-a", store_a, [link_b, dead])
        )
        cb = threading.Thread(
            target=_stand, args=("replica-b", store_b, [link_a, dead])
        )
        ca.start()
        cb.start()
        ca.join(timeout=30)
        cb.join(timeout=30)
        assert not ca.is_alive() and not cb.is_alive(), "an election hung"
        winners = [n for n, gen in results.items() if gen is not None]
        assert len(winners) == 1, f"split brain: {results}"
        winner = store_a if winners[0] == "replica-a" else store_b
        loser = store_b if winner is store_a else store_a
        assert results[winners[0]] == 2  # epoch 1 was the dead primary's
        assert winner.role == "primary" and winner.epoch == 2

        # the winner was gated on being at least as caught up as every
        # reachable peer, and watermarks are contiguous prefixes — so
        # every acked event is there, exactly once
        ids = [e.entity_id for e in winner.find_since(APP, 0)]
        assert len(ids) == len(set(ids)), "double-delivered revisions"
        missing = set(acked) - set(ids)
        assert not missing, f"lost {len(missing)} acked events"

        # ---- promoted follower serves writes immediately -----------------
        winner.insert_batch([Event(
            event="rate", entity_type="user", entity_id="post-failover",
            target_entity_type="item", target_entity_id="i1",
            properties={"rating": 5.0},
        )], APP)

        # ---- re-replicate: winner ships to the surviving follower -------
        loser_port = p_b if loser is store_b else p_a
        sh2 = SegmentShipper(
            winner,
            ReplicationConfig(
                followers=(f"127.0.0.1:{loser_port}",), timeout_s=10.0
            ),
            epoch=2,
        )
        deadline = time.time() + 30
        while time.time() < deadline:
            sh2.pass_once()
            if loser.replication_lag(APP)["lag"] == 0 and \
                    loser.latest_revision(APP) == \
                    winner.latest_revision(APP):
                break
            time.sleep(0.05)
        assert loser.latest_revision(APP) == winner.latest_revision(APP)
        assert loser.epoch == 2  # adopted from the epoch-2 frames

        # ---- zombie fencing ----------------------------------------------
        # a zombie primary's late epoch-1 frame is un-replayable on BOTH
        # survivors: the promoted store refuses frames outright, the
        # follower fences the stale epoch
        zombie = (APP, None, 1, 0, [1], [[
            "z", "rate", "user", "z", "item", "i1", {}, 0, None, None, 0,
        ]], 1)
        with pytest.raises(StorageError):
            winner.replication_apply_wal(*zombie)
        with pytest.raises(StorageError, match="fenced"):
            loser.replication_apply_wal(*zombie)
        # lag is observable wherever the replica's registry renders
        assert "replication_lag_revisions" in get_default_registry().render()

        # ---- consumer resumes exactly-once on the follower ---------------
        # store_a holds the full replicated stream now (it is either the
        # winner or the caught-up loser); drain the consumer
        for _ in range(200):
            if not consumer.tick().get("consumed"):
                break
        total = store_a.latest_revision(APP)
        first_run = dict(consumer.counters)
        # every event id is unique, so exactly-once across the failover
        # means the counter equals the number of live events — no id
        # consumed twice, none skipped
        assert first_run["events_consumed"] == len(
            store_a.find_since(APP, 0)
        )
        consumer.stop()

        # restart: the durable per-replica cursor resumes — nothing is
        # re-consumed, nothing is skipped
        consumer2 = OnlineConsumer(
            ReplicaReadStorage(ctl, store_a, [APP]), _StubHost(), APP,
            OnlineConsumerConfig(
                tick_s=3600, name=f"online/{APP}/replica-a"
            ),
        )
        assert consumer2.tick().get("consumed", 0) == 0
        assert consumer2.counters["events_consumed"] == \
            first_run["events_consumed"]
        assert total == store_a.latest_revision(APP)
    finally:
        if proc.poll() is None:
            proc.kill()
        if consumer is not None:
            consumer.stop()
        if consumer2 is not None:
            consumer2.stop()
        srv_a.shutdown()
        srv_b.shutdown()
