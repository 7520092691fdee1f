"""Partitioned reads (``EventQuery.shard``) in every ported store, on the
CPU, against the JAX package's stores.

The unit layer of the JAX tests/test_partitioned_reads.py over the
port's memory, sqlite, segmentfs (sealed rows and the tail) and remote
(the port's client and daemon; the JAX client and daemon beside them)
stores, each fed the same seeded events with explicit ids as its JAX
counterpart:

- n shards partition ``find`` exactly, each entity's events land in one
  shard, and each partition holds the JAX store's events;
- ``find_frame`` under a shard (``EventFrame.from_events`` of the find
  where the store has no columnar read) equals the JAX frame, column
  for column;
- ``find_since`` under a shard equals the JAX tail;
- the wire round trip keeps ``shard``;
- ``SegmentStager`` keys its sealed prefix by the shard, and the
  replicated store's read view routes a shard-scoped read to the
  replica.

The two-process partitioned train of the JAX file waits for the port's
multi-process train.
"""

import contextlib
import datetime as dt

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data import event as jevent  # noqa: E402
from predictionio_tpu.data.storage import base as jbase  # noqa: E402
from predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from predictionio_tpu.data.storage import wire as jwire  # noqa: E402
from predictionio_tpu.data.store.columnar import EventFrame as JFrame  # noqa: E402
from predictionio_tpu_torch.data import event as tevent  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from predictionio_tpu_torch.data.storage import wire  # noqa: E402
from predictionio_tpu_torch.data.storage.memory import MemoryEventStore  # noqa: E402
from predictionio_tpu_torch.data.storage.replication import ReplicaReadStorage  # noqa: E402
from predictionio_tpu_torch.data.store.columnar import EventFrame  # noqa: E402

from test_torch_remote_storage import _daemon  # noqa: E402

PKG = {"port": (tevent, tbase, treg, EventFrame), "jax": (jevent, jbase, jreg, JFrame)}
KINDS = ["memory", "sqlite", "segmentfs", "remote"]
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _config(pkg, kind, path, daemon_port=None):
    reg = PKG[pkg][2]
    src = {
        "memory": ("memory", {}),
        "sqlite": ("sqlite", {"PATH": str(path / "s.db")}),
        "segmentfs": ("segmentfs", {"PATH": str(path / "seg"), "SEAL_INTERVAL_S": "3600"}),
        "remote": ("remote", {"HOST": "127.0.0.1", "PORT": str(daemon_port)}),
    }[kind]
    return reg.StorageConfig(
        sources={"S": reg.SourceConfig("S", *src), "M": reg.SourceConfig("M", "memory", {})},
        repositories={"METADATA": "M", "EVENTDATA": "S", "MODELDATA": "M"})


def _rows(n=90):
    """Ratings of 17 users on 5 items (and a few views), half of them at
    one time stamp, with explicit ids."""
    rng = np.random.RandomState(4)
    return [dict(event="rate" if i % 7 else "view", entity_type="user",
                 entity_id=f"u{i % 17}", target_entity_type="item",
                 target_entity_id=f"i{rng.randint(0, 5)}",
                 properties={"rating": float(rng.randint(1, 6))},
                 event_time=T0 + dt.timedelta(seconds=i % 2 * i), event_id=f"e{i:04d}")
            for i in range(n)]


@contextlib.contextmanager
def _stores(kind, tmp_path):
    """{pkg: event store} of `kind`, each seeded with `_rows()` (over
    segmentfs the first half sealed, the rest in the tail)."""
    daemons, out = [], {}
    try:
        for pkg in PKG:
            path = tmp_path / pkg
            path.mkdir(parents=True)
            port = None
            if kind == "remote":
                daemons.append(_daemon(pkg, path / "daemon"))
                port = daemons[-1].port
            store = PKG[pkg][2].Storage(_config(pkg, kind, path, port)).get_events()
            store.init_app(1)
            events = [PKG[pkg][0].Event(**r) for r in _rows()]
            store.insert_batch(events[:45], 1)
            if kind == "segmentfs":
                store.seal(1)
            store.insert_batch(events[45:], 1)
            out[pkg] = store
        yield out
    finally:
        for store in out.values():
            if hasattr(store, "close"):
                store.close()
        for d in daemons:
            d.shutdown()


def _query(pkg, **kw):
    return PKG[pkg][1].EventQuery(app_id=1, **kw)


def _frame(pkg, store, query):
    fast = getattr(store, "find_frame", None)
    if fast is not None:
        return fast(query, value_prop="rating")
    return PKG[pkg][3].from_events(store.find(query), value_prop="rating")


def _frame_tuple(f):
    return (f.event_code.tolist(), f.entity_idx.tolist(), f.target_idx.tolist(),
            f.time_ms.tolist(), f.value.tobytes(), f.event_vocab.to_dict(),
            f.entity_vocab.to_dict(), f.target_vocab.to_dict())


@pytest.mark.parametrize("kind", KINDS)
def test_disjoint_and_complete(kind, tmp_path):
    """The n shards of a find partition it exactly, each entity's events
    land in one shard, and each partition is the JAX store's."""
    with _stores(kind, tmp_path) as st:
        store = st["port"]
        full = [e.event_id for e in store.find(_query("port"))]
        assert len(full) == 90
        for n in (2, 3, 4):
            seen: dict[str, int] = {}
            union: list[str] = []
            for s in range(n):
                part = list(store.find(_query("port", shard=(s, n))))
                want = [e.event_id for e in st["jax"].find(_query("jax", shard=(s, n)))]
                assert [e.event_id for e in part] == want, (kind, n, s)
                for e in part:
                    assert tbase.shard_of(e.entity_id, n) == s
                    assert seen.setdefault(e.entity_id, s) == s
                union.extend(e.event_id for e in part)
            assert sorted(union) == sorted(full), (kind, n)
        # with the other filters, reversed and cut to a limit
        q = dict(shard=(1, 3), event_names=["rate"], reversed=True, limit=5)
        assert [e.event_id for e in store.find(_query("port", **q))] == \
            [e.event_id for e in st["jax"].find(_query("jax", **q))]


@pytest.mark.parametrize("kind", KINDS)
def test_find_frame_sharded(kind, tmp_path):
    with _stores(kind, tmp_path) as st:
        total = len(_frame("port", st["port"], _query("port")).entity_idx)
        got = 0
        for s in range(4):
            frames = {pkg: _frame(pkg, st[pkg], _query(pkg, shard=(s, 4))) for pkg in PKG}
            assert _frame_tuple(frames["port"]) == _frame_tuple(frames["jax"]), (kind, s)
            got += len(frames["port"].entity_idx)
        assert got == total == 90
        # the columnar read's shard filter with the event filter
        q = {pkg: _query(pkg, shard=(2, 3), event_names=["rate"], entity_type="user")
             for pkg in PKG}
        assert _frame_tuple(_frame("port", st["port"], q["port"])) == _frame_tuple(
            _frame("jax", st["jax"], q["jax"]))


@pytest.mark.parametrize("kind", KINDS)
def test_find_since_sharded(kind, tmp_path):
    with _stores(kind, tmp_path) as st:
        for shard in ((0, 2), (1, 2), (2, 3)):
            for after, limit in ((0, None), (40, None), (10, 7)):
                got = st["port"].find_since(1, after, limit=limit, shard=shard)
                want = st["jax"].find_since(1, after, limit=limit, shard=shard)
                assert [(e.revision, e.event_id) for e in got] == \
                    [(e.revision, e.event_id) for e in want], (kind, shard, after, limit)
                assert all(tbase.shard_of(e.entity_id, shard[1]) == shard[0] for e in got)


def test_wire_round_trip():
    q = tbase.EventQuery(app_id=3, shard=(2, 5))
    q2 = wire.decode(wire.encode(q))
    assert q2.shard == (2, 5) and q2 == q
    assert wire.decode(wire.encode(tbase.EventQuery(app_id=3))).shard is None
    assert jwire.decode(wire.encode(q)).shard == (2, 5)
    assert wire.decode(jwire.encode(jbase.EventQuery(app_id=3, shard=(2, 5)))) == q


def test_segment_stager_keys_the_sealed_prefix_by_shard(tmp_path):
    from predictionio_tpu.parallel.loader import SegmentStager as JStager
    from predictionio_tpu_torch.parallel.loader import SegmentStager

    with _stores("segmentfs", tmp_path) as st:
        stagers = {"port": SegmentStager("cpu"), "jax": JStager()}
        stats = {}
        for pkg, store in st.items():
            for shard in ((0, 2), (0, 2), (1, 2), None):
                frame, staged = stagers[pkg].stage(store, _query(pkg, shard=shard),
                                                   value_prop="rating")
                assert np.asarray(staged["entity_idx"]).tolist() == frame.entity_idx.tolist()
                if shard is not None:
                    ents = frame.entity_vocab.to_dict()
                    assert ents and all(tbase.shard_of(x, 2) == shard[0] for x in ents)
            stats[pkg] = dict(stagers[pkg].stats)
        assert stats["port"] == stats["jax"]
        assert stats["port"]["sealed_restage"] == 3 and stats["port"]["sealed_reuse"] == 1


def test_replica_read_view_routes_a_shard_scoped_read():
    """A consumer beside a follower reads a replicated app's shard from
    the replica, filtered there; other apps stay on control."""

    class _Control:
        def __init__(self, events):
            self._events = events

        def get_events(self):
            return self._events

    control, replica = MemoryEventStore(), MemoryEventStore()
    rows = [tevent.Event(**r) for r in _rows(30)]
    replica.insert_batch(rows, 1)
    control.insert_batch(rows[:5], 1)
    control.insert_batch(rows[:8], 2)
    view = ReplicaReadStorage(_Control(control), replica, [1]).get_events()
    part = list(view.find(tbase.EventQuery(app_id=1, shard=(1, 2))))
    assert [e.event_id for e in part] == [
        e.event_id for e in replica.find(tbase.EventQuery(app_id=1)) if
        tbase.shard_of(e.entity_id, 2) == 1]
    tail = view.find_since(1, 0, shard=(0, 3))
    assert [e.event_id for e in tail] == [
        e.event_id for e in replica.find_since(1, 0) if tbase.shard_of(e.entity_id, 3) == 0]
    assert len(view.find_since(2, 0, shard=(0, 1))) == 8  # app 2: control
