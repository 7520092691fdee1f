"""The port's sharded event store on the CPU, against the JAX package's.

Every case of the JAX tests/test_sharded_storage.py but its two-process
train runs here through both packages, each over ``stores=`` children of
its own memory stores (or its own storage daemons) fed the same seeded
events: the two must place every event on the same shard, merge in the
same order (compared by fields: event ids are random), fail over, degrade
on the same shards, and hedge to the same answers. Also:

- the packages across one another: a JAX ``ShardedEventStore`` over two
  of the port's daemons, and the port's over two JAX daemons; asked
  directly, each daemon holds its shard only, and a ``shard=(i, 2)``
  read reaches daemon i alone (its ``storage_rpc_total``);
- the ``sharded`` source through the registry, ``Storage.get_instance``
  / ``set_instance``, ``verify_all_data_objects`` and ``console status``
  naming a down shard;
- ``insert_batch_with_req_id``'s derived per-shard request ids, which a
  daemon's dedupe replays;
- the Event Server with one shard's daemon stopped: a batch POST answers
  201 or 503 by position as the JAX server does, and a retry after the
  restart lands each event once;
- the online consumer over the three revision streams of a store at
  ``REPLICAS=2``: each event once, cursors equal to the JAX consumer's.
"""

import datetime as dt
import logging
import threading
import time
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data import event as jevent  # noqa: E402
from predictionio_tpu.data.api import server as jes  # noqa: E402
from predictionio_tpu.data.storage import base as jbase  # noqa: E402
from predictionio_tpu.data.storage import memory as jmem  # noqa: E402
from predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from predictionio_tpu.data.storage import remote as jremote  # noqa: E402
from predictionio_tpu.data.storage import sharded as jsh  # noqa: E402
from predictionio_tpu.obs import get_default_registry as jdefault_registry  # noqa: E402
from predictionio_tpu.online import consumer as jconsumer  # noqa: E402
from predictionio_tpu_torch.data import event as tevent  # noqa: E402
from predictionio_tpu_torch.data.api import server as tes  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import memory as tmem  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from predictionio_tpu_torch.data.storage import remote as tremote  # noqa: E402
from predictionio_tpu_torch.data.storage import sharded as tsh  # noqa: E402
from predictionio_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from predictionio_tpu_torch.obs.registry import get_default_registry  # noqa: E402
from predictionio_tpu_torch.online import consumer as tconsumer  # noqa: E402
from predictionio_tpu_torch.resilience import breaker as tbreaker  # noqa: E402
from predictionio_tpu_torch.resilience import faults as tfaults  # noqa: E402
from predictionio_tpu.resilience import breaker as jbreaker  # noqa: E402
from predictionio_tpu.resilience import faults as jfaults  # noqa: E402

from test_torch_remote_storage import (  # noqa: E402
    _daemon,
    _free_port,
    _metrics,
    _post,
    _spawn_daemon,
    _value,
)

UTC = dt.timezone.utc
T0 = dt.datetime(2026, 1, 1, tzinfo=UTC)


def _kinds(pkg, ev, base, mem, sh):
    """The JAX test's child stores, made of `pkg`'s memory store."""
    unreachable = base.StorageUnreachableError

    class Flaky(mem.MemoryEventStore):
        """Fails the first `fail_n` reads: a daemon mid-restart."""

        def __init__(self, fail_n=1):
            super().__init__()
            self.fail_n, self.calls = fail_n, 0

        def _maybe_fail(self):
            self.calls += 1
            if self.calls <= self.fail_n:
                raise unreachable("transient hiccup")

        def find(self, query):
            self._maybe_fail()
            return super().find(query)

        def get(self, event_id, app_id, channel_id=None):
            self._maybe_fail()
            return super().get(event_id, app_id, channel_id)

    class DeadClient:
        host, port = "10.0.0.9", 7070

        def ping(self):
            return False

    class Dead(mem.MemoryEventStore):
        """Every data call fails: a daemon that is gone."""

        def __init__(self):
            super().__init__()
            self._client = DeadClient()

        def _die(self, *_a, **_k):
            raise unreachable("connection refused")

        find = get = delete = delete_batch = insert = insert_batch = _die
        aggregate_properties = data_signature = _die

    class Togglable(mem.MemoryEventStore):
        down = False
        delay = 0.0

        def _gate(self):
            if self.down:
                raise unreachable("daemon gone")

        def find(self, query):
            self._gate()
            return super().find(query)

        def find_entities_batch(self, *a, **k):
            if self.delay:
                time.sleep(self.delay)
            self._gate()
            return super().find_entities_batch(*a, **k)

        def get(self, *a, **k):
            self._gate()
            return super().get(*a, **k)

        def insert_batch(self, *a, **k):
            self._gate()
            return super().insert_batch(*a, **k)

        def aggregate_properties(self, *a, **k):
            self._gate()
            return super().aggregate_properties(*a, **k)

    return types.SimpleNamespace(
        name=pkg, Event=ev.Event, base=base, EventQuery=base.EventQuery,
        shard_of=base.shard_of, Memory=mem.MemoryEventStore, Sharded=sh.ShardedEventStore,
        Down=sh.ShardDownError, Partial=sh.PartialBatchWriteError, Flaky=Flaky, Dead=Dead,
        Togglable=Togglable)


P = {"port": _kinds("port", tevent, tbase, tmem, tsh),
     "jax": _kinds("jax", jevent, jbase, jmem, jsh)}


@pytest.fixture(autouse=True)
def _clean_faults_and_breakers():
    for module in (tfaults, jfaults):
        module.clear()
    for module in (tbreaker, jbreaker):
        module.reset_breakers()
    yield
    for module in (tbreaker, jbreaker):
        module.reset_breakers()


def _both(run):
    """`run(p)` for each package; the two results must be equal."""
    got, want = run(P["port"]), run(P["jax"])
    assert got == want
    return got


def _events(p, n=40, seed=0):
    rng = np.random.RandomState(seed)
    return [p.Event(event="rate", entity_type="user", entity_id=f"u{i % 11}",
                    target_entity_type="item", target_entity_id=f"i{i % 5}",
                    properties={"rating": float(rng.randint(1, 6))},
                    event_time=T0 + dt.timedelta(minutes=i))
            for i in range(n)]


def _f(e):
    """An event's fields, without its (random) id and revision."""
    props = e.properties.to_dict() if hasattr(e.properties, "to_dict") else dict(e.properties)
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type, e.target_entity_id,
            tuple(sorted(props.items())), e.event_time)


def _fs(events):
    return [_f(e) for e in events]


def _held(p, child, app=1):
    """A child's events as a sorted list of fields."""
    return sorted(_fs(child.find(p.EventQuery(app_id=app))))


def _mk(p, n_shards=3, **kw):
    children = [p.Memory() for _ in range(n_shards)]
    store = p.Sharded(stores=children, **kw)
    store.init_app(1)
    return store, children


# ---------------------------------------------------------------------------
# the unit layer: routing, locality, the merge, by-id broadcast, folds
# ---------------------------------------------------------------------------


def test_routing_and_entity_locality():
    def run(p):
        store, children = _mk(p)
        ids = store.insert_batch(_events(p), 1)
        assert len(ids) == 40 and all(ids)
        for sx, child in enumerate(children):
            assert all(p.shard_of(e.entity_id, 3) == sx
                       for e in child.find(p.EventQuery(app_id=1)))
        return [_held(p, c) for c in children]

    held = _both(run)
    assert all(held) and sum(map(len, held)) == 40


def test_shard_of_is_the_jax_hash():
    ids = [f"u{i}" for i in range(500)] + ["", "ü-ñ", "x" * 300]
    for n in (1, 2, 3, 7, 64):
        assert [tbase.shard_of(i, n) for i in ids] == [jbase.shard_of(i, n) for i in ids]


def test_merged_find_is_time_ordered():
    def run(p):
        store, _ = _mk(p)
        store.insert_batch(_events(p), 1)
        got = list(store.find(p.EventQuery(app_id=1)))
        assert [e.event_time for e in got] == sorted(e.event_time for e in got)
        rev = list(store.find(p.EventQuery(app_id=1, reversed=True)))
        lim = list(store.find(p.EventQuery(app_id=1, limit=7)))
        assert [e.event_id for e in lim] == [e.event_id for e in got[:7]]
        return _fs(got), _fs(rev), _fs(lim)

    got, rev, _ = _both(run)
    assert len(got) == 40 and rev == got[::-1]


def test_entity_query_hits_one_shard():
    def run(p):
        store, children = _mk(p)
        store.insert_batch(_events(p), 1)
        got = list(store.find(p.EventQuery(app_id=1, entity_id="u3")))
        home = children[p.shard_of("u3", 3)]
        assert len(got) == len(list(home.find(p.EventQuery(app_id=1, entity_id="u3"))))
        return _fs(got)

    got = _both(run)
    assert got and all(f[2] == "u3" for f in got)


def test_partitioned_read_goes_straight_to_child():
    def run(p):
        store, children = _mk(p)
        store.insert_batch(_events(p), 1)
        for s in range(3):
            via = {e.event_id for e in store.find(p.EventQuery(app_id=1, shard=(s, 3)))}
            assert via == {e.event_id for e in children[s].find(p.EventQuery(app_id=1))}
        # a shard count other than the store's still partitions (filtered
        # a child, then merged)
        parts = [_fs(store.find(p.EventQuery(app_id=1, shard=(s, 2)))) for s in range(2)]
        assert not set(parts[0]) & set(parts[1])
        return parts

    parts = _both(run)
    assert len(parts[0]) + len(parts[1]) == 40


def test_merged_find_reads_the_shards_at_once():
    """The merged find reads each shard a page ahead on a thread of its
    own: slow shards serve one merged read at once, in the same order,
    and a reader that lets go stops the threads."""

    class Slow(tmem.MemoryEventStore):
        def find(self, query):
            for e in super().find(query):
                time.sleep(0.02)
                yield e

    children = [Slow() for _ in range(3)]
    store = tsh.ShardedEventStore(stores=children)
    store.init_app(1)
    store.insert_batch(_events(P["port"], n=60), 1)
    serial = sum(len(list(tmem.MemoryEventStore.find(c, tbase.EventQuery(app_id=1))))
                 for c in children) * 0.02
    t0 = time.monotonic()
    got = list(store.find(tbase.EventQuery(app_id=1)))
    took = time.monotonic() - t0
    assert _fs(got) == sorted(_fs(got), key=lambda f: f[-1]) and len(got) == 60
    assert took < 0.75 * serial, (took, serial)
    it = store.find(tbase.EventQuery(app_id=1))
    assert next(it) == got[0]
    del it
    deadline_at = time.monotonic() + 5
    while any(t.name.startswith("shardscan") for t in threading.enumerate()):
        assert time.monotonic() < deadline_at, "a read-ahead thread outlived its reader"
        time.sleep(0.05)


def test_get_delete_broadcast_and_signature():
    def run(p):
        store, _ = _mk(p)
        ids = store.insert_batch(_events(p), 1)
        found = _f(store.get(ids[5], 1))
        sig1 = store.data_signature(1)
        assert store.delete(ids[5], 1)
        assert store.get(ids[5], 1) is None
        assert not store.delete(ids[5], 1)
        assert store.data_signature(1) != sig1
        return found, sig1.count("|"), store.delete_batch(ids[:4], 1)

    assert _both(run)[1:] == (2, 4)


def test_aggregate_properties_union():
    def run(p):
        store, _ = _mk(p)
        store.insert_batch([p.Event(event="$set", entity_type="user", entity_id=f"u{i}",
                                    properties={"plan": f"p{i}"},
                                    event_time=T0 + dt.timedelta(seconds=i))
                            for i in range(9)], 1)
        props = store.aggregate_properties(1, "user")
        return {k: v.get("plan") for k, v in props.items()}

    got = _both(run)
    assert len(got) == 9 and got["u4"] == "p4"


# ---------------------------------------------------------------------------
# the edge cases
# ---------------------------------------------------------------------------


def test_explicit_id_insert_rehomes_across_shards():
    def run(p):
        store, children = _mk(p)
        e1 = p.Event(event="rate", entity_type="user", entity_id="u1",
                     target_entity_type="item", target_entity_id="i1", event_id="fixed-id",
                     event_time=T0)
        store.insert(e1, 1)
        other = next(f"u{k}" for k in range(50)
                     if p.shard_of(f"u{k}", 3) != p.shard_of("u1", 3))
        store.insert(p.Event(event="rate", entity_type="user", entity_id=other,
                             target_entity_type="item", target_entity_id="i2",
                             event_id="fixed-id", event_time=T0), 1)
        live = [e for e in store.find(p.EventQuery(app_id=1)) if e.event_id == "fixed-id"]
        assert len(live) == 1 and live[0].entity_id == other
        assert store.get("fixed-id", 1).entity_id == other
        store.insert_batch([e1], 1)  # a batch replay re-homes too
        live = [e for e in store.find(p.EventQuery(app_id=1)) if e.event_id == "fixed-id"]
        assert len(live) == 1 and live[0].entity_id == "u1"
        return [_held(p, c) for c in children]

    _both(run)


def test_out_of_range_shard_is_empty_not_crash():
    def run(p):
        store, _ = _mk(p)
        store.insert_batch(_events(p), 1)
        return list(store.find(p.EventQuery(app_id=1, shard=(3, 3))))

    assert _both(run) == []


def test_auth_key_and_settings_passed_to_children():
    cfg = {"SHARDS": "127.0.0.1:1,10.0.0.2:2", "AUTH_KEY": "sekrit", "TIMEOUT": "3",
           "REPLICAS": "5", "RETRIES": "4", "ALLOW_PARTIAL": "yes"}
    s = tsh.ShardedEventStore(cfg)
    j = jsh.ShardedEventStore(cfg)
    for store in (s, j):
        assert all(c._client.auth_key == "sekrit" for c in store._stores)
        # REPLICAS is capped at the shard count
        assert (store.n_shards, store.replicas, store.retries, store.allow_partial,
                store.hedged_reads) == (2, 2, 4, True, True)
    assert [s.shard_address(i) for i in range(2)] == [j.shard_address(i) for i in range(2)]
    assert s.shard_address(1) == "10.0.0.2:2"
    with pytest.raises(tbase.StorageError, match="SHARDS"):
        tsh.ShardedEventStore({})


def test_find_since_refuses_and_streams_are_per_shard():
    store, children = _mk(P["port"])
    with pytest.raises(tbase.StorageError, match="revision_streams"):
        store.find_since(1, 0)
    with pytest.raises(jbase.StorageError, match="revision_streams"):
        _mk(P["jax"])[0].find_since(1, 0)
    streams = store.revision_streams()
    assert [(k, s, sh) for k, s, sh in streams] == [
        (f"shard{i}", children[i], (i, 3)) for i in range(3)]
    assert [(k, sh) for k, _s, sh in _mk(P["jax"])[0].revision_streams()] == [
        (k, sh) for k, _s, sh in streams]


# ---------------------------------------------------------------------------
# failures: retries, attribution, degraded reads, partial writes
# ---------------------------------------------------------------------------


def _mk_with(p, bad, bad_index=1, n=3, **kw):
    children = [p.Memory() for _ in range(n)]
    children[bad_index] = bad
    store = p.Sharded(stores=children, retries=kw.pop("retries", 1), **kw)
    store.BACKOFF_BASE = 0.001
    return store, children


def test_transient_failure_retries_invisibly():
    def run(p):
        store, _ = _mk_with(p, p.Flaky(fail_n=1))
        store.init_app(1)
        ids = store.insert_batch(_events(p), 1)
        got = list(store.find(p.EventQuery(app_id=1)))
        assert store.get(ids[0], 1) is not None
        return _fs(got)

    assert len(_both(run)) == 40


def test_down_shard_error_names_the_shard():
    def run(p):
        store, children = _mk_with(p, p.Dead(), bad_index=2)
        for c in children[:2]:
            c.init_app(1)
        for e in _events(p, n=12):
            if p.shard_of(e.entity_id, 3) != 2:
                store.insert(e, 1)
        with pytest.raises(p.Down) as ei:
            list(store.find(p.EventQuery(app_id=1)))
        return ei.value.shard_index, ei.value.address, str(ei.value).split(":")[0]

    assert _both(run) == (2, "10.0.0.9:7070", "shard 2 (10.0.0.9")


def test_allow_partial_degrades_and_records():
    def run(p):
        store, children = _mk_with(p, p.Dead(), bad_index=1, allow_partial=True)
        for sx, c in enumerate(children):
            if sx != 1:
                c.init_app(1)
        live = [e for e in _events(p) if p.shard_of(e.entity_id, 3) != 1]
        for e in live:
            store.insert(e, 1)
        got = list(store.find(p.EventQuery(app_id=1)))
        assert len(got) == len(live)
        degraded = list(store.last_degraded_shards)
        props = store.aggregate_properties(1, "user")
        assert all(p.shard_of(k, 3) != 1 for k in props)
        return _fs(got), degraded, list(store.last_degraded_shards)

    _, first, second = _both(run)
    assert first == second == [1]


def test_writes_never_partial():
    def run(p):
        store, _ = _mk_with(p, p.Dead(), bad_index=1, allow_partial=True)
        bad = next(f"u{k}" for k in range(50) if p.shard_of(f"u{k}", 3) == 1)
        with pytest.raises(p.Down) as ei:
            store.insert(p.Event(event="rate", entity_type="user", entity_id=bad), 1)
        return ei.value.shard_index

    assert _both(run) == 1


def test_health_reports_per_shard():
    def run(p):
        store, _ = _mk_with(p, p.Dead(), bad_index=0)
        return [(h["shard"], h["address"], h["alive"], bool(h["error"]))
                for h in store.health()]

    assert [h[2] for h in _both(run)] == [False, True, True]


def test_partial_batch_write_reports_per_position():
    def run(p):
        children = [p.Memory(), p.Dead()]
        store = p.Sharded(stores=children, retries=0)
        children[0].init_app(1)
        events = _events(p, n=20)
        with pytest.raises(p.Partial) as ei:
            store.insert_batch(events, 1)
        ids = ei.value.ids
        assert len(ids) == 20
        for e, eid in zip(events, ids):
            assert (eid is not None) == (p.shard_of(e.entity_id, 2) == 0)
        return [i is None for i in ids], str(ei.value).split(":")[0]

    missing, msg = _both(run)
    assert any(missing) and not all(missing) and msg.startswith("bulk write failed on")


def test_batch_with_req_id_derives_one_id_a_shard():
    """The WAL's batched replay: each shard's group lands under
    `{req_id}/s{shard}` through the child's own deduped batch insert."""

    def run(p):
        calls = []

        class Recording(p.Memory):
            def insert_batch_with_req_id(self, events, app_id, channel_id, req_id):
                calls.append((req_id, len(events)))
                return self.insert_batch(events, app_id, channel_id)

        children = [Recording() for _ in range(3)]
        store = p.Sharded(stores=children)
        store.init_app(1)
        ids = store.insert_batch_with_req_id(_events(p, n=30), 1, None, "wal-7")
        assert all(ids)
        return sorted(calls), [_held(p, c) for c in children]

    calls, _ = _both(run)
    assert [c[0] for c in calls] == ["wal-7/s0", "wal-7/s1", "wal-7/s2"]
    assert sum(n for _, n in calls) == 30


# ---------------------------------------------------------------------------
# REPLICAS=2: successor copies and failover
# ---------------------------------------------------------------------------


def _mk_replicated(p, n=3):
    children = [p.Togglable() for _ in range(n)]
    store = p.Sharded(stores=children, retries=0)
    store.replicas = 2
    store.BACKOFF_BASE = 0.001
    store.init_app(1)
    return store, children


def test_writes_land_on_home_and_successor():
    def run(p):
        store, children = _mk_replicated(p)
        store.insert_batch(_events(p), 1)
        for e in _events(p):
            home = p.shard_of(e.entity_id, 3)
            holders = {sx for sx, c in enumerate(children)
                       if any(x.entity_id == e.entity_id
                              for x in c.find(p.EventQuery(app_id=1)))}
            assert holders == {home, (home + 1) % 3}
        return [_held(p, c) for c in children]

    assert sum(map(len, _both(run))) == 80


def test_broadcast_find_has_no_duplicates():
    def run(p):
        store, _ = _mk_replicated(p)
        store.insert_batch(_events(p), 1)
        got = list(store.find(p.EventQuery(app_id=1)))
        assert len({e.event_id for e in got}) == len(got)
        return _fs(got)

    got = _both(run)
    assert len(got) == 40 and got == sorted(got, key=lambda f: f[-1])


def test_reads_survive_a_down_shard():
    def run(p):
        store, children = _mk_replicated(p)
        store.insert_batch(_events(p), 1)
        dead = 1
        children[dead].down = True
        victim = next(f"u{k}" for k in range(50) if p.shard_of(f"u{k}", 3) == dead)
        ref = [e for e in _events(p) if e.entity_id == victim]
        got = list(store.find(p.EventQuery(app_id=1, entity_id=victim)))
        assert len(got) == len(ref) > 0
        part = list(store.find(p.EventQuery(app_id=1, shard=(dead, 3))))
        assert len(part) == sum(1 for e in _events(p) if p.shard_of(e.entity_id, 3) == dead)
        got_all = list(store.find(p.EventQuery(app_id=1)))
        assert len(got_all) == 40 and len({e.event_id for e in got_all}) == 40
        out = store.find_entities_batch(1, "user", [victim, "u0"])
        assert len(out[victim]) == len(ref)
        # the fold of properties too: the down home's entities from its copy
        return (_fs(got), _fs(part), _fs(got_all),
                {k: _fs(v) for k, v in out.items()}, list(store.last_degraded_shards))

    got = _both(run)
    assert got[-1] == []


def test_aggregate_properties_fail_over_to_the_copy():
    def run(p):
        store, children = _mk_replicated(p)
        store.insert_batch([p.Event(event="$set", entity_type="user", entity_id=f"u{i}",
                                    properties={"plan": f"p{i}"},
                                    event_time=T0 + dt.timedelta(seconds=i))
                            for i in range(12)], 1)
        children[2].down = True
        props = store.aggregate_properties(1, "user")
        degraded = list(store.last_degraded_shards)
        children[0].down = True  # shard 2's whole chain (2, 0) is down now
        with pytest.raises(p.Down):
            store.aggregate_properties(1, "user")
        store.allow_partial = True
        partial = store.aggregate_properties(1, "user")
        return ({k: v.get("plan") for k, v in props.items()}, degraded,
                sorted(partial), list(store.last_degraded_shards))

    props, degraded, partial, after = _both(run)
    assert len(props) == 12 and degraded == [] and after == [2]
    assert partial == sorted(k for k in props if tbase.shard_of(k, 3) != 2)


def test_two_down_shards_still_raise():
    def run(p):
        store, children = _mk_replicated(p)
        store.insert_batch(_events(p), 1)
        children[1].down = children[2].down = True
        victim = next(f"u{k}" for k in range(50) if p.shard_of(f"u{k}", 3) == 1)
        with pytest.raises(p.Down) as ei:
            list(store.find(p.EventQuery(app_id=1, entity_id=victim)))
        return ei.value.shard_index

    assert _both(run) == 2  # the last of the chain (1, 2) is named


def test_delete_removes_all_copies():
    def run(p):
        store, children = _mk_replicated(p)
        ids = store.insert_batch(_events(p), 1)
        assert store.delete(ids[0], 1)
        for c in children:
            assert all(e.event_id != ids[0] for e in c.find(p.EventQuery(app_id=1)))
        return [_held(p, c) for c in children]

    _both(run)


def test_replica_write_failure_degrades_not_fails(caplog):
    def run(p):
        store, children = _mk_replicated(p)
        children[1].down = True  # the follower of shard 0
        evs = [e for e in _events(p) if p.shard_of(e.entity_id, 3) == 0]
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            ids = store.insert_batch(evs, 1)
        assert all(ids)
        return (any("reduced redundancy" in r.message for r in caplog.records),
                [_held(p, c) for c in (children[0], children[2])])

    assert _both(run)[0]


def test_find_edges_by_entity_is_the_base_read_in_bulk():
    """The fold's history read: one bulk read a home shard, the same
    rows as the base class's find an id, through a down home too."""
    store, children = _mk_replicated(P["port"])
    events = _events(P["port"], n=60, seed=2) + [
        tevent.Event(event="rate", entity_type="user", entity_id="u1",
                     target_entity_type="shop", target_entity_id="s1", event_time=T0),
        tevent.Event(event="$set", entity_type="user", entity_id="u2",
                     properties={"plan": "a"}, event_time=T0)]
    store.insert_batch(events, 1)
    ids = ["u3", "u1", "u9", "nobody", "u2", "u3"]
    calls = []
    for c in children:
        fn = c.find_entities_batch
        c.find_entities_batch = lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a, **k)
    for down in (None, 1):
        if down is not None:
            children[down].down = True
        calls.clear()
        got = store.find_edges(1, "user", "item", ["rate"], entity_ids=ids)
        assert len(calls) <= 3
        want = tbase.EventStore.find_edges(store, 1, "user", "item", ["rate"], entity_ids=ids)
        assert got == want and len(got) == sum(
            1 for e in events if e.entity_id in {"u1", "u2", "u3", "u9"} and e.event == "rate"
            and e.target_entity_type == "item")
    by_target = store.find_edges(1, "user", "item", ["rate"], target_ids=["i2"])
    assert by_target == tbase.EventStore.find_edges(store, 1, "user", "item", ["rate"],
                                                    target_ids=["i2"])


# ---------------------------------------------------------------------------
# hedged reads
# ---------------------------------------------------------------------------


def _mk_hedged(p, n=3, replicas=2, **cfg):
    children = [p.Togglable() for _ in range(n)]
    store = p.Sharded(stores=children, config={"REPLICAS": str(replicas), **cfg})
    store.init_app(1)
    return store, children


def test_hedge_enabled_only_with_replicas():
    def run(p):
        return (_mk_hedged(p, replicas=2)[0].hedged_reads,
                _mk_hedged(p, replicas=1)[0].hedged_reads,
                _mk_hedged(p, replicas=2, HEDGED_READS="0")[0].hedged_reads)

    assert _both(run) == (True, False, False)


def test_p95_delay_derivation():
    def run(p):
        store, _ = _mk_hedged(p)
        cold = store.hedge_delay_s()
        for k in range(40):
            store._record_read_latency(0.001 + k * 1e-5)
        store._record_read_latency(0.1)  # one outlier above the p95
        warm = store.hedge_delay_s()
        for _ in range(600):  # the window keeps HEDGE_WINDOW reads
            store._record_read_latency(0.0001)
        return cold, warm, store.hedge_delay_s(), len(store._read_lat)

    cold, warm, floor, kept = _both(run)
    assert cold == tsh.ShardedEventStore.HEDGE_DEFAULT_DELAY_S
    assert tsh.ShardedEventStore.HEDGE_MIN_DELAY_S <= warm < 0.1
    assert floor == tsh.ShardedEventStore.HEDGE_MIN_DELAY_S and kept == 512


def _hedge_counts(registry):
    text = registry.render()
    return {o: sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                   if line.startswith("storage_hedged_reads_total{")
                   and f'outcome="{o}"' in line)
            for o in ("primary_fast", "primary", "hedge", "failover")}


def test_hedge_beats_slow_primary():
    registries = {"port": get_default_registry(), "jax": jdefault_registry()}

    def run(p):
        store, children = _mk_hedged(p)
        for e in _events(p):
            store.insert(e, 1)
        ids = [f"u{i}" for i in range(11)]
        for _ in range(25):  # warm the latency window with fast reads
            store.find_entities_batch(1, "user", ids)
        before = _hedge_counts(registries[p.name])
        children[0].delay = 0.8  # one slow shard: its home groups hedge
        t0 = time.monotonic()
        out = store.find_entities_batch(1, "user", ids)
        took = time.monotonic() - t0
        assert took < 0.7, took  # the hedge beat the stall
        after = _hedge_counts(registries[p.name])
        return ({k: _fs(v) for k, v in out.items()},
                after["hedge"] > before["hedge"], after["primary_fast"] > before["primary_fast"])

    out, hedged, fast = _both(run)
    assert set(out) == {f"u{i}" for i in range(11)} and hedged and fast


def test_hedged_result_matches_serial():
    def run(p):
        store, _ = _mk_hedged(p)
        for e in _events(p):
            store.insert(e, 1)
        ids = [f"u{i}" for i in range(11)]
        hedged = store.find_entities_batch(1, "user", ids)
        store.hedged_reads = False
        serial = store.find_entities_batch(1, "user", ids)
        assert {k: _fs(v) for k, v in hedged.items()} == {k: _fs(v) for k, v in serial.items()}
        return {k: _fs(v) for k, v in serial.items()}

    assert len(_both(run)) == 11


def test_down_primary_fails_over_through_hedge():
    def run(p):
        store, children = _mk_hedged(p)
        for e in _events(p):
            store.insert(e, 1)
        ids = [f"u{i}" for i in range(11) if p.shard_of(f"u{i}", 3) == 0]
        assert ids
        children[0].down = True
        return {k: _fs(v) for k, v in store.find_entities_batch(1, "user", ids).items()}

    got = _both(run)
    assert got and all(got.values())


# ---------------------------------------------------------------------------
# storage daemons, within and across the packages
# ---------------------------------------------------------------------------

REMOTE = {"port": tremote, "jax": jremote}
SHARDED = {"port": tsh, "jax": jsh}


def _rpc_finds(daemon):
    return daemon.httpd.metrics.counter(
        "storage_rpc_total", "storage RPCs by DAO and method",
        ("dao", "method")).value(dao="events", method="find")


def _ingest_and_read(client_pkg, daemon_pkg, tmp_path):
    """`client_pkg`'s sharded store over two of `daemon_pkg`'s daemons:
    ingest, the partitioned reads, each daemon's own rows."""
    p = P[client_pkg]
    daemons = [_daemon(daemon_pkg, tmp_path / f"{daemon_pkg}{s}") for s in range(2)]
    try:
        store = SHARDED[client_pkg].ShardedEventStore(
            {"SHARDS": ",".join(f"127.0.0.1:{d.port}" for d in daemons)})
        store.init_app(7)
        events = _events(p, n=60, seed=3)
        ids = store.insert_batch(events, 7)
        assert len(ids) == 60 and all(ids)
        parts, alone = [], []
        for s in range(2):
            before = [_rpc_finds(d) for d in daemons]
            parts.append({e.event_id for e in store.find(p.EventQuery(app_id=7, shard=(s, 2)))})
            moved = [_rpc_finds(d) - b for d, b in zip(daemons, before)]
            alone.append([m > 0 for m in moved])
        assert parts[0] and parts[1] and not parts[0] & parts[1]
        assert len(parts[0] | parts[1]) == 60
        held = []
        for s, d in enumerate(daemons):
            direct = REMOTE[client_pkg].RemoteEventStore({"HOST": "127.0.0.1",
                                                          "PORT": str(d.port)})
            rows = list(direct.find(p.EventQuery(app_id=7)))
            assert {e.event_id for e in rows} == parts[s]
            assert all(p.shard_of(e.entity_id, 2) == s for e in rows)
            held.append(sorted(_fs(rows)))
        got = list(store.find(p.EventQuery(app_id=7)))
        return held, alone, _fs(got)
    finally:
        for d in daemons:
            d.shutdown()


@pytest.mark.parametrize("client_pkg,daemon_pkg", [("port", "port"), ("jax", "port"),
                                                   ("port", "jax")])
def test_two_daemon_sharded_ingest_and_partitioned_read(tmp_path, client_pkg, daemon_pkg):
    """Events ingested through a two-daemon sharded store land disjointly,
    a shard=(i, 2) read reaches daemon i alone, and the merged read is
    time-ordered: the same across the packages' clients and daemons."""
    got = _ingest_and_read(client_pkg, daemon_pkg, tmp_path / "a")
    want = _ingest_and_read("jax", "jax", tmp_path / "b")
    assert got == want
    held, alone, merged = got
    assert all(held) and alone == [[True, False], [False, True]]
    assert len(merged) == 60 and merged == sorted(merged, key=lambda f: f[-1])


def _killed_mid_find(pkg, tmp_path):
    p = P[pkg]
    tmp_path.mkdir(parents=True)
    ports = [_free_port() for _ in range(2)]
    procs = []
    try:
        for s, port in enumerate(ports):
            (tmp_path / str(s)).mkdir()
            procs.append(_spawn_daemon(pkg, tmp_path / str(s), port))
        store = SHARDED[pkg].ShardedEventStore(
            {"SHARDS": ",".join(f"127.0.0.1:{port}" for port in ports), "RETRIES": "1",
             "RETRY_ATTEMPTS": "1", "RETRY_BASE_DELAY": "0.01"})
        store.BACKOFF_BASE = 0.01
        store.init_app(3)
        store.insert_batch(_events(p, n=60, seed=1), 3)
        for child in store._stores:  # pages of 5: the stream is mid-flight
            child.FIND_PAGE = 5
        it = store.find(p.EventQuery(app_id=3))
        for _ in range(4):
            next(it)
        procs[1].kill()
        procs[1].wait(timeout=10)
        with pytest.raises(p.Down) as ei:
            list(it)
        assert str(ports[1]) in ei.value.address
        alive = [h["alive"] for h in store.health()]
        part0 = _fs(store.find(p.EventQuery(app_id=3, shard=(0, 2))))
        assert part0
        return ei.value.shard_index, alive, sorted(part0)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=10)


def test_daemon_killed_mid_find_names_shard(tmp_path):
    """Two daemons, one SIGKILLed mid-stream: the merged read fails naming
    the dead shard, health names it, the other shard goes on serving."""
    got = _killed_mid_find("port", tmp_path / "port")
    assert got == _killed_mid_find("jax", tmp_path / "jax")
    assert got[:2] == (1, [True, False])


# ---------------------------------------------------------------------------
# the registry: the source, the process singleton, the self-check
# ---------------------------------------------------------------------------


def _sharded_storage(pkg, ports, **settings):
    reg = {"port": treg, "jax": jreg}[pkg]
    return reg.Storage(reg.StorageConfig(
        sources={"SH": reg.SourceConfig("SH", "sharded", {
                     "SHARDS": ",".join(f"127.0.0.1:{p}" for p in ports), **settings}),
                 "M": reg.SourceConfig("M", "memory", {})},
        repositories={"EVENTDATA": "SH", "METADATA": "M", "MODELDATA": "M"}))


def _self_check(pkg, ports):
    storage = _sharded_storage(pkg, ports, RETRIES="0", RETRY_ATTEMPTS="1")
    try:
        lines = storage.verify_all_data_objects()
        return [line.split(" @ ")[0] for line in lines], None
    except Exception as e:  # noqa: BLE001 — the error is the answer
        return None, (type(e).__name__, str(e).splitlines()[0].split(": ")[0],
                      [line.strip().split(" @ ")[0] for line in str(e).splitlines()[1:]])


def test_sharded_source_self_check_names_a_down_shard(tmp_path):
    daemons = [_daemon("port", tmp_path / f"d{s}") for s in range(3)]
    ports = [d.port for d in daemons]
    store = _sharded_storage("port", ports).get_events()
    assert isinstance(store, tsh.ShardedEventStore) and store.n_shards == 3
    with pytest.raises(tbase.StorageError, match="does not implement"):
        treg.Storage(treg.StorageConfig(
            sources={"SH": treg.SourceConfig("SH", "sharded", {"SHARDS": "127.0.0.1:1"})},
            repositories={"METADATA": "SH"})).get_meta_data_apps()
    try:
        ok = _self_check("port", ports)
        assert ok == _self_check("jax", ports)
        lines, err = ok
        assert err is None and lines[-4:-1] == [f"OK shard {s}" for s in range(3)]
        assert lines[-1] == "OK ShardedEventStore (write/read/delete probe)"
        daemons[1].shutdown()
        down = _self_check("port", ports)
        assert down == _self_check("jax", ports)
        assert down[0] is None and down[1][0] == "StorageError"
        assert down[1][1] == "event store shards down"
        assert "DOWN shard 1" in down[1][2] and "OK shard 2" in down[1][2]
    finally:
        for d in (daemons[0], daemons[2]):
            d.shutdown()


def test_storage_get_and_set_instance(monkeypatch):
    for key in [k for k in __import__("os").environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_STORAGE_SOURCES_M_TYPE", "memory")
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "M")
    treg.Storage.set_instance(None)
    try:
        first = treg.Storage.get_instance()
        assert treg.Storage.get_instance() is first
        assert first.config.sources["M"].type == "memory"
        mine = treg.Storage(treg.StorageConfig.memory())
        treg.Storage.set_instance(mine)
        assert treg.Storage.get_instance() is mine
    finally:
        treg.Storage.set_instance(None)


def test_console_status_fails_on_a_down_shard(tmp_path, monkeypatch, capsys):
    from predictionio_tpu_torch.tools import console

    daemons = [_daemon("port", tmp_path / f"d{s}") for s in range(2)]
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SH_TYPE", "sharded")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SH_SHARDS",
                       ",".join(f"127.0.0.1:{d.port}" for d in daemons))
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SH_RETRIES", "0")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SH_RETRY_ATTEMPTS", "1")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_M_TYPE", "memory")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "SH")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "M")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "M")
    try:
        assert console.main(["status"]) == 0
        out = capsys.readouterr().out
        for s, d in enumerate(daemons):
            assert f"[INFO]   OK shard {s} @ 127.0.0.1:{d.port}" in out
        daemons[1].shutdown()
        assert console.main(["status"]) == 1
        err = capsys.readouterr().err
        assert "storage verification failed: event store shards down: 1 " in err
        assert "DOWN shard 1" in err
    finally:
        daemons[0].shutdown()


# ---------------------------------------------------------------------------
# the Event Server with one shard's daemon down
# ---------------------------------------------------------------------------

FAST = {"RETRIES": "0", "RETRY_ATTEMPTS": "1", "RETRY_BASE_DELAY": "0.01",
        "BREAKER_THRESHOLD": "1000"}


def _batch(tag, n=10):
    return [{"event": "buy", "entityType": "user", "entityId": f"u{k}",
             "targetEntityType": "item", "targetEntityId": f"{tag}{k}"} for k in range(n)]


def _partial_outage(pkg, tmp_path):
    base = P[pkg].base
    module = {"port": tes, "jax": jes}[pkg]
    tmp_path.mkdir(parents=True)
    ports = [_free_port() for _ in range(2)]
    procs = []
    srv = None
    try:
        for s, port in enumerate(ports):
            (tmp_path / str(s)).mkdir()
            procs.append(_spawn_daemon(pkg, tmp_path / str(s), port))
        storage = _sharded_storage(pkg, ports, **FAST)
        app_id = storage.get_meta_data_apps().insert(base.App(0, "sharded"))
        storage.get_events().init_app(app_id)
        storage.get_meta_data_access_keys().insert(base.AccessKey(key="SK", app_id=app_id))
        srv = module.EventServer(storage, module.EventServerConfig(
            ip="127.0.0.1", port=0, wal_dir=str(tmp_path / "wal"),
            wal_replay_interval_s=0.1))
        es_port = srv.start()
        before = _post(es_port, "SK", _batch("a"), batch=True)
        procs[1].kill()
        procs[1].wait(timeout=10)
        during = _post(es_port, "SK", _batch("b"), batch=True)
        procs[1] = _spawn_daemon(pkg, tmp_path / "1", ports[1])
        # the client retries only the events that failed
        failed = [k for k, r in enumerate(during[1]) if r["status"] != 201]
        retry = _post(es_port, "SK", [_batch("b")[k] for k in failed], batch=True)
        rows = list(storage.get_events().find(base.EventQuery(app_id=app_id)))
        return {"before": [r["status"] for r in before[1]],
                "during": [(r["status"], r.get("message")) for r in during[1]],
                "failed": failed, "retry": [r["status"] for r in retry[1]],
                "rows": sorted((e.entity_id, e.target_entity_id) for e in rows),
                "unique": len({e.event_id for e in rows}) == len(rows),
                "spilled": _value(_metrics(es_port), "event_wal_spilled_total ") or 0}
    finally:
        if srv is not None:
            srv.stop()
        for proc in procs:
            proc.kill()
            proc.wait(timeout=10)


def test_event_server_answers_a_partial_batch_by_position(tmp_path):
    got = _partial_outage("port", tmp_path / "port")
    want = _partial_outage("jax", tmp_path / "jax")
    assert got == want
    on_down = [k for k in range(10) if tbase.shard_of(f"u{k}", 2) == 1]
    assert got["before"] == [201] * 10 and got["failed"] == on_down
    assert [s for s, _ in got["during"]] == [503 if k in on_down else 201 for k in range(10)]
    assert {m for s, m in got["during"] if s == 503} == {"storage shard unavailable"}
    assert got["retry"] == [201] * len(on_down) and got["spilled"] == 0
    assert got["unique"] and got["rows"] == sorted(
        [(f"u{k}", f"a{k}") for k in range(10)] + [(f"u{k}", f"b{k}") for k in range(10)])


def _spill_and_replay(pkg, tmp_path):
    """The `event.insert` fault over a sharded source: a batch spilled
    (202 each), then replayed through the sharded store's batched replay
    (one derived request id a shard's group), each event once."""
    base = P[pkg].base
    module = {"port": tes, "jax": jes}[pkg]
    fault_mod = {"port": tfaults, "jax": jfaults}[pkg]
    daemons = [_daemon(pkg, tmp_path / f"d{s}") for s in range(2)]
    srv = None
    try:
        storage = _sharded_storage(pkg, [d.port for d in daemons])
        app_id = storage.get_meta_data_apps().insert(base.App(0, "spill"))
        storage.get_events().init_app(app_id)
        storage.get_meta_data_access_keys().insert(base.AccessKey(key="SK", app_id=app_id))
        srv = module.EventServer(storage, module.EventServerConfig(
            ip="127.0.0.1", port=0, wal_dir=str(tmp_path / "wal"),
            wal_replay_interval_s=0.1))
        es_port = srv.start()
        fault_mod.install(fault_mod.FaultSpec("event.insert", "error", 1.0))
        spilled = _post(es_port, "SK", _batch("w", 12), batch=True)
        fault_mod.clear()
        deadline_at = time.time() + 20
        while _value(_metrics(es_port), "event_wal_replayed_total ") != 12:
            assert time.time() < deadline_at, "the spill was not replayed"
            time.sleep(0.1)
        rows = list(storage.get_events().find(base.EventQuery(app_id=app_id)))
        per_daemon = [sorted(e.entity_id for e in d.storage.get_events().find(
            base.EventQuery(app_id=app_id))) for d in daemons]
        return {"spilled": [r["status"] for r in spilled[1]],
                "rows": sorted((e.entity_id, e.target_entity_id) for e in rows),
                "unique": len({e.event_id for e in rows}) == len(rows),
                "per_daemon": per_daemon}
    finally:
        fault_mod.clear()
        if srv is not None:
            srv.stop()
        for d in daemons:
            d.shutdown()


def test_event_server_spill_replays_through_the_sharded_store(tmp_path):
    got = _spill_and_replay("port", tmp_path / "port")
    assert got == _spill_and_replay("jax", tmp_path / "jax")
    assert got["spilled"] == [202] * 12 and got["unique"]
    assert got["rows"] == sorted((f"u{k}", f"w{k}") for k in range(12))
    assert all(tbase.shard_of(u, 2) == s for s, us in enumerate(got["per_daemon"]) for u in us)


# ---------------------------------------------------------------------------
# the online consumer over the per-shard streams
# ---------------------------------------------------------------------------


class _StubHost:
    scope = "server"

    def __init__(self):
        self.runtime = object()  # no model: the events consume without a fold

    def current(self):
        return self.runtime

    def swap(self, old, new):
        if self.runtime is old:
            self.runtime = new
            return True
        return False


class _EventsOnly:
    def __init__(self, store):
        self.store = store

    def get_events(self):
        return self.store


def _consume(p, consumer_mod, registry):
    children = [p.Memory() for _ in range(3)]
    store = p.Sharded(stores=children, config={"REPLICAS": "2"})
    store.init_app(1)
    events = _events(p, n=45, seed=5)
    store.insert_batch(events[:30], 1)
    for e in events[30:]:
        store.insert(e, 1)
    storage = _EventsOnly(store)
    c = consumer_mod.OnlineConsumer(storage, _StubHost(), 1,
                                    consumer_mod.OnlineConsumerConfig(tick_s=9),
                                    metrics=registry)
    # each stream holds its shard's primaries only: no copy is read
    per_stream = [len(s.find_since(1, 0, shard=sh)) for _k, s, sh in store.revision_streams()]
    held = [len(list(ch.find(p.EventQuery(app_id=1)))) for ch in children]
    first = c.tick()
    cursor1 = dict(c.cursor)
    more = _events(p, n=6, seed=9)
    store.insert_batch([p.Event(event="rate", entity_type="user", entity_id=f"w{k}",
                                target_entity_type="item", target_entity_id="i1",
                                event_time=T0 + dt.timedelta(hours=2, minutes=k))
                        for k in range(len(more))], 1)
    second = c.tick()
    resumed = consumer_mod.OnlineConsumer(storage, _StubHost(), 1,
                                          consumer_mod.OnlineConsumerConfig(tick_s=9),
                                          metrics=registry)
    return {"per_stream": per_stream, "held": held, "consumed": (first.get("consumed"),
                                                                second.get("consumed")),
            "cursor1": cursor1, "cursor": dict(c.cursor), "resumed": dict(resumed.cursor),
            "total": c.counters["events_consumed"], "idle": resumed.tick()}


def test_consumer_folds_each_event_once_across_shard_streams():
    got = _consume(P["port"], tconsumer, MetricsRegistry())
    from predictionio_tpu.obs.registry import MetricsRegistry as JMetrics

    want = _consume(P["jax"], jconsumer, JMetrics())
    assert got == want
    assert sum(got["per_stream"]) == 45 and sum(got["held"]) == 90
    assert got["consumed"] == (45, 6) and got["total"] == 51
    assert set(got["cursor"]) == {"shard0", "shard1", "shard2"}
    assert got["resumed"] == got["cursor"] and got["idle"] == {"idle": "no new events"}
