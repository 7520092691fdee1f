"""The port's segmentfs store, its device stager and its surfaces against
the JAX package's.

The same events, made from a numpy seed with explicit ids, times and
creation times, go into both packages' stores (each at a PATH of its
own, or one PATH read by the other), and every answer is compared
exactly:

- the sealed contract, crash recovery (the unsealed tail, a torn WAL
  line, a crash between a seal and the WAL's reclaim, the revision floor
  after a deleted tail), ``find_since`` once per revision across seals
  and compactions (also through the port's ``OnlineConsumer``), frame
  parity over the JAX test's query cases (less ``shard``), the target
  posting read, ``events_page``, the concurrency race, the writer guard;
- the on-disk layout: files written by the same inserts are byte-equal,
  and a PATH written by either package is read by the other to the same
  events and frames, with equal ``segment_content_hash``;
- ``SegmentStager`` on CPU tensors (reuse, bytes staged), the data
  view's delegation counters, ``/segments/*`` on both Event Servers, and
  ``console status``'s segment line.
"""

import contextlib
import datetime as dt
import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data import event as jevent  # noqa: E402
from predictionio_tpu.data.storage import base as jbase  # noqa: E402
from predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from predictionio_tpu.data.storage import segmentfs as jseg  # noqa: E402
from predictionio_tpu.data.store.columnar import EventFrame as JFrame  # noqa: E402
from predictionio_tpu_torch.data import event as tevent  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from predictionio_tpu_torch.data.storage import segmentfs as tseg  # noqa: E402
from predictionio_tpu_torch.data.store.columnar import EventFrame  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
UTC = dt.timezone.utc
T0 = dt.datetime(2024, 1, 1, tzinfo=UTC)
APP = 1
PACKAGES = {"port": (tseg, tbase, tevent, EventFrame),
            "jax": (jseg, jbase, jevent, JFrame)}


def T(i):
    return T0 + dt.timedelta(hours=i)


def _spec(name, entity, t=0, etype="user", target=None, props=None, n=0, **kw):
    """One event's fields with an explicit id and creation time."""
    out = dict(event=name, entity_type=etype, entity_id=entity, event_time=T(t),
               creation_time=T0 + dt.timedelta(seconds=n), event_id=f"e{n:05d}",
               properties=dict(props or {}), **kw)
    if target is not None:
        out.update(target_entity_type="item", target_entity_id=target)
    return out


def _rate(u, i, r, t=0, n=0):
    return _spec("rate", u, t=t, target=i, props={"rating": float(r)}, n=n)


def _make(pkg, specs):
    ev = PACKAGES[pkg][2].Event
    return [ev(**s) for s in specs]


def _open(pkg, path, **settings):
    cfg = {"PATH": str(path), "SEAL_INTERVAL_S": "3600", **settings}
    return PACKAGES[pkg][0].SegmentFSEventStore(cfg)


def _query(pkg, **kw):
    return PACKAGES[pkg][1].EventQuery(app_id=APP, **kw)


def _props(e):
    p = e.properties
    return p.to_dict() if hasattr(p, "to_dict") else dict(p)


def _key(e):
    """Every field of an event, in one comparable tuple."""
    return (e.event_id, e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, json.dumps(_props(e), sort_keys=True), e.event_time,
            tuple(e.tags), e.pr_id, e.creation_time, e.revision)


def _keys(events):
    return [_key(e) for e in events]


def _frame_tuple(f):
    return (f.event_code.tolist(), f.entity_idx.tolist(), f.target_idx.tolist(),
            f.time_ms.tolist(), f.value.tobytes(), f.event_vocab.to_dict(),
            f.entity_vocab.to_dict(), f.target_vocab.to_dict(), f.entity_type,
            f.target_entity_type, str(f.event_code.dtype), str(f.value.dtype))


def _both(tmp_path, **settings):
    """The port's and the JAX package's stores, each at its own PATH."""
    return {pkg: _open(pkg, tmp_path / pkg, **settings) for pkg in PACKAGES}


@contextlib.contextmanager
def _pair(tmp_path, **settings):
    stores = _both(tmp_path, **settings)
    try:
        yield stores
    finally:
        for s in stores.values():
            s.close()


def _mixed(rng, n=60):
    """The JAX test's mixed workload: rates and buys with and without a
    rating, $set events without a target."""
    out = []
    for k in range(n):
        if k % 7 == 3:
            out.append(_spec("$set", f"u{k % 5}", t=k,
                             props={"age": int(rng.randint(18, 60))}, n=k))
        else:
            props = {"rating": float(rng.randint(1, 6))}
            if k % 5 == 0:
                props.pop("rating")
            out.append(_spec("rate" if k % 3 else "buy", f"u{int(rng.randint(6))}",
                             t=int(rng.randint(48)), target=f"i{int(rng.randint(9))}",
                             props=props, n=k))
    return out


# ---------------------------------------------------------------------------
# the sealed contract: one script on both packages' stores
# ---------------------------------------------------------------------------


def _contract_script(pkg, s):
    out = []
    s.init_app(APP)
    s.insert_batch(_make(pkg, [_rate(f"u{i % 3}", f"i{i % 2}", i + 1, t=i, n=i)
                               for i in range(8)]), APP)
    s.insert(_make(pkg, [_spec("$set", "u0", t=9, props={"a": 1}, n=8)])[0], APP)
    out.append(s.seal(APP))
    found = list(s.find(_query(pkg, event_names=["rate"])))
    out.append(_keys(found))
    out.append(_keys(s.find(_query(pkg, entity_id="u0"))))
    out.append({k: v.to_dict() for k, v in s.aggregate_properties(APP, "user").items()})
    eid = found[0].event_id
    out.append(_key(s.get(eid, APP)))
    out.append(s.delete(eid, APP))
    out.append(s.get(eid, APP))
    out.append(_keys(s.find(_query(pkg))))
    # an overwrite of a sealed row: a new revision, one live copy
    s.insert(_make(pkg, [dict(_rate("u1", "i9", 3, t=5, n=20), event_id="e00001")])[0], APP)
    out.append(_key(s.get("e00001", APP)))
    out.append([e.event_id for e in s.find(_query(pkg))].count("e00001"))
    # channel isolation, sealed
    s.init_app(APP, 7)
    s.insert(_make(pkg, [_rate("u2", "i2", 4, n=30)])[0], APP, 7)
    out.append(s.seal(APP))
    out.append(s.seal(APP, 7))
    out.append([e.entity_id for e in s.find(_query(pkg, channel_id=7))])
    out.append(s.segment_stats(APP))
    out.append(s.data_signature(APP))
    out.append(s.latest_revision(APP))
    out.append(_keys(s.find(_query(pkg, reversed=True, limit=3))))
    return out


def test_contract_behaviors_survive_seal(tmp_path):
    with _pair(tmp_path) as st:
        got = _contract_script("port", st["port"])
        want = _contract_script("jax", st["jax"])
    assert got[0] == 9 and got[3] == {"u0": {"a": 1}} and got[6] is None
    assert got == want


def test_find_entities_batch_is_a_find_per_entity(tmp_path):
    with _pair(tmp_path) as st:
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, [_rate(f"u{i % 4}", f"i{i % 3}", i % 5 + 1, t=i, n=i)
                                       for i in range(30)]), APP)
            s.seal(APP)
            s.insert_batch(_make(pkg, [_rate("u1", "i7", 2, t=40, n=40)]), APP)
        got = st["port"].find_entities_batch(APP, "user", ["u1", "u3", "zz", "u1"],
                                             event_names=["rate"], limit_per_entity=4)
        want = st["jax"].find_entities_batch(APP, "user", ["u1", "u3", "zz", "u1"],
                                             event_names=["rate"], limit_per_entity=4)
    assert {k: _keys(v) for k, v in got.items()} == {k: _keys(v) for k, v in want.items()}
    assert len(got["u1"]) == 4 and got["u1"][0].target_entity_id == "i7"


@pytest.mark.parametrize("side", ["entity_ids", "target_ids"])
def test_find_edges_is_the_find_an_id_read(tmp_path, side):
    """segmentfs's one-pass fold history read equals the base class's
    `find` an id over sealed segments, dead rows, a compaction, a
    superseded and a deleted row, the unsealed tail, other event names
    and entity types, and events without a target; on a replica too."""
    rng = np.random.RandomState(7)
    s = _open("port", tmp_path / "edges")
    s.init_app(APP)
    s.insert_batch(_make("port", _mixed(rng)), APP)
    s.seal(APP)
    s.insert_batch(_make("port", [_spec("view", f"u{k % 4}", t=k, target=f"i{k % 3}", n=100 + k)
                                  for k in range(10)]), APP)
    s.insert_batch(_make("port", [_spec("rate", "u1", t=k, etype="admin", target="i1",
                                        props={"rating": 5.0}, n=120 + k)
                                  for k in range(3)]), APP)
    s.seal(APP)
    s.compact(APP)
    s.insert_batch(_make("port", [dict(_rate("u2", "i9", 1, t=50, n=200), event_id="e00004")]),
                   APP)  # supersedes a sealed row by id
    s.delete("e00006", APP)
    s.insert_batch(_make("port", [_rate(f"u{k % 6}", f"i{k % 9}", 2, t=60 + k, n=300 + k)
                                  for k in range(12)]), APP)  # the tail
    ids = (["u1", "u0", "zz", "u5", "u1", "u3"] if side == "entity_ids"
           else ["i1", "i9", "i0", "nope", "i4"])
    for names in (["rate"], ["rate", "buy", "view"]):
        got = s.find_edges(APP, "user", "item", names, **{side: ids})
        assert got == tbase.EventStore.find_edges(s, APP, "user", "item", names, **{side: ids})
        assert got
    with pytest.raises(ValueError, match="entity_ids or target_ids"):
        s.find_edges(APP, "user", "item", ["rate"])
    s.close()


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------


def _crash(s):
    s._stop.set()  # the "crashed" store's sealer only; nothing is sealed


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_unsealed_tail_survives_crash(tmp_path, writer, reader):
    s1 = _open(writer, tmp_path / "seg")
    ids = s1.insert_batch(_make(writer, [_rate(f"u{i}", "i1", i + 1, n=i)
                                         for i in range(5)]), APP)
    s2 = _open(reader, tmp_path / "seg")
    evs = s2.find_since(APP, 0)
    assert [e.revision for e in evs] == [1, 2, 3, 4, 5]
    assert [e.event_id for e in evs] == ids
    assert s2.latest_revision(APP) == 5
    _crash(s1)
    s2.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_torn_wal_tail_skipped(tmp_path, pkg):
    s1 = _open("port", tmp_path / "seg")
    s1.insert_batch(_make("port", [_rate("u1", "i1", 5, n=1), _rate("u2", "i2", 4, n=2)]), APP)
    (wal,) = (tmp_path / "seg" / "app_1").glob("wal-*.jsonl")
    with open(wal, "a") as f:
        f.write('[3, [["someid", "rate", "user", "u3"')
    s2 = _open(pkg, tmp_path / "seg")
    assert [e.revision for e in s2.find_since(APP, 0)] == [1, 2]
    new_id = s2.insert(_make(pkg, [_rate("u3", "i3", 1, n=3)])[0], APP)
    assert s2.get(new_id, APP).revision == 3
    _crash(s1)
    s2.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_crash_between_seal_and_wal_reclaim(tmp_path, pkg):
    """The port seals, the WAL comes back as if never reclaimed: either
    package's reopen dedupes by revision."""
    s1 = _open("port", tmp_path / "seg")
    s1.insert_batch(_make("port", [_rate(f"u{i}", "i1", i + 1, n=i) for i in range(4)]), APP)
    (wal,) = (tmp_path / "seg" / "app_1").glob("wal-*.jsonl")
    saved = wal.read_bytes()
    s1.seal(APP)
    wal.write_bytes(saved)
    s2 = _open(pkg, tmp_path / "seg")
    evs = s2.find_since(APP, 0)
    assert [e.revision for e in evs] == [1, 2, 3, 4]
    assert len({e.event_id for e in evs}) == 4
    _crash(s1)
    s2.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_revision_floor_survives_deleted_tail(tmp_path, pkg):
    s1 = _open("port", tmp_path / "seg")
    ids = s1.insert_batch(_make("port", [_rate(f"u{i}", "i1", 1, n=i) for i in range(3)]), APP)
    s1.delete(ids[-1], APP)
    s1.seal(APP)
    s2 = _open(pkg, tmp_path / "seg")
    assert s2.latest_revision(APP) == 3
    nid = s2.insert(_make(pkg, [_rate("u9", "i1", 1, n=9)])[0], APP)
    assert s2.get(nid, APP).revision == 4
    _crash(s1)
    s2.close()


def test_a_failed_wal_append_changes_no_state(tmp_path, monkeypatch):
    """A batch whose WAL append raised is not acknowledged and leaves no
    row; its revisions are spent, so a later batch cannot take them."""
    with _pair(tmp_path) as st:
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, [_rate("u0", "i0", 1, n=0)]), APP)
            ns = s._namespace(APP, None)

            def boom(line):
                raise OSError("disk full")

            monkeypatch.setattr(ns, "wal_append", boom)
            with pytest.raises(OSError):
                s.insert_batch(_make(pkg, [_rate("u1", "i1", 1, n=1)]), APP)
            monkeypatch.undo()
            s.insert_batch(_make(pkg, [_rate("u2", "i2", 1, n=2)]), APP)
        got = [(e.event_id, e.revision) for e in st["port"].find_since(APP, 0)]
        want = [(e.event_id, e.revision) for e in st["jax"].find_since(APP, 0)]
    assert got == want == [("e00000", 1), ("e00002", 3)]


# ---------------------------------------------------------------------------
# the revision tail
# ---------------------------------------------------------------------------


def test_exactly_once_across_seal(tmp_path):
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, [_rate(f"u{i}", "i1", 1, n=i) for i in range(6)]), APP)
            page = s.find_since(APP, 0, limit=3)
            s.seal(APP)
            rest = s.find_since(APP, page[-1].revision)
            out[pkg] = _keys(page + rest)
    assert [k[-1] for k in out["port"]] == [1, 2, 3, 4, 5, 6]
    assert out["port"] == out["jax"]


def test_exactly_once_across_compaction(tmp_path):
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            for k in range(4):
                s.insert_batch(_make(pkg, [_rate(f"u{k}_{i}", "i1", 1, n=10 * k + i)
                                           for i in range(3)]), APP)
                s.seal(APP)
            page = s.find_since(APP, 0, limit=5)
            merged = s.compact(APP)
            rest = s.find_since(APP, page[-1].revision)
            out[pkg] = (merged, _keys(page + rest))
    assert out["port"][0] == 3
    assert [k[-1] for k in out["port"][1]] == list(range(1, 13))
    assert out["port"] == out["jax"]


def test_compaction_drops_dead_rows(tmp_path):
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            ids = s.insert_batch(_make(pkg, [_rate(f"u{i}", "i1", 1, n=i) for i in range(4)]),
                                 APP)
            s.seal(APP)
            s.insert_batch(_make(pkg, [_rate(f"v{i}", "i1", 1, n=10 + i) for i in range(4)]),
                           APP)
            s.seal(APP)
            s.delete(ids[0], APP)
            s.insert(_make(pkg, [dict(_rate("uX", "i2", 2, t=9, n=20), event_id=ids[1])])[0],
                     APP)
            s.seal(APP)
            before = s.segment_stats(APP)
            s.compact(APP)
            out[pkg] = (before, s.segment_stats(APP), _keys(s.find(_query(pkg))))
    before, after, live = out["port"]
    assert before["dead_rows"] == 2 and after["segments"] == 1 and after["dead_rows"] == 0
    assert after["sealed_rows"] == 7 and len(live) == 7
    assert out["port"] == out["jax"]


def test_revision_streams_one_and_shard_refused(tmp_path):
    with _pair(tmp_path) as st:
        s = st["port"]
        [(key, store, shard)] = s.revision_streams()
        assert key == "0" and store is s and shard is None
        # the one stream's tail takes a shard filter (the sharded store's
        # streams pass one), read as the JAX store reads it, across a seal
        rows = [_rate(f"u{k}", f"i{k % 3}", 1 + k % 5, n=k) for k in range(12)]
        for pkg, store in st.items():
            store.insert_batch(_make(pkg, rows[:7]), APP)
            store.seal(APP)
            store.insert_batch(_make(pkg, rows[7:]), APP)
        for shard in ((0, 2), (1, 2), (2, 3)):
            for after, limit in ((0, None), (3, 2), (0, 1)):
                got = s.find_since(APP, after, limit=limit, shard=shard)
                want = st["jax"].find_since(APP, after, limit=limit, shard=shard)
                assert _keys(got) == _keys(want), (shard, after, limit)
                assert all(tbase.shard_of(e.entity_id, shard[1]) == shard[0] for e in got)


def test_online_consumer_tails_a_segmentfs_store(tmp_path):
    """The port's consumer over segmentfs events reads each revision once
    across a seal, a compaction and a reopen of the store."""
    from predictionio_tpu_torch.obs.registry import MetricsRegistry
    from predictionio_tpu_torch.online import OnlineConsumer, OnlineConsumerConfig

    class Host:
        scope = "server"
        runtime = object()  # no model: events are consumed, not folded

        def current(self):
            return self.runtime

        def swap(self, old, new):
            return False

    def storage():
        return treg.Storage(treg.StorageConfig(
            sources={"M": treg.SourceConfig("M", "docfs", {"PATH": str(tmp_path / "meta")}),
                     "SEG": treg.SourceConfig("SEG", "segmentfs", {
                         "PATH": str(tmp_path / "seg"), "SEAL_INTERVAL_S": "3600"})},
            repositories={"METADATA": "M", "EVENTDATA": "SEG", "MODELDATA": "M"}))

    def consumer(s):
        return OnlineConsumer(s, Host(), APP, OnlineConsumerConfig(tick_s=9),
                              metrics=MetricsRegistry())

    s1 = storage()
    store = s1.get_events()
    store.insert_batch(_make("port", [_rate(f"u{k}", "i1", 1, n=k) for k in range(5)]), APP)
    c = consumer(s1)
    assert c.tick()["consumed"] == 5
    store.seal(APP)
    for k in range(3):
        store.insert_batch(_make("port", [_rate(f"v{k}_{i}", "i2", 2, n=100 + 10 * k + i)
                                          for i in range(2)]), APP)
        store.seal(APP)
    assert store.compact(APP) >= 1
    assert c.tick()["consumed"] == 6
    assert c.tick() == {"idle": "no new events"}
    store.close()
    s2 = storage()
    s2.get_events().insert(_make("port", [_rate("w", "i3", 3, n=999)])[0], APP)
    c2 = consumer(s2)
    assert c2.cursor == c.cursor
    assert c2.tick()["consumed"] == 1
    assert c2.counters["events_consumed"] == 12
    s2.get_events().close()


# ---------------------------------------------------------------------------
# find_frame: bit-identical to the row path and to the JAX store's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("query_kw", [
    {},
    {"event_names": ["rate"]},
    {"event_names": ["rate", "buy"], "entity_type": "user"},
    {"start_time": T(10), "until_time": T(40)},
    {"target_entity_type": "item"},
    {"filter_target_absent": True},
])
def test_frame_bit_identical_to_the_row_path_and_jax(tmp_path, query_kw):
    specs = _mixed(np.random.RandomState(7))
    with _pair(tmp_path) as st:
        frames = {}
        for pkg, s in st.items():
            evs = _make(pkg, specs)
            s.insert_batch(evs[:25], APP)
            s.seal(APP)
            s.insert_batch(evs[25:45], APP)
            s.seal(APP)
            s.insert_batch(evs[45:], APP)  # the unsealed tail
            q = _query(pkg, **query_kw)
            fast = s.find_frame(q, value_prop="rating", default_value=9.0)
            ref = PACKAGES[pkg][3].from_events(s.find(q), value_prop="rating",
                                               default_value=9.0)
            assert _frame_tuple(fast) == _frame_tuple(ref)
            frames[pkg] = _frame_tuple(fast)
    assert len(frames["port"][0]) > 0
    assert frames["port"] == frames["jax"]


def test_value_prop_overflow_reads_the_sidecar(tmp_path):
    props = {f"p{k:02d}": float(k) for k in range(20)}
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, [_spec("rate", f"u{i}", t=i, target="i0",
                                             props=dict(props), n=i) for i in range(4)]), APP)
            s.seal(APP)
            seg = s._ns[(APP, None)].segments[0]
            overflow = sorted(set(props) - set(seg.footer["value_props"]))
            assert overflow
            q = _query(pkg)
            fast = s.find_frame(q, value_prop=overflow[0], default_value=0.5)
            ref = PACKAGES[pkg][3].from_events(s.find(q), value_prop=overflow[0],
                                               default_value=0.5)
            assert _frame_tuple(fast) == _frame_tuple(ref)
            out[pkg] = (overflow, _frame_tuple(fast))
    assert out["port"] == out["jax"]


def test_sealed_cache_folds_only_the_tail(tmp_path):
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, [_rate(f"u{i}", "i1", i + 1, n=i) for i in range(6)]),
                           APP)
            s.seal(APP)
            q = _query(pkg)
            s.find_frame(q, value_prop="rating")
            m0 = s.frame_cache_stats["misses"]
            s.insert(_make(pkg, [_rate("u9", "i2", 3, t=99, n=99)])[0], APP)
            frame = s.find_frame(q, value_prop="rating")
            after_tail = dict(s.frame_cache_stats)
            s.seal(APP)
            s.find_frame(q, value_prop="rating")
            out[pkg] = (m0, after_tail, dict(s.frame_cache_stats), "u9" in frame.entity_vocab)
    m0, after_tail, after_seal, has_u9 = out["port"]
    assert after_tail == {"hits": 1, "misses": m0} and has_u9
    assert after_seal["misses"] == m0 + 1
    assert out["port"] == out["jax"]


def test_exotic_queries_take_the_row_path(tmp_path):
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, [_rate(f"u{i}", "i1", 1, n=i) for i in range(4)]), APP)
            s.seal(APP)
            q = _query(pkg, entity_id="u1")
            out[pkg] = _frame_tuple(s.find_frame(q))
            with pytest.raises(PACKAGES[pkg][1].StorageError):
                s.find_frame_parts(q)
    assert len(out["port"][0]) == 1 and out["port"] == out["jax"]


def test_frame_parts_lay_the_sealed_rows_first(tmp_path):
    specs = _mixed(np.random.RandomState(3), 40)
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            evs = _make(pkg, specs)
            s.insert_batch(evs[:30], APP)
            s.seal(APP)
            s.insert_batch(evs[30:], APP)
            frame, token, n_sealed = s.find_frame_parts(_query(pkg, event_names=["rate"]),
                                                        value_prop="rating")
            out[pkg] = ([os.path.basename(p) for p in token[0]], token[1:], n_sealed,
                        _frame_tuple(frame))
    assert 0 < out["port"][2] < len(out["port"][3][0])
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# the target posting read and the page materializer
# ---------------------------------------------------------------------------


def test_target_read_prunes_segments(tmp_path):
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, [_rate(f"u{i}", "iA", 1, n=i) for i in range(5)]), APP)
            s.seal(APP)
            s.insert_batch(_make(pkg, [_rate(f"u{i}", "iB", 1, n=10 + i) for i in range(5)]),
                           APP)
            s.seal(APP)
            s.segments_scanned = 0
            got = list(s.find(_query(pkg, target_entity_type="item", target_entity_id="iB")))
            out[pkg] = (s.segments_scanned, _keys(got))
    assert out["port"][0] == 1 and len(out["port"][1]) == 5
    assert out["port"] == out["jax"]


def test_events_page_matches_the_row_materializer(tmp_path):
    specs = ([_rate(f"u{i % 3}", f"i{i % 2}", i + 1, t=i, n=i) for i in range(6)]
             + [_spec("signup", f"u{i}", t=10 + i, props={"x": i}, tags=("a", "b"),
                      pr_id=f"p{i}", n=10 + i) for i in range(3)])
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, specs), APP)
            s.seal(APP)
            seg = s._namespace(APP, None).segments[0]
            rows = np.arange(seg.n_rows)
            page = seg.events_page(rows)
            assert _keys(page) == [_key(seg.event(int(i))) for i in rows]
            out[pkg] = _keys(page)
    assert out["port"] == out["jax"]


def test_generic_find_pages_stay_exact(tmp_path):
    with _pair(tmp_path) as st:
        out = {}
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, [_rate(f"u{i % 4}", f"i{i % 3}", i + 1, t=i, n=i)
                                       for i in range(20)]), APP)
            ids = [e.event_id for e in s.find(_query(pkg))]
            s.delete_batch(ids[3:5], APP)
            pre = _keys(s.find(_query(pkg)))
            s.seal(APP)
            post = _keys(s.find(_query(pkg)))
            assert pre == post and len(post) == 18
            out[pkg] = (post, [e.revision for e in s.find_since(APP, 5, limit=4)])
    assert out["port"][1] == [6, 7, 8, 9]
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# concurrency and the sealer thread
# ---------------------------------------------------------------------------


def test_compaction_vs_tail_read_race(tmp_path):
    store = _open("port", tmp_path / "race", COMPACT_SEGMENTS="2")
    n_total, batch = 400, 20
    errors: list = []
    seen: list = []

    def writer():
        try:
            for b in range(n_total // batch):
                store.insert_batch(_make("port", [
                    dict(_rate(f"u{b}_{i}", f"i{i % 3}", 1, t=b), event_id=f"b{b}_{i}")
                    for i in range(batch)]), APP)
        except BaseException as e:  # noqa: BLE001 — fails the test
            errors.append(e)

    def maintainer():
        try:
            for _ in range(30):
                store.seal(APP)
                store.compact(APP)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            cursor = 0
            while len(seen) < n_total and not errors:
                for e in store.find_since(APP, cursor, limit=64):
                    seen.append(e.event_id)
                    cursor = e.revision
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (writer, maintainer, reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert len(seen) == n_total and len(set(seen)) == n_total
    store.close()


def test_background_sealer_seals_and_close_joins_it(tmp_path):
    store = _open("port", tmp_path / "bg", SEAL_INTERVAL_S="0.02", SEAL_AGE_S="0.01")
    store.insert_batch(_make("port", [_rate(f"u{i}", "i1", 1, n=i) for i in range(8)]), APP)
    deadline = dt.datetime.now() + dt.timedelta(seconds=10)
    while store.segment_stats(APP)["tail_rows"] and dt.datetime.now() < deadline:
        pass
    assert store.segment_stats(APP)["tail_rows"] == 0
    sealer = store._sealer
    assert sealer is not None and sealer.name == "segmentfs-sealer"
    store.close()
    assert not sealer.is_alive()


# ---------------------------------------------------------------------------
# the writer guard
# ---------------------------------------------------------------------------


def _child(code):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_second_writer_process_is_refused(tmp_path):
    path = str(tmp_path / "seg")
    store = _open("port", path)
    store.insert(_make("port", [_rate("u1", "i1", 5)])[0], APP)
    child = _child(f"""
        from predictionio_tpu_torch.data.storage.base import StorageError
        from predictionio_tpu_torch.data.storage.segmentfs import SegmentFSEventStore
        try:
            SegmentFSEventStore({{"PATH": {path!r}}})
        except StorageError as e:
            assert "another process" in str(e) and "pid {os.getpid()}" in str(e), str(e)
            print("REFUSED")
        else:
            print("ACQUIRED")
    """)
    assert child.returncode == 0, child.stderr
    assert "REFUSED" in child.stdout
    store.close()
    child = _child(f"""
        from predictionio_tpu_torch.data.storage.segmentfs import SegmentFSEventStore
        s = SegmentFSEventStore({{"PATH": {path!r}}})
        assert s.latest_revision({APP}) == 1
        s.close()
        print("ACQUIRED")
    """)
    assert child.returncode == 0, child.stderr
    assert "ACQUIRED" in child.stdout


def test_same_process_reopen_is_allowed(tmp_path):
    s1 = _open("port", tmp_path / "seg")
    s1.insert(_make("port", [_rate("u1", "i1", 5)])[0], APP)
    s2 = _open("port", tmp_path / "seg")
    assert s2.latest_revision(APP) == 1
    _crash(s1)
    s2.close()


# ---------------------------------------------------------------------------
# the on-disk layout, read across packages
# ---------------------------------------------------------------------------


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*"))
            if p.is_file() and p.name != ".writer.lock"}


def test_the_same_inserts_write_the_same_bytes(tmp_path):
    """WAL lines, segments (columns, sidecars, footers), tombstones and
    the revision floor, byte for byte, after the same inserts, deletes,
    seals and a compaction."""
    specs = _mixed(np.random.RandomState(11), 90)
    with _pair(tmp_path) as st:
        for pkg, s in st.items():
            evs = _make(pkg, specs)
            s.insert_batch(evs[:30], APP)
            s.insert_batch(evs[30:40], APP)
        assert _files(tmp_path / "port") == _files(tmp_path / "jax")  # the WAL alone
        for pkg, s in st.items():
            evs = _make(pkg, specs)
            s.seal(APP)
            s.insert_batch(evs[40:70], APP)
            s.delete_batch(["e00003", "e00045"], APP)
            s.seal(APP)
            s.insert_batch(evs[70:], APP)
            s.seal(APP)
            s.compact(APP)
            s.insert_batch(_make(pkg, [_rate("late", "i1", 2, t=90, n=500)]), APP)
        port, jax_ = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert any(n.endswith("footer.json") for n in port)
    assert any("/wal-" in n for n in port) and any(n.endswith("tombstones.json") for n in port)
    assert port == jax_


def _write_history(pkg, path, specs):
    """Two sealed segments, a delete, an overwrite of a sealed row, a
    channel and an unsealed tail left in the WAL (the store is dropped
    without close, as in a crash)."""
    s = _open(pkg, path)
    evs = _make(pkg, specs)
    s.insert_batch(evs[:30], APP)
    s.seal(APP)
    s.insert_batch(evs[30:50], APP)
    s.seal(APP)
    s.delete(specs[5]["event_id"], APP)
    s.insert(_make(pkg, [dict(specs[7], entity_id="over", event_time=T(47))])[0], APP)
    s.insert_batch(evs[50:], APP)
    s.init_app(APP, 3)
    s.insert_batch(_make(pkg, [_rate("c", "i1", 4, n=900)]), APP, 3)
    s.seal(APP, 3)
    _crash(s)
    return s


def _read_all(pkg, s):
    out = [_keys(s.find(_query(pkg))), _keys(s.find_since(APP, 0)),
           _keys(s.find(_query(pkg, channel_id=3))), s.segment_stats(APP),
           s.data_signature(APP), s.latest_revision(APP)]
    for kw in ({}, {"event_names": ["rate"]}, {"filter_target_absent": True},
               {"start_time": T(5), "until_time": T(30)}):
        out.append(_frame_tuple(s.find_frame(_query(pkg, **kw), value_prop="rating")))
    frame, token, n_sealed = s.find_frame_parts(_query(pkg), value_prop="rating")
    out.append((_frame_tuple(frame), [os.path.basename(p) for p in token[0]], n_sealed))
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_path_reads_across_packages(tmp_path, writer, reader):
    specs = _mixed(np.random.RandomState(5), 70)
    w = _write_history(writer, tmp_path / "seg", specs)
    want = _read_all(writer, w)
    r = _open(reader, tmp_path / "seg")
    got = _read_all(reader, r)
    assert got == want
    assert want[3]["segments"] == 2 and want[3]["tail_rows"] > 0 and want[3]["dead_rows"] == 2
    # the reader goes on: a seal of the replayed tail and a compaction,
    # read back by a fresh store of the writer's package
    r.seal(APP)
    r.compact(APP)
    r.close()
    again = _open(writer, tmp_path / "seg")
    assert _keys(again.find(_query(writer))) == want[0]
    assert _keys(again.find_since(APP, 0)) == want[1]
    again.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segment_content_hash_equal_across_packages(tmp_path, writer):
    specs = _mixed(np.random.RandomState(2), 40)
    s = _open(writer, tmp_path / "seg")
    s.insert_batch(_make(writer, specs[:20]), APP)
    s.seal(APP)
    s.insert_batch(_make(writer, specs[20:]), APP)
    s.seal(APP)
    s.close()
    segs = sorted((tmp_path / "seg" / "app_1").glob("seg-*"))
    assert len(segs) == 2
    for d in segs:
        footer = json.loads((d / "footer.json").read_text())
        assert tseg.segment_content_hash(str(d)) == jseg.segment_content_hash(str(d)) \
            == footer["content_hash"]


# ---------------------------------------------------------------------------
# the device stager on CPU tensors
# ---------------------------------------------------------------------------


def test_segment_stager_reuses_the_sealed_prefix(tmp_path):
    import torch

    from predictionio_tpu.parallel.loader import SegmentStager as JStager
    from predictionio_tpu_torch.parallel.loader import SegmentStager

    with _pair(tmp_path) as st:
        stats = {}
        for pkg, s in st.items():
            s.insert_batch(_make(pkg, [_rate(f"u{i % 4}", f"i{i % 3}", i + 1, t=i, n=i)
                                       for i in range(12)]), APP)
            s.seal(APP)
        stagers = {"port": SegmentStager("cpu"), "jax": JStager()}
        q = {pkg: _query(pkg, event_names=["rate"]) for pkg in PACKAGES}
        for step in range(3):
            for pkg, s in st.items():
                frame, staged = stagers[pkg].stage(s, q[pkg], value_prop="rating")
                for name in ("entity_idx", "target_idx", "value"):
                    col = np.asarray(staged[name])
                    assert col.tobytes() == getattr(frame, name).tobytes()
                if pkg == "port":
                    assert all(t.device.type == "cpu" for t in staged.values())
                    assert staged["valid"].dtype == torch.float32
                    assert float(staged["valid"].sum()) == len(frame)
                stats[pkg, step] = dict(stagers[pkg].stats)
            if step == 0:
                for pkg, s in st.items():
                    s.insert_batch(_make(pkg, [_rate("u9", "i9", 2, t=99, n=99)]), APP)
            if step == 1:
                for s in st.values():
                    s.seal(APP)
    assert stats["port", 0] == {"sealed_restage": 1, "sealed_reuse": 0, "bytes_staged": 144}
    assert stats["port", 1] == {"sealed_restage": 1, "sealed_reuse": 1, "bytes_staged": 156}
    assert stats["port", 2]["sealed_restage"] == 2
    assert {k: v for k, v in stats.items() if k[0] == "port"} == \
        {("port", k[1]): v for k, v in stats.items() if k[0] == "jax"}


def test_segment_stager_keeps_staged_tensors_apart_from_its_buffers(tmp_path):
    """A tensor handed out stays as it was when the stager refills its
    host buffers for the next call."""
    from predictionio_tpu_torch.parallel.loader import SegmentStager

    s = _open("port", tmp_path / "seg")
    s.insert_batch(_make("port", [_rate(f"u{i}", "i1", i + 1, n=i) for i in range(5)]), APP)
    s.seal(APP)
    stager = SegmentStager("cpu")
    s.insert_batch(_make("port", [_rate("u8", "i1", 6, n=8)]), APP)
    _, first = stager.stage(s, _query("port"), value_prop="rating")
    s.insert_batch(_make("port", [_rate("u9", "i1", 7, n=9)]), APP)
    _, second = stager.stage(s, _query("port"), value_prop="rating")
    assert stager.stats == {"sealed_restage": 1, "sealed_reuse": 1,
                            "bytes_staged": 5 * 12 + 1 * 12 + 2 * 12}
    assert first["value"].tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert second["value"].tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
    s.close()


def test_segment_stager_needs_the_card_by_default():
    import torch

    from predictionio_tpu_torch.parallel.loader import SegmentStager

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegmentStager()


# ---------------------------------------------------------------------------
# the data view, the Event Server, the console
# ---------------------------------------------------------------------------


def _seg_config(reg, tmp_path, meta="memory"):
    meta_settings = {"PATH": str(tmp_path / "meta")} if meta == "docfs" else {}
    return reg.StorageConfig(
        sources={"M": reg.SourceConfig("M", meta, meta_settings),
                 "SEG": reg.SourceConfig("SEG", "segmentfs", {
                     "PATH": str(tmp_path / "seg"), "SEAL_INTERVAL_S": "3600"})},
        repositories={"METADATA": "M", "EVENTDATA": "SEG", "MODELDATA": "M"})


def test_data_view_delegates_to_the_segment_cache(tmp_path):
    from predictionio_tpu.data.view import DataView as JView
    from predictionio_tpu_torch.data.view import DataView

    out = {}
    for pkg, reg, base, view in (("port", treg, tbase, DataView),
                                 ("jax", jreg, jbase, JView)):
        storage = reg.Storage(_seg_config(reg, tmp_path / pkg))
        app_id = storage.get_meta_data_apps().insert(base.App(0, "segapp"))
        store = storage.get_events()
        store.insert_batch(_make(pkg, [_rate(f"u{i}", f"i{i % 2}", i + 1, t=i, n=i)
                                       for i in range(6)]), app_id)
        store.seal(app_id)
        v = view(view_dir=str(tmp_path / pkg / "view"))
        view.stats = {"hits": 0, "misses": 0}
        seen = []
        f1 = v.find_frame(storage, "segapp", value_prop="rating")
        seen.append(dict(view.stats))
        v.find_frame(storage, "segapp", value_prop="rating")
        seen.append(dict(view.stats))
        store.insert(_make(pkg, [_rate("u9", "i0", 2, t=50, n=50)])[0], app_id)
        f3 = v.find_frame(storage, "segapp", value_prop="rating")
        seen.append(dict(view.stats))
        assert not (tmp_path / pkg / "view").exists()
        out[pkg] = (seen, _frame_tuple(f1), _frame_tuple(f3), dict(store.frame_cache_stats))
        store.close()
    assert out["port"][0] == [{"hits": 0, "misses": 1}, {"hits": 1, "misses": 1},
                              {"hits": 2, "misses": 1}]
    assert out["port"] == out["jax"]


def _http(port, path, method="GET"):
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                               data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(r, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "null")


def _events_json(n0, n):
    return [{"event": "rate", "entityType": "user", "entityId": f"u{k % 7}",
             "targetEntityType": "item", "targetEntityId": f"i{k % 5}",
             "properties": {"rating": k % 5 + 1}, "eventId": f"ev{k:04d}",
             "eventTime": "2024-01-01T00:00:00.000Z"} for k in range(n0, n0 + n)]


def _segments_script(port, post):
    out = []
    for n0 in (0, 40):
        for k in range(n0, n0 + 40, 20):
            post(port, _events_json(k, 20))
        out.append(_http(port, "/segments/stats?accessKey=SKEY"))
        out.append(_http(port, "/segments/seal?accessKey=SKEY", "POST"))
        out.append(_http(port, "/segments/stats?accessKey=SKEY"))
    out.append(_http(port, "/segments/seal?accessKey=SKEY", "POST"))  # nothing left
    for path, method in (("/segments/compact", "POST"), ("/segments/stats", "GET"),
                         ("/segments/compact", "POST"), ("/segments/seal", "GET"),
                         ("/segments/stats", "POST"), ("/segments/other", "GET")):
        out.append(_http(port, f"{path}?accessKey=SKEY", method))
    out.append(_http(port, "/segments/stats?accessKey=WRONG"))
    out.append(_http(port, "/segments/seal"))
    return out


def test_segments_routes_answer_as_the_jax_server(tmp_path):
    from predictionio_tpu.data.api.server import EventServer as JServer
    from predictionio_tpu.data.api.server import EventServerConfig as JConfig
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig

    def post(port, batch):
        r = urllib.request.Request(f"http://127.0.0.1:{port}/batch/events.json?accessKey=SKEY",
                                   data=json.dumps(batch).encode(), method="POST",
                                   headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=10) as resp:
            assert resp.status == 200

    answers = {}
    for pkg, reg, base, server, config in (("port", treg, tbase, EventServer, EventServerConfig),
                                           ("jax", jreg, jbase, JServer, JConfig)):
        storage = reg.Storage(_seg_config(reg, tmp_path / pkg, meta="docfs"))
        app_id = storage.get_meta_data_apps().insert(base.App(0, "segapp"))
        storage.get_meta_data_access_keys().insert(base.AccessKey("SKEY", app_id, ()))
        srv = server(storage, config(ip="127.0.0.1", port=0, wal_dir=None))
        port = srv.start()
        try:
            answers[pkg] = _segments_script(port, post)
        finally:
            srv.stop()
            storage.get_events().close()
    got, want = answers["port"], answers["jax"]
    assert got[1] == (200, {"sealedRows": 40}) and got[7][0] == 200
    assert got[6] == (200, {"sealedRows": 0})
    for n, (g, w) in enumerate(zip(got, want)):
        assert g == w, n
    assert len(got) == len(want)


def test_segments_routes_404_without_segmentfs(tmp_path):
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig

    storage = treg.Storage(treg.StorageConfig.memory())
    app_id = storage.get_meta_data_apps().insert(tbase.App(0, "memapp"))
    storage.get_meta_data_access_keys().insert(tbase.AccessKey("SKEY", app_id, ()))
    srv = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    port = srv.start()
    try:
        for path, method in (("/segments/stats", "GET"), ("/segments/seal", "POST"),
                             ("/segments/compact", "POST")):
            status, body = _http(port, f"{path}?accessKey=SKEY", method)
            assert status == 404 and "segmentfs" in body["message"]
    finally:
        srv.stop()


def test_segments_op_failure_is_a_503(tmp_path, monkeypatch):
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig

    storage = treg.Storage(_seg_config(treg, tmp_path))
    app_id = storage.get_meta_data_apps().insert(tbase.App(0, "segapp"))
    storage.get_meta_data_access_keys().insert(tbase.AccessKey("SKEY", app_id, ()))
    store = storage.get_events()

    def broken(*a, **k):
        raise OSError("no space left")

    monkeypatch.setattr(store, "seal", broken)
    monkeypatch.setattr(store, "segment_stats", broken)
    srv = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    port = srv.start()
    try:
        assert _http(port, "/segments/seal?accessKey=SKEY", "POST") == (
            503, {"message": "seal failed: no space left"})
        assert _http(port, "/segments/stats?accessKey=SKEY") == (
            503, {"message": "segment stats failed: no space left"})
    finally:
        srv.stop()
        store.close()


def _storage_env(tmp_path):
    return {"PIO_STORAGE_SOURCES_SEG_TYPE": "segmentfs",
            "PIO_STORAGE_SOURCES_SEG_PATH": str(tmp_path / "seg"),
            "PIO_STORAGE_SOURCES_SEG_SEAL_INTERVAL_S": "3600",
            "PIO_STORAGE_SOURCES_DOC_TYPE": "docfs",
            "PIO_STORAGE_SOURCES_DOC_PATH": str(tmp_path / "meta"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DOC",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SEG",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DOC"}


def _segment_lines(text):
    return [ln for ln in text.splitlines() if "segmentfs app" in ln or "event server" in ln]


def test_console_status_prints_the_jax_segment_line(tmp_path, monkeypatch):
    from predictionio_tpu.tools import console as jconsole
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig
    from predictionio_tpu_torch.tools import console

    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)
    monkeypatch.setattr(jreg.Storage, "_instance", None)  # the JAX console's singleton
    for k, v in _storage_env(tmp_path).items():
        monkeypatch.setenv(k, v)
    storage = treg.Storage()
    for name in ("one", "two"):
        app_id = storage.get_meta_data_apps().insert(tbase.App(0, name))
        storage.get_meta_data_access_keys().insert(tbase.AccessKey(f"K{name}", app_id, ()))
    store = storage.get_events()
    store.insert_batch(_make("port", [_rate(f"u{i}", "i1", 1, n=i) for i in range(10)]), 1)
    store.seal(1)
    store.insert_batch(_make("port", [_rate(f"v{i}", "i1", 1, n=20 + i) for i in range(3)]), 1)
    store.delete("e00002", 1)
    _crash(store)  # the tail stays in the WAL for the readers below

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue()

    rc_j, out_j = run(jconsole.main, ["status"])
    _crash(jreg.Storage._instance.get_events())  # left as it was: no seal at close
    rc_t, out_t = run(console.main, ["status"])
    assert rc_t == 0 == rc_j
    lines = _segment_lines(out_t)
    assert lines == _segment_lines(out_j)
    assert lines == ["[INFO]   segmentfs app 1 (one): 1 segment(s), 10 sealed + 3 tail "
                     "row(s), 1 dead, rev 13",
                     "[INFO]   segmentfs app 2 (two): 0 segment(s), 0 sealed + 0 tail "
                     "row(s), 0 dead, rev 0"]
    # --event-url reads a running server's /segments/stats (over a memory
    # store the route's 404 is a warning)
    srv_storage = treg.Storage(_seg_config(treg, tmp_path / "live"))
    app_id = srv_storage.get_meta_data_apps().insert(tbase.App(0, "live"))
    srv_storage.get_meta_data_access_keys().insert(tbase.AccessKey("LKEY", app_id, ()))
    srv_storage.get_events().insert_batch(
        _make("port", [_rate("x", "i1", 1, n=i) for i in range(4)]), app_id)
    srv = EventServer(srv_storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    port = srv.start()
    try:
        url = f"http://127.0.0.1:{port}"
        argv = ["status", "--event-url", url, "--access-key", "LKEY"]
        _, out_t = run(console.main, argv)
        _, out_j = run(jconsole.main, argv)
        _, bad = run(console.main, ["status", "--event-url", url, "--access-key", "NOPE"])
    finally:
        srv.stop()
        srv_storage.get_events().close()
    want = f"[INFO] event server {url}: 0 segment(s), 0 sealed + 4 tail row(s), 0 dead, rev 4"
    assert want in _segment_lines(out_t) and want in _segment_lines(out_j)
    assert "[WARN] event-server segment stats unavailable: HTTP Error 401" in bad
