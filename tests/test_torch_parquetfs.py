"""The port's parquetfs event store against the JAX package's, on the CPU.

- The schema is the JAX schema (its nullable ``revision`` included), and
  both codecs agree: ``events_to_table`` gives equal tables, and
  ``table_to_events`` of either package's table gives equal events (a
  malformed row warned and skipped at the same physical index).
- Segments, tombstones, ``flush`` and the revision sequence: the same
  operations leave the same files (segment tables equal, the same
  tombstones.json) and the same reads; a store reopened over the PATH
  continues the revision sequence.
- Cross-reads: the two packages on one PATH read each other's segments
  and tombstones in both directions, pre-revision segment files included.
- ``find_frame`` (the column-projected scan, with the shard, time, event
  and type filters and the value property) equals the JAX frame column
  for column; ``find_since`` with ``shard`` and ``limit`` equals the JAX
  tail.
"""

import datetime as dt
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data import event as jevent  # noqa: E402
from predictionio_tpu.data.storage import base as jbase  # noqa: E402
from predictionio_tpu.data.storage import parquetfs as jpq  # noqa: E402
from predictionio_tpu_torch.data import event as tevent  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import parquetfs as tpq  # noqa: E402

PKG = {"jax": (jevent, jbase, jpq), "port": (tevent, tbase, tpq)}
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _events(pkg, n=48, seed=11, prefix="p"):
    """Seeded rates, views and $set events of 8 users on 5 items, some at
    one time stamp, a zero rating among them, with explicit ids."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = str(rng.choice(["rate", "rate", "view", "$set"]))
        target = kind != "$set"
        props = ({"rating": float(rng.integers(0, 6))} if kind == "rate"
                 else {"plan": "a"} if kind == "$set" else {})
        out.append(PKG[pkg][0].Event(
            event=kind, entity_type="user", entity_id=f"u{rng.integers(8)}",
            target_entity_type="item" if target else None,
            target_entity_id=f"i{rng.integers(5)}" if target else None,
            properties=props,
            event_time=T0 + dt.timedelta(seconds=0 if k % 4 == 0 else int(rng.integers(1, 90))),
            creation_time=T0 + dt.timedelta(seconds=k), tags=("x",) if k % 6 == 0 else (),
            pr_id="pr" if k % 7 == 0 else None, event_id=f"{prefix}{k:03d}"))
    return out


def _json(events):
    return [e.to_json_dict() for e in events]


def _frame_tuple(f):
    return (f.event_code.tolist(), f.entity_idx.tolist(), f.target_idx.tolist(),
            f.time_ms.tolist(), f.value.tobytes(), f.event_vocab.to_dict(),
            f.entity_vocab.to_dict(), f.target_vocab.to_dict(), f.entity_type,
            f.target_entity_type)


def _store(pkg, path):
    return PKG[pkg][2].ParquetFSEventStore({"PATH": str(path)})


def _segments(path, app="app_1"):
    d = os.path.join(path, app)
    return sorted(f for f in os.listdir(d) if f.startswith("seg-"))


# -- schema and codecs ------------------------------------------------------------


def test_schema_is_the_jax_schema():
    assert tpq._SCHEMA.equals(jpq._SCHEMA)
    assert tpq._SCHEMA.field("revision").nullable
    assert tpq.ParquetFSEventStore.FLUSH_THRESHOLD == jpq.ParquetFSEventStore.FLUSH_THRESHOLD


def test_events_to_table_equals_jax():
    tables = {pkg: PKG[pkg][2].events_to_table(_events(pkg)) for pkg in PKG}
    assert tables["port"].equals(tables["jax"])
    # unstored events carry a null revision; stored ones their own
    stored = [e.with_revision(k + 1) for k, e in enumerate(_events("port", 5))]
    assert tpq.events_to_table(stored).column("revision").to_pylist() == [1, 2, 3, 4, 5]
    assert tpq.events_to_table(_events("port", 3)).column("revision").null_count == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_table_to_events_reads_either_table(writer):
    table = PKG[writer][2].events_to_table(_events(writer))
    got = {pkg: _json(PKG[pkg][2].table_to_events(table)) for pkg in PKG}
    assert got["port"] == got["jax"] == _json(_events(writer))
    # a table without the revision column (a pre-revision file) decodes too
    old = table.drop(["revision"])
    assert _json(tpq.table_to_events(old)) == _json(jpq.table_to_events(old))


def test_malformed_rows_warned_at_the_same_index():
    table = tpq.events_to_table(_events("port", 6))
    bad = table.set_column(
        table.schema.get_field_index("properties"), "properties",
        pa.array(['{"rating": 1}', "not json", "{}", "[", "{}", "{}"], pa.string()))
    seen = {}
    for pkg in PKG:
        errors = []
        out = list(PKG[pkg][2].table_to_events(
            bad, on_error=lambda i, e, errors=errors: errors.append(i), with_index=True))
        seen[pkg] = ([i for i, _ in out], errors)
    assert seen["port"] == seen["jax"] == ([0, 2, 4, 5], [1, 3])
    with pytest.raises(ValueError):
        list(tpq.table_to_events(bad))


# -- segments, tombstones, flush ----------------------------------------------------


def _script(pkg, path, monkeypatch):
    """Writes, deletes and reads over a store at FLUSH_THRESHOLD 16."""
    monkeypatch.setattr(PKG[pkg][2].ParquetFSEventStore, "FLUSH_THRESHOLD", 16)
    store = _store(pkg, path)
    events = _events(pkg)
    base = PKG[pkg][1]
    store.init_app(1)
    steps = [store.insert_batch(events[:10], 1), _segments(path)]  # buffered
    store.insert_batch(events[10:30], 1)  # past the threshold: a segment
    steps.append(_segments(path))
    steps.append(store.insert(events[30], 1))
    steps += [store.delete(events[3].event_id, 1), store.delete(events[3].event_id, 1),
              store.delete_batch([events[4].event_id, events[30].event_id, "nope"], 1),
              _segments(path)]  # a delete flushes first
    store.insert_batch(events[31:], 1, 2)
    store.flush()
    steps += [_segments(path), _segments(path, "app_1_2"),
              _json(store.find(base.EventQuery(app_id=1))),
              _json(store.find(base.EventQuery(app_id=1, channel_id=2, reversed=True,
                                               limit=5))),
              None if store.get(events[3].event_id, 1) is None else "found",
              store.get(events[7].event_id, 1).to_json_dict(),
              store.latest_revision(1), store.latest_revision(1, 2),
              store.data_signature(1), store.data_signature(9)]
    return steps


def test_segments_tombstones_and_flush_match_jax(tmp_path, monkeypatch):
    got = {pkg: _script(pkg, tmp_path / pkg, monkeypatch) for pkg in PKG}
    assert got["port"] == got["jax"]
    assert got["port"][1] == [] and got["port"][2] == ["seg-00000000.parquet"]
    for seg in _segments(tmp_path / "port"):
        a = pq.read_table(tmp_path / "port" / "app_1" / seg)
        b = pq.read_table(tmp_path / "jax" / "app_1" / seg)
        assert a.equals(b), seg
    stones = [json.loads((tmp_path / pkg / "app_1" / "tombstones.json").read_text())
              for pkg in ("port", "jax")]
    assert stones[0] == stones[1] and len(stones[0]) == 3


def test_reopen_continues_the_revision_sequence(tmp_path):
    store = _store("port", tmp_path)
    store.insert_batch(_events("port")[:20], 1)
    store.flush()
    again = _store("port", tmp_path)
    assert again.latest_revision(1) == 20
    again.insert_batch(_events("port")[20:25], 1)
    assert [e.revision for e in again.find_since(1, 18)] == [19, 20, 21, 22, 23, 24, 25]
    assert again.remove_app(1) and again.latest_revision(1) == 0


# -- cross-reads ------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segments_and_tombstones_read_across(tmp_path, writer):
    """The writer's segments, tombstones and revisions under one PATH
    read through the reader's store, and the reader's writes continue
    the writer's sequence where the writer reads them back."""
    reader = "port" if writer == "jax" else "jax"
    w, r = _store(writer, tmp_path), _store(reader, tmp_path)
    events = _events(writer)
    w.insert_batch(events[:30], 1)
    w.delete_batch([events[2].event_id, events[9].event_id], 1)
    w.insert_batch(events[30:40], 1)
    w.flush()
    wq, rq = PKG[writer][1].EventQuery, PKG[reader][1].EventQuery
    assert _json(r.find(rq(app_id=1))) == _json(w.find(wq(app_id=1)))
    assert len(_json(r.find(rq(app_id=1)))) == 38
    assert _json(r.find_since(1, 25)) == _json(w.find_since(1, 25))
    assert _frame_tuple(r.find_frame(rq(app_id=1), value_prop="rating")) == _frame_tuple(
        w.find_frame(wq(app_id=1), value_prop="rating"))
    assert r.data_signature(1) == w.data_signature(1)
    r.insert_batch(_events(reader)[40:], 1)
    r.delete(events[0].event_id, 1)  # flushes the reader's buffer
    fresh = _store(writer, tmp_path)
    assert fresh.latest_revision(1) == 48
    assert [e.event_id for e in fresh.find_since(1, 40)] == [
        e.event_id for e in _events(reader)[40:]]
    assert fresh.get(events[0].event_id, 1) is None


def test_pre_revision_segments_read_in_both(tmp_path):
    """A segment file without the revision column (an older writer) beside
    new ones: both packages read it, and neither tails its rows."""
    d = tmp_path / "app_1"
    d.mkdir(parents=True)
    old = tpq.events_to_table(_events("port", 10)).drop(["revision"])
    pq.write_table(old, d / "seg-00000000.parquet")
    for pkg in PKG:
        store = _store(pkg, tmp_path)
        store.insert_batch(_events(pkg, 20)[10:], 1)
        store.flush()
    reads = {pkg: (_json(_store(pkg, tmp_path).find(PKG[pkg][1].EventQuery(app_id=1))),
                   _json(_store(pkg, tmp_path).find_since(1, 0)),
                   _store(pkg, tmp_path).latest_revision(1)) for pkg in PKG}
    assert reads["port"] == reads["jax"]
    assert len(reads["port"][0]) == 30 and reads["port"][2] == 20


# -- find_frame and find_since against the JAX store -----------------------------------


FRAME_CASES = {
    "all": {},
    "rate": {"event_names": ["rate"], "entity_type": "user", "target_entity_type": "item"},
    "time": {"start_time": T0 + dt.timedelta(seconds=10),
             "until_time": T0 + dt.timedelta(seconds=70)},
    "shard": {"shard": (1, 3)},
    "shard_rate": {"shard": (0, 2), "event_names": ["rate"]},
    "no_match": {"entity_type": "shop"},
}


@pytest.fixture()
def fed(tmp_path):
    stores = {}
    for pkg in PKG:
        store = _store(pkg, tmp_path / pkg)
        events = _events(pkg)
        store.insert_batch(events[:24], 1)
        store.flush()  # two segments
        store.insert_batch(events[24:], 1)
        store.delete_batch([events[5].event_id, events[30].event_id], 1)
        stores[pkg] = store
    return stores


@pytest.mark.parametrize("value_prop", [None, "rating"])
@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_find_frame_matches_jax(fed, case, value_prop):
    got = {pkg: _frame_tuple(fed[pkg].find_frame(
        PKG[pkg][1].EventQuery(app_id=1, **FRAME_CASES[case]), value_prop=value_prop,
        default_value=0.5)) for pkg in PKG}
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == (0 if case == "no_match" else len(got["port"][0]))
    if case == "all":
        assert len(got["port"][0]) == 46


def test_find_since_and_shards_match_jax(fed):
    for after, limit, shard in ((0, None, None), (20, None, None), (5, 6, None),
                                (0, None, (1, 2)), (10, 3, (2, 3)), (48, None, None)):
        got = {pkg: _json(fed[pkg].find_since(1, after, limit=limit, shard=shard))
               for pkg in PKG}
        assert got["port"] == got["jax"], (after, limit, shard)
    for n in (2, 3):
        parts = [[e.event_id for e in fed["port"].find(tbase.EventQuery(app_id=1, shard=(i, n)))]
                 for i in range(n)]
        assert sorted(sum(parts, [])) == sorted(
            e.event_id for e in fed["port"].find(tbase.EventQuery(app_id=1)))
    got = {pkg: {k: _json(v) for k, v in fed[pkg].find_entities_batch(
        1, "user", ["u2", "u5"], event_names=["rate"], limit_per_entity=2).items()}
        for pkg in PKG}
    assert got["port"] == got["jax"]
