"""The port's self-cleaning data source (core/self_cleaning.py) against
the JAX package's: tests/test_self_cleaning.py's cases, and a seeded
stream with every kind of dirt, go into both packages' stores (memory
and sqlite) with explicit event ids and times; each package cleans its
own. The counters must be equal, and so must the surviving events
(name, entity, target, properties and time; a compacted snapshot's id
is new in each store, every other survivor keeps its id)."""

import datetime as dt

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.core.self_cleaning import (  # noqa: E402
    EventWindow as JWindow,
    SelfCleaningDataSource as JSource,
)
from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App as JApp, EventQuery as JQuery  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.core.self_cleaning import (  # noqa: E402
    EventWindow,
    SelfCleaningDataSource,
    parse_duration,
)
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App, EventQuery  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)

UTC = dt.timezone.utc
APP = "clean"
KINDS = ["memory", "sqlite"]


class _Port(SelfCleaningDataSource):
    def __init__(self, window):
        self.app_name = APP
        self.event_window = window


class _Jax(JSource):
    def __init__(self, window):
        self.app_name = APP
        self.event_window = window


def _stores(kind, path):
    if kind == "memory":
        port = Storage(StorageConfig.memory())
        jax = JStorage(JStorageConfig(
            sources={"MEM": JSourceConfig("MEM", "memory", {})},
            repositories={"METADATA": "MEM", "EVENTDATA": "MEM", "MODELDATA": "MEM"}))
    else:
        port = Storage(StorageConfig(
            sources={"S": SourceConfig("S", "sqlite", {"PATH": str(path / "port.db")})},
            repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
        jax = JStorage(JStorageConfig(
            sources={"S": JSourceConfig("S", "sqlite", {"PATH": str(path / "jax.db")})},
            repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
    tid = port.get_meta_data_apps().insert(App(0, APP))
    jid = jax.get_meta_data_apps().insert(JApp(0, APP))
    port.get_events().init_app(tid)
    jax.get_events().init_app(jid)
    return (port, tid), (jax, jid)


def _view(e, jax=False):
    props = e.properties.to_dict() if jax else dict(e.properties)
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, repr(sorted(props.items())), e.event_time)


def _clean(kind, path, rows, window):
    """Insert `rows` (Event kwargs) into both packages' stores, clean
    each with `window` (EventWindow kwargs or None); returns (port
    counters, JAX counters, port survivors, JAX survivors, the ids kept
    in both)."""
    (port, tid), (jax, jid) = _stores(kind, path)
    port.get_events().insert_batch([Event(**r) for r in rows], tid)
    jax.get_events().insert_batch([JEvent(**r) for r in rows], jid)
    got = _Port(None if window is None else EventWindow(**window)
                ).clean_persisted_events(RuntimeContext(storage=port))
    want = _Jax(None if window is None else JWindow(**window)
                ).clean_persisted_events(JContext(storage=jax))
    tleft = list(port.get_events().find(EventQuery(app_id=tid)))
    jleft = list(jax.get_events().find(JQuery(app_id=jid)))
    ids = {r["event_id"] for r in rows}
    kept = ({e.event_id for e in tleft} & ids, {e.event_id for e in jleft} & ids)
    return (got, want, sorted(map(_view, tleft), key=repr),
            sorted((_view(e, jax=True) for e in jleft), key=repr), kept)


def _assert_same(kind, path, rows, window):
    got, want, tleft, jleft, (tkept, jkept) = _clean(kind, path, rows, window)
    assert got == want
    assert tleft == jleft
    assert tkept == jkept
    return got, tleft


def _ev(n, **kw):
    return dict(kw, event_id=f"ev{n:04d}")


T0 = dt.datetime(2026, 1, 1, tzinfo=UTC)


def test_parse_duration():
    from predictionio_tpu.core.self_cleaning import parse_duration as jparse

    for s in ("4 days", "12 hours", "1 week", "90 seconds", " 3 minutes "):
        assert parse_duration(s) == jparse(s)
    assert parse_duration("4 days") == dt.timedelta(days=4)
    with pytest.raises(ValueError):
        parse_duration("fortnight")


@pytest.mark.parametrize("kind", KINDS)
def test_compress_properties(kind, tmp_path):
    rows = [
        _ev(0, event="$set", entity_type="item", entity_id="i1",
            properties={"a": 1, "b": 2}, event_time=T0),
        _ev(1, event="$set", entity_type="item", entity_id="i1",
            properties={"a": 9}, event_time=T0 + dt.timedelta(days=1)),
        _ev(2, event="$unset", entity_type="item", entity_id="i1",
            properties={"b": None}, event_time=T0 + dt.timedelta(days=2)),
        _ev(3, event="$set", entity_type="item", entity_id="i2",
            properties={"x": 1}, event_time=T0),
    ]
    stats, left = _assert_same(kind, tmp_path, rows, {"compress_properties": True})
    assert stats["compacted"] == 3
    i1 = [v for v in left if v[2] == "i1"]
    assert len(i1) == 1 and i1[0][0] == "$set" and i1[0][5] == repr([("a", 9)])
    assert i1[0][6] == T0 + dt.timedelta(days=2)  # the last update's time
    assert len([v for v in left if v[2] == "i2"]) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_compact_fully_deleted_entity(kind, tmp_path):
    rows = [
        _ev(0, event="$set", entity_type="item", entity_id="gone",
            properties={"a": 1}, event_time=T0),
        _ev(1, event="$delete", entity_type="item", entity_id="gone",
            event_time=T0 + dt.timedelta(days=1)),
    ]
    stats, left = _assert_same(kind, tmp_path, rows, {"compress_properties": True})
    assert stats["compacted"] == 2 and left == []


@pytest.mark.parametrize("kind", KINDS)
def test_remove_duplicates(kind, tmp_path):
    dup = dict(event="buy", entity_type="user", entity_id="u1",
               target_entity_type="item", target_entity_id="i1")
    rows = [_ev(0, **dup, event_time=T0),
            _ev(1, **dup, event_time=T0 + dt.timedelta(hours=1)),
            _ev(2, **dup, event_time=T0 + dt.timedelta(hours=2)),
            _ev(3, event="buy", entity_type="user", entity_id="u2",
                target_entity_type="item", target_entity_id="i1", event_time=T0)]
    stats, left = _assert_same(kind, tmp_path, rows, {"remove_duplicates": True})
    assert stats["deduplicated"] == 2 and len(left) == 2
    assert [v[6] for v in left if v[2] == "u1"] == [T0]  # the earliest copy stays


@pytest.mark.parametrize("kind", KINDS)
def test_remove_duplicates_with_list_valued_properties(kind, tmp_path):
    base = dict(event="view", entity_type="user", entity_id="u1",
                target_entity_type="item", target_entity_id="i1",
                properties={"categories": ["a", "b"], "meta": {"k": 1}})
    rows = [_ev(0, **base, event_time=T0),
            _ev(1, **base, event_time=T0 + dt.timedelta(hours=1))]
    stats, left = _assert_same(kind, tmp_path, rows, {"remove_duplicates": True})
    assert stats["deduplicated"] == 1 and len(left) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_age_out(kind, tmp_path):
    now = dt.datetime.now(UTC)
    rows = [
        _ev(0, event="view", entity_type="user", entity_id="old",
            target_entity_type="item", target_entity_id="i1",
            event_time=now - dt.timedelta(days=30)),
        _ev(1, event="view", entity_type="user", entity_id="new",
            target_entity_type="item", target_entity_id="i1",
            event_time=now - dt.timedelta(hours=1)),
        # a $set carries state, not history: it does not age out
        _ev(2, event="$set", entity_type="item", entity_id="i1",
            properties={"a": 1}, event_time=now - dt.timedelta(days=60)),
    ]
    stats, left = _assert_same(kind, tmp_path, rows, {"duration": "7 days"})
    assert stats["aged_out"] == 1
    assert {v[2] for v in left} == {"new", "i1"}


@pytest.mark.parametrize("kind", KINDS)
def test_no_window_is_noop(kind, tmp_path):
    rows = [_ev(0, event="view", entity_type="user", entity_id="u",
                target_entity_type="item", target_entity_id="i", event_time=T0)]
    stats, left = _assert_same(kind, tmp_path, rows, None)
    assert stats == {"compacted": 0, "deduplicated": 0, "aged_out": 0}
    assert len(left) == 1


def _dirty_stream(seed, now):
    """A seeded stream with every kind of dirt: $set/$unset/$delete
    histories (equal times among them), exact duplicates with and without
    properties, and events on both sides of a 10-day window."""
    rng = np.random.RandomState(seed)
    rows = []
    for n in range(400):
        r = rng.rand()
        t = now - dt.timedelta(days=float(rng.choice([1, 3, 9, 15, 40])),
                               seconds=int(rng.randint(0, 4)))
        if r < 0.3:
            eid = f"i{rng.randint(12)}"
            kind = rng.choice(["$set", "$set", "$unset", "$delete"])
            props = ({} if kind == "$delete" else
                     {f"p{rng.randint(4)}": int(rng.randint(100))
                      if kind == "$set" else None})
            rows.append(_ev(n, event=str(kind), entity_type="item", entity_id=eid,
                            properties=props, event_time=t))
        else:
            props = {} if rng.rand() < 0.6 else {"w": [int(rng.randint(2)), "x"]}
            rows.append(_ev(n, event=str(rng.choice(["buy", "view"])), entity_type="user",
                            entity_id=f"u{rng.randint(15)}", target_entity_type="item",
                            target_entity_id=f"i{rng.randint(6)}", properties=props,
                            event_time=t))
    return rows


@pytest.mark.parametrize("kind", KINDS)
def test_seeded_stream_cleans_like_jax(kind, tmp_path):
    now = dt.datetime.now(UTC)
    rows = _dirty_stream(7, now)
    window = {"duration": "10 days", "remove_duplicates": True,
              "compress_properties": True}
    stats, left = _assert_same(kind, tmp_path, rows, window)
    # the counters against a plain count of the same rows
    special = [r for r in rows if r["event"].startswith("$")]
    per = {}
    for r in special:
        per.setdefault(r["entity_id"], []).append(r)
    regular = sorted((r for r in rows if not r["event"].startswith("$")),
                     key=lambda r: (r["event_time"], r["event_id"]))
    seen, dups = set(), set()
    for r in regular:
        key = (r["event"], r["entity_id"], r["target_entity_id"],
               repr(sorted(r["properties"].items())))
        (dups.add(r["event_id"]) if key in seen else seen.add(key))
    cutoff = now - dt.timedelta(days=10)
    assert stats == {
        "compacted": sum(len(v) for v in per.values() if len(v) > 1),
        "deduplicated": len(dups),
        "aged_out": sum(1 for r in regular
                        if r["event_time"] < cutoff and r["event_id"] not in dups),
    }
    assert all(v[6] >= cutoff for v in left if not v[0].startswith("$"))
