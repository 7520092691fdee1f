"""Item properties on the port against the JAX package.

- ``DataMap`` / ``PropertyMap``: every getter and combinator gives the
  same value, or the same error type and message, on the same fields.
- Aggregation: seeded $set/$unset/$delete streams (with events at equal
  times, ties broken by event id in both packages' `find` order) go
  into the port's memory and sqlite stores and into the JAX stores of
  the same backend; ``aggregate_properties`` (with and without
  ``required``), ``aggregate_properties_of_entity`` and the facade's
  read give equal PropertyMaps, first and last update times included.
- ``find_by_entity``: the same events in the same order, newest first by
  default, oldest first with ``latest=False``, cut to the limit.
- ``data_signature``: moves at every insert and delete, and reads the
  same as the JAX store's after the same writes.
"""

import datetime as dt

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data import aggregator as jagg  # noqa: E402
from predictionio_tpu.data import datamap as jdm  # noqa: E402
from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App as JApp  # noqa: E402
from predictionio_tpu.data.storage.memory import MemoryEventStore as JMemory  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.data.storage.sqlite import SqliteEventStore as JSqlite  # noqa: E402
from predictionio_tpu.data.store.event_store import EventStoreFacade as JFacade  # noqa: E402
from predictionio_tpu_torch.data import aggregator as tagg  # noqa: E402
from predictionio_tpu_torch.data import datamap as tdm  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.memory import MemoryEventStore  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.data.storage.sqlite import SqliteEventStore  # noqa: E402
from predictionio_tpu_torch.data.store.event_store import (  # noqa: E402
    EventStoreFacade,
    LEventStore,
    PEventStore,
)

T0 = dt.datetime(2024, 6, 1, tzinfo=dt.timezone.utc)

FIELDS = {"n": 3, "x": 2.5, "s": "abc", "b": True, "l": [1, 2, 3], "ls": ["a", "b"],
          "d": {"k": 1}, "none": None, "t": "2024-06-01T10:00:00Z", "tms": 1717236000000,
          "tnaive": "2024-06-01T10:00:00"}

# (method, args): every getter on every kind of field, the missing and
# null ones, and wrong types
GETTER_CASES = {
    "get_any": ("get", ("n",)),
    "get_int": ("get", ("n", int)),
    "get_int_from_float": ("get", ("x", int)),
    "get_float_from_int": ("get", ("n", float)),
    "get_float_from_bool": ("get", ("b", float)),
    "get_str_wrong": ("get", ("n", str)),
    "get_bool": ("get", ("b", bool)),
    "get_bool_wrong": ("get", ("n", bool)),
    "get_list": ("get", ("l", list)),
    "get_dict": ("get", ("d", dict)),
    "get_dict_wrong": ("get", ("l", dict)),
    "get_missing": ("get", ("zz",)),
    "get_null": ("get", ("none",)),
    "get_unsupported_type": ("get", ("n", complex)),
    "get_opt_missing": ("get_opt", ("zz", int)),
    "get_opt_null": ("get_opt", ("none", int)),
    "get_opt_wrong": ("get_opt", ("s", int)),
    "get_opt_str": ("get_opt", ("s", str)),
    "get_or_else_missing": ("get_or_else", ("zz", 7)),
    "get_or_else_present": ("get_or_else", ("n", 7)),
    "get_or_else_wrong": ("get_or_else", ("s", 7)),
    "get_or_else_typed": ("get_or_else", ("x", 1, float)),
    "get_list_of_int": ("get_list", ("l", int)),
    "get_list_of_str_wrong": ("get_list", ("l", str)),
    "get_list_any": ("get_list", ("ls",)),
    "get_list_not_list": ("get_list", ("s",)),
    "get_datetime_iso": ("get_datetime", ("t",)),
    "get_datetime_ms": ("get_datetime", ("tms",)),
    "get_datetime_naive": ("get_datetime", ("tnaive",)),
    "get_datetime_bad": ("get_datetime", ("l",)),
    "get_datetime_unparsable": ("get_datetime", ("s",)),
    "keyset": ("keyset", ()),
    "to_dict": ("to_dict", ()),
    "merge": ("merge", ({"n": 4, "new": 1},)),
    "remove": ("remove", (["n", "s", "zz"],)),
    "len": ("__len__", ()),
    "contains": ("__contains__", ("s",)),
    "is_empty": ("is_empty", None),
}


def _outcome(mod, method, args):
    m = mod.DataMap(FIELDS)
    try:
        if args is None:
            out = getattr(m, method)
        else:
            out = getattr(m, method)(*args)
    except Exception as e:  # noqa: BLE001 — the outcome compared
        return ("error", type(e).__name__, str(e))
    if isinstance(out, (mod.DataMap,)):
        return ("map", out.to_dict())
    return ("value", out, type(out).__name__)


@pytest.mark.parametrize("case", sorted(GETTER_CASES))
def test_datamap_getters_match_jax(case):
    method, args = GETTER_CASES[case]
    assert _outcome(tdm, method, args) == _outcome(jdm, method, args)


def test_datamap_errors_are_key_errors_and_extract():
    m = tdm.DataMap({"a": 1, "b": "x", "zz": 3})
    with pytest.raises(KeyError, match="The field q is required"):
        m.get("q")
    assert issubclass(tdm.DataMapError, KeyError)

    import dataclasses

    @dataclasses.dataclass
    class AB:
        a: int
        b: str

    assert m.extract(AB) == AB(1, "x") == jdm.DataMap({"a": 1, "b": "x", "zz": 3}).extract(AB)
    assert (m + {"c": 2}).to_dict() == {"a": 1, "b": "x", "zz": 3, "c": 2}
    assert (m - ["zz"]) == {"a": 1, "b": "x"}
    assert m == tdm.DataMap({"zz": 3, "b": "x", "a": 1}) and hash(m) == hash(
        tdm.DataMap({"zz": 3, "b": "x", "a": 1}))


def test_property_map_equality_and_repr():
    t1, t2 = T0, T0 + dt.timedelta(seconds=5)
    pm = tdm.PropertyMap({"a": 1}, t1, t2)
    jpm = jdm.PropertyMap({"a": 1}, t1, t2)
    assert pm == tdm.PropertyMap({"a": 1}, t1, t2)
    assert pm != tdm.PropertyMap({"a": 1}, t1, t1)
    assert pm == {"a": 1}
    assert repr(pm) == repr(jpm)
    assert (pm.first_updated, pm.last_updated) == (jpm.first_updated, jpm.last_updated)


# -- aggregation -----------------------------------------------------------------


def _stream(seed, n_entities=12, n_events=160, n_times=25):
    """(event, entity_type, entity_id, properties, time offset s, id):
    $set/$unset/$delete over a few fields, plus irrelevant events, with
    many equal times (n_times distinct ones) so that ties are common."""
    rng = np.random.default_rng(seed)
    rows = []
    for n in range(n_events):
        ent = f"i{int(rng.integers(n_entities))}"
        r = rng.random()
        t = int(rng.integers(n_times))
        if r < 0.55:
            keys = rng.choice(["categories", "price", "title", "stock"],
                              int(rng.integers(1, 4)), replace=False)
            props = {}
            for k in keys:
                if k == "categories":
                    props[k] = [f"c{int(c)}" for c in rng.choice(6, int(rng.integers(1, 3)),
                                                                 replace=False)]
                elif k == "price":
                    props[k] = float(np.round(rng.uniform(1, 100), 2))
                else:
                    props[k] = f"{k}{int(rng.integers(100))}"
            rows.append(("$set", "item", ent, props, t))
        elif r < 0.75:
            keys = rng.choice(["categories", "price", "title", "stock"],
                              int(rng.integers(1, 3)), replace=False)
            rows.append(("$unset", "item", ent, {k: None for k in keys}, t))
        elif r < 0.82:
            rows.append(("$delete", "item", ent, {}, t))
        elif r < 0.9:
            rows.append(("$set", "user", f"u{int(rng.integers(4))}", {"plan": "x"}, t))
        else:
            rows.append(("view", "user", f"u{int(rng.integers(4))}", {}, t))
    # ids in a random order against the stream order, so that the tie
    # order is the ids', not the insert order
    ids = rng.permutation(len(rows))
    return [row + (f"ev{ids[n]:05d}",) for n, row in enumerate(rows)]


def _events(make, stream):
    out = []
    for ev, etype, eid, props, t, ident in stream:
        kw = {}
        if ev == "view":
            kw = dict(target_entity_type="item", target_entity_id="i0")
        out.append(make(event=ev, entity_type=etype, entity_id=eid, properties=props,
                        event_time=T0 + dt.timedelta(seconds=t), creation_time=T0,
                        event_id=ident, **kw))
    return out


def _stores(kind, tmp_path):
    if kind == "memory":
        return MemoryEventStore(), JMemory()
    return (SqliteEventStore({"PATH": str(tmp_path / "port.db")}),
            JSqlite({"PATH": str(tmp_path / "jax.db")}))


def _same_maps(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.to_dict() == w.to_dict(), k
        assert (g.first_updated, g.last_updated) == (w.first_updated, w.last_updated), k


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_aggregate_properties_matches_jax(kind, seed, tmp_path):
    stream = _stream(seed)
    ts, js = _stores(kind, tmp_path)
    ts.insert_batch(_events(Event, stream), 1)
    js.insert_batch(_events(JEvent, stream), 1)
    for kw in ({}, {"required": ["categories"]}, {"required": ["price", "title"]},
               {"start_time": T0 + dt.timedelta(seconds=5),
                "until_time": T0 + dt.timedelta(seconds=20)}):
        got = ts.aggregate_properties(1, "item", **kw)
        want = js.aggregate_properties(1, "item", **kw)
        _same_maps(got, want)
        if not kw:
            assert len(want) > 3  # the stream leaves entities alive
    _same_maps(ts.aggregate_properties(1, "user"), js.aggregate_properties(1, "user"))
    for n in range(12):
        g = ts.aggregate_properties_of_entity(1, "item", f"i{n}")
        w = js.aggregate_properties_of_entity(1, "item", f"i{n}")
        assert (g is None) == (w is None)
        if w is not None:
            _same_maps({0: g}, {0: w})
    assert ts.aggregate_properties_of_entity(1, "item", "nope") is None


def test_fold_rules_and_ties():
    """Per field the newest time wins, a tie to the later event; $unset
    removes fields set at or before it; $delete clears the entity, a
    later $set starts it again; both packages agree on each step."""
    t = [T0 + dt.timedelta(seconds=s) for s in range(5)]

    def ev(make, name, props, when, ident):
        return make(event=name, entity_type="item", entity_id="x", properties=props,
                    event_time=when, event_id=ident)

    cases = [
        ([("$set", {"a": 1}, 0), ("$set", {"a": 2}, 0)], {"a": 2}),
        ([("$set", {"a": 1}, 1), ("$set", {"a": 2}, 0)], {"a": 1}),
        ([("$set", {"a": 1, "b": 2}, 1), ("$unset", {"a": None}, 1)], {"b": 2}),
        ([("$set", {"a": 1}, 2), ("$unset", {"a": None}, 1)], {"a": 1}),
        ([("$set", {"a": 1}, 1), ("$delete", {}, 2)], None),
        ([("$set", {"a": 1}, 1), ("$delete", {}, 2), ("$set", {"b": 3}, 3)], {"b": 3}),
        ([("$set", {"a": 1}, 1), ("$delete", {}, 1)], None),
        ([("$unset", {"a": None}, 1)], None),
        ([("$set", {"a": 1}, 1), ("$unset", {"a": None}, 2)], {}),
    ]
    for steps, want in cases:
        got = tagg.aggregate_properties_of_entity(
            [ev(Event, n, p, t[w], f"e{k}") for k, (n, p, w) in enumerate(steps)])
        ref = jagg.aggregate_properties_of_entity(
            [ev(JEvent, n, p, t[w], f"e{k}") for k, (n, p, w) in enumerate(steps)])
        if want is None:
            assert got is None and ref is None, steps
        else:
            assert got.to_dict() == ref.to_dict() == want, steps
            assert (got.first_updated, got.last_updated) == (ref.first_updated,
                                                             ref.last_updated)


# -- the facade over a Storage ---------------------------------------------------


def _port_storage(kind, path):
    if kind == "memory":
        return Storage(StorageConfig.memory())
    return Storage(StorageConfig(
        sources={"S": SourceConfig("S", "sqlite", {"PATH": str(path / "port.db")}),
                 "F": SourceConfig("F", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "F"}))


def _jax_storage(kind, path):
    if kind == "memory":
        return JStorage(JStorageConfig(
            sources={"MEM": JSourceConfig("MEM", "memory", {})},
            repositories={"METADATA": "MEM", "EVENTDATA": "MEM", "MODELDATA": "MEM"}))
    return JStorage(JStorageConfig(
        sources={"S": JSourceConfig("S", "sqlite", {"PATH": str(path / "jax.db")}),
                 "F": JSourceConfig("F", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "F"}))


def _history(seed):
    """A user's view/buy history with equal times among the events."""
    rng = np.random.default_rng(seed)
    rows = []
    for n in range(60):
        user = f"u{int(rng.integers(3))}"
        ev = str(rng.choice(["view", "buy", "rate"]))
        rows.append((ev, "user", user, {"rating": 3} if ev == "rate" else {},
                     int(rng.integers(20)), f"h{int(rng.permutation(1000)[n]):04d}"))
    return rows


def _history_events(make, rows):
    return [make(event=ev, entity_type=et, entity_id=eid, properties=p,
                 target_entity_type="item", target_entity_id=f"i{n % 9}",
                 event_time=T0 + dt.timedelta(seconds=t), creation_time=T0, event_id=ident)
            for n, (ev, et, eid, p, t, ident) in enumerate(rows)]


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_facade_reads_match_jax(kind, tmp_path):
    ts, js = _port_storage(kind, tmp_path), _jax_storage(kind, tmp_path)
    for st, app_cls, make in ((ts, App, Event), (js, JApp, JEvent)):
        app_id = st.get_meta_data_apps().insert(app_cls(0, "props"))
        st.get_events().init_app(app_id)
        st.get_events().insert_batch(_events(make, _stream(7)), app_id)
        st.get_events().insert_batch(_history_events(make, _history(8)), app_id)
    tf, jf = EventStoreFacade(ts), JFacade(js)
    assert PEventStore is EventStoreFacade and LEventStore is EventStoreFacade
    _same_maps(tf.aggregate_properties("props", "item"),
               jf.aggregate_properties(app_name="props", entity_type="item"))
    _same_maps(tf.aggregate_properties("props", "item", required=["title"]),
               jf.aggregate_properties(app_name="props", entity_type="item",
                                       required=["title"]))
    for kw in ({}, {"latest": False}, {"limit": 5}, {"limit": 0},
               {"event_names": ["view", "buy"], "limit": 7},
               {"event_names": ["rate"], "latest": False, "limit": 3},
               {"target_entity_type": "item", "target_entity_id": "i4"},
               {"start_time": T0 + dt.timedelta(seconds=5),
                "until_time": T0 + dt.timedelta(seconds=9)}):
        for user in ("u0", "u1", "u2", "nobody"):
            got = [(e.event_id, e.event, e.event_time) for e in tf.find_by_entity(
                "props", "user", user, **kw)]
            want = [(e.event_id, e.event, e.event_time) for e in jf.find_by_entity(
                app_name="props", entity_type="user", entity_id=user, **kw)]
            assert got == want, (kw, user)
            if kw == {} and user != "nobody":
                times = [t for _, _, t in got]
                assert times == sorted(times, reverse=True) and len(got) > 5


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_data_signature_moves_on_insert_and_delete(kind, tmp_path):
    ts, js = _stores(kind, tmp_path)
    seen = set()
    for store, make in ((ts, Event), (js, JEvent)):
        store.init_app(3)
    for step in range(4):
        batch = [f"d{step}{n}" for n in range(3)]
        for store, make in ((ts, Event), (js, JEvent)):
            store.insert_batch([make(event="view", entity_type="user", entity_id="u",
                                     target_entity_type="item", target_entity_id="i",
                                     event_time=T0, event_id=i) for i in batch], 3)
        sig = ts.data_signature(3)
        assert sig == js.data_signature(3) and sig not in seen
        seen.add(sig)
        for store in (ts, js):
            assert store.delete(batch[0], 3)
        sig = ts.data_signature(3)
        assert sig == js.data_signature(3) and sig not in seen
        seen.add(sig)
    # a delete followed by a replayed identical insert moves it too
    for store, make in ((ts, Event), (js, JEvent)):
        store.insert(make(event="view", entity_type="user", entity_id="u",
                          target_entity_type="item", target_entity_id="i",
                          event_time=T0, event_id="d00"), 3)
    assert ts.data_signature(3) not in seen
    assert ts.data_signature(3) == js.data_signature(3)
    # another namespace does not move it
    before = ts.data_signature(3)
    ts.insert(Event(event="view", entity_type="user", entity_id="u",
                    target_entity_type="item", target_entity_id="i"), 4)
    assert ts.data_signature(3) == before


def test_default_data_signature_is_exact():
    """The base class's scan (a store without an override): count and the
    ids' crc32 xor, moving on insert and delete."""
    from predictionio_tpu_torch.data.storage.base import EventStore

    store = MemoryEventStore()
    sig = lambda: EventStore.data_signature(store, 5)  # noqa: E731
    assert sig() == "0:0"
    store.insert(Event(event="view", entity_type="user", entity_id="u",
                       target_entity_type="item", target_entity_id="i",
                       event_id="a"), 5)
    one = sig()
    store.insert(Event(event="view", entity_type="user", entity_id="u",
                       target_entity_type="item", target_entity_id="i",
                       event_id="b"), 5)
    assert sig() not in (one, "0:0")
    store.delete("b", 5)
    assert sig() == one
