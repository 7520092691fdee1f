"""The port's storage against the JAX package's.

- Events: the JSON codec and the validation rules give the same JSON and
  the same accept/refuse outcome.
- SQLite: the port creates the JAX package's tables (same DDL), so a
  ``pio.db`` written by either package reads in the other; events
  written by one give the other's columnar ``find_frame`` equal columns
  and vocabularies, and its ``find`` equal events. Engine-instance rows
  and localfs model files read across too.
- ``EventFrame.interactions`` equals the JAX package's on seeded columns
  with duplicate pairs, for each dedupe mode.
- The registry reads the same ``PIO_STORAGE_*`` variables into the same
  configuration.

Every comparison is exact: the same float32 values go through the same
sums (``interactions`` adds in float64 in both).
"""

import datetime as dt
import json
import sqlite3

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data import event as jevent  # noqa: E402
from predictionio_tpu.data.storage import base as jbase  # noqa: E402
from predictionio_tpu.data.storage import localfs as jlocalfs  # noqa: E402
from predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from predictionio_tpu.data.storage import sqlite as jsqlite  # noqa: E402
from predictionio_tpu.data.store.bimap import BiMap as JBiMap  # noqa: E402
from predictionio_tpu.data.store.columnar import EventFrame as JFrame  # noqa: E402
from predictionio_tpu.data.store.event_store import EventStoreFacade as JFacade  # noqa: E402
from predictionio_tpu_torch.data import event as tevent  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import localfs as tlocalfs  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from predictionio_tpu_torch.data.storage import sqlite as tsqlite  # noqa: E402
from predictionio_tpu_torch.data.store.bimap import BiMap  # noqa: E402
from predictionio_tpu_torch.data.store.columnar import EventFrame  # noqa: E402
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade  # noqa: E402

T0 = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)

EVENT_CASES = {
    "rate": {"event": "rate", "entityType": "user", "entityId": "u1",
             "targetEntityType": "item", "targetEntityId": "i1",
             "properties": {"rating": 4}, "eventTime": "2024-03-01T10:00:00.123Z",
             "creationTime": "2024-03-01T10:00:01Z", "eventId": "e1"},
    "set": {"event": "$set", "entityType": "item", "entityId": "i1",
            "properties": {"categories": ["a", "b"]},
            "eventTime": "2024-03-01T10:00:00+02:00", "creationTime": 1700000000000,
            "tags": ["t"], "prId": "p"},
    "int_ids": {"event": "buy", "entityType": "user", "entityId": 7,
                "targetEntityType": "item", "targetEntityId": 9,
                "eventTime": "2024-03-01T10:00:00Z", "creationTime": "2024-03-01T10:00:00Z"},
    "missing_entity": {"event": "rate", "entityType": "user"},
    "empty_event": {"event": "", "entityType": "user", "entityId": "u"},
    "reserved_event": {"event": "pio_x", "entityType": "user", "entityId": "u"},
    "reserved_entity": {"event": "rate", "entityType": "$user", "entityId": "u"},
    "builtin_entity": {"event": "rate", "entityType": "pio_pr", "entityId": "u",
                       "eventTime": "2024-03-01T10:00:00Z",
                       "creationTime": "2024-03-01T10:00:00Z"},
    "target_without_type": {"event": "rate", "entityType": "user", "entityId": "u",
                            "targetEntityId": "i"},
    "set_with_target": {"event": "$set", "entityType": "user", "entityId": "u",
                        "targetEntityType": "item", "targetEntityId": "i"},
    "unset_empty": {"event": "$unset", "entityType": "user", "entityId": "u"},
    "delete_with_props": {"event": "$delete", "entityType": "user", "entityId": "u",
                          "properties": {"a": 1}},
}


def _codec(mod, d):
    try:
        return mod.Event.from_json(json.dumps(d)).to_json_dict()
    except ValueError:
        return "refused"


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_event_codec_and_validation_match_jax(case):
    d = EVENT_CASES[case]
    assert _codec(tevent, d) == _codec(jevent, d)
    if _codec(tevent, d) != "refused":
        e = tevent.Event.from_json(json.dumps(d))
        assert tevent.Event.from_json(e.to_json()) == e


def _rows(seed, n=400, n_users=30, n_items=25):
    """(event, user, item, rating or None) rows with duplicate pairs, and
    non-rate events, a rate without a rating and events of other types."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ev = rng.choice(["rate", "rate", "rate", "buy", "view"])
        rating = None if ev != "rate" or rng.random() < 0.05 else int(rng.integers(1, 6))
        out.append((str(ev), f"u{rng.integers(n_users)}", f"i{rng.integers(n_items)}", rating))
    return out


def _events(mod, rows, first=0):
    out = []
    for n, (ev, u, i, r) in enumerate(rows):
        out.append(mod.Event(
            event=ev, entity_type="user", entity_id=u,
            target_entity_type="item", target_entity_id=i,
            properties={} if r is None else {"rating": r},
            event_time=T0 + dt.timedelta(seconds=(first + n) // 2),  # ties on time
            creation_time=T0, event_id=f"e{first + n:05d}",
        ))
    out.append(mod.Event(event="$set", entity_type="item", entity_id="i1",
                         properties={"categories": ["c"]}, event_time=T0,
                         creation_time=T0, event_id=f"s{first}"))
    out.append(mod.Event(event="follow", entity_type="user", entity_id="u1",
                         target_entity_type="user", target_entity_id="u2",
                         event_time=T0, creation_time=T0, event_id=f"f{first}"))
    return out


def _jax_sqlite(path):
    client = jsqlite._SqliteClient({"PATH": str(path)})
    return (jsqlite.SqliteEventStore(client=client), jsqlite.SqliteApps(client=client),
            jsqlite.SqliteEngineInstances(client=client))


def _port_sqlite(path):
    client = tsqlite.SqliteClient({"PATH": str(path)})
    return (tsqlite.SqliteEventStore(client=client), tsqlite.SqliteApps(client=client),
            tsqlite.SqliteEngineInstances(client=client))


def _frame_equal(got, want):
    for col in ("event_code", "entity_idx", "target_idx", "time_ms", "value"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col), err_msg=col)
        assert getattr(got, col).dtype == getattr(want, col).dtype, col
    for vocab in ("event_vocab", "entity_vocab", "target_vocab"):
        assert getattr(got, vocab).to_dict() == getattr(want, vocab).to_dict(), vocab
    assert (got.entity_type, got.target_entity_type) == (want.entity_type,
                                                         want.target_entity_type)


QUERY = dict(entity_type="user", target_entity_type="item",
             event_names=["rate", "buy"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_frames_read_across_packages(tmp_path, writer):
    """One package writes events into a pio.db; both read the same
    columnar frame from it, through both packages' facades."""
    db = tmp_path / "pio.db"
    if writer == "jax":
        store, apps, _ = _jax_sqlite(db)
        app_id = apps.insert(jbase.App(0, "app"))
        store.insert_batch(_events(jevent, _rows(1)), app_id)
        store.insert(_events(jevent, [("rate", "u99", "i1", 5)], first=999)[0], app_id)
    else:
        store, apps, _ = _port_sqlite(db)
        app_id = apps.insert(tbase.App(0, "app"))
        store.insert_batch(_events(tevent, _rows(1)), app_id)
        store.insert(_events(tevent, [("rate", "u99", "i1", 5)], first=999)[0], app_id)
    jstorage = jreg.Storage(jreg.StorageConfig(
        sources={"S": jreg.SourceConfig("S", "sqlite", {"PATH": str(db)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
    tstorage = treg.Storage(treg.StorageConfig(
        sources={"S": treg.SourceConfig("S", "sqlite", {"PATH": str(db)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
    kw = dict(value_prop="rating", default_value=1.0, **QUERY)
    want = JFacade(jstorage).find_frame("app", **kw)
    got = EventStoreFacade(tstorage).find_frame("app", **kw)
    assert len(got) == sum(r[0] in ("rate", "buy") for r in _rows(1)) + 1
    _frame_equal(got, want)
    # the Event read path gives the same events, in the same order
    jq = jbase.EventQuery(app_id=app_id, **QUERY)
    tq = tbase.EventQuery(app_id=app_id, **QUERY)
    jev = [e.to_json_dict() for e in jstorage.get_events().find(jq)]
    tev = [e.to_json_dict() for e in tstorage.get_events().find(tq)]
    assert tev == jev and len(tev) == len(got)
    # the frame from Events equals the columnar read
    _frame_equal(EventFrame.from_events(tstorage.get_events().find(tq),
                                        value_prop="rating"), got)
    # history reads: newest first, cut per entity
    hist = tstorage.get_events().find_entities_batch(
        app_id, "user", ["u1", "u2", "nobody"], event_names=["rate"],
        limit_per_entity=3)
    jhist = jstorage.get_events().find_entities_batch(
        app_id, "user", ["u1", "u2", "nobody"], event_names=["rate"],
        limit_per_entity=3)
    assert {k: [e.event_id for e in v] for k, v in hist.items()} == \
        {k: [e.event_id for e in v] for k, v in jhist.items()}


def test_sqlite_ddl_matches_jax(tmp_path):
    for name, make in (("jax", _jax_sqlite), ("port", _port_sqlite)):
        store, apps, instances = make(tmp_path / f"{name}.db")
        store.init_app(3)
    schema = {}
    for name in ("jax", "port"):
        with sqlite3.connect(tmp_path / f"{name}.db") as conn:
            schema[name] = sorted(conn.execute(
                "SELECT type, name, sql FROM sqlite_master").fetchall())
    assert schema["port"] == schema["jax"]
    assert ("table", "events_3") in [(t, n) for t, n, _ in schema["port"]]


def test_apps_and_instances_read_across(tmp_path):
    db = tmp_path / "pio.db"
    _, japps, jinst = _jax_sqlite(db)
    _, tapps, tinst = _port_sqlite(db)
    assert japps.insert(jbase.App(0, "a", "first")) == 1
    assert tapps.insert(tbase.App(0, "b")) == 2
    assert tapps.insert(tbase.App(0, "a")) is None  # names are unique
    assert [vars(a) for a in tapps.get_all()] == [vars(a) for a in japps.get_all()]
    assert vars(tapps.get_by_name("a")) == vars(japps.get_by_name("a"))
    fields = dict(status="COMPLETED", engine_id="e", engine_version="0",
                  engine_variant="v", engine_factory="f", batch="b",
                  env={"stage_timings": "{}"}, data_source_params='{"x": 1}',
                  algorithms_params="[]", serving_params="{}")
    for n, (inst, mod) in enumerate(((jinst, jbase), (tinst, tbase),
                                     (jinst, jbase))):
        inst.insert(mod.EngineInstance(
            id=f"i{n}", start_time=T0 + dt.timedelta(minutes=n),
            end_time=T0 + dt.timedelta(minutes=n + 1), **fields))
    got = tinst.get_latest_completed("e", "0", "v")
    want = jinst.get_latest_completed("e", "0", "v")
    assert got.id == "i2" and vars(got) == vars(want)
    assert [vars(i) for i in tinst.get_completed("e", "0", "v")] == \
        [vars(i) for i in jinst.get_completed("e", "0", "v")]
    got.status = "ABORTED"
    assert tinst.update(got) and jinst.get("i2").status == "ABORTED"
    assert tinst.get_latest_completed("e", "0", "v").id == "i1"


def test_localfs_models_read_across(tmp_path):
    tmodels = tlocalfs.LocalFSModels({"PATH": str(tmp_path)})
    jmodels = jlocalfs.LocalFSModels({"PATH": str(tmp_path)})
    jmodels.insert(jbase.Model("m1", b"jax"))
    tmodels.insert(tbase.Model("m2", b"port"))
    assert tmodels.get("m1").models == b"jax" and jmodels.get("m2").models == b"port"
    assert tmodels.get("nope") is None
    tmodels.delete("m1")
    assert jmodels.get("m1") is None


@pytest.mark.parametrize("dedupe", ["sum", "max", "last"])
def test_interactions_match_jax(dedupe):
    rng = np.random.default_rng(3)
    n = 2000
    ev = rng.choice(["rate", "buy"], n)
    ent = [f"u{x}" for x in rng.integers(0, 40, n)]
    tgt = [f"i{x}" if x >= 0 else None for x in rng.integers(-3, 30, n)]
    times = rng.integers(0, 10_000, n).astype(np.int64)
    vals = rng.integers(1, 11, n).astype(np.float32) / 2
    got = EventFrame.from_columns(ev, ent, tgt, times, vals).interactions(dedupe)
    want = JFrame.from_columns(ev, ent, tgt, times, vals).interactions(dedupe)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    rows, cols, _ = got
    assert len(set(zip(rows.tolist(), cols.tolist()))) == len(rows) < n


def test_memory_find_honours_target_entity_type():
    storage = treg.Storage(treg.StorageConfig.memory())
    app_id = storage.get_meta_data_apps().insert(tbase.App(0, "app"))
    events = _events(tevent, _rows(2, n=50))
    storage.get_events().insert_batch(events, app_id)
    frame = EventStoreFacade(storage).find_frame(
        "app", value_prop="rating", **QUERY)
    assert len(frame) == sum(e.event in ("rate", "buy") for e in events)
    assert set(frame.target_vocab.to_dict()) <= {f"i{n}" for n in range(25)}
    everything = EventStoreFacade(storage).find_frame("app", entity_type="user")
    assert "u2" in everything.target_vocab.to_dict()  # the follow event's target
    with pytest.raises(tbase.StorageError, match="Invalid app name"):
        EventStoreFacade(storage).find_frame("nope")


def test_storage_config_from_env_matches_jax(tmp_path):
    env = {
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "x.db"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
        "UNRELATED": "1",
    }
    got, want = treg.StorageConfig.from_env(env), jreg.StorageConfig.from_env(env)
    assert {k: vars(v) for k, v in got.sources.items()} == \
        {k: vars(v) for k, v in want.sources.items()}
    assert got.repositories == want.repositories
    storage = treg.Storage(got)
    assert isinstance(storage.get_events(), tsqlite.SqliteEventStore)
    assert isinstance(storage.get_model_data_models(), tlocalfs.LocalFSModels)
    # one client per sqlite source
    assert storage.get_events()._client is storage.get_meta_data_apps()._client
    dev_t = treg.StorageConfig.default_dev(str(tmp_path / "base"))
    dev_j = jreg.StorageConfig.default_dev(str(tmp_path / "base"))
    assert {k: vars(v) for k, v in dev_t.sources.items()} == \
        {k: vars(v) for k, v in dev_j.sources.items()}
    assert dev_t.repositories == dev_j.repositories
    bad = treg.Storage(treg.StorageConfig(
        sources={"P": treg.SourceConfig("P", "postgres")},
        repositories={"EVENTDATA": "P"}))
    with pytest.raises(tbase.StorageError, match="not in the port"):
        bad.get_events()
    with pytest.raises(tbase.StorageError, match="METADATA is not configured"):
        bad.get_meta_data_apps()


def test_storage_config_segmentfs_docfs_matches_jax(tmp_path):
    """`TYPE=segmentfs` and `TYPE=docfs` sources (with their settings)
    parse to the JAX package's configuration and resolve to the port's
    stores: events on segmentfs, metadata and models on docfs."""
    from predictionio_tpu_torch.data.storage import docfs as tdocfs
    from predictionio_tpu_torch.data.storage import segmentfs as tsegfs

    env = {
        "PIO_STORAGE_SOURCES_SEG_TYPE": "segmentfs",
        "PIO_STORAGE_SOURCES_SEG_PATH": str(tmp_path / "seg"),
        "PIO_STORAGE_SOURCES_SEG_SEAL_EVENTS": "8192",
        "PIO_STORAGE_SOURCES_SEG_FSYNC": "1",
        "PIO_STORAGE_SOURCES_DOC_TYPE": "docfs",
        "PIO_STORAGE_SOURCES_DOC_PATH": str(tmp_path / "meta"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DOC",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SEG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DOC",
    }
    got, want = treg.StorageConfig.from_env(env), jreg.StorageConfig.from_env(env)
    assert {k: vars(v) for k, v in got.sources.items()} == \
        {k: vars(v) for k, v in want.sources.items()}
    assert got.repositories == want.repositories
    assert treg.BACKENDS["segmentfs"][1] == jreg.BACKENDS["segmentfs"][1] == "SegmentFS"
    assert treg.BACKENDS["docfs"][1] == jreg.BACKENDS["docfs"][1] == "DocFS"
    # the follower backend maps to the port's replication module, with
    # the JAX registry's class prefix
    assert treg.BACKENDS["segmentfs-replica"] == (
        "predictionio_tpu_torch.data.storage.replication", "Replica")
    assert jreg.BACKENDS["segmentfs-replica"][1] == "Replica"
    storage = treg.Storage(got)
    events = storage.get_events()
    assert isinstance(events, tsegfs.SegmentFSEventStore)
    assert (events.seal_events, events.fsync, events.seal_interval_s) == (8192, True, 0.25)
    assert isinstance(storage.get_meta_data_apps(), tdocfs.DocFSApps)
    assert isinstance(storage.get_model_data_models(), tdocfs.DocFSModels)
    assert storage.get_meta_data_apps()._client is storage.get_model_data_models()._client
    with pytest.raises(tbase.StorageError, match="does not implement Apps"):
        treg.Storage(treg.StorageConfig(sources=got.sources,
                                        repositories={"METADATA": "SEG"})).get_meta_data_apps()
    events.close()


def test_storage_defaults_to_pio_fs_basedir(tmp_path, monkeypatch):
    for key in list(__import__("os").environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    storage = treg.Storage()
    assert storage.config.sources["PIOSQLITE"].settings["PATH"] == str(
        tmp_path / "store" / "pio.db")
    app_id = storage.get_meta_data_apps().insert(tbase.App(0, "a"))
    storage.get_events().init_app(app_id)
    assert (tmp_path / "store" / "pio.db").exists()
    storage.get_model_data_models().insert(tbase.Model("m", b"x"))
    assert (tmp_path / "store" / "models" / "pio_model_m").read_bytes() == b"x"


def test_bimap_pickles():
    import pickle

    b = BiMap({"a": 0, "b": 1})
    assert pickle.loads(pickle.dumps(b)) == b and JBiMap({"a": 0}).to_dict() == {"a": 0}


def test_bulk_write_builds_the_same_indexes(tmp_path, monkeypatch):
    """A bulk write into an empty table drops the secondary indexes and
    builds them at the end: the same schema as the JAX package's, the
    same rows as insert_batch; a write that fails midway rebuilds them."""
    events = _events(tevent, _rows(4, n=300))
    bulk, _, _ = _port_sqlite(tmp_path / "bulk.db")
    plain, _, _ = _port_sqlite(tmp_path / "plain.db")
    monkeypatch.setattr(tsqlite.SqliteEventStore, "WRITE_CHUNK", 64)
    assert bulk.write(iter(events), 1) == len(events)
    plain.insert_batch(events, 1)
    bulk.write(_events(tevent, _rows(5, n=20), first=5000), 1)  # not empty: kept
    plain.insert_batch(_events(tevent, _rows(5, n=20), first=5000), 1)
    jstore, _, _ = _jax_sqlite(tmp_path / "jax.db")
    jstore.init_app(1)

    def dump(name, sql):
        with sqlite3.connect(tmp_path / name) as conn:
            return sorted(conn.execute(sql).fetchall())

    schema = "SELECT type, name, sql FROM sqlite_master WHERE name LIKE '%events_1%'"
    assert dump("bulk.db", schema) == dump("plain.db", schema) == dump("jax.db", schema)
    rows = "SELECT id, event, entityId, targetEntityId, properties, eventTime FROM events_1"
    assert dump("bulk.db", rows) == dump("plain.db", rows)

    def failing():
        yield from events[:10]
        raise ValueError("bad line")

    store, _, _ = _port_sqlite(tmp_path / "failed.db")
    monkeypatch.setattr(tsqlite.SqliteEventStore, "WRITE_CHUNK", 4)
    with pytest.raises(ValueError, match="bad line"):
        store.write(failing(), 1)
    assert dump("failed.db", schema) == dump("jax.db", schema)
    assert len(dump("failed.db", rows)) == 8  # the two full chunks were written


# -- channels, the full filter set, get / delete / remove_app, access keys ---

def _stores(kind, tmp_path):
    """(JAX, port) event stores and metadata DAOs of one backend kind."""
    def make(reg, sub):
        settings = {}
        if kind == "sqlite":
            (tmp_path / sub).mkdir(exist_ok=True)
            settings = {"PATH": str(tmp_path / sub / "pio.db")}
        return reg.Storage(reg.StorageConfig(
            sources={"S": reg.SourceConfig("S", kind, settings)},
            repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))

    return make(jreg, "jax"), make(treg, "port")


def _channel_events(mod, channel):
    """Seeded events with distinct times but for deliberate ties, some
    without a target, for one channel."""
    rng = np.random.default_rng(30 + channel)
    out = []
    for n in range(120):
        target = rng.random() > 0.15
        out.append(mod.Event(
            event=str(rng.choice(["rate", "buy", "view"])),
            entity_type=str(rng.choice(["user", "user", "shop"])),
            entity_id=f"u{rng.integers(8)}",
            target_entity_type="item" if target else None,
            target_entity_id=f"i{rng.integers(6)}" if target else None,
            properties={"rating": int(rng.integers(1, 6))},
            event_time=T0 + dt.timedelta(seconds=int(rng.integers(0, 90))),
            creation_time=T0, event_id=f"c{channel}e{n:04d}"))
    return out


FILTERS = {
    "all": {},
    "channel": {"channel_id": 1},
    "channel_zero_is_default": {"channel_id": 0},
    "time_range": {"start_time": T0 + dt.timedelta(seconds=20),
                   "until_time": T0 + dt.timedelta(seconds=50)},
    "entity": {"entity_type": "user", "entity_id": "u3"},
    "events": {"event_names": ["rate", "view"]},
    "target": {"target_entity_type": "item", "target_entity_id": "i2"},
    "target_absent": {"filter_target_absent": True},
    "limit": {"limit": 7},
    "limit_all": {"limit": -1},
    "reversed": {"reversed": True},
    "reversed_limit_channel": {"reversed": True, "limit": 5, "channel_id": 1,
                               "event_names": ["buy"]},
    "everything": {"start_time": T0 + dt.timedelta(seconds=5), "entity_type": "user",
                   "event_names": ["rate"], "target_entity_type": "item",
                   "limit": 10, "reversed": True},
}


@pytest.mark.parametrize("case", sorted(FILTERS))
@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_event_query_filters_match_jax(tmp_path, kind, case):
    js, ts = _stores(kind, tmp_path)
    for storage, mod in ((js, jevent), (ts, tevent)):
        storage.get_events().insert_batch(_channel_events(mod, 0), 1)
        storage.get_events().insert_batch(_channel_events(mod, 1), 1, 1)
    kw = FILTERS[case]
    jkw = dict(kw)
    if kind == "memory" and case == "channel_zero_is_default":
        # the JAX memory store keeps a channel 0 apart from the default
        # one; its sqlite store and both of the port's stores do not
        jkw["channel_id"] = None
    want = [e.to_json_dict() for e in js.get_events().find(jbase.EventQuery(app_id=1, **jkw))]
    got = [e.to_json_dict() for e in ts.get_events().find(tbase.EventQuery(app_id=1, **kw))]
    assert got == want and (got or case == "target_absent")
    # the port's own matches() agrees with its store
    every = list(ts.get_events().find(tbase.EventQuery(
        app_id=1, channel_id=kw.get("channel_id"), limit=-1)))
    if "limit" not in kw and not kw.get("reversed"):
        q = tbase.EventQuery(app_id=1, **kw)
        assert [e.event_id for e in every if q.matches(e)] == [g["eventId"] for g in got]


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_get_delete_remove_app_match_jax(tmp_path, kind):
    js, ts = _stores(kind, tmp_path)
    outcomes = []
    for storage, mod in ((js, jevent), (ts, tevent)):
        events = storage.get_events()
        events.insert_batch(_channel_events(mod, 0)[:20], 1)
        events.insert_batch(_channel_events(mod, 1)[:20], 1, 2)
        got = [events.get("c0e0003", 1), events.get("c0e0003", 1, 2),
               events.get("c1e0004", 1, 2), events.get("nope", 1)]
        steps = [
            [None if e is None else e.to_json_dict() for e in got],
            events.delete("c0e0003", 1), events.delete("c0e0003", 1),
            events.delete("c1e0004", 1), events.delete("c1e0004", 1, 2),
            events.get("c0e0003", 1) is None,
            len(list(events.find(EVENTQ[mod](app_id=1)))),
            len(list(events.find(EVENTQ[mod](app_id=1, channel_id=2)))),
            events.remove_app(1, 2),
            len(list(events.find(EVENTQ[mod](app_id=1, channel_id=2)))),
            len(list(events.find(EVENTQ[mod](app_id=1)))),
            events.remove_app(1),
            len(list(events.find(EVENTQ[mod](app_id=1)))),
        ]
        events.init_app(1)
        steps.append(events.insert(_channel_events(mod, 0)[0], 1))
        outcomes.append(steps)
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][6:8] == [19, 19] and outcomes[1][9:11] == [0, 19]


EVENTQ = {jevent: jbase.EventQuery, tevent: tbase.EventQuery}


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_access_keys_and_channels_match_jax(tmp_path, kind):
    js, ts = _stores(kind, tmp_path)
    outcomes = []
    for storage, base in ((js, jbase), (ts, tbase)):
        keys, chans = storage.get_meta_data_access_keys(), storage.get_meta_data_channels()
        apps = storage.get_meta_data_apps()
        generated = keys.insert(base.AccessKey("", 1))
        steps = [
            len(generated), keys.get(generated).app_id,
            keys.insert(base.AccessKey("K1", 1, ("rate", "buy"))),
            keys.insert(base.AccessKey("K1", 2)),  # taken
            keys.insert(base.AccessKey("K2", 2)),
            vars(keys.get("K1")), keys.get("nope"),
            sorted(k.key for k in keys.get_by_app_id(1) if k.key != generated),
            len(keys.get_all()),
            keys.update(base.AccessKey("K2", 2, ("view",))), vars(keys.get("K2")),
            keys.update(base.AccessKey("K9", 2)),
            keys.delete("K1"), keys.delete("K1"), keys.get("K1"),
            chans.insert(base.Channel(0, "ch-1_a", 1)),
            chans.insert(base.Channel(0, "ch-1_a", 1)),  # taken in app 1
            chans.insert(base.Channel(0, "ch-1_a", 2)),
            chans.insert(base.Channel(0, "bad name", 1)),
            chans.insert(base.Channel(0, "", 1)),
            vars(chans.get(1)), chans.get(99),
            [vars(c) for c in chans.get_by_app_id(1)],
            chans.delete(1), chans.delete(1), chans.get_by_app_id(1),
            apps.insert(base.App(0, "a", "d")), apps.update(base.App(1, "b", "e")),
            vars(apps.get(1)), apps.update(base.App(7, "x")),
            apps.delete(1), apps.delete(1), apps.get_all(),
            [base.Channel.is_valid_name(n) for n in ("a", "A-b_9", "", "a.b", "é")],
        ]
        outcomes.append(steps)
    assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_keys_channels_and_channel_tables_read_across(tmp_path, writer):
    """A pio.db written by one package: the other reads its access keys,
    channels and the channel's events_<app>_<channel> table, and its
    DDL is the same."""
    db = tmp_path / "pio.db"
    mods = {"jax": (jreg, jbase, jevent), "port": (treg, tbase, tevent)}
    wreg, wbase, wevent = mods[writer]
    w = wreg.Storage(wreg.StorageConfig(
        sources={"S": wreg.SourceConfig("S", "sqlite", {"PATH": str(db)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
    app_id = w.get_meta_data_apps().insert(wbase.App(0, "app"))
    w.get_meta_data_access_keys().insert(wbase.AccessKey("KEY", app_id, ("rate",)))
    ch = w.get_meta_data_channels().insert(wbase.Channel(0, "hold", app_id))
    w.get_events().insert_batch(_channel_events(wevent, 1), app_id, ch)
    w.get_events().insert_batch(_channel_events(wevent, 0)[:10], app_id)
    rreg, rbase, _ = mods["port" if writer == "jax" else "jax"]
    r = rreg.Storage(rreg.StorageConfig(
        sources={"S": rreg.SourceConfig("S", "sqlite", {"PATH": str(db)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
    assert vars(r.get_meta_data_access_keys().get("KEY")) == {
        "key": "KEY", "app_id": app_id, "events": ("rate",)}
    assert [vars(c) for c in r.get_meta_data_channels().get_by_app_id(app_id)] == [
        {"id": ch, "name": "hold", "app_id": app_id}]
    for channel_id, n in ((ch, 120), (None, 10)):
        q = dict(app_id=app_id, channel_id=channel_id)
        got = [e.to_json_dict() for e in r.get_events().find(rbase.EventQuery(**q))]
        want = [e.to_json_dict() for e in w.get_events().find(wbase.EventQuery(**q))]
        assert got == want and len(got) == n
    with sqlite3.connect(db) as conn:
        names = {n for (n,) in conn.execute("SELECT name FROM sqlite_master WHERE type='table'")}
    assert {"accesskeys", "channels", f"events_{app_id}_{ch}", f"events_{app_id}"} <= names
    # the two packages create the same DDL for these tables
    for name, make in (("jax", _jax_sqlite), ("port", _port_sqlite)):
        store, *_ = make(tmp_path / f"ddl_{name}.db")
        store.init_app(3, 4)
        client = store._client
        mod = jsqlite if name == "jax" else tsqlite
        mod.SqliteAccessKeys(client=client)
        mod.SqliteChannels(client=client)
    ddl = {}
    for name in ("jax", "port"):
        with sqlite3.connect(tmp_path / f"ddl_{name}.db") as conn:
            ddl[name] = sorted(conn.execute("SELECT type, name, sql FROM sqlite_master"))
    assert ddl["port"] == ddl["jax"]


def test_facade_resolves_channel_names_as_jax(tmp_path):
    js, ts = _stores("sqlite", tmp_path)
    for storage, base, mod in ((js, jbase, jevent), (ts, tbase, tevent)):
        app_id = storage.get_meta_data_apps().insert(base.App(0, "app"))
        ch = storage.get_meta_data_channels().insert(base.Channel(0, "hold", app_id))
        storage.get_events().insert_batch(_channel_events(mod, 1)[:30], app_id, ch)
    kw = dict(channel_name="hold", value_prop="rating", entity_type="user")
    _frame_equal(EventStoreFacade(ts).find_frame("app", **kw),
                 JFacade(js).find_frame("app", **kw))
    assert EventStoreFacade(ts).app_name_to_id("app", "hold") == \
        JFacade(js).app_name_to_id("app", "hold")
    for facade, err in ((EventStoreFacade(ts), tbase.StorageError),
                        (JFacade(js), jbase.StorageError)):
        with pytest.raises(err, match="Invalid channel name 'nope' for app 'app'"):
            facade.find_frame("app", channel_name="nope")
