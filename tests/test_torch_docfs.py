"""The port's docfs metadata store against the JAX package's.

- The metadata contract: one script a DAO (apps, access keys, channels,
  engine instances, evaluation instances, engine manifests, models) runs
  on both packages' stores, each in a directory of its own; every answer
  is equal, and the two directories hold the same files byte for byte.
- A directory written by either package is read by the other to the same
  records; ids allocated by one go on in the other.
- The exclusive create (``put_new``) holds across processes: apps
  inserted by several processes at once get distinct ids.
- A storage with docfs metadata and models and segmentfs events (no
  sqlite file) trains on the CPU through the data view; the JAX package
  reads its instance and model blob.

Every comparison is exact.
"""

import datetime as dt
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.storage import base as jbase  # noqa: E402
from predictionio_tpu.data.storage import docfs as jdoc  # noqa: E402
from predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import docfs as tdoc  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T0 = dt.datetime(2024, 2, 1, tzinfo=dt.timezone.utc)
PACKAGES = {"port": (tdoc, tbase), "jax": (jdoc, jbase)}
DAOS = ("Apps", "AccessKeys", "Channels", "EngineInstances", "EvaluationInstances",
        "EngineManifests", "Models")


def _daos(pkg, path):
    doc, _ = PACKAGES[pkg]
    client = doc._DocFSClient({"PATH": str(path)})
    return {name: getattr(doc, f"DocFS{name}")(client=client) for name in DAOS}


def _rec(obj):
    """A record as plain data (dataclass fields, times as ISO strings)."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, dt.datetime):
        return obj.isoformat()
    if isinstance(obj, (list, tuple)):
        return [_rec(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _rec(v) for k, v in obj.items()}
    return {k: _rec(v) for k, v in vars(obj).items()}


def _apps(b, d):
    a = d["Apps"]
    return [a.insert(b.App(0, "alpha", "first")), a.insert(b.App(0, "beta", None)),
            a.insert(b.App(7, "gamma", "explicit")), a.insert(b.App(0, "alpha")),
            a.insert(b.App(7, "delta")), a.insert(b.App(0, "eps")),
            _rec(a.get(1)), _rec(a.get_by_name("gamma")), _rec(a.get(99)),
            sorted(x.name for x in a.get_all()),
            a.update(b.App(1, "alpha2", "renamed")), a.update(b.App(2, "gamma")),
            a.update(b.App(50, "nope")), a.insert(b.App(0, "alpha")),
            a.delete(2), a.delete(2), a.insert(b.App(0, "beta")),
            sorted((x.id, x.name) for x in a.get_all())]


def _keys(b, d):
    k = d["AccessKeys"]
    return [k.insert(b.AccessKey("KEY1", 1, ("view", "buy"))), k.insert(b.AccessKey("KEY1", 2)),
            k.insert(b.AccessKey("KEY2", 1)), k.insert(b.AccessKey("K/3 ?", 2, ("rate",))),
            _rec(k.get("KEY1")), _rec(k.get("K/3 ?")), k.get("none"),
            sorted(x.key for x in k.get_by_app_id(1)),
            k.update(b.AccessKey("KEY2", 1, ("rate",))), k.update(b.AccessKey("NO", 1)),
            _rec(k.get("KEY2")), k.delete("KEY1"), k.delete("KEY1"),
            sorted(x.key for x in k.get_all())]


def _channels(b, d):
    c = d["Channels"]
    return [c.insert(b.Channel(0, "ch-1", 1)), c.insert(b.Channel(0, "bad name!", 1)),
            c.insert(b.Channel(0, "ch-1", 1)), c.insert(b.Channel(0, "ch-1", 2)),
            c.insert(b.Channel(0, "ch_2", 1)), _rec(c.get(1)),
            sorted(x.id for x in c.get_by_app_id(1)), c.delete(1), c.delete(1),
            c.insert(b.Channel(0, "ch-1", 1)), sorted(x.name for x in c.get_by_app_id(1))]


def _instances(b, d):
    ins = d["EngineInstances"]
    kw = dict(engine_id="eng", engine_version="1", engine_variant="v.json",
              engine_factory="f", env={"A": "1"}, data_source_params='{"x": 1}',
              algorithms_params="[]")
    i1 = ins.insert(b.EngineInstance(id="ei-1", status="INIT", start_time=T0,
                                     end_time=T0, **kw))
    rec = ins.get(i1)
    rec.status = "COMPLETED"
    out = [i1, ins.update(rec)]
    ins.insert(b.EngineInstance(id="ei-2", status="COMPLETED",
                                start_time=T0 + dt.timedelta(hours=1),
                                end_time=T0 + dt.timedelta(hours=2), **kw))
    ins.insert(b.EngineInstance(id="ei-3", status="ABORTED", start_time=T0, end_time=T0,
                                **kw))
    out += [_rec(ins.get("ei-2")), [r.id for r in ins.get_completed("eng", "1", "v.json")],
            ins.get_latest_completed("eng", "1", "v.json").id,
            ins.get_latest_completed("x", "1", "v.json"),
            ins.update(b.EngineInstance(id="nope", status="X", start_time=T0, end_time=T0,
                                        **kw)),
            sorted(r.id for r in ins.get_all()), ins.delete("ei-3"), ins.get("ei-3")]
    return out


def _evaluations(b, d):
    ev = d["EvaluationInstances"]
    out = []
    for n, status in enumerate(("EVALCOMPLETED", "EVALRUNNING", "EVALCOMPLETED")):
        out.append(ev.insert(b.EvaluationInstance(
            id=f"evi-{n}", status=status, start_time=T0 + dt.timedelta(minutes=n),
            end_time=T0, evaluation_class="mod.Eval", evaluator_results="best",
            evaluator_results_json='{"score": 0.5}', env={"B": "2"})))
    rec = ev.get("evi-1")
    rec.status = "EVALABORTED"
    out += [ev.update(rec), _rec(ev.get("evi-1")), [r.id for r in ev.get_completed()],
            sorted(r.id for r in ev.get_all()), ev.delete("evi-0"), ev.get("evi-0")]
    return out


def _manifests(b, d):
    m = d["EngineManifests"]
    m.insert(b.EngineManifest("eng", "1", "Engine", "desc", ("a.py", "b.py"), "f.Factory"))
    out = [_rec(m.get("eng", "1")), m.get("eng", "2")]
    try:
        m.update(b.EngineManifest("eng", "2", "Engine"))
    except b.StorageError as e:
        out.append(str(e))
    m.update(b.EngineManifest("eng", "2", "Engine 2"), upsert=True)
    out += [sorted((x.id, x.version) for x in m.get_all())]
    m.delete("eng", "1")
    out += [m.get("eng", "1"), sorted((x.id, x.version) for x in m.get_all())]
    return out


def _models(b, d):
    m = d["Models"]
    blob = bytes(np.random.default_rng(3).integers(0, 256, 4096, dtype=np.uint8))
    m.insert(b.Model("m/1", blob))
    out = [m.get("m/1").models == blob, m.get("missing")]
    m.insert(b.Model("m/1", b"v2"))
    out.append(m.get("m/1").models)
    m.delete("m/1")
    m.delete("m/1")
    out.append(m.get("m/1"))
    m.insert(b.Model("kept", blob[:100]))
    return out


SCRIPTS = {"Apps": _apps, "AccessKeys": _keys, "Channels": _channels,
           "EngineInstances": _instances, "EvaluationInstances": _evaluations,
           "EngineManifests": _manifests, "Models": _models}


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("dao", DAOS)
def test_metadata_contract_matches_jax(tmp_path, dao):
    got = SCRIPTS[dao](tbase, _daos("port", tmp_path / "port"))
    want = SCRIPTS[dao](jbase, _daos("jax", tmp_path / "jax"))
    assert got == want
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert not [n for n in _files(tmp_path / "port") if n.endswith(".tmp")]


def _write_all(pkg, path):
    b = PACKAGES[pkg][1]
    d = _daos(pkg, path)
    for dao in DAOS:
        SCRIPTS[dao](b, d)
    return d


def _read_all(d):
    return [sorted((a.id, a.name, a.description) for a in d["Apps"].get_all()),
            sorted((k.key, k.app_id, tuple(k.events)) for k in d["AccessKeys"].get_all()),
            sorted((c.id, c.name, c.app_id) for c in d["Channels"].get_by_app_id(1)),
            sorted(json.dumps(_rec(i), sort_keys=True) for i in d["EngineInstances"].get_all()),
            [i.id for i in d["EngineInstances"].get_completed("eng", "1", "v.json")],
            sorted(json.dumps(_rec(i), sort_keys=True)
                   for i in d["EvaluationInstances"].get_all()),
            [i.id for i in d["EvaluationInstances"].get_completed()],
            sorted(json.dumps(_rec(m), sort_keys=True)
                   for m in d["EngineManifests"].get_all()),
            d["Models"].get("kept").models, d["Models"].get("m/1"),
            d["Apps"].get_by_name("eps").id]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_directory_reads_across_packages(tmp_path, writer, reader):
    w = _write_all(writer, tmp_path / "doc")
    r = _daos(reader, tmp_path / "doc")
    assert _read_all(r) == _read_all(w)
    taken = {a.id for a in w["Apps"].get_all()}
    # the reader allocates the next ids and names as the writer would
    rb = PACKAGES[reader][1]
    wb = PACKAGES[writer][1]
    got = [r["Apps"].insert(rb.App(0, "next")), r["Channels"].insert(rb.Channel(0, "c9", 1)),
           r["Apps"].insert(rb.App(0, "gamma"))]
    w2 = _daos(writer, tmp_path / "doc")
    assert w2["Apps"].get_by_name("next").id == got[0] and got[0] not in taken
    assert w2["Channels"].get(got[1]).name == "c9"
    assert got[2] is None and w2["Apps"].insert(wb.App(0, "next")) is None


def test_listings_skip_torn_and_alien_files(tmp_path):
    d = _daos("port", tmp_path / "doc")
    d["Apps"].insert(tbase.App(0, "ok"))
    (tmp_path / "doc" / "apps" / "zz.json").write_text('{"__kind__": "apps", "id"')
    (tmp_path / "doc" / "apps" / "notes.txt").write_text("x")
    assert [a.name for a in d["Apps"].get_all()] == ["ok"]
    j = _daos("jax", tmp_path / "doc")
    assert [a.name for a in j["Apps"].get_all()] == ["ok"]


def test_id_allocation_skips_explicit_ids(tmp_path):
    apps = _daos("port", tmp_path / "d")["Apps"]
    assert apps.insert(tbase.App(3, "explicit")) == 3
    ids = [apps.insert(tbase.App(0, f"auto{i}")) for i in range(4)]
    assert 3 not in ids and len(set(ids)) == 4
    assert apps.get(3).name == "explicit"
    assert apps.insert(tbase.App(0, "explicit")) is None
    assert apps.update(tbase.App(3, "renamed"))
    assert apps.insert(tbase.App(0, "explicit")) is not None


def test_put_new_holds_across_processes(tmp_path):
    """Three processes (two of the port, one of the JAX package) insert
    20 apps each into one directory at once: 60 distinct ids, each row
    the app its name says."""
    path = str(tmp_path / "doc")
    code = textwrap.dedent("""
        import sys
        pkg, path, tag = sys.argv[1:]
        if pkg == "port":
            from predictionio_tpu_torch.data.storage import base, docfs
        else:
            from predictionio_tpu.data.storage import base, docfs
        apps = docfs.DocFSApps(client=docfs._DocFSClient({"PATH": path}))
        ids = [apps.insert(base.App(0, f"{tag}-{i}")) for i in range(20)]
        print(",".join(map(str, ids)))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, pkg, path, tag], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pkg, tag in (("port", "a"), ("port", "b"), ("jax", "c"))]
    ids = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        ids += [int(x) for x in out.strip().split(",")]
    assert sorted(ids) == list(range(1, 61))
    apps = _daos("port", tmp_path / "doc")["Apps"]
    names = {a.id: a.name for a in apps.get_all()}
    assert len(names) == 60 and len(set(names.values())) == 60


def test_registry_serves_docfs_daos_from_one_client(tmp_path):
    storage = treg.Storage(treg.StorageConfig(
        sources={"DOC": treg.SourceConfig("DOC", "docfs", {"PATH": str(tmp_path / "m")})},
        repositories={"METADATA": "DOC", "MODELDATA": "DOC"}))
    apps = storage.get_meta_data_apps()
    assert isinstance(apps, tdoc.DocFSApps)
    assert isinstance(storage.get_model_data_models(), tdoc.DocFSModels)
    assert apps._client is storage.get_meta_data_engine_instances()._client
    with pytest.raises(tbase.StorageError, match="EVENTDATA is not configured"):
        storage.get_events()
    ev = treg.Storage(treg.StorageConfig(
        sources={"DOC": treg.SourceConfig("DOC", "docfs", {"PATH": str(tmp_path / "m")})},
        repositories={"EVENTDATA": "DOC"}))
    with pytest.raises(tbase.StorageError, match="does not implement EventStore"):
        ev.get_events()


def _rate_events(mod, rng, n=160):
    return [mod.Event(event="rate", entity_type="user", entity_id=f"u{rng.integers(8)}",
                      target_entity_type="item", target_entity_id=f"i{rng.integers(12)}",
                      properties={"rating": float(rng.integers(1, 6))},
                      event_time=T0 + dt.timedelta(minutes=k), event_id=f"r{k:04d}")
            for k in range(n)]


def test_docfs_and_segmentfs_storage_trains_without_sqlite(tmp_path):
    """METADATA and MODELDATA on docfs, EVENTDATA on segmentfs: a CPU
    train through the data view (a miss, then a hit after tail-only
    ingest), the latest completed runtime, and the JAX package reading
    the instance and the model blob from the same directory."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.view import DataView
    from predictionio_tpu_torch.workflow.core import run_train
    from predictionio_tpu_torch.workflow.server import latest_completed_runtime

    def config(reg):
        return reg.StorageConfig(
            sources={"DOC": reg.SourceConfig("DOC", "docfs", {"PATH": str(tmp_path / "meta")}),
                     "SEG": reg.SourceConfig("SEG", "segmentfs", {
                         "PATH": str(tmp_path / "seg"), "SEAL_INTERVAL_S": "3600"})},
            repositories={"METADATA": "DOC", "EVENTDATA": "SEG", "MODELDATA": "DOC"})

    storage = treg.Storage(config(treg))
    app_id = storage.get_meta_data_apps().insert(tbase.App(0, "docapp"))
    store = storage.get_events()
    rng = np.random.default_rng(0)
    events = _rate_events(sys.modules[Event.__module__], rng)
    store.insert_batch(events[:120], app_id)
    store.seal(app_id)
    variant = {
        "id": "docrun",
        "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
        "datasource": {"params": {"app_name": "docapp", "event_names": ["rate"],
                                  "use_data_view": True}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "num_iterations": 2}}],
    }
    DataView.stats = {"hits": 0, "misses": 0}
    first = run_train(storage, variant, device="cpu")
    store.insert_batch(events[120:], app_id)
    second = run_train(storage, variant, device="cpu")
    assert first.status == second.status == "COMPLETED"
    assert DataView.stats == {"hits": 1, "misses": 1}
    runtime = latest_completed_runtime(storage, "docrun", "0", "docrun", device="cpu")
    assert runtime.instance.id == second.id
    assert not list(tmp_path.rglob("*.db"))
    store.close()
    jstorage = jreg.Storage(config(jreg))
    jinst = jstorage.get_meta_data_engine_instances().get(second.id)
    assert jinst.status == "COMPLETED" and jinst.engine_factory == variant["engineFactory"]
    latest = jstorage.get_meta_data_engine_instances().get_latest_completed(
        "docrun", "0", "docrun")
    assert latest.id == second.id
    assert jstorage.get_model_data_models().get(second.id).models == \
        storage.get_model_data_models().get(second.id).models
    jstorage.get_events().close()
