"""The port's operator tooling against the JAX package's, on the CPU.

- ``workflow/fake.py``: the cases of tests/test_fake_workflow.py (the
  function runs under an eval context, nothing is persisted, the device
  flows through where the JAX mesh does, exceptions propagate), and
  ``FakeEvalResult`` renders as the JAX one.
- ``tools/template.py``: the cases of tests/test_template_gallery.py
  through ``python -m predictionio_tpu_torch.tools.console`` (the list,
  no overwrite, a scaffold that trains and deploys from its own
  directory), every ported template's skeleton resolving, and the
  families the port lacks listed and refused.
- ``tools/shell.py``: the JAX namespace's names over the port's objects;
  a script and piped input run in it.
- Engine manifests: a completed train registers one in either package,
  and the other package's ``status`` lists it with the same line.
- ``export``/``import --format parquet``: a file one package's console
  writes, the other's reads; ``.parquet`` sniffing, the error text of an
  unreadable file, malformed rows skipped with exit 1.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from predictionio_tpu.tools import console as jconsole  # noqa: E402
from predictionio_tpu.tools import template as jtemplate  # noqa: E402
from predictionio_tpu.workflow import fake as jfake  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from predictionio_tpu_torch.tools import console  # noqa: E402
from predictionio_tpu_torch.tools import template  # noqa: E402
from predictionio_tpu_torch.workflow.fake import FakeEvalResult, run_fake_workflow  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def base(tmp_path, monkeypatch):
    """PIO_FS_BASEDIR under tmp_path, no PIO_STORAGE_* variables: both
    consoles' development wiring (sqlite + model files) over one pio.db."""
    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    jreg.Storage.set_instance(None)  # the JAX console's process singleton
    yield tmp_path / "store"
    jreg.Storage.set_instance(None)


def _run(main, argv, capsys):
    code = main(argv)
    out, err = capsys.readouterr()
    return code, out, err


def _env(base):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_FS_BASEDIR=str(base), PYTHONPATH=str(REPO))
    return env


# -- FakeWorkflow --------------------------------------------------------------------


def _storage(tmp_path):
    return treg.Storage(treg.StorageConfig.default_dev(str(tmp_path / "fake")))


def test_runs_fn_under_eval_context(tmp_path):
    seen = {}

    def probe(ctx):
        seen.update(mode=ctx.mode, has_storage=ctx.storage is not None,
                    save=ctx.workflow_params.save_model)
        return float(np.square(np.arange(4)).sum())

    result = run_fake_workflow(probe, storage=_storage(tmp_path))
    assert isinstance(result, FakeEvalResult) and result.no_save
    assert result.value == 14.0
    assert seen == {"mode": "eval", "has_storage": True, "save": True}
    assert "FakeEvalResult" in result.to_one_liner() and "14.0" in result.to_json()


def test_nothing_persisted(tmp_path):
    storage = _storage(tmp_path)
    before = storage.get_meta_data_evaluation_instances().get_all()
    run_fake_workflow(lambda ctx: "hello", storage=storage)
    after = storage.get_meta_data_evaluation_instances().get_all()
    assert len(before) == len(after) == 0


def test_device_flows_through():
    """The JAX mesh's place: the caller's device reaches the function."""
    assert run_fake_workflow(lambda ctx: ctx.device, device="cpu").value == "cpu"
    assert run_fake_workflow(lambda ctx: ctx.device).value is None


def test_exceptions_propagate(tmp_path):
    storage = _storage(tmp_path)

    def boom(ctx):
        raise RuntimeError("bad fn")

    with pytest.raises(RuntimeError, match="bad fn"):
        run_fake_workflow(boom, storage=storage)
    assert storage.get_meta_data_evaluation_instances().get_all() == []


@pytest.mark.parametrize("value", [14.0, "hello", {"a": [1, 2]}, None, object])
def test_fake_result_renders_as_jax(value):
    got, want = FakeEvalResult(value), jfake.FakeEvalResult(value)
    assert got.no_save is want.no_save is True
    assert (got.to_one_liner(), got.to_html(), got.to_json()) == (
        want.to_one_liner(), want.to_html(), want.to_json())


# -- the template gallery ----------------------------------------------------------------


def _console(args, cwd, env, timeout=300):
    out = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.console", *args],
                         cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout + out.stderr


def test_template_list(base, tmp_path):
    code, out = _console(["template", "list"], tmp_path, _env(base))
    assert code == 0
    for name in ("recommendation", "similarproduct", "classification", "ecommerce",
                 "universal", "markov", "itemsim", "simrank", "friendrec"):
        assert name in out
    # the JAX gallery's names and descriptions, in its order
    assert [(t.name, t.description) for t in template.list_templates()] == [
        (t.name, t.description.replace(", MXU matmuls", ""))
        for t in jtemplate.list_templates()]
    lines = out.splitlines()
    assert [ln.split()[0] for ln in lines] == [t.name for t in jtemplate.list_templates()]
    unported = {ln.split()[0] for ln in lines if ln.endswith("(not ported yet)")}
    assert unported == {"markov", "itemsim", "simrank", "friendrec"}


def test_scaffold_refuses_overwrite(base, tmp_path):
    env = _env(base)
    assert _console(["template", "get", "classification", str(tmp_path / "eng")],
                    tmp_path, env)[0] == 0
    code, out = _console(["template", "get", "classification", str(tmp_path / "eng")],
                         tmp_path, env)
    assert code != 0 and "already contains" in out


@pytest.mark.parametrize("name", [t.name for t in template.list_templates()])
def test_every_template_scaffolds_or_is_refused(tmp_path, name, monkeypatch):
    """A ported template's scaffold imports from its directory and its
    engine.json gives the engine's params; a family the port lacks is
    refused and leaves nothing behind."""
    t = template.TEMPLATES[name]
    dest = tmp_path / "eng"
    if not t.ported:
        with pytest.raises(template.NotPortedTemplate):
            template.scaffold(name, str(dest))
        assert not dest.exists()
        return
    pkg = "pkg_" + name.replace("-", "_")
    template.scaffold(name, str(dest), pkg)
    from predictionio_tpu_torch.controller.engine import resolve_engine
    from predictionio_tpu_torch.controller.params import load_symbol
    from predictionio_tpu_torch.workflow.core import load_variant

    monkeypatch.syspath_prepend(str(dest))
    variant = load_variant(str(dest / "engine.json"))
    assert variant["engineFactory"] == f"{pkg}.{t.factory}"
    engine = resolve_engine(load_symbol(variant["engineFactory"]))
    params = engine.params_from_variant_json(variant)
    assert [n for n, _ in params.algorithm_params_list] == [
        a["name"] for a in t.default_params["algorithms"]]
    assert (dest / pkg / "engine.py").read_bytes() == (
        REPO / t.package.replace(".", "/") / "engine.py").read_bytes()
    assert "python -m predictionio_tpu_torch.tools.console train" in (
        dest / "README.md").read_text()


def test_scaffold_refuses_bad_names(tmp_path):
    with pytest.raises(ValueError, match="unknown template"):
        template.scaffold("nope", str(tmp_path / "a"))
    with pytest.raises(ValueError, match="lowercase identifier"):
        template.scaffold("recommendation", str(tmp_path / "b"), "Bad-Name")
    with pytest.raises(ValueError, match="lowercase identifier"):
        template.scaffold("recommendation-file", str(tmp_path / "c"))  # my_recommendation-file


def test_scaffolded_engine_trains_and_deploys(base, tmp_path):
    env = _env(base)
    eng_dir = tmp_path / "myengine"
    assert _console(["template", "get", "recommendation", str(eng_dir), "--package",
                     "shoprec"], tmp_path, env)[0] == 0
    variant = json.loads((eng_dir / "engine.json").read_text())
    assert variant["engineFactory"] == "shoprec.RecommendationEngine"
    variant["datasource"]["params"]["app_name"] = "ShopApp"
    (eng_dir / "engine.json").write_text(json.dumps(variant))
    assert _console(["app", "new", "ShopApp"], eng_dir, env)[0] == 0
    lines = [json.dumps({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                         "targetEntityType": "item", "targetEntityId": f"i{i}",
                         "properties": {"rating": 4.0},
                         "eventTime": "2026-01-01T00:00:00.000Z"})
             for u in range(6) for i in range(5) if (u + i) % 2 == 0]
    (eng_dir / "events.jsonl").write_text("\n".join(lines) + "\n")
    assert _console(["import", "--app", "ShopApp", "--input", "events.jsonl"],
                    eng_dir, env)[0] == 0
    code, out = _console(["train", "--engine-json", "engine.json", "--device", "cpu"],
                         eng_dir, env)
    assert code == 0 and "completed" in out.lower(), out
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", "deploy",
         "--engine-json", "engine.json", "--ip", "127.0.0.1", "--port", str(port),
         "--device", "cpu"], cwd=eng_dir, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline, body = time.time() + 120, None
        while time.time() < deadline:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/queries.json",
                    data=json.dumps({"user": "u0", "num": 2}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=5) as r:
                    body = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, "deploy died:\n" + proc.stdout.read()
                time.sleep(0.5)
        assert body is not None, "deploy server never answered"
        assert len(body["item_scores"]) == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    # the train registered the scaffold's engine
    code, out = _console(["status"], eng_dir, env)
    assert code == 0 and "[INFO]   shoprec v0: shoprec.RecommendationEngine" in out


# -- the shell ---------------------------------------------------------------------------


def test_shell_namespace_is_the_jax_one_over_the_port(base):
    from predictionio_tpu.tools import shell as jshell
    from predictionio_tpu_torch.data.storage.base import EventQuery
    from predictionio_tpu_torch.tools import shell

    ns, jns = shell.make_namespace(), jshell.make_namespace()
    assert set(ns) == set(jns)
    assert ns["EventQuery"] is EventQuery
    assert type(ns["storage"]) is treg.Storage
    assert type(ns["events"]).__module__ == "predictionio_tpu_torch.data.storage.sqlite"
    assert ns["models"].__name__ == "predictionio_tpu_torch.models"
    assert ns["engines"].__name__ == "predictionio_tpu_torch.engines"
    assert type(ns["facade"]).__module__ == "predictionio_tpu_torch.data.store.event_store"


def test_shell_runs_scripts_and_piped_input(base, tmp_path):
    env = _env(base)
    script = tmp_path / "s.py"
    script.write_text("import sys\nprint('args', sys.argv[1:], type(events).__name__)\n")
    out = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.shell",
                          str(script), "x"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "args ['x'] SqliteEventStore" in out.stdout
    out = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.shell"],
                         input="print(storage.verify_all_data_objects()[0])\nhelp_pio()\n",
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK SqliteApps" in out.stdout
    assert "Preloaded:" in out.stdout and "jax" not in out.stdout
    assert "predictionio_tpu_torch.models import als" in out.stdout


# -- engine manifests ------------------------------------------------------------------


def _seed_app(storage, base_mod, event_mod, name="manapp"):
    app_id = storage.get_meta_data_apps().insert(base_mod.App(0, name))
    events = storage.get_events()
    events.init_app(app_id)
    rng = np.random.RandomState(0)
    events.insert_batch([event_mod.Event(
        event="rate", entity_type="user", entity_id=f"u{rng.randint(6)}",
        target_entity_type="item", target_entity_id=f"i{rng.randint(10)}",
        properties={"rating": float(rng.randint(1, 6))}) for _ in range(120)], app_id)


def _manifest_lines(out):
    return [ln for ln in out.splitlines()
            if ln.startswith("[INFO]   ") and " v0: " in ln]


@pytest.mark.parametrize("trainer", ["jax", "port"])
def test_manifests_listed_by_the_other_status(base, capsys, trainer):
    """A completed train registers its engine's manifest (non-fatal,
    upserted); the other package's `status` lists it with the line its
    own status prints."""
    if trainer == "port":
        from predictionio_tpu_torch.data import event as mod_event
        from predictionio_tpu_torch.data.storage import base as mod_base
        from predictionio_tpu_torch.workflow.core import run_train

        storage = treg.Storage()
        factory = "predictionio_tpu_torch.engines.recommendation.RecommendationEngine"
        kw = {"device": "cpu"}
    else:
        from predictionio_tpu.data import event as mod_event
        from predictionio_tpu.data.storage import base as mod_base
        from predictionio_tpu.workflow.core import run_train

        storage = jreg.Storage()
        factory = "predictionio_tpu.engines.recommendation.RecommendationEngine"
        kw = {}
    _seed_app(storage, mod_base, mod_event)
    variant = {"id": "maneng", "engineFactory": factory,
               "datasource": {"params": {"app_name": "manapp"}},
               "algorithms": [{"name": "als", "params": {"rank": 4, "num_iterations": 2}}]}
    for _ in range(2):  # a second train upserts the same (id, version)
        assert run_train(storage, variant, **kw).status == "COMPLETED"
    [m] = storage.get_meta_data_engine_manifests().get_all()
    assert (m.id, m.version, m.name, m.engine_factory) == ("maneng", "0", "maneng", factory)
    assert m.files == (factory.rsplit(".", 1)[0],)
    code, port_out, _ = _run(console.main, ["status"], capsys)
    assert code == 0
    code, jax_out, _ = _run(jconsole.main, ["status"], capsys)
    assert code == 0
    want = f"[INFO]   maneng v0: {factory}" + (f" — {m.description}" if m.description else "")
    assert _manifest_lines(port_out) == _manifest_lines(jax_out) == [want]
    assert "[INFO] Registered engines (trained at least once):" in port_out


def test_manifest_registration_is_not_fatal(base, monkeypatch):
    from predictionio_tpu_torch.data import event as tevent
    from predictionio_tpu_torch.data.storage import base as tbase
    from predictionio_tpu_torch.data.storage import sqlite as tsqlite
    from predictionio_tpu_torch.workflow.core import run_train

    storage = treg.Storage()
    _seed_app(storage, tbase, tevent)

    def refuse(self, m, upsert=False):
        raise RuntimeError("manifest store down")

    monkeypatch.setattr(tsqlite.SqliteEngineManifests, "update", refuse)
    variant = {"id": "e2", "engineFactory":
               "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
               "datasource": {"params": {"app_name": "manapp"}},
               "algorithms": [{"name": "als", "params": {"rank": 4, "num_iterations": 2}}]}
    assert run_train(storage, variant, device="cpu").status == "COMPLETED"
    assert storage.get_meta_data_engine_manifests().get_all() == []


# -- parquet import/export ---------------------------------------------------------------


EVENTS = [{"event": "rate", "entityType": "user", "entityId": f"u{n % 7}",
           "targetEntityType": "item", "targetEntityId": f"i{n % 11}",
           "properties": {"rating": n % 5 + 1}, "tags": ["t"] if n % 4 == 0 else [],
           "eventTime": f"2026-02-01T00:00:{n % 60:02d}.{n:03d}Z",
           "eventId": f"ev{n:03d}"} for n in range(90)]


def _clean(jsonl):
    return [{k: v for k, v in json.loads(x).items() if k not in ("creationTime", "revision")}
            for x in jsonl.splitlines()]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parquet_export_imports_in_the_other(base, capsys, tmp_path, writer):
    """One package's `export --format parquet` is the other's `import`
    input (sniffed by its .parquet suffix), and the round trip keeps every
    event; the two exports of one app are equal tables."""
    mains = {"jax": jconsole.main, "port": console.main}
    reader = "port" if writer == "jax" else "jax"
    src = tmp_path / "events.jsonl"
    src.write_text("\n".join(json.dumps(e) for e in EVENTS) + "\n")
    assert _run(mains[writer], ["app", "new", "A"], capsys)[0] == 0
    assert _run(mains[writer], ["import", "--app", "A", "--input", str(src)], capsys)[0] == 0
    out = {}
    for pkg in ("jax", "port"):
        out[pkg] = tmp_path / f"{pkg}.parquet"
        code, text, _ = _run(mains[pkg], ["export", "--app", "A", "--output", str(out[pkg]),
                                          "--format", "parquet"], capsys)
        assert code == 0 and "Exported 90 events" in text
    assert pq.read_table(out["port"]).equals(pq.read_table(out["jax"]))
    assert _run(mains[reader], ["app", "new", "B"], capsys)[0] == 0
    code, text, _ = _run(mains[reader], ["import", "--app", "B", "--input",
                                         str(out[writer])], capsys)
    assert code == 0 and "Imported 90 events" in text
    back = tmp_path / "back.jsonl"
    assert _run(mains[reader], ["export", "--app", "B", "--output", str(back)], capsys)[0] == 0
    assert _clean(back.read_text()) == [{k: v for k, v in e.items() if v != []}
                                        for e in sorted(EVENTS, key=lambda e: (
                                            e["eventTime"], e["eventId"]))]


def test_parquet_import_sniffing_and_errors(base, capsys, tmp_path):
    assert _run(console.main, ["app", "new", "A"], capsys)[0] == 0
    # a .parquet name that is not parquet: the JAX error text, exit 1
    bogus = tmp_path / "bogus.parquet"
    bogus.write_text("not parquet\n")
    with pytest.raises(SystemExit) as e:
        console.main(["import", "--app", "A", "--input", str(bogus)])
    assert str(e.value).startswith(f"[ERROR] {bogus} is not a readable parquet file: ")
    assert jconsole.main(["import", "--app", "A", "--input", str(bogus)]) == 1
    # --format json overrides the suffix
    jsonl = tmp_path / "events.parquet"
    jsonl.write_text(json.dumps(EVENTS[0]) + "\n")
    code, text, _ = _run(console.main, ["import", "--app", "A", "--input", str(jsonl),
                                        "--format", "json"], capsys)
    assert code == 0 and "Imported 1 events" in text
    # --format parquet reads a file of any name; bad rows are skipped, exit 1
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.parquetfs import events_to_table

    table = events_to_table([Event.from_json_dict(e) for e in EVENTS[1:6]])
    bad = table.set_column(table.schema.get_field_index("properties"), "properties",
                           pa.array(["{}", "{", "{}", "{}", "{}"], pa.string()))
    bad = bad.set_column(bad.schema.get_field_index("event"), "event",
                         pa.array(["rate", "rate", "$bogus", "rate", "rate"], pa.string()))
    path = tmp_path / "rows.bin"
    pq.write_table(bad, path)
    code, text, err = _run(console.main, ["import", "--app", "A", "--input", str(path),
                                          "--format", "parquet"], capsys)
    assert code == 1 and "Imported 3 events" in text and "2 malformed rows skipped" in text
    assert "[WARN] row 1: " in err and "[WARN] row 2: " in err
    assert jconsole.main(["import", "--app", "A", "--input", str(path),
                          "--format", "parquet"]) == 1
    # the JSON line and the 3 good rows (the JAX import rewrote the same ids)
    assert _app_rows("A") == 1 + 3


def _app_rows(name):
    from predictionio_tpu_torch.data.storage.base import EventQuery

    storage = treg.Storage()
    app = storage.get_meta_data_apps().get_by_name(name)
    return len(list(storage.get_events().find(EventQuery(app_id=app.id))))
