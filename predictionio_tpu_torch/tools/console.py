"""Command line of the port.

    python -m predictionio_tpu_torch.tools.console app new NAME \\
        [--description D] [--access-key K]
    python -m predictionio_tpu_torch.tools.console app list|show NAME
    python -m predictionio_tpu_torch.tools.console app delete NAME [-f]
    python -m predictionio_tpu_torch.tools.console app data-delete NAME \\
        [--channel C] [-f]
    python -m predictionio_tpu_torch.tools.console channel new|delete APP C
    python -m predictionio_tpu_torch.tools.console accesskey new APP \\
        [--key K] [--events a,b]
    python -m predictionio_tpu_torch.tools.console accesskey list [APP]
    python -m predictionio_tpu_torch.tools.console accesskey delete KEY
    python -m predictionio_tpu_torch.tools.console eventserver [--ip ADDR] \\
        [--port 7070] [--stats]
    python -m predictionio_tpu_torch.tools.console import --app NAME \\
        [--channel C] --input events.jsonl
    python -m predictionio_tpu_torch.tools.console export --app NAME \\
        [--channel C] --output events.jsonl
    python -m predictionio_tpu_torch.tools.console status
    python -m predictionio_tpu_torch.tools.console train --engine-json F \\
        [--engine-version V] [--device cpu]
    python -m predictionio_tpu_torch.tools.console deploy --engine-json F \\
        [--engine-version V] [--ip ADDR] [--port N] [--device cpu]

    python -m predictionio_tpu_torch.tools.console eval run EVALUATION \\
        [GENERATOR] [--device cpu]
    python -m predictionio_tpu_torch.tools.console online \\
        status|pause|resume [--url http://localhost:8000] [--reason R]
    python -m predictionio_tpu_torch.tools.console online cursors
    python -m predictionio_tpu_torch.tools.console jobs submit \
        [--variant engine.json] [--timeout S] [--period S] [--max-attempts N]
    python -m predictionio_tpu_torch.tools.console jobs list [--status S]
    python -m predictionio_tpu_torch.tools.console jobs show|logs JOB
    python -m predictionio_tpu_torch.tools.console jobs gc [--keep N]
    python -m predictionio_tpu_torch.tools.console jobs worker [--once] \
        [--log-dir D] [--device cpu]
    python -m predictionio_tpu_torch.tools.console models list \
        [--engine E] [--status S]
    python -m predictionio_tpu_torch.tools.console models show|promote VERSION
    python -m predictionio_tpu_torch.tools.console models rollback VERSION \
        [--reason R]
    python -m predictionio_tpu_torch.tools.console models gc [--keep N] \
        [--delete-blobs]
    python -m predictionio_tpu_torch.tools.console metrics [--url URL] \
        [--summary]
    python -m predictionio_tpu_torch.tools.console trace list|show|export \
        [TRACE] [--url http://localhost:8000] [--limit N] [--output F]
    python -m predictionio_tpu_torch.tools.console profile list|show|capture \
        [NAME] [--url http://localhost:8000] [--dir D] [--seconds S]

    python -m predictionio_tpu_torch.tools.console train --ratings FILE \\
        --out blob.npz [--rank 10] [--iterations 20] [--lambda 0.01] \\
        [--alpha 1.0] [--explicit] [--device cpu]
    python -m predictionio_tpu_torch.tools.console deploy --model PATH \\
        --port N [--ip ADDR] [--serve-dtype f32|bf16|int8] [--device cpu]

These are the JAX package's ``pio`` commands over the configured storage
(``PIO_STORAGE_*``, else sqlite and model files under
``PIO_FS_BASEDIR``, default ``~/.pio_store``). ``app new`` registers an
app and prints its default access key; ``app``, ``channel`` and
``accesskey`` list, show and delete what the JAX package's verbs do.
``eventserver`` serves the Event Server (``data/api/server.py``) until
interrupted; it makes no device call, and neither imports the model and
kernel modules nor touches CUDA. ``import`` writes events from JSON
lines (one event object a line, as ``pio import`` reads them) and
``export`` writes them so. ``train --engine-json`` trains the engine
variant into an engine instance and its MODELDATA blob, and ``deploy
--engine-json`` serves the variant's newest completed instance until
interrupted. ``eval run`` evaluates an ``Evaluation`` named by its
import path (``module.Class``) over the grid of an
``EngineParamsGenerator`` (or the evaluation's own
``engine_params_list``) and stores an evaluation instance; it exits 0
only when that instance is EVALCOMPLETED. ``online status|pause|resume``
ask a running query server (``--url``) for its fold-in consumer's state,
or pause or resume it; ``online cursors`` prints the consumers' durable
cursor records from storage. ``jobs submit`` queues a train job of
an engine variant; ``jobs worker`` claims queued jobs and runs each in a
supervised subprocess on ``--device`` (``--once``: the jobs queued now,
then exit); ``jobs list|show|logs|gc`` read and prune the queue.
``models list|show|promote|rollback|gc`` read the model versions that
train jobs register, make one live, roll one back and collect old ones.
``metrics`` prints a server's ``/metrics`` (``--url`` names the whole
URL) or this process's registry; ``trace list|show|export`` read a
running server's retained traces (``--url``: its base URL; export
writes Chrome trace-event JSON for https://ui.perfetto.dev) or this
process's; ``profile list|show`` print a server's device profile
(``/debug/profile``) or this process's, and ``profile capture`` asks
the server for a ``torch.profiler`` window (``POST
/debug/profile/capture``; the server needs ``PIO_PROFILE_CAPTURE_DIR``)
or, with ``--dir``, opens one in this process. Not ported, and refused with
exit code 1: the fleet evaluation (an EvalSpec file as the target,
``eval list/show/status/gc``), ``tune``, ``eventserver --log-url`` and
the parquet format of ``import`` and ``export``. An operator error (an
app, channel or key that does not exist or is taken) exits 1 with
``[ERROR]`` and the reason.

``train --ratings`` reads ``user::item::rating`` lines and writes the
npz factor blob (``ALSFactors.to_bytes()``, the JAX package's format);
``deploy --model`` serves such a blob, written here or by the JAX
package. Every command that trains or serves runs on the first CUDA
device unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
from pathlib import Path
from typing import Optional

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App, Channel, EventQuery
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.tools import common
from predictionio_tpu_torch.tools.common import CommandError

# The model, kernel and workflow modules are imported inside the
# commands that train, serve or evaluate, so that the others (the event
# server above all) start without torch.

# the JAX package's fleet-evaluation commands, which the port refuses
NOT_PORTED_EVAL = ("list", "show", "status", "gc")


def _not_ported(what: str) -> int:
    print(f"[ERROR] {what} is not ported yet to the PyTorch port", file=sys.stderr)
    return 1


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="predictionio_tpu_torch.tools.console")
    sub = ap.add_subparsers(dest="cmd", required=True)
    app = sub.add_parser("app", help="manage apps").add_subparsers(
        dest="app_cmd", required=True)
    new = app.add_parser("new", help="register an app and its default access key")
    new.add_argument("name")
    new.add_argument("--description")
    new.add_argument("--access-key")
    app.add_parser("list", help="list apps and their access keys")
    app.add_parser("show", help="an app, its channels and keys").add_argument("name")
    s = app.add_parser("delete", help="delete an app with its channels, events and keys")
    s.add_argument("name")
    s.add_argument("-f", "--force", action="store_true")
    s = app.add_parser("data-delete", help="delete an app's events in one channel")
    s.add_argument("name")
    s.add_argument("--channel")
    s.add_argument("-f", "--force", action="store_true")
    ch = sub.add_parser("channel", help="manage channels").add_subparsers(
        dest="channel_cmd", required=True)
    for name in ("new", "delete"):
        s = ch.add_parser(name)
        s.add_argument("app")
        s.add_argument("channel")
    ak = sub.add_parser("accesskey", help="manage access keys").add_subparsers(
        dest="accesskey_cmd", required=True)
    s = ak.add_parser("new")
    s.add_argument("app")
    s.add_argument("--key")
    s.add_argument("--events", help="comma-separated event names the key may write")
    ak.add_parser("list").add_argument("app", nargs="?")
    ak.add_parser("delete").add_argument("key")
    es = sub.add_parser("eventserver", help="serve the Event Server")
    es.add_argument("--ip", default="0.0.0.0")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--stats", action="store_true")
    es.add_argument("--log-url", help="not ported")
    sub.add_parser("status", help="the storage and the device")
    for name, what, io in (("import", "write an app's events from JSON lines", "--input"),
                           ("export", "write an app's events as JSON lines", "--output")):
        s = sub.add_parser(name, help=what)
        s.add_argument("--app", required=True)
        s.add_argument("--channel")
        s.add_argument(io, required=True, type=Path)
        s.add_argument("--format", choices=("json", "parquet"), default="json",
                       help="parquet is not ported")

    tr = sub.add_parser("train", help="train an engine variant, or ALS factors "
                                      "from a ratings file")
    src = tr.add_mutually_exclusive_group(required=True)
    src.add_argument("--engine-json", type=Path, help="the engine variant")
    src.add_argument("--ratings", type=Path, help="user::item::rating lines")
    tr.add_argument("--engine-version", default="0")
    tr.add_argument("--delimiter", default="::")
    tr.add_argument("--out", type=Path,
                    help="with --ratings: where to write the factor blob (npz)")
    # with --ratings; unset ones take ALSAlgorithmParams' defaults
    tr.add_argument("--rank", type=int)
    tr.add_argument("--iterations", type=int)
    tr.add_argument("--lambda", dest="lambda_", type=float)
    tr.add_argument("--alpha", type=float)
    tr.add_argument("--explicit", action="store_true",
                    help="explicit ratings (ALS-WR) instead of implicit")
    tr.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")

    dep = sub.add_parser("deploy", help="serve an engine variant's newest "
                                        "trained instance, or an ALS factor blob")
    src = dep.add_mutually_exclusive_group(required=True)
    src.add_argument("--engine-json", type=Path, help="the engine variant")
    src.add_argument("--model", type=Path,
                     help="ALS factor blob (npz bytes of ALSFactors.to_bytes)")
    dep.add_argument("--engine-version", default="0")
    dep.add_argument("--ip", default="0.0.0.0")
    dep.add_argument("--port", type=int, default=8000)
    dep.add_argument("--serve-dtype", default="f32",
                     help="with --model: the serving dtype (f32, bf16 or int8)")
    dep.add_argument("--device", default=None,
                     help="torch device (default: the first CUDA device)")

    ev = sub.add_parser("eval", help="run an evaluation").add_subparsers(
        dest="eval_cmd", required=True)
    run = ev.add_parser("run", help="evaluate an Evaluation over a params grid")
    run.add_argument("target", help="import path of the Evaluation")
    run.add_argument("params_generator", nargs="?",
                     help="import path of an EngineParamsGenerator")
    run.add_argument("--device", default=None,
                     help="torch device (default: the first CUDA device)")
    for name in NOT_PORTED_EVAL:
        ev.add_parser(name, help="not ported").add_argument(
            "rest", nargs=argparse.REMAINDER)
    sub.add_parser("tune", help="not ported").add_argument(
        "rest", nargs=argparse.REMAINDER)

    on = sub.add_parser("online", help="the streaming fold-in consumer"
                        ).add_subparsers(dest="online_action", required=True)
    for name, what in (("status", "consumer status"),
                       ("pause", "pause fold-in (the last-good model serves)"),
                       ("resume", "resume fold-in from the durable cursor")):
        s = on.add_parser(name, help=what)
        s.add_argument("--url", default="http://localhost:8000",
                       help="query server base URL")
        if name == "pause":
            s.add_argument("--reason", default=None)
    on.add_parser("cursors", help="durable consumer cursor records in storage")

    jobs = sub.add_parser("jobs", help="the train-job queue").add_subparsers(
        dest="jobs_action", required=True)
    s = jobs.add_parser("submit", help="queue a train job")
    s.add_argument("--variant", default="engine.json",
                   help="engine variant JSON path (default engine.json)")
    s.add_argument("--timeout", type=float, default=None,
                   help="wall-clock train timeout in seconds")
    s.add_argument("--period", type=float, default=None,
                   help="periodic retrain interval in seconds")
    s.add_argument("--max-attempts", type=int, default=3,
                   help="infrastructure-failure retries before the job fails")
    jobs.add_parser("list", help="list train jobs").add_argument(
        "--status", choices=("queued", "running", "completed", "failed"))
    jobs.add_parser("show", help="one job's record").add_argument("job_id")
    jobs.add_parser("logs", help="print a job's train log").add_argument("job_id")
    jobs.add_parser("gc", help="purge old completed and failed jobs").add_argument(
        "--keep", type=int, default=200, help="terminal job records to keep")
    s = jobs.add_parser("worker", help="run the train scheduler's worker loop")
    s.add_argument("--log-dir", default=None, help="per-job log directory")
    s.add_argument("--once", action="store_true",
                   help="run the jobs queued now, then exit")
    s.add_argument("--device", default=None,
                   help="the jobs' torch device (default: the first CUDA device)")

    models = sub.add_parser("models", help="the model version registry"
                            ).add_subparsers(dest="models_action", required=True)
    s = models.add_parser("list", help="list model versions")
    s.add_argument("--engine", help="only this engine id")
    s.add_argument("--status", choices=("trained", "canary", "live",
                                        "rolled_back", "archived"))
    models.add_parser("show", help="one version and its lineage").add_argument(
        "version_id")
    models.add_parser("promote", help="make a version live").add_argument(
        "version_id")
    s = models.add_parser("rollback", help="mark a version rolled_back")
    s.add_argument("version_id")
    s.add_argument("--reason", default=None)
    s = models.add_parser("gc", help="retention GC over old versions")
    s.add_argument("--keep", type=int, default=5,
                   help="versions kept per engine variant besides live/canary")
    s.add_argument("--delete-blobs", action="store_true",
                   help="also delete the collected versions' MODELDATA blobs")

    s = sub.add_parser("metrics", help="print Prometheus metrics: this process's "
                       "registry, or a running server's /metrics via --url")
    s.add_argument("--url", default=None, help="scrape this URL (e.g. "
                   "http://127.0.0.1:8000/metrics) instead of the local registry")
    s.add_argument("--summary", action="store_true",
                   help="a readable summary instead of exposition text")

    tr = sub.add_parser("trace", help="tail-sampled request traces (local "
                        "recorder, or a running server via --url)"
                        ).add_subparsers(dest="trace_action", required=True)
    s = tr.add_parser("list", help="list retained trace summaries")
    s.add_argument("--url", help="server base URL, e.g. http://127.0.0.1:8000")
    s.add_argument("--limit", type=int, default=20)
    s = tr.add_parser("show", help="print one trace's span tree")
    s.add_argument("trace_id")
    s.add_argument("--url", help="server base URL")
    s = tr.add_parser("export", help="write Chrome trace-event JSON "
                      "(open at ui.perfetto.dev)")
    s.add_argument("trace_id", nargs="?", default=None,
                   help="one trace (default: all retained)")
    s.add_argument("--url", help="server base URL")
    s.add_argument("--output", required=True)

    pr = sub.add_parser("profile", help="per-function device profiling: device "
                        "seconds, work, MFU/roofline, padding waste (local, or a "
                        "server via --url)").add_subparsers(
        dest="profile_action", required=True)
    s = pr.add_parser("list", help="list profiled executables")
    s.add_argument("--url", help="server base URL, e.g. http://127.0.0.1:8000")
    s = pr.add_parser("show", help="one executable's full profile")
    s.add_argument("name")
    s.add_argument("--url", help="server base URL")
    s = pr.add_parser("capture", help="open a torch.profiler window (the server "
                      "needs PIO_PROFILE_CAPTURE_DIR; or --dir for this process)")
    s.add_argument("--url", help="server base URL")
    s.add_argument("--dir", help="local output directory (no --url)")
    s.add_argument("--seconds", type=float, default=2.0)
    return ap


def _get_app(storage: Storage, name: str) -> App:
    app = storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App '{name}' does not exist.")
    return app


def _channel_id(storage: Storage, app: App, name: Optional[str]) -> Optional[int]:
    return common.resolve_channel(storage, app, name) if name else None


def _confirm(question: str) -> bool:
    if input(f"{question} (YES to confirm): ") == "YES":
        return True
    print("[INFO] Aborted.")
    return False


def app_cmd(args: argparse.Namespace) -> int:
    """`app new|list|show|delete|data-delete`, printing what the JAX
    package's verbs print."""
    storage = Storage()
    if args.app_cmd == "new":
        app, key = common.create_app(storage, args.name, description=args.description,
                                     access_key=args.access_key)
        print(f"[INFO] App created: ID={app.id} Name={app.name}")
        print(f"[INFO] Access key: {key}", flush=True)
        return 0
    keys = storage.get_meta_data_access_keys()
    if args.app_cmd == "list":
        print(f"{'ID':>4}  {'Name':<24} Access key(s)")
        for app in sorted(storage.get_meta_data_apps().get_all(), key=lambda a: a.id):
            ks = ", ".join(k.key for k in keys.get_by_app_id(app.id)) or "-"
            print(f"{app.id:>4}  {app.name:<24} {ks}")
        return 0
    app = _get_app(storage, args.name)
    if args.app_cmd == "show":
        print(f"[INFO] App: ID={app.id} Name={app.name} "
              f"Description={app.description or ''}")
        for ch in storage.get_meta_data_channels().get_by_app_id(app.id):
            print(f"[INFO] Channel: ID={ch.id} Name={ch.name}")
        for k in keys.get_by_app_id(app.id):
            print(f"[INFO] Access key: {k.key} events={','.join(k.events) or '(all)'}")
        return 0
    if args.app_cmd == "delete":
        if not args.force and not _confirm(
                f"Delete app '{app.name}' and ALL its data?"):
            return 1
        common.delete_app(storage, app)
        print(f"[INFO] App '{app.name}' deleted.")
        return 0
    channel_id = _channel_id(storage, app, args.channel)
    scope = f"channel '{args.channel}'" if args.channel else "default channel"
    if not args.force and not _confirm(
            f"Delete all event data of app '{app.name}' ({scope})?"):
        return 1
    common.delete_app_data(storage, app, channel_id)
    print(f"[INFO] Event data of app '{app.name}' deleted.")
    return 0


def channel_cmd(args: argparse.Namespace) -> int:
    storage = Storage()
    app = _get_app(storage, args.app)
    if args.channel_cmd == "delete":
        channel_id = common.resolve_channel(storage, app, args.channel)
        storage.get_events().remove_app(app.id, channel_id)
        storage.get_meta_data_channels().delete(channel_id)
        print(f"[INFO] Channel '{args.channel}' deleted.")
        return 0
    if not Channel.is_valid_name(args.channel):
        raise CommandError(f"Channel name {args.channel!r}: {Channel.NAME_CONSTRAINT}")
    channels = storage.get_meta_data_channels()
    if any(c.name == args.channel for c in channels.get_by_app_id(app.id)):
        raise CommandError(f"Channel '{args.channel}' already exists.")
    channel_id = channels.insert(Channel(id=0, name=args.channel, app_id=app.id))
    storage.get_events().init_app(app.id, channel_id)
    print(f"[INFO] Channel created: ID={channel_id} Name={args.channel}")
    return 0


def accesskey_cmd(args: argparse.Namespace) -> int:
    storage = Storage()
    keys = storage.get_meta_data_access_keys()
    if args.accesskey_cmd == "new":
        app = _get_app(storage, args.app)
        events = tuple(e for e in (args.events or "").split(",") if e)
        print(f"[INFO] Access key created: "
              f"{common.create_access_key(storage, app, args.key, events)}")
        return 0
    if args.accesskey_cmd == "list":
        rows = (keys.get_by_app_id(_get_app(storage, args.app).id) if args.app
                else keys.get_all())
        print(f"{'App':>4}  {'Access key':<48} Allowed events")
        for k in rows:
            print(f"{k.app_id:>4}  {k.key:<48} {','.join(k.events) or '(all)'}")
        return 0
    if not keys.delete(args.key):
        raise CommandError(f"Access key not found: {args.key}")
    print(f"[INFO] Access key deleted: {args.key}")
    return 0


def eventserver(args: argparse.Namespace) -> int:
    """Serve the Event Server until interrupted; the banner names the
    bound port (with --port 0, a free one)."""
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig

    if args.log_url:
        return _not_ported("eventserver --log-url (log shipping)")
    server = EventServer(Storage(), EventServerConfig(ip=args.ip, port=args.port,
                                                      stats=args.stats))
    port = server.start()
    print(f"[INFO] Event Server is listening at http://{args.ip}:{port}.", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def status(args: argparse.Namespace) -> int:
    """The storage each repository resolves to, every metadata DAO and the
    event store touched, and the device the trains and deploys take."""
    import torch

    storage = Storage()
    print(f"[INFO] predictionio_tpu_torch: torch {torch.__version__}")
    if torch.cuda.is_available():
        print(f"[INFO] device: cuda:0 {torch.cuda.get_device_name(0)} "
              f"({torch.cuda.device_count()} CUDA device(s))")
    else:
        print("[INFO] device: no CUDA device; train and deploy need --device cpu")
    for repo, name in sorted(storage.config.repositories.items()):
        src = storage.config.sources[name]
        where = src.settings.get("PATH", "")
        print(f"[INFO] {repo}: source {name} ({src.type}) {where}".rstrip())
    for getter in (storage.get_meta_data_apps, storage.get_meta_data_access_keys,
                   storage.get_meta_data_channels,
                   storage.get_meta_data_engine_instances,
                   storage.get_meta_data_evaluation_instances,
                   storage.get_model_data_models, storage.get_events):
        print(f"[INFO]   OK {type(getter()).__name__}")
    print(f"[INFO] {len(storage.get_meta_data_apps().get_all())} app(s). "
          "Your system is all ready to go.", flush=True)
    return 0


def _read_events(path: Path):
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                yield Event.from_json(line)
            except ValueError as e:
                raise SystemExit(f"[ERROR] {path} line {i}: {e}")


def import_events(args: argparse.Namespace) -> int:
    """Validate every line's event and write them through the store's
    bulk write into the app's default channel or `--channel`; a
    malformed line is an error naming its line, and nothing after it is
    written."""
    storage = Storage()
    app = _get_app(storage, args.app)
    return storage.get_events().write(
        _read_events(args.input), app.id, _channel_id(storage, app, args.channel))


def export_events(args: argparse.Namespace) -> int:
    """The channel's events as JSON lines, in (event time, id) order."""
    storage = Storage()
    app = _get_app(storage, args.app)
    events = storage.get_events().find(
        EventQuery(app_id=app.id, channel_id=_channel_id(storage, app, args.channel)))
    n = 0
    with open(args.output, "w") as f:
        for e in events:
            f.write(e.to_json() + "\n")
            n += 1
    return n


def build_server(args: argparse.Namespace):
    """The QueryServer of `deploy`."""
    from predictionio_tpu_torch.convert import load_jax_als_blob
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm, ALSAlgorithmParams, ALSModel)
    from predictionio_tpu_torch.models.als import SERVE_DTYPES
    from predictionio_tpu_torch.workflow.core import load_variant
    from predictionio_tpu_torch.workflow.server import (
        QueryServer, QueryServerConfig, latest_completed_runtime)

    if args.serve_dtype not in SERVE_DTYPES:
        raise SystemExit(f"[ERROR] --serve-dtype {args.serve_dtype!r}: "
                         f"one of {', '.join(SERVE_DTYPES)}")
    config = QueryServerConfig(ip=args.ip, port=args.port)
    if args.engine_json is not None:
        variant = load_variant(str(args.engine_json))
        runtime = latest_completed_runtime(
            Storage(), variant["id"], args.engine_version, variant["id"],
            device=args.device,
        )
        return QueryServer(runtime=runtime, config=config, storage=Storage())
    factors = load_jax_als_blob(args.model.read_bytes())
    params = ALSAlgorithmParams(rank=factors.params.rank, serve_dtype=args.serve_dtype)
    model = ALSModel(factors, serve_dtype=args.serve_dtype, device=args.device)
    return QueryServer(ALSAlgorithm(params), model, config)


def train(args: argparse.Namespace):
    """Read the ratings file, train, and write the factor blob; returns
    the ALSModel."""
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm, ALSAlgorithmParams, FileDataSourceParams,
        FileRatingsDataSource, RuntimeContext)

    ctx = RuntimeContext(device=args.device)
    td = FileRatingsDataSource(
        FileDataSourceParams(str(args.ratings), delimiter=args.delimiter)
    ).read_training(ctx)
    td.sanity_check()
    given = {"rank": args.rank, "num_iterations": args.iterations,
             "lambda_": args.lambda_, "alpha": args.alpha}
    params = ALSAlgorithmParams(implicit_prefs=not args.explicit,
                                **{k: v for k, v in given.items() if v is not None})
    model = ALSAlgorithm(params).train(ctx, td)
    args.out.write_bytes(model.factors.to_bytes())
    return model


def _instance(obj):
    return obj() if isinstance(obj, type) else obj


def eval_run(args: argparse.Namespace) -> int:
    """`eval run`: the single-process evaluation of an Evaluation import
    path over the generator's grid, on `--device`."""
    from predictionio_tpu_torch.controller.evaluation import Evaluation
    from predictionio_tpu_torch.controller.params import ParamsError, load_symbol
    from predictionio_tpu_torch.workflow.evaluation import run_evaluation

    if os.path.isfile(args.target):
        print(f"[ERROR] {args.target} is a file: an EvalSpec runs on the fleet "
              f"evaluation, which is not ported yet to the PyTorch port; name "
              f"an Evaluation import path", file=sys.stderr)
        return 1
    try:
        evaluation = _instance(load_symbol(args.target))
        params_list = None
        if args.params_generator:
            params_list = list(
                _instance(load_symbol(args.params_generator)).engine_params_list)
    except ParamsError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    if not isinstance(evaluation, Evaluation):
        print(f"[ERROR] {args.target} is not an Evaluation", file=sys.stderr)
        return 1
    inst, result = run_evaluation(Storage(), evaluation, params_list,
                                  device=args.device)
    print(f"[INFO] Evaluation {inst.status}: {result.to_one_liner()} "
          f"(instance {inst.id})", flush=True)
    return 0 if inst.status == "EVALCOMPLETED" else 1


def _server_call(base: str, path: str, body: Optional[dict] = None,
                 timeout: float = 30.0) -> dict:
    """POST (with a JSON body) or GET `base+path` on a running query
    server; HTTP and transport failures become CommandError."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base.rstrip("/") + path,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"},
        method="POST" if body is not None else "GET",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")
        try:
            detail = json.loads(detail).get("message", detail)
        except ValueError:
            pass
        raise CommandError(f"query server refused ({e.code}): {detail}")
    except OSError as e:
        raise CommandError(f"query server unreachable at {base}: {e}")


def online(args: argparse.Namespace) -> int:
    """`online status|pause|resume`: a running query server's fold-in
    consumer (--url); `online cursors`: the durable cursor records."""
    counters = ("events_consumed", "events_folded", "users_folded",
                "items_folded", "ticks")
    if args.online_action == "cursors":
        from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore
        from predictionio_tpu_torch.online.consumer import CURSOR_ENTITY

        records = LifecycleRecordStore(Storage()).fold(CURSOR_ENTITY)
        if not records:
            print("[INFO] no online consumer cursors recorded")
            return 0
        for cid, rec in sorted(records.items()):
            print(f"[INFO] {cid}:")
            print(f"[INFO]   cursor: {rec.get('cursor')}")
            for k in counters:
                print(f"[INFO]   {k}: {rec.get(k, 0)}")
        return 0
    if args.online_action == "status":
        st = _server_call(args.url, "/online/status")
    elif args.online_action == "pause":
        st = _server_call(args.url, "/online/pause",
                          {"reason": args.reason or "operator pause"})
    else:
        st = _server_call(args.url, "/online/resume", {})
    print(f"[INFO] online consumer: {st.get('state')}")
    if st.get("state") != "attached":
        return 0
    print(f"[INFO]   paused: {st.get('paused') or 'no'}")
    print(f"[INFO]   cursor {st.get('cursor_id')}: {st.get('cursor')}")
    print(f"[INFO]   drift: {st.get('drift')} "
          f"(threshold {st.get('drift_threshold')})")
    for k, v in (st.get("counters") or {}).items():
        print(f"[INFO]   {k}: {v}")
    return 0


def jobs_cmd(args: argparse.Namespace) -> int:
    """`jobs submit|list|show|logs|gc|worker`: the train-job queue."""
    import json
    import time

    from predictionio_tpu_torch.deploy.scheduler import (
        JobQueue, SchedulerConfig, TrainScheduler)

    storage = Storage()
    queue = JobQueue(storage)
    action = args.jobs_action
    if action == "submit":
        from predictionio_tpu_torch.workflow.core import load_variant

        try:
            job = queue.submit(load_variant(args.variant), timeout_s=args.timeout,
                               period_s=args.period,
                               max_attempts=args.max_attempts)
        except (OSError, ValueError) as e:
            raise CommandError(str(e))
        print(f"[INFO] submitted train job {job.id} (engine {job.engine_id})")
        if job.period_s:
            print(f"[INFO] periodic retrain every {job.period_s:.0f}s")
        return 0
    if action == "list":
        jobs = queue.list(status=args.status)
        if not jobs:
            print("[INFO] no train jobs")
            return 0
        print(f"[INFO] {len(jobs)} train job(s):")
        for j in jobs:
            extra = f" attempt={j.attempt}/{j.max_attempts}"
            if j.model_version:
                extra += f" version={j.model_version}"
            if j.last_error:
                extra += f" error={j.last_error!r}"
            print(f"[INFO]   {j.id} [{j.status}] engine={j.engine_id}"
                  f" created={j.created_at}{extra}")
        return 0
    if action == "gc":
        purged = queue.gc(keep=args.keep)
        print(f"[INFO] purged {len(purged)} terminal job record(s)"
              + (f": {', '.join(purged)}" if purged else ""))
        return 0
    if action in ("show", "logs"):
        job = queue.get(args.job_id)
        if job is None:
            raise CommandError(f"no job {args.job_id!r}")
        if action == "show":
            print(json.dumps(job.to_dict(), indent=2))
            return 0
        if not job.log_path:
            raise CommandError(f"job {job.id} has no log yet")
        try:
            with open(job.log_path, errors="replace") as f:
                sys.stdout.write(f.read())
        except OSError as e:
            raise CommandError(f"job log unreadable: {e}")
        return 0
    config = SchedulerConfig(device=args.device)
    if args.log_dir:
        config.log_dir = args.log_dir
    scheduler = TrainScheduler(storage, config)
    if args.once:
        n = scheduler.run_pending_once()
        print(f"[INFO] ran {n} pending job(s)")
        return 0
    scheduler.start()
    print(f"[INFO] train scheduler running as {scheduler.worker_id} "
          "(Ctrl-C to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("[INFO] stopping scheduler (in-flight train finishes)")
        scheduler.stop()
        return 0


def models_cmd(args: argparse.Namespace) -> int:
    """`models list|show|promote|rollback|gc`: the version registry."""
    import json

    from predictionio_tpu_torch.deploy.registry import ModelRegistry

    registry = ModelRegistry(Storage())
    action = args.models_action
    if action == "list":
        versions = registry.list(engine_id=args.engine, status=args.status)
        if not versions:
            print("[INFO] no registered model versions")
            return 0
        print(f"[INFO] {len(versions)} model version(s):")
        for v in versions:
            note = f" ({v.reason})" if v.reason else ""
            print(f"[INFO]   {v.id} [{v.status}] {v.engine_id}/{v.engine_variant} "
                  f"instance={v.instance_id} params={v.params_hash}"
                  f" created={v.created_at}{note}")
        return 0
    if action == "gc":
        collected = registry.gc(keep=args.keep, delete_blobs=args.delete_blobs)
        print(f"[INFO] collected {len(collected)} version(s)"
              + (f": {', '.join(v.id for v in collected)}" if collected else ""))
        return 0
    version = registry.get(args.version_id)
    if version is None:
        raise CommandError(f"no model version {args.version_id!r}")
    if action == "show":
        print(json.dumps(version.to_dict(), indent=2))
        lineage = registry.lineage(version.id)
        if len(lineage) > 1:
            print("[INFO] lineage: " + " <- ".join(v.id for v in lineage))
        return 0
    if action == "promote":
        print(f"[INFO] {registry.promote(version.id).id} is now live")
        return 0
    v = registry.rollback(version.id, args.reason or "operator rollback")
    print(f"[INFO] {v.id} marked rolled_back")
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    try:
        return _run(args)
    except CommandError as e:
        raise SystemExit(f"[ERROR] {e}")


def _print_registry_summary() -> None:
    """This process's default registry in console form."""
    from predictionio_tpu_torch.obs import get_default_registry

    snap = get_default_registry().snapshot()
    if not snap:
        return
    print("[INFO] Process metrics (registry snapshot):")
    for name, fam in sorted(snap.items()):
        for row in fam["values"]:
            labels = ",".join(f"{k}={v}" for k, v in row["labels"].items())
            where = f"{name}{{{labels}}}" if labels else name
            if fam["type"] == "histogram":
                print(f"[INFO]   {where}: count={row['count']} "
                      f"mean={row['mean'] * 1e3:.1f}ms p50={row['p50'] * 1e3:.1f}ms "
                      f"p99={row['p99'] * 1e3:.1f}ms")
            else:
                print(f"[INFO]   {where}: {row['value']:g}")


def metrics_cmd(args: argparse.Namespace) -> int:
    """`metrics`: a server's /metrics (--url) or this process's registry."""
    if args.url:
        import urllib.request

        with urllib.request.urlopen(args.url, timeout=10) as r:
            print(r.read().decode(), end="")
        return 0
    if args.summary:
        _print_registry_summary()
        return 0
    from predictionio_tpu_torch.obs import get_default_registry

    print(get_default_registry().render(), end="")
    return 0


def _print_span_tree(spans: list) -> None:
    """Spans indented by their parent links; a missing or remote parent
    roots a subtree."""
    ids = {s["span_id"] for s in spans}
    children: dict = {}
    roots = []
    for s in sorted(spans, key=lambda s: s["start"]):
        parent = s.get("parent_span_id")
        if parent in ids:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)

    def walk(s: dict, depth: int) -> None:
        attrs = s.get("attrs", {})
        extra = " ".join(f"{k}={v}" for k, v in attrs.items() if k != "server")
        flag = " ERROR" if s.get("error") else ""
        server = attrs.get("server")
        where = f" [{server}]" if server else ""
        print(f"[INFO] {'  ' * depth}{s['name']}{where} {s['duration_ms']:.3f} ms{flag}"
              + (f"  ({extra})" if extra else ""))
        for c in children.get(s["span_id"], ()):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)


def _traces_or_none(url: str, params: str) -> Optional[dict]:
    """`GET /debug/traces?params`, None when the server has no such
    trace (its 404); other failures raise."""
    try:
        return _server_call(url, f"/debug/traces?{params}")
    except CommandError as e:
        if "(404)" in str(e):
            return None
        raise


def trace_cmd(args: argparse.Namespace) -> int:
    """`trace list|show|export`: the retained (tail-sampled) traces of a
    running server (--url) or of this process."""
    import json

    from predictionio_tpu_torch.obs.spans import get_default_recorder

    url, action = args.url, args.trace_action
    if action == "list":
        if url:
            data = _server_call(url, f"/debug/traces?limit={args.limit}")
            summaries, cfg = data["traces"], data.get("sampling", {})
        else:
            rec = get_default_recorder()
            summaries, cfg = rec.summaries(limit=args.limit), rec.config()
        print(f"[INFO] {len(summaries)} retained trace(s) (sampling: {cfg})")
        for s in summaries:
            where = f" {s['server']}" if s.get("server") else ""
            path = f" {s['path']}" if s.get("path") else ""
            err = " ERROR" if s["error"] else ""
            print(f"[INFO]   {s['trace_id']}  {s['root']}{where}{path}  "
                  f"{s['duration_ms']:.1f} ms  {s['spans']} spans  "
                  f"kept={s['kept']}{err}")
        return 0
    if action == "show":
        if url:
            spans = _traces_or_none(url, f"trace_id={args.trace_id}")
            spans = spans["spans"] if spans else []
        else:
            spans = [s.to_dict() for s in get_default_recorder().get_trace(args.trace_id)]
        if not spans:
            print(f"[ERROR] no retained trace {args.trace_id!r}", file=sys.stderr)
            return 1
        print(f"[INFO] Trace {args.trace_id} ({len(spans)} spans):")
        _print_span_tree(spans)
        return 0
    if url:
        params = "format=perfetto"
        if args.trace_id:
            params = f"trace_id={args.trace_id}&" + params
        export = _traces_or_none(url, params) or {}
    else:
        export = get_default_recorder().perfetto_export(args.trace_id)
    if not export.get("traceEvents"):
        what = (f"no retained trace {args.trace_id!r}" if args.trace_id
                else "no retained traces to export")
        print(f"[ERROR] {what}", file=sys.stderr)
        return 1
    with open(args.output, "w") as f:
        json.dump(export, f)
    print(f"[INFO] Wrote {len(export['traceEvents'])} trace events to "
          f"{args.output} — load it at https://ui.perfetto.dev")
    return 0


def profile_cmd(args: argparse.Namespace) -> int:
    """`profile list|show|capture`: the device profile of a running
    server (--url) or of this process."""
    from predictionio_tpu_torch.obs import devprof

    action, url = args.profile_action, args.url
    if action == "capture":
        if url:
            result = _server_call(url, "/debug/profile/capture",
                                  {"seconds": args.seconds}, timeout=args.seconds + 30)
            print(f"[INFO] torch.profiler trace captured to {result['trace']} "
                  f"(on the server host; {result['device_events']} device records)")
            return 0
        if not args.dir:
            print("[ERROR] profile capture needs --url or --dir", file=sys.stderr)
            return 1
        import torch  # noqa: F401 — the capture is of this process's torch

        result = devprof.capture_trace(args.dir, args.seconds)
        print(f"[INFO] torch.profiler trace captured to {result['trace']} "
              f"({result['device_events']} device records)")
        return 0
    rep = _server_call(url, "/debug/profile") if url else devprof.report()
    plat = rep.get("platform", {})
    if action == "list":
        peak = plat.get("peak_flops")
        peak_s = f"{peak / 1e12:g} TFLOP/s" if peak else "unknown"
        print(f"[INFO] platform={plat.get('platform')} kind={plat.get('device_kind')} "
              f"peak={peak_s} (source: {plat.get('peak_source')})")
        rows = rep.get("executables", [])
        if not rows:
            print("[INFO] no profiled executables yet")
            return 0
        print(f"[INFO] {'executable':<28} {'calls':>7} {'dev_sec':>9} "
              f"{'compile_s':>9} {'GFLOP':>10} {'dtype':>6} {'mfu':>9} {'hbm%':>7}")
        for r in rows:
            u, h = r.get("mfu"), r.get("hbm_fraction_of_roof")
            print(f"[INFO] {r['name']:<28} {r['invocations']:>7} "
                  f"{r['device_seconds']:>9.3f} {r['compile_seconds']:>9.2f} "
                  f"{r['flops_total'] / 1e9:>10.2f} {r.get('dtype', 'bf16'):>6} "
                  f"{(f'{u:.5f}' if u is not None else '-'):>9} "
                  f"{(f'{100 * h:.1f}' if h is not None else '-'):>7}")
        pad = rep.get("padding", {})
        if pad.get("batches"):
            print(f"[INFO] padding: {pad['batches']} batches, mean ratio "
                  f"{pad['mean_padding_ratio']:.3f}, wasted "
                  f"{pad['wasted_flops'] / 1e9:.2f} GFLOP")
        return 0
    row = next((r for r in rep.get("executables", []) if r["name"] == args.name), None)
    if row is None:
        print(f"[ERROR] no profiled executable {args.name!r}", file=sys.stderr)
        return 1
    print(f"[INFO] {row['name']}:")
    for k, v in row.items():
        if k != "name":
            print(f"[INFO]   {k}: {v}")
    return 0


def _run(args: argparse.Namespace) -> int:
    commands = {"app": app_cmd, "channel": channel_cmd, "accesskey": accesskey_cmd,
                "eventserver": eventserver, "status": status, "online": online,
                "jobs": jobs_cmd, "models": models_cmd, "metrics": metrics_cmd,
                "trace": trace_cmd, "profile": profile_cmd}
    if args.cmd in commands:
        return commands[args.cmd](args)
    if args.cmd in ("import", "export") and args.format == "parquet":
        return _not_ported(f"{args.cmd} --format parquet")
    if args.cmd == "import":
        n = import_events(args)
        print(f"[INFO] Imported {n} events into {args.app}", flush=True)
        return 0
    if args.cmd == "export":
        n = export_events(args)
        print(f"[INFO] Exported {n} events to {args.output}", flush=True)
        return 0
    if args.cmd == "tune" or (args.cmd == "eval" and args.eval_cmd != "run"):
        what = "tune" if args.cmd == "tune" else f"eval {args.eval_cmd}"
        return _not_ported(f"{what} (the fleet evaluation)")
    if args.cmd == "eval":
        return eval_run(args)
    if args.cmd == "train" and args.engine_json is not None:
        from predictionio_tpu_torch.workflow.core import (
            load_variant, run_train, stage_timings)

        inst = run_train(
            Storage(), load_variant(str(args.engine_json)),
            engine_version=args.engine_version, device=args.device,
        )
        print(f"[INFO] Training {inst.status.lower()}: instance {inst.id}; "
              f"stage timings (s): {stage_timings(inst)}", flush=True)
        return 0 if inst.status in ("COMPLETED", "INTERRUPTED") else 1
    if args.cmd == "train":
        if args.out is None:
            raise SystemExit("[ERROR] train --ratings needs --out")
        model = train(args)
        print(f"trained {model.factors.user_factors.shape[0]} users x "
              f"{model.factors.item_factors.shape[0]} items, rank "
              f"{model.factors.params.rank}, on {model.device}; wrote {args.out}",
              flush=True)
        return 0
    server = build_server(args)
    try:
        port = server.start()
        what = args.engine_json or args.model
        # a host model (ridge regression) has no device
        device = getattr(server.model, "device", None)
        print(f"serving {what} on {args.ip}:{port} ({device or 'host model'})",
              flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
