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
        [--port 7070] [--stats] [--log-url URL]
    python -m predictionio_tpu_torch.tools.console storageserver \\
        [--ip 127.0.0.1] [--port 7077] [--auth-key KEY]
    python -m predictionio_tpu_torch.tools.console import --app NAME \\
        [--channel C] --input events.jsonl|events.parquet [--format json|parquet]
    python -m predictionio_tpu_torch.tools.console export --app NAME \\
        [--channel C] --output F [--format json|parquet]
    python -m predictionio_tpu_torch.tools.console status \\
        [--event-url http://localhost:7070 --access-key KEY]
    python -m predictionio_tpu_torch.tools.console train --engine-json F \\
        [--engine-version V] [--device cpu]
    python -m predictionio_tpu_torch.tools.console deploy --engine-json F \\
        [--engine-version V] [--ip ADDR] [--port N] [--device cpu] \\
        [--feedback --event-server-url URL --access-key KEY] [--log-url URL]
    python -m predictionio_tpu_torch.tools.console template list
    python -m predictionio_tpu_torch.tools.console template get NAME DIR \\
        [--package PKG]

    python -m predictionio_tpu_torch.tools.console eval run EVALUATION \\
        [GENERATOR] [--device cpu]
    python -m predictionio_tpu_torch.tools.console eval run SPEC.json \\
        [--local-workers N] [--no-wait] [--timeout S] [--tenant T] [--device cpu]
    python -m predictionio_tpu_torch.tools.console eval list \\
        [--engine E] [--status S] [--tenant T]
    python -m predictionio_tpu_torch.tools.console eval show|status RUN
    python -m predictionio_tpu_torch.tools.console eval gc [--keep N] [--now]
    python -m predictionio_tpu_torch.tools.console tune SPEC.json \\
        [--local-workers N] [--timeout S] [--tenant T] [--device cpu]
    python -m predictionio_tpu_torch.tools.console fleet status
    python -m predictionio_tpu_torch.tools.console fleet worker \\
        [--log-dir D] [--max-concurrent N] [--device cpu]
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
    python -m predictionio_tpu_torch.tools.console tenants list
    python -m predictionio_tpu_torch.tools.console tenants show|delete TENANT
    python -m predictionio_tpu_torch.tools.console tenants new TENANT \
        --engine E [--engine-version V] [--variant V] [--weight W] [--qps Q] \
        [--max-concurrency N] [--device-seconds S] [--description D]
    python -m predictionio_tpu_torch.tools.console tenants set-quota TENANT \
        [--weight W] [--qps Q] [--max-concurrency N] [--device-seconds S]
    python -m predictionio_tpu_torch.tools.console metrics [--url URL] \
        [--summary]
    python -m predictionio_tpu_torch.tools.console trace list|show|export \
        [TRACE] [--url http://localhost:8000] [--fleet] [--limit N] [--output F]
    python -m predictionio_tpu_torch.tools.console profile list|show|capture \
        [NAME] [--url http://localhost:8000] [--dir D] [--seconds S]
    python -m predictionio_tpu_torch.tools.console rollout start \
        [--url http://localhost:8000] [--version V] [--fraction F] \
        [--bake-s S] [--min-requests N] [--shadow]
    python -m predictionio_tpu_torch.tools.console rollout status|abort \
        [--url http://localhost:8000] [--reason R]
    python -m predictionio_tpu_torch.tools.console faults list|clear [POINT] \
        [--url URL]
    python -m predictionio_tpu_torch.tools.console faults set SPEC \
        [--seed N] [--url URL]
    python -m predictionio_tpu_torch.tools.console adminserver [--ip ADDR] \
        [--port 7071]
    python -m predictionio_tpu_torch.tools.console dashboard [--ip ADDR] \
        [--port 9000] [--monitor-targets name=url[,name=url]]
    python -m predictionio_tpu_torch.tools.console monitor [--targets T] \
        [--interval S] [--duration S] [--slos JSON|@FILE] [--expr EXPR]
    python -m predictionio_tpu_torch.tools.console alerts list|show [NAME] \
        [--url URL]
    python -m predictionio_tpu_torch.tools.console tsdb query [EXPR] \
        [--name N] [--labels k:v,...] [--window S] \
        [--agg rate|increase|quantile] [--q Q] [--last N] [--url URL]

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
kernel modules nor touches CUDA. ``storageserver`` (also
``storage-server``, the JAX name) serves the storage daemon
(``data/api/storage_server.py``) over the configured storage until
interrupted: any other process, every verb here included, then reaches
it through a ``remote`` source (``PIO_STORAGE_SOURCES_<NAME>_TYPE=remote``
with ``_HOST``, ``_PORT`` and ``_AUTH_KEY``). ``import`` writes events from JSON
lines (one event object a line, as ``pio import`` reads them) and
``export`` writes them so; with ``--format parquet`` both use the
parquetfs store's schema (``data/storage/parquetfs.py``), and ``import``
reads an ``--input`` ending in ``.parquet`` as parquet unless ``--format
json`` says otherwise (a row that does not decode or validate is a
warning naming its row, and the import then exits 1). ``eventserver
--log-url`` and ``deploy --log-url`` ship the server's log records,
access log included, to a collector as JSON lines
(``utils/logship.py``). ``status`` lists the engine manifests that
completed trains registered. ``template list`` prints the template
gallery and ``template get NAME DIR`` scaffolds one of the port's engine
families into DIR as a package of its own (``tools/template.py``); a
family the port lacks is listed and refused. ``train --engine-json`` trains the engine
variant into an engine instance and its MODELDATA blob, and ``deploy
--engine-json`` serves the variant's newest completed instance until
interrupted. ``eval run`` evaluates an ``Evaluation`` named by its
import path (``module.Class``) over the grid of an
``EngineParamsGenerator`` (or the evaluation's own
``engine_params_list``) and stores an evaluation instance; it exits 0
only when that instance is EVALCOMPLETED. ``eval run SPEC.json`` runs
an EvalSpec (the JAX package's JSON: a variant, axes, metrics, folds)
as the fleet evaluation: one ``eval`` job a (grid group x fold) on the
job queue, which any worker claims (``--local-workers N`` starts N
fleet members in this process, each a child at a time on ``--device``),
then waits for the run and prints its points; ``eval list|show|status|gc``
read and prune the eval runs. ``tune SPEC.json`` runs the space the same
way and parks the winner as the engine's retrain preset, which the next
periodic retrain of the engine trains. ``fleet status`` prints the
workers and the queue; ``fleet worker`` runs one fleet member until
interrupted. ``online status|pause|resume``
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
or, with ``--dir``, opens one in this process. ``rollout start|status|abort``
drive a canary on a running query server (``--url``): start one of a
registered version (the newest ``trained`` one by default), print its
state and verdict windows, or abort it. ``faults list|set|clear`` read
and change the fault-injection specs of this process, or of a running
server with ``--url`` (its ``POST /debug/faults`` needs
``PIO_FAULTS_ADMIN=1`` on the server). ``adminserver`` serves the admin
REST API (``tools/admin.py``) and ``dashboard`` the evaluation dashboard
with the fleet monitor's panels (``tools/dashboard.py``; it scrapes
``--monitor-targets`` or ``PIO_MONITOR_TARGETS`` and, unless
``PIO_TRACE_COLLECT=0``, collects their traces), each until interrupted.
``monitor`` scrapes the targets into this process's TSDB every
``--interval``, runs the trace collector and the SLO engine over it and
prints the fleet, each ``--expr`` and each SLO a pass. ``alerts
list|show`` print the SLO alert states of a server (``--url``: its ``GET
/alerts``) or of this process; ``tsdb query`` prints a server's or this
process's time-series history (the series, one series' points or an
aggregate, or an expression's rows; with a durable tier, each tier's
blocks, series, bytes and span); ``trace ... --fleet`` reads the
assembled cross-process traces of a process that runs a collector.
``deploy --feedback`` posts each
answer to the Event Server at ``--event-server-url`` with
``--access-key`` as a ``predict`` event. Not ported, and refused with
exit code 1: the multi-host flags of ``fleet worker`` and the template
families the port lacks. An operator error (an
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
    es.add_argument("--log-url", default=None,
                    help="ship the server's log records to this collector URL")
    ss = sub.add_parser("storageserver", aliases=["storage-server"],
                        help="serve the shared storage daemon")
    ss.add_argument("--ip", default="127.0.0.1")
    ss.add_argument("--port", type=int, default=7077)
    ss.add_argument("--auth-key", default=None)
    st = sub.add_parser("status", help="the storage and the device")
    st.add_argument("--event-url",
                    help="also read a running Event Server's GET /segments/stats")
    st.add_argument("--access-key",
                    help="the access key for --event-url (its app and channel)")
    for name, what, io, fmt in (
            ("import", "write an app's events from JSON lines or parquet", "--input",
             "input codec (default: parquet for a .parquet file, else json)"),
            ("export", "write an app's events as JSON lines or parquet", "--output",
             "output codec")):
        s = sub.add_parser(name, help=what)
        s.add_argument("--app", required=True)
        s.add_argument("--channel")
        s.add_argument(io, required=True, type=Path)
        s.add_argument("--format", choices=("json", "parquet"),
                       default=None if name == "import" else "json", help=fmt)
    tp = sub.add_parser("template", help="scaffold engines from the gallery"
                        ).add_subparsers(dest="template_cmd", required=True)
    tp.add_parser("list", help="list the gallery's templates")
    s = tp.add_parser("get", help="copy a template into a directory")
    s.add_argument("name", help="template name (see `template list`)")
    s.add_argument("directory", help="destination directory")
    s.add_argument("--package", default=None,
                   help="package name of the scaffolded engine (default my_<name>)")

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
    dep.add_argument("--feedback", action="store_true",
                     help="post each answer to the Event Server as a predict event")
    dep.add_argument("--event-server-url", help="with --feedback: the Event Server")
    dep.add_argument("--access-key", help="with --feedback: the app's access key")
    dep.add_argument("--log-url", default=None,
                     help="ship the server's log records to this collector URL")

    ev = sub.add_parser("eval", help="run and inspect evaluations").add_subparsers(
        dest="eval_cmd", required=True)
    run = ev.add_parser("run", help="run an EvalSpec JSON on the fleet, or evaluate "
                        "an Evaluation over a params grid in this process")
    run.add_argument("target", help="EvalSpec JSON path, or import path of the "
                     "Evaluation")
    run.add_argument("params_generator", nargs="?",
                     help="import path of an EngineParamsGenerator")
    run.add_argument("--device", default=None,
                     help="torch device (default: the first CUDA device)")
    _fleet_run_args(run)
    run.add_argument("--no-wait", action="store_true",
                     help="queue the shards and return at once")
    s = ev.add_parser("list", help="list eval runs")
    s.add_argument("--engine", default=None)
    s.add_argument("--status", default=None, choices=("running", "completed", "failed"))
    s.add_argument("--tenant", default=None)
    ev.add_parser("show", help="one run's record and point scores").add_argument("run_id")
    ev.add_parser("status", help="a run's shard jobs and partial folds").add_argument(
        "run_id")
    s = ev.add_parser("gc", help="purge old terminal eval runs")
    s.add_argument("--keep", type=int, default=None,
                   help="terminal runs to keep (default PIO_EVAL_RETENTION)")
    s.add_argument("--now", action="store_true",
                   help="compact without the quiescence age gate")
    tu = sub.add_parser("tune", help="evaluate a param space on the fleet and park "
                        "the winner as the engine's retrain preset")
    tu.add_argument("spec", help="EvalSpec JSON path")
    tu.add_argument("--device", default=None,
                    help="the local workers' torch device (default: the first CUDA "
                         "device)")
    _fleet_run_args(tu)

    fl = sub.add_parser("fleet", help="the training worker fleet").add_subparsers(
        dest="fleet_action", required=True)
    fl.add_parser("status", help="workers and the queue, as JSON")
    s = fl.add_parser("worker", help="run one fleet member until interrupted")
    s.add_argument("--log-dir", default=None, help="per-job log directory")
    s.add_argument("--max-concurrent", type=int, default=None,
                   help="jobs supervised at once")
    s.add_argument("--device", default=None,
                   help="the jobs' torch device (default: the first CUDA device)")

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

    tn = sub.add_parser("tenants", help="multi-tenant serving control plane"
                        ).add_subparsers(dest="tenants_action", required=True)
    tn.add_parser("list", help="list tenants")
    tn.add_parser("show", help="one tenant's full record").add_argument("tenant_id")
    s = tn.add_parser("new", help="create or update a tenant")
    s.add_argument("tenant_id")
    s.add_argument("--engine", required=True, help="engine id to serve")
    s.add_argument("--engine-version", dest="engine_version", default="0")
    s.add_argument("--variant", default=None,
                   help="engine variant (default: the engine id)")
    s.add_argument("--weight", type=float, default=1.0,
                   help="fair-share weight in the batch scheduler")
    s.add_argument("--qps", type=float, default=None)
    s.add_argument("--max-concurrency", dest="max_concurrency", type=int, default=None)
    s.add_argument("--device-seconds", dest="device_seconds", type=float, default=None,
                   help="device-seconds budget per second")
    s.add_argument("--description", default=None)
    s = tn.add_parser("set-quota", help="update fair share / quotas")
    s.add_argument("tenant_id")
    s.add_argument("--weight", type=float, default=None)
    s.add_argument("--qps", type=float, default=None)
    s.add_argument("--max-concurrency", dest="max_concurrency", type=int, default=None)
    s.add_argument("--device-seconds", dest="device_seconds", type=float, default=None)
    tn.add_parser("delete", help="delete a tenant record").add_argument("tenant_id")

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
    s.add_argument("--fleet", action="store_true", help="assembled cross-process "
                   "traces (the fleet collector on a dashboard/monitor)")
    s = tr.add_parser("show", help="print one trace's span tree")
    s.add_argument("trace_id")
    s.add_argument("--url", help="server base URL")
    s.add_argument("--fleet", action="store_true",
                   help="look the trace up in the fleet collector")
    s = tr.add_parser("export", help="write Chrome trace-event JSON "
                      "(open at ui.perfetto.dev)")
    s.add_argument("trace_id", nargs="?", default=None,
                   help="one trace (default: all retained)")
    s.add_argument("--url", help="server base URL")
    s.add_argument("--fleet", action="store_true", help="export assembled fleet traces")
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

    ro = sub.add_parser("rollout", help="canary rollout on a running query "
                        "server").add_subparsers(dest="rollout_action", required=True)
    s = ro.add_parser("start", help="start a canary")
    s.add_argument("--url", default="http://localhost:8000",
                   help="query server base URL")
    s.add_argument("--version", default=None,
                   help="model version id (default: newest trained)")
    s.add_argument("--fraction", type=float, default=None,
                   help="candidate traffic share (0..1]")
    s.add_argument("--bake-s", dest="bake_s", type=float, default=None,
                   help="healthy seconds before auto-promote")
    s.add_argument("--min-requests", dest="min_requests", type=int, default=None,
                   help="candidate samples before judging")
    s.add_argument("--shadow", action="store_true",
                   help="mirror traffic instead of splitting it")
    ro.add_parser("status", help="rollout status").add_argument(
        "--url", default="http://localhost:8000")
    s = ro.add_parser("abort", help="abort the active canary")
    s.add_argument("--url", default="http://localhost:8000")
    s.add_argument("--reason", default=None)

    fa = sub.add_parser("faults", help="fault-injection registry: list/set/clear "
                        "named fault points (local, or a running server via "
                        "--url, which needs PIO_FAULTS_ADMIN=1)").add_subparsers(
        dest="faults_action", required=True)
    fa.add_parser("list", help="show active fault specs").add_argument(
        "--url", help="server base URL, e.g. http://127.0.0.1:8000")
    s = fa.add_parser("set", help="install fault specs: point:mode:prob[:param][,...]")
    s.add_argument("spec", help="e.g. event.insert:error:0.2 or "
                                "dispatch.device:delay:1.0:0.05")
    s.add_argument("--seed", type=int, default=None,
                   help="deterministic RNG seed for the fault points")
    s.add_argument("--url", help="server base URL")
    s = fa.add_parser("clear", help="clear one fault point, or all")
    s.add_argument("point", nargs="?", default=None,
                   help="fault point to clear (default: all)")
    s.add_argument("--url", help="server base URL")

    s = sub.add_parser("adminserver", help="run the admin REST API")
    s.add_argument("--ip", default="0.0.0.0")
    s.add_argument("--port", type=int, default=7071)
    s = sub.add_parser("dashboard", help="run the evaluation dashboard (+ fleet "
                       "monitor panels when scrape targets are configured)")
    s.add_argument("--monitor-targets", dest="monitor_targets", default=None,
                   help="fleet scrape targets instance=url[,...] "
                        "(default: PIO_MONITOR_TARGETS)")
    s.add_argument("--ip", default="0.0.0.0")
    s.add_argument("--port", type=int, default=9000)

    s = sub.add_parser("monitor", help="standalone fleet monitor: scrape /metrics "
                       "from a target list into the TSDB and run SLO burn-rate "
                       "alerting")
    s.add_argument("--targets", default=None,
                   help="instance=url[,instance=url] (default: PIO_MONITOR_TARGETS)")
    s.add_argument("--interval", type=float, default=10.0,
                   help="scrape/evaluate period in seconds")
    s.add_argument("--duration", type=float, default=None,
                   help="stop after this many seconds (default: forever)")
    s.add_argument("--slos", default=None,
                   help="SLO specs: JSON array or @/path.json (default: PIO_SLOS)")
    s.add_argument("--expr", action="append", default=None, metavar="EXPR",
                   help="series-algebra expression to evaluate and print each "
                        "pass (repeatable)")

    al = sub.add_parser("alerts", help="SLO alert states (local engine, or a "
                        "server via --url)").add_subparsers(
        dest="alerts_action", required=True)
    al.add_parser("list", help="list SLOs with their alert state").add_argument(
        "--url", help="server base URL, e.g. http://127.0.0.1:8000")
    s = al.add_parser("show", help="one SLO's full status")
    s.add_argument("name")
    s.add_argument("--url", help="server base URL")

    ts = sub.add_parser("tsdb", help="query the in-process time-series history "
                        "(local, or a server via --url)").add_subparsers(
        dest="tsdb_action", required=True)
    s = ts.add_parser("query", help="list series, or one series' points/aggregates, "
                      "or evaluate a series-algebra expression")
    s.add_argument("expr", nargs="?", default=None,
                   help="expression to evaluate, e.g. "
                        "'sum by (instance) (rate(errors_total[5m]))' "
                        "(omit for the series listing / --name forms)")
    s.add_argument("--name", default=None, help="series name (omit to list all)")
    s.add_argument("--labels", default=None, help="label filter, k:v[,k:v...]")
    s.add_argument("--window", type=float, default=None,
                   help="window seconds (default: full ring)")
    s.add_argument("--agg", choices=("rate", "increase", "quantile"), default=None)
    s.add_argument("--q", type=float, default=None,
                   help="quantile for --agg quantile (default 0.99)")
    s.add_argument("--last", type=int, default=20, help="points to print per series")
    s.add_argument("--url", help="server base URL")
    return ap


def _fleet_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tenant", default=None, help="tenant scope recorded on the run")
    p.add_argument("--local-workers", type=int, default=0,
                   help="start N fleet members in this process for the run")
    p.add_argument("--timeout", type=float, default=None,
                   help="longest wait, in seconds, for the run to converge")


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


def _serve_until_interrupt(server, banner: str) -> int:
    """Start a server, print the banner with its bound port, and serve
    until interrupted."""
    port = server.start()
    print(banner.format(port=port), flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def eventserver(args: argparse.Namespace) -> int:
    """Serve the Event Server until interrupted; the banner names the
    bound port (with --port 0, a free one)."""
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig

    return _serve_until_interrupt(
        EventServer(Storage(), EventServerConfig(ip=args.ip, port=args.port,
                                                 stats=args.stats, log_url=args.log_url)),
        f"[INFO] Event Server is listening at http://{args.ip}:{{port}}.")


def storageserver(args: argparse.Namespace) -> int:
    """Serve the storage daemon over this process's configured storage
    until interrupted; the banner names the bound port (with --port 0,
    a free one). The process loads no torch."""
    from predictionio_tpu_torch.data.api.storage_server import StorageServer

    server = StorageServer(Storage(), host=args.ip, port=args.port,
                           auth_key=args.auth_key).start()
    print(f"[INFO] Storage server is listening at http://{args.ip}:{server.port}.",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


def status(args: argparse.Namespace) -> int:
    """The storage each repository resolves to, its self-check
    (`Storage.verify_all_data_objects`: every DAO, each shard of a
    sharded event store, a probe event; a down shard fails the command),
    the device the trains and deploys take; over segmentfs each app's
    segment line, and with `--event-url` a running Event Server's."""
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
    print("[INFO] Verifying storage backend connections...")
    try:
        for line in storage.verify_all_data_objects():
            print(f"[INFO]   {line}")
    except Exception as e:  # noqa: BLE001 — reported, as the JAX console does
        return _fail(f"storage verification failed: {e}")
    events = storage.get_events()
    if hasattr(events, "segment_stats"):
        # segmentfs: each app's sealed segments, tail depth and dead rows
        try:
            for app in storage.get_meta_data_apps().get_all():
                st = events.segment_stats(app.id)
                print(f"[INFO]   segmentfs app {app.id} ({app.name}): "
                      f"{st['segments']} segment(s), "
                      f"{st['sealed_rows']} sealed + {st['tail_rows']} tail "
                      f"row(s), {st['dead_rows']} dead, "
                      f"rev {st['max_revision']}")
        except Exception as e:  # noqa: BLE001 — a warning, as the JAX console's
            print(f"[WARN] segmentfs stats unavailable: {e}")
    if getattr(args, "event_url", None):
        # a running Event Server's segment surface
        import json
        import urllib.parse
        import urllib.request

        try:
            url = (args.event_url.rstrip("/") + "/segments/stats?accessKey="
                   + urllib.parse.quote(args.access_key or ""))
            with urllib.request.urlopen(url, timeout=5) as resp:
                st = json.loads(resp.read().decode())
            print(f"[INFO] event server {args.event_url}: "
                  f"{st.get('segments')} segment(s), "
                  f"{st.get('sealed_rows')} sealed + "
                  f"{st.get('tail_rows')} tail row(s), "
                  f"{st.get('dead_rows')} dead, "
                  f"rev {st.get('max_revision')}")
        except Exception as e:  # noqa: BLE001 — a warning, as the JAX console's
            print(f"[WARN] event-server segment stats unavailable: {e}")
    try:
        manifests = storage.get_meta_data_engine_manifests().get_all()
    except Exception as e:  # noqa: BLE001 — a warning, as the JAX console's
        manifests = []
        print(f"[WARN] could not list engine manifests: {e}")
    if manifests:
        print("[INFO] Registered engines (trained at least once):")
        for m in manifests:
            print(f"[INFO]   {m.id} v{m.version}: {m.engine_factory}"
                  + (f" — {m.description}" if m.description else ""))
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


def _is_parquet(args: argparse.Namespace) -> bool:
    """`import`'s codec: `--format`, else the input's .parquet suffix."""
    return args.format == "parquet" or (
        args.format is None and str(args.input).endswith(".parquet"))


def _read_parquet_events(path: Path) -> tuple[list[Event], int]:
    """The parquet file's events (the parquetfs schema, as `export
    --format parquet` writes it) and the count of rows skipped: a row
    that does not decode or validate is a warning naming its row (0-based,
    physical), as in the JAX console."""
    import pyarrow.parquet as pq

    from predictionio_tpu_torch.data.event import EventValidation
    from predictionio_tpu_torch.data.storage.parquetfs import table_to_events

    errors = 0

    def bad_row(i, exc):
        nonlocal errors
        errors += 1
        print(f"[WARN] row {i}: {exc}", file=sys.stderr)

    try:
        table = pq.read_table(path)
    except Exception as exc:  # noqa: BLE001 — any unreadable file, as the JAX console
        raise CommandError(f"{path} is not a readable parquet file: {exc}") from None
    events = []
    for i, e in table_to_events(table, on_error=bad_row, with_index=True):
        try:
            EventValidation.validate(e)
            events.append(e)
        except Exception as exc:  # noqa: BLE001 — a skipped row, as the JAX console
            bad_row(i, exc)
    return events, errors


def import_events(args: argparse.Namespace) -> tuple[int, int]:
    """Write the input's events through the store's bulk write into the
    app's default channel or `--channel`; returns (written, skipped).
    JSON lines: a malformed line is an error naming its line, and nothing
    after it is written. Parquet: `_read_parquet_events`."""
    storage = Storage()
    app = _get_app(storage, args.app)
    channel_id = _channel_id(storage, app, args.channel)
    if _is_parquet(args):
        events, errors = _read_parquet_events(args.input)
        return storage.get_events().write(events, app.id, channel_id), errors
    return storage.get_events().write(_read_events(args.input), app.id, channel_id), 0


# events a parquet row group of `export --format parquet`
PARQUET_EXPORT_BATCH = 50_000


def export_events(args: argparse.Namespace) -> int:
    """The channel's events in (event time, id) order, as JSON lines or,
    with `--format parquet`, through one parquet writer in batches of
    PARQUET_EXPORT_BATCH (reference EventsToFile.scala:42)."""
    storage = Storage()
    app = _get_app(storage, args.app)
    events = storage.get_events().find(
        EventQuery(app_id=app.id, channel_id=_channel_id(storage, app, args.channel)))
    n = 0
    if args.format == "parquet":
        import pyarrow.parquet as pq

        from predictionio_tpu_torch.data.storage.parquetfs import (
            _SCHEMA, events_to_table)

        writer = pq.ParquetWriter(args.output, _SCHEMA)
        batch: list = []
        try:
            for e in events:
                batch.append(e)
                n += 1
                if len(batch) >= PARQUET_EXPORT_BATCH:
                    writer.write_table(events_to_table(batch))
                    batch.clear()
            if batch:
                writer.write_table(events_to_table(batch))
        finally:
            writer.close()
        return n
    with open(args.output, "w") as f:
        for e in events:
            f.write(e.to_json() + "\n")
            n += 1
    return n


def template_cmd(args: argparse.Namespace) -> int:
    """`template list|get`: the gallery, or a scaffold of one of its
    templates; a family the port lacks is refused as not ported."""
    from predictionio_tpu_torch.tools.template import (
        NotPortedTemplate, list_templates, scaffold)

    if args.template_cmd == "list":
        for t in list_templates():
            print(f"{t.name:16s} {t.description}"
                  + ("" if t.ported else " (not ported yet)"))
        return 0
    try:
        dest = scaffold(args.name, args.directory, args.package)
    except NotPortedTemplate:
        return _not_ported(f"template {args.name!r}")
    except (ValueError, FileExistsError) as e:
        return _fail(str(e))
    print(f"[INFO] Engine template '{args.name}' scaffolded at {dest}.")
    print("[INFO] Next: edit engine.json, then `train` from that directory.")
    return 0


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
    config = QueryServerConfig(
        ip=args.ip, port=args.port, feedback=args.feedback,
        event_server_url=args.event_server_url, access_key=args.access_key,
        log_url=args.log_url,
    )
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
        return fleet_eval_run(args)
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


def _fail(message: str) -> int:
    print(f"[ERROR] {message}", file=sys.stderr)
    return 1


def _local_fleet(storage: Storage, n: int, device: Optional[str]) -> list:
    """Start n fleet members in this process, so that `eval run` and
    `tune` work without a standing fleet (each member supervises real
    shard subprocesses on `device`)."""
    from predictionio_tpu_torch.deploy.scheduler import SchedulerConfig
    from predictionio_tpu_torch.fleet.coordinator import FleetMember

    members = [FleetMember(storage, SchedulerConfig(device=device))
               for _ in range(max(0, n))]
    for m in members:
        m.start()
    return members


def _print_eval_run(run: dict, points: list) -> None:
    """A run's record and its points, as the JAX console prints them."""
    import json

    print(f"run        {run['id']}")
    print(f"engine     {run.get('engine_id')}"
          + (f"  tenant {run['tenant']}" if run.get("tenant") else ""))
    print(f"status     {run.get('status')}")
    print(f"metric     {run.get('metric_header')}"
          f" ({'higher' if run.get('higher_is_better', True) else 'lower'} is better)")
    if run.get("winner_index") is not None:
        print(f"winner     point {run['winner_index']}  score {run.get('winner_score')}")
    if run.get("winner_model_version"):
        print(f"lineage    model version {run['winner_model_version']}")
    if points:
        print(f"{'POINT':>5s}  {'DONE':4s}  {'SCORE':>12s}  PARAMS")
        for pt in points:
            score = "-" if pt["score"] is None else f"{pt['score']:.6g}"
            mark = "yes" if pt["complete"] else f"{len(pt['folds_done'])}f"
            print(f"{pt['point_index']:>5d}  {mark:4s}  {score:>12s}  "
                  f"{json.dumps(pt.get('params') or {})[:80]}")


def fleet_eval_run(args: argparse.Namespace) -> int:
    """`eval run SPEC.json`: queue the spec's shard jobs, wait for the
    run (unless --no-wait) and print its points; 0 only when it
    completed."""
    from predictionio_tpu_torch.evalfleet.driver import EvalDriver
    from predictionio_tpu_torch.evalfleet.specs import EvalSpec

    try:
        spec = EvalSpec.load(args.target)
    except (OSError, ValueError, KeyError) as e:
        return _fail(f"bad eval spec: {e}")
    storage = Storage()
    driver = EvalDriver(storage)
    members = _local_fleet(storage, args.local_workers, args.device)
    try:
        run = driver.submit(spec, tenant=args.tenant)
        print(f"[INFO] Eval run {run.id}: {run.num_points} points, "
              f"{len(run.shards)} shard jobs queued.", flush=True)
        if args.no_wait:
            return 0
        run = driver.wait(run.id, timeout_s=args.timeout)
    finally:
        for m in members:
            m.stop()
    status = driver.status(run.id)
    _print_eval_run(status["run"], status["points"])
    return 0 if run.status == "completed" else 1


def eval_records(args: argparse.Namespace) -> int:
    """`eval list|show|status|gc` over the eval-run records."""
    from predictionio_tpu_torch.evalfleet.driver import EvalDriver
    from predictionio_tpu_torch.evalfleet.records import EvalRecordStore
    from predictionio_tpu_torch.utils.env import eval_knob

    storage = Storage()
    store = EvalRecordStore(storage)
    action = args.eval_cmd
    if action == "list":
        runs = store.list_runs(engine_id=args.engine, status=args.status,
                               tenant=args.tenant)
        print(f"{'RUN':24s} {'ENGINE':12s} {'STATUS':10s} {'POINTS':>6s} "
              f"{'METRIC':14s} {'WINNER':>8s}")
        for r in runs:
            winner = "-" if r.winner_score is None else f"{r.winner_score:.4g}"
            print(f"{r.id:24s} {r.engine_id:12s} {r.status:10s} "
                  f"{r.num_points:>6d} {r.metric_header:14s} {winner:>8s}")
        return 0
    if action in ("show", "status"):
        try:
            status = EvalDriver(storage).status(args.run_id)
        except KeyError as e:
            return _fail(str(e.args[0]))
        _print_eval_run(status["run"], status["points"])
        if action == "status":
            print(f"progress   {status['points_done']}/{status['points_total']} points")
            for sh in status["shards"]:
                fold = "all" if sh["fold"] is None else sh["fold"]
                print(f"  shard {sh['job_id']}  group {sh['group']} fold {fold}  "
                      f"{sh['status']}"
                      + (f"  worker {sh['worker_id']}" if sh.get("worker_id") else ""))
        return 0
    removed = store.gc(keep=args.keep if args.keep is not None
                       else eval_knob("PIO_EVAL_RETENTION"))
    removed += store.compact(min_age_s=0.0 if args.now else 60.0)
    print(f"[INFO] Eval GC: {removed} events removed.")
    return 0


def tune_cmd(args: argparse.Namespace) -> int:
    """`tune SPEC.json`: run the space on the fleet, wait, and park the
    winner as the engine's retrain preset."""
    from predictionio_tpu_torch.evalfleet.specs import EvalSpec
    from predictionio_tpu_torch.evalfleet.tuning import tune

    try:
        spec = EvalSpec.load(args.spec)
    except (OSError, ValueError, KeyError) as e:
        return _fail(f"bad eval spec: {e}")
    storage = Storage()
    members = _local_fleet(storage, args.local_workers, args.device)
    try:
        run, preset = tune(storage, spec, tenant=args.tenant, timeout_s=args.timeout)
    finally:
        for m in members:
            m.stop()
    if preset is None:
        return _fail(f"tune: run {run.id} ended {run.status} without a winner")
    scope = f"tenant {preset.tenant}" if preset.tenant else "global"
    print(f"[INFO] Eval run {run.id} completed: winner point "
          f"{run.winner_index} ({run.metric_header}={run.winner_score}).")
    print(f"[INFO] Winner parked as {scope} retrain preset for engine "
          f"{preset.engine_id} — the next periodic retrain trains it.", flush=True)
    return 0


def fleet_cmd(args: argparse.Namespace) -> int:
    """`fleet status`: the workers and the queue as JSON; `fleet
    worker`: one fleet member (a CAS-claiming scheduler with a
    heartbeating worker record) until interrupted."""
    import json
    import time

    from predictionio_tpu_torch.deploy.scheduler import SchedulerConfig
    from predictionio_tpu_torch.fleet import FleetMember, fleet_status

    storage = Storage()
    if args.fleet_action == "status":
        print(json.dumps(fleet_status(storage), indent=2))
        return 0
    config = SchedulerConfig(device=args.device)
    if args.log_dir:
        config.log_dir = args.log_dir
    if args.max_concurrent:
        config.max_concurrent = args.max_concurrent
    try:
        member = FleetMember(storage, scheduler_config=config)
    except NotImplementedError as e:
        return _fail(str(e))
    member.start()
    print(f"[INFO] fleet worker {member.worker_id} running (Ctrl-C to stop)",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("[INFO] stopping fleet worker (in-flight jobs finish)")
        member.stop()
        return 0


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


def rollout_cmd(args: argparse.Namespace) -> int:
    """`rollout start|status|abort`: a canary on a running query server
    (--url)."""
    def show(st: dict) -> None:
        print(f"[INFO] rollout state: {st.get('state')}")
        if st.get("state") == "none":
            return
        v, cfg = st.get("version") or {}, st.get("config") or {}
        print(f"[INFO]   version: {v.get('id')} "
              f"({v.get('engine_id')}/{v.get('engine_variant')})")
        print(f"[INFO]   traffic: {cfg.get('fraction', 0) * 100:.0f}%"
              + (" shadow" if cfg.get("shadow") else ""))
        if st.get("reason"):
            print(f"[INFO]   verdict: {st.get('last_action')} — {st['reason']}")
        for variant in ("live", "candidate"):
            w = st.get(variant) or {}
            agreement = (f" agreement={w['agreement']:.3f}"
                         if "agreement" in w else "")
            print(f"[INFO]   {variant}: n={w.get('count', 0)} "
                  f"err={w.get('error_rate', 0):.3f} "
                  f"p99={w.get('p99_ms', 0):.1f}ms{agreement}")

    try:
        if args.rollout_action == "start":
            body: dict = {}
            if args.version:
                body["version"] = args.version
            for k in ("fraction", "bake_s", "min_requests"):
                if getattr(args, k) is not None:
                    body[k] = getattr(args, k)
            if args.shadow:
                body["shadow"] = True
            show(_server_call(args.url, "/rollout/start", body))
        elif args.rollout_action == "abort":
            show(_server_call(args.url, "/rollout/abort",
                              {"reason": args.reason or "operator abort"}))
        else:
            show(_server_call(args.url, "/rollout/status"))
    except CommandError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    return 0


def faults_cmd(args: argparse.Namespace) -> int:
    """`faults list|set|clear`: the fault-injection registry of this
    process, or of a running server (--url; its POST /debug/faults needs
    PIO_FAULTS_ADMIN=1 on the server)."""
    import json
    import urllib.error
    import urllib.request

    from predictionio_tpu_torch.resilience import faults

    url = getattr(args, "url", None)

    def remote(method: str, body: Optional[dict] = None) -> list:
        req = urllib.request.Request(
            url.rstrip("/") + "/debug/faults",
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"}, method=method)
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return json.loads(r.read().decode())["faults"]
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            raise CommandError(f"fault admin refused ({e.code}): {detail}")

    def show(specs: list) -> None:
        if not specs:
            print("[INFO] no active fault specs (registry inert)")
            return
        print(f"[INFO] {len(specs)} active fault spec(s):")
        for s in specs:
            extra = (f" param={s['param']}" if s["mode"] == "delay" else "") + (
                f" seed={s['seed']}" if s.get("seed") is not None else "")
            # the whole key (point@scope): it is what `faults clear` takes
            name = s["point"] + (f"@{s['scope']}" if s.get("scope") else "")
            print(f"[INFO]   {name}: {s['mode']} p={s['probability']}{extra}")

    try:
        if args.faults_action == "list":
            show(remote("GET") if url else faults.specs())
        elif args.faults_action == "set" and url:
            body: dict = {"set": args.spec}
            if args.seed is not None:
                body["seed"] = args.seed
            show(remote("POST", body))
        elif args.faults_action == "set":
            for spec in faults.parse_specs(args.spec, args.seed):
                faults.install(spec)
            show(faults.specs())
        elif url:
            show(remote("POST", {"clear": args.point if args.point else True}))
        else:
            faults.clear(args.point)
            show(faults.specs())
    except (CommandError, faults.FaultSpecError) as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
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


def tenants_cmd(args: argparse.Namespace) -> int:
    """`tenants list|show|new|set-quota|delete`: the multi-tenant serving
    control plane. Storage-backed: every query server's multiplexer
    picks an edit up within its refresh."""
    import json

    from predictionio_tpu_torch.tenancy.tenants import Tenant, TenantStore

    store = TenantStore(Storage())
    action = args.tenants_action
    if action == "list":
        tenants = store.list()
        if not tenants:
            print("[INFO] no tenants")
            return 0
        print(f"[INFO] {len(tenants)} tenant(s):")
        for t in tenants:
            quota = ", ".join(
                f"{k}={v}" for k, v in (("qps", t.qps), ("conc", t.max_concurrency),
                                        ("dev_s/s", t.device_seconds_per_s))
                if v is not None) or "unlimited"
            print(f"[INFO]   {t.id} engine={t.engine_id}/{t.engine_variant} "
                  f"weight={t.weight} quota=[{quota}]" + ("" if t.enabled else " DISABLED"))
        return 0
    if action == "new":
        try:
            tenant = store.upsert(Tenant(
                id=args.tenant_id, engine_id=args.engine,
                engine_version=args.engine_version,
                engine_variant=args.variant or args.engine, weight=args.weight,
                qps=args.qps, max_concurrency=args.max_concurrency,
                device_seconds_per_s=args.device_seconds,
                description=args.description or ""))
        except ValueError as e:
            return _fail(str(e))
        print(f"[INFO] tenant {tenant.id} -> {tenant.engine_id}/{tenant.engine_variant}")
        return 0
    if action == "delete":
        if not store.delete(args.tenant_id):
            return _fail(f"no tenant {args.tenant_id!r}")
        print(f"[INFO] tenant {args.tenant_id} deleted")
        return 0
    tenant = store.get(args.tenant_id)
    if tenant is None:
        return _fail(f"no tenant {args.tenant_id!r}")
    if action == "show":
        print(json.dumps(tenant.to_dict(), indent=2))
        return 0
    fields = {k: v for k, v in (("weight", args.weight), ("qps", args.qps),
                                ("max_concurrency", args.max_concurrency),
                                ("device_seconds_per_s", args.device_seconds))
              if v is not None}
    if not fields:
        return _fail("set-quota needs at least one of --weight/--qps/"
                     "--max-concurrency/--device-seconds")
    try:
        tenant = store.set_quota(args.tenant_id, **fields)
    except (KeyError, ValueError) as e:
        return _fail(str(e))
    print(f"[INFO] tenant {tenant.id} quota updated: weight={tenant.weight}"
          f" qps={tenant.qps} conc={tenant.max_concurrency}"
          f" dev_s/s={tenant.device_seconds_per_s}")
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


def _fleet_collector():
    """This process's fleet trace collector, or None (after the error)
    when no dashboard or monitor in this process runs one."""
    from predictionio_tpu_torch.obs.monitor import get_monitor

    col = get_monitor().collector
    if col is None:
        print("[ERROR] no fleet trace collector in this process — pass --url "
              "pointing at a gateway started with PIO_TRACE_COLLECT=1", file=sys.stderr)
    return col


def trace_cmd(args: argparse.Namespace) -> int:
    """`trace list|show|export`: the retained (tail-sampled) traces of a
    running server (--url) or of this process; with --fleet, the
    assembled cross-process traces of a fleet trace collector."""
    import json

    from predictionio_tpu_torch.obs.spans import get_default_recorder

    url, action, fleet = args.url, args.trace_action, args.fleet
    pre = "fleet=1&" if fleet else ""
    if action == "list":
        if url:
            data = _server_call(url, f"/debug/traces?{pre}limit={args.limit}")
            summaries = data["traces"]
            cfg = data.get("collector" if fleet else "sampling", {})
        elif fleet:
            col = _fleet_collector()
            if col is None:
                return 1
            summaries, cfg = col.summaries(limit=args.limit), col.status()
        else:
            rec = get_default_recorder()
            summaries, cfg = rec.summaries(limit=args.limit), rec.config()
        kind = "assembled fleet" if fleet else "retained"
        print(f"[INFO] {len(summaries)} {kind} trace(s) "
              f"({'collector' if fleet else 'sampling'}: {cfg})")
        for s in summaries:
            # a fleet row names every server the trace crossed
            servers = s.get("servers") or ([s["server"]] if s.get("server") else [])
            where = f" {','.join(servers)}" if servers else ""
            path = f" {s['path']}" if s.get("path") else ""
            err = " ERROR" if s["error"] else ""
            print(f"[INFO]   {s['trace_id']}  {s['root']}{where}{path}  "
                  f"{s['duration_ms']:.1f} ms  {s['spans']} spans  "
                  f"kept={s['kept']}{err}")
        return 0
    if action == "show":
        if url:
            spans = _traces_or_none(url, f"{pre}trace_id={args.trace_id}")
            spans = spans["spans"] if spans else []
        elif fleet:
            col = _fleet_collector()
            if col is None:
                return 1
            spans = col.get_trace(args.trace_id)
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
        export = _traces_or_none(url, pre + params) or {}
    elif fleet:
        col = _fleet_collector()
        if col is None:
            return 1
        export = col.perfetto_export(args.trace_id)
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


def adminserver(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.tools.admin import AdminServer

    return _serve_until_interrupt(
        AdminServer(Storage(), ip=args.ip, port=args.port),
        f"[INFO] Admin server is listening at http://{args.ip}:{{port}}.")


def dashboard(args: argparse.Namespace) -> int:
    from predictionio_tpu_torch.tools.dashboard import Dashboard

    return _serve_until_interrupt(
        Dashboard(Storage(), ip=args.ip, port=args.port,
                  monitor_targets=args.monitor_targets),
        f"[INFO] Dashboard is listening at http://{args.ip}:{{port}}.")


def _expr_rows(tsdb, text: str) -> None:
    """One `monitor --expr` pass: the expression's rows over the TSDB."""
    from predictionio_tpu_torch.obs.monitor.expr import ExprError, evaluate_rows

    try:
        rows = evaluate_rows(tsdb, text)
    except ExprError as exc:
        print(f"[WARN]   expr {text}: {exc}")
        return
    if not rows:
        print(f"[INFO]   expr {text} = (no data)")
        return
    for row in rows:
        lbls = ",".join(f"{k}={v}" for k, v in sorted(row["labels"].items()))
        where = f"{{{lbls}}}" if lbls else ""
        print(f"[INFO]   expr {text}{where} = {row['value']:g}")


def monitor_cmd(args: argparse.Namespace) -> int:
    """`monitor`: a standalone fleet-aggregation process: scrape the
    targets' /metrics into this process's TSDB, run the trace collector
    and the SLO engine over it, and print the fleet and alert state each
    pass."""
    import time

    from predictionio_tpu_torch.obs.monitor import (
        FleetScraper,
        SLOEngine,
        TraceCollector,
        get_monitor,
        load_slos,
        parse_targets,
    )
    from predictionio_tpu_torch.obs.monitor.expr import ExprError, parse
    from predictionio_tpu_torch.utils.env import monitor_knob

    targets = parse_targets(args.targets or monitor_knob("PIO_MONITOR_TARGETS"))
    if not targets:
        print("[ERROR] no scrape targets: pass --targets name=url[,name=url] or "
              "set PIO_MONITOR_TARGETS", file=sys.stderr)
        return 1
    monitor = get_monitor()
    scraper = FleetScraper(monitor.tsdb, targets, interval_s=args.interval)
    collector = None
    if monitor_knob("PIO_TRACE_COLLECT"):
        collector = TraceCollector(targets=list(targets), interval_s=args.interval)
        monitor.set_collector(collector)
    exprs = list(args.expr or [])
    for e in exprs:  # a typo fails before the first scrape pass
        try:
            parse(e)
        except ExprError as exc:
            print(f"[ERROR] bad --expr {e!r}: {exc}", file=sys.stderr)
            return 1
    specs = load_slos(args.slos) if args.slos else load_slos()
    engine = (SLOEngine(monitor.tsdb, specs, interval_s=max(args.interval, 1.0))
              if specs else None)
    deadline = time.monotonic() + args.duration if args.duration else None
    try:
        while True:
            ups = scraper.scrape_once()
            if collector is not None:
                collector.collect_once()
            if engine is not None:
                engine.evaluate_once()
            fleet = " ".join(f"{inst}={'up' if ok else 'DOWN'}"
                             for inst, ok in sorted(ups.items()))
            traces = (f"  traces={collector.status()['assembled']}"
                      if collector is not None else "")
            print(f"[INFO] {time.strftime('%H:%M:%S')} fleet: {fleet}{traces}",
                  flush=True)
            for e in exprs:
                _expr_rows(monitor.tsdb, e)
            if engine is not None:
                for row in engine.payload()["slos"]:
                    fast = row["fast_burn"]
                    print(f"[INFO]   slo {row['slo']}: {row['state']} (fast burn "
                          f"{'-' if fast is None else f'{fast:.2f}'} / threshold "
                          f"{row['burn_threshold']})", flush=True)
            if deadline is not None and time.monotonic() >= deadline:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        if collector is not None and monitor.collector is collector:
            monitor.set_collector(None)


def alerts_cmd(args: argparse.Namespace) -> int:
    """`alerts list|show`: the SLO alert states of this process, or of a
    running server via --url (its GET /alerts)."""
    from predictionio_tpu_torch.obs.monitor import get_monitor

    try:
        payload = (_server_call(args.url, "/alerts") if args.url
                   else get_monitor().alerts_payload())
    except CommandError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    rows = payload.get("slos", [])
    if args.alerts_action == "list":
        if not rows:
            print(f"[INFO] no SLOs configured ({payload.get('message', 'set PIO_SLOS')})")
            return 0
        print(f"[INFO] {len(rows)} SLO(s), firing: {payload.get('firing') or 'none'}")
        for r in rows:
            fast, slow = r.get("fast_burn"), r.get("slow_burn")
            print(f"[INFO]   {r['slo']}: {r['state']}  fast="
                  f"{'-' if fast is None else f'{fast:.2f}'} slow="
                  f"{'-' if slow is None else f'{slow:.2f}'} "
                  f"threshold={r.get('burn_threshold')} "
                  f"samples={r.get('fast_samples')}")
        return 0
    row = next((r for r in rows if r["slo"] == args.name), None)
    if row is None:
        print(f"[ERROR] no SLO {args.name!r}", file=sys.stderr)
        return 1
    print(f"[INFO] {row['slo']}:")
    for k, v in row.items():
        if k != "slo":
            print(f"[INFO]   {k}: {v}")
    return 0


def tsdb_cmd(args: argparse.Namespace) -> int:
    """`tsdb query`: the time-series history of this process, or of a
    running server via --url (its GET /debug/tsdb)."""
    from urllib.parse import urlencode

    from predictionio_tpu_torch.obs.monitor import get_monitor

    qs: dict = {}
    if args.expr:
        qs["expr"] = args.expr
    if args.name:
        qs["name"] = args.name
    if args.labels:
        qs["labels"] = args.labels
    if args.window is not None:
        qs["window_s"] = str(args.window)
    if args.agg:
        qs["agg"] = args.agg
        if args.q is not None:
            qs["q"] = str(args.q)
    try:
        payload = (_server_call(args.url, "/debug/tsdb"
                                + (f"?{urlencode(qs)}" if qs else ""))
                   if args.url else get_monitor().tsdb_payload(qs))
    except CommandError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    if not payload.get("enabled", True):
        print("[INFO] monitoring disabled (PIO_TSDB=0)")
        return 0
    if "expr" in payload:
        if "error" in payload:
            print(f"[ERROR] expression error: {payload['error']}", file=sys.stderr)
            return 1
        rows = payload.get("result") or []
        print(f"[INFO] {payload['expr']}")
        if not rows:
            print("[INFO]   (no data)")
            return 0
        for row in rows:
            labels = ",".join(f"{k}={v}" for k, v in sorted(row["labels"].items()))
            print(f"[INFO]   {{{labels}}} = {row['value']:g}")
        return 0
    if "value" in payload:
        print(f"[INFO] {payload['agg']}({payload['name']}"
              + (f", window={payload.get('window_s')}s" if payload.get("window_s") else "")
              + f") = {payload['value']}")
        return 0
    series = payload.get("series", [])
    if not args.name:
        print(f"[INFO] {payload.get('series_count', len(series))} series "
              f"(capacity {payload.get('capacity')} pts, "
              f"{payload.get('dropped_series', 0)} dropped at the cardinality cap)")
        durable = payload.get("durable")
        if durable:
            wal = durable.get("wal", {})
            print(f"[INFO] durable tier at {durable.get('dir')}: "
                  f"{wal.get('segments', 0)} wal segment(s), "
                  f"{wal.get('pending', 0)} pending pts, replayed "
                  f"{durable.get('replayed_points', 0)} pts at attach")
            for tier, st in (durable.get("tiers") or {}).items():
                span = (f"{st['max_t'] - st['min_t']:.0f}s span"
                        if st.get("min_t") is not None else "empty")
                print(f"[INFO]   tier {tier}: {st.get('blocks', 0)} block(s), "
                      f"{st.get('series', 0)} series, {st.get('bytes', 0)} bytes, {span}")
        for s in series:
            labels = ",".join(f"{k}={v}" for k, v in s["labels"].items())
            where = f"{s['name']}{{{labels}}}" if labels else s["name"]
            print(f"[INFO]   {where} [{s['kind']}] {s['points']} pts last={s['last']}")
        return 0
    for s in series:
        labels = ",".join(f"{k}={v}" for k, v in s["labels"].items())
        where = f"{s['name']}{{{labels}}}" if labels else s["name"]
        print(f"[INFO] {where} [{s['kind']}] {len(s['points'])} pts:")
        for t, v in s["points"][-(args.last or len(s["points"])):]:
            print(f"[INFO]   {t:.3f}  {v:g}")
    return 0


def _run(args: argparse.Namespace) -> int:
    commands = {"app": app_cmd, "channel": channel_cmd, "accesskey": accesskey_cmd,
                "eventserver": eventserver, "storageserver": storageserver,
                "storage-server": storageserver, "status": status, "online": online,
                "jobs": jobs_cmd, "models": models_cmd, "tenants": tenants_cmd,
                "metrics": metrics_cmd,
                "trace": trace_cmd, "profile": profile_cmd,
                "rollout": rollout_cmd, "faults": faults_cmd,
                "adminserver": adminserver, "dashboard": dashboard,
                "monitor": monitor_cmd, "alerts": alerts_cmd, "tsdb": tsdb_cmd,
                "tune": tune_cmd, "fleet": fleet_cmd, "template": template_cmd}
    if args.cmd in commands:
        return commands[args.cmd](args)
    if args.cmd == "import":
        n, skipped = import_events(args)
        print(f"[INFO] Imported {n} events into {args.app}"
              + (f" ({skipped} malformed rows skipped)" if skipped else ""), flush=True)
        return 0 if skipped == 0 else 1
    if args.cmd == "export":
        n = export_events(args)
        print(f"[INFO] Exported {n} events to {args.output}", flush=True)
        return 0
    if args.cmd == "eval":
        return eval_run(args) if args.eval_cmd == "run" else eval_records(args)
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
