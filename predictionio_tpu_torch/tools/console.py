"""Command line of the port.

    python -m predictionio_tpu_torch.tools.console app new NAME
    python -m predictionio_tpu_torch.tools.console import --app NAME \\
        --input events.jsonl
    python -m predictionio_tpu_torch.tools.console train --engine-json F \\
        [--engine-version V] [--device cpu]
    python -m predictionio_tpu_torch.tools.console deploy --engine-json F \\
        [--engine-version V] [--ip ADDR] [--port N] [--device cpu]

    python -m predictionio_tpu_torch.tools.console eval run EVALUATION \\
        [GENERATOR] [--device cpu]

    python -m predictionio_tpu_torch.tools.console train --ratings FILE \\
        --out blob.npz [--rank 10] [--iterations 20] [--lambda 0.01] \\
        [--alpha 1.0] [--explicit] [--device cpu]
    python -m predictionio_tpu_torch.tools.console deploy --model PATH \\
        --port N [--ip ADDR] [--serve-dtype f32|bf16|int8] [--device cpu]

The first four are the JAX package's ``pio`` loop over the configured
storage (``PIO_STORAGE_*``, else sqlite and model files under
``PIO_FS_BASEDIR``, default ``~/.pio_store``): ``app new`` registers an
app, ``import`` writes its events from JSON lines (one event object a
line, as ``pio import`` reads them), ``train --engine-json`` trains the
engine variant into an engine instance and its MODELDATA blob, and
``deploy --engine-json`` serves the variant's newest completed instance
until interrupted. ``eval run`` evaluates an ``Evaluation`` named by its
import path (``module.Class``) over the grid of an
``EngineParamsGenerator`` (or the evaluation's own
``engine_params_list``) and stores an evaluation instance; it exits 0
only when that instance is EVALCOMPLETED. Access keys, channels, the
fleet evaluation (an EvalSpec file as the target, ``eval
list/show/status/gc``) and ``tune`` are not ported: they exit 1 saying
so.

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
from pathlib import Path

from predictionio_tpu_torch.controller.evaluation import Evaluation
from predictionio_tpu_torch.controller.params import ParamsError, load_symbol
from predictionio_tpu_torch.convert import load_jax_als_blob
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.engines.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    FileDataSourceParams,
    FileRatingsDataSource,
    RuntimeContext,
)
from predictionio_tpu_torch.models.als import SERVE_DTYPES
from predictionio_tpu_torch.workflow.core import load_variant, run_train, stage_timings
from predictionio_tpu_torch.workflow.evaluation import run_evaluation
from predictionio_tpu_torch.workflow.server import (
    QueryServer,
    QueryServerConfig,
    latest_completed_runtime,
)


# the JAX package's fleet-evaluation commands, which the port refuses
NOT_PORTED_EVAL = ("list", "show", "status", "gc")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="predictionio_tpu_torch.tools.console")
    sub = ap.add_subparsers(dest="cmd", required=True)
    defaults = ALSAlgorithmParams()
    app = sub.add_parser("app", help="manage apps").add_subparsers(
        dest="app_cmd", required=True)
    new = app.add_parser("new", help="register an app")
    new.add_argument("name")
    new.add_argument("--description")
    imp = sub.add_parser("import", help="write an app's events from JSON lines")
    imp.add_argument("--app", required=True)
    imp.add_argument("--input", required=True, type=Path)

    tr = sub.add_parser("train", help="train an engine variant, or ALS factors "
                                      "from a ratings file")
    src = tr.add_mutually_exclusive_group(required=True)
    src.add_argument("--engine-json", type=Path, help="the engine variant")
    src.add_argument("--ratings", type=Path, help="user::item::rating lines")
    tr.add_argument("--engine-version", default="0")
    tr.add_argument("--delimiter", default="::")
    tr.add_argument("--out", type=Path,
                    help="with --ratings: where to write the factor blob (npz)")
    tr.add_argument("--rank", type=int, default=defaults.rank)
    tr.add_argument("--iterations", type=int, default=defaults.num_iterations)
    tr.add_argument("--lambda", dest="lambda_", type=float,
                    default=defaults.lambda_)
    tr.add_argument("--alpha", type=float, default=defaults.alpha)
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
    dep.add_argument("--serve-dtype", choices=SERVE_DTYPES, default="f32",
                     help="with --model: the serving dtype")
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
    return ap


def app_new(args: argparse.Namespace) -> App:
    storage = Storage()
    app_id = storage.get_meta_data_apps().insert(App(0, args.name, args.description))
    if app_id is None:
        raise SystemExit(f"[ERROR] app {args.name!r} already exists")
    storage.get_events().init_app(app_id)
    return App(app_id, args.name, args.description)


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
    bulk write; a malformed line is an error naming its line, and
    nothing after it is written."""
    storage = Storage()
    app = storage.get_meta_data_apps().get_by_name(args.app)
    if app is None:
        raise SystemExit(f"[ERROR] app {args.app!r} does not exist")
    return storage.get_events().write(_read_events(args.input), app.id)


def build_server(args: argparse.Namespace) -> QueryServer:
    config = QueryServerConfig(ip=args.ip, port=args.port)
    if args.engine_json is not None:
        variant = load_variant(str(args.engine_json))
        runtime = latest_completed_runtime(
            Storage(), variant["id"], args.engine_version, variant["id"],
            device=args.device,
        )
        return QueryServer(runtime=runtime, config=config)
    factors = load_jax_als_blob(args.model.read_bytes())
    params = ALSAlgorithmParams(rank=factors.params.rank, serve_dtype=args.serve_dtype)
    model = ALSModel(factors, serve_dtype=args.serve_dtype, device=args.device)
    return QueryServer(ALSAlgorithm(params), model, config)


def train(args: argparse.Namespace) -> ALSModel:
    """Read the ratings file, train, and write the factor blob."""
    ctx = RuntimeContext(device=args.device)
    td = FileRatingsDataSource(
        FileDataSourceParams(str(args.ratings), delimiter=args.delimiter)
    ).read_training(ctx)
    td.sanity_check()
    params = ALSAlgorithmParams(
        rank=args.rank, num_iterations=args.iterations,
        lambda_=args.lambda_, alpha=args.alpha,
        implicit_prefs=not args.explicit,
    )
    model = ALSAlgorithm(params).train(ctx, td)
    args.out.write_bytes(model.factors.to_bytes())
    return model


def _instance(obj):
    return obj() if isinstance(obj, type) else obj


def eval_run(args: argparse.Namespace) -> int:
    """`eval run`: the single-process evaluation of an Evaluation import
    path over the generator's grid, on `--device`."""
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


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd == "app":
        app = app_new(args)
        print(f"[INFO] App created: ID={app.id} Name={app.name}", flush=True)
        return 0
    if args.cmd == "import":
        n = import_events(args)
        print(f"[INFO] Imported {n} events into {args.app}", flush=True)
        return 0
    if args.cmd == "tune" or (args.cmd == "eval" and args.eval_cmd != "run"):
        what = "tune" if args.cmd == "tune" else f"eval {args.eval_cmd}"
        print(f"[ERROR] {what} (the fleet evaluation) is not ported yet to "
              f"the PyTorch port", file=sys.stderr)
        return 1
    if args.cmd == "eval":
        return eval_run(args)
    if args.cmd == "train" and args.engine_json is not None:
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
              f"{args.rank}, on {model.device}; wrote {args.out}", flush=True)
        return 0
    server = build_server(args)
    try:
        port = server.start()
        what = args.engine_json or args.model
        print(f"serving {what} on {args.ip}:{port} ({server.model.device})",
              flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
