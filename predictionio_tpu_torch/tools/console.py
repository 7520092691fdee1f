"""Command line of the port.

    python -m predictionio_tpu_torch.tools.console train --ratings FILE \\
        --out blob.npz [--rank 10] [--iterations 20] [--lambda 0.01] \\
        [--alpha 1.0] [--explicit] [--device cpu]
    python -m predictionio_tpu_torch.tools.console deploy --model PATH \\
        --port N [--ip ADDR] [--serve-dtype f32|bf16|int8] [--device cpu]

``train`` reads ``user::item::rating`` lines (the file-backed
recommendation engine's DataSource), trains ALS factors and writes the
npz factor blob (``ALSFactors.to_bytes()``, the JAX package's format).
``deploy`` serves such a blob — written here or by the JAX package —
through the recommendation engine's query server until interrupted.
Both run on the first CUDA device unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from predictionio_tpu_torch.convert import load_jax_als_blob
from predictionio_tpu_torch.engines.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    FileDataSourceParams,
    FileRatingsDataSource,
    RuntimeContext,
)
from predictionio_tpu_torch.models.als import SERVE_DTYPES
from predictionio_tpu_torch.workflow.server import QueryServer, QueryServerConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="predictionio_tpu_torch.tools.console")
    sub = ap.add_subparsers(dest="cmd", required=True)
    defaults = ALSAlgorithmParams()
    tr = sub.add_parser("train", help="train ALS factors from a ratings file")
    tr.add_argument("--ratings", required=True, type=Path,
                    help="user::item::rating lines")
    tr.add_argument("--delimiter", default="::")
    tr.add_argument("--out", required=True, type=Path,
                    help="where to write the factor blob (npz)")
    tr.add_argument("--rank", type=int, default=defaults.rank)
    tr.add_argument("--iterations", type=int, default=defaults.num_iterations)
    tr.add_argument("--lambda", dest="lambda_", type=float,
                    default=defaults.lambda_)
    tr.add_argument("--alpha", type=float, default=defaults.alpha)
    tr.add_argument("--explicit", action="store_true",
                    help="explicit ratings (ALS-WR) instead of implicit")
    tr.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    dep = sub.add_parser("deploy", help="serve an ALS factor blob")
    dep.add_argument("--model", required=True, type=Path,
                     help="ALS factor blob (npz bytes of ALSFactors.to_bytes)")
    dep.add_argument("--ip", default="0.0.0.0")
    dep.add_argument("--port", type=int, default=8000)
    dep.add_argument("--serve-dtype", choices=SERVE_DTYPES, default="f32")
    dep.add_argument("--device", default=None,
                     help="torch device (default: the first CUDA device)")
    return ap


def build_server(args: argparse.Namespace) -> QueryServer:
    factors = load_jax_als_blob(args.model.read_bytes())
    params = ALSAlgorithmParams(
        rank=factors.params.rank, serve_dtype=args.serve_dtype
    )
    model = ALSModel(factors, serve_dtype=args.serve_dtype, device=args.device)
    return QueryServer(
        ALSAlgorithm(params), model,
        QueryServerConfig(ip=args.ip, port=args.port),
    )


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


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd == "train":
        model = train(args)
        print(f"trained {model.factors.user_factors.shape[0]} users x "
              f"{model.factors.item_factors.shape[0]} items, rank "
              f"{args.rank}, on {model.device}; wrote {args.out}", flush=True)
        return 0
    server = build_server(args)
    try:
        port = server.start()
        print(f"serving {args.model} on {args.ip}:{port} "
              f"({server.model.device})", flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
