"""Command line of the port.

    python -m predictionio_tpu_torch.tools.console deploy --model PATH \\
        --port N [--ip ADDR] [--serve-dtype f32|bf16|int8] [--device cpu]

``deploy`` serves an ALS factor blob — the bytes of the JAX package's
``ALSFactors.to_bytes()``, or of the port's own — through the
recommendation engine's query server until interrupted. The model runs
on the first CUDA device unless ``--device`` names another.
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
)
from predictionio_tpu_torch.models.als import SERVE_DTYPES
from predictionio_tpu_torch.workflow.server import QueryServer, QueryServerConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="predictionio_tpu_torch.tools.console")
    sub = ap.add_subparsers(dest="cmd", required=True)
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


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
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
