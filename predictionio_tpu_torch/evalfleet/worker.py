"""The eval shard's subprocess: ``python -m predictionio_tpu_torch.evalfleet.worker
<spec.json>``.

Counterpart of the JAX package's ``evalfleet/worker.py``. The scheduler
starts this module for a ``kind="eval"`` job as it starts
``deploy/worker.py`` for a train job: the same spec file (the storage
settings, the variant, the result path, the torch device) and the same
exit codes. The variant carries the ``evalShard`` payload the eval driver
wrote (``evalfleet/driver.py``): which points of which run, which fold,
which metrics.

Here the shard builds the engine, makes one EngineParams a point, runs
them through ``Engine.batch_eval`` on the spec's device (a grid group
trains over one staging a fold through ``train_grid``), reduces each
point's (Q, P, A) tuples to combinable metric partials and writes them
to the durable results. Its log ends with the kernel launches the shard
made. A shard killed midway costs nothing: a re-claimed shard rewrites
the same fields (``evalfleet/records.py``).

The device is resolved before anything runs: with no CUDA device (and
no ``device`` in the spec) the shard fails and trains nothing on the
CPU.

Exit codes, the scheduler's retry contract:
- 0                  partials recorded;
- EXIT_TRAIN_FAILED  the evaluation raised, or the device is missing (a
                     retry would repeat it: the job fails at once);
- anything else      infrastructure; the scheduler re-queues the job.
"""

from __future__ import annotations

import json
import logging
import sys
import traceback


def main(argv: list[str]) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if len(argv) != 2:
        print("usage: python -m predictionio_tpu_torch.evalfleet.worker <spec.json>",
              file=sys.stderr)
        return 2
    from predictionio_tpu_torch.controller.engine import resolve_engine
    from predictionio_tpu_torch.controller.params import load_symbol
    from predictionio_tpu_torch.core.base import RuntimeContext
    from predictionio_tpu_torch.data.storage.base import StorageError
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.deploy.scheduler import (
        EXIT_INFRA_FAILED,
        EXIT_TRAIN_FAILED,
        storage_config_from_json,
    )
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.evalfleet.records import EvalRecordStore
    from predictionio_tpu_torch.evalfleet.specs import metric_partial, resolve_metric
    from predictionio_tpu_torch.ops import dense_fused, recommend, windowed_fused

    with open(argv[1]) as f:
        spec = json.load(f)
    try:
        storage = Storage(storage_config_from_json(spec["storage"]))
    except Exception:  # noqa: BLE001 — the stores did not open
        traceback.print_exc()
        return EXIT_INFRA_FAILED

    variant = spec["variant"]
    shard = variant.get("evalShard")
    if not shard:
        print("spec variant carries no evalShard payload", file=sys.stderr)
        return EXIT_TRAIN_FAILED

    try:
        device = str(resolve_device(spec.get("device")))
        engine = resolve_engine(load_symbol(variant["engineFactory"]))
        base = {k: v for k, v in variant.items() if k != "evalShard"}
        eps = [engine.params_from_variant_json({**base, **frag})
               for frag in shard["points"]]
        fold = shard.get("fold")
        ctx = RuntimeContext(storage=storage, mode="eval", device=device)
        eval_data = engine.batch_eval(
            ctx, eps, fold_indices=None if fold is None else [int(fold)])
        primary = resolve_metric(shard["metric"])
        others = [resolve_metric(m) for m in shard.get("other_metrics", [])]
    except StorageError:
        traceback.print_exc()
        return EXIT_INFRA_FAILED
    except Exception:  # noqa: BLE001 — the evaluation's own failure
        traceback.print_exc()
        return EXIT_TRAIN_FAILED
    print(f"kernel launches: dense row {dense_fused.PASS_LAUNCHES['row']}, "
          f"col {dense_fused.PASS_LAUNCHES['col']}; windowed partials "
          f"{windowed_fused.BLOCK_LAUNCHES['partials']}, combine "
          f"{windowed_fused.BLOCK_LAUNCHES['combine']}; top-k {recommend.LAUNCHES} "
          f"(select {recommend.ROUTE_LAUNCHES['select']}, sort "
          f"{recommend.ROUTE_LAUNCHES['sort']}) on {device}", flush=True)

    run_id = shard["run_id"]
    try:
        records = EvalRecordStore(storage)
        for idx, (point_index, (_ep, data)) in enumerate(
                zip(shard["point_indices"], eval_data)):
            payload = {
                "primary": metric_partial(primary, ctx, data),
                "others": [{"header": m.header(), **metric_partial(m, ctx, data)}
                           for m in others],
                "job_id": spec.get("job_id"),
            }
            records.record_partial(run_id, point_index, fold, payload,
                                   params=shard["points"][idx])
    except StorageError:
        traceback.print_exc()
        return EXIT_INFRA_FAILED
    except Exception:  # noqa: BLE001 — a metric raised
        traceback.print_exc()
        return EXIT_TRAIN_FAILED

    with open(spec["result_path"], "w") as f:
        json.dump({"run_id": run_id, "points": len(eps), "fold": fold}, f)
    print(f"eval shard done: run {run_id}, {len(eps)} point(s), "
          f"fold {'all' if fold is None else fold}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
