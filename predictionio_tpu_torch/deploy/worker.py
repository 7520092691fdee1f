"""The train job's subprocess: ``python -m predictionio_tpu_torch.deploy.worker
<spec.json>``.

Counterpart of the JAX package's ``deploy/worker.py``. The scheduler
(``scheduler.py``) writes the spec (the storage settings, the variant,
the result path and the torch device), starts this module and
supervises it from outside. Here the job opens the same stores, runs
``run_train`` on the spec's device (None: the first CUDA device, which
must be there), registers the COMPLETED instance as a model version
stamped with the job's id, writes the result receipt and exits 0. A
retried job whose earlier attempt already registered a version adopts
it instead of training again. Its log ends with the kernel launches the
train made. The version carries the device profiler's report of the
train (``devprof``: each executable's invocations, device seconds and
roofline) when the train ran an instrumented function.

Push telemetry: with ``PIO_PUSH_URL`` or ``PIO_PUSH_SPOOL`` set, a
``TelemetryShipper`` (``obs/monitor/push.py``) spools this process's
series, ``train.*`` spans and devprof report every interval and ships
them; the ``finally`` of ``main`` stops it, which spools and ships one
last time. A child killed with SIGKILL leaves its spool for the
scheduler to ship.

Exit codes, the scheduler's retry contract:
- 0                  trained and registered (or adopted);
- EXIT_TRAIN_FAILED  the train raised or did not complete (a retry
                     would repeat it: the job fails at once); a kernel
                     that does not build or load fails here too;
- anything else      infrastructure (storage down, a killed process);
                     the scheduler re-queues the job with backoff.
"""

from __future__ import annotations

import json
import logging
import sys
import traceback

log = logging.getLogger(__name__)


def _write_result(path: str, instance_id: str, version_id: str) -> None:
    with open(path, "w") as f:
        json.dump({"instance_id": instance_id, "model_version": version_id}, f)


def main(argv: list[str]) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if len(argv) != 2:
        print("usage: python -m predictionio_tpu_torch.deploy.worker <spec.json>",
              file=sys.stderr)
        return 2
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.deploy.scheduler import storage_config_from_json

    with open(argv[1]) as f:
        spec = json.load(f)
    storage = Storage(storage_config_from_json(spec["storage"]))
    shipper = None
    try:
        from predictionio_tpu_torch.obs.monitor.push import TelemetryShipper

        shipper = TelemetryShipper.from_env(job_id=spec.get("job_id"))
        if shipper is not None:
            shipper.start()
    except Exception:  # noqa: BLE001 — telemetry never fails a train
        log.debug("telemetry shipper unavailable", exc_info=True)
    try:
        return _run(spec, storage)
    finally:
        if shipper is not None:
            shipper.stop()  # joins, then spools and ships one last time


def _run(spec: dict, storage) -> int:
    from predictionio_tpu_torch.data.storage.base import StorageError
    from predictionio_tpu_torch.deploy.registry import ModelRegistry
    from predictionio_tpu_torch.deploy.scheduler import EXIT_INFRA_FAILED, EXIT_TRAIN_FAILED
    from predictionio_tpu_torch.ops import dense_fused, windowed_fused
    from predictionio_tpu_torch.workflow.core import run_train

    # a retried job whose earlier attempt registered a version (and lost
    # only its receipt) adopts that version
    job_id = spec.get("job_id")
    if job_id:
        try:
            existing = ModelRegistry(storage).find_by_job(job_id)
        except Exception:  # noqa: BLE001 — a storage hiccup: train
            existing = None
        if existing is not None and existing.status not in (
                "rolled_back", "archived"):
            _write_result(spec["result_path"], existing.instance_id,
                          existing.id)
            print(f"job {job_id}: adopting already-registered version "
                  f"{existing.id} (instance {existing.instance_id}); "
                  f"skipping retrain")
            return 0
    try:
        instance = run_train(storage, spec["variant"],
                             engine_id=spec.get("engine_id"),
                             device=spec.get("device"))
    except StorageError:
        traceback.print_exc()
        return EXIT_INFRA_FAILED
    except Exception:  # noqa: BLE001 — the train's own failure
        traceback.print_exc()
        return EXIT_TRAIN_FAILED
    print(f"kernel launches: dense row {dense_fused.PASS_LAUNCHES['row']}, "
          f"col {dense_fused.PASS_LAUNCHES['col']}; windowed partials "
          f"{windowed_fused.BLOCK_LAUNCHES['partials']}, combine "
          f"{windowed_fused.BLOCK_LAUNCHES['combine']}", flush=True)
    if instance.status != "COMPLETED":
        print(f"train ended {instance.status}, not COMPLETED", file=sys.stderr)
        return EXIT_TRAIN_FAILED
    devprof_report: dict = {}
    try:
        from predictionio_tpu_torch.obs import devprof

        report = devprof.report()
        if report.get("executables"):
            devprof_report = report
    except Exception:  # noqa: BLE001 — the version record stays valid
        log.exception("device profile unavailable; registering without it")
    version = ModelRegistry(storage).register(instance, devprof=devprof_report,
                                              job_id=job_id)
    _write_result(spec["result_path"], instance.id, version.id)
    print(f"trained instance {instance.id} → model version {version.id}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
