"""Train workflow: variant JSON → engine → models → MODELDATA blob, and
the deploy-side rehydration.

Counterpart of the JAX package's ``workflow/core.py`` (reference
CreateWorkflow.scala:133, CoreWorkflow.runTrain:42-99,
CreateServer.createServerActorWithEngine:206). The JAX mesh becomes a
device: the train runs on the caller's device (None is the first CUDA
device), and deploy serves on the device it is given, never the one the
model was trained on. Metrics, profiler traces
and engine-manifest registration are not ported.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import time
import uuid
from typing import Any, Optional

from predictionio_tpu_torch.controller.engine import EngineParams, resolve_engine
from predictionio_tpu_torch.controller.params import load_symbol, params_to_json
from predictionio_tpu_torch.controller.persistent import (
    deserialize_models,
    serialize_models,
)
from predictionio_tpu_torch.core.base import (
    RuntimeContext,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    WorkflowParams,
)
from predictionio_tpu_torch.data.storage.base import EngineInstance, Model
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _stage_json(stage: tuple[str, Any]) -> str:
    """A (stage-name, params) pair as stored on the instance row: deploy
    rebinds the same named class the train used (EngineInstances.scala:43)."""
    name, params = stage
    return json.dumps(
        {"name": name, "params": json.loads(params_to_json(params))}, sort_keys=True
    )


def load_variant(path: str) -> dict:
    """An engine variant JSON file (engine.json)."""
    with open(path) as f:
        variant = json.load(f)
    for key in ("id", "engineFactory"):
        if key not in variant:
            raise ValueError(f"engine variant is missing {key!r} ({path})")
    return variant


def runtime_context_from_variant(
    storage: Storage,
    variant: dict,
    mode: str = "train",
    workflow_params: Optional[WorkflowParams] = None,
    device: Optional[str] = None,
) -> RuntimeContext:
    """The context a train runs in, on `device` (the first CUDA device
    when None). The variant's JAX ``mesh`` is not read."""
    return RuntimeContext(
        storage=storage,
        mode=mode,
        device=device,
        workflow_params=workflow_params or WorkflowParams(),
    )


def run_train(
    storage: Storage,
    variant: dict,
    workflow_params: Optional[WorkflowParams] = None,
    engine_params: Optional[EngineParams] = None,
    engine_id: Optional[str] = None,
    engine_version: str = "0",
    device: Optional[str] = None,
) -> EngineInstance:
    """`pio train`: resolve the factory, params from the variant, an
    INIT instance row, TRAINING, engine.train, the models' MODELDATA blob,
    then COMPLETED (INTERRUPTED at a debug stop-point, ABORTED on an
    error, which is raised again). Returns the final row."""
    wp = workflow_params or WorkflowParams()
    engine = resolve_engine(load_symbol(variant["engineFactory"]))
    if engine_params is None:
        engine_params = engine.params_from_variant_json(variant)
    instances = storage.get_meta_data_engine_instances()
    now = _now()
    instance = EngineInstance(
        id=str(uuid.uuid4()),
        status="INIT",
        start_time=now,
        end_time=now,
        engine_id=engine_id or variant["id"],
        engine_version=engine_version,
        engine_variant=variant["id"],
        engine_factory=variant["engineFactory"],
        batch=wp.batch,
        data_source_params=_stage_json(engine_params.data_source_params),
        preparator_params=_stage_json(engine_params.preparator_params),
        algorithms_params=json.dumps([
            {"name": name, "params": json.loads(params_to_json(p))}
            for name, p in engine_params.algorithm_params_list
        ]),
        serving_params=_stage_json(engine_params.serving_params),
    )
    instance.id = instances.insert(instance)
    ctx = runtime_context_from_variant(storage, variant, "train", wp, device)
    ctx.instance_id = instance.id

    def finish(status: str) -> None:
        instance.status = status
        instance.end_time = _now()
        instance.env = dict(instance.env or {})
        instance.env["stage_timings"] = json.dumps(
            {k: round(v, 4) for k, v in ctx.stage_timings.items()}
        )
        instances.update(instance)

    try:
        instance.status = "TRAINING"
        instances.update(instance)
        try:
            models = engine.train(ctx, engine_params)
        except (StopAfterReadInterruption, StopAfterPrepareInterruption) as e:
            log.info("training interrupted by %s", type(e).__name__)
            finish("INTERRUPTED")
            return instance
        if wp.save_model:
            t0 = time.perf_counter()
            serializable = engine.make_serializable_models(
                ctx, models, engine_params, instance.id
            )
            storage.get_model_data_models().insert(
                Model(id=instance.id, models=serialize_models(serializable))
            )
            ctx.stage_timings["persist"] = time.perf_counter() - t0
        finish("COMPLETED")
        log.info("training completed: instance %s (stages: %s)", instance.id,
                 {k: round(v, 3) for k, v in ctx.stage_timings.items()})
        return instance
    except Exception:
        finish("ABORTED")  # partial timings show where the failed run spent time
        raise


def stage_timings(instance: EngineInstance) -> dict:
    """The read/prepare/train/persist seconds recorded on an instance row."""
    return json.loads((instance.env or {}).get("stage_timings") or "{}")


def prepare_deploy_models(
    storage: Storage,
    instance: EngineInstance,
    engine: Any = None,
    engine_params: Optional[EngineParams] = None,
    device: Optional[str] = None,
) -> tuple[Any, EngineParams, list[Any]]:
    """Rehydrate a COMPLETED instance's models for serving on `device`
    (the first CUDA device when None; raises without one). Returns
    (engine, engine_params, models)."""
    dev = str(resolve_device(device))
    if engine is None:
        engine = resolve_engine(load_symbol(instance.engine_factory))
    if engine_params is None:
        engine_params = engine_instance_to_engine_params(engine, instance)
    blob = storage.get_model_data_models().get(instance.id)
    if blob is None:
        raise RuntimeError(f"no model blob stored for instance {instance.id}")
    persisted = deserialize_models(blob.models)
    ctx = RuntimeContext(storage=storage, mode="serve", device=dev)
    models = engine.prepare_deploy(ctx, engine_params, persisted, instance_id=instance.id)
    return engine, engine_params, models


def _stage_from_json(raw: str) -> Optional[dict]:
    """Invert _stage_json into a variant stage object (None when empty)."""
    if not raw or raw == "{}":
        return None
    obj = json.loads(raw)
    if "name" not in obj:  # the bare-params form
        return {"params": obj} if obj else None
    if not obj["name"] and not obj.get("params"):
        return None
    return {"name": obj["name"], "params": obj.get("params") or None}


def engine_instance_to_engine_params(engine: Any, instance: EngineInstance) -> EngineParams:
    """EngineParams from the name+params JSON on the instance row
    (reference Engine.engineInstanceToEngineParams:419)."""
    variant: dict = {"id": instance.engine_variant,
                     "engineFactory": instance.engine_factory}
    for key, raw in (("datasource", instance.data_source_params),
                     ("preparator", instance.preparator_params),
                     ("serving", instance.serving_params)):
        stage = _stage_from_json(raw)
        if stage is not None:
            variant[key] = stage
    if instance.algorithms_params:
        variant["algorithms"] = json.loads(instance.algorithms_params)
    return engine.params_from_variant_json(variant)
