"""Evaluation workflow: the grid's batch eval → the evaluator → an
EvaluationInstance row.

Counterpart of the JAX package's ``workflow/evaluation.py`` (reference
CoreWorkflow.runEvaluation, CoreWorkflow.scala:101-163;
EvaluationWorkflow.runEvaluation, EvaluationWorkflow.scala:29-41). The
JAX mesh becomes a device: the evaluation trains and predicts on the
caller's device (None is the first CUDA device).
"""

from __future__ import annotations

import datetime as _dt
import logging
import time
import uuid
from typing import Any, Optional, Sequence

from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.evaluation import Evaluation
from predictionio_tpu_torch.core.base import RuntimeContext, WorkflowParams
from predictionio_tpu_torch.data.storage.base import EvaluationInstance
from predictionio_tpu_torch.data.storage.registry import Storage

log = logging.getLogger(__name__)


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def run_evaluation(
    storage: Storage,
    evaluation: Evaluation,
    engine_params_list: Optional[Sequence[EngineParams]] = None,
    workflow_params: Optional[WorkflowParams] = None,
    device: Optional[str] = None,
) -> tuple[EvaluationInstance, Any]:
    """Evaluate every grid point on `device` and store the evaluator's
    rendered results: the instance goes INIT → EVALRUNNING →
    EVALCOMPLETED, or EVALABORTED on an error, which is raised again.
    `env` records the batch eval's wall seconds (`eval_wall_sec`) and the
    grid's size (`grid_points`). Returns (the final row, the evaluator's
    result)."""
    wp = workflow_params or WorkflowParams()
    engine = evaluation.get_engine()
    evaluator = evaluation.get_evaluator()
    if engine_params_list is None:
        engine_params_list = getattr(evaluation, "engine_params_list", None)
    if not engine_params_list:
        raise ValueError(
            "no engine params to evaluate — pass engine_params_list or use "
            "an EngineParamsGenerator"
        )

    instances = storage.get_meta_data_evaluation_instances()
    now = _now()
    instance = EvaluationInstance(
        id=str(uuid.uuid4()),
        status="INIT",
        start_time=now,
        end_time=now,
        evaluation_class=type(evaluation).__module__ + "."
        + type(evaluation).__qualname__,
        batch=wp.batch,
    )
    instance.id = instances.insert(instance)

    ctx = RuntimeContext(storage=storage, mode="eval", device=device,
                         workflow_params=wp)
    try:
        instance.status = "EVALRUNNING"
        instances.update(instance)
        eps = list(engine_params_list)  # materialize once (generators)
        t0 = time.perf_counter()
        engine_eval_data = engine.batch_eval(ctx, eps)
        eval_wall = time.perf_counter() - t0
        instance.env = dict(instance.env or {})
        instance.env["eval_wall_sec"] = f"{eval_wall:.3f}"
        instance.env["grid_points"] = str(len(eps))
        result = evaluator.evaluate(ctx, evaluation, engine_eval_data, wp)
        if not getattr(result, "no_save", False):
            instance.evaluator_results = result.to_one_liner()
            instance.evaluator_results_html = result.to_html()
            instance.evaluator_results_json = result.to_json()
        instance.status = "EVALCOMPLETED"
        instance.end_time = _now()
        instances.update(instance)
        log.info("evaluation completed: %s — %s", instance.id,
                 result.to_one_liner())
        return instance, result
    except Exception:
        instance.status = "EVALABORTED"
        instance.end_time = _now()
        instances.update(instance)
        raise
