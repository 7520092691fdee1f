"""Evaluation wiring and the MetricEvaluator (grid search over
EngineParams).

Counterpart of the JAX package's ``controller/evaluation.py`` (reference
controller/Evaluation.scala:31-122: an engine and a metric, or a whole
evaluator; MetricEvaluator.scala:113-260: the primary and other metrics
per grid point, the best by the metric's ordering, best.json through
saveEngineJson:190; EngineParamsGenerator.scala:27)."""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.metrics import Metric
from predictionio_tpu_torch.controller.params import params_to_json
from predictionio_tpu_torch.core.base import (
    BaseEngine,
    BaseEvaluator,
    BaseEvaluatorResult,
    RuntimeContext,
    WorkflowParams,
)

log = logging.getLogger(__name__)


@dataclass
class MetricScores:
    """One grid point's outcome (reference MetricEvaluator.scala case class)."""

    engine_params: EngineParams
    score: Any
    other_scores: list[Any] = field(default_factory=list)


class MetricEvaluatorResult(BaseEvaluatorResult):
    """Reference MetricEvaluator.scala:113 result rendering."""

    def __init__(
        self,
        best_score: MetricScores,
        best_index: int,
        metric_header: str,
        other_metric_headers: list[str],
        engine_params_scores: list[MetricScores],
    ):
        self.best_score = best_score
        self.best_index = best_index
        self.metric_header = metric_header
        self.other_metric_headers = other_metric_headers
        self.engine_params_scores = engine_params_scores

    def to_one_liner(self) -> str:
        return f"[{self.metric_header}] best: {self.best_score.score}"

    def _params_dict(self, ep: EngineParams) -> dict:
        return {
            "datasource": json.loads(params_to_json(ep.data_source_params[1])),
            "preparator": json.loads(params_to_json(ep.preparator_params[1])),
            "algorithms": [
                {"name": n, "params": json.loads(params_to_json(p))}
                for n, p in ep.algorithm_params_list
            ],
            "serving": json.loads(params_to_json(ep.serving_params[1])),
        }

    def to_json(self) -> str:
        return json.dumps(
            {
                "metric": self.metric_header,
                "otherMetrics": self.other_metric_headers,
                "bestScore": self.best_score.score,
                "bestIndex": self.best_index,
                "bestEngineParams": self._params_dict(
                    self.best_score.engine_params
                ),
                "scores": [
                    {
                        "score": s.score,
                        "otherScores": s.other_scores,
                        "engineParams": self._params_dict(s.engine_params),
                    }
                    for s in self.engine_params_scores
                ],
            }
        )

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{s.score}</td><td>{s.other_scores}</td>"
            f"<td><code>{self._params_dict(s.engine_params)}</code></td></tr>"
            for s in self.engine_params_scores
        )
        return (
            f"<h2>{self.metric_header}</h2>"
            f"<p>best: {self.best_score.score} (variant #{self.best_index})</p>"
            f"<table><tr><th>score</th><th>others</th><th>params</th></tr>"
            f"{rows}</table>"
        )


class MetricEvaluator(BaseEvaluator):
    """Score every grid point with the primary metric (+ others), keep the
    best (reference MetricEvaluator.scala:215 evaluateBase)."""

    def __init__(
        self,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: Optional[str] = None,
    ):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path  # best.json target (reference :190)

    def evaluate(
        self,
        ctx: RuntimeContext,
        evaluation: Any,
        engine_eval_data_set: list[tuple[EngineParams, list]],
        params: WorkflowParams,
    ) -> MetricEvaluatorResult:
        if not engine_eval_data_set:
            raise ValueError(
                "MetricEvaluator.evaluate: empty engine_eval_data_set — "
                "the tuning grid produced no (EngineParams, eval data) "
                "pairs; check the EngineParamsGenerator"
            )
        scores: list[MetricScores] = []
        for ep, eval_data in engine_eval_data_set:
            score = self.metric.calculate(ctx, eval_data)
            others = [m.calculate(ctx, eval_data) for m in self.other_metrics]
            log.info("metric %s = %s for %s", self.metric.header(), score, ep)
            scores.append(MetricScores(ep, score, others))
        best_index = 0
        for i, s in enumerate(scores):
            if self.metric.compare(s.score, scores[best_index].score) > 0:
                best_index = i
        result = MetricEvaluatorResult(
            best_score=scores[best_index],
            best_index=best_index,
            metric_header=self.metric.header(),
            other_metric_headers=[m.header() for m in self.other_metrics],
            engine_params_scores=scores,
        )
        if self.output_path:
            self.save_best_engine_json(result)
        return result

    def save_best_engine_json(self, result: MetricEvaluatorResult) -> None:
        """Write the winning params as an engine-variant fragment
        (reference saveEngineJson → best.json, MetricEvaluator.scala:190)."""
        assert self.output_path is not None
        with open(self.output_path, "w") as f:
            json.dump(
                result._params_dict(result.best_score.engine_params), f, indent=2
            )
        log.info("best engine params written to %s", self.output_path)


class EngineParamsGenerator:
    """Holds the tuning grid (reference EngineParamsGenerator.scala:27).
    Subclass and set `engine_params_list`."""

    engine_params_list: Sequence[EngineParams] = ()


class Evaluation:
    """Binds an engine to an evaluator (reference Evaluation.scala:31).
    Subclass and set `engine` + one of: `metric` (+ `metrics`), or a full
    `evaluator`."""

    engine: Optional[BaseEngine] = None
    metric: Optional[Metric] = None
    metrics: Sequence[Metric] = ()
    evaluator: Optional[BaseEvaluator] = None
    output_path: Optional[str] = None

    def get_evaluator(self) -> BaseEvaluator:
        if self.evaluator is not None:
            return self.evaluator
        if self.metric is None:
            raise ValueError(
                "Evaluation must define `metric` (or a full `evaluator`)"
            )
        return MetricEvaluator(
            self.metric, list(self.metrics), output_path=self.output_path
        )

    def get_engine(self) -> BaseEngine:
        if self.engine is None:
            raise ValueError("Evaluation must define `engine`")
        return self.engine
