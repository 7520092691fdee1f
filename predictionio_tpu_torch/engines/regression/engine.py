"""Regression engine template: entity properties → numeric prediction.

Counterpart of the JAX package's ``engines/regression/engine.py``
(reference examples/experimental/scala-parallel-regression/Run.scala —
MLlib LinearRegressionWithSGD behind a P2LAlgorithm with k-fold eval, the
MSE metric, LAverageServing, and a custom VectorSerializer for queries).
Entity $set properties fold into one dense (N, D) matrix; ridge
regression takes the normal equations' statistics on the context's
device and solves on the host (``models/linreg.py``); a tuning grid of
l2 values shares one statistics pass (``RidgeAlgorithm.train_grid``).
Prediction is numpy on the host: a model holds no tensor.

The vector-query serializer comes through the algorithm's
``query_serializer`` hook: a bare JSON array ``[x1, x2, ...]`` or
``{"features": [...]}`` is a query, and the answer is the bare predicted
number.

``RegressionAverageServing`` averages the predictions' ``value`` and
answers a ``PredictedResult`` of the mean. The JAX package's class sets
``FIELD = "value"`` but inherits a serve that sums the PredictedResult
objects themselves, which raises TypeError at every query; the port
does not reproduce that.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    AverageServing,
    DataSource,
    Engine,
    EngineFactory,
    IdentityPreparator,
    SanityCheck,
)
from predictionio_tpu_torch.controller.metrics import AverageMetric
from predictionio_tpu_torch.core.base import RuntimeContext
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade
from predictionio_tpu_torch.e2.cross_validation import split_data
from predictionio_tpu_torch.models import linreg


@dataclass
class Query:
    features: list[float] = field(default_factory=list)


@dataclass
class PredictedResult:
    value: float


@dataclass
class ActualResult:
    value: float


def _floats(values) -> list[float]:
    try:
        return [float(v) for v in values]
    except (TypeError, ValueError) as e:
        raise ValueError(f"features must be a list of numbers: {e}") from None


class VectorQuerySerializer:
    """Reference VectorSerializer analogue: accepts `[1.0, 2.0]` (bare
    array) or `{"features": [...]}`; renders the bare predicted value.
    Anything else, features that are not a list of numbers included, is
    a ValueError, which the query server answers with 400 (the JAX
    package's serializer lets a TypeError through, a 500)."""

    def query_from_json(self, parsed) -> Query:
        if isinstance(parsed, list):
            return Query(features=_floats(parsed))
        if isinstance(parsed, dict) and "features" in parsed:
            return Query(features=_floats(parsed["features"]))
        raise ValueError(
            "regression query must be a JSON array or {'features': [...]}"
        )

    def result_to_json(self, prediction):
        if isinstance(prediction, PredictedResult):
            return prediction.value
        return prediction


@dataclass
class DataSourceParams:
    app_name: str
    entity_type: str = "point"
    attrs: tuple[str, ...] = ("x0", "x1", "x2")
    target_attr: str = "y"
    eval_k: int = 0


@dataclass
class TrainingData(SanityCheck):
    features: np.ndarray  # (N, D) float32
    targets: np.ndarray  # (N,) float32

    def sanity_check(self) -> None:
        if len(self.features) == 0:
            raise ValueError("no regression points found")


@dataclass
class EvalInfo:
    fold: int


class RegressionDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read_all(self, ctx: RuntimeContext) -> TrainingData:
        store = EventStoreFacade(ctx.storage)
        props = store.aggregate_properties(
            app_name=self.params.app_name,
            entity_type=self.params.entity_type,
            required=[*self.params.attrs, self.params.target_attr],
        )
        rows, targets = [], []
        for _entity, pmap in sorted(props.items()):
            rows.append(
                [
                    float(pmap.get_opt(a, float) or 0.0)
                    for a in self.params.attrs
                ]
            )
            targets.append(float(pmap.get_opt(self.params.target_attr, float)))
        return TrainingData(
            features=np.asarray(rows, dtype=np.float32),
            targets=np.asarray(targets, dtype=np.float32),
        )

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        return self._read_all(ctx)

    def read_eval(self, ctx: RuntimeContext):
        if self.params.eval_k <= 0:
            raise ValueError("eval requires datasource params eval_k > 0")
        td = self._read_all(ctx)
        idx = list(range(len(td.targets)))
        out = []
        for fold, (train_ix, test_ix) in enumerate(
            split_data(self.params.eval_k, idx)
        ):
            tr = TrainingData(
                features=td.features[train_ix], targets=td.targets[train_ix]
            )
            qa = [
                (
                    Query(features=td.features[i].tolist()),
                    ActualResult(value=float(td.targets[i])),
                )
                for i in test_ix
            ]
            out.append((tr, EvalInfo(fold=fold), qa))
        return out


@dataclass
class RidgeParams:
    l2: float = 1e-6
    fit_intercept: bool = True


@dataclass
class RidgeModel:
    model: linreg.LinearRegressionModel


class RidgeAlgorithm(Algorithm):
    """Closed-form ridge (replaces LinearRegressionWithSGD — same model
    family, exact solution)."""

    def __init__(self, params: RidgeParams):
        self.params = params

    def train(self, ctx: RuntimeContext, pd: TrainingData) -> RidgeModel:
        return RidgeModel(
            model=linreg.train_linear_regression(
                pd.features,
                pd.targets,
                l2=self.params.l2,
                fit_intercept=self.params.fit_intercept,
                device=ctx.device if ctx is not None else None,
            )
        )

    def train_grid(
        self, ctx: RuntimeContext, pd: TrainingData, params_list
    ) -> list[RidgeModel]:
        """The whole l2 grid from one statistics pass; each point trains
        alone when fit_intercept differs across the grid."""
        intercepts = {p.fit_intercept for p in params_list}
        if len(intercepts) != 1:
            # type(self): a subclass's train() override must win here too
            return [type(self)(p).train(ctx, pd) for p in params_list]
        models = linreg.train_linear_regression_grid(
            pd.features, pd.targets,
            [p.l2 for p in params_list],
            fit_intercept=intercepts.pop(),
            device=ctx.device if ctx is not None else None,
        )
        return [RidgeModel(model=m) for m in models]

    def predict(self, model: RidgeModel, query: Query) -> PredictedResult:
        val = float(model.model.predict(np.asarray(query.features))[0])
        return PredictedResult(value=val)

    def batch_predict(self, ctx, model: RidgeModel, queries):
        x = np.asarray([q.features for _, q in queries], dtype=np.float32)
        vals = model.model.predict(x)
        return [
            (qx, PredictedResult(value=float(v)))
            for (qx, _q), v in zip(queries, vals)
        ]

    def query_serializer(self):
        return VectorQuerySerializer()


class RegressionAverageServing(AverageServing):
    """LAverageServing analogue: the mean of the algorithms' predicted
    `FIELD` as a PredictedResult."""

    FIELD = "value"

    def serve(self, query: Query, predictions) -> PredictedResult:
        values = [getattr(p, self.FIELD) for p in predictions]
        return PredictedResult(value=sum(values) / len(values))


class MeanSquareError(AverageMetric):
    """Reference controller MeanSquareError (used by the example's
    Workflow run); lower is better."""

    higher_is_better = False

    def calculate_one(self, q: Query, p: PredictedResult, a: ActualResult):
        return (p.value - a.value) ** 2


class RegressionEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            RegressionDataSource,
            IdentityPreparator,
            {"ridge": RidgeAlgorithm},
            RegressionAverageServing,
        )
