"""Classification engine template: entity properties → label prediction.

Counterpart of the JAX package's ``engines/classification/engine.py``
(reference examples/scala-parallel-classification, the add-algorithm
and custom-attributes variants). ``ClassificationDataSource`` folds each
entity's $set properties (``aggregate_properties``, the required
attributes and the label) into one dense (N, D) feature matrix and
integer labels over the sorted label vocabulary; ``read_eval`` makes k
folds by entity index (``e2.split_data``). Three algorithms train on the
context's device (``models/classify.py``, ``models/forest.py``):
``naive`` (multinomial naive Bayes, λ smoothing), ``logreg`` (softmax
logistic regression) and ``randomforest``; naive Bayes and logistic
regression train a tuning grid in one pass (``train_grid``). Each model
pickles without a device and scores a batch of queries in one device
call where deploy binds it. ``Accuracy`` is the template's eval metric.
The JAX package's ``mesh=`` is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    SanityCheck,
)
from predictionio_tpu_torch.controller.metrics import AverageMetric
from predictionio_tpu_torch.core.base import RuntimeContext
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade
from predictionio_tpu_torch.e2.cross_validation import split_data
from predictionio_tpu_torch.models import classify, forest


@dataclass
class Query:
    features: list[float] = field(default_factory=list)


@dataclass
class PredictedResult:
    label: str


@dataclass
class ActualResult:
    label: str


@dataclass
class DataSourceParams:
    app_name: str
    entity_type: str = "user"
    attrs: tuple[str, ...] = ("attr0", "attr1", "attr2")
    label_attr: str = "plan"
    eval_k: int = 0


@dataclass
class TrainingData(SanityCheck):
    features: np.ndarray  # (N, D) float32
    labels: np.ndarray  # (N,) int32
    label_vocab: tuple[str, ...]  # class index → label string

    def sanity_check(self) -> None:
        if len(self.features) == 0:
            raise ValueError("no labeled entities found")
        if len(self.label_vocab) < 2:
            raise ValueError(
                f"need ≥2 classes, found {list(self.label_vocab)}"
            )


@dataclass
class EvalInfo:
    fold: int


class ClassificationDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read_all(self, ctx: RuntimeContext) -> TrainingData:
        store = EventStoreFacade(ctx.storage)
        props = store.aggregate_properties(
            app_name=self.params.app_name,
            entity_type=self.params.entity_type,
            required=[*self.params.attrs, self.params.label_attr],
        )
        rows = []
        labels = []
        for _entity, pmap in sorted(props.items()):
            rows.append(
                [float(pmap.get_opt(a, float) or 0.0) for a in self.params.attrs]
            )
            labels.append(str(pmap.get_opt(self.params.label_attr, str)))
        vocab = tuple(sorted(set(labels)))
        index = {lb: i for i, lb in enumerate(vocab)}
        return TrainingData(
            features=np.asarray(rows, dtype=np.float32),
            labels=np.asarray([index[lb] for lb in labels], dtype=np.int32),
            label_vocab=vocab,
        )

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        return self._read_all(ctx)

    def read_eval(self, ctx: RuntimeContext):
        if self.params.eval_k <= 0:
            raise ValueError("eval requires datasource params eval_k > 0")
        td = self._read_all(ctx)
        idx = list(range(len(td.labels)))
        out = []
        for fold, (train_ix, test_ix) in enumerate(
            split_data(self.params.eval_k, idx)
        ):
            tr = TrainingData(
                features=td.features[train_ix],
                labels=td.labels[train_ix],
                label_vocab=td.label_vocab,
            )
            qa = [
                (
                    Query(features=td.features[i].tolist()),
                    ActualResult(label=td.label_vocab[td.labels[i]]),
                )
                for i in test_ix
            ]
            out.append((tr, EvalInfo(fold=fold), qa))
        return out


# -- algorithms -------------------------------------------------------------


def _device(ctx: Optional[RuntimeContext]):
    return ctx.device if ctx is not None else None


@dataclass
class _LabelModel:
    """A model of models/ and the label vocabulary its class indices
    name; deploy binds it to its device."""

    model: classify.DeviceModel
    label_vocab: tuple[str, ...]

    @property
    def device(self):
        return self.model.device

    def bind_device(self, device=None) -> None:
        self.model.bind_device(device)


class NBModel(_LabelModel):
    pass


class LRModel(_LabelModel):
    pass


class RFModel(_LabelModel):
    pass


class _LabelAlgorithm(Algorithm):
    """Prediction shared by the three algorithms: the model's argmax
    class, one device call for a batch."""

    def predict(self, model: _LabelModel, query: Query) -> PredictedResult:
        cls = int(model.model.predict(np.asarray(query.features))[0])
        return PredictedResult(label=model.label_vocab[cls])

    def batch_predict(self, ctx, model: _LabelModel, queries):
        x = np.asarray([q.features for _, q in queries], dtype=np.float32)
        classes = model.model.predict(x)
        return [
            (qx, PredictedResult(label=model.label_vocab[int(c)]))
            for (qx, _q), c in zip(queries, classes)
        ]

    def warmup(self, model: _LabelModel) -> None:
        """Stage the model on its device and score one row, so that the
        first live query pays neither."""
        model.model.predict(np.zeros((1, model.model.n_features), np.float32))


@dataclass
class NaiveBayesParams:
    lambda_: float = 1.0


class NaiveBayesAlgorithm(_LabelAlgorithm):
    """Reference NaiveBayesAlgorithm.scala (MLlib NB, lambda smoothing)."""

    def __init__(self, params: NaiveBayesParams):
        self.params = params

    def train(self, ctx: RuntimeContext, pd: TrainingData) -> NBModel:
        return NBModel(
            model=classify.train_naive_bayes(
                pd.features, pd.labels, len(pd.label_vocab),
                self.params.lambda_, device=_device(ctx),
            ),
            label_vocab=pd.label_vocab,
        )

    def train_grid(
        self, ctx: RuntimeContext, pd: TrainingData, params_list
    ) -> list[NBModel]:
        """The whole smoothing grid over one label-sum pass
        (``Engine.batch_eval``'s grid path)."""
        models = classify.train_naive_bayes_grid(
            pd.features, pd.labels, len(pd.label_vocab),
            [p.lambda_ for p in params_list], device=_device(ctx),
        )
        return [NBModel(model=m, label_vocab=pd.label_vocab) for m in models]


@dataclass
class LogisticRegressionParams:
    iterations: int = 200
    lr: float = 0.5
    l2: float = 1e-4


class LogisticRegressionAlgorithm(_LabelAlgorithm):
    """The template's second algorithm: softmax logistic regression."""

    def __init__(self, params: LogisticRegressionParams):
        self.params = params

    def train(self, ctx: RuntimeContext, pd: TrainingData) -> LRModel:
        return LRModel(
            model=classify.train_logistic_regression(
                pd.features,
                pd.labels,
                len(pd.label_vocab),
                iterations=self.params.iterations,
                lr=self.params.lr,
                l2=self.params.l2,
                device=_device(ctx),
            ),
            label_vocab=pd.label_vocab,
        )

    def train_grid(
        self, ctx: RuntimeContext, pd: TrainingData, params_list
    ) -> list[LRModel]:
        """The whole (lr, l2) grid as one batched gradient loop; the
        points must share `iterations` (else each point trains alone)."""
        iterations = {p.iterations for p in params_list}
        if len(iterations) != 1:
            # type(self): a subclass's train() override must win here too
            return [type(self)(p).train(ctx, pd) for p in params_list]
        models = classify.train_logistic_regression_grid(
            pd.features, pd.labels, len(pd.label_vocab),
            [(p.lr, p.l2) for p in params_list],
            iterations=iterations.pop(), device=_device(ctx),
        )
        return [LRModel(model=m, label_vocab=pd.label_vocab) for m in models]


@dataclass
class RandomForestParams:
    """Reference RandomForestAlgoParams (RandomForestAlgorithm.scala:17-24:
    numTrees/maxDepth/maxBins; featureSubsetStrategy="auto" →
    feature_fraction=None)."""

    num_trees: int = 20
    max_depth: int = 6
    max_bins: int = 32
    feature_fraction: Optional[float] = None
    seed: int = 42


class RandomForestAlgorithm(_LabelAlgorithm):
    """Histogram random forest (models/forest.py), the add-algorithm
    variant's second MLlib algorithm."""

    def __init__(self, params: RandomForestParams):
        self.params = params

    def train(self, ctx: RuntimeContext, pd: TrainingData) -> RFModel:
        return RFModel(
            model=forest.train_random_forest(
                pd.features,
                pd.labels,
                len(pd.label_vocab),
                n_trees=self.params.num_trees,
                max_depth=self.params.max_depth,
                n_bins=self.params.max_bins,
                feature_fraction=self.params.feature_fraction,
                seed=self.params.seed,
                device=_device(ctx),
            ),
            label_vocab=pd.label_vocab,
        )


# -- evaluation -------------------------------------------------------------


class Accuracy(AverageMetric):
    """Fraction of correct label predictions (the template's quickstart
    eval metric)."""

    def calculate_one(self, q: Query, p: PredictedResult, a: ActualResult):
        return 1.0 if p.label == a.label else 0.0


# -- engine factory ---------------------------------------------------------


class ClassificationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            ClassificationDataSource,
            IdentityPreparator,
            {
                "naive": NaiveBayesAlgorithm,
                "logreg": LogisticRegressionAlgorithm,
                "randomforest": RandomForestAlgorithm,
            },
            FirstServing,
        )
