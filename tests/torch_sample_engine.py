"""Engines for the port's train-job and fleet-evaluation tests
(tests/test_torch_lifecycle.py, tests/test_torch_evalfleet.py): the
recommendation template whose data source can stall before it reads
(`sleep_s`, for timeouts, crashes and concurrency) or fail (`error`, a
deterministic train failure), and the grid engine of
tests/sample_engine.py (folds, a `train_grid` that stamps how many
points shared it, a score peaked at weight 0.37). The port's
counterparts of tests/sample_engine.py's engines; the job subprocesses
import them by their engineFactory paths."""

from __future__ import annotations

import time
from dataclasses import dataclass

from predictionio_tpu_torch.controller import (
    Algorithm,
    AverageMetric,
    DataSource,
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    Preparator,
)
from predictionio_tpu_torch.engines.recommendation.engine import (
    ALSAlgorithm,
    DataSourceParams,
    RecommendationDataSource,
)


@dataclass
class SlowDataSourceParams(DataSourceParams):
    sleep_s: float = 0.0
    error: bool = False


class SlowDataSource(RecommendationDataSource):
    def __init__(self, params: SlowDataSourceParams):
        super().__init__(params)

    def read_training(self, ctx):
        if self.params.error:
            raise ValueError(f"training data of {self.params.app_name} is dirty")
        print(f"data source sleeping {self.params.sleep_s} s", flush=True)
        time.sleep(self.params.sleep_s)
        return super().read_training(ctx)


class SlowRecommendationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(SlowDataSource, IdentityPreparator, {"als": ALSAlgorithm},
                      FirstServing)


# -- the grid engine (tests/sample_engine.py's GridEngineFactory) -------------


@dataclass
class GridTrainingData:
    id: int


@dataclass
class GridPrepared:
    td_id: int


@dataclass
class GridEvalInfo:
    id: int


@dataclass
class GridQuery:
    q: int


@dataclass
class GridActual:
    q: int


@dataclass
class GridDSP:
    folds: int = 2
    queries: int = 4
    sleep_s: float = 0.0  # a stall inside read_eval: a kill lands mid-shard


class GridDataSource(DataSource):
    def __init__(self, params: GridDSP):
        self.params = params

    def read_training(self, ctx):
        return GridTrainingData(id=0)

    def read_eval(self, ctx):
        if self.params.sleep_s:
            time.sleep(self.params.sleep_s)
        return [(GridTrainingData(id=f), GridEvalInfo(id=f),
                 [(GridQuery(q=100 * f + i), GridActual(q=100 * f + i))
                  for i in range(self.params.queries)])
                for f in range(self.params.folds)]


@dataclass
class GridPP:
    id: int = 0


class GridPreparator(Preparator):
    def __init__(self, params: GridPP):
        self.params = params

    def prepare(self, ctx, td):
        return GridPrepared(td_id=td.id)


@dataclass
class GridAP:
    weight: float = 0.0
    train_cost_s: float = 0.0


@dataclass
class GridModel:
    weight: float
    td_id: int
    grid_size: int = 1  # points trained in the same train_grid call


@dataclass
class GridPrediction:
    q: int
    score: float
    grid_size: int


class GridAlgo(Algorithm):
    BEST_WEIGHT = 0.37

    def __init__(self, params: GridAP):
        self.params = params

    def train(self, ctx, pd):
        time.sleep(self.params.train_cost_s)
        return GridModel(self.params.weight, pd.td_id, 1)

    def train_grid(self, ctx, pd, params_list):
        time.sleep(max(p.train_cost_s for p in params_list))
        return [GridModel(p.weight, pd.td_id, len(params_list)) for p in params_list]

    def predict(self, model, query):
        return GridPrediction(q=query.q, score=1.0 - abs(model.weight - self.BEST_WEIGHT),
                              grid_size=model.grid_size)


class GridScore(AverageMetric):
    def header(self):
        return "GridScore"

    def calculate_one(self, q, p, a):
        return p.score


class GridEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return Engine(GridDataSource, GridPreparator, {"grid": GridAlgo}, FirstServing)
