"""Engines for the port's train-job tests (tests/test_torch_lifecycle.py):
the recommendation template whose data source can stall before it reads
(`sleep_s`, for timeouts, crashes and concurrency) or fail (`error`, a
deterministic train failure). The port's counterpart of the slow and
failing engines of tests/sample_engine.py; the train job's subprocess
imports it by its engineFactory path."""

from __future__ import annotations

import time
from dataclasses import dataclass

from predictionio_tpu_torch.controller import (
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
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
