"""FastEvalEngine: grid evaluation with shared-prefix memoization.

Counterpart of the JAX package's ``controller/fast_eval.py`` (reference
controller/FastEvalEngine.scala:43, prefix case classes :58-90, caches
:283-310): when a tuning grid varies only algorithm params, the
DataSource read and the Preparator's work are the same for every grid
point, so each prefix runs once. The caches are host dicts keyed by the
canonical params JSON of each prefix."""

from __future__ import annotations

import logging
from typing import Any

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.params import params_to_json
from predictionio_tpu_torch.core.base import BaseEngine, RuntimeContext

log = logging.getLogger(__name__)


def _key(*stage_params) -> str:
    return "|".join(
        f"{name}:{params_to_json(p)}" for name, p in stage_params
    )


class FastEvalEngine(Engine):
    """Drop-in Engine whose batch_eval memoizes DataSource / Preparator /
    Algorithm prefixes across grid points. `compute_counts` counts the
    times each stage ran (reference FastEvalEngineTest counts prefix
    computations)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._ds_cache: dict[str, Any] = {}
        self._prep_cache: dict[str, Any] = {}
        self._algo_cache: dict[str, Any] = {}
        self.compute_counts = {"datasource": 0, "preparator": 0, "algorithms": 0}

    def _eval_sets(self, ctx: RuntimeContext, ep: EngineParams):
        key = _key(ep.data_source_params)
        if key not in self._ds_cache:
            self.compute_counts["datasource"] += 1
            self._ds_cache[key] = self.make_data_source(ep).read_eval(ctx)
        return self._ds_cache[key]

    def _prepared(self, ctx: RuntimeContext, ep: EngineParams):
        key = _key(ep.data_source_params, ep.preparator_params)
        if key not in self._prep_cache:
            self.compute_counts["preparator"] += 1
            preparator = self.make_preparator(ep)
            self._prep_cache[key] = [
                preparator.prepare(ctx, td)
                for td, _ei, _qa in self._eval_sets(ctx, ep)
            ]
        return self._prep_cache[key]

    def _models(self, ctx: RuntimeContext, ep: EngineParams):
        key = _key(
            ep.data_source_params,
            ep.preparator_params,
            *ep.algorithm_params_list,
        )
        if key not in self._algo_cache:
            self.compute_counts["algorithms"] += 1
            algorithms = self.make_algorithms(ep)
            self._algo_cache[key] = [
                [algo.train(ctx, pd) for algo in algorithms]
                for pd in self._prepared(ctx, ep)
            ]
        return self._algo_cache[key]

    def eval(self, ctx: RuntimeContext, engine_params: EngineParams):
        eval_sets = self._eval_sets(ctx, engine_params)
        fold_models = self._models(ctx, engine_params)
        algorithms = self.make_algorithms(engine_params)
        serving = self.make_serving(engine_params)
        results = []
        for (td, ei, qa), models in zip(eval_sets, fold_models):
            supplemented = [
                (qx, serving.supplement(q)) for qx, (q, _a) in enumerate(qa)
            ]
            per_algo = [
                dict(algo.batch_predict(ctx, model, supplemented))
                for algo, model in zip(algorithms, models)
            ]
            qpa = [
                (q, serving.serve(q, [pa[qx] for pa in per_algo]), a)
                for qx, (q, a) in enumerate(qa)
            ]
            results.append((ei, qpa))
        return results

    def batch_eval(self, ctx: RuntimeContext, engine_params_list):
        """Always the memoized per-point path: the base Engine's
        grid-batched route would bypass this class's prefix caches and
        compute_counts contract."""
        return BaseEngine.batch_eval(self, ctx, engine_params_list)

    def clear_caches(self) -> None:
        self._ds_cache.clear()
        self._prep_cache.clear()
        self._algo_cache.clear()
