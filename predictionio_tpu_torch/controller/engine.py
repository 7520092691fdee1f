"""Engine: binds the DASE class maps, trains, evaluates, and rehydrates
for deploy.

Counterpart of the JAX package's ``controller/engine.py`` (reference
Engine.scala: class:80, train:154, prepareDeploy:196,
makeSerializableModels:283, eval:312, jValueToEngineParams:354;
EngineParams.scala:32, SimpleEngine:127; EngineFactory.scala:28).
Each train stage runs under a span (``train.read``, ``train.prepare``,
``train.train`` with one ``train.algorithm`` a model; ``workflow/core.py``
adds ``train.persist``): its duration is the stage timing written to
``ctx.stage_timings``, and the span recorder's bridge feeds it into the
default registry's ``train_stage_seconds{stage}``. A stage span also
carries the device profiler's work and seconds over the stage and the
kernel builds it paid.

``batch_eval`` trains a tuning grid through the algorithm's
``train_grid`` (one staging per fold) when the grid varies only one
algorithm's params; otherwise it evaluates the points one by one.

Deploy binds every loaded model to the deploy context's device: a model
serves where it is deployed, never where it was trained.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Any, Mapping, Optional, Sequence, Union

from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    ParamsError,
    extract_params,
    params_class_of,
    params_to_json,
)
from predictionio_tpu_torch.controller.persistent import (
    RetrainOnDeploy,
    load_persistent_model,
)
from predictionio_tpu_torch.core.base import (
    BaseEngine,
    PersistentModelManifest,
    RuntimeContext,
    SanityCheck,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    WorkflowParams,
    doer,
)
from predictionio_tpu_torch.obs import cudamon, devprof, get_default_registry
from predictionio_tpu_torch.obs.spans import get_default_recorder, span

log = logging.getLogger(__name__)


def train_stage_histogram():
    """``train_stage_seconds{stage}`` on the process-default registry."""
    return get_default_registry().histogram(
        "train_stage_seconds",
        "train workflow stage durations (read/prepare/train/persist)",
        ("stage",),  # label-bound: literal DASE stage names
    )


def _bridge_train_stage_spans() -> None:
    """The train-stage spans are the one timing source: their durations
    feed train_stage_seconds{stage} through the recorder's bridge."""
    recorder = get_default_recorder()
    for stage in ("read", "prepare", "train", "persist"):
        recorder.bridge(
            f"train.{stage}",
            lambda sp, _s=stage: train_stage_histogram().observe(sp.duration, stage=_s),
        )


_bridge_train_stage_spans()


@contextmanager
def _stage_span(name: str, **attrs):
    """A span that also diffs the device profiler's totals and the
    kernel-build counter across the stage, so the stage's device work,
    seconds and MFU, and the builds it paid, ride on its span."""
    b0 = cudamon.build_snapshot()
    p0 = devprof.snapshot()
    with span(name, **attrs) as sp:
        try:
            yield sp
        finally:
            b1 = cudamon.build_snapshot()
            if b1[0] > b0[0]:
                sp.attrs["kernel_builds"] = b1[0] - b0[0]
                sp.attrs["kernel_build_sec"] = round(b1[1] - b0[1], 4)
            p1 = devprof.snapshot()
            d_flops = p1.flops - p0.flops
            d_bytes = p1.bytes - p0.bytes
            d_secs = p1.device_seconds - p0.device_seconds
            if d_flops > 0 or d_secs > 0:
                sp.attrs["device_flops"] = d_flops
                sp.attrs["device_bytes"] = d_bytes
                sp.attrs["device_seconds"] = round(d_secs, 4)
                u = devprof.mfu(d_flops, d_secs)
                if u is not None:
                    sp.attrs["mfu"] = round(u, 6)
                h = devprof.hbm_fraction(d_bytes, d_secs)
                if h is not None:
                    sp.attrs["hbm_fraction_of_roof"] = round(h, 6)


# a stage binding: one class, or a name → class map
ClassMap = Union[type, Mapping[str, type]]


@dataclass(frozen=True)
class EngineParams:
    """Named (stage-name, params) per stage plus the algorithm list
    (reference EngineParams.scala:32)."""

    data_source_params: tuple[str, Any] = ("", EmptyParams())
    preparator_params: tuple[str, Any] = ("", EmptyParams())
    algorithm_params_list: tuple[tuple[str, Any], ...] = ()
    serving_params: tuple[str, Any] = ("", EmptyParams())

    def copy(self, **kw) -> "EngineParams":
        return replace(self, **kw)


def _select_folds(eval_sets, fold_indices: Optional[Sequence[int]]):
    """The eval sets at `fold_indices` (all of them when None). A fold
    out of range is an error, not an empty evaluation."""
    if fold_indices is None:
        return eval_sets
    sets = list(eval_sets)
    want = sorted({int(i) for i in fold_indices})
    bad = [i for i in want if i < 0 or i >= len(sets)]
    if bad:
        raise ValueError(
            f"fold_indices {bad} out of range: datasource yields "
            f"{len(sets)} eval set(s)"
        )
    return [sets[i] for i in want]


def _as_classmap(cm: ClassMap) -> Mapping[str, type]:
    return cm if isinstance(cm, Mapping) else {"": cm}


def _sanity(obj: Any, what: str, wp: WorkflowParams) -> None:
    if not wp.skip_sanity_check and isinstance(obj, SanityCheck):
        log.info("sanity check %s", what)
        obj.sanity_check()


class Engine(BaseEngine):
    """Binds named class maps for DataSource/Preparator/Algorithms/Serving
    (reference Engine.scala:80)."""

    def __init__(
        self,
        data_source_classmap: ClassMap,
        preparator_classmap: ClassMap,
        algorithm_classmap: ClassMap,
        serving_classmap: ClassMap,
    ):
        self.data_source_classmap = _as_classmap(data_source_classmap)
        self.preparator_classmap = _as_classmap(preparator_classmap)
        self.algorithm_classmap = _as_classmap(algorithm_classmap)
        self.serving_classmap = _as_classmap(serving_classmap)

    # -- stage instantiation ----------------------------------------------
    @staticmethod
    def _stage_class(cm: Mapping[str, type], name: str, stage: str) -> type:
        if name in cm:
            return cm[name]
        raise ParamsError(
            f"{stage} class {name!r} not bound in engine (available: {sorted(cm)})"
        )

    def make_data_source(self, ep: EngineParams):
        name, params = ep.data_source_params
        return doer(self._stage_class(self.data_source_classmap, name, "datasource"), params)

    def make_preparator(self, ep: EngineParams):
        name, params = ep.preparator_params
        return doer(self._stage_class(self.preparator_classmap, name, "preparator"), params)

    def make_algorithms(self, ep: EngineParams) -> list[Any]:
        return [
            doer(self._stage_class(self.algorithm_classmap, name, "algorithm"), params)
            for name, params in ep.algorithm_params_list
        ]

    def make_serving(self, ep: EngineParams):
        name, params = ep.serving_params
        return doer(self._stage_class(self.serving_classmap, name, "serving"), params)

    # -- train (reference Engine.train:154, object Engine.train:622) -------
    def train(self, ctx: RuntimeContext, engine_params: EngineParams) -> list[Any]:
        wp = ctx.workflow_params
        with _stage_span("train.read") as sp:
            data_source = self.make_data_source(engine_params)
            sp.attrs["datasource"] = type(data_source).__name__
            td = data_source.read_training(ctx)
            _sanity(td, "training data", wp)
        ctx.stage_timings["read"] = sp.duration
        if wp.stop_after_read:
            raise StopAfterReadInterruption()

        with _stage_span("train.prepare") as sp:
            preparator = self.make_preparator(engine_params)
            sp.attrs["preparator"] = type(preparator).__name__
            pd = preparator.prepare(ctx, td)
            _sanity(pd, "prepared data", wp)
        ctx.stage_timings["prepare"] = sp.duration
        if wp.stop_after_prepare:
            raise StopAfterPrepareInterruption()

        with _stage_span("train.train") as sp:
            algorithms = self.make_algorithms(engine_params)
            if not algorithms:
                raise ParamsError("engine has no algorithms configured")
            models = []
            for i, algo in enumerate(algorithms):
                with _stage_span("train.algorithm", index=i,
                                 algorithm=type(algo).__name__):
                    model = algo.train(ctx, pd)
                _sanity(model, f"model of algorithm #{i}", wp)
                models.append(model)
        ctx.stage_timings["train"] = sp.duration
        return models

    # -- serializable models (reference makeSerializableModels:283) --------
    def make_serializable_models(
        self,
        ctx: RuntimeContext,
        models: list[Any],
        engine_params: EngineParams,
        instance_id: str,
    ) -> list[Any]:
        algorithms = self.make_algorithms(engine_params)
        return [
            algo.make_persistent_model(
                f"{instance_id}-{i}", model, engine_params.algorithm_params_list[i][1]
            )
            for i, (algo, model) in enumerate(zip(algorithms, models))
        ]

    # -- deploy-time rehydration (reference prepareDeploy:196) -------------
    def prepare_deploy(
        self,
        ctx: RuntimeContext,
        engine_params: EngineParams,
        persisted_models: list[Any],
        instance_id: str = "deploy",
    ) -> list[Any]:
        """The models to serve, on ``ctx.device``: loaded from the blob,
        re-loaded by a PersistentModel's class, or trained again where
        the blob says RetrainOnDeploy (a model of None at train time)."""
        algorithms = self.make_algorithms(engine_params)
        if len(persisted_models) != len(algorithms):
            raise ParamsError(
                f"persisted model count {len(persisted_models)} != "
                f"algorithm count {len(algorithms)}"
            )
        retrained: Optional[list[Any]] = None
        if any(isinstance(m, RetrainOnDeploy) or m is None for m in persisted_models):
            log.info("some models require retrain-on-deploy; running train")
            retrained = self.train(ctx, engine_params)
        out = []
        for i, m in enumerate(persisted_models):
            if isinstance(m, PersistentModelManifest):
                m = load_persistent_model(
                    m, f"{instance_id}-{i}",
                    engine_params.algorithm_params_list[i][1],
                )
            elif isinstance(m, RetrainOnDeploy) or m is None:
                assert retrained is not None
                m = retrained[i]
            bind = getattr(m, "bind_device", None)
            if callable(bind):
                bind(ctx.device)
            out.append(m)
        return out

    # -- eval (reference Engine.eval:312, object Engine.eval:727) ---------
    def eval(
        self,
        ctx: RuntimeContext,
        engine_params: EngineParams,
        fold_indices: Optional[Sequence[int]] = None,
    ) -> list[Any]:
        """Per eval set: prepare, train every algorithm, batch-predict the
        set's queries per algorithm, and serve each query from the
        algorithms' predictions (reference Engine.scala:770-811)."""
        data_source = self.make_data_source(engine_params)
        preparator = self.make_preparator(engine_params)
        algorithms = self.make_algorithms(engine_params)
        serving = self.make_serving(engine_params)
        eval_sets = _select_folds(data_source.read_eval(ctx), fold_indices)
        results = []
        for td, ei, qa in eval_sets:
            pd = preparator.prepare(ctx, td)
            models = [algo.train(ctx, pd) for algo in algorithms]
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

    # -- grid tuning: one staging per fold (the reference's grid is
    # serial, Engine.scala:758-764) -----------------------------------------
    def batch_eval(
        self,
        ctx: RuntimeContext,
        engine_params_list,
        fold_indices: Optional[Sequence[int]] = None,
    ):
        eps = list(engine_params_list)
        if self._grid_batchable(ctx, eps):
            return self._batch_eval_grid(ctx, eps, fold_indices=fold_indices)
        return super().batch_eval(ctx, eps, fold_indices=fold_indices)

    def _grid_batchable(self, ctx: RuntimeContext, eps: list) -> bool:
        """True when the grid has two or more points that differ only in
        the params of one algorithm, under one name, that has
        `train_grid`: then each fold trains every point over one staging.
        (The JAX package also keeps mesh evals serial; the port has no
        mesh.)"""
        if len(eps) < 2:
            return False
        if any(len(ep.algorithm_params_list) != 1 for ep in eps):
            return False
        if len({ep.algorithm_params_list[0][0] for ep in eps}) != 1:
            return False
        algo = self.make_algorithms(eps[0])[0]
        if not callable(getattr(algo, "train_grid", None)):
            return False

        def shared_key(ep):
            return tuple(
                (name, params_to_json(p))
                for name, p in (
                    ep.data_source_params,
                    ep.preparator_params,
                    ep.serving_params,
                )
            )

        key0 = shared_key(eps[0])
        return all(shared_key(ep) == key0 for ep in eps[1:])

    def _batch_eval_grid(
        self,
        ctx: RuntimeContext,
        eps: list,
        fold_indices: Optional[Sequence[int]] = None,
    ):
        ep0 = eps[0]
        data_source = self.make_data_source(ep0)
        preparator = self.make_preparator(ep0)
        serving = self.make_serving(ep0)
        algos = [self.make_algorithms(ep)[0] for ep in eps]
        params_list = [ep.algorithm_params_list[0][1] for ep in eps]
        eval_sets = _select_folds(list(data_source.read_eval(ctx)), fold_indices)
        per_ep: list[list] = [[] for _ in eps]
        for td, ei, qa in eval_sets:
            pd = preparator.prepare(ctx, td)
            models = algos[0].train_grid(ctx, pd, params_list)
            supplemented = [
                (qx, serving.supplement(q)) for qx, (q, _a) in enumerate(qa)
            ]
            for i, model in enumerate(models):
                preds = dict(algos[i].batch_predict(ctx, model, supplemented))
                qpa = [
                    (q, serving.serve(q, [preds[qx]]), a)
                    for qx, (q, a) in enumerate(qa)
                ]
                per_ep[i].append((ei, qpa))
        log.info("grid eval: %d points x %d folds, one train_grid per fold",
                 len(eps), len(eval_sets))
        return list(zip(eps, per_ep))

    # -- engine.json → EngineParams (reference jValueToEngineParams:354) ---
    @staticmethod
    def _resolve_stage_class(cm: Mapping[str, type], name: str, what: str) -> type:
        """Name → class; an unnamed stage resolves to the sole bound class."""
        cls = cm.get(name)
        if cls is None and name == "" and len(cm) == 1:
            cls = next(iter(cm.values()))
        if cls is None:
            raise ParamsError(
                f"variant {what} names {name!r}, not bound (available: {sorted(cm)})"
            )
        return cls

    def params_from_variant_json(self, variant: dict) -> EngineParams:
        def stage(key: str, cm: Mapping[str, type]) -> tuple[str, Any]:
            obj = variant.get(key)
            name, raw = ("", None) if obj is None else (obj.get("name", ""), obj.get("params"))
            cls = self._resolve_stage_class(cm, name, key)
            return name, extract_params(params_class_of(cls), raw)

        ds = stage("datasource", self.data_source_classmap)
        prep = stage("preparator", self.preparator_classmap)
        serv = stage("serving", self.serving_classmap)
        algo_list = []
        for obj in variant.get("algorithms", []):
            name = obj.get("name", "")
            cls = self._resolve_stage_class(self.algorithm_classmap, name, "algorithm")
            algo_list.append((name, extract_params(params_class_of(cls), obj.get("params"))))
        if not algo_list and len(self.algorithm_classmap) == 1:
            # default: the single bound algorithm with default params
            name, cls = next(iter(self.algorithm_classmap.items()))
            algo_list = [(name, extract_params(params_class_of(cls), None))]
        return EngineParams(
            data_source_params=ds,
            preparator_params=prep,
            algorithm_params_list=tuple(algo_list),
            serving_params=serv,
        )


class SimpleEngine(Engine):
    """Single-algorithm engine with identity prep and first serving
    (reference EngineParams.scala SimpleEngine:127)."""

    def __init__(self, data_source_class: type, algorithm_class: type):
        from predictionio_tpu_torch.controller.dase import FirstServing, IdentityPreparator

        super().__init__(data_source_class, IdentityPreparator, algorithm_class, FirstServing)


class EngineFactory:
    """Subclass with `apply()` returning an Engine (reference
    EngineFactory.scala:28); engine.json's engineFactory names it."""

    def apply(self) -> BaseEngine:
        raise NotImplementedError


def resolve_engine(factory: Any) -> BaseEngine:
    """An Engine from an Engine, an EngineFactory class or instance, or a
    callable returning an Engine (reference WorkflowUtils.getEngine:62)."""
    if isinstance(factory, BaseEngine):
        return factory
    if isinstance(factory, type):
        factory = factory()
    if isinstance(factory, EngineFactory):
        return factory.apply()
    if callable(factory):
        result = factory()
        if isinstance(result, BaseEngine):
            return result
    raise ParamsError(f"cannot resolve an Engine from {factory!r}")
