"""Typeless DASE runtime base: the layer every engine builds on.

Counterpart of the JAX package's ``core/base.py`` (reference
BaseDataSource.scala:31, BasePreparator.scala:30, BaseAlgorithm.scala:55,
BaseServing.scala:28, BaseEngine.scala:35, AbstractDoer.scala:32).

The ambient handle every stage gets is a ``RuntimeContext``: the storage
to read events from, the mode, and the device to train and serve on
(None means the first CUDA device, ``device.resolve_device``). The
evaluator bases and ``BaseEngine``'s eval half (reference
BaseEvaluator.scala:36, BaseEngine.scala:62-81) are here, and the
algorithm's query serializer hook; the JAX mesh is not ported.
"""

from __future__ import annotations

import inspect
import typing
from dataclasses import dataclass, field
from typing import Any, Generic, Optional, Sequence, TypeVar

TD = TypeVar("TD")  # training data
EI = TypeVar("EI")  # eval info
PD = TypeVar("PD")  # prepared data
M = TypeVar("M")  # model
Q = TypeVar("Q")  # query
P = TypeVar("P")  # predicted result
A = TypeVar("A")  # actual result
R = TypeVar("R")  # evaluator result


@dataclass
class WorkflowParams:
    """Reference WorkflowParams.scala:29. The JAX package's profiler
    directory is not ported."""

    batch: str = ""
    verbose: int = 2
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False


@dataclass
class RuntimeContext:
    storage: Any = None  # data.storage.registry.Storage
    mode: str = "train"  # train | eval | serve
    device: Optional[str] = None
    workflow_params: WorkflowParams = field(default_factory=WorkflowParams)
    # the EngineInstance id of the current train run ("" outside train
    # workflows)
    instance_id: str = ""
    # per-stage wall-clock seconds (read/prepare/train/persist), filled
    # by Engine.train and run_train, recorded on the EngineInstance row
    stage_timings: dict = field(default_factory=dict)

    @property
    def is_serving(self) -> bool:
        return self.mode == "serve"


class SanityCheck:
    """Opt-in data validation hook the train workflow calls on training
    data, prepared data and models (reference SanityCheck.scala)."""

    def sanity_check(self) -> None:
        raise NotImplementedError


class StopAfterReadInterruption(Exception):
    """Debug stop-point: --stop-after-read (reference Engine.scala:663)."""


class StopAfterPrepareInterruption(Exception):
    """Debug stop-point: --stop-after-prepare (reference Engine.scala:684)."""


@dataclass(frozen=True)
class PersistentModelManifest:
    """Marker stored in the serialized model list for models persisted by
    the user's own PersistentModel.save."""

    class_name: str


def doer(cls: type, params: Any) -> Any:
    """Instantiate a controller class: with its params when the
    constructor declares one, else zero-arg (reference Doer.apply,
    AbstractDoer.scala:32-66). A first positional parameter annotated as
    a params dataclass, or any required positional, receives the params
    object."""
    from predictionio_tpu_torch.controller.params import params_class_of

    if params_class_of(cls) is not None:
        return cls(params)
    try:
        sig = inspect.signature(cls.__init__)
    except (TypeError, ValueError):
        return cls()
    n_required = sum(
        1
        for name, p in sig.parameters.items()
        if name != "self"
        and p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY)
        and p.default is p.empty
    )
    return cls(params) if n_required >= 1 else cls()


class BaseDataSource(Generic[TD, EI, Q, A]):
    """Reference BaseDataSource.scala:31-52."""

    def read_training(self, ctx: RuntimeContext) -> TD:
        raise NotImplementedError

    def read_eval(self, ctx: RuntimeContext) -> list:
        """Eval sets: (training data, eval info, [(query, actual)])."""
        return []


class BasePreparator(Generic[TD, PD]):
    """Reference BasePreparator.scala:30-42."""

    def prepare(self, ctx: RuntimeContext, td: TD) -> PD:
        raise NotImplementedError


class BaseAlgorithm(Generic[PD, M, Q, P]):
    """Reference BaseAlgorithm.scala:55-123."""

    # serving-time context set by the deploy runtime so predict() can
    # read the event store live and knows its device
    _serving_ctx: Optional[RuntimeContext] = None

    def set_serving_context(self, ctx: RuntimeContext) -> None:
        self._serving_ctx = ctx

    @property
    def serving_context(self) -> RuntimeContext:
        return (self._serving_ctx if self._serving_ctx is not None
                else RuntimeContext(mode="serve"))

    def train(self, ctx: RuntimeContext, pd: PD) -> M:
        raise NotImplementedError

    def predict(self, model: M, query: Q) -> P:
        raise NotImplementedError

    def batch_predict(
        self, ctx: RuntimeContext, model: M, queries: list[tuple[int, Q]]
    ) -> list[tuple[int, P]]:
        """Default: `predict` per query; algorithms override to batch
        queries into one device call."""
        return [(qx, self.predict(model, q)) for qx, q in queries]

    def query_serializer(self) -> Optional[Any]:
        """Optional custom query/result serde (reference
        CustomQuerySerializer.scala: `querySerializer` formats attached to
        an algorithm, e.g. the regression example's VectorSerializer).
        Return an object with `query_from_json(parsed_json) -> Q` and/or
        `result_to_json(prediction) -> jsonable`; either may be absent.
        When the first algorithm has one, the query server hands it the
        raw parsed JSON (not necessarily an object) instead of the strict
        dataclass extraction."""
        return None

    def query_class(self) -> Optional[type]:
        """The query type for JSON extraction: the `query` annotation of
        `predict` (reference BaseAlgorithm.queryClass)."""
        try:
            ann = typing.get_type_hints(self.predict).get("query")
        except (TypeError, ValueError, NameError):
            return None
        return ann if isinstance(ann, type) else None

    def make_persistent_model(self, model_id: str, model: M, params: Any) -> Any:
        """The persistence mode of a trained model (reference
        BaseAlgorithm.makePersistentModel:96-112): a model that saves
        itself stores a manifest; any other model is pickled into
        MODELDATA as it is (``controller.persistent.serialize_models``)."""
        save = getattr(model, "save", None)
        if callable(save) and getattr(model, "PERSISTENT", False):
            if save(model_id, params):
                return PersistentModelManifest(
                    class_name=type(model).__module__ + "."
                    + type(model).__qualname__
                )
        return model


class BaseServing(Generic[Q, P]):
    """Reference BaseServing.scala:28-51."""

    def supplement(self, query: Q) -> Q:
        return query

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        raise NotImplementedError


class BaseEvaluatorResult:
    """Reference BaseEvaluator.scala:55-72."""

    no_save: bool = False

    def to_one_liner(self) -> str:
        return ""

    def to_html(self) -> str:
        return ""

    def to_json(self) -> str:
        return ""


class BaseEvaluator(Generic[EI, Q, P, A, R]):
    """Reference BaseEvaluator.scala:36-53."""

    def evaluate(
        self,
        ctx: RuntimeContext,
        evaluation: Any,
        engine_eval_data_set: list[
            tuple[Any, list[tuple[EI, list[tuple[Q, P, A]]]]]
        ],
        params: WorkflowParams,
    ) -> R:
        raise NotImplementedError


class BaseEngine(Generic[EI, Q, P, A]):
    """Reference BaseEngine.scala:35-100."""

    def train(self, ctx: RuntimeContext, engine_params: Any) -> list[Any]:
        raise NotImplementedError

    def eval(
        self, ctx: RuntimeContext, engine_params: Any
    ) -> list[tuple[EI, list[tuple[Q, P, A]]]]:
        """[(eval info, [(query, predicted, actual)])] per eval set; the
        workflow settings come from ctx.workflow_params."""
        raise NotImplementedError

    def batch_eval(
        self,
        ctx: RuntimeContext,
        engine_params_list: Sequence[Any],
        fold_indices: Optional[Sequence[int]] = None,
    ) -> list[tuple[Any, list[tuple[EI, list[tuple[Q, P, A]]]]]]:
        """`eval` over the params grid (reference BaseEngine.batchEval:81).
        `fold_indices` restricts the evaluation to a subset of the data
        source's eval sets; it is forwarded only when set, so an `eval`
        override without the parameter keeps working."""
        if fold_indices is None:
            return [(ep, self.eval(ctx, ep)) for ep in engine_params_list]
        return [
            (ep, self.eval(ctx, ep, fold_indices=fold_indices))
            for ep in engine_params_list
        ]

    def params_from_variant_json(self, variant: dict) -> Any:
        raise NotImplementedError
