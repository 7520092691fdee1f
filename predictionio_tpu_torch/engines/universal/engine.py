"""Universal-Recommender engine: multi-event CCO + realtime history.

Counterpart of the JAX package's ``engines/universal/engine.py``
(reference: the ActionML Universal Recommender,
actionml/template-scala-parallel-universal-recommendation).

- ``URDataSource`` reads one EventFrame per indicator event type from
  the event store (the first indicator is the PRIMARY: its targets are
  the item space).
- ``URAlgorithm.train`` computes, per indicator, each item's top
  correlators by CCO + LLR on the device (``models/cco.py``).
- ``URModel`` keeps the correlator tables on the device.
- Serving reads each user's recent history live from the event store
  and scores items by summed LLR over history hits, minus exclusions,
  in one device dispatch per query batch: the history scoring and then
  the hand-written masked top-k kernel.

``UniversalRecommenderEngine`` is the factory an engine.json names, so
the UR trains and deploys by variant too. A model pickles without its
device; deploy binds it to the deploy's device. Not ported:
self-cleaning (``event_window``).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    SanityCheck,
)
from predictionio_tpu_torch.core.base import RuntimeContext
from predictionio_tpu_torch.data.store.bimap import BiMap
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models import cco
from predictionio_tpu_torch.obs import devprof
from predictionio_tpu_torch.utils.bucket import batch_bucket, topk_bucket

log = logging.getLogger(__name__)


@dataclass
class Query:
    user: str
    num: int = 10
    blacklist: Optional[list[str]] = None
    # exclude items the user has already acted on with the primary event
    exclude_seen: bool = True


@dataclass
class ItemScore:
    item: str
    score: float


@dataclass
class PredictedResult:
    item_scores: list[ItemScore] = field(default_factory=list)


@dataclass
class DataSourceParams:
    app_name: str
    # indicator event names, PRIMARY first (UR's eventNames)
    indicators: tuple[str, ...] = ("buy", "view")
    # self-cleaning window: not ported, must stay None
    event_window: Optional[dict] = None


@dataclass
class IndicatorData:
    name: str
    rows: np.ndarray  # user idx
    cols: np.ndarray  # target idx (into its own target vocab)
    target_vocab: BiMap


@dataclass
class TrainingData(SanityCheck):
    indicators: list[IndicatorData]
    n_users: int
    user_vocab: BiMap

    def sanity_check(self) -> None:
        if not self.indicators or len(self.indicators[0].rows) == 0:
            raise ValueError("no primary indicator events found")


class URDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        if params.event_window is not None:
            raise NotImplementedError(
                "self-cleaning (event_window) is not ported yet"
            )
        self.params = params

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        frame = EventStoreFacade(ctx.storage).find_frame(
            app_name=self.params.app_name,
            entity_type="user",
            event_names=list(self.params.indicators),
        )
        inv_frame = frame.target_vocab.inverse()
        indicators = []
        for name in self.params.indicators:
            sub = frame.where_event(name)
            mask = sub.target_idx >= 0
            # each indicator gets its own compact target vocabulary, in
            # the order of the frame's target ids
            raw_targets = sub.target_idx[mask]
            uniq = np.unique(raw_targets)
            vocab = BiMap({inv_frame(int(t)): i for i, t in enumerate(uniq)})
            indicators.append(
                IndicatorData(
                    name=name,
                    rows=sub.entity_idx[mask].astype(np.int32),
                    cols=np.searchsorted(uniq, raw_targets).astype(np.int32),
                    target_vocab=vocab,
                )
            )
        return TrainingData(
            indicators=indicators,
            n_users=frame.n_entities,
            user_vocab=frame.entity_vocab,
        )


# -- algorithm --------------------------------------------------------------


@dataclass
class URAlgorithmParams:
    app_name: str
    max_correlators_per_item: int = 50
    max_query_events: int = 100  # recent history depth per indicator
    indicators: Optional[tuple[str, ...]] = None  # default: all from data


@dataclass
class IndicatorModel:
    name: str
    correlator_scores: np.ndarray  # (I, top_n)
    correlator_idx: np.ndarray  # (I, top_n) into its target vocab, -1 pad
    target_vocab: BiMap


class URModel:
    def __init__(
        self,
        item_vocab: BiMap,
        indicator_models: list[IndicatorModel],
        primary_indicator: str,
        device=None,
    ):
        self.item_vocab = item_vocab  # primary target vocab = item space
        self.indicator_models = indicator_models
        self.primary_indicator = primary_indicator
        self.device = resolve_device(device)
        self._device_tables = None
        self._stage_lock = threading.Lock()

    # the device, the staged tables and the lock are serving state, not
    # the model: an unpickled model has no device until bind_device
    def __getstate__(self):
        return {
            "item_vocab": self.item_vocab,
            "indicator_models": self.indicator_models,
            "primary_indicator": self.primary_indicator,
        }

    def __setstate__(self, state):
        self.item_vocab = state["item_vocab"]
        self.indicator_models = state["indicator_models"]
        self.primary_indicator = state["primary_indicator"]
        self.device = None
        self._device_tables = None
        self._stage_lock = threading.Lock()

    def bind_device(self, device=None) -> None:
        """Serve on `device` (the first CUDA device when None), dropping
        any tables staged elsewhere."""
        with self._stage_lock:
            self.device = resolve_device(device)
            self._device_tables = None

    def device_tables(self) -> list:
        """The correlator tables on the model's device, [(idx int32,
        scores f32, J), ...]: staged once, under the lock, so concurrent
        batches never stage twice."""
        with self._stage_lock:
            if self.device is None:
                raise RuntimeError(
                    "the model has no device: an unpickled model is bound "
                    "by prepare_deploy (URModel.bind_device)"
                )
            if self._device_tables is None:
                self._device_tables = [
                    (
                        torch.tensor(m.correlator_idx, dtype=torch.int32,
                                     device=self.device),
                        torch.tensor(m.correlator_scores, dtype=torch.float32,
                                     device=self.device),
                        len(m.target_vocab),
                    )
                    for m in self.indicator_models
                ]
            return self._device_tables


class URAlgorithm(Algorithm):
    def __init__(self, params: URAlgorithmParams):
        self.params = params

    def train(self, ctx: RuntimeContext, pd: TrainingData) -> URModel:
        """CCO + LLR per kept indicator on the context's device (the
        first CUDA device by default); the model's tables live there."""
        device = resolve_device(ctx.device if ctx is not None else None)
        primary = pd.indicators[0]
        n_items = len(primary.target_vocab)
        p_matrix = cco.edges_to_indicator(
            primary.rows, primary.cols, pd.n_users, n_items, device=device
        )
        wanted = self.params.indicators or tuple(i.name for i in pd.indicators)
        models = []
        for ind in pd.indicators:
            if ind.name not in wanted:
                continue
            if ind.name == primary.name:
                s_matrix = p_matrix
            else:
                s_matrix = cco.edges_to_indicator(
                    ind.rows, ind.cols, pd.n_users, len(ind.target_vocab),
                    device=device,
                )
            scores, idx = cco.cross_occurrence_topn(
                p_matrix,
                s_matrix,
                top_n=self.params.max_correlators_per_item,
                self_indicator=ind.name == primary.name,
            )
            del s_matrix
            models.append(
                IndicatorModel(
                    name=ind.name,
                    correlator_scores=scores,
                    correlator_idx=idx,
                    target_vocab=ind.target_vocab,
                )
            )
        return URModel(
            item_vocab=primary.target_vocab,
            indicator_models=models,
            primary_indicator=primary.name,
            device=device,
        )

    # -- serving -----------------------------------------------------------
    def _user_histories(
        self,
        ctx: RuntimeContext,
        users: list,
        event_name: str,
        target_vocab: BiMap,
    ) -> list:
        """Per-user history rows (newest first, at most
        max_query_events) for a whole micro-batch in one store call."""
        empty = np.empty(0, dtype=np.int64)
        if ctx.storage is None:
            return [empty for _ in users]
        try:
            by_user = EventStoreFacade(ctx.storage).find_by_entities(
                app_name=self.params.app_name,
                entity_type="user",
                entity_ids=users,
                event_names=[event_name],
                limit_per_entity=self.params.max_query_events,
            )
        except Exception:
            log.exception("history lookup failed for %s", event_name)
            return [empty for _ in users]
        out = []
        for u in users:
            rows = []
            for e in by_user.get(u, ()):
                ix = target_vocab.get(e.target_entity_id)
                if ix is not None:
                    rows.append(ix)
            out.append(np.asarray(rows, dtype=np.int64))
        return out

    def warmup(self, model: URModel) -> None:
        """Stage the correlator tables on the device and run the batch
        ladder {1, 8, 64} once, so the first live queries pay neither
        staging nor the kernel build."""
        if not model.indicator_models or len(model.item_vocab) == 0:
            return
        for batch in (1, 8, 64):
            self._predict_batch(
                self.serving_context, model,
                [Query(user="__warmup__")] * batch,
            )

    def _exclusion_width(self) -> int:
        # fixed per params: the seen-history is capped by max_query_events
        # and blacklists get 64 slots; a longer list overflows host-side
        return 1 << (self.params.max_query_events + 64 - 1).bit_length()

    _DISPATCH_CHUNK = 64  # device micro-batch; larger inputs chunk

    def _predict_batch(
        self, ctx: RuntimeContext, model: URModel, queries: list[Query]
    ) -> list[PredictedResult]:
        """One device dispatch per ≤64-query chunk: the host gathers the
        histories from the event store, the device scores every (query,
        item) pair across all indicators, applies each query's exclusion
        set and selects the top k."""
        if len(queries) > self._DISPATCH_CHUNK:
            out: list[PredictedResult] = []
            for lo in range(0, len(queries), self._DISPATCH_CHUNK):
                out.extend(self._predict_batch(
                    ctx, model, queries[lo : lo + self._DISPATCH_CHUNK]
                ))
            return out
        n_real = len(queries)
        n_items = len(model.item_vocab)
        if n_items == 0 or not model.indicator_models:
            return [PredictedResult() for _ in queries]
        bsz = batch_bucket(n_real)
        h_max = self.params.max_query_events

        users = [q.user for q in queries]
        histories = []
        for ind in model.indicator_models:
            h = np.full((bsz, h_max), -1, np.int32)
            per_user = self._user_histories(
                ctx, users, ind.name, ind.target_vocab
            )
            for qi, hist in enumerate(per_user):
                h[qi, : len(hist)] = hist[:h_max]
            histories.append(h)
        # the seen-filter works in the PRIMARY item space, even when the
        # algorithm keeps only secondary indicators
        e_max = self._exclusion_width()
        exclude = np.full((bsz, e_max), -1, np.int32)
        seen_users = [q.user for q in queries if q.exclude_seen]
        seen_by_user = (
            dict(zip(
                seen_users,
                self._user_histories(
                    ctx, seen_users, model.primary_indicator,
                    model.item_vocab,
                ),
            ))
            if seen_users
            else {}
        )
        # exclusions beyond the device width are not dropped: the overflow
        # is filtered host-side after top-k, with k widened to still fill
        # q.num results
        overflow: dict[int, set] = {}
        for qi, q in enumerate(queries):
            ex: list[int] = []
            if q.exclude_seen:
                ex.extend(int(ix) for ix in seen_by_user[q.user])
            for it in q.blacklist or []:
                ix = model.item_vocab.get(it)
                if ix is not None:
                    ex.append(ix)
            if len(ex) > e_max:
                overflow[qi] = set(ex[e_max:])
                log.info(
                    "query exclusion list %d > device width %d: overflow "
                    "filtered host-side", len(ex), e_max,
                )
            exclude[qi, : min(len(ex), e_max)] = ex[:e_max]

        k_req = min(max((q.num for q in queries), default=10), n_items)
        max_over = max((len(s) for s in overflow.values()), default=0)
        k = topk_bucket(min(k_req + max_over, n_items), n_items, floor=64)
        # padding waste at the pad site: n_real live queries ran in a
        # bsz-row call
        prof0 = devprof.snapshot()
        vals, idx = cco.batch_score_topk(
            model.device_tables(), histories, exclude, k
        )
        devprof.record_batch_padding(
            n_real, bsz, flops=devprof.snapshot().flops - prof0.flops)
        inv = model.item_vocab.inverse()
        out = []
        for qi, q in enumerate(queries[:n_real]):
            scores = []
            skip = overflow.get(qi)
            for v, ix in zip(vals[qi], idx[qi]):
                if len(scores) >= q.num:
                    break
                if v <= 0.0:  # positive only: no LLR evidence, or excluded
                    continue
                if skip is not None and int(ix) in skip:
                    continue
                scores.append(ItemScore(item=inv(int(ix)), score=float(v)))
            out.append(PredictedResult(item_scores=scores))
        return out

    def predict(self, model: URModel, query: Query) -> PredictedResult:
        return self._predict_batch(self.serving_context, model, [query])[0]

    def batch_predict(self, ctx, model: URModel, queries):
        preds = self._predict_batch(
            ctx or self.serving_context, model, [q for _, q in queries]
        )
        return [(qx, p) for (qx, _q), p in zip(queries, preds)]


class UniversalRecommenderEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            URDataSource,
            IdentityPreparator,
            {"ur": URAlgorithm},
            FirstServing,
        )
