"""E-commerce recommendation template: ALS with serving-time business
rules read live from the event store.

Counterpart of the JAX package's ``engines/ecommerce/engine.py``
(reference examples/scala-parallel-ecommercerecommendation,
train-with-rate-event/src/main/scala/ALSAlgorithm.scala:153-221).
``ECommerceDataSource`` reads view/buy/rate events (a rate weighs its
rating, the others 1, repeats summed) and each item's ``categories``
from its aggregated $set properties. ``ECommAlgorithm`` trains implicit
ALS on the context's device (``models/als.py``); at every query it reads
the store: the items the user has seen (``unseen_only``), the
``constraint``/``unavailableItems`` entity's ``items`` and, for a user
the model does not know, their 10 latest ``similar_events`` items as
the basis of a cosine answer. Scores rank on the host as in the JAX
package (``models/ranking.py`` ``top_k_filtered``, sparse white and
black lists, category candidates from a lazily built index): the JAX
package has no kernel on this path, so the card's work is the train.

As in the JAX package, a failing store read is logged and the query is
served without that filter.
"""

from __future__ import annotations

import logging
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
from predictionio_tpu_torch.core.base import RuntimeContext
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models import als, ranking

log = logging.getLogger(__name__)


@dataclass
class Query:
    user: str
    num: int = 10
    categories: Optional[list[str]] = None
    whitelist: Optional[list[str]] = None
    blacklist: Optional[list[str]] = None


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
    # the interaction events; the rate event weighs its "rating" property
    # (the train-with-rate-event variant), the others 1.0
    event_names: tuple[str, ...] = ("view", "buy", "rate")
    rate_event: str = "rate"


@dataclass
class TrainingData(SanityCheck):
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    n_users: int
    n_items: int
    user_vocab: object
    item_vocab: object
    item_categories: Optional[list[frozenset]] = None

    def sanity_check(self) -> None:
        if len(self.rows) == 0:
            raise ValueError("no interaction events found")


class ECommerceDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        store = EventStoreFacade(ctx.storage)
        frame = store.find_frame(
            app_name=self.params.app_name,
            entity_type="user",
            target_entity_type="item",
            event_names=list(self.params.event_names),
            value_prop="rating",
            default_value=1.0,
        )
        rate_code = frame.event_vocab.get(self.params.rate_event, -2)
        frame.value = np.where(frame.event_code == rate_code, frame.value,
                               1.0).astype(np.float32)
        rows, cols, vals = frame.interactions(dedupe="sum")
        props = store.aggregate_properties(app_name=self.params.app_name,
                                           entity_type="item")
        cats: Optional[list[frozenset]] = None
        if props:
            cats = [frozenset()] * frame.n_targets
            for item_id, pmap in props.items():
                row = frame.target_vocab.get(item_id)
                if row is not None:
                    cats[row] = frozenset(pmap.get_opt("categories", list) or [])
        return TrainingData(
            rows=rows, cols=cols, vals=vals,
            n_users=frame.n_entities, n_items=frame.n_targets,
            user_vocab=frame.entity_vocab, item_vocab=frame.target_vocab,
            item_categories=cats,
        )


# -- algorithm --------------------------------------------------------------


@dataclass
class ECommAlgorithmParams:
    app_name: str
    unseen_only: bool = False
    seen_events: tuple[str, ...] = ("view", "buy")
    similar_events: tuple[str, ...] = ("view",)  # the unknown user's basis
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 3


class ECommModel:
    """Trained factors and item categories. Pickles both, never its
    device; an unpickled model has no device until `bind_device`."""

    def __init__(self, factors: als.ALSFactors,
                 item_categories: Optional[list[frozenset]], device=None):
        self.factors = factors
        self.item_categories = item_categories
        self.device = resolve_device(device)
        self._normed: Optional[np.ndarray] = None
        self._cat_index: Optional[dict] = None

    def __getstate__(self):
        return {"factors": self.factors, "item_categories": self.item_categories}

    def __setstate__(self, state):
        self.factors = state["factors"]
        self.item_categories = state["item_categories"]
        self.device = None  # bound by the deploy (bind_device)
        self._normed = None
        self._cat_index = None

    def bind_device(self, device=None) -> None:
        """The deploy's device (the first CUDA device when None)."""
        self.device = resolve_device(device)

    def normed_item_factors(self) -> np.ndarray:
        if self._normed is None:
            self._normed = ranking.l2_normalize(self.factors.item_factors)
        return self._normed

    def category_index(self) -> dict:
        """category → sorted item rows, built once: a category filter is a
        union of candidate rows, not a scan of every item."""
        if self._cat_index is None:
            index: dict = {}
            for ix, cats in enumerate(self.item_categories or []):
                for c in cats:
                    index.setdefault(c, []).append(ix)
            self._cat_index = {c: np.asarray(v, dtype=np.int64) for c, v in index.items()}
        return self._cat_index


class ECommAlgorithm(Algorithm):
    def __init__(self, params: ECommAlgorithmParams):
        self.params = params

    def train(self, ctx: Optional[RuntimeContext], pd: TrainingData) -> ECommModel:
        device = ctx.device if ctx is not None else None
        factors = als.train(
            pd.rows, pd.cols, pd.vals, pd.n_users, pd.n_items,
            als.ALSParams(
                rank=self.params.rank,
                iterations=self.params.num_iterations,
                lambda_=self.params.lambda_,
                alpha=self.params.alpha,
                implicit_prefs=True,
                seed=self.params.seed,
            ),
            user_vocab=pd.user_vocab,
            item_vocab=pd.item_vocab,
            device=device,
        )
        return ECommModel(factors, pd.item_categories, device=device)

    # -- serving-time store reads (reference ALSAlgorithm.scala:153) ----------
    def _seen_items(self, ctx: RuntimeContext, user: str) -> set[str]:
        """The items of the user's `seen_events`; empty (logged) when the
        read fails."""
        store = EventStoreFacade(ctx.storage)
        try:
            events = store.find_by_entity(
                app_name=self.params.app_name, entity_type="user",
                entity_id=user, event_names=list(self.params.seen_events),
                target_entity_type="item", limit=None,
            )
            return {e.target_entity_id for e in events if e.target_entity_id}
        except Exception:  # noqa: BLE001 — the JAX package serves unfiltered
            log.exception("seen-items lookup failed; serving unfiltered")
            return set()

    def _unavailable_items(self, ctx: RuntimeContext) -> set[str]:
        """The `items` of the newest state of the constraint entity
        (entityType "constraint", entityId "unavailableItems"), read at
        every query; empty (logged) when the read fails."""
        store = EventStoreFacade(ctx.storage)
        try:
            app_id, _ = store.app_name_to_id(self.params.app_name)
            pmap = ctx.storage.get_events().aggregate_properties_of_entity(
                app_id, "constraint", "unavailableItems")
            if pmap is None:
                return set()
            return set(pmap.get_opt("items", list) or [])
        except Exception:  # noqa: BLE001 — the JAX package serves unfiltered
            log.exception("unavailable-items lookup failed; ignoring")
            return set()

    def _recent_item_rows(self, ctx: RuntimeContext, user: str, model: ECommModel) -> list[int]:
        """An unknown user's basis: the rows of their 10 latest
        `similar_events` items the model knows (reference predictSimilar);
        empty when the read fails."""
        store = EventStoreFacade(ctx.storage)
        try:
            events = store.find_by_entity(
                app_name=self.params.app_name, entity_type="user",
                entity_id=user, event_names=list(self.params.similar_events),
                target_entity_type="item", limit=10, latest=True,
            )
            vocab = model.factors.item_vocab
            return [ix for e in events
                    if (ix := vocab.get(e.target_entity_id)) is not None]
        except Exception:  # noqa: BLE001 — the JAX package serves unfiltered
            log.exception("recent-items lookup failed; no basis")
            return []

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        # the live filters read the store of the serving context, which
        # the deploy sets at build_runtime
        return self.predict_with_ctx(self.serving_context, model, query)

    def batch_predict(self, ctx: RuntimeContext, model: ECommModel, queries):
        """Each query against `ctx`'s store: the deploy server passes its
        serving context, an evaluation its own."""
        return [(qx, self.predict_with_ctx(ctx, model, q)) for qx, q in queries]

    def predict_with_ctx(
        self, ctx: RuntimeContext, model: ECommModel, query: Query
    ) -> PredictedResult:
        vocab = model.factors.item_vocab
        # sparse filters: candidate rows (categories, whitelist) and
        # excluded rows (blacklist, unavailable, seen, the basis)
        include = None
        if query.categories:
            if model.item_categories is None:
                raise ValueError(
                    "query filters by categories but no item category "
                    "properties were found at train time"
                )
            cat_index = model.category_index()
            arrs = [cat_index[c] for c in query.categories if c in cat_index]
            include = np.unique(np.concatenate(arrs)) if arrs else np.empty(0, np.int64)
        if query.whitelist is not None:
            wl = np.asarray([ix for it in query.whitelist
                             if (ix := vocab.get(it)) is not None], dtype=np.int64)
            include = wl if include is None else np.intersect1d(include, wl)
        exclude: list[int] = [ix for it in query.blacklist or []
                              if (ix := vocab.get(it)) is not None]
        if ctx.storage is not None:
            exclude += [ix for it in self._unavailable_items(ctx)
                        if (ix := vocab.get(it)) is not None]
            if self.params.unseen_only:
                exclude += [ix for it in self._seen_items(ctx, query.user)
                            if (ix := vocab.get(it)) is not None]

        user_row = model.factors.user_vocab.get(query.user)
        if user_row is not None:
            scores = model.factors.item_factors @ model.factors.user_factors[user_row]
        else:
            basis = (self._recent_item_rows(ctx, query.user, model)
                     if ctx.storage is not None else [])
            if not basis:
                return PredictedResult()
            normed = model.normed_item_factors()
            scores = normed @ normed[basis].mean(axis=0)
            exclude.extend(basis)  # never the basis items
        inv = vocab.inverse()
        return PredictedResult(item_scores=[
            ItemScore(item=inv(int(ix)), score=float(scores[ix]))
            for ix in ranking.top_k_filtered(scores, query.num, exclude_idx=exclude,
                                             include_idx=include)
        ])


class ECommServing(FirstServing):
    pass


class ECommerceEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            ECommerceDataSource,
            IdentityPreparator,
            {"ecomm": ECommAlgorithm},
            ECommServing,
        )
