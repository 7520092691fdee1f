"""Similar-product engine template: item-item similarity on ALS factors.

Counterpart of the JAX package's ``engines/similarproduct/engine.py``
(reference examples/scala-parallel-similarproduct, the `multi` variant
included). ``SimilarProductDataSource`` reads view events (weight 1,
repeats summed) and like/dislike events (+1 / -1, the latest of a pair
wins). ``ALSSimilarAlgorithm`` trains implicit ALS on the views,
``LikeAlgorithm`` on the signed likes, both on the context's device
(``models/als.py``). A query's answer is the cosine top-N against the
mean of its known items' normalized vectors, the query items, the
blacklist and everything off the whitelist excluded; ``SumScoreServing``
sums the algorithms' scores per item.

Serving: the model stages its item slab on its device
(``als.stage_item_serving``) and each query is one call of the fused
score+top-k selector with the items' inverse norms as scales
(``als.similar_vectors_serving``, one `recommend_select` launch pair a
query an algorithm on the card); the scores are multiplied back by the
query vector's norm, so they equal the host formula
`normed @ mean(normed[known])`. Only a model on the CPU at
``serve_dtype`` "f32" ranks on the host (``models/ranking.py``), as the
JAX package does where no kernel runs. Sharded serving is not ported: a
variant with ``shard_serving`` true is refused.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    ParamsError,
    SanityCheck,
    Serving,
)
from predictionio_tpu_torch.core.base import RuntimeContext
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models import als, ranking
from predictionio_tpu_torch.ops.topk import NEG_INF


@dataclass
class Query:
    items: list[str] = field(default_factory=list)
    num: int = 10
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
    view_event: str = "view"
    like_event: str = "like"
    dislike_event: str = "dislike"


@dataclass
class TrainingData(SanityCheck):
    # view interactions
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    # like/dislike interactions (+1 / -1) for LikeAlgorithm
    like_rows: np.ndarray
    like_cols: np.ndarray
    like_vals: np.ndarray
    n_users: int
    n_items: int
    user_vocab: object
    item_vocab: object

    def sanity_check(self) -> None:
        if len(self.rows) == 0 and len(self.like_rows) == 0:
            raise ValueError("no view or like/dislike events found")


class SimilarProductDataSource(DataSource):
    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        p = self.params
        frame = EventStoreFacade(ctx.storage).find_frame(
            app_name=p.app_name,
            entity_type="user",
            target_entity_type="item",
            event_names=[p.view_event, p.like_event, p.dislike_event],
        )
        v_rows, v_cols, v_vals = frame.where_event(p.view_event).interactions(dedupe="sum")
        likes = frame.where_event(p.like_event, p.dislike_event)
        like_code = frame.event_vocab.get(p.like_event, -2)
        # like = +1, dislike = -1; the latest event of a pair wins
        # (reference LikeAlgorithm keeps a pair's most recent rating)
        signed = np.where(likes.event_code == like_code, 1.0, -1.0).astype(np.float32)
        l_rows, l_cols, l_vals = dataclasses.replace(likes, value=signed).interactions(
            dedupe="last")
        return TrainingData(
            rows=v_rows, cols=v_cols, vals=v_vals,
            like_rows=l_rows, like_cols=l_cols, like_vals=l_vals,
            n_users=frame.n_entities, n_items=frame.n_targets,
            user_vocab=frame.entity_vocab, item_vocab=frame.target_vocab,
        )


# -- algorithms -------------------------------------------------------------


@dataclass
class ALSSimilarParams:
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    # the JAX package's sharded basket cosine; not ported: true is refused
    shard_serving: bool = False
    # the item slab's serving dtype: "f32" scores exactly, "bf16" and
    # "int8" (per-row quantized) shift scores by their rounding
    serve_dtype: str = "f32"

    def __post_init__(self):
        if self.shard_serving:
            raise ParamsError(
                "ALSSimilarParams.shard_serving is not ported yet to the "
                "PyTorch port; leave it false"
            )


class SimilarModel:
    """Item factors + vocabularies, and the item slab staged on the
    model's device for serving.

    Pickles its factors and serving dtype, never its device or staged
    state; an unpickled model has no device until `bind_device` gives it
    the deploy's."""

    def __init__(self, factors: als.ALSFactors, serve_dtype: str = "f32", device=None):
        self.factors = factors
        self.serve_dtype = serve_dtype
        self.device = resolve_device(device)
        self._normed: Optional[np.ndarray] = None
        self._serving_state: Optional[als.ServingFactors] = None
        self._stage_lock = threading.Lock()

    def __getstate__(self):
        return {"factors": self.factors, "serve_dtype": self.serve_dtype}

    def __setstate__(self, state):
        self.factors = state["factors"]
        self.serve_dtype = state.get("serve_dtype", "f32")
        self.device = None  # bound by the deploy (bind_device)
        self._normed = None
        self._serving_state = None
        self._stage_lock = threading.Lock()

    def bind_device(self, device=None) -> None:
        """Serve on `device` (the first CUDA device when None), dropping
        any state staged elsewhere."""
        with self._stage_lock:
            self.device = resolve_device(device)
            self._serving_state = None

    def normed_item_factors(self) -> np.ndarray:
        if self._normed is None:
            self._normed = ranking.l2_normalize(self.factors.item_factors)
        return self._normed

    def host_ranked(self) -> bool:
        """Whether queries rank on the host: only on the CPU at f32."""
        return (self.device is not None and self.device.type == "cpu"
                and self.serve_dtype == "f32")

    def serving_state(self) -> als.ServingFactors:
        """The item slab staged for the fused basket cosine, staged once
        under the stage lock (concurrent batches must not double-stage)."""
        with self._stage_lock:
            if self.device is None:
                raise RuntimeError(
                    "the model has no device: an unpickled model is bound "
                    "by prepare_deploy (SimilarModel.bind_device)"
                )
            if self._serving_state is None:
                self._serving_state = als.stage_item_serving(
                    self.factors.item_factors, serve_dtype=self.serve_dtype,
                    device=self.device,
                )
            return self._serving_state


class _SimilarBase(Algorithm):
    """Shared serving: the mean of the query items' normalized vectors,
    cosine top-N."""

    def _train_model(self, ctx: Optional[RuntimeContext], rows, cols, vals,
                     pd: TrainingData) -> SimilarModel:
        device = ctx.device if ctx is not None else None
        factors = als.train(
            rows, cols, vals, pd.n_users, pd.n_items,
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
        return SimilarModel(factors, serve_dtype=self.params.serve_dtype, device=device)

    def _exclusion(self, model: SimilarModel, query: Query, known) -> np.ndarray:
        vocab = model.factors.item_vocab
        n = model.factors.item_factors.shape[0]
        excluded = np.zeros(n, dtype=bool)
        excluded[known] = True  # never the query's own items
        if query.whitelist is not None:
            keep = np.zeros(n, dtype=bool)
            for it in query.whitelist:
                ix = vocab.get(it)
                if ix is not None:
                    keep[ix] = True
            excluded |= ~keep
        for it in query.blacklist or []:
            ix = vocab.get(it)
            if ix is not None:
                excluded[ix] = True
        return excluded

    def _predict(self, model: SimilarModel, query: Query) -> PredictedResult:
        vocab = model.factors.item_vocab
        known = [k for k in (vocab.get(i) for i in query.items) if k is not None]
        if not known:
            return PredictedResult()
        excluded = self._exclusion(model, query, known)
        inv = vocab.inverse()
        normed = model.normed_item_factors()
        if model.host_ranked():
            scores = ranking.exclusion_scores(normed @ normed[known].mean(axis=0), excluded)
            return PredictedResult(item_scores=[
                ItemScore(item=inv(int(ix)), score=float(scores[ix]))
                for ix in ranking.top_k_indices(scores, query.num)
            ])
        q = normed[known].mean(axis=0)
        vals, idx = als.similar_vectors_serving(
            model.serving_state(), q[None, :], query.num,
            exclude_mask=excluded[None, :],
        )
        # the selector scores the cosine, divided by |q|: multiply it back
        # so the scores are the host formula's; masked entries are dropped
        # on the raw value first
        qnorm = float(np.linalg.norm(q)) + 1e-9
        return PredictedResult(item_scores=[
            ItemScore(item=inv(int(ix)), score=float(s * qnorm))
            for s, ix in zip(vals[0], idx[0])
            if s > NEG_INF / 2
        ])

    def predict(self, model: SimilarModel, query: Query) -> PredictedResult:
        return self._predict(model, query)

    def warmup(self, model: SimilarModel) -> None:
        """Stage the item slab and answer one basket, so that the first
        live query pays neither staging nor the kernel's load."""
        first = next(iter(model.factors.item_vocab.to_dict()), None)
        if first is not None:
            self._predict(model, Query(items=[first], num=10))


class ALSSimilarAlgorithm(_SimilarBase):
    """Implicit ALS on view events (reference ALSAlgorithm.scala of the
    similarproduct template)."""

    def __init__(self, params: ALSSimilarParams):
        self.params = params

    def train(self, ctx: Optional[RuntimeContext], pd: TrainingData) -> SimilarModel:
        return self._train_model(ctx, pd.rows, pd.cols, pd.vals, pd)


class LikeAlgorithm(_SimilarBase):
    """The same factorization over like/dislike ±1 events (reference
    LikeAlgorithm.scala, the multi variant's second algorithm)."""

    def __init__(self, params: ALSSimilarParams):
        self.params = params

    def train(self, ctx: Optional[RuntimeContext], pd: TrainingData) -> SimilarModel:
        if len(pd.like_rows) == 0:
            raise ValueError("LikeAlgorithm requires like/dislike events")
        return self._train_model(ctx, pd.like_rows, pd.like_cols, pd.like_vals, pd)


class SumScoreServing(Serving):
    """Per-item scores summed across the algorithms, top `num` (reference
    multi variant's Serving.scala)."""

    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        combined: dict[str, float] = {}
        for p in predictions:
            for s in p.item_scores:
                combined[s.item] = combined.get(s.item, 0.0) + s.score
        top = sorted(combined.items(), key=lambda kv: -kv[1])[: query.num]
        return PredictedResult(item_scores=[ItemScore(item=i, score=v) for i, v in top])


class SimilarProductEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            SimilarProductDataSource,
            IdentityPreparator,
            {"als": ALSSimilarAlgorithm, "like": LikeAlgorithm},
            {"": FirstServing, "sum": SumScoreServing},
        )
