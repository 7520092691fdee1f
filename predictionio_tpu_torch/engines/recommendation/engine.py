"""Recommendation engine template: ratings → ALS factors → top-N items
per query.

Counterpart of the JAX package's ``engines/recommendation/engine.py``
(reference examples/scala-parallel-recommendation).
``RecommendationDataSource`` reads "rate"/"buy" events from the event
store as one columnar frame, through the data view's cache with
``use_data_view`` (``data/view.py``), and with ``read_item_categories``
each item's ``categories`` from its aggregated $set properties (the
filter-by-category variant); the file-backed ``FileRatingsDataSource``
reads ``user::item::rating`` lines. ``ALSAlgorithm.train`` trains
through ``models/als.py``'s routing, in checkpointed segments when the
variant asks (``workflow/checkpoint.py``), warm-started from the live
registry version with ``warm_start`` (sharded serving is not ported
yet, and a variant that asks for it is refused). Evaluation follows the template's
query/actual protocol: ``read_eval`` makes k folds by interaction
index, each fold's queries ask for the held-out users' top N, and the
actual result is the held-out items rated at or above the goal
threshold; ``ALSAlgorithm.train_grid`` trains a tuning grid over one
staging per fold, and ``PrecisionAtK`` scores it. The model keeps its factor
matrices resident on its device, so serving is one fused score+top-k
call per query batch; it pickles without them, and deploy binds it to
the deploy's device. An online fold's successor model takes over the
staged state through ``ALSModel.adopt_serving`` (only the dirty rows
written). A model also comes from a factor blob
(``convert.py``). ``RecommendationEngine`` and
``FileRecommendationEngine`` are the factories engine.json names.
"""

from __future__ import annotations

import logging
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
    SanityCheck,
)
from predictionio_tpu_torch.controller.metrics import OptionAverageMetric
from predictionio_tpu_torch.core.base import RuntimeContext
from predictionio_tpu_torch.data.store.bimap import BiMap
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade
from predictionio_tpu_torch.data.view import DataView
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops.recommend import ROWLIST_MAX, rowlist_np
from predictionio_tpu_torch.ops.topk import NEG_INF
from predictionio_tpu_torch.utils.bucket import batch_bucket, topk_bucket
from predictionio_tpu_torch.workflow.checkpoint import (
    CheckpointManager,
    train_als_checkpointed,
)

log = logging.getLogger(__name__)


# -- training data ------------------------------------------------------------


@dataclass
class TrainingData(SanityCheck):
    rows: np.ndarray  # user idx per interaction
    cols: np.ndarray  # item idx
    vals: np.ndarray  # rating / implicit weight
    n_users: int
    n_items: int
    user_vocab: BiMap  # str → int
    item_vocab: BiMap
    # item row → category set, from item $set properties
    item_categories: Optional[list[frozenset]] = None

    def sanity_check(self) -> None:
        if len(self.rows) == 0:
            raise ValueError(
                "no interaction events found (check appName/eventNames)"
            )
        if not np.isfinite(self.vals).all():
            raise ValueError("non-finite interaction values")


@dataclass
class DataSourceParams:
    """The JAX package's fields, so that a variant's JSON reads the same."""

    app_name: str
    event_names: tuple[str, ...] = ("rate", "buy")
    rate_event: str = "rate"  # carries a "rating" property; others weigh 1.0
    eval_k: int = 0  # > 0 enables read_eval with k folds
    goal_threshold: float = 4.0  # a rating >= threshold counts as relevant
    eval_num: int = 20  # top N asked per eval query (>= the metric's k)
    # read item $set properties for category filtering (off by default:
    # the plain variant pays no extra event-store scan)
    read_item_categories: bool = False
    # cache the read frame keyed by (query, data signature): a train of
    # an unchanged app skips the event scan
    use_data_view: bool = False
    data_view_dir: Optional[str] = None  # default $PIO_FS_BASEDIR/view


class RecommendationDataSource(DataSource):
    """The app's interaction events → TrainingData (reference template
    DataSource.scala:24-80)."""

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _frame(self, ctx: RuntimeContext):
        frame_kwargs = dict(
            app_name=self.params.app_name,
            entity_type="user",
            target_entity_type="item",
            event_names=list(self.params.event_names),
            value_prop="rating",
            default_value=1.0,
        )
        if self.params.use_data_view:
            frame = DataView(self.params.data_view_dir).find_frame(
                ctx.storage, **frame_kwargs)
        else:
            frame = EventStoreFacade(ctx.storage).find_frame(**frame_kwargs)
        # only the rate event carries a rating; every other interaction
        # type weighs 1.0, even with a "rating" property
        rate_code = frame.event_vocab.get(self.params.rate_event, -2)
        frame.value = np.where(
            frame.event_code == rate_code, frame.value, 1.0
        ).astype(np.float32)
        return frame

    def _item_categories(
        self, ctx: RuntimeContext, item_vocab: BiMap
    ) -> Optional[list[frozenset]]:
        """Item row → its `categories` property, from the items' folded
        $set/$unset/$delete events (empty for an item with none); None
        without `read_item_categories` or when no item has properties."""
        if not self.params.read_item_categories:
            return None
        props = EventStoreFacade(ctx.storage).aggregate_properties(
            app_name=self.params.app_name, entity_type="item"
        )
        if not props:
            return None
        out: list[frozenset] = [frozenset()] * len(item_vocab)
        for item_id, pmap in props.items():
            row = item_vocab.get(item_id)
            if row is not None:
                out[row] = frozenset(pmap.get_opt("categories", list) or [])
        return out

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        frame = self._frame(ctx)
        rows, cols, vals = frame.interactions(dedupe="sum")
        return TrainingData(
            rows=rows, cols=cols, vals=vals,
            n_users=frame.n_entities, n_items=frame.n_targets,
            user_vocab=frame.entity_vocab, item_vocab=frame.target_vocab,
            item_categories=self._item_categories(ctx, frame.target_vocab),
        )

    def read_eval(self, ctx: RuntimeContext):
        """k folds by interaction index (fold = idx mod k; reference e2
        CrossValidation.splitData:21) over `interactions(dedupe="sum")`.
        Each fold trains on the other folds' interactions; its queries go
        to the held-out users in ascending user index, each with the
        held-out items rated at or above `goal_threshold`, in held-out
        order, as the actual result. A user with no such item gets no
        query. One stable sort by user groups each fold's held-out
        edges."""
        k = self.params.eval_k
        if k <= 0:
            raise ValueError("eval requires datasource params eval_k > 0")
        frame = self._frame(ctx)
        rows, cols, vals = frame.interactions(dedupe="sum")
        fold_of = np.arange(len(rows)) % k
        inv_user = frame.entity_vocab.inverse()
        inv_item = frame.target_vocab.inverse()
        out = []
        for fold in range(k):
            test = fold_of == fold
            td = TrainingData(
                rows=rows[~test], cols=cols[~test], vals=vals[~test],
                n_users=frame.n_entities, n_items=frame.n_targets,
                user_vocab=frame.entity_vocab, item_vocab=frame.target_vocab,
            )
            keep = test & (vals >= self.params.goal_threshold)
            t_rows, t_cols = rows[keep], cols[keep]
            order = np.argsort(t_rows, kind="stable")
            t_rows, t_cols = t_rows[order], t_cols[order]
            users, starts = np.unique(t_rows, return_index=True)
            ends = np.append(starts[1:], len(t_rows))
            qa = [
                (Query(user=inv_user(int(u)), num=self.params.eval_num),
                 ActualResult([inv_item(int(c)) for c in t_cols[a:b]]))
                for u, a, b in zip(users, starts, ends)
            ]
            out.append((td, EvalInfo(fold=fold), qa))
        return out


@dataclass
class FileDataSourceParams:
    filepath: str
    delimiter: str = "::"  # MovieLens ratings.dat convention


class FileRatingsDataSource(DataSource):
    """``user::item::rating`` lines from a delimited text file, no event
    store involved (the JAX package's file-backed DataSource; reference
    examples/experimental/scala-parallel-recommendation-custom-datasource
    /DataSource.scala:24-33)."""

    def __init__(self, params: FileDataSourceParams):
        self.params = params

    def read_training(self, ctx: Optional[RuntimeContext] = None) -> TrainingData:
        users: dict[str, int] = {}
        items: dict[str, int] = {}
        rows, cols, vals = [], [], []
        with open(self.params.filepath) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(self.params.delimiter)
                if len(parts) < 3:
                    raise ValueError(
                        f"bad ratings line (want user{self.params.delimiter}"
                        f"item{self.params.delimiter}rating): {line!r}"
                    )
                u, i, r = parts[0], parts[1], float(parts[2])
                rows.append(users.setdefault(u, len(users)))
                cols.append(items.setdefault(i, len(items)))
                vals.append(r)
        return TrainingData(
            rows=np.asarray(rows, np.int32),
            cols=np.asarray(cols, np.int32),
            vals=np.asarray(vals, np.float32),
            n_users=len(users),
            n_items=len(items),
            user_vocab=BiMap(users),
            item_vocab=BiMap(items),
        )


# -- query/result ------------------------------------------------------------


@dataclass
class Query:
    user: str
    num: int = 10
    # filter-by-category variant surface
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
class ActualResult:
    """Held-out relevant items of an eval query."""

    items: list[str] = field(default_factory=list)


@dataclass
class EvalInfo:
    fold: int


# -- algorithm ----------------------------------------------------------------


@dataclass
class ALSAlgorithmParams:
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    implicit_prefs: bool = True
    cg_iterations: int = 3
    seed: int = 3
    # serving dtype: "int8" quantizes both factor matrices per row at
    # staging (int8xint8->int32 scoring, scale-product dequant); "bf16"
    # halves the bytes with f32 products and sum; "f32" scores exactly.
    # Scores shift by the quantization/rounding error, so both are
    # explicit opt-ins
    serve_dtype: str = "f32"
    # > 0: save the factors into MODELDATA every N iterations, so that an
    # interrupted train resumes (workflow/checkpoint.py); 0 disables
    checkpoint_every: int = 0
    # start the train from the variant's live registry version, its
    # factors mapped onto the new vocabularies (als.warm_start_factors)
    warm_start: bool = False

    # the JAX package's fields the port does not have yet: a variant that
    # names one is refused (controller.params.extract_params)
    NOT_PORTED = ("shard_serving",)


class ALSModel:
    """Trained factors + device-resident factor matrices for serving.

    Pickles its factors (numpy), categories and serving dtype, never its
    device or staged state; an unpickled model has no device until
    `bind_device` gives it the deploy's."""

    def __init__(
        self,
        factors: als.ALSFactors,
        item_categories: Optional[list[frozenset]] = None,
        serve_dtype: str = "f32",
        device=None,
    ):
        self.factors = factors
        self.item_categories = item_categories
        self.serve_dtype = serve_dtype
        self.device = resolve_device(device)
        self._serving_state: Optional[als.ServingFactors] = None
        self._stage_lock = threading.Lock()

    def __getstate__(self):
        return {
            "factors": self.factors,
            "item_categories": self.item_categories,
            "serve_dtype": self.serve_dtype,
        }

    def __setstate__(self, state):
        self.factors = state["factors"]
        self.item_categories = state.get("item_categories")
        self.serve_dtype = state.get("serve_dtype", "f32")
        self.device = None  # bound by the deploy (bind_device)
        self._serving_state = None
        self._stage_lock = threading.Lock()

    def bind_device(self, device=None) -> None:
        """Serve on `device` (the first CUDA device when None), dropping
        any state staged elsewhere."""
        with self._stage_lock:
            self.device = resolve_device(device)
            self._serving_state = None

    def serving_state(self) -> als.ServingFactors:
        """The staged serving-side factor state, staged lazily under the
        stage lock (concurrent batches must not double-stage)."""
        with self._stage_lock:
            if self.device is None:
                raise RuntimeError(
                    "the model has no device: an unpickled model is bound "
                    "by prepare_deploy (ALSModel.bind_device)"
                )
            if self._serving_state is None:
                self._serving_state = als.stage_serving(
                    self.factors, serve_dtype=self.serve_dtype,
                    device=self.device,
                )
            return self._serving_state

    def adopt_serving(self, old_state, dirty_users=None, dirty_items=None):
        """The online fold's publish hook (`online/foldin.py:
        _clone_model`): carry the predecessor's staged state by
        publishing only the tick's dirty rows (`als.serving_publish_rows`,
        copy-on-write off its shared tables) instead of restaging a
        factor matrix. A side that changed without row attribution, or a
        failed publish (logged), leaves the state unstaged: the next
        query stages it from the factors."""
        if old_state is None:
            return
        with self._stage_lock:
            n_users = self.factors.user_factors.shape[0]
            n_items = self.factors.item_factors.shape[0]
            if dirty_users is None and n_users != old_state.n_users:
                return
            if dirty_items is None and n_items != old_state.n_items:
                return
            ur, uv = dirty_users if dirty_users is not None else (None, None)
            ir, iv = dirty_items if dirty_items is not None else (None, None)
            try:
                self._serving_state = als.serving_publish_rows(
                    old_state, user_rows=ur, user_vals=uv, item_rows=ir,
                    item_vals=iv, n_users=n_users, n_items=n_items,
                )
            except Exception:  # noqa: BLE001 — the next query restages
                log.exception("dirty-row publish failed; the model "
                              "restages on its next query")
                self._serving_state = None

    def resident_device_bytes(self) -> float:
        """Device footprint: the staged (possibly int8) state when staged,
        else the factor matrices once."""
        sv = self._serving_state
        if sv is not None:
            return sv.device_nbytes()
        return float(
            self.factors.user_factors.nbytes
            + self.factors.item_factors.nbytes
        )


class ALSAlgorithm(Algorithm):
    def __init__(self, params: ALSAlgorithmParams):
        self.params = params

    def train(self, ctx: Optional[RuntimeContext], pd: TrainingData) -> ALSModel:
        """Train ALS factors on the context's device (the first CUDA
        device by default) and return the model, resident there. With
        `checkpoint_every` and a train run's storage and instance id the
        train runs in checkpointed segments; with `warm_start` it starts
        from the live version's factors (`_warm_start_init`)."""
        device = ctx.device if ctx is not None else None
        als_params = als.ALSParams(
            rank=self.params.rank,
            iterations=self.params.num_iterations,
            lambda_=self.params.lambda_,
            alpha=self.params.alpha,
            implicit_prefs=self.params.implicit_prefs,
            cg_iterations=self.params.cg_iterations,
            seed=self.params.seed,
        )
        manager = None
        if (self.params.checkpoint_every > 0 and ctx is not None
                and ctx.storage is not None and ctx.instance_id):
            manager = CheckpointManager(ctx.storage, ctx.instance_id)
        factors = train_als_checkpointed(
            pd.rows, pd.cols, pd.vals, pd.n_users, pd.n_items, als_params,
            manager, self.params.checkpoint_every,
            user_vocab=pd.user_vocab, item_vocab=pd.item_vocab,
            device=device,
            init_factors=self._warm_start_init(ctx, pd, als_params),
        )
        return ALSModel(
            factors,
            item_categories=pd.item_categories,
            serve_dtype=self.params.serve_dtype,
            device=device,
        )

    def _warm_start_init(self, ctx: Optional[RuntimeContext], pd: TrainingData,
                         als_params: als.ALSParams):
        """The variant's live version's factors mapped onto this train's
        vocabularies (`als.warm_start_factors`), or None for a cold
        start: without `warm_start`, a train run's storage and instance,
        a live version, its blob, or a parent of this rank. The live
        version is the one this train's version will name as its parent.
        Best-effort, as in the JAX package: a failure is logged and the
        train starts cold."""
        if not self.params.warm_start or ctx is None or ctx.storage is None:
            return None
        try:
            if not ctx.instance_id:
                return None
            inst = ctx.storage.get_meta_data_engine_instances().get(
                ctx.instance_id)
            if inst is None:
                return None
            from predictionio_tpu_torch.controller.persistent import (
                deserialize_models,
            )
            from predictionio_tpu_torch.deploy.registry import ModelRegistry

            live = ModelRegistry(ctx.storage).live_version(
                inst.engine_id, inst.engine_variant)
            if live is None:
                return None
            blob = ctx.storage.get_model_data_models().get(live.instance_id)
            if blob is None:
                return None
            parent = next((m.factors for m in deserialize_models(blob.models)
                           if hasattr(m, "factors")), None)
            if parent is None or parent.params.rank != als_params.rank:
                return None
            log.info("warm-starting train from live version %s", live.id)
            return als.warm_start_factors(parent, pd.user_vocab,
                                          pd.item_vocab, als_params)
        except Exception:  # noqa: BLE001 — a cold start, logged
            log.warning("warm start unavailable; using cold init",
                        exc_info=True)
            return None

    def train_grid(
        self, ctx: Optional[RuntimeContext], pd: TrainingData, params_list
    ) -> list[ALSModel]:
        """A tuning grid trained over one staging (`als.train_grid`) on
        the context's device, each model bound there with its own
        point's serving dtype; a grid that `als.train_grid` refuses (a
        rank above its bound, implicit and explicit points mixed) trains
        point by point."""
        device = ctx.device if ctx is not None else None
        als_list = [
            als.ALSParams(
                rank=p.rank,
                iterations=p.num_iterations,
                lambda_=p.lambda_,
                alpha=p.alpha,
                implicit_prefs=p.implicit_prefs,
                cg_iterations=p.cg_iterations,
                seed=p.seed,
            )
            for p in params_list
        ]
        data = (pd.rows, pd.cols, pd.vals, pd.n_users, pd.n_items)
        vocabs = dict(user_vocab=pd.user_vocab, item_vocab=pd.item_vocab)
        try:
            grid = als.train_grid(*data, als_list, **vocabs, device=device)
        except ValueError:
            grid = [als.train(*data, p, **vocabs, device=device)
                    for p in als_list]
        return [
            ALSModel(f, item_categories=pd.item_categories,
                     serve_dtype=p.serve_dtype, device=device)
            for p, f in zip(params_list, grid)
        ]

    def warmup(self, model: ALSModel) -> None:
        """Stage the factors on the device and run the serving ladder's
        batch shapes once, unmasked and masked, so the first live
        queries pay neither staging nor the kernel build."""
        if model.factors.user_factors.shape[0] == 0:
            return
        vocab_ids = list(model.factors.user_vocab.to_dict())
        if not vocab_ids:
            return
        for batch in (1, 8, 64):  # the full serving bucket ladder
            self._predict_batch(
                model, [Query(user=vocab_ids[0], num=10)] * batch
            )
            self._predict_batch(
                model,
                [Query(user=vocab_ids[0], num=10, blacklist=["__warmup__"])]
                * batch,
            )

    def _exclusion_mask(
        self, model: ALSModel, queries: Sequence[Query]
    ) -> Optional[np.ndarray]:
        """Category/white/black-list filters → per-query item mask
        (True = exclude)."""
        if not any(q.whitelist or q.blacklist or q.categories for q in queries):
            return None
        vocab = model.factors.item_vocab
        n_items = model.factors.item_factors.shape[0]
        mask = np.zeros((len(queries), n_items), dtype=bool)
        for qi, q in enumerate(queries):
            # three independent exclusions, OR-ed: an item must pass
            # every configured filter
            if q.categories:
                if model.item_categories is None:
                    raise ValueError(
                        "query filters by categories but no item category "
                        "properties were found at train time"
                    )
                wanted = set(q.categories)
                no_overlap = np.fromiter(
                    (not (cats & wanted) for cats in model.item_categories),
                    dtype=bool,
                    count=n_items,
                )
                mask[qi] |= no_overlap
            if q.whitelist is not None:
                not_listed = np.ones(n_items, dtype=bool)
                for it in q.whitelist:
                    ix = vocab.get(it)
                    if ix is not None:
                        not_listed[ix] = False
                mask[qi] |= not_listed
            if q.blacklist:
                for it in q.blacklist:
                    ix = vocab.get(it)
                    if ix is not None:
                        mask[qi, ix] = True
        return mask

    def _exclusion_args(
        self, model: ALSModel, queries: Sequence[Query]
    ) -> tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """(dense mask, row list) — exactly one is set when any filter
        applies. The common small-blacklist case ships a (B, E) int32 row
        list; category/whitelist filters, which exclude most of the
        catalog, keep the dense mask, packed to words downstream."""
        if not any(
            q.whitelist or q.blacklist or q.categories for q in queries
        ):
            return None, None
        if any(q.whitelist is not None or q.categories for q in queries):
            return self._exclusion_mask(model, queries), None
        vocab = model.factors.item_vocab
        lists: list[list[int]] = []
        for q in queries:
            rows = [
                ix for it in (q.blacklist or [])
                if (ix := vocab.get(it)) is not None
            ]
            lists.append(rows)
        if max(len(r) for r in lists) > ROWLIST_MAX:
            return self._exclusion_mask(model, queries), None
        return None, rowlist_np(lists)

    def _predict_batch(
        self, model: ALSModel, queries: Sequence[Query]
    ) -> list[PredictedResult]:
        vocab = model.factors.user_vocab
        known = [(i, vocab.get(q.user)) for i, q in enumerate(queries)]
        known_ix = [(i, u) for i, u in known if u is not None]
        results: list[PredictedResult] = [PredictedResult() for _ in queries]
        if not known_ix:
            return results
        # fixed device-side k (pow2-bucketed above a floor) so q.num does
        # not create a device shape per distinct value; results are
        # sliced to num on host
        n_items = model.factors.item_factors.shape[0]
        k_req = min(max(q.num for q in queries), n_items)
        k = topk_bucket(k_req, n_items)
        user_rows = np.array([u for _, u in known_ix], dtype=np.int64)
        full_mask, full_rows = self._exclusion_args(model, queries)
        keep = [i for i, _ in known_ix]
        sub_mask = full_mask[keep] if full_mask is not None else None
        sub_rows = full_rows[keep] if full_rows is not None else None
        n_real = len(user_rows)
        bucket = batch_bucket(n_real)
        if bucket != n_real:
            user_rows = np.concatenate(
                [user_rows, np.zeros(bucket - n_real, dtype=np.int64)]
            )
            if sub_mask is not None:
                sub_mask = np.concatenate(
                    [sub_mask, np.zeros((bucket - n_real, sub_mask.shape[1]), bool)]
                )
            if sub_rows is not None:
                sub_rows = np.concatenate([
                    sub_rows,
                    np.full(
                        (bucket - n_real, sub_rows.shape[1]), -1, np.int32
                    ),
                ])
        scores, items = als.recommend_serving(
            model.serving_state(), user_rows, k,
            exclude_mask=sub_mask, exclude_rows=sub_rows,
        )
        scores, items = scores[:n_real], items[:n_real]
        inv = model.factors.item_vocab.inverse()
        for row, (qi, _u) in enumerate(known_ix):
            n = min(queries[qi].num, k)
            item_scores = [
                ItemScore(item=inv(int(ix)), score=float(s))
                for s, ix in zip(scores[row][:n], items[row][:n])
                if s > NEG_INF / 2
            ]
            results[qi] = PredictedResult(item_scores=item_scores)
        return results

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        return self._predict_batch(model, [query])[0]

    def batch_predict(self, ctx, model: ALSModel, queries):
        preds = self._predict_batch(model, [q for _, q in queries])
        return [(qx, p) for (qx, _q), p in zip(queries, preds)]


# -- evaluation ---------------------------------------------------------------


class PrecisionAtK(OptionAverageMetric):
    """|top-k ∩ relevant| / k, averaged over the queries with relevant
    items (the recommendation template's tuning metric)."""

    def __init__(self, k: int = 10):
        self.k = k

    def header(self) -> str:
        return f"Precision@{self.k}"

    def calculate_one(self, q: Query, p: PredictedResult, a: ActualResult):
        if not a.items:
            return None
        top = {s.item for s in p.item_scores[: self.k]}
        return len(top & set(a.items)) / self.k


# -- engine factories ----------------------------------------------------------


class RecommendationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            RecommendationDataSource,
            IdentityPreparator,
            {"als": ALSAlgorithm},
            FirstServing,
        )


class FileRecommendationEngine(EngineFactory):
    """The recommendation engine with the file-backed DataSource."""

    def apply(self) -> Engine:
        return Engine(
            FileRatingsDataSource,
            IdentityPreparator,
            {"als": ALSAlgorithm},
            FirstServing,
        )
