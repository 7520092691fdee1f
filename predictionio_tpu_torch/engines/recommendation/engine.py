"""Recommendation engine template, serving half: ALS factors → top-N
items per query.

Counterpart of the JAX package's ``engines/recommendation/engine.py``.
The model keeps its factor matrices resident on the device, so serving
is one fused score+top-k call per query batch. Training is not part of
this package yet: a model comes from a factor blob (``convert.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops.recommend import ROWLIST_MAX, rowlist_np
from predictionio_tpu_torch.ops.topk import NEG_INF
from predictionio_tpu_torch.utils.bucket import batch_bucket, topk_bucket


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


class ALSModel:
    """Trained factors + device-resident factor matrices for serving."""

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

    def serving_state(self) -> als.ServingFactors:
        """The staged serving-side factor state, staged lazily under the
        stage lock (concurrent batches must not double-stage)."""
        with self._stage_lock:
            if self._serving_state is None:
                self._serving_state = als.stage_serving(
                    self.factors, serve_dtype=self.serve_dtype,
                    device=self.device,
                )
            return self._serving_state

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


class ALSAlgorithm:
    def __init__(self, params: ALSAlgorithmParams):
        self.params = params

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
