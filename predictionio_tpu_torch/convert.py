"""Carry trained models from the JAX package into the port.

The JAX package persists a deployed model as a pickle of its own
classes; unpickling that would import the JAX package. The carry-across
format is therefore arrays and id vocabularies: for ALS its npz factor
blob (``ALSFactors.to_bytes``, the arrays, the ids and the parameters as
JSON) or the arrays themselves, also for the similar-product and
e-commerce templates' models (their factors, serving dtype or item
categories); for the Universal Recommender the correlator tables of each
indicator and the item vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from predictionio_tpu_torch.data.store.bimap import BiMap
from predictionio_tpu_torch.engines.ecommerce.engine import ECommModel
from predictionio_tpu_torch.engines.similarproduct.engine import SimilarModel
from predictionio_tpu_torch.engines.universal.engine import IndicatorModel, URModel
from predictionio_tpu_torch.models.als import ALSFactors, ALSParams


def als_factors_from_numpy(
    user_factors, item_factors, user_ids, item_ids, params: dict
) -> ALSFactors:
    """Factor matrices (rows in id order) and the JAX package's
    ``ALSParams`` as a dict → the port's ``ALSFactors``. Unknown
    parameter names raise."""
    uf = np.ascontiguousarray(user_factors, np.float32)
    itf = np.ascontiguousarray(item_factors, np.float32)
    user_ids, item_ids = list(user_ids), list(item_ids)
    if uf.ndim != 2 or itf.ndim != 2 or uf.shape[1] != itf.shape[1]:
        raise ValueError(
            f"need (U, K) and (I, K) factors, got {uf.shape} and {itf.shape}"
        )
    if len(user_ids) != uf.shape[0] or len(item_ids) != itf.shape[0]:
        raise ValueError("one id per factor row is required")
    names = {f.name for f in dataclasses.fields(ALSParams)}
    unknown = set(params) - names
    if unknown:
        raise ValueError(f"unknown ALS params: {sorted(unknown)}")
    return ALSFactors(
        user_factors=uf,
        item_factors=itf,
        user_vocab=BiMap({u: n for n, u in enumerate(user_ids)}),
        item_vocab=BiMap({i: n for n, i in enumerate(item_ids)}),
        params=ALSParams(**params),
    )


def similar_model_from_numpy(
    item_factors, user_factors, user_ids, item_ids, params: dict,
    serve_dtype: str = "f32", device=None,
) -> SimilarModel:
    """A JAX ``SimilarModel``'s arrays (its ``factors`` and
    ``serve_dtype``) → the port's ``SimilarModel`` on `device` (the first
    CUDA device by default)."""
    return SimilarModel(
        als_factors_from_numpy(user_factors, item_factors, user_ids, item_ids, params),
        serve_dtype=serve_dtype, device=device,
    )


def ecomm_model_from_numpy(
    item_factors, user_factors, user_ids, item_ids, params: dict,
    item_categories: Optional[list] = None, device=None,
) -> ECommModel:
    """A JAX ``ECommModel``'s arrays and item categories (one collection
    of category names an item row, or None) → the port's ``ECommModel``
    on `device` (the first CUDA device by default)."""
    factors = als_factors_from_numpy(user_factors, item_factors, user_ids, item_ids, params)
    if item_categories is not None:
        if len(item_categories) != factors.item_factors.shape[0]:
            raise ValueError("one category set per item row is required")
        item_categories = [frozenset(c) for c in item_categories]
    return ECommModel(factors, item_categories, device=device)


def load_jax_als_blob(data: bytes) -> ALSFactors:
    """Read the bytes of the JAX package's ``ALSFactors.to_bytes()``."""
    return ALSFactors.from_bytes(data)


def ur_model_from_numpy(item_vocab, primary: str, indicators, device=None) -> URModel:
    """A JAX ``URModel``'s arrays → the port's ``URModel`` on `device`
    (the first CUDA device by default). `item_vocab` maps item id →
    row (``item_vocab.to_dict()``); `indicators` holds one `(name,
    correlator_scores (I, T) f32, correlator_idx (I, T) int32,
    target_vocab dict)` per indicator model, in the model's order."""
    items = BiMap(dict(item_vocab))
    models = []
    for name, scores, idx, target_vocab in indicators:
        scores = np.ascontiguousarray(scores, np.float32)
        idx = np.ascontiguousarray(idx, np.int32)
        if scores.shape != idx.shape or scores.ndim != 2:
            raise ValueError(
                f"indicator {name!r}: need (I, T) scores and indices, got "
                f"{scores.shape} and {idx.shape}"
            )
        if scores.shape[0] != len(items):
            raise ValueError(
                f"indicator {name!r}: {scores.shape[0]} rows for "
                f"{len(items)} items"
            )
        vocab = BiMap(dict(target_vocab))
        if idx.size and int(idx.max()) >= len(vocab):
            raise ValueError(f"indicator {name!r}: index past its target vocabulary")
        models.append(IndicatorModel(name, scores, idx, vocab))
    if not models:
        raise ValueError("a model needs at least one indicator")
    return URModel(items, models, primary, device=device)
