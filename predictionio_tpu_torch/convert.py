"""Carry trained models from the JAX package into the port.

The JAX package persists a deployed model as a pickle of its own
classes; unpickling that would import the JAX package. The carry-across
format is therefore arrays and id vocabularies: for ALS its npz factor
blob (``ALSFactors.to_bytes``, the arrays, the ids and the parameters as
JSON) or the arrays themselves, also for the similar-product and
e-commerce templates' models (their factors, serving dtype or item
categories); for the Universal Recommender the correlator tables of each
indicator and the item vocabulary; for the classification and
regression templates' models their arrays (naive Bayes' log prior and
log likelihood, logistic regression's weights, a random forest's bin
edges, trees and leaf distributions, ridge's weights and intercept).
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
from predictionio_tpu_torch.models.classify import LogisticRegressionModel, NaiveBayesModel
from predictionio_tpu_torch.models.forest import RandomForestModel
from predictionio_tpu_torch.models.linreg import LinearRegressionModel


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


def nb_model_from_numpy(log_prior, log_likelihood, device=None) -> NaiveBayesModel:
    """A JAX ``NaiveBayesModel``'s (C,) log prior and (C, D) log
    likelihood → the port's model on `device` (the first CUDA device by
    default)."""
    log_prior = np.asarray(log_prior, np.float32)
    log_likelihood = np.asarray(log_likelihood, np.float32)
    if log_prior.ndim != 1 or log_likelihood.ndim != 2 or (
            log_likelihood.shape[0] != log_prior.shape[0]):
        raise ValueError(f"need (C,) and (C, D), got {log_prior.shape} and "
                         f"{log_likelihood.shape}")
    return NaiveBayesModel(log_prior, log_likelihood, device=device)


def lr_model_from_numpy(weights, device=None) -> LogisticRegressionModel:
    """A JAX ``LogisticRegressionModel``'s (D+1, C) weights (the last row
    the bias) → the port's model on `device`."""
    weights = np.asarray(weights, np.float32)
    if weights.ndim != 2 or weights.shape[0] < 2:
        raise ValueError(f"need (D+1, C) weights, got {weights.shape}")
    return LogisticRegressionModel(weights, device=device)


def rf_model_from_numpy(bin_edges, features, routes_f, routes_t, leaf_proba, depth: int,
                        device=None) -> RandomForestModel:
    """A JAX ``RandomForestModel``'s arrays → the port's model on
    `device`: (D, n_bins-1) bin edges, (T, depth, 2^(depth-1)) features,
    routing features and thresholds, (T, 2^depth, C) leaf
    distributions."""
    t, lv, nodes = np.shape(routes_f)
    if (lv != depth or nodes != 2 ** (depth - 1) or np.shape(features) != (t, lv, nodes)
            or np.shape(routes_t) != (t, lv, nodes)
            or np.shape(leaf_proba)[:2] != (t, 2 ** depth)):
        raise ValueError("the forest's arrays disagree with its depth or each other")
    return RandomForestModel(bin_edges, features, routes_f, routes_t, leaf_proba, depth,
                             device=device)


def linreg_model_from_numpy(weights, intercept: float) -> LinearRegressionModel:
    """A JAX ``LinearRegressionModel``'s (D,) weights and intercept → the
    port's (a host model: no device)."""
    weights = np.asarray(weights, np.float32)
    if weights.ndim != 1:
        raise ValueError(f"need (D,) weights, got {weights.shape}")
    return LinearRegressionModel(weights=weights, intercept=float(intercept))
