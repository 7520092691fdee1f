"""Host-side ranking helpers for the serving paths that rank one score
vector on the host.

Counterpart of the JAX package's ``models/ranking.py``, call for call:
the e-commerce template ranks `item_factors @ user` (or a basket's
cosine) after sparse business-rule filters, and the similar-product
template's CPU f32 route ranks its cosine scores. Equal scores come out
in the order the same numpy calls give (`np.argpartition`, then a
default `np.argsort` in `top_k_indices`, a stable one in
`top_k_filtered`), so these stay exactly those calls. One NEG_INF
convention: an entry at or below NEG_INF / 2 is masked.
"""

from __future__ import annotations

import numpy as np

from predictionio_tpu_torch.ops.topk import NEG_INF


def l2_normalize(factors: np.ndarray) -> np.ndarray:
    """Rows scaled to unit L2 norm (+1e-9 in the divisor)."""
    return factors / (np.linalg.norm(factors, axis=-1, keepdims=True) + 1e-9)


def top_k_indices(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k best scores, best first, masked entries
    (≤ NEG_INF / 2) dropped."""
    k = min(k, len(scores))
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    top = np.argpartition(-scores, k - 1)[:k]
    top = top[np.argsort(-scores[top])]
    return top[scores[top] > NEG_INF / 2]


def exclusion_scores(scores: np.ndarray, excluded: np.ndarray) -> np.ndarray:
    """`scores` with the `excluded` entries at NEG_INF."""
    return np.where(excluded, NEG_INF, scores)


def top_k_filtered(
    scores: np.ndarray,
    k: int,
    exclude_idx=None,
    include_idx=None,
    positive_only: bool = False,
) -> np.ndarray:
    """Top-k indices, best first, with sparse filters and no dense mask.

    `exclude_idx`: indices never returned (seen, blacklisted,
    unavailable); k + |exclude| candidates are drawn, then the excluded
    dropped. `include_idx`: a whitelist, the only candidates. Masked
    entries, and non-positive ones with `positive_only`, are dropped."""
    if k <= 0 or len(scores) == 0:
        return np.empty(0, dtype=np.int64)
    ex = (
        np.unique(np.asarray(exclude_idx, dtype=np.int64))
        if exclude_idx is not None and len(exclude_idx)
        else None
    )
    if include_idx is not None:
        cand = np.unique(np.asarray(include_idx, dtype=np.int64))
        if ex is not None:
            cand = np.setdiff1d(cand, ex, assume_unique=True)
    else:
        m = k + (len(ex) if ex is not None else 0)
        if m >= len(scores):
            cand = np.arange(len(scores), dtype=np.int64)
        else:
            cand = np.argpartition(-scores, m - 1)[:m].astype(np.int64)
        if ex is not None:
            cand = cand[~np.isin(cand, ex, assume_unique=False)]
    cand_scores = scores[cand]
    keep = cand_scores > (0.0 if positive_only else NEG_INF / 2)
    cand, cand_scores = cand[keep], cand_scores[keep]
    top = np.argsort(-cand_scores, kind="stable")[:k]
    return cand[top]
