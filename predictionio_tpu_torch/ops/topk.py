"""Top-k scoring with exclusion masks — the serving-side ranking op."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def masked_top_k(
    scores: torch.Tensor,  # (..., N)
    k: int,
    exclude_mask: Optional[torch.Tensor] = None,  # (..., N) bool — True = exclude
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (values, indices) of the top-k scores, with excluded
    positions pushed to NEG_INF (they can still appear if fewer than k
    valid entries — callers filter on value > NEG_INF/2).

    Order is (value descending, index ascending), the order `lax.top_k`
    gives: a stable descending sort keeps equal values in index order,
    which `torch.topk` does not promise. Adding 0.0 folds -0.0 into
    +0.0, so a radix sort on the card, which tells the two zeros apart,
    orders them as the comparison sort on the CPU does."""
    if exclude_mask is not None:
        scores = torch.where(exclude_mask, NEG_INF, scores)
    vals, idx = torch.sort(scores + 0.0, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
