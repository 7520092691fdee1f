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


def top_k_ordered(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`masked_top_k`'s result and order, (value descending, index
    ascending), without sorting whole rows: each f32 score becomes a
    unique int64 key, its order-preserving bits above (2^32 - 1 - index),
    and `torch.topk` selects k keys. Keys are unique, so any exact
    selection gives the same answer on every device. For rows far wider
    than k, where a stable sort of every row would cost 8-byte indices
    per element. Returns (values (..., k) f32, indices (..., k) int64)."""
    x = scores + 0.0  # -0.0 -> +0.0, as masked_top_k
    bits = x.view(torch.int32)
    # negative floats order backwards by their bits: flip their magnitude
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    col = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    keys = ordered * (1 << 32) + ((1 << 32) - 1 - col)
    top = torch.topk(keys, k, dim=-1).values
    idx = ((1 << 32) - 1) - (top & 0xFFFFFFFF)
    return torch.gather(x, -1, idx), idx
