"""Shared serving-shape bucketing.

Batch and top-k dimensions are bucketed to a tiny ladder so warmup
covers every shape live traffic sends and a query's `num` does not
change the device-side k. One definition, used by every engine, so the
shape sets cannot drift apart.
"""

from __future__ import annotations


def batch_bucket(n: int) -> int:
    """{1, 8, 64, pow2 beyond}: three shapes cover everything up to the
    dispatcher's default max_batch of 64."""
    if n <= 1:
        return 1
    if n <= 8:
        return 8
    if n <= 64:
        return 64
    return 1 << (n - 1).bit_length()


def topk_bucket(k_req: int, n_items: int, floor: int = 128) -> int:
    """Fixed device-side k (pow2 above a floor, capped by the catalog) so
    a query's `num` does not create a device shape per distinct value;
    results are sliced to `num` on host."""
    if n_items <= floor:
        return n_items
    return min(n_items, max(floor, 1 << (max(k_req, 1) - 1).bit_length()))
