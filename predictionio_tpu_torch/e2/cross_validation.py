"""k-fold split helper (a copy of the JAX package's
``e2/cross_validation.py``).

Reference: e2/src/main/scala/io/prediction/e2/evaluation/
CrossValidation.scala:21-64 — `CommonHelperFunctions.splitData[D, TD, EI,
Q, A]`: fold membership by element index mod k."""

from __future__ import annotations

from typing import Callable, Sequence, TypeVar

D = TypeVar("D")

def split_data(
    eval_k: int,
    dataset: Sequence[D],
) -> list[tuple[list[D], list[D]]]:
    """[(training, testing)] per fold; element i is in fold i mod k's test
    set. Callers convert to their TD/Q/A shapes."""
    if eval_k <= 0:
        raise ValueError("eval_k must be positive")
    folds = []
    for fold in range(eval_k):
        train = [d for i, d in enumerate(dataset) if i % eval_k != fold]
        test = [d for i, d in enumerate(dataset) if i % eval_k == fold]
        folds.append((train, test))
    return folds
