"""User-facing DASE base classes and the stock servings/preparators.

Counterpart of the JAX package's ``controller/dase.py`` (reference
PDataSource.scala:35, IdentityPreparator.scala:31, P2LAlgorithm.scala:43,
LServing.scala:27, LFirstServing.scala:25, LAverageServing.scala:25):
one class per stage; templates subclass these.
"""

from __future__ import annotations

from typing import Sequence

from predictionio_tpu_torch.core.base import (
    A,
    EI,
    PD,
    TD,
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    BaseServing,
    M,
    P,
    Q,
    RuntimeContext,
)


class DataSource(BaseDataSource[TD, EI, Q, A]):
    """Subclass and implement `read_training`."""


class Preparator(BasePreparator[TD, PD]):
    """Subclass and implement `prepare`."""


class IdentityPreparator(BasePreparator[TD, TD]):
    """Pass-through TD → PD (reference IdentityPreparator.scala:31)."""

    def prepare(self, ctx: RuntimeContext, td: TD) -> TD:
        return td


class Algorithm(BaseAlgorithm[PD, M, Q, P]):
    """Subclass and implement `train` and `predict` (and `batch_predict`
    with a device-batched version where throughput matters)."""


class Serving(BaseServing[Q, P]):
    """Subclass and implement `serve`; override `supplement` to enrich
    queries before prediction."""


class FirstServing(Serving[Q, P]):
    """The first algorithm's prediction (reference LFirstServing.scala:25)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class AverageServing(Serving[Q, float]):
    """The mean of numeric predictions (reference LAverageServing.scala:25)."""

    def serve(self, query: Q, predictions: Sequence[float]) -> float:
        return sum(predictions) / len(predictions)
