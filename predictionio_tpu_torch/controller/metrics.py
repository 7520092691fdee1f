"""Metric family: per-(Q, P, A) scores reduced over eval sets.

Counterpart of the JAX package's ``controller/metrics.py`` (reference
controller/Metric.scala:36-266: Metric with its Ordering,
AverageMetric:96, OptionAverageMetric:121, StdevMetric:148,
OptionStdevMetric:176, SumMetric:202, ZeroMetric:231, QPAMetric:256).
The reductions are numpy over the in-memory QPA lists: eval sets are
host-sized, and the device work (training, batch predict) has already
run."""

from __future__ import annotations

import math
from typing import Any, Generic, Optional, Sequence, TypeVar

import numpy as np

from predictionio_tpu_torch.core.base import A, EI, P, Q, RuntimeContext

R = TypeVar("R")

EvalData = Sequence[tuple[Any, Sequence[tuple[Any, Any, Any]]]]  # [(EI, [(Q,P,A)])]


class Metric(Generic[EI, Q, P, A, R]):
    """Subclass and implement `calculate`. `higher_is_better=False` flips
    the comparison used to pick the best engine params (the reference
    parameterizes an Ordering)."""

    higher_is_better: bool = True

    def header(self) -> str:
        return type(self).__name__

    def calculate(self, ctx: RuntimeContext, data: EvalData) -> R:
        raise NotImplementedError

    def compare(self, a: R, b: R) -> int:
        """sign(a - b) in 'betterness' space. NaN always loses — a grid
        point with no defined scores must never win best-params selection."""
        a_nan = isinstance(a, float) and math.isnan(a)
        b_nan = isinstance(b, float) and math.isnan(b)
        if a_nan or b_nan:
            return 0 if a_nan and b_nan else (-1 if a_nan else 1)
        if a == b:
            return 0
        better = a > b if self.higher_is_better else a < b  # type: ignore[operator]
        return 1 if better else -1


class QPAMetric(Metric[EI, Q, P, A, R]):
    """Per-tuple score hook (reference QPAMetric:256)."""

    def calculate_one(self, q: Q, p: P, a: A) -> R:
        raise NotImplementedError


class AverageMetric(QPAMetric[EI, Q, P, A, float]):
    """Mean of per-tuple scores across all eval sets (reference :96)."""

    def calculate(self, ctx: RuntimeContext, data: EvalData) -> float:
        scores = [
            self.calculate_one(q, p, a) for _, qpa in data for q, p, a in qpa
        ]
        return float(np.mean(scores)) if scores else float("nan")


class OptionAverageMetric(QPAMetric[EI, Q, P, A, float]):
    """Mean of the defined (non-None) scores only (reference :121)."""

    def calculate_one(self, q: Q, p: P, a: A) -> Optional[float]:  # type: ignore[override]
        raise NotImplementedError

    def calculate(self, ctx: RuntimeContext, data: EvalData) -> float:
        scores = [
            s
            for _, qpa in data
            for q, p, a in qpa
            if (s := self.calculate_one(q, p, a)) is not None
        ]
        return float(np.mean(scores)) if scores else float("nan")


class StdevMetric(QPAMetric[EI, Q, P, A, float]):
    """Population stdev of per-tuple scores (reference :148)."""

    def calculate(self, ctx: RuntimeContext, data: EvalData) -> float:
        scores = [
            self.calculate_one(q, p, a) for _, qpa in data for q, p, a in qpa
        ]
        return float(np.std(scores)) if scores else float("nan")


class OptionStdevMetric(QPAMetric[EI, Q, P, A, float]):
    """Population stdev of defined scores (reference :176)."""

    def calculate_one(self, q: Q, p: P, a: A) -> Optional[float]:  # type: ignore[override]
        raise NotImplementedError

    def calculate(self, ctx: RuntimeContext, data: EvalData) -> float:
        scores = [
            s
            for _, qpa in data
            for q, p, a in qpa
            if (s := self.calculate_one(q, p, a)) is not None
        ]
        return float(np.std(scores)) if scores else float("nan")


class SumMetric(QPAMetric[EI, Q, P, A, float]):
    """Sum of per-tuple scores (reference :202)."""

    def calculate(self, ctx: RuntimeContext, data: EvalData) -> float:
        return float(
            sum(self.calculate_one(q, p, a) for _, qpa in data for q, p, a in qpa)
        )


class ZeroMetric(Metric[EI, Q, P, A, float]):
    """Always 0 — placeholder for eval runs that only want side effects
    (reference :231)."""

    def calculate(self, ctx: RuntimeContext, data: EvalData) -> float:
        return 0.0


def is_defined_number(x: Any) -> bool:
    return isinstance(x, (int, float)) and not (
        isinstance(x, float) and math.isnan(x)
    )
