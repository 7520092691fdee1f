"""Categorical naive Bayes over string features (a copy of the JAX
package's ``e2/naive_bayes.py``).

Reference: e2/src/main/scala/io/prediction/e2/engine/
CategoricalNaiveBayes.scala:23-176 — train aggregates (label, position,
feature-value) counts into log priors + log likelihoods; the model scores
a feature vector per label, with an optional default likelihood for unseen
feature values (logScore/logScoreInternal), and predicts the argmax label.

String-keyed counting is host work by nature; the arrays the model keeps
are dense numpy so downstream scoring is vectorizable."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence


@dataclass(frozen=True)
class LabeledPoint:
    """Reference e2 LabeledPoint(label, Array[String])."""

    label: str
    features: tuple[str, ...]


@dataclass
class CategoricalNaiveBayesModel:
    """log P(label) + log P(feature@position | label)."""

    priors: dict[str, float]
    likelihoods: dict[str, list[dict[str, float]]]

    def log_score(
        self,
        point: LabeledPoint,
        default_likelihood: Callable[[Sequence[float]], float] = lambda _: float(
            "-inf"
        ),
    ) -> Optional[float]:
        """Log joint score of a point's features under its label; None when
        the label is unknown. Unseen feature values fall back to
        `default_likelihood` over the position's known log-likelihoods
        (reference logScore:~90)."""
        if point.label not in self.priors:
            return None
        return self._score(point.label, point.features, default_likelihood)

    def _score(self, label, features, default_likelihood) -> float:
        ll = self.likelihoods[label]
        total = self.priors[label]
        for pos, value in enumerate(features):
            pos_map = ll[pos]
            total += pos_map.get(value, default_likelihood(list(pos_map.values())))
        return total

    def predict(self, features: Sequence[str]) -> str:
        """Argmax label; unseen values contribute -inf unless every label
        misses them (reference predict: max by logScoreInternal)."""
        return max(
            self.priors,
            key=lambda lb: self._score(lb, features, lambda _: float("-inf")),
        )


class CategoricalNaiveBayes:
    """Reference object CategoricalNaiveBayes.train:29."""

    @staticmethod
    def train(points: Sequence[LabeledPoint]) -> CategoricalNaiveBayesModel:
        if not points:
            raise ValueError("cannot train naive Bayes on no data")
        n_positions = len(points[0].features)
        label_counts: dict[str, int] = {}
        # (label, position, value) → count
        feature_counts: dict[str, list[dict[str, int]]] = {}
        for p in points:
            if len(p.features) != n_positions:
                raise ValueError("inconsistent feature vector lengths")
            label_counts[p.label] = label_counts.get(p.label, 0) + 1
            per_pos = feature_counts.setdefault(
                p.label, [dict() for _ in range(n_positions)]
            )
            for pos, value in enumerate(p.features):
                per_pos[pos][value] = per_pos[pos].get(value, 0) + 1
        total = len(points)
        priors = {lb: math.log(c / total) for lb, c in label_counts.items()}
        likelihoods = {
            lb: [
                {v: math.log(c / label_counts[lb]) for v, c in pos_map.items()}
                for pos_map in per_pos
            ]
            for lb, per_pos in feature_counts.items()
        }
        return CategoricalNaiveBayesModel(priors=priors, likelihoods=likelihoods)
