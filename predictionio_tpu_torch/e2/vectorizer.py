"""(property, value) → one-hot index encoder (a copy of the JAX
package's ``e2/vectorizer.py``).

Reference: e2/src/main/scala/io/prediction/e2/engine/BinaryVectorizer.scala:
24-44 — builds an index over the observed (property, value) pairs and maps
a property map to a binary vector."""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np


class BinaryVectorizer:
    def __init__(self, index: dict[tuple[str, str], int]):
        self.index = index

    @property
    def num_features(self) -> int:
        return len(self.index)

    @staticmethod
    def fit(
        maps: Iterable[Mapping[str, str]], properties: Iterable[str]
    ) -> "BinaryVectorizer":
        """Index every (property, value) seen across `maps`, restricted to
        `properties` (reference BinaryVectorizer.apply:44)."""
        props = set(properties)
        pairs = sorted(
            {
                (k, str(v))
                for m in maps
                for k, v in m.items()
                if k in props
            }
        )
        return BinaryVectorizer({pair: i for i, pair in enumerate(pairs)})

    def to_binary(self, m: Mapping[str, str]) -> np.ndarray:
        out = np.zeros(len(self.index), dtype=np.float32)
        for k, v in m.items():
            ix = self.index.get((k, str(v)))
            if ix is not None:
                out[ix] = 1.0
        return out

    def to_matrix(self, maps: Iterable[Mapping[str, str]]) -> np.ndarray:
        """Batch encode: one (N, F) float32 matrix."""
        return np.stack([self.to_binary(m) for m in maps])
