"""First-order Markov chain with top-N transition pruning (a copy of
the JAX package's ``e2/markov_chain.py``).

Reference: e2/src/main/scala/io/prediction/e2/engine/MarkovChain.scala:25-89
— builds a row-normalized transition matrix from a CoordinateMatrix of
counts, keeping only each row's top-N entries; predict = current state
distribution × transition matrix."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MarkovChainModel:
    """Row-normalized pruned transitions, dense (N_states is vocabulary
    scale, not user scale)."""

    transition: np.ndarray  # (S, S) float32, rows sum to 1 (or 0 if unseen)
    top_n: int

    def predict(self, state_probs: np.ndarray) -> np.ndarray:
        """Next-state distribution (reference MarkovChainModel.predict)."""
        return np.asarray(state_probs, dtype=np.float32) @ self.transition


class MarkovChain:
    """Reference object MarkovChain.train:~35."""

    @staticmethod
    def train(
        rows: np.ndarray,
        cols: np.ndarray,
        counts: np.ndarray,
        n_states: int,
        top_n: int,
    ) -> MarkovChainModel:
        """rows/cols/counts are COO transition counts (from→to→count)."""
        m = np.zeros((n_states, n_states), dtype=np.float64)
        np.add.at(m, (np.asarray(rows), np.asarray(cols)), np.asarray(counts))
        if top_n < n_states:
            # zero everything below each row's top-N
            kth = np.partition(m, -top_n, axis=1)[:, -top_n]
            m[m < kth[:, None]] = 0.0
        row_sums = m.sum(axis=1, keepdims=True)
        np.divide(m, row_sums, out=m, where=row_sums > 0)
        return MarkovChainModel(transition=m.astype(np.float32), top_n=top_n)
