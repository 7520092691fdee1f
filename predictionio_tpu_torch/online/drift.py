"""Score-distribution drift guard of the online fold-in.

Counterpart of the JAX package's ``online/drift.py``. Fold-in bypasses
a canary, so the guard checks statistically: the baseline and the
folded model score the same fixed sample of (user, item) pairs, drawn
from the rows both share (fold-in appends rows, never reorders them),
and the drift is the mean shift of the nine deciles over the baseline's
inter-quartile range: 0 when nothing changed, order 1 when the folded
scores no longer resemble the trained ones. Past the threshold the
consumer pauses fold-in and the last-good model keeps serving.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

_DECILES = np.linspace(0.1, 0.9, 9)


def score_drift(
    baseline_factors: Any,
    current_factors: Any,
    sample_users: int = 128,
    sample_items: int = 256,
    seed: int = 0,
) -> float:
    """Drift between two ALS factor sets' score distributions, sampled
    over the row range both share: the new users and items, which
    fold-in is meant to change, are left out."""
    n_u = min(baseline_factors.user_factors.shape[0],
              current_factors.user_factors.shape[0])
    n_i = min(baseline_factors.item_factors.shape[0],
              current_factors.item_factors.shape[0])
    if n_u == 0 or n_i == 0:
        return 0.0
    rng = np.random.RandomState(seed)
    u_rows = rng.randint(0, n_u, size=min(sample_users, n_u))
    i_rows = rng.randint(0, n_i, size=min(sample_items, n_i))

    def deciles(f) -> tuple[np.ndarray, float]:
        scores = (
            f.user_factors[u_rows].astype(np.float64)
            @ f.item_factors[i_rows].astype(np.float64).T
        ).ravel()
        iqr = float(np.quantile(scores, 0.75) - np.quantile(scores, 0.25))
        return np.quantile(scores, _DECILES), iqr

    q_base, iqr_base = deciles(baseline_factors)
    q_cur, _ = deciles(current_factors)
    return float(np.mean(np.abs(q_cur - q_base)) / max(iqr_base, 1e-6))


class DriftGuard:
    """The last-trained baseline and the check of folded models against
    it; the consumer rebases it whenever the runtime changes under it (a
    retrain)."""

    def __init__(self, threshold: float = 1.0, sample_users: int = 128,
                 sample_items: int = 256, seed: int = 0):
        self.threshold = float(threshold)
        self.sample_users = sample_users
        self.sample_items = sample_items
        self.seed = seed
        self._baseline: Optional[Any] = None  # ALSFactors, by reference
        self.last_drift: float = 0.0

    @property
    def has_baseline(self) -> bool:
        return self._baseline is not None

    def rebase(self, factors: Any) -> None:
        """Adopt `factors` as the baseline: a reference, since fold-in
        never writes a published factor array."""
        self._baseline = factors
        self.last_drift = 0.0

    def check(self, factors: Any) -> float:
        """Drift of `factors` from the baseline (0.0 with none)."""
        if self._baseline is None:
            return 0.0
        self.last_drift = score_drift(
            self._baseline, factors, sample_users=self.sample_users,
            sample_items=self.sample_items, seed=self.seed,
        )
        return self.last_drift

    def breached(self, factors: Any) -> bool:
        return self.check(factors) > self.threshold
