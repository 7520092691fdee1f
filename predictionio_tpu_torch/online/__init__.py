"""Online learning: live events folded into the serving model between
retrains.

Counterpart of the JAX package's ``online/``: a stream consumer
(``consumer.py``) tails the event store's insert revisions from a
durable cursor; the fold-in (``foldin.py``) re-solves each dirty user's
and new item's factor row against the fixed opposite side
(``models/als.py:fold_in_rows``) and publishes only those rows into the
staged serving state; a drift guard (``drift.py``) holds the folded
model to the last-trained baseline. The new runtime swaps in under the
query server's swap lock, or, for one tenant of a multi-tenant server,
through the model cache's conditional swap (``TenantApplyHost``).
"""

from predictionio_tpu_torch.online.consumer import (
    CURSOR_ENTITY,
    OnlineConsumer,
    OnlineConsumerConfig,
    ServerApplyHost,
    TenantApplyHost,
)
from predictionio_tpu_torch.online.drift import DriftGuard, score_drift
from predictionio_tpu_torch.online.foldin import ALSFoldIn, FoldInConfig

__all__ = [
    "ALSFoldIn",
    "CURSOR_ENTITY",
    "DriftGuard",
    "FoldInConfig",
    "OnlineConsumer",
    "OnlineConsumerConfig",
    "ServerApplyHost",
    "TenantApplyHost",
    "score_drift",
]
