"""Observability of the port: the metrics registry (``registry.py``)."""

from predictionio_tpu_torch.obs.registry import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
    get_default_registry,
)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "MetricsRegistry",
    "get_default_registry",
]
