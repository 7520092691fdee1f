"""Observability of the port: the metrics registry and its Prometheus
exposition (``registry.py``), request tracing (``tracing.py``),
hierarchical spans with tail sampling (``spans.py``), the device
profiler (``devprof.py``, its work counts in ``costs.py``), the CUDA
runtime gauges with the kernel-build counter (``cudamon.py``), and the
monitoring plane (``monitor/``: the time-series history, SLO alerts,
fleet scrape and the trace collector). Importing it loads no torch."""

from predictionio_tpu_torch.obs.cudamon import install_cuda_gauges
from predictionio_tpu_torch.obs.devprof import install_devprof_gauges
from predictionio_tpu_torch.obs.registry import (
    BATCH_SIZE_BUCKETS,
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
    get_default_registry,
    render_merged,
)
from predictionio_tpu_torch.obs.spans import (
    Span,
    SpanRecorder,
    current_span_id,
    get_default_recorder,
    span,
)
from predictionio_tpu_torch.obs.tracing import (
    current_trace_id,
    log_access,
    new_request_id,
    trace_context,
)

__all__ = [
    "BATCH_SIZE_BUCKETS",
    "DEFAULT_LATENCY_BUCKETS",
    "MetricsRegistry",
    "Span",
    "SpanRecorder",
    "current_span_id",
    "current_trace_id",
    "get_default_recorder",
    "get_default_registry",
    "install_cuda_gauges",
    "install_devprof_gauges",
    "log_access",
    "new_request_id",
    "render_merged",
    "server_registry",
    "span",
    "trace_context",
]


def server_registry() -> MetricsRegistry:
    """A fresh per-server registry with the CUDA runtime and device-profile
    gauges mounted: what every server binds to its ``GET /metrics``."""
    reg = MetricsRegistry()
    install_cuda_gauges(reg)
    install_devprof_gauges(reg)
    return reg
