"""CUDA runtime gauges and the kernel-build counter.

Counterpart of the JAX package's ``obs/jaxmon.py``. XLA compiles a
program at its first call; the port builds its CUDA sources with
``nvcc`` and loads them with ``ctypes`` (``ops/_build.py``), which
reports each build and load here. ``build_snapshot()`` is what the
device profiler diffs around a signature's first call, so that a build
paid inside the timed window stays out of the device seconds.

``install_cuda_gauges`` mounts the device's allocated, reserved and
peak-allocated bytes (the caching allocator's counters) as callback
gauges sampled at scrape time, with the build count and seconds. A
process that has not touched CUDA reads 0: neither importing this
module nor a scrape imports torch or initialises a device.
"""

from __future__ import annotations

import sys
import threading

from predictionio_tpu_torch.obs.registry import MetricsRegistry

_lock = threading.Lock()
_build_count = 0  # guarded-by: _lock
_build_seconds = 0.0  # guarded-by: _lock


def record_build(seconds: float, count: int = 1) -> None:
    """Account `count` kernel builds or loads that took `seconds` (called
    by ``ops/_build.py``)."""
    global _build_count, _build_seconds
    with _lock:
        _build_count += count
        _build_seconds += max(0.0, float(seconds))


def build_snapshot() -> tuple[int, float]:
    """(builds and loads seen, seconds spent) so far."""
    with _lock:
        return _build_count, _build_seconds


def _cuda_in_use():
    """torch's CUDA module when this process has already initialised
    CUDA, else None (never imports torch, never initialises a device)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
    except Exception:  # noqa: BLE001 — a torch without CUDA support
        return None
    return torch.cuda


def _memory(stat: str) -> float:
    cuda = _cuda_in_use()
    if cuda is None:
        return 0.0
    try:
        return float(getattr(cuda, stat)())
    except Exception:  # noqa: BLE001 — a scrape never fails on a gauge
        return 0.0


def install_cuda_gauges(registry: MetricsRegistry) -> None:
    """Register the CUDA runtime gauges on `registry` (idempotent)."""
    registry.gauge_callback(
        "cuda_kernel_build_count",
        "CUDA kernel library builds and loads in this process",
        lambda: float(build_snapshot()[0]),
    )
    registry.gauge_callback(
        "cuda_kernel_build_seconds_total",
        "seconds spent building and loading CUDA kernel libraries",
        lambda: build_snapshot()[1],
    )
    registry.gauge_callback(
        "cuda_memory_allocated_bytes",
        "bytes held by tensors on the current CUDA device (sampled at scrape)",
        lambda: _memory("memory_allocated"),
    )
    registry.gauge_callback(
        "cuda_memory_reserved_bytes",
        "bytes the caching allocator holds on the current CUDA device",
        lambda: _memory("memory_reserved"),
    )
    registry.gauge_callback(
        "cuda_memory_peak_allocated_bytes",
        "peak bytes held by tensors on the current CUDA device",
        lambda: _memory("max_memory_allocated"),
    )
