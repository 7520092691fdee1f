"""Metrics registry: counters, gauges and histograms with labels.

Counterpart of the JAX package's ``obs/registry.py``, the port's own
copy, cut to what the online consumer records: families created or
fetched by name (a second registration with another type, label set or
bucket set raises), one lock a family over child creation and updates,
fixed cumulative histogram buckets with quantiles interpolated inside
the target bucket (what Prometheus' ``histogram_quantile`` computes),
and the process-wide default registry. The text exposition and
snapshot, callback gauges, the trace exemplars and the JAX runtime
gauges are not ported: the port mounts no ``/metrics`` route yet.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

# latency seconds: sub-ms device calls to multi-second trains
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class _Value:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _Histogram:
    __slots__ = ("bucket_counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * (n_buckets + 1)  # the last: +Inf
        self.sum = 0.0
        self.count = 0


class MetricFamily:
    """One named metric and its children, one a label set."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}

    def _new_child(self) -> Any:
        return _Value()

    def _child(self, labelvalues: tuple[str, ...]) -> Any:
        child = self._children.get(labelvalues)
        if child is None:
            child = self._children[labelvalues] = self._new_child()
        return child

    def _values(self, **labels: Any) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def value(self, **labels: Any) -> float:
        with self._lock:
            child = self._children.get(self._values(**labels))
            return child.value if child is not None else 0.0


class CounterFamily(MetricFamily):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._child(self._values(**labels)).value += amount

    @property
    def total(self) -> float:
        with self._lock:
            return sum(c.value for c in self._children.values())


class GaugeFamily(MetricFamily):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._child(self._values(**labels)).value = float(value)


class HistogramFamily(MetricFamily):
    kind = "histogram"

    def __init__(self, name, help_text, labelnames,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help_text, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")

    def _new_child(self) -> _Histogram:
        return _Histogram(len(self.buckets))

    def observe(self, value: float, **labels: Any) -> None:
        value = float(value)
        with self._lock:
            child = self._child(self._values(**labels))
            i = next((n for n, edge in enumerate(self.buckets) if value <= edge),
                     len(self.buckets))
            child.bucket_counts[i] += 1
            child.sum += value
            child.count += 1

    def _get(self, labels: dict) -> Optional[_Histogram]:
        return self._children.get(self._values(**labels))

    def count_of(self, **labels: Any) -> int:
        with self._lock:
            c = self._get(labels)
            return c.count if c else 0

    def sum_of(self, **labels: Any) -> float:
        with self._lock:
            c = self._get(labels)
            return c.sum if c else 0.0

    def quantile(self, q: float, **labels: Any) -> float:
        """Quantile `q` by linear interpolation inside the target
        cumulative bucket, the first from 0; the highest finite edge
        when it falls in +Inf."""
        with self._lock:
            c = self._get(labels)
            if c is None or c.count == 0:
                return 0.0
            target = q * c.count
            cum = 0
            prev_edge = 0.0
            for edge, n in zip(self.buckets, c.bucket_counts):
                if n and cum + n >= target:
                    frac = (target - cum) / n
                    return prev_edge + (edge - prev_edge) * frac
                cum += n
                prev_edge = edge
            return self.buckets[-1]


class MetricsRegistry:
    """Create-or-get metric families by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}

    def _get_or_create(self, cls: type, name: str, help_text: str,
                       labelnames: Sequence[str], **kw) -> Any:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help_text,
                                                 tuple(labelnames), **kw)
                return fam
            if not isinstance(fam, cls) or tuple(labelnames) != fam.labelnames:
                raise ValueError(f"metric {name!r} re-registered with a "
                                 f"different type or label set")
            if "buckets" in kw and (
                tuple(sorted(float(b) for b in kw["buckets"])) != fam.buckets
            ):
                raise ValueError(f"histogram {name!r} re-registered with "
                                 f"different buckets")
            return fam

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> CounterFamily:
        return self._get_or_create(CounterFamily, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> GaugeFamily:
        return self._get_or_create(GaugeFamily, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> HistogramFamily:
        return self._get_or_create(HistogramFamily, name, help_text, labelnames,
                                   buckets=buckets)


_default_registry = MetricsRegistry()


def get_default_registry() -> MetricsRegistry:
    """The process-wide registry: whatever no server owns records here."""
    return _default_registry
