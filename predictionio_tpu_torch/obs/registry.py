"""Metrics registry: counters, gauges and labeled histograms, with the
Prometheus text exposition.

Counterpart of the JAX package's ``obs/registry.py``, the port's own
copy. Servers mount their registry at ``GET /metrics`` (Prometheus text
exposition v0.0.4, merged with the process-default registry that the
train workflow and the device profiler record into), and the console
renders snapshots of it. The rendered text is byte for byte the JAX
registry's for the same sequence of operations.

Thread-safety: one lock per metric family guards both child creation
and child mutation — servers update from many handler threads. A second
registration of a name with another type, label set or bucket set
raises. Histograms use fixed cumulative buckets and derive p50/p95/p99
by linear interpolation inside the target bucket (what Prometheus'
``histogram_quantile`` computes). A histogram observed while a request
trace is in scope keeps the slowest few trace ids of each label set as
exemplars (``PIO_TRACE_EXEMPLARS``, default 4; 0 disables them)."""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence

from predictionio_tpu_torch.obs.tracing import current_trace_id
from predictionio_tpu_torch.utils.env import env_int

# latency seconds: sub-ms device calls to multi-second trains
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# micro-batch depth: powers of two up to 2x the default max_batch of 64
BATCH_SIZE_BUCKETS: tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str],
               extra: Optional[tuple[str, str]] = None) -> str:
    pairs = list(zip(labelnames, labelvalues))
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs
    )
    return "{" + inner + "}"


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

    def remove(self, **labels: Any) -> bool:
        """Drop one label set's child (an open-ended label value, such as
        a resolved external alert's name, must not leave a dead series on
        /metrics); returns whether it existed."""
        with self._lock:
            return self._children.pop(self._values(**labels), None) is not None

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

    def __init__(self, name, help_text, labelnames,
                 callback: Optional[Callable[[], float]] = None):
        super().__init__(name, help_text, labelnames)
        if callback is not None and labelnames:
            raise ValueError("callback gauges cannot be labeled")
        self.callback = callback

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._child(self._values(**labels)).value = float(value)

    def value(self, **labels: Any) -> float:
        if self.callback is not None:
            try:
                return float(self.callback())
            except Exception:  # noqa: BLE001 — a scrape never fails on a gauge
                return 0.0
        return super().value(**labels)


class HistogramFamily(MetricFamily):
    kind = "histogram"

    def __init__(self, name, help_text, labelnames,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 lower_bound: float = 0.0):
        super().__init__(name, help_text, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        # smallest value observe() may receive: quantile() interpolates
        # the first bucket from here (count-valued histograms pass 1)
        self.lower_bound = float(lower_bound)
        # the slowest (trace id, value) pairs observed per label set
        # while a request trace was in scope, one slot per trace id
        self._exemplar_cap = env_int("PIO_TRACE_EXEMPLARS", 4)
        self._exemplars: dict[
            tuple[str, ...], dict[str, tuple[float, float]]
        ] = {}

    def _new_child(self) -> _Histogram:
        return _Histogram(len(self.buckets))

    def observe(self, value: float, **labels: Any) -> None:
        value = float(value)
        tid = current_trace_id() if self._exemplar_cap > 0 else None
        with self._lock:
            lv = self._values(**labels)
            child = self._child(lv)
            i = next((n for n, edge in enumerate(self.buckets) if value <= edge),
                     len(self.buckets))
            child.bucket_counts[i] += 1
            child.sum += value
            child.count += 1
            if tid is not None:
                self._note_exemplar_locked(lv, tid, value)

    def _note_exemplar_locked(self, lv: tuple[str, ...], tid: str,
                              value: float) -> None:
        d = self._exemplars.setdefault(lv, {})
        prev = d.get(tid)
        if prev is not None:
            if value > prev[0]:
                d[tid] = (value, time.time())
            return
        if len(d) >= self._exemplar_cap:
            floor_tid = min(d, key=lambda t: d[t])
            if value <= d[floor_tid][0]:
                return
            del d[floor_tid]
        d[tid] = (value, time.time())

    def exemplars(self) -> list[dict]:
        """Retained exemplars, slowest first: [{trace_id, value, ts,
        labels}], `labels` the observing label set."""
        with self._lock:
            items = [
                (lv, tid, val, ts)
                for lv, d in self._exemplars.items()
                for tid, (val, ts) in d.items()
            ]
        items.sort(key=lambda row: row[2], reverse=True)
        return [
            {
                "trace_id": tid, "value": val, "ts": ts,
                "labels": dict(zip(self.labelnames, lv)),
            }
            for lv, tid, val, ts in items
        ]

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
        cumulative bucket, the first from `lower_bound`; the highest
        finite edge when it falls in +Inf."""
        with self._lock:
            c = self._get(labels)
            if c is None or c.count == 0:
                return 0.0
            target = q * c.count
            cum = 0
            prev_edge = self.lower_bound
            for edge, n in zip(self.buckets, c.bucket_counts):
                if n and cum + n >= target:
                    frac = (target - cum) / n
                    return prev_edge + (edge - prev_edge) * frac
                cum += n
                prev_edge = edge
            return self.buckets[-1]

    # unlabeled-family conveniences (the servers' hot-path histograms)
    @property
    def count(self) -> int:
        return self.count_of()

    @property
    def mean(self) -> float:
        with self._lock:
            c = self._children.get(())
            if c is None or c.count == 0:
                return 0.0
            return c.sum / c.count


class MetricsRegistry:
    """Create-or-get metric families by name; render/snapshot them all."""

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
                or float(kw.get("lower_bound", 0.0)) != fam.lower_bound
            ):
                raise ValueError(f"histogram {name!r} re-registered with "
                                 f"different buckets")
            if kw.get("callback") is not None and isinstance(fam, GaugeFamily):
                # the newest callback wins: a re-attached component must
                # not leave /metrics reading (and keeping alive) a dead one
                fam.callback = kw["callback"]
            return fam

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> CounterFamily:
        return self._get_or_create(CounterFamily, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> GaugeFamily:
        return self._get_or_create(GaugeFamily, name, help_text, labelnames)

    def gauge_callback(self, name: str, help_text: str,
                       callback: Callable[[], float]) -> GaugeFamily:
        """Gauge sampled at render/snapshot time (e.g. device memory)."""
        return self._get_or_create(
            GaugeFamily, name, help_text, (), callback=callback
        )

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  lower_bound: float = 0.0) -> HistogramFamily:
        return self._get_or_create(HistogramFamily, name, help_text, labelnames,
                                   buckets=buckets, lower_bound=lower_bound)

    def families(self) -> list[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    # -- exposition --------------------------------------------------------
    def render(self) -> str:
        return render_families(self.families())

    def snapshot(self) -> dict:
        """JSON-able view: counters/gauges → value, histograms → count,
        sum, mean, p50/p95/p99 per label set."""
        out: dict[str, Any] = {}
        for fam in sorted(self.families(), key=lambda f: f.name):
            rows = []
            if isinstance(fam, GaugeFamily) and fam.callback is not None:
                rows.append({"labels": {}, "value": fam.value()})
            elif isinstance(fam, HistogramFamily):
                with fam._lock:
                    items = list(fam._children.items())
                for lv, c in items:
                    row = {
                        "labels": dict(zip(fam.labelnames, lv)),
                        "count": c.count,
                        "sum": round(c.sum, 6),
                        "mean": round(c.sum / c.count, 6) if c.count else 0.0,
                    }
                    for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                        row[key] = round(fam.quantile(q, **row["labels"]), 6)
                    rows.append(row)
            else:
                with fam._lock:
                    items = list(fam._children.items())
                for lv, c in items:
                    rows.append({
                        "labels": dict(zip(fam.labelnames, lv)),
                        "value": c.value,
                    })
            if rows:
                out[fam.name] = {"type": fam.kind, "values": rows}
        return out


def render_families(families: Iterable[MetricFamily]) -> str:
    """Prometheus text exposition format v0.0.4."""
    lines: list[str] = []
    for fam in sorted(families, key=lambda f: f.name):
        lines.append(f"# HELP {fam.name} {fam.help or fam.name}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        if isinstance(fam, GaugeFamily) and fam.callback is not None:
            lines.append(f"{fam.name} {_format_value(fam.value())}")
            continue
        with fam._lock:
            items = sorted(fam._children.items())
            if isinstance(fam, HistogramFamily):
                for lv, c in items:
                    cum = 0
                    for edge, n in zip(fam.buckets, c.bucket_counts):
                        cum += n
                        ls = _label_str(
                            fam.labelnames, lv, ("le", _format_value(edge))
                        )
                        lines.append(f"{fam.name}_bucket{ls} {cum}")
                    ls = _label_str(fam.labelnames, lv, ("le", "+Inf"))
                    lines.append(f"{fam.name}_bucket{ls} {c.count}")
                    ls = _label_str(fam.labelnames, lv)
                    lines.append(f"{fam.name}_sum{ls} {_format_value(c.sum)}")
                    lines.append(f"{fam.name}_count{ls} {c.count}")
            else:
                if not items and not fam.labelnames:
                    lines.append(f"{fam.name} 0")
                for lv, c in items:
                    ls = _label_str(fam.labelnames, lv)
                    lines.append(f"{fam.name}{ls} {_format_value(c.value)}")
        if isinstance(fam, HistogramFamily):
            # exemplars ride as comment lines (a scraper that does not
            # read them skips '#'), outside the family lock, which
            # exemplars() takes; the trailing token is the observing
            # label set as compact JSON, omitted for label-less families
            for ex in fam.exemplars():
                line = (
                    f"# EXEMPLAR {fam.name} {ex['trace_id']} "
                    f"{repr(float(ex['value']))} {ex['ts']:.3f}"
                )
                if ex.get("labels"):
                    line += " " + json.dumps(
                        ex["labels"], separators=(",", ":"), sort_keys=True,
                    )
                lines.append(line)
    return "\n".join(lines) + "\n"


def render_merged(*registries: Optional[MetricsRegistry]) -> str:
    """Render several registries as one exposition document, the first
    registry winning on family-name collisions (a server scrape shows
    its own registry plus the process-default one)."""
    seen: set[str] = set()
    families: list[MetricFamily] = []
    for reg in registries:
        if reg is None:
            continue
        for fam in reg.families():
            if fam.name not in seen:
                seen.add(fam.name)
                families.append(fam)
    return render_families(families)


_default_registry = MetricsRegistry()


def get_default_registry() -> MetricsRegistry:
    """The process-wide registry: train workflows, the device profiler's
    padding accounting and whatever no server owns record here."""
    return _default_registry
