"""In-process time-series history: a fixed-capacity ring-buffer TSDB.

Counterpart of the JAX package's ``obs/monitor/tsdb.py``, the port's own
copy. ``/metrics``, ``/debug/traces`` and ``/debug/profile`` are
point-in-time; this module keeps a bounded window of history in the
process, so "when did p99 start degrading" has an answer without an
external Prometheus:

- :class:`TSDB`: a thread-safe map of (name, sorted label pairs) to a
  ring of ``(epoch_seconds, value)`` points (a deque: O(1) append, the
  oldest point falls off at capacity). Past ``max_series`` series, new
  series are dropped and counted (``dropped_series``) instead of growing
  without bound.
- :class:`MetricsSampler`: a background thread that snapshots metric
  families every ``interval_s``: counters and gauges land as their
  cumulative or current values; histograms as ``_count``/``_sum``, the
  cumulative ``_bucket{le=}`` series (the SLO engine's latency math
  reads them) and p50/p95/p99 gauges under a ``quantile`` label.
  Counter rates are derived at query time: ``rate()``/``increase()``
  walk the ring reset-aware, so a restarted server's counters make no
  negative spike.
- :class:`RecordingRule`: derived series evaluated once a sampler tick
  and stored as points; :class:`SnapshotWriter` persists the rings.

``GET /debug/tsdb`` is a window onto the query API. Standard library
only: the data-plane processes that import it never load torch.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

from predictionio_tpu_torch.obs.registry import (
    CounterFamily,
    GaugeFamily,
    HistogramFamily,
    MetricFamily,
)
from predictionio_tpu_torch.utils.env import monitor_knob

LabelPairs = tuple[tuple[str, str], ...]


def _label_key(labels: Optional[dict]) -> LabelPairs:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Series:
    """One named and labeled series' ring of (t, value) points."""

    __slots__ = ("name", "labels", "kind", "points")

    def __init__(self, name: str, labels: LabelPairs, kind: str, capacity: int):
        self.name = name
        self.labels = labels
        self.kind = kind
        self.points: deque[tuple[float, float]] = deque(maxlen=capacity)

    def labels_dict(self) -> dict[str, str]:
        return dict(self.labels)


def increase_of(points: Iterable[tuple[float, float]]) -> float:
    """Counter increase across `points`, reset-aware: a drop between
    consecutive samples means the process restarted and the counter began
    again from zero, so the post-reset value is the delta (Prometheus'
    semantics). Gauge series do not come here."""
    total = 0.0
    prev: Optional[float] = None
    for _t, v in points:
        if prev is not None:
            total += (v - prev) if v >= prev else v
        prev = v
    return total


def quantile_of(values: list[float], q: float) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = min(max(q, 0.0), 1.0) * (len(vs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    frac = pos - lo
    return vs[lo] + (vs[hi] - vs[lo]) * frac


class TSDB:
    """Thread-safe fixed-capacity ring-buffer time-series store."""

    def __init__(self, capacity: int = 720, max_series: int = 4096):
        self.capacity = max(2, int(capacity))
        self.max_series = max(1, int(max_series))
        self._lock = threading.Lock()
        self._series: "OrderedDict[tuple[str, LabelPairs], Series]" = OrderedDict()
        self.dropped_series = 0  # adds refused at the cardinality cap

    # -- writing -----------------------------------------------------------
    def add(self, name: str, labels: Optional[dict], value: float,
            kind: str = "gauge", t: Optional[float] = None) -> bool:
        """Append one point; False when the series would pass the
        cardinality cap (dropped and counted, never raised).

        Points stay in time order even when they arrive out of order (a
        snapshot restored after live sampling began): `increase()` and
        `rate()` walk the ring in sequence, and an interleaved restore
        would read as a counter reset and double-count the window."""
        key = (name, _label_key(labels))
        now = time.time() if t is None else t
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return False
                series = self._series[key] = Series(name, key[1], kind, self.capacity)
            pts = series.points
            if pts and now < pts[-1][0]:
                # out of order (rare): rebuild with the point in its time
                # slot; the deque's maxlen still drops the oldest
                ordered = list(pts)
                idx = len(ordered)
                while idx > 0 and ordered[idx - 1][0] > now:
                    idx -= 1
                ordered.insert(idx, (now, float(value)))
                series.points = deque(ordered, maxlen=self.capacity)
            else:
                pts.append((now, float(value)))
        return True

    # -- reading -----------------------------------------------------------
    def _match_locked(self, name: str, match: Optional[dict]) -> list[Series]:
        want = None if match is None else _label_key(match)
        out = []
        for (n, lbls), series in self._series.items():
            if n != name:
                continue
            if want is not None and not set(want) <= set(lbls):
                continue
            out.append(series)
        return out

    def matching(self, name: str, match: Optional[dict] = None) -> list[Series]:
        """Series named `name` whose labels are a superset of `match`."""
        with self._lock:
            return list(self._match_locked(name, match))

    def points(self, series: Series, window_s: Optional[float] = None,
               now: Optional[float] = None) -> list[tuple[float, float]]:
        now = time.time() if now is None else now
        with self._lock:
            pts = list(series.points)
        if window_s is None:
            return pts
        cutoff = now - window_s
        return [(t, v) for t, v in pts if t >= cutoff]

    def range(self, name: str, match: Optional[dict] = None,
              window_s: Optional[float] = None,
              now: Optional[float] = None) -> list[dict[str, Any]]:
        """The `GET /debug/tsdb?name=` payload: every matching series with
        its in-window points."""
        return [
            {"name": s.name, "labels": s.labels_dict(), "kind": s.kind,
             "points": [[round(t, 3), v] for t, v in self.points(s, window_s, now)]}
            for s in self.matching(name, match)
        ]

    def series_increase(self, series: Series, window_s: Optional[float] = None,
                        now: Optional[float] = None) -> float:
        """Reset-aware increase of one series over the window. The last
        sample before the window is the baseline: without it a window
        holding a single sample would always read as no increase."""
        now = time.time() if now is None else now
        with self._lock:
            pts = list(series.points)
        if window_s is None:
            return increase_of(pts)
        cutoff = now - window_s
        idx = 0
        for idx, (t, _v) in enumerate(pts):
            if t >= cutoff:
                break
        else:
            return 0.0  # nothing in the window: no observable activity
        windowed = pts[idx:]
        if idx > 0:
            windowed = [pts[idx - 1]] + windowed
        return increase_of(windowed)

    def increase(self, name: str, match: Optional[dict] = None,
                 window_s: Optional[float] = None,
                 now: Optional[float] = None) -> float:
        """Reset-aware increase summed over the matching series."""
        return sum(self.series_increase(s, window_s, now)
                   for s in self.matching(name, match))

    def rate(self, name: str, match: Optional[dict] = None,
             window_s: float = 300.0, now: Optional[float] = None) -> float:
        """Per-second rate over the window (increase / window)."""
        if window_s <= 0:
            return 0.0
        return self.increase(name, match, window_s, now) / window_s

    def quantile_over_time(self, name: str, q: float, match: Optional[dict] = None,
                           window_s: Optional[float] = None,
                           now: Optional[float] = None) -> Optional[float]:
        """Quantile of the sampled values across the window (gauge
        series)."""
        values: list[float] = []
        for s in self.matching(name, match):
            values.extend(v for _t, v in self.points(s, window_s, now))
        return quantile_of(values, q)

    def latest(self, name: str, match: Optional[dict] = None) -> Optional[float]:
        pt = self.latest_point(name, match)
        return None if pt is None else pt[1]

    def latest_point(self, name: str, match: Optional[dict] = None
                     ) -> Optional[tuple[float, float]]:
        """The newest (t, value) across the matching series: readers that
        need freshness (the SLO engine's recorded ratios) check the time."""
        best: Optional[tuple[float, float]] = None
        for s in self.matching(name, match):
            with self._lock:
                pt = s.points[-1] if s.points else None
            if pt is not None and (best is None or pt[0] > best[0]):
                best = pt
        return best

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def summary(self, limit: int = 0) -> dict[str, Any]:
        """The parameterless `GET /debug/tsdb` payload: one row a series,
        no points (those come by name)."""
        with self._lock:
            rows = [
                {"name": s.name, "labels": s.labels_dict(), "kind": s.kind,
                 "points": len(s.points),
                 "last": s.points[-1][1] if s.points else None,
                 "last_t": round(s.points[-1][0], 3) if s.points else None}
                for s in self._series.values()
            ]
        rows.sort(key=lambda r: (r["name"], sorted(r["labels"].items())))
        if limit:
            rows = rows[:limit]
        return {"series": rows, "series_count": self.series_count(),
                "capacity": self.capacity, "max_series": self.max_series,
                "dropped_series": self.dropped_series}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self.dropped_series = 0


# -- recording rules ----------------------------------------------------------
#
# Declarative derived series, evaluated once a sampler tick and stored as
# points: a rate, an error ratio, a bucket quantile or an expression over
# the raw rings. Readers (the SLO engine, the dashboard, the console) then
# read one point instead of rescanning the raw bucket rings. Rules parse
# from PIO_RECORDING_RULES (a JSON array or ``@/path.json``); the monitor
# adds per-SLO ratio series on top (slo.record_slo_ratios).

RULE_KINDS = ("rate", "error_ratio", "quantile", "expr")


def bucket_quantile(tsdb: TSDB, name: str, q: float, match: Optional[dict] = None,
                    window_s: Optional[float] = None,
                    now: Optional[float] = None) -> Optional[float]:
    """histogram_quantile over the raw cumulative ``<name>_bucket`` rings:
    each edge's increase across the window, then linear interpolation
    inside the target bucket (None with no traffic)."""
    inc_by_le: dict[float, float] = {}
    for s in tsdb.matching(name + "_bucket", match):
        le_s = s.labels_dict().get("le", "")
        try:
            le = float("inf") if le_s == "+Inf" else float(le_s)
        except ValueError:
            continue
        inc_by_le[le] = inc_by_le.get(le, 0.0) + tsdb.series_increase(s, window_s, now)
    if not inc_by_le:
        return None
    edges = sorted(inc_by_le)
    total = inc_by_le.get(float("inf"), max(inc_by_le.values()))
    if total <= 0:
        return None
    target = min(max(q, 0.0), 1.0) * total
    prev_edge = 0.0
    prev_cum = 0.0
    for le in edges:
        cum = inc_by_le[le]
        if cum >= target:
            if le == float("inf"):
                # past the finite edges: the highest finite edge is the
                # best bounded estimate (as the registry gives it)
                finite = [e for e in edges if e != float("inf")]
                return finite[-1] if finite else None
            n = cum - prev_cum
            frac = (target - prev_cum) / n if n > 0 else 0.0
            return prev_edge + (le - prev_edge) * frac
        prev_edge = 0.0 if le == float("inf") else le
        prev_cum = cum
    finite = [e for e in edges if e != float("inf")]
    return finite[-1] if finite else None


@dataclass(frozen=True)
class RecordingRule:
    """One derived-series rule.

    record     output series name (stored as a gauge)
    kind       "rate" | "error_ratio" | "quantile" | "expr"
    source     raw family name (the counter for rate/error_ratio, the
               histogram's base name for quantile; unused by expr rules)
    expr       expr rules: a series expression (obs.monitor.expr), which
               may give a vector: one point a label set, the expression's
               labels merged under `labels`
    match      label matcher on the source series
    labels     labels stamped on the derived series
    window_s   evaluation window (default 300)
    q          quantile rules: the quantile (default 0.99)
    bad_label  error_ratio rules: the label that marks badness
    bad_min    bad when int(label) >= bad_min
    bad_values exact-match alternative to bad_min
    """

    record: str
    kind: str
    source: str = ""
    expr: str = ""
    match: tuple = ()
    labels: tuple = ()
    window_s: float = 300.0
    q: float = 0.99
    bad_label: str = "status"
    bad_min: Optional[float] = 500.0
    bad_values: tuple = ()

    def __post_init__(self):
        if self.kind not in RULE_KINDS:
            raise ValueError(f"rule {self.record!r}: unknown kind {self.kind!r} "
                             f"(known: {', '.join(RULE_KINDS)})")
        if self.kind == "expr":
            if not self.record or not self.expr:
                raise ValueError("expr recording rule needs 'record' and 'expr'")
            # parse now: a typo fails at load time, not every sampler tick
            from predictionio_tpu_torch.obs.monitor.expr import parse

            parse(self.expr)
        elif not self.record or not self.source:
            raise ValueError("recording rule needs 'record' and 'source'")
        if self.window_s <= 0:
            raise ValueError(f"rule {self.record!r}: window_s must be > 0")

    @classmethod
    def from_dict(cls, d: dict) -> "RecordingRule":
        known = {k: d[k] for k in ("record", "kind", "source", "expr", "match", "labels",
                                   "window_s", "q", "bad_label", "bad_min", "bad_values")
                 if k in d}
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError("recording rule has unknown field(s): "
                             + ", ".join(sorted(unknown)))
        for key in ("match", "labels"):
            if key in known and isinstance(known[key], dict):
                known[key] = tuple(sorted((str(k), str(v)) for k, v in known[key].items()))
        if "bad_values" in known:
            known["bad_values"] = tuple(str(v) for v in known["bad_values"])
        return cls(**known)

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "record": self.record, "kind": self.kind, "source": self.source,
            "window_s": self.window_s, "match": dict(self.match),
            "labels": dict(self.labels),
        }
        if self.kind == "expr":
            out["expr"] = self.expr
            out.pop("source")
            out.pop("match")
        if self.kind == "quantile":
            out["q"] = self.q
        if self.kind == "error_ratio":
            out["bad_label"] = self.bad_label
            if self.bad_values:
                out["bad_values"] = list(self.bad_values)
            else:
                out["bad_min"] = self.bad_min
        return out

    def evaluate(self, tsdb: TSDB, now: Optional[float] = None) -> Optional[float]:
        """This rule's current value (None with no traffic: nothing is
        written for an empty window, so readers tell quiet from zero)."""
        now = time.time() if now is None else now
        if self.kind == "expr":
            rows = self.evaluate_vector(tsdb, now)
            return rows[0][1] if len(rows) == 1 else None
        match = dict(self.match) or None
        if self.kind == "rate":
            if not tsdb.matching(self.source, match):
                return None
            return tsdb.rate(self.source, match, self.window_s, now)
        if self.kind == "quantile":
            return bucket_quantile(tsdb, self.source, self.q, match, self.window_s, now)
        # error_ratio
        total = bad = 0.0
        for s in tsdb.matching(self.source, match):
            inc = tsdb.series_increase(s, self.window_s, now)
            total += inc
            lbl = s.labels_dict().get(self.bad_label, "")
            if self.bad_values:
                is_bad = lbl in self.bad_values
            else:
                try:
                    is_bad = float(int(lbl)) >= float(self.bad_min or 0.0)
                except (TypeError, ValueError):
                    is_bad = False
            if is_bad:
                bad += inc
        if total <= 0:
            return None
        return bad / total

    def evaluate_vector(self, tsdb: TSDB,
                        now: Optional[float] = None) -> list[tuple[dict, float]]:
        """[(labels, value), ...]: an expr rule may give one point a label
        set; the fixed kinds give at most one under the rule's labels.
        Empty with no traffic."""
        now = time.time() if now is None else now
        if self.kind != "expr":
            value = self.evaluate(tsdb, now)
            if value is None:
                return []
            return [(dict(self.labels), value)]
        from predictionio_tpu_torch.obs.monitor import expr as _expr

        val = _expr.evaluate(tsdb, self.expr, now, default_window_s=self.window_s)
        if val is None:
            return []
        if isinstance(val, float):
            return [(dict(self.labels), val)]
        # the rule's labels win on a collision: they are what readers match
        return [({**dict(labels), **dict(self.labels)}, v) for labels, v in val]


def load_recording_rules(text: Optional[str] = None) -> list[RecordingRule]:
    """Parse ``PIO_RECORDING_RULES`` (or an explicit string): a JSON array
    of rule objects, or ``@/path.json``. Malformed input logs and gives
    [], as PIO_SLOS does."""
    import json as _json
    import logging as _logging

    raw = text if text is not None else monitor_knob("PIO_RECORDING_RULES")
    raw = (raw or "").strip()
    if not raw:
        return []
    try:
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        data = _json.loads(raw)
        if isinstance(data, dict):
            data = [data]
        return [RecordingRule.from_dict(d) for d in data]
    except (OSError, ValueError, TypeError) as e:
        _logging.getLogger(__name__).warning(
            "ignoring malformed PIO_RECORDING_RULES (%s)", e)
        return []


def evaluate_rules(tsdb: TSDB, rules: Iterable[RecordingRule],
                   now: Optional[float] = None) -> int:
    """One recording pass: evaluate every rule and store the results as
    gauge points. Returns the points written."""
    now = time.time() if now is None else now
    written = 0
    for rule in rules:
        try:
            rows = rule.evaluate_vector(tsdb, now)
        except Exception:
            import logging as _logging

            _logging.getLogger(__name__).debug(
                "recording rule %s failed", rule.record, exc_info=True)
            continue
        for labels, value in rows:
            if tsdb.add(rule.record, labels, value, "gauge", now):
                written += 1
    return written


# -- snapshot persistence -----------------------------------------------------
#
# The rings are process memory: a restart forgets every point it saw, and
# the SLO engine's slow window goes blind for its length. With a path
# configured the rings are serialized periodically (atomic tmp + rename,
# size-capped by dropping each series' oldest points first) and reloaded
# on start; a corrupt or truncated file loads nothing: history is an aid,
# never worth refusing to start over. The file format is the JAX
# package's, so either package loads the other's snapshot.

SNAPSHOT_VERSION = 1


def save_snapshot(tsdb: TSDB, path: str, max_bytes: int = 8 * 1024 * 1024) -> int:
    """Write the TSDB's rings to `path` (atomic replace); returns the
    bytes written. Each series' points shrink (newest kept) until the
    image fits `max_bytes`."""
    import json
    import os

    with tsdb._lock:
        rows = [{"name": s.name, "labels": s.labels_dict(), "kind": s.kind,
                 "points": [[round(t, 3), v] for t, v in s.points]}
                for s in tsdb._series.values()]
    cap = max((len(r["points"]) for r in rows), default=0)
    while True:
        data = json.dumps({"v": SNAPSHOT_VERSION, "saved_at": time.time(),
                           "capacity": tsdb.capacity, "series": rows},
                          separators=(",", ":")).encode()
        if len(data) <= max_bytes or cap <= 2:
            break
        cap = max(2, cap // 2)
        rows = [dict(r, points=r["points"][-cap:]) for r in rows]
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(data)


def load_snapshot(tsdb: TSDB, path: str) -> int:
    """Reload a snapshot into `tsdb`; returns the series restored. A
    missing, corrupt or future-versioned file loads nothing (warned,
    never raised)."""
    import json
    import logging

    log = logging.getLogger(__name__)
    try:
        with open(path, "rb") as f:
            payload = json.loads(f.read())
        if payload.get("v") != SNAPSHOT_VERSION:
            log.warning("ignoring TSDB snapshot %s: unknown version %r",
                        path, payload.get("v"))
            return 0
        loaded = 0
        for row in payload["series"]:
            name, labels = row["name"], row["labels"]
            kind = row.get("kind", "gauge")
            ok = True
            for t, v in row["points"]:
                ok = tsdb.add(name, labels, float(v), kind, float(t))
                if not ok:
                    break  # the cardinality cap: counted by add()
            if ok:
                loaded += 1
        return loaded
    except FileNotFoundError:
        return 0
    except Exception:
        log.warning("ignoring corrupt TSDB snapshot %s (starting with empty "
                    "history)", path, exc_info=True)
        return 0


class SnapshotWriter:
    """A background thread persisting the rings every `interval_s`; a
    final snapshot lands on stop(), which joins the thread."""

    thread_name = "tsdb-snapshot"

    def __init__(self, tsdb: TSDB, path: str, interval_s: float = 60.0,
                 max_bytes: int = 8 * 1024 * 1024):
        self.tsdb = tsdb
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        self.max_bytes = int(max_bytes)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def write_once(self) -> int:
        try:
            return save_snapshot(self.tsdb, self.path, self.max_bytes)
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "TSDB snapshot write failed; history continues in memory",
                exc_info=True)
            return 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name=self.thread_name,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
            self.write_once()  # the final image: a clean stop loses nothing

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_once()


# -- the in-process sampler ----------------------------------------------------

#: quantiles materialized per histogram child at each sample tick
SAMPLED_QUANTILES: tuple[tuple[float, str], ...] = (
    (0.5, "p50"), (0.95, "p95"), (0.99, "p99"),
)


def sample_families(tsdb: TSDB, families: Iterable[MetricFamily],
                    extra_labels: Optional[dict] = None,
                    now: Optional[float] = None) -> int:
    """Snapshot metric families into the TSDB; returns the points written.

    A (name, labels) series met twice in one pass is written once (the
    first family wins): every server in a process mounts the same
    unlabeled CUDA and device-profile gauges over one global source, and
    each writing its own point a tick would interleave duplicates. The
    callback gauges read counters the profiler and the allocator keep on
    the host; nothing here waits on the card."""
    now = time.time() if now is None else now
    extra = dict(extra_labels or {})
    written = 0
    seen: set[tuple[str, LabelPairs]] = set()

    def put(name: str, labels: dict, value: float, kind: str) -> None:
        nonlocal written
        merged = {**labels, **extra}
        key = (name, _label_key(merged))
        if key in seen:
            return
        seen.add(key)
        if tsdb.add(name, merged, value, kind, now):
            written += 1

    for fam in families:
        if isinstance(fam, HistogramFamily):
            with fam._lock:
                items = [(dict(zip(fam.labelnames, lv)), list(c.bucket_counts), c.sum,
                          c.count) for lv, c in fam._children.items()]
            for labels, bucket_counts, total_sum, count in items:
                put(fam.name + "_count", labels, count, "counter")
                put(fam.name + "_sum", labels, total_sum, "counter")
                cum = 0
                for edge, n in zip(fam.buckets, bucket_counts):
                    cum += n
                    put(fam.name + "_bucket", {**labels, "le": repr(float(edge))},
                        cum, "counter")
                put(fam.name + "_bucket", {**labels, "le": "+Inf"}, count, "counter")
                for q, qname in SAMPLED_QUANTILES:
                    put(fam.name, {**labels, "quantile": qname},
                        fam.quantile(q, **labels), "gauge")
        elif isinstance(fam, GaugeFamily):
            if fam.callback is not None:
                put(fam.name, {}, fam.value(), "gauge")
                continue
            with fam._lock:
                items = [(dict(zip(fam.labelnames, lv)), c.value)
                         for lv, c in fam._children.items()]
            for labels, value in items:
                put(fam.name, labels, value, "gauge")
        elif isinstance(fam, CounterFamily):
            with fam._lock:
                items = [(dict(zip(fam.labelnames, lv)), c.value)
                         for lv, c in fam._children.items()]
            for labels, value in items:
                put(fam.name, labels, value, "counter")
    return written


class MetricsSampler:
    """A background thread snapshotting `provider()`'s metric families
    into the TSDB every `interval_s`. The loop waits on an event, so
    `stop()` ends it at once and joins the thread."""

    thread_name = "tsdb-sampler"

    def __init__(self, tsdb: TSDB, provider: Callable[[], list[MetricFamily]],
                 interval_s: float = 5.0,
                 post_sample: Optional[Callable[[TSDB, float], None]] = None):
        self.tsdb = tsdb
        self.provider = provider
        self.interval_s = max(0.05, float(interval_s))
        # runs on the sampler thread after each snapshot: the recording
        # rules, so derived series share the raw series' tick times
        self.post_sample = post_sample
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self, now: Optional[float] = None) -> int:
        try:
            families = self.provider()
        except Exception:
            return 0
        now = time.time() if now is None else now
        written = sample_families(self.tsdb, families, now=now)
        if self.post_sample is not None:
            try:
                self.post_sample(self.tsdb, now)
            except Exception:
                pass  # derived series must never stop the raw sampling
        return written

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name=self.thread_name,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        # sample at once, so short-lived processes still get history
        while True:
            try:
                self.sample_once()
            except Exception:
                pass  # a sampling hiccup must never end the thread
            if self._stop.wait(self.interval_s):
                return
