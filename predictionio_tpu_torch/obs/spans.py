"""Hierarchical span tracing with tail-based sampling.

The port's own copy of the JAX package's ``obs/spans.py``. A flat
`X-Request-ID` and aggregate histograms answer "how slow is this route
on average" but not "*where* did this one slow query spend its time" —
in the micro-batch queue or the device call. This module adds the
Dapper-style span model on top of the trace-id plumbing:

- `span(name, **attrs)` opens a hierarchical span: trace_id comes from
  the `obs.tracing` ContextVar (or is minted, establishing a trace),
  span_id is fresh, parent_span_id is the enclosing span in this
  context (or an explicit remote parent — the `X-Parent-Span` header
  carries span identity across processes, so a storage daemon's server
  span parents under the deploy server's RPC client span).
- `SpanRecorder` keeps a bounded in-memory store of *completed traces*
  with **tail-based sampling**: the keep/drop decision happens when the
  trace's local root span completes, so traces that errored or exceeded
  the slow threshold are always retained, the boring rest is sampled
  probabilistically, and the oldest kept traces are evicted beyond a
  cap. (Head-based sampling cannot do this — it must decide before
  knowing the outcome.)
- `perfetto_export()` renders retained traces as Chrome trace-event
  JSON, loadable at https://ui.perfetto.dev for a flame view.
- A metric bridge feeds the durations of a declared subset of span
  names into existing `MetricsRegistry` histograms, so `/metrics`
  aggregates and `/debug/traces` exemplars are one consistent story
  (the span IS the observation; nothing is counted twice).

Knobs (read once when the default recorder is created; also mutable
attributes on the recorder for tests/benchmarks):
  PIO_TRACE_MAX      retained-trace cap            (default 256)
  PIO_TRACE_SLOW_MS  always-keep latency threshold (default 250)
  PIO_TRACE_SAMPLE   keep probability for the rest (default 0.1)

Thread-safety: one lock guards the recorder's maps; span context lives
in ContextVars, so keep-alive handler threads and the micro-batch
dispatcher cannot leak spans across requests."""

from __future__ import annotations

import contextvars
import random
import threading
import time
import uuid
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.utils import env as _env

_current_span_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "pio_span_id", default=None
)


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def current_span_id() -> Optional[str]:
    return _current_span_id.get()


def set_current_span(span_id: Optional[str]) -> contextvars.Token:
    return _current_span_id.set(span_id)


def reset_current_span(token: contextvars.Token) -> None:
    _current_span_id.reset(token)


@dataclass
class Span:
    """One completed (or in-flight, while inside the `span()` cm) span."""

    trace_id: str
    span_id: str
    name: str
    parent_span_id: Optional[str] = None
    start: float = 0.0  # wall clock, epoch seconds
    duration: float = 0.0  # seconds
    attrs: dict[str, Any] = field(default_factory=dict)
    error: bool = False

    def to_dict(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "start": round(self.start, 6),
            "duration_ms": round(self.duration * 1e3, 3),
            "attrs": self.attrs,
            "error": self.error,
        }


def _env_float(name: str, default: float) -> float:
    return _env.env_float(name, default)


class SpanRecorder:
    """Thread-safe span store with tail-based sampling.

    Spans accumulate per trace in `_active`; when a *local root* span
    (one opened with no enclosing span in this process) completes, the
    trace fragment is finalized: kept if any span errored or ran past
    `slow_ms`, else kept with probability `sample_rate`, else dropped.
    Kept traces merge across fragments — a storage daemon's spans and
    the calling server's spans share one trace_id, so in a single-process
    deployment (or test) the fragments reunite into one tree."""

    def __init__(
        self,
        max_traces: Optional[int] = None,
        slow_ms: Optional[float] = None,
        sample_rate: Optional[float] = None,
    ):
        self.max_traces = int(
            max_traces if max_traces is not None
            else _env_float("PIO_TRACE_MAX", 256)
        )
        self.slow_ms = (
            slow_ms if slow_ms is not None
            else _env_float("PIO_TRACE_SLOW_MS", 250.0)
        )
        self.sample_rate = (
            sample_rate if sample_rate is not None
            else _env_float("PIO_TRACE_SAMPLE", 0.1)
        )
        # per-trace span cap: trace ids are client-controlled
        # (X-Request-ID), so one id replayed forever must not grow a
        # retained trace without bound
        self.max_spans_per_trace = 512
        self._lock = threading.Lock()
        # trace_id -> spans completed but not yet sampled-on
        self._active: "OrderedDict[str, list[Span]]" = OrderedDict()  # guarded-by: _lock
        # trace_id -> {"spans": [...], "reason": keep-reason}
        self._traces: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _lock
        self._bridges: dict[str, Callable[[Span], None]] = {}  # guarded-by: _lock
        # query-triggered capture: capture_id ->
        # {"requested", "remaining", "trace_ids", ...}; the dispatcher
        # consumes one "batch credit" per device batch and force-keeps
        # that batch's traces regardless of the sample rate
        self._captures: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _lock
        self._forced: dict[str, str] = {}  # trace_id -> capture_id  # guarded-by: _lock
        # every completed span, pre-sampling, for the fleet trace
        # collector: cross-process stitching needs the raw
        # fragments — a fast replica-side attempt would never survive
        # LOCAL tail sampling, yet it is exactly the child the
        # assembled hedged trace must show. Bounded ring; the
        # collector dedups on span_id across overlapping polls.
        self._recent: deque[Span] = deque(maxlen=4096)  # guarded-by: _lock

    # -- recording ---------------------------------------------------------
    @contextmanager
    def span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
        **attrs: Any,
    ) -> Iterator[Span]:
        """Open a span. Yields the (mutable) Span so callers can add
        attributes mid-flight. Establishes trace + span context for
        anything nested; an exception marks the span errored (and
        re-raises). The trace fragment finalizes when a span with no
        *local* parent completes — an explicit `parent_span_id` (a
        remote parent from `X-Parent-Span`) does not suppress that."""
        ambient = _tracing.current_trace_id()
        tid = trace_id or ambient or _tracing.new_request_id()
        # establish trace context for everything nested whenever this
        # span starts (or switches) the trace — an explicit trace_id
        # must flow to children exactly like an inherited one
        trace_token = _tracing.set_trace_id(tid) if tid != ambient else None
        local_parent = _current_span_id.get()
        sp = Span(
            trace_id=tid,
            span_id=new_span_id(),
            name=name,
            parent_span_id=(
                parent_span_id if parent_span_id is not None else local_parent
            ),
            start=time.time(),
            attrs=dict(attrs),
        )
        span_token = _current_span_id.set(sp.span_id)
        t0 = time.perf_counter()
        try:
            yield sp
        except BaseException:
            sp.error = True
            raise
        finally:
            sp.duration = time.perf_counter() - t0
            _current_span_id.reset(span_token)
            if trace_token is not None:
                _tracing.reset_trace_id(trace_token)
            self.record(sp, finalize=local_parent is None)

    def record(self, sp: Span, finalize: bool = False) -> None:
        """Record a completed span. `finalize=True` marks the end of this
        process's fragment of the trace: the tail-sampling decision runs
        over everything recorded for the trace so far."""
        bridge = self._bridges.get(sp.name)
        if bridge is not None:
            try:
                bridge(sp)
            except Exception:
                pass  # a metrics hiccup must never break the request
        with self._lock:
            self._recent.append(sp)
            kept = self._traces.get(sp.trace_id)
            if kept is not None:
                # trace already deemed interesting: merge late fragments
                # (e.g. the client span completing after the remote
                # server's fragment finalized) straight in — capped, and
                # WITHOUT refreshing eviction age, so a client pinning
                # one request id can neither grow it unbounded nor keep
                # it alive forever
                if len(kept["spans"]) < self.max_spans_per_trace:
                    kept["spans"].append(sp)
                return
            frag = self._active.setdefault(sp.trace_id, [])
            if len(frag) < self.max_spans_per_trace:
                frag.append(sp)
            if not finalize:
                # orphan guard: fragments whose root never completes
                # (handler crashed pre-response) must not grow unbounded
                while len(self._active) > max(64, 4 * self.max_traces):
                    self._active.popitem(last=False)
                return
            spans = self._active.pop(sp.trace_id)
            forced_cap = self._forced.pop(sp.trace_id, None)
            reason = (
                f"capture:{forced_cap}" if forced_cap
                else self._keep_reason(spans)
            )
            if reason is None:
                if sp.parent_span_id is not None:
                    # the finalizing span has a REMOTE parent: it roots
                    # only this process's fragment, not the trace. When
                    # two servers share a process (query server +
                    # storage daemon in tests / single-box deploys), the
                    # daemon's server span completes MID-request — a
                    # definitive drop here would amputate the outer
                    # request's already-recorded queue/assemble spans
                    # from its eventual slow/error trace. Defer: leave
                    # the fragment active for the true root's finalize
                    # to re-evaluate over the union. (The orphan guard
                    # below bounds fragments whose root never comes.)
                    self._active[sp.trace_id] = spans
                    while len(self._active) > max(64, 4 * self.max_traces):
                        self._active.popitem(last=False)
                return
            self._traces[sp.trace_id] = {"spans": spans, "reason": reason}
            if forced_cap is not None:
                cap = self._captures.get(forced_cap)
                if cap is not None and sp.trace_id not in cap["trace_ids"]:
                    cap["trace_ids"].append(sp.trace_id)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    def _keep_reason(self, spans: list[Span]) -> Optional[str]:
        if any(s.error for s in spans):
            return "error"
        if any(s.duration * 1e3 >= self.slow_ms for s in spans):
            return "slow"
        if random.random() < self.sample_rate:
            return "sampled"
        return None

    # -- metric bridge -----------------------------------------------------
    def bridge(self, span_name: str, observe: Callable[[Span], None]) -> None:
        """Feed every completed span named `span_name` into `observe`
        (typically `lambda sp: histogram.observe(sp.duration)`), so the
        span is the single source for both the trace and the metric.
        One callback per name — last registration wins."""
        with self._lock:
            self._bridges[span_name] = observe

    def unbridge(
        self, span_name: str,
        observe: Optional[Callable[[Span], None]] = None,
    ) -> None:
        """Remove a bridge. With `observe`, removes only if it is still
        the registered callback — a stopped server must not tear down a
        newer server's bridge."""
        # check+pop under the recorder lock: a stopping server racing
        # a newer server's registration must not observe its own bridge
        # and then pop the replacement
        with self._lock:
            if observe is None or self._bridges.get(span_name) is observe:
                self._bridges.pop(span_name, None)

    # -- query-triggered capture ---------------------------------------------
    def arm_capture(self, n_batches: int) -> str:
        """Arm force-sampling for the next `n_batches` device batches:
        the dispatcher calls `consume_capture()` per batch and
        `force_keep()`s that batch's trace ids, so they are retained
        with reason ``capture:<id>`` no matter what PIO_TRACE_SAMPLE
        says. Returns the capture id for `?capture=<id>`."""
        capture_id = new_span_id()[:8]
        with self._lock:
            self._captures[capture_id] = {
                "id": capture_id,
                "requested": int(n_batches),
                "remaining": int(n_batches),
                "trace_ids": [],
                "created": time.time(),
            }
            while len(self._captures) > 16:
                dropped_id, dropped = self._captures.popitem(last=False)
                # an evicted armed capture must not leave dangling arms
                self._forced = {
                    tid: cid for tid, cid in self._forced.items()
                    if cid != dropped_id
                }
        return capture_id

    def consume_capture(self) -> Optional[str]:
        """One batch credit off the oldest still-armed capture (None
        when nothing is armed — the inert fast path is one dict check)."""
        if not self._captures:
            return None
        with self._lock:
            for capture_id, cap in self._captures.items():
                if cap["remaining"] > 0:
                    cap["remaining"] -= 1
                    return capture_id
        return None

    def force_keep(self, trace_id: str, capture_id: str) -> None:
        """Mark a trace for unconditional retention under `capture_id`.
        A trace already retained joins the capture immediately."""
        with self._lock:
            cap = self._captures.get(capture_id)
            if cap is None:
                return
            kept = self._traces.get(trace_id)
            if kept is not None:
                if trace_id not in cap["trace_ids"]:
                    cap["trace_ids"].append(trace_id)
                return
            self._forced[trace_id] = capture_id
            # bound the pending map: a capture whose traces never
            # finalize (handler crash) must not grow it forever
            while len(self._forced) > 4 * self.max_spans_per_trace:
                self._forced.pop(next(iter(self._forced)))

    def capture_status(self, capture_id: str) -> Optional[dict]:
        """The `GET /debug/traces?capture=<id>` body: the capture
        record plus summaries of its retained traces."""
        with self._lock:
            cap = self._captures.get(capture_id)
            if cap is None:
                return None
            cap = dict(cap, trace_ids=list(cap["trace_ids"]))
        all_summaries = {
            s["trace_id"]: s for s in self.summaries(limit=0)
        }
        return {
            "capture": cap,
            "done": cap["remaining"] == 0,
            "traces": [
                all_summaries[tid] for tid in cap["trace_ids"]
                if tid in all_summaries
            ],
        }

    # -- reading -----------------------------------------------------------
    def recent(self, since: float = 0.0) -> list[Span]:
        """Raw completed spans (pre-sampling) whose END falls at or
        after `since` — the `/debug/traces?spans=1` dump the fleet
        trace collector polls for cross-process stitching."""
        with self._lock:
            spans = list(self._recent)
        if since <= 0.0:
            return spans
        return [s for s in spans if s.start + s.duration >= since]

    def get_trace(self, trace_id: str) -> list[Span]:
        """Spans of a retained trace, start-ordered ([] if not retained)."""
        with self._lock:
            rec = self._traces.get(trace_id)
            spans = list(rec["spans"]) if rec else []
        return sorted(spans, key=lambda s: s.start)

    def summaries(self, limit: int = 50) -> list[dict]:
        """Newest-first one-line views of the retained traces."""
        with self._lock:
            items = list(self._traces.items())
        out = []
        for tid, rec in reversed(items[-limit:] if limit else items):
            spans = rec["spans"]
            ids = {s.span_id for s in spans}
            roots = [
                s for s in spans
                if s.parent_span_id is None or s.parent_span_id not in ids
            ] or spans
            root = max(roots, key=lambda s: s.duration)
            out.append({
                "trace_id": tid,
                "root": root.name,
                "server": root.attrs.get("server"),
                "path": root.attrs.get("path"),
                "spans": len(spans),
                "duration_ms": round(root.duration * 1e3, 3),
                "error": any(s.error for s in spans),
                "kept": rec["reason"],
                "start": round(min(s.start for s in spans), 3),
            })
        return out

    def perfetto_export(self, trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (the `traceEvents` array form) for one
        retained trace, or all of them. Loadable in Perfetto / chrome
        ://tracing: spans become complete ("X") events; each originating
        server gets a named process row, span depth maps to the thread
        row so children nest under parents."""
        with self._lock:
            if trace_id is not None:
                rec = self._traces.get(trace_id)
                spans = list(rec["spans"]) if rec else []
            else:
                spans = [
                    s for rec in self._traces.values() for s in rec["spans"]
                ]
        procs: dict[str, int] = {}
        events: list[dict] = []
        by_id = {s.span_id: s for s in spans}

        def depth(s: Span, hops: int = 0) -> int:
            parent = by_id.get(s.parent_span_id or "")
            if parent is None or hops > 32:  # missing/remote parent or cycle
                return 0
            return 1 + depth(parent, hops + 1)

        for s in sorted(spans, key=lambda x: x.start):
            proc = str(s.attrs.get("server") or s.name.split(".")[0])
            pid = procs.setdefault(proc, len(procs) + 1)
            events.append({
                "ph": "X",
                "name": s.name,
                "cat": "pio",
                "ts": round(s.start * 1e6, 3),
                "dur": round(s.duration * 1e6, 3),
                "pid": pid,
                "tid": depth(s),
                "args": {
                    "trace_id": s.trace_id,
                    "span_id": s.span_id,
                    "parent_span_id": s.parent_span_id,
                    "error": s.error,
                    **{k: str(v) for k, v in s.attrs.items()},
                },
            })
        meta = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": proc},
            }
            for proc, pid in procs.items()
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def config(self) -> dict:
        return {
            "max_traces": self.max_traces,
            "slow_ms": self.slow_ms,
            "sample_rate": self.sample_rate,
        }

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._traces.clear()
            self._captures.clear()
            self._forced.clear()
            self._recent.clear()


_default_recorder: Optional[SpanRecorder] = None
_default_lock = threading.Lock()


def get_default_recorder() -> SpanRecorder:
    """The process-wide recorder every server and workflow records into
    (lazy so env knobs set before first use are honored)."""
    global _default_recorder
    with _default_lock:
        if _default_recorder is None:
            _default_recorder = SpanRecorder()
        return _default_recorder


def span(name: str, **kwargs: Any):
    """`with span("stage", key=val):` on the default recorder."""
    return get_default_recorder().span(name, **kwargs)
