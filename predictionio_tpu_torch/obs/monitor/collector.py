"""Fleet trace collector: many processes' span fragments into one tree.

Counterpart of the JAX package's ``obs/monitor/collector.py``, the
port's own copy. The span recorder is process-local: a query that
crosses processes leaves one fragment in each. The
:class:`TraceCollector` polls every target's ``/debug/traces?spans=1``
(the raw span dump before sampling), merges the local recorder's recent
spans, and stitches everything that shares a trace id (the propagated
``X-Request-ID``) into one cross-process tree.

Tail sampling happens here, over the assembled trace: keep it when any
span errored, when a span ran past ``slow_ms``, or when the trace crossed
a hedge or failover attempt (``gateway.attempt`` children beyond the
primary). Fragments that never grow a root span (orphans: the rooting
process died, or its dump was missed) are held for ``hold_s`` so that a
late root can still claim them, then expired.

The owning process (the dashboard, ``console monitor``) starts and stops
it; `stop()` joins the ``trace-collector`` thread, and it registers on
the process :class:`Monitor` so that ``/debug/traces?fleet=1`` and
``console trace --fleet`` reach the assembled store. Spans pushed by a
process that may since have died (``POST /telemetry/push``, through
``obs/monitor/push.py``) arrive through :meth:`TraceCollector.ingest_spans`.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from collections import OrderedDict
from typing import Any, Optional

from predictionio_tpu_torch.obs import spans as _spans
from predictionio_tpu_torch.utils.env import monitor_knob

log = logging.getLogger(__name__)

# attempt kinds that mark a trace "hedged" for the keep decision
_HEDGE_KINDS = ("hedge", "failover")


class TraceCollector:
    """Background poll loop assembling cross-process traces.

    `targets` is [(instance, base_url)] — the same shape the scraper
    uses. The local recorder is always included (the owning process's
    own fragments never cross HTTP)."""

    thread_name = "trace-collector"

    def __init__(
        self,
        targets: Optional[list[tuple[str, str]]] = None,
        recorder: Optional[_spans.SpanRecorder] = None,
        interval_s: Optional[float] = None,
        hold_s: Optional[float] = None,
        max_traces: Optional[int] = None,
        slow_ms: Optional[float] = None,
        timeout_s: float = 5.0,
    ):
        self.targets: list[tuple[str, str]] = list(targets or [])
        self.recorder = (
            recorder if recorder is not None
            else _spans.get_default_recorder()
        )
        self.interval_s = max(0.05, float(
            interval_s if interval_s is not None
            else monitor_knob("PIO_TRACE_COLLECT_INTERVAL_S")
        ))
        self.hold_s = float(
            hold_s if hold_s is not None
            else monitor_knob("PIO_TRACE_COLLECT_HOLD_S")
        )
        self.max_traces = int(
            max_traces if max_traces is not None
            else monitor_knob("PIO_TRACE_COLLECT_MAX")
        )
        self.slow_ms = float(
            slow_ms if slow_ms is not None else self.recorder.slow_ms
        )
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        # trace_id -> {"spans": {span_id: span-dict}, "last_seen": t}
        self._frags: "OrderedDict[str, dict]" = OrderedDict()  # guarded by _lock
        # trace_id -> {"spans": {span_id: dict}, "reason": str, ...}
        self._traces: "OrderedDict[str, dict]" = OrderedDict()  # guarded by _lock
        # per-target poll cursor (epoch seconds of the last good poll)
        self._cursors: dict[str, float] = {}
        self._polls = 0
        self._poll_errors = 0
        self._expired_orphans = 0
        self._pushed_spans = 0  # spans that came by POST /telemetry/push
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one pass ----------------------------------------------------------
    def collect_once(self, now: Optional[float] = None) -> int:
        """One poll+stitch pass; returns how many spans were ingested."""
        now = time.time() if now is None else now
        ingested = 0
        # local fragments first: the rooting gateway span usually lives
        # here, so orphan remote fragments resolve in the same pass
        cursor = self._cursors.get("", 0.0)
        for sp in self.recorder.recent(since=cursor):
            ingested += self._ingest(sp.to_dict(), now)
        self._cursors[""] = now - self.interval_s
        for instance, base in list(self.targets):
            self._polls += 1
            cursor = self._cursors.get(instance, 0.0)
            url = f"{base}/debug/traces?spans=1&since={cursor:.3f}"
            try:
                with urllib.request.urlopen(
                    url, timeout=self.timeout_s
                ) as r:
                    payload = json.loads(r.read().decode(errors="replace"))
            except Exception as e:
                self._poll_errors += 1
                log.debug(
                    "trace poll of %s (%s) failed: %s", instance, base, e
                )
                continue
            for sp in payload.get("spans") or []:
                if isinstance(sp, dict):
                    ingested += self._ingest(sp, now)
            # next poll re-covers one interval of overlap; span_id
            # dedup makes the overlap free and clock skew harmless
            self._cursors[instance] = (
                float(payload.get("now", now)) - self.interval_s
            )
        self._settle(now)
        return ingested

    def ingest_spans(self, spans: list, now: Optional[float] = None) -> int:
        """Pushed span batches (``POST /telemetry/push``) from a process
        that may be gone before any poll reaches it. A rooted pushed trace
        is kept at once, with reason "pushed" when nothing else keeps it:
        waiting for the poll loop to decide would only expire it. Unrooted
        fragments keep the usual ``hold_s`` grace for a late root."""
        now = time.time() if now is None else now
        ingested = 0
        tids: set = set()
        for sp in spans or []:
            if not isinstance(sp, dict):
                continue
            n = self._ingest(sp, now)
            ingested += n
            if n and sp.get("trace_id"):
                tids.add(sp["trace_id"])
        if not ingested:
            return 0
        with self._lock:
            self._pushed_spans += ingested
            for tid in tids:
                frag = self._frags.get(tid)
                if frag is None:
                    continue
                spans_by_id = frag["spans"]
                if not any(not s.get("parent_span_id") for s in spans_by_id.values()):
                    continue
                del self._frags[tid]
                self._traces[tid] = {
                    "spans": spans_by_id,
                    "reason": self._keep_reason(spans_by_id.values()) or "pushed",
                    "assembled_at": now,
                }
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
        return ingested

    def _ingest(self, sp: dict, now: float) -> int:
        tid = sp.get("trace_id")
        sid = sp.get("span_id")
        if not tid or not sid:
            return 0
        with self._lock:
            kept = self._traces.get(tid)
            if kept is not None:
                # late fragment of an already-assembled trace: merge,
                # without refreshing its eviction age
                if sid not in kept["spans"] and (
                    len(kept["spans"]) < self.recorder.max_spans_per_trace
                ):
                    kept["spans"][sid] = sp
                    return 1
                return 0
            frag = self._frags.get(tid)
            if frag is None:
                frag = self._frags[tid] = {
                    "spans": {}, "first_seen": now, "last_seen": now,
                }
                # pending-fragment bound: under sustained traffic every
                # request opens a fragment for up to hold_s — the map
                # must stay bounded even if the settle pass lags
                while len(self._frags) > max(256, 4 * self.max_traces):
                    self._frags.popitem(last=False)
            if sid in frag["spans"]:
                return 0
            if len(frag["spans"]) >= self.recorder.max_spans_per_trace:
                return 0
            frag["spans"][sid] = sp
            frag["last_seen"] = now
            return 1

    def _settle(self, now: float) -> None:
        """Promote assembled fragments that earned retention; expire
        rooted-but-boring and orphan fragments past the hold window."""
        with self._lock:
            for tid in list(self._frags):
                frag = self._frags[tid]
                spans = frag["spans"]
                rooted = any(
                    not s.get("parent_span_id") for s in spans.values()
                )
                reason = self._keep_reason(spans.values())
                if rooted and reason is not None:
                    del self._frags[tid]
                    self._traces[tid] = {
                        "spans": spans,
                        "reason": reason,
                        "assembled_at": now,
                    }
                    continue
                if now - frag["first_seen"] >= self.hold_s:
                    # orphan (no root arrived) or boring: expired. The
                    # hold covers poll skew — a replica fragment lands
                    # a pass or two before the gateway's root.
                    if not rooted:
                        self._expired_orphans += 1
                    del self._frags[tid]
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    def _keep_reason(self, spans) -> Optional[str]:
        hedged = False
        slow = False
        for s in spans:
            if s.get("error"):
                return "error"
            attrs = s.get("attrs") or {}
            if (
                s.get("name") == "gateway.attempt"
                and attrs.get("kind") in _HEDGE_KINDS
            ):
                hedged = True
            if float(s.get("duration_ms") or 0.0) >= self.slow_ms:
                slow = True
        if hedged:
            return "hedged"
        if slow:
            return "slow"
        return None

    # -- reading -----------------------------------------------------------
    def get_trace(self, trace_id: str) -> list[dict]:
        """Start-ordered span dicts of one assembled trace ([] if
        unknown)."""
        with self._lock:
            rec = self._traces.get(trace_id)
            spans = list(rec["spans"].values()) if rec else []
        return sorted(spans, key=lambda s: s.get("start") or 0.0)

    def summaries(self, limit: int = 50) -> list[dict]:
        """Newest-first one-line views of the assembled fleet traces."""
        with self._lock:
            items = list(self._traces.items())
        out = []
        for tid, rec in reversed(items[-limit:] if limit else items):
            spans = list(rec["spans"].values())
            ids = {s.get("span_id") for s in spans}
            roots = [
                s for s in spans
                if not s.get("parent_span_id")
                or s.get("parent_span_id") not in ids
            ] or spans
            root = max(roots, key=lambda s: s.get("duration_ms") or 0.0)
            servers = sorted({
                str((s.get("attrs") or {}).get("server"))
                for s in spans if (s.get("attrs") or {}).get("server")
            })
            out.append({
                "trace_id": tid,
                "root": root.get("name"),
                "servers": servers,
                "path": (root.get("attrs") or {}).get("path"),
                "spans": len(spans),
                "duration_ms": root.get("duration_ms"),
                "error": any(s.get("error") for s in spans),
                "kept": rec["reason"],
                "start": min(
                    (s.get("start") or 0.0) for s in spans
                ),
            })
        return out

    def slowest(self, limit: int = 3) -> list[dict]:
        """The slowest assembled traces — what a firing alert links to."""
        rows = self.summaries(limit=0)
        rows.sort(key=lambda r: r.get("duration_ms") or 0.0, reverse=True)
        return rows[:limit]

    def perfetto_export(self, trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON over assembled traces (same shape as
        SpanRecorder.perfetto_export, but each fragment's originating
        server becomes its own process row — the fleet waterfall)."""
        with self._lock:
            if trace_id is not None:
                rec = self._traces.get(trace_id)
                spans = list(rec["spans"].values()) if rec else []
            else:
                spans = [
                    s for rec in self._traces.values()
                    for s in rec["spans"].values()
                ]
        procs: dict[str, int] = {}
        events: list[dict] = []
        by_id = {s.get("span_id"): s for s in spans}

        def depth(s: dict, hops: int = 0) -> int:
            parent = by_id.get(s.get("parent_span_id") or "")
            if parent is None or hops > 32:
                return 0
            return 1 + depth(parent, hops + 1)

        for s in sorted(spans, key=lambda x: x.get("start") or 0.0):
            attrs = s.get("attrs") or {}
            proc = str(
                attrs.get("server")
                or str(s.get("name") or "span").split(".")[0]
            )
            pid = procs.setdefault(proc, len(procs) + 1)
            events.append({
                "ph": "X",
                "name": s.get("name"),
                "cat": "pio-fleet",
                "ts": round((s.get("start") or 0.0) * 1e6, 3),
                "dur": round((s.get("duration_ms") or 0.0) * 1e3, 3),
                "pid": pid,
                "tid": depth(s),
                "args": {
                    "trace_id": s.get("trace_id"),
                    "span_id": s.get("span_id"),
                    "parent_span_id": s.get("parent_span_id"),
                    "error": s.get("error"),
                    **{k: str(v) for k, v in attrs.items()},
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

    def status(self) -> dict[str, Any]:
        with self._lock:
            assembled = len(self._traces)
            pending = len(self._frags)
        return {
            "targets": len(self.targets),
            "interval_s": self.interval_s,
            "hold_s": self.hold_s,
            "assembled": assembled,
            "pending_fragments": pending,
            "polls": self._polls,
            "poll_errors": self._poll_errors,
            "expired_orphans": self._expired_orphans,
            "pushed_spans": self._pushed_spans,
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=self.thread_name, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + 5)
            self._thread = None

    def _loop(self) -> None:
        while True:
            try:
                self.collect_once()
            except Exception:
                log.exception("trace collect pass failed; will retry")
            if self._stop.wait(self.interval_s):
                return
