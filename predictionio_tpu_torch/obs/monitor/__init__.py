"""Monitoring plane: in-process time-series history, fleet scrape
aggregation, the trace collector and SLO burn-rate alerting.

Counterpart of the JAX package's ``obs/monitor/``, the port's own copy.
The process-global :class:`Monitor` owns one TSDB and the background
threads over it. Servers attach on start and detach on stop; the sampler
(and the SLO engine, when specs are configured) runs while at least one
server is attached and is joined on the last detach: no thread outlives
the servers. Every thread waits on an event, so a stop is prompt.

Knobs (read when the monitor is created; attributes after):

  PIO_TSDB=0             disable the monitoring plane wholesale
  PIO_TSDB_INTERVAL_S    sampler period           (default 5)
  PIO_TSDB_POINTS        ring capacity per series (default 720)
  PIO_TSDB_MAX_SERIES    series cardinality cap   (default 4096)
  PIO_SLO_INTERVAL_S     SLO evaluation period    (default 15)
  PIO_SLOS               JSON SLO spec array, or @/path.json
  PIO_MONITOR_TARGETS    fleet scrape targets (dashboard, console monitor)
  PIO_RECORDING_RULES    derived-series recording rules
  PIO_TSDB_SNAPSHOT      path persisting the rings across restarts
  PIO_TSDB_DIR           the durable on-disk tier: WAL, sealed blocks and
                         5m/1h downsampled tiers, replayed at start
                         (``durable.py``, ``compact.py``; tuned by
                         PIO_TSDB_{FLUSH_S,SEAL_*,COMPACT_S,CKPT_POINTS,
                         RETENTION_*}); it supersedes PIO_TSDB_SNAPSHOT
  PIO_PUSH_*             push telemetry's shipper and ingest (``push.py``)
  PIO_ALERT_WEBHOOK, PIO_ALERT_EXEC   the alert notification sinks

  PIO_TENANT_SLO_PRESETS derive per-tenant SLOs at mux attach
                         (``apply_tenant_presets``)

Standard library only: importing it loads no torch.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from predictionio_tpu_torch.obs.monitor.collector import TraceCollector
from predictionio_tpu_torch.obs.monitor.compact import Compactor
from predictionio_tpu_torch.obs.monitor.durable import DurableTSDB
from predictionio_tpu_torch.obs.monitor.notify import AlertNotifier
from predictionio_tpu_torch.obs.monitor.scrape import (
    FleetScraper,
    parse_prometheus_text,
    parse_targets,
)
from predictionio_tpu_torch.obs.monitor.slo import (
    AlertStatus,
    SLOEngine,
    SLOSpec,
    load_slos,
    record_slo_ratios,
    tenant_slo_presets,
)
from predictionio_tpu_torch.obs.monitor.tsdb import (
    TSDB,
    MetricsSampler,
    RecordingRule,
    SnapshotWriter,
    evaluate_rules,
    load_recording_rules,
    load_snapshot,
    sample_families,
    save_snapshot,
)
from predictionio_tpu_torch.utils.env import durable_knob, env_path, monitor_knob

__all__ = [
    "TSDB",
    "AlertNotifier",
    "Compactor",
    "DurableTSDB",
    "MetricsSampler",
    "FleetScraper",
    "RecordingRule",
    "SLOEngine",
    "SLOSpec",
    "AlertStatus",
    "Monitor",
    "SnapshotWriter",
    "TraceCollector",
    "enabled",
    "evaluate_rules",
    "get_monitor",
    "load_recording_rules",
    "load_slos",
    "load_snapshot",
    "parse_prometheus_text",
    "parse_targets",
    "record_slo_ratios",
    "sample_families",
    "save_snapshot",
    "tenant_slo_presets",
]

# the thread names of the plane, for checks that none is left running
THREAD_NAMES = (MetricsSampler.thread_name, SLOEngine.thread_name,
                FleetScraper.thread_name, TraceCollector.thread_name,
                SnapshotWriter.thread_name, DurableTSDB.thread_name,
                Compactor.thread_name)


def enabled() -> bool:
    return monitor_knob("PIO_TSDB")


class Monitor:
    """One TSDB, a sampler and an optional SLO engine per process.

    `attach(label, registry)` refcounts: the first attach starts the
    sampler (and the SLO engine when specs exist), the last `detach`
    stops and joins both. The attached registries are sampled in attach
    order, then the process-default registry: the merge `GET /metrics`
    renders, so history and scrape agree."""

    def __init__(self):
        self.sampler_interval_s = monitor_knob("PIO_TSDB_INTERVAL_S")
        self.slo_interval_s = monitor_knob("PIO_SLO_INTERVAL_S")
        # the durable tier: with a directory, the rings are backed by a
        # WAL and sealed blocks, and the constructor replays the durable
        # tail, so a restarted process alerts on the burn before its
        # restart. It supersedes the JSON snapshot.
        self.durable_dir = durable_knob("PIO_TSDB_DIR") or None
        if self.durable_dir and enabled():
            self.tsdb: TSDB = DurableTSDB(
                self.durable_dir,
                capacity=monitor_knob("PIO_TSDB_POINTS"),
                max_series=monitor_knob("PIO_TSDB_MAX_SERIES"),
                flush_interval_s=durable_knob("PIO_TSDB_FLUSH_S"),
                seal_points=durable_knob("PIO_TSDB_SEAL_POINTS"),
                seal_age_s=durable_knob("PIO_TSDB_SEAL_AGE_S"))
        else:
            self.tsdb = TSDB(capacity=monitor_knob("PIO_TSDB_POINTS"),
                             max_series=monitor_knob("PIO_TSDB_MAX_SERIES"))
        # snapshot persistence: with a path configured, history survives
        # restarts: reloaded here, written periodically and on last detach
        self.snapshot_path = (None if self.durable_dir
                              else env_path("PIO_TSDB_SNAPSHOT") or None)
        self.snapshot_interval_s = monitor_knob("PIO_TSDB_SNAPSHOT_INTERVAL_S")
        if self.snapshot_path and enabled():
            restored = load_snapshot(self.tsdb, self.snapshot_path)
            if restored:
                import logging

                logging.getLogger(__name__).info(
                    "restored %d TSDB series from %s", restored, self.snapshot_path)
        self._lock = threading.Lock()
        self._attached: list[tuple[int, str, Any]] = []  # (token, label, registry)
        self._next_token = 1
        self._sampler: Optional[MetricsSampler] = None
        self._engine: Optional[SLOEngine] = None
        self._snapshotter: Optional[SnapshotWriter] = None
        self._compactor: Optional[Compactor] = None
        self._slos: list[SLOSpec] = load_slos()
        # per-tenant presets, installed by the mux and kept apart from the
        # operator's specs: an operator spec of the same name wins
        self._presets: list[SLOSpec] = []
        # recording rules, evaluated on the sampler tick
        # (MetricsSampler.post_sample): no extra thread
        self.recording_rules: list[RecordingRule] = load_recording_rules()
        # the fleet trace collector, when this process runs one (the
        # dashboard, console monitor): registered through set_collector;
        # its owner keeps its start and stop
        self.collector: Optional[TraceCollector] = None
        # scraped exemplar index: family → observing label set → trace id
        # → (value, ts), fed by the fleet scraper's `# EXEMPLAR` lines and
        # merged with the local registries' exemplars on read; bounded per
        # (family, label set), so a slow route cannot evict another's
        self._exemplars: dict[str, dict[tuple, dict[str, tuple[float, float]]]] = {}
        self._exemplar_cap = max(16, 4 * monitor_knob("PIO_TRACE_EXEMPLARS"))
        # push telemetry: the last receipt's wall time and the newest
        # devprof report of each pushed instance. The sampler tick
        # rewrites telemetry_last_push_age_seconds from _push_last, so the
        # series ages between pushes and a silent process trips a
        # threshold alert as up{instance} == 0 does
        self._push_last: dict[str, float] = {}
        self.push_reports: dict[str, dict] = {}
        self._push_reports_cap = 64
        # webhook/exec sinks, fired on pending→firing (and resolve)
        # transitions: SLO alerts and the external ones below
        self.notifier: AlertNotifier = AlertNotifier.from_env()
        # externally managed alerts (the online drift pause): name →
        # status dict, merged into alerts_payload and the firing gauge
        self._external: dict[str, dict] = {}

    # -- what the sampler samples ------------------------------------------
    def _families(self) -> list:
        """Every attached registry's families, then the process-default
        ones. Same-named families of different servers are all kept (a
        query server's and an Event Server's `http_requests_total` carry
        disjoint `server=` children); exact duplicate (name, labels)
        series, the CUDA and device-profile gauges every server's
        registry mounts over one global source, are written once a tick
        by the sampler, the first writer winning."""
        from predictionio_tpu_torch.obs.registry import get_default_registry

        seen_ids: set[int] = set()
        out = []
        with self._lock:
            registries = [reg for _t, _l, reg in self._attached]
        registries.append(get_default_registry())
        for reg in registries:
            for fam in reg.families():
                if id(fam) not in seen_ids:
                    seen_ids.add(id(fam))
                    out.append(fam)
        return out

    # -- lifecycle ---------------------------------------------------------
    def attach(self, label: str, registry: Any) -> Optional[int]:
        """Register a server's registry for sampling; returns a token for
        `detach` (None when the plane is disabled or the server has no
        registry)."""
        if not enabled() or registry is None:
            return None
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._attached.append((token, label, registry))
        self._ensure_threads()
        return token

    def detach(self, token: Optional[int]) -> None:
        if token is None:
            return
        stop_sampler = stop_engine = stop_snapshotter = stop_compactor = None
        stop_flusher = False
        with self._lock:
            self._attached = [row for row in self._attached if row[0] != token]
            if not self._attached:
                stop_sampler, self._sampler = self._sampler, None
                stop_engine, self._engine = self._engine, None
                stop_snapshotter, self._snapshotter = self._snapshotter, None
                stop_compactor, self._compactor = self._compactor, None
                stop_flusher = isinstance(self.tsdb, DurableTSDB)
        # join outside the lock: the threads' loops call back into us
        if stop_engine is not None:
            stop_engine.stop()
        if stop_sampler is not None:
            stop_sampler.stop()
        if stop_snapshotter is not None:
            stop_snapshotter.stop()  # also writes the final snapshot
        if stop_compactor is not None:
            stop_compactor.stop()
        if stop_flusher:
            self.tsdb.stop()  # the last WAL drain and fsync
        if stop_engine is not None or stop_sampler is not None:
            # the last detach joins in-flight alert deliveries too: no
            # notification thread outlives the plane
            self.notifier.close(timeout=2.0)

    def _ensure_threads(self) -> None:
        with self._lock:
            if not self._attached:
                return
            if self._sampler is None:
                self._sampler = MetricsSampler(self.tsdb, self._families,
                                               self.sampler_interval_s,
                                               post_sample=self._post_sample)
                self._sampler.start()
            specs = self._slo_union_locked()
            if self._engine is None and specs:
                self._engine = SLOEngine(self.tsdb, specs, self.slo_interval_s,
                                         on_transition=self._on_transition)
                # recorded ratios no staler than ~2 sampler ticks are
                # trusted; past that the engine rescans the raw rings
                self._engine.recorded_max_age_s = 2.5 * self.sampler_interval_s
                self._engine.start()
            if self._snapshotter is None and self.snapshot_path:
                self._snapshotter = SnapshotWriter(self.tsdb, self.snapshot_path,
                                                   interval_s=self.snapshot_interval_s)
                self._snapshotter.start()
            if self._compactor is None and isinstance(self.tsdb, DurableTSDB):
                self.tsdb.start()  # the tsdb-wal flusher
                self._compactor = Compactor(
                    self.tsdb, interval_s=durable_knob("PIO_TSDB_COMPACT_S"),
                    retention={"raw": durable_knob("PIO_TSDB_RETENTION_RAW"),
                               "5m": durable_knob("PIO_TSDB_RETENTION_5M"),
                               "1h": durable_knob("PIO_TSDB_RETENTION_1H")})
                self._compactor.start()

    def _post_sample(self, tsdb: TSDB, now: float) -> None:
        """The recording pass, on the sampler thread right after each raw
        snapshot: the user's recording rules, then the per-SLO ratio
        series the engine's fast path reads, then each pushed instance's
        push age."""
        if self.recording_rules:
            evaluate_rules(tsdb, self.recording_rules, now)
        with self._lock:
            specs = self._slo_union_locked()
            push_last = dict(self._push_last)
        if specs:
            record_slo_ratios(tsdb, specs, now)
        for instance, last in push_last.items():
            tsdb.add("telemetry_last_push_age_seconds", {"instance": instance},
                     max(0.0, now - last), "gauge", now)

    # -- SLOs --------------------------------------------------------------
    def set_slos(self, specs: list[SLOSpec]) -> None:
        """Install or replace the SLO set; starts the engine if servers
        are attached (tests and console monitor configure so, deployments
        through PIO_SLOS)."""
        with self._lock:
            self._slos = list(specs)
            if self._engine is not None:
                self._engine.set_specs(self._slo_union_locked())
        self._ensure_threads()

    def _slo_union_locked(self) -> list[SLOSpec]:
        """The operator's specs, then the tenant presets an operator
        spec of the same name does not shadow."""
        names = {s.name for s in self._slos}
        return self._slos + [p for p in self._presets if p.name not in names]

    def apply_tenant_presets(self, tenant_ids) -> None:
        """Install the per-tenant SLO presets of `tenant_ids` (the mux
        calls this at each refresh when PIO_TENANT_SLO_PRESETS is set); a
        no-op while the tenant set is unchanged."""
        specs = tenant_slo_presets(tenant_ids)
        with self._lock:
            if [s.name for s in specs] == [s.name for s in self._presets]:
                return
            self._presets = specs
            if self._engine is not None:
                self._engine.set_specs(self._slo_union_locked())
        self._ensure_threads()

    # -- trace collector and exemplars -----------------------------------
    def set_collector(self, collector: Optional[TraceCollector]) -> None:
        """Register (or clear) this process's fleet trace collector, so
        that `GET /debug/traces?fleet=1` and the alert evidence reach it.
        The owner keeps its start and stop."""
        self.collector = collector

    def note_exemplar(self, family: str, trace_id: str, value: float,
                      ts: Optional[float] = None,
                      labels: Optional[dict] = None) -> None:
        """Index one scraped exemplar: bounded per (family, observing
        label set), one slot a trace id, the fastest evicted when full."""
        ts = time.time() if ts is None else float(ts)
        lkey = tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))
        with self._lock:
            d = self._exemplars.setdefault(family, {}).setdefault(lkey, {})
            prev = d.get(trace_id)
            if prev is not None:
                if value > prev[0]:
                    d[trace_id] = (value, ts)
                return
            if len(d) >= self._exemplar_cap:
                floor_tid = min(d, key=lambda t: d[t])
                if value <= d[floor_tid][0]:
                    return
                del d[floor_tid]
            d[trace_id] = (value, ts)

    def exemplars(self, family: Optional[str] = None, limit: int = 8,
                  labels: Optional[dict] = None) -> list[dict]:
        """Slowest-first exemplars across the scraped fleet index and the
        local registries' histogram families, deduplicated by trace id.
        `labels` keeps the label sets that hold those pairs."""
        from predictionio_tpu_torch.obs.registry import HistogramFamily

        want = None if not labels else set((str(k), str(v)) for k, v in labels.items())
        rows: list[dict] = []
        with self._lock:
            for fam, by_lkey in self._exemplars.items():
                if family and fam != family:
                    continue
                for lkey, d in by_lkey.items():
                    if want is not None and not want <= set(lkey):
                        continue
                    rows.extend({"family": fam, "trace_id": tid, "value": v, "ts": ts,
                                 "labels": dict(lkey)} for tid, (v, ts) in d.items())
        for f in self._families():
            if isinstance(f, HistogramFamily) and (not family or f.name == family):
                for ex in f.exemplars():
                    ex_labels = ex.get("labels") or {}
                    if want is not None and not want <= set(
                            (str(k), str(v)) for k, v in ex_labels.items()):
                        continue
                    rows.append({"family": f.name, **ex})
        rows.sort(key=lambda r: r["value"], reverse=True)
        seen: set[str] = set()
        out: list[dict] = []
        for r in rows:
            if r["trace_id"] in seen:
                continue
            seen.add(r["trace_id"])
            out.append(r)
            if len(out) >= max(1, limit):
                break
        return out

    # -- push telemetry ----------------------------------------------------
    def note_push(self, instance: str, sampled_at: float,
                  devprof: Optional[dict] = None,
                  now: Optional[float] = None) -> None:
        """The bookkeeping of one ingested push: its freshness (the sampler
        rewrites telemetry_last_push_age_seconds from it) and the
        instance's newest devprof report. Writes an age point at once, so
        that the series exists before the next sampler tick."""
        now = time.time() if now is None else now
        with self._lock:
            self._push_last[instance] = now
            if devprof is not None:
                self.push_reports[instance] = devprof
                while len(self.push_reports) > self._push_reports_cap:
                    self.push_reports.pop(next(iter(self.push_reports)))
        self.tsdb.add("telemetry_last_push_age_seconds", {"instance": instance},
                      max(0.0, now - float(sampled_at)), "gauge", now)

    def push_status(self) -> list[dict]:
        """Each pushed instance's push age and whether it sent a devprof
        report, for the dashboard and the console."""
        now = time.time()
        with self._lock:
            rows = [{"instance": instance, "age_s": round(max(0.0, now - last), 3),
                     "devprof": instance in self.push_reports}
                    for instance, last in self._push_last.items()]
        rows.sort(key=lambda r: r["instance"])
        return rows

    def _enrich_alert(self, payload: dict) -> dict:
        """Attach evidence to a firing alert: the slowest exemplar trace
        ids of the relevant latency family, and the slowest assembled
        fleet traces when a collector runs here."""
        spec = payload.get("spec") or {}
        fam = "tenant_serve_seconds" if spec.get("tenant") else "http_request_seconds"
        try:
            exs = self.exemplars(family=fam, limit=4) or self.exemplars(limit=4)
        except Exception:
            exs = []
        if exs:
            payload["exemplars"] = exs
        collector = self.collector
        if collector is not None:
            try:
                slow = collector.slowest(limit=3)
            except Exception:
                slow = []
            if slow:
                payload["fleet_traces"] = slow
        return payload

    def _on_transition(self, payload: dict, old_state: str, new_state: str) -> None:
        if new_state == "firing":
            payload = self._enrich_alert(dict(payload))
        if new_state in ("firing", "resolved"):
            self.notifier.notify(dict(payload, transition=f"{old_state}->{new_state}"))

    # -- external alerts (the online drift pause) --------------------------
    def _firing_gauge(self):
        from predictionio_tpu_torch.obs.registry import get_default_registry

        return get_default_registry().gauge(
            "alerts_firing", "SLO alerts currently firing (1) or not (0)",
            # declared SLO specs and external alerts, which remove() their
            # series on resolve
            ("slo",),
        )

    def raise_alert(self, name: str, info: Optional[dict] = None) -> None:
        """Raise (or refresh) an externally managed alert: shown at `GET
        /alerts` and by `console alerts`, exported on `alerts_firing{slo}`
        and pushed through the notification sinks on the inactive→firing
        edge."""
        with self._lock:
            prev = self._external.get(name)
            was_firing = prev is not None and prev.get("state") == "firing"
            st = {"slo": name, "state": "firing", "external": True,
                  "since": prev.get("since") if was_firing else time.time(),
                  **(info or {})}
            self._external[name] = st
        try:
            self._firing_gauge().set(1.0, slo=name)
        except Exception:
            pass
        if not was_firing:
            self.notifier.notify(dict(st, transition="inactive->firing"))

    def resolve_alert(self, name: str) -> None:
        with self._lock:
            st = self._external.get(name)
            if st is None or st.get("state") != "firing":
                return
            # a resolved external alert is dropped after its notification:
            # the names are open-ended (one a consumer cursor), and keeping
            # each would grow /alerts and the gauge's label set
            self._external.pop(name, None)
            st = dict(st, state="resolved", since=time.time())
        try:
            # removed, not zeroed: no dead 0-series per name on /metrics
            self._firing_gauge().remove(slo=name)
        except Exception:
            pass
        self.notifier.notify(dict(st, transition="firing->resolved"))

    def _external_rows(self) -> list[dict]:
        with self._lock:
            return [dict(v) for v in self._external.values()]

    @property
    def engine(self) -> Optional[SLOEngine]:
        return self._engine

    @property
    def attached_count(self) -> int:
        with self._lock:
            return len(self._attached)

    def alerts_payload(self) -> dict:
        """The `GET /alerts` body, one shape whether or not the engine
        runs. External alerts (the drift pause) merge into `alerts` and
        `firing` beside the SLO ones."""
        engine = self._engine
        ext = self._external_rows()
        if engine is None:
            out = {
                "enabled": enabled(),
                "slos": [s.to_dict() for s in self._slos],
                "alerts": [],
                "firing": [],
                "message": (
                    "monitoring disabled (PIO_TSDB=0)" if not enabled()
                    else "no SLO engine running (configure PIO_SLOS or "
                         "Monitor.set_slos)"
                ),
            }
        else:
            out = {"enabled": True, **engine.payload()}
            for row in out.get("alerts", []):
                if row.get("state") == "firing":
                    self._enrich_alert(row)
        if ext:
            out["alerts"] = list(out.get("alerts", [])) + [
                r for r in ext if r.get("state") != "inactive"]
            out["firing"] = list(out.get("firing", [])) + [
                r["slo"] for r in ext if r.get("state") == "firing"]
        return out

    def tsdb_payload(self, qs: dict[str, str]) -> dict:
        """The `GET /debug/tsdb` body: the summary by default; `?name=`
        (with `labels=k:v,...`, `window_s=`, `agg=rate|increase|quantile`
        and `q=`) for points and aggregates; `?expr=` for an expression."""
        if not enabled():
            return {"enabled": False, "series": []}
        expr_s = qs.get("expr")
        if expr_s:
            from predictionio_tpu_torch.obs.monitor.expr import ExprError, evaluate_rows

            try:
                window_s = float(qs["window_s"]) if "window_s" in qs else 300.0
            except ValueError:
                window_s = 300.0
            try:
                rows = evaluate_rows(self.tsdb, expr_s, default_window_s=window_s)
            except ExprError as e:
                return {"enabled": True, "expr": expr_s, "error": str(e)}
            return {"enabled": True, "expr": expr_s, "result": rows}
        name = qs.get("name")
        if not name:
            try:
                limit = int(qs.get("limit", "0") or 0)
            except ValueError:
                limit = 0
            return {"enabled": True, **self.tsdb.summary(limit=limit)}
        match: Optional[dict] = None
        labels_s = qs.get("labels", "")
        if labels_s:
            match = {}
            for pair in labels_s.split(","):
                if not pair:
                    continue
                k, _, v = pair.partition(":") if ":" in pair else pair.partition("=")
                match[k.strip()] = v.strip()
        try:
            window_s = float(qs["window_s"]) if "window_s" in qs else None
        except ValueError:
            window_s = None
        agg = qs.get("agg")
        out: dict[str, Any] = {"enabled": True, "name": name}
        if agg in ("rate", "increase"):
            w = window_s or 300.0
            value = (self.tsdb.rate(name, match, w) if agg == "rate"
                     else self.tsdb.increase(name, match, w))
            out.update({"agg": agg, "window_s": w, "value": value})
        elif agg == "quantile":
            try:
                q = float(qs.get("q", "0.99"))
            except ValueError:
                q = 0.99
            out.update({"agg": agg, "q": q, "window_s": window_s,
                        "value": self.tsdb.quantile_over_time(name, q, match, window_s)})
        else:
            out["series"] = self.tsdb.range(name, match, window_s)
        return out


_monitor: Optional[Monitor] = None
_monitor_lock = threading.Lock()


def get_monitor() -> Monitor:
    """The process-wide monitor (created on first use, so knobs set
    before the first server starts are honoured)."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = Monitor()
        return _monitor
