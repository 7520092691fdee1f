"""Evaluation dashboard and fleet monitor (default port 9000).

Counterpart of the JAX package's ``tools/dashboard.py`` (reference
tools/.../dashboard/Dashboard.scala:37), the port's own copy. ``GET /``
is an HTML page: the completed evaluation instances newest first with
their one-liner results and links to the full HTML and JSON reports
(``/engine_instances/<id>.html|.json``), then the monitoring panels:
alerts (each SLO's state with a burn-rate sparkline), fleet (each scrape
target's up state and scrape time), fleet traces (the collector's
assembled traces), the TSDB explorer (``?series=&match=`` plots any
retained series as a sparkline, ``?expr=`` evaluates an expression),
the model lifecycle, the fleet evaluations (eval runs newest first: the
space, convergence, the winner and the lineage link to the model
version its params trained), the tenants (who shares the serving fleet,
with weights and quotas) and online learning. With a durable TSDB
tier (``PIO_TSDB_DIR``) the explorer also lists each tier's blocks,
series, bytes and span. ``POST /telemetry/push`` (403 unless
``PIO_PUSH_INGEST=1``) lands a pushed payload in the process monitor.
The routes every server shares (``/metrics``, ``/alerts``,
``/debug/*``) are mounted too.

With scrape targets (an argument or ``PIO_MONITOR_TARGETS``), `start`
runs a FleetScraper feeding every target's ``/metrics`` into the process
TSDB under an ``instance`` label, and, unless ``PIO_TRACE_COLLECT=0``, a
TraceCollector over the same targets that backs
``/debug/traces?fleet=1``. With ``PIO_PUSH_INGEST=1`` and no trace
collector of its own it mounts an unstarted one, so that pushed spans
have a place to land. Standard library only: no torch is loaded.
"""

from __future__ import annotations

import html
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.obs import server_registry
from predictionio_tpu_torch.obs.monitor import get_monitor
from predictionio_tpu_torch.utils.http import (
    HttpError,
    JsonHandler,
    ServerProcess,
    ThreadedServer,
)

class _Handler(JsonHandler):
    server: "_Server"  # type: ignore[assignment]

    def do_GET(self):
        self._drain_body()
        path = self.path.split("?")[0].rstrip("/") or "/"
        try:
            if path == "/":
                qs = parse_qs(urlsplit(self.path).query)
                self._respond(200, self._index(qs), "text/html")
            elif path == "/metrics":
                self._serve_metrics()
            elif path == "/alerts":
                self._serve_alerts()
            elif path == "/debug/traces":
                self._serve_debug_traces()
            elif path == "/debug/tsdb":
                self._serve_debug_tsdb()
            elif path == "/debug/profile":
                self._serve_debug_profile()
            elif path == "/debug/faults":
                self._serve_debug_faults()
            elif path.startswith("/engine_instances/") and path.endswith(".html"):
                inst = self._evaluation(path[len("/engine_instances/"):-len(".html")])
                self._respond(200, inst.evaluator_results_html or "<p>(no report)</p>",
                              "text/html")
            elif path.startswith("/engine_instances/") and path.endswith(".json"):
                inst = self._evaluation(path[len("/engine_instances/"):-len(".json")])
                self._respond(200, inst.evaluator_results_json or "{}")
            else:
                raise HttpError(404, "Not Found")
        except HttpError as e:
            self._respond(e.status, {"message": e.message})

    def do_POST(self):
        self._drain_body()
        path = self.path.split("?")[0].rstrip("/")
        try:
            if path == "/debug/faults":
                self._serve_debug_faults_set()
            elif path == "/telemetry/push":
                self._serve_telemetry_push()
            else:
                raise HttpError(404, "Not Found")
        except HttpError as e:
            self._respond(e.status, {"message": e.message})

    def _evaluation(self, iid: str):
        inst = self.server.storage.get_meta_data_evaluation_instances().get(iid)
        if inst is None:
            raise HttpError(404, "Not Found")
        return inst

    def _index(self, qs: Optional[dict] = None) -> str:
        instances = self.server.storage.get_meta_data_evaluation_instances().get_completed()
        rows = "".join(
            f"<tr><td>{i.id}</td><td>{i.start_time}</td>"
            f"<td>{html.escape(i.evaluation_class)}</td>"
            f"<td>{html.escape(i.evaluator_results)}</td>"
            f"<td><a href='/engine_instances/{i.id}.html'>HTML</a> "
            f"<a href='/engine_instances/{i.id}.json'>JSON</a></td></tr>"
            for i in instances
        )
        return f"""<!DOCTYPE html><html><head><title>predictionio_tpu dashboard</title></head>
<body><h1>Completed evaluations</h1>
<table border="1" cellpadding="4">
<tr><th>ID</th><th>Started</th><th>Evaluation</th><th>Result</th><th>Reports</th></tr>
{rows}
</table>
{self._alerts_html()}
{self._fleet_html()}
{self._traces_html()}
{self._tsdb_html(qs or {})}
{self._lifecycle_html()}
{self._evals_html()}
{self._tenants_html()}
{self._online_html()}
</body></html>"""

    # -- tenants -----------------------------------------------------------
    def _tenants_html(self) -> str:
        """Who shares the serving fleet, with weights and quotas; the
        descriptions are the operators', so everything is escaped."""
        from predictionio_tpu_torch.tenancy.tenants import TenantStore

        try:
            store = getattr(self.server, "tenant_store", None)
            if store is None:
                store = self.server.tenant_store = TenantStore(self.server.storage)
            tenants = store.list()
        except Exception:  # noqa: BLE001 — the page renders without it
            return "<h1>Tenants</h1><p>(tenant store unavailable)</p>"
        if not tenants:
            return "<h1>Tenants</h1><p>(no tenants registered)</p>"

        def fmt(v):
            return "∞" if v is None else html.escape(str(v))

        rows = "".join(
            f"<tr><td>{html.escape(t.id)}</td>"
            f"<td>{html.escape(t.engine_id)}/{html.escape(t.engine_variant)}</td>"
            f"<td>{t.weight:g}</td>"
            f"<td>{fmt(t.qps)}</td><td>{fmt(t.max_concurrency)}</td>"
            f"<td>{fmt(t.device_seconds_per_s)}</td>"
            f"<td>{'yes' if t.enabled else 'no'}</td>"
            f"<td>{html.escape(t.description)}</td></tr>"
            for t in tenants
        )
        return f"""<h1>Tenants</h1>
<table border="1" cellpadding="4">
<tr><th>Tenant</th><th>Engine</th><th>Weight</th><th>QPS</th>
<th>Concurrency</th><th>Device s/s</th><th>Enabled</th><th>Note</th></tr>
{rows}
</table>"""

    # -- online learning ---------------------------------------------------
    def _online_html(self) -> str:
        """Each online consumer's durable cursor record: stream positions
        and cumulative fold counters."""
        from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore
        from predictionio_tpu_torch.online.consumer import CURSOR_ENTITY

        try:
            records = LifecycleRecordStore(self.server.storage).fold(CURSOR_ENTITY)
        except Exception:
            return "<h1>Online learning</h1><p>(cursor store unavailable)</p>"
        if not records:
            return "<h1>Online learning</h1><p>(no consumers recorded)</p>"
        rows = "".join(
            f"<tr><td>{html.escape(cid)}</td>"
            f"<td>{html.escape(str(rec.get('cursor')))}</td>"
            f"<td>{rec.get('events_consumed', 0)}</td>"
            f"<td>{rec.get('events_folded', 0)}</td>"
            f"<td>{rec.get('users_folded', 0)}</td>"
            f"<td>{rec.get('items_folded', 0)}</td>"
            f"<td>{rec.get('ticks', 0)}</td></tr>"
            for cid, rec in sorted(records.items())
        )
        return f"""<h1>Online learning</h1>
<table border="1" cellpadding="4">
<tr><th>Consumer</th><th>Cursor</th><th>Consumed</th><th>Folded</th>
<th>User rows</th><th>Item rows</th><th>Ticks</th></tr>
{rows}
</table>"""

    # -- monitoring plane --------------------------------------------------
    _SPARK_BLOCKS = "▁▂▃▄▅▆▇█"

    @classmethod
    def _sparkline(cls, values: list, width: int = 40) -> str:
        """Unicode-block sparkline of the last `width` values (None: a
        gap), scaled to the window's max so the shape survives any unit."""
        vals = list(values[-width:])
        nums = [v for v in vals if v is not None]
        if not nums:
            return ""
        top = max(nums) or 1.0
        out = []
        for v in vals:
            if v is None:
                out.append(" ")
            else:
                idx = min(len(cls._SPARK_BLOCKS) - 1,
                          int(max(0.0, v) / top * (len(cls._SPARK_BLOCKS) - 1)))
                out.append(cls._SPARK_BLOCKS[idx])
        return "".join(out)

    def _alerts_html(self) -> str:
        """Each SLO's state with a fast-burn sparkline from the engine's
        history. SLO names are operator-authored, so escaped."""
        monitor = get_monitor()
        engine = monitor.engine
        payload = monitor.alerts_payload()
        if not payload.get("slos"):
            return ("<h1>Alerts</h1><p>(no SLOs configured — set PIO_SLOS "
                    "or use Monitor.set_slos)</p>")
        color = {"firing": "#c00", "pending": "#c80", "resolved": "#080",
                 "inactive": "#888"}
        rows = []
        for r in payload["slos"]:
            name = r["slo"]
            spark = ""
            if engine is not None:
                spark = self._sparkline([v for _t, v in engine.history(name)])
            fast = r.get("fast_burn")
            slow = r.get("slow_burn")
            state = r.get("state", "inactive")
            rows.append(
                f"<tr><td>{html.escape(name)}</td>"
                f"<td style='color:{color.get(state, '#000')}'>"
                f"<b>{html.escape(state)}</b></td>"
                f"<td>{'-' if fast is None else f'{fast:.2f}'}</td>"
                f"<td>{'-' if slow is None else f'{slow:.2f}'}</td>"
                f"<td>{r.get('burn_threshold')}</td>"
                f"<td><code>{html.escape(spark)}</code></td></tr>"
            )
        return f"""<h1>Alerts</h1>
<table border="1" cellpadding="4">
<tr><th>SLO</th><th>State</th><th>Fast burn</th><th>Slow burn</th>
<th>Threshold</th><th>Burn history</th></tr>
{''.join(rows)}
</table>"""

    def _fleet_html(self) -> str:
        """Each scrape target's up state and scrape time with an `up`
        sparkline: a dead server shows on the page."""
        scraper = self.server.fleet_scraper
        if scraper is None:
            return ""
        tsdb = get_monitor().tsdb
        rows = []
        for t in scraper.status():
            ups = []
            for s in tsdb.matching("up", {"instance": t["instance"]}):
                ups = [v for _t, v in tsdb.points(s)]
            up = t["up"]
            state = "?" if up is None else ("up" if up else "DOWN")
            lat = t["scrape_seconds"]
            rows.append(
                f"<tr><td>{html.escape(t['instance'])}</td>"
                f"<td>{html.escape(t['url'])}</td>"
                f"<td><b>{state}</b></td>"
                f"<td>{'-' if lat is None else f'{lat * 1e3:.1f} ms'}</td>"
                f"<td><code>{html.escape(self._sparkline(ups))}</code></td></tr>"
            )
        return f"""<h1>Fleet</h1>
<table border="1" cellpadding="4">
<tr><th>Instance</th><th>URL</th><th>Up</th><th>Scrape</th>
<th>Up history</th></tr>
{''.join(rows)}
</table>"""

    def _traces_html(self) -> str:
        """The collector's assembled cross-process traces, newest first
        (`console trace show --fleet` prints the tree)."""
        col = get_monitor().collector
        if col is None:
            return ""
        rows = "".join(
            f"<tr><td><code>{html.escape(s['trace_id'])}</code></td>"
            f"<td>{html.escape(s['root'])}</td>"
            f"<td>{html.escape(','.join(s.get('servers') or []))}</td>"
            f"<td>{html.escape(s.get('path') or '')}</td>"
            f"<td>{s['duration_ms']:.1f} ms</td>"
            f"<td>{s['spans']}</td>"
            f"<td>{html.escape(s['kept'])}"
            f"{' <b>ERROR</b>' if s['error'] else ''}</td></tr>"
            for s in col.summaries(limit=15)
        )
        st = col.status()
        return f"""<h1>Fleet traces</h1>
<p>{st['assembled']} assembled, {st['pending_fragments']} pending
fragment(s), {st['polls']} poll(s)</p>
<table border="1" cellpadding="4">
<tr><th>Trace</th><th>Root</th><th>Servers</th><th>Path</th>
<th>Duration</th><th>Spans</th><th>Kept</th></tr>
{rows}
</table>"""

    def _tsdb_html(self, qs: dict) -> str:
        """The TSDB explorer: any retained series (raw samples or a
        recording rule's output) as a sparkline, by ``?series=<name>``
        with an optional ``match=k=v,k=v``, or ``?expr=`` evaluated."""
        tsdb = get_monitor().tsdb
        name = (qs.get("series") or [""])[0].strip()
        match_raw = (qs.get("match") or [""])[0].strip()
        expr_s = (qs.get("expr") or [""])[0].strip()
        form = f"""<form method="get" action="/">
<input name="series" size="40" value="{html.escape(name)}"
 placeholder="series name, e.g. slo_error_ratio">
<input name="match" size="30" value="{html.escape(match_raw)}"
 placeholder="label match, e.g. slo=availability">
<input type="submit" value="Plot"></form>
<form method="get" action="/">
<input name="expr" size="72" value="{html.escape(expr_s)}"
 placeholder="expression, e.g. sum by (instance) (rate(errors_total[5m]))">
<input type="submit" value="Eval"></form>"""
        if expr_s:
            from predictionio_tpu_torch.obs.monitor.expr import ExprError, evaluate_rows

            try:
                rows_v = evaluate_rows(tsdb, expr_s)
            except ExprError as e:
                return (f"<h1>TSDB explorer</h1>{form}"
                        f"<p>expression error: <code>{html.escape(str(e))}</code></p>")
            if not rows_v:
                return f"<h1>TSDB explorer</h1>{form}<p>(expression matched no data)</p>"
            body = "".join(
                "<tr><td><code>"
                + (html.escape(",".join(f"{k}={v}" for k, v in sorted(r["labels"].items())))
                   or "-")
                + f"</code></td><td>{r['value']:g}</td></tr>"
                for r in rows_v
            )
            return f"""<h1>TSDB explorer</h1>{form}
<table border="1" cellpadding="4">
<tr><th>Labels</th><th>Value</th></tr>
{body}
</table>"""
        if not name:
            return (f"<h1>TSDB explorer</h1>{form}"
                    f"<p>({tsdb.series_count()} series retained)</p>"
                    f"{self._durable_html(tsdb)}")
        match = None
        if match_raw:
            match = dict(p.split("=", 1) for p in match_raw.split(",") if "=" in p)
        series = tsdb.matching(name, match)
        if not series:
            return (f"<h1>TSDB explorer</h1>{form}"
                    f"<p>(no series named <code>{html.escape(name)}</code>"
                    + (f" matching <code>{html.escape(match_raw)}</code>"
                       if match_raw else "") + ")</p>")
        rows = []
        for s in series[:32]:
            pts = tsdb.points(s)
            vals = [v for _t, v in pts]
            last = vals[-1] if vals else None
            lbls = ",".join(f"{k}={v}" for k, v in sorted(s.labels))
            rows.append(
                f"<tr><td><code>{html.escape(lbls) or '-'}</code></td>"
                f"<td>{html.escape(s.kind)}</td>"
                f"<td>{len(pts)}</td>"
                f"<td>{'-' if last is None else f'{last:g}'}</td>"
                f"<td><code>{html.escape(self._sparkline(vals))}</code></td></tr>"
            )
        extra = (f"<p>(showing 32 of {len(series)} series)</p>"
                 if len(series) > 32 else "")
        return f"""<h1>TSDB explorer</h1>{form}
<table border="1" cellpadding="4">
<tr><th>Labels</th><th>Kind</th><th>Points</th><th>Last</th>
<th>History</th></tr>
{''.join(rows)}
</table>{extra}"""

    @staticmethod
    def _durable_html(tsdb) -> str:
        """The durable tiers: blocks, series, bytes and span of each, so
        an operator sees how far back a query reaches past the ring."""
        if not hasattr(tsdb, "durable_stats"):
            return ""
        ds = tsdb.durable_stats()
        rows = "".join(
            f"<tr><td>{html.escape(t)}</td>"
            f"<td>{st['blocks']}</td><td>{st['series']}</td>"
            f"<td>{st['bytes']}</td>"
            + (f"<td>{st['max_t'] - st['min_t']:.0f}s</td>"
               if st["min_t"] is not None else "<td>-</td>")
            + "</tr>"
            for t, st in ds.get("tiers", {}).items()
        )
        return f"""<h2>Durable tiers</h2>
<p><code>{html.escape(str(ds.get('dir')))}</code> —
wal {ds['wal']['segments']} segment(s), {ds['wal']['pending']} pending;
replayed {ds.get('replayed_points', 0)} pts /
{ds.get('replayed_series', 0)} series at attach</p>
<table border="1" cellpadding="4">
<tr><th>Tier</th><th>Blocks</th><th>Series</th><th>Bytes</th>
<th>Span</th></tr>
{rows}
</table>"""

    def _lifecycle_html(self) -> str:
        """Model versions newest first with their rollout state, active
        canaries leading. Reasons are operator-authored, so escaped."""
        from predictionio_tpu_torch.deploy.registry import ModelRegistry

        try:
            if self.server.model_registry is None:
                self.server.model_registry = ModelRegistry(self.server.storage)
            versions = self.server.model_registry.list()
        except Exception:
            return "<h1>Model lifecycle</h1><p>(registry unavailable)</p>"
        if not versions:
            return "<h1>Model lifecycle</h1><p>(no registered versions)</p>"
        order = {"canary": 0, "live": 1}
        versions.sort(key=lambda v: order.get(v.status, 2))
        rows = "".join(
            f"<tr><td>{html.escape(v.id)}</td>"
            f"<td>{html.escape(v.engine_id)}/{html.escape(v.engine_variant)}</td>"
            f"<td><b>{html.escape(v.status)}</b></td>"
            f"<td>{html.escape(v.created_at)}</td>"
            f"<td>{html.escape(v.params_hash)}</td>"
            f"<td>{html.escape(v.reason or '')}</td></tr>"
            for v in versions
        )
        return f"""<h1>Model lifecycle</h1>
<table border="1" cellpadding="4">
<tr><th>Version</th><th>Engine</th><th>Status</th><th>Created</th><th>Params hash</th><th>Note</th></tr>
{rows}
</table>"""


    def _evals_html(self) -> str:
        """The fleet evaluation's runs newest first: the space, the
        convergence, the winner and the lineage link to the model version
        the winning params trained."""
        from predictionio_tpu_torch.evalfleet.records import EvalRecordStore

        try:
            runs = EvalRecordStore(self.server.storage).list_runs()
        except Exception:
            return "<h1>Fleet evaluations</h1><p>(eval store unavailable)</p>"
        if not runs:
            return "<h1>Fleet evaluations</h1><p>(no eval runs recorded)</p>"
        rows = "".join(
            f"<tr><td>{html.escape(r.id)}</td>"
            f"<td>{html.escape(r.engine_id)}</td>"
            f"<td>{html.escape(r.tenant or '-')}</td>"
            f"<td>{r.status}</td>"
            f"<td>{r.num_points} pts / {r.num_groups} grp "
            f"&times; {r.num_folds} folds</td>"
            f"<td>{html.escape(r.metric_header)}</td>"
            f"<td>{'-' if r.winner_score is None else f'{r.winner_score:.6g}'}"
            f"{'' if r.winner_index is None else f' (p{r.winner_index})'}</td>"
            f"<td>{html.escape(r.winner_model_version or '-')}</td></tr>"
            for r in runs[:50]
        )
        return f"""<h1>Fleet evaluations</h1>
<table border="1" cellpadding="4">
<tr><th>Run</th><th>Engine</th><th>Tenant</th><th>Status</th>
<th>Space</th><th>Metric</th><th>Winner</th><th>Model version</th></tr>
{rows}
</table>"""


class _Server(ThreadedServer):
    def __init__(self, addr, storage: Storage):
        super().__init__(addr, _Handler)
        self.storage = storage
        self.metrics = server_registry()
        self.metrics_label = "dashboard"
        self.fleet_scraper = None
        self.model_registry = None
        self.tenant_store = None


class Dashboard(ServerProcess):
    """The fleet's aggregation point: with scrape targets (an argument or
    PIO_MONITOR_TARGETS), a FleetScraper feeds every target's /metrics
    into the process TSDB under an `instance` label, and the index grows
    the alerts and fleet panels."""

    _name = "dashboard"

    def __init__(self, storage: Optional[Storage] = None, ip: str = "0.0.0.0",
                 port: int = 9000, monitor_targets: Optional[str] = None,
                 scrape_interval_s: Optional[float] = None):
        from predictionio_tpu_torch.utils.env import monitor_knob

        super().__init__()
        self.storage = storage or Storage()
        self.ip = ip
        self.port_config = port
        self.monitor_targets = (monitor_targets if monitor_targets is not None
                                else monitor_knob("PIO_MONITOR_TARGETS"))
        self.scrape_interval_s = scrape_interval_s
        self._scraper = None
        self._collector = None

    def _make_server(self) -> _Server:
        return _Server((self.ip, self.port_config), self.storage)

    def start(self) -> int:
        from predictionio_tpu_torch.obs.monitor import (
            FleetScraper,
            TraceCollector,
            enabled,
            parse_targets,
        )
        from predictionio_tpu_torch.utils.env import monitor_knob, push_knob

        port = super().start()
        targets = parse_targets(self.monitor_targets)
        push_ingest = push_knob("PIO_PUSH_INGEST")
        if push_ingest and enabled() and not targets:
            # a push-ingest sink: pushed spans need a collector to land
            # in, and with no targets there is nothing to poll, so its
            # thread is not started
            self._collector = TraceCollector(targets=[], interval_s=3600)
            get_monitor().set_collector(self._collector)
        if targets and enabled():
            interval = (self.scrape_interval_s if self.scrape_interval_s is not None
                        else monitor_knob("PIO_SCRAPE_INTERVAL_S"))
            self._scraper = FleetScraper(get_monitor().tsdb, targets, interval_s=interval)
            self._scraper.start()
            self._server.fleet_scraper = self._scraper  # type: ignore[union-attr]
            if monitor_knob("PIO_TRACE_COLLECT"):
                # the dashboard is the fleet's trace assembly point
                self._collector = TraceCollector(targets=list(targets),
                                                 interval_s=interval)
                get_monitor().set_collector(self._collector)
                self._collector.start()
            elif push_ingest:
                # scraping without polling traces: pushed spans still
                # need an (unstarted) collector
                self._collector = TraceCollector(targets=[], interval_s=3600)
                get_monitor().set_collector(self._collector)
        return port

    def stop(self) -> None:
        if self._collector is not None:
            self._collector.stop()  # joins the collect thread
            mon = get_monitor()
            if mon.collector is self._collector:
                mon.set_collector(None)
            self._collector = None
        if self._scraper is not None:
            self._scraper.stop()  # joins the scrape thread
            self._scraper = None
        super().stop()
