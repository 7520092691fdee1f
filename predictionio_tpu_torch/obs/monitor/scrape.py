"""Fleet scrape aggregation: many servers' /metrics into one TSDB.

Counterpart of the JAX package's ``obs/monitor/scrape.py``, the port's
own copy. A deployment runs an Event Server, query servers, an admin
server and a dashboard; the :class:`FleetScraper` polls a target list's
``/metrics`` (the Prometheus text the registry emits), tags every parsed
series with an ``instance`` label and feeds the same in-process TSDB the
local sampler uses, so the dashboard (or ``console monitor``) sees the
whole deployment through one query API.

Per-target meta-series make a dead server an alertable signal:

- ``up{instance=}``                        1 scrape ok / 0 unreachable
- ``scrape_duration_seconds{instance=}``   scrape wall time

Targets parse from ``PIO_MONITOR_TARGETS`` (or an argument):
``instance=url`` pairs, comma-separated:
``query=http://host:8000,event=http://host:7070``. A bare url gets its
``host:port`` as the instance name.

With a durable tier (``PIO_TSDB_DIR``) the scraped series write through
:class:`~.durable.DurableTSDB` as every other writer does: the fleet's
history, ``up`` included, survives a monitor restart and ages through the
5m and 1h tiers, so multi-window burn-rate SLOs over scraped series keep
working across restarts.
"""

from __future__ import annotations

import logging
import threading
import time
import urllib.request
from typing import Optional
from urllib.parse import urlsplit

from predictionio_tpu_torch.obs.monitor.tsdb import TSDB

log = logging.getLogger(__name__)


def parse_targets(text: str) -> list[tuple[str, str]]:
    """``name=url,name=url`` (or bare urls) → [(instance, base_url)]."""
    out: list[tuple[str, str]] = []
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part.split("://", 1)[0]:
            name, _, url = part.partition("=")
            name = name.strip()
        else:
            name, url = "", part
        url = url.strip().rstrip("/")
        if not name:
            name = urlsplit(url).netloc or url
        out.append((name, url))
    return out


def parse_exemplar_lines(
    text: str,
) -> list[tuple[str, str, float, float, dict]]:
    """Parse the registry's ``# EXEMPLAR <family> <trace_id> <value>
    <ts> [<labels-json>]`` comment lines →
    [(family, trace_id, value, ts, labels)]. The trailing compact-JSON
    token is the observing label set; 6-token lines parse with empty
    labels. JSON label values may
    contain spaces, so the line is split at most 6 times and the
    remainder JSON-decoded. Plain Prometheus parsers skip all of it as
    comments; the fleet scraper feeds these into the Monitor's exemplar
    index so a firing alert can link straight to the slowest traces
    anywhere in the fleet."""
    import json as _json

    out: list[tuple[str, str, float, float, dict]] = []
    for line in text.splitlines():
        parts = line.strip().split(None, 6)
        if len(parts) < 6 or parts[0] != "#" or parts[1] != "EXEMPLAR":
            continue
        labels: dict = {}
        if len(parts) == 7:
            try:
                decoded = _json.loads(parts[6])
                if isinstance(decoded, dict):
                    labels = {str(k): str(v) for k, v in decoded.items()}
            except ValueError:
                continue
        try:
            out.append(
                (parts[2], parts[3], float(parts[4]), float(parts[5]),
                 labels)
            )
        except ValueError:
            continue
    return out


def parse_prometheus_text(text: str) -> list[tuple[str, dict, float]]:
    """Parse exposition-format samples → [(name, labels, value)].

    Handles exactly what `obs.registry.render_families` emits (v0.0.4
    text: HELP/TYPE comments, ``name{k="v",...} value`` lines with
    backslash-escaped label values). Unparseable lines are skipped —
    a half-broken peer must not kill the scrape pass."""
    samples: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                labels_s, _, value_s = rest.rpartition("}")
                labels = _parse_labels(labels_s)
            else:
                name, _, value_s = line.rpartition(" ")
                labels = {}
            value_s = value_s.strip()
            value = float(
                "inf" if value_s == "+Inf"
                else "-inf" if value_s == "-Inf" else value_s
            )
            samples.append((name.strip(), labels, value))
        except (ValueError, IndexError):
            continue
    return samples


def _parse_labels(s: str) -> dict[str, str]:
    labels: dict[str, str] = {}
    i = 0
    n = len(s)
    while i < n:
        eq = s.index("=", i)
        key = s[i:eq].strip().lstrip(",").strip()
        # value is a double-quoted string with \\ \" \n escapes
        j = s.index('"', eq) + 1
        buf: list[str] = []
        while j < n:
            ch = s[j]
            if ch == "\\" and j + 1 < n:
                nxt = s[j + 1]
                buf.append("\n" if nxt == "n" else nxt)
                j += 2
                continue
            if ch == '"':
                break
            buf.append(ch)
            j += 1
        labels[key] = "".join(buf)
        i = j + 1
    return labels


class FleetScraper:
    """Background scrape loop over a fixed target list, feeding `tsdb`.
    `stop()` joins the thread (the no-leaked-threads contract)."""

    thread_name = "fleet-scraper"

    def __init__(self, tsdb: TSDB, targets: list[tuple[str, str]],
                 interval_s: float = 10.0, timeout_s: float = 5.0,
                 backoff_max_s: Optional[float] = None):
        from predictionio_tpu_torch.utils.env import monitor_knob

        self.tsdb = tsdb
        self.targets = list(targets)
        self.interval_s = max(0.05, float(interval_s))
        self.timeout_s = float(timeout_s)
        # a down target is not re-polled every
        # interval — each consecutive failure doubles the wait (capped),
        # so a dead replica doesn't eat a connect timeout per tick. The
        # up{instance}=0 point still lands every logical tick below, so
        # alerting freshness is unaffected by the backoff.
        self.backoff_max_s = float(
            backoff_max_s if backoff_max_s is not None
            else monitor_knob("PIO_SCRAPE_BACKOFF_MAX_S")
        )
        self._fails: dict[str, int] = {}       # consecutive failures
        self._not_before: dict[str, float] = {}  # next attempt (epoch s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def backoff_remaining(self, instance: str,
                          now: Optional[float] = None) -> float:
        """Seconds until the next real attempt at `instance` (0 when it
        is due — or healthy)."""
        now = time.time() if now is None else now
        return max(0.0, self._not_before.get(instance, 0.0) - now)

    # -- one pass ----------------------------------------------------------
    def scrape_once(self, now: Optional[float] = None) -> dict[str, bool]:
        """Scrape every target once; returns {instance: up}. Targets
        inside their failure backoff are skipped (no HTTP), but still
        write up=0 for the tick."""
        results: dict[str, bool] = {}
        for instance, base in self.targets:
            now_t = time.time() if now is None else now
            if now_t < self._not_before.get(instance, 0.0):
                self.tsdb.add(
                    "up", {"instance": instance}, 0.0, "gauge", now_t,
                )
                results[instance] = False
                continue
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(
                    base + "/metrics", timeout=self.timeout_s
                ) as r:
                    body = r.read().decode(errors="replace")
                up = True
            except Exception as e:
                body = ""
                up = False
                log.debug("scrape of %s (%s) failed: %s", instance, base, e)
            dur = time.perf_counter() - t0
            if up:
                self._fails.pop(instance, None)
                self._not_before.pop(instance, None)
            else:
                n = self._fails.get(instance, 0) + 1
                self._fails[instance] = n
                self._not_before[instance] = now_t + min(
                    self.interval_s * (2.0 ** n), self.backoff_max_s
                )
            self.tsdb.add(
                "up", {"instance": instance}, 1.0 if up else 0.0,
                "gauge", now_t,
            )
            self.tsdb.add(
                "scrape_duration_seconds", {"instance": instance}, dur,
                "gauge", now_t,
            )
            if up:
                written = 0
                for name, labels, value in parse_prometheus_text(body):
                    kind = (
                        "counter" if name.endswith(
                            ("_total", "_count", "_sum", "_bucket")
                        ) else "gauge"
                    )
                    if self.tsdb.add(
                        name, {**labels, "instance": instance}, value,
                        kind, now_t,
                    ):
                        written += 1
                self.tsdb.add(
                    "scrape_samples_stored", {"instance": instance},
                    written, "gauge", now_t,
                )
                self._index_exemplars(body)
            results[instance] = up
        return results

    def _index_exemplars(self, body: str) -> None:
        """Feed scraped `# EXEMPLAR` lines to the process monitor's
        index (late import: obs.monitor imports this module)."""
        try:
            from predictionio_tpu_torch.obs.monitor import get_monitor

            note = get_monitor().note_exemplar
            for family, tid, value, ts, labels in parse_exemplar_lines(
                body
            ):
                note(family, tid, value, ts, labels=labels)
        except Exception:
            log.debug("exemplar indexing failed", exc_info=True)

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
                self.scrape_once()
            except Exception:
                log.exception("fleet scrape pass failed; will retry")
            if self._stop.wait(self.interval_s):
                return

    def status(self) -> list[dict]:
        """Per-target latest up/latency, read back off the TSDB (one
        source of truth for the dashboard panel and `console monitor`)."""
        out = []
        for instance, base in self.targets:
            match = {"instance": instance}
            up = self.tsdb.latest("up", match)
            dur = self.tsdb.latest("scrape_duration_seconds", match)
            row = {
                "instance": instance,
                "url": base,
                "up": None if up is None else bool(up),
                "scrape_seconds": dur,
            }
            backoff = self.backoff_remaining(instance)
            if backoff > 0:
                row["backoff_s"] = round(backoff, 1)
            out.append(row)
        return out
