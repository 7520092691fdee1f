"""Push telemetry for short-lived processes.

Counterpart of the JAX package's ``obs/monitor/push.py``, the port's own
copy: the same payload, spool files, token and route, so either
package's shipper pushes to the other's ingest. The monitor plane polls
(the fleet scraper reads ``/metrics``, the trace collector
``/debug/traces``); a train child that lives for seconds usually dies
between polls and takes its devprof report, its ``train.*`` spans and
its last counters with it. This module is the push half:

- :class:`TelemetryShipper`, inside the short-lived process: every
  ``interval_s`` it snapshots the process's metric families, its recent
  spans and the devprof report (when it has ``executables``) into a
  local fsync'd spool file, then ships every spooled file to the ingest
  URL (``POST /telemetry/push``) with ``resilience/retry.py`` backoff
  inside a wall-clock deadline. ``stop()`` spools and ships once more,
  so a clean exit loses nothing; a process killed with SIGKILL leaves
  its spool for its supervisor to ship (:func:`ship_spool`; the train
  scheduler ships each dead child's ``<job>.spool``).
- :func:`ingest`, the server side: every pushed series is tagged
  ``instance`` and ``job_id`` and written into the monitor's TSDB at its
  sampled time (the TSDB's ordered insert keeps a late backfill right),
  spans go to the trace collector, the devprof report is kept, and
  ``telemetry_last_push_age_seconds{instance}`` is refreshed: a silent
  process becomes alertable, as ``up{instance}`` makes a scraped one.

Standard library only on import: the processes that ship telemetry need
not load torch for it.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Optional

from predictionio_tpu_torch.obs import spans as _spans
from predictionio_tpu_torch.obs.monitor.tsdb import TSDB, sample_families
from predictionio_tpu_torch.resilience.retry import RetryPolicy
from predictionio_tpu_torch.utils.env import push_knob

log = logging.getLogger(__name__)

__all__ = [
    "PushAuthError",
    "PushError",
    "TelemetryShipper",
    "build_payload",
    "ingest",
    "issue_push_token",
    "ship_spool",
    "spool_payload",
    "verify_push_token",
]

PAYLOAD_VERSION = 1

#: the ingest route, relative to the push base URL
PUSH_ROUTE = "/telemetry/push"

#: the header that carries the instance's push token
TOKEN_HEADER = "X-PIO-Push-Token"


class PushError(ValueError):
    """A malformed push payload (ingest side → HTTP 400)."""


class PushAuthError(PushError):
    """A missing/invalid push token (ingest side → HTTP 403)."""


# -- per-instance push auth --------------------------------------------------
#
# PIO_PUSH_TOKEN is a secret shared by the receiver and the processes
# allowed to push. The wire token is HMAC-SHA256(secret, instance), bound
# to the payload's `instance` label: a token taken from instance A cannot
# write series labeled B, and a sender without the secret cannot make up
# series at all. The train scheduler hands the secret to its children in
# their environment; the shipper derives the wire token itself.


def issue_push_token(instance: str, secret: str) -> str:
    """The wire token authorizing pushes labeled `instance`."""
    return hmac.new(
        secret.encode(), str(instance).encode(), hashlib.sha256
    ).hexdigest()


def verify_push_token(instance: str, token: Optional[str],
                      secret: str) -> bool:
    """Constant-time check of a presented wire token."""
    if not token:
        return False
    return hmac.compare_digest(
        issue_push_token(instance, secret), str(token)
    )


# -- payload construction (the ephemeral process side) -----------------------


def build_payload(
    instance: str,
    job_id: Optional[str] = None,
    registries: Optional[list] = None,
    recorder: Optional[_spans.SpanRecorder] = None,
    span_since: float = 0.0,
    now: Optional[float] = None,
    include_devprof: bool = True,
) -> dict:
    """One self-contained push payload: a point-in-time snapshot of the
    given registries' families (default registry included), spans ended
    since `span_since`, and the devprof report when one exists."""
    from predictionio_tpu_torch.obs.registry import get_default_registry

    now = time.time() if now is None else now
    seen: set[int] = set()
    families = []
    for reg in list(registries or []) + [get_default_registry()]:
        for fam in reg.families():
            if id(fam) not in seen:
                seen.add(id(fam))
                families.append(fam)
    # the sampler's own flattening (histograms to _count/_sum/_bucket and
    # quantile gauges, duplicates written once) through a throwaway TSDB
    tmp = TSDB(capacity=2, max_series=1 << 17)
    sample_families(tmp, families, now=now)
    series = []
    with tmp._lock:
        for s in tmp._series.values():
            if s.points:
                series.append({
                    "name": s.name,
                    "labels": s.labels_dict(),
                    "value": s.points[-1][1],
                    "kind": s.kind,
                })
    recorder = recorder if recorder is not None else (
        _spans.get_default_recorder()
    )
    spans = [sp.to_dict() for sp in recorder.recent(since=span_since)]
    payload: dict[str, Any] = {
        "v": PAYLOAD_VERSION,
        "instance": instance,
        "sampled_at": round(now, 3),
        "series": series,
        "spans": spans,
    }
    if job_id:
        payload["job_id"] = str(job_id)
    if include_devprof:
        try:
            from predictionio_tpu_torch.obs import devprof as _devprof

            report = _devprof.report()
            if report.get("executables"):
                payload["devprof"] = report
        except Exception:
            pass  # profiling is best-effort; the payload stays valid
    return payload


def spool_payload(spool_dir: str, payload: dict, seq: int = 0) -> str:
    """Write one payload to the spool, durably: tmp + fsync + atomic
    rename + directory fsync. Filenames sort in ship order."""
    os.makedirs(spool_dir, exist_ok=True)
    name = f"{int(payload.get('sampled_at', time.time()) * 1000):015d}" \
           f"-{os.getpid()}-{seq:04d}.json"
    path = os.path.join(spool_dir, name)
    tmp = path + ".tmp"
    data = json.dumps(payload, separators=(",", ":")).encode()
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(spool_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # platform without dir fsync: rename durability is best-effort
    return path


def _spool_files(spool_dir: str) -> list[str]:
    try:
        names = os.listdir(spool_dir)
    except OSError:
        return []
    return sorted(
        os.path.join(spool_dir, n) for n in names
        if n.endswith(".json") and not n.endswith(".tmp")
    )


def trim_spool(spool_dir: str, max_bytes: int) -> int:
    """Drop oldest spool files until the directory fits `max_bytes`
    (the shipper calls this after each spool write). Returns dropped."""
    files = _spool_files(spool_dir)
    sizes = {}
    for p in files:
        try:
            sizes[p] = os.path.getsize(p)
        except OSError:
            sizes[p] = 0
    total = sum(sizes.values())
    dropped = 0
    for p in files:
        if total <= max_bytes:
            break
        try:
            os.unlink(p)
        except OSError:
            pass
        total -= sizes[p]
        dropped += 1
    return dropped


def _post(url: str, data: bytes, timeout_s: float,
          headers: Optional[dict[str, str]] = None) -> None:
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        r.read()


def ship_spool(
    spool_dir: str,
    url: str,
    deadline_s: float = 5.0,
    timeout_s: float = 3.0,
    retry: Optional[RetryPolicy] = None,
) -> int:
    """Ship every spooled payload to `url` + /telemetry/push, oldest
    first, with retry/backoff inside one wall-clock `deadline_s` budget
    for the whole pass. Shipped files are unlinked; files that could
    not be shipped stay spooled for the next pass (or for the
    supervisor's orphan sweep). Returns files shipped."""
    url = (url or "").rstrip("/")
    if not url or not spool_dir:
        return 0
    # PIO_PUSH_URL is documented as the receiver's BASE url, but a full
    # endpoint url must not double the route
    endpoint = url if url.endswith(PUSH_ROUTE) else url + PUSH_ROUTE
    retry = retry or RetryPolicy(max_attempts=4, base_delay=0.05)
    deadline = time.monotonic() + max(0.1, float(deadline_s))
    secret = push_knob("PIO_PUSH_TOKEN")
    shipped = 0
    for path in _spool_files(spool_dir):
        try:
            with open(path, "rb") as f:
                data = f.read()
            # never retry a file that does not parse; and the orphan sweep
            # ships the spools of many instances, so the token comes from
            # each file's own label
            parsed = json.loads(data)
        except (OSError, ValueError):
            try:
                os.unlink(path)
            except OSError:
                pass
            continue
        headers = None
        if secret and isinstance(parsed, dict):
            headers = {TOKEN_HEADER: issue_push_token(
                str(parsed.get("instance") or "") or "(unknown)", secret
            )}
        if time.monotonic() >= deadline:
            break
        try:
            retry.call(
                lambda _a: _post(endpoint, data, timeout_s, headers),
                retry_on=(OSError, urllib.error.URLError),
                deadline=deadline,
            )
        except Exception as e:
            log.debug("telemetry ship of %s to %s failed: %s",
                      path, endpoint, e)
            break  # keep this and newer files spooled; order preserved
        try:
            os.unlink(path)
        except OSError:
            pass
        shipped += 1
    return shipped


class TelemetryShipper:
    """Spool-then-ship telemetry out of an ephemeral process.

    ``start()`` runs the spool+ship loop on a background thread (named
    ``telemetry-shipper``; ``stop()`` joins it and flushes one final
    snapshot — the atexit/finally path). A process that never reaches
    ``stop()`` (kill -9, OOM) still leaves its periodic spool files for
    :func:`ship_spool` from the supervisor."""

    thread_name = "telemetry-shipper"

    def __init__(
        self,
        spool_dir: str,
        url: str = "",
        instance: Optional[str] = None,
        job_id: Optional[str] = None,
        interval_s: Optional[float] = None,
        deadline_s: Optional[float] = None,
        timeout_s: float = 3.0,
        spool_max_bytes: Optional[int] = None,
        registries: Optional[list] = None,
        recorder: Optional[_spans.SpanRecorder] = None,
    ):
        if not spool_dir:
            raise ValueError("TelemetryShipper needs a spool directory")
        self.spool_dir = spool_dir
        self.url = (url or "").rstrip("/")
        self.instance = instance or (
            f"{socket.gethostname()}:{os.getpid()}"
        )
        self.job_id = job_id
        self.interval_s = max(0.05, float(
            interval_s if interval_s is not None
            else push_knob("PIO_PUSH_INTERVAL_S")
        ))
        self.deadline_s = float(
            deadline_s if deadline_s is not None
            else push_knob("PIO_PUSH_DEADLINE_S")
        )
        self.timeout_s = float(timeout_s)
        self.spool_max_bytes = int(
            spool_max_bytes if spool_max_bytes is not None
            else push_knob("PIO_PUSH_SPOOL_MAX_BYTES")
        )
        self.registries = list(registries or [])
        self.recorder = recorder
        self.spooled = 0
        self.shipped = 0
        self._span_cursor = 0.0
        self._seq = 0
        self._flush_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_env(
        cls,
        instance: Optional[str] = None,
        job_id: Optional[str] = None,
        registries: Optional[list] = None,
    ) -> Optional["TelemetryShipper"]:
        """Build from PIO_PUSH_* knobs; None when pushing is not
        configured (no URL and no spool) — the caller just skips it."""
        url = push_knob("PIO_PUSH_URL")
        spool = push_knob("PIO_PUSH_SPOOL")
        if not url and not spool:
            return None
        if not spool:
            import tempfile

            spool = os.path.join(
                tempfile.gettempdir(), f"pio-push-{os.getpid()}"
            )
        return cls(
            spool, url=url, instance=instance, job_id=job_id,
            registries=registries,
        )

    # -- one pass ----------------------------------------------------------
    def spool_once(self, now: Optional[float] = None) -> Optional[str]:
        """Snapshot → durable spool file (never raises; None on error)."""
        now = time.time() if now is None else now
        try:
            payload = build_payload(
                self.instance, job_id=self.job_id,
                registries=self.registries, recorder=self.recorder,
                span_since=self._span_cursor, now=now,
            )
            # one interval of span overlap; the collector's span_id
            # dedup makes the overlap free and clock skew harmless
            self._span_cursor = max(0.0, now - self.interval_s)
            self._seq += 1
            path = spool_payload(self.spool_dir, payload, self._seq)
            self.spooled += 1
            trim_spool(self.spool_dir, self.spool_max_bytes)
            return path
        except Exception:
            log.debug("telemetry spool failed", exc_info=True)
            return None

    def ship(self, deadline_s: Optional[float] = None) -> int:
        n = ship_spool(
            self.spool_dir, self.url,
            deadline_s if deadline_s is not None else self.deadline_s,
            self.timeout_s,
        )
        self.shipped += n
        return n

    def flush(self) -> int:
        """Spool a final snapshot and ship everything pending — the
        clean-exit path (atexit / the owner's finally). Reentrant and
        safe to call multiple times."""
        with self._flush_lock:
            self.spool_once()
            return self.ship()

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
        """Join the loop and run the final flush. Idempotent."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.deadline_s + 10)
            self._thread = None
        self.flush()

    def _loop(self) -> None:
        while True:
            try:
                with self._flush_lock:
                    self.spool_once()
                    self.ship()
            except Exception:
                log.debug("telemetry ship pass failed", exc_info=True)
            if self._stop.wait(self.interval_s):
                return


# -- the ingest side ---------------------------------------------------------


# per-instance span token buckets: instance → (tokens, last_refill_ts)
_span_buckets: dict[str, tuple[float, float]] = {}  # under _span_lock
_span_lock = threading.Lock()
_dropped_family = None  # made on first use


def _dropped_counter():
    global _dropped_family
    if _dropped_family is None:
        from predictionio_tpu_torch.obs.registry import get_default_registry

        _dropped_family = get_default_registry().counter(
            "telemetry_push_dropped_total",
            "Pushed telemetry discarded at ingest, by kind",
            ("kind",),  # the ingest's literal drop kinds
        )
    return _dropped_family


def _admit_spans(instance: str, n: int, now: float) -> int:
    """Token-bucket admission for pushed spans: how many of `n` this
    instance may ingest right now (PIO_PUSH_SPAN_RATE refill/s, burst
    PIO_PUSH_SPAN_BURST). Rate <= 0 disables the limiter."""
    rate = push_knob("PIO_PUSH_SPAN_RATE")
    if rate <= 0 or n <= 0:
        return n
    burst = max(1.0, push_knob("PIO_PUSH_SPAN_BURST"))
    with _span_lock:
        tokens, last = _span_buckets.get(instance, (burst, now))
        tokens = min(burst, tokens + max(0.0, now - last) * rate)
        allowed = int(min(float(n), tokens))
        _span_buckets[instance] = (tokens - allowed, now)
        if len(_span_buckets) > 4096:  # shed: idle instances refill anyway
            _span_buckets.pop(next(iter(_span_buckets)))
    return allowed


def ingest(payload: Any, monitor: Any = None,
           now: Optional[float] = None,
           token: Optional[str] = None) -> dict:
    """Land one pushed payload in the process monitor: series into the
    TSDB (tagged instance/job_id, at their *sampled* timestamps), spans
    into the TraceCollector, devprof report + freshness bookkeeping
    onto the Monitor. Raises :class:`PushError` on malformed input
    (the HTTP handler maps it to 400) and :class:`PushAuthError` when
    PIO_PUSH_TOKEN is set on this receiver and `token` is not the
    HMAC for the payload's `instance` (→ 403)."""
    from predictionio_tpu_torch.obs.monitor import get_monitor

    if not isinstance(payload, dict):
        raise PushError("push payload must be a JSON object")
    if payload.get("v") != PAYLOAD_VERSION:
        raise PushError(
            f"unknown push payload version {payload.get('v')!r}"
        )
    series = payload.get("series") or []
    spans = payload.get("spans") or []
    if not isinstance(series, list) or not isinstance(spans, list):
        raise PushError("'series' and 'spans' must be arrays")
    monitor = monitor if monitor is not None else get_monitor()
    now = time.time() if now is None else now
    instance = str(payload.get("instance") or "") or "(unknown)"
    secret = push_knob("PIO_PUSH_TOKEN")
    if secret and not verify_push_token(instance, token, secret):
        raise PushAuthError(
            f"push token missing or not valid for instance "
            f"{instance!r}"
        )
    job_id = payload.get("job_id")
    extra: dict[str, str] = {"instance": instance}
    if job_id:
        extra["job_id"] = str(job_id)
    try:
        sampled_at = float(payload.get("sampled_at") or now)
    except (TypeError, ValueError):
        sampled_at = now
    # a skewed producer clock must not write points from the future
    sampled_at = min(sampled_at, now + 1.0)
    written = 0
    for row in series:
        if not isinstance(row, dict):
            continue
        name = row.get("name")
        if not name:
            continue
        try:
            value = float(row.get("value", 0.0))
        except (TypeError, ValueError):
            continue
        labels = {**(row.get("labels") or {}), **extra}
        if monitor.tsdb.add(
            str(name), labels, value,
            str(row.get("kind") or "gauge"), sampled_at,
        ):
            written += 1
    ingested = 0
    dropped_spans = 0
    collector = monitor.collector
    if collector is not None and spans:
        allowed = _admit_spans(instance, len(spans), now)
        dropped_spans = len(spans) - allowed
        if dropped_spans:
            _dropped_counter().inc(dropped_spans, kind="span")
        if allowed:
            ingested = collector.ingest_spans(spans[:allowed], now)
    devprof = payload.get("devprof")
    monitor.note_push(
        instance,
        sampled_at,
        devprof if isinstance(devprof, dict) else None,
        now=now,
    )
    return {
        "ok": True,
        "instance": instance,
        "series_written": written,
        "spans_ingested": ingested,
        "spans_dropped": dropped_spans,
    }
