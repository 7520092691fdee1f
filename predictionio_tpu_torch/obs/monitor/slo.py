"""SLO burn-rate alerting over the in-process TSDB.

Counterpart of the JAX package's ``obs/monitor/slo.py``, the port's own
copy: the same specs, validations, burn rates and state machine.
Declarative SLO specs (availability and latency objectives per route)
are evaluated as multi-window burn-rate rules (a fast window catches
cliffs, a slow window suppresses blips; an alert needs both over the
threshold), driving a pending → firing → resolved machine surfaced at
``GET /alerts`` and as an ``alerts_firing{slo}`` gauge.

Spec fields (JSON; `PIO_SLOS` holds a JSON array or ``@/path.json``):

  name          unique id (becomes the metric label: keep it small)
  kind          "availability" | "latency" | "up" | "expr"
  objective     e.g. 0.99 (error budget = 1 - objective)
  server        metrics `server` label (default "query")
  route         metric route label (default "/queries.json")
  tenant        scope to one tenant's series instead of the route
  instance      kind "up" only: the scrape target to watch
  threshold_ms  latency only: the good-request bound (default 250)
  window_s      slow window (default 3600)
  fast_window_s fast window (default 300)
  burn_threshold  both windows must burn >= this (default 14.4, the
                  page-worthy rate; 1.0 is exactly eating the budget)
  for_s         seconds a breach must persist in `pending` before
                `firing` (default 0: fires on the second breached pass)
  resolve_s     seconds of clean passes a firing alert needs before
                `resolved` (default 0: the next clean pass resolves)
  min_samples   requests the fast window must hold before the rule is
                judged at all: an idle route neither divides by zero nor
                flaps its alert
  extra_pairs   more (fast, slow) window pairs judged beside the primary
                one: a list of {"fast_window_s", "window_s",
                "burn_threshold"} objects; a breach on any pair (both of
                its windows over its threshold) trips the alert. Long
                windows read through to the durable tier when
                PIO_TSDB_DIR is set, so a restarted process still alerts
                on the burn before its restart
  aggregate     fleet scope: judge the scraper's `instance`-tagged series
                instead of this process's own. "sum" pools bad/total
                across every instance; "mean" averages each instance's
                error fraction. Kind "up" with an aggregate watches every
                scrape target, so `instance` becomes optional
  expr          kind "expr": the error fraction is this series
                expression, evaluated per window with $window replaced

Error-rate sources (counter series the sampler records):

  availability  http_requests_total{server,path,status}: 5xx / all;
                with `tenant`: tenant_requests_total{tenant,outcome}
  latency       http_request_seconds_bucket{server,path,le}: the
                fraction of requests over `threshold_ms`; with `tenant`:
                tenant_serve_seconds_bucket{tenant,le}
  up            1 - mean(up{instance}): a dead scrape target burns its
                availability budget directly

``replication_slo_presets`` gives the replicated event store's lag
objective; ``tenant_slo_presets`` an availability and a latency
objective a tenant (the mux installs them with PIO_TENANT_SLO_PRESETS).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

from predictionio_tpu_torch.obs.monitor.tsdb import TSDB
from predictionio_tpu_torch.obs.registry import MetricsRegistry
from predictionio_tpu_torch.utils.env import monitor_knob

log = logging.getLogger(__name__)

KINDS = ("availability", "latency", "up", "expr")

# alert states
INACTIVE = "inactive"
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"


@dataclass(frozen=True)
class SLOSpec:
    name: str
    kind: str = "availability"
    objective: float = 0.99
    server: str = "query"
    route: str = "/queries.json"
    tenant: Optional[str] = None
    instance: Optional[str] = None
    threshold_ms: float = 250.0
    window_s: float = 3600.0
    fast_window_s: float = 300.0
    burn_threshold: float = 14.4
    for_s: float = 0.0
    resolve_s: float = 0.0
    min_samples: int = 1
    aggregate: Optional[str] = None
    # kind "expr": the error fraction is this series-algebra
    # expression (obs.monitor.expr), evaluated per window with $window
    # substituted (e.g. "sum(increase(errs[$window])) /
    # sum(increase(reqs[$window]))"). min_samples does not apply — an
    # expression with no data holds state exactly like no-traffic.
    expr: Optional[str] = None
    # multi-window ladder: extra (fast_s, slow_s, threshold)
    # triples judged alongside the primary pair; canonicalized by
    # __post_init__ from dicts/sequences
    extra_pairs: tuple = ()

    def __post_init__(self):
        if self.extra_pairs:
            norm = []
            for p in self.extra_pairs:
                if isinstance(p, dict):
                    unknown = set(p) - {
                        "fast_window_s", "window_s", "burn_threshold"
                    }
                    if unknown:
                        raise ValueError(
                            f"SLO {self.name!r}: extra_pairs entry has "
                            f"unknown field(s): {', '.join(sorted(unknown))}"
                        )
                    fast = float(p.get("fast_window_s", 0.0))
                    slow = float(p.get("window_s", 0.0))
                    thr = float(p.get("burn_threshold", 1.0))
                else:
                    seq = tuple(p)
                    if len(seq) != 3:
                        raise ValueError(
                            f"SLO {self.name!r}: extra_pairs entries are "
                            "(fast_window_s, window_s, burn_threshold)"
                        )
                    fast, slow, thr = (float(x) for x in seq)
                if fast <= 0 or slow <= 0 or thr <= 0:
                    raise ValueError(
                        f"SLO {self.name!r}: extra pair windows and "
                        "threshold must be > 0"
                    )
                if fast > slow:
                    raise ValueError(
                        f"SLO {self.name!r}: extra pair fast window must "
                        "not exceed its slow window"
                    )
                norm.append((fast, slow, thr))
            object.__setattr__(self, "extra_pairs", tuple(norm))
        if not self.name:
            raise ValueError("SLO spec needs a name")
        if self.kind not in KINDS:
            raise ValueError(
                f"SLO {self.name!r}: unknown kind {self.kind!r} "
                f"(known: {', '.join(KINDS)})"
            )
        if self.kind == "expr":
            if not self.expr:
                raise ValueError(
                    f"SLO {self.name!r}: kind 'expr' needs an 'expr'"
                )
            # parse eagerly (with a dummy window) so a typo fails at
            # spec-load time, not silently on every evaluation
            from predictionio_tpu_torch.obs.monitor.expr import parse

            parse(self.expr.replace("$window", "300s"))
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), got "
                f"{self.objective}"
            )
        if self.fast_window_s <= 0 or self.window_s <= 0:
            raise ValueError(f"SLO {self.name!r}: windows must be > 0")
        if self.fast_window_s > self.window_s:
            raise ValueError(
                f"SLO {self.name!r}: fast window must not exceed the "
                "slow window"
            )
        if self.aggregate not in (None, "sum", "mean"):
            raise ValueError(
                f"SLO {self.name!r}: aggregate must be 'sum' or 'mean', "
                f"got {self.aggregate!r}"
            )
        if self.kind == "up" and not self.instance and not self.aggregate:
            raise ValueError(
                f"SLO {self.name!r}: kind 'up' needs an 'instance' "
                "(or an 'aggregate' to watch every scrape target)"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    @property
    def burn_pairs(self) -> tuple[tuple[float, float, float], ...]:
        """Every (fast_s, slow_s, threshold) pair, primary first."""
        return (
            (self.fast_window_s, self.window_s, self.burn_threshold),
        ) + self.extra_pairs

    @classmethod
    def from_dict(cls, d: dict) -> "SLOSpec":
        known = {
            k: d[k] for k in (
                "name", "kind", "objective", "server", "route", "tenant",
                "instance", "threshold_ms", "window_s", "fast_window_s",
                "burn_threshold", "for_s", "resolve_s", "min_samples",
                "aggregate", "expr", "extra_pairs",
            ) if k in d
        }
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError(
                f"SLO spec has unknown field(s): {', '.join(sorted(unknown))}"
            )
        return cls(**known)

    def to_dict(self) -> dict[str, Any]:
        out = {
            "name": self.name, "kind": self.kind,
            "objective": self.objective, "window_s": self.window_s,
            "fast_window_s": self.fast_window_s,
            "burn_threshold": self.burn_threshold,
            "for_s": self.for_s, "resolve_s": self.resolve_s,
            "min_samples": self.min_samples,
        }
        if self.kind == "up":
            if self.instance:
                out["instance"] = self.instance
        elif self.kind == "expr":
            out["expr"] = self.expr
        else:
            out["server"] = self.server
            if self.tenant:
                out["tenant"] = self.tenant
            else:
                out["route"] = self.route
        if self.kind == "latency":
            out["threshold_ms"] = self.threshold_ms
        if self.aggregate:
            out["aggregate"] = self.aggregate
        if self.extra_pairs:
            out["extra_pairs"] = [
                {"fast_window_s": f, "window_s": w, "burn_threshold": t}
                for f, w, t in self.extra_pairs
            ]
        return out


def tenant_slo_presets(tenant_ids) -> list[SLOSpec]:
    """Per-tenant SLO presets derived from the tenant records: a 99 %
    availability objective and a 95 % sub-500 ms latency objective a
    tenant, judged only once the tenant shows traffic (min_samples
    keeps quiet tenants out)."""
    specs: list[SLOSpec] = []
    for tid in sorted(set(tenant_ids)):
        specs.append(SLOSpec(name=f"tenant:{tid}:availability", kind="availability",
                             objective=0.99, tenant=str(tid), min_samples=10))
        specs.append(SLOSpec(name=f"tenant:{tid}:latency", kind="latency",
                             objective=0.95, tenant=str(tid), threshold_ms=500.0,
                             min_samples=10))
    return specs


def replication_slo_presets(max_lag_revisions: Optional[int] = None) -> list[SLOSpec]:
    """The replication-lag preset: an expression objective on the
    ``replication_lag_revisions`` gauge the replicas keep per namespace.
    Its error fraction is the window's p99 lag over the
    ``PIO_REPL_MAX_LAG_REVISIONS`` budget, so at objective 0.5 and burn
    threshold 2.0 the alert fires when sustained lag reaches the budget
    (fraction >= 1.0 is burn >= 2.0 x the 0.5 budget) on both windows."""
    if max_lag_revisions is None:
        from predictionio_tpu_torch.utils.env import repl_knob

        max_lag_revisions = repl_knob("PIO_REPL_MAX_LAG_REVISIONS")
    budget = max(1, int(max_lag_revisions))
    return [SLOSpec(
        name="replication:lag", kind="expr", objective=0.5, burn_threshold=2.0,
        expr=("max(quantile_over_time(0.99, "
              f"replication_lag_revisions[$window])) / {budget}"),
    )]


def load_slos(text: Optional[str] = None) -> list[SLOSpec]:
    """Parse `PIO_SLOS` (or an explicit string): a JSON array of spec
    objects, or ``@/path/to/slos.json``. Malformed input logs and
    yields [] — a typo'd spec must not take a server down."""
    raw = text if text is not None else monitor_knob("PIO_SLOS")
    raw = (raw or "").strip()
    if not raw:
        return []
    try:
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        data = json.loads(raw)
        if isinstance(data, dict):
            data = [data]
        return [SLOSpec.from_dict(d) for d in data]
    except (OSError, ValueError, TypeError) as e:
        log.warning("ignoring malformed PIO_SLOS (%s)", e)
        return []


# -- error-rate math ---------------------------------------------------------
#
# Module-level so the engine's per-evaluation path and the sampler-tick
# recording pass (record_slo_ratios) share ONE implementation of the
# raw-window math — two copies would drift on exactly the edge cases
# (counter resets, window baselines, min_samples) that matter.


def _availability_source(spec: SLOSpec):
    """(series name, label match, is_bad predicate) for one spec."""
    if spec.tenant:
        def is_bad(lbls: dict) -> bool:
            return lbls.get("outcome") == "error"

        return "tenant_requests_total", {"tenant": spec.tenant}, is_bad

    def is_bad(lbls: dict) -> bool:
        try:
            return int(lbls.get("status", "0")) >= 500
        except ValueError:
            return False

    return (
        "http_requests_total",
        {"server": spec.server, "path": spec.route},
        is_bad,
    )


def _pool_latency_fraction(
    tsdb: TSDB, buckets: list, counts: list, threshold_s: float,
    window_s: float, now: float,
) -> tuple[Optional[float], float]:
    """(bad fraction, total) over one pool of bucket/count series; the
    smallest le ≥ threshold is the good-bucket (PromQL's conservative
    rounding). None fraction = no traffic or no usable bucket."""
    total = sum(tsdb.series_increase(s, window_s, now) for s in counts)
    if total <= 0:
        return None, 0.0
    best_le: Optional[float] = None
    by_le: dict[float, list] = {}
    for s in buckets:
        le_s = s.labels_dict().get("le", "")
        try:
            le = float("inf") if le_s == "+Inf" else float(le_s)
        except ValueError:
            continue
        by_le.setdefault(le, []).append(s)
        if le >= threshold_s and (best_le is None or le < best_le):
            best_le = le
    if best_le is None:
        return None, total
    good = sum(
        tsdb.series_increase(s, window_s, now) for s in by_le[best_le]
    )
    return max(0.0, 1.0 - good / total), total


def error_fraction(
    tsdb: TSDB, spec: SLOSpec, window_s: float, now: float
) -> tuple[Optional[float], float]:
    """(bad/total over the window, total). total < min_samples →
    (None, total): not enough traffic to judge — callers hold state
    instead of flapping (and never divide by zero).

    With `spec.aggregate` set, only series carrying an `instance`
    label (the fleet scraper's stamp) are judged: "sum" pools
    bad/total across the fleet, "mean" averages the per-instance
    fractions (zero-traffic instances are skipped)."""
    floor = max(1, spec.min_samples)
    if spec.kind == "expr":
        from predictionio_tpu_torch.obs.monitor import expr as _expr

        text = (spec.expr or "").replace("$window", f"{window_s:g}s")
        try:
            val = _expr.evaluate(
                tsdb, text, now, default_window_s=window_s
            )
        except _expr.ExprError:
            return None, 0.0
        if val is None:
            return None, 0.0
        if isinstance(val, list):
            if not val:
                return None, 0.0
            # a vector result averages across label sets — the scalar
            # shape burn_rate needs; write the expression with sum()/
            # ratios if a different pooling is wanted
            val = sum(v for _l, v in val) / len(val)
        # it IS an error fraction by contract: clamp to the unit range
        # so a mis-scaled expression can't produce a negative budget
        frac = min(max(float(val), 0.0), 1.0)
        return frac, float(floor)
    if spec.kind == "up":
        match = {"instance": spec.instance} if spec.instance else None
        if spec.aggregate == "mean":
            per: dict[str, list[float]] = {}
            for s in tsdb.matching("up", match):
                inst = s.labels_dict().get("instance")
                if inst is None:
                    continue
                per.setdefault(inst, []).extend(
                    v for _t, v in tsdb.points(s, window_s, now)
                )
            n = float(sum(len(p) for p in per.values()))
            fracs = [
                1.0 - sum(p) / len(p) for p in per.values() if p
            ]
            if n < floor or not fracs:
                return None, n
            return sum(fracs) / len(fracs), n
        pts: list[float] = []
        for s in tsdb.matching("up", match):
            if spec.aggregate and "instance" not in s.labels_dict():
                continue
            pts.extend(v for _t, v in tsdb.points(s, window_s, now))
        if len(pts) < floor:
            return None, float(len(pts))
        return 1.0 - sum(pts) / len(pts), float(len(pts))
    if spec.kind == "availability":
        name, match, is_bad = _availability_source(spec)
        series = tsdb.matching(name, match)
        if spec.aggregate:
            series = [
                s for s in series if "instance" in s.labels_dict()
            ]
        if spec.aggregate == "mean":
            per_tot: dict[str, float] = {}
            per_bad: dict[str, float] = {}
            for s in series:
                inst = s.labels_dict()["instance"]
                inc = tsdb.series_increase(s, window_s, now)
                per_tot[inst] = per_tot.get(inst, 0.0) + inc
                if is_bad(s.labels_dict()):
                    per_bad[inst] = per_bad.get(inst, 0.0) + inc
            grand = sum(per_tot.values())
            fracs = [
                per_bad.get(i, 0.0) / t
                for i, t in per_tot.items() if t > 0
            ]
            if grand < floor or not fracs:
                return None, grand
            return sum(fracs) / len(fracs), grand
        total = bad = 0.0
        for s in series:
            inc = tsdb.series_increase(s, window_s, now)
            total += inc
            if is_bad(s.labels_dict()):
                bad += inc
        if total < floor:
            return None, total
        return bad / total, total
    # latency: good = requests under the threshold, via the sampled
    # cumulative bucket counters
    if spec.tenant:
        name = "tenant_serve_seconds_bucket"
        cname = "tenant_serve_seconds_count"
        match = {"tenant": spec.tenant}
    else:
        name = "http_request_seconds_bucket"
        cname = "http_request_seconds_count"
        match = {"server": spec.server, "path": spec.route}
    threshold_s = spec.threshold_ms / 1000.0
    buckets = tsdb.matching(name, match)
    counts = tsdb.matching(cname, match)
    if spec.aggregate:
        buckets = [s for s in buckets if "instance" in s.labels_dict()]
        counts = [s for s in counts if "instance" in s.labels_dict()]
    if spec.aggregate == "mean":
        pools: dict[str, tuple[list, list]] = {}
        for s in counts:
            pools.setdefault(
                s.labels_dict()["instance"], ([], [])
            )[1].append(s)
        for s in buckets:
            inst = s.labels_dict()["instance"]
            if inst in pools:
                pools[inst][0].append(s)
        grand = 0.0
        fracs = []
        for bs, cs in pools.values():
            frac, total = _pool_latency_fraction(
                tsdb, bs, cs, threshold_s, window_s, now
            )
            grand += total
            if frac is not None:
                fracs.append(frac)
        if grand < floor or not fracs:
            return None, grand
        return sum(fracs) / len(fracs), grand
    frac, total = _pool_latency_fraction(
        tsdb, buckets, counts, threshold_s, window_s, now
    )
    if total < floor or frac is None:
        return None, total
    return frac, total


# -- recorded ratios -----------------------------------------------------------
#
# record_slo_ratios runs on the SAMPLER tick (MetricsSampler's
# post_sample hook — no extra thread): one raw-window rescan per tick
# stores `slo_error_ratio{slo,window}` and `slo_samples{slo,window}` as
# first-class series, and the engine's burn_rate then reads one
# precomputed point per window instead of rescanning every raw bucket
# ring on every evaluation. Freshness-gated: a recorded point older
# than `recorded_max_age_s` (sampler wedged, rules disabled) silently
# falls back to the raw math, so recording can never make alerting
# WRONG — only cheap.

RECORDED_RATIO = "slo_error_ratio"
RECORDED_SAMPLES = "slo_samples"


def record_slo_ratios(
    tsdb: TSDB, specs: list[SLOSpec], now: Optional[float] = None
) -> int:
    """One recording pass over every spec × (fast, slow) window.
    Samples are always written (the engine needs 'quiet' to be
    observable); the ratio only when there is enough traffic to judge.
    Returns points written."""
    now = time.time() if now is None else now
    written = 0
    for spec in specs:
        for tag, window_s in (
            ("fast", spec.fast_window_s), ("slow", spec.window_s)
        ):
            try:
                frac, samples = error_fraction(tsdb, spec, window_s, now)
            except Exception:
                log.debug(
                    "recording ratios for %s failed", spec.name,
                    exc_info=True,
                )
                continue
            labels = {"slo": spec.name, "window": tag}
            if tsdb.add(RECORDED_SAMPLES, labels, samples, "gauge", now):
                written += 1
            if frac is not None and tsdb.add(
                RECORDED_RATIO, labels, frac, "gauge", now
            ):
                written += 1
    return written


@dataclass
class AlertStatus:
    """One spec's live alert state + the numbers behind it."""

    spec: SLOSpec
    state: str = INACTIVE
    since: Optional[float] = None        # entered current state at
    pending_since: Optional[float] = None
    clear_since: Optional[float] = None  # firing + non-breach streak start
    fast_burn: Optional[float] = None
    slow_burn: Optional[float] = None
    fast_samples: float = 0.0
    last_eval: Optional[float] = None
    transitions: int = 0
    # per-pair burn numbers of the last evaluation:
    # primary-first, same order as spec.burn_pairs
    pair_burns: list = field(default_factory=list)
    # (t, fast_burn) ring for the dashboard sparkline
    history: deque = field(default_factory=lambda: deque(maxlen=120))

    def to_dict(self) -> dict[str, Any]:
        return {
            "slo": self.spec.name,
            "state": self.state,
            "since": self.since,
            "fast_burn": (
                None if self.fast_burn is None
                else round(self.fast_burn, 4)
            ),
            "slow_burn": (
                None if self.slow_burn is None
                else round(self.slow_burn, 4)
            ),
            "fast_samples": self.fast_samples,
            "burn_threshold": self.spec.burn_threshold,
            "error_budget": round(self.spec.budget, 6),
            "transitions": self.transitions,
            "last_eval": self.last_eval,
            "pairs": [dict(p) for p in self.pair_burns],
            "spec": self.spec.to_dict(),
        }


class SLOEngine:
    """Evaluates every spec against the TSDB on a fixed interval and
    drives the alert state machines. `stop()` joins the thread."""

    thread_name = "slo-engine"

    def __init__(self, tsdb: TSDB, specs: list[SLOSpec],
                 interval_s: float = 15.0,
                 registry: Optional[MetricsRegistry] = None,
                 on_transition=None):
        self.tsdb = tsdb
        self.interval_s = max(0.05, float(interval_s))
        # recorded-ratio fast path: points no older than this
        # are trusted over a raw rescan; 0 disables the fast path (the
        # Monitor sets ~2 sampler intervals when recording is on)
        self.recorded_max_age_s = 0.0
        # notification hook: called OUTSIDE the lock
        # as (status_dict, old_state, new_state) on every state change —
        # the Monitor wires the webhook/exec sinks through it
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._status: dict[str, AlertStatus] = {
            s.name: AlertStatus(spec=s) for s in specs
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from predictionio_tpu_torch.obs.registry import get_default_registry

            registry = get_default_registry()
        self._firing_gauge = registry.gauge(
            "alerts_firing", "SLO alerts currently firing (1) or not (0)",
            ("slo",),  # label-bound: operator-declared SLO spec names
        )

    # -- spec management ---------------------------------------------------
    def set_specs(self, specs: list[SLOSpec]) -> None:
        with self._lock:
            old = self._status
            self._status = {
                s.name: old.get(s.name) or AlertStatus(spec=s)
                for s in specs
            }
            for name, st in self._status.items():
                st.spec = next(s for s in specs if s.name == name)

    def specs(self) -> list[SLOSpec]:
        with self._lock:
            return [st.spec for st in self._status.values()]

    # -- error-rate math ---------------------------------------------------
    def _error_fraction(
        self, spec: SLOSpec, window_s: float, now: float
    ) -> tuple[Optional[float], float]:
        """Raw-window math — see the module-level error_fraction (one
        shared implementation with the recording pass)."""
        return error_fraction(self.tsdb, spec, window_s, now)

    def _recorded_fraction(
        self, spec: SLOSpec, window_tag: str, now: float
    ) -> Optional[tuple[Optional[float], float]]:
        """The recorded fast path: read the precomputed
        slo_error_ratio/slo_samples point for this spec+window. None =
        MISS (no point, or staler than recorded_max_age_s) — caller
        falls back to the raw rescan. (None, samples) = a fresh HIT
        that says 'not enough traffic to judge' — the hold-state
        signal, same as the raw path's."""
        if self.recorded_max_age_s <= 0:
            return None
        match = {"slo": spec.name, "window": window_tag}
        spt = self.tsdb.latest_point(RECORDED_SAMPLES, match)
        if spt is None or now - spt[0] > self.recorded_max_age_s:
            return None
        samples = spt[1]
        if samples < max(1, spec.min_samples):
            return None, samples
        rpt = self.tsdb.latest_point(RECORDED_RATIO, match)
        if rpt is None or now - rpt[0] > self.recorded_max_age_s:
            return None
        return rpt[1], samples

    def burn_rate(
        self, spec: SLOSpec, window_s: float, now: Optional[float] = None
    ) -> tuple[Optional[float], float]:
        """(error_fraction / budget, samples) over the window — via the
        recorded fast path when a fresh precomputed ratio exists,
        rescanning the raw rings otherwise."""
        now = time.time() if now is None else now
        tag = (
            "fast" if window_s == spec.fast_window_s
            else "slow" if window_s == spec.window_s
            else None
        )
        frac: Optional[float] = None
        samples = 0.0
        hit = (
            self._recorded_fraction(spec, tag, now)
            if tag is not None else None
        )
        if hit is not None:
            frac, samples = hit
        else:
            frac, samples = self._error_fraction(spec, window_s, now)
        if frac is None:
            return None, samples
        return frac / spec.budget, samples

    # -- evaluation --------------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            statuses = list(self._status.values())
        transitions: list[tuple[dict, str, str]] = []
        for st in statuses:
            spec = st.spec
            # every pair evaluates (primary first); a breach on ANY
            # complete pair trips
            pair_rows: list[dict] = []
            for fast_w, slow_w, thr in spec.burn_pairs:
                p_fast, p_n = self.burn_rate(spec, fast_w, now)
                p_slow, _ = self.burn_rate(spec, slow_w, now)
                pair_rows.append({
                    "fast_window_s": fast_w, "window_s": slow_w,
                    "burn_threshold": thr,
                    "fast_burn": (
                        None if p_fast is None else round(p_fast, 4)
                    ),
                    "slow_burn": (
                        None if p_slow is None else round(p_slow, 4)
                    ),
                    "fast_samples": p_n,
                })
            fast = pair_rows[0]["fast_burn"]
            slow = pair_rows[0]["slow_burn"]
            fast_n = pair_rows[0]["fast_samples"]
            complete = [
                r for r in pair_rows
                if r["fast_burn"] is not None
                and r["slow_burn"] is not None
            ]
            with self._lock:
                st.fast_burn, st.slow_burn = fast, slow
                st.fast_samples = fast_n
                st.pair_burns = pair_rows
                st.last_eval = now
                st.history.append(
                    (round(now, 3), None if fast is None else fast)
                )
                if not complete:
                    # zero-traffic window: hold state (no flap), freeze
                    # the resolve streak — silence is not health
                    st.clear_since = None if st.state == FIRING else (
                        st.clear_since
                    )
                    self._export_locked(st)
                    continue
                breach = any(
                    r["fast_burn"] >= r["burn_threshold"]
                    and r["slow_burn"] >= r["burn_threshold"]
                    for r in complete
                )
                old_state = st.state
                self._step_locked(st, breach, now)
                self._export_locked(st)
                if st.state != old_state:
                    transitions.append((st.to_dict(), old_state, st.state))
        # notification sinks fire OUTSIDE the lock: a slow webhook must
        # not serialize alert evaluation
        if self.on_transition is not None:
            for payload, old_state, new_state in transitions:
                try:
                    self.on_transition(payload, old_state, new_state)
                except Exception:
                    log.exception("alert transition hook failed")

    def _step_locked(self, st: AlertStatus, breach: bool,
                     now: float) -> None:
        spec = st.spec

        def goto(state: str) -> None:
            st.state = state
            st.since = now
            st.transitions += 1

        if st.state in (INACTIVE, RESOLVED):
            if breach:
                st.pending_since = now
                goto(PENDING)
        elif st.state == PENDING:
            if not breach:
                goto(INACTIVE)
                st.pending_since = None
            elif now - (st.pending_since or now) >= spec.for_s:
                goto(FIRING)
                st.clear_since = None
        elif st.state == FIRING:
            if breach:
                st.clear_since = None
            else:
                if st.clear_since is None:
                    st.clear_since = now
                if now - st.clear_since >= spec.resolve_s:
                    goto(RESOLVED)
                    st.clear_since = None

    def _export_locked(self, st: AlertStatus) -> None:
        try:
            self._firing_gauge.set(
                1.0 if st.state == FIRING else 0.0, slo=st.spec.name
            )
        except Exception:
            pass

    # -- reading -----------------------------------------------------------
    def status(self, name: str) -> Optional[AlertStatus]:
        with self._lock:
            return self._status.get(name)

    def payload(self) -> dict[str, Any]:
        """The `GET /alerts` body."""
        with self._lock:
            rows = [st.to_dict() for st in self._status.values()]
        return {
            "interval_s": self.interval_s,
            "slos": rows,
            "alerts": [
                r for r in rows if r["state"] != INACTIVE
            ],
            "firing": [r["slo"] for r in rows if r["state"] == FIRING],
        }

    def history(self, name: str) -> list[tuple[float, Optional[float]]]:
        with self._lock:
            st = self._status.get(name)
            return list(st.history) if st else []

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
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:
                log.exception("SLO evaluation pass failed; will retry")
