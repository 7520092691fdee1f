"""Environment knobs the port reads.

The port's own copy of the readers of the JAX package's ``utils/env.py``
that it needs: the dense-ALS gate (``PIO_DENSE_ALS`` and
``PIO_DENSE_ALS_BYTES``), the storage base directory
(``PIO_FS_BASEDIR``), the online consumer's knobs (``ONLINE_KEYS``), the
canary rollout's verdict knobs (``ROLLOUT_KEYS``), fault injection
(``FAULT_KEYS``), the observability knobs (``PIO_DEVPROF``, the peak
overrides, the trace sampling) and the monitoring plane's
(``MONITOR_KEYS``, read through ``monitor_knob``; the durable tier's
``DURABLE_TSDB_KEYS``, read through ``durable_knob``; push telemetry's
``PUSH_KEYS``, read through ``push_knob``), and the fleet evaluation's
and the fleet
members' (``EVAL_KEYS`` and ``FLEET_KEYS``, read through
``eval_knob``), and the storage outage path's (``STORAGE_KEYS``: the
Event Server's write-ahead spill directory and the remote client's
retry and breaker knobs, read through ``storage_knob``; a remote
source's own settings and their defaults in ``REMOTE_SOURCE_KEYS``),
and the replicated event store's (``REPL_KEYS``, read through
``repl_knob``), and multi-tenant serving's (``TENANT_KEYS``, read
through ``tenant_knob``).
A missing or empty value gives the caller's default; a malformed number
gives the default with a warning, as in the JAX package. Every reader
takes an optional `env` mapping to read instead of the process
environment.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Optional

log = logging.getLogger(__name__)

# the online fold-in consumer's knobs and their defaults (the JAX
# package's registry entries)
ONLINE_KEYS = {
    # seconds between consumer ticks
    "PIO_ONLINE_TICK_S": 0.5,
    # score drift above which fold-in pauses
    "PIO_ONLINE_DRIFT_THRESHOLD": 1.0,
    # seconds a drift-paused consumer waits after a retrain before it
    # re-probes drift and resumes; 0 resumes on the retrain itself
    "PIO_ONLINE_DRIFT_COOLDOWN_S": 0.0,
}

# the canary rollout's verdict knobs and their defaults (the JAX
# package's registry entries; deploy/rollout.py reads them)
ROLLOUT_KEYS = {
    # sticky fraction of traffic routed to a canary candidate
    "PIO_ROLLOUT_FRACTION": 0.1,
    # sliding stats window (s) the rollout verdict compares over
    "PIO_ROLLOUT_WINDOW_S": 30.0,
    # seconds between rollout verdict ticks
    "PIO_ROLLOUT_INTERVAL_S": 1.0,
    # candidate samples required before the verdict engages
    "PIO_ROLLOUT_MIN_REQUESTS": 20,
    # candidate-minus-live error-rate delta that forces rollback
    "PIO_ROLLOUT_MAX_ERROR_DELTA": 0.05,
    # candidate/live p99 latency ratio that forces rollback
    "PIO_ROLLOUT_MAX_P99_RATIO": 3.0,
    # healthy bake time (s) before a canary auto-promotes
    "PIO_ROLLOUT_BAKE_S": 60.0,
    # shadow mode: mirror live traffic to the candidate and compare
    "PIO_ROLLOUT_SHADOW": False,
    # minimum shadow result-agreement fraction (rollback below)
    "PIO_ROLLOUT_MIN_AGREEMENT": 0.9,
}

# fault injection (resilience/faults.py) and its defaults
FAULT_KEYS = {
    # deterministic fault specs: point[@scope]:mode:prob[:param][,...]
    "PIO_FAULTS": "",
    # seed pinning every fault point's RNG across processes
    "PIO_FAULTS_SEED": None,
    # set 1 to enable the guarded POST /debug/faults admin endpoint
    "PIO_FAULTS_ADMIN": "",
}

# the monitoring plane (obs/monitor/) and its defaults
MONITOR_KEYS = {
    # in-process monitoring plane; 0 disables sampler, TSDB and SLO engine
    "PIO_TSDB": True,
    # ring-buffer points retained per TSDB series
    "PIO_TSDB_POINTS": 720,
    # TSDB series-cardinality cap (adds beyond are dropped and counted)
    "PIO_TSDB_MAX_SERIES": 4096,
    # seconds between metrics-sampler snapshots into the TSDB
    "PIO_TSDB_INTERVAL_S": 5.0,
    # seconds between SLO burn-rate evaluation passes
    "PIO_SLO_INTERVAL_S": 15.0,
    # SLO specs: a JSON array of spec objects, or @/path/to/slos.json
    "PIO_SLOS": "",
    # comma-separated name=url /metrics scrape targets of the fleet
    # scraper (dashboard, console monitor)
    "PIO_MONITOR_TARGETS": "",
    # seconds between fleet-scraper /metrics polls
    "PIO_SCRAPE_INTERVAL_S": 10.0,
    # cap (s) on the fleet scraper's backoff for a down target
    "PIO_SCRAPE_BACKOFF_MAX_S": 60.0,
    # recording rules: a JSON array of rule objects, or @/path/to/rules
    "PIO_RECORDING_RULES": "",
    # path persisting the TSDB rings across restarts (empty: off)
    "PIO_TSDB_SNAPSHOT": "",
    # seconds between TSDB snapshot writes
    "PIO_TSDB_SNAPSHOT_INTERVAL_S": 60.0,
    # URL POSTed one JSON alert per alert transition
    "PIO_ALERT_WEBHOOK": "",
    # command run per alert transition (JSON on stdin and $PIO_ALERT_JSON)
    "PIO_ALERT_EXEC": "",
    # set by the exec alert sink for its child: the alert payload
    "PIO_ALERT_JSON": "",
    # fleet trace collector on a process that scrapes targets; 0 disables it
    "PIO_TRACE_COLLECT": True,
    # seconds between trace-collector /debug/traces polls
    "PIO_TRACE_COLLECT_INTERVAL_S": 2.0,
    # seconds an orphan span fragment is held for a late root
    "PIO_TRACE_COLLECT_HOLD_S": 15.0,
    # assembled cross-process traces the collector retains
    "PIO_TRACE_COLLECT_MAX": 256,
    # slowest exemplars retained per histogram family
    "PIO_TRACE_EXEMPLARS": 4,
}

# the durable TSDB tier (obs/monitor/durable.py, compact.py) and its
# defaults (the JAX package's registry entries)
DURABLE_TSDB_KEYS = {
    # directory of the durable tier (WAL, sealed blocks, 5m/1h tiers);
    # empty keeps history in memory only (~ expanded)
    "PIO_TSDB_DIR": "",
    # seconds between WAL flush and fsync passes
    "PIO_TSDB_FLUSH_S": 2.0,
    # points in the active WAL segment that seal it into a block
    "PIO_TSDB_SEAL_POINTS": 50000,
    # age (s) of a non-empty active WAL segment that seals it
    "PIO_TSDB_SEAL_AGE_S": 300.0,
    # seconds between compactor passes (downsampling and retention)
    "PIO_TSDB_COMPACT_S": 30.0,
    # flushed WAL points between replay checkpoints (0: none)
    "PIO_TSDB_CKPT_POINTS": 50000,
    # retention (s) of the raw, 5-minute and 1-hour tiers
    "PIO_TSDB_RETENTION_RAW": 6 * 3600.0,
    "PIO_TSDB_RETENTION_5M": 3 * 86400.0,
    "PIO_TSDB_RETENTION_1H": 14 * 86400.0,
}

# push telemetry (obs/monitor/push.py) and its defaults (the JAX
# package's registry entries)
PUSH_KEYS = {
    # base URL of a push ingest (POST /telemetry/push); empty: no shipping
    "PIO_PUSH_URL": "",
    # the shipper's fsync'd spool directory (~ expanded); the train
    # scheduler gives each child <log_dir>/<job>.spool
    "PIO_PUSH_SPOOL": "",
    # set 1 to enable the guarded POST /telemetry/push on a server
    "PIO_PUSH_INGEST": False,
    # seconds between the shipper's spool and ship passes
    "PIO_PUSH_INTERVAL_S": 10.0,
    # wall-clock budget (s) of one ship pass's retries
    "PIO_PUSH_DEADLINE_S": 5.0,
    # bound of the spool directory's size; the oldest files drop first
    "PIO_PUSH_SPOOL_MAX_BYTES": 8 * 1024 * 1024,
    # shared secret: a shipper sends X-PIO-Push-Token =
    # HMAC-SHA256(secret, instance); empty: no auth
    "PIO_PUSH_TOKEN": "",
    # pushed spans admitted per instance (spans/s token bucket; <= 0: all)
    "PIO_PUSH_SPAN_RATE": 50.0,
    # burst capacity (spans) of that bucket
    "PIO_PUSH_SPAN_BURST": 200.0,
}


# the fleet evaluation and the tuning loop (evalfleet/) and their defaults
EVAL_KEYS = {
    # eval-driver poll cadence (s): partial-result folds and re-dispatch
    "PIO_EVAL_POLL_S": 0.5,
    # wall-clock timeout (s) of one eval shard job
    "PIO_EVAL_SHARD_TIMEOUT_S": 600.0,
    # the queue's retry budget of an eval shard job (infra failures)
    "PIO_EVAL_MAX_ATTEMPTS": 3,
    # extra driver re-submissions of an exhausted shard before the run fails
    "PIO_EVAL_REDISPATCH": 2,
    # terminal eval runs (with their results) the eval GC keeps
    "PIO_EVAL_RETENTION": 20,
    # 0 disables the canary's offline prior from the eval records
    "PIO_TUNE_PRIOR": True,
    # bake multiplier when the candidate's linked offline score is worse
    # than live's (<= 1 disables)
    "PIO_TUNE_STRICT_BAKE": 2.0,
}

# a fleet member's knobs (fleet/coordinator.py) and their defaults; the
# multi-host keys (PIO_FLEET_COORDINATOR, _NUM_PROCESSES, _PROCESS_ID)
# belong to the distributed wiring, which is not ported
FLEET_KEYS = {
    # operator-pinned CAS claim settle window (s); empty: adapt from the
    # storage's measured write-visibility skew when a member starts
    "PIO_CAS_SETTLE_S": "",
    # floor and ceiling (s) of the adaptive settle window
    "PIO_CAS_SETTLE_MIN_S": 0.02,
    "PIO_CAS_SETTLE_MAX_S": 2.0,
    # the /metrics URL a worker advertises on its record (fleet status
    # scrapes its device gauges)
    "PIO_WORKER_METRICS_URL": "",
}


# the storage outage path and its defaults (the JAX package's registry
# entries): the remote client's retry and breaker (a source's
# RETRY_ATTEMPTS, RETRY_BASE_DELAY, BREAKER_THRESHOLD and
# BREAKER_COOLDOWN settings override them) and the Event Server's spill
STORAGE_KEYS = {
    # storage RPC attempts in all
    "PIO_STORAGE_RETRY_ATTEMPTS": 3,
    # base delay (s) of the storage RPC's exponential backoff
    "PIO_STORAGE_RETRY_BASE_DELAY": 0.05,
    # storage failures in a row before a breaker opens
    "PIO_BREAKER_THRESHOLD": 5,
    # seconds an open breaker waits before its recovery probe
    "PIO_BREAKER_COOLDOWN": 10.0,
    # the Event Server's write-ahead spill directory (~ expanded)
    "PIO_WAL_DIR": "~/.predictionio_tpu/event-wal",
}

# a remote source's settings, PIO_STORAGE_SOURCES_<NAME>_<KEY>, and their
# defaults (data/storage/remote.py)
REMOTE_SOURCE_KEYS = {
    "HOST": "127.0.0.1",
    "PORT": "7077",
    # the daemon's shared secret, sent as X-PIO-Storage-Key (none: no auth)
    "AUTH_KEY": "",
    # seconds a pooled data connection waits on the daemon
    "TIMEOUT": "30",
}


# the replicated event store and its defaults (the JAX package's registry
# entries; data/storage/replication.py)
REPL_KEYS = {
    # comma-separated host:port follower storage daemons the primary's
    # shipper streams segments and the WAL tail to (empty: no replication)
    "PIO_REPL_FOLLOWERS": "",
    # followers that must apply a frame before an insert acks (0: the
    # shipping is asynchronous only)
    "PIO_REPL_MIN_ACKS": 0,
    # seconds between the shipper's background passes
    "PIO_REPL_SHIP_INTERVAL_S": 0.25,
    # live-tail rows a catch-up frame at most
    "PIO_REPL_WAL_BATCH": 512,
    # the lag budget (revisions) of the replication_lag SLO preset
    "PIO_REPL_MAX_LAG_REVISIONS": 1000,
    # the epoch a primary daemon stamps into its frames at boot (a
    # promoted follower's comes from the election's generation)
    "PIO_REPL_EPOCH": 1,
}


# multi-tenant serving (tenancy/) and its defaults (the JAX package's
# registry entries)
TENANT_KEYS = {
    # resident model-cache entries a query server (LRU beyond)
    "PIO_TENANT_CACHE_SIZE": 4,
    # model-cache budget in measured device bytes (0: by entry count)
    "PIO_TENANT_CACHE_HBM_BYTES": 0.0,
    # seconds the admission path's tenant records are cached
    "PIO_TENANT_REFRESH_S": 5.0,
    # seconds between the mux's background syncs (records, rollouts,
    # prefetch)
    "PIO_TENANT_SYNC_S": 10.0,
    # distinct tenant label values before metrics fold into "(other)"
    "PIO_TENANT_METRIC_MAX": 50,
    # set 1 to derive per-tenant availability and latency SLO presets
    # from the tenant records (a presence gate)
    "PIO_TENANT_SLO_PRESETS": "",
}


def tenant_knob(name: str, env: Optional[Mapping[str, str]] = None):
    """A multi-tenant serving knob read with its declared default, typed
    as the default is (``PIO_TENANT_SLO_PRESETS`` a presence gate, as
    ``env_flag`` reads it)."""
    if name == "PIO_TENANT_SLO_PRESETS":
        return env_flag(name, env)
    return _typed(name, TENANT_KEYS[name], env)


def repl_knob(name: str, env: Optional[Mapping[str, str]] = None):
    """A replication knob read with its declared default, typed as the
    default is."""
    return _typed(name, REPL_KEYS[name], env)


def storage_knob(name: str, env: Optional[Mapping[str, str]] = None):
    """A storage-outage knob read with its declared default, typed as the
    default is (``PIO_WAL_DIR`` with ~ expanded)."""
    if name == "PIO_WAL_DIR":
        return env_path(name, STORAGE_KEYS[name], env)
    return _typed(name, STORAGE_KEYS[name], env)


def _typed(name: str, default, env: Optional[Mapping[str, str]]):
    if isinstance(default, bool):
        return env_bool(name, default, env)
    if isinstance(default, int):
        return env_int(name, default, env)
    if isinstance(default, float):
        return env_float(name, default, env)
    return env_str(name, default, env)


def monitor_knob(name: str, env: Optional[Mapping[str, str]] = None):
    """A monitoring-plane knob read with its declared default, typed as
    the default is (bool, int, float or str)."""
    return _typed(name, MONITOR_KEYS[name], env)


def durable_knob(name: str, env: Optional[Mapping[str, str]] = None):
    """A durable-tier knob read with its declared default, typed as the
    default is (``PIO_TSDB_DIR`` with ~ expanded)."""
    if name == "PIO_TSDB_DIR":
        return env_path(name, DURABLE_TSDB_KEYS[name], env)
    return _typed(name, DURABLE_TSDB_KEYS[name], env)


def push_knob(name: str, env: Optional[Mapping[str, str]] = None):
    """A push-telemetry knob read with its declared default, typed as the
    default is (``PIO_PUSH_SPOOL`` with ~ expanded; ``PIO_PUSH_INGEST`` a
    presence gate, as ``env_flag`` reads it)."""
    if name == "PIO_PUSH_SPOOL":
        return env_path(name, PUSH_KEYS[name], env)
    if name == "PIO_PUSH_INGEST":
        return env_flag(name, env)
    return _typed(name, PUSH_KEYS[name], env)


def eval_knob(name: str, env: Optional[Mapping[str, str]] = None):
    """A fleet-evaluation or fleet-member knob read with its declared
    default, typed as the default is."""
    return _typed(name, {**EVAL_KEYS, **FLEET_KEYS}[name], env)


def _get(name: str, env: Optional[Mapping[str, str]]) -> Optional[str]:
    """The value as set, or None when missing or empty."""
    raw = (os.environ if env is None else env).get(name)
    return raw if raw else None


def env_raw(name: str, env: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """The raw value, or None when missing or empty: for grammars with a
    parser of their own (the fault specs)."""
    return _get(name, env)


def env_str(name: str, default: str = "",
            env: Optional[Mapping[str, str]] = None) -> str:
    return _get(name, env) or default


def env_path(name: str, default: str = "",
             env: Optional[Mapping[str, str]] = None) -> str:
    """Like env_str, with ~ expanded in the value and the default."""
    return os.path.expanduser(env_str(name, default, env))


def env_int(name: str, default: int,
            env: Optional[Mapping[str, str]] = None) -> int:
    raw = _get(name, env)
    if not raw:
        return default
    try:
        return int(float(raw))
    except (ValueError, OverflowError):  # OverflowError: "inf"
        log.warning("ignoring malformed %s=%r", name, raw)
        return default


def env_float(name: str, default: float,
              env: Optional[Mapping[str, str]] = None) -> float:
    raw = _get(name, env)
    if not raw:
        return float(default)
    try:
        return float(raw)
    except ValueError:
        log.warning("ignoring malformed %s=%r", name, raw)
        return float(default)


_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def env_bool(name: str, default: bool,
             env: Optional[Mapping[str, str]] = None) -> bool:
    """1/true/yes/on or 0/false/no/off; missing, empty or malformed: the
    default (malformed with a warning)."""
    raw = (_get(name, env) or "").strip().lower()
    if not raw:
        return default
    if raw in _TRUTHY:
        return True
    if raw in _FALSY:
        return False
    log.warning("ignoring malformed %s=%r", name, raw)
    return default


def env_flag(name: str, env: Optional[Mapping[str, str]] = None) -> bool:
    """A presence gate: set to anything but ''/0/false/no/off."""
    raw = _get(name, env)
    return raw is not None and raw.strip().lower() not in _FALSY


def env_opt_float(name: str):
    """A float, or None when missing, empty or malformed (the peak
    overrides' semantics)."""
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        log.warning("ignoring malformed %s=%r", name, raw)
        return None
