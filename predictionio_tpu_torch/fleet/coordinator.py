"""Training worker fleet: N cooperating schedulers over shared storage.

Counterpart of the JAX package's ``fleet/coordinator.py``, on one host.
A fleet member wraps a ``TrainScheduler`` with what N workers need:

- a **worker record**: each member keeps a heartbeating
  ``pio_fleet_worker`` record in the lifecycle records, so every member
  (and ``fleet status``) sees who is alive. The scheduler's
  ``peer_probe`` reads them: a claim waits out the settle window only
  while live peers could be bidding (``deploy/scheduler.py``);
- the **adaptive settle**: at start the member measures the record
  store's write-visibility latency and sets the claim settle window
  from it (``PIO_CAS_SETTLE_S`` pins it instead);
- **push telemetry**: with ``PIO_PUSH_URL`` or ``PIO_PUSH_SPOOL`` set,
  the member runs a ``TelemetryShipper`` (``obs/monitor/push.py``) as
  ``fleet-<worker id>``, since a monitor may not reach it to scrape.

There is no elected coordinator: the queue (compare-and-set claims,
fenced heartbeats, the stale steal) is the point of coordination. A
member may die at any time; its jobs go stale and the survivors steal
them.

Not ported, and refused when asked for: the multi-host wiring (the JAX
package's ``fleet/distributed.py``: a ``distributed`` config, or
``PIO_FLEET_COORDINATOR`` / ``PIO_FLEET_NUM_PROCESSES`` > 1 in the
environment).
"""

from __future__ import annotations

import logging
import os
import socket
import sys
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Optional

from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore
from predictionio_tpu_torch.deploy.scheduler import JobQueue, SchedulerConfig, TrainScheduler
from predictionio_tpu_torch.utils.env import env_int, env_str, eval_knob

log = logging.getLogger(__name__)

WORKER_ENTITY = "pio_fleet_worker"

# the multi-host settings of the JAX fleet member, refused here
MULTI_HOST_KEYS = ("PIO_FLEET_COORDINATOR", "PIO_FLEET_NUM_PROCESSES")


def _utcnow_iso() -> str:
    import datetime as _dt

    return _dt.datetime.now(_dt.timezone.utc).isoformat()


@dataclass
class WorkerInfo:
    """One fleet member's heartbeating presence record."""

    id: str
    host: str = ""
    pid: int = 0
    started_at: str = ""
    heartbeat_at: float = 0.0
    running_jobs: int = 0
    capacity: int = 1
    process_id: int = 0
    num_processes: int = 1
    devices: int = 0
    # the advertised /metrics URL (PIO_WORKER_METRICS_URL): `fleet
    # status` scrapes the worker's device gauges off it
    metrics_url: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id, "host": self.host, "pid": self.pid,
            "started_at": self.started_at,
            "heartbeat_at": self.heartbeat_at,
            "running_jobs": self.running_jobs, "capacity": self.capacity,
            "process_id": self.process_id,
            "num_processes": self.num_processes, "devices": self.devices,
            "metrics_url": self.metrics_url,
        }

    @staticmethod
    def from_dict(d: dict) -> "WorkerInfo":
        w = WorkerInfo(id=d.get("id", ""))
        for k in ("host", "pid", "started_at", "heartbeat_at", "running_jobs",
                  "capacity", "process_id", "num_processes", "devices",
                  "metrics_url"):
            if d.get(k) is not None:
                setattr(w, k, d[k])
        return w


@dataclass
class FleetConfig:
    """Fleet-member knobs on top of the scheduler's own config."""

    # worker-record heartbeat cadence and liveness horizon
    heartbeat_interval_s: float = 2.0
    worker_stale_after_s: float = 10.0
    # the JAX package's multi-host topology: not ported, refused when set
    distributed: Any = None
    # set the claim settle window from the storage's measured
    # write-visibility skew at start(); PIO_CAS_SETTLE_S pins it instead
    adaptive_settle: bool = True


# safety factor on the measured same-process visibility latency: the
# skew across workers (another host's clock and commit path) is what the
# settle window waits out, and a worker can probe only its own round trip
SETTLE_SKEW_FACTOR = 4.0


def measure_write_visibility_skew(storage: Storage, probes: int = 3,
                                  timeout_s: float = 2.0) -> float:
    """The worst append → visible latency of the record store, measured
    with throwaway probe records (purged after): the floor of the skew a
    claimant must wait out before it reads the bid order."""
    store = LifecycleRecordStore(storage)
    entity = f"probe-{uuid.uuid4().hex[:8]}"
    worst = 0.0
    try:
        for i in range(max(1, probes)):
            t0 = time.monotonic()
            store.append("pio_settle_probe", entity, {"i": i})
            while (len(store.events("pio_settle_probe", entity)) <= i
                   and time.monotonic() - t0 < timeout_s):
                time.sleep(0.001)
            worst = max(worst, time.monotonic() - t0)
    finally:
        try:
            store.purge("pio_settle_probe", entity)
        except Exception:  # noqa: BLE001 — a leftover probe is harmless
            log.debug("settle probe cleanup failed", exc_info=True)
    return worst


class WorkerRegistry:
    """Worker records and their liveness, on the shared record layer."""

    def __init__(self, storage: Storage):
        self._store = LifecycleRecordStore(storage)

    def upsert(self, info: WorkerInfo) -> None:
        self._store.append(WORKER_ENTITY, info.id, info.to_dict())

    def heartbeat(self, worker_id: str, prev_event_id: Optional[str],
                  running_jobs: int) -> str:
        """A new beat, then the previous one deleted (one live beat event
        a worker). The beat carries `id` too: a record a peer collected
        during a connectivity gap would otherwise come back without one,
        and an id-less phantom would count as everyone's live peer."""
        eid = self._store.append(WORKER_ENTITY, worker_id, {
            "id": worker_id, "heartbeat_at": time.time(),
            "running_jobs": running_jobs,
        })
        if prev_event_id:
            self._store.discard(prev_event_id)
        return eid

    def remove(self, worker_id: str) -> None:
        self._store.purge(WORKER_ENTITY, worker_id)

    def list(self) -> list[WorkerInfo]:
        return [WorkerInfo.from_dict(d)
                for d in self._store.fold(WORKER_ENTITY).values()]

    def live(self, stale_after_s: float = 10.0) -> list[WorkerInfo]:
        cutoff = time.time() - stale_after_s
        return [w for w in self.list() if w.heartbeat_at >= cutoff]

    def gc(self, stale_after_s: float = 60.0) -> list[str]:
        """Purge the records of workers dead for much longer than the
        liveness horizon (a crashed member cannot deregister itself)."""
        cutoff = time.time() - stale_after_s
        doomed = [w.id for w in self.list() if w.heartbeat_at < cutoff]
        for wid in doomed:
            self.remove(wid)
        return doomed


def refuse_unported(config: "FleetConfig") -> None:
    """Raise for the multi-host settings a JAX fleet member would act
    on: the port runs none of them, and never ignores them."""
    if config.distributed is not None:
        raise NotImplementedError(
            "a multi-host fleet (the distributed config) is not ported yet "
            "to the PyTorch port")
    if env_str("PIO_FLEET_COORDINATOR") or env_int("PIO_FLEET_NUM_PROCESSES", 1) > 1:
        raise NotImplementedError(
            f"a multi-host fleet ({', '.join(k for k in MULTI_HOST_KEYS if env_str(k))})"
            f" is not ported yet to the PyTorch port")


class FleetMember:
    """One worker of the fleet: a TrainScheduler, a heartbeating worker
    record, and the peer probe that arms the claim settle window only
    under real contention."""

    def __init__(self, storage: Storage,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 fleet_config: Optional[FleetConfig] = None):
        self.storage = storage
        self.config = fleet_config or FleetConfig()
        refuse_unported(self.config)
        self.scheduler = TrainScheduler(storage, scheduler_config or SchedulerConfig())
        self.scheduler.peer_probe = self.live_peer_count
        self.registry = WorkerRegistry(storage)
        self.worker_id = self.scheduler.worker_id
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_event: Optional[str] = None
        # liveness reads fold the worker records: cached for a heartbeat
        # period so that a claim does not pay one
        self._peer_cache: tuple[float, int] = (0.0, 0)
        self._peer_lock = threading.Lock()
        self._shipper = None  # push telemetry, armed in start()

    # -- liveness --------------------------------------------------------
    def live_peer_count(self) -> int:
        """Live workers other than this one (the scheduler's settle
        gate), cached for one heartbeat interval."""
        now = time.monotonic()
        with self._peer_lock:
            ts, n = self._peer_cache
            if now - ts < self.config.heartbeat_interval_s:
                return n
        try:
            n = len(self.peers())
        except Exception:  # noqa: BLE001 — storage hiccup: assume contention
            n = 1
        with self._peer_lock:
            self._peer_cache = (now, n)
        return n

    def peers(self) -> list[WorkerInfo]:
        return [w for w in self.registry.live(self.config.worker_stale_after_s)
                if w.id != self.worker_id]

    # -- lifecycle -------------------------------------------------------
    @staticmethod
    def _device_count() -> int:
        # torch only if the process already loaded it: a member must stay
        # importable and startable on a control host without torch
        torch = sys.modules.get("torch")
        if torch is None:
            return 0
        try:
            return int(torch.cuda.device_count())
        except Exception:  # noqa: BLE001 — no driver: no devices
            return 0

    def start(self) -> None:
        self.registry.upsert(WorkerInfo(
            id=self.worker_id, host=socket.gethostname(), pid=os.getpid(),
            started_at=_utcnow_iso(), heartbeat_at=time.time(),
            capacity=max(1, int(self.scheduler.config.max_concurrent)),
            devices=self._device_count(),
            metrics_url=eval_knob("PIO_WORKER_METRICS_URL").strip(),
        ))
        self._stop.clear()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name="fleet-worker-heartbeat", daemon=True)
        self._hb_thread.start()
        # push telemetry: a fleet worker may sit where the monitor cannot
        # scrape it, so it ships its series and spans out instead (none
        # unless PIO_PUSH_URL or PIO_PUSH_SPOOL is set)
        try:
            from predictionio_tpu_torch.obs.monitor.push import TelemetryShipper

            self._shipper = TelemetryShipper.from_env(instance=f"fleet-{self.worker_id}")
            if self._shipper is not None:
                self._shipper.start()
        except Exception:  # noqa: BLE001 — telemetry never blocks a start
            log.debug("telemetry shipper unavailable", exc_info=True)
        self._adapt_claim_settle()
        self.scheduler.resume_orphans()
        self.scheduler.start()

    def _adapt_claim_settle(self) -> None:
        """Set the claim settle window from the measured write-visibility
        skew (an eval fan-out multiplies concurrent claims, and a window
        tuned for a local sqlite file is wrong for a remote store). A
        pinned PIO_CAS_SETTLE_S wins; a failed probe keeps the configured
        window (adaptation never blocks a start)."""
        cfg = self.scheduler.config
        pinned = eval_knob("PIO_CAS_SETTLE_S").strip()
        if pinned:
            try:
                cfg.claim_settle_s = float(pinned)
                log.info("claim settle pinned: %.3fs (PIO_CAS_SETTLE_S)",
                         cfg.claim_settle_s)
            except ValueError:
                log.warning("PIO_CAS_SETTLE_S=%r is not a number; keeping %.3fs",
                            pinned, cfg.claim_settle_s)
            return
        if not self.config.adaptive_settle:
            return
        try:
            skew = measure_write_visibility_skew(self.storage)
        except Exception:  # noqa: BLE001 — keep the configured window
            log.debug("settle skew probe failed; keeping %.3fs",
                      cfg.claim_settle_s, exc_info=True)
            return
        lo = eval_knob("PIO_CAS_SETTLE_MIN_S")
        hi = eval_knob("PIO_CAS_SETTLE_MAX_S")
        settle = min(max(SETTLE_SKEW_FACTOR * skew, lo), max(lo, hi))
        log.info("claim settle adapted: measured visibility skew %.4fs -> "
                 "settle %.3fs (was %.3fs)", skew, settle, cfg.claim_settle_s)
        cfg.claim_settle_s = settle

    def stop(self, kill_child: bool = False) -> None:
        """Stop the scheduler and the heartbeat, then deregister.
        `kill_child=True` is a crash: the children die and the worker
        record is left to go stale, as a real death leaves it."""
        if self._shipper is not None:
            try:
                self._shipper.stop()  # joins, then the final flush
            except Exception:  # noqa: BLE001
                log.debug("telemetry shipper stop failed", exc_info=True)
            self._shipper = None
        self.scheduler.stop(kill_child=kill_child)
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join()
            self._hb_thread = None
        if kill_child:
            return
        try:
            self.registry.remove(self.worker_id)
        except Exception:  # noqa: BLE001 — the record goes stale instead
            log.debug("worker deregister failed (non-fatal)", exc_info=True)

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.config.heartbeat_interval_s):
            try:
                running = len(self.scheduler._running_ids)
                self._hb_event = self.registry.heartbeat(
                    self.worker_id, self._hb_event, running)
                self.registry.gc(stale_after_s=6 * self.config.worker_stale_after_s)
            except Exception:  # noqa: BLE001 — storage down: beat again
                log.warning("worker heartbeat failed (storage down?); continuing",
                            exc_info=True)


#: the device gauge families `fleet status` reads off each worker's
#: /metrics (obs/cudamon.py's; the JAX package reads its jax_* ones)
_DEVICE_FAMILIES = (
    "cuda_kernel_build_count",
    "cuda_kernel_build_seconds_total",
    "cuda_memory_allocated_bytes",
    "cuda_memory_reserved_bytes",
)


def worker_device_info(metrics_url: str,
                       timeout_s: float = 2.0) -> Optional[dict[str, float]]:
    """One worker's device gauges scraped off its advertised /metrics
    (torch.cuda's allocator and the kernel builds); None when it is
    unreachable or exports none."""
    import urllib.request

    from predictionio_tpu_torch.obs.monitor.scrape import parse_prometheus_text

    try:
        with urllib.request.urlopen(metrics_url, timeout=timeout_s) as r:
            body = r.read().decode(errors="replace")
    except Exception as e:  # noqa: BLE001 — an unreachable worker
        log.debug("worker metrics scrape %s failed: %s", metrics_url, e)
        return None
    out: dict[str, float] = {}
    for name, _labels, value in parse_prometheus_text(body):
        if name in _DEVICE_FAMILIES:
            out[name] = out.get(name, 0.0) + value
    return out or None


def fleet_status(storage: Storage, stale_after_s: float = 10.0,
                 probe_devices: bool = True) -> dict[str, Any]:
    """The operator's view of the fleet (the `fleet status` payload):
    live and stale workers and the queue. A live worker that advertises
    a metrics URL also gets its scraped `device_info`."""
    workers = WorkerRegistry(storage).list()
    queue = JobQueue(storage)
    jobs = queue.list()
    now = time.time()
    cutoff = now - stale_after_s
    by_status: dict[str, int] = {}
    for j in jobs:
        by_status[j.status] = by_status.get(j.status, 0) + 1

    def _row(w: WorkerInfo) -> dict[str, Any]:
        live = w.heartbeat_at >= cutoff
        row = dict(w.to_dict(), live=live,
                   heartbeat_age_s=round(max(0.0, now - w.heartbeat_at), 1))
        if probe_devices and live and w.metrics_url:
            info = worker_device_info(w.metrics_url)
            if info is not None:
                row["device_info"] = info
        return row

    return {
        "workers": [_row(w) for w in sorted(workers, key=lambda w: w.id)],
        "live_workers": sum(1 for w in workers if w.heartbeat_at >= cutoff),
        "jobs": by_status,
        "claimable": len(queue.claimable()),
        "running": [
            {"id": j.id, "worker_id": j.worker_id, "generation": j.generation,
             "heartbeat_age_s": round(max(0.0, now - j.heartbeat_at), 1)}
            for j in jobs if j.status == "running"
        ],
    }
