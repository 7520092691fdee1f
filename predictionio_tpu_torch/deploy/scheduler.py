"""The job queue and its worker: train jobs and eval shards.

Counterpart of the JAX package's ``deploy/scheduler.py``. A train is a
job in a queue kept in the lifecycle records (``registry.py``), so the
queue outlives any process and every worker over the same storage sees
it. ``TrainScheduler`` claims queued jobs and supervises each in a
subprocess (``python -m predictionio_tpu_torch.deploy.worker`` for a
train job, ``python -m predictionio_tpu_torch.evalfleet.worker`` for an
eval shard of the fleet evaluation):

- the child runs ``run_train`` on ``SchedulerConfig.device`` (None: the
  first CUDA device), so a crash in engine code cannot take the
  scheduler down; its output goes to a per-job log file;
- the parent heartbeats the job record while the child lives; a worker
  that died leaves a ``running`` job with a stale heartbeat, which the
  next ``resume_orphans`` re-queues;
- a wall-clock timeout kills a runaway train;
- the child's exit code says what failed: ``EXIT_TRAIN_FAILED`` (the
  train raised; retrying would repeat it) fails the job at once, any
  other non-zero code re-queues it with the ``retry_delay`` backoff
  until ``max_attempts``;
- a job with ``period_s`` enqueues its next run when it ends; a train
  job's next run carries the engine's parked tuning preset
  (``evalfleet/tuning.py apply_preset``), and a completed train whose
  variant names an ``evalRun`` stamps the lineage link of its model
  version onto that eval run.

Claims are compare-and-set. A claim appends a bid to the job's claim
record (``pio_job_claim``); the first bid for a generation in the
record's total order wins, and every queued↔running transition bumps
``generation``. An owner's heartbeats and its terminal writes are
fenced by its (claim token, generation), so two workers never supervise
one job, and a re-queue of a stale job is a bid like any other. A
worker with live fleet peers (``peer_probe``, wired by
``fleet/coordinator.py``) waits ``claim_settle_s`` before it resolves a
bid, so that concurrent bids are visible; a lone worker resolves at
once. Train jobs of one engine run one at a time across the fleet; eval
shards run side by side.

Record fields and their meanings are the JAX package's, so either
package's queue lists the other's jobs. This package's worker claims
only the jobs whose engine factory it can load: a job submitted with the
JAX package's factory stays queued for that package's worker.

Push telemetry: with ``PIO_PUSH_URL`` set (and no ``PIO_PUSH_SPOOL``
pinned by the operator), each child gets a spool directory of its own,
``<log_dir>/<job>.spool``, and the push secret ``PIO_PUSH_TOKEN``. What
a child killed before its exit flush left spooled is shipped from here:
after the child exits, and by ``ship_orphan_spools`` at each
``resume_orphans`` for the spools of children of a dead scheduler.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Optional

from predictionio_tpu_torch.controller.params import is_reference_module
from predictionio_tpu_torch.data.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore
from predictionio_tpu_torch.obs import get_default_registry
from predictionio_tpu_torch.utils.env import push_knob

log = logging.getLogger(__name__)

JOB_ENTITY = "pio_train_job"

# one claim record per job collects every worker's bids; the winner of
# a generation is its first bid in the record store's total order
CLAIM_ENTITY = "pio_job_claim"

JOB_STATUSES = ("queued", "running", "completed", "failed")

# the worker's exit codes: a train failure is deterministic (a retry
# would repeat it), anything else is infrastructure, worth a retry
EXIT_TRAIN_FAILED = 3
EXIT_INFRA_FAILED = 4

# job kind → the subprocess's module
WORKER_MODULES = {
    "train": "predictionio_tpu_torch.deploy.worker",
    "eval": "predictionio_tpu_torch.evalfleet.worker",
}


# the re-queue backoff after an infrastructure failure (the JAX
# package's ``resilience/retry.py`` policy as its scheduler sets it, the
# delay schedule only): attempt i (0-based) waits 1 s x 4**i, capped at
# 60 s, times a jitter factor uniform in [0.5, 1.5]
RETRY_BASE_DELAY_S = 1.0
RETRY_MULTIPLIER = 4.0
RETRY_MAX_DELAY_S = 60.0
RETRY_JITTER = 0.5

# a job submitted without timeout_s is killed after this long
DEFAULT_TIMEOUT_S = 3600.0

# completed and failed job records the scheduler's periodic sweep keeps
JOB_RETENTION = 200


def retry_delay(attempt: int) -> float:
    """Seconds before the re-queued job's next attempt (`attempt` is the
    0-based count of the attempts so far)."""
    d = min(RETRY_BASE_DELAY_S * RETRY_MULTIPLIER ** attempt, RETRY_MAX_DELAY_S)
    return d * (1.0 + RETRY_JITTER * (2.0 * random.random() - 1.0))


def storage_config_to_json(config: StorageConfig) -> dict:
    """A StorageConfig as JSON, so that the train subprocess opens the
    stores the scheduler uses."""
    return {
        "sources": {name: {"type": s.type, "settings": dict(s.settings)}
                    for name, s in config.sources.items()},
        "repositories": dict(config.repositories),
    }


def storage_config_from_json(obj: dict) -> StorageConfig:
    return StorageConfig(
        sources={name: SourceConfig(name, s["type"], dict(s.get("settings", {})))
                 for name, s in obj.get("sources", {}).items()},
        repositories=dict(obj.get("repositories", {})),
    )


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _now_iso() -> str:
    return _utcnow().isoformat()


_JOB_FIELDS = (
    "status", "created_at", "not_before", "started_at", "finished_at",
    "heartbeat_at", "attempt", "max_attempts", "timeout_s", "period_s",
    "last_error", "instance_id", "model_version", "log_path", "worker_id",
    "generation", "claim_token", "kind", "tenant",
)


@dataclass
class TrainJob:
    """One job record."""

    id: str
    variant: dict[str, Any]
    engine_id: str
    status: str = "queued"
    created_at: str = ""
    not_before: float = 0.0  # epoch seconds: the backoff or period gate
    started_at: Optional[str] = None
    finished_at: Optional[str] = None
    heartbeat_at: float = 0.0  # epoch seconds: the supervisor's liveness
    attempt: int = 0
    max_attempts: int = 3
    timeout_s: Optional[float] = None
    period_s: Optional[float] = None  # periodic retrain interval
    last_error: Optional[str] = None
    instance_id: Optional[str] = None
    model_version: Optional[str] = None
    log_path: Optional[str] = None
    worker_id: Optional[str] = None
    # the fenced claim: `generation` grows at every queued↔running
    # transition; `claim_token` names the owner of the current one
    generation: int = 0
    claim_token: Optional[str] = None
    kind: str = "train"
    tenant: Optional[str] = None

    def to_dict(self) -> dict[str, Any]:
        return {"id": self.id, "variant": self.variant,
                "engine_id": self.engine_id,
                **{k: getattr(self, k) for k in _JOB_FIELDS}}

    @staticmethod
    def from_dict(d: dict) -> "TrainJob":
        job = TrainJob(id=d["id"], variant=dict(d.get("variant") or {}),
                       engine_id=d.get("engine_id", ""))
        for k in _JOB_FIELDS:
            if d.get(k) is not None:
                setattr(job, k, d[k])
        return job


def _positive(name: str, val: Any) -> Optional[float]:
    """A submitted number, checked when it is submitted (a bad one stored
    raw would wedge the job when it is claimed)."""
    if val is None:
        return None
    try:
        out = float(val)
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be a number, got {val!r}")
    if out <= 0:
        raise ValueError(f"{name} must be positive, got {out}")
    return out


class JobQueue:
    """Job records in storage: the console, the scheduler and any other
    worker over the same stores share them."""

    def __init__(self, storage: Storage):
        self.storage = storage
        self._store = LifecycleRecordStore(storage)

    def submit(
        self,
        variant: dict,
        engine_id: Optional[str] = None,
        timeout_s: Optional[float] = None,
        period_s: Optional[float] = None,
        max_attempts: int = 3,
        not_before: float = 0.0,
        kind: str = "train",
        tenant: Optional[str] = None,
    ) -> TrainJob:
        for key in ("id", "engineFactory"):
            if key not in variant:
                raise ValueError(f"engine variant is missing {key!r}")
        if kind not in WORKER_MODULES:
            raise ValueError(f"unknown job kind {kind!r} (known: {sorted(WORKER_MODULES)})")
        job = TrainJob(
            id=f"job-{uuid.uuid4().hex[:12]}",
            variant=dict(variant),
            engine_id=engine_id or variant["id"],
            created_at=_now_iso(),
            not_before=not_before,
            timeout_s=_positive("timeout_s", timeout_s),
            period_s=_positive("period_s", period_s),
            max_attempts=max(1, int(max_attempts)),
            kind=kind,
            tenant=tenant,
        )
        self._store.append(JOB_ENTITY, job.id, job.to_dict())
        return job

    def update(self, job_id: str, **fields: Any) -> str:
        return self._store.append(JOB_ENTITY, job_id, fields)

    def heartbeat(self, job_id: str, prev_event_id: Optional[str]) -> str:
        """A new beat, then the previous one deleted: a long train leaves
        one heartbeat event in the job's fold."""
        eid = self.update(job_id, heartbeat_at=time.time())
        if prev_event_id:
            self._store.discard(prev_event_id)
        return eid

    def heartbeat_fenced(self, job_id: str, prev_event_id: Optional[str],
                         claim_token: str) -> tuple[Optional[str], bool]:
        """A heartbeat only while `claim_token` owns the job: returns
        (event id, owned). A job stolen off a stale heartbeat is not
        refreshed, and its old owner must kill its child."""
        job = self.get(job_id)
        if job is None or job.claim_token != claim_token:
            return None, False
        return self.heartbeat(job_id, prev_event_id), True

    # -- compare-and-set claims ------------------------------------------
    def _bids(self, job_id: str):
        for e in self._store.events(CLAIM_ENTITY, f"{job_id}#claim"):
            yield dict(e.properties)

    def claim_bid(self, job_id: str, generation: int) -> Optional[dict]:
        """The winning bid for `generation`: its first bid in the claim
        record's total order (None when nobody bid)."""
        for props in self._bids(job_id):
            if int(props.get("generation") or 0) == generation:
                return props
        return None

    def claim_winner(self, job_id: str, generation: int) -> Optional[str]:
        bid = self.claim_bid(job_id, generation)
        return bid.get("claim_token") if bid else None

    def highest_bid(self, job_id: str) -> tuple[int, Optional[dict]]:
        """(generation, winning bid) of the highest generation any bid
        names: an un-wedge bids past it."""
        best_gen, best = 0, None
        for props in self._bids(job_id):
            gen = int(props.get("generation") or 0)
            if gen > best_gen:
                best_gen, best = gen, props
        return best_gen, best

    def claim(
        self,
        job: TrainJob,
        worker_id: str,
        intent: str = "run",
        generation: Optional[int] = None,
        fields: Optional[dict] = None,
        settle_s: float = 0.0,
    ) -> Optional[str]:
        """Bid for the job's next transition (generation `job.generation`
        + 1, or `generation`) and resolve it: this worker's claim token
        when its bid is the first, else None; None too when the record
        has already moved past the generation (`job` was a stale read).
        `settle_s` > 0 waits out the storage's write-visibility skew
        before resolving (a fleet with live peers). The winner writes
        `fields` (its post-transition record) right after the check."""
        gen = generation if generation is not None else job.generation + 1
        token = uuid.uuid4().hex
        self._store.append(CLAIM_ENTITY, f"{job.id}#claim", {
            "job_id": job.id, "generation": gen, "claim_token": token,
            "worker_id": worker_id, "intent": intent, "bid_at": time.time(),
        })
        if settle_s > 0:
            time.sleep(settle_s)
        if self.claim_winner(job.id, gen) != token:
            return None
        cur = self.get(job.id)
        if cur is None or cur.generation >= gen:
            return None
        if fields is not None:
            # `fields` may set claim_token itself (a re-queue ends unowned)
            self.update(job.id, **{"generation": gen, "claim_token": token,
                                   **fields})
        return token

    def is_owner(self, job: TrainJob) -> bool:
        """Does the record still carry `job`'s claim token and generation
        (the fence before a terminal write)?"""
        cur = self.get(job.id)
        return (cur is not None and cur.claim_token == job.claim_token
                and cur.generation == job.generation)

    def get(self, job_id: str) -> Optional[TrainJob]:
        d = self._store.fold(JOB_ENTITY, job_id).get(job_id)
        return TrainJob.from_dict(d) if d else None

    def list(self, status: Optional[str] = None) -> list[TrainJob]:
        """Jobs, oldest first, of one status or all."""
        jobs = [TrainJob.from_dict(d)
                for d in self._store.fold(JOB_ENTITY).values()]
        if status is not None:
            jobs = [j for j in jobs if j.status == status]
        jobs.sort(key=lambda j: j.created_at)
        return jobs

    def purge(self, job_id: str) -> int:
        """Delete a job's record and its claim record."""
        return (self._store.purge(JOB_ENTITY, job_id)
                + self._store.purge(CLAIM_ENTITY, f"{job_id}#claim"))

    def gc(self, keep: int = 200) -> list[str]:
        """Purge the completed and failed jobs beyond the newest `keep`,
        then compact the rest; returns the purged ids."""
        if keep < 0:
            raise ValueError("keep must be >= 0")
        terminal = [j for j in self.list()
                    if j.status in ("completed", "failed")]
        doomed = terminal[:len(terminal) - keep] if keep else terminal
        for j in doomed:
            self.purge(j.id)
        self._store.compact_all(JOB_ENTITY)
        return [j.id for j in doomed]

    def claimable(self, now_epoch: Optional[float] = None) -> list[TrainJob]:
        now_epoch = time.time() if now_epoch is None else now_epoch
        return [j for j in self.list(status="queued")
                if j.not_before <= now_epoch]


@dataclass
class SchedulerConfig:
    poll_interval_s: float = 0.5
    heartbeat_interval_s: float = 1.0
    # train subprocesses at once; jobs of one engine still run one at a
    # time (two would race the newest-COMPLETED instance deploys read)
    max_concurrent: int = 1
    # a `running` job whose heartbeat is older than this is an orphan of
    # a dead worker, and is re-queued
    stale_after_s: float = 15.0
    # with live fleet peers, a bidder waits this long before it resolves
    # its claim, so that concurrent bids are visible and every worker
    # computes the same winner; it must exceed the storage's
    # write-visibility skew (fleet/coordinator.py adapts it at start)
    claim_settle_s: float = 0.25
    log_dir: Optional[str] = None
    # extra environment of the child (tests add PYTHONPATH)
    child_env: dict[str, str] = field(default_factory=dict)
    # the child's torch device, written into its spec ("device"); None
    # is the first CUDA device
    device: Optional[str] = None


class TrainScheduler:
    """Claims queued jobs and supervises their subprocesses."""

    def __init__(self, storage: Storage,
                 config: Optional[SchedulerConfig] = None):
        self.storage = storage
        self.config = config or SchedulerConfig()
        self.queue = JobQueue(storage)
        self.worker_id = f"worker-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        # the live-peer probe (fleet/coordinator.py wires it to the worker
        # records): > 0 live peers make claims wait out the settle window
        self.peer_probe: Optional[Any] = None
        self._stop = threading.Event()
        self._abandon = False  # a simulated crash: no bookkeeping
        self._thread: Optional[threading.Thread] = None
        self._children: dict[str, subprocess.Popen] = {}
        self._child_lock = threading.Lock()
        # one spool ship at a time: a dead child's residue ship and the
        # orphan sweep would otherwise post the same files twice
        self._spool_lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._claim_lock = threading.Lock()
        self._running_ids: set[str] = set()
        self._running_engines: set[str] = set()
        self._log_dir = self.config.log_dir or os.path.join(
            tempfile.gettempdir(), "pio_train_jobs")
        self._jobs_counter = get_default_registry().counter(
            "train_jobs_total", "scheduler job outcomes", ("outcome",))

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._abandon = False
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=max(1, int(self.config.max_concurrent)),
                thread_name_prefix="train-supervise")
        self._thread = threading.Thread(target=self._loop,
                                        name="train-scheduler", daemon=True)
        self._thread.start()

    def stop(self, kill_child: bool = False) -> None:
        """Stop polling. A plain stop waits until the trains in flight
        end and are recorded (each bounded by its timeout).
        `kill_child=True` kills every child and leaves its record as it
        is: a worker crash, whose jobs the next `resume_orphans`
        re-queues."""
        self._stop.set()
        if kill_child:
            self._abandon = True
            with self._child_lock:
                children = list(self._children.values())
            for child in children:
                if child.poll() is None:
                    child.kill()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _claim_settle(self) -> float:
        """The settle wait of a claim: paid only while live fleet peers
        could bid at the same time; a lone worker resolves at once."""
        try:
            peers = int(self.peer_probe()) if self.peer_probe else 0
        except Exception:  # noqa: BLE001 — a broken probe: assume peers
            peers = 1
        return self.config.claim_settle_s if peers > 0 else 0.0

    def _claimable(self) -> list[TrainJob]:
        """Queued jobs this worker can run: of a ported kind, and of an
        engine this package can load. A job whose engine factory names
        the JAX package stays queued for that package's worker (this
        package's child would refuse the factory and fail the job)."""
        return [j for j in self.queue.claimable() if j.kind in WORKER_MODULES
                and not is_reference_module(str(j.variant.get("engineFactory", "")))]

    # -- crash resume ----------------------------------------------------
    def resume_orphans(self) -> list[str]:
        """Re-queue `running` jobs whose heartbeat went stale (fail those
        on their last attempt), by the same compare-and-set as a claim,
        and un-wedge queued jobs whose next generation was won by a bid
        that never wrote its record. Returns the re-queued ids."""
        cutoff = time.time() - self.config.stale_after_s
        requeued = []
        for job in self.queue.list(status="running"):
            if job.heartbeat_at >= cutoff:
                continue
            if job.attempt >= job.max_attempts:
                token = self.queue.claim(
                    job, self.worker_id, intent="steal",
                    settle_s=self._claim_settle(), fields=dict(
                        status="failed", finished_at=_now_iso(),
                        claim_token=None, worker_id=None,
                        last_error="worker crashed mid-train; attempts "
                                   "exhausted"))
                if token is None:
                    continue  # another worker's steal won
                log.warning("job %s orphaned on final attempt %d/%d; "
                            "failing", job.id, job.attempt, job.max_attempts)
                self._jobs_counter.inc(outcome="failed_infra")
                self._schedule_next_period(job)
                continue
            token = self.queue.claim(
                job, self.worker_id, intent="steal",
                settle_s=self._claim_settle(), fields=dict(
                    status="queued", worker_id=None, claim_token=None,
                    last_error="worker crashed mid-train; re-queued"))
            if token is None:
                continue
            log.warning("job %s orphaned (heartbeat %.1fs stale); "
                        "re-queuing", job.id, time.time() - job.heartbeat_at)
            self._jobs_counter.inc(outcome="requeued_orphan")
            requeued.append(job.id)
        for job in self.queue.list(status="queued"):
            if self.queue.claim_bid(job.id, job.generation + 1) is None:
                continue  # no bid above the record: not wedged
            top_gen, top = self.queue.highest_bid(job.id)
            if top is None or top_gen <= job.generation:
                continue
            if time.time() - float(top.get("bid_at") or 0) < \
                    self.config.stale_after_s:
                continue  # a live claimant is mid-protocol
            token = self.queue.claim(
                job, self.worker_id, intent="unwedge", generation=top_gen + 1,
                settle_s=self._claim_settle(), fields=dict(
                    status="queued", worker_id=None, claim_token=None,
                    last_error="claim wedged by a dead bid; generation "
                               "bumped"))
            if token is not None:
                log.warning("job %s: dead claim bid at generation %d; "
                            "un-wedged", job.id, job.generation + 1)
                self._jobs_counter.inc(outcome="unwedged")
        # a child killed with SIGKILL never ran its exit flush: what it
        # spooled is still under log_dir, so ship it now
        try:
            self.ship_orphan_spools()
        except Exception:  # noqa: BLE001
            log.debug("orphan spool sweep failed", exc_info=True)
        return requeued

    # -- push-telemetry spools -------------------------------------------
    def _push_spool_dir(self, job_id: str, env: dict[str, str]) -> Optional[str]:
        """The child's own spool directory, or None when pushing is not
        configured. A PIO_PUSH_SPOOL the operator pinned is left alone (a
        shared spool: the children own it, the supervisor stays out)."""
        if not push_knob("PIO_PUSH_URL", env).strip():
            return None
        if push_knob("PIO_PUSH_SPOOL", env).strip():
            return None
        return os.path.join(self._log_dir, f"{job_id}.spool")

    def _ship_spool_residue(self, spool_dir: str, url: str) -> int:
        """Ship what is left in `spool_dir` and remove the directory once
        it is empty, one spool at a time. Never raises: an ingest that is
        down keeps the files for the next sweep."""
        from predictionio_tpu_torch.obs.monitor import push as _push

        if not url:
            return 0
        with self._spool_lock:
            try:
                shipped = _push.ship_spool(spool_dir, url)
            except Exception:  # noqa: BLE001
                log.debug("spool ship failed: %s", spool_dir, exc_info=True)
                return 0
            try:
                os.rmdir(spool_dir)  # succeeds only once drained
            except OSError:
                pass
        return shipped

    def ship_orphan_spools(self) -> int:
        """Ship every `<log_dir>/<job>.spool` a dead child left, skipping
        the jobs whose child still runs under this scheduler (a live child
        ships its own). Returns the payloads shipped."""
        env = dict(os.environ, **self.config.child_env)
        url = push_knob("PIO_PUSH_URL", env).strip()
        if not url:
            return 0
        try:
            entries = sorted(os.listdir(self._log_dir))
        except OSError:
            return 0
        shipped = 0
        for entry in entries:
            if not entry.endswith(".spool"):
                continue
            with self._child_lock:
                live = entry[:-len(".spool")] in self._children
            if live:
                continue
            shipped += self._ship_spool_residue(os.path.join(self._log_dir, entry), url)
        return shipped

    # -- main loop -------------------------------------------------------
    def _loop(self) -> None:
        last_resume = 0.0
        while not self._stop.is_set():
            if time.monotonic() - last_resume >= self.config.stale_after_s:
                last_resume = time.monotonic()
                try:
                    self.resume_orphans()
                    self.queue.gc(keep=JOB_RETENTION)
                except Exception:  # noqa: BLE001 — the loop goes on
                    log.exception("orphan resume/gc failed; continuing")
            try:
                ready = self._claimable()
            except Exception:  # noqa: BLE001 — storage down: poll again
                log.exception("job poll failed (storage down?); retrying")
                ready = []
            dispatched = False
            for job in ready:
                if self._stop.is_set():
                    break
                if self._dispatch(job):
                    dispatched = True
            if not dispatched:
                self._stop.wait(self.config.poll_interval_s)

    def _dispatch(self, job: TrainJob) -> bool:
        """Run `job` on the supervision pool if there is room and, for a
        train job, no job of its engine runs here (the shards of an eval
        run side by side)."""
        engine_key = job.engine_id if job.kind == "train" else None
        with self._claim_lock:
            if (len(self._running_ids) >= max(1, int(self.config.max_concurrent))
                    or job.id in self._running_ids
                    or engine_key in self._running_engines):
                return False
            self._running_ids.add(job.id)
            if engine_key is not None:
                self._running_engines.add(engine_key)

        def release() -> None:
            with self._claim_lock:
                self._running_ids.discard(job.id)
                self._running_engines.discard(engine_key)

        def run() -> None:
            try:
                self._run_job(job)
            except Exception:  # noqa: BLE001 — the stale heartbeat resumes it
                log.exception("job %s supervision failed", job.id)
            finally:
                release()

        try:
            self._pool.submit(run)
        except RuntimeError:  # the pool shut down (stop raced)
            release()
            return False
        return True

    def run_pending_once(self) -> int:
        """Run the jobs claimable now, one after another, in this thread
        (`jobs worker --once`). Returns how many."""
        self.resume_orphans()
        ready = self._claimable()
        for job in ready:
            self._run_job(job)
        return len(ready)

    # -- one job ---------------------------------------------------------
    def _rivals(self, job: TrainJob) -> list[TrainJob]:
        """Other running train jobs of a train job's engine, on any
        worker (an eval shard has none)."""
        if job.kind != "train":
            return []
        return [j for j in self.queue.list(status="running")
                if j.engine_id == job.engine_id and j.id != job.id
                and j.kind == "train"]

    def _run_job(self, job: TrainJob) -> None:
        # no bid while a job of the engine trains anywhere (bids cannot
        # be compacted); the check after the claim closes the race
        try:
            if self._rivals(job):
                return
        except Exception:  # noqa: BLE001 — the post-claim check guards
            pass
        os.makedirs(self._log_dir, mode=0o700, exist_ok=True)
        log_path = os.path.join(self._log_dir, f"{job.id}.log")
        token = self.queue.claim(
            job, self.worker_id, settle_s=self._claim_settle(),
            fields=dict(status="running", worker_id=self.worker_id,
                        started_at=_now_iso(), heartbeat_at=time.time(),
                        log_path=log_path, attempt=job.attempt + 1))
        if token is None:
            self._jobs_counter.inc(outcome="claim_lost")
            log.debug("job %s: claim lost to another worker", job.id)
            return
        job.claim_token = token
        job.generation += 1
        job.attempt += 1
        # across workers, the senior running job of an engine (earliest
        # started_at, then id) goes on; a junior yields to the queue
        # without spending its attempt. With live peers the check waits
        # out the settle window, so that concurrent claimants see each other
        settle = self._claim_settle() if job.kind == "train" else 0.0
        if settle:
            time.sleep(settle)
        try:
            rivals = self._rivals(job)
        except Exception:  # noqa: BLE001 — the in-process guard holds
            rivals = []
        if rivals:
            mine = self.queue.get(job.id)
            key = lambda j: (j.started_at or "", j.id)  # noqa: E731
            if mine is not None and min(rivals + [mine], key=key).id != job.id:
                self.queue.update(
                    job.id, status="queued", worker_id=None, claim_token=None,
                    generation=job.generation + 1, attempt=job.attempt - 1,
                    not_before=time.time() + self.config.poll_interval_s,
                    last_error=None)
                self._jobs_counter.inc(outcome="engine_yield")
                log.info("job %s: engine %s already training on another "
                         "worker; yielded", job.id, job.engine_id)
                return
        spec_path = os.path.join(self._log_dir, f"{job.id}.spec.json")
        result_path = os.path.join(self._log_dir, f"{job.id}.result.json")
        # the spec holds the storage settings verbatim (passwords too):
        # owner-only, deleted after the run
        fd = os.open(spec_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump({
                "job_id": job.id,
                "storage": storage_config_to_json(self.storage.config),
                "variant": job.variant,
                "engine_id": job.engine_id,
                "result_path": result_path,
                "device": self.config.device,
            }, f)
        try:
            self._supervise(job, spec_path, result_path, log_path)
        finally:
            for p in (spec_path, result_path):
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def _supervise(self, job: TrainJob, spec_path: str, result_path: str,
                   log_path: str) -> None:
        env = dict(os.environ, **self.config.child_env)
        # push telemetry: a spool of the child's own under log_dir (unless
        # the operator pinned one), so that what a child killed with
        # SIGKILL left unsent survives as files this supervisor ships
        spool_dir = self._push_spool_dir(job.id, env)
        if spool_dir is not None:
            env["PIO_PUSH_SPOOL"] = spool_dir
        # the push secret, from which the child's shipper derives the
        # token of its instance (HMAC(secret, instance))
        push_secret = push_knob("PIO_PUSH_TOKEN", env).strip()
        if push_secret:
            env["PIO_PUSH_TOKEN"] = push_secret
        timeout_s = job.timeout_s or DEFAULT_TIMEOUT_S
        deadline = time.monotonic() + timeout_s
        timed_out = False
        try:
            with open(log_path, "ab") as logf:
                logf.write(f"--- attempt {job.attempt} ({_now_iso()}) ---\n"
                           .encode())
                logf.flush()
                child = subprocess.Popen(
                    [sys.executable, "-m", WORKER_MODULES[job.kind], spec_path],
                    stdout=logf, stderr=subprocess.STDOUT, env=env)
            with self._child_lock:
                self._children[job.id] = child
                if self._abandon and child.poll() is None:
                    child.kill()  # stop(kill_child=True) raced the spawn
            # heartbeat while the child lives; a plain stop() keeps
            # beating and enforcing the timeout until the child exits
            hb_event: Optional[str] = None
            try:
                while True:
                    try:
                        rc = child.wait(timeout=self.config.heartbeat_interval_s)
                        break
                    except subprocess.TimeoutExpired:
                        if self._abandon:
                            return  # a crashed worker records nothing
                        try:
                            hb_event, owned = self.queue.heartbeat_fenced(
                                job.id, hb_event, job.claim_token or "")
                            if not owned:
                                log.warning("job %s: claim fenced (stolen by "
                                            "another worker); killing child "
                                            "and abandoning", job.id)
                                self._jobs_counter.inc(outcome="fenced")
                                child.kill()
                                child.wait()
                                return
                        except Exception:  # noqa: BLE001 — storage blip
                            log.warning("job %s heartbeat write failed "
                                        "(storage down?); supervision "
                                        "continues", job.id, exc_info=True)
                        if time.monotonic() >= deadline:
                            timed_out = True
                            child.kill()
                            rc = child.wait()
                            break
            except BaseException:
                # never leave a child running unsupervised: it would end on
                # its own and its job would then train again
                if child.poll() is None:
                    child.kill()
                    child.wait()
                raise
        except FileNotFoundError as e:  # the interpreter is missing
            self._finish_infra(job, f"could not spawn train worker: {e}")
            return
        finally:
            with self._child_lock:
                self._children.pop(job.id, None)
        if self._abandon:
            return
        if spool_dir is not None:
            # the exit flush usually leaves the spool empty; a child
            # killed before it cannot flush, so its spooled payloads ship
            # from here
            self._ship_spool_residue(spool_dir, push_knob("PIO_PUSH_URL", env))
        if not self.queue.is_owner(job):
            log.warning("job %s: claim superseded before bookkeeping; "
                        "dropping outcome", job.id)
            self._jobs_counter.inc(outcome="fenced")
            return
        if timed_out:
            self._finish_infra(
                job, f"train exceeded timeout ({timeout_s:.0f}s); killed")
            return
        if rc == 0:
            try:
                with open(result_path) as f:
                    result = json.load(f)
            except (OSError, ValueError) as e:
                self._finish_infra(job, f"train result unreadable: {e}")
                return
            self.queue.update(
                job.id, status="completed", finished_at=_now_iso(),
                instance_id=result.get("instance_id"),
                model_version=result.get("model_version"),
                last_error=None, claim_token=None)
            self._jobs_counter.inc(outcome="completed")
            self._link_eval_run(job, result)
            self._schedule_next_period(job)
        elif rc == EXIT_TRAIN_FAILED:
            self.queue.update(
                job.id, status="failed", finished_at=_now_iso(),
                last_error=f"train failed (see {log_path})", claim_token=None)
            self._jobs_counter.inc(outcome="failed_train")
            self._schedule_next_period(job)
        else:
            self._finish_infra(job, f"train worker exited {rc} (see {log_path})")

    def _finish_infra(self, job: TrainJob, error: str) -> None:
        """An infrastructure failure: re-queue with backoff, or fail after
        `max_attempts`; fenced like every terminal write."""
        if job.claim_token is not None and not self.queue.is_owner(job):
            self._jobs_counter.inc(outcome="fenced")
            return
        if job.attempt >= job.max_attempts:
            self.queue.update(
                job.id, status="failed", finished_at=_now_iso(),
                last_error=f"{error} (attempts exhausted)", claim_token=None)
            self._jobs_counter.inc(outcome="failed_infra")
            self._schedule_next_period(job)
            return
        backoff = retry_delay(job.attempt - 1)
        self.queue.update(
            job.id, status="queued", last_error=error,
            not_before=time.time() + backoff, worker_id=None,
            generation=job.generation + 1, claim_token=None)
        self._jobs_counter.inc(outcome="retried")
        log.warning("job %s infra failure (%s); retry %d/%d in %.1fs",
                    job.id, error, job.attempt, job.max_attempts, backoff)

    def _link_eval_run(self, job: TrainJob, result: dict) -> None:
        """The lineage stamp: a completed train whose variant carries an
        `evalRun` marker (the preset overlay put it there) links its model
        version onto that eval run. Best effort: lineage never fails a
        completed train."""
        run_id = (job.variant or {}).get("evalRun")
        version = result.get("model_version")
        if not run_id or not version:
            return
        try:
            from predictionio_tpu_torch.evalfleet.records import EvalRecordStore

            EvalRecordStore(self.storage).link_model_version(run_id, version,
                                                             job_id=job.id)
            log.info("job %s: linked model version %s to eval run %s",
                     job.id, version, run_id)
        except Exception:  # noqa: BLE001 — the train stays completed
            log.debug("eval-run lineage stamp failed", exc_info=True)

    def _schedule_next_period(self, job: TrainJob) -> None:
        """A periodic job's next run, `period_s` after this one ended. A
        train job's next run trains the engine's parked tuning preset
        (the job's tenant's first, else the global one) when there is one."""
        if not job.period_s:
            return
        variant = job.variant
        if job.kind == "train":
            try:
                from predictionio_tpu_torch.evalfleet.tuning import apply_preset

                variant = apply_preset(self.storage, variant, job.engine_id,
                                       tenant=job.tenant)
            except Exception:  # noqa: BLE001 — the retrain goes on as it was
                log.debug("retrain preset lookup failed", exc_info=True)
        nxt = self.queue.submit(
            variant, engine_id=job.engine_id, timeout_s=job.timeout_s,
            period_s=job.period_s, max_attempts=job.max_attempts,
            not_before=time.time() + job.period_s, kind=job.kind,
            tenant=job.tenant)
        log.info("periodic retrain: job %s scheduled %.0fs after %s "
                 "finished", nxt.id, job.period_s, job.id)
