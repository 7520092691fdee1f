"""The fleet evaluation's driver: split a param space into shard jobs on
the job queue, fold the shards' durable partials into a live status,
re-dispatch failed shards and pick the winner.

Counterpart of the JAX package's ``evalfleet/driver.py``. The eval
driver runs nothing itself: a shard is a ``kind="eval"`` job that any
worker over the same storage claims as it claims a train job
(heartbeats, re-queue after a crash, the fenced steal of
``deploy/scheduler.py``), one job per (grid group x fold). Its state is
a fold over durable records, so an eval driver can die and another
resume: `status(run_id)` recomputes everything from the results and the
job records.

`start(run_id)` runs one named poll thread ("eval-driver"), which
`stop()` joins.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.deploy.scheduler import JobQueue
from predictionio_tpu_torch.evalfleet.records import (
    EvalRecordStore,
    EvalRun,
    RUN_TERMINAL,
)
from predictionio_tpu_torch.evalfleet.specs import (
    EvalSpec,
    combine_partials,
    expand_points,
    group_points,
    metric_finalize,
    point_fragment,
    resolve_metric,
)
from predictionio_tpu_torch.utils.env import eval_knob

log = logging.getLogger(__name__)

EVAL_DRIVER_THREAD = "eval-driver"


@dataclass
class EvalDriverConfig:
    poll_interval_s: float = field(
        default_factory=lambda: eval_knob("PIO_EVAL_POLL_S"))
    shard_timeout_s: float = field(
        default_factory=lambda: eval_knob("PIO_EVAL_SHARD_TIMEOUT_S"))
    max_attempts: int = field(
        default_factory=lambda: eval_knob("PIO_EVAL_MAX_ATTEMPTS"))
    # extra re-submissions per exhausted shard before the run fails —
    # straggler/poison insurance ON TOP of the queue's own retry budget
    redispatch_limit: int = field(
        default_factory=lambda: eval_knob("PIO_EVAL_REDISPATCH"))


class EvalDriver:
    """Fan out an EvalSpec, watch it converge, pick the winner."""

    def __init__(self, storage: Storage,
                 config: Optional[EvalDriverConfig] = None):
        self.storage = storage
        self.config = config or EvalDriverConfig()
        self.queue = JobQueue(storage)
        self.records = EvalRecordStore(storage)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- fan-out -----------------------------------------------------------

    def submit(self, spec: EvalSpec, tenant: Optional[str] = None) -> EvalRun:
        """Expand the space, create the EvalRun record, and enqueue one
        shard job per (grid-compatible group × fold)."""
        points = expand_points(spec)
        groups = group_points(points)
        folds = list(range(spec.folds)) if spec.folds > 0 else [None]
        metric = resolve_metric(spec.metric)
        run = self.records.create_run(
            engine_id=str(spec.variant.get("id", "")),
            spec=spec.to_dict(),
            num_points=len(points),
            num_groups=len(groups),
            num_folds=len(folds),
            metric_header=metric.header(),
            higher_is_better=metric.higher_is_better,
            tenant=tenant,
        )
        shards: dict[str, dict] = {}
        for gi, group in enumerate(groups):
            for fold in folds:
                job = self._submit_shard(run, spec, points, group, fold)
                shards[job.id] = {"group": gi, "fold": fold,
                                  "point_indices": list(group)}
        self.records.update_run(run.id, shards=shards)
        run.shards = shards
        log.info(
            "eval run %s: %d points in %d groups x %d folds -> %d shards",
            run.id, len(points), len(groups), len(folds), len(shards),
        )
        return run

    def _submit_shard(self, run: EvalRun, spec: EvalSpec,
                      points: list, group: list, fold: Optional[int]):
        shard = {
            "run_id": run.id,
            "point_indices": list(group),
            "points": [point_fragment(points[i]) for i in group],
            "fold": fold,
            "folds": spec.folds,
            "metric": spec.metric,
            "other_metrics": list(spec.other_metrics),
        }
        variant = {
            "id": spec.variant.get("id", ""),
            "engineFactory": spec.variant["engineFactory"],
            "evalShard": shard,
        }
        return self.queue.submit(
            variant,
            engine_id=str(spec.variant.get("id", "")),
            timeout_s=self.config.shard_timeout_s,
            max_attempts=self.config.max_attempts,
            kind="eval",
            tenant=run.tenant,
        )

    # -- the live fold -----------------------------------------------------

    def scores(self, run: EvalRun) -> list[dict]:
        """Per-point combined view from the durable records: folds seen,
        combined primary score (partial until all folds land)."""
        metric = resolve_metric((run.spec or {}).get("metric", run.metric_header))
        results = self.records.results(run.id)
        expected = (
            [f"fold_{i}" for i in range(run.num_folds)]
            if run.num_folds > 1 or (run.spec or {}).get("folds", 0) > 0
            else ["fold_all"]
        )
        out = []
        for pi in range(run.num_points):
            rec = results.get(pi, {})
            partials = self.records.point_partials(rec)
            primary = [p.get("primary", {}) for p in partials.values()]
            total, count = combine_partials(primary)
            out.append({
                "point_index": pi,
                "params": rec.get("params"),
                "folds_done": sorted(partials),
                "complete": all(k in partials for k in expected),
                "score": metric_finalize(metric, total, count)
                if primary else None,
            })
        return out

    def status(self, run_id: str) -> dict:
        """The `pio eval status` payload: run record + per-point coverage
        + shard job states, recomputed from durable state every call."""
        run = self.records.get_run(run_id)
        if run is None:
            raise KeyError(f"no such eval run: {run_id}")
        scores = self.scores(run)
        jobs = {j.id: j for j in self.queue.list()}
        shard_view = []
        for job_id, meta in sorted(run.shards.items()):
            j = jobs.get(job_id)
            shard_view.append({
                "job_id": job_id,
                "group": meta.get("group"),
                "fold": meta.get("fold"),
                "status": j.status if j is not None else "unknown",
                "worker_id": getattr(j, "worker_id", None),
                "attempt": getattr(j, "attempt", None),
            })
        done = sum(1 for s in scores if s["complete"])
        return {
            "run": run.to_dict(),
            "points_done": done,
            "points_total": run.num_points,
            "shards": shard_view,
            "points": scores,
        }

    # -- convergence -------------------------------------------------------

    def poll_once(self, run_id: str) -> EvalRun:
        """One driver tick: re-dispatch exhausted shards whose points are
        still incomplete, finalize when every point converged, fail when
        the retry budget is spent."""
        run = self.records.get_run(run_id)
        if run is None:
            raise KeyError(f"no such eval run: {run_id}")
        if run.status in RUN_TERMINAL:
            return run
        scores = self.scores(run)
        if all(s["complete"] for s in scores):
            return self._finalize(run, scores)

        jobs = {j.id: j for j in self.queue.list()}
        incomplete = {
            pi for s in scores if not s["complete"]
            for pi in [s["point_index"]]
        }
        redispatches = dict(run.shards)
        changed = False
        exhausted = 0
        for job_id, meta in list(run.shards.items()):
            if not (set(meta.get("point_indices", [])) & incomplete):
                continue  # this shard's points already landed
            j = jobs.get(job_id)
            if j is None or j.status != "failed":
                continue  # pending/running/completed: let the fleet work
            n = int(meta.get("redispatched", 0))
            if n >= self.config.redispatch_limit:
                exhausted += 1
                continue
            # straggler/poison re-dispatch: same shard payload, fresh job
            nxt = self.queue.submit(
                j.variant,
                engine_id=j.engine_id,
                timeout_s=j.timeout_s,
                max_attempts=self.config.max_attempts,
                kind="eval",
                tenant=run.tenant,
            )
            log.warning("eval run %s: re-dispatched failed shard %s as %s",
                        run.id, job_id, nxt.id)
            meta = dict(meta, redispatched=n + 1)
            redispatches[job_id] = meta
            # the replacement INHERITS the lineage's spent budget — a
            # poison shard can't buy itself a fresh limit per re-dispatch
            redispatches[nxt.id] = {
                "group": meta.get("group"), "fold": meta.get("fold"),
                "point_indices": list(meta.get("point_indices", [])),
                "redispatched": n + 1,
            }
            changed = True
        if changed:
            self.records.update_run(run.id, shards=redispatches)
            run.shards = redispatches
        elif exhausted:
            self.records.update_run(
                run.id, status="failed", finished_at=time.time(),
                last_error=f"{exhausted} shard(s) exhausted their retry "
                           f"budget with incomplete points",
            )
            return self.records.get_run(run.id) or run
        return run

    def _finalize(self, run: EvalRun, scores: list[dict]) -> EvalRun:
        metric = resolve_metric((run.spec or {}).get("metric", run.metric_header))
        winner = None
        for s in scores:
            if s["score"] is None:
                continue
            if winner is None or metric.compare(s["score"], winner["score"]) > 0:
                winner = s
        fields: dict[str, Any] = {
            "status": "completed", "finished_at": time.time(),
        }
        if winner is not None:
            fields.update(
                winner_index=winner["point_index"],
                winner_score=winner["score"],
                winner_params=winner["params"],
            )
        self.records.update_run(run.id, **fields)
        out = self.records.get_run(run.id) or run
        log.info(
            "eval run %s completed: winner point %s (%s=%s)",
            run.id, out.winner_index, out.metric_header, out.winner_score,
        )
        return out

    def wait(self, run_id: str, timeout_s: Optional[float] = None) -> EvalRun:
        """Poll until the run is terminal (or timeout); returns the run."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            run = self.poll_once(run_id)
            if run.status in RUN_TERMINAL:
                return run
            if deadline is not None and time.monotonic() >= deadline:
                return run
            if self._stop.wait(self.config.poll_interval_s):
                return run

    # -- background poll thread (joined by stop) ---------------------------

    def start(self, run_id: str) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("eval driver already running")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    run = self.poll_once(run_id)
                    if run.status in RUN_TERMINAL:
                        return
                except Exception:
                    log.warning("eval driver poll failed", exc_info=True)
                if self._stop.wait(self.config.poll_interval_s):
                    return

        self._thread = threading.Thread(
            target=loop, name=EVAL_DRIVER_THREAD, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
