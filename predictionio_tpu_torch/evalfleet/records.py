"""The fleet evaluation's records: ``EvalRun`` and its per-point results
on the lifecycle record layer.

Counterpart of the JAX package's ``evalfleet/records.py``: the same
entity types (``pio_eval_run``, ``pio_eval_result``), ids and fields,
so either package reads the runs and results the other writes into a
shared store. Runs and results are durable, compacted and collected,
and a run carries lineage links from its winning params to the model
versions later trained from them.

A shard's write is idempotent by the record's shape, with no
coordination:

- a result's entity id is ``{run_id}#p{index}``, so a shard that runs
  again (a re-queue after a crash, a steal, a re-dispatch) writes the
  same record;
- each shard writes its fold's partial under a field of its own
  (``fold_3``); the field-level last-write-wins fold merges the folds of
  different workers and makes a fold's rewrite a no-op.

A point has converged when every expected fold field is there.
"""

from __future__ import annotations

import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore

log = logging.getLogger(__name__)

EVAL_RUN_ENTITY = "pio_eval_run"
EVAL_RESULT_ENTITY = "pio_eval_result"

RUN_TERMINAL = ("completed", "failed")


@dataclass
class EvalRun:
    """One declarative evaluation of a param space."""

    id: str
    engine_id: str
    status: str = "running"  # running | completed | failed
    tenant: Optional[str] = None
    spec: dict = field(default_factory=dict)
    num_points: int = 0
    num_groups: int = 0
    num_folds: int = 1  # shard granularity (1 = all folds in one shard)
    metric_header: str = ""
    higher_is_better: bool = True
    created_at: float = 0.0
    finished_at: Optional[float] = None
    winner_index: Optional[int] = None
    winner_score: Optional[float] = None
    winner_params: Optional[dict] = None
    winner_model_version: Optional[str] = None
    last_error: Optional[str] = None
    shards: dict = field(default_factory=dict)  # job_id → {group, fold}
    links: dict = field(default_factory=dict)  # version_id → {job_id, at}

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "engine_id": self.engine_id,
            "status": self.status,
            "tenant": self.tenant,
            "spec": self.spec,
            "num_points": self.num_points,
            "num_groups": self.num_groups,
            "num_folds": self.num_folds,
            "metric_header": self.metric_header,
            "higher_is_better": self.higher_is_better,
            "created_at": self.created_at,
            "finished_at": self.finished_at,
            "winner_index": self.winner_index,
            "winner_score": self.winner_score,
            "winner_params": self.winner_params,
            "winner_model_version": self.winner_model_version,
            "last_error": self.last_error,
            "shards": self.shards,
            "links": self.links,
        }

    @staticmethod
    def from_fields(fields: dict) -> "EvalRun":
        run = EvalRun(id=fields.get("id", ""), engine_id=fields.get("engine_id", ""))
        for k in (
            "status", "tenant", "spec", "num_points", "num_groups",
            "num_folds", "metric_header", "higher_is_better", "created_at",
            "finished_at", "winner_index", "winner_score", "winner_params",
            "winner_model_version", "last_error", "shards",
        ):
            if fields.get(k) is not None:
                setattr(run, k, fields[k])
        # lineage links live as link_{version_id} fields so concurrent
        # stampers never clobber each other (field-level LWW)
        run.links = {
            k[len("link_"):]: v for k, v in fields.items()
            if k.startswith("link_") and isinstance(v, dict)
        }
        return run


class EvalRecordStore:
    """CRUD + fold/compaction/GC for the EvalRun/EvalResult family."""

    def __init__(self, storage: Storage):
        self.storage = storage
        self._store = LifecycleRecordStore(storage)

    # -- runs --------------------------------------------------------------

    def create_run(
        self,
        engine_id: str,
        spec: dict,
        num_points: int,
        num_groups: int,
        num_folds: int,
        metric_header: str,
        higher_is_better: bool = True,
        tenant: Optional[str] = None,
    ) -> EvalRun:
        run = EvalRun(
            id=f"eval-{uuid.uuid4().hex[:12]}",
            engine_id=engine_id,
            tenant=tenant,
            spec=spec,
            num_points=num_points,
            num_groups=num_groups,
            num_folds=max(1, num_folds),
            metric_header=metric_header,
            higher_is_better=higher_is_better,
            created_at=time.time(),
        )
        props = {k: v for k, v in run.to_dict().items()
                 if k != "links" and v is not None}
        self._store.append(EVAL_RUN_ENTITY, run.id, props)
        return run

    def update_run(self, run_id: str, **fields: Any) -> None:
        self._store.append(EVAL_RUN_ENTITY, run_id, fields)

    def get_run(self, run_id: str) -> Optional[EvalRun]:
        fields = self._store.fold(EVAL_RUN_ENTITY, run_id).get(run_id)
        return EvalRun.from_fields(fields) if fields else None

    def list_runs(
        self,
        engine_id: Optional[str] = None,
        status: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> list[EvalRun]:
        runs = [
            EvalRun.from_fields(f)
            for f in self._store.fold(EVAL_RUN_ENTITY).values()
            if f.get("id")
        ]
        if engine_id is not None:
            runs = [r for r in runs if r.engine_id == engine_id]
        if status is not None:
            runs = [r for r in runs if r.status == status]
        if tenant is not None:
            runs = [r for r in runs if r.tenant == tenant]
        runs.sort(key=lambda r: r.created_at, reverse=True)
        return runs

    # -- per-point results -------------------------------------------------

    @staticmethod
    def result_id(run_id: str, point_index: int) -> str:
        return f"{run_id}#p{point_index}"

    @staticmethod
    def fold_key(fold: Optional[int]) -> str:
        return "fold_all" if fold is None else f"fold_{int(fold)}"

    def record_partial(
        self,
        run_id: str,
        point_index: int,
        fold: Optional[int],
        payload: dict,
        params: Optional[dict] = None,
    ) -> None:
        """One shard's per-point contribution. Idempotent: a requeued
        shard rewrites the same entity's same fold field."""
        props: dict[str, Any] = {
            "run_id": run_id,
            "point_index": int(point_index),
            self.fold_key(fold): payload,
        }
        if params is not None:
            props["params"] = params
        self._store.append(
            EVAL_RESULT_ENTITY, self.result_id(run_id, point_index), props
        )

    def results(self, run_id: str) -> dict[int, dict]:
        """point_index → folded result record for one run."""
        out: dict[int, dict] = {}
        prefix = f"{run_id}#p"
        for eid, fields in self._store.fold(EVAL_RESULT_ENTITY).items():
            if eid.startswith(prefix) and fields.get("run_id") == run_id:
                out[int(fields.get("point_index", eid[len(prefix):]))] = fields
        return out

    def point_partials(self, record: dict) -> dict[str, dict]:
        """fold_key → partial payload from a folded result record."""
        return {
            k: v for k, v in record.items()
            if (k == "fold_all" or k.startswith("fold_")) and isinstance(v, dict)
        }

    # -- lineage -----------------------------------------------------------

    def link_model_version(
        self, run_id: str, version_id: str, job_id: Optional[str] = None,
    ) -> None:
        """Lineage pointer: the winning params of `run_id` were trained
        into ModelVersion `version_id` (stamped by the scheduler when a
        preset-carrying retrain completes). Field-per-version keeps
        concurrent stamps merge-safe; winner_model_version tracks the
        newest."""
        self._store.append(EVAL_RUN_ENTITY, run_id, {
            f"link_{version_id}": {"job_id": job_id, "at": time.time()},
            "winner_model_version": version_id,
        })

    # -- hygiene: compaction + GC (same discipline as ModelRegistry) -------

    def compact(self, min_events: int = 8, min_age_s: float = 60.0) -> int:
        removed = self._store.compact_all(
            EVAL_RUN_ENTITY, min_events=min_events, min_age_s=min_age_s
        )
        removed += self._store.compact_all(
            EVAL_RESULT_ENTITY, min_events=min_events, min_age_s=min_age_s
        )
        return removed

    def purge_run(self, run_id: str) -> int:
        removed = self._store.purge(EVAL_RUN_ENTITY, run_id)
        for eid in list(self._store.fold(EVAL_RESULT_ENTITY)):
            if eid.startswith(f"{run_id}#p"):
                removed += self._store.purge(EVAL_RESULT_ENTITY, eid)
        return removed

    def gc(self, keep: int = 20) -> int:
        """Drop the oldest terminal runs (and their results) beyond
        `keep`; running evaluations are never collected."""
        terminal = [r for r in self.list_runs() if r.status in RUN_TERMINAL]
        removed = 0
        for run in terminal[keep:]:
            removed += self.purge_run(run.id)
        if removed:
            log.info("eval GC: purged %d events beyond %d kept runs",
                     removed, keep)
        return removed
