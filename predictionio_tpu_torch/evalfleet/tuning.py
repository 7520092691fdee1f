"""The tuning loop: park an eval run's winner as a retrain preset,
overlay it onto the next periodic retrain, and lend the winner's offline
score to the canary's verdict as a prior.

Counterpart of the JAX package's ``evalfleet/tuning.py``. Presets are
lifecycle records (entity ``pio_retrain_preset``) keyed by engine id,
or ``engine_id@tenant`` for a tenant's (``tune --tenant``), which wins
over the global one for a job of that tenant. The scheduler calls
`apply_preset` when it enqueues a periodic job's next run, so the next
retrain of the engine trains the winning params; the merged variant
carries an ``evalRun`` marker, and the completed train stamps the
lineage link (``EvalRun.winner_model_version``) onto the run.

The offline prior: when the canary candidate and the live version both
have lineage-linked eval runs on the same metric, and the candidate's
offline score is worse than live's, the rollout's bake stretches by
``PIO_TUNE_STRICT_BAKE``. It never vetoes a canary: missing or
incomparable evidence gives a multiplier of 1, and ``PIO_TUNE_PRIOR=0``
turns it off.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Optional

from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore
from predictionio_tpu_torch.evalfleet.records import EvalRecordStore, EvalRun
from predictionio_tpu_torch.evalfleet.specs import STAGE_KEYS, EvalSpec, resolve_metric
from predictionio_tpu_torch.utils.env import eval_knob

log = logging.getLogger(__name__)

PRESET_ENTITY = "pio_retrain_preset"


@dataclass
class RetrainPreset:
    """A parked winner: stage-params fragment + provenance."""

    engine_id: str
    params: dict
    tenant: Optional[str] = None
    run_id: str = ""
    metric_header: str = ""
    score: Optional[float] = None
    created_at: float = 0.0

    @property
    def key(self) -> str:
        return preset_key(self.engine_id, self.tenant)

    def to_dict(self) -> dict:
        return {
            "engine_id": self.engine_id,
            "params": self.params,
            "tenant": self.tenant,
            "run_id": self.run_id,
            "metric_header": self.metric_header,
            "score": self.score,
            "created_at": self.created_at,
        }

    @staticmethod
    def from_fields(fields: dict) -> "RetrainPreset":
        return RetrainPreset(
            engine_id=fields.get("engine_id", ""),
            params=fields.get("params") or {},
            tenant=fields.get("tenant"),
            run_id=fields.get("run_id", ""),
            metric_header=fields.get("metric_header", ""),
            score=fields.get("score"),
            created_at=fields.get("created_at", 0.0),
        )


def preset_key(engine_id: str, tenant: Optional[str] = None) -> str:
    return f"{engine_id}@{tenant}" if tenant else engine_id


class PresetStore:
    """CRUD for retrain presets on the shared record layer."""

    def __init__(self, storage: Storage):
        self._store = LifecycleRecordStore(storage)

    def park(self, preset: RetrainPreset) -> None:
        preset.created_at = preset.created_at or time.time()
        self._store.append(PRESET_ENTITY, preset.key, preset.to_dict())

    def get(self, engine_id: str,
            tenant: Optional[str] = None) -> Optional[RetrainPreset]:
        """Tenant-scoped preset first, global fallback."""
        for key in filter(None, (
            preset_key(engine_id, tenant) if tenant else None,
            preset_key(engine_id),
        )):
            fields = self._store.fold(PRESET_ENTITY, key).get(key)
            if fields:
                return RetrainPreset.from_fields(fields)
        return None

    def list(self) -> list[RetrainPreset]:
        out = [RetrainPreset.from_fields(f)
               for f in self._store.fold(PRESET_ENTITY).values() if f]
        out.sort(key=lambda p: p.created_at, reverse=True)
        return out

    def clear(self, engine_id: str, tenant: Optional[str] = None) -> int:
        return self._store.purge(PRESET_ENTITY, preset_key(engine_id, tenant))


def apply_preset(storage: Storage, variant: dict, engine_id: str,
                 tenant: Optional[str] = None) -> dict:
    """Overlay the parked winner's stage params onto a retrain variant.

    Called by TrainScheduler._schedule_next_period for every periodic
    train resubmission; identity when no preset is parked. The merged
    variant keeps id/engineFactory/mesh and gains an `evalRun` marker
    for the completion-time lineage stamp."""
    preset = PresetStore(storage).get(engine_id, tenant)
    if preset is None:
        return variant
    merged = dict(variant)
    for key in STAGE_KEYS:
        if key in preset.params:
            merged[key] = preset.params[key]
    if preset.run_id:
        merged["evalRun"] = preset.run_id
    log.info(
        "retrain preset applied: engine %s%s trains eval winner from %s "
        "(%s=%s)", engine_id, f" tenant {tenant}" if tenant else "",
        preset.run_id, preset.metric_header, preset.score,
    )
    return merged


def park_winner(storage: Storage, run: EvalRun,
                tenant: Optional[str] = None) -> RetrainPreset:
    """EvalRun winner → retrain preset (the `pio tune` parking step)."""
    if run.status != "completed" or run.winner_params is None:
        raise ValueError(
            f"eval run {run.id} has no winner to park "
            f"(status={run.status})"
        )
    preset = RetrainPreset(
        engine_id=run.engine_id,
        params=run.winner_params,
        tenant=tenant if tenant is not None else run.tenant,
        run_id=run.id,
        metric_header=run.metric_header,
        score=run.winner_score,
    )
    PresetStore(storage).park(preset)
    return preset


def tune(
    storage: Storage,
    spec: EvalSpec,
    tenant: Optional[str] = None,
    timeout_s: Optional[float] = None,
    driver: Any = None,
) -> tuple[EvalRun, Optional[RetrainPreset]]:
    """The full loop: run the space on the fleet, wait, park the winner.

    Returns (run, preset); preset is None when the run did not complete
    with a winner (the run record carries the diagnosis)."""
    from predictionio_tpu_torch.evalfleet.driver import EvalDriver

    drv = driver or EvalDriver(storage)
    run = drv.submit(spec, tenant=tenant)
    run = drv.wait(run.id, timeout_s=timeout_s)
    if run.status != "completed" or run.winner_params is None:
        log.warning("tune: eval run %s ended %s without a usable winner",
                    run.id, run.status)
        return run, None
    return run, park_winner(storage, run, tenant=tenant)


# ---------------------------------------------------------------------------
# canary offline prior
# ---------------------------------------------------------------------------


def _linked_score(runs: list[EvalRun],
                  version_id: str) -> Optional[tuple[EvalRun, float]]:
    """Newest completed run whose lineage links `version_id` and whose
    winner score is defined."""
    for run in runs:
        if version_id in run.links and run.winner_score is not None:
            return run, float(run.winner_score)
    return None


def offline_prior_multiplier(
    storage: Storage,
    engine_id: str,
    candidate_version_id: str,
    live_version_id: Optional[str],
) -> tuple[float, Optional[str]]:
    """(bake multiplier, reason) for the canary verdict.

    Strict (PIO_TUNE_STRICT_BAKE) only when both versions carry lineage-
    linked eval scores on the SAME metric header and the candidate's is
    worse; 1.0 whenever the evidence is missing or incomparable — the
    prior must never be able to wedge a rollout."""
    if not eval_knob("PIO_TUNE_PRIOR"):
        return 1.0, None
    factor = eval_knob("PIO_TUNE_STRICT_BAKE")
    if factor <= 1.0 or not live_version_id:
        return 1.0, None
    runs = EvalRecordStore(storage).list_runs(
        engine_id=engine_id, status="completed"
    )
    cand = _linked_score(runs, candidate_version_id)
    live = _linked_score(runs, live_version_id)
    if cand is None or live is None:
        return 1.0, None
    cand_run, cand_score = cand
    live_run, live_score = live
    if cand_run.metric_header != live_run.metric_header:
        return 1.0, None
    try:
        metric = resolve_metric((cand_run.spec or {}).get("metric"))
    except Exception:
        return 1.0, None
    if metric.compare(cand_score, live_score) < 0:
        return factor, (
            f"offline prior: candidate {cand_run.metric_header}="
            f"{cand_score:.6g} worse than live {live_score:.6g} "
            f"(runs {cand_run.id}/{live_run.id}) -> bake x{factor:g}"
        )
    return 1.0, None
