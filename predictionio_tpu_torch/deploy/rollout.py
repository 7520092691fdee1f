"""Canary rollout with automatic rollback.

The query server holds up to two ``EngineRuntime``s, live and candidate,
and routes a sticky hash-of-request fraction of traffic to the
candidate. Per-variant serve and error metrics land in the server's
registry under a ``variant`` label, and a verdict loop compares the
candidate with live over a sliding window:

- error-rate delta above `max_error_delta`       → roll back
- candidate p99 / live p99 above `max_p99_ratio` → roll back
- shadow mode: the candidate answers a mirrored copy of live traffic off
  the response path; agreement below `min_agreement` → roll back
- healthy through `bake_s` of traffic             → promote

Promote swaps the runtime reference under the server's swap lock; the
old runtime drains rather than drops (queries in flight keep the runtime
they were read against, and the dispatcher groups by runtime), so no
query is dropped by either swap. Rollback detaches the candidate and
marks the version ``rolled_back``. Each rollout persists its state as a
``pio_rollout`` record, so a server restarted mid-canary re-adopts the
bake (``resume_rollout``).

Counterpart of the JAX package's ``deploy/rollout.py``, with the same
knobs (``PIO_ROLLOUT_*``), verdicts and records, and the same offline
prior: a candidate whose lineage-linked fleet evaluation scores below
live's gets its bake stretched by ``PIO_TUNE_STRICT_BAKE``
(``evalfleet/tuning.py``; never a veto, off with ``PIO_TUNE_PRIOR=0``).
One difference: the candidate is built on the live model's device, as
``reload`` builds. A tenant's rollout (``tenancy/mux.py``) persists
under the scope ``tenant/<id>`` and drives a host adapter whose promote
puts the candidate into the model cache; in such a scope a version that
another tenant already made live stays live at the start, and a resume
is refused only for a version rolled back or archived.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Optional

from predictionio_tpu_torch.deploy.registry import (
    ROLLOUT_ENTITY,
    LifecycleRecordStore,
    ModelRegistry,
    ModelVersion,
)
from predictionio_tpu_torch.utils.env import (
    ROLLOUT_KEYS,
    env_bool,
    env_float,
    env_int,
)

if TYPE_CHECKING:  # the runtime import would cycle with workflow.server
    from predictionio_tpu_torch.workflow.server import QueryServer

log = logging.getLogger(__name__)

VARIANT_LIVE = "live"
VARIANT_CANDIDATE = "candidate"


def _knob(reader, name: str, env: dict):
    return reader(name, ROLLOUT_KEYS[name], env=env)


@dataclass
class RolloutConfig:
    """Verdict knobs. `from_env` reads ``PIO_ROLLOUT_*``, so a deployment
    sets policy once; a start request overrides per rollout."""

    fraction: float = 0.1          # candidate traffic share (0..1]
    window_s: float = 30.0         # sliding comparison window
    interval_s: float = 1.0        # verdict loop cadence
    min_requests: int = 20         # candidate samples before judging
    max_error_delta: float = 0.05  # candidate err-rate − live err-rate bound
    max_p99_ratio: float = 3.0     # candidate p99 / live p99 bound
    bake_s: float = 60.0           # healthy for this long → promote
    shadow: bool = False           # mirror mode instead of live traffic
    min_agreement: float = 0.9     # shadow result-agreement floor

    @staticmethod
    def from_env(
        env: Optional[dict] = None, **overrides: Any
    ) -> "RolloutConfig":
        env = dict(os.environ if env is None else env)
        cfg = RolloutConfig(
            fraction=_knob(env_float, "PIO_ROLLOUT_FRACTION", env),
            window_s=_knob(env_float, "PIO_ROLLOUT_WINDOW_S", env),
            interval_s=_knob(env_float, "PIO_ROLLOUT_INTERVAL_S", env),
            min_requests=_knob(env_int, "PIO_ROLLOUT_MIN_REQUESTS", env),
            max_error_delta=_knob(env_float, "PIO_ROLLOUT_MAX_ERROR_DELTA", env),
            max_p99_ratio=_knob(env_float, "PIO_ROLLOUT_MAX_P99_RATIO", env),
            bake_s=_knob(env_float, "PIO_ROLLOUT_BAKE_S", env),
            shadow=_knob(env_bool, "PIO_ROLLOUT_SHADOW", env),
            min_agreement=_knob(env_float, "PIO_ROLLOUT_MIN_AGREEMENT", env),
        )
        for k, v in overrides.items():
            if v is None:
                continue
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                # bool("false") is True: parse the string spellings, so a
                # templated {"shadow": "false"} cannot turn a live canary
                # into a shadow one
                if isinstance(v, str):
                    v = v.strip().lower() in ("1", "true", "yes", "on")
                else:
                    v = bool(v)
                setattr(cfg, k, v)
            else:
                setattr(cfg, k, type(cur)(v))
        if not 0.0 < cfg.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {cfg.fraction}")
        return cfg

    def to_dict(self) -> dict[str, Any]:
        return {
            "fraction": self.fraction, "window_s": self.window_s,
            "interval_s": self.interval_s,
            "min_requests": self.min_requests,
            "max_error_delta": self.max_error_delta,
            "max_p99_ratio": self.max_p99_ratio, "bake_s": self.bake_s,
            "shadow": self.shadow, "min_agreement": self.min_agreement,
        }


def route_bucket(raw_request: bytes) -> int:
    """The sticky routing bucket of one request body: crc32 % 10000."""
    return zlib.crc32(raw_request) % 10_000


def sticky_candidate(
    raw_request: bytes, fraction: float, bucket: Optional[int] = None
) -> bool:
    """Hash-of-request routing: the same body always lands on the same
    variant, and the candidate's share tracks `fraction`. `bucket`
    (``X-PIO-Route-Hash``, a gateway's hash) overrides the local one."""
    if bucket is None:
        bucket = route_bucket(raw_request)
    return bucket < fraction * 10_000


class VariantWindow:
    """Thread-safe sliding window of (time, duration, error, trace id)
    serve samples of one variant, and the shadow agree/disagree counts."""

    def __init__(self, window_s: float):
        self.window_s = window_s
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque()  # guarded-by: _lock
        self._agree: collections.deque = collections.deque()  # guarded-by: _lock

    def add(self, duration_s: float, error: bool,
            trace_id: Optional[str] = None) -> None:
        with self._lock:
            self._samples.append(
                (time.monotonic(), duration_s, error, trace_id))
            self._trim()

    def add_agreement(self, agree: bool) -> None:
        with self._lock:
            self._agree.append((time.monotonic(), agree))
            self._trim()

    def _trim(self) -> None:
        cutoff = time.monotonic() - self.window_s
        for dq in (self._samples, self._agree):
            while dq and dq[0][0] < cutoff:
                dq.popleft()

    def stats(self) -> dict[str, Any]:
        with self._lock:
            self._trim()
            samples = list(self._samples)
            agree = list(self._agree)
        n = len(samples)
        errors = sum(1 for _, _, e, _tid in samples if e)
        durations = sorted(d for _, d, _, _tid in samples)
        p99 = durations[min(n - 1, int(0.99 * n))] if n else 0.0
        out = {
            "count": n,
            "errors": errors,
            "error_rate": errors / n if n else 0.0,
            "p50_ms": durations[n // 2] * 1000.0 if n else 0.0,
            "p99_ms": p99 * 1000.0,
        }
        # the slowest sample's trace: a p99 rollback names its exemplar
        if n:
            _t, worst_d, _e, worst_tid = max(samples, key=lambda s: s[1])
            if worst_tid:
                out["worst_trace_id"] = worst_tid
                out["worst_ms"] = worst_d * 1000.0
        if agree:
            out["agreement"] = sum(1 for _, a in agree if a) / len(agree)
            out["shadow_count"] = len(agree)
        return out


def verdict(
    live: dict[str, Any], cand: dict[str, Any], cfg: RolloutConfig,
    elapsed_s: float,
) -> tuple[str, str]:
    """The verdict over two window-stat dicts → (action, reason), action
    in {"wait", "promote", "rollback"}."""
    n = cand.get("shadow_count", 0) if cfg.shadow else cand["count"]
    if n < cfg.min_requests:
        return "wait", f"candidate has {n}/{cfg.min_requests} samples"
    if not cfg.shadow:
        delta = cand["error_rate"] - live["error_rate"]
        if delta > cfg.max_error_delta:
            return "rollback", (
                f"error-rate delta {delta:.3f} > {cfg.max_error_delta} "
                f"(candidate {cand['error_rate']:.3f} vs live "
                f"{live['error_rate']:.3f})"
            )
        if live["p99_ms"] > 0 and cand["p99_ms"] > 0:
            ratio = cand["p99_ms"] / live["p99_ms"]
            if ratio > cfg.max_p99_ratio:
                return "rollback", (
                    f"p99 ratio {ratio:.2f} > {cfg.max_p99_ratio} "
                    f"(candidate {cand['p99_ms']:.1f}ms vs live "
                    f"{live['p99_ms']:.1f}ms)"
                )
    else:
        agreement = cand.get("agreement")
        if agreement is not None and agreement < cfg.min_agreement:
            return "rollback", (
                f"shadow agreement {agreement:.3f} < {cfg.min_agreement}"
            )
    if elapsed_s >= cfg.bake_s:
        return "promote", f"healthy through {cfg.bake_s:.0f}s bake"
    return "wait", f"baking ({elapsed_s:.0f}/{cfg.bake_s:.0f}s)"


@dataclass
class RolloutState:
    version: ModelVersion
    config: RolloutConfig
    state: str = "starting"  # canary|promoted|rolled_back|aborted|failed
    started_at: float = field(default_factory=time.monotonic)
    started_wall: float = 0.0  # epoch seconds; survives restarts
    verdict_reason: str = ""
    last_action: str = "wait"


class RolloutController:
    """One canary's life: build → route → judge → swap or detach."""

    def __init__(
        self,
        server: "QueryServer",
        version: ModelVersion,
        config: Optional[RolloutConfig] = None,
        scope: Optional[str] = None,
    ):
        self.server = server
        self.registry = ModelRegistry(server.storage)
        self.config = config or RolloutConfig.from_env()
        self.st = RolloutState(version, self.config)
        # one active rollout per scope: the engine variant the server serves
        self.scope = scope or f"{version.engine_id}/{version.engine_variant}"
        self._records = LifecycleRecordStore(server.storage)
        self.windows = {
            VARIANT_LIVE: VariantWindow(self.config.window_s),
            VARIANT_CANDIDATE: VariantWindow(self.config.window_s),
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._shadow_inflight = threading.Semaphore(8)
        # the mirror pool (shadow mode only): a thread per mirror would
        # churn at serving rates
        self._shadow_pool = (
            ThreadPoolExecutor(max_workers=8,
                               thread_name_prefix="rollout-shadow")
            if self.config.shadow else None
        )
        # mirrors started after the pool closed mid-request; stop() joins them
        self._stray_lock = threading.Lock()
        self._stray_shadows: list[threading.Thread] = []  # guarded-by: _stray_lock

    # -- persistence ------------------------------------------------------
    def _persist(self, **fields: Any) -> None:
        """Best-effort state write: a storage blip must not fail the
        rollout (a restart re-checks the registry anyway)."""
        try:
            self._records.append(ROLLOUT_ENTITY, self.scope, fields)
        except Exception:  # noqa: BLE001 — logged; the rollout goes on
            log.warning(
                "rollout state persist failed for scope %s; a restart may "
                "miss this transition", self.scope, exc_info=True,
            )

    # -- lifecycle --------------------------------------------------------
    def start(self, resume_started_wall: Optional[float] = None) -> None:
        """Build the candidate runtime on the live model's device and
        attach it to the server. A build failure (a ``model.load`` fault,
        a missing blob, an engine the port cannot build) leaves the live
        runtime untouched: the canary never starts.

        `resume_started_wall` re-adopts a persisted canary after a
        restart: the bake is credited from the original start (the
        verdict windows, kept in memory, start empty)."""
        from predictionio_tpu_torch.workflow.server import (
            RolloutConflict,
            build_runtime,
            runtime_device,
        )

        # a cheap conflict check before the model build; attach_rollout
        # checks again under the swap lock
        active = self.server.rollout
        if active is not None and active is not self and active.st.state in (
            "starting", "canary"
        ):
            raise RolloutConflict(
                f"rollout of {active.st.version.id} is already active")
        instance = (self.server.storage.get_meta_data_engine_instances()
                    .get(self.st.version.instance_id))
        if instance is None:
            self.st.state = "failed"
            raise RuntimeError(
                f"model version {self.st.version.id} references missing "
                f"instance {self.st.version.instance_id}")
        try:
            candidate = build_runtime(
                self.server.storage, instance,
                device=runtime_device(self.server.runtime))
        except Exception as e:
            self.st.state = "failed"
            self.st.verdict_reason = f"candidate build failed: {e}"
            raise
        # attach before the registry flip: a conflicting rollout must
        # abort this start without marking the version; a failed flip
        # detaches, or traffic would reach a candidate nobody judges
        self.server.attach_rollout(self, candidate)
        try:
            # tenant scopes only: a version another tenant already
            # promoted stays "live" (tenants of one engine canary the same
            # trained version by default, and flipping the shared record
            # back would erase the variant's live pointer under the
            # tenants serving it). The default scope always flips: its
            # resume is strict (the status must be "canary")
            cur = (self.registry.get(self.st.version.id)
                   if self.scope.startswith("tenant/") else None)
            if cur is None or cur.status != "live":
                self.registry.set_status(self.st.version.id, "canary")
        except Exception:
            self.st.state = "failed"
            self.server.complete_rollout(self, promote=False)
            raise
        self.st.state = "canary"
        self._apply_offline_prior()
        now_wall = time.time()
        if (resume_started_wall is not None
                and 0 < resume_started_wall <= now_wall):
            self.st.started_at = time.monotonic() - (
                now_wall - resume_started_wall)
            self.st.started_wall = resume_started_wall
        else:
            self.st.started_at = time.monotonic()
            self.st.started_wall = now_wall
        self._persist(
            state="canary",
            version_id=self.st.version.id,
            config=self.config.to_dict(),
            started_wall=self.st.started_wall,
        )
        self._thread = threading.Thread(
            target=self._loop, name="rollout-verdict", daemon=True)
        self._thread.start()
        log.info("canary started: version %s at %.0f%% traffic%s",
                 self.st.version.id, self.config.fraction * 100,
                 " (shadow)" if self.config.shadow else "")

    def _apply_offline_prior(self) -> None:
        """Stretch the bake when the candidate's lineage-linked eval
        score is worse than live's: the online verdict gets more evidence
        before it promotes a model the fleet evaluation ranked lower.
        Never blocking: any failure leaves the bake as it is."""
        try:
            from predictionio_tpu_torch.evalfleet.tuning import offline_prior_multiplier

            v = self.st.version
            live = self.registry.live_version(v.engine_id, v.engine_variant)
            mult, why = offline_prior_multiplier(
                self.server.storage, v.engine_id, v.id,
                live.id if live is not None else None)
            if mult > 1.0:
                self.config.bake_s *= mult
                log.info("%s; bake now %.0fs", why, self.config.bake_s)
        except Exception:  # noqa: BLE001 — the canary goes on unchanged
            log.debug("offline prior unavailable", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._shadow_pool is not None:
            self._shadow_pool.shutdown(wait=False)
        with self._stray_lock:
            strays = list(self._stray_shadows)
        for t in strays:
            t.join(timeout=2)
        with self._stray_lock:
            self._stray_shadows[:] = [
                s for s in self._stray_shadows if s.is_alive()]

    # -- serving-path hooks ----------------------------------------------
    def record(self, variant: str, duration_s: float, error: bool) -> None:
        w = self.windows.get(variant)
        if w is not None:
            from predictionio_tpu_torch.obs.tracing import current_trace_id

            # called on the handler's thread, where the request's trace
            # id is ambient: it becomes the window's slowest-sample exemplar
            w.add(duration_s, error, trace_id=current_trace_id())

    def record_agreement(self, agree: bool) -> None:
        self.windows[VARIANT_CANDIDATE].add_agreement(agree)

    def try_shadow(self) -> bool:
        """The bounded gate of shadow mirrors: a slow candidate must not
        pile mirrors up behind it."""
        return self._shadow_inflight.acquire(blocking=False)

    def shadow_done(self) -> None:
        self._shadow_inflight.release()

    def run_shadow(self, fn) -> None:
        """Run a mirror off the response path on the pool; a thread of
        its own when the pool closed mid-request, so that `fn` always
        releases the caller's slot."""
        if self._shadow_pool is not None:
            try:
                self._shadow_pool.submit(fn)
                return
            except RuntimeError:
                pass  # the pool shut down: the rollout just ended
        t = threading.Thread(target=fn, name="rollout-shadow", daemon=True)
        with self._stray_lock:
            self._stray_shadows[:] = [
                s for s in self._stray_shadows if s.is_alive()]
            self._stray_shadows.append(t)
        t.start()

    # -- verdict loop -----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                action, _reason = self._tick()
            except Exception:  # noqa: BLE001 — the next tick retries
                log.exception("rollout verdict tick failed; retrying")
                continue
            if action != "wait":
                return

    def _tick(self) -> tuple[str, str]:
        live = self.windows[VARIANT_LIVE].stats()
        cand = self.windows[VARIANT_CANDIDATE].stats()
        elapsed = time.monotonic() - self.st.started_at
        action, reason = verdict(live, cand, self.config, elapsed)
        self.st.last_action, self.st.verdict_reason = action, reason
        if action == "promote":
            self.promote(reason)
        elif action == "rollback":
            self.rollback(reason)
        return action, reason

    # -- transitions ------------------------------------------------------
    def promote(self, reason: str = "operator promote") -> None:
        """The candidate becomes live under the server's swap lock; the
        old runtime drains. The serving swap is the source of truth: a
        failed registry write after it is reported in the reason
        (``console models promote`` repairs it)."""
        self._stop.set()
        self.server.complete_rollout(self, promote=True)
        self.st.state = "promoted"
        self.st.verdict_reason = reason
        try:
            self.registry.promote(self.st.version.id)
        except Exception:  # noqa: BLE001 — serving already swapped
            self.st.verdict_reason = (
                f"{reason} — REGISTRY UPDATE FAILED; run "
                f"`console models promote {self.st.version.id}`")
            log.exception("canary %s promoted in serving, but the registry "
                          "status write failed", self.st.version.id)
        self._persist(state="promoted", verdict_reason=reason)
        log.info("canary promoted: %s (%s)", self.st.version.id, reason)

    def rollback(self, reason: str) -> None:
        self._stop.set()
        self.server.complete_rollout(self, promote=False)
        self.st.state = "rolled_back"
        self.st.verdict_reason = reason
        try:
            self.registry.rollback(self.st.version.id, reason)
        except Exception:  # noqa: BLE001 — serving already detached
            self.st.verdict_reason = (
                f"{reason} — REGISTRY UPDATE FAILED; run "
                f"`console models rollback {self.st.version.id}`")
            log.exception("canary %s detached from serving, but the "
                          "registry status write failed", self.st.version.id)
        self._persist(state="rolled_back", verdict_reason=reason)
        log.warning("canary rolled back: %s (%s)", self.st.version.id, reason)

    def abort(self, reason: str = "operator abort") -> None:
        self.rollback(reason)
        self.st.state = "aborted"
        self._persist(state="aborted", verdict_reason=reason)

    # -- reporting --------------------------------------------------------
    def status(self) -> dict[str, Any]:
        return {
            "state": self.st.state,
            "version": self.st.version.to_dict(),
            "config": self.config.to_dict(),
            "elapsed_s": round(time.monotonic() - self.st.started_at, 1),
            "started_wall": self.st.started_wall,
            "last_action": self.st.last_action,
            "reason": self.st.verdict_reason,
            "live": self.windows[VARIANT_LIVE].stats(),
            "candidate": self.windows[VARIANT_CANDIDATE].stats(),
        }


def resume_rollout(server, scope: Optional[str] = None):
    """Re-adopt a persisted canary after a restart. Returns the started
    controller, or None when there is nothing valid to resume.

    The registry is the source of truth: a record that says "canary" for
    a version the registry has moved on (another server promoted or
    rolled it back meanwhile) is retired, not resumed."""
    storage = server.storage
    if scope is None:
        inst = server.runtime.instance
        scope = f"{inst.engine_id}/{inst.engine_variant}"
    rec = LifecycleRecordStore(storage).fold(ROLLOUT_ENTITY, scope).get(scope)
    if not rec or rec.get("state") != "canary":
        return None
    version = ModelRegistry(storage).get(rec.get("version_id") or "")
    if version is None:
        stale = "version record missing from the registry"
    elif scope.startswith("tenant/"):
        # tenant scopes share version records, so the global status does
        # not say whether THIS scope's rollout finished: another tenant
        # promoting the shared version makes it "live" mid-bake. Only
        # the globally disqualifying states stop a tenant resume:
        # rolled_back (judged bad somewhere) and archived (its blob may
        # be collected)
        stale = (f"version {version.id} is {version.status}"
                 if version.status in ("rolled_back", "archived") else None)
    else:
        # the default scope is the variant's one serving scope: any move
        # off "canary" means this rollout finished elsewhere
        stale = (f"version {version.id} is {version.status}"
                 if version.status != "canary" else None)
    if stale is not None:
        # retire the stale record, or every restart would consider it again
        try:
            LifecycleRecordStore(storage).append(
                ROLLOUT_ENTITY, scope,
                {"state": "aborted", "verdict_reason": f"not resumed: {stale}"})
        except Exception:  # noqa: BLE001 — logged; nothing resumes anyway
            log.warning("could not retire stale rollout record for scope %s",
                        scope, exc_info=True)
        log.warning("persisted rollout for scope %s not resumed: %s", scope, stale)
        return None
    try:
        config = RolloutConfig.from_env(**(rec.get("config") or {}))
    except (TypeError, ValueError):
        log.warning("persisted rollout config for scope %s is malformed; "
                    "resuming with the environment's", scope)
        config = RolloutConfig.from_env()
    controller = RolloutController(server, version, config, scope=scope)
    controller.start(resume_started_wall=rec.get("started_wall"))
    log.info("re-adopted persisted rollout of %s (scope %s)", version.id, scope)
    return controller
