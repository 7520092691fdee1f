"""Deterministic fault-injection registry.

Named fault points sit at the boundaries the chaos tests need to break:

  ==================  =====================================================
  point               fires in
  ==================  =====================================================
  ``event.insert``    the Event Server, before the storage write
  ``dispatch.device`` the query server's dispatcher, before a group's
                      device call (scoped by rollout variant), and in its
                      per-query fallback (scoped specs only)
  ``model.load``      ``build_runtime``, before the model is rehydrated
  ``online.fold``     the fold-in, after each row solve (``corrupt``
                      scrambles the solved rows)
  ``storage.rpc``     the remote storage client (``data/storage/
                      remote.py``), before each attempt of an RPC
                      (``corrupt`` garbles the daemon's answer)
  ==================  =====================================================

Each point carries at most one :class:`FaultSpec` per scope: mode
``error`` (raise :class:`FaultInjected`), ``delay`` (sleep ``param``
seconds, then proceed) or ``corrupt`` (the call site substitutes a
garbled result; a site that cannot corrupt raises instead), firing with
``probability`` decided by a per-point seeded RNG, so that a chaos run
replays the same fault sequence for the same seed and call order.

Configure three ways:

- the environment at process start: ``PIO_FAULTS=event.insert:error:0.2``
  (comma-separated specs, grammar ``point[@scope]:mode:prob[:param]``;
  ``PIO_FAULTS_SEED=N`` for determinism across processes),
- ``POST /debug/faults`` on any of the port's servers (403 unless
  ``PIO_FAULTS_ADMIN=1`` is set on the server process),
- ``console faults list|set|clear``.

Inert by default: with no spec installed, :func:`fire` is one dict
check. Counterpart of the JAX package's ``resilience/faults.py``: the
same grammar, the same errors and the same draws for a seed. Loads no
torch.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

from predictionio_tpu_torch.utils.env import FAULT_KEYS, env_raw, env_str

log = logging.getLogger(__name__)

FAULT_POINTS = (
    "storage.rpc",
    "event.insert",
    "dispatch.device",
    "model.load",
    "online.fold",
)

MODES = ("error", "delay", "corrupt")


class FaultInjected(Exception):
    """An injected failure (distinguishable from organic errors)."""


class FaultSpecError(ValueError):
    """A malformed fault spec string or field."""


@dataclass(frozen=True)
class FaultSpec:
    """One fault point's behaviour. `param` is the sleep seconds of mode
    ``delay`` (ignored otherwise). `scope` narrows the spec to the call
    sites that fire the point with that scope label
    (``dispatch.device@candidate`` fails only a canary's batches); a
    spec without one matches every fire of the point."""

    point: str
    mode: str
    probability: float
    param: float = 0.05
    seed: Optional[int] = None
    scope: Optional[str] = None

    def key(self) -> str:
        return self.point if self.scope is None else f"{self.point}@{self.scope}"

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise FaultSpecError(
                f"unknown fault point {self.point!r} "
                f"(known: {', '.join(FAULT_POINTS)})"
            )
        if self.mode not in MODES:
            raise FaultSpecError(
                f"unknown fault mode {self.mode!r} (known: {', '.join(MODES)})"
            )
        if not 0.0 <= self.probability <= 1.0:
            raise FaultSpecError(
                f"fault probability must be in [0, 1], got {self.probability}"
            )
        if self.param < 0:
            raise FaultSpecError("fault param must be >= 0")

    def to_dict(self) -> dict[str, Any]:
        return {
            "point": self.point,
            "mode": self.mode,
            "probability": self.probability,
            "param": self.param,
            "seed": self.seed,
            "scope": self.scope,
        }


def parse_spec(text: str, seed: Optional[int] = None) -> FaultSpec:
    """``point[@scope]:mode:prob[:param]`` → FaultSpec."""
    parts = text.strip().split(":")
    if len(parts) not in (3, 4):
        raise FaultSpecError(
            f"fault spec {text!r} is not point[@scope]:mode:prob[:param]"
        )
    try:
        prob = float(parts[2])
        param = float(parts[3]) if len(parts) == 4 else 0.05
    except ValueError as e:
        raise FaultSpecError(f"fault spec {text!r}: {e}")
    point, _, scope = parts[0].partition("@")
    return FaultSpec(point, parts[1], prob, param, seed, scope or None)


def parse_specs(text: str, seed: Optional[int] = None) -> list[FaultSpec]:
    """A comma-separated spec list (the ``PIO_FAULTS`` grammar)."""
    return [parse_spec(p, seed) for p in text.split(",") if p.strip()]


class FaultRegistry:
    """Thread-safe spec-key → spec map with per-key deterministic RNGs.

    The specs dict is replaced whole on every change, so that `fire`
    reads it without the lock: the inert path is one attribute load and
    a truth test."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, FaultSpec] = {}
        self._rngs: dict[str, random.Random] = {}  # guarded-by: _lock

    def install(self, spec: FaultSpec) -> None:
        with self._lock:
            specs = dict(self._specs)
            specs[spec.key()] = spec
            self._rngs[spec.key()] = random.Random(spec.seed)
            self._specs = specs

    def clear(self, point: Optional[str] = None) -> None:
        """Clear one spec key (``point`` or ``point@scope``), or all."""
        with self._lock:
            if point is None:
                self._specs = {}
                self._rngs.clear()
            else:
                specs = dict(self._specs)
                specs.pop(point, None)
                self._rngs.pop(point, None)
                self._specs = specs

    def specs(self) -> list[dict[str, Any]]:
        return [s.to_dict() for s in self._specs.values()]

    def active(self) -> bool:
        return bool(self._specs)

    def fire(
        self, point: str, corruptable: bool = False,
        scope: Optional[str] = None, scoped_only: bool = False,
    ) -> Optional[str]:
        """Evaluate the fault point. Returns None (no fault), ``"delay"``
        (after sleeping) or ``"corrupt"`` (the caller substitutes a
        garbled result); raises :class:`FaultInjected` for mode
        ``error``, and for ``corrupt`` where the site cannot corrupt.

        A `scope` label matches the ``point@scope`` spec first, then the
        spec without a scope; `scoped_only=True` skips the second, for a
        site (the dispatcher's per-query fallback) that must pass a
        scope-less spec by but honour a variant-targeted one."""
        specs = self._specs  # one snapshot read; {} when inert
        if not specs:
            return None
        key = point
        spec = specs.get(f"{point}@{scope}") if scope is not None else None
        if spec is not None:
            key = spec.key()
        elif scoped_only:
            return None
        else:
            spec = specs.get(point)
        if spec is None:
            return None
        with self._lock:
            rng = self._rngs.get(key)
            roll = rng.random() if rng is not None else random.random()
        if roll >= spec.probability:
            return None
        self._count(point, spec.mode)
        if spec.mode == "delay":
            time.sleep(spec.param)
            return "delay"
        if spec.mode == "corrupt" and corruptable:
            return "corrupt"
        raise FaultInjected(f"injected {spec.mode} fault at {point}")

    @staticmethod
    def _count(point: str, mode: str) -> None:
        # imported here: a process that never faults need not load obs
        try:
            from predictionio_tpu_torch.obs.registry import get_default_registry

            get_default_registry().counter(
                "faults_injected_total",
                "injected faults fired, by point and mode",
                ("point", "mode"),  # label-bound: the points x the modes
            ).inc(point=point, mode=mode)
        except Exception:  # noqa: BLE001 — counting never fails a fire
            pass

    def configure_from_env(self, env: Optional[dict] = None) -> None:
        """Apply ``PIO_FAULTS`` / ``PIO_FAULTS_SEED`` from `env` (the
        process environment when None). Raises FaultSpecError on a
        malformed value; the start-up load below logs it instead, so that
        a mistyped variable crashes no server."""
        env = env if env is not None else os.environ
        text = env_str("PIO_FAULTS", FAULT_KEYS["PIO_FAULTS"], env=env)
        if not text:
            return
        seed_s = env_raw("PIO_FAULTS_SEED", env=env)
        try:
            seed = int(seed_s) if seed_s else None
        except ValueError:
            raise FaultSpecError(
                f"PIO_FAULTS_SEED must be an integer, got {seed_s!r}"
            )
        for spec in parse_specs(text, seed):
            self.install(spec)


_default = FaultRegistry()
try:
    _default.configure_from_env()
except FaultSpecError as _e:
    log.warning(
        "ignoring malformed PIO_FAULTS (%s); the fault registry stays "
        "inert: fix the spec and restart, or use `console faults set`", _e,
    )


def registry() -> FaultRegistry:
    """The process-wide registry every fault point fires against."""
    return _default


def fire(
    point: str, corruptable: bool = False,
    scope: Optional[str] = None, scoped_only: bool = False,
) -> Optional[str]:
    return _default.fire(point, corruptable, scope, scoped_only)


def install(spec: FaultSpec) -> None:
    _default.install(spec)


def clear(point: Optional[str] = None) -> None:
    _default.clear(point)


def specs() -> list[dict[str, Any]]:
    return _default.specs()


def active() -> bool:
    return _default.active()
