"""Environment knobs the port reads.

The port's own copy of the readers of the JAX package's ``utils/env.py``
that it needs: the dense-ALS gate (``PIO_DENSE_ALS`` and
``PIO_DENSE_ALS_BYTES``), the storage base directory
(``PIO_FS_BASEDIR``), the online consumer's knobs (``ONLINE_KEYS``) and
the observability knobs (``PIO_DEVPROF``, the peak overrides, the
trace sampling).
A missing or empty value gives the caller's default; a malformed number
gives the default with a warning, as in the JAX package.
"""

from __future__ import annotations

import logging
import os

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


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name) or default


def env_path(name: str, default: str = "") -> str:
    """Like env_str, with ~ expanded in the value and the default."""
    return os.path.expanduser(env_str(name, default))


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(float(raw))
    except (ValueError, OverflowError):  # OverflowError: "inf"
        log.warning("ignoring malformed %s=%r", name, raw)
        return default


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return float(default)
    try:
        return float(raw)
    except ValueError:
        log.warning("ignoring malformed %s=%r", name, raw)
        return float(default)


_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def env_bool(name: str, default: bool) -> bool:
    """1/true/yes/on or 0/false/no/off; missing, empty or malformed: the
    default (malformed with a warning)."""
    raw = (os.environ.get(name) or "").strip().lower()
    if not raw:
        return default
    if raw in _TRUTHY:
        return True
    if raw in _FALSY:
        return False
    log.warning("ignoring malformed %s=%r", name, raw)
    return default


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
