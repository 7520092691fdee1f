"""Environment knobs the port reads.

The port's own copy of the readers of the JAX package's ``utils/env.py``
that it needs: the dense-ALS gate (``PIO_DENSE_ALS`` and
``PIO_DENSE_ALS_BYTES``) and the storage base directory
(``PIO_FS_BASEDIR``). A missing or empty value gives the caller's
default; a malformed integer gives the default with a warning, as in
the JAX package.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)


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
