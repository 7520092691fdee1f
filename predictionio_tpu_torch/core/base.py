"""The runtime handle every DASE stage gets from its caller.

Counterpart of the JAX package's ``core.base.RuntimeContext``. The port's
carries the storage to read events from, the mode, and the device to
train and serve on (None means the first CUDA device); the JAX mesh, the
workflow parameters and the stage timings are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class RuntimeContext:
    storage: Any = None  # data.storage.registry.Storage
    mode: str = "train"  # train | eval | serve
    device: Optional[str] = None
