"""Storage: the repositories a DASE stage reads through.

Counterpart of the JAX package's ``data/storage/registry.py``, cut to the
in-memory source: events and app metadata. The configured backends
(sqlite, localfs, segment files, the storage daemon) are not ported.
"""

from __future__ import annotations

from predictionio_tpu_torch.data.storage.memory import MemoryApps, MemoryEventStore


class Storage:
    def __init__(self):
        self._events = MemoryEventStore()
        self._apps = MemoryApps()

    def get_events(self) -> MemoryEventStore:
        return self._events

    def get_meta_data_apps(self) -> MemoryApps:
        return self._apps
