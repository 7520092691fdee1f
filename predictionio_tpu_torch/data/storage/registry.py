"""Storage: the repositories a DASE stage reads and writes through.

Counterpart of the JAX package's ``data/storage/registry.py`` (reference
Storage.scala:114-403): sources come from ``PIO_STORAGE_SOURCES_<NAME>_TYPE``
(and ``PIO_STORAGE_SOURCES_<NAME>_<KEY>`` settings), repositories from
``PIO_STORAGE_REPOSITORIES_<REPO>_SOURCE`` for METADATA, EVENTDATA and
MODELDATA, the same variables as the JAX package's. With none set, the
development wiring: sqlite metadata and events in
``$PIO_FS_BASEDIR/pio.db`` and model files under ``$PIO_FS_BASEDIR``
(default ``~/.pio_store``). The port's backends are memory, sqlite,
localfs, remote (every DAO through a storage daemon,
``data/api/storage_server.py``; its ``HOST``, ``PORT``, ``AUTH_KEY`` and
``TIMEOUT`` settings), segmentfs (columnar events only; ``PATH`` and
the seal settings), segmentfs-replica (a segmentfs follower fed by a
primary's shipper, ``data/storage/replication.py``), sharded (events
over N storage daemons by entity hash, ``data/storage/sharded.py``;
``SHARDS``, ``REPLICAS``, ``ALLOW_PARTIAL``, ``RETRIES``,
``HEDGED_READS``; EVENTDATA only) and docfs (JSON metadata documents
and model files; ``PATH``); a repository resolves to the backend's DAO,
with one client a source where the backend has clients (sqlite's
connection, remote's ``CLIENT_FACTORY``). ``Storage.get_instance`` and
``set_instance`` hold the process's Storage; ``verify_all_data_objects``
is the storage self-check of ``console status`` (reference
Storage.verifyAllDataObjects:335): every DAO, each shard's health, and
a write/read/delete probe event.
"""

from __future__ import annotations

import importlib
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import StorageError
from predictionio_tpu_torch.utils.env import env_path

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")

# backend type → (module, DAO class prefix)
BACKENDS: dict[str, tuple[str, str]] = {
    "memory": ("predictionio_tpu_torch.data.storage.memory", "Memory"),
    "sqlite": ("predictionio_tpu_torch.data.storage.sqlite", "Sqlite"),
    "localfs": ("predictionio_tpu_torch.data.storage.localfs", "LocalFS"),
    # every DAO proxied to a storage daemon (the reference's JDBC client
    # role, Storage.scala:140-142)
    "remote": ("predictionio_tpu_torch.data.storage.remote", "Remote"),
    # metadata as JSON documents (the reference's Elasticsearch role)
    "docfs": ("predictionio_tpu_torch.data.storage.docfs", "DocFS"),
    # columnar events: an fsync'd WAL sealed into column segments;
    # EVENTDATA only, paired with another source for metadata
    "segmentfs": ("predictionio_tpu_torch.data.storage.segmentfs", "SegmentFS"),
    # a segmentfs follower: read-only, fed by a primary's shipper over the
    # storage daemon's transport, promotable by a fenced election;
    # EVENTDATA only
    "segmentfs-replica": ("predictionio_tpu_torch.data.storage.replication", "Replica"),
    # events over N storage daemons, routed by entity hash (the
    # reference's HBase region-server role); EVENTDATA only
    "sharded": ("predictionio_tpu_torch.data.storage.sharded", "Sharded"),
}

# DAO → class suffix
_DAO_SUFFIXES = {
    "events": "EventStore",
    "apps": "Apps",
    "access_keys": "AccessKeys",
    "channels": "Channels",
    "engine_instances": "EngineInstances",
    "evaluation_instances": "EvaluationInstances",
    "engine_manifests": "EngineManifests",
    "models": "Models",
}


@dataclass
class SourceConfig:
    name: str
    type: str
    settings: dict[str, str] = field(default_factory=dict)


@dataclass
class StorageConfig:
    """Named sources and the repository → source mapping."""

    sources: dict[str, SourceConfig] = field(default_factory=dict)
    repositories: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def from_env(env: Optional[dict[str, str]] = None) -> "StorageConfig":
        """Parse the PIO_STORAGE_* variables (reference Storage.scala:124-193)."""
        env = dict(env if env is not None else os.environ)
        cfg = StorageConfig()
        src_prefix = "PIO_STORAGE_SOURCES_"
        for key, val in env.items():
            if key.startswith(src_prefix) and key.endswith("_TYPE"):
                name = key[len(src_prefix):-len("_TYPE")]
                cfg.sources.setdefault(name, SourceConfig(name, val)).type = val
        for key, val in env.items():
            if not key.startswith(src_prefix):
                continue
            rest = key[len(src_prefix):]
            for name in cfg.sources:
                if rest.startswith(name + "_") and not rest.endswith("_TYPE"):
                    cfg.sources[name].settings[rest[len(name) + 1:]] = val
        for repo in REPOSITORIES:
            source = env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
            if source:
                cfg.repositories[repo] = source
        return cfg

    @staticmethod
    def default_dev(basedir: Optional[str] = None) -> "StorageConfig":
        """sqlite metadata and events plus localfs models under the base
        directory (the reference's pio-env.sh.template defaults)."""
        base_dir = basedir or env_path("PIO_FS_BASEDIR", "~/.pio_store")
        os.makedirs(base_dir, exist_ok=True)
        return StorageConfig(
            sources={
                "PIOSQLITE": SourceConfig(
                    "PIOSQLITE", "sqlite", {"PATH": os.path.join(base_dir, "pio.db")}
                ),
                "PIOFS": SourceConfig("PIOFS", "localfs", {"PATH": base_dir}),
            },
            repositories={"METADATA": "PIOSQLITE", "EVENTDATA": "PIOSQLITE",
                          "MODELDATA": "PIOFS"},
        )

    @staticmethod
    def memory() -> "StorageConfig":
        """Every repository in this process's memory."""
        return StorageConfig(
            sources={"MEM": SourceConfig("MEM", "memory")},
            repositories={repo: "MEM" for repo in REPOSITORIES},
        )


class Storage:
    """DAO factory bound to a StorageConfig: the environment's, else the
    development wiring."""

    _instance: Optional["Storage"] = None
    _instance_lock = threading.Lock()

    def __init__(self, config: Optional[StorageConfig] = None):
        if config is None:
            config = StorageConfig.from_env()
            if not config.repositories:
                config = StorageConfig.default_dev()
        self.config = config
        self._clients: dict[str, Any] = {}
        self._daos: dict[tuple[str, str], Any] = {}
        self._lock = threading.RLock()

    @classmethod
    def get_instance(cls) -> "Storage":
        """The process's Storage, made from the environment at the first
        call."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Storage()
            return cls._instance

    @classmethod
    def set_instance(cls, storage: Optional["Storage"]) -> None:
        with cls._instance_lock:
            cls._instance = storage

    def _source_for_repo(self, repo: str) -> SourceConfig:
        src_name = self.config.repositories.get(repo)
        if src_name is None:
            raise StorageError(
                f"repository {repo} is not configured "
                f"(set PIO_STORAGE_REPOSITORIES_{repo}_SOURCE)"
            )
        src = self.config.sources.get(src_name)
        if src is None:
            raise StorageError(f"storage source {src_name} is not configured")
        return src

    def _get_dao(self, repo: str, dao: str) -> Any:
        src = self._source_for_repo(repo)
        key = (src.name, dao)
        with self._lock:
            if key in self._daos:
                return self._daos[key]
            backend = BACKENDS.get(src.type)
            if backend is None:
                raise StorageError(
                    f"storage backend type {src.type!r} is not in the port "
                    f"(available: {sorted(BACKENDS)})"
                )
            module = importlib.import_module(backend[0])
            cls = getattr(module, backend[1] + _DAO_SUFFIXES[dao], None)
            if cls is None:
                raise StorageError(
                    f"backend {src.type!r} does not implement "
                    f"{_DAO_SUFFIXES[dao]} in the port"
                )
            kwargs: dict[str, Any] = {"config": dict(src.settings)}
            client_factory = (getattr(module, "CLIENT_FACTORY", None)
                              or getattr(module, "SqliteClient", None))
            if client_factory is not None:
                if src.name not in self._clients:
                    self._clients[src.name] = client_factory(dict(src.settings))
                kwargs["client"] = self._clients[src.name]
            self._daos[key] = cls(**kwargs)
            return self._daos[key]

    # -- repository getters (reference Storage.scala:360-391) --------------
    def get_events(self) -> base.EventStore:
        return self._get_dao("EVENTDATA", "events")

    def get_meta_data_apps(self) -> base.Apps:
        return self._get_dao("METADATA", "apps")

    def get_meta_data_access_keys(self) -> base.AccessKeys:
        return self._get_dao("METADATA", "access_keys")

    def get_meta_data_channels(self) -> base.Channels:
        return self._get_dao("METADATA", "channels")

    def get_meta_data_engine_instances(self) -> base.EngineInstances:
        return self._get_dao("METADATA", "engine_instances")

    def get_meta_data_evaluation_instances(self) -> base.EvaluationInstances:
        return self._get_dao("METADATA", "evaluation_instances")

    def get_meta_data_engine_manifests(self) -> base.EngineManifests:
        return self._get_dao("METADATA", "engine_manifests")

    def get_model_data_models(self) -> base.Models:
        return self._get_dao("MODELDATA", "models")

    # -- the self-check (reference Storage.verifyAllDataObjects:335) ---------
    def verify_all_data_objects(self) -> list[str]:
        """Touch every DAO, ping every shard of a sharded event store, and
        write, read and delete a probe event in app 0. Returns one line a
        check; raises a StorageError naming the down shards (with every
        line so far) or a failed probe."""
        results = []
        for getter in (
            self.get_meta_data_apps,
            self.get_meta_data_access_keys,
            self.get_meta_data_channels,
            self.get_meta_data_engine_instances,
            self.get_meta_data_evaluation_instances,
            self.get_meta_data_engine_manifests,
            self.get_model_data_models,
        ):
            results.append(f"OK {type(getter()).__name__}")
        events = self.get_events()
        if hasattr(events, "health"):
            down = []
            for h in events.health():
                line = f"{'OK' if h['alive'] else 'DOWN'} shard {h['shard']} @ {h['address']}"
                if h["error"]:
                    line += f" — {h['error']}"
                results.append(line)
                if not h["alive"]:
                    down.append(f"{h['shard']} ({h['address']})")
            if down:
                # the raise drops `results`: the operator needs these lines
                raise StorageError("event store shards down: " + ", ".join(down)
                                   + "\n" + "\n".join(f"  {r}" for r in results))
        events.init_app(0)
        from predictionio_tpu_torch.data.event import Event

        eid = events.insert(Event(event="$set", entity_type="storage_probe",
                                  entity_id="0", properties={"probe": True}), 0)
        if events.get(eid, 0) is None:
            raise StorageError("event store probe write/read failed")
        events.delete(eid, 0)
        events.remove_app(0)
        results.append(f"OK {type(events).__name__} (write/read/delete probe)")
        return results
