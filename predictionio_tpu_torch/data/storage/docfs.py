"""docfs: a metadata store of JSON documents on a filesystem.

Counterpart of the JAX package's ``data/storage/docfs.py`` (the
reference's Elasticsearch metadata role: elasticsearch/ESApps.scala:127,
ESAccessKeys:116, ESChannels:114, ESEngineInstances:155,
ESEngineManifests, ESEvaluationInstances:133, ESSequences), with the
same documents byte for byte, so that a directory written by either
package is read by the other. Each row is one JSON document in its
index's directory, named by the hex of its id; auto-increment ids come
from a counter document (the ESSequences role) made race-free by an
exclusive create of the row document (``put_new``: a temporary file
hard-linked into place), which holds across processes sharing the
directory; writes are atomic (temporary file + rename). Model blobs
are sibling binary files. With segmentfs events it makes a storage with
no sqlite file: the reference's split of HBase events from separate
metadata.

Configure with
  PIO_STORAGE_SOURCES_<NAME>_TYPE=docfs
  PIO_STORAGE_SOURCES_<NAME>_PATH=/var/pio/meta
and point PIO_STORAGE_REPOSITORIES_METADATA_SOURCE (and MODELDATA, if
the models go there too) at it. Without PATH: ``$PIO_FS_BASEDIR/docfs``.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import secrets
import tempfile
import threading
from typing import Any, Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    Model,
    StorageError,
)
from predictionio_tpu_torch.utils.env import env_path

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _ms(dt: _dt.datetime) -> int:
    return int(dt.timestamp() * 1000)


def _from_ms(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc)


class _DocFSClient:
    """Shared per-source root directory + lock (the ES TransportClient
    role)."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.root = config.get(
            "PATH",
            os.path.join(env_path("PIO_FS_BASEDIR", "~/.pio_store"), "docfs"),
        )
        os.makedirs(self.root, exist_ok=True)
        self.lock = threading.RLock()

    def index_dir(self, index: str) -> str:
        d = os.path.join(self.root, index)
        os.makedirs(d, exist_ok=True)
        return d


def CLIENT_FACTORY(config: dict[str, str]) -> _DocFSClient:
    return _DocFSClient(config)


def _doc_name(doc_id: str) -> str:
    # ids may contain path-hostile characters; hex keeps one file per doc
    return doc_id.encode().hex() + ".json"


class _DocIndex:
    """One 'index' (directory) of JSON documents keyed by id string."""

    def __init__(self, client: _DocFSClient, index: str):
        self._client = client
        self._dir = client.index_dir(index)

    def put(self, doc_id: str, doc: dict) -> None:
        with self._client.lock:
            fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, separators=(",", ":"))
            os.replace(tmp, os.path.join(self._dir, _doc_name(doc_id)))

    def put_new(self, doc_id: str, doc: dict) -> bool:
        """Atomic create-if-absent (tempfile + hard link): the filesystem
        arbitrates uniqueness, so it holds across PROCESSES sharing the
        directory — the in-process lock alone could not. False when the
        document already exists."""
        with self._client.lock:
            fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, separators=(",", ":"))
            try:
                os.link(tmp, os.path.join(self._dir, _doc_name(doc_id)))
                return True
            except FileExistsError:
                return False
            finally:
                os.unlink(tmp)

    def get(self, doc_id: str) -> Optional[dict]:
        path = os.path.join(self._dir, _doc_name(doc_id))
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def delete(self, doc_id: str) -> bool:
        try:
            os.unlink(os.path.join(self._dir, _doc_name(doc_id)))
            return True
        except FileNotFoundError:
            return False

    def all(self) -> list[dict]:
        out = []
        with self._client.lock:
            for name in sorted(os.listdir(self._dir)):
                if not name.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(self._dir, name)) as f:
                        out.append(json.load(f))
                except (OSError, json.JSONDecodeError):
                    continue  # torn/alien file: skip, never crash listings
        return out

    def allocate_id(self, make_doc) -> int:
        """ESSequences role, made race-free: the counter document is only a
        HINT; the authoritative allocation is the exclusive create of the
        row document itself (put_new), so concurrent processes — or an
        auto-id racing a previously explicit id — can never overwrite an
        existing row. `make_doc(doc_id)` builds the document to publish."""
        with self._client.lock:
            counter = self.get("__seq__") or {"n": 0}
            cand = int(counter["n"]) + 1
            while not self.put_new(str(cand), make_doc(cand)):
                cand += 1
            if cand > counter["n"]:
                self.put("__seq__", {"n": cand})
            return cand


class _DocMetaBase:
    INDEX = ""

    def __init__(self, config: Optional[dict] = None, client: Optional[_DocFSClient] = None):
        self._client = client or _DocFSClient(config)
        self._index = _DocIndex(self._client, self.INDEX)

    def _docs(self) -> list[dict]:
        return [
            d for d in self._index.all() if d.get("__kind__") == self.INDEX
        ]


class DocFSApps(_DocMetaBase, base.Apps):
    INDEX = "apps"

    def _doc(self, app: App) -> dict:
        return {"__kind__": self.INDEX, "id": app.id, "name": app.name,
                "description": app.description}

    def insert(self, app: App) -> Optional[int]:
        with self._client.lock:
            # name uniqueness arbitrated by an exclusive reservation doc
            # (holds across processes); rolled back if the row can't land
            name_key = "name_" + app.name.encode().hex()
            if not self._index.put_new(name_key, {"name": app.name}):
                return None
            if app.id > 0:
                ok = self._index.put_new(str(app.id), self._doc(app))
                if not ok:
                    self._index.delete(name_key)
                    return None
                return app.id
            return self._index.allocate_id(
                lambda i: self._doc(App(i, app.name, app.description))
            )

    def get(self, app_id: int) -> Optional[App]:
        d = self._index.get(str(app_id))
        return App(d["id"], d["name"], d.get("description")) if d else None

    def get_by_name(self, name: str) -> Optional[App]:
        for d in self._docs():
            if d["name"] == name:
                return App(d["id"], d["name"], d.get("description"))
        return None

    def get_all(self) -> list[App]:
        return [
            App(d["id"], d["name"], d.get("description")) for d in self._docs()
        ]

    def update(self, app: App) -> bool:
        with self._client.lock:
            old = self._index.get(str(app.id))
            if old is None:
                return False
            if old["name"] != app.name:  # move the name reservation
                if not self._index.put_new(
                    "name_" + app.name.encode().hex(), {"name": app.name}
                ):
                    return False
                self._index.delete("name_" + old["name"].encode().hex())
            self._index.put(str(app.id), self._doc(app))
            return True

    def delete(self, app_id: int) -> bool:
        with self._client.lock:
            d = self._index.get(str(app_id))
            if d is not None:
                self._index.delete("name_" + d["name"].encode().hex())
            return self._index.delete(str(app_id))


class DocFSAccessKeys(_DocMetaBase, base.AccessKeys):
    INDEX = "accesskeys"

    def _doc(self, k: AccessKey) -> dict:
        return {"__kind__": self.INDEX, "key": k.key, "app_id": k.app_id,
                "events": list(k.events)}

    @staticmethod
    def _from(d: dict) -> AccessKey:
        return AccessKey(d["key"], d["app_id"], tuple(d.get("events") or ()))

    def insert(self, k: AccessKey) -> Optional[str]:
        key = k.key or secrets.token_urlsafe(32)
        with self._client.lock:
            if not self._index.put_new(
                key, self._doc(AccessKey(key, k.app_id, k.events))
            ):
                return None
            return key

    def get(self, key: str) -> Optional[AccessKey]:
        d = self._index.get(key)
        return self._from(d) if d else None

    def get_all(self) -> list[AccessKey]:
        return [self._from(d) for d in self._docs()]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [self._from(d) for d in self._docs() if d["app_id"] == app_id]

    def update(self, k: AccessKey) -> bool:
        with self._client.lock:
            if self._index.get(k.key) is None:
                return False
            self._index.put(k.key, self._doc(k))
            return True

    def delete(self, key: str) -> bool:
        return self._index.delete(key)


class DocFSChannels(_DocMetaBase, base.Channels):
    INDEX = "channels"

    def insert(self, c: Channel) -> Optional[int]:
        if not Channel.is_valid_name(c.name):
            return None
        with self._client.lock:
            pair_key = "pair_" + f"{c.app_id}:{c.name}".encode().hex()
            if not self._index.put_new(
                pair_key, {"name": c.name, "app_id": c.app_id}
            ):
                return None
            return self._index.allocate_id(
                lambda i: {"__kind__": self.INDEX, "id": i, "name": c.name,
                           "app_id": c.app_id}
            )

    def get(self, channel_id: int) -> Optional[Channel]:
        d = self._index.get(str(channel_id))
        return Channel(d["id"], d["name"], d["app_id"]) if d else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [
            Channel(d["id"], d["name"], d["app_id"])
            for d in self._docs()
            if d["app_id"] == app_id
        ]

    def delete(self, channel_id: int) -> bool:
        with self._client.lock:
            d = self._index.get(str(channel_id))
            if d is not None:
                self._index.delete(
                    "pair_" + f"{d['app_id']}:{d['name']}".encode().hex()
                )
            return self._index.delete(str(channel_id))


class DocFSEngineInstances(_DocMetaBase, base.EngineInstances):
    INDEX = "engineinstances"

    def _doc(self, i: EngineInstance) -> dict:
        return {
            "__kind__": self.INDEX, "id": i.id, "status": i.status,
            "start_time": _ms(i.start_time), "end_time": _ms(i.end_time),
            "engine_id": i.engine_id, "engine_version": i.engine_version,
            "engine_variant": i.engine_variant,
            "engine_factory": i.engine_factory, "batch": i.batch,
            "env": dict(i.env), "mesh_conf": i.mesh_conf,
            "data_source_params": i.data_source_params,
            "preparator_params": i.preparator_params,
            "algorithms_params": i.algorithms_params,
            "serving_params": i.serving_params,
        }

    @staticmethod
    def _from(d: dict) -> EngineInstance:
        return EngineInstance(
            id=d["id"], status=d["status"],
            start_time=_from_ms(d["start_time"]),
            end_time=_from_ms(d["end_time"]), engine_id=d["engine_id"],
            engine_version=d["engine_version"],
            engine_variant=d["engine_variant"],
            engine_factory=d["engine_factory"], batch=d.get("batch", ""),
            env=d.get("env") or {}, mesh_conf=d.get("mesh_conf") or {},
            data_source_params=d.get("data_source_params", ""),
            preparator_params=d.get("preparator_params", ""),
            algorithms_params=d.get("algorithms_params", ""),
            serving_params=d.get("serving_params", ""),
        )

    def insert(self, i: EngineInstance) -> str:
        iid = i.id or f"ei_{secrets.token_hex(8)}"
        row = EngineInstance(**{**i.__dict__, "id": iid})
        self._index.put(iid, self._doc(row))
        return iid

    def get(self, iid: str) -> Optional[EngineInstance]:
        d = self._index.get(iid)
        return self._from(d) if d else None

    def get_all(self) -> list[EngineInstance]:
        return [self._from(d) for d in self._docs()]

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = [
            self._from(d)
            for d in self._docs()
            if d["status"] == "COMPLETED"
            and d["engine_id"] == engine_id
            and d["engine_version"] == engine_version
            and d["engine_variant"] == engine_variant
        ]
        rows.sort(key=lambda r: r.start_time, reverse=True)
        return rows

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def update(self, i: EngineInstance) -> bool:
        with self._client.lock:
            if self._index.get(i.id) is None:
                return False
            self._index.put(i.id, self._doc(i))
            return True

    def delete(self, iid: str) -> bool:
        return self._index.delete(iid)


class DocFSEvaluationInstances(_DocMetaBase, base.EvaluationInstances):
    INDEX = "evaluationinstances"

    def _doc(self, i: EvaluationInstance) -> dict:
        return {
            "__kind__": self.INDEX, "id": i.id, "status": i.status,
            "start_time": _ms(i.start_time), "end_time": _ms(i.end_time),
            "evaluation_class": i.evaluation_class,
            "engine_params_generator_class": i.engine_params_generator_class,
            "batch": i.batch, "env": dict(i.env),
            "evaluator_results": i.evaluator_results,
            "evaluator_results_html": i.evaluator_results_html,
            "evaluator_results_json": i.evaluator_results_json,
        }

    @staticmethod
    def _from(d: dict) -> EvaluationInstance:
        return EvaluationInstance(
            id=d["id"], status=d["status"],
            start_time=_from_ms(d["start_time"]),
            end_time=_from_ms(d["end_time"]),
            evaluation_class=d.get("evaluation_class", ""),
            engine_params_generator_class=d.get(
                "engine_params_generator_class", ""
            ),
            batch=d.get("batch", ""), env=d.get("env") or {},
            evaluator_results=d.get("evaluator_results", ""),
            evaluator_results_html=d.get("evaluator_results_html", ""),
            evaluator_results_json=d.get("evaluator_results_json", ""),
        )

    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or f"evi_{secrets.token_hex(8)}"
        row = EvaluationInstance(**{**i.__dict__, "id": iid})
        self._index.put(iid, self._doc(row))
        return iid

    def get(self, iid: str) -> Optional[EvaluationInstance]:
        d = self._index.get(iid)
        return self._from(d) if d else None

    def get_all(self) -> list[EvaluationInstance]:
        return [self._from(d) for d in self._docs()]

    def get_completed(self) -> list[EvaluationInstance]:
        rows = [
            self._from(d)
            for d in self._docs()
            if d["status"] == "EVALCOMPLETED"
        ]
        rows.sort(key=lambda r: r.start_time, reverse=True)
        return rows

    def update(self, i: EvaluationInstance) -> bool:
        with self._client.lock:
            if self._index.get(i.id) is None:
                return False
            self._index.put(i.id, self._doc(i))
            return True

    def delete(self, iid: str) -> bool:
        return self._index.delete(iid)


class DocFSEngineManifests(_DocMetaBase, base.EngineManifests):
    INDEX = "enginemanifests"

    def _key(self, mid: str, version: str) -> str:
        return f"{mid}@{version}"

    def _doc(self, m: EngineManifest) -> dict:
        return {
            "__kind__": self.INDEX, "id": m.id, "version": m.version,
            "name": m.name, "description": m.description,
            "files": list(m.files), "engine_factory": m.engine_factory,
        }

    @staticmethod
    def _from(d: dict) -> EngineManifest:
        return EngineManifest(
            id=d["id"], version=d["version"], name=d["name"],
            description=d.get("description"),
            files=tuple(d.get("files") or ()),
            engine_factory=d.get("engine_factory", ""),
        )

    def insert(self, m: EngineManifest) -> None:
        self._index.put(self._key(m.id, m.version), self._doc(m))

    def get(self, mid: str, version: str) -> Optional[EngineManifest]:
        d = self._index.get(self._key(mid, version))
        return self._from(d) if d else None

    def get_all(self) -> list[EngineManifest]:
        return [self._from(d) for d in self._docs()]

    def update(self, m: EngineManifest, upsert: bool = False) -> None:
        if not upsert and self.get(m.id, m.version) is None:
            raise StorageError(f"manifest {m.id} {m.version} not found")
        self.insert(m)

    def delete(self, mid: str, version: str) -> None:
        self._index.delete(self._key(mid, version))


class DocFSModels(_DocMetaBase, base.Models):
    """Model blobs as sibling binary files (ES stored blobs base64-inline;
    plain files avoid the 33% blowup)."""

    INDEX = "models"

    def insert(self, m: Model) -> None:
        with self._client.lock:
            d = self._client.index_dir(self.INDEX)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(m.models)
            os.replace(tmp, os.path.join(d, _doc_name(m.id) + ".bin"))

    def get(self, mid: str) -> Optional[Model]:
        path = os.path.join(
            self._client.index_dir(self.INDEX), _doc_name(mid) + ".bin"
        )
        try:
            with open(path, "rb") as f:
                return Model(mid, f.read())
        except FileNotFoundError:
            return None

    def delete(self, mid: str) -> None:
        try:
            os.unlink(
                os.path.join(
                    self._client.index_dir(self.INDEX), _doc_name(mid) + ".bin"
                )
            )
        except FileNotFoundError:
            pass
