"""DataView: the training read's EventFrame cached on disk, keyed by the
query and the store's data signature.

Counterpart of the JAX package's ``data/view.py`` (reference
DataView.scala:37-110: events to a DataFrame cached as parquet under a
hash of the time range, version and schema). ``find_frame`` takes the
facade's ``find_frame`` arguments; the key hashes the query's shape
(app and channel, time range, entity and event filters, value column)
with ``data_signature``, which changes at every insert and delete of
the namespace, so a hit is the frame the store would give now. A miss
folds the store once, writes ``frame_<query>_<signature>.npz``
atomically and evicts the same query's older versions. ``stats``
counts hits and misses in the process. A segment-backed store (one
with ``find_frame_parts``, segmentfs) keeps its own cache of the sealed
rows under the segment ids and folds only the unsealed tail a read, so
the view delegates to it, writes no npz file and counts the store's hit
or miss in ``stats``.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import logging
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.store.bimap import BiMap
from predictionio_tpu_torch.data.store.columnar import EventFrame
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade
from predictionio_tpu_torch.utils.env import env_path

log = logging.getLogger(__name__)


def default_view_dir() -> str:
    """``$PIO_FS_BASEDIR/view``."""
    return os.path.join(env_path("PIO_FS_BASEDIR", "~/.pio_store"), "view")


def _iso(t: Optional[_dt.datetime]) -> Optional[str]:
    return t.isoformat() if t is not None else None


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _from_json_bytes(arr: np.ndarray):
    return json.loads(bytes(arr.tobytes()).decode())


def _save_frame(path: str, frame: EventFrame) -> None:
    """The frame as a compressed npz, published by an atomic rename from a
    temporary file of its own (concurrent writers never interleave)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez_compressed(
            f,
            event_code=frame.event_code,
            entity_idx=frame.entity_idx,
            target_idx=frame.target_idx,
            time_ms=frame.time_ms,
            value=frame.value,
            event_vocab=_json_bytes(list(frame.event_vocab.to_dict().items())),
            entity_vocab=_json_bytes(list(frame.entity_vocab.to_dict().items())),
            target_vocab=_json_bytes(list(frame.target_vocab.to_dict().items())),
            meta=_json_bytes({"entity_type": frame.entity_type,
                              "target_entity_type": frame.target_entity_type}),
        )
    os.replace(tmp, path)


def _load_frame(path: str) -> EventFrame:
    with np.load(path) as z:
        meta = _from_json_bytes(z["meta"])
        return EventFrame(
            event_code=z["event_code"],
            entity_idx=z["entity_idx"],
            target_idx=z["target_idx"],
            time_ms=z["time_ms"],
            value=z["value"],
            event_vocab=BiMap(dict(_from_json_bytes(z["event_vocab"]))),
            entity_vocab=BiMap(dict(_from_json_bytes(z["entity_vocab"]))),
            target_vocab=BiMap(dict(_from_json_bytes(z["target_vocab"]))),
            entity_type=meta["entity_type"],
            target_entity_type=meta["target_entity_type"],
        )


class DataView:
    """A cached ``find_frame`` over any ported store, under `view_dir`
    (``$PIO_FS_BASEDIR/view`` by default)."""

    stats = {"hits": 0, "misses": 0}

    def __init__(self, view_dir: Optional[str] = None):
        self.view_dir = view_dir or default_view_dir()

    def find_frame(
        self,
        storage,
        app_name: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        value_prop: Optional[str] = None,
        default_value: float = 1.0,
    ) -> EventFrame:
        """The frame `EventStoreFacade.find_frame` gives for these
        arguments: loaded from the cache on a hit, else read, cached and
        returned."""
        facade = EventStoreFacade(storage)
        app_id, channel_id = facade.app_name_to_id(app_name, channel_name)
        store = storage.get_events()
        frame_kwargs = dict(
            app_name=app_name, channel_name=channel_name,
            event_names=event_names, entity_type=entity_type,
            target_entity_type=target_entity_type, start_time=start_time,
            until_time=until_time, value_prop=value_prop,
            default_value=default_value,
        )
        if hasattr(store, "find_frame_parts"):
            # a second layer of npz files over the store's own cache
            # would rewrite the whole frame at every retrain and save no
            # read
            before = store.frame_cache_stats["hits"]
            frame = facade.find_frame(**frame_kwargs)
            hit = store.frame_cache_stats["hits"] > before
            DataView.stats["hits" if hit else "misses"] += 1
            log.info("DataView segment-cache %s: %d events",
                     "hit" if hit else "miss", len(frame))
            return frame
        signature = store.data_signature(app_id, channel_id)
        query_key = hashlib.sha1(json.dumps({
            "app_id": app_id,
            "channel_id": channel_id,
            "event_names": sorted(event_names) if event_names else None,
            "entity_type": entity_type,
            "target_entity_type": target_entity_type,
            "start": _iso(start_time),
            "until": _iso(until_time),
            "value_prop": value_prop,
            "default": default_value,
        }, sort_keys=True).encode()).hexdigest()[:20]
        sig_key = hashlib.sha1(signature.encode()).hexdigest()[:16]
        # query hash + signature hash: a query's superseded versions are
        # found by their prefix and evicted
        key = f"{query_key}_{sig_key}"
        path = os.path.join(self.view_dir, f"frame_{key}.npz")
        if os.path.exists(path):
            try:
                frame = _load_frame(path)
            except (OSError, ValueError, KeyError):
                log.exception("DataView cache %s unreadable; reading the store", path)
            else:
                DataView.stats["hits"] += 1
                log.info("DataView hit: %s (%d events)", key[:12], len(frame))
                return frame
        DataView.stats["misses"] += 1
        frame = facade.find_frame(**frame_kwargs)
        try:
            os.makedirs(self.view_dir, exist_ok=True)
            _save_frame(path, frame)
        except OSError:
            log.exception("DataView cache write failed (continuing uncached)")
            return frame
        for name in os.listdir(self.view_dir):
            if name.startswith(f"frame_{query_key}_") and name != os.path.basename(path):
                try:
                    os.unlink(os.path.join(self.view_dir, name))
                except OSError:
                    pass
        return frame
