"""Wire codec of the client-server storage protocol.

Counterpart of the JAX package's ``data/storage/wire.py``, tag for tag,
so that either package's client talks to the other's daemon: tagged
JSON for every value that crosses the storage RPC boundary, which are
events (with datetimes to the microsecond), queries (with the keyset
cursor and the shard filter), the seven metadata record types, model
blobs, datetimes and bytes. The protocol takes the role of the
reference's JDBC/HBase client stacks (data/.../storage/jdbc/
JDBCLEvents.scala:34, hbase/HBEventsUtil.scala:47): the Event Server,
the deploy server, train and the operator servers share one app's
state through one storage daemon. Standard library only.
"""

from __future__ import annotations

import base64
import datetime as _dt
from typing import Any

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    EventQuery,
    Model,
)


def _enc_dt(d: _dt.datetime) -> str:
    if d.tzinfo is None:
        d = d.replace(tzinfo=_dt.timezone.utc)
    return d.astimezone(_dt.timezone.utc).isoformat()


def _dec_dt(s: str) -> _dt.datetime:
    return _dt.datetime.fromisoformat(s)


def encode(obj: Any) -> Any:
    """Python value → JSON-safe tagged value."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, _dt.datetime):
        return {"$dt": _enc_dt(obj)}
    if isinstance(obj, (bytes, bytearray)):
        return {"$b64": base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, (list, tuple)):
        return {"$list": [encode(v) for v in obj]}
    if isinstance(obj, dict):
        return {"$dict": {str(k): encode(v) for k, v in obj.items()}}
    if isinstance(obj, Event):
        # datetimes to the microsecond: the public JSON form truncates to
        # milliseconds, but a time-window filter or a keyset cursor read
        # through the daemon must match the embedded stores' order
        d = obj.to_json_dict(with_id=True)
        d["eventTime"] = _enc_dt(obj.event_time)
        d["creationTime"] = _enc_dt(obj.creation_time)
        return {"$event": d}
    if isinstance(obj, EventQuery):
        return {
            "$query": {
                "app_id": obj.app_id,
                "channel_id": obj.channel_id,
                "start_time": encode(obj.start_time),
                "until_time": encode(obj.until_time),
                "entity_type": obj.entity_type,
                "entity_id": obj.entity_id,
                "event_names": (
                    list(obj.event_names) if obj.event_names is not None else None
                ),
                "target_entity_type": obj.target_entity_type,
                "target_entity_id": obj.target_entity_id,
                "limit": obj.limit,
                "reversed": obj.reversed,
                "filter_target_absent": obj.filter_target_absent,
                "shard": list(obj.shard) if obj.shard is not None else None,
                "start_after": (
                    [_enc_dt(obj.start_after[0]), obj.start_after[1]]
                    if obj.start_after is not None
                    else None
                ),
            }
        }
    if isinstance(obj, App):
        return {"$app": {"id": obj.id, "name": obj.name,
                         "description": obj.description}}
    if isinstance(obj, AccessKey):
        return {"$accesskey": {"key": obj.key, "app_id": obj.app_id,
                               "events": list(obj.events)}}
    if isinstance(obj, Channel):
        return {"$channel": {"id": obj.id, "name": obj.name,
                             "app_id": obj.app_id}}
    if isinstance(obj, EngineInstance):
        return {"$enginst": {
            "id": obj.id, "status": obj.status,
            "start_time": _enc_dt(obj.start_time),
            "end_time": _enc_dt(obj.end_time),
            "engine_id": obj.engine_id,
            "engine_version": obj.engine_version,
            "engine_variant": obj.engine_variant,
            "engine_factory": obj.engine_factory,
            "batch": obj.batch, "env": dict(obj.env),
            "mesh_conf": obj.mesh_conf,
            "data_source_params": obj.data_source_params,
            "preparator_params": obj.preparator_params,
            "algorithms_params": obj.algorithms_params,
            "serving_params": obj.serving_params,
        }}
    if isinstance(obj, EvaluationInstance):
        return {"$evalinst": {
            "id": obj.id, "status": obj.status,
            "start_time": _enc_dt(obj.start_time),
            "end_time": _enc_dt(obj.end_time),
            "evaluation_class": obj.evaluation_class,
            "engine_params_generator_class": obj.engine_params_generator_class,
            "batch": obj.batch, "env": dict(obj.env),
            "evaluator_results": obj.evaluator_results,
            "evaluator_results_html": obj.evaluator_results_html,
            "evaluator_results_json": obj.evaluator_results_json,
        }}
    if isinstance(obj, EngineManifest):
        return {"$manifest": {
            "id": obj.id, "version": obj.version, "name": obj.name,
            "description": obj.description, "files": list(obj.files),
            "engine_factory": obj.engine_factory,
        }}
    if isinstance(obj, Model):
        return {"$model": {
            "id": obj.id,
            "models": base64.b64encode(obj.models).decode("ascii"),
        }}
    raise TypeError(f"cannot encode {type(obj).__name__} for storage RPC")


def decode(obj: Any) -> Any:
    """JSON-safe tagged value → Python value."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):  # a plain JSON list (top-level arguments)
        return [decode(v) for v in obj]
    if not isinstance(obj, dict):
        raise TypeError(f"cannot decode {type(obj).__name__}")
    if len(obj) == 1:
        (tag, val), = obj.items()
        if tag == "$dt":
            return _dec_dt(val)
        if tag == "$b64":
            return base64.b64decode(val)
        if tag == "$list":
            return [decode(v) for v in val]
        if tag == "$dict":
            return {k: decode(v) for k, v in val.items()}
        if tag == "$event":
            return Event.from_json_dict(val)
        if tag == "$query":
            return EventQuery(
                app_id=val["app_id"],
                channel_id=val["channel_id"],
                start_time=decode(val["start_time"]),
                until_time=decode(val["until_time"]),
                entity_type=val["entity_type"],
                entity_id=val["entity_id"],
                event_names=val["event_names"],
                target_entity_type=val["target_entity_type"],
                target_entity_id=val["target_entity_id"],
                limit=val["limit"],
                reversed=val["reversed"],
                filter_target_absent=val["filter_target_absent"],
                shard=(tuple(val["shard"]) if val.get("shard") is not None
                       else None),
                start_after=(
                    (_dec_dt(val["start_after"][0]), val["start_after"][1])
                    if val.get("start_after") is not None
                    else None
                ),
            )
        if tag == "$app":
            return App(**val)
        if tag == "$accesskey":
            return AccessKey(
                key=val["key"], app_id=val["app_id"],
                events=tuple(val["events"]),
            )
        if tag == "$channel":
            return Channel(**val)
        if tag == "$enginst":
            val = dict(val)
            val["start_time"] = _dec_dt(val["start_time"])
            val["end_time"] = _dec_dt(val["end_time"])
            return EngineInstance(**val)
        if tag == "$evalinst":
            val = dict(val)
            val["start_time"] = _dec_dt(val["start_time"])
            val["end_time"] = _dec_dt(val["end_time"])
            return EvaluationInstance(**val)
        if tag == "$manifest":
            val = dict(val)
            val["files"] = tuple(val["files"])
            return EngineManifest(**val)
        if tag == "$model":
            return Model(id=val["id"], models=base64.b64decode(val["models"]))
    raise TypeError(f"cannot decode tagged value {list(obj)[:1]}")
