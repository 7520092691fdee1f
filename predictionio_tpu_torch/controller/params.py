"""Typed params and engine-factory resolution.

Counterpart of the JAX package's ``controller/params.py``: engine.json
names classes as import-path strings and carries per-stage params
objects; params are dataclasses validated on extraction (reference
WorkflowUtils.extractParams:132), and classes resolve through
`load_symbol` (reference WorkflowUtils.getEngine:62).

`load_symbol` refuses any path into the JAX package: an
``engineFactory`` copied from one of its engine.json files would
otherwise import the reference into the port's process. A params class
may list fields of its JAX counterpart that the port does not have yet
in a ``NOT_PORTED`` class attribute; naming one is an error that says so.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import json
import types as _types
import typing
from typing import Any, Optional

#: the JAX package's top-level name: the port never imports from it
REFERENCE_PACKAGE = "predictionio_tpu"


@dataclasses.dataclass(frozen=True)
class EmptyParams:
    """Reference controller package object `EmptyParams` (package.scala:105)."""


class ParamsError(ValueError):
    pass


def is_reference_module(name: str) -> bool:
    """True for the JAX package and its modules (not for this port,
    whose name only starts the same)."""
    return name == REFERENCE_PACKAGE or name.startswith(REFERENCE_PACKAGE + ".")


def load_symbol(path: str) -> Any:
    """Resolve "pkg.module.Symbol" (or "pkg.module:Symbol") to the object."""
    if ":" in path:
        mod_name, _, sym = path.partition(":")
    else:
        mod_name, _, sym = path.rpartition(".")
    if not mod_name:
        raise ParamsError(f"not an importable path: {path!r}")
    if is_reference_module(mod_name):
        raise ParamsError(
            f"{path!r} is in the JAX package ({REFERENCE_PACKAGE}); the "
            f"PyTorch port does not import it: name the port's class "
            f"(predictionio_tpu_torch.{mod_name[len(REFERENCE_PACKAGE) + 1:]}"
            f".{sym})"
        )
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise ParamsError(f"cannot import module {mod_name!r} for {path!r}: {e}")
    try:
        return getattr(mod, sym)
    except AttributeError:
        raise ParamsError(f"module {mod_name!r} has no symbol {sym!r}")


def params_class_of(cls: type) -> Optional[type]:
    """The params dataclass a controller class's constructor expects,
    from the first non-self parameter's annotation."""
    try:
        hints = typing.get_type_hints(cls.__init__)
        sig = inspect.signature(cls.__init__)
    except (TypeError, ValueError, NameError):
        return None
    for name, p in sig.parameters.items():
        if name == "self":
            continue
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY):
            ann = hints.get(name, p.annotation)
            if isinstance(ann, type) and dataclasses.is_dataclass(ann):
                return ann
        break
    return None


def extract_params(cls: Optional[type], obj: Any) -> Any:
    """Build a params dataclass from a JSON object, strictly: unknown keys
    are errors, missing keys take the dataclass defaults, and values must
    have the fields' JSON shapes."""
    if cls is None or cls is EmptyParams:
        if obj not in (None, {}, []):
            raise ParamsError(f"params given but no params class declared: {obj!r}")
        return EmptyParams()
    if obj is None:
        obj = {}
    if not isinstance(obj, dict):
        raise ParamsError(f"params for {cls.__name__} must be an object, got {obj!r}")
    if not dataclasses.is_dataclass(cls):
        raise ParamsError(f"params class {cls.__name__} must be a dataclass")
    names = {f.name for f in dataclasses.fields(cls)}
    not_ported = sorted(set(obj) & set(getattr(cls, "NOT_PORTED", ())))
    if not_ported:
        raise ParamsError(
            f"params {not_ported} of {cls.__name__} are not ported yet to "
            f"the PyTorch port; remove them from the variant"
        )
    unknown = set(obj) - names
    if unknown:
        raise ParamsError(
            f"unknown params for {cls.__name__}: {sorted(unknown)} "
            f"(valid: {sorted(names)})"
        )
    missing = [
        f.name
        for f in dataclasses.fields(cls)
        if f.name not in obj
        and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    ]
    if missing:
        raise ParamsError(f"missing required params for {cls.__name__}: {missing}")
    hints = _class_hints(cls)
    for key, val in obj.items():
        ann = hints.get(key)
        if ann is not None and not _value_matches(val, ann):
            raise ParamsError(
                f"param {key!r} of {cls.__name__} expects {_ann_name(ann)}, "
                f"got {type(val).__name__} ({val!r})"
            )
    try:
        return cls(**obj)
    except TypeError as e:
        raise ParamsError(f"invalid params for {cls.__name__}: {e}")


@functools.lru_cache(maxsize=256)
def _class_hints(cls: type) -> dict:
    try:
        return typing.get_type_hints(cls)
    except (TypeError, NameError):
        return {}


def _ann_name(ann: Any) -> str:
    return getattr(ann, "__name__", None) or str(ann)


def _value_matches(val: Any, ann: Any) -> bool:
    """Shallow JSON-shape check of a value against a field annotation.
    Unknown annotation forms pass."""
    origin = typing.get_origin(ann)
    if ann is Any or ann is inspect.Parameter.empty:
        return True
    if origin is typing.Union or origin is _types.UnionType:
        return any(_value_matches(val, a) for a in typing.get_args(ann))
    if ann is type(None):
        return val is None
    if origin in (list, tuple, set):
        if not isinstance(val, (list, tuple)):
            return False
        args = [a for a in typing.get_args(ann) if a is not Ellipsis]
        return all(_value_matches(v, args[0]) for v in val) if args else True
    if origin is dict:
        return isinstance(val, dict)
    if ann is float:
        return isinstance(val, (int, float)) and not isinstance(val, bool)
    if ann is int:
        return isinstance(val, int) and not isinstance(val, bool)
    if ann is bool:
        return isinstance(val, bool)
    if ann is str:
        return isinstance(val, str)
    if isinstance(ann, type) and dataclasses.is_dataclass(ann):
        return isinstance(val, (dict, ann))
    return True


def params_to_json(params: Any) -> str:
    """Serialize a params dataclass for the EngineInstance rows' per-stage
    params JSON (EngineInstances.scala:43)."""
    if params is None or isinstance(params, EmptyParams):
        return "{}"
    if dataclasses.is_dataclass(params):
        return json.dumps(dataclasses.asdict(params), sort_keys=True)
    return json.dumps(params, sort_keys=True)
