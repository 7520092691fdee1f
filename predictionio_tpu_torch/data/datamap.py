"""DataMap / PropertyMap: typed JSON property bags attached to events.

Counterpart of the JAX package's ``data/datamap.py`` (reference
DataMap.scala:41-211, PropertyMap.scala:33-96): immutable wrappers over
plain JSON-compatible dicts with the same getters, combinators and
errors (``DataMapError``, a ``KeyError``, on a missing or null required
field and on a value of the wrong type).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Any, Callable, Iterator, Mapping, Optional, TypeVar

T = TypeVar("T")


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong type."""


def _parse_time(value: Any) -> _dt.datetime:
    """An ISO-8601 string, epoch milliseconds or a datetime, as an aware
    datetime (UTC when it names no zone)."""
    if isinstance(value, _dt.datetime):
        return value if value.tzinfo else value.replace(tzinfo=_dt.timezone.utc)
    if isinstance(value, (int, float)):
        return _dt.datetime.fromtimestamp(value / 1000.0, tz=_dt.timezone.utc)
    if isinstance(value, str):
        dt = _dt.datetime.fromisoformat(value.replace("Z", "+00:00"))
        return dt if dt.tzinfo else dt.replace(tzinfo=_dt.timezone.utc)
    raise DataMapError(f"cannot parse datetime from {value!r}")


def _bad(v: Any, t: type) -> Any:
    raise DataMapError(f"value {v!r} is not of type {t.__name__}")


def _number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


_CASTS: dict[type, Callable[[Any], Any]] = {
    int: lambda v: int(v) if _number(v) else _bad(v, int),
    float: lambda v: float(v) if _number(v) else _bad(v, float),
    str: lambda v: v if isinstance(v, str) else _bad(v, str),
    bool: lambda v: v if isinstance(v, bool) else _bad(v, bool),
    list: lambda v: v if isinstance(v, list) else _bad(v, list),
    dict: lambda v: v if isinstance(v, dict) else _bad(v, dict),
    _dt.datetime: _parse_time,
}


class DataMap(Mapping[str, Any]):
    """Immutable mapping of property name → JSON value with typed getters
    (reference DataMap.scala: `get[T]`, `getOpt[T]`, `getOrElse`, `++`,
    `--`, extraction into a class)."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_fields", dict(fields or {}))

    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(tuple(sorted(self._fields.items(), key=lambda kv: kv[0])))

    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")
        if self._fields[name] is None:
            raise DataMapError(f"The required field {name} cannot be null.")

    def get(self, name: str, as_type: type[T] = object) -> T:  # type: ignore[assignment]
        """The required field `name`, cast to `as_type` (any JSON value
        when `object`)."""
        self.require(name)
        value = self._fields[name]
        if as_type is object:
            return value
        cast = _CASTS.get(as_type)
        if cast is None:
            raise DataMapError(f"unsupported extraction type {as_type!r}")
        return cast(value)

    def get_opt(self, name: str, as_type: type[T] = object) -> Optional[T]:  # type: ignore[assignment]
        """None when the field is missing or null, else `get`."""
        if name not in self._fields or self._fields[name] is None:
            return None
        return self.get(name, as_type)

    def get_or_else(self, name: str, default: T, as_type: Optional[type] = None) -> T:
        got = self.get_opt(name, as_type or type(default))
        return default if got is None else got  # type: ignore[return-value]

    def get_list(self, name: str, of_type: type[T] = object) -> list[T]:  # type: ignore[assignment]
        raw = self.get(name, list)
        if of_type is object:
            return list(raw)
        cast = _CASTS[of_type]
        return [cast(v) for v in raw]

    def get_datetime(self, name: str) -> _dt.datetime:
        return self.get(name, _dt.datetime)

    def merge(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """`++`: `other`'s fields over these."""
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    __add__ = merge

    def remove(self, keys) -> "DataMap":
        """`--`: without the fields named in `keys`."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    __sub__ = remove

    def extract(self, cls: type[T]) -> T:
        """The fields as keyword arguments of `cls` (a dataclass takes only
        the fields it declares)."""
        if dataclasses.is_dataclass(cls):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in self._fields.items() if k in names})  # type: ignore[return-value]
        return cls(**self._fields)  # type: ignore[call-arg]

    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)

    @property
    def is_empty(self) -> bool:
        return not self._fields

    def keyset(self) -> set[str]:
        return set(self._fields)


class PropertyMap(DataMap):
    """A DataMap with its first and last update times: one entity's
    folded $set/$unset/$delete events (reference PropertyMap.scala:33)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]],
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        object.__setattr__(self, "first_updated", first_updated)
        object.__setattr__(self, "last_updated", last_updated)

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.to_dict()!r}, first_updated={self.first_updated},"
            f" last_updated={self.last_updated})"
        )

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self.to_dict() == other.to_dict()
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    __hash__ = DataMap.__hash__
