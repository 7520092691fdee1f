"""BiMap — immutable bidirectional map for entity-id ↔ dense-index
translation (reference data/.../storage/BiMap.scala:25-164).

The dense integer side is what feeds device arrays: string entity ids are
interned to contiguous int32 indices so factor matrices row-align with them.
"""

from __future__ import annotations

from collections.abc import Sized
from itertools import repeat
from typing import Generic, Hashable, Iterable, Iterator, Mapping, Optional, TypeVar

import numpy as np

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class BiMap(Generic[K, V]):
    __slots__ = ("_fwd", "_rev")

    def __init__(self, forward: Mapping[K, V], _rev: Optional[dict] = None):
        self._fwd = dict(forward)
        if _rev is not None:
            self._rev = _rev
        else:
            self._rev = {v: k for k, v in self._fwd.items()}
            if len(self._rev) != len(self._fwd):
                raise ValueError("BiMap values must be unique")

    def __call__(self, key: K) -> V:
        return self._fwd[key]

    def get(self, key: K, default=None):
        return self._fwd.get(key, default)

    def contains(self, key: K) -> bool:
        return key in self._fwd

    __contains__ = contains

    def inverse(self) -> "BiMap[V, K]":
        return BiMap(self._rev, _rev=self._fwd)

    def take(self, keys: Iterable[K]) -> "BiMap[K, V]":
        return BiMap({k: self._fwd[k] for k in keys if k in self._fwd})

    def to_dict(self) -> dict[K, V]:
        return dict(self._fwd)

    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self) -> Iterator[K]:
        return iter(self._fwd)

    def items(self):
        return self._fwd.items()

    def __eq__(self, other):
        return isinstance(other, BiMap) and self._fwd == other._fwd

    def __repr__(self):
        return f"BiMap({len(self)} entries)"

    # -- index builders (reference BiMap.stringLong/stringInt:~110) --------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Build string → dense contiguous int index (first-seen order,
        duplicates collapsed)."""
        return BiMap.dense(dict.fromkeys(keys))

    string_long = string_int  # parity alias

    @staticmethod
    def dense(keys: Iterable[K]) -> "BiMap[K, int]":
        """Distinct keys → 0, 1, 2, ... in the order given (the interning
        of `string_int` once the duplicates are gone; C-level dict builds,
        no per-key Python step)."""
        keys = list(keys)
        n = range(len(keys))
        return BiMap(dict(zip(keys, n)), _rev=dict(zip(n, keys)))

    def map_array(self, keys: Iterable[str]) -> np.ndarray:
        """Vectorized translate: iterable of keys → int32 array (-1 if absent)."""
        count = len(keys) if isinstance(keys, Sized) else -1
        return np.fromiter(map(self._fwd.get, keys, repeat(-1)), dtype=np.int32,
                           count=count)

