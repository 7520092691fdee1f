"""Carry trained ALS weights from the JAX package into the port.

The JAX package persists a deployed model as a pickle of its own
classes; unpickling that would import the JAX package. The carry-across
format is therefore its npz factor blob (``ALSFactors.to_bytes``),
which holds only arrays, id vocabularies and the parameters as JSON —
or the arrays themselves.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from predictionio_tpu_torch.data.store.bimap import BiMap
from predictionio_tpu_torch.models.als import ALSFactors, ALSParams


def als_factors_from_numpy(
    user_factors, item_factors, user_ids, item_ids, params: dict
) -> ALSFactors:
    """Factor matrices (rows in id order) and the JAX package's
    ``ALSParams`` as a dict → the port's ``ALSFactors``. Unknown
    parameter names raise."""
    uf = np.ascontiguousarray(user_factors, np.float32)
    itf = np.ascontiguousarray(item_factors, np.float32)
    user_ids, item_ids = list(user_ids), list(item_ids)
    if uf.ndim != 2 or itf.ndim != 2 or uf.shape[1] != itf.shape[1]:
        raise ValueError(
            f"need (U, K) and (I, K) factors, got {uf.shape} and {itf.shape}"
        )
    if len(user_ids) != uf.shape[0] or len(item_ids) != itf.shape[0]:
        raise ValueError("one id per factor row is required")
    names = {f.name for f in dataclasses.fields(ALSParams)}
    unknown = set(params) - names
    if unknown:
        raise ValueError(f"unknown ALS params: {sorted(unknown)}")
    return ALSFactors(
        user_factors=uf,
        item_factors=itf,
        user_vocab=BiMap({u: n for n, u in enumerate(user_ids)}),
        item_vocab=BiMap({i: n for n, i in enumerate(item_ids)}),
        params=ALSParams(**params),
    )


def load_jax_als_blob(data: bytes) -> ALSFactors:
    """Read the bytes of the JAX package's ``ALSFactors.to_bytes()``."""
    return ALSFactors.from_bytes(data)
