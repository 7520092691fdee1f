"""Mid-training checkpoints of the ALS factors in MODELDATA.

Counterpart of the JAX package's ``workflow/checkpoint.py``: a long ALS
train saves its factors every N iterations so that an interrupted train
resumes where it stopped. An ALS iteration is a function of the factors
and the fixed edge data alone, so k segments of m iterations, each
started from the factors the one before handed over, reproduce one run
of k·m iterations.

A checkpoint is the MODELDATA blob ``ckpt:<instance_id>``: a 4-byte
big-endian header length, the JSON header ``{"iteration": n}``, then
``ALSFactors.to_bytes()``. The layout is the JAX package's, so a
checkpoint that either package saved loads in the other.
"""

from __future__ import annotations

import io
import json
import logging
from dataclasses import replace
from typing import Any, Callable, Optional

import numpy as np

from predictionio_tpu_torch.data.storage.base import Model
from predictionio_tpu_torch.models import als

log = logging.getLogger(__name__)


class CheckpointManager:
    """One checkpoint slot per engine instance (the latest wins)."""

    def __init__(self, storage: Any, instance_id: str):
        if not instance_id:
            raise ValueError("checkpointing requires a non-empty instance id")
        self._models = storage.get_model_data_models()
        self._key = f"ckpt:{instance_id}"

    def save(self, iteration: int, payload: bytes) -> None:
        buf = io.BytesIO()
        header = json.dumps({"iteration": iteration}).encode()
        buf.write(len(header).to_bytes(4, "big"))
        buf.write(header)
        buf.write(payload)
        self._models.insert(Model(id=self._key, models=buf.getvalue()))
        log.info("checkpoint saved at iteration %d (%s)", iteration, self._key)

    def load(self) -> Optional[tuple[int, bytes]]:
        rec = self._models.get(self._key)
        if rec is None:
            return None
        data = rec.models
        hlen = int.from_bytes(data[:4], "big")
        header = json.loads(data[4:4 + hlen])
        return header["iteration"], data[4 + hlen:]

    def clear(self) -> None:
        self._models.delete(self._key)


def train_als_checkpointed(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_users: int,
    n_items: int,
    params: als.ALSParams,
    manager: Optional[CheckpointManager],
    checkpoint_every: int,
    on_segment: Optional[Callable[[int], None]] = None,
    **train_kwargs: Any,
):
    """ALS in segments of `checkpoint_every` iterations, each an
    ``als.train`` from the factors the one before returned, with a
    checkpoint after every segment but the last; resumes from the
    manager's checkpoint when there is one, and clears it at the end.
    `train_kwargs` go to ``als.train`` (vocabularies, ``device``); an
    ``init_factors`` among them seeds the first segment unless a
    checkpoint, which is newer, resumes. Without a manager, or with
    `checkpoint_every` <= 0, it is one ``als.train``. Returns the final
    ALSFactors."""
    init = train_kwargs.pop("init_factors", None)
    if manager is None or checkpoint_every <= 0:
        return als.train(rows, cols, vals, n_users, n_items, params,
                         init_factors=init, **train_kwargs)

    done = 0
    factors = None
    resumed = manager.load()
    if resumed is not None:
        done, payload = resumed
        factors = als.ALSFactors.from_bytes(payload)
        init = (factors.user_factors, factors.item_factors)
        log.info("resuming ALS from checkpoint at iteration %d", done)
    while done < params.iterations:
        step = min(checkpoint_every, params.iterations - done)
        factors = als.train(rows, cols, vals, n_users, n_items,
                            replace(params, iterations=step),
                            init_factors=init, **train_kwargs)
        done += step
        if done < params.iterations:
            manager.save(done, factors.to_bytes())
        init = (factors.user_factors, factors.item_factors)
        if on_segment is not None:
            on_segment(done)
    manager.clear()
    return factors
