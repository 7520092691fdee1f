"""Device staging of segment-backed training reads.

Counterpart of the JAX package's ``parallel/loader.py`` ``SegmentStager``
(loader.py:124-225), on torch tensors on an explicit device. The JAX
module's multi-host staging (``stage_rows``, ``stage_edges``, process
slices assembled over a mesh) waits for the port's multi-card train.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device


class SegmentStager:
    """Stages a segmentfs training read (``find_frame_parts``) onto the
    device:

    - one reusable host buffer a column, grown geometrically and pinned
      when the device is CUDA, filled by a copy (an mmapped column is
      read-only and never handed to torch);
    - one host-to-device copy a column; a buffer is not refilled before
      its last copy has completed (a CUDA event recorded after it);
    - the sealed prefix's device tensors kept under the store's segment
      token: after tail-only ingest only the tail's rows are copied, and
      the columns are concatenated on the device.

    ``stats``: ``sealed_restage`` (the sealed prefix copied),
    ``sealed_reuse`` (kept from the last call), ``bytes_staged`` (host to
    device). One stager a training loop; not thread-safe.
    """

    _DTYPES = {"entity_idx": torch.int32, "target_idx": torch.int32, "value": torch.float32}

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._pinned = self.device.type == "cuda"
        self._host: dict[str, torch.Tensor] = {}
        self._copied: dict[str, torch.cuda.Event] = {}
        # (query key, segment token) → {column: sealed device tensor}
        self._key: Optional[tuple] = None
        self._sealed_dev: dict[str, torch.Tensor] = {}
        self.stats = {"sealed_restage": 0, "sealed_reuse": 0, "bytes_staged": 0}

    def _host_view(self, name: str, src: np.ndarray) -> torch.Tensor:
        """`src` copied into the reusable host buffer of `name`; returns
        the filled view."""
        n = src.shape[0]
        buf = self._host.get(name)
        if buf is None or buf.shape[0] < n:
            cap = max(1024, 1 << max(0, (max(n, 1) - 1)).bit_length())
            buf = torch.empty(cap, dtype=self._DTYPES[name.split("/")[0]],
                              pin_memory=self._pinned)
            self._host[name] = buf
            self._copied.pop(name, None)
        done = self._copied.get(name)
        if done is not None:
            done.synchronize()  # the last copy out of this buffer has ended
        view = buf[:n]
        np.copyto(view.numpy(), src, casting="same_kind")
        return view

    def _put(self, name: str, src: np.ndarray) -> torch.Tensor:
        view = self._host_view(name, src)
        self.stats["bytes_staged"] += view.numel() * view.element_size()
        if not self._pinned:
            return view.clone()  # the buffer is refilled at the next call
        out = view.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._copied[name] = ev
        return out

    def stage(self, store, query, value_prop: Optional[str] = None,
              default_value: float = 1.0):
        """A training read from the store's sealed segments and tail onto
        the device: ``(frame, {entity_idx, target_idx, value, valid})``,
        the tensors of equal length on the stager's device (int32, int32,
        float32, float32 ones). The query's event, type and time filters
        are the store's columnar read's."""
        frame, token, n_sealed = store.find_frame_parts(
            query, value_prop=value_prop, default_value=default_value)
        key = (query.app_id, query.channel_id,
               tuple(query.event_names) if query.event_names else None,
               query.entity_type, query.target_entity_type,
               query.start_time, query.until_time, query.shard,
               value_prop, default_value, token, n_sealed)
        cols = {"entity_idx": np.asarray(frame.entity_idx, np.int32),
                "target_idx": np.asarray(frame.target_idx, np.int32),
                "value": np.asarray(frame.value, np.float32)}
        if self._key == key:
            self.stats["sealed_reuse"] += 1
        else:
            self._sealed_dev = {name: self._put(name, arr[:n_sealed])
                                for name, arr in cols.items()}
            self._key = key
            self.stats["sealed_restage"] += 1
        staged = {}
        for name, arr in cols.items():
            if arr.shape[0] > n_sealed:
                tail = self._put(f"{name}/tail", arr[n_sealed:])
                staged[name] = torch.cat([self._sealed_dev[name], tail])
            else:
                staged[name] = self._sealed_dev[name]
        staged["valid"] = torch.ones(cols["value"].shape[0], dtype=torch.float32,
                                     device=self.device)
        return frame, staged
