"""ALS serving: factor persistence, staged serving state and the serving
verbs.

Serving half of the JAX package's ``models/als.py``. Factors persist in
the same npz format, so a blob written by the JAX package's
``ALSFactors.to_bytes`` loads here. Staging puts the factor matrices on
a device once (padded to ``ITEM_PAD`` rows, quantized for int8); every
verb then sends only the row ids and, when filters apply, the packed
exclusion words or row list, and runs ``ops.recommend.
fused_recommend_topk``.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.data.store.bimap import BiMap
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops import recommend as _rp


@dataclass(frozen=True)
class ALSParams:
    rank: int = 10
    iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0  # implicit confidence scale
    implicit_prefs: bool = True
    cg_iterations: int = 3
    seed: int = 3
    # max edges per device program step in training
    edge_chunk_size: int = 1 << 21


@dataclass
class ALSFactors:
    """Trained factor matrices + id vocabularies."""

    user_factors: np.ndarray  # (U, K) float32
    item_factors: np.ndarray  # (I, K) float32
    user_vocab: BiMap  # user id → row
    item_vocab: BiMap  # item id → row
    params: ALSParams = field(default_factory=ALSParams)

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.savez_compressed(
            buf,
            user_factors=self.user_factors,
            item_factors=self.item_factors,
            user_ids=np.array(list(self.user_vocab.to_dict().keys()), dtype=object),
            user_idx=np.array(list(self.user_vocab.to_dict().values()), dtype=np.int64),
            item_ids=np.array(list(self.item_vocab.to_dict().keys()), dtype=object),
            item_idx=np.array(list(self.item_vocab.to_dict().values()), dtype=np.int64),
            params=np.frombuffer(
                json.dumps(self.params.__dict__).encode(), dtype=np.uint8
            ),
        )
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "ALSFactors":
        with np.load(io.BytesIO(data), allow_pickle=True) as z:
            params = ALSParams(
                **json.loads(bytes(z["params"].tobytes()).decode())
            )
            user_vocab = BiMap(
                dict(zip(z["user_ids"].tolist(), z["user_idx"].tolist()))
            )
            item_vocab = BiMap(
                dict(zip(z["item_ids"].tolist(), z["item_idx"].tolist()))
            )
            return ALSFactors(
                user_factors=z["user_factors"],
                item_factors=z["item_factors"],
                user_vocab=user_vocab,
                item_vocab=item_vocab,
                params=params,
            )


# -- staged serving state ----------------------------------------------------


SERVE_DTYPES = ("f32", "bf16", "int8")


@dataclass(frozen=True)
class ServingFactors:
    """Device-resident serving-side factor state, staged once and reused
    by every call.

    `items` is row-padded to `ops.recommend.ITEM_PAD`; `n_items` is the
    live extent (pad rows are dead inside the selector). dtype "int8"
    holds both matrices per-row symmetric-quantized with their scale
    vectors (users (U, 1), items (1, I_p)); "bf16" halves the factor
    stream with no scale vectors. `item_inv_norm` carries the items'
    f32-row inverse L2 norms, so the cosine verbs serve off the same
    slab: cosine is the scaled dot, never a normalized copy."""

    users: torch.Tensor  # (U, K) f32 | bf16 | int8
    items: torch.Tensor  # (I_p, K) f32 | bf16 | int8 — pad rows zero
    user_scale: Optional[torch.Tensor]  # (U, 1) f32 when int8
    item_scale: Optional[torch.Tensor]  # (1, I_p) f32 when int8
    n_items: int
    dtype: str  # "f32" | "bf16" | "int8"
    item_inv_norm: torch.Tensor  # (1, I_p) f32 — cosine

    @property
    def n_users(self) -> int:
        return int(self.users.shape[0])

    @property
    def device(self) -> torch.device:
        return self.items.device

    def device_nbytes(self) -> float:
        tensors = [self.users, self.items, self.item_inv_norm]
        if self.user_scale is not None:
            tensors += [self.user_scale, self.item_scale]
        return float(sum(t.nelement() * t.element_size() for t in tensors))


def stage_serving(
    factors: ALSFactors, serve_dtype: str = "f32", device=None
) -> ServingFactors:
    """Stage (and for "int8", quantize) the factor matrices for serving,
    on the card unless `device` says otherwise."""
    return _stage_arrays(
        np.asarray(factors.user_factors, np.float32),
        np.asarray(factors.item_factors, np.float32),
        serve_dtype, device,
    )


def stage_item_serving(
    item_matrix: np.ndarray, serve_dtype: str = "f32", device=None
) -> ServingFactors:
    """Item-only staging for cosine-only models: same ServingFactors
    contract with an empty user side — `similar_serving` is the only
    verb that makes sense here."""
    itf = np.asarray(item_matrix, np.float32)
    return _stage_arrays(
        np.zeros((0, itf.shape[1] if itf.ndim == 2 else 0), np.float32),
        itf, serve_dtype, device,
    )


def _stage_arrays(
    uf: np.ndarray, itf: np.ndarray, serve_dtype: str, device
) -> ServingFactors:
    if serve_dtype not in SERVE_DTYPES:
        raise ValueError(
            f"serve_dtype must be one of {SERVE_DTYPES}, got "
            f"{serve_dtype!r}"
        )
    dev = resolve_device(device)
    n_items, k = itf.shape if itf.ndim == 2 else (0, uf.shape[1])
    i_p = _rp.pad_items(n_items)
    # inverse norms from the PRE-quantization f32 rows: the cosine verbs
    # normalize by the true magnitudes, identically across dtypes
    inv = torch.from_numpy(_rp.inv_norms_np(itf, i_p)).to(dev)
    if serve_dtype == "int8":
        uq, us = _rp.quantize_rows_np(uf)
        iq, isc = _rp.quantize_rows_np(itf)
        items = np.zeros((i_p, k), np.int8)
        items[:n_items] = iq
        iscale = np.ones((1, i_p), np.float32)
        iscale[0, :n_items] = isc
        return ServingFactors(
            users=torch.from_numpy(uq).to(dev),
            items=torch.from_numpy(items).to(dev),
            user_scale=torch.from_numpy(
                np.ascontiguousarray(us[:, None])
            ).to(dev),
            item_scale=torch.from_numpy(iscale).to(dev),
            n_items=n_items,
            dtype="int8",
            item_inv_norm=inv,
        )
    items = np.zeros((i_p, k), np.float32)
    items[:n_items] = itf
    torch_dt = torch.bfloat16 if serve_dtype == "bf16" else torch.float32
    return ServingFactors(
        users=torch.from_numpy(np.ascontiguousarray(uf)).to(dev).to(torch_dt),
        items=torch.from_numpy(items).to(dev).to(torch_dt),
        user_scale=None,
        item_scale=None,
        n_items=n_items,
        dtype=serve_dtype,
        item_inv_norm=inv,
    )


def _serve_recommend(rows, sv: ServingFactors, bits, ex, *, k):
    """Gather the query block from the resident user matrix and run the
    fused selector; int8 gathers the dequant scales with it."""
    int8 = sv.items.dtype == torch.int8
    q = sv.users[rows]
    qs = sv.user_scale[rows] if int8 else None
    isc = sv.item_scale if int8 else None
    return _rp.fused_recommend_topk(
        q, sv.items, qs, isc, bits, ex, k=k, n_items=sv.n_items
    )


def _serve_similar(rows, sv: ServingFactors, bits, ex, *, k):
    """Cosine `similar` off the same resident item slab as recommend:
    cosine(q, x) = (q·x)·(1/|q|)·(1/|x|) — the inverse norms ride the
    selector's scale inputs. int8 composes: the effective scales are
    (dequant scale · inverse norm) per side."""
    q = sv.items[rows]
    inv_q = sv.item_inv_norm[0, rows][:, None]  # (B, 1)
    if sv.items.dtype == torch.int8:
        qs = sv.item_scale[0, rows][:, None] * inv_q
        isc = sv.item_scale * sv.item_inv_norm
    else:
        qs = inv_q
        isc = sv.item_inv_norm
    return _rp.fused_recommend_topk(
        q, sv.items, qs, isc, bits, ex, k=k, n_items=sv.n_items
    )


def _serve_similar_vecs(vecs, sv: ServingFactors, bits, ex, *, k):
    """Cosine top-k against arbitrary f32 query vectors: the query side
    quantizes per call for int8 slabs; norms fold into the scale
    product like every other cosine verb."""
    inv_q = 1.0 / (torch.linalg.vector_norm(vecs, dim=-1, keepdim=True) + 1e-9)
    if sv.items.dtype == torch.int8:
        q, qscale = _rp.quantize_rows(vecs)
        qs = qscale * inv_q
        isc = sv.item_scale * sv.item_inv_norm
    else:
        q = vecs.to(sv.items.dtype)
        qs = inv_q
        isc = sv.item_inv_norm
    return _rp.fused_recommend_topk(
        q, sv.items, qs, isc, bits, ex, k=k, n_items=sv.n_items
    )


def _exclusion_device_args(
    serving: ServingFactors,
    batch: int,
    exclude_mask: Optional[np.ndarray],
    exclude_rows: Optional[np.ndarray],
    extra_rows: Optional[np.ndarray] = None,
):
    """Host-side exclusion packing shared by the serving verbs: a row
    list (the common small-blacklist case) ships (B, E) int32 at a
    pow2-bucketed width; anything wider — or a dense mask — packs to
    bit words at 1/32 the f32 bytes. `extra_rows` appends one
    always-excluded row per query (similar's exclude_self)."""
    dev = serving.device
    i_p = int(serving.items.shape[0])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if exclude_mask is not None:
        mask = np.asarray(exclude_mask, bool)
        if extra_rows is not None:
            mask = mask.copy()
            mask[np.arange(batch), np.asarray(extra_rows)] = True
        return put(_rp.pack_mask_np(mask, i_p)), None
    if exclude_rows is not None and extra_rows is None:
        # fast path: an already -1-padded (B, E) int32 array (the
        # engine's _exclusion_args builds exactly this) ships as-is
        ex = np.asarray(exclude_rows, np.int32)
        if ex.shape[1] <= _rp.ROWLIST_MAX:
            return None, (put(ex) if ex.shape[1] else None)
    lists: list[list[int]] = [[] for _ in range(batch)]
    if exclude_rows is not None:
        for b, row in enumerate(exclude_rows):
            lists[b] = [int(x) for x in row if int(x) >= 0]
    if extra_rows is not None:
        for b, r in enumerate(np.asarray(extra_rows)):
            lists[b].append(int(r))
    widest = max((len(r) for r in lists), default=0)
    if widest == 0:
        return None, None
    if widest > _rp.ROWLIST_MAX:
        # too wide for the per-column compare: scatter host-side into
        # packed words instead (still 1/32 the f32 mask bytes)
        mask = np.zeros((batch, i_p), bool)
        for b, row in enumerate(lists):
            hits = np.asarray(row, np.int64)
            hits = hits[(hits >= 0) & (hits < i_p)]
            mask[b, hits] = True
        return put(_rp.pack_mask_np(mask, i_p)), None
    return None, put(_rp.rowlist_np(lists))


def _host(vals, idx):
    return vals.cpu().numpy(), idx.cpu().numpy()


def recommend_serving(
    serving: ServingFactors,
    user_indices: np.ndarray,
    k: int,
    exclude_mask: Optional[np.ndarray] = None,  # (B, n_items) bool
    exclude_rows: Optional[np.ndarray] = None,  # (B, E) int, -1 padded
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k items from staged serving state: (scores (B, k) f32,
    indices (B, k) int32). One selector call; only the row ids (and the
    exclusion words / row list, when filters apply) cross to the
    device."""
    k = min(int(k), serving.n_items)
    if k <= 0 or serving.n_users == 0:
        b = len(np.asarray(user_indices))
        return (
            np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int64),
        )
    rows_np = np.asarray(user_indices, np.int64)
    bits, ex = _exclusion_device_args(
        serving, len(rows_np), exclude_mask, exclude_rows
    )
    rows = torch.from_numpy(rows_np).to(serving.device)
    return _host(*_serve_recommend(rows, serving, bits, ex, k=k))


def similar_serving(
    serving: ServingFactors,
    item_indices: np.ndarray,
    k: int,
    exclude_self: bool = True,
    exclude_mask: Optional[np.ndarray] = None,
    exclude_rows: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Cosine top-k for a batch of item rows off the staged state.
    exclude_self rides the row-list path (one entry per query) unless
    a dense mask is already in play."""
    k = min(int(k), serving.n_items)
    rows_np = np.asarray(item_indices, np.int64)
    if k <= 0 or serving.n_items == 0:
        return (
            np.zeros((len(rows_np), 0), np.float32),
            np.zeros((len(rows_np), 0), np.int64),
        )
    bits, ex = _exclusion_device_args(
        serving, len(rows_np), exclude_mask, exclude_rows,
        extra_rows=rows_np if exclude_self else None,
    )
    rows = torch.from_numpy(rows_np).to(serving.device)
    return _host(*_serve_similar(rows, serving, bits, ex, k=k))


def similar_vectors_serving(
    serving: ServingFactors,
    vectors: np.ndarray,  # (B, K) f32 query vectors
    k: int,
    exclude_mask: Optional[np.ndarray] = None,
    exclude_rows: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Cosine top-k against arbitrary query vectors (a basket mean) from
    the staged state."""
    k = min(int(k), serving.n_items)
    vecs = np.asarray(vectors, np.float32)
    if k <= 0 or serving.n_items == 0:
        return (
            np.zeros((len(vecs), 0), np.float32),
            np.zeros((len(vecs), 0), np.int64),
        )
    bits, ex = _exclusion_device_args(
        serving, len(vecs), exclude_mask, exclude_rows
    )
    v = torch.from_numpy(np.ascontiguousarray(vecs)).to(serving.device)
    return _host(*_serve_similar_vecs(v, serving, bits, ex, k=k))
