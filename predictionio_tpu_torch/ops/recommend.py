"""Fused score+top-k over a padded item-factor slab: score, mask and
select without writing the (B, I_p) score matrix to device memory.

Counterpart of the JAX package's ``ops/recommend_pallas.py``. Every
serving verb routes through ``fused_recommend_topk``: dot-product
recommend and cosine similar (inverse norms ride the scale inputs), in
f32, bf16 (f32 products and sum) or int8 (int32 sum, scale-product
dequantization), with exclusion as bit-packed words or a short row list.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/recommend_topk.cu``; on a CPU tensor it runs
``fused_recommend_topk_plain``, the plain PyTorch version of the same
function. There is no fallback from one to the other.

Both compute each score as ONE fixed-order chain over K — multiply,
then add, each rounded on its own — so the kernel and the plain
version agree bit for bit on every device, and a query's scores do not
depend on the batch it rides in (a shadow B=1 mirror must serialize the
same floats as a B=n live answer). Order is (score descending, index
ascending), the order ``lax.top_k`` gives; masked items score NEG_INF
and dead pad columns at or above ``n_items`` sink to ``_SENTINEL``,
strictly below NEG_INF.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from predictionio_tpu_torch.ops.topk import NEG_INF, masked_top_k

#: pad item rows to this multiple at staging (a multiple of 32, so
#: bit-packed mask words always cover whole rows of the slab)
ITEM_PAD = 128

#: widest (B, E) exclusion row list the kernel compares per column;
#: longer exclusion sets ship as bit-packed mask words instead
ROWLIST_MAX = 64

#: strictly below every representable score INCLUDING the NEG_INF mask
#: value, so dead pad columns never collide with masked real items
_SENTINEL = float(np.finfo(np.float32).min)

#: item columns one pass-1 block of the kernel scores and sorts; must
#: equal CHUNK in csrc/recommend_topk.cu
_CHUNK = 1024

#: kernel launches through ``fused_recommend_topk`` in this process
LAUNCHES = 0
_launch_lock = threading.Lock()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def pad_items(n_items: int) -> int:
    """Padded item-row count the staging side must allocate."""
    return -(-max(n_items, 1) // ITEM_PAD) * ITEM_PAD


# ---------------------------------------------------------------------------
# host-side helpers (numpy)
# ---------------------------------------------------------------------------


def pack_mask_np(mask, i_p: int):
    """Pack a bool (B, n) exclusion mask into little-endian 32-bit words
    at the padded item width: word ``c // 32`` bit ``c % 32`` is column
    ``c``. (B, i_p/32) int32 — 1/32 the bytes of an f32 0/1 mask."""
    mask = np.asarray(mask, bool)
    b = mask.shape[0]
    out = np.zeros((b, i_p // 8), np.uint8)
    if mask.shape[1]:
        packed = np.packbits(mask, axis=1, bitorder="little")
        out[:, : packed.shape[1]] = packed[:, : i_p // 8]
    return np.ascontiguousarray(out).view("<u4").view("<i4")


def rowlist_np(lists):
    """(B, E) int32 -1-padded exclusion row list from per-query id lists,
    at a pow2-bucketed width (floor 8) — the one owner of the row-list
    wire convention. Returns None when every list is empty."""
    widest = max((len(r) for r in lists), default=0)
    if widest == 0:
        return None
    e_pad = max(8, 1 << (widest - 1).bit_length())
    ex = np.full((len(lists), e_pad), -1, np.int32)
    for b, row in enumerate(lists):
        ex[b, : len(row)] = row
    return ex


def quantize_rows_np(arr) -> tuple:
    """Per-row symmetric int8 quantization: scale_r = max|row| / 127
    (1.0 for all-zero rows so dequant is exact zero), q = round(row /
    scale) in [-127, 127]. Returns (int8 (N, K), f32 scales (N,))."""
    arr = np.asarray(arr, np.float32)
    amax = np.max(np.abs(arr), axis=1) if arr.size else np.zeros(
        arr.shape[0], np.float32
    )
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(
        np.round(arr / scale[:, None]), -127, 127
    ).astype(np.int8)
    return q, scale


def inv_norms_np(arr, pad_to: int = 0):
    """Per-row inverse L2 norms 1/(|row|+1e-9) as a (1, N_p) f32 row —
    the cosine verbs' item-side scale, from the f32 factors (pad rows
    get 0.0: their scores are dead either way, and 0 keeps them
    finite)."""
    arr = np.asarray(arr, np.float32)
    n = arr.shape[0]
    out = np.zeros((1, max(pad_to, n)), np.float32)
    if n:
        out[0, :n] = 1.0 / (np.linalg.norm(arr, axis=1) + 1e-9)
    return out


# ---------------------------------------------------------------------------
# tensor helpers
# ---------------------------------------------------------------------------


def unpack_mask(words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Packed (B, W) int32 mask words → bool (B, n_cols) mask."""
    b, w = words.shape
    shifts = torch.arange(32, dtype=words.dtype, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(b, w * 32)[:, :n_cols] != 0


def rowlist_mask(rows: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(B, E) exclusion row list → bool (B, n_cols) mask (-1 and
    out-of-range entries are inert)."""
    b = rows.shape[0]
    safe = torch.where((rows >= 0) & (rows < n_cols), rows, n_cols).long()
    m = torch.zeros((b, n_cols + 1), dtype=torch.bool, device=rows.device)
    m[torch.arange(b, device=rows.device)[:, None], safe] = True
    return m[:, :n_cols]


def quantize_rows(arr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor twin of `quantize_rows_np` for query rows made per call;
    returns (int8 (B, K), f32 scales (B, 1))."""
    amax = arr.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(arr / scale), -127, 127).to(torch.int8)
    return q, scale


def plain_scores(q, items, qs, isc) -> torch.Tensor:
    """(B, I_p) f32 scores with the kernel's arithmetic: int8 sums in
    int32 and converts once; f32 and bf16 sum f32 products; the chain
    over K runs in index order, multiply and add rounded separately
    (never fused), so every device gives the same bits for any batch.
    Scales multiply as ``s * qs * isc``."""
    kdim = q.shape[1]
    if items.dtype == torch.int8:
        qv, xv = q.to(torch.int32), items.to(torch.int32)
    else:
        qv, xv = q.to(torch.float32), items.to(torch.float32)
    s = qv[:, 0:1] * xv[:, 0]
    for j in range(1, kdim):
        s = s + qv[:, j : j + 1] * xv[:, j]
    s = s.to(torch.float32)
    if qs is not None:
        s = s * qs * isc
    return s


# ---------------------------------------------------------------------------
# the fused selector
# ---------------------------------------------------------------------------


def fused_recommend_topk_plain(
    q, itf, q_scale, item_scale, mask_bits, exclude_rows, *, k, n_items
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused selector: the score matrix,
    masked columns to NEG_INF, dead pad columns to _SENTINEL, then a
    stable descending top-k. Returns (values (B, k) f32, indices (B, k)
    int32)."""
    s = plain_scores(q, itf, q_scale, item_scale)
    i_p = int(itf.shape[0])
    if mask_bits is not None:
        s = torch.where(unpack_mask(mask_bits, i_p), NEG_INF, s)
    elif exclude_rows is not None and exclude_rows.shape[1]:
        s = torch.where(rowlist_mask(exclude_rows, i_p), NEG_INF, s)
    col = torch.arange(i_p, device=s.device)
    s = torch.where((col >= int(n_items))[None, :], _SENTINEL, s)
    vals, idx = masked_top_k(s, k)
    return vals, idx.to(torch.int32)


def _mask_kind(mask_bits, exclude_rows):
    if mask_bits is not None and exclude_rows is not None:
        raise ValueError(
            "pass either packed mask words or an exclusion row list, "
            "not both — callers compose exclusions into one form"
        )
    if mask_bits is not None:
        return "bits"
    if exclude_rows is not None:
        if exclude_rows.shape[1] == 0:
            return None  # a (B, 0) list excludes nothing
        if exclude_rows.shape[1] > ROWLIST_MAX:
            raise ValueError(
                f"exclusion row list width {exclude_rows.shape[1]} > "
                f"ROWLIST_MAX ({ROWLIST_MAX}) — pack to mask words"
            )
        return "rows"
    return None


def _check(t, name, shape, dtype, device):
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q is on {device}")


def fused_recommend_topk(
    q: torch.Tensor,  # (B, K) f32 | bf16 | int8 — matches itf's dtype
    itf: torch.Tensor,  # (I_p, K) f32 | bf16 | int8, I_p % ITEM_PAD == 0
    q_scale=None,  # (B, 1) f32 per-row scales (int8 dequant / cosine 1/|q|)
    item_scale=None,  # (1, I_p) f32 per-row scales
    mask_bits=None,  # (B, I_p/32) int32 packed exclusion words
    exclude_rows=None,  # (B, E) int32 exclusion row list, -1 padded
    *,
    k: int,
    n_items,  # live item count: columns at or above it are dead pad
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-pass fused score+top-k over a padded item-factor matrix.

    Returns (values (B, k) f32, global indices (B, k) int32), ordered
    by score descending, ties to the lowest index. Needs 0 < k <= I_p.
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if q.dim() != 2 or itf.dim() != 2 or q.shape[1] != itf.shape[1]:
        raise ValueError(
            f"need q (B, K) and itf (I_p, K), got {tuple(q.shape)} and "
            f"{tuple(itf.shape)}"
        )
    b, kdim = q.shape
    i_p = int(itf.shape[0])
    dev = q.device
    if itf.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported factor dtype {itf.dtype}")
    _check(q, "q", (b, kdim), itf.dtype, dev)
    _check(itf, "itf", (i_p, kdim), itf.dtype, dev)
    if b == 0 or kdim == 0:
        raise ValueError(f"empty query block {tuple(q.shape)}")
    if i_p % ITEM_PAD:
        raise ValueError(
            f"padded item count {i_p} is not a multiple of {ITEM_PAD} — "
            f"stage with recommend.pad_items"
        )
    k = int(k)
    if not 0 < k <= i_p:
        raise ValueError(f"need 0 < k ({k}) <= padded {i_p}")
    n_items = int(n_items)
    scaled = q_scale is not None
    if scaled != (item_scale is not None):
        raise ValueError("pass both q_scale and item_scale, or neither")
    if itf.dtype == torch.int8 and not scaled:
        raise ValueError("int8 factors require dequant scales")
    if scaled:
        _check(q_scale, "q_scale", (b, 1), torch.float32, dev)
        _check(item_scale, "item_scale", (1, i_p), torch.float32, dev)
    kind = _mask_kind(mask_bits, exclude_rows)
    if kind == "bits":
        _check(mask_bits, "mask_bits", (b, i_p // 32), torch.int32, dev)
    elif kind == "rows":
        _check(
            exclude_rows, "exclude_rows", (b, exclude_rows.shape[1]),
            torch.int32, dev,
        )
    bits = mask_bits if kind == "bits" else None
    rows = exclude_rows if kind == "rows" else None
    if dev.type == "cpu":
        return fused_recommend_topk_plain(
            q, itf, q_scale, item_scale, bits, rows, k=k, n_items=n_items
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(q, itf, q_scale, item_scale, bits, rows, k, n_items)


# ---------------------------------------------------------------------------
# the CUDA launch
# ---------------------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from predictionio_tpu_torch.ops import _build

        lib = _build.load("recommend_topk")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.recommend_topk.argtypes = [
            i, p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, i, p,
        ]
        lib.recommend_topk.restype = i
        _lib = lib
    return _lib


def merge_levels(i_p: int, k: int) -> list[tuple[int, int]]:
    """(lists, list stride) per level of the kernel's merge tree: level 0
    holds each chunk's top min(k, CHUNK); each level merges neighbours
    pairwise until one list of k remains. Mirrors the C host loop."""
    n = -(-i_p // _CHUNK)
    levels = [(n, min(k, _CHUNK))]
    while n > 1:
        n = (n + 1) // 2
        levels.append((n, min(k, _CHUNK << len(levels))))
    return levels


def _contig(t):
    if t is not None and not t.is_contiguous():
        raise ValueError("the CUDA kernel takes contiguous tensors only")
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, itf, q_scale, item_scale, bits, rows, k, n_items):
    global LAUNCHES
    for t in (q, itf, q_scale, item_scale, bits, rows):
        _contig(t)
    b, kdim = q.shape
    i_p = int(itf.shape[0])
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    lib = _kernel_lib()
    per_row = max(n * stride for n, stride in merge_levels(i_p, k))
    scratch = torch.empty((2, b, per_row), dtype=torch.int64, device=q.device)
    vals = torch.empty((b, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=q.device)
    n_excl = 0 if rows is None else int(rows.shape[1])
    err = lib.recommend_topk(
        _DTYPE_CODE[itf.dtype], _ptr(q), _ptr(itf), _ptr(q_scale),
        _ptr(item_scale), _ptr(bits), _ptr(rows), n_excl,
        b, kdim, i_p, n_items, k, _CHUNK,
        _ptr(scratch[0]), _ptr(scratch[1]), _ptr(vals), _ptr(idx),
        q.device.index if q.device.index is not None else
        torch.cuda.current_device(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"recommend_topk kernel launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES += 1
    return vals, idx
