"""The windowed ALS edge pass: per-block partial sums and their ordered
combine into output windows.

Counterpart of the JAX package's ``ops/windowed_pallas.py``
(``block_partials``) and of the block-level segment sum that
``ops/windowed.py:windowed_gram_b`` runs after it. For every block c of
B_E edge slots and every row r < S of its window:

    pb[c, r]  = Σ_{e in c: local[e] = r} w_b[e] · y[src[e]]            (K)
    pg[c, r]  = Σ_{e in c: local[e] = r} w_g[e] · y[src[e]] ⊗ y[src[e]] (K²)

where y⊗y is formed in f32 and flattened row-major, and slots whose
local id lies outside [0, S) (padding) add nothing. Then

    out[w·S + r] = Σ over the blocks c of window w, in block order, of p[c, r]

with `block_window` (sorted) naming each block's window. Everything is
full f32: CG consumes these sums, so no TF32 and no bf16 operands.

On a CUDA tensor the wrappers launch the hand-written kernels in
``csrc/windowed_pass.cu``; on a CPU tensor they run the plain PyTorch
versions below. There is no fallback from one to the other.

The partials kernel sums only the K(K+1)/2 gram pairs i <= j (and the K
b entries) and stores each pair to both (i, j) and (j, i), so the two
mirrored cells hold the same bits. The products are the plain
version's (y_i·y_j rounded on its own; a b term's y_d·1 is exact), but
the kernel fuses each weight into its sum with one rounding (fma) and
sums in slot order, one run of equal local ids at a time, where the
plain version's matrix products take their own order: the bound on that
difference is relative to the sum of the absolute terms, which
`block_partials_plain` computes when called with ``magnitude=True``.
Both combines add a window's blocks in block order.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from predictionio_tpu_torch.ops.segment import full_f32

#: widest rank the kernel takes (models/als.py GRAM_SOLVER_MAX_RANK)
MAX_RANK = 32
#: blocks per plain-version step: bounds its one-hot and outer products
PLAIN_BLOCKS = 256

#: kernel launches through the wrappers in this process
BLOCK_LAUNCHES = {"partials": 0, "combine": 0}
_launch_lock = threading.Lock()


def block_partials_plain(factors, src, w_b, w_g, local, *, s_rows=128,
                         magnitude=False):
    """Plain PyTorch version of `block_partials`: per step of
    PLAIN_BLOCKS blocks, the (S, B_E) one-hot of the local ids times the
    weights, times the gathered rows and their outer products, as f32
    batched matrix products (TF32 off). ``magnitude=True`` sums the
    absolute terms instead (|w|·|y|), the scale of the summation-order
    error."""
    n_blocks, b_e = src.shape
    k = factors.shape[1]
    dev = factors.device
    pb = torch.empty((n_blocks, s_rows, k), dtype=torch.float32, device=dev)
    pg = torch.empty((n_blocks, s_rows, k * k), dtype=torch.float32,
                     device=dev)
    rows = torch.arange(s_rows, dtype=torch.int32, device=dev)
    with full_f32():
        for c0 in range(0, n_blocks, PLAIN_BLOCKS):
            sl = slice(c0, c0 + PLAIN_BLOCKS)
            y = factors[src[sl].long()]  # (cb, B_E, K)
            outer = (y[..., :, None] * y[..., None, :]).reshape(
                *y.shape[:2], k * k)
            wb, wg = w_b[sl], w_g[sl]
            if magnitude:
                y, outer, wb, wg = y.abs(), outer.abs(), wb.abs(), wg.abs()
            # out-of-range ids match no row of the one-hot
            onehot = (local[sl][:, None, :] == rows[None, :, None]).float()
            pb[sl] = torch.bmm(onehot * wb[:, None, :], y)
            pg[sl] = torch.bmm(onehot * wg[:, None, :], outer)
    return pb, pg


def combine_windows_plain(pb, pg, block_window, n_windows):
    """Plain PyTorch version of `combine_windows`: ``index_add_`` of the
    block partials into n_windows + 1 window rows (the JAX package's
    segment count), the last dropped."""
    n_blocks, s_rows, k = pb.shape
    idx = block_window.long()

    def one(p):
        width = p.shape[1] * p.shape[2]
        out = torch.zeros((n_windows + 1, width), dtype=torch.float32,
                          device=p.device)
        out.index_add_(0, idx, p.reshape(n_blocks, width))
        return out[:n_windows].reshape(n_windows * s_rows, p.shape[2])

    return one(pb), one(pg)


def _check(factors, src, w_b, w_g, local):
    if factors.dim() != 2 or factors.dtype != torch.float32:
        raise ValueError(f"factors must be a 2-D f32 matrix, got "
                         f"{factors.dtype} {tuple(factors.shape)}")
    if not 1 <= factors.shape[1] <= MAX_RANK:
        raise ValueError(f"rank {factors.shape[1]} outside 1..{MAX_RANK}")
    if src.dim() != 2:
        raise ValueError(f"src must be (n_blocks, B_E), got {tuple(src.shape)}")
    for name, t, dt in (("src", src, torch.int32), ("w_b", w_b, torch.float32),
                        ("w_g", w_g, torch.float32),
                        ("local", local, torch.int32)):
        if t.dtype != dt or t.shape != src.shape:
            raise ValueError(f"{name} must be {dt} {tuple(src.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != factors.device:
            raise ValueError(f"{name} on {t.device}, factors on "
                             f"{factors.device}")


def block_partials(
    factors: torch.Tensor,  # (N, K) f32 — the fixed side's factors
    src: torch.Tensor,  # (n_blocks, B_E) int32 — rows of `factors`
    w_b: torch.Tensor,  # (n_blocks, B_E) f32 — 0 on padding slots
    w_g: torch.Tensor,  # (n_blocks, B_E) f32 — 0 on padding slots
    local: torch.Tensor,  # (n_blocks, B_E) int32 — row in the window
    *,
    s_rows: int = 128,  # ops.windowed.WINDOW_ROWS
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pb (n_blocks, S, K), pg (n_blocks, S, K²)) f32, every block's
    partial sums over all its slots in one call. CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    _check(factors, src, w_b, w_g, local)
    if factors.device.type == "cpu":
        return block_partials_plain(factors, src, w_b, w_g, local,
                                    s_rows=s_rows)
    return _launch_partials(factors, src, w_b, w_g, local, s_rows)


def combine_windows(
    pb: torch.Tensor,  # (n_blocks, S, K) f32
    pg: torch.Tensor,  # (n_blocks, S, K²) f32
    block_window: torch.Tensor,  # (n_blocks,) int32, non-decreasing
    n_windows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(b (n_windows·S, K), gram_flat (n_windows·S, K²)) f32: each
    window's blocks added in block order. CPU tensors run the plain
    version; CUDA tensors launch the kernel, which relies on
    `block_window` being sorted (plan_windows makes it so)."""
    n_blocks = pb.shape[0]
    if (pb.dim() != 3 or pg.dim() != 3 or pb.dtype != torch.float32
            or pg.dtype != torch.float32 or pg.shape[:2] != pb.shape[:2]
            or pg.shape[2] != pb.shape[2] ** 2):
        raise ValueError(f"partials must be f32 (n_blocks, S, K) and "
                         f"(n_blocks, S, K²), got {tuple(pb.shape)} and "
                         f"{tuple(pg.shape)}")
    if (block_window.dtype != torch.int32
            or tuple(block_window.shape) != (n_blocks,)
            or block_window.device != pb.device or pg.device != pb.device):
        raise ValueError(f"block_window must be int32 ({n_blocks},) on "
                         f"{pb.device}, got {block_window.dtype} "
                         f"{tuple(block_window.shape)} on "
                         f"{block_window.device}")
    if pb.device.type == "cpu":
        return combine_windows_plain(pb, pg, block_window, n_windows)
    return _launch_combine(pb, pg, block_window, n_windows)


# ---------------------------------------------------------------------------
# the CUDA launches
# ---------------------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from predictionio_tpu_torch.ops import _build

        lib = _build.load("windowed_pass")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.block_partials.argtypes = [p, ll, i, p, p, p, p, ll, i, i, p, p,
                                       i, p]
        lib.block_partials_plan.argtypes = [i, i, i, p]
        lib.block_partials_plan.restype = i
        lib.combine_windows.argtypes = [p, p, p, ll, i, i, ll, p, p, i, p]
        lib.block_partials.restype = lib.combine_windows.restype = i
        _lib = lib
    return _lib


def _device_and_stream(t):
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def partials_plan(k: int, s_rows: int, device: torch.device) -> dict:
    """The partials kernel's launch at rank k on `device`, as the kernel
    chooses it (``block_partials_plan``): the 2 x 2 tiles of the summed
    pairs (one thread each), threads a CTA, output rows a CTA and the
    row groups a block is cut into (one CTA each), shared memory bytes a
    CTA and CTAs an SM holds. Raises where the kernel takes no such
    launch."""
    out = (ctypes.c_int * 6)()
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    err = _kernel_lib().block_partials_plan(k, s_rows, dev, out)
    if err:
        raise ValueError(f"no partials launch at rank {k}, {s_rows} rows: "
                         f"CUDA error {err}")
    return dict(zip(("tiles", "threads", "rows", "groups", "smem_bytes",
                     "ctas_per_sm"), out))


def _launch_partials(factors, src, w_b, w_g, local, s_rows):
    if factors.device.type != "cuda":
        raise ValueError(f"unsupported device {factors.device}")
    if not all(t.is_contiguous() for t in (factors, src, w_b, w_g, local)):
        raise ValueError("the CUDA kernel takes contiguous tensors only")
    n_blocks, b_e = src.shape
    n_src, k = factors.shape
    pb = torch.empty((n_blocks, s_rows, k), dtype=torch.float32,
                     device=factors.device)
    pg = torch.empty((n_blocks, s_rows, k * k), dtype=torch.float32,
                     device=factors.device)
    err = _kernel_lib().block_partials(
        factors.data_ptr(), n_src, k, src.data_ptr(), w_b.data_ptr(),
        w_g.data_ptr(), local.data_ptr(), n_blocks, b_e, s_rows,
        pb.data_ptr(), pg.data_ptr(), *_device_and_stream(factors),
    )
    if err:
        raise RuntimeError(
            f"block_partials kernel launch failed: CUDA error {err}")
    with _launch_lock:
        BLOCK_LAUNCHES["partials"] += 1
    return pb, pg


def _launch_combine(pb, pg, block_window, n_windows):
    if pb.device.type != "cuda":
        raise ValueError(f"unsupported device {pb.device}")
    if not all(t.is_contiguous() for t in (pb, pg, block_window)):
        raise ValueError("the CUDA kernel takes contiguous tensors only")
    n_blocks, s_rows, k = pb.shape
    ob = torch.empty((n_windows * s_rows, k), dtype=torch.float32,
                     device=pb.device)
    og = torch.empty((n_windows * s_rows, k * k), dtype=torch.float32,
                     device=pb.device)
    err = _kernel_lib().combine_windows(
        pb.data_ptr(), pg.data_ptr(), block_window.data_ptr(), n_blocks,
        s_rows, k, n_windows, ob.data_ptr(), og.data_ptr(),
        *_device_and_stream(pb),
    )
    if err:
        raise RuntimeError(
            f"combine_windows kernel launch failed: CUDA error {err}")
    with _launch_lock:
        BLOCK_LAUNCHES["combine"] += 1
    return ob, og
