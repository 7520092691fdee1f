"""Windowed segment reduction for dst-sorted edge lists, and the flat
operator matvec the ALS CG solve applies.

Counterpart of the JAX package's ``ops/windowed.py``. The ALS
normal-equation builders reduce one term per rating into per-row sums:
b[d] = Σ w_b·y and gram[d] = Σ w_g·y⊗y over the edges into row d.

1. HOST PLAN (``plan_windows``, numpy, once per training set): cut the
   dst-sorted edge list into blocks of at most ``BLOCK_EDGES`` edges that
   never cross an aligned window of ``WINDOW_ROWS`` output rows; pad
   each block to ``BLOCK_EDGES`` slots and the block count to a multiple
   of ``CHUNK_BLOCKS``. The plan is the JAX package's, field for field.
2. DEVICE PASS (``windowed_gram_b``): per block, the partial sums over
   its edges into its window's S rows (``ops.windowed_fused.
   block_partials``: the hand-written kernel on the card), then the
   blocks of each window added in block order
   (``ops.windowed_fused.combine_windows``).

Only the single-part plan (P = 1) runs here; the sharded pass over
several devices is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from predictionio_tpu_torch.ops import windowed_fused

# Output window rows: every edge's local row id is dst % S.
WINDOW_ROWS = 128
# Max edges per block.
BLOCK_EDGES = 1024
# The block count is padded to a multiple of this (the JAX package scans
# the blocks in chunks of this many).
CHUNK_BLOCKS = 128


@dataclass(frozen=True)
class WindowPlan:
    """Host-side blocking of one dst-sorted edge list.

    The plan re-indexes every per-edge array through `edge_index` (padding
    slots point at edge 0 with valid=0), reshaped to (n_parts,
    chunks_per_part, chunk_blocks, block_edges). `n_parts` > 1 splits the
    block list into contiguous per-device groups: blocks (hence output
    windows) are assigned to parts contiguously, so the part-major global
    block order keeps window ids non-decreasing — padding blocks inside a
    part carry the part's LAST real window id (zero-weight, so they
    contribute nothing) to preserve sortedness.
    """

    edge_index: np.ndarray  # (E_p,) int — padded slot → original edge
    valid: np.ndarray  # (E_p,) float32 — 0.0 on padding slots
    local: np.ndarray  # (E_p,) int32 — dst % S per slot
    block_window: np.ndarray  # (n_blocks_p,) int32 — output window per block
    n_blocks: int  # real blocks (before padding)
    n_blocks_p: int  # padded blocks: n_parts * chunks_per_part * CB
    n_chunks: int  # n_parts * chunks_per_part
    n_windows: int  # output rows padded to n_windows * S
    n_rows: int  # true output row count
    n_parts: int = 1
    chunks_per_part: int = 1

    @property
    def n_rows_padded(self) -> int:
        return self.n_windows * WINDOW_ROWS

    def _shape4(self):
        return (self.n_parts, self.chunks_per_part, CHUNK_BLOCKS, BLOCK_EDGES)

    def take(self, per_edge: np.ndarray) -> np.ndarray:
        """Re-index a per-edge array into padded (P, L, CB, B_E) form.
        Float arrays are masked by `valid` so padding slots are inert."""
        if per_edge.size == 0:  # empty training set: all-padding plan
            per_edge = np.zeros(1, per_edge.dtype)
        out = per_edge[self.edge_index]
        if np.issubdtype(out.dtype, np.floating):
            out = out * self.valid
        return out.reshape(self._shape4())

    def chunked_local(self) -> np.ndarray:
        return self.local.reshape(self._shape4())

    def chunked_valid(self) -> np.ndarray:
        return self.valid.reshape(self._shape4())


def plan_windows(
    dst_sorted: np.ndarray, n_rows: int, n_parts: int = 1
) -> WindowPlan:
    """Build the block/window plan for a dst-sorted edge list. O(E) numpy.

    `n_parts` > 1 splits blocks into that many contiguous equal-size
    (padded) groups — one per data-parallel device."""
    S, B_E, CB = WINDOW_ROWS, BLOCK_EDGES, CHUNK_BLOCKS
    dst_sorted = np.asarray(dst_sorted)
    n_windows = max(1, -(-n_rows // S))
    if dst_sorted.size == 0:  # no edges: all-padding plan
        return WindowPlan(
            edge_index=np.zeros(n_parts * CB * B_E, np.int64),
            valid=np.zeros(n_parts * CB * B_E, np.float32),
            local=np.zeros(n_parts * CB * B_E, np.int32),
            block_window=np.zeros(n_parts * CB, np.int32),
            n_blocks=1,
            n_blocks_p=n_parts * CB,
            n_chunks=n_parts,
            n_windows=n_windows,
            n_rows=n_rows,
            n_parts=n_parts,
            chunks_per_part=1,
        )
    win = dst_sorted // S
    cnt = np.bincount(win, minlength=n_windows).astype(np.int64)
    nb_per_win = -(-cnt // B_E)
    nb_per_win[cnt == 0] = 0
    n_blocks = int(nb_per_win.sum())
    block_win = np.repeat(
        np.arange(n_windows, dtype=np.int32), nb_per_win
    )
    blk_in_win = np.concatenate(
        [np.arange(k, dtype=np.int64) for k in nb_per_win if k > 0]
    )
    rem = cnt[block_win] - blk_in_win * B_E
    block_len = np.clip(rem, 0, B_E).astype(np.int64)
    win_start = np.zeros(n_windows + 1, np.int64)
    np.cumsum(cnt, out=win_start[1:])
    block_start = win_start[block_win] + blk_in_win * B_E

    # contiguous equal-count split of real blocks over parts, each part
    # padded to a common chunk multiple
    bounds = np.linspace(0, n_blocks, n_parts + 1).astype(np.int64)
    sizes = np.diff(bounds)
    L = max(1, int(-(-sizes.max() // CB)))
    bpp = L * CB  # padded blocks per part
    n_blocks_p = n_parts * bpp

    # padded-slot → real block id (-1 on padding blocks)
    part_block = np.full(n_blocks_p, -1, np.int64)
    pad_win = np.zeros(n_blocks_p, np.int32)
    last_win = np.int32(0)
    for d in range(n_parts):
        s, e = bounds[d], bounds[d + 1]
        lo = d * bpp
        part_block[lo : lo + (e - s)] = np.arange(s, e)
        if e > s:
            last_win = block_win[e - 1]
        pad_win[lo : lo + bpp] = last_win

    is_real = part_block >= 0
    safe = np.where(is_real, part_block, 0)
    b_len = np.where(is_real, block_len[safe], 0)
    b_start = np.where(is_real, block_start[safe], 0)
    b_win = np.where(is_real, block_win[safe], pad_win).astype(np.int32)

    off = np.tile(np.arange(B_E, dtype=np.int64), n_blocks_p)
    blk = np.repeat(np.arange(n_blocks_p, dtype=np.int64), B_E)
    valid = off < b_len[blk]
    edge_index = np.where(
        valid,
        b_start[blk] + np.minimum(off, np.maximum(b_len[blk] - 1, 0)),
        0,
    )
    # padding slots read edge 0's dst, so their local id may fall outside
    # [0, S): block_partials skips such slots
    local = (dst_sorted[edge_index] - b_win[blk] * S).astype(np.int32)

    return WindowPlan(
        edge_index=edge_index,
        valid=valid.astype(np.float32),
        local=local,
        block_window=b_win,
        n_blocks=n_blocks,
        n_blocks_p=n_blocks_p,
        n_chunks=n_parts * L,
        n_windows=n_windows,
        n_rows=n_rows,
        n_parts=n_parts,
        chunks_per_part=L,
    )


def windowed_gram_b(
    factors: torch.Tensor,  # (N_src_padded, K) f32
    src: torch.Tensor,  # (…, B_E) int32 — rows into `factors`
    w_b: torch.Tensor,  # (…, B_E) f32 — b-vector edge weights (0 on pads)
    w_g: torch.Tensor,  # (…, B_E) f32 — gram edge weights (0 on pads)
    local: torch.Tensor,  # (…, B_E) int32 — dst % S
    block_window: torch.Tensor,  # (n_blocks_p,) int32, sorted
    n_windows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused edge pass → (b (N_pad, K), gram_flat (N_pad, K²)).

    b[d]    = Σ_{e→d} w_b[e] · y[src[e]]
    gram[d] = Σ_{e→d} w_g[e] · y[src[e]] ⊗ y[src[e]]   (flattened K²)

    The per-edge arrays come as a plan lays them out, (P, L, CB, B_E)
    with P = 1, or already flat as (n_blocks_p, B_E). P > 1 raises: the
    sharded pass is not ported, and no single-part path stands in for
    it."""
    if src.dim() == 4 and src.shape[0] != 1:
        raise ValueError(
            f"a plan of {src.shape[0]} parts needs the sharded windowed "
            "pass, which the port does not have; plan with n_parts=1"
        )
    b_e = src.shape[-1]
    pb, pg = windowed_fused.block_partials(
        factors, *(a.reshape(-1, b_e) for a in (src, w_b, w_g, local)),
        s_rows=WINDOW_ROWS,
    )
    return windowed_fused.combine_windows(pb, pg, block_window, n_windows)


def flat_gram_matvec(a_flat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched (K×K)·(K,) matvec with the operator kept flat (N, K²):

        out[n, i] = Σ_j a_flat[n, i·K + j] · v[n, j]

    An elementwise product and a sum over the last axis, in plain f32:
    no matmul, so no TF32 can enter."""
    n, k2 = a_flat.shape
    k = v.shape[1]
    if k * k != k2:
        raise ValueError(f"operator width {k2} is not K² for K = {k}")
    return (a_flat.view(n, k, k) * v[:, None, :]).sum(-1)
