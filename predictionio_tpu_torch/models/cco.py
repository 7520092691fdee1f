"""Correlated cross-occurrence (CCO) with log-likelihood-ratio scoring:
the Universal Recommender's train and its batched history scoring.

Counterpart of the JAX package's ``models/cco.py`` (external template
actionml/template-scala-parallel-universal-recommendation, which
delegates to Mahout's SimilarityAnalysis.cooccurrences).

Train: the cross-occurrence counts between a primary interaction matrix
P (users × items) and a secondary indicator matrix S (users × things)
are exactly PᵀS on 0/1 indicators, one ``torch.matmul`` per item block.
Dunning's LLR then scores every (item, thing) pair, and each item keeps
its strongest correlators. Items are processed in blocks and each block
in row chunks, so the count matrix and the LLR temporaries stay bounded
at a 100,000-item catalog.

Serving: ``batch_score_topk`` scores a whole query batch against the
correlator tables on the device (a sum of LLR over the correlators in
each user's history) and selects through ``ops.recommend.
fused_masked_topk``, the hand-written exclusion + top-k kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.recommend import (
    ROWLIST_MAX,
    fused_masked_topk,
    pack_mask_np,
    pad_items,
)
from predictionio_tpu_torch.ops.topk import NEG_INF, top_k_ordered

#: f32 elements of one row chunk of a block's count matrix that go
#: through LLR and top-n at a time; the LLR holds about ten temporaries
#: of this size (2^27 elements: 512 MB each)
LLR_CHUNK_ELEMS = 1 << 27


def _x_log_x(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x * torch.log(torch.clamp_min(x, 1e-30)), 0.0)


def llr_scores(
    k11: torch.Tensor,  # (I, J) co-occurrence counts
    prim_totals: torch.Tensor,  # (I,) per-item event totals
    sec_totals: torch.Tensor,  # (J,) per-thing event totals
    n_users,  # user count, float or 0-d tensor
) -> torch.Tensor:
    """Dunning log-likelihood ratio of the 2×2 contingency per pair, in
    the JAX package's order of operations. Every count is an integer
    below 2^24, so k12, k21 and k22 are exact; the entropy terms are of
    size N·log N and cancel to values of order 1-100, so the result
    carries an absolute error of a few ulps of N·log N."""
    n = torch.as_tensor(n_users, dtype=torch.float32, device=k11.device)
    k12 = prim_totals[:, None] - k11
    k21 = sec_totals[None, :] - k11
    k22 = n - k11 - k12 - k21
    row_entropy = _x_log_x(k11 + k12) + _x_log_x(k21 + k22)
    col_entropy = _x_log_x(k11 + k21) + _x_log_x(k12 + k22)
    mat_entropy = (
        _x_log_x(k11) + _x_log_x(k12) + _x_log_x(k21) + _x_log_x(k22)
    )
    llr = 2.0 * (mat_entropy - row_entropy - col_entropy + _x_log_x(n))
    return torch.clamp_min(llr, 0.0)


def cooccurrence_counts(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """(I_blk, J) = Pᵀ S over the user axis. P and S hold 0 and 1, so
    every product is exact and every sum is an integer below 2^24: the
    result is exact in f32, TF32 or bf16 inputs with f32 sums, in any
    summation order, so the card and the CPU give the same bits."""
    return primary.T @ secondary


def llr_topn(
    counts: torch.Tensor,  # (I_blk, J) co-occurrence counts
    prim_totals: torch.Tensor,  # (I_blk,)
    sec_totals: torch.Tensor,  # (J,)
    n_users: int,
    diag_offset: int,
    *,
    top_n: int,
    exclude_diagonal: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LLR, exclusion and top-n of one block, in row chunks of at most
    LLR_CHUNK_ELEMS elements. Pairs that never co-occur, and with
    `exclude_diagonal` the global diagonal (row diag_offset + r, column
    r), are excluded; a correlator with LLR 0 gets index -1. Returns
    (values (I_blk, top_n) f32, indices (I_blk, top_n) int32)."""
    n_rows, n_cols = counts.shape
    step = max(1, LLR_CHUNK_ELEMS // max(n_cols, 1))
    vals = torch.empty((n_rows, top_n), dtype=torch.float32, device=counts.device)
    idx = torch.empty((n_rows, top_n), dtype=torch.int32, device=counts.device)
    for r0 in range(0, n_rows, step):
        r1 = min(r0 + step, n_rows)
        c = counts[r0:r1]
        llr = llr_scores(c, prim_totals[r0:r1], sec_totals, n_users)
        exclude = c <= 0  # never correlate never-co-occurring pairs
        if exclude_diagonal:
            r = torch.arange(r0, r1, device=c.device)[:, None] + diag_offset
            col = torch.arange(n_cols, device=c.device)[None, :]
            exclude |= r == col
        llr.masked_fill_(exclude, NEG_INF)
        del exclude
        v, i = top_k_ordered(llr, top_n)
        vals[r0:r1] = v
        idx[r0:r1] = torch.where(v > 0.0, i, -1).to(torch.int32)
    return vals, idx


def _cco_topn(
    primary: torch.Tensor,  # (U, I_blk) 0/1
    secondary: torch.Tensor,  # (U, J) 0/1
    n_users: int,
    diag_offset: int,
    *,
    top_n: int,
    exclude_diagonal: bool,
    sec_totals: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One item block: counts, LLR and top-n (the JAX `_cco_topn`)."""
    counts = cooccurrence_counts(primary, secondary)
    prim_totals = primary.sum(dim=0)
    if sec_totals is None:
        sec_totals = secondary.sum(dim=0)
    return llr_topn(
        counts, prim_totals, sec_totals, n_users, diag_offset,
        top_n=top_n, exclude_diagonal=exclude_diagonal,
    )


def edges_to_indicator(
    rows, cols, n_rows: int, n_cols: int, device=None
) -> torch.Tensor:
    """Binarized dense (n_rows, n_cols) f32 indicator matrix from an edge
    list, built on the device (the first CUDA device by default)."""
    dev = resolve_device(device)
    m = torch.zeros((n_rows, n_cols), dtype=torch.float32, device=dev)
    r = torch.as_tensor(np.asarray(rows, np.int64)).to(dev)
    c = torch.as_tensor(np.asarray(cols, np.int64)).to(dev)
    m[r, c] = 1.0
    return m


def cross_occurrence_topn(
    primary,  # (U, I) 0/1, numpy or tensor
    secondary,  # (U, J) 0/1
    top_n: int,
    self_indicator: bool = False,
    mesh=None,
    block_items: int = 8192,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per primary item: top correlator columns of `secondary` by LLR.

    Returns (scores (I, top_n) f32, indices (I, top_n) int32) with -1
    index padding. `self_indicator` excludes the diagonal. Items are
    processed in `block_items`-column blocks; rows are independent
    through LLR and top-n, so blocking is exact. Tensors stay on their
    device; numpy inputs go to `device` (the first CUDA device by
    default). A `mesh` (the JAX package's user-sharded counts) is not
    ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "the user-sharded CCO train (mesh) is not ported yet"
        )
    dev = (primary.device if isinstance(primary, torch.Tensor)
           else resolve_device(device))
    p = torch.as_tensor(primary, dtype=torch.float32).to(dev)
    s = torch.as_tensor(secondary, dtype=torch.float32).to(dev)
    top_n = min(top_n, s.shape[1])
    n_users, n_items = p.shape
    sec_totals = s.sum(dim=0)
    out_vals = np.empty((n_items, top_n), np.float32)
    out_idx = np.empty((n_items, top_n), np.int32)
    for lo in range(0, n_items, block_items):
        hi = min(lo + block_items, n_items)
        vals, idx = _cco_topn(
            p[:, lo:hi], s, n_users, lo, top_n=top_n,
            exclude_diagonal=self_indicator, sec_totals=sec_totals,
        )
        out_vals[lo:hi] = vals.cpu().numpy()
        out_idx[lo:hi] = idx.cpu().numpy()
    return out_vals, out_idx


def score_history(
    correlator_idx: np.ndarray,  # (I, top_n) int, -1 padded
    correlator_scores: np.ndarray,  # (I, top_n)
    history: np.ndarray,  # (H,) int — the user's recent things for this indicator
) -> np.ndarray:
    """Host-side single-query scoring: per-item sum of LLR over correlators
    present in the user's history. The reference the batched device path
    (batch_score_topk) is tested against."""
    if len(history) == 0:
        return np.zeros(correlator_idx.shape[0], dtype=np.float32)
    hit = np.isin(correlator_idx, history) & (correlator_idx >= 0)
    return np.where(hit, correlator_scores, 0.0).sum(axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# device-side batched serving
# ---------------------------------------------------------------------------


def history_scores(
    corr_idx: tuple,  # per indicator: (I, T_m) int32, -1 padded
    corr_scores: tuple,  # per indicator: (I, T_m) f32
    histories: tuple,  # per indicator: (B, H_m) int, -1 padded
    j_sizes: tuple,  # per indicator: its target-vocab size J_m
    width: int,  # columns of the result: n_items, or the padded width
) -> torch.Tensor:
    """(B, width) f32 scores of a query batch: per indicator, a (B, J+1)
    membership table of each user's history, read at every item's
    correlators and weighted by their LLR; columns past n_items are 0.

    Each item's score is ONE fixed-order chain over the correlators
    t = 0..T-1 and then over the indicators, a multiply (by 0 or 1,
    exact) and an add, each rounded on its own (as
    `ops.recommend.plain_scores`): the card and the CPU give the same
    bits, and a query's scores do not depend on its batch."""
    n_items = int(corr_idx[0].shape[0])
    bsz = int(histories[0].shape[0])
    dev = corr_idx[0].device
    total = torch.zeros((bsz, width), dtype=torch.float32, device=dev)
    for idx, sc, hist, j in zip(corr_idx, corr_scores, histories, j_sizes):
        hist = hist.long()
        member = torch.zeros((bsz, j + 1), dtype=torch.float32, device=dev)
        member.scatter_(1, torch.where(hist >= 0, hist, j), 1.0)
        member[:, j] = 0.0  # the -1 padding slot is inert
        live = idx >= 0
        safe = torch.where(live, idx, j).long().T.contiguous()  # (T, I)
        w = torch.where(live, sc, 0.0).T.contiguous()
        acc = None
        for t in range(safe.shape[0]):
            term = member.index_select(1, safe[t]) * w[t]
            acc = term if acc is None else acc + term
        if acc is not None:
            total[:, :n_items] += acc
    return total


def _batch_score_topk(
    corr_idx: tuple,
    corr_scores: tuple,
    histories: tuple,
    exclude: torch.Tensor,  # (B, E) int32 rows / (B, I_p/32) int32 words
    *,
    j_sizes: tuple,
    k: int,
    packed: bool = False,  # exclude arrived as bit-packed mask words
):
    """One query batch on the device: `history_scores` at the padded
    width, then exclusion and top-k through the fused selector."""
    n_items = int(corr_idx[0].shape[0])
    total = history_scores(corr_idx, corr_scores, histories, j_sizes,
                           pad_items(n_items))
    return fused_masked_topk(
        total,
        mask_bits=exclude if packed else None,
        exclude_rows=None if packed else exclude,
        k=k, n_items=n_items,
    )


def batch_score_topk(
    indicator_tables: list,  # [(corr_idx, corr_scores, J), ...], tensors or numpy
    histories: list,  # per indicator: (B, H) int32 np, -1 padded
    exclude: np.ndarray,  # (B, E) int32, -1 padded (item space)
    k: int,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched UR history scoring + exclusion + top-k. Returns (scores
    (B, k), item indices (B, k) int32); entries with score <= 0 carry no
    LLR evidence (callers filter positive-only).

    The tail is the fused selector (`fused_masked_topk`: the kernel on
    the card, its plain version on the CPU) at the padded width.
    Exclusion sets up to ROWLIST_MAX wide ride it as row lists; wider
    ones are bit-packed on the host. Tables that are tensors stay on
    their device; numpy tables go to `device` (the first CUDA device by
    default)."""
    first = indicator_tables[0][0]
    dev = (first.device if isinstance(first, torch.Tensor)
           else resolve_device(device))
    exclude = np.asarray(exclude, np.int32)
    packed = exclude.shape[1] > ROWLIST_MAX
    ex_dev = exclude
    if packed:
        n_items = int(first.shape[0])
        i_p = pad_items(n_items)
        mask = np.zeros((exclude.shape[0], i_p), bool)
        live = (exclude >= 0) & (exclude < i_p)
        mask[np.nonzero(live)[0], exclude[live]] = True
        ex_dev = pack_mask_np(mask, i_p)
    vals, idx = _batch_score_topk(
        tuple(torch.as_tensor(t[0]).to(dev) for t in indicator_tables),
        tuple(torch.as_tensor(t[1]).to(dev) for t in indicator_tables),
        tuple(torch.as_tensor(np.asarray(h)).to(dev) for h in histories),
        torch.from_numpy(np.ascontiguousarray(ex_dev)).to(dev),
        j_sizes=tuple(int(t[2]) for t in indicator_tables),
        k=k, packed=packed,
    )
    return vals.cpu().numpy(), idx.cpu().numpy()
