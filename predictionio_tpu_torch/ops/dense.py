"""Dense-weight-matrix ALS edge pass: matrix products over a dense
rating matrix instead of per-edge gathers.

Counterpart of the JAX package's ``ops/dense.py``. Below ~1 % density
(MovieLens-20M: 20 M ratings over 138 k × 26.7 k) the rating matrix is
stored dense and each ALS half-step is two products over it:

    b     =  w1(R) @ Y         w1 = 1[r>0] + α·relu(r)   (implicit)
    gram  =  wg(R) @ Z         wg = α·|r|
         (explicit:  w1 = r, wg = 1[r≠0];  Z[i] = y_i ⊗ y_i flattened)

Zeros in R contribute exactly zero to every sum. The weights are
derived one block of ROW_BLOCK rows at a time, so they never exist at
full size. The row pass (solving R's rows) maps blocks to outputs; the
column pass contracts the same row blocks and accumulates.

These passes serve f32 and bf16 storage, as plain PyTorch: the JAX
package computes them as XLA dot products outside any Pallas kernel.
int8 storage trains through ``ops/dense_fused.py`` (one R read per
pass, a hand-written kernel on the card).

The JAX dots take bf16 operands with f32 results. ``torch.matmul`` on
bf16 tensors returns bf16, so bf16 operands are widened to f32 (exact)
and multiplied in f32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.ops.segment import full_f32

# rows of R processed per block; the weight tiles live in (ROW_BLOCK,
# n_cols) intermediates instead of full-matrix ones
ROW_BLOCK = 2048
# column quantum of the padded matrix
COL_PAD = 256

#: bytes per dense-R cell, by storage mode — the staging gate reads it
BYTES_PER_CELL = {"f32": 4, "bf16": 2, "int8": 1}


def storage_dtype(dense_dtype: str) -> torch.dtype:
    if dense_dtype == "int8":
        return torch.int8
    return torch.float32 if dense_dtype == "f32" else torch.bfloat16


def int8_scale(vals) -> Optional[float]:
    """Smallest power-of-two (or decimal) scale making every rating an
    exact int8, or None. ML-style ratings (half-star steps ≤ 5) get
    s=2; integer counts ≤ 127 get s=1. Exactness is required — the
    dense path must train the same weights the sparse path would."""
    m = float(np.max(np.abs(vals))) if len(vals) else 0.0
    if m == 0.0:
        return 1.0
    for s in (1.0, 2.0, 4.0, 8.0, 10.0, 16.0, 20.0, 32.0, 50.0, 64.0, 100.0):
        scaled = np.asarray(vals, np.float64) * s
        if m * s <= 127.0 and np.all(scaled == np.round(scaled)):
            return s
    return None


def _weights(r_blk: torch.Tensor, implicit: bool, alpha):
    """Per-block weight tiles, in the storage dtype's own arithmetic
    (each bf16 operation rounds to bf16, as in the JAX package).

    implicit (Hu-Koren-Volinsky, signed feedback):
      w1 = conf·pref = (1+α|r|)·1[r>0] = 1[r>0] + α·relu(r)
      wg = conf−1    = α·|r|
    explicit (ALS-WR):
      w1 = r, wg = 1[r≠0]  (staging rejects r==0 edges: a dense zero
      must mean "unobserved")
    """
    if implicit:
        a = torch.tensor(alpha, dtype=r_blk.dtype, device=r_blk.device)
        w1 = (r_blk > 0).to(r_blk.dtype) + a * torch.clamp(r_blk, min=0)
        wg = a * torch.abs(r_blk)
    else:
        w1 = r_blk
        wg = (r_blk != 0).to(r_blk.dtype)
    return w1, wg


def _storage(r: torch.Tensor) -> torch.dtype:
    """R's dtype: f32 or bf16 storage only."""
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"these passes take f32 or bf16 storage, got {r.dtype} "
            "(int8 storage runs ops.dense_fused)"
        )
    return r.dtype


def _yz(fixed: torch.Tensor, dt):
    """Cast factor operands: Y (N, K) and flattened outer products
    Z (N, K²), formed in f32 and then cast."""
    n, k = fixed.shape
    y = fixed.to(dt)
    z = (fixed[:, :, None] * fixed[:, None, :]).reshape(n, k * k).to(dt)
    return y, z


def dense_row_pass(
    r: torch.Tensor,  # (n_rows_p, n_cols_p) storage-dtype rating matrix
    fixed: torch.Tensor,  # (n_cols_p, K) f32 — the fixed side's factors
    *,
    implicit: bool,
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(b (n_rows_p, K), gram_corr_flat (n_rows_p, K²)) for R's rows."""
    n_rows = r.shape[0]
    k = fixed.shape[1]
    dt = _storage(r)
    y, z = _yz(fixed, dt)
    y, z = y.float(), z.float()  # exact widening
    b = torch.empty((n_rows, k), dtype=torch.float32, device=r.device)
    corr = torch.empty((n_rows, k * k), dtype=torch.float32, device=r.device)
    with full_f32():
        for s in range(0, n_rows, ROW_BLOCK):
            w1, wg = _weights(r[s : s + ROW_BLOCK], implicit, alpha)
            b[s : s + ROW_BLOCK] = w1.float() @ y
            corr[s : s + ROW_BLOCK] = wg.float() @ z
    return b, corr


def dense_col_pass(
    r: torch.Tensor,  # (n_rows_p, n_cols_p) — the same row-major storage
    fixed: torch.Tensor,  # (n_rows_p, K) f32 — factors of R's row side
    *,
    implicit: bool,
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(b (n_cols_p, K), gram_corr_flat (n_cols_p, K²)) for R's columns:
    contracts the same row blocks the row pass streams and accumulates
    over them in block order."""
    n_rows, n_cols = r.shape
    k = fixed.shape[1]
    dt = _storage(r)
    y, z = _yz(fixed, dt)
    y, z = y.float(), z.float()
    b = torch.zeros((n_cols, k), dtype=torch.float32, device=r.device)
    corr = torch.zeros((n_cols, k * k), dtype=torch.float32, device=r.device)
    with full_f32():
        for s in range(0, n_rows, ROW_BLOCK):
            w1, wg = _weights(r[s : s + ROW_BLOCK], implicit, alpha)
            b = b + w1.float().T @ y[s : s + ROW_BLOCK]
            corr = corr + wg.float().T @ z[s : s + ROW_BLOCK]
    return b, corr


def densify(
    rows: torch.Tensor,  # (E,) int64
    cols: torch.Tensor,  # (E,) int64
    vals: torch.Tensor,  # (E,) f32
    *,
    n_rows_p: int,
    n_cols_p: int,
    dense_dtype: str = "bf16",
    scale: float = 1.0,
) -> torch.Tensor:
    """Write the COO edge list into the dense padded rating matrix, on
    the device the edges are on. int8 mode stores round(r·scale)
    (round half to even, as the JAX package does; exactness is gated by
    int8_scale at staging). Requires unique (row, col) pairs — the
    staging gate checks."""
    st = storage_dtype(dense_dtype)
    r = torch.zeros((n_rows_p, n_cols_p), dtype=st, device=vals.device)
    if st == torch.int8:
        q = torch.round(vals * torch.tensor(scale, dtype=torch.float32,
                                            device=vals.device))
        r[rows, cols] = q.to(torch.int8)
    else:
        r[rows, cols] = vals.to(st)
    return r
