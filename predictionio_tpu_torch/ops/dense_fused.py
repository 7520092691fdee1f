"""The dense ALS half-step's edge pass with one read of int8 R per pass.

Counterpart of the JAX package's ``ops/dense_pallas.py``
(``fused_row_pass`` / ``fused_col_pass``). From each tile of the int8
rating matrix both weight tiles are derived in f32 and rounded to bf16:

    implicit:  w1 = 1[q>0] + a·relu(q)      wg = a·|q|       (a = α/s)
    explicit:  w1 = a·q                     wg = 1[q≠0]      (a = 1/s)

and both sums are taken against bf16-rounded factor operands with f32
accumulation: b = w1 @ Y (K wide) and corr = wg @ Z (K² wide), where
Z[i] = bf16(y_i ⊗ y_i), the outer product formed in f32 from the f32
factors. The row pass contracts R's columns (solving users); the column
pass contracts R's rows (solving items). int8 storage only.

On a CUDA tensor the wrappers launch the hand-written kernel in
``csrc/dense_pass.cu``; on a CPU tensor they run the plain PyTorch
versions below. There is no fallback from one to the other.

A bf16 × bf16 product is exact in f32, so the kernels and the plain
versions differ only in how the f32 sums are taken. Both kernels
multiply every cell on the tensor cores (zero cells add exact zeros for
finite factors; each symmetric pair of corr once) against the bf16
operand ``[Y16 | Z16]`` that `pass_operand` forms from the factors on
the contracted side, sum blocks of 128 along the contracted axis in the
mma accumulators and add the block sums in order; the col pass does so
per row chunk (the kernel's own choice, `col_pass_plan`) and then adds
the chunks in order.
The plain versions sum through f32 matrix products. The bound on that
difference is relative to the sum of the absolute terms, which the
plain versions compute when called with ``magnitude=True``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from predictionio_tpu_torch.obs import devprof
from predictionio_tpu_torch.ops.dense import ROW_BLOCK, pass_cost, pass_dtype
from predictionio_tpu_torch.ops.segment import full_f32

#: widest rank the kernel takes (models/als.py GRAM_SOLVER_MAX_RANK)
MAX_RANK = 32

#: operand columns of one CTA of either pass kernel (a column block of
#: the outputs); must equal TC_W in csrc/dense_pass.cu
OPERAND_BLOCK_COLS = 72

#: R rows of one CTA of the row pass kernel (a strip); must equal TC_ROWS
#: in csrc/dense_pass.cu
ROW_STRIP = 128

#: CTAs one launch may have on its 1-D grid
_MAX_GRID = 2**31 - 1

#: kernel launches through the wrappers in this process, by pass
PASS_LAUNCHES = {"row": 0, "col": 0}
_launch_lock = threading.Lock()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 (nearest, ties to even) and widen back."""
    return t.to(torch.bfloat16).to(torch.float32)


def _fused_weights(qf: torch.Tensor, a: torch.Tensor, implicit: bool):
    """The kernel's f32 weights, each operation rounded on its own, then
    rounded to bf16."""
    if implicit:
        w1 = (qf > 0).to(torch.float32) + a * torch.clamp(qf, min=0.0)
        wg = a * torch.abs(qf)
    else:
        w1 = a * qf
        wg = (qf != 0).to(torch.float32)
    return _bf16(w1), _bf16(wg)


def _plain_pass(r, x, ascale, implicit, rows, magnitude):
    n_rows, n_cols = r.shape
    k = x.shape[1]
    x16 = _bf16(x)
    z16 = _bf16((x[:, :, None] * x[:, None, :]).reshape(x.shape[0], k * k))
    if magnitude:
        x16, z16 = x16.abs(), z16.abs()
    a = torch.tensor(float(np.float32(ascale)), dtype=torch.float32,
                     device=r.device)
    n_out = n_rows if rows else n_cols
    b = torch.zeros((n_out, k), dtype=torch.float32, device=r.device)
    corr = torch.zeros((n_out, k * k), dtype=torch.float32, device=r.device)
    with full_f32():
        for s in range(0, n_rows, ROW_BLOCK):
            w1, wg = _fused_weights(r[s : s + ROW_BLOCK].float(), a, implicit)
            if magnitude:
                w1, wg = w1.abs(), wg.abs()
            if rows:
                b[s : s + ROW_BLOCK] = w1 @ x16
                corr[s : s + ROW_BLOCK] = wg @ z16
            else:
                b += w1.T @ x16[s : s + ROW_BLOCK]
                corr += wg.T @ z16[s : s + ROW_BLOCK]
    return b, corr


def fused_row_pass_plain(r, y, ascale, *, implicit, magnitude=False):
    """Plain PyTorch version of the row pass: per ROW_BLOCK rows, the
    f32 weights, rounded to bf16, times bf16-rounded Y and Z in f32.
    ``magnitude=True`` sums the absolute terms instead (|w|·|y|), the
    scale of the summation-order error."""
    return _plain_pass(r, y, ascale, implicit, True, magnitude)


def fused_col_pass_plain(r, x, ascale, *, implicit, magnitude=False):
    """Plain PyTorch version of the column pass (see
    `fused_row_pass_plain`)."""
    return _plain_pass(r, x, ascale, implicit, False, magnitude)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def pass_operand(y: torch.Tensor) -> torch.Tensor:
    """Both kernels' tensor-core B operand ``[Y16 | Z16]`` (n,
    `operand_column_blocks` · OPERAND_BLOCK_COLS) bf16 of the factors y
    (n, K) on the contracted side (column-side for the row pass, row-side
    for the col pass), formed once per call as the JAX wrapper forms its
    ``y16``/``z16``: bf16(y) in columns [0, K), then from K rounded up to
    8, bf16(y_i · y_j formed in f32) for the K(K+1)/2 pairs i ≤ j in
    row-major order (corr is symmetric: the kernels write each pair's sum
    to (i, j) and (j, i)), zeros elsewhere."""
    n, k = y.shape
    i, j = torch.triu_indices(k, k, device=y.device)
    pad_y = torch.zeros((n, _pad8(k) - k), dtype=y.dtype, device=y.device)
    pad_z = torch.zeros((n, operand_column_blocks(k) * OPERAND_BLOCK_COLS
                         - _pad8(k) - len(i)), dtype=y.dtype, device=y.device)
    return torch.cat([y, pad_y, y[:, i] * y[:, j], pad_z], 1).to(torch.bfloat16)


def operand_column_blocks(k: int) -> int:
    """Column blocks of OPERAND_BLOCK_COLS outputs the pass kernels split
    rank k into: b rounded up to 8 columns, then the K(K+1)/2 pairs of
    corr rounded up to 8 (one block up to K = 10, eight at K = 32)."""
    return -(-(_pad8(k) + _pad8(k * (k + 1) // 2)) // OPERAND_BLOCK_COLS)


def row_pass_ctas(n_rows: int, k: int) -> int:
    """CTAs of one row pass launch: one per strip of ROW_STRIP rows and
    column block, on a 1-D grid (the column blocks of a strip side by
    side). Raises if the grid cannot hold them (past 2^31 - 1, about 3.4e10
    rows at K = 32)."""
    ctas = -(-n_rows // ROW_STRIP) * operand_column_blocks(k)
    if ctas > _MAX_GRID:
        raise ValueError(f"{n_rows} rows at rank {k} need {ctas} CTAs, past "
                         f"the grid's {_MAX_GRID}")
    return ctas


def col_pass_plan(n_rows: int, n_cols: int, k: int,
                  device: torch.device) -> tuple[int, int]:
    """(chunk_rows, scratch floats) of one col pass launch on `device`,
    as the kernel chooses them (``dense_col_pass_plan``): R's rows split
    into chunks of whole 128-row stages that fill about four waves of
    CTAs, each chunk's sums of the operand columns held in scratch.
    Raises if the 1-D grid cannot hold the CTAs."""
    chunk_rows, floats = ctypes.c_longlong(), ctypes.c_longlong()
    err = _kernel_lib().dense_col_pass_plan(
        n_rows, n_cols, k, _device_index(device), ctypes.byref(chunk_rows),
        ctypes.byref(floats))
    if err:
        raise ValueError(f"no col pass launch for {n_rows} x {n_cols} at "
                         f"rank {k}: CUDA error {err}")
    return chunk_rows.value, floats.value


def _check(r, x, side, n_side):
    if r.dim() != 2 or r.dtype != torch.int8:
        raise ValueError(f"r must be a 2-D int8 matrix, got {r.dtype} "
                         f"{tuple(r.shape)}")
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[0] != n_side:
        raise ValueError(
            f"{side} factors must be f32 ({n_side}, K), got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if not 1 <= x.shape[1] <= MAX_RANK:
        raise ValueError(f"rank {x.shape[1]} outside 1..{MAX_RANK}")
    if x.device != r.device:
        raise ValueError(f"factors on {x.device}, r on {r.device}")


def fused_row_pass(
    r: torch.Tensor,  # (n_rows, n_cols) int8
    y: torch.Tensor,  # (n_cols, K) f32 — column-side factors
    ascale: float,  # α/s (implicit) or 1/s (explicit), an f32 value
    *,
    implicit: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(b (n_rows, K), corr (n_rows, K²)) f32 for R's rows. CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    _check(r, y, "column-side", r.shape[1])
    if r.device.type == "cpu":
        return fused_row_pass_plain(r, y, ascale, implicit=implicit)
    return _launch("row", r, y, ascale, implicit)


def fused_col_pass(
    r: torch.Tensor,  # (n_rows, n_cols) int8
    x: torch.Tensor,  # (n_rows, K) f32 — row-side factors
    ascale: float,
    *,
    implicit: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(b (n_cols, K), corr (n_cols, K²)) f32 for R's columns. CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    _check(r, x, "row-side", r.shape[0])
    if r.device.type == "cpu":
        return fused_col_pass_plain(r, x, ascale, implicit=implicit)
    return _launch("col", r, x, ascale, implicit)


# the JAX package's names for the dense passes (``ops/dense.py``'s f32
# and bf16 passes record under them too)
fused_row_pass = devprof.instrument("ops.dense_row_pass", fused_row_pass,
                                    cost=pass_cost("row"), dtype_of=pass_dtype)
fused_col_pass = devprof.instrument("ops.dense_col_pass", fused_col_pass,
                                    cost=pass_cost("col"), dtype_of=pass_dtype)


# ---------------------------------------------------------------------------
# the CUDA launch
# ---------------------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from predictionio_tpu_torch.ops import _build

        lib = _build.load("dense_pass")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dense_row_pass.argtypes = [i, p, p, ctypes.c_float, ll, ll, i,
                                       p, p, i, p]
        lib.dense_col_pass.argtypes = [i, p, p, ctypes.c_float, ll, ll, i,
                                       p, p, p, i, p]
        lib.dense_col_pass_plan.argtypes = [ll, ll, i, i, p, p]
        lib.dense_row_pass.restype = lib.dense_col_pass.restype = i
        lib.dense_col_pass_plan.restype = i
        _lib = lib
    return _lib


def _device_index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _launch(which, r, x, ascale, implicit):
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if not (r.is_contiguous() and x.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous tensors only")
    n_rows, n_cols = r.shape
    k = x.shape[1]
    n_out = n_rows if which == "row" else n_cols
    lib = _kernel_lib()
    b = torch.empty((n_out, k), dtype=torch.float32, device=r.device)
    corr = torch.empty((n_out, k * k), dtype=torch.float32, device=r.device)
    dims = [float(np.float32(ascale)), n_rows, n_cols, k]
    if which == "row":
        row_pass_ctas(n_rows, k)
        fn = lib.dense_row_pass
        tail = []
    else:  # the col pass sums row chunks apart, then in order
        _, size = col_pass_plan(n_rows, n_cols, k, r.device)
        scratch = torch.empty(size, dtype=torch.float32, device=r.device)
        fn = lib.dense_col_pass
        tail = [scratch.data_ptr()]
    op = pass_operand(x)  # the tensor-core B operand, formed once per call
    args = [int(implicit), r.data_ptr(), op.data_ptr(), *dims, b.data_ptr(),
            corr.data_ptr(), *tail]
    err = fn(*args, _device_index(r.device),
             torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"dense {which} pass kernel launch failed: CUDA error {err}"
        )
    with _launch_lock:
        PASS_LAUNCHES[which] += 1
    return b, corr
