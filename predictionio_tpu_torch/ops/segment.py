"""Full-precision f32 products and the batched CG solve of the ALS
normal equations.

Counterpart of ``f32_gram`` and ``batched_cg`` in the JAX package's
``ops/segment.py``. The ``*edge_sum`` / ``edge_matvec`` family serves
the rank > 32 scatter path and is not part of the port yet.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Matrix products inside run in full f32: TF32 off for matmuls and
    cuDNN, whatever the process set, and restored on the way out. CG
    consumes these sums; TF32 keeps about three decimal digits."""
    mm = torch.backends.cuda.matmul.allow_tf32
    dnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


def f32_gram(a: torch.Tensor) -> torch.Tensor:
    """aᵀa at full float32 precision — CG needs exact Gram matrices."""
    with full_f32():
        return a.T @ a


def batched_cg(
    matvec,
    b: torch.Tensor,
    x0: torch.Tensor,
    iterations: int,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Batched conjugate gradient: solves A_i x_i = b_i for every row i
    with a shared matvec that applies all A_i at once. Fixed iteration
    count, unrolled; rows whose residual has reached float32 noise are
    frozen via `where` (iterating CG past convergence amplifies rounding
    error instead of reducing it)."""
    r0 = b - matvec(x0)
    rs0 = torch.sum(r0 * r0, dim=-1)
    tol = torch.clamp(rs0, min=1.0) * 1e-12  # relative f32 floor

    x, r, p, rs = x0, r0, r0, rs0
    for _ in range(iterations):
        live = rs > tol
        ap = matvec(p)
        alpha = torch.where(
            live, rs / (torch.sum(p * ap, dim=-1) + eps), 0.0
        )
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        rs_new = torch.where(live, torch.sum(r * r, dim=-1), rs)
        beta = torch.where(live, rs_new / (rs + eps), 0.0)
        p = torch.where(live[:, None], r + beta[:, None] * p, p)
        rs = rs_new
    return x
