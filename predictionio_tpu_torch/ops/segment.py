"""Segment reductions over edge lists, full-precision f32 products and
the batched CG solve of the ALS normal equations.

Counterpart of the JAX package's ``ops/segment.py``. Training data is a
COO edge list (src, dst, weight), and every normal-equation product
reduces per-edge terms into per-row sums. The ``*edge_sum`` /
``edge_matvec`` family serves the rank > 32 scatter path; as in the
JAX package, where XLA computes them, they are plain tensor code here
(a gather, elementwise products and ``index_add_``), no kernel of the
port's own. ``index_add_`` on a CUDA tensor adds with atomics, so the
order of its sums, and their last bits, vary between runs.
"""

from __future__ import annotations

import contextlib

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = Σ_{e: segment_ids[e] = s} data[e], for s < num_segments."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids, data)


def weighted_edge_sum(factors, src_idx, dst_idx, weights, num_dst):
    """out[d] = Σ_{e: dst_idx[e] = d} weights[e] · factors[src_idx[e]] — the
    right-hand side of the ALS normal equations, b_u = Σ c_ui y_i."""
    return segment_sum(factors[src_idx] * weights[:, None], dst_idx, num_dst)


def edge_matvec(factors, v, src_idx, dst_idx, weights, num_dst):
    """out[d] = Σ_e w_e · y_{src_e} (y_{src_e} · v_d) over the edges of d:
    the matrix-free normal-equation matvec, which applies the per-row
    Gram correction Σ w y yᵀ without building any K×K matrix."""
    y_e = factors[src_idx]
    s = torch.sum(y_e * v[dst_idx], dim=-1)
    return segment_sum(y_e * (weights * s)[:, None], dst_idx, num_dst)


def _chunks(n_chunks, *arrays):
    """The edge arrays cut into n_chunks equal contiguous slices (E must
    divide by n_chunks; pad upstream with weight-0 edges)."""
    return zip(*(a.reshape(n_chunks, -1) for a in arrays))


def chunked_weighted_edge_sum(factors, src_idx, dst_idx, weights, num_dst,
                              n_chunks):
    """`weighted_edge_sum` over `n_chunks` contiguous slices of the edge
    list, each chunk's sum added to the running (num_dst, K) total: the
    (E, K) gather stays chunk-sized."""
    if n_chunks <= 1:
        return weighted_edge_sum(factors, src_idx, dst_idx, weights, num_dst)
    acc = torch.zeros((num_dst, factors.shape[1]), dtype=factors.dtype,
                      device=factors.device)
    for s, d, w in _chunks(n_chunks, src_idx, dst_idx, weights):
        acc = acc + segment_sum(factors[s] * w[:, None], d, num_dst)
    return acc


def chunked_edge_matvec(factors, v, src_idx, dst_idx, weights, num_dst,
                        n_chunks):
    """`edge_matvec` over the edge list in chunks (see
    `chunked_weighted_edge_sum`)."""
    if n_chunks <= 1:
        return edge_matvec(factors, v, src_idx, dst_idx, weights, num_dst)
    acc = torch.zeros((num_dst, factors.shape[1]), dtype=factors.dtype,
                      device=factors.device)
    for s, d, w in _chunks(n_chunks, src_idx, dst_idx, weights):
        y_e = factors[s]
        dot = torch.sum(y_e * v[d], dim=-1)
        acc = acc + segment_sum(y_e * (w * dot)[:, None], d, num_dst)
    return acc


def chunked_gram_edge_sum(factors, src_idx, dst_idx, weights, num_dst,
                          n_chunks):
    """A_flat[d] = Σ_{e: dst_e = d} w_e · (y_{src_e} ⊗ y_{src_e}), flattened
    to (num_dst, K²): one edge pass builds every row's normal-equation
    operator."""
    k = factors.shape[1]

    def one(s, d, w):
        y = factors[s]
        outer = (y * w[:, None])[:, :, None] * y[:, None, :]
        return segment_sum(outer.reshape(y.shape[0], k * k), d, num_dst)

    if n_chunks <= 1:
        return one(src_idx, dst_idx, weights)
    acc = torch.zeros((num_dst, k * k), dtype=factors.dtype,
                      device=factors.device)
    for s, d, w in _chunks(n_chunks, src_idx, dst_idx, weights):
        acc = acc + one(s, d, w)
    return acc


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
