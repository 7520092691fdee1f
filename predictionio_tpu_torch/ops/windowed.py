"""The flat-operator matvec the ALS CG solve applies.

Counterpart of ``flat_gram_matvec`` in the JAX package's
``ops/windowed.py``; the dense path shares it with the windowed path.
The rest of that module (window planning and the windowed edge pass)
is not part of the port yet.
"""

from __future__ import annotations

import torch


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
