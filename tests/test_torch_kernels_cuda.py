"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Needs a CUDA device and nvcc; skips without a
card (a CUDA kernel has no CPU mode). Imports no jax, so it runs where
only the port is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

The kernel and the plain version do the same rounded operations, so
indices AND values must be equal, for every k up to the padded width.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import recommend as rec

pytestmark = pytest.mark.cuda

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda:0")


def _inputs(rng, dtype, b, n_items, kdim, scaled, mask_kind, dev):
    i_p = rec.pad_items(n_items)
    uf = rng.standard_normal((b, kdim)).astype(np.float32)
    itf = np.zeros((i_p, kdim), np.float32)
    itf[:n_items] = rng.standard_normal((n_items, kdim))
    qs = isc = None
    if dtype == "int8":
        uf, us = rec.quantize_rows_np(uf)
        iq, iscale = rec.quantize_rows_np(itf[:n_items])
        itf = np.zeros((i_p, kdim), np.int8)
        itf[:n_items] = iq
        qs = us[:, None]
        isc = np.ones((1, i_p), np.float32)
        isc[0, :n_items] = iscale
    elif scaled:
        qs = rng.uniform(0.5, 2.0, (b, 1)).astype(np.float32)
        isc = rng.uniform(0.5, 2.0, (1, i_p)).astype(np.float32)
    bits = rows = None
    if mask_kind == "bits":
        mask = rng.random((b, n_items)) < 0.5
        mask[0] = True
        bits = rec.pack_mask_np(mask, i_p)
    elif mask_kind == "rows":
        rows = np.full((b, rec.ROWLIST_MAX), -1, np.int32)
        rows[:, :40] = rng.integers(0, n_items, (b, 40))

    def put(a, dt=None):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t.to(dt) if dt is not None else t

    return (put(uf, TORCH_DT[dtype]), put(itf, TORCH_DT[dtype]), put(qs),
            put(isc), put(bits), put(rows))


@pytest.mark.parametrize("mask_kind", [None, "bits", "rows"])
@pytest.mark.parametrize("dtype,scaled", [("f32", False), ("f32", True),
                                          ("bf16", False), ("bf16", True),
                                          ("int8", True)])
def test_kernel_equals_plain(card, dtype, scaled, mask_kind):
    rng = np.random.default_rng(0)
    for b, n_items, kdim in ((1, 100, 3), (3, 1100, 10), (64, 5000, 10),
                             (130, 3000, 16)):
        args = _inputs(rng, dtype, b, n_items, kdim, scaled, mask_kind, card)
        i_p = rec.pad_items(n_items)
        for k in sorted({1, 7, min(128, i_p), min(1024, i_p), n_items, i_p}):
            before = rec.LAUNCHES
            kv, ki = rec.fused_recommend_topk(*args, k=k, n_items=n_items)
            pv, pi = rec.fused_recommend_topk_plain(*args, k=k, n_items=n_items)
            torch.cuda.synchronize()
            assert rec.LAUNCHES == before + 1
            assert torch.equal(ki, pi), (b, n_items, k)
            assert torch.equal(kv, pv), (b, n_items, k)


def test_kernel_ties_and_batch_invariance(card):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(-1, 2, (64, 4)).astype(np.float32)).to(card)
    itf = torch.from_numpy(rng.integers(-1, 2, (4096, 4)).astype(np.float32)).to(card)
    for k in (10, 1000, 4096):
        kv, ki = rec.fused_recommend_topk(q, itf, k=k, n_items=4000)
        pv, pi = rec.fused_recommend_topk_plain(q, itf, None, None, None, None,
                                                k=k, n_items=4000)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)
        one = rec.fused_recommend_topk(q[:1].contiguous(), itf, k=k, n_items=4000)
        assert torch.equal(one[0][0], kv[0]) and torch.equal(one[1][0], ki[0])


def test_kernel_rejects_noncontiguous(card):
    itf = torch.zeros((256, 4), device=card)
    q = torch.zeros((8, 8), device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        rec.fused_recommend_topk(q, itf, k=3, n_items=200)
