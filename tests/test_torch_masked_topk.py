"""Port parity for the precomputed-score selector (``fused_masked_topk``).

The same scores and exclusions, made with numpy from a seed, go through
the JAX package's ``ops/recommend_pallas.fused_masked_topk`` (its Pallas
kernel in interpret mode) and the port's ``ops/recommend.
fused_masked_topk`` on the CPU, which runs the plain PyTorch version.
The selector only selects, so indices must be equal and values equal
within rtol 1e-6 (the bars of tests/test_fused_serving.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.ops import recommend_pallas as jrp  # noqa: E402
from predictionio_tpu_torch.ops import recommend as trp  # noqa: E402

B, N_ITEMS = 8, 300
I_P = jrp.pad_items(N_ITEMS)  # 384: three 128-wide tiles in the JAX kernel


def _case(seed, mask_kind):
    """(scores (B, I_P) f32, bits, rows) with dead pads, a fully masked
    row under bits, an all-zero row, and ties across tiles."""
    rng = np.random.default_rng(seed)
    # quarter steps: many exact ties inside and across tiles
    scores = (rng.integers(-8, 9, (B, I_P)) / 4.0).astype(np.float32)
    scores[:, N_ITEMS:] = rng.standard_normal((B, I_P - N_ITEMS))  # dead pads
    scores[2] = 0.0  # a user with no history: every item scores 0
    scores[3, :5] = -0.0
    # crafted equal maxima in all three tiles
    scores[4, [7, 135, 263]] = 9.0
    bits = rows = None
    if mask_kind == "bits":
        mask = rng.random((B, N_ITEMS)) < 0.4
        mask[0] = True  # a fully masked row
        bits = jrp.pack_mask_np(mask, I_P)
    elif mask_kind == "rows":
        rows = np.full((B, 8), -1, np.int32)
        rows[:, :5] = rng.integers(0, N_ITEMS, (B, 5))
        rows[4, :2] = [135, 7]  # two of the crafted maxima
        rows[1, 5] = I_P + 7  # out of range: inert
    return scores, bits, rows


def _torch(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _jax(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("k", [1, 17, N_ITEMS])
@pytest.mark.parametrize("mask_kind", [None, "bits", "rows"])
def test_masked_topk_matches_jax_interpret(mask_kind, k):
    scores, bits, rows = _case(3, mask_kind)
    jv, ji = jrp.fused_masked_topk(
        _jax(scores), _jax(bits), _jax(rows), k=k, n_items=N_ITEMS,
        interpret=True,
    )
    tv, ti = trp.fused_masked_topk(
        _torch(scores), _torch(bits), _torch(rows), k=k, n_items=N_ITEMS
    )
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    if mask_kind == "bits":  # the fully masked row lists items in order
        assert (tv[0].numpy() == np.float32(trp.NEG_INF)).all()
        assert np.array_equal(ti[0].numpy(), np.arange(k))


def test_masked_topk_past_n_items_matches_xla_tail():
    """k > n_items: the reference kernel leaves those slots at its fill
    index (ROADMAP Queue 3), so they are held to the XLA-style tail,
    which orders the dead pad columns by index below every masked item."""
    scores, bits, _ = _case(4, "bits")
    # lax.top_k orders -0.0 below +0.0; the kernels (the reference's and
    # the port's) take them as one value (ROADMAP Queue 3)
    scores = scores + np.float32(0.0)
    k = I_P
    s = jnp.where(jrp.unpack_mask_jnp(jnp.asarray(bits), I_P), jrp.NEG_INF,
                  jnp.asarray(scores))
    col = jnp.arange(I_P)
    s = jnp.where((col >= N_ITEMS)[None, :], jnp.finfo(jnp.float32).min, s)
    jv, ji = jax.lax.top_k(s, k)
    tv, ti = trp.fused_masked_topk(_torch(scores), _torch(bits), k=k,
                                   n_items=N_ITEMS)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    assert (ti[:, N_ITEMS:].numpy() >= N_ITEMS).all()


def test_masked_topk_rows_equal_bits():
    """A short row list and the same exclusions as packed words select
    the same items."""
    scores, _, rows = _case(5, "rows")
    mask = np.zeros((B, I_P), bool)
    for b in range(B):
        live = rows[b][(rows[b] >= 0) & (rows[b] < I_P)]
        mask[b, live] = True
    bits = trp.pack_mask_np(mask, I_P)
    a = trp.fused_masked_topk(_torch(scores), exclude_rows=_torch(rows), k=40,
                              n_items=N_ITEMS)
    b = trp.fused_masked_topk(_torch(scores), mask_bits=_torch(bits), k=40,
                              n_items=N_ITEMS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("bad", ["k0", "k_big", "both", "width", "dtype",
                                 "pad", "wide_rows", "bits_shape"])
def test_masked_topk_rejects(bad):
    scores, bits, rows = _case(6, "bits")
    _, _, rows = _case(6, "rows")
    s = _torch(scores)
    kw = {"k": 5, "n_items": N_ITEMS}
    args = {"k0": ((s,), {**kw, "k": 0}),
            "k_big": ((s,), {**kw, "k": I_P + 1}),
            "both": ((s, _torch(bits), _torch(rows)), kw),
            "width": ((s[:, :300].contiguous(),), kw),
            "dtype": ((s.double(),), kw),
            "pad": ((torch.zeros((B, 200)),), kw),
            "wide_rows": ((s, None, torch.full((B, 65), -1, dtype=torch.int32)), kw),
            "bits_shape": ((s, _torch(bits)[:, :3].contiguous()), kw)}[bad]
    with pytest.raises(ValueError):
        trp.fused_masked_topk(*args[0], **args[1])


def test_masked_topk_empty_row_list_excludes_nothing():
    scores, _, _ = _case(7, None)
    a = trp.fused_masked_topk(_torch(scores), k=9, n_items=N_ITEMS)
    b = trp.fused_masked_topk(_torch(scores),
                              exclude_rows=torch.zeros((B, 0), dtype=torch.int32),
                              k=9, n_items=N_ITEMS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the card's routes and scratch (sizing only: the kernels run on the card)
# ---------------------------------------------------------------------------


def _csrc_constant(name):
    import re
    from pathlib import Path

    src = (Path(trp.__file__).parent / "csrc" / "recommend_topk.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_select_constants_match_the_kernel_source():
    assert trp.SELECT_SEGMENT == _csrc_constant("SEGMENT")
    assert trp.SELECT_MAX_K == _csrc_constant("SELECT_MAX_K")
    assert trp._CHUNK == _csrc_constant("CHUNK")


@pytest.mark.parametrize("k,route", [(1, "select"), (64, "select"),
                                     (1023, "select"), (1024, "select"),
                                     (1025, "sort"), (100_000, "sort")])
def test_masked_route_by_k(k, route):
    """k up to SELECT_MAX_K takes the two-launch select route, larger k
    the chunk sort and merge tree (pass 1, merge levels, emit)."""
    assert trp.topk_route(k) == route
    if route == "sort":
        # the sort route's pass 1 and merge levels at the UR catalog's I_p
        levels = trp.merge_levels(100_096, k)
        assert levels[0] == (98, min(k, trp._CHUNK)) and levels[-1][0] == 1
        if k == 100_000:
            assert len(levels) == 8  # 98 chunks: 7 merge levels


@pytest.mark.parametrize("b,i_p,k", [(1, 128, 1), (64, 100_096, 64),
                                     (8, 4096, 1024), (3, 4224, 1000),
                                     (2, 12_416, 7), (1, 1024, 1024)])
def test_select_scratch_holds_k_slots_per_segment(b, i_p, k):
    """One row of k key slots per SELECT_SEGMENT columns, the last
    segment short (4224 = 4096 + 128) or the only one (I_p below a
    segment); every segment's top min(k, its columns) fits its slots."""
    n_seg = -(-i_p // trp.SELECT_SEGMENT)
    assert trp.select_scratch_keys(i_p, k) == n_seg * k
    widths = [min(trp.SELECT_SEGMENT, i_p - s * trp.SELECT_SEGMENT)
              for s in range(n_seg)]
    assert sum(widths) == i_p and min(widths) > 0
    # the row pass selects k of the candidates: there are at least k
    assert sum(min(k, w) for w in widths) >= k


def test_cpu_path_counts_no_masked_launch():
    before = (trp.MASKED_LAUNCHES, dict(trp.MASKED_ROUTE_LAUNCHES))
    scores, bits, _ = _case(7, "bits")
    trp.fused_masked_topk(_torch(scores), _torch(bits), k=5, n_items=N_ITEMS)
    assert (trp.MASKED_LAUNCHES, trp.MASKED_ROUTE_LAUNCHES) == before
