"""Port parity for the fused score+top-k selector and its helpers.

The same inputs, made with numpy from a seed, go through the JAX
package's ``ops/recommend_pallas.py`` (its Pallas kernel in interpret
mode, and the XLA two-step) and the port's ``ops/recommend.py`` on the
CPU, which runs the plain PyTorch version. Factors are multiples of
1/8 (int8 factors are integers), so every score is exact in f32 in any
summation order: indices and values must be EQUAL, ties included.
Scaled modes multiply by arbitrary f32 scales in the same order on both
sides, so they stay exact too.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.ops import recommend_pallas as jrp  # noqa: E402
from predictionio_tpu.ops import topk as jtopk  # noqa: E402
from predictionio_tpu_torch.ops import recommend as trp  # noqa: E402
from predictionio_tpu_torch.ops import topk as ttopk  # noqa: E402
from predictionio_tpu_torch.utils import bucket as tbucket  # noqa: E402

B, K, N_ITEMS = 8, 10, 300
I_P = jrp.pad_items(N_ITEMS)  # 384: three 128-wide tiles in the JAX kernel


def _dyadic(rng, shape):
    return (np.round(rng.standard_normal(shape) * 8) / 8).astype(np.float32)


def _case(seed, dtype, mask_kind, scaled):
    """numpy inputs for one selector call: (q, itf, qs, isc, bits, rows)."""
    rng = np.random.default_rng(seed)
    itf = np.zeros((I_P, K), np.float32)
    if dtype == "int8":
        q = rng.integers(-127, 128, (B, K)).astype(np.int8)
        itf = np.zeros((I_P, K), np.int8)
        itf[:N_ITEMS] = rng.integers(-127, 128, (N_ITEMS, K))
    else:
        q = _dyadic(rng, (B, K))
        itf[:N_ITEMS] = _dyadic(rng, (N_ITEMS, K))
    # crafted cross-tile ties: identical item rows in all three tiles
    itf[130] = itf[5]
    itf[260] = itf[5]
    qs = isc = None
    if scaled:
        qs = rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32)
        isc = rng.uniform(0.5, 2.0, (1, I_P)).astype(np.float32)
        isc[0, 130] = isc[0, 260] = isc[0, 5]
    bits = rows = None
    if mask_kind == "bits":
        mask = rng.random((B, N_ITEMS)) < 0.4
        mask[0] = True  # a fully masked row
        bits = jrp.pack_mask_np(mask, I_P)
    elif mask_kind == "rows":
        rows = np.full((B, 8), -1, np.int32)
        rows[:, :5] = rng.integers(0, N_ITEMS, (B, 5))
        rows[1, 5] = I_P + 7  # out of range: inert
    return q, itf, qs, isc, bits, rows


def _jnp(a, dtype=None):
    if a is None:
        return None
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _torch(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


# ---------------------------------------------------------------------------
# host helpers: byte-identical copies
# ---------------------------------------------------------------------------


def _helper_outputs(mod, rng_seed):
    rng = np.random.default_rng(rng_seed)
    mask = rng.random((5, 300)) < 0.3
    arr = rng.standard_normal((7, 10)).astype(np.float32)
    arr[3] = 0.0
    lists = [[1, 2, 3], [], list(range(11)), [299]]
    return {
        "pad_items": np.array([mod.pad_items(n) for n in (0, 1, 127, 128, 129, 26744)]),
        "pack_mask_np": mod.pack_mask_np(mask, 384),
        "pack_mask_np_empty": mod.pack_mask_np(np.zeros((2, 0), bool), 128),
        "rowlist_np": mod.rowlist_np(lists),
        "quantize_rows_np": np.concatenate(
            [a.view(np.uint8).ravel() for a in mod.quantize_rows_np(arr)]
        ),
        "inv_norms_np": mod.inv_norms_np(arr, 16),
        "constants": np.array(
            [mod.ITEM_PAD, mod.ROWLIST_MAX, mod._SENTINEL], np.float64
        ),
    }


@pytest.mark.parametrize("name", sorted(_helper_outputs(trp, 0)))
def test_host_helpers_byte_identical(name):
    ours = _helper_outputs(trp, 0)[name]
    ref = _helper_outputs(jrp, 0)[name]
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert ours.tobytes() == ref.tobytes()


def test_rowlist_np_all_empty_is_none():
    assert trp.rowlist_np([[], []]) is None
    assert jrp.rowlist_np([[], []]) is None


@pytest.mark.parametrize("k_req,n_items", [(1, 50), (10, 26744), (129, 26744),
                                           (300, 200), (5000, 4096)])
def test_buckets_match(k_req, n_items):
    from predictionio_tpu.utils import bucket as jbucket

    assert tbucket.topk_bucket(k_req, n_items) == jbucket.topk_bucket(k_req, n_items)
    for n in (0, 1, 2, 8, 9, 64, 65, 200):
        assert tbucket.batch_bucket(n) == jbucket.batch_bucket(n)


# ---------------------------------------------------------------------------
# tensor helpers vs their jnp twins
# ---------------------------------------------------------------------------


def test_unpack_mask_matches_jnp():
    rng = np.random.default_rng(1)
    mask = rng.random((6, 300)) < 0.5
    words = jrp.pack_mask_np(mask, 384)
    ours = trp.unpack_mask(torch.from_numpy(words), 300).numpy()
    ref = np.asarray(jrp.unpack_mask_jnp(jnp.asarray(words), 300))
    assert np.array_equal(ours, ref)
    assert np.array_equal(ours, mask)


def test_rowlist_mask_matches_jnp():
    rows = np.array([[0, 5, -1, 400], [299, 299, 7, -1]], np.int32)
    ours = trp.rowlist_mask(torch.from_numpy(rows), 300).numpy()
    ref = np.asarray(jrp.rowlist_mask_jnp(jnp.asarray(rows), 300))
    assert np.array_equal(ours, ref)
    assert ours.sum() == 4  # 400 and -1 inert, 299 twice


def test_quantize_rows_matches_jnp():
    rng = np.random.default_rng(2)
    arr = rng.standard_normal((9, 10)).astype(np.float32)
    arr[4] = 0.0
    arr[5, 3] = 2.5 * (arr[5].max() / 127.0)  # a half-way rounding case
    q, s = trp.quantize_rows(torch.from_numpy(arr))
    jq, js = jrp.quantize_rows_jnp(jnp.asarray(arr))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    nq, ns = trp.quantize_rows_np(arr)
    assert np.array_equal(q.numpy(), nq) and np.array_equal(s.numpy()[:, 0], ns)


# int8 scores only ever run with dequant scales
DTYPE_SCALED = [("f32", False), ("f32", True), ("bf16", False),
                ("bf16", True), ("int8", True)]


@pytest.mark.parametrize("dtype,scaled", DTYPE_SCALED)
def test_plain_scores_match_xla_scores(dtype, scaled):
    q, itf, qs, isc, _, _ = _case(3, dtype, None, scaled)
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    tdt = torch.bfloat16 if dtype == "bf16" else None
    ref = np.asarray(jrp.xla_scores(
        _jnp(q, jdt), _jnp(itf, jdt), _jnp(qs), _jnp(isc)
    ))
    ours = trp.plain_scores(
        _torch(q, tdt), _torch(itf, tdt), _torch(qs), _torch(isc)
    ).numpy()
    assert ours.dtype == np.float32
    # exact: dyadic / integer inputs make every sum exact in any order
    assert np.array_equal(ours, ref)


def test_plain_scores_random_floats_within_rtol():
    """Arbitrary f32 factors: the port's fixed-order chain and the CPU
    GEMM sum K=10 products in different orders — rtol 1e-5."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((16, K)).astype(np.float32)
    itf = rng.standard_normal((256, K)).astype(np.float32)
    ref = np.asarray(jrp.xla_scores(jnp.asarray(q), jnp.asarray(itf), None, None))
    ours = trp.plain_scores(torch.from_numpy(q), torch.from_numpy(itf), None, None)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_masked_top_k_matches_lax_top_k_with_ties():
    rng = np.random.default_rng(5)
    s = rng.integers(-3, 4, (6, 50)).astype(np.float32)
    mask = rng.random((6, 50)) < 0.3
    for k in (1, 7, 50):
        v, i = ttopk.masked_top_k(torch.from_numpy(s), k, torch.from_numpy(mask))
        jv, ji = jtopk.masked_top_k(jnp.asarray(s), k, jnp.asarray(mask))
        assert np.array_equal(i.numpy(), np.asarray(ji))
        assert np.array_equal(v.numpy(), np.asarray(jv))
    assert ttopk.NEG_INF == jtopk.NEG_INF


# ---------------------------------------------------------------------------
# the fused selector: port (CPU, plain version) vs JAX kernel + XLA two-step
# ---------------------------------------------------------------------------


def _jax_inputs(case, dtype):
    q, itf, qs, isc, bits, rows = case
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    return (_jnp(q, jdt), _jnp(itf, jdt), _jnp(qs), _jnp(isc), _jnp(bits),
            _jnp(rows))


def _port(case, dtype, k, n_items=N_ITEMS):
    q, itf, qs, isc, bits, rows = case
    tdt = torch.bfloat16 if dtype == "bf16" else None
    v, i = trp.fused_recommend_topk(
        _torch(q, tdt), _torch(itf, tdt), _torch(qs), _torch(isc),
        _torch(bits), _torch(rows), k=k, n_items=n_items,
    )
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert tuple(v.shape) == (B, k) == tuple(i.shape)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("k", [1, 17, N_ITEMS, I_P])
@pytest.mark.parametrize("mask_kind", [None, "bits", "rows"])
@pytest.mark.parametrize("dtype,scaled", DTYPE_SCALED)
def test_fused_matches_jax(dtype, scaled, mask_kind, k):
    case = _case(10, dtype, mask_kind, scaled)
    q, itf, qs, isc, bits, rows = _jax_inputs(case, dtype)
    v, i = _port(case, dtype, k)
    kv, ki = jrp.fused_recommend_topk(
        q, itf, qs, isc, bits, rows, k=k, n_items=N_ITEMS, interpret=True
    )
    xv, xi = jrp.fused_or_xla_topk(
        q, itf, qs, isc, bits, rows, N_ITEMS, k=k, mode=None
    )
    kv, ki, xv, xi = (np.asarray(a) for a in (kv, ki, xv, xi))
    assert np.array_equal(i, xi)
    assert np.array_equal(v, xv)
    assert np.array_equal(v, kv)
    # past n_items the JAX kernel's slots keep its running list's fill
    # index 0 (its pad columns never enter the list); lax.top_k, and the
    # port, order the dead pad columns by index there
    live = min(k, N_ITEMS)
    assert np.array_equal(i[:, :live], ki[:, :live])
    if mask_kind == "bits":  # the fully masked row: NEG_INF in index order
        assert np.all(v[0, :live] == np.float32(jtopk.NEG_INF))
        assert np.array_equal(i[0, :live], np.arange(live))
    if k == I_P:  # dead pad columns sink below NEG_INF
        assert np.all(v[:, N_ITEMS:] == np.float32(trp._SENTINEL))


def test_cross_tile_ties_lowest_index_first():
    case = _case(11, "f32", None, False)
    v, i = _port(case, "f32", N_ITEMS)
    for r in range(B):
        pos = [int(np.where(i[r] == c)[0][0]) for c in (5, 130, 260)]
        assert pos == sorted(pos)
        assert v[r, pos[0]] == v[r, pos[1]] == v[r, pos[2]]


def test_empty_rowlist_is_no_mask():
    case = _case(12, "f32", None, False)
    q, itf = _torch(case[0]), _torch(case[1])
    empty = torch.zeros((B, 0), dtype=torch.int32)
    a = trp.fused_recommend_topk(q, itf, None, None, None, empty, k=9, n_items=N_ITEMS)
    b = trp.fused_recommend_topk(q, itf, k=9, n_items=N_ITEMS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _raises(match, **over):
    case = _case(13, "f32", None, False)
    args = dict(q=_torch(case[0]), itf=_torch(case[1]), q_scale=None,
                item_scale=None, mask_bits=None, exclude_rows=None, k=5,
                n_items=N_ITEMS)
    args.update(over)
    with pytest.raises(ValueError, match=match):
        trp.fused_recommend_topk(**args)


@pytest.mark.parametrize("what", [
    "int8_unscaled", "both_masks", "rowlist_too_wide", "k_zero", "k_too_big",
    "dtype_mismatch", "unpadded", "half_scales", "bad_mask_shape",
])
def test_fused_validation_raises(what):
    rng = np.random.default_rng(14)
    if what == "int8_unscaled":
        _raises("int8 factors require dequant scales",
                q=torch.zeros((B, K), dtype=torch.int8),
                itf=torch.zeros((I_P, K), dtype=torch.int8))
    elif what == "both_masks":
        _raises("not both", mask_bits=torch.zeros((B, I_P // 32), dtype=torch.int32),
                exclude_rows=torch.zeros((B, 8), dtype=torch.int32))
    elif what == "rowlist_too_wide":
        _raises("ROWLIST_MAX", exclude_rows=torch.from_numpy(
            rng.integers(0, N_ITEMS, (B, trp.ROWLIST_MAX + 1)).astype(np.int32)))
    elif what == "k_zero":
        _raises("0 < k", k=0)
    elif what == "k_too_big":
        _raises("0 < k", k=I_P + 1)
    elif what == "dtype_mismatch":
        _raises("q must be", q=torch.zeros((B, K), dtype=torch.bfloat16))
    elif what == "unpadded":
        _raises("multiple of", itf=torch.zeros((300, K)))
    elif what == "half_scales":
        _raises("both q_scale", q_scale=torch.ones((B, 1)))
    elif what == "bad_mask_shape":
        _raises("mask_bits must have shape",
                mask_bits=torch.zeros((B, 3), dtype=torch.int32))


def test_cpu_path_counts_no_launch():
    before = (trp.LAUNCHES, dict(trp.ROUTE_LAUNCHES))
    case = _case(15, "f32", "rows", False)
    _port(case, "f32", 4)  # a select-route k
    trp.fused_recommend_topk(_torch(case[0]), torch.zeros((2048, K)),
                             k=trp.SELECT_MAX_K + 1, n_items=2000)  # sort route
    assert (trp.LAUNCHES, trp.ROUTE_LAUNCHES) == before


# ---------------------------------------------------------------------------
# ties across the card's 4,096-column segments: the order the select
# route must reproduce, pinned on the CPU against the JAX kernel
# ---------------------------------------------------------------------------

SEG_ITEMS = 9_000  # I_p 9,088 = 4,096 + 4,096 + 896: a short last segment
SEG_MAXIMA = (10, 4_095, 4_096, 8_191, 8_192, 8_999)


def _segment_case(dtype):
    """Integer factors (every score exact): the row maxima sit on both
    sides of both segment boundaries, and the lower scores are a few
    integers, so the k-th score is a tie group spanning all segments."""
    rng = np.random.default_rng(16)
    i_p = trp.pad_items(SEG_ITEMS)
    q = rng.integers(1, 3, (3, 4)).astype(np.float32)
    itf = np.zeros((i_p, 4), np.float32)
    itf[:SEG_ITEMS] = rng.integers(-1, 2, (SEG_ITEMS, 4))
    itf[list(SEG_MAXIMA)] = 2.0
    itf[SEG_ITEMS:] = 2.0  # dead pads must sink anyway
    qs = isc = None
    if dtype == "int8":
        q, itf = q.astype(np.int8), itf.astype(np.int8)
        qs, isc = np.ones((3, 1), np.float32), np.ones((1, i_p), np.float32)
    return q, itf, qs, isc


@pytest.mark.parametrize("k", [128, 1024, 1025])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_plain_matches_jax_across_segments(dtype, k):
    q, itf, qs, isc = _segment_case(dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    tdt = torch.bfloat16 if dtype == "bf16" else None
    v, i = trp.fused_recommend_topk(
        _torch(q, tdt), _torch(itf, tdt), _torch(qs), _torch(isc),
        k=k, n_items=SEG_ITEMS)
    kv, ki = jrp.fused_recommend_topk(
        _jnp(q, jdt), _jnp(itf, jdt), _jnp(qs), _jnp(isc), k=k,
        n_items=SEG_ITEMS, interpret=True)
    v, i, kv, ki = v.numpy(), i.numpy(), np.asarray(kv), np.asarray(ki)
    assert np.array_equal(v, kv)
    assert np.array_equal(i, ki)  # k < SEG_ITEMS: every slot is live
    for r in range(3):  # the maxima lead, lowest column first
        assert list(i[r, : len(SEG_MAXIMA)]) == list(SEG_MAXIMA)
        assert len(set(v[r, : len(SEG_MAXIMA)])) == 1


@pytest.mark.parametrize("k,route", [(1, "select"), (128, "select"),
                                     (1024, "select"), (1025, "sort"),
                                     (26_744, "sort")])
def test_scored_route_by_k(k, route):
    """The scored selector routes by k as the precomputed-score one: the
    two-launch select route up to SELECT_MAX_K (at the ML-20M slab, 7
    segments), the chunk sort and merge tree above it."""
    i_p = trp.pad_items(26_744)
    assert trp.topk_route(k) == route
    if route == "sort":
        levels = trp.merge_levels(i_p, k)
        assert levels[0] == (27, min(k, trp._CHUNK)) and levels[-1][0] == 1
        assert len(levels) == 6  # 27 chunks: 5 merge levels, then the emit


def test_select_scratch_at_the_ml20m_slab():
    """k = 128 slots for each of the ML-20M slab's 7 segments (the last
    2,176 columns wide); a B = 64 call's scratch is 64 x 896 keys."""
    i_p = trp.pad_items(26_744)
    assert i_p == 26_752 and -(-i_p // trp.SELECT_SEGMENT) == 7
    assert trp.select_scratch_keys(i_p, 128) == 7 * 128
    assert i_p - 6 * trp.SELECT_SEGMENT == 2_176


def test_merge_levels_cover_every_list():
    """The kernel's scratch sizing: each level halves the lists, list
    stride doubles up to k, one list of k remains at the top."""
    for i_p, k in ((128, 1), (26752, 128), (26752, 26744), (4096, 4096), (1024 * 5, 3000)):
        levels = trp.merge_levels(i_p, k)
        assert levels[0] == (-(-i_p // trp._CHUNK), min(k, trp._CHUNK))
        assert levels[-1][0] == 1 and levels[-1][1] >= k
        for (n0, s0), (n1, s1) in zip(levels, levels[1:]):
            assert n1 == (n0 + 1) // 2 and s1 == min(k, 2 * s0)

