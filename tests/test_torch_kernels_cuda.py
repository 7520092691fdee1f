"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Needs a CUDA device and nvcc; skips without a
card (a CUDA kernel has no CPU mode). Imports no jax, so it runs where
only the port is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest

The top-k kernels (scored and precomputed-score, each on both of its
routes) and their plain versions do the same rounded
operations, or only select, so indices AND values must be equal, for
every k up to the padded width. The ALS edge-pass kernels differ from
their plain versions only in how the f32 sums are taken (both passes
on the tensor cores), so they are held to 1e-5 times the sum of the
absolute terms, and to equal bits on a second launch. The col pass
alone:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest -k "dense and col"

The windowed pass alone:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest -k "block_partials or windowed"

The scored top-k alone:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest -k "test_kernel_ or recommend"
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


# (B, n_items, K): I_p below one 4,096-column segment (128, 1,152), not a
# multiple of it (3,072, 5,120), a short last segment (9,088 = 4,096 +
# 4,096 + 896), the ML-20M slab (26,752); K = 1, 3, 10, 16 (a row of
# 1 to 64 bytes; the segment pass stages these slabs in shared memory)
SCORED_SHAPES = ((1, 100, 3), (3, 1100, 10), (64, 5000, 10), (130, 3000, 16),
                 (4, 9000, 1), (2, 9000, 3), (130, 9000, 10), (64, 26_744, 10))


@pytest.mark.parametrize("mask_kind", [None, "bits", "rows"])
@pytest.mark.parametrize("dtype,scaled", [("f32", False), ("f32", True),
                                          ("bf16", False), ("bf16", True),
                                          ("int8", True)])
def test_kernel_equals_plain(card, dtype, scaled, mask_kind):
    rng = np.random.default_rng(0)
    for b, n_items, kdim in SCORED_SHAPES:
        args = _inputs(rng, dtype, b, n_items, kdim, scaled, mask_kind, card)
        i_p = rec.pad_items(n_items)
        for k in sorted({1, 7, min(128, i_p), min(1024, i_p), min(1025, i_p),
                         n_items, i_p}):
            route = rec.topk_route(k)
            before = (rec.LAUNCHES, dict(rec.ROUTE_LAUNCHES))
            kv, ki = rec.fused_recommend_topk(*args, k=k, n_items=n_items)
            pv, pi = rec.fused_recommend_topk_plain(*args, k=k, n_items=n_items)
            torch.cuda.synchronize()
            assert rec.LAUNCHES == before[0] + 1
            assert route == ("select" if k <= rec.SELECT_MAX_K else "sort")
            assert rec.ROUTE_LAUNCHES[route] == before[1][route] + 1
            assert sum(rec.ROUTE_LAUNCHES.values()) == sum(before[1].values()) + 1
            assert torch.equal(ki, pi), (b, n_items, kdim, k)
            assert torch.equal(kv, pv), (b, n_items, kdim, k)


@pytest.mark.parametrize("dtype,kdim", [("f32", 4), ("bf16", 4), ("bf16", 3),
                                        ("int8", 4), ("int8", 3)])
def test_kernel_ties_across_segments(card, dtype, kdim):
    """Integer factors make every score exact: equal row maxima on both
    sides of the 4,095/4,096 and 8,191/8,192 segment boundaries, and the
    k-th score a tie group over all three segments of I_p = 9,088, on
    both routes; B = 1 equals row 0 of the batch."""
    rng = np.random.default_rng(8)
    n_items = 9_000
    i_p = rec.pad_items(n_items)
    maxima = [10, 4_095, 4_096, 8_191, 8_192, 8_999]
    q = rng.integers(1, 3, (5, kdim)).astype(np.float32)
    itf = np.zeros((i_p, kdim), np.float32)
    itf[:n_items] = rng.integers(-1, 2, (n_items, kdim))
    itf[maxima] = 2.0
    itf[n_items:] = 2.0  # dead pads still sink
    qs = isc = None
    if dtype == "int8":
        qs = torch.ones((5, 1), device=card)
        isc = torch.ones((1, i_p), device=card)
    qt = torch.from_numpy(q).to(card).to(TORCH_DT[dtype])
    it = torch.from_numpy(itf).to(card).to(TORCH_DT[dtype])
    for k in (1, 128, 1_024, 1_025, n_items):
        kv, ki = rec.fused_recommend_topk(qt, it, qs, isc, k=k, n_items=n_items)
        pv, pi = rec.fused_recommend_topk_plain(qt, it, qs, isc, None, None,
                                                k=k, n_items=n_items)
        torch.cuda.synchronize()
        assert torch.equal(ki, pi) and torch.equal(kv, pv), k
        n = min(k, len(maxima))
        want = torch.tensor(maxima[:n], dtype=torch.int32, device=card)
        assert all(torch.equal(ki[r, :n], want) for r in range(5)), k
        one = rec.fused_recommend_topk(
            qt[:1].contiguous(), it, None if qs is None else qs[:1], isc,
            k=k, n_items=n_items)
        assert torch.equal(one[0][0], kv[0]) and torch.equal(one[1][0], ki[0])


@pytest.mark.parametrize("dtype,kdim,offset", [
    ("f32", 32, 0), ("bf16", 64, 0), ("int8", 128, 0),  # rows too wide to stage
    ("f32", 3, 1), ("bf16", 10, 1), ("int8", 10, 1),  # a slab not 16-byte aligned
])
def test_kernel_unstaged_slab(card, dtype, kdim, offset):
    """The segment pass reads the slab where it lies when a block's rows
    would take more shared memory than it stages, or the slab does not
    start on 16 bytes (a view one row into a larger tensor)."""
    rng = np.random.default_rng(10)
    q, itf, qs, isc, bits, _ = _inputs(rng, dtype, 64, 9_000, kdim,
                                       dtype == "int8", "bits", card)
    if offset:
        wider = torch.empty((itf.shape[0] + offset, kdim), dtype=itf.dtype,
                            device=card)
        wider[offset:] = itf
        itf = wider[offset:]
        assert itf.is_contiguous() and itf.data_ptr() % 16
    for k in (1, 128, 1_024):
        kv, ki = rec.fused_recommend_topk(q, itf, qs, isc, bits, k=k, n_items=9_000)
        pv, pi = rec.fused_recommend_topk_plain(q, itf, qs, isc, bits, None,
                                                k=k, n_items=9_000)
        torch.cuda.synchronize()
        assert torch.equal(ki, pi) and torch.equal(kv, pv), k


def test_kernel_relaunch_bit_equal(card):
    """The main path's shape (ML-20M slab, B = 64, k = 128, bit words),
    launched 50 times: every launch gives the first one's bits, which
    equal the plain version's."""
    rng = np.random.default_rng(9)
    for dtype, scaled in (("f32", False), ("bf16", True), ("int8", True)):
        args = _inputs(rng, dtype, 64, 26_744, 10, scaled, "bits", card)
        pv, pi = rec.fused_recommend_topk_plain(*args, k=128, n_items=26_744)
        for _ in range(50):
            kv, ki = rec.fused_recommend_topk(*args, k=128, n_items=26_744)
            assert torch.equal(ki, pi) and torch.equal(kv, pv), dtype


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


EVAL_USERS, EVAL_ITEMS, EVAL_QUERIES = 6_040, 3_706, 6_001  # ML-1M, one fold


@pytest.mark.parametrize("kdim", [10, 20])
def test_kernel_eval_batch(card, kdim):
    """An evaluation fold's one top-k call: B = 8,192 (6,001 queries
    bucketed), I_p = 3,712, k = 128 on the select route, equal to the
    plain version bit for bit, rows past the queries included."""
    rng = np.random.default_rng(20 + kdim)
    args = _inputs(rng, "f32", 8_192, EVAL_ITEMS, kdim, False, None, card)
    assert args[1].shape[0] == 3_712 and rec.topk_route(128) == "select"
    before = dict(rec.ROUTE_LAUNCHES)
    kv, ki = rec.fused_recommend_topk(*args, k=128, n_items=EVAL_ITEMS)
    pv, pi = rec.fused_recommend_topk_plain(*args, k=128, n_items=EVAL_ITEMS)
    torch.cuda.synchronize()
    assert rec.ROUTE_LAUNCHES["select"] == before["select"] + 1
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert int(ki.max()) < EVAL_ITEMS  # no dead pad column is returned


@pytest.mark.parametrize("kdim", [10, 20])
def test_eval_batch_predict_returns_no_pad_rows(card, kdim):
    """`batch_predict` of a fold's 6,001 queries: one launch at B = 8,192,
    one answer per query, each equal to the plain top-k on the CPU over
    the same factors (the 2,191 pad rows are cut before the answers)."""
    from predictionio_tpu_torch.data.store.bimap import BiMap
    from predictionio_tpu_torch.engines.recommendation import engine as teng
    from predictionio_tpu_torch.models import als

    rng = np.random.default_rng(30 + kdim)
    factors = als.ALSFactors(
        user_factors=rng.standard_normal((EVAL_USERS, kdim)).astype(np.float32),
        item_factors=rng.standard_normal((EVAL_ITEMS, kdim)).astype(np.float32),
        user_vocab=BiMap({f"u{n}": n for n in range(EVAL_USERS)}),
        item_vocab=BiMap({f"i{n}": n for n in range(EVAL_ITEMS)}))
    users = rng.choice(EVAL_USERS, EVAL_QUERIES, replace=False)
    queries = [(n, teng.Query(user=f"u{u}", num=10)) for n, u in enumerate(users)]
    algo = teng.ALSAlgorithm(teng.ALSAlgorithmParams(rank=kdim))
    before = rec.LAUNCHES
    got = algo.batch_predict(None, teng.ALSModel(factors, device=card), queries)
    assert rec.LAUNCHES == before + 1
    want = algo.batch_predict(None, teng.ALSModel(factors, device="cpu"), queries)
    assert len(got) == EVAL_QUERIES and got == want
    assert all(len(p.item_scores) == 10 for _, p in got)


def test_kernel_rejects_noncontiguous(card):
    itf = torch.zeros((256, 4), device=card)
    q = torch.zeros((8, 8), device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        rec.fused_recommend_topk(q, itf, k=3, n_items=200)


# ---------------------------------------------------------------------------
# the dense ALS edge passes (csrc/dense_pass.cu)
# ---------------------------------------------------------------------------


def _dense_case(rng, n_rows, n_cols, kdim, signed, dev, density=0.05):
    q = rng.integers(-10 if signed else 1, 11, (n_rows, n_cols)).astype(np.int8)
    q[rng.random((n_rows, n_cols)) > density] = 0
    return torch.from_numpy(q).to(dev)


def _assert_pass_close(which, r, x, implicit, ascale=0.85):
    """Kernel vs plain version: they differ only in the order of f32
    sums of exact bf16 products, so |Δ| ≤ 1e-5·S elementwise, S the pass
    over the absolute terms; finite; one launch per call, and a second
    launch gives the same bits."""
    from predictionio_tpu_torch.ops import dense_fused as df

    fn = df.fused_row_pass if which == "row" else df.fused_col_pass
    plain = df.fused_row_pass_plain if which == "row" else df.fused_col_pass_plain
    before = df.PASS_LAUNCHES[which]
    kb, kc = fn(r, x, ascale, implicit=implicit)
    kb2, kc2 = fn(r, x, ascale, implicit=implicit)
    pb, pc = plain(r, x, ascale, implicit=implicit)
    sb, sc = plain(r, x, ascale, implicit=implicit, magnitude=True)
    torch.cuda.synchronize()
    assert df.PASS_LAUNCHES[which] == before + 2
    assert torch.equal(kb, kb2) and torch.equal(kc, kc2)
    for got, want, mag in ((kb, pb, sb), (kc, pc, sc)):
        assert bool(torch.isfinite(got).all())
        assert float(((got - want).abs() - 1e-5 * mag).max()) <= 0.0


@pytest.mark.parametrize("which", ["row", "col"])
@pytest.mark.parametrize("implicit,signed", [(True, False), (True, True),
                                             (False, True)])
def test_dense_pass_kernel_equals_plain(card, which, implicit, signed):
    """Kernel vs plain version (`_assert_pass_close`) on ragged dims
    (bounds checks, unaligned rows) and padded ones. For the col pass:
    row chunks with a short last one (5,037 rows in 20 chunks of 256 on
    132 SMs), column tiles not a multiple of 128, 313 tiles (more than a
    wave of CTAs, 3 chunks), and one chunk (K = 32 at ML-20M width);
    `test_dense_col_pass_plan` pins those chunks."""
    rng = np.random.default_rng(3)
    for n_rows, n_cols, kdim in ((2048, 256, 10), (300, 77, 1), (1000, 1003, 8),
                                 (2048, 256, 32), (64, 4096, 16),
                                 (5_037, 1_040, 10), (600, 40_000, 10),
                                 (139, 26_880, 32)):
        r = _dense_case(rng, n_rows, n_cols, kdim, signed, card)
        n_side = n_cols if which == "row" else n_rows
        x = torch.from_numpy(
            rng.standard_normal((n_side, kdim)).astype(np.float32)).to(card)
        for ascale in (0.5, 0.85, 0.1):
            _assert_pass_close(which, r, x, implicit, ascale)


@pytest.mark.parametrize("which", ["row", "col"])
def test_dense_pass_kernel_long_sums(card, which):
    """A line of R rated in every cell (a most-rated item: tens of
    thousands of positive terms in one sum) stays within 1e-5 * S of
    the plain version: the kernels sum 128-long blocks on the tensor
    cores and add the block sums in order (the col pass per row chunk,
    here 547 chunks of one block, then the chunks in order)."""
    rng = np.random.default_rng(5)
    long_side, short_side = (30_000, 40) if which == "row" else (70_000, 48)
    q = rng.integers(1, 11, (long_side, short_side)).astype(np.int8)
    q[rng.random((long_side, short_side)) > 0.05] = 0
    q[:, 3] = rng.integers(1, 11, long_side)  # line 3: every cell rated
    if which == "row":
        q = np.ascontiguousarray(q.T)  # row 3 of (40, 30,000)
    r = torch.from_numpy(q).to(card)
    x = torch.from_numpy((rng.standard_normal((long_side, 10)) / np.sqrt(10))
                         .astype(np.float32)).to(card)
    for implicit in (True, False):
        _assert_pass_close(which, r, x, implicit, 0.5)


@pytest.mark.parametrize("which", ["row", "col"])
@pytest.mark.parametrize("k", [16, 32])
def test_dense_pass_kernel_split_columns(card, k, which):
    """Ranks whose K + K(K+1)/2 outputs exceed one CTA's columns split
    them over column blocks (three at K = 16, eight at K = 32), each
    reading R once, in both passes; ragged rows and columns (not
    multiples of the strip, stage, chunk or column tile)."""
    from predictionio_tpu_torch.ops import dense_fused as df

    assert df.operand_column_blocks(k) > 1
    rng = np.random.default_rng(11 + k)
    r = _dense_case(rng, 700, 1_040, k, True, card, density=0.2)
    n_side = 1_040 if which == "row" else 700
    x = torch.from_numpy(rng.standard_normal((n_side, k)).astype(np.float32)).to(card)
    for implicit in (True, False):
        _assert_pass_close(which, r, x, implicit)


@pytest.mark.parametrize("which", ["row", "col"])
def test_dense_pass_kernel_all_zero_r(card, which):
    """An all-zero R gives exact zeros: both passes multiply every cell,
    and zero weights times finite factors are exact zeros."""
    from predictionio_tpu_torch.ops import dense_fused as df

    fn = df.fused_row_pass if which == "row" else df.fused_col_pass
    r = torch.zeros((600, 1_024), dtype=torch.int8, device=card)
    n_side = 1_024 if which == "row" else 600
    x = torch.randn((n_side, 10), device=card)
    for implicit in (True, False):
        kb, kc = fn(r, x, 0.5, implicit=implicit)
        torch.cuda.synchronize()
        assert not kb.any() and not kc.any()


@pytest.mark.parametrize("n_rows,n_cols,k,chunk_rows,chunks", [
    # the ML-20M slab at K = 10: 210 tiles, 5 chunks, 1,050 CTAs (3.98
    # waves of 264); at K = 32 eight column blocks fill the card alone
    (139_264, 26_880, 10, 27_904, 5),
    (139_264, 26_880, 32, 139_264, 1),
    (139_264, 26_880, 11, 46_464, 3),    # two column blocks
    # a long, narrow R: one tile, one chunk per 128-row stage
    (70_000, 48, 10, 128, 547),
    # ragged: three stages, the last one short
    (300, 77, 1, 128, 3),
    (5_037, 1_040, 16, 256, 20),
    # more tiles than one wave: 313 tiles, 3 chunks of 2 stages
    (600, 40_000, 10, 256, 3),
    (1, 1, 1, 128, 1),
])
def test_dense_col_pass_plan(card, n_rows, n_cols, k, chunk_rows, chunks):
    """The col pass kernel's row chunks: whole 128-row stages, together
    covering every row once, about four waves of CTAs where R allows (the
    counts are for an H100's 132 SMs); scratch for each chunk's operand
    columns."""
    from predictionio_tpu_torch.ops import dense_fused as df

    got_rows, floats = df.col_pass_plan(n_rows, n_cols, k, card)
    n_chunks = -(-n_rows // got_rows)
    assert got_rows % 128 == 0
    assert (n_chunks - 1) * got_rows < n_rows <= n_chunks * got_rows
    assert floats == n_chunks * n_cols * df.operand_column_blocks(k) * 72
    if torch.cuda.get_device_properties(card).multi_processor_count == 132:
        assert (got_rows, n_chunks) == (chunk_rows, chunks)


def test_dense_col_pass_plan_refuses_past_the_grid(card):
    """2^28 column tiles of eight column blocks are 2^31 CTAs, one past
    the 1-D grid: refused before launch; one tile fewer is planned."""
    from predictionio_tpu_torch.ops import dense_fused as df

    n_cols = 2**28 * 128
    with pytest.raises(ValueError, match="no col pass launch"):
        df.col_pass_plan(128, n_cols, 32, card)
    assert df.col_pass_plan(128, n_cols - 128, 32, card)[0] == 128


def test_row_pass_kernel_past_65535_strips(card):
    """8,400,000 users (65,625 strips of 128 rows, past a 2-D grid's
    65,535) at two column blocks: every strip is computed, as in the
    plain version, and a relaunch gives the same bits."""
    from predictionio_tpu_torch.ops import dense_fused as df

    rng = np.random.default_rng(17)
    n_rows, n_cols, k = 8_400_000, 16, 11
    assert -(-n_rows // df.ROW_STRIP) > 65_535 and df.operand_column_blocks(k) == 2
    r = torch.randint(-3, 4, (n_rows, n_cols), dtype=torch.int8, device=card,
                      generator=torch.Generator(card).manual_seed(17))
    y = torch.from_numpy(rng.standard_normal((n_cols, k)).astype(np.float32)).to(card)
    _assert_pass_close("row", r, y, True, 0.5)


def test_dense_pass_kernel_rejects_noncontiguous(card):
    from predictionio_tpu_torch.ops import dense_fused as df

    r = torch.zeros((64, 128), dtype=torch.int8, device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        df.fused_row_pass(r, torch.zeros((64, 4), device=card), 1.0,
                          implicit=True)


# ---------------------------------------------------------------------------
# the windowed edge pass (csrc/windowed_pass.cu)
# ---------------------------------------------------------------------------


def _windowed_case(rng, k, implicit, dev, n_src=500, n_dst=3000,
                   n_edges=60_000):
    """A real plan's per-slot arrays (signed ratings, the implicit or
    explicit half-step's weights) with extra out-of-range local ids on
    padding slots, on the card."""
    from predictionio_tpu_torch.ops import windowed as win

    dst = np.sort(rng.integers(0, n_dst, n_edges))
    src = rng.integers(0, n_src, n_edges).astype(np.int32)
    vals = (rng.integers(1, 11, n_edges) / 2.0
            * rng.choice([-1.0, 1.0], n_edges)).astype(np.float32)
    plan = win.plan_windows(dst, n_dst)
    flat = (plan.n_blocks_p, win.BLOCK_EDGES)
    v = plan.take(vals).reshape(flat)
    ok = plan.chunked_valid().reshape(flat)
    if implicit:
        conf = (1.0 + np.float32(1.7) * np.abs(v)).astype(np.float32)
        w_b, w_g = conf * (v > 0) * ok, (conf - 1.0) * ok
    else:
        w_b, w_g = v * ok, ok.copy()
    local = plan.chunked_local().reshape(flat).copy()
    pad = ok == 0
    local[pad & (np.arange(flat[1]) % 2 == 0)] = win.WINDOW_ROWS + 3
    factors = (rng.standard_normal((n_src, k)) / np.sqrt(k)).astype(np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (put(factors), put(plan.take(src).reshape(flat)),
            put(w_b.astype(np.float32)), put(w_g.astype(np.float32)),
            put(local), put(plan.block_window), plan.n_windows)


def _assert_partials_close(args, magnitude_args=None):
    """Kernel vs plain: |Δ| <= 1e-5 * S elementwise, S the pass over the
    absolute terms; a second launch gives the same bits."""
    from predictionio_tpu_torch.ops import windowed_fused as wf

    before = wf.BLOCK_LAUNCHES["partials"]
    kb, kg = wf.block_partials(*args)
    kb2, kg2 = wf.block_partials(*args)
    pb, pg = wf.block_partials_plain(*args)
    sb, sg = wf.block_partials_plain(*args, magnitude=True)
    torch.cuda.synchronize()
    assert wf.BLOCK_LAUNCHES["partials"] == before + 2
    assert torch.equal(kb, kb2) and torch.equal(kg, kg2)
    for got, want, mag in ((kb, pb, sb), (kg, pg, sg)):
        assert bool(torch.isfinite(got).all())
        assert float(((got - want).abs() - 1e-5 * mag).max()) <= 0.0
    k = kb.shape[2]  # each gram pair is stored to (i, j) and (j, i)
    square = kg.reshape(*kg.shape[:2], k, k)
    assert torch.equal(square, square.transpose(2, 3))
    return kb, kg


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("k", [1, 10, 11, 16, 23, 32])
def test_block_partials_kernel_equals_plain(card, k, implicit):
    """K = 1 to 32: one to several warps of tiles and of row groups, odd
    and even K (the b column alone in its tile or beside a gram
    column)."""
    rng = np.random.default_rng(k + 100 * implicit)
    *args, bwin, n_windows = _windowed_case(rng, k, implicit, card)
    _assert_partials_close(args)


def test_block_partials_plan(card):
    """The kernel's own launch plan: one thread for each 2 x 2 tile of
    the pairs a <= b of (y, 1)(y, 1)ᵀ with a < K, and the block's rows
    cut into groups whose shared memory fits an SM."""
    from predictionio_tpu_torch.ops import windowed_fused as wf

    for s_rows in (128, 1, 1000):
        for k in range(1, wf.MAX_RANK + 1):
            p = wf.partials_plan(k, s_rows, card)
            nb, na = (k + 2) // 2, (k + 1) // 2
            assert p["tiles"] == sum(nb - bi for bi in range(na))
            assert p["threads"] % 32 == 0
            assert p["tiles"] <= p["threads"] < p["tiles"] + 32
            assert p["groups"] * p["rows"] >= s_rows
            assert (p["groups"] - 1) * p["rows"] < s_rows
            assert p["smem_bytes"] <= 227 * 1024 and p["ctas_per_sm"] >= 1
    for bad in ((0, 128), (33, 128), (10, 0)):
        with pytest.raises(ValueError, match="no partials launch"):
            wf.partials_plan(*bad, card)


@pytest.mark.parametrize("b_e", [1000, 64, 100, 1])
def test_block_partials_kernel_short_blocks(card, b_e):
    """Blocks of b_e slots, not a multiple of the kernel's 64-slot
    stage, or one stage, or one slot."""
    rng = np.random.default_rng(b_e)
    *args, bwin, n_windows = _windowed_case(rng, 10, True, card)
    _assert_partials_close([args[0]] + [a[:, :b_e].contiguous()
                                        for a in args[1:]])


def test_block_partials_kernel_padding_repeats_a_row(card):
    """A plan's own padding, untouched: the padding slots of window 0's
    last block carry edge 0's local id, in range and repeating a row
    summed earlier in the block, with zero weights."""
    from predictionio_tpu_torch.ops import windowed as win

    rng = np.random.default_rng(12)
    dst = np.sort(rng.integers(0, 300, 1500))
    plan = win.plan_windows(dst, 300)
    flat = (plan.n_blocks_p, win.BLOCK_EDGES)
    ok = plan.chunked_valid().reshape(flat)
    local = plan.chunked_local().reshape(flat)
    assert (ok[0] == 0).any() and (local[0][ok[0] == 0] == dst[0]).all()
    src = rng.integers(0, 40, len(dst)).astype(np.int32)
    w = (rng.uniform(0.5, 5.0, len(dst)).astype(np.float32))
    factors = rng.standard_normal((40, 10)).astype(np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    wt = plan.take(w).reshape(flat)
    kb, _ = _assert_partials_close((put(factors), put(plan.take(src).reshape(flat)),
                                    put(wt), put(wt), put(local)))
    assert kb[0, dst[0]].any()


def test_block_partials_kernel_many_waves(card):
    """About 2,000 blocks: several waves of CTAs on the card."""
    rng = np.random.default_rng(13)
    *args, bwin, n_windows = _windowed_case(rng, 10, True, card,
                                            n_edges=2_000_000)
    assert args[1].shape[0] >= 1_900
    _assert_partials_close(args)


def test_block_partials_kernel_one_row_block(card):
    """All 1,024 slots of a block on one row (a most-rated item's block),
    and a block whose ids run backwards (unsorted: the flush adds into
    rows already written)."""
    rng = np.random.default_rng(7)
    factors = torch.from_numpy(rng.standard_normal((50, 10)).astype(np.float32)).to(card)
    src = torch.from_numpy(rng.integers(0, 50, (3, 1024)).astype(np.int32)).to(card)
    w = torch.from_numpy(rng.uniform(0.1, 3.0, (3, 1024)).astype(np.float32)).to(card)
    local = np.full((3, 1024), 77, np.int32)
    local[1] = np.arange(1024) % 128  # every row, eight times, in rounds
    local[2] = (1023 - np.arange(1024)) % 128
    kb, _ = _assert_partials_close((factors, src, w, w,
                                    torch.from_numpy(local).to(card)))
    assert not kb[0, :77].any() and not kb[0, 78:].any()


def test_block_partials_kernel_out_of_range_rows(card):
    """Slots with ids outside [0, S) add nothing, whatever their weight;
    rows no slot reaches read 0."""
    from predictionio_tpu_torch.ops import windowed_fused as wf

    rng = np.random.default_rng(8)
    factors = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32)).to(card)
    src = torch.from_numpy(rng.integers(0, 20, (2, 1024)).astype(np.int32)).to(card)
    w = torch.ones((2, 1024), device=card)
    local = torch.full((2, 1024), -5, dtype=torch.int32, device=card)
    local[0, 100:200] = 9
    local[0, 300:] = 128
    kb, kg = wf.block_partials(factors, src, w, w, local)
    torch.cuda.synchronize()
    assert not kb[1].any() and not kg[1].any()
    assert not kb[0, :9].any() and not kb[0, 10:].any()
    want = factors[src[0, 100:200].long()].sum(0)
    assert torch.allclose(kb[0, 9], want, rtol=1e-5, atol=1e-5)


def test_windowed_gram_b_kernels_relaunch_bit_equal(card):
    from predictionio_tpu_torch.ops import windowed as win
    from predictionio_tpu_torch.ops import windowed_fused as wf

    rng = np.random.default_rng(9)
    *args, bwin, n_windows = _windowed_case(rng, 10, True, card)
    before = wf.BLOCK_LAUNCHES["combine"]
    b1, g1 = win.windowed_gram_b(*args, bwin, n_windows)
    b2, g2 = win.windowed_gram_b(*args, bwin, n_windows)
    pb, pg = wf.combine_windows_plain(*wf.block_partials_plain(*args), bwin,
                                      n_windows)
    sb, sg = wf.combine_windows_plain(
        *wf.block_partials_plain(*args, magnitude=True), bwin, n_windows)
    torch.cuda.synchronize()
    assert wf.BLOCK_LAUNCHES["combine"] == before + 2
    assert torch.equal(b1, b2) and torch.equal(g1, g2)
    for got, want, mag in ((b1, pb, sb), (g1, pg, sg)):
        assert float(((got - want).abs() - 1e-5 * mag).max()) <= 0.0


def test_windowed_kernels_reject_noncontiguous(card):
    from predictionio_tpu_torch.ops import windowed_fused as wf

    f = torch.zeros((10, 8), device=card)[:, ::2]
    src = torch.zeros((2, 64), dtype=torch.int32, device=card)
    w = torch.zeros((2, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        wf.block_partials(f, src, w, w, src)
    pb = torch.zeros((2, 128, 8), device=card)[:, :, ::2]
    pg = torch.zeros((2, 128, 16), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        wf.combine_windows(pb, pg, torch.zeros(2, dtype=torch.int32,
                                               device=card), 1)


# ---------------------------------------------------------------------------
# the precomputed-score selector (csrc/recommend_topk.cu, masked_topk)
# ---------------------------------------------------------------------------


def _masked_case(rng, b, n_items, mask_kind, dev, width=64):
    """Quarter-step scores (exact ties within and across chunks), dead
    pads, an all-zero row, and exclusions."""
    i_p = rec.pad_items(n_items)
    scores = (rng.integers(-8, 9, (b, i_p)) / 4.0).astype(np.float32)
    scores[:, n_items:] = rng.standard_normal((b, i_p - n_items))
    scores[-1, :n_items] = 0.0  # no history: every live item scores 0
    bits = rows = None
    if mask_kind == "bits":
        mask = rng.random((b, n_items)) < 0.5
        mask[0] = True  # a fully masked row
        bits = torch.from_numpy(rec.pack_mask_np(mask, i_p)).to(dev)
    elif mask_kind == "rows":
        r = np.full((b, width), -1, np.int32)
        r[:, : width - 3] = rng.integers(0, n_items, (b, width - 3))
        r[0, -1] = i_p + 3  # out of range: inert
        rows = torch.from_numpy(r).to(dev)
    return torch.from_numpy(scores).to(dev), bits, rows


@pytest.mark.parametrize("mask_kind,width", [(None, 0), ("bits", 0),
                                             ("rows", 8), ("rows", 64)])
def test_masked_kernel_equals_plain(card, mask_kind, width):
    rng = np.random.default_rng(3)
    # 12,345 items: 4 segments of candidates, 32 KB of them at k = 1,024
    for b, n_items in ((1, 100), (3, 1100), (64, 5000), (130, 3000),
                       (2, 12_345), (8, 100_000)):
        scores, bits, rows = _masked_case(rng, b, n_items, mask_kind, card,
                                          width or 64)
        i_p = scores.shape[1]
        for k in sorted({1, 7, 64, min(1024, i_p), min(1500, i_p), n_items, i_p}):
            before = rec.MASKED_LAUNCHES
            kv, ki = rec.fused_masked_topk(scores, bits, rows, k=k, n_items=n_items)
            pv, pi = rec.fused_masked_topk_plain(scores, bits, rows, k=k,
                                                 n_items=n_items)
            torch.cuda.synchronize()
            assert rec.MASKED_LAUNCHES == before + 1
            assert torch.equal(ki, pi), (b, n_items, k)
            assert torch.equal(kv, pv), (b, n_items, k)
            if mask_kind == "bits":
                n = min(k, n_items)
                assert bool((kv[0, :n] == rec.NEG_INF).all())


def test_masked_kernel_ties_across_chunks(card):
    """Equal maxima in every 1,024-column chunk, -0.0 beside +0.0: the
    lowest index wins, the two zeros are one value."""
    scores = torch.zeros((4, 8192), device=card)
    scores[:, ::1024] = 5.0
    scores[:, 1::1024] = 5.0
    scores[1, :100] = -0.0
    for k in (3, 16, 17, 2000):
        kv, ki = rec.fused_masked_topk(scores, k=k, n_items=8000)
        pv, pi = rec.fused_masked_topk_plain(scores, None, None, k=k, n_items=8000)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)
    want = torch.tensor([0, 1, 1024, 1025, 2048], dtype=torch.int32, device=card)
    assert torch.equal(ki[0, :5], want)


@pytest.mark.parametrize("k", [1023, 1024, 1025])
def test_masked_kernel_routes_by_k(card, k):
    """k up to SELECT_MAX_K takes the select route (segment and row
    passes), larger k the chunk sort and merge tree; both equal the plain
    version."""
    rng = np.random.default_rng(6)
    scores, bits, rows = _masked_case(rng, 16, 30_000, "bits", card)
    route = rec.topk_route(k)
    before = dict(rec.MASKED_ROUTE_LAUNCHES)
    kv, ki = rec.fused_masked_topk(scores, bits, rows, k=k, n_items=30_000)
    pv, pi = rec.fused_masked_topk_plain(scores, bits, rows, k=k, n_items=30_000)
    torch.cuda.synchronize()
    assert route == ("select" if k <= rec.SELECT_MAX_K else "sort")
    assert rec.MASKED_ROUTE_LAUNCHES[route] == before[route] + 1
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("n_items", [1_000, 12_345, 40_000])
def test_masked_kernel_ties_across_segments(card, n_items):
    """Equal maxima on both sides of every segment boundary (and every
    chunk boundary), -0.0 beside +0.0, I_p below one segment and not a
    multiple of it: the lowest index wins, on both routes."""
    i_p = rec.pad_items(n_items)
    scores = torch.zeros((3, i_p), device=card)
    edges = torch.tensor(range(rec._CHUNK, n_items, rec._CHUNK),
                         dtype=torch.long, device=card)
    scores[:, edges - 1] = 7.0
    scores[:, edges] = 7.0
    scores[1, :300] = -0.0
    scores[2, ::3] = 7.0
    for k in (1, 2, 10, 64, 1_000, 1_024, 1_500, n_items):
        if k > i_p:
            continue
        kv, ki = rec.fused_masked_topk(scores, k=k, n_items=n_items)
        pv, pi = rec.fused_masked_topk_plain(scores, None, None, k=k,
                                             n_items=n_items)
        torch.cuda.synchronize()
        assert torch.equal(ki, pi) and torch.equal(kv, pv), (n_items, k)


def test_masked_kernel_mostly_zero_segments_relaunched(card):
    """Rows of users with little history: whole segments of equal
    scores (one value is left after the radix select's first narrowing,
    then the tie ranks are scanned), launched many times, each equal to
    the plain version: no launch may take more or fewer than k keys."""
    rng = np.random.default_rng(21)
    n_items, b = 100_000, 64
    i_p = rec.pad_items(n_items)
    scores = np.zeros((b, i_p), np.float32)
    for row in range(1, b):  # a few scored items, the rest 0 (row 0: all 0)
        cols = rng.integers(0, n_items, rng.integers(1, 40))
        scores[row, cols] = rng.integers(1, 5, len(cols)) / 2.0
    scores[:, n_items:] = 1.0  # pads sink below every live item
    mask = rng.random((b, n_items)) < 0.01
    bits = torch.from_numpy(rec.pack_mask_np(mask, i_p)).to(card)
    s = torch.from_numpy(scores).to(card)
    for k in (10, 64, 1_024):
        pv, pi = rec.fused_masked_topk_plain(s, bits, None, k=k, n_items=n_items)
        for _ in range(50):
            kv, ki = rec.fused_masked_topk(s, bits, k=k, n_items=n_items)
            assert torch.equal(ki, pi) and torch.equal(kv, pv), k


def test_masked_kernel_rejects_noncontiguous(card):
    scores = torch.zeros((8, 512), device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        rec.fused_masked_topk(scores, k=3, n_items=200)


def test_batch_score_topk_card_equals_cpu(card):
    """The UR batch on the card (history chain + kernel) gives the same
    bits as on the CPU (the same chain + the plain version)."""
    from predictionio_tpu_torch.models import cco

    rng = np.random.default_rng(4)
    tables = []
    for j in (3000, 700):
        idx = rng.integers(-1, j, (20_000, 50)).astype(np.int32)
        sc = rng.gamma(2.0, 5.0, (20_000, 50)).astype(np.float32)
        tables.append((idx, sc, j))
    hists = [rng.integers(-1, j, (64, 100)).astype(np.int32) for _, _, j in tables]
    for width in (8, 256):
        ex = np.full((64, width), -1, np.int32)
        ex[:, : width // 2] = rng.integers(0, 20_000, (64, width // 2))
        on_card = [(torch.from_numpy(i).to(card), torch.from_numpy(s).to(card), j)
                   for i, s, j in tables]
        before = rec.MASKED_LAUNCHES
        select = rec.MASKED_ROUTE_LAUNCHES["select"]
        got = cco.batch_score_topk(on_card, hists, ex, 64)
        assert rec.MASKED_LAUNCHES == before + 1
        assert rec.MASKED_ROUTE_LAUNCHES["select"] == select + 1
        want = cco.batch_score_topk(tables, hists, ex, 64, device="cpu")
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])


def test_train_from_event_server_posts_equals_plain_pass_train(card):
    """Events POSTed through the port's Event Server (memory storage,
    50-event batches), read by the recommendation template's data source
    and trained on the card: the windowed path's kernels launch twice an
    iteration each, a second train gives the same bits, and the train
    through the plain windowed passes on the card correlates > 0.9999
    (chip_smoke.py's windowed-train bar)."""
    import json
    import urllib.request

    from predictionio_tpu_torch.core.base import RuntimeContext
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig
    from predictionio_tpu_torch.data.storage.base import AccessKey, App
    from predictionio_tpu_torch.data.storage.registry import Storage, StorageConfig
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm, ALSAlgorithmParams, DataSourceParams, RecommendationDataSource)
    from predictionio_tpu_torch.ops import windowed_fused as wf

    storage = Storage(StorageConfig.memory())
    app_id = storage.get_meta_data_apps().insert(App(0, "cardapp"))
    storage.get_meta_data_access_keys().insert(AccessKey("K", app_id))
    rng = np.random.default_rng(41)
    n_users, n_items, n = 1_000, 600, 20_000
    cells = rng.choice(n_users * n_items, n, replace=False)
    events = [{"event": "rate", "entityType": "user", "entityId": f"u{c // n_items}",
               "targetEntityType": "item", "targetEntityId": f"i{c % n_items}",
               "properties": {"rating": int(rng.integers(1, 6))},
               "eventTime": f"2024-01-01T00:00:00.{k % 1000:03d}Z"}
              for k, c in enumerate(cells)]
    server = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    port = server.start()
    try:
        for b in range(0, n, 50):
            r = urllib.request.Request(
                f"http://127.0.0.1:{port}/batch/events.json?accessKey=K",
                data=json.dumps(events[b:b + 50]).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=30) as resp:
                assert [x["status"] for x in json.loads(resp.read())] == [201] * 50
    finally:
        server.stop()
    ctx = RuntimeContext(storage=storage, device="cuda:0")
    td = RecommendationDataSource(DataSourceParams("cardapp")).read_training(ctx)
    assert len(td.rows) == n
    params = ALSAlgorithmParams(num_iterations=5)
    wf.BLOCK_LAUNCHES.update(partials=0, combine=0)
    f = ALSAlgorithm(params).train(ctx, td).factors
    assert wf.BLOCK_LAUNCHES == {"partials": 10, "combine": 10}
    again = ALSAlgorithm(params).train(ctx, td).factors
    assert np.array_equal(f.user_factors, again.user_factors)
    saved = (wf.block_partials, wf.combine_windows)
    wf.block_partials, wf.combine_windows = wf.block_partials_plain, wf.combine_windows_plain
    try:
        plain = ALSAlgorithm(params).train(ctx, td).factors
    finally:
        wf.block_partials, wf.combine_windows = saved
    for side in ("user_factors", "item_factors"):
        got, want = getattr(f, side), getattr(plain, side)
        assert np.isfinite(got).all()
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999, side


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_select_on_a_slab_grown_by_row_publish(card, dtype):
    """recommend_select on a slab that serving_publish_rows grew from
    1,792 to 1,920 rows (ML-100K's 1,682 items plus 200 new ones, past
    the pad headroom) and rewrote row by row: indices and values equal to
    the plain version, and the slab equal to a restage of the same
    factors."""
    import dataclasses

    from predictionio_tpu_torch.data.store.bimap import BiMap
    from predictionio_tpu_torch.models import als

    rng = np.random.default_rng(42)
    k, n_users, n_items, new_users, new_items = 10, 943, 1_682, 200, 200
    base = als.ALSFactors(
        user_factors=rng.standard_normal((n_users, k)).astype(np.float32),
        item_factors=rng.standard_normal((n_items, k)).astype(np.float32),
        user_vocab=BiMap({f"u{i}": i for i in range(n_users)}),
        item_vocab=BiMap({f"i{i}": i for i in range(n_items)}))
    sv = als.stage_serving(base, dtype, device=card)
    assert sv.items.shape[0] == 1_792
    uf, itf = base.user_factors.copy(), base.item_factors.copy()
    for tick in range(4):  # new rows in four publishes, old rows rewritten
        urows = np.concatenate([rng.choice(len(uf), 30, replace=False),
                                len(uf) + np.arange(new_users // 4)])
        irows = np.concatenate([rng.choice(len(itf), 20, replace=False),
                                len(itf) + np.arange(new_items // 4)])
        uf = np.concatenate([uf, np.zeros((new_users // 4, k), np.float32)])
        itf = np.concatenate([itf, np.zeros((new_items // 4, k), np.float32)])
        uf[urows] = rng.standard_normal((len(urows), k))
        itf[irows] = rng.standard_normal((len(irows), k))
        sv = als.serving_publish_rows(sv, urows, uf[urows], irows, itf[irows],
                                      n_users=len(uf), n_items=len(itf))
    assert sv.items.shape[0] == 1_920 and sv.n_items == 1_882
    want = als.stage_serving(dataclasses.replace(base, user_factors=uf, item_factors=itf),
                             dtype, device=card)
    for f in ("users", "items", "user_scale", "item_scale", "item_inv_norm"):
        a, b = getattr(sv, f), getattr(want, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    int8 = dtype == "int8"
    for b in (1, 64):
        rows = torch.from_numpy(rng.choice(len(uf), b, replace=False)).to(card)
        args = (sv.users[rows].contiguous(), sv.items,
                sv.user_scale[rows].contiguous() if int8 else None,
                sv.item_scale if int8 else None, None, None)
        for kk in (10, 128):
            before = rec.ROUTE_LAUNCHES["select"]
            kv, ki = rec.fused_recommend_topk(*args, k=kk, n_items=sv.n_items)
            pv, pi = rec.fused_recommend_topk_plain(*args, k=kk, n_items=sv.n_items)
            torch.cuda.synchronize()
            assert rec.ROUTE_LAUNCHES["select"] == before + 1
            assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("verb", ["similar_vectors_serving", "similar_serving"])
@pytest.mark.parametrize("mask_kind", [None, "rows", "bits"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_cosine_verbs_equal_plain(card, dtype, mask_kind, verb, monkeypatch):
    """The cosine verbs the similar-product template serves through: the
    scored selector with the items' inverse norms (and for int8 the
    dequant scales) as scales, at ML-1M's 3,706 items (I_p 3,712), K =
    10, B in {1, 8}, unmasked, with row lists and with bit words. Each
    call launches the selector once on its select route; the same call
    through the plain version on the same card tensors gives equal
    indices and values."""
    from predictionio_tpu_torch.models import als

    rng = np.random.default_rng(16)
    n_items, kdim = 3_706, 10
    itf = rng.standard_normal((n_items, kdim)).astype(np.float32)
    itf[5] = 0.0  # a zero row: inverse norm 1 / 1e-9 times a zero dot
    sv = als.stage_item_serving(itf, serve_dtype=dtype, device=card)
    assert sv.items.shape[0] == 3_712
    for b in (1, 8):
        kw = {}
        if mask_kind == "rows":
            kw["exclude_rows"] = rng.integers(0, n_items, (b, 5)).astype(np.int32)
        elif mask_kind == "bits":
            kw["exclude_mask"] = rng.random((b, n_items)) < 0.9
        if verb == "similar_vectors_serving":
            arg = rng.standard_normal((b, kdim)).astype(np.float32)
        else:
            arg = rng.integers(0, n_items, b)
        for k in (1, 10, 50, 1024):
            before = (rec.LAUNCHES, rec.ROUTE_LAUNCHES["select"])
            kv, ki = getattr(als, verb)(sv, arg, k, **kw)
            assert (rec.LAUNCHES, rec.ROUTE_LAUNCHES["select"]) == (
                before[0] + 1, before[1] + 1)
            with monkeypatch.context() as m:
                m.setattr(als._rp, "fused_recommend_topk", rec.fused_recommend_topk_plain)
                pv, pi = getattr(als, verb)(sv, arg, k, **kw)
            assert rec.LAUNCHES == before[0] + 1
            assert np.array_equal(ki, pi), (b, k)
            assert np.array_equal(kv, pv), (b, k)
            if verb == "similar_serving":  # the query item only as a masked filler
                for r, it in enumerate(arg):
                    assert it not in ki[r][kv[r] > rec.NEG_INF / 2]


def test_pipelined_server_launches_equal_device_batches(card):
    """16 client threads against one QueryServer at continuous batching
    and depth 4: the top-k launches, and those of its select route, equal
    the device batches the server booked, and every answer equals the
    plain version's on the CPU."""
    import json
    import threading
    import urllib.request

    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm, ALSAlgorithmParams, ALSModel, Query)
    from predictionio_tpu_torch.workflow.server import (
        QueryServer, QueryServerConfig, _to_jsonable)

    rng = np.random.default_rng(19)
    n_users, n_items, kdim = 2_000, 5_000, 10
    factors = convert.als_factors_from_numpy(
        rng.standard_normal((n_users, kdim)).astype(np.float32),
        rng.standard_normal((n_items, kdim)).astype(np.float32),
        [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)], {})
    params = ALSAlgorithmParams(rank=kdim)
    server = QueryServer(ALSAlgorithm(params), ALSModel(factors, device=card),
                         QueryServerConfig(ip="127.0.0.1", port=0, pipeline_depth=4))
    port = server.start()
    bodies = [{"user": f"u{int(rng.integers(n_users))}",
               "num": int(rng.choice([5, 10, 50]))} for _ in range(16 * 40)]
    out = {}
    lock = threading.Lock()

    def client(c):
        for n in range(c, len(bodies), 16):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/queries.json", data=json.dumps(bodies[n]).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                with lock:
                    out[n] = (r.status, json.loads(r.read()))

    try:
        before = server.status()
        base = (rec.LAUNCHES, rec.ROUTE_LAUNCHES["select"])
        threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        after = server.status()
        launches = rec.LAUNCHES - base[0]
        selects = rec.ROUTE_LAUNCHES["select"] - base[1]
    finally:
        server.stop()
    batches = after["batches"] - before["batches"]
    assert len(out) == len(bodies)
    assert 0 < batches == launches == selects, (batches, launches, selects)
    cpu_model, cpu_alg = ALSModel(factors, device="cpu"), ALSAlgorithm(params)
    for n, q in enumerate(bodies):
        assert out[n] == (200, _to_jsonable(cpu_alg.predict(cpu_model, Query(**q)))), n
