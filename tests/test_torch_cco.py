"""Port parity for the CCO train and the batched UR history scoring
(``predictionio_tpu_torch/models/cco.py``).

The same 0/1 matrices, correlator tables and histories, made with numpy
from a seed, go through the JAX package's ``models/cco.py`` and the
port's on the CPU.

LLR tolerance: ``llr_scores`` subtracts entropy terms of size N·ln N
(N users) to reach values of order 1-100, and ``torch.log`` and XLA's
``log`` may differ in the last ulp, so values are held to
``atol = 16 · eps_f32 · N·ln N``. Indices are compared exactly outside
tie groups (runs of values within that atol of each other or of 0, and
the run that reaches the end of the list, whose members outside the
list are unseen); inside them, as sets.

Batched scoring: the port sums each item's correlator hits in one fixed
order, the JAX package in an einsum, so scores are held to rtol 1e-5
(as tests/test_universal.py holds the JAX path to ``score_history``)
and indices must be equal.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from predictionio_tpu.models import cco as jcco  # noqa: E402
from predictionio_tpu_torch.models import cco as tcco  # noqa: E402


def llr_atol(n_users: int) -> float:
    return 16 * float(np.finfo(np.float32).eps) * n_users * np.log(n_users)


def assert_correlators_close(ref, got, n_users):
    """(values, indices) of two CCO trains: values within the LLR atol
    position by position, indices equal outside tie groups and equal as
    sets inside them."""
    (rv, ri), (gv, gi) = ref, got
    atol = llr_atol(n_users)
    assert rv.shape == gv.shape and ri.shape == gi.shape
    np.testing.assert_allclose(gv, rv, rtol=0, atol=atol)
    n = rv.shape[1]
    for row in range(rv.shape[0]):
        v = rv[row]
        start = 0
        while start < n:
            end = start + 1
            while end < n and abs(v[end] - v[end - 1]) <= atol:
                end += 1
            near_zero = v[start] <= atol
            if not near_zero and end < n:  # a closed run: same members
                assert sorted(ri[row, start:end]) == sorted(gi[row, start:end]), (
                    row, start, end, ri[row], gi[row])
            start = end


def _matrices(seed, n_users=60, n_items=300, n_things=150):
    rng = np.random.RandomState(seed)
    p = (rng.rand(n_users, n_items) < 0.1).astype(np.float32)
    s = (rng.rand(n_users, n_things) < 0.15).astype(np.float32)
    return p, s


def test_llr_scores_match():
    p, s = _matrices(1)
    counts = p.T @ s
    prim, sec = p.sum(0), s.sum(0)
    ref = np.asarray(jcco.llr_scores(counts, prim, sec, np.float32(p.shape[0])))
    got = tcco.llr_scores(torch.from_numpy(counts), torch.from_numpy(prim),
                          torch.from_numpy(sec), p.shape[0]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=llr_atol(p.shape[0]))
    assert (got >= 0).all() and np.isfinite(got).all()


@pytest.mark.parametrize("block_items", [8192, 64])
@pytest.mark.parametrize("self_indicator", [True, False])
def test_cross_occurrence_topn_matches(self_indicator, block_items):
    """Self and secondary indicators, one block and many blocks
    (tests/test_universal.py:333), against the JAX package's one-block
    train."""
    p, s = _matrices(4)
    sec = p if self_indicator else s
    ref = jcco.cross_occurrence_topn(p, sec, 8, self_indicator=self_indicator)
    got = tcco.cross_occurrence_topn(p, sec, 8, self_indicator=self_indicator,
                                     block_items=block_items, device="cpu")
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert_correlators_close(ref, got, p.shape[0])
    if self_indicator:  # never its own correlator
        rows = np.arange(p.shape[1])[:, None]
        assert not (got[1] == rows).any()


def test_llr_chunks_are_exact(monkeypatch):
    """Row chunks inside a block give the same bits as one chunk."""
    p, s = _matrices(5)
    whole = tcco.cross_occurrence_topn(p, p, 8, self_indicator=True, device="cpu")
    monkeypatch.setattr(tcco, "LLR_CHUNK_ELEMS", 7 * p.shape[1])
    chunked = tcco.cross_occurrence_topn(p, p, 8, self_indicator=True, device="cpu")
    assert np.array_equal(whole[0], chunked[0])
    assert np.array_equal(whole[1], chunked[1])


def _small_cases():
    """tests/test_universal.py's TestCCOKernel inputs."""
    e = jcco.edges_to_indicator
    return {
        "counts_and_llr": (e(np.arange(6), np.array([0, 0, 0, 0, 1, 1]), 6, 2),
                           e(np.arange(6), np.array([1, 1, 1, 1, 0, 0]), 6, 2),
                           2, False),
        "no_cooccurrence": (e(np.array([0]), np.array([0]), 4, 1),
                            e(np.array([1]), np.array([0]), 4, 1), 1, False),
        "self_diagonal": (e(np.array([0, 0, 1, 1, 2, 3]),
                            np.array([0, 1, 0, 1, 2, 2]), 4, 3), None, 2, True),
        "uninformative": (np.ones((8, 2), np.float32),
                          np.ones((8, 2), np.float32), 2, False),
    }


@pytest.mark.parametrize("name", sorted(_small_cases()))
def test_small_cco_cases_match(name):
    p, s, top_n, self_ind = _small_cases()[name]
    s = p if s is None else s
    ref = jcco.cross_occurrence_topn(p, s, top_n, self_indicator=self_ind)
    got = tcco.cross_occurrence_topn(p, s, top_n, self_indicator=self_ind,
                                     device="cpu")
    assert_correlators_close(ref, got, p.shape[0])
    assert np.array_equal(ref[1], got[1])


def test_edges_to_indicator_matches():
    rows, cols = np.array([0, 2, 2, 5, 0]), np.array([1, 0, 3, 3, 1])
    got = tcco.edges_to_indicator(rows, cols, 6, 4, device="cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), jcco.edges_to_indicator(rows, cols, 6, 4))


def test_score_history_matches():
    rng = np.random.RandomState(2)
    idx = rng.randint(-1, 40, (50, 6))
    vals = rng.rand(50, 6).astype(np.float32)
    for hist in (np.array([3, 2, 17]), np.empty(0, int), rng.randint(0, 40, 30)):
        assert np.array_equal(tcco.score_history(idx, vals, hist),
                              jcco.score_history(idx, vals, hist))


def test_mesh_is_not_ported():
    p, s = _matrices(6, 8, 10, 5)
    with pytest.raises(NotImplementedError):
        tcco.cross_occurrence_topn(p, s, 3, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# batched history scoring
# ---------------------------------------------------------------------------


def _cco_tables(rng, I=500, T=20, js=(120, 80)):
    """tests/test_fused_serving.py's tables and histories."""
    tables, hists = [], []
    for J in js:
        idx = rng.randint(-1, J, (I, T)).astype(np.int32)
        sc = np.abs(rng.standard_normal((I, T))).astype(np.float32)
        tables.append((idx, sc, J))
        hists.append(rng.randint(-1, J, (8, 16)).astype(np.int32))
    return tables, hists


def _assert_same(ref, got):
    assert got[1].dtype == np.int32 and got[0].dtype == np.float32
    assert np.array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)


@pytest.mark.parametrize("jmode", ["off", "interpret"])
@pytest.mark.parametrize("width", [32, 128])
def test_batch_score_topk_matches_jax(width, jmode):
    """Row-list (narrow) and host-packed (wide) exclusions against each
    of the JAX package's tails: XLA (``off``) and its kernel in interpret
    mode (tests/test_fused_serving.py:176)."""
    rng = np.random.RandomState(25)
    tables, hists = _cco_tables(rng)
    ex = np.full((8, width), -1, np.int32)
    for b in range(8):
        ex[b, :12] = rng.choice(500, 12, replace=False)
    got = tcco.batch_score_topk(tables, hists, ex, 17, device="cpu")
    _assert_same(jcco.batch_score_topk(tables, hists, ex, 17, mode=jmode), got)


@pytest.mark.parametrize("jmode", ["off", "interpret"])
def test_batch_score_topk_ties_and_k_edge(jmode):
    """Every item row carries the same correlators (global ties) and
    k == n_items: lax.top_k's lowest-index order, as each of the JAX
    package's tails gives it."""
    rng = np.random.RandomState(26)
    I, J = 256, 40
    idx = np.tile(rng.randint(0, J, (1, 6)), (I, 1)).astype(np.int32)
    sc = np.tile(np.abs(rng.standard_normal((1, 6))), (I, 1)).astype(np.float32)
    hist = rng.randint(-1, J, (4, 8)).astype(np.int32)
    ex = np.full((4, 8), -1, np.int32)
    got = tcco.batch_score_topk([(idx, sc, J)], [hist], ex, I, device="cpu")
    _assert_same(
        jcco.batch_score_topk([(idx, sc, J)], [hist], ex, I, mode=jmode), got
    )


def test_batch_score_topk_matches_score_history():
    """tests/test_universal.py:267: the batch equals the host reference
    scorer summed over indicators, excluded items zeroed."""
    rng = np.random.RandomState(5)
    n_items = 500
    tables = []
    for n_things in (300, 120):
        idx = rng.randint(0, n_things, (n_items, 16)).astype(np.int32)
        for i in range(0, n_items, 3):
            idx[i, 8:] = -1
        scores = rng.rand(n_items, 16).astype(np.float32) + 0.1
        scores[idx < 0] = 0.0
        tables.append((idx, scores, n_things))
    B, H = 6, 20
    hists = []
    for _, _, j in tables:
        h = np.full((B, H), -1, np.int32)
        for b in range(B):
            n = rng.randint(0, H)
            h[b, :n] = rng.randint(0, j, n)
        hists.append(h)
    exclude = np.full((B, 8), -1, np.int32)
    exclude[0, :3] = [1, 2, 3]
    vals, idx = tcco.batch_score_topk(tables, hists, exclude, k=n_items,
                                      device="cpu")
    for b in range(B):
        expect = np.zeros(n_items, np.float32)
        for (cidx, csc, _j), h in zip(tables, hists):
            expect += tcco.score_history(cidx, csc, h[b][h[b] >= 0])
        got = np.zeros(n_items, np.float32)
        got[idx[b]] = np.maximum(vals[b], 0.0)
        expect[exclude[b][exclude[b] >= 0]] = 0.0
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


def test_batch_score_topk_batch_invariant():
    """A query's scores do not depend on the batch it rides in."""
    rng = np.random.RandomState(8)
    tables, hists = _cco_tables(rng)
    ex = np.full((8, 8), -1, np.int32)
    full = tcco.batch_score_topk(tables, hists, ex, 30, device="cpu")
    for b in (0, 5):
        one = tcco.batch_score_topk(tables, [h[b:b + 1] for h in hists],
                                    ex[b:b + 1], 30, device="cpu")
        assert np.array_equal(one[0][0], full[0][b])
        assert np.array_equal(one[1][0], full[1][b])


def test_batch_score_topk_rejects_unknown_mode():
    """The port has one tail: a tail mode is not an argument."""
    rng = np.random.RandomState(9)
    tables, hists = _cco_tables(rng, I=50, js=(10,))
    with pytest.raises(TypeError, match="mode"):
        tcco.batch_score_topk(tables, hists, np.full((8, 8), -1, np.int32), 5,
                              mode="interpret", device="cpu")


def test_entry_points_need_the_card_by_default():
    p, s = _matrices(7, 8, 10, 5)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcco.cross_occurrence_topn(p, s, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcco.edges_to_indicator([0], [0], 2, 2)
