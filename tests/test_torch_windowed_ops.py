"""Port parity for the windowed edge pass and the scatter-path segment
ops.

The same inputs, made with numpy from a seed, go through the JAX
package (``ops/windowed.py``, ``ops/windowed_pallas.py`` in interpret
mode, ``ops/segment.py``) and the port's counterparts on the CPU, where
the ``ops.windowed_fused`` wrappers run their plain PyTorch versions.

Tolerances:
- plans: every field equal.
- ``block_partials``: ``|port − jax| ≤ 1e-5 · S`` elementwise, S the
  same pass over the absolute terms (|w|·|y|): both sides sum the same
  f32 terms in another order. The same bar holds the kernel to its
  plain version on the card.
- ``windowed_gram_b``: rtol = atol = 1e-5 (1e-4 over two chunks), the
  JAX package's own bars between its XLA and Pallas paths
  (tests/test_windowed_pallas.py).
- segment ops: rtol 1e-5, atol 1e-6 (f32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.ops import segment as jseg  # noqa: E402
from predictionio_tpu.ops import windowed as jwin  # noqa: E402
from predictionio_tpu.ops import windowed_pallas as jwp  # noqa: E402
from predictionio_tpu_torch.ops import segment as tseg  # noqa: E402
from predictionio_tpu_torch.ops import windowed as twin  # noqa: E402
from predictionio_tpu_torch.ops import windowed_fused as twf  # noqa: E402

S, B_E, CB = twin.WINDOW_ROWS, twin.BLOCK_EDGES, twin.CHUNK_BLOCKS


def test_plan_constants_match_jax():
    assert (S, B_E, CB) == (jwin.WINDOW_ROWS, jwin.BLOCK_EDGES,
                            jwin.CHUNK_BLOCKS)


def _dst(case, rng):
    if case == "empty":
        return np.zeros(0, np.int32), 300
    if case == "one window":
        return np.sort(rng.integers(0, 90, 700)).astype(np.int32), 90
    if case == "long row":  # row 7 alone spans three blocks
        dst = np.concatenate([rng.integers(0, 400, 900), np.full(2500, 7)])
        return np.sort(dst).astype(np.int32), 400
    dst = np.sort(rng.integers(0, 1000, 6000)).astype(np.int32)
    dst[dst % 128 == 5] = 4  # some empty rows, a window-aligned gap
    return np.sort(dst), 1000


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("case", ["empty", "one window", "long row", "random"])
def test_plan_windows_matches_jax(case, n_parts):
    dst, n_rows = _dst(case, np.random.default_rng(0))
    ours = twin.plan_windows(dst, n_rows, n_parts)
    ref = jwin.plan_windows(dst, n_rows, n_parts)
    for f in dataclasses.fields(jwin.WindowPlan):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert ours.n_rows_padded == ref.n_rows_padded
    per_edge = np.arange(max(len(dst), 1), dtype=np.float32) + 1.0
    np.testing.assert_array_equal(ours.take(per_edge), ref.take(per_edge))
    np.testing.assert_array_equal(ours.take(per_edge[: len(dst)].astype(np.int32)),
                                  ref.take(per_edge[: len(dst)].astype(np.int32)))
    np.testing.assert_array_equal(ours.chunked_local(), ref.chunked_local())
    np.testing.assert_array_equal(ours.chunked_valid(), ref.chunked_valid())


def _chunk(rng, k, implicit, n_src=70, n_dst=400, n_edges=3000):
    """One chunk of CB blocks from a real plan, with signed ratings and
    the weights of the implicit or explicit half-step; extra padding
    slots get local ids past both ends of [0, S)."""
    dst = np.sort(rng.integers(0, n_dst, n_edges))
    src = rng.integers(0, n_src, n_edges).astype(np.int32)
    vals = (rng.integers(1, 11, n_edges) / 2.0
            * rng.choice([-1.0, 1.0], n_edges)).astype(np.float32)
    plan = twin.plan_windows(dst, n_dst)
    flat = (plan.n_blocks_p, B_E)
    v = plan.take(vals).reshape(flat)
    ok = plan.chunked_valid().reshape(flat)
    if implicit:
        conf = (1.0 + np.float32(1.7) * np.abs(v)).astype(np.float32)
        w_b, w_g = conf * (v > 0) * ok, (conf - 1.0) * ok
    else:
        w_b, w_g = v * ok, ok.copy()
    local = plan.chunked_local().reshape(flat).copy()
    pad = ok == 0
    local[pad & (np.arange(B_E) % 3 == 0)] = S + 17
    local[pad & (np.arange(B_E) % 3 == 1)] = -40
    factors = (rng.standard_normal((n_src, k)) / np.sqrt(k)).astype(np.float32)
    return (factors, plan.take(src).reshape(flat)[:CB], w_b[:CB].astype(np.float32),
            w_g[:CB].astype(np.float32), local[:CB])


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_block_partials_matches_pallas_interpret(k, implicit):
    rng = np.random.default_rng(k + 10 * implicit)
    factors, src, w_b, w_g, local = _chunk(rng, k, implicit)
    y_t = np.ascontiguousarray(factors[src].transpose(0, 2, 1))  # (CB, K, B_E)
    jb, jg = jwp.block_partials(jnp.asarray(y_t), jnp.asarray(w_b),
                                jnp.asarray(w_g), jnp.asarray(local),
                                s_rows=S, interpret=True)
    args = _torch(factors, src, w_b, w_g, local)
    tb, tg = twf.block_partials(*args)
    sb, sg = twf.block_partials_plain(*args, magnitude=True)
    assert tb.shape == (CB, S, k) and tg.shape == (CB, S, k * k)
    for got, want, mag in ((tb, jb, sb), (tg, jg, sg)):
        err = np.abs(got.numpy() - np.asarray(want))
        assert np.all(err <= 1e-5 * mag.numpy()), float(err.max())
    assert float(sb.sum()) > 0


def test_block_partials_skips_out_of_range_rows_and_zero_fills():
    """Slots with local ids outside [0, S) add nothing even with nonzero
    weights (the TPU kernel's one-hot never matches them); rows no slot
    reaches read exactly 0."""
    rng = np.random.default_rng(4)
    factors = rng.standard_normal((10, 4)).astype(np.float32)
    src = rng.integers(0, 10, (2, B_E)).astype(np.int32)
    w = rng.uniform(0.5, 2.0, (2, B_E)).astype(np.float32)
    local = np.full((2, B_E), 3, np.int32)
    local[0, ::2] = -1
    local[1] = S  # a whole block out of range
    pb, pg = twf.block_partials(*_torch(factors, src, w, w, local))
    keep = local[0] == 3
    want = (w[0, keep, None] * factors[src[0, keep]]).sum(0)
    np.testing.assert_allclose(pb[0, 3].numpy(), want, rtol=1e-5)
    assert not pb[0, :3].any() and not pb[0, 4:].any() and not pb[1].any()
    assert not pg[1].any()


def _pair_partials(factors, src, w_b, w_g, local):
    """The sums as the CUDA kernel lays them out, in plain torch: with
    z = (y, 1), only the entries a <= b of z zᵀ with a < K are summed,
    the K(K+1)/2 gram pairs (i, j) weighed by w_g and the K entries
    (d, K) by w_b; each gram pair is then stored to both (i, j) and
    (j, i)."""
    k = factors.shape[1]
    z = torch.cat([factors, torch.ones((factors.shape[0], 1))], 1)[src.long()]
    ii, jj = torch.triu_indices(k, k)
    pair = torch.empty((k, k), dtype=torch.long)
    pair[ii, jj] = pair[jj, ii] = torch.arange(len(ii))
    onehot = (local[:, None, :]
              == torch.arange(S, dtype=torch.int32)[None, :, None]).float()
    pb = torch.bmm(onehot * w_b[:, None, :], z[..., :k] * z[..., k:])
    pairs = torch.bmm(onehot * w_g[:, None, :], z[..., ii] * z[..., jj])
    return pb, pairs[..., pair.reshape(-1)]


@pytest.mark.parametrize("k", [1, 10, 11, 32])
def test_pair_layout_equals_block_partials_plain(k):
    """The kernel's layout (pairs a <= b, mirrored at the store) gives
    the plain version's bits: y_d * 1 = y_d and y_i * y_j = y_j * y_i
    exactly, so only which cells are summed changes."""
    rng = np.random.default_rng(40 + k)
    args = _torch(*_chunk(rng, k, True))
    kb, kg = _pair_partials(*args)
    pb, pg = twf.block_partials_plain(*args)
    assert torch.equal(kb, pb) and torch.equal(kg, pg)
    mirror = kg.reshape(CB, S, k, k)
    assert torch.equal(mirror, mirror.transpose(2, 3))


@pytest.mark.parametrize("k", [1, 10, 11, 32])
def test_pair_layout_matches_pallas_interpret(k):
    rng = np.random.default_rng(50 + k)
    factors, src, w_b, w_g, local = _chunk(rng, k, False)
    y_t = np.ascontiguousarray(factors[src].transpose(0, 2, 1))
    jb, jg = jwp.block_partials(jnp.asarray(y_t), jnp.asarray(w_b),
                                jnp.asarray(w_g), jnp.asarray(local),
                                s_rows=S, interpret=True)
    args = _torch(factors, src, w_b, w_g, local)
    kb, kg = _pair_partials(*args)
    sb, sg = twf.block_partials_plain(*args, magnitude=True)
    for got, want, mag in ((kb, jb, sb), (kg, jg, sg)):
        err = np.abs(got.numpy() - np.asarray(want))
        assert np.all(err <= 1e-5 * mag.numpy()), float(err.max())
    assert float(sg.sum()) > 0


def test_combine_windows_adds_blocks_in_order_and_drops_nothing():
    rng = np.random.default_rng(5)
    pb = torch.from_numpy(rng.standard_normal((6, S, 2)).astype(np.float32))
    pg = torch.from_numpy(rng.standard_normal((6, S, 4)).astype(np.float32))
    bwin = torch.tensor([0, 0, 2, 2, 2, 3], dtype=torch.int32)
    ob, og = twf.combine_windows(pb, pg, bwin, 4)
    assert ob.shape == (4 * S, 2) and og.shape == (4 * S, 4)
    want = torch.zeros((4, S, 2))
    for c, w in enumerate(bwin.tolist()):
        want[w] = want[w] + pb[c]
    assert torch.equal(ob, want.reshape(4 * S, 2))
    assert not ob[S : 2 * S].any()  # window 1 has no blocks


def test_wrappers_reject_bad_inputs():
    f = torch.zeros((5, 4))
    src = torch.zeros((2, 8), dtype=torch.int32)
    w = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="rank"):
        twf.block_partials(torch.zeros((5, 33)), src, w, w, src)
    with pytest.raises(ValueError, match="f32"):
        twf.block_partials(f.double(), src, w, w, src)
    with pytest.raises(ValueError, match="src"):
        twf.block_partials(f, src.long(), w, w, src)
    with pytest.raises(ValueError, match="w_g"):
        twf.block_partials(f, src, w, w[:1], src)
    pb, pg = twf.block_partials(f, src, w, w, src, s_rows=16)
    with pytest.raises(ValueError, match="block_window"):
        twf.combine_windows(pb, pg, torch.zeros(3, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="partials"):
        twf.combine_windows(pb, pb, torch.zeros(2, dtype=torch.int32), 1)


def _staged_edge_pass(rng, n_src, n_dst, n_edges, k=8):
    """A random edge list planned and laid out as windowed_gram_b takes
    it, as numpy (shared by both sides)."""
    src = rng.integers(0, n_src, n_edges)
    dst = np.sort(rng.integers(0, n_dst, n_edges))
    vals = rng.uniform(0.5, 5.0, n_edges).astype(np.float32)
    plan = twin.plan_windows(dst, n_dst)
    factors = rng.normal(size=(n_src, k)).astype(np.float32)
    return (factors, plan.take(src.astype(np.int32)), plan.take(vals),
            plan.take((1.0 + vals).astype(np.float32)), plan.chunked_local(),
            plan.block_window, plan.n_windows)


@pytest.mark.parametrize("pallas", [None, "interpret"])
@pytest.mark.parametrize("n_edges", [1, 500, 5000])
def test_windowed_gram_b_matches_jax(n_edges, pallas):
    rng = np.random.default_rng(7)
    *arrays, n_windows = _staged_edge_pass(rng, 60, 300, n_edges)
    jb, jg = jwin.windowed_gram_b(*(jnp.asarray(a) for a in arrays), n_windows,
                                  pallas=pallas)
    tb, tg = twin.windowed_gram_b(*_torch(*arrays), n_windows)
    assert tb.shape == jb.shape and tg.shape == jg.shape
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_windowed_gram_b_multi_chunk():
    """More blocks than one chunk: padding blocks carry the last real
    window's id and add nothing. rtol = atol = 1e-4, the JAX package's
    bar for this case: ~1,000 signed terms per sum."""
    rng = np.random.default_rng(11)
    *arrays, n_windows = _staged_edge_pass(rng, 40, 4 * S, CB * B_E + 777, k=4)
    assert arrays[1].shape[1] == 2  # two chunks
    jb, jg = jwin.windowed_gram_b(*(jnp.asarray(a) for a in arrays), n_windows)
    tb, tg = twin.windowed_gram_b(*_torch(*arrays), n_windows)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)


def test_windowed_gram_b_empty_plan_is_zero():
    plan = twin.plan_windows(np.zeros(0, np.int32), 200)
    f = torch.ones((3, 5))
    src = torch.from_numpy(plan.take(np.zeros(0, np.int32)))
    w = torch.from_numpy(plan.take(np.zeros(0, np.float32)))
    b, g = twin.windowed_gram_b(f, src, w, w, torch.from_numpy(plan.chunked_local()),
                                torch.from_numpy(plan.block_window), plan.n_windows)
    assert b.shape == (2 * S, 5) and g.shape == (2 * S, 25)
    assert not b.any() and not g.any()


def test_windowed_gram_b_refuses_several_parts():
    dst = np.sort(np.random.default_rng(2).integers(0, 600, 4000))
    plan = twin.plan_windows(dst, 600, n_parts=2)
    src = torch.from_numpy(plan.take(np.zeros(len(dst), np.int32)))
    w = torch.from_numpy(plan.chunked_valid())
    with pytest.raises(ValueError, match="2 parts"):
        twin.windowed_gram_b(torch.ones((3, 4)), src, w, w,
                             torch.from_numpy(plan.chunked_local()),
                             torch.from_numpy(plan.block_window), plan.n_windows)


# ---------------------------------------------------------------------------
# the scatter path's segment ops
# ---------------------------------------------------------------------------


def _edges(rng, n_src=50, n_dst=40, n_edges=800, k=6):
    src = rng.integers(0, n_src, n_edges)
    dst = np.sort(rng.integers(0, n_dst, n_edges))
    w = rng.uniform(-1.0, 2.0, n_edges).astype(np.float32)
    y = rng.standard_normal((n_src, k)).astype(np.float32)
    v = rng.standard_normal((n_dst, k)).astype(np.float32)
    return y, v, src, dst, w, n_dst


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((300, 3)).astype(np.float32)
    ids = rng.integers(0, 17, 300)
    _close(tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 20),
           jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 20))


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_edge_sums_match_jax(n_chunks):
    rng = np.random.default_rng(n_chunks)
    y, v, src, dst, w, n_dst = _edges(rng)
    t = dict(zip("yvsdw", _torch(y, v, src, dst, w)))
    j = dict(zip("yvsdw", (jnp.asarray(a) for a in (y, v, src, dst, w))))
    _close(tseg.chunked_weighted_edge_sum(t["y"], t["s"], t["d"], t["w"], n_dst,
                                          n_chunks),
           jseg.chunked_weighted_edge_sum(j["y"], j["s"], j["d"], j["w"], n_dst,
                                          n_chunks))
    _close(tseg.chunked_edge_matvec(t["y"], t["v"], t["s"], t["d"], t["w"],
                                    n_dst, n_chunks),
           jseg.chunked_edge_matvec(j["y"], j["v"], j["s"], j["d"], j["w"],
                                    n_dst, n_chunks))
    _close(tseg.chunked_gram_edge_sum(t["y"], t["s"], t["d"], t["w"], n_dst,
                                      n_chunks),
           jseg.chunked_gram_edge_sum(j["y"], j["s"], j["d"], j["w"], n_dst,
                                      n_chunks))
    _close(tseg.weighted_edge_sum(t["y"], t["s"], t["d"], t["w"], n_dst),
           jseg.weighted_edge_sum(j["y"], j["s"], j["d"], j["w"], n_dst))
    _close(tseg.edge_matvec(t["y"], t["v"], t["s"], t["d"], t["w"], n_dst),
           jseg.edge_matvec(j["y"], j["v"], j["s"], j["d"], j["w"], n_dst))
