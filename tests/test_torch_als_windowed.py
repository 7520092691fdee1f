"""Port parity for ALS training on the windowed and scatter paths.

The same COO ratings and init factors, made with numpy from a seed,
train through the JAX package's ``models/als.py`` and the port's on the
CPU, where ``ops.windowed_fused`` runs its plain PyTorch versions. Both
sides do the same f32 math with sums in another order, so whole trains
are held to rtol = atol = 1e-4, the JAX package's bar between its XLA
and Pallas windowed trains (tests/test_windowed_pallas.py); one
half-step from the same state to rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402

NU, NI = 300, 180
TOL = dict(rtol=1e-4, atol=1e-4)


def _coo(n_edges=5000, seed=0, dup=False, signed=False):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, NU, n_edges).astype(np.int32)
    cols = rng.integers(0, NI, n_edges).astype(np.int32)
    if not dup:
        _, idx = np.unique(rows.astype(np.int64) * NI + cols, return_index=True)
        rows, cols = rows[idx], cols[idx]
    else:  # every tenth pair rated twice more
        rep = np.arange(0, len(rows), 10)
        rows = np.concatenate([rows, rows[rep], rows[rep]])
        cols = np.concatenate([cols, cols[rep], cols[rep]])
    vals = (rng.integers(1, 11, len(rows)) / 2.0).astype(np.float32)
    if signed:
        vals *= rng.choice([-1.0, 1.0], len(rows)).astype(np.float32)
    return rows, cols, vals


def _init(rank, seed=1):
    rng = np.random.default_rng(seed)
    uf = (rng.standard_normal((NU, rank)) / np.sqrt(rank)).astype(np.float32)
    itf = (rng.standard_normal((NI, rank)) / np.sqrt(rank)).astype(np.float32)
    return uf, itf


def _params(implicit=True, rank=8, iterations=3, **kw):
    base = dict(rank=rank, iterations=iterations, implicit_prefs=implicit,
                alpha=2.0, lambda_=0.05)
    base.update(kw)
    return jals.ALSParams(**base), tals.ALSParams(**base)


def _assert_trains_match(got, ref):
    np.testing.assert_allclose(got.user_factors, ref.user_factors, **TOL)
    np.testing.assert_allclose(got.item_factors, ref.item_factors, **TOL)


@pytest.mark.parametrize("implicit", [True, False])
def test_half_step_matches_jax(implicit):
    rows, cols, vals = _coo(seed=1, signed=True)
    jp, tp = _params(implicit, rank=6)
    uf, itf = _init(6, seed=2)
    js = jals.stage_windowed(rows, cols, vals, NU, NI, jp, init_factors=(uf, itf))
    ts = tals.stage_windowed(rows, cols, vals, NU, NI, tp, init_factors=(uf, itf),
                             device="cpu")
    kw = dict(implicit=implicit, lam=0.05, alpha=2.0, cg_iterations=3)
    n_win = js.static_kwargs["n_user_windows"]
    ref = jals._half_step_windowed(
        js.device_args[13], *js.device_args[:5], js.device_args[10],
        js.device_args[12], n_windows=n_win, **kw)
    got = tals._half_step_windowed(
        ts.device_args[13], *ts.device_args[:5], ts.device_args[10],
        ts.device_args[12], n_windows=n_win, **kw)
    assert got.shape == ref.shape == (n_win * 128, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert not got[NU:].any()  # window padding stays zero


def test_stage_windowed_matches_jax():
    rows, cols, vals = _coo(seed=3, dup=True)
    jp, tp = _params()
    js = jals.stage_windowed(rows, cols, vals, NU, NI, jp, init_factors=_init(8))
    ts = tals.stage_windowed(rows, cols, vals, NU, NI, tp, init_factors=_init(8),
                             device="cpu")
    for n, (got, want) in enumerate(zip(ts.device_args, js.device_args)):
        want = np.array(want)
        assert got.dtype == torch.from_numpy(want).dtype, n
        np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))
    for key in ("n_user_windows", "n_item_windows", "rank", "iterations",
                "implicit", "lam", "alpha", "cg_iterations", "seed"):
        assert ts.static_kwargs[key] == js.static_kwargs[key], key
    assert ts.host_prep_sec > 0 and ts.transfer_sec >= 0


@pytest.mark.parametrize("implicit,rank,dup,signed", [
    (True, 10, False, False),
    (False, 10, False, False),
    (True, 1, False, True),
    (True, 32, False, False),
    (True, 10, True, True),
    (False, 10, True, False),
])
def test_windowed_train_matches_jax(implicit, rank, dup, signed):
    rows, cols, vals = _coo(seed=4 + rank, dup=dup, signed=signed)
    jp, tp = _params(implicit, rank=rank, iterations=2 if rank == 32 else 3)
    init = _init(rank, seed=5)
    assert not jals.dense_eligible(rows, cols, vals, NU, NI, jp)
    ref = jals.train(rows, cols, vals, NU, NI, jp, init_factors=init)
    got = tals.train(rows, cols, vals, NU, NI, tp, init_factors=init,
                     device="cpu")
    _assert_trains_match(got, ref)


def test_windowed_train_matches_jax_pallas_interpret(monkeypatch):
    monkeypatch.setenv("PIO_PALLAS_WINDOWED", "interpret")
    rows, cols, vals = _coo(seed=8, signed=True)
    jp, tp = _params(rank=8, iterations=2)
    init = _init(8, seed=6)
    ref = jals.train(rows, cols, vals, NU, NI, jp, init_factors=init)
    got = tals.train(rows, cols, vals, NU, NI, tp, init_factors=init,
                     device="cpu")
    _assert_trains_match(got, ref)


def test_windowed_random_init_is_seeded_and_masks_padding():
    rows, cols, vals = _coo(seed=9)
    _, tp = _params(iterations=0, seed=11)
    uf, itf = tals.stage_windowed(rows, cols, vals, NU, NI, tp,
                                  device="cpu").run()
    uf2, itf2 = tals.stage_windowed(rows, cols, vals, NU, NI, tp,
                                    device="cpu").run()
    assert torch.equal(uf, uf2) and torch.equal(itf, itf2)
    assert uf.shape == (384, 8) and itf.shape == (256, 8)
    assert not uf[NU:].any() and not itf[NI:].any()
    assert uf[:NU].abs().min() > 0
    # the same draw as the dense path's, up to the padded heights
    d_uf, _ = tals.stage_dense(rows, cols, vals, NU, NI, tp, device="cpu").run()
    assert torch.equal(uf[:NU], d_uf[:NU])


# ---------------------------------------------------------------------------
# the scatter path (rank > 32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("implicit,chunk", [(True, 1 << 21), (False, 1 << 21),
                                            (True, 1500)])
def test_scatter_train_matches_jax(implicit, chunk):
    """Rank 40: matrix-free CG over the edge list; a small
    edge_chunk_size cuts it into padded chunks on both sides."""
    rows, cols, vals = _coo(seed=12, dup=True, signed=True)
    jp, tp = _params(implicit, rank=40, iterations=2, edge_chunk_size=chunk)
    init = _init(40, seed=7)
    ref = jals.train(rows, cols, vals, NU, NI, jp, init_factors=init)
    got = tals.train(rows, cols, vals, NU, NI, tp, init_factors=init,
                     device="cpu")
    _assert_trains_match(got, ref)


@pytest.mark.parametrize("implicit", [True, False])
def test_scatter_half_steps_with_built_operators_match_jax(implicit):
    """Up to rank 32 the scatter half-steps build every row's operator in
    one edge pass (the branch train() leaves to the windowed path)."""
    rng = np.random.default_rng(13)
    n_src, n_dst, e, k = 50, 40, 900, 6
    src = rng.integers(0, n_src, e)
    dst = np.sort(rng.integers(0, n_dst, e))
    val = rng.uniform(-2.0, 5.0, e).astype(np.float32)
    fixed = rng.standard_normal((n_src, k)).astype(np.float32)
    x0 = rng.standard_normal((n_dst, k)).astype(np.float32)
    ok = (rng.random(e) > 0.1).astype(np.float32)
    deg = np.bincount(dst, minlength=n_dst).astype(np.float32)
    j = [jnp.asarray(a) for a in (fixed, src, dst, val, ok, deg, x0)]
    t = [torch.from_numpy(a) for a in (fixed, src, dst, val, ok, deg, x0)]
    if implicit:
        def args(f, s, d, v, o, _, x):
            return (f, s, d, 1.0 + 2.0 * abs(v), (v > 0) * 1.0, o, x, 0.05, 3, 3)
        ref = jals._half_step_implicit(*args(*j[:3], j[3], *j[4:]))
        got = tals._half_step_implicit(*args(*t[:3], t[3], *t[4:]))
    else:
        ref = jals._half_step_explicit(*j[:5], j[5], j[6], 0.05, 3, 3)
        got = tals._half_step_explicit(*t[:5], t[5], t[6], 0.05, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the gate at MovieLens-25M's width
# ---------------------------------------------------------------------------


def test_ml25m_width_is_over_the_dense_budget(monkeypatch):
    """162,541 users x 59,047 items in int8 is 9,688,842,240 bytes, over
    DENSE_DEFAULT_BYTES: both gates send it to the windowed path even
    when PIO_DENSE_ALS=1 lifts the edge-count bar."""
    n_u, n_i = 162_541, 59_047
    for dt in ("int8", "bf16", "f32"):
        assert tals.dense_matrix_bytes(n_u, n_i, dt) == jals.dense_matrix_bytes(
            n_u, n_i, dt)
    assert tals.dense_matrix_bytes(n_u, n_i, "int8") == 9_688_842_240
    assert 9_688_842_240 > tals.DENSE_DEFAULT_BYTES
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    rng = np.random.default_rng(0)
    rows = rng.integers(0, n_u, 1000).astype(np.int32)
    cols = rng.integers(0, n_i, 1000).astype(np.int32)
    vals = (rng.integers(1, 11, 1000) / 2.0).astype(np.float32)
    jp, tp = _params(rank=10)
    assert not tals.dense_eligible(rows, cols, vals, n_u, n_i, tp)
    assert not jals.dense_eligible(rows, cols, vals, n_u, n_i, jp)
