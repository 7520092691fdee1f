"""Port parity for ALS training on the dense-W path, and the gate that
sends the rest to the windowed and scatter paths
(tests/test_torch_als_windowed.py).

The same COO ratings and init factors, made with numpy from a seed,
train through the JAX package's ``models/als.py`` and the port's on the
CPU (where the fused edge passes run their plain PyTorch versions).

Tolerances are the JAX package's own (tests/test_dense_als.py): the two
sides do the same math in another summation order with truncated CG, so
per-element drift compounds over the alternating iterations —
rtol = atol = 2e-3 for implicit (well conditioned) and 5e-2 for
explicit (ALS-WR) on f32 storage end to end, and per iteration on int8
storage, whose whole runs are held to factor correlation > 0.9999
against the JAX Pallas kernel (interpret mode) and > 0.999 against its
default XLA two-dot path, which rounds the int8 weights in bf16
arithmetic instead of f32.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402

NU, NI = 300, 180


def _coo(n_users=NU, n_items=NI, n_edges=6000, seed=0, signed=False):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, n_users, n_edges).astype(np.int32)
    cols = rng.randint(0, n_items, n_edges).astype(np.int32)
    key = rows.astype(np.int64) * n_items + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = (rng.randint(1, 11, len(rows)) / 2.0).astype(np.float32)
    if signed:
        vals *= rng.choice([-1.0, 1.0], len(rows)).astype(np.float32)
    return rows, cols, vals


def _init(rank, seed=1):
    rng = np.random.default_rng(seed)
    uf = (rng.standard_normal((NU, rank)) / np.sqrt(rank)).astype(np.float32)
    itf = (rng.standard_normal((NI, rank)) / np.sqrt(rank)).astype(np.float32)
    return uf, itf


def _params(implicit=True, rank=8, iterations=5, **kw):
    base = dict(rank=rank, iterations=iterations, implicit_prefs=implicit,
                alpha=2.0, lambda_=0.05)
    base.update(kw)
    return jals.ALSParams(**base), tals.ALSParams(**base)


def _corr(a, b):
    return np.corrcoef(np.ravel(a), np.ravel(b))[0, 1]


@pytest.mark.parametrize("implicit,signed,iterations", [
    (True, False, 4), (True, True, 5), (False, False, 6),
])
def test_train_matches_jax_pallas_interpret(monkeypatch, implicit, signed,
                                            iterations):
    """Every alternating iteration, started from the JAX package's state
    of the previous one, lands within rtol = atol = 2e-3 (implicit) /
    5e-2 (explicit) of the JAX iteration; the whole run from the same
    init correlates > 0.9999.

    The whole run is not held elementwise to those bars: the factors
    enter each pass rounded to bf16, so an f32-noise difference can
    flip one operand's rounding (2^-9 relative) and the alternating
    loop carries it on. The JAX package's own XLA and Pallas int8 paths
    differ by as much on this data."""
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    monkeypatch.setenv("PIO_PALLAS_DENSE", "interpret")
    rows, cols, vals = _coo(seed=3 + signed, signed=signed)
    tol = 2e-3 if implicit else 5e-2
    jp1, tp1 = _params(implicit, iterations=1)
    state = _init(8)
    for _ in range(iterations):
        ref = jals.train(rows, cols, vals, NU, NI, jp1, init_factors=state)
        got = tals.train(rows, cols, vals, NU, NI, tp1, init_factors=state,
                         device="cpu")
        np.testing.assert_allclose(got.user_factors, ref.user_factors,
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(got.item_factors, ref.item_factors,
                                   rtol=tol, atol=tol)
        state = (ref.user_factors, ref.item_factors)
    jp, tp = _params(implicit, iterations=iterations)
    ref = jals.train(rows, cols, vals, NU, NI, jp, init_factors=_init(8))
    got = tals.train(rows, cols, vals, NU, NI, tp, init_factors=_init(8),
                     device="cpu")
    assert _corr(got.user_factors, ref.user_factors) > 0.9999
    assert _corr(got.item_factors, ref.item_factors) > 0.9999


def test_train_close_to_jax_default_xla_path(monkeypatch):
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    monkeypatch.delenv("PIO_PALLAS_DENSE", raising=False)
    rows, cols, vals = _coo(seed=21)
    jp, tp = _params(iterations=4)
    init = _init(8, seed=2)
    ref = jals.train(rows, cols, vals, NU, NI, jp, init_factors=init)
    got = tals.train(rows, cols, vals, NU, NI, tp, init_factors=init,
                     device="cpu")
    assert np.all(np.isfinite(got.user_factors))
    assert _corr(got.user_factors, ref.user_factors) > 0.999
    assert _corr(got.item_factors, ref.item_factors) > 0.999


@pytest.mark.parametrize("implicit", [True, False])
def test_f32_storage_matches_jax(implicit):
    rows, cols, vals = _coo(seed=5)
    jp, tp = _params(implicit, iterations=5)
    init = _init(8, seed=3)
    js = jals.stage_dense(rows, cols, vals, NU, NI, jp, init_factors=init,
                          dense_dtype="f32")
    ts = tals.stage_dense(rows, cols, vals, NU, NI, tp, init_factors=init,
                          dense_dtype="f32", device="cpu")
    assert ts.dense_dtype == "f32"
    juf, jitf = js.factors(*js.run())
    tuf, titf = ts.factors(*ts.run())
    tol = 2e-3 if implicit else 5e-2
    np.testing.assert_allclose(tuf, juf, rtol=tol, atol=tol)
    np.testing.assert_allclose(titf, jitf, rtol=tol, atol=tol)


def test_bf16_storage_close_to_jax():
    rows, cols, vals = _coo(seed=6)
    jp, tp = _params(iterations=4)
    init = _init(8, seed=4)
    js = jals.stage_dense(rows, cols, vals, NU, NI, jp, init_factors=init,
                          dense_dtype="bf16")
    ts = tals.stage_dense(rows, cols, vals, NU, NI, tp, init_factors=init,
                          dense_dtype="bf16", device="cpu")
    juf, _ = js.factors(*js.run())
    tuf, _ = ts.factors(*ts.run())
    assert np.all(np.isfinite(tuf))
    assert _corr(tuf, juf) > 0.999


def test_stage_dense_picks_int8_like_jax():
    rows, cols, vals = _coo(seed=7)
    jp, tp = _params()
    js = jals.stage_dense(rows, cols, vals, NU, NI, jp)
    ts = tals.stage_dense(rows, cols, vals, NU, NI, tp, device="cpu")
    assert ts.dense_dtype == js.static_kwargs["dense_dtype"] == "int8"
    for key in ("scale", "rank", "iterations", "lam", "alpha"):
        assert ts.static_kwargs[key] == js.static_kwargs[key], key
    r = ts.device_args[0]
    assert r.dtype == torch.int8 and tuple(r.shape) == (2048, 256)
    np.testing.assert_array_equal(r.numpy(), np.asarray(js.device_args[0]))
    np.testing.assert_array_equal(ts.device_args[1].numpy(),
                                  np.asarray(js.device_args[1]))
    with pytest.raises(ValueError, match="int8"):
        tals.stage_dense(rows, cols, vals * 0.3, NU, NI, tp,
                         dense_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="init_factors"):
        tals.stage_dense(rows, cols, vals, NU, NI, tp,
                         init_factors=_init(4), device="cpu")


def test_resume_matches_straight_run(monkeypatch):
    """ALS iterations are memoryless in the factor state: 4 + 4 resumed
    iterations reproduce 8."""
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    rows, cols, vals = _coo(seed=8)
    _, p8 = _params(rank=6, iterations=8)
    _, p4 = _params(rank=6, iterations=4)
    full = tals.train(rows, cols, vals, NU, NI, p8, device="cpu")
    first = tals.train(rows, cols, vals, NU, NI, p4, device="cpu")
    second = tals.train(rows, cols, vals, NU, NI, p4, device="cpu",
                        init_factors=(first.user_factors, first.item_factors))
    np.testing.assert_allclose(second.user_factors, full.user_factors,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(second.item_factors, full.item_factors,
                               rtol=1e-3, atol=1e-4)


def test_random_init_is_seeded_and_masks_padding():
    rows, cols, vals = _coo(seed=9)
    _, tp = _params(iterations=0, seed=11)
    a = tals.stage_dense(rows, cols, vals, NU, NI, tp, device="cpu")
    uf, itf = a.run()
    uf2, itf2 = tals.stage_dense(rows, cols, vals, NU, NI, tp,
                                 device="cpu").run()
    assert torch.equal(uf, uf2) and torch.equal(itf, itf2)
    assert not uf[NU:].any() and not itf[NI:].any()
    assert uf[:NU].abs().min() > 0
    assert abs(float(uf[:NU].std()) - 1 / np.sqrt(8)) < 0.03


def test_train_returns_vocabularies_and_params(monkeypatch):
    from predictionio_tpu_torch.data.store.bimap import BiMap

    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    rows, cols, vals = _coo(seed=10)
    _, tp = _params(iterations=2)
    uv = BiMap({f"u{n}": n for n in range(NU)})
    iv = BiMap({f"i{n}": n for n in range(NI)})
    f = tals.train(rows, cols, vals, NU, NI, tp, user_vocab=uv,
                   item_vocab=iv, device="cpu")
    assert f.user_factors.shape == (NU, 8) and f.item_factors.shape == (NI, 8)
    assert f.user_factors.dtype == np.float32
    assert f.user_vocab is uv and f.params == tp


# ---------------------------------------------------------------------------
# the gate, case by case from the JAX package's test_gate_conditions
# ---------------------------------------------------------------------------


def test_gate_conditions(monkeypatch):
    rows, cols, vals = _coo(n_edges=500, seed=3)
    jp, tp = _params(rank=8)

    def ok(r=rows, c=cols, v=vals, jparams=jp, tparams=tp):
        want = jals.dense_eligible(r, c, v, NU, NI, jparams)
        got = tals.dense_eligible(r, c, v, NU, NI, tparams)
        assert got == want
        return got

    # auto mode: below the min-edge bar → the windowed path
    monkeypatch.delenv("PIO_DENSE_ALS", raising=False)
    assert not ok()
    # forced on: eligible at any size
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    assert ok()
    # forced off wins
    monkeypatch.setenv("PIO_DENSE_ALS", "0")
    assert not ok()
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    # memory budget
    monkeypatch.setenv("PIO_DENSE_ALS_BYTES", "1000")
    assert not ok()
    monkeypatch.setenv("PIO_DENSE_ALS_BYTES", "not-a-number")  # → default
    assert ok()
    monkeypatch.delenv("PIO_DENSE_ALS_BYTES")
    # duplicate pairs fall back (dense would merge them)
    assert not ok(np.concatenate([rows, rows[:1]]),
                  np.concatenate([cols, cols[:1]]),
                  np.concatenate([vals, vals[:1]]))
    # explicit with zero-valued ratings falls back
    z_vals = vals.copy()
    z_vals[0] = 0.0
    jpe, tpe = _params(False, rank=8)
    assert not ok(v=z_vals, jparams=jpe, tparams=tpe)
    # rank above the gram-solver bound
    jpr, tpr = _params(rank=33)
    assert not ok(jparams=jpr, tparams=tpr)


def test_gate_constants_match_jax():
    assert tals.GRAM_SOLVER_MAX_RANK == jals.GRAM_SOLVER_MAX_RANK
    assert tals.DENSE_DEFAULT_BYTES == jals.DENSE_DEFAULT_BYTES
    assert tals.DENSE_AUTO_MIN_EDGES == jals.DENSE_AUTO_MIN_EDGES
    for dt in ("f32", "bf16", "int8"):
        assert (tals.dense_matrix_bytes(138_493, 26_744, dt)
                == jals.dense_matrix_bytes(138_493, 26_744, dt))
    # ML-20M width in int8: 139,264 x 26,880 cells
    assert tals.dense_matrix_bytes(138_493, 26_744, "int8") == 139_264 * 26_880


@pytest.mark.parametrize("case,path", [
    ("under 1 M ratings", "_train_windowed"),
    ("rank 40", "_train_scatter"),
    ("repeated pairs", "_train_windowed"),
])
def test_train_routes_like_the_jax_gate(monkeypatch, case, path):
    """Input the JAX gate sends past the dense path trains on the path
    it picks — windowed up to rank 32, scatter beyond — and matches the
    JAX train from the same init to rtol = atol = 1e-4."""
    rows, cols, vals = _coo(n_edges=800, seed=4)
    rank = 40 if case == "rank 40" else 6
    jp, tp = _params(rank=rank, iterations=2)
    if case == "under 1 M ratings":
        monkeypatch.delenv("PIO_DENSE_ALS", raising=False)
    else:
        monkeypatch.setenv("PIO_DENSE_ALS", "1")
    if case == "repeated pairs":
        rows, cols, vals = (np.concatenate([a, a[:1]]) for a in (rows, cols, vals))
    assert not jals.dense_eligible(rows, cols, vals, NU, NI, jp)
    taken = []
    for name in ("_train_dense", "_train_windowed", "_train_scatter"):
        def spy(*a, _name=name, _fn=getattr(tals, name), **kw):
            taken.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tals, name, spy)
    init = _init(rank, seed=5)
    ref = jals.train(rows, cols, vals, NU, NI, jp, init_factors=init)
    got = tals.train(rows, cols, vals, NU, NI, tp, init_factors=init,
                     device="cpu")
    assert taken == [path]
    np.testing.assert_allclose(got.user_factors, ref.user_factors,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.item_factors, ref.item_factors,
                               rtol=1e-4, atol=1e-4)


def test_train_without_device_needs_the_card(monkeypatch):
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    rows, cols, vals = _coo(n_edges=800, seed=4)
    _, tp = _params(rank=4, iterations=1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tals.train(rows, cols, vals, NU, NI, tp)
