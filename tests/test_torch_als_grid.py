"""Port parity for the ALS tuning grid (``models/als.py:train_grid`` and
``ALSAlgorithm.train_grid``).

- Against the port's own serial ``train`` on the CPU: every grid point,
  windowed and forced dense, in several rank groups, is bit-equal to the
  serial train of its params, and the grid stages the data once.
- Against the JAX package's ``train_grid`` on the same seeded COO data:
  the port's seeded init is replaced by the JAX package's threefry draw
  (partitionable, so rows [:n] of a larger draw are the same), and then
  the windowed grid is held to rtol = atol = 1e-4, the bar of
  tests/test_torch_als_windowed.py, and the forced-dense grid (int8
  storage; the JAX grid runs its XLA two-dot path, which rounds the int8
  weights in bf16 arithmetic) to factor correlation > 0.999, the bar of
  tests/test_torch_als_train.py against that path.
- A rank above 32, or implicit and explicit points in one grid, raises;
  ``ALSAlgorithm.train_grid`` then trains serially. Each grid model
  serves at its own point's dtype. ``Engine`` sends a grid that is not
  batchable down the per-point path, as the JAX package's ``Engine``
  decides.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.controller.engine import EngineParams as JEngineParams  # noqa: E402
from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu_torch.controller import EngineParams  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402

NU, NI = 240, 150


def _coo(n_edges=4000, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, NU, n_edges).astype(np.int32)
    cols = rng.integers(0, NI, n_edges).astype(np.int32)
    _, idx = np.unique(rows.astype(np.int64) * NI + cols, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = (rng.integers(1, 11, len(rows)) / 2.0).astype(np.float32)
    return rows, cols, vals


# rank x iterations x λ (x α): four signature groups of two points each
GRID = [dict(rank=r, iterations=it, lambda_=lam, alpha=a)
        for r in (4, 6) for it in (2, 3) for lam, a in ((0.01, 1.0), (0.1, 2.0))]


def _grid(pkg, implicit=True):
    return [pkg.ALSParams(implicit_prefs=implicit, **g) for g in GRID]


def jax_init(n_users_p, n_items_p, rank, user_deg, item_deg, seed):
    """The JAX package's start factors (models/als.py, the threefry draw
    of its dense and windowed trains), as the port's `_seeded_init`
    returns them."""
    ku, ki = jax.random.split(jax.random.PRNGKey(int(seed)))
    with jax.threefry_partitionable(True):
        uf = jax.random.normal(ku, (n_users_p, rank), jnp.float32) / jnp.sqrt(rank)
        itf = jax.random.normal(ki, (n_items_p, rank), jnp.float32) / jnp.sqrt(rank)

    def put(x, deg):
        return torch.from_numpy(np.array(x)).to(deg.device) * (deg >= 0)[:, None]

    return put(uf, user_deg), put(itf, item_deg)


def _staged_counter(monkeypatch):
    calls = []
    for name in ("stage_dense", "stage_windowed"):
        fn = getattr(tals, name)
        monkeypatch.setattr(tals, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("route,implicit", [
    ("windowed", True), ("windowed", False), ("dense", True), ("dense", False),
])
def test_grid_points_bit_equal_serial_train(monkeypatch, route, implicit):
    monkeypatch.setenv("PIO_DENSE_ALS", "1" if route == "dense" else "0")
    rows, cols, vals = _coo(seed=1)
    params = _grid(tals, implicit)
    staged = _staged_counter(monkeypatch)
    grid = tals.train_grid(rows, cols, vals, NU, NI, params, device="cpu")
    assert staged == [f"stage_{route}"]  # one staging for all four groups
    for p, got in zip(params, grid):
        assert got.params == p
        assert got.user_factors.shape == (NU, p.rank)
        ref = tals.train(rows, cols, vals, NU, NI, p, device="cpu")
        np.testing.assert_array_equal(got.user_factors, ref.user_factors)
        np.testing.assert_array_equal(got.item_factors, ref.item_factors)
        assert np.all(np.isfinite(got.user_factors))


def test_dense_grid_keeps_the_staged_int8_scale(monkeypatch):
    """Half-star ratings stage as int8 with scale 2: every point runs with
    the staged scale, not the default 1."""
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    rows, cols, vals = _coo(seed=2)
    seen = []
    loop = tals._train_loop_dense
    monkeypatch.setattr(tals, "_train_loop_dense", lambda *a, **k: (
        seen.append((a[0].dtype, k["scale"], k["rank"], k["lam"])), loop(*a, **k))[1])
    tals.train_grid(rows, cols, vals, NU, NI, _grid(tals), device="cpu")
    assert [s[:2] for s in seen] == [(torch.int8, 2.0)] * len(GRID)
    assert [(r, lam) for *_, r, lam in seen] == [(g["rank"], g["lambda_"]) for g in GRID]


@pytest.mark.parametrize("route", ["windowed", "dense"])
def test_grid_matches_jax_train_grid(monkeypatch, route):
    monkeypatch.setenv("PIO_DENSE_ALS", "1" if route == "dense" else "0")
    monkeypatch.setattr(tals, "_seeded_init", jax_init)
    rows, cols, vals = _coo(seed=3)
    ref = jals.train_grid(rows, cols, vals, NU, NI, _grid(jals))
    got = tals.train_grid(rows, cols, vals, NU, NI, _grid(tals), device="cpu")
    for g, r in zip(got, ref):
        for side in ("user_factors", "item_factors"):
            a, b = getattr(g, side), np.asarray(getattr(r, side))
            assert a.shape == b.shape
            if route == "windowed":
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
            else:
                assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999


def test_rank_above_32_raises():
    rows, cols, vals = _coo()
    with pytest.raises(ValueError):
        tals.train_grid(rows, cols, vals, NU, NI,
                        [tals.ALSParams(rank=4), tals.ALSParams(rank=40)],
                        device="cpu")
    with pytest.raises(ValueError):
        jals.train_grid(rows, cols, vals, NU, NI,
                        [jals.ALSParams(rank=4), jals.ALSParams(rank=40)])


def _td(rows, cols, vals):
    from predictionio_tpu_torch.data.store.bimap import BiMap

    return teng.TrainingData(
        rows=rows, cols=cols, vals=vals, n_users=NU, n_items=NI,
        user_vocab=BiMap({f"u{n}": n for n in range(NU)}),
        item_vocab=BiMap({f"i{n}": n for n in range(NI)}))


def test_algorithm_grid_binds_models_and_falls_back_to_serial(monkeypatch):
    monkeypatch.setenv("PIO_DENSE_ALS", "0")
    rows, cols, vals = _coo(seed=4)
    td = _td(rows, cols, vals)
    ctx = RuntimeContext(device="cpu")
    hetero = [teng.ALSAlgorithmParams(rank=r, num_iterations=2) for r in (4, 40)]
    staged = _staged_counter(monkeypatch)
    models = teng.ALSAlgorithm(hetero[0]).train_grid(ctx, td, hetero)
    assert staged == ["stage_windowed"]  # the rank-4 point; rank 40 scatters
    for p, m in zip(hetero, models):
        assert isinstance(m, teng.ALSModel) and m.device == torch.device("cpu")
        ref = teng.ALSAlgorithm(p).train(ctx, td)
        np.testing.assert_array_equal(m.factors.user_factors, ref.factors.user_factors)
        np.testing.assert_array_equal(m.factors.item_factors, ref.factors.item_factors)
    homo = [teng.ALSAlgorithmParams(rank=4, num_iterations=2, lambda_=lam,
                                    serve_dtype="bf16") for lam in (0.01, 0.1)]
    models = teng.ALSAlgorithm(homo[0]).train_grid(ctx, td, homo)
    assert [m.device for m in models] == [torch.device("cpu")] * 2
    assert [m.serve_dtype for m in models] == ["bf16"] * 2
    assert models[0].serving_state().device == torch.device("cpu")


def test_mixed_implicit_grid_trains_serially(monkeypatch):
    """Zero ratings keep explicit points off the dense path, not implicit
    ones: a grid that mixes them is refused, and each point then trains
    on its own serial path (implicit dense, explicit windowed)."""
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    rows, cols, vals = _coo(seed=5)
    vals[::9] = 0.0
    mixed = [teng.ALSAlgorithmParams(rank=4, num_iterations=2, implicit_prefs=imp)
             for imp in (False, True)]
    with pytest.raises(ValueError, match="implicit_prefs"):
        tals.train_grid(rows, cols, vals, NU, NI,
                        [tals.ALSParams(rank=4, implicit_prefs=p.implicit_prefs)
                         for p in mixed], device="cpu")
    td = _td(rows, cols, vals)
    ctx = RuntimeContext(device="cpu")
    staged = _staged_counter(monkeypatch)
    models = teng.ALSAlgorithm(mixed[0]).train_grid(ctx, td, mixed)
    assert staged == ["stage_windowed", "stage_dense"]
    for p, m in zip(mixed, models):
        ref = teng.ALSAlgorithm(p).train(ctx, td)
        np.testing.assert_array_equal(m.factors.user_factors, ref.factors.user_factors)
        np.testing.assert_array_equal(m.factors.item_factors, ref.factors.item_factors)


def test_grid_serves_each_point_at_its_dtype(monkeypatch):
    """A grid that differs only in serve_dtype: each point's answers are
    those of `Engine.eval` of that point alone."""
    monkeypatch.setenv("PIO_DENSE_ALS", "0")
    td = _td(*_coo(seed=6))
    qa = [(teng.Query(user=f"u{u}", num=10), teng.ActualResult([]))
          for u in range(0, NU, 7)]
    monkeypatch.setattr(teng.RecommendationDataSource, "read_eval",
                        lambda self, ctx: [(td, teng.EvalInfo(fold=0), qa)])
    eps = [EngineParams(
        data_source_params=("", teng.DataSourceParams(app_name="A", eval_k=2)),
        algorithm_params_list=(("als", teng.ALSAlgorithmParams(
            rank=4, num_iterations=2, serve_dtype=dtype)),))
        for dtype in ("f32", "int8")]
    engine = teng.RecommendationEngine().apply()
    ctx = RuntimeContext(device="cpu")
    assert engine._grid_batchable(ctx, eps)
    grid = engine.batch_eval(ctx, eps)
    for ep, (got_ep, sets) in zip(eps, grid):
        assert got_ep == ep and sets == engine.eval(ctx, ep)
    assert grid[0][1] != grid[1][1]  # int8 serving scores otherwise


def _eps(pkg, eng, variants):
    """EngineParams per (data source eval_k, [(algo name, rank)...])."""
    return [pkg(
        data_source_params=("", eng.DataSourceParams(app_name="A", eval_k=k)),
        algorithm_params_list=tuple(
            (name, eng.ALSAlgorithmParams(rank=r)) for name, r in algos))
        for k, algos in variants]


@pytest.mark.parametrize("variants,batchable", [
    ([(2, [("als", 4)]), (2, [("als", 6)])], True),
    ([(2, [("als", 4)])], False),  # one point
    ([(2, [("als", 4)]), (3, [("als", 6)])], False),  # data source differs
    ([(2, [("als", 4), ("als", 6)]), (2, [("als", 4), ("als", 8)])], False),
])
def test_grid_batchable_matches_jax(variants, batchable):
    teps = _eps(EngineParams, teng, variants)
    jeps = _eps(JEngineParams, jeng, variants)
    t = teng.RecommendationEngine().apply()._grid_batchable(
        RuntimeContext(device="cpu"), teps)
    j = jeng.RecommendationEngine().apply()._grid_batchable(JContext(), jeps)
    assert t == j == batchable


def test_unbatchable_grid_evaluates_point_by_point(monkeypatch):
    """Two algorithms a point: `batch_eval` calls `eval` per point, and
    `train_grid` never runs."""
    engine = teng.RecommendationEngine().apply()
    eps = _eps(EngineParams, teng, [(2, [("als", 4), ("als", 6)])] * 2)
    calls = []
    monkeypatch.setattr(type(engine), "eval", lambda self, ctx, ep, **kw: (
        calls.append(ep), [])[1])
    monkeypatch.setattr(teng.ALSAlgorithm, "train_grid",
                        lambda *a: pytest.fail("train_grid on an unbatchable grid"))
    out = engine.batch_eval(RuntimeContext(device="cpu"), eps)
    assert calls == eps and [ep for ep, _ in out] == eps
