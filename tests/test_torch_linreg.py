"""Ridge regression on the port (``models/linreg.py``) against the JAX
package's, on the CPU, on the same seeded inputs.

- The weighted sufficient statistics (XᵀWX, XᵀWy, Σw, Σw·x, Σw·y) against
  the JAX ``_normal_eq_terms`` within rtol 1e-5.
- Trains at several l2, with and without the intercept: weights within
  rtol 1e-4 and the intercept within rtol 1e-3 (the JAX package's grid
  bars, tests/test_grid_eval.py:63-64).
- The l2 grid from one pass: against the JAX grid at the same bars, and
  bit-equal to the port's per-point trains.
- Where a mean is large against its spread (features ~ 50 ± 10, a target
  in years), the port stays within rtol 1e-5 of a float64 ridge; the JAX
  package's centring of unshifted f32 sums is 10x or more farther.
- Prediction is the JAX package's host numpy: equal bits on carried
  weights (``convert.linreg_model_from_numpy``). The model pickles (no
  device).
"""

import pickle

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from predictionio_tpu.models import linreg as jl  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.models import linreg as tl  # noqa: E402


def _data(n=500, d=8, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32)
    y = (x @ rng.rand(d).astype(np.float32) + 0.3 + 0.05 * rng.randn(n)).astype(np.float32)
    return x, y


def test_weighted_statistics_match_jax():
    x, y = _data()
    w = np.random.default_rng(2).integers(0, 4, len(x)).astype(np.float32)
    got = tl._normal_eq_terms(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w))
    want = [np.asarray(v, np.float64) for v in jl._normal_eq_terms(x, y, w)]
    for name, g, v in zip(("xtx", "xty", "n", "xsum", "ysum"), got, want):
        np.testing.assert_allclose(g, v, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("l2", [1e-6, 1e-3, 1e-1])
def test_train_matches_jax(l2, fit_intercept):
    x, y = _data()
    got = tl.train_linear_regression(x, y, l2=l2, fit_intercept=fit_intercept, device="cpu")
    want = jl.train_linear_regression(x, y, l2=l2, fit_intercept=fit_intercept)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-4)
    assert got.weights.dtype == np.float32
    assert got.intercept == pytest.approx(want.intercept, rel=1e-3)
    if not fit_intercept:
        assert got.intercept == 0.0


def test_grid_matches_jax_and_per_point_trains():
    x, y = _data(n=700, d=12, seed=3)
    l2s = [1e-6, 1e-3, 1e-1]
    grid = tl.train_linear_regression_grid(x, y, l2s, device="cpu")
    jgrid = jl.train_linear_regression_grid(x, y, l2s)
    for l2, m, jm in zip(l2s, grid, jgrid):
        np.testing.assert_allclose(m.weights, jm.weights, rtol=1e-4)
        assert m.intercept == pytest.approx(jm.intercept, rel=1e-3)
        ref = tl.train_linear_regression(x, y, l2=l2, device="cpu")
        np.testing.assert_array_equal(m.weights, ref.weights)
        assert m.intercept == ref.intercept


def test_large_means_stay_close_to_float64():
    """The hazard the shifted products answer: the JAX package's float64
    centring of unshifted f32 sums loses digits at large means."""
    rng = np.random.default_rng(4)
    x = (50 + 10 * rng.standard_normal((20_000, 10))).astype(np.float32)
    y = (1990 + 0.3 * (x - 50) @ rng.standard_normal(10) + rng.standard_normal(20_000)
         ).astype(np.float32)
    xd = np.c_[x.astype(np.float64), np.ones(len(x))]
    ref = np.linalg.lstsq(xd, y.astype(np.float64), rcond=None)[0][:-1]
    got = tl.train_linear_regression(x, y, l2=0.0, device="cpu").weights
    jax_w = jl.train_linear_regression(x, y, l2=0.0).weights
    err, jax_err = (np.abs(w - ref).max() / np.abs(ref).max() for w in (got, jax_w))
    assert err < 1e-5, err
    assert jax_err > 10 * err, (jax_err, err)


def test_predict_matches_jax_and_pickles():
    x, y = _data()
    jm = jl.train_linear_regression(x, y)
    tm = convert.linreg_model_from_numpy(jm.weights, jm.intercept)
    q = np.random.default_rng(5).random((17, x.shape[1])).astype(np.float32)
    np.testing.assert_array_equal(tm.predict(q), jm.predict(q))
    np.testing.assert_array_equal(tm.predict(q[0]), jm.predict(q[0]))
    back = pickle.loads(pickle.dumps(tm))
    np.testing.assert_array_equal(back.predict(q), tm.predict(q))
    with pytest.raises(ValueError):
        convert.linreg_model_from_numpy(np.zeros((2, 2)), 0.0)
