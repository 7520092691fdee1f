"""Naive Bayes and logistic regression on the port (``models/classify.py``)
against the JAX package's, on the CPU, on the same seeded inputs.

- Naive Bayes: log prior and log likelihood within rtol 1e-5 (the JAX
  package's grid bar, tests/test_grid_eval.py:32-36); the λ grid against
  the JAX grid at that bar and equal to the port's per-point trains;
  negative features refused.
- Logistic regression, 200 full-batch steps (standardized) and 60 (raw):
  weights within rtol 1e-4, atol 1e-5·max|w| (test_grid_eval.py:51-53);
  the (lr, l2) grid the same against the JAX grid and the port's
  per-point trains; labels equal wherever the JAX model's top-two logit
  margin exceeds 1e-4.
- The standardization and its fold-back equal the JAX functions, and the
  folded weights on raw rows score as the raw weights on standardized
  rows.
- Predictions from carried JAX arrays (``convert``): scores within rtol
  1e-5, labels equal outside near-ties; equal scores take the first class
  in both packages.
- A train gives the same bits again; models pickle without a device and
  serve where they are bound.
"""

import pickle

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.models import classify as jc  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.models import classify as tc  # noqa: E402


def _synth(n=3000, d=24, c=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.rand(c, d).astype(np.float32) * 3
    y = rng.randint(0, c, n).astype(np.int32)
    x = np.abs(centers[y] + rng.rand(n, d).astype(np.float32))
    return x, y


def _lr_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _labels_agree(tm, jm, x):
    """Equal labels wherever the JAX scores' top-two margin > 1e-4."""
    s = jm.predict_scores(x)
    top2 = np.sort(s, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tm.predict(x)[clear], jm.predict(x)[clear])
    np.testing.assert_allclose(tm.predict_scores(x), s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lam", [0.5, 1.0, 3.0])
def test_naive_bayes_matches_jax(lam):
    x, y = _synth()
    got = tc.train_naive_bayes(x, y, 4, lam, device="cpu")
    want = jc.train_naive_bayes(x, y, 4, lam)
    np.testing.assert_allclose(got.log_prior, want.log_prior, rtol=1e-5)
    np.testing.assert_allclose(got.log_likelihood, want.log_likelihood, rtol=1e-5)
    _labels_agree(got, want, x[:500])
    again = tc.train_naive_bayes(x, y, 4, lam, device="cpu")
    np.testing.assert_array_equal(again.log_likelihood, got.log_likelihood)


def test_naive_bayes_grid_matches_jax_and_per_point_trains():
    x, y = _synth(seed=1)
    lams = [0.1, 0.5, 1.0, 2.0]
    grid = tc.train_naive_bayes_grid(x, y, 4, lams, device="cpu")
    jgrid = jc.train_naive_bayes_grid(x, y, 4, lams)
    for lam, m, jm in zip(lams, grid, jgrid):
        np.testing.assert_allclose(m.log_prior, jm.log_prior, rtol=1e-5)
        np.testing.assert_allclose(m.log_likelihood, jm.log_likelihood, rtol=1e-5)
        ref = tc.train_naive_bayes(x, y, 4, lam, device="cpu")
        np.testing.assert_allclose(m.log_likelihood, ref.log_likelihood, rtol=1e-6)
        np.testing.assert_array_equal(m.log_prior, ref.log_prior)


def test_naive_bayes_refuses_negative_features():
    x, y = _synth(n=50)
    x[3, 2] = -1.0
    with pytest.raises(ValueError, match="non-negative"):
        tc.train_naive_bayes(x, y, 4, device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        tc.train_naive_bayes_grid(x, y, 4, [1.0], device="cpu")


@pytest.mark.parametrize("normalize,iterations", [(True, 200), (False, 60)])
def test_logistic_regression_matches_jax(normalize, iterations):
    x, y = _synth(n=800, d=10)
    if not normalize:
        x = x / x.max()
    got = tc.train_logistic_regression(x, y, 4, iterations=iterations, normalize=normalize,
                                       device="cpu")
    want = jc.train_logistic_regression(x, y, 4, iterations=iterations, normalize=normalize)
    _lr_close(got.weights, want.weights)
    _labels_agree(got, want, x)
    again = tc.train_logistic_regression(x, y, 4, iterations=iterations, normalize=normalize,
                                         device="cpu")
    np.testing.assert_array_equal(again.weights, got.weights)


def test_logistic_regression_grid_matches_jax_and_per_point_trains():
    x, y = _synth(n=800, d=10, seed=2)
    pts = [(0.3, 1e-4), (0.5, 1e-3), (0.8, 1e-2)]
    grid = tc.train_logistic_regression_grid(x, y, 4, pts, iterations=60, device="cpu")
    jgrid = jc.train_logistic_regression_grid(x, y, 4, pts, iterations=60)
    for (lr, l2), m, jm in zip(pts, grid, jgrid):
        _lr_close(m.weights, jm.weights)
        ref = tc.train_logistic_regression(x, y, 4, iterations=60, lr=lr, l2=l2, device="cpu")
        _lr_close(m.weights, ref.weights)


def test_standardization_and_fold_back():
    x, _ = _synth(n=300, d=6, seed=3)
    x[:, 2] = 1.5  # a constant column: std 1
    got, want = tc._standardize(x), jc._standardize(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    xs, mu, std = got
    w = np.random.default_rng(4).standard_normal((7, 3)).astype(np.float32)
    folded = tc._fold_back_standardization(w, mu, std)
    np.testing.assert_array_equal(folded, jc._fold_back_standardization(w, mu, std))
    np.testing.assert_allclose(x @ folded[:-1] + folded[-1], xs @ w[:-1] + w[-1],
                               rtol=1e-5, atol=1e-4)


def test_carried_models_predict_as_jax():
    x, y = _synth(seed=5)
    jnb = jc.train_naive_bayes(x, y, 4)
    _labels_agree(convert.nb_model_from_numpy(jnb.log_prior, jnb.log_likelihood,
                                              device="cpu"), jnb, x[:400])
    jlr = jc.train_logistic_regression(x[:800], y[:800], 4, iterations=100)
    _labels_agree(convert.lr_model_from_numpy(jlr.weights, device="cpu"), jlr, x[:400])
    with pytest.raises(ValueError):
        convert.nb_model_from_numpy(jnb.log_prior[:2], jnb.log_likelihood, device="cpu")
    with pytest.raises(ValueError):
        convert.lr_model_from_numpy(jlr.weights[0], device="cpu")


def test_equal_scores_take_the_first_class():
    log_prior = np.log(np.array([0.2, 0.4, 0.4], np.float32))
    log_like = np.log(np.array([[0.5, 0.5], [0.3, 0.7], [0.3, 0.7]], np.float32))
    x = np.array([[1.0, 2.0], [0.0, 0.0], [3.0, 1.0]], np.float32)
    tm = convert.nb_model_from_numpy(log_prior, log_like, device="cpu")
    jm = jc.NaiveBayesModel(log_prior, log_like)
    np.testing.assert_array_equal(tm.predict(x), jm.predict(x))
    assert tm.predict(x)[1] == 1  # classes 1 and 2 tie everywhere
    w = np.zeros((3, 4), np.float32)  # all logits 0: class 0
    assert convert.lr_model_from_numpy(w, device="cpu").predict(x).tolist() == [0, 0, 0]
    assert jc.LogisticRegressionModel(w).predict(x).tolist() == [0, 0, 0]


def test_models_pickle_without_a_device():
    x, y = _synth(n=200, seed=6)
    for m in (tc.train_naive_bayes(x, y, 4, device="cpu"),
              tc.train_logistic_regression(x, y, 4, iterations=20, device="cpu")):
        want = m.predict_scores(x[:20])
        back = pickle.loads(pickle.dumps(m))
        assert back.device is None and back._staged is None
        with pytest.raises(RuntimeError, match="bind_device"):
            back.predict(x[:2])
        back.bind_device("cpu")
        np.testing.assert_array_equal(back.predict_scores(x[:20]), want)
