"""The port's ``e2`` library against the JAX package's: the same seeded
inputs through both, results equal exactly (both are the same host code
over the same numpy and Python arithmetic).

- ``split_data``: the folds of seeded lists, k = 1-7, and the bad k.
- ``BinaryVectorizer``: the index and the matrix of seeded property maps,
  properties restricted, unseen values ignored.
- ``CategoricalNaiveBayes``: priors, likelihoods, log scores (default
  likelihood or not, unknown labels) and predictions on seeded points.
- ``MarkovChain``: the pruned, row-normalized transition matrix of seeded
  COO counts at several top-N, and its predictions.
- The package exports the JAX package's names.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import predictionio_tpu.e2 as je2  # noqa: E402
import predictionio_tpu_torch.e2 as te2  # noqa: E402


def test_exports_match():
    assert te2.__all__ == je2.__all__
    for name in te2.__all__:
        assert getattr(te2, name).__module__.startswith("predictionio_tpu_torch.e2")


@pytest.mark.parametrize("k", range(1, 8))
def test_split_data_matches(k):
    data = list(np.random.default_rng(k).integers(0, 1000, 23))
    assert te2.split_data(k, data) == je2.split_data(k, data)


def test_split_data_refuses_bad_k():
    for mod in (te2, je2):
        with pytest.raises(ValueError):
            mod.split_data(0, [1])


def _maps(seed, n=40):
    rng = np.random.default_rng(seed)
    return [{p: str(rng.integers(0, 4)) for p in ("color", "size", "shape", "extra")
             if rng.random() < 0.8} for _ in range(n)]


@pytest.mark.parametrize("props", [["color", "size"], ["color", "size", "shape", "extra"]])
def test_vectorizer_matches(props):
    maps = _maps(3)
    tv, jv = te2.BinaryVectorizer.fit(maps, props), je2.BinaryVectorizer.fit(maps, props)
    assert tv.index == jv.index and tv.num_features == jv.num_features
    probe = _maps(4) + [{"color": "9", "weight": "1"}]
    np.testing.assert_array_equal(tv.to_matrix(probe), jv.to_matrix(probe))
    assert tv.to_matrix(probe).dtype == np.float32


def _points(mod, seed, n=60, positions=3):
    rng = np.random.default_rng(seed)
    return [mod.LabeledPoint(str(rng.choice(["yes", "no", "maybe"])),
                             tuple(str(rng.integers(0, 3)) for _ in range(positions)))
            for _ in range(n)]


def test_categorical_naive_bayes_matches():
    tm = te2.CategoricalNaiveBayes.train(_points(te2, 5))
    jm = je2.CategoricalNaiveBayes.train(_points(je2, 5))
    assert tm.priors == jm.priors
    assert tm.likelihoods == jm.likelihoods
    rng = np.random.default_rng(6)
    for _ in range(30):
        feats = tuple(str(rng.integers(0, 4)) for _ in range(3))  # "3" is unseen
        assert tm.predict(feats) == jm.predict(feats)
        for label in ("yes", "no", "maybe", "never"):
            for default in (None, lambda ls: min(ls) - 1.0):
                kw = {} if default is None else {"default_likelihood": default}
                assert (tm.log_score(te2.LabeledPoint(label, feats), **kw)
                        == jm.log_score(je2.LabeledPoint(label, feats), **kw))


def test_categorical_naive_bayes_refuses_bad_input():
    for mod in (te2, je2):
        with pytest.raises(ValueError):
            mod.CategoricalNaiveBayes.train([])
        with pytest.raises(ValueError):
            mod.CategoricalNaiveBayes.train([mod.LabeledPoint("a", ("x",)),
                                             mod.LabeledPoint("b", ("x", "y"))])


@pytest.mark.parametrize("top_n", [1, 2, 5, 8])
def test_markov_chain_matches(top_n):
    rng = np.random.default_rng(top_n)
    rows, cols = rng.integers(0, 8, 50), rng.integers(0, 8, 50)
    counts = rng.integers(1, 6, 50)
    tm = te2.MarkovChain.train(rows, cols, counts, n_states=8, top_n=top_n)
    jm = je2.MarkovChain.train(rows, cols, counts, n_states=8, top_n=top_n)
    np.testing.assert_array_equal(tm.transition, jm.transition)
    assert tm.transition.dtype == np.float32 and tm.top_n == top_n
    probs = rng.random(8).astype(np.float32)
    np.testing.assert_array_equal(tm.predict(probs), jm.predict(probs))
