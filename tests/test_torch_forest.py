"""The random forest on the port (``models/forest.py``) against the JAX
package's, on the CPU.

The two packages cannot share a seed (threefry against a
``torch.Generator``), so the JAX package's draws are made here with
``jax.random`` on its key schedule (``split(PRNGKey(seed), T)``, then
``poisson(fold_in(key, 0))`` and ``uniform(fold_in(key, level + 1))``)
and fed to the port's grower, which must give the JAX
``_train_forest_jit`` trees: ``features``, ``routes_f`` and ``routes_t``
equal, ``leaf_proba`` within 1e-6. Also:

- ties: duplicated feature columns (equal gains: the first feature wins)
  and a min_child_weight no split meets (every gain -inf: index 0, a
  leaf), both equal to the JAX package's trees;
- binning equal to the JAX functions;
- prediction from a carried JAX forest: probabilities within 1e-6, labels
  equal;
- the port's own seeded train holds tests/test_forest.py's properties:
  normalized probabilities, the same trees for the same seed, the
  pure-node early stop, accuracy > 0.9 on the multimodal fixture;
- the model pickles without a device and serves where it is bound.
"""

import pickle

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.models import forest as jf  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.models import forest as tf  # noqa: E402


@pytest.fixture(scope="module")
def multimodal():
    """tests/test_forest.py's fixture: 3 blobs per class."""
    rng = np.random.RandomState(0)
    n_per, c, d = 300, 4, 8
    cents = rng.randn(c, 3, d) * 3
    xs, ys = [], []
    for k in range(c):
        for b in range(3):
            xs.append(cents[k, b] + rng.randn(n_per // 3, d))
            ys.append(np.full(n_per // 3, k))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    ntr = int(0.8 * len(x))
    return x[:ntr], y[:ntr], x[ntr:], y[ntr:], c


def _jax_draws(seed, n_trees, n, d, depth, k):
    """The JAX package's per-tree draws (models/forest.py:151-163, :77)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_trees)
    boot = np.stack([np.asarray(jax.random.poisson(jax.random.fold_in(key, 0), 1.0, (n,)))
                     for key in keys]).astype(np.float32)
    uniforms = [None if k >= d else torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(jax.random.fold_in(key, level + 1), (2 ** level, d)))
        for key in keys])) for level in range(depth)]
    return torch.from_numpy(boot), uniforms


def _grown_against_jax(x, y, n_classes, *, n_trees, depth, n_bins, k, mcw, seed):
    edges = jf.make_bin_edges(x, n_bins)
    xbin = jf.binize(x, edges)
    y1h = np.eye(n_classes, dtype=np.float32)[y]
    want = jf._train_forest_jit(
        jnp.asarray(xbin), jnp.asarray(y1h), jnp.ones(len(x), jnp.float32),
        n_trees=n_trees, depth=depth, n_bins=n_bins, feat_per_node=k,
        min_child_weight=mcw, seed=seed)
    boot, uniforms = _jax_draws(seed, n_trees, len(x), x.shape[1], depth, k)
    got = tf.grow_forest(torch.from_numpy(xbin.astype(np.int64)),
                         torch.from_numpy(y.astype(np.int64)), boot, uniforms,
                         n_classes=n_classes, n_bins=n_bins, feat_per_node=k,
                         min_child_weight=mcw)
    for name, g, w in zip(("features", "routes_f", "routes_t"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert g.dtype == torch.int32
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1e-6)
    return got, edges


@pytest.mark.parametrize("n_trees,depth,n_bins,fraction,mcw,seed", [
    (5, 4, 16, None, 1.0, 3),
    (3, 3, 32, 1.0, 5.0, 11),  # every feature at every node: no uniforms
])
def test_grower_fed_jax_draws_grows_jax_trees(multimodal, n_trees, depth, n_bins, fraction,
                                              mcw, seed):
    x, y, xte, _, c = multimodal
    k = tf.feat_per_node_of(x.shape[1], fraction)
    got, edges = _grown_against_jax(x, y, c, n_trees=n_trees, depth=depth, n_bins=n_bins,
                                    k=k, mcw=mcw, seed=seed)
    assert (got[0] >= 0).any()  # the trees did split
    # the grown trees, carried across, predict as the JAX model does
    arrays = [g.numpy() for g in got]
    jm = jf.RandomForestModel(edges, *arrays, depth=depth)
    tm = convert.rf_model_from_numpy(edges, *arrays, depth, device="cpu")
    np.testing.assert_allclose(tm.predict_proba(xte), jm.predict_proba(xte), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tm.predict(xte), jm.predict(xte))
    with pytest.raises(ValueError):
        convert.rf_model_from_numpy(edges, *arrays, depth + 1, device="cpu")


def test_equal_gains_take_the_first_feature():
    """Columns 0 and 1 are the same feature: every split on either gains
    the same, and both packages take feature 0 (the first maximal
    index)."""
    rng = np.random.RandomState(7)
    a = rng.rand(200).astype(np.float32)
    x = np.stack([a, a, rng.rand(200).astype(np.float32)], axis=1)
    y = (a > 0.5).astype(np.int32)
    got, _ = _grown_against_jax(x, y, 2, n_trees=2, depth=2, n_bins=8, k=3, mcw=1.0, seed=2)
    roots = got[0][:, 0, 0]
    assert (roots == 0).all()


@pytest.mark.parametrize("mcw", [1.0, 4.0, 1e6])
def test_best_splits_match_jax(mcw):
    """One level's split choice on the same integer histograms: features
    0 and 2 equal (equal gains, the first wins), a node whose mask keeps
    no feature and, at min_child_weight 1e6, no valid split anywhere
    (every gain -inf: index 0, a leaf)."""
    rng = np.random.default_rng(9)
    d, nodes, bins, c = 4, 4, 8, 3
    hist = rng.poisson(2.0, (d, nodes, bins, c)).astype(np.float32)
    hist[:, :, :, :] = hist.sum(0, keepdims=True) // d  # one node total for every feature
    hist[2] = hist[0]
    hist[1, 1] = np.roll(hist[1, 1], 3, axis=0)
    mask = rng.random((nodes, d)) < 0.7
    mask[:, 0] = mask[:, 2] = True
    mask[3] = False
    want = jf._best_splits(jnp.asarray(hist), jnp.asarray(mask), mcw, bins)
    got = tf._best_splits(torch.from_numpy(hist)[None], torch.from_numpy(mask)[None], mcw, bins)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    feature = got[0][0]
    assert feature[3] == -1 and (feature != 2).all()
    if mcw == 1e6:
        assert (feature == -1).all() and (got[1] == 0).all() and (got[2] == bins).all()


def test_binning_matches_jax(multimodal):
    x = multimodal[0]
    edges = tf.make_bin_edges(x, 32)
    np.testing.assert_array_equal(edges, jf.make_bin_edges(x, 32))
    np.testing.assert_array_equal(tf.binize(x, edges), jf.binize(x, edges))


def test_seeded_train_beats_accuracy_bar(multimodal):
    xtr, ytr, xte, yte, c = multimodal
    rf = tf.train_random_forest(xtr, ytr, c, n_trees=20, max_depth=6, device="cpu")
    assert (rf.predict(xte) == yte).mean() > 0.9


def test_seeded_train_properties(multimodal):
    xtr, ytr, xte, _, c = multimodal
    a = tf.train_random_forest(xtr, ytr, c, n_trees=4, max_depth=4, seed=7, device="cpu")
    b = tf.train_random_forest(xtr, ytr, c, n_trees=4, max_depth=4, seed=7, device="cpu")
    other = tf.train_random_forest(xtr, ytr, c, n_trees=4, max_depth=4, seed=8, device="cpu")
    np.testing.assert_array_equal(a.routes_f, b.routes_f)
    np.testing.assert_array_equal(a.routes_t, b.routes_t)
    np.testing.assert_array_equal(a.leaf_proba, b.leaf_proba)
    assert not np.array_equal(a.leaf_proba, other.leaf_proba)
    p = a.predict_proba(xte)
    assert p.shape == (len(xte), c) and (p >= 0).all()
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-5)


def test_pure_nodes_stop_early():
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.rand(50, 1), rng.rand(50, 1) + 5.0]).astype(np.float32)
    y = np.concatenate([np.zeros(50), np.ones(50)]).astype(np.int32)
    rf = tf.train_random_forest(x, y, 2, n_trees=3, max_depth=4, device="cpu")
    assert (rf.predict(x) == y).all()
    assert (rf.features[:, 2:, :] == -1).all()


def test_model_pickles_without_a_device(multimodal):
    xtr, ytr, xte, _, c = multimodal
    m = tf.train_random_forest(xtr, ytr, c, n_trees=3, max_depth=3, device="cpu")
    back = pickle.loads(pickle.dumps(m))
    assert back.device is None
    with pytest.raises(RuntimeError, match="bind_device"):
        back.predict(xte)
    back.bind_device("cpu")
    np.testing.assert_array_equal(back.predict_proba(xte), m.predict_proba(xte))
