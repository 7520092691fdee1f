"""The host ranking helpers (``models/ranking.py``) against the JAX
package's, index for index: seeded score vectors with many equal
scores (integer-valued and a few distinct values), NEG_INF entries, and
every filter combination. Equal scores must come out in the same order,
since both call the same numpy functions."""

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.models import ranking as jrank  # noqa: E402
from predictionio_tpu.ops.topk import NEG_INF as JNEG_INF  # noqa: E402
from predictionio_tpu_torch.models import ranking as trank  # noqa: E402
from predictionio_tpu_torch.ops.topk import NEG_INF  # noqa: E402


def _scores(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        s = rng.integers(-3, 4, n).astype(np.float32)
    elif kind == "few":
        s = rng.choice(np.array([0.5, 0.25, -1.0], np.float32), n)
    else:
        s = rng.standard_normal(n).astype(np.float32)
    s[rng.random(n) < 0.15] = NEG_INF
    return s


def test_neg_inf_is_the_jax_packages():
    assert NEG_INF == JNEG_INF


def test_l2_normalize_matches_jax():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((50, 7)).astype(np.float32)
    f[3] = 0.0
    np.testing.assert_array_equal(trank.l2_normalize(f), jrank.l2_normalize(f))


@pytest.mark.parametrize("kind", ["ties", "few", "normal"])
@pytest.mark.parametrize("seed", range(4))
def test_top_k_indices_matches_jax(seed, kind):
    for n in (1, 7, 64, 513):
        s = _scores(seed, n, kind)
        for k in (0, 1, 3, 10, n, n + 5):
            got, want = trank.top_k_indices(s, k), jrank.top_k_indices(s, k)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
            assert (s[got] > NEG_INF / 2).all()


def test_exclusion_scores_matches_jax():
    s = _scores(1, 40, "normal")
    ex = np.random.default_rng(2).random(40) < 0.3
    np.testing.assert_array_equal(trank.exclusion_scores(s, ex), jrank.exclusion_scores(s, ex))


@pytest.mark.parametrize("kind", ["ties", "few", "normal"])
@pytest.mark.parametrize("seed", range(4))
def test_top_k_filtered_matches_jax(seed, kind):
    rng = np.random.default_rng(100 + seed)
    for n in (5, 64, 700):
        s = _scores(seed, n, kind)
        for k in (0, 1, 4, 20, n + 3):
            for ex in (None, [], list(rng.integers(0, n, 3)), list(rng.integers(0, n, n // 2))):
                for inc in (None, [], list(rng.integers(0, n, max(1, n // 4)))):
                    for pos in (False, True):
                        got = trank.top_k_filtered(s, k, exclude_idx=ex, include_idx=inc,
                                                   positive_only=pos)
                        want = jrank.top_k_filtered(s, k, exclude_idx=ex, include_idx=inc,
                                                    positive_only=pos)
                        np.testing.assert_array_equal(got, want)
                        assert got.dtype == want.dtype
                        if ex:
                            assert not set(got.tolist()) & set(ex)
                        if inc is not None:
                            assert set(got.tolist()) <= set(inc)


def test_top_k_filtered_empty_scores():
    for mod in (trank, jrank):
        assert mod.top_k_filtered(np.zeros(0, np.float32), 5).shape == (0,)
