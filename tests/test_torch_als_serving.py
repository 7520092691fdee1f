"""Port parity for ALS serving: the factor blob carried across from the
JAX package, staged serving state, and the three serving verbs.

Factors are multiples of 1/8, so f32 and bf16 scores are exact in any
summation order and int8 scores are exact int32 sums: staged arrays,
indices and values must be equal. The one exception is
`similar_vectors_serving`, whose query norm is a square root computed
by each framework — values there are held to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from predictionio_tpu.data.store.bimap import BiMap as JBiMap  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402

U, I, K = 40, 300, 10


def _arrays(seed=0, dyadic=True):
    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((U, K)).astype(np.float32)
    itf = rng.standard_normal((I, K)).astype(np.float32)
    if dyadic:
        uf = (np.round(uf * 8) / 8).astype(np.float32)
        itf = (np.round(itf * 8) / 8).astype(np.float32)
    return uf, itf


def _jax_factors(seed=0, dyadic=True):
    uf, itf = _arrays(seed, dyadic)
    return jals.ALSFactors(
        user_factors=uf,
        item_factors=itf,
        user_vocab=JBiMap({f"u{n}": n for n in range(U)}),
        item_vocab=JBiMap({f"i{n}": n for n in range(I)}),
        params=jals.ALSParams(rank=K, iterations=7, lambda_=0.05),
    )


def _port_factors(seed=0, dyadic=True):
    return convert.load_jax_als_blob(_jax_factors(seed, dyadic).to_bytes())


# ---------------------------------------------------------------------------
# carrying factors across
# ---------------------------------------------------------------------------


def test_jax_blob_loads_identically():
    jf = _jax_factors(1)
    pf = convert.load_jax_als_blob(jf.to_bytes())
    assert np.array_equal(pf.user_factors, jf.user_factors)
    assert pf.user_factors.dtype == jf.user_factors.dtype
    assert np.array_equal(pf.item_factors, jf.item_factors)
    assert pf.user_vocab.to_dict() == jf.user_vocab.to_dict()
    assert pf.item_vocab.to_dict() == jf.item_vocab.to_dict()
    assert pf.params.__dict__ == jf.params.__dict__


def test_port_blob_loads_in_jax_package():
    pf = _port_factors(2)
    jf = jals.ALSFactors.from_bytes(pf.to_bytes())
    assert np.array_equal(pf.item_factors, jf.item_factors)
    assert jf.user_vocab.to_dict() == pf.user_vocab.to_dict()
    assert jf.params == jals.ALSParams(**pf.params.__dict__)


def test_factors_from_numpy():
    uf, itf = _arrays(3)
    pf = convert.als_factors_from_numpy(
        uf, itf, [f"u{n}" for n in range(U)], [f"i{n}" for n in range(I)],
        {"rank": K, "lambda_": 0.05},
    )
    assert pf.user_vocab("u7") == 7 and pf.item_vocab.inverse()(299) == "i299"
    assert pf.params.rank == K and pf.params.lambda_ == 0.05
    with pytest.raises(ValueError, match="unknown ALS params"):
        convert.als_factors_from_numpy(uf, itf, range(U), range(I), {"bogus": 1})
    with pytest.raises(ValueError, match="one id per factor row"):
        convert.als_factors_from_numpy(uf, itf, range(U - 1), range(I), {})


# ---------------------------------------------------------------------------
# staged serving state
# ---------------------------------------------------------------------------


def _np(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t.astype("float32") if str(t.dtype) == "bfloat16" else t)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_stage_serving_matches_jax(dtype):
    sv = tals.stage_serving(_port_factors(4), serve_dtype=dtype, device="cpu")
    jsv = jals.stage_serving(_jax_factors(4), serve_dtype=dtype)
    assert sv.dtype == jsv.dtype and sv.n_items == jsv.n_items
    assert sv.device == torch.device("cpu")
    for name in ("users", "items", "user_scale", "item_scale", "item_inv_norm"):
        ours, ref = _np(getattr(sv, name)), _np(getattr(jsv, name))
        if ref is None:
            assert ours is None, name
            continue
        assert ours.shape == ref.shape, name
        assert np.array_equal(ours, ref), name
    assert sv.device_nbytes() == jsv.device_nbytes()


def test_stage_item_serving_and_bad_dtype():
    _, itf = _arrays(5)
    sv = tals.stage_item_serving(itf, device="cpu")
    assert sv.n_users == 0 and sv.n_items == I and sv.items.shape == (384, K)
    with pytest.raises(ValueError, match="serve_dtype"):
        tals.stage_serving(_port_factors(5), serve_dtype="fp8", device="cpu")


# ---------------------------------------------------------------------------
# the three serving verbs
# ---------------------------------------------------------------------------


def _rows_and_mask(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((6, I)) < 0.3
    rows = np.full((6, 8), -1, np.int32)
    rows[:, :4] = rng.integers(0, I, (6, 4))
    return mask, rows


@pytest.mark.parametrize("excl", [None, "mask", "rows"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_recommend_serving_matches_jax(dtype, excl):
    sv = tals.stage_serving(_port_factors(6), serve_dtype=dtype, device="cpu")
    jsv = jals.stage_serving(_jax_factors(6), serve_dtype=dtype)
    mask, rows = _rows_and_mask(7)
    kw = {"mask": {"exclude_mask": mask}, "rows": {"exclude_rows": rows},
          None: {}}[excl]
    users = np.array([0, 3, 39, 3, 17, 8])
    for k in (5, 128, 400):
        v, i = tals.recommend_serving(sv, users, k, **kw)
        jv, ji = jals.recommend_serving(jsv, users, k, **kw)
        assert np.array_equal(i, ji)
        assert np.array_equal(v, jv)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_similar_serving_matches_jax(dtype):
    sv = tals.stage_serving(_port_factors(8), serve_dtype=dtype, device="cpu")
    jsv = jals.stage_serving(_jax_factors(8), serve_dtype=dtype)
    mask, rows = _rows_and_mask(9)
    items = np.array([0, 5, 299, 5, 130, 77])
    for kw in ({}, {"exclude_mask": mask}, {"exclude_rows": rows},
               {"exclude_self": False}):
        v, i = tals.similar_serving(sv, items, 11, **kw)
        jv, ji = jals.similar_serving(jsv, items, 11, **kw)
        assert np.array_equal(i, ji)
        assert np.array_equal(v, jv)
    v, i = tals.similar_serving(sv, items, 11)
    for r, it in enumerate(items):  # exclude_self holds
        assert it not in i[r]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_similar_vectors_serving_matches_jax(dtype):
    sv = tals.stage_serving(_port_factors(10), serve_dtype=dtype, device="cpu")
    jsv = jals.stage_serving(_jax_factors(10), serve_dtype=dtype)
    rng = np.random.default_rng(11)
    vecs = (np.round(rng.standard_normal((5, K)) * 8) / 8).astype(np.float32)
    _, rows = _rows_and_mask(12)
    for kw in ({}, {"exclude_rows": rows[:5]}):
        v, i = tals.similar_vectors_serving(sv, vecs, 9, **kw)
        jv, ji = jals.similar_vectors_serving(jsv, vecs, 9, **kw)
        assert np.array_equal(i, ji)
        np.testing.assert_allclose(v, jv, rtol=1e-5)


def test_empty_verbs():
    sv = tals.stage_serving(_port_factors(13), device="cpu")
    v, i = tals.recommend_serving(sv, np.array([1, 2]), 0)
    assert v.shape == (2, 0) and i.dtype == np.int64
    item_only = tals.stage_item_serving(np.zeros((0, K), np.float32), device="cpu")
    v, i = tals.similar_serving(item_only, np.array([0]), 5)
    assert v.shape == (1, 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_scores_do_not_depend_on_batch(dtype):
    """B=1 and B=8 give identical bits for the same query (random f32
    factors: the per-element fixed-order chain, not a batched GEMM)."""
    sv = tals.stage_serving(
        _port_factors(14, dyadic=False), serve_dtype=dtype, device="cpu"
    )
    users = np.arange(8) * 5
    v8, i8 = tals.recommend_serving(sv, users, 50)
    for r, u in enumerate(users):
        v1, i1 = tals.recommend_serving(sv, np.array([u]), 50)
        assert np.array_equal(v1[0], v8[r]) and np.array_equal(i1[0], i8[r])
