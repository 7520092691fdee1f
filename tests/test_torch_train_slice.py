"""The port's train → deploy loop on the CPU, against the JAX package.

A small ``user::item::rating`` file trains through ``console train
--device cpu`` (the dense-W path, forced on with PIO_DENSE_ALS=1 at this
size, or without it the windowed path) into an npz factor blob; ``console deploy --device cpu`` serves
it and answers ``POST /queries.json``. The blob loads in the JAX
package with equal arrays and vocabularies, and the served top-k equals
the JAX package's ``recommend`` on the same factors: item ids equal,
scores within rtol 1e-5 (f32 dot products summed in another order).
"""

import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402
from predictionio_tpu_torch.tools import console  # noqa: E402

NU, NI, RANK, ITERS = 120, 80, 6, 4


def _ratings_file(path: Path, seed=0, explicit=False):
    rng = np.random.default_rng(seed)
    cells = rng.choice(NU * NI, 1500, replace=False)
    lines = []
    for c in cells:
        u, i = divmod(int(c), NI)
        r = float(rng.integers(1, 11)) / 2.0
        lines.append(f"user{u}::item{i}::{r}")
    path.write_text("\n".join(lines) + "\n\n")
    return lines


def _train(tmp_path, monkeypatch, *extra):
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    ratings = tmp_path / "ratings.dat"
    lines = _ratings_file(ratings)
    blob = tmp_path / "factors.npz"
    rc = console.main(["train", "--ratings", str(ratings), "--out", str(blob),
                       "--rank", str(RANK), "--iterations", str(ITERS),
                       "--device", "cpu", *extra])
    assert rc == 0 and blob.exists()
    return lines, blob


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_console_train_then_deploy_matches_jax_recommend(tmp_path, monkeypatch):
    lines, blob = _train(tmp_path, monkeypatch)
    jf = jals.ALSFactors.from_bytes(blob.read_bytes())
    users = list(dict.fromkeys(ln.split("::")[0] for ln in lines))
    assert jf.user_factors.shape == (len(users), RANK)
    assert np.all(np.isfinite(jf.user_factors))
    assert jf.params.iterations == ITERS and jf.params.implicit_prefs

    args = console._parser().parse_args(
        ["deploy", "--model", str(blob), "--ip", "127.0.0.1", "--port", "0",
         "--device", "cpu"])
    server = console.build_server(args)
    port = server.start()
    try:
        user = users[3]
        status, body = _post(port, {"user": user, "num": 7})
    finally:
        server.stop()
    assert status == 200
    row = jf.user_vocab(user)
    scores, idx = jals.recommend(jf, np.array([row]), 7)
    inv = jf.item_vocab.inverse()
    assert [s["item"] for s in body["item_scores"]] == [inv(int(i)) for i in idx[0]]
    np.testing.assert_allclose([s["score"] for s in body["item_scores"]],
                               scores[0], rtol=1e-5)


def test_console_train_repeated_lines_takes_the_windowed_path(tmp_path,
                                                              monkeypatch):
    """Without PIO_DENSE_ALS a small file with repeated user::item lines
    takes the windowed path, as the JAX gate would (under 1 M ratings,
    and the repeats must sum). The blob's factors equal the JAX
    package's train on the same file from the port's seeded start
    (rtol = atol = 1e-4, tests/test_torch_als_windowed.py), and the
    deployed server answers as the JAX package's recommend on them."""
    import torch

    from predictionio_tpu_torch.models import als as tals

    monkeypatch.delenv("PIO_DENSE_ALS", raising=False)
    ratings = tmp_path / "ratings.dat"
    lines = _ratings_file(ratings, seed=2)
    lines = lines + lines[::7]  # every seventh pair rated again
    ratings.write_text("\n".join(lines) + "\n")
    blob = tmp_path / "factors.npz"
    rc = console.main(["train", "--ratings", str(ratings), "--out", str(blob),
                       "--rank", str(RANK), "--iterations", str(ITERS),
                       "--device", "cpu"])
    assert rc == 0
    jf = jals.ALSFactors.from_bytes(blob.read_bytes())

    td = jeng.FileRatingsDataSource(
        jeng.FileDataSourceParams(str(ratings))).read_training(None)
    assert len(td.rows) == len(lines)
    p = teng.ALSAlgorithmParams(rank=RANK, num_iterations=ITERS)
    jp = jals.ALSParams(rank=RANK, iterations=ITERS, lambda_=p.lambda_,
                        alpha=p.alpha, cg_iterations=p.cg_iterations)
    assert not jals.dense_eligible(td.rows, td.cols, td.vals, td.n_users,
                                   td.n_items, jp)
    n_u_p, n_i_p = (-(-n // 128) * 128 for n in (td.n_users, td.n_items))
    uf0, itf0 = tals._seeded_init(n_u_p, n_i_p, RANK, torch.zeros(n_u_p),
                                  torch.zeros(n_i_p), p.seed)
    ref = jals.train(td.rows, td.cols, td.vals, td.n_users, td.n_items, jp,
                     init_factors=(uf0[: td.n_users].numpy(),
                                   itf0[: td.n_items].numpy()))
    np.testing.assert_allclose(jf.user_factors, ref.user_factors,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(jf.item_factors, ref.item_factors,
                               rtol=1e-4, atol=1e-4)

    args = console._parser().parse_args(
        ["deploy", "--model", str(blob), "--ip", "127.0.0.1", "--port", "0",
         "--device", "cpu"])
    server = console.build_server(args)
    port = server.start()
    try:
        user = lines[5].split("::")[0]
        status, body = _post(port, {"user": user, "num": 9})
    finally:
        server.stop()
    assert status == 200
    scores, idx = jals.recommend(jf, np.array([jf.user_vocab(user)]), 9)
    inv = jf.item_vocab.inverse()
    assert [s["item"] for s in body["item_scores"]] == [inv(int(i)) for i in idx[0]]
    np.testing.assert_allclose([s["score"] for s in body["item_scores"]],
                               scores[0], rtol=1e-5)


def test_blob_loads_in_jax_with_equal_arrays_and_vocab(tmp_path, monkeypatch):
    from predictionio_tpu_torch.convert import load_jax_als_blob

    lines, blob = _train(tmp_path, monkeypatch, "--explicit", "--lambda",
                         "0.1", "--alpha", "2.0")
    ours = load_jax_als_blob(blob.read_bytes())
    jf = jals.ALSFactors.from_bytes(blob.read_bytes())
    np.testing.assert_array_equal(jf.user_factors, ours.user_factors)
    np.testing.assert_array_equal(jf.item_factors, ours.item_factors)
    assert jf.user_vocab.to_dict() == ours.user_vocab.to_dict()
    assert jf.item_vocab.to_dict() == ours.item_vocab.to_dict()
    assert not jf.params.implicit_prefs and jf.params.lambda_ == 0.1
    assert jf.params.alpha == 2.0
    # ids in first-seen order, as the JAX package's file DataSource does
    first_items = list(dict.fromkeys(ln.split("::")[1] for ln in lines))
    assert list(ours.item_vocab.to_dict()) == first_items


def test_file_datasource_matches_jax(tmp_path):
    path = tmp_path / "r.dat"
    _ratings_file(path, seed=4)
    ours = teng.FileRatingsDataSource(
        teng.FileDataSourceParams(str(path))).read_training()
    ref = jeng.FileRatingsDataSource(
        jeng.FileDataSourceParams(str(path))).read_training(None)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    assert (ours.n_users, ours.n_items) == (ref.n_users, ref.n_items)
    assert ours.user_vocab.to_dict() == ref.user_vocab.to_dict()
    bad = tmp_path / "bad.dat"
    bad.write_text("u1::i1\n")
    with pytest.raises(ValueError, match="bad ratings line"):
        teng.FileRatingsDataSource(teng.FileDataSourceParams(str(bad))).read_training()


def test_sanity_check(tmp_path):
    from predictionio_tpu_torch.data.store.bimap import BiMap

    def td(vals):
        n = len(vals)
        return teng.TrainingData(
            rows=np.zeros(n, np.int32), cols=np.arange(n, dtype=np.int32),
            vals=np.asarray(vals, np.float32), n_users=1, n_items=max(n, 1),
            user_vocab=BiMap({"u": 0}),
            item_vocab=BiMap({f"i{k}": k for k in range(n)}))

    td([1.0, 2.0]).sanity_check()
    with pytest.raises(ValueError, match="no interaction"):
        td([]).sanity_check()
    with pytest.raises(ValueError, match="non-finite"):
        td([1.0, float("nan")]).sanity_check()


def test_algorithm_train_matches_jax_engine(tmp_path, monkeypatch):
    """ALSAlgorithm.train on the same TrainingData and init-free params:
    both sides draw their own random init, so only shapes, finiteness
    and the serving model's device are compared; the factor math is
    held to the JAX package in tests/test_torch_als_train.py."""
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    path = tmp_path / "r.dat"
    _ratings_file(path, seed=5)
    td = teng.FileRatingsDataSource(teng.FileDataSourceParams(str(path))).read_training()
    alg = teng.ALSAlgorithm(teng.ALSAlgorithmParams(rank=4, num_iterations=2))
    model = alg.train(teng.RuntimeContext(device="cpu"), td)
    assert model.device.type == "cpu"
    assert model.factors.user_factors.shape == (td.n_users, 4)
    assert np.all(np.isfinite(model.factors.item_factors))
    res = alg.predict(model, teng.Query(user="user0", num=3))
    known = "user0" in td.user_vocab.to_dict()
    assert len(res.item_scores) == (3 if known else 0)
