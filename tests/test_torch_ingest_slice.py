"""The quick start through the port's Event Server on the CPU, against the
JAX package: ``app new`` → the port's ``EventServer`` on port 0 → batch
POSTs of a seeded 300 x 200, 6,000-event set → ``train --engine-json
--device cpu`` → ``deploy --engine-json --device cpu`` → queries.

- The events go in as 120 ``/batch/events.json`` POSTs of 50 with the
  key ``app new`` printed; 20 more go to a ``holdout`` channel and a
  batch of ``buy`` events with a rate-only key comes back 403 each. The
  train reads exactly the 6,000 triples, and the JAX package's read of
  the same sqlite file gives the same ``TrainingData``.
- 6,000 ratings are under the dense gate: the train takes the windowed
  path. Its factors are within rtol = atol = 1e-4 of the JAX package's
  train of the same data from the port's seeded start (the JAX draw is
  threefry, so the start is passed to it, as
  tests/test_torch_train_slice.py does).
- The deployed server's answers name the same items as the JAX engine's
  predict on the port's factors, scores within rtol 1e-5
  (tests/test_torch_train_slice.py's serving bar).
"""

import datetime as dt
import json
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.data.store.bimap import BiMap as JBiMap  # noqa: E402
from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu_torch.controller import deserialize_models  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import Storage  # noqa: E402
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402
from predictionio_tpu_torch.tools import console  # noqa: E402

APP = "ingest"
N_USERS, N_ITEMS, N_EVENTS = 300, 200, 6_000
RANK, ITERS = 8, 5
T0_MS = 874_724_710_000
VARIANT = {
    "id": "ingest-als",
    "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
    "datasource": {"params": {"app_name": APP, "event_names": ["rate"]}},
    "algorithms": [{"name": "als", "params": {"rank": RANK, "num_iterations": ITERS}}],
}


def _data(seed=13):
    rng = np.random.default_rng(seed)
    cells = rng.choice(N_USERS * N_ITEMS, N_EVENTS, replace=False)
    ratings = rng.integers(1, 6, N_EVENTS)
    times = T0_MS + 1000 * rng.permutation(N_EVENTS)
    return cells // N_ITEMS, cells % N_ITEMS, ratings, times


def _event(u, i, r, t_ms, event="rate"):
    stamp = dt.datetime.fromtimestamp(t_ms / 1000, dt.timezone.utc)
    return {"event": event, "entityType": "user", "entityId": f"u{u}",
            "targetEntityType": "item", "targetEntityId": f"i{i}",
            "properties": {"rating": int(r)},
            "eventTime": stamp.isoformat(timespec="milliseconds").replace("+00:00", "Z")}


def _post(port, path, body):
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                               data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            mp.delenv(key)
    mp.delenv("PIO_DENSE_ALS", raising=False)
    base = tmp_path_factory.mktemp("ingest")
    mp.setenv("PIO_FS_BASEDIR", str(base))
    paths = []
    train_windowed = tals._train_windowed
    mp.setattr(tals, "_train_windowed",
               lambda *a, **k: (paths.append("windowed"), train_windowed(*a, **k))[1])
    try:
        yield _ingest_and_train(base, paths)
    finally:
        mp.undo()


def _ingest_and_train(base, paths):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert console.main(["app", "new", APP]) == 0
        assert console.main(["accesskey", "new", APP, "--key", "RATEONLY",
                             "--events", "rate"]) == 0
        assert console.main(["channel", "new", APP, "holdout"]) == 0
    key = re.search(r"Access key: (\S+)", out.getvalue()).group(1)
    users, items, ratings, times = _data()
    events = [_event(*row) for row in zip(users, items, ratings, times)]
    server = EventServer(Storage(), EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    port = server.start()
    try:
        statuses = []
        for b in range(0, N_EVENTS, 50):
            status, body = _post(port, f"/batch/events.json?accessKey={key}", events[b:b + 50])
            assert status == 200
            statuses += [r["status"] for r in body]
        holdout = [_event(u, u % N_ITEMS, 5, T0_MS - 1000 * u) for u in range(20)]
        status, body = _post(port, f"/batch/events.json?accessKey={key}&channel=holdout",
                             holdout)
        refused = _post(port, "/batch/events.json?accessKey=RATEONLY",
                        [_event(u, 0, 1, T0_MS, "buy") for u in range(5)])
        wrong = _post(port, "/events.json?accessKey=nope", events[0])
    finally:
        server.stop()
    variant = base / "engine.json"
    variant.write_text(json.dumps(VARIANT))
    assert console.main(["train", "--engine-json", str(variant), "--device", "cpu"]) == 0
    storage = Storage()
    [inst] = storage.get_meta_data_engine_instances().get_all()
    [model] = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    return dict(base=base, key=key, statuses=statuses, holdout=(status, body),
                refused=refused, wrong=wrong, variant=variant, inst=inst,
                model=model, paths=list(paths), data=(users, items, ratings))


def test_ingest_statuses(ingested):
    assert ingested["statuses"] == [201] * N_EVENTS
    status, body = ingested["holdout"]
    assert status == 200 and [r["status"] for r in body] == [201] * 20
    status, body = ingested["refused"]
    assert status == 200 and [r["status"] for r in body] == [403] * 5
    assert ingested["wrong"][0] == 401


def _jax_training_data(base):
    js = JStorage(JStorageConfig(
        sources={"S": JSourceConfig("S", "sqlite", {"PATH": str(base / "pio.db")})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
    return jeng.RecommendationDataSource(
        jeng.DataSourceParams(APP, event_names=("rate",))).read_training(JContext(storage=js))


def test_training_data_is_the_posted_triples_and_jax_reads_it(ingested):
    ttd = teng.RecommendationDataSource(
        teng.DataSourceParams(APP, event_names=("rate",))).read_training(
        RuntimeContext(storage=Storage(), device="cpu"))
    jtd = _jax_training_data(ingested["base"])
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ttd, f), getattr(jtd, f))
    assert ttd.user_vocab.to_dict() == jtd.user_vocab.to_dict()
    users, items, ratings = ingested["data"]
    uinv, iinv = ttd.user_vocab.inverse(), ttd.item_vocab.inverse()
    got = sorted((uinv(int(r)), iinv(int(c)), float(v))
                 for r, c, v in zip(ttd.rows, ttd.cols, ttd.vals))
    assert got == sorted((f"u{u}", f"i{i}", float(r)) for u, i, r in zip(users, items, ratings))


def test_factors_match_the_jax_train(ingested):
    assert ingested["inst"].status == "COMPLETED"
    assert ingested["paths"] == ["windowed"]
    td = _jax_training_data(ingested["base"])
    p = teng.ALSAlgorithmParams(rank=RANK, num_iterations=ITERS)
    jp = jals.ALSParams(rank=RANK, iterations=ITERS, lambda_=p.lambda_, alpha=p.alpha,
                        cg_iterations=p.cg_iterations)
    n_u_p, n_i_p = (-(-n // 128) * 128 for n in (td.n_users, td.n_items))
    uf0, itf0 = tals._seeded_init(n_u_p, n_i_p, RANK, torch.zeros(n_u_p),
                                  torch.zeros(n_i_p), p.seed)
    ref = jals.train(td.rows, td.cols, td.vals, td.n_users, td.n_items, jp,
                     init_factors=(uf0[:td.n_users].numpy(), itf0[:td.n_items].numpy()))
    f = ingested["model"].factors
    assert f.user_vocab.to_dict() == td.user_vocab.to_dict()
    np.testing.assert_allclose(f.user_factors, ref.user_factors, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f.item_factors, ref.item_factors, rtol=1e-4, atol=1e-4)


def test_deploy_answers_match_the_jax_engine(ingested):
    args = console._parser().parse_args(
        ["deploy", "--engine-json", str(ingested["variant"]), "--ip", "127.0.0.1",
         "--port", "0", "--device", "cpu"])
    server = console.build_server(args)
    port = server.start()
    queries = [{"user": f"u{u}", "num": n} for u, n in ((0, 5), (17, 10), (299, 20),
                                                          (150, 200))]
    queries.append({"user": "u3", "num": 10, "blacklist": ["i0", "i1", "i2"]})
    try:
        answers = [_post(port, "/queries.json", q) for q in queries]
    finally:
        server.stop()
    f = ingested["model"].factors
    jmodel = jeng.ALSModel(jals.ALSFactors(
        user_factors=f.user_factors, item_factors=f.item_factors,
        user_vocab=JBiMap(f.user_vocab.to_dict()), item_vocab=JBiMap(f.item_vocab.to_dict())))
    jalg = jeng.ALSAlgorithm(jeng.ALSAlgorithmParams(rank=RANK))
    for q, (status, body) in zip(queries, answers):
        assert status == 200
        want = jalg.predict(jmodel, jeng.Query(**q))
        assert [s["item"] for s in body["item_scores"]] == [s.item for s in want.item_scores]
        np.testing.assert_allclose([s["score"] for s in body["item_scores"]],
                                   [s.score for s in want.item_scores], rtol=1e-5)
        items = [s["item"] for s in body["item_scores"]]
        assert len(items) == min(q["num"], N_ITEMS)
        assert not set(items) & set(q.get("blacklist", ()))
