"""The port's serving slice end to end against the JAX package: the
recommendation engine's `_predict_batch` on the same factors, and the
port's query server answering concurrent `POST /queries.json` with the
JSON the JAX engine's result serializes to.

Factors are multiples of 1/8, so every score is exact on both sides:
item lists must be identical and scores equal."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from predictionio_tpu.data.store.bimap import BiMap as JBiMap  # noqa: E402
from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu.workflow.server import _to_jsonable as j_to_jsonable  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402
from predictionio_tpu_torch.workflow import server as tserver  # noqa: E402

U, I, K = 30, 300, 10


def _jax_model(dtype="f32"):
    rng = np.random.default_rng(0)
    uf = (np.round(rng.standard_normal((U, K)) * 8) / 8).astype(np.float32)
    itf = (np.round(rng.standard_normal((I, K)) * 8) / 8).astype(np.float32)
    cats = [frozenset({"even" if n % 2 == 0 else "odd", f"c{n % 7}"})
            for n in range(I)]
    f = jals.ALSFactors(
        user_factors=uf,
        item_factors=itf,
        user_vocab=JBiMap({f"u{n}": n for n in range(U)}),
        item_vocab=JBiMap({f"i{n}": n for n in range(I)}),
    )
    return jeng.ALSModel(f, item_categories=cats, serve_dtype=dtype)


def _port_model(jm):
    factors = convert.load_jax_als_blob(jm.factors.to_bytes())
    return teng.ALSModel(
        factors, item_categories=jm.item_categories,
        serve_dtype=jm.serve_dtype, device="cpu",
    )


QUERIES = [
    dict(user="u1", num=5),
    dict(user="nobody", num=5),  # unknown user → empty result
    dict(user="u2", num=10, blacklist=["i3", "i9", "zzz"]),
    dict(user="u3", num=4, whitelist=["i10", "i20", "i30", "i40", "i50", "nope"]),
    dict(user="u4", num=8, categories=["c3"]),
    dict(user="u5", num=200),  # above the 128 floor → k = 256
    dict(user="u6", num=400),  # above the catalog → capped at n_items
    dict(user="u7", num=290, blacklist=[f"i{n}" for n in range(0, 300, 3)]),
    dict(user="u8", num=3, categories=["even"], blacklist=["i0", "i2"]),
]


def _same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert [s.item for s in a.item_scores] == [s.item for s in b.item_scores]
        np.testing.assert_allclose(
            [s.score for s in a.item_scores], [s.score for s in b.item_scores],
            rtol=1e-6,
        )


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("subset", ["all", "single", "filters"])
def test_predict_batch_matches_jax(dtype, subset):
    jm = _jax_model(dtype)
    tm = _port_model(jm)
    qs = {"all": QUERIES, "single": QUERIES[:1],
          "filters": QUERIES[2:5]}[subset]
    jalg = jeng.ALSAlgorithm(jeng.ALSAlgorithmParams(serve_dtype=dtype))
    talg = teng.ALSAlgorithm(teng.ALSAlgorithmParams(serve_dtype=dtype))
    ref = jalg._predict_batch(jm, [jeng.Query(**q) for q in qs])
    ours = talg._predict_batch(tm, [teng.Query(**q) for q in qs])
    _same(ours, ref)
    if subset == "all":
        assert ours[1].item_scores == []
        assert len(ours[6].item_scores) == I
        assert {s.item for s in ours[3].item_scores} <= {
            "i10", "i20", "i30", "i40", "i50"
        }


def test_category_filter_without_categories_raises():
    jm = _jax_model()
    tm = _port_model(jm)
    tm.item_categories = None
    alg = teng.ALSAlgorithm(teng.ALSAlgorithmParams())
    with pytest.raises(ValueError, match="categories"):
        alg.predict(tm, teng.Query(user="u1", categories=["c1"]))


def test_warmup_stages_and_sizes():
    tm = _port_model(_jax_model("int8"))
    alg = teng.ALSAlgorithm(teng.ALSAlgorithmParams(serve_dtype="int8"))
    unstaged = tm.resident_device_bytes()
    alg.warmup(tm)
    assert tm.serving_state().dtype == "int8"
    assert tm.resident_device_bytes() < unstaged


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_status(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
        return json.loads(r.read())


def test_query_server_matches_jax_and_stops_clean():
    jm = _jax_model()
    jalg = jeng.ALSAlgorithm(jeng.ALSAlgorithmParams())
    expected = [
        j_to_jsonable(jalg.predict(jm, jeng.Query(**q))) for q in QUERIES
    ]
    baseline = set(threading.enumerate())
    server = tserver.QueryServer(
        teng.ALSAlgorithm(teng.ALSAlgorithmParams()), _port_model(jm),
        tserver.QueryServerConfig(ip="127.0.0.1", port=0),
    )
    port = server.start()
    try:
        work = [i % len(QUERIES) for i in range(36)]
        got: dict[int, tuple] = {}
        lock = threading.Lock()

        def client(ids):
            for n in ids:
                res = _post(port, QUERIES[work[n]])
                with lock:
                    got[n] = res

        threads = [threading.Thread(target=client, args=(range(t, 36, 8),))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert len(got) == 36
        for n, (status, body) in got.items():
            assert status == 200
            assert body == expected[work[n]]
        status = _get_status(port)
        assert status["requests"] == 36
        assert 1 <= status["batches"] <= 36
        assert status["kernel_launches"] >= 0 and status["device"] == "cpu"
        # malformed queries are the client's fault, not the server's
        assert _post(port, {"user": "u1", "bogus": 1})[0] == 400
        assert _post(port, {"user": 5})[0] == 400
        assert _post(port, {"num": 3})[0] == 400
        assert _post(port, [1, 2])[0] == 400
        assert _post(port, {"user": "u1", "categories": ["c1"]})[0] == 200
    finally:
        server.stop()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t not in baseline and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, leaked


def test_query_server_without_micro_batch():
    jm = _jax_model()
    server = tserver.QueryServer(
        teng.ALSAlgorithm(teng.ALSAlgorithmParams()), _port_model(jm),
        tserver.QueryServerConfig(ip="127.0.0.1", port=0, micro_batch=False),
    )
    port = server.start()
    try:
        status, body = _post(port, QUERIES[0])
        assert status == 200 and len(body["item_scores"]) == 5
        assert _get_status(port)["batches"] == 1
    finally:
        server.stop()
    assert server.dispatcher is None


def test_console_deploy_serves_a_jax_blob(tmp_path):
    from predictionio_tpu_torch.tools import console

    jm = _jax_model()
    blob = tmp_path / "factors.npz"
    blob.write_bytes(jm.factors.to_bytes())
    args = console._parser().parse_args([
        "deploy", "--model", str(blob), "--ip", "127.0.0.1", "--port", "0",
        "--serve-dtype", "bf16", "--device", "cpu",
    ])
    server = console.build_server(args)
    port = server.start()
    try:
        status, body = _post(port, QUERIES[2])
        ref = jeng.ALSAlgorithm(jeng.ALSAlgorithmParams(serve_dtype="bf16"))
        expected = j_to_jsonable(
            ref.predict(_jax_model("bf16"), jeng.Query(**QUERIES[2]))
        )
        assert status == 200 and body == expected
        assert server.model.serving_state().dtype == "bf16"
    finally:
        server.stop()
