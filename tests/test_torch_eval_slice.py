"""`pio eval` on the port against the JAX package: read_eval folds, the
whole grid evaluation, and `console eval run`.

The same seeded events (explicit ids and times, so that both stores order
them the same way) go into both packages' sqlite storage.

- ``read_eval``: every fold's training arrays, vocabularies, eval info,
  queries and actual lists equal the JAX package's element for element.
- ``run_evaluation`` of the recommendation template over a rank x λ
  grid, on the windowed path and on the forced dense one: the port's
  seeded init is replaced by the JAX package's threefry draw
  (tests/test_torch_als_grid.py's ``jax_init``), so both grids start
  from the same factors; every point's Precision@k is within 0.01 of
  the JAX package's and the best point is the same. The port's grid path
  runs (one ``train_grid`` per fold), and its instance row is
  EVALCOMPLETED with the evaluator's results.
- ``console eval run`` on the port's sqlite storage (PIO_FS_BASEDIR)
  exits 0 with an EVALCOMPLETED row and best.json, and 1 for a
  malformed spec file (for `eval run` and `tune`), an unknown eval run,
  a JAX import path, an Evaluation missing or not an Evaluation.
"""

import dataclasses
import datetime as dt
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu import controller as jc  # noqa: E402
from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App as JApp  # noqa: E402
from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu.workflow import evaluation as jwf  # noqa: E402
from predictionio_tpu_torch import controller as tc  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import Storage  # noqa: E402
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402
from predictionio_tpu_torch.tools import console  # noqa: E402
from predictionio_tpu_torch.workflow import evaluation as twf  # noqa: E402
from test_torch_als_grid import jax_init  # noqa: E402
from test_torch_workflow import _jax_storage, _port_storage  # noqa: E402

APP = "evapp"
T0 = dt.datetime(2024, 6, 1, tzinfo=dt.timezone.utc)
N_USERS, N_ITEMS = 80, 50
EVAL_K, EVAL_NUM, PREC_K = 3, 10, 5


def _rows():
    """(event, user, item, rating): three taste cohorts over disjoint item
    groups, 14 rated items a user, a repeated pair every fourth user
    (summed by the read), and a buy of another group's item."""
    rng = np.random.RandomState(3)
    rows = []
    for u in range(N_USERS):
        group = u % 3
        pool = np.arange(N_ITEMS)[np.arange(N_ITEMS) % 3 == group]
        for i in rng.choice(pool, 14, replace=False):
            rows.append(("rate", f"u{u}", f"i{i}", float(rng.randint(2, 6))))
        if u % 4 == 0:
            rows.append(rows[-1][:3] + (1.0,))
        rows.append(("buy", f"u{u}", f"i{(u * 7 + group + 1) % N_ITEMS}", None))
    order = rng.permutation(len(rows))
    return [rows[n] for n in order]


def _events(make, rows):
    return [
        make(event=e, entity_type="user", entity_id=u, target_entity_type="item",
             target_entity_id=i, properties={} if r is None else {"rating": r},
             event_time=T0 + dt.timedelta(seconds=n), creation_time=T0,
             event_id=f"e{n:06d}")
        for n, (e, u, i, r) in enumerate(rows)
    ]


def _seed(storage, app_cls, event_cls):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, APP))
    storage.get_events().init_app(app_id)
    storage.get_events().insert_batch(_events(event_cls, _rows()), app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval_slice")
    return (_seed(_jax_storage(base / "jax"), JApp, JEvent),
            _seed(_port_storage(base / "port"), App, Event))


def _ds_params(eng, **kw):
    return eng.DataSourceParams(app_name=APP, eval_k=EVAL_K, eval_num=EVAL_NUM, **kw)


@pytest.mark.parametrize("threshold", [4.0, 5.0])
def test_read_eval_folds_match_jax(stores, threshold):
    js, ts = stores
    jsets = jeng.RecommendationDataSource(
        _ds_params(jeng, goal_threshold=threshold)).read_eval(JContext(storage=js))
    tsets = teng.RecommendationDataSource(
        _ds_params(teng, goal_threshold=threshold)).read_eval(
            RuntimeContext(storage=ts, device="cpu"))
    assert len(tsets) == len(jsets) == EVAL_K
    n_queries = 0
    for (ttd, tei, tqa), (jtd, jei, jqa) in zip(tsets, jsets):
        assert tei.fold == jei.fold
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(ttd, f), getattr(jtd, f))
            assert getattr(ttd, f).dtype == getattr(jtd, f).dtype
        assert (ttd.n_users, ttd.n_items) == (jtd.n_users, jtd.n_items)
        assert ttd.user_vocab.to_dict() == jtd.user_vocab.to_dict()
        assert ttd.item_vocab.to_dict() == jtd.item_vocab.to_dict()
        assert [(dataclasses.asdict(q), a.items) for q, a in tqa] == \
            [(dataclasses.asdict(q), a.items) for q, a in jqa]
        n_queries += len(tqa)
    assert n_queries > N_USERS  # most users have a relevant held-out item a fold
    with pytest.raises(ValueError, match="eval_k > 0"):
        teng.RecommendationDataSource(teng.DataSourceParams(app_name=APP)).read_eval(
            RuntimeContext(storage=ts, device="cpu"))


GRID = [(rank, lam) for rank in (4, 8) for lam in (0.01, 1.0)]


def _grid(pkg, eng):
    return [pkg.EngineParams(
        data_source_params=("", _ds_params(eng)),
        algorithm_params_list=(("als", eng.ALSAlgorithmParams(
            rank=rank, num_iterations=4, lambda_=lam)),))
        for rank, lam in GRID]


def _evaluation(pkg, eng):
    return type("RecEval", (pkg.Evaluation,), {
        "engine": eng.RecommendationEngine().apply(),
        "metric": eng.PrecisionAtK(k=PREC_K)})()


@pytest.mark.parametrize("route", ["windowed", "dense"])
def test_run_evaluation_matches_jax(stores, monkeypatch, route):
    js, ts = stores
    monkeypatch.setenv("PIO_DENSE_ALS", "1" if route == "dense" else "0")
    monkeypatch.setattr(tals, "_seeded_init", jax_init)
    staged, grids = [], []
    for name in ("stage_dense", "stage_windowed"):
        fn = getattr(tals, name)
        monkeypatch.setattr(tals, name, lambda *a, _f=fn, _n=name, **k: (
            staged.append(_n), _f(*a, **k))[1])
    fn = tals.train_grid
    monkeypatch.setattr(tals, "train_grid", lambda *a, **k: (grids.append(1), fn(*a, **k))[1])
    jinst, jres = jwf.run_evaluation(js, _evaluation(jc, jeng), _grid(jc, jeng))
    tinst, tres = twf.run_evaluation(ts, _evaluation(tc, teng), _grid(tc, teng),
                                     device="cpu")
    assert staged == [f"stage_{route}"] * EVAL_K and len(grids) == EVAL_K
    assert tinst.status == jinst.status == "EVALCOMPLETED"
    tscores = [s.score for s in tres.engine_params_scores]
    jscores = [s.score for s in jres.engine_params_scores]
    np.testing.assert_allclose(tscores, jscores, rtol=0, atol=0.01)
    assert tres.best_index == jres.best_index
    assert max(tscores) > 2 * min(tscores)  # the grid matters on this data
    row = ts.get_meta_data_evaluation_instances().get(tinst.id)
    assert row.status == "EVALCOMPLETED" and row.env["grid_points"] == str(len(GRID))
    assert row.evaluator_results == f"[Precision@{PREC_K}] best: {tres.best_score.score}"
    parsed = json.loads(row.evaluator_results_json)
    assert parsed["bestIndex"] == tres.best_index and len(parsed["scores"]) == len(GRID)
    assert "<table>" in row.evaluator_results_html


# -- console eval run ---------------------------------------------------------


class ConsoleEvaluation(tc.Evaluation):
    """What `eval run test_torch_eval_slice.ConsoleEvaluation` loads."""

    engine = teng.RecommendationEngine().apply()
    metric = teng.PrecisionAtK(k=PREC_K)
    output_path = None  # set by the test


class ConsoleGrid(tc.EngineParamsGenerator):
    engine_params_list = _grid(tc, teng)[:2]


def test_console_eval_run(tmp_path, monkeypatch, capsys):
    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.setattr(ConsoleEvaluation, "output_path", str(tmp_path / "best.json"))
    events = tmp_path / "events.jsonl"
    events.write_text("\n".join(e.to_json() for e in _events(Event, _rows())) + "\n")
    assert console.main(["app", "new", APP]) == 0
    assert console.main(["import", "--app", APP, "--input", str(events)]) == 0
    here = __name__
    assert console.main(["eval", "run", f"{here}.ConsoleEvaluation",
                         f"{here}.ConsoleGrid", "--device", "cpu"]) == 0
    [row] = Storage().get_meta_data_evaluation_instances().get_all()
    assert row.status == "EVALCOMPLETED" and row.env["grid_points"] == "2"
    assert row.evaluation_class == f"{here}.ConsoleEvaluation"
    assert f"Evaluation EVALCOMPLETED: {row.evaluator_results}" in capsys.readouterr().out
    best = json.loads((tmp_path / "best.json").read_text())
    winner = json.loads(row.evaluator_results_json)["bestEngineParams"]
    assert best == winner and best["algorithms"][0]["name"] == "als"

    spec = tmp_path / "spec.json"
    spec.write_text("{}")
    for argv, says in (
        (["eval", "run", str(spec)], "bad eval spec"),
        (["eval", "status", "r1"], "no such eval run"),
        (["tune", str(spec)], "bad eval spec"),
        (["eval", "run", "predictionio_tpu.controller.Evaluation"], "JAX package"),
        (["eval", "run", f"{here}.NoSuchEvaluation"], "no symbol"),
        (["eval", "run", f"{here}.ConsoleGrid", "--device", "cpu"], "not an Evaluation"),
    ):
        assert console.main(argv) == 1, argv
        assert says in capsys.readouterr().err, argv
    assert len(Storage().get_meta_data_evaluation_instances().get_all()) == 1
