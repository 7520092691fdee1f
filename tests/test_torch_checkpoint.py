"""Checkpointed ALS training on the port (``workflow/checkpoint.py``),
against an uninterrupted port train and the JAX package's checkpoints.

The four cases of the JAX package's tests/test_checkpoint.py, on each of
the port's three train routes, each route checked by the staging it
took: dense (unique pairs, ``PIO_DENSE_ALS=1``), windowed (the auto
route below 1 M edges; the data repeats pairs) and scatter (rank 40 >
32):

- 9 iterations as 4 + 4 + 1 explicit warm-started trains, and a train
  killed after its second segment of 3 then resumed from its MODELDATA
  checkpoint (at iteration 6), equal an uninterrupted 9-iteration train
  within the JAX package's bar (rtol 1e-5, atol 1e-6), and the
  checkpoint is cleared at the end;
- ``checkpoint_every=0`` is a plain train, array_equal.

Then the blob layout across packages, over one localfs MODELDATA
directory: a checkpoint the port saved loads in the JAX package's
``CheckpointManager`` (the same iteration and factors), and a JAX
train killed after a segment resumes in the port, whose result equals a
port train of the remaining iterations from the JAX checkpoint's
factors. Last, ``run_train`` of a variant with ``checkpoint_every``
leaves the model and no checkpoint behind.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu.workflow import checkpoint as jckpt  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.models import als  # noqa: E402
from predictionio_tpu_torch.workflow.checkpoint import (  # noqa: E402
    CheckpointManager,
    train_als_checkpointed,
)
from predictionio_tpu_torch.workflow.core import run_train  # noqa: E402

N_USERS, N_ITEMS, N_EDGES = 50, 30, 600
ITERS = 9
ROUTES = {  # route → (rank, PIO_DENSE_ALS, unique pairs, the staging taken)
    "dense": (6, "1", True, "_train_dense"),
    "windowed": (6, None, False, "_train_windowed"),
    "scatter": (40, None, False, "_train_scatter"),
}


def _storage(path):
    path.mkdir(parents=True, exist_ok=True)
    return Storage(StorageConfig(
        sources={"TESTSQL": SourceConfig("TESTSQL", "sqlite", {"PATH": str(path / "pio.db")}),
                 "TESTFS": SourceConfig("TESTFS", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "TESTSQL", "EVENTDATA": "TESTSQL", "MODELDATA": "TESTFS"},
    ))


def _jax_storage(path):
    path.mkdir(parents=True, exist_ok=True)
    return JStorage(JStorageConfig(
        sources={"TESTSQL": JSourceConfig("TESTSQL", "sqlite", {"PATH": str(path / "pio.db")}),
                 "TESTFS": JSourceConfig("TESTFS", "localfs", {"PATH": str(path)})},
        repositories={"METADATA": "TESTSQL", "EVENTDATA": "TESTSQL", "MODELDATA": "TESTFS"},
    ))


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch):
    """(rank, data, the staging functions called, the one wanted) of one
    route."""
    rank, env, unique, path = ROUTES[request.param]
    if env is None:
        monkeypatch.delenv("PIO_DENSE_ALS", raising=False)
    else:
        monkeypatch.setenv("PIO_DENSE_ALS", env)
    rng = np.random.RandomState(5)
    if unique:
        keys = rng.choice(N_USERS * N_ITEMS, N_EDGES, replace=False)
        rows, cols = keys // N_ITEMS, keys % N_ITEMS
        vals = rng.randint(1, 6, N_EDGES)
    else:  # tests/test_checkpoint.py's data: repeated pairs, real ratings
        rows = rng.randint(0, N_USERS, N_EDGES)
        cols = rng.randint(0, N_ITEMS, N_EDGES)
        vals = rng.rand(N_EDGES) * 4 + 1
    data = (rows.astype(np.int32), cols.astype(np.int32), vals.astype(np.float32),
            N_USERS, N_ITEMS)
    taken = []
    for name in ROUTES.values():
        fn = getattr(als, name[3])
        monkeypatch.setattr(als, name[3], lambda *a, _f=fn, _n=name[3], **k:
                            (taken.append(_n), _f(*a, **k))[1])
    return rank, data, taken, path


def _params(rank, iterations=ITERS):
    return als.ALSParams(rank=rank, iterations=iterations, implicit_prefs=True)


def _assert_close(got, want):
    for side in ("user_factors", "item_factors"):
        np.testing.assert_allclose(getattr(got, side), getattr(want, side),
                                   rtol=1e-5, atol=1e-6)


def test_warm_start_segments_equal_uninterrupted(route):
    rank, data, taken, path = route
    full = als.train(*data, _params(rank), device="cpu")
    seg = None
    for it in (4, 4, 1):
        init = None if seg is None else (seg.user_factors, seg.item_factors)
        seg = als.train(*data, _params(rank, it), init_factors=init, device="cpu")
    _assert_close(seg, full)
    assert taken == [path] * 4


def test_kill_and_resume_matches_uninterrupted(route, tmp_path):
    rank, data, taken, path = route
    full = als.train(*data, _params(rank), device="cpu")
    manager = CheckpointManager(_storage(tmp_path), "inst-1")
    segments = []

    class Killed(RuntimeError):
        pass

    def die_after_two_segments(done):
        segments.append(done)
        if len(segments) == 2:
            raise Killed()

    with pytest.raises(Killed):
        train_als_checkpointed(*data, _params(rank), manager, checkpoint_every=3,
                               on_segment=die_after_two_segments, device="cpu")
    loaded = manager.load()
    assert loaded is not None and loaded[0] == 6 and segments == [3, 6]
    resumed = train_als_checkpointed(*data, _params(rank), manager,
                                     checkpoint_every=3, device="cpu")
    _assert_close(resumed, full)
    assert manager.load() is None
    assert taken == [path] * 4  # the full train, 2 killed segments, 1 resumed


def test_checkpointing_disabled_is_plain_train(route, tmp_path):
    rank, data, taken, path = route
    manager = CheckpointManager(_storage(tmp_path), "inst-0")
    a = train_als_checkpointed(*data, _params(rank), manager, checkpoint_every=0,
                               device="cpu")
    b = als.train(*data, _params(rank), device="cpu")
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    np.testing.assert_array_equal(a.item_factors, b.item_factors)
    assert manager.load() is None and taken == [path] * 2


class _Stop(RuntimeError):
    pass


def _stop(done):
    raise _Stop(done)


def _unique_data():
    rng = np.random.RandomState(6)
    keys = rng.choice(N_USERS * N_ITEMS, N_EDGES, replace=False)
    return ((keys // N_ITEMS).astype(np.int32), (keys % N_ITEMS).astype(np.int32),
            rng.randint(1, 6, N_EDGES).astype(np.float32), N_USERS, N_ITEMS)


def test_port_checkpoint_loads_in_jax(tmp_path):
    data = _unique_data()
    manager = CheckpointManager(_storage(tmp_path / "port"), "inst-x")

    with pytest.raises(_Stop):
        train_als_checkpointed(*data, _params(6), manager, checkpoint_every=4,
                               on_segment=_stop, device="cpu")
    it, payload = manager.load()
    jit, jpayload = jckpt.CheckpointManager(_jax_storage(tmp_path / "port"),
                                            "inst-x").load()
    assert (jit, jpayload) == (it, payload) == (4, payload)
    mine, theirs = als.ALSFactors.from_bytes(payload), jals.ALSFactors.from_bytes(jpayload)
    np.testing.assert_array_equal(theirs.user_factors, mine.user_factors)
    np.testing.assert_array_equal(theirs.item_factors, mine.item_factors)
    assert theirs.params.rank == 6 and theirs.params.iterations == 4


def test_jax_checkpoint_resumes_in_port(tmp_path):
    data = _unique_data()
    jmanager = jckpt.CheckpointManager(_jax_storage(tmp_path / "shared"), "inst-j")
    jparams = jals.ALSParams(rank=6, iterations=ITERS, implicit_prefs=True)

    with pytest.raises(_Stop):
        jckpt.train_als_checkpointed(*data, jparams, jmanager, checkpoint_every=5,
                                     on_segment=_stop)
    it, payload = jmanager.load()
    assert it == 5
    jax_state = jals.ALSFactors.from_bytes(payload)
    manager = CheckpointManager(_storage(tmp_path / "shared"), "inst-j")
    resumed = train_als_checkpointed(*data, _params(6), manager, checkpoint_every=5,
                                     device="cpu")
    want = als.train(*data, _params(6, ITERS - 5),
                     init_factors=(jax_state.user_factors, jax_state.item_factors),
                     device="cpu")
    np.testing.assert_array_equal(resumed.user_factors, want.user_factors)
    np.testing.assert_array_equal(resumed.item_factors, want.item_factors)
    assert manager.load() is None and jmanager.load() is None


def test_engine_level_checkpointing(tmp_path):
    """`checkpoint_every` flows from the variant through run_train; the
    completed train leaves the model and no checkpoint."""
    storage = _storage(tmp_path)
    app_id = storage.get_meta_data_apps().insert(App(id=0, name="ckapp"))
    storage.get_events().init_app(app_id)
    rng = np.random.RandomState(0)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{rng.randint(8)}",
              target_entity_type="item", target_entity_id=f"i{rng.randint(6)}",
              properties={"rating": float(rng.randint(1, 6))})
        for _ in range(60)], app_id)
    saved = []
    orig = CheckpointManager.save
    CheckpointManager.save = lambda self, it, p: (saved.append(it), orig(self, it, p))[1]
    try:
        inst = run_train(storage, {
            "id": "ck",
            "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
            "datasource": {"params": {"app_name": "ckapp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "num_iterations": 6, "checkpoint_every": 2}}],
        }, device="cpu")
    finally:
        CheckpointManager.save = orig
    assert inst.status == "COMPLETED" and saved == [2, 4]
    models = storage.get_model_data_models()
    assert models.get(f"ckpt:{inst.id}") is None
    assert models.get(inst.id) is not None


@pytest.mark.parametrize("iterations", [1, 2, 5])
def test_dense_pad_rows_stay_zero(monkeypatch, iterations):
    """A segment restarts from factors cut to the real rows and padded
    with zeros, so an uninterrupted dense train must keep its pad rows
    exactly zero after every half-step, or the implicit Gram over the
    full side would differ across a checkpoint."""
    monkeypatch.setenv("PIO_DENSE_ALS", "1")
    rows, cols, vals, n_users, n_items = _unique_data()
    staged = als.stage_dense(rows, cols, vals, n_users, n_items,
                             _params(6, iterations), device="cpu")
    uf, itf = staged.run()
    assert uf.shape[0] > n_users and itf.shape[0] > n_items  # there are pads
    assert not uf[n_users:].any() and not itf[n_items:].any()
    assert uf[:n_users].any() and itf[:n_items].any()
