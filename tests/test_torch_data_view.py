"""The data view (``data/view.py``) on the port against the JAX package.

- ``DataView.find_frame``: a miss reads the store and caches the frame,
  the next call with an unchanged store is a hit with an equal frame;
  an insert or a delete moves the data signature, so the next call
  misses and evicts the query's superseded file; a different query
  keeps its own file; an unreadable file is read again from the store.
- Frames equal the facade's and the JAX ``DataView``'s on the same
  sqlite file, and both packages name the same cache file, which each
  reads as a hit.
- ``default_view_dir`` follows ``PIO_FS_BASEDIR``.
- The recommendation template with ``use_data_view`` and
  ``read_item_categories``: TrainingData equal to the JAX one's
  (categories included), the second read a hit; ``read_eval`` through
  the view equal to the JAX folds.
"""

import datetime as dt
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from predictionio_tpu.core.base import RuntimeContext as JContext  # noqa: E402
from predictionio_tpu.data import view as jview  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu_torch.core.base import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.data import view as tview  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.data.store.event_store import EventStoreFacade  # noqa: E402
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402

T0 = dt.datetime(2024, 7, 1, tzinfo=dt.timezone.utc)
APP = "viewapp"
KW = dict(entity_type="user", target_entity_type="item", event_names=["rate", "buy"],
          value_prop="rating", default_value=1.0)


def _events(make, seed=5, n=300, first=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ev = "rate" if rng.random() < 0.8 else "buy"
        out.append(make(
            event=ev, entity_type="user", entity_id=f"u{int(rng.integers(25))}",
            target_entity_type="item", target_entity_id=f"i{int(rng.integers(40))}",
            properties={"rating": int(rng.integers(1, 6))} if ev == "rate" else {},
            event_time=T0 + dt.timedelta(seconds=int(rng.integers(200))),
            creation_time=T0, event_id=f"v{first + k:05d}"))
    for k in range(40):
        if k % 5 == 4:
            continue  # items without properties
        out.append(make(event="$set", entity_type="item", entity_id=f"i{k}",
                        properties={"categories": [f"c{k % 3}", f"g{k % 2}"]},
                        event_time=T0, creation_time=T0, event_id=f"p{first + k:05d}"))
    out.append(make(event="$unset", entity_type="item", entity_id="i1",
                    properties={"categories": None}, event_time=T0 + dt.timedelta(seconds=1),
                    creation_time=T0, event_id=f"q{first:05d}"))
    return out


def _sqlite(cls_storage, cls_config, cls_source, db):
    return cls_storage(cls_config(
        sources={"S": cls_source("S", "sqlite", {"PATH": str(db)}),
                 "F": cls_source("F", "localfs", {"PATH": str(db.parent)})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "F"}))


@pytest.fixture()
def shared(tmp_path):
    """One sqlite file written by the port, opened by both packages."""
    db = tmp_path / "pio.db"
    ts = _sqlite(Storage, StorageConfig, SourceConfig, db)
    app_id = ts.get_meta_data_apps().insert(App(0, APP))
    ts.get_events().init_app(app_id)
    ts.get_events().insert_batch(_events(Event), app_id)
    js = _sqlite(JStorage, JStorageConfig, JSourceConfig, db)
    return ts, js, app_id, tmp_path


def _frame_equal(got, want):
    for col in ("event_code", "entity_idx", "target_idx", "time_ms", "value"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col), err_msg=col)
        assert getattr(got, col).dtype == getattr(want, col).dtype, col
    for vocab in ("event_vocab", "entity_vocab", "target_vocab"):
        assert getattr(got, vocab).to_dict() == getattr(want, vocab).to_dict(), vocab
    assert (got.entity_type, got.target_entity_type) == (want.entity_type,
                                                         want.target_entity_type)


def _files(d):
    return sorted(n for n in os.listdir(d) if n.startswith("frame_"))


def test_miss_then_hit_then_evict(shared):
    ts, js, app_id, tmp = shared
    vdir = tmp / "view"
    view = tview.DataView(str(vdir))
    tview.DataView.stats.update(hits=0, misses=0)
    first = view.find_frame(ts, APP, **KW)
    assert tview.DataView.stats == {"hits": 0, "misses": 1}
    _frame_equal(first, EventStoreFacade(ts).find_frame(APP, **KW))
    [name] = _files(vdir)
    second = view.find_frame(ts, APP, **KW)
    assert tview.DataView.stats == {"hits": 1, "misses": 1}
    _frame_equal(second, first)
    # another query keeps a file of its own
    view.find_frame(ts, APP, entity_type="user", target_entity_type="item",
                    event_names=["rate"])
    assert len(_files(vdir)) == 2
    # an insert supersedes the query's version: a miss, the old file evicted
    ts.get_events().insert(Event(event="rate", entity_type="user", entity_id="u0",
                                 target_entity_type="item", target_entity_id="i0",
                                 properties={"rating": 2}, event_time=T0,
                                 event_id="new1"), app_id)
    third = view.find_frame(ts, APP, **KW)
    assert tview.DataView.stats == {"hits": 1, "misses": 3}
    assert len(third) == len(first) + 1
    assert name not in _files(vdir) and len(_files(vdir)) == 2
    # so does a delete
    ts.get_events().delete("new1", app_id)
    fourth = view.find_frame(ts, APP, **KW)
    assert tview.DataView.stats == {"hits": 1, "misses": 4}
    _frame_equal(fourth, first)
    assert view.find_frame(ts, APP, **KW) is not fourth
    assert tview.DataView.stats == {"hits": 2, "misses": 4}


def test_time_window_is_part_of_the_key(shared):
    ts, js, _, tmp = shared
    view = tview.DataView(str(tmp / "view"))
    w = dict(KW, start_time=T0 + dt.timedelta(seconds=50),
             until_time=T0 + dt.timedelta(seconds=120))
    got = view.find_frame(ts, APP, **w)
    _frame_equal(got, jview.DataView(str(tmp / "jview")).find_frame(js, APP, **w))
    assert 0 < len(got) < len(view.find_frame(ts, APP, **KW))
    assert len(_files(tmp / "view")) == 2


def test_frames_and_files_match_jax(shared):
    ts, js, app_id, tmp = shared
    vdir = tmp / "view"
    jframe = jview.DataView(str(vdir)).find_frame(js, APP, **KW)
    [jname] = _files(vdir)
    tview.DataView.stats.update(hits=0, misses=0)
    tframe = tview.DataView(str(vdir)).find_frame(ts, APP, **KW)
    assert tview.DataView.stats == {"hits": 1, "misses": 0}  # the JAX file
    _frame_equal(tframe, jframe)
    # the port's own file reads in the JAX package
    other = tmp / "other"
    tview.DataView(str(other)).find_frame(ts, APP, **KW)
    assert _files(other) == [jname]
    jview.DataView.stats.update(hits=0, misses=0)
    _frame_equal(jview.DataView(str(other)).find_frame(js, APP, **KW), tframe)
    assert jview.DataView.stats == {"hits": 1, "misses": 0}


def test_unreadable_file_is_read_again(shared):
    ts, _, _, tmp = shared
    vdir = tmp / "view"
    view = tview.DataView(str(vdir))
    want = view.find_frame(ts, APP, **KW)
    [name] = _files(vdir)
    (vdir / name).write_bytes(b"not an npz")
    tview.DataView.stats.update(hits=0, misses=0)
    _frame_equal(view.find_frame(ts, APP, **KW), want)
    assert tview.DataView.stats == {"hits": 0, "misses": 1}
    _frame_equal(view.find_frame(ts, APP, **KW), want)
    assert tview.DataView.stats == {"hits": 1, "misses": 1}


def test_default_view_dir_follows_the_base_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    assert tview.default_view_dir() == jview.default_view_dir() == str(
        tmp_path / "base" / "view")
    assert tview.DataView().view_dir == str(tmp_path / "base" / "view")
    monkeypatch.delenv("PIO_FS_BASEDIR")
    assert tview.default_view_dir() == os.path.expanduser("~/.pio_store/view")


@pytest.mark.parametrize("options", [
    {"use_data_view": True},
    {"read_item_categories": True},
    {"use_data_view": True, "read_item_categories": True},
])
def test_recommendation_training_data_matches_jax(shared, options):
    ts, js, _, tmp = shared
    opts = dict(options)
    if opts.get("use_data_view"):
        opts["data_view_dir"] = str(tmp / "view")
    tds = teng.RecommendationDataSource(teng.DataSourceParams(APP, **opts))
    jds = jeng.RecommendationDataSource(jeng.DataSourceParams(
        APP, **dict(opts, data_view_dir=str(tmp / "jview")) if opts.get("use_data_view")
        else opts))
    tview.DataView.stats.update(hits=0, misses=0)
    want = jds.read_training(JContext(storage=js))
    for n in range(2):
        got = tds.read_training(RuntimeContext(storage=ts, device="cpu"))
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype
        assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
        assert got.item_vocab.to_dict() == want.item_vocab.to_dict()
        assert got.item_categories == want.item_categories
        if options.get("read_item_categories"):
            cats = got.item_categories
            assert cats is not None and frozenset() in cats
            assert cats[got.item_vocab.get("i1")] == frozenset()  # unset
            assert cats[got.item_vocab.get("i0")] == {"c0", "g0"}
        else:
            assert got.item_categories is None
    want_stats = {"hits": 1, "misses": 1} if options.get("use_data_view") else {
        "hits": 0, "misses": 0}
    assert tview.DataView.stats == want_stats


def test_recommendation_read_eval_through_the_view_matches_jax(shared):
    ts, js, _, tmp = shared
    tds = teng.RecommendationDataSource(teng.DataSourceParams(
        APP, eval_k=3, use_data_view=True, read_item_categories=True,
        data_view_dir=str(tmp / "view")))
    jds = jeng.RecommendationDataSource(jeng.DataSourceParams(
        APP, eval_k=3, use_data_view=True, read_item_categories=True,
        data_view_dir=str(tmp / "jview")))
    got = tds.read_eval(RuntimeContext(storage=ts, device="cpu"))
    want = jds.read_eval(JContext(storage=js))
    assert len(got) == len(want) == 3
    for (gtd, ginfo, gqa), (wtd, winfo, wqa) in zip(got, want):
        assert ginfo.fold == winfo.fold
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(gtd, f), getattr(wtd, f))
        assert gtd.item_categories == wtd.item_categories
        assert [(q.user, q.num, a.items) for q, a in gqa] == [
            (q.user, q.num, a.items) for q, a in wqa]
