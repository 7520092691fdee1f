"""The port's online fold-in modules on the CPU, against the JAX package.

- Revision tail: ``find_since`` / ``latest_revision`` of the port's
  memory and sqlite stores equal the JAX stores' on the same events
  (explicit ids and times): revisions, ids and order, across cursors,
  limits (None, 0, 1, 3, -1) and two channels, and after a sqlite
  reopen. Exact.
- Cursor records: a ``LifecycleRecordStore`` record that either package
  appends to a shared sqlite file folds the same in the other. Exact.
- ``fold_in_rows``: within rtol 1e-4, atol 1e-5 of the JAX function,
  implicit and explicit, ragged edges, rows with no edges (exactly 0)
  and row counts across the bucket edges (1, 8, 9, 65).
- ``serving_publish_rows``: bit-equal to ``stage_serving`` of the same
  factors in f32, bf16 and int8, without growth, within the pad
  headroom and past ``ITEM_PAD``; the old state's tensors keep their
  bytes (copy-on-write); its live rows equal the JAX function's.
- Drift: ``score_drift`` and ``DriftGuard`` equal the JAX package's.
- ``ALSFoldIn.apply`` / ``apply_pending`` over the same events in both
  packages' memory stores from the same factors: the same vocabularies
  in the same order, the same stats and carry, rows within the
  ``fold_in_rows`` bar.
- The consumer's mechanics (the JAX tests/test_online.py:366-527 cases
  on the port): exact resume, ``from_latest``, crash before the persist
  replayed once, compaction, pause and resume; ``status()`` reads its
  tick and drift figures from the metrics registry; a drift pause raises
  the monitor alert ``online_drift_pause/<cursor>`` with the JAX
  consumer's payload and ``resume`` resolves it.
- ``find_edges`` (the fold's one-call history read) equals per-id reads
  of the JAX stores, and the sqlite store's one-step JSON reads
  (``find_edges``, ``find_since``) equal its row-by-row reads field for
  field on ids, properties and numbers a JSON round trip could bend.
- The metrics registry's quantiles equal the JAX registry's.
"""

import dataclasses
import datetime as dt
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.data.storage.base import EventQuery as JEventQuery  # noqa: E402
from predictionio_tpu.data.storage.memory import MemoryEventStore as JMemory  # noqa: E402
from predictionio_tpu.data.storage.registry import (  # noqa: E402
    SourceConfig as JSourceConfig,
    Storage as JStorage,
    StorageConfig as JStorageConfig,
)
from predictionio_tpu.data.storage.sqlite import SqliteEventStore as JSqlite  # noqa: E402
from predictionio_tpu.data.store.bimap import BiMap as JBiMap  # noqa: E402
from predictionio_tpu.deploy.registry import LifecycleRecordStore as JRecords  # noqa: E402
from predictionio_tpu.engines.recommendation import engine as jeng  # noqa: E402
from predictionio_tpu.models import als as jals  # noqa: E402
from predictionio_tpu.obs.registry import MetricsRegistry as JMetrics  # noqa: E402
from predictionio_tpu.online import drift as jdrift  # noqa: E402
from predictionio_tpu.online import foldin as jfoldin  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage import base  # noqa: E402
from predictionio_tpu_torch.data.storage.memory import MemoryEventStore  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.data.storage.sqlite import SqliteEventStore  # noqa: E402
from predictionio_tpu_torch.data.store.bimap import BiMap  # noqa: E402
from predictionio_tpu_torch.deploy.registry import (  # noqa: E402
    LIFECYCLE_APP_ID,
    LifecycleRecordStore,
)
from predictionio_tpu_torch.engines.recommendation import engine as teng  # noqa: E402
from predictionio_tpu_torch.models import als as tals  # noqa: E402
from predictionio_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from predictionio_tpu_torch.online import consumer as consumer_mod  # noqa: E402
from predictionio_tpu_torch.online import (  # noqa: E402
    CURSOR_ENTITY,
    ALSFoldIn,
    DriftGuard,
    FoldInConfig,
    OnlineConsumer,
    OnlineConsumerConfig,
    score_drift,
)
from predictionio_tpu_torch.ops import recommend as rec  # noqa: E402

T0 = dt.datetime(2024, 6, 1, tzinfo=dt.timezone.utc)
FOLD_RTOL, FOLD_ATOL = 1e-4, 1e-5


def _rate(make, u, i, rating=5.0, n=0, name="rate"):
    return make(event=name, entity_type="user", entity_id=u,
                target_entity_type="item", target_entity_id=i,
                properties={"rating": rating} if name == "rate" else {},
                event_time=T0 + dt.timedelta(seconds=n), creation_time=T0,
                event_id=f"e{n:06d}")


# ---------------------------------------------------------------------------
# revision tail
# ---------------------------------------------------------------------------


def _stores(kind, tmp_path):
    if kind == "memory":
        return MemoryEventStore(), JMemory()
    return (SqliteEventStore({"PATH": str(tmp_path / "port.db")}),
            JSqlite({"PATH": str(tmp_path / "jax.db")}))


def _fill(store, make):
    """Six events in the default channel (one a batch of two, one an
    overwrite by id, one deleted) and three in channel 5."""
    store.init_app(1)
    store.init_app(1, 5)
    for n in range(3):
        store.insert(_rate(make, f"u{n}", f"i{n}", n=n), 1)
    store.insert_batch([_rate(make, "u9", "i1", n=3), _rate(make, "u9", "i2", n=4)], 1)
    store.insert(_rate(make, "u0", "i0", 2.0, n=0), 1)  # overwrites e000000
    store.delete("e000001", 1)
    store.insert_batch([_rate(make, "c1", "i1", n=10 + k) for k in range(3)], 1, 5)


def _tail(evs):
    return [(e.revision, e.event_id, e.entity_id, e.event_time) for e in evs]


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_find_since_and_latest_revision_match_the_jax_stores(kind, tmp_path):
    port, jax_store = _stores(kind, tmp_path)
    _fill(port, Event)
    _fill(jax_store, JEvent)
    for channel in (None, 5):
        assert port.latest_revision(1, channel) == jax_store.latest_revision(1, channel)
        for after in (0, 2, 4, 6, 99):
            for limit in (None, 0, 1, 3, -1):
                got = port.find_since(1, after, channel_id=channel, limit=limit)
                want = jax_store.find_since(1, after, channel_id=channel, limit=limit)
                assert _tail(got) == _tail(want), (channel, after, limit)
    assert port.latest_revision(1) == 6 and port.latest_revision(1, 5) == 3
    # the default scan gives what the override gives
    assert _tail(base.EventStore.find_since(port, 1, 2, limit=2)) == _tail(
        port.find_since(1, 2, limit=2))
    assert base.EventStore.latest_revision(port, 1) == 6
    assert port.revision_streams() == [("0", port, None)]
    # a shard keeps that partition's events, as the JAX stores keep them
    for n in (2, 3):
        for i in range(n):
            for after, limit in ((0, None), (2, 1), (0, 2)):
                got = port.find_since(1, after, limit=limit, shard=(i, n))
                want = jax_store.find_since(1, after, limit=limit, shard=(i, n))
                assert _tail(got) == _tail(want), (i, n, after, limit)
                assert all(base.shard_of(e.entity_id, n) == i for e in got)
    assert _tail(base.EventStore.find_since(port, 1, 0, shard=(1, 2))) == _tail(
        port.find_since(1, 0, shard=(1, 2)))


def test_sqlite_tail_survives_a_reopen_and_reads_across_packages(tmp_path):
    path = str(tmp_path / "reopen.db")
    s1 = SqliteEventStore({"PATH": path})
    s1.init_app(2)
    s1.insert_batch([_rate(Event, "u1", "i1", n=0), _rate(Event, "u2", "i1", n=1)], 2)
    s2 = SqliteEventStore({"PATH": path})
    assert s2.latest_revision(2) == 2
    s2.insert(_rate(Event, "u3", "i2", n=2), 2)
    assert [e.revision for e in s2.find_since(2, 2)] == [3]
    j = JSqlite({"PATH": path})
    assert _tail(j.find_since(2, 0)) == _tail(s2.find_since(2, 0))
    assert j.latest_revision(2) == 3


def _odd_events(make):
    """Events whose fields a JSON round trip could bend: float ratings
    with 17 significant digits, a huge int, a string and a bool rating,
    unicode and quotes in ids, tags, a pr id, an untargeted `$set`, a
    `buy`, a `view` of another name, a rating by an `admin`, equal event
    times (the id orders them), and a second channel."""
    odd = [0.1 + 0.2, 1e-300, 2**62 + 1, "4", True, 3.0]
    out = []
    for n in range(24):
        u, i = f"u{n % 5}é\"", f"i{n % 4}'π"
        props = {"rating": odd[n % len(odd)], "note": "a\nb"}
        out.append(make(event=("rate", "buy", "view")[n % 3], entity_type="user",
                        entity_id=u, target_entity_type="item", target_entity_id=i,
                        properties=props, event_time=T0 + dt.timedelta(seconds=n // 3),
                        tags=("t1", "t2") if n % 2 else (), pr_id="p" if n % 7 == 0 else None,
                        creation_time=T0, event_id=f"e{23 - n:06d}"))
    out.append(make(event="$set", entity_type="user", entity_id="u1é\"",
                    properties={"a": 1}, event_time=T0, creation_time=T0, event_id="s1"))
    out.append(make(event="rate", entity_type="admin", entity_id="u1é\"",
                    target_entity_type="item", target_entity_id="i1'π",
                    properties={"rating": 5}, event_time=T0, creation_time=T0,
                    event_id="a1"))
    return out


def _edges_of(store, by, ids, channel=None):
    """What `find_edges` must return, from per-id `find`s of any store."""
    out = []
    for i in ids:
        out.extend((e.entity_id, e.target_entity_id, e.event, dict(e.properties))
                   for e in store.find(_query(store, i, by, channel)))
    return out


def _query(store, i, by, channel):
    q = (JEventQuery if type(store).__module__.startswith("predictionio_tpu.") else
         base.EventQuery)
    return q(app_id=1, channel_id=channel, event_names=["rate", "buy"],
             entity_type="user", target_entity_type="item",
             **({"target_entity_id": i} if by == "target" else {"entity_id": i}))


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
@pytest.mark.parametrize("by", ["entity", "target"])
def test_find_edges_match_the_jax_stores_per_id_reads(kind, by, tmp_path):
    port, jax_store = _stores(kind, tmp_path)
    for store, make in ((port, Event), (jax_store, JEvent)):
        store.insert_batch(_odd_events(make), 1)
        store.insert_batch([_rate(make, "u1é\"", "i1'π", n=50)], 1, 3)
    ids = ([f"u{n}é\"" for n in (3, 0, 4, 9, 1)] if by == "entity"
           else [f"i{n}'π" for n in (2, 7, 0, 1)])
    kw = {"target_ids" if by == "target" else "entity_ids": ids + ids[:1]}
    got = port.find_edges(1, "user", "item", ("rate", "buy"), **kw)
    assert got == _edges_of(jax_store, by, ids) == _edges_of(port, by, ids)
    assert got and all(u.startswith("u") for u, *_ in got)
    # the default (one find an id) gives what the override gives
    assert base.EventStore.find_edges(port, 1, "user", "item", ("rate", "buy"), **kw) == got
    assert port.find_edges(1, "user", "item", ("rate",), channel_id=3, **kw) == (
        [("u1é\"", "i1'π", "rate", {"rating": 5.0})])
    with pytest.raises(ValueError, match="entity_ids or target_ids"):
        port.find_edges(1, "user", "item", ("rate",))


def test_sqlite_one_step_tail_equals_the_row_by_row_read(tmp_path):
    store = SqliteEventStore({"PATH": str(tmp_path / "odd.db")})
    store.insert_batch(_odd_events(Event), 1)
    store.insert(_rate(Event, "u0é\"", "i0'π", 2.5, n=99), 1)
    for after, limit in ((0, None), (3, 5), (20, -1), (26, None), (0, 0)):
        got = store.find_since(1, after, limit=limit)
        want = base.EventStore.find_since(store, 1, after, limit=limit)
        assert got == want and [dataclasses.astuple(e) for e in got] == [
            dataclasses.astuple(e) for e in want], (after, limit)
    assert [e.revision for e in store.find_since(1, 0)] == list(range(1, 28))


# ---------------------------------------------------------------------------
# lifecycle records across packages
# ---------------------------------------------------------------------------


def _shared_storages(path):
    cfg = {"sources": {"DB": ("DB", "sqlite", {"PATH": str(path)})},
           "repositories": {"METADATA": "DB", "EVENTDATA": "DB", "MODELDATA": "DB"}}
    port = Storage(StorageConfig(
        sources={k: SourceConfig(*v) for k, v in cfg["sources"].items()},
        repositories=cfg["repositories"]))
    jax_storage = JStorage(JStorageConfig(
        sources={k: JSourceConfig(*v) for k, v in cfg["sources"].items()},
        repositories=cfg["repositories"]))
    return port, jax_storage


def test_cursor_records_fold_across_packages(tmp_path):
    port, jax_storage = _shared_storages(tmp_path / "records.db")
    jrec, trec = JRecords(jax_storage), LifecycleRecordStore(port)
    cid = "online/7/server"
    jrec.append(CURSOR_ENTITY, cid, {"cursor": {"0": 5}, "events_consumed": 5,
                                     "ticks": 1})
    assert trec.fold(CURSOR_ENTITY, cid) == jrec.fold(CURSOR_ENTITY, cid)
    assert trec.fold(CURSOR_ENTITY)[cid]["cursor"] == {"0": 5}
    time.sleep(0.005)  # sqlite keeps event times in ms: a later tick
    trec.append(CURSOR_ENTITY, cid, {"cursor": {"0": 9}, "events_consumed": 9,
                                     "ticks": 2})
    want = {cid: {"cursor": {"0": 9}, "events_consumed": 9, "ticks": 2}}
    assert jrec.fold(CURSOR_ENTITY) == trec.fold(CURSOR_ENTITY) == want
    time.sleep(0.005)
    assert trec.compact(CURSOR_ENTITY, cid, min_age_s=0.0) == 2
    assert jrec.fold(CURSOR_ENTITY) == want
    store = port.get_events()
    assert len(list(store.find(base.EventQuery(app_id=LIFECYCLE_APP_ID)))) == 1


# ---------------------------------------------------------------------------
# fold_in_rows
# ---------------------------------------------------------------------------


def _edges(rng, n_rows, n_fixed, min_edges, max_edges, empty=()):
    out = []
    for r in range(n_rows):
        if r in empty:
            out.append([])
            continue
        cols = rng.choice(n_fixed, rng.integers(min_edges, max_edges + 1), replace=False)
        out.append([(int(c), float(rng.integers(-2, 6))) for c in cols])
    return out


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "explicit"])
@pytest.mark.parametrize("n_rows", [1, 8, 9, 65])
def test_fold_in_rows_matches_jax(implicit, n_rows):
    rng = np.random.default_rng(100 + n_rows)
    k, n_fixed = 6, 70
    fixed = rng.standard_normal((n_fixed, k)).astype(np.float32) / np.sqrt(k)
    empty = {0} if n_rows > 1 else set()
    # ragged, 6-20 edges a row: at least the rank, as a user with a
    # handful of ratings has; fewer leaves an explicit system at
    # lambda * deg ~ 0.05 so ill-conditioned that f32 CG rounding in
    # another order moves the last digits past the bar
    edges = _edges(rng, n_rows, n_fixed, k, 20, empty)
    kw = dict(rank=k, implicit_prefs=implicit, lambda_=0.05, alpha=2.0,
              cg_iterations=4)  # below the rank (see _fold_setup)
    got = tals.fold_in_rows(fixed, edges, tals.ALSParams(**kw), device="cpu")
    want = jals.fold_in_rows(fixed, edges, jals.ALSParams(**kw))
    assert got.shape == (n_rows, k) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=FOLD_RTOL, atol=FOLD_ATOL)
    for r in empty:
        assert not got[r].any()  # exactly zero
    # a tensor on the device as the fixed side gives the same rows
    np.testing.assert_array_equal(
        tals.fold_in_rows(torch.from_numpy(fixed), edges, tals.ALSParams(**kw),
                          device="cpu"), got)


def test_fold_in_rows_empty_and_edge_bucket():
    params = tals.ALSParams(rank=3)
    assert tals.fold_in_rows(np.ones((4, 3), np.float32), [], params).shape == (0, 3)
    out = tals.fold_in_rows(np.ones((4, 3), np.float32), [[]], params, device="cpu")
    np.testing.assert_array_equal(out, np.zeros((1, 3), np.float32))
    for n in (0, 1, 7, 8, 9, 16, 17, 100):
        assert tals._fold_edge_bucket(n) == jals._fold_edge_bucket(n)


# ---------------------------------------------------------------------------
# serving_publish_rows
# ---------------------------------------------------------------------------


def _factors(rng, n_users, n_items, k, mod):
    uf = rng.standard_normal((n_users, k)).astype(np.float32)
    itf = rng.standard_normal((n_items, k)).astype(np.float32)
    vocab = lambda p, n: {f"{p}{i}": i for i in range(n)}  # noqa: E731
    params = dict(rank=k)
    return mod.ALSFactors(user_factors=uf, item_factors=itf,
                          user_vocab=(BiMap if mod is tals else JBiMap)(vocab("u", n_users)),
                          item_vocab=(BiMap if mod is tals else JBiMap)(vocab("i", n_items)),
                          params=mod.ALSParams(**params))


def _snapshot(sv):
    return {f: (getattr(sv, f).clone() if getattr(sv, f) is not None else None)
            for f in ("users", "items", "user_scale", "item_scale", "item_inv_norm")}


def _assert_state_equal(got, want):
    assert got.n_items == want.n_items and got.dtype == want.dtype
    for f in ("users", "items", "user_scale", "item_scale", "item_inv_norm"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert torch.equal(a, b), f


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("growth", [(0, 0), (5, 40), (7, 150)],
                         ids=["none", "within-pad", "past-pad"])
def test_publish_rows_bit_equal_to_a_restage(dtype, growth):
    rng = np.random.default_rng(7)
    k, n_users, n_items = 8, 30, 200  # items pad to 256
    extra_u, extra_i = growth
    old = _factors(rng, n_users, n_items, k, tals)
    old_sv = tals.stage_serving(old, dtype, device="cpu")
    before = _snapshot(old_sv)
    ptrs = {f: getattr(old_sv, f).data_ptr() for f, t in before.items() if t is not None}
    # dirty: 6 old users and 9 old items re-solved, every new row written
    urows = np.concatenate([rng.choice(n_users, 6, replace=False),
                            np.arange(n_users, n_users + extra_u)])
    irows = np.concatenate([rng.choice(n_items, 9, replace=False),
                            np.arange(n_items, n_items + extra_i)])
    uvals = rng.standard_normal((len(urows), k)).astype(np.float32)
    ivals = rng.standard_normal((len(irows), k)).astype(np.float32)
    irows[-1:] = irows[-1]  # a zero row among them
    ivals[-1] = 0.0
    uf = np.concatenate([old.user_factors, np.zeros((extra_u, k), np.float32)])
    itf = np.concatenate([old.item_factors, np.zeros((extra_i, k), np.float32)])
    uf[urows], itf[irows] = uvals, ivals
    new = dataclasses.replace(old, user_factors=uf, item_factors=itf)
    got = tals.serving_publish_rows(old_sv, urows, uvals, irows, ivals,
                                    n_users=len(uf), n_items=len(itf))
    _assert_state_equal(got, tals.stage_serving(new, dtype, device="cpu"))
    assert got.items.shape[0] == rec.pad_items(len(itf))
    # copy-on-write: the old state's tensors keep their bytes
    for f, t in before.items():
        if t is not None:
            assert torch.equal(getattr(old_sv, f), t), f
            assert getattr(old_sv, f).data_ptr() == ptrs[f]
            assert getattr(got, f).data_ptr() != ptrs[f], f

    # the live rows equal the JAX package's publish of the same rows
    jold = _factors(np.random.default_rng(7), n_users, n_items, k, jals)
    jsv = jals.serving_publish_rows(
        jals.stage_serving(jold, dtype), urows, uvals, irows, ivals,
        n_users=len(uf), n_items=len(itf))
    n_i = len(itf)

    def host(t):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    np.testing.assert_array_equal(host(got.users), np.asarray(jsv.users, np.float32)
                                  if dtype == "bf16" else np.asarray(jsv.users))
    np.testing.assert_array_equal(host(got.items)[:n_i], np.asarray(
        jsv.items, np.float32 if dtype == "bf16" else None)[:n_i])
    np.testing.assert_array_equal(got.item_inv_norm.numpy()[:, :n_i],
                                  np.asarray(jsv.item_inv_norm)[:, :n_i])
    if dtype == "int8":
        np.testing.assert_array_equal(got.user_scale.numpy(), np.asarray(jsv.user_scale))
        np.testing.assert_array_equal(got.item_scale.numpy()[:, :n_i],
                                      np.asarray(jsv.item_scale)[:, :n_i])


def test_publish_growth_without_rows_and_pad_fills():
    """Growth with no dirty row of a side takes `_stage_arrays`' fills
    (the JAX package zero-pads item_scale and item_inv_norm)."""
    rng = np.random.default_rng(3)
    sv = tals.stage_serving(_factors(rng, 4, 120, 4, tals), "int8", device="cpu")
    got = tals.serving_publish_rows(sv, n_users=6, n_items=130)
    assert got.users.shape == (6, 4) and not got.users[4:].any()
    assert torch.equal(got.user_scale[4:], torch.ones(2, 1))
    assert got.items.shape[0] == 256 and got.n_items == 130
    assert torch.equal(got.item_scale[0, 128:], torch.ones(128))
    assert not got.item_inv_norm[0, 128:].any()
    assert tals.serving_publish_rows(sv) .items is sv.items  # nothing to write


def test_adopt_serving_publishes_and_refuses_unattributed_growth():
    rng = np.random.default_rng(5)
    f = _factors(rng, 10, 20, 4, tals)
    old = teng.ALSModel(f, serve_dtype="int8", device="cpu")
    sv = old.serving_state()
    uf = np.concatenate([f.user_factors, rng.standard_normal((1, 4)).astype(np.float32)])
    new_f = dataclasses.replace(f, user_factors=uf)
    m = teng.ALSModel(new_f, serve_dtype="int8", device="cpu")
    m.adopt_serving(sv, dirty_users=([10], uf[10:]))
    _assert_state_equal(m._serving_state, tals.stage_serving(new_f, "int8", device="cpu"))
    m2 = teng.ALSModel(new_f, serve_dtype="int8", device="cpu")
    m2.adopt_serving(sv)  # users grew with no rows: left to a lazy restage
    assert m2._serving_state is None


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------


def _drift_factors(mod, seed=0, scale=1.0, n_users=40):
    rng = np.random.RandomState(seed)
    return mod.ALSFactors(
        user_factors=rng.standard_normal((n_users, 4)).astype(np.float32) * scale,
        item_factors=rng.standard_normal((60, 4)).astype(np.float32),
        user_vocab=(BiMap if mod is tals else JBiMap)({}),
        item_vocab=(BiMap if mod is tals else JBiMap)({}))


@pytest.mark.parametrize("case", ["same", "scaled", "reseeded", "grown"])
def test_score_drift_and_guard_match_jax(case):
    base_t, base_j = _drift_factors(tals, 3), _drift_factors(jals, 3)
    other = {"same": dict(seed=3), "scaled": dict(seed=3, scale=40.0),
             "reseeded": dict(seed=4), "grown": dict(seed=3, n_users=45)}[case]
    cur_t, cur_j = _drift_factors(tals, **other), _drift_factors(jals, **other)
    got = score_drift(base_t, cur_t, sample_users=30, sample_items=50, seed=2)
    assert got == jdrift.score_drift(base_j, cur_j, sample_users=30,
                                     sample_items=50, seed=2)
    guard, jguard = DriftGuard(threshold=1.0), jdrift.DriftGuard(threshold=1.0)
    assert guard.check(cur_t) == 0.0 and not guard.has_baseline
    guard.rebase(base_t)
    jguard.rebase(base_j)
    assert guard.breached(cur_t) == jguard.breached(cur_j)
    assert guard.last_drift == jguard.last_drift
    if case == "scaled":
        assert guard.last_drift > 1.0


# ---------------------------------------------------------------------------
# ALSFoldIn.apply against the JAX fold
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Runtime:
    models: list
    instance: object = None


def _fold_setup(mod_als, mod_eng, make, store, rows, k=5):
    rng = np.random.default_rng(11)
    n_users, n_items = 12, 15
    bimap = BiMap if mod_als is tals else JBiMap
    factors = mod_als.ALSFactors(
        user_factors=rng.standard_normal((n_users, k)).astype(np.float32) / 2,
        item_factors=rng.standard_normal((n_items, k)).astype(np.float32) / 2,
        user_vocab=bimap({f"u{i}": i for i in range(n_users)}),
        item_vocab=bimap({f"i{i}": i for i in range(n_items)}),
        # the template's 3 CG steps: at as many steps as the rank the
        # last one runs at the f32 noise floor in both packages, where
        # the freeze test falls either way
        params=mod_als.ALSParams(rank=k, lambda_=0.05, alpha=1.5, cg_iterations=3))
    model = (mod_eng.ALSModel(factors, device="cpu") if mod_eng is teng
             else mod_eng.ALSModel(factors))
    store.insert_batch([_rate(make, *r[:2], r[2], n=n, name=r[3])
                        for n, r in enumerate(rows)], 1)
    return _Runtime([model])


def _fold_rows():
    """History of old users, then a tick: old users rate old and new
    items, new users rate old items (one item twice: summed), a buy."""
    rows = [(f"u{u}", f"i{(u * 3 + j) % 15}", 4.0, "rate") for u in range(6) for j in range(3)]
    tick = [("u1", "new0", 5.0, "rate"), ("nu0", "i2", 3.0, "rate"),
            ("u2", "new1", 2.0, "rate"), ("nu1", "i4", 5.0, "rate"),
            ("nu1", "i4", 1.0, "rate"), ("nu0", "new2", 4.0, "rate"),
            ("u3", "new3", 1.0, "buy"), ("u4", "new4", 5.0, "rate"),
            ("nu2", "i7", 4.0, "rate"), ("u5", "i9", 1.0, "rate")]
    return rows, tick


def _relevant_events(store, first):
    return [e for e in store.find(base.EventQuery(app_id=1)) if e.event_id >= first]


def _compare_folds(got, want):
    (t_rt, t_model, t_stats), (j_rt, j_model, j_stats) = got, want
    assert list(t_model.factors.user_vocab.items()) == list(j_model.factors.user_vocab.items())
    assert list(t_model.factors.item_vocab.items()) == list(j_model.factors.item_vocab.items())
    assert t_stats.to_dict() == j_stats.to_dict()
    assert t_stats.pending_after == j_stats.pending_after
    np.testing.assert_allclose(t_model.factors.user_factors, j_model.factors.user_factors,
                               rtol=FOLD_RTOL, atol=FOLD_ATOL)
    np.testing.assert_allclose(t_model.factors.item_factors, j_model.factors.item_factors,
                               rtol=FOLD_RTOL, atol=FOLD_ATOL)
    assert t_rt.models == [t_model]


def test_fold_apply_and_pending_match_jax():
    rows, tick = _fold_rows()
    t_store, j_store = MemoryEventStore(), JMemory()
    t_rt = _fold_setup(tals, teng, Event, t_store, rows + tick)
    j_rt = _fold_setup(jals, jeng, JEvent, j_store, rows + tick)
    t_rt.models[0].serving_state()  # staged: the fold publishes rows into it
    first = f"e{len(rows):06d}"
    cfg = dict(max_items_per_tick=2, grow_chunk=4)
    t_fold, j_fold = ALSFoldIn(FoldInConfig(**cfg)), jfoldin.ALSFoldIn(jfoldin.FoldInConfig(**cfg))

    class _S:  # storage: the event store only
        def __init__(self, store):
            self.store = store

        def get_events(self):
            return self.store

    got = t_fold.apply(_S(t_store), 1, None, t_rt, _relevant_events(t_store, first))
    want = j_fold.apply(_S(j_store), 1, None, j_rt, _relevant_events(j_store, first))
    _compare_folds(got, want)
    assert got[2].users_added == 3 and got[2].items_added == 5
    # first seen in the dirty users' histories: new0, new2, new1, ...
    assert got[2].pending_after == ["new1", "new3", "new4"]
    old_sv = t_rt.models[0]._serving_state
    assert got[1]._serving_state is not old_sv
    for rt, fold, res in ((t_rt, t_fold, got), (j_rt, j_fold, want)):
        fold.commit_pending(res[2].pending_after)
    # the carry drains over two item-only passes, the same in both
    for _ in range(2):
        got = t_fold.apply_pending(_S(t_store), 1, None, got[0])
        want = j_fold.apply_pending(_S(j_store), 1, None, want[0])
        _compare_folds(got, want)
        t_fold.commit_pending(got[2].pending_after)
        j_fold.commit_pending(want[2].pending_after)
    assert t_fold.pending_items == [] and t_fold.apply_pending(_S(t_store), 1, None,
                                                                got[0]) is None
    # every live row published: the carried state equals a restage
    _assert_state_equal(got[1]._serving_state,
                        tals.stage_serving(got[1].factors, device="cpu"))


def test_fold_ignores_irrelevant_and_needs_a_model():
    store = MemoryEventStore()
    fold = ALSFoldIn()
    evs = [Event(event="$set", entity_type="user", entity_id="u1",
                 properties={"plan": "pro"})]
    assert fold.dirty_entities(evs) == ([], [])
    assert fold.apply(None, 1, None, _Runtime([]), evs) is None
    store.insert(_rate(Event, "u1", "i1"), 1)

    class _S:
        def get_events(self):
            return store

    assert fold.apply(_S(), 1, None, _Runtime([object()]),
                      store.find_since(1, 0)) is None


# ---------------------------------------------------------------------------
# the consumer's mechanics (storage only: a runtime with no model)
# ---------------------------------------------------------------------------


class _StubHost:
    scope = "server"

    def __init__(self):
        self.runtime = object()  # no model: events consume without folding

    def current(self):
        return self.runtime

    def swap(self, old, new):
        if self.runtime is old:
            self.runtime = new
            return True
        return False


def _mem_storage():
    return Storage(StorageConfig(
        sources={"M": SourceConfig("M", "memory", {})},
        repositories={"METADATA": "M", "EVENTDATA": "M", "MODELDATA": "M"}))


def _consumer(storage, **cfg):
    return OnlineConsumer(storage, _StubHost(), 1,
                          OnlineConsumerConfig(tick_s=9, **cfg),
                          metrics=MetricsRegistry())


def test_cursor_and_counters_resume_exactly():
    storage = _mem_storage()
    storage.get_events().insert_batch([_rate(Event, f"u{k}", "i1", n=k) for k in range(5)], 1)
    c1 = _consumer(storage)
    out = c1.tick()
    assert out["consumed"] == 5 and out["folded"] == 0
    assert c1.cursor == {"0": 5}
    c2 = _consumer(storage)
    assert c2.cursor == {"0": 5} and c2.counters["events_consumed"] == 5
    assert c2.tick() == {"idle": "no new events"}


def test_from_latest_skips_history():
    storage = _mem_storage()
    storage.get_events().insert_batch([_rate(Event, f"u{k}", "i1", n=k) for k in range(4)], 1)
    c = _consumer(storage, from_latest=True)
    assert c.cursor == {"0": 4}
    assert c.tick() == {"idle": "no new events"}


def test_crash_before_persist_replays_exactly_once():
    storage = _mem_storage()
    storage.get_events().insert_batch([_rate(Event, f"u{k}", "i1", n=k) for k in range(3)], 1)
    c1 = _consumer(storage)
    c1._crash_after_apply = True
    with pytest.raises(RuntimeError):
        c1.tick()
    assert c1.counters["events_consumed"] == 0
    c2 = _consumer(storage)
    assert c2.cursor == {}
    assert c2.tick()["consumed"] == 3
    assert c2.tick() == {"idle": "no new events"}
    assert c2.counters["events_consumed"] == 3


def test_cursor_record_compacts(monkeypatch):
    monkeypatch.setattr(consumer_mod, "COMPACT_EVERY", 4)
    storage = _mem_storage()
    store = storage.get_events()
    c = _consumer(storage)
    for k in range(8):
        store.insert(_rate(Event, f"u{k}", "i1", n=k), 1)
        c.tick()
    n_events = len(list(store.find(base.EventQuery(app_id=LIFECYCLE_APP_ID,
                                                   entity_type=CURSOR_ENTITY))))
    assert n_events <= 5  # 8 appends compacted twice
    rec = LifecycleRecordStore(storage).fold(CURSOR_ENTITY, c.cursor_id)[c.cursor_id]
    assert rec["events_consumed"] == 8 and rec["ticks"] == 8


def test_pause_blocks_tick_and_resume_clears():
    storage = _mem_storage()
    storage.get_events().insert(_rate(Event, "u1", "i1"), 1)
    c = _consumer(storage)
    c.pause("test pause")
    assert c.tick() == {"paused": "test pause"}
    assert c.counters["events_consumed"] == 0
    assert c.metrics.gauge("online_paused", "", ("scope",)).value(scope=c.cursor_id) == 1.0
    c.resume()
    assert c.tick()["consumed"] == 1
    assert c.status()["paused"] is None


def test_status_reads_the_tick_and_drift_figures_from_the_registry():
    storage = _mem_storage()
    store = storage.get_events()
    c = _consumer(storage)
    for k in range(3):
        store.insert(_rate(Event, f"u{k}", "i1", n=k), 1)
        c.tick()
    hist = c.metrics.histogram("online_fold_tick_seconds", "", ("scope",))
    st = c.status()
    assert st["ticks_timed"] == 3 == hist.count_of(scope=c.cursor_id)
    assert st["tick_seconds_p50"] == hist.quantile(0.5, scope=c.cursor_id) > 0
    assert st["tick_seconds_p99"] == hist.quantile(0.99, scope=c.cursor_id)
    c.metrics.gauge("online_drift_score", "", ("scope",)).set(0.25, scope=c.cursor_id)
    assert c.status()["drift"] == 0.25


def test_consumer_config_reads_the_online_env(monkeypatch):
    monkeypatch.setenv("PIO_ONLINE_TICK_S", "0.25")
    monkeypatch.setenv("PIO_ONLINE_DRIFT_THRESHOLD", "bad")
    monkeypatch.setenv("PIO_ONLINE_DRIFT_COOLDOWN_S", "3")
    cfg = OnlineConsumerConfig()
    assert (cfg.tick_s, cfg.drift_threshold, cfg.drift_cooldown_s) == (0.25, 1.0, 3.0)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_metrics_registry_matches_jax():
    rng = np.random.default_rng(4)
    values = rng.exponential(0.05, 300).tolist() + [100.0]
    t, j = MetricsRegistry(), JMetrics()
    th = t.histogram("h", "", ("side",))
    jh = j.histogram("h", "", ("side",))
    for v in values:
        th.observe(v, side="user")
        jh.observe(v, side="user")
    for q in (0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q, side="user") == jh.quantile(q, side="user")
    assert th.count_of(side="user") == jh.count_of(side="user") == 301
    assert th.sum_of(side="user") == jh.sum_of(side="user")
    c = t.counter("c", "", ("side",))
    c.inc(2, side="a")
    c.inc(3, side="b")
    assert c.total == 5 and c.value(side="a") == 2
    with pytest.raises(ValueError):
        c.inc(-1, side="a")
    with pytest.raises(ValueError):
        t.gauge("c")  # another type under the name
    with pytest.raises(ValueError):
        t.histogram("h", "", ("side",), buckets=(1.0,))
    g = t.gauge("g", "", ("scope",))
    assert g.value(scope="x") == 0.0
    g.set(2.5, scope="x")
    assert g.value(scope="x") == 2.5 and t.gauge("g", "", ("scope",)) is g
    with pytest.raises(ValueError):
        g.set(1.0, other="x")  # undeclared label


def test_drift_pause_raises_the_jax_alert_and_resume_resolves_it(monkeypatch):
    """A drift breach pauses fold-in and raises `online_drift_pause/<cursor>`
    on the process monitor with the JAX consumer's payload; `resume`
    resolves it (dropped from /alerts, its firing gauge removed)."""
    from types import SimpleNamespace

    from predictionio_tpu.obs.monitor import get_monitor as jax_monitor
    from predictionio_tpu.online import consumer as jconsumer
    from predictionio_tpu_torch.obs import get_default_registry
    from predictionio_tpu_torch.obs.monitor import get_monitor

    c = _consumer(_mem_storage(), drift_threshold=0.5)
    monkeypatch.setattr(c.guard, "check", lambda factors: 2.345678)
    out = c._guard_and_publish(object(), object(), SimpleNamespace(factors=None), None)
    assert out == {"paused": "score drift 2.346 > threshold 0.500", "drift": 2.345678}
    assert c.alert_name == f"online_drift_pause/{c.cursor_id}"
    payload = get_monitor().alerts_payload()
    row = next(r for r in payload["alerts"] if r["slo"] == c.alert_name)
    assert c.alert_name in payload["firing"]
    gauge = get_default_registry().gauge("alerts_firing", "", ("slo",))
    assert gauge.value(slo=c.alert_name) == 1.0
    # the JAX consumer's alert for the same figures, on the JAX monitor
    stub = SimpleNamespace(alert_name=c.alert_name, host=c.host, guard=c.guard,
                           cursor_id=c.cursor_id)
    jconsumer.OnlineConsumer._raise_drift_alert(stub, 2.345678)
    jmon = jax_monitor()
    try:
        jrow = next(r for r in jmon.alerts_payload()["alerts"] if r["slo"] == c.alert_name)
    finally:
        jmon.resolve_alert(c.alert_name)
    assert {k: v for k, v in row.items() if k != "since"} == {
        k: v for k, v in jrow.items() if k != "since"}
    assert row["drift"] == 2.3457 and row["state"] == "firing" and row["external"]
    c.resume()
    payload = get_monitor().alerts_payload()
    assert c.alert_name not in payload["firing"]
    assert all(r["slo"] != c.alert_name for r in payload["alerts"])
    assert gauge.value(slo=c.alert_name) == 0.0 and not gauge.remove(slo=c.alert_name)
