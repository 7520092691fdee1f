"""The port's multi-tenant serving units against the JAX package's.

- The 29 cases of the JAX package's tests/test_tenancy.py on the port:
  DRR fairness (FIFO with one stream, a hog against light tenants,
  weights, fractional weights, blocking gets, no banked deficit, depths),
  quotas (the bucket, qps, concurrency, post-paid device seconds,
  unlimited, a refresh that keeps a bucket), the model cache (hits,
  misses, reloads, LRU order, leases and pins that block eviction,
  `put_runtime`, load failures, prefetch on a version move), tenant
  records (CRUD, `set_quota`, validation), the bounded metric labels, a
  deleted tenant's cleanup, `warm_and_pin`, the resume latch and its
  give-up cap, and the cache gauges frozen on stop.
- Across the packages, on the same inputs: tenant records written by
  either package's `TenantStore` are read alike by the other's over one
  sqlite record store; seeded put/get sequences (weights, skip sets)
  give the same `FairQueue` pop order; seeded admit/release/charge
  sequences under one injected clock give the same `QuotaEnforcer`
  decisions, Retry-After values and snapshots; seeded acquire/release/
  pin/put sequences with the same measures give the same `ModelCache`
  eviction order, counters and entries (by count and by bytes); the
  `PIO_TENANT_*` knobs read alike; `tenant_slo_presets` and the
  monitor's union of operator specs and presets; `console tenants`
  prints what the JAX console prints.
- The port's own: a runtime's device bytes charge each torch storage
  once (views of one storage, grown slabs, a model's staged state);
  `serving_transient_bytes` reads the device profiler's report; a cache
  with no device names the card.
"""

import json
import os
import queue as stdlib_queue
import re
import threading
import time
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from predictionio_tpu.data.storage.registry import SourceConfig as JSourceConfig  # noqa: E402
from predictionio_tpu.data.storage.registry import Storage as JStorage  # noqa: E402
from predictionio_tpu.data.storage.registry import StorageConfig as JStorageConfig  # noqa: E402
from predictionio_tpu.obs.monitor import slo as jslo  # noqa: E402
from predictionio_tpu.tenancy import cache as jcache  # noqa: E402
from predictionio_tpu.tenancy import fair as jfair  # noqa: E402
from predictionio_tpu.tenancy import mux as jmux  # noqa: E402
from predictionio_tpu.tenancy import quota as jquota  # noqa: E402
from predictionio_tpu.tenancy import tenants as jtenants  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.obs.monitor import slo as tslo  # noqa: E402
from predictionio_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from predictionio_tpu_torch.tenancy import cache as tcache  # noqa: E402
from predictionio_tpu_torch.tenancy import fair as tfair  # noqa: E402
from predictionio_tpu_torch.tenancy import mux as tmux  # noqa: E402
from predictionio_tpu_torch.tenancy import quota as tquota  # noqa: E402
from predictionio_tpu_torch.tenancy import tenants as ttenants  # noqa: E402
from predictionio_tpu_torch.tenancy.cache import ModelCache, ModelLoadError  # noqa: E402
from predictionio_tpu_torch.tenancy.fair import FairQueue  # noqa: E402
from predictionio_tpu_torch.tenancy.quota import (  # noqa: E402
    QuotaEnforcer,
    QuotaExceeded,
    TokenBucket,
)
from predictionio_tpu_torch.tenancy.tenants import Tenant, TenantStore  # noqa: E402


def _sources(path):
    return ({"TESTSQL": ("sqlite", {"PATH": str(path / "pio.db")}),
             "TESTFS": ("localfs", {"PATH": str(path)})},
            {"METADATA": "TESTSQL", "EVENTDATA": "TESTSQL", "MODELDATA": "TESTFS"})


def _storage(path):
    path.mkdir(parents=True, exist_ok=True)
    sources, repos = _sources(path)
    return Storage(StorageConfig(
        sources={n: SourceConfig(n, t, s) for n, (t, s) in sources.items()},
        repositories=repos))


def _jax_storage(path):
    path.mkdir(parents=True, exist_ok=True)
    sources, repos = _sources(path)
    return JStorage(JStorageConfig(
        sources={n: JSourceConfig(n, t, s) for n, (t, s) in sources.items()},
        repositories=repos))


@pytest.fixture
def fresh_storage(tmp_path):
    """A port Storage over throwaway sqlite and localfs (the JAX test's
    fixture of the same name)."""
    return _storage(tmp_path / "store")


class _Item:
    def __init__(self, tenant, i):
        self.tenant = tenant
        self.i = i

    def __repr__(self):
        return f"{self.tenant}:{self.i}"


# ---------------------------------------------------------------------------
# deficit round robin (JAX: TestFairQueue)
# ---------------------------------------------------------------------------


class TestFairQueue:
    def test_fifo_degenerate_single_stream(self):
        q = FairQueue()
        for i in range(10):
            q.put(_Item(None, i))
        assert [q.get_nowait().i for i in range(10)] == list(range(10))
        with pytest.raises(stdlib_queue.Empty):
            q.get_nowait()

    def test_hog_cannot_starve_light_tenants(self):
        q = FairQueue()
        for i in range(100):
            q.put(_Item("hog", i))
        for i in range(5):
            q.put(_Item("a", i))
            q.put(_Item("b", i))
        drained = [q.get_nowait() for _ in range(110)]
        a_done = max(i for i, it in enumerate(drained) if it.tenant == "a")
        b_done = max(i for i, it in enumerate(drained) if it.tenant == "b")
        assert a_done < 16 and b_done < 16, (a_done, b_done)
        assert [it.i for it in drained if it.tenant == "hog"] == list(range(100))

    def test_weights_scale_share(self):
        weights = {"heavy": 3.0, "light": 1.0}
        q = FairQueue(weight_of=lambda t: weights.get(t, 1.0))
        for i in range(30):
            q.put(_Item("heavy", i))
            q.put(_Item("light", i))
        first = [q.get_nowait() for _ in range(24)]
        heavy = sum(1 for it in first if it.tenant == "heavy")
        assert heavy == pytest.approx(18, abs=2), heavy

    def test_fractional_weights_make_progress(self):
        q = FairQueue(weight_of=lambda t: 0.3)
        for i in range(9):
            q.put(_Item("a", i))
            q.put(_Item("b", i))
        drained = [q.get_nowait() for _ in range(18)]
        assert len(drained) == 18
        assert q.qsize() == 0 and q.empty()

    def test_blocking_get_timeout_and_wakeup(self):
        q = FairQueue()
        with pytest.raises(stdlib_queue.Empty):
            q.get(timeout=0.05)
        got = []
        waiting = threading.Event()

        def consumer():
            waiting.set()
            got.append(q.get(timeout=5.0))

        t = threading.Thread(target=consumer)
        t.start()
        waiting.wait(5.0)
        q.put(_Item("x", 1))
        t.join(timeout=5.0)
        assert got and got[0].i == 1

    def test_idle_tenant_banks_no_priority(self):
        q = FairQueue()
        q.put(_Item("a", 0))
        assert q.get_nowait().tenant == "a"
        for i in range(10):
            q.put(_Item("b", i))
        q.put(_Item("a", 1))
        drained = [q.get_nowait() for _ in range(11)]
        a_pos = next(i for i, it in enumerate(drained) if it.tenant == "a")
        assert a_pos <= 2

    def test_depths_snapshot(self):
        q = FairQueue()
        q.put(_Item("a", 0))
        q.put(_Item("a", 1))
        q.put(_Item(None, 0))
        assert q.depths() == {"a": 2, "(default)": 1}
        assert q.backlogged() == {"a", None}


# ---------------------------------------------------------------------------
# quotas (JAX: TestQuota)
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class TestQuota:
    def test_token_bucket_refill_and_debt(self):
        clock = _Clock()
        b = TokenBucket(rate_per_s=2.0, burst=4.0, now_fn=clock)
        assert b.try_take(4.0) == 0.0
        assert b.try_take(1.0) == pytest.approx(0.5)
        clock.t += 0.5
        assert b.try_take(1.0) == 0.0
        b.debit(3.0)
        assert b.balance() < 0

    def test_qps_quota_admits_and_rejects(self):
        clock = _Clock()
        q = QuotaEnforcer(now_fn=clock)
        q.configure(Tenant(id="t", engine_id="e", qps=2.0))
        q.admit("t")
        q.admit("t")
        with pytest.raises(QuotaExceeded) as ei:
            q.admit("t")
        assert ei.value.resource == "qps" and ei.value.retry_after_s > 0
        clock.t += 1.0
        q.admit("t")
        snap = q.snapshot("t")["t"]
        assert snap["admitted"] == 3 and snap["rejected"]["qps"] == 1

    def test_concurrency_quota_and_release(self):
        q = QuotaEnforcer(now_fn=_Clock())
        q.configure(Tenant(id="t", engine_id="e", max_concurrency=2))
        q.admit("t")
        q.admit("t")
        with pytest.raises(QuotaExceeded) as ei:
            q.admit("t")
        assert ei.value.resource == "concurrency"
        q.release("t")
        q.admit("t")

    def test_device_seconds_post_paid(self):
        clock = _Clock()
        q = QuotaEnforcer(now_fn=clock)
        q.configure(Tenant(id="t", engine_id="e", device_seconds_per_s=0.5))
        q.admit("t")
        q.charge_device("t", 10.0)
        with pytest.raises(QuotaExceeded) as ei:
            q.admit("t")
        assert ei.value.resource == "device_seconds"
        clock.t += 30.0
        q.admit("t")
        assert q.snapshot("t")["t"]["device_seconds"] == pytest.approx(10.0)

    def test_unlimited_tenant_never_rejected(self):
        q = QuotaEnforcer(now_fn=_Clock())
        q.configure(Tenant(id="t", engine_id="e"))
        for _ in range(100):
            q.admit("t")

    def test_reconfigure_keeps_bucket_state(self):
        clock = _Clock()
        q = QuotaEnforcer(now_fn=clock)
        t = Tenant(id="t", engine_id="e", qps=1.0)
        q.configure(t)
        q.admit("t")
        q.configure(t)
        with pytest.raises(QuotaExceeded):
            q.admit("t")


# ---------------------------------------------------------------------------
# the model cache (JAX: TestModelCache)
# ---------------------------------------------------------------------------


class _FakeCacheTenant:
    def __init__(self, tid):
        self.id = tid


def _make_cache(capacity, module=tcache):
    loads = []
    cache = module.ModelCache(storage=None, capacity=capacity,
                              build=lambda inst: f"runtime-{inst}")
    cache.resolve_version = (  # type: ignore[method-assign]
        lambda tenant: (loads.append(tenant.id) or (f"v-{tenant.id}", tenant.id)))
    return cache, loads


class TestModelCache:
    def test_hit_miss_reload_accounting(self):
        cache, loads = _make_cache(capacity=1)
        t1, t2 = _FakeCacheTenant("t1"), _FakeCacheTenant("t2")
        cache.release(cache.acquire(t1))
        cache.release(cache.acquire(t1))
        cache.release(cache.acquire(t2))
        cache.release(cache.acquire(t1))
        s = cache.stats()
        assert s["hits"] == 1 and s["misses"] == 3
        assert s["reloads"] == 1 and s["evictions"] == 2
        assert loads == ["t1", "t2", "t1"]

    def test_lru_eviction_order(self):
        cache, _ = _make_cache(capacity=2)
        t = {k: _FakeCacheTenant(k) for k in ("a", "b", "c")}
        cache.release(cache.acquire(t["a"]))
        cache.release(cache.acquire(t["b"]))
        cache.release(cache.acquire(t["a"]))
        cache.release(cache.acquire(t["c"]))
        assert set(cache.stats()["entries"]) == {"a", "c"}

    def test_inflight_runtime_never_evicted(self):
        cache, _ = _make_cache(capacity=1)
        t1, t2 = _FakeCacheTenant("t1"), _FakeCacheTenant("t2")
        lease = cache.acquire(t1)
        cache.release(cache.acquire(t2))
        assert "t1" in cache.stats()["entries"]
        cache.release(lease)
        cache.release(cache.acquire(_FakeCacheTenant("t3")))
        assert "t1" not in cache.stats()["entries"]

    def test_pinned_runtime_never_evicted(self):
        cache, _ = _make_cache(capacity=1)
        t1, t2 = _FakeCacheTenant("t1"), _FakeCacheTenant("t2")
        cache.release(cache.acquire(t1))
        cache.pin("t1", on=True)
        cache.release(cache.acquire(t2))
        assert "t1" in cache.stats()["entries"]
        cache.pin("t1", on=False)
        cache.release(cache.acquire(_FakeCacheTenant("t3")))
        assert "t1" not in cache.stats()["entries"]

    def test_put_runtime_swaps_and_preserves_pin(self):
        cache, _ = _make_cache(capacity=2)
        t1 = _FakeCacheTenant("t1")
        cache.release(cache.acquire(t1))
        cache.pin("t1", on=True)
        cache.put_runtime("t1", "runtime-new", version_key="v-new")
        e = cache.stats()["entries"]["t1"]
        assert e["version"] == "v-new" and e["pinned"]
        assert cache.acquire(t1).runtime == "runtime-new"

    def test_load_failure_raises_model_load_error(self):
        cache = ModelCache(storage=None, capacity=1,
                           build=lambda inst: (_ for _ in ()).throw(RuntimeError("boom")))
        cache.resolve_version = lambda tenant: ("v", "inst")  # type: ignore
        with pytest.raises(ModelLoadError):
            cache.acquire(_FakeCacheTenant("t1"))

    def test_sync_prefetches_on_version_drift(self):
        versions = {"t1": "v1"}
        cache = ModelCache(storage=None, capacity=2, build=lambda inst: f"runtime-{inst}")
        cache.resolve_version = (  # type: ignore[method-assign]
            lambda tenant: (versions[tenant.id], versions[tenant.id]))
        t1 = _FakeCacheTenant("t1")
        cache.release(cache.acquire(t1))
        assert cache.sync([t1]) == 0
        versions["t1"] = "v2"
        assert cache.sync([t1]) == 1
        entry = cache.acquire(t1)
        assert entry.runtime == "runtime-v2" and entry.version_key == "v2"
        assert cache.stats()["misses"] == 1


# ---------------------------------------------------------------------------
# tenant records (JAX: TestTenantStore)
# ---------------------------------------------------------------------------


class TestTenantStore:
    def test_crud_roundtrip(self, fresh_storage):
        store = TenantStore(fresh_storage)
        t = store.upsert(Tenant(id="acme", engine_id="rec", weight=2.0, qps=100.0,
                                description="the acme corp"))
        assert t.engine_variant == "rec"
        got = store.get("acme")
        assert got.weight == 2.0 and got.qps == 100.0
        assert store.get("nope") is None
        store.upsert(Tenant(id="zeta", engine_id="rec"))
        assert [x.id for x in store.list()] == ["acme", "zeta"]
        assert store.delete("zeta") > 0
        assert store.get("zeta") is None

    def test_set_quota_updates_only_quota_fields(self, fresh_storage):
        store = TenantStore(fresh_storage)
        store.upsert(Tenant(id="acme", engine_id="rec", qps=10.0))
        t = store.set_quota("acme", qps=50.0, weight=3.0)
        assert t.qps == 50.0 and t.weight == 3.0
        assert store.get("acme").qps == 50.0
        with pytest.raises(KeyError):
            store.set_quota("nope", qps=1.0)
        with pytest.raises(ValueError):
            store.set_quota("acme", bogus=1.0)

    def test_validation(self):
        with pytest.raises(ValueError):
            Tenant(id="bad/id", engine_id="rec")
        with pytest.raises(ValueError):
            Tenant(id="ok", engine_id="")
        with pytest.raises(ValueError):
            Tenant(id="ok", engine_id="rec", weight=0)
        assert Tenant(id="ok", engine_id="rec", qps=0).qps is None


# ---------------------------------------------------------------------------
# the mux's labels, cleanup, resume latch and stop (JAX: module tests)
# ---------------------------------------------------------------------------


def test_tenant_metric_labels_bounded(fresh_storage):
    from predictionio_tpu_torch.tenancy.mux import OVERFLOW_LABEL, TenantMux

    mux = TenantMux(fresh_storage, metrics=MetricsRegistry(), cache_capacity=2, label_max=3)
    labels = {mux.label(f"tenant-{i}") for i in range(50)}
    assert len(labels) == 4 and OVERFLOW_LABEL in labels
    assert mux.label("tenant-0") == "tenant-0"


def test_deleted_tenant_releases_quota_and_cache(fresh_storage):
    from predictionio_tpu_torch.tenancy.mux import TenantMux, UnknownTenant

    mux = TenantMux(fresh_storage, metrics=MetricsRegistry(), cache_capacity=2,
                    refresh_s=0.0, sync_s=3600.0)
    mux.cache._build_fn = lambda inst: "rt"
    mux.cache.resolve_version = lambda tenant: ("v1", "inst")
    store = TenantStore(fresh_storage)
    store.upsert(Tenant(id="acme", engine_id="rec", qps=5.0))
    mux.refresh(force=True)
    mux.admit("acme")
    mux.done("acme", mux.cache.acquire(store.get("acme")))
    assert mux.quota.snapshot("acme")
    assert "acme" in mux.cache.stats()["entries"]
    store.delete("acme")
    mux.refresh(force=True)
    assert mux.quota.snapshot("acme") == {}
    assert "acme" not in mux.cache.stats()["entries"]
    with pytest.raises(UnknownTenant):
        mux.admit("acme")


def test_warm_and_pin_leaves_entry_pinned():
    cache, _ = _make_cache(capacity=1)
    t1, t2 = _FakeCacheTenant("t1"), _FakeCacheTenant("t2")
    cache.warm_and_pin(t1)
    e = cache.stats()["entries"]["t1"]
    assert e["pinned"] and e["refs"] == 0
    cache.release(cache.acquire(t2))
    assert "t1" in cache.stats()["entries"]


def test_resume_latch_survives_failed_first_refresh(fresh_storage):
    from predictionio_tpu_torch.tenancy.mux import TenantMux

    mux = TenantMux(fresh_storage, metrics=MetricsRegistry(), cache_capacity=2,
                    refresh_s=0.0, sync_s=3600.0)
    TenantStore(fresh_storage).upsert(Tenant(id="acme", engine_id="rec"))

    def _down():
        raise RuntimeError("storage down")

    orig_list = mux.store.list
    mux.store.list = _down
    mux.sync()
    assert not mux._resumed, "failed refresh consumed the re-adoption"
    mux.store.list = orig_list
    calls: list = []

    def _boom(t):
        calls.append(t.id)
        raise RuntimeError("transient resume failure")

    mux._resume_rollout = _boom
    mux.sync()
    assert calls == ["acme"] and not mux._resumed
    mux._resume_rollout = lambda t: calls.append(f"ok:{t.id}")
    mux.sync()
    assert mux._resumed and calls[-1] == "ok:acme"


def test_resume_gives_up_after_repeated_failures(fresh_storage):
    from predictionio_tpu_torch.tenancy.mux import TenantMux

    mux = TenantMux(fresh_storage, metrics=MetricsRegistry(), cache_capacity=2,
                    refresh_s=0.0, sync_s=3600.0)
    TenantStore(fresh_storage).upsert(Tenant(id="acme", engine_id="rec"))
    calls: list = []

    def _boom(t):
        calls.append(t.id)
        raise RuntimeError("baseline unservable")

    mux._resume_rollout = _boom
    for _ in range(5):
        mux.sync()
    assert len(calls) == 3, "give-up cap did not bound the retries"
    assert mux._resumed, "latch never set after the give-up"


def test_stop_freezes_cache_gauges_and_releases_mux(fresh_storage):
    import gc
    import weakref

    from predictionio_tpu_torch.tenancy.mux import TenantMux

    reg = MetricsRegistry()
    mux = TenantMux(fresh_storage, metrics=reg, cache_capacity=2, refresh_s=0.0,
                    sync_s=3600.0)
    mux.cache._build_fn = lambda inst: "rt"
    mux.cache.resolve_version = lambda tenant: ("v1", "inst")
    store = TenantStore(fresh_storage)
    store.upsert(Tenant(id="acme", engine_id="rec"))
    mux.refresh(force=True)
    mux.cache.release(mux.cache.acquire(store.get("acme")))
    mux.stop()
    ref = weakref.ref(mux.cache)
    del mux
    gc.collect()
    assert ref() is None, "registry gauge closure kept the dead mux's cache alive"
    assert "tenant_cache_resident 1" in reg.render()


# ---------------------------------------------------------------------------
# across the packages, on the same inputs
# ---------------------------------------------------------------------------


def _record_ops(tenant_cls):
    return [
        ("upsert", tenant_cls(id="acme", engine_id="rec", weight=2.0, qps=10.0,
                              deadline_floor_ms=250.0, description="acme <corp>")),
        ("upsert", tenant_cls(id="zeta", engine_id="rec", engine_variant="v2",
                              max_concurrency=4, device_seconds_per_s=0.5)),
        ("set_quota", "acme", {"qps": 0, "max_concurrency": 3, "weight": 0.5}),
        ("upsert", tenant_cls(id="mid", engine_id="other", engine_version="3",
                              enabled=False)),
        ("set_quota", "zeta", {"deadline_floor_ms": 1000.0}),
        ("delete", "mid"),
        ("upsert", tenant_cls(id="mid", engine_id="other", qps=1.5)),
    ]


def _apply(store, op):
    if op[0] == "upsert":
        store.upsert(op[1])
    elif op[0] == "set_quota":
        store.set_quota(op[1], **op[2])
    else:
        store.delete(op[1])


def _listing(store):
    return [{k: v for k, v in t.to_dict().items() if k not in ("created_at", "updated_at")}
            for t in store.list()]


@pytest.mark.parametrize("writer", ["port", "jax", "alternate"])
def test_tenant_records_read_alike_across_packages(writer, tmp_path):
    """Tenants written by one package's TenantStore (or by both in turns)
    on one sqlite record store are listed and got alike by both."""
    stores = {"port": TenantStore(_storage(tmp_path)),
              "jax": jtenants.TenantStore(_jax_storage(tmp_path))}
    for n, op in enumerate(_record_ops(Tenant)):
        who = writer if writer != "alternate" else ("port", "jax")[n % 2]
        if op[0] == "upsert" and who == "jax":
            op = ("upsert", jtenants.Tenant.from_dict(op[1].to_dict()))
        _apply(stores[who], op)
    assert _listing(stores["port"]) == _listing(stores["jax"])
    for tid in ("acme", "zeta", "mid", "ghost"):
        a, b = stores["port"].get(tid), stores["jax"].get(tid)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.to_dict() == b.to_dict()
    acme = stores["port"].get("acme")
    assert (acme.qps, acme.max_concurrency, acme.weight, acme.deadline_floor_ms) == (
        None, 3, 0.5, 250.0)


def _fair_trace(module, seed):
    rng = np.random.default_rng(seed)
    tenants = [None, "a", "b", "c", "d"]
    weights = {None: 1.0, "a": float(rng.choice([0.3, 1.0, 2.5])), "b": 1.0,
               "c": float(rng.choice([0.5, 3.0])), "d": 0.0}
    q = module.FairQueue(weight_of=lambda t: weights[t])
    out, n = [], 0
    for _ in range(400):
        r = rng.random()
        if r < 0.55:
            t = tenants[int(rng.integers(len(tenants)))]
            q.put(_Item(t, n))
            n += 1
        else:
            skip = None
            if rng.random() < 0.3:
                skip = {tenants[int(k)] for k in rng.integers(0, len(tenants), 2)}
            try:
                it = q.get_nowait(skip=skip)
                out.append((it.tenant, it.i))
            except stdlib_queue.Empty:
                out.append("empty")
        if rng.random() < 0.05:
            out.append(("depths", sorted(q.depths().items()), q.qsize()))
    while q.qsize():
        it = q.get_nowait()
        out.append((it.tenant, it.i))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_fair_queue_pop_order_equals_jax(seed):
    assert _fair_trace(tfair, seed) == _fair_trace(jfair, seed)


def _quota_trace(module, tenant_module, seed):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    q = module.QuotaEnforcer(now_fn=clock)
    specs = {"q": dict(qps=float(rng.choice([0.5, 1.0]))),
             "c": dict(max_concurrency=int(rng.integers(1, 4))),
             "d": dict(device_seconds_per_s=float(rng.choice([0.05, 0.3]))),
             "all": dict(qps=3.0, max_concurrency=2, device_seconds_per_s=0.2),
             "free": {}}
    for tid, kw in specs.items():
        q.configure(tenant_module.Tenant(id=tid, engine_id="e", **kw))
    out, held = [], {t: 0 for t in specs}
    for _ in range(500):
        clock.t += float(rng.exponential(0.04))
        tid = list(specs)[int(rng.integers(len(specs)))]
        r = rng.random()
        if r < 0.55:
            try:
                q.admit(tid)
                held[tid] += 1
                out.append(("ok", tid))
            except module.QuotaExceeded as e:
                out.append((e.resource, tid, round(e.retry_after_s, 9),
                            max(1, int(e.retry_after_s + 0.999)), str(e)))
        elif r < 0.8 and held[tid]:
            q.release(tid)
            held[tid] -= 1
        elif r < 0.95:
            q.charge_device(tid, float(rng.exponential(0.2)))
        else:
            kw = dict(specs[tid])
            if "qps" in kw and rng.random() < 0.5:
                kw["qps"] = kw["qps"] * 2
            q.configure(tenant_module.Tenant(id=tid, engine_id="e", **kw))
        if rng.random() < 0.05:
            out.append(q.snapshot())
    out.append(q.snapshot())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_quota_decisions_equal_jax_under_one_clock(seed):
    got = _quota_trace(tquota, ttenants, seed)
    want = _quota_trace(jquota, jtenants, seed)
    assert got == want
    kinds = {row[0] for row in got if isinstance(row, tuple)}
    assert {"ok", "qps", "concurrency", "device_seconds"} <= kinds


def _cache_trace(module, seed, by_bytes):
    rng = np.random.default_rng(seed)
    sizes = {f"t{k}": float(rng.integers(1, 9)) * 1e6 for k in range(6)}
    clock = [0.0]

    def measure(rt):
        return sizes[rt.split(":")[0]] * (1.5 if rt.endswith("big") else 1.0)

    cache = module.ModelCache(storage=None, capacity=3, build=lambda inst: f"{inst}:rt",
                              hbm_bytes=14e6 if by_bytes else None, measure=measure,
                              transient=lambda: 2e6)
    cache.resolve_version = lambda tenant: (f"v-{tenant.id}", tenant.id)
    leases: list = []
    out = []
    real_monotonic = time.monotonic
    module.time.monotonic = lambda: clock[0]  # one ordered clock for last_used
    try:
        for _ in range(160):
            clock[0] += 1.0
            tid = f"t{int(rng.integers(6))}"
            r = rng.random()
            if r < 0.5:
                e = cache.acquire(_FakeCacheTenant(tid))
                if rng.random() < 0.3:
                    leases.append(e)
                else:
                    cache.release(e)
            elif r < 0.65 and leases:
                cache.release(leases.pop(int(rng.integers(len(leases)))))
            elif r < 0.75:
                cache.pin(tid, on=bool(rng.random() < 0.5))
            elif r < 0.85:
                cache.put_runtime(tid, f"{tid}:big", version_key=f"p-{tid}")
            elif r < 0.95:
                cur = cache.peek_runtime(tid)
                out.append(("swap", tid, cache.swap_runtime(tid, cur, f"{tid}:big")))
            else:
                cache.invalidate(tid)
            st = cache.stats()
            out.append((sorted((k, v["version"], v["refs"], v["pinned"], v["bytes"])
                               for k, v in st["entries"].items()),
                        st["hits"], st["misses"], st["reloads"], st["evictions"],
                        st["resident_bytes"]))
    finally:
        module.time.monotonic = real_monotonic
    return out


@pytest.mark.parametrize("by_bytes", [False, True], ids=["by_count", "by_bytes"])
@pytest.mark.parametrize("seed", range(3))
def test_cache_eviction_order_equals_jax(seed, by_bytes):
    got = _cache_trace(tcache, seed, by_bytes)
    assert got == _cache_trace(jcache, seed, by_bytes)
    assert got[-1][4] > 0  # evictions happened


def test_runtime_bytes_charge_each_storage_once():
    """Views of one storage are charged that storage once; distinct
    tensors each; a model's own footprint hook is used when it has one
    (the staged serving state of an ALS model, whose grown tables may be
    views of one slab)."""
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.engines.recommendation.engine import ALSModel

    slab = torch.zeros((100, 8))  # 3,200 bytes
    rt = types.SimpleNamespace(models=[{"a": slab[:60], "b": slab[60:], "c": slab.view(-1)},
                                       [torch.zeros(10), np.zeros(5, np.float32)]])
    assert tcache.estimate_runtime_device_bytes(rt) == 3200 + 40 + 20
    rng = np.random.default_rng(0)
    f = convert.als_factors_from_numpy(
        rng.standard_normal((7, 4)).astype(np.float32),
        rng.standard_normal((9, 4)).astype(np.float32),
        [f"u{i}" for i in range(7)], [f"i{i}" for i in range(9)], {})
    model = ALSModel(f, device="cpu")
    model.serving_state()
    sv = model._serving_state
    fresh = sv.device_nbytes()
    want = sum(t.nelement() * t.element_size()
               for t in (sv.users, sv.items, sv.item_inv_norm))
    assert fresh == want
    assert tcache.estimate_runtime_device_bytes(types.SimpleNamespace(models=[model])) == fresh
    # a grown user table that is a view of a larger slab: the slab once
    grown = torch.zeros((2 * sv.users.shape[0], sv.users.shape[1]))
    import dataclasses

    model._serving_state = dataclasses.replace(sv, users=grown[: sv.users.shape[0]],
                                               item_inv_norm=sv.item_inv_norm)
    got = model._serving_state.device_nbytes()
    assert got == want - sv.users.nelement() * 4 + grown.nelement() * 4
    both = dataclasses.replace(model._serving_state, items=grown[sv.users.shape[0]:][:1])
    assert both.device_nbytes() == grown.nelement() * 4 + sv.item_inv_norm.nelement() * 4


def test_serving_transient_bytes_reads_the_device_profile(monkeypatch):
    from predictionio_tpu_torch.obs import devprof

    rows = [{"memory_analysis_ok": True, "output_bytes": 100.0, "temp_bytes": 50.0},
            {"memory_analysis_ok": False, "output_bytes": 1e9, "temp_bytes": 1e9},
            {"memory_analysis_ok": True, "output_bytes": 300.0, "temp_bytes": None}]
    monkeypatch.setattr(devprof.get_profiler(), "report", lambda: {"executables": rows})
    assert tcache.serving_transient_bytes() == 300.0
    monkeypatch.setattr(devprof.get_profiler(), "report",
                        lambda: (_ for _ in ()).throw(RuntimeError("x")))
    assert tcache.serving_transient_bytes() == 0.0


def test_cache_without_a_device_builds_on_the_card(fresh_storage):
    """A mux or cache with no device builds its runtimes on the first
    CUDA device: on a host without one the load fails naming the card,
    never falling back to the CPU."""
    import datetime as dt

    from predictionio_tpu_torch.data.storage.base import EngineInstance

    now = dt.datetime.now(dt.timezone.utc)
    fresh_storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="i1", status="COMPLETED", start_time=now, end_time=now, engine_id="rec",
        engine_version="0", engine_variant="rec",
        engine_factory="predictionio_tpu_torch.engines.recommendation.RecommendationEngine"))
    mux = tmux.TenantMux(fresh_storage, metrics=MetricsRegistry())
    assert mux.cache.device is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ModelLoadError, match="no CUDA device"):
        mux.cache.acquire(Tenant(id="t", engine_id="rec"))


ENVS = [{}, {"PIO_TENANT_CACHE_SIZE": "7", "PIO_TENANT_CACHE_HBM_BYTES": "2.5e9",
             "PIO_TENANT_REFRESH_S": "0.5", "PIO_TENANT_SYNC_S": "2",
             "PIO_TENANT_METRIC_MAX": "9"},
        {"PIO_TENANT_CACHE_SIZE": "bad", "PIO_TENANT_CACHE_HBM_BYTES": "0",
         "PIO_TENANT_REFRESH_S": "", "PIO_TENANT_METRIC_MAX": "3.0"}]


@pytest.mark.parametrize("env", ENVS)
def test_tenant_knobs_read_as_the_jax_mux_reads_them(env, monkeypatch, tmp_path):
    for k in list(os.environ):
        if k.startswith("PIO_TENANT_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def knobs(m):
        return (m.cache.capacity, m.cache.hbm_bytes, m.refresh_s, m.sync_s, m._label_max)

    got = knobs(tmux.TenantMux(_storage(tmp_path / "p"), metrics=MetricsRegistry()))
    from predictionio_tpu.obs.registry import MetricsRegistry as JRegistry

    want = knobs(jmux.TenantMux(_jax_storage(tmp_path / "j"), metrics=JRegistry()))
    assert got == want


def test_tenant_slo_presets_and_their_union_equal_jax(monkeypatch):
    from predictionio_tpu_torch.obs.monitor import Monitor, SLOSpec

    ids = ["zeta", "acme", "acme", "m.1"]
    assert ([s.to_dict() for s in tslo.tenant_slo_presets(ids)]
            == [s.to_dict() for s in jslo.tenant_slo_presets(ids)])
    mon = Monitor()
    mon._slos = [SLOSpec(name="tenant:acme:latency", objective=0.5)]
    mon.apply_tenant_presets(ids)
    with mon._lock:
        union = [s.name for s in mon._slo_union_locked()]
    assert union == ["tenant:acme:latency", "tenant:acme:availability",
                     "tenant:m.1:availability", "tenant:m.1:latency",
                     "tenant:zeta:availability", "tenant:zeta:latency"]
    presets = mon._presets
    mon.apply_tenant_presets(list(reversed(ids)))  # the same set: a no-op
    assert mon._presets is presets


def test_refresh_installs_tenant_presets_with_the_flag(fresh_storage, monkeypatch):
    from predictionio_tpu_torch.obs import monitor

    seen = []
    monkeypatch.setattr(monitor.get_monitor(), "apply_tenant_presets", seen.append)
    TenantStore(fresh_storage).upsert(Tenant(id="acme", engine_id="rec"))
    mux = tmux.TenantMux(fresh_storage, metrics=MetricsRegistry(), refresh_s=0.0)
    monkeypatch.delenv("PIO_TENANT_SLO_PRESETS", raising=False)
    mux.refresh(force=True)
    assert seen == []
    monkeypatch.setenv("PIO_TENANT_SLO_PRESETS", "1")
    mux.refresh(force=True)
    assert seen == [["acme"]]


def _run(main, argv, capsys):
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    out, err = capsys.readouterr()
    return code, out, err


def test_console_tenants_verbs_print_what_the_jax_console_prints(tmp_path, monkeypatch,
                                                                 capsys):
    from predictionio_tpu.tools import console as jconsole
    from predictionio_tpu_torch.tools import console

    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)

    def jmain(argv):
        JStorage.set_instance(None)
        try:
            return jconsole.main(argv)
        finally:
            JStorage.set_instance(None)

    script = [
        ["tenants", "list"],
        ["tenants", "new", "acme", "--engine", "rec", "--weight", "2", "--qps", "5",
         "--description", "acme corp"],
        ["tenants", "new", "zeta", "--engine", "rec", "--variant", "v2",
         "--max-concurrency", "3", "--device-seconds", "0.5"],
        ["tenants", "new", "bad/id", "--engine", "rec"],
        ["tenants", "list"],
        ["tenants", "set-quota", "acme", "--qps", "9", "--max-concurrency", "2"],
        ["tenants", "set-quota", "acme"],
        ["tenants", "set-quota", "ghost", "--qps", "1"],
        ["tenants", "set-quota", "zeta", "--weight", "0"],
        ["tenants", "show", "zeta"],
        ["tenants", "show", "ghost"],
        ["tenants", "delete", "zeta"],
        ["tenants", "delete", "zeta"],
        ["tenants", "list"],
    ]
    outs = {}
    for name, main in (("port", console.main), ("jax", jmain)):
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / name))
        rows = []
        for argv in script:
            code, out, err = _run(main, argv, capsys)
            out = re.sub(r'"(created_at|updated_at)": "[^"]*"', r'"\1": "T"', out)
            rows.append((code, out, err.splitlines()[-1:] if code else []))
        outs[name] = rows
    assert outs["port"] == outs["jax"]
    assert outs["port"][4][1].startswith("[INFO] 2 tenant(s):")
