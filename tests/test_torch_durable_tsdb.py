"""The port's durable TSDB tier and compactor against the JAX package's,
on the same seeded points with explicit times (nothing sleeps for a
result):

- the block format: the delta-of-delta time codec and `write_block` give
  identical bytes, and each package reads the other's blocks;
- the same writes (WAL flushes, seals, a checkpoint) leave byte-identical
  directories, and each package opens the directory the other wrote and
  answers the same `points`, `increase`, `rate`, `quantile_over_time`
  and `latest_point` over windows that read the ring, the disk or both;
- a directory left without `stop()` (and one left by a process killed
  with SIGKILL) replays the same ring in both; a checkpointed replay
  equals a full one; counters continue across a restart with no phantom
  reset, and a real reset inside the window still counts;
- the compactor at a pinned `now` writes the same 5m and 1h blocks and
  removes the same blocks under retention; over full buckets the 5m
  tier's increase equals the raw tier's;
- the long SLO pairs and the expression `offset` windows read through to
  disk alike; `PIO_TSDB_DIR` builds the tier in the monitor, whose last
  detach joins its threads; `console tsdb` and the dashboard's durable
  panel show what the JAX package's show.
"""

import os
import shutil
import signal
import subprocess
import sys
import threading
import types
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

import predictionio_tpu.obs.monitor as jmon  # noqa: E402
from predictionio_tpu.obs.monitor import compact as jcompact  # noqa: E402
from predictionio_tpu.obs.monitor import durable as jdurable  # noqa: E402
from predictionio_tpu.obs.monitor import expr as jexpr  # noqa: E402
from predictionio_tpu.obs.monitor import slo as jslo  # noqa: E402
from predictionio_tpu.obs.monitor import tsdb as jtsdb  # noqa: E402
from predictionio_tpu.tools import console as jconsole  # noqa: E402
from predictionio_tpu.tools import dashboard as jdashboard  # noqa: E402

import predictionio_tpu_torch.obs.monitor as tmon  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import (  # noqa: E402
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_tpu_torch.obs import registry as tregistry  # noqa: E402
from predictionio_tpu_torch.obs.monitor import compact as tcompact  # noqa: E402
from predictionio_tpu_torch.obs.monitor import durable as tdurable  # noqa: E402
from predictionio_tpu_torch.obs.monitor import expr as texpr  # noqa: E402
from predictionio_tpu_torch.obs.monitor import slo as tslo  # noqa: E402
from predictionio_tpu_torch.obs.monitor import tsdb as ttsdb  # noqa: E402
from predictionio_tpu_torch.tools import console as tconsole  # noqa: E402
from predictionio_tpu_torch.tools import dashboard as tdashboard  # noqa: E402

T0 = 1_700_000_000.0
REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"jax": (jdurable, jcompact, jtsdb, jexpr, jslo),
       "port": (tdurable, tcompact, ttsdb, texpr, tslo)}


def _open(pkg, path, **kw):
    """A DurableTSDB with the background flusher and the periodic
    checkpoint off: the tests flush, seal and checkpoint themselves."""
    kw.setdefault("capacity", 120)
    kw.setdefault("flush_interval_s", 9999.0)
    kw.setdefault("seal_age_s", 9999.0)
    kw.setdefault("ckpt_points", 0)
    return PKG[pkg][0].DurableTSDB(str(path), **kw)


def _stream(seed=3, hours=3.0, step=10.0, jitter=0.4):
    """A seeded point stream sorted by time: (name, labels, value, kind,
    t). Integer counters (one restarts two thirds of the way through) and
    a wandering gauge; stamps jittered off the 10 s grid."""
    rng = np.random.default_rng(seed)
    n = int(hours * 3600 / step)
    ts = T0 + np.cumsum(step + rng.uniform(-jitter, jitter, n))
    ok = np.cumsum(rng.poisson(20, n)).astype(float)
    cut = 2 * n // 3
    ok[cut:] -= ok[cut - 1] + 1.0  # the counted process restarted
    err = np.cumsum(rng.poisson(1, n)).astype(float)
    lat = rng.gamma(2.0, 0.05, n)
    rows = []
    for i in range(n):
        t = float(ts[i])
        rows.append(("reqs_total", {"code": "200"}, float(ok[i]), "counter", t))
        rows.append(("reqs_total", {"code": "500"}, float(err[i]), "counter", t))
        rows.append(("latency_p99", {"route": "/q"}, float(lat[i]), "gauge", t))
    return rows


def _feed(db, rows, seal_every=0, ckpt_at=None):
    """Add `rows`, flushing every 300 points; sealing every `seal_every`
    points (0: never); a checkpoint after `ckpt_at` points."""
    for i, (name, labels, value, kind, t) in enumerate(rows, 1):
        db.add(name, labels, value, kind, t)
        if i % 300 == 0:
            db.flush_once(now=t, seal=bool(seal_every) and i % seal_every == 0)
        if ckpt_at is not None and i == ckpt_at:
            db.checkpoint_once()
    db.flush_once(now=rows[-1][4], seal=False)


def _files(root):
    """{relative path: bytes} of a directory tree (ckpt.json without its
    wall-clock stamp)."""
    import json

    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                data = f.read()
            if n == jdurable.CKPT_NAME:
                doc = json.loads(data)
                doc.pop("t")
                data = json.dumps(doc, sort_keys=True).encode()
            out[os.path.relpath(p, root)] = data
    return out


def _answers(db, now, windows=(600.0, 3600.0, 3 * 3600.0, None)):
    """Every read the tier stitches, over windows in the ring, on the disk
    and across both."""
    out = {}
    for name, match in (("reqs_total", {"code": "200"}), ("reqs_total", {"code": "500"}),
                        ("reqs_total", None), ("latency_p99", None)):
        key = (name, None if match is None else tuple(sorted(match.items())))
        for s in db.matching(name, match):
            for w in windows:
                out[key, s.labels, "points", w] = db.points(s, w, now)
        for w in windows[:-1]:
            out[key, "increase", w] = db.increase(name, match, w, now)
            out[key, "rate", w] = db.rate(name, match, w, now)
            out[key, "q90", w] = db.quantile_over_time(name, 0.9, match, w, now)
        out[key, "latest"] = db.latest_point(name, match)
    return out


def _ring(db):
    with db._lock:
        return {k: (s.kind, list(s.points)) for k, s in db._series.items()}


# -- the block format ----------------------------------------------------------


def test_time_codec_bytes_equal():
    rng = np.random.default_rng(11)
    steps = np.concatenate([rng.integers(0, 3, 50), rng.integers(9_000, 11_000, 200),
                            rng.integers(0, 10 ** 7, 20)])
    ts = [int(x) for x in int(T0 * 1000) + np.cumsum(steps)]
    enc = tdurable._encode_times(ts)
    assert enc == jdurable._encode_times(ts)
    assert tdurable._decode_times(enc, 0, len(ts)) == (ts, len(enc))
    for n in (0, 1, 127, 128, 2 ** 35, -1, -(2 ** 40)):
        assert tdurable._unzigzag(tdurable._zigzag(n)) == n
        assert tdurable._zigzag(n) == jdurable._zigzag(n)


def _block_rows(tier, seed=7):
    rng = np.random.default_rng(seed)
    cols = ("v",) if tier == "raw" else jdurable.DS_COLS
    step = 10_000 if tier == "raw" else int(jdurable.TIER_BUCKETS[tier] * 1000)
    rows = []
    for name, labels, kind in (("a_total", (("code", "200"), ("server", "q")), "counter"),
                               ("b", (), "gauge"), ("c", (("le", "+Inf"),), "counter")):
        n = int(rng.integers(3, 40))
        ts = [int(T0 * 1000) + i * step + int(rng.integers(0, 5)) for i in range(n)]
        rows.append((name, labels, kind, ts,
                     {c: [float(x) for x in rng.normal(0, 1e3, n)] for c in cols}))
    return rows


@pytest.mark.parametrize("tier", ["raw", "5m", "1h"])
def test_write_block_bytes_equal(tmp_path, tier):
    rows = _block_rows(tier)
    fj = jdurable.write_block(str(tmp_path / "j.blk"), tier, rows)
    ft = tdurable.write_block(str(tmp_path / "t.blk"), tier, rows)
    assert ft == fj
    assert (tmp_path / "t.blk").read_bytes() == (tmp_path / "j.blk").read_bytes()
    assert tdurable.write_block(str(tmp_path / "e.blk"), tier, []) is None
    assert not (tmp_path / "e.blk").exists()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_block(tmp_path, writer):
    rows = _block_rows("5m", seed=8)
    path = str(tmp_path / "b.blk")
    PKG[writer][0].write_block(path, "5m", rows)
    hj = jdurable.BlockHandle.load(path)
    ht = tdurable.BlockHandle.load(path)
    assert (ht.tier, ht.bucket_s, ht.min_t, ht.max_t, ht.size) == \
        (hj.tier, hj.bucket_s, hj.min_t, hj.max_t, hj.size)
    for name, labels, _kind, ts, cols in rows:
        got = ht.read_series((name, labels))
        assert got == hj.read_series((name, labels))
        assert got[1] == cols and got[0] == [t / 1000.0 for t in ts]
    assert ht.read_series(("missing", ())) is None


def test_corrupt_block_is_skipped_in_both(tmp_path):
    db = _open("port", tmp_path / "d")
    _feed(db, _stream(hours=1.0), seal_every=300)
    db.stop()
    blocks = db.tiers["raw"].blocks()
    assert len(blocks) >= 2
    with open(blocks[0].path, "r+b") as f:
        f.truncate(10)
    for pkg in PKG:
        other = _open(pkg, tmp_path / "d")
        assert [b.path for b in other.tiers["raw"].blocks()] == [b.path for b in blocks[1:]]
        assert other.summary()["durable"]["tiers"]["raw"]["blocks"] == len(blocks) - 1
        other.stop()


# -- the WAL, replay and the restart boundary ------------------------------------


def test_same_writes_leave_the_same_directory(tmp_path):
    rows = _stream()
    for pkg in PKG:
        db = _open(pkg, tmp_path / pkg)
        _feed(db, rows, seal_every=900, ckpt_at=2_400)
        db.stop()
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax")
    assert any(p.startswith("raw/") for p in got) and any(p.startswith("wal/w-") for p in got)
    assert "wal/ckpt.json" in got


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_answers_alike_on_the_others_directory(tmp_path, writer):
    rows = _stream()
    db = _open(writer, tmp_path / "w")
    _feed(db, rows, seal_every=900, ckpt_at=2_400)
    db.stop()
    now = rows[-1][4]
    answers = {}
    for pkg in PKG:
        shutil.copytree(tmp_path / "w", tmp_path / pkg)
        reader = _open(pkg, tmp_path / pkg)
        assert reader.replayed_points > 0 and reader.ckpt_seeded_points > 0
        answers[pkg] = _answers(reader, now)
        reader.stop()
    assert answers["port"] == answers["jax"]
    # the windows past the ring read the disk: a 3 h window holds ~1,080
    # points a series, the ring 120
    key = ("reqs_total", (("code", "200"),))
    assert len(answers["port"][key, (("code", "200"),), "points", 3 * 3600.0]) > 1_000


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_unstopped_directory_replays_the_same_ring(tmp_path, writer):
    """Points flushed to the WAL and never sealed or stopped (the shape a
    SIGKILL leaves) come back alike in both packages."""
    rows = _stream(hours=0.6)
    db = _open(writer, tmp_path / "w")
    _feed(db, rows)
    assert db.tiers["raw"].blocks() == []
    rings = {pkg: _ring(_open(pkg, tmp_path / "w")) for pkg in PKG}
    assert rings["port"] == rings["jax"] == _ring(db)
    db._stop.set()


def test_checkpointed_replay_equals_a_full_replay(tmp_path):
    rows = _stream(hours=1.0)
    db = _open("port", tmp_path / "d")
    _feed(db, rows, ckpt_at=900)
    db.stop()
    shutil.copytree(tmp_path / "d", tmp_path / "full")
    os.remove(tmp_path / "full" / "wal" / jdurable.CKPT_NAME)
    seeded, full, jax_seeded = (_open("port", tmp_path / "d"), _open("port", tmp_path / "full"),
                                _open("jax", tmp_path / "d"))
    assert seeded.ckpt_seeded_points > 0 and full.ckpt_seeded_points == 0
    assert _ring(seeded) == _ring(full) == _ring(jax_seeded)
    assert seeded.durable_stats()["ckpt_seeded_points"] == jax_seeded.ckpt_seeded_points
    for d in (seeded, full, jax_seeded):
        d.stop()


def test_periodic_checkpoint_rides_the_flush_alike(tmp_path):
    stats = {}
    for pkg in PKG:
        db = _open(pkg, tmp_path / pkg, ckpt_points=100)
        for i in range(251):
            db.add("c", {}, float(i), "counter", T0 + 10.0 * i)
            if i % 60 == 59:
                db.flush_once(now=T0 + 10.0 * i, seal=False)
        db.flush_once(seal=False)
        st = db.durable_stats()
        st.pop("dir")
        stats[pkg] = st
        db.stop()
    assert stats["port"] == stats["jax"]
    assert stats["port"]["ckpt_written"] >= 2 and stats["port"]["wal"]["ckpt_pending_points"] < 100


def test_increase_across_a_restart_matches_no_restart(tmp_path):
    """A monitor restart inside the window: the increase and rate equal
    an uninterrupted ring's, with no phantom reset, in both packages."""
    now = T0 + 7200.0
    ref = ttsdb.TSDB(capacity=4096)
    got = {}
    for pkg in PKG:
        db = _open(pkg, tmp_path / pkg, capacity=720)
        for i in range(361):
            db.add("reqs", {}, 4.0 * (i + 1), "counter", T0 + 10.0 * i)
            if pkg == "port":
                ref.add("reqs", {}, 4.0 * (i + 1), "counter", T0 + 10.0 * i)
        db.flush_once(seal=True)
        db.stop()
        db = _open(pkg, tmp_path / pkg, capacity=720)
        for i in range(361, 721):
            db.add("reqs", {}, 4.0 * (i + 1), "counter", T0 + 10.0 * i)
            if pkg == "port":
                ref.add("reqs", {}, 4.0 * (i + 1), "counter", T0 + 10.0 * i)
        got[pkg] = [(db.increase("reqs", None, w, now), db.rate("reqs", None, w, now))
                    for w in (1800.0, 3600.0, 7200.0)]
        db.stop()
    want = [(ref.increase("reqs", None, w, now), ref.rate("reqs", None, w, now))
            for w in (1800.0, 3600.0, 7200.0)]
    assert got["port"] == got["jax"] == want


def test_a_real_reset_inside_the_window_still_counts(tmp_path):
    now = T0 + 7200.0
    got = {}
    for pkg in PKG:
        db = _open(pkg, tmp_path / pkg, capacity=720)
        for i in range(361):
            db.add("c", {}, float(i + 1), "counter", T0 + 10.0 * i)
        db.flush_once(seal=True)
        db.stop()
        db = _open(pkg, tmp_path / pkg, capacity=720)
        for i in range(361, 721):  # the counted process restarted from 0
            db.add("c", {}, float(i - 360), "counter", T0 + 10.0 * i)
        got[pkg] = db.increase("c", None, 7200.0, now)
        db.stop()
    # 360 steps before the reset, then the first post-reset value (1) and
    # 359 steps after it
    assert got["port"] == got["jax"] == 360.0 + 1.0 + 359.0


def test_sigkilled_writer_history_survives(tmp_path):
    """A process of the port writes the tier and dies by SIGKILL after a
    flush; both packages read its history back alike."""
    d = str(tmp_path / "tsdb")
    script = f"""
import os, signal
from predictionio_tpu_torch.obs.monitor.durable import DurableTSDB
db = DurableTSDB({d!r}, flush_interval_s=9999, seal_age_s=9999, ckpt_points=0)
for i in range(361):
    db.add("reqs", {{}}, 4.0 * (i + 1), "counter", {T0} + i * 10.0)
    if i == 200:
        db.flush_once(seal=True)
db.flush_once(seal=False)
os.kill(os.getpid(), signal.SIGKILL)
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_DIR, timeout=120)
    assert proc.returncode == -signal.SIGKILL
    got = {}
    for pkg in PKG:
        db = _open(pkg, d)
        s = db.matching("reqs", None)
        got[pkg] = (len(s), db.series_increase(s[0], 3600.0, T0 + 3600.0), _ring(db))
        db.stop()
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (1, 4.0 * 360)


# -- compaction and retention ------------------------------------------------------


def _two_dirs(tmp_path, hours=4.0):
    rows = _stream(hours=hours)
    dbs = {}
    for pkg in PKG:
        db = dbs[pkg] = _open(pkg, tmp_path / pkg)
        _feed(db, rows, seal_every=600)
        db.flush_once(seal=True)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    return dbs, rows[-1][4]


def test_compactor_writes_the_same_blocks_and_removes_the_same(tmp_path):
    dbs, now = _two_dirs(tmp_path)
    runs = {}
    for pkg, db in dbs.items():
        comp = PKG[pkg][1].Compactor(db, interval_s=9999.0, grace_s=0.0,
                                     retention={"raw": 5400.0, "5m": 3 * 3600.0, "1h": 86400.0})
        runs[pkg] = [comp.run_once(now=now), comp.run_once(now=now + 1800.0),
                     comp.run_once(now=now + 2 * 3600.0)]
        st = comp.stats()
        runs[pkg].append({k: st[k] for k in ("passes", "compacted_blocks",
                                             "compacted_buckets", "removed_blocks")})
    assert runs["port"] == runs["jax"]
    assert runs["port"][-1]["removed_blocks"] > 0 and runs["port"][-1]["compacted_blocks"] >= 2
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax")
    assert any(p.startswith("5m/") for p in got) and any(p.startswith("1h/") for p in got)
    for db in dbs.values():
        db.stop()


def test_retention_waits_for_the_next_tier_alike(tmp_path):
    dbs, now = _two_dirs(tmp_path, hours=2.0)
    raw = {}
    for pkg, db in dbs.items():
        comp = PKG[pkg][1].Compactor(db, interval_s=9999.0, grace_s=1e9,
                                     retention={"raw": 0.001})
        before = db.tiers["raw"].stats()["blocks"]
        comp.run_once(now=now)  # nothing rolled up: nothing may go
        kept = db.tiers["raw"].stats()["blocks"]
        comp.grace_s = 0.0
        comp.run_once(now=now, force=True)
        comp.run_once(now=now + 60.0)
        raw[pkg] = (before, kept, sorted(os.listdir(db.tiers["raw"].root)))
        db.stop()
    assert raw["port"] == raw["jax"]
    before, kept, after = raw["port"]
    assert kept == before > len(after)
    assert tcompact.DEFAULT_RETENTION == jcompact.DEFAULT_RETENTION


def test_five_minute_increase_equals_the_raw_over_full_buckets(tmp_path):
    """Over whole 5-minute buckets the 5m tier's counter increase equals
    the raw tier's exactly (integer counters, a reset inside); the tiered
    answers of both packages agree and stay within one bucket an edge."""
    dbs, now = _two_dirs(tmp_path)
    answers = {}
    for pkg, db in dbs.items():
        PKG[pkg][1].Compactor(db, interval_s=9999.0, grace_s=0.0).run_once(now=now)
        key = ("reqs_total", (("code", "200"),))
        bucket = jdurable.TIER_BUCKETS["5m"]
        hi = (now // bucket - 1) * bucket
        rows = []
        for n_buckets in (1, 6, 24, 36):
            lo = hi - n_buckets * bucket
            raw, _ = db._disk_increase(key, lo, hi, hi - lo, tier="raw")
            ds, _ = db._disk_increase(key, lo, hi, hi - lo, tier="5m")
            assert ds == raw > 0
            rows.append(raw)
        for w in (6 * 3600.0, 4 * 3600.0):
            rows.append((db._pick_tier(w, now - w), db.increase("reqs_total", None, w, now)))
        answers[pkg] = rows
        db.stop()
    assert answers["port"] == answers["jax"]


def test_tier_pick_and_long_windows_alike(tmp_path):
    got = {}
    for pkg in PKG:
        db = _open(pkg, tmp_path / pkg, capacity=60)
        now = T0 + 3 * 86400
        for i in range(int(3 * 86400 / 300) + 1):
            db.add("reqs", {}, 30.0 * (i + 1), "counter", T0 + 300.0 * i)
        db.flush_once(seal=True)
        PKG[pkg][1].Compactor(db, interval_s=9999.0).run_once(now=now, force=True)
        got[pkg] = ([db._pick_tier(w, now - w) for w in (3 * 86400.0, 6 * 3600.0, 2 * 3600.0)],
                    db.increase("reqs", None, 3 * 86400.0, now))
        db.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == "1h"
    assert got["port"][1] == pytest.approx(30.0 / 300.0 * 3 * 86400, rel=0.02)


def test_compactor_and_flusher_threads_are_joined(tmp_path):
    db = _open("port", tmp_path / "d", flush_interval_s=0.05)
    comp = tcompact.Compactor(db, interval_s=9999.0)
    db.start()
    comp.start()
    names = {t.name for t in threading.enumerate()}
    assert {"tsdb-wal", "tsdb-compactor"} <= names
    comp.stop()
    db.stop()
    names = {t.name for t in threading.enumerate()}
    assert "tsdb-wal" not in names and "tsdb-compactor" not in names


# -- SLOs and expressions through to disk -------------------------------------------


def test_long_burn_pair_fires_from_the_replayed_disk_alike(tmp_path):
    """After a restart the 5m/1h pair sees no traffic, but the 6h/3d pair
    reads the replayed disk tier and fires, in both packages alike."""
    now = T0 + 3 * 86400
    states = {}
    for pkg in PKG:
        slo = PKG[pkg][4]
        spec = slo.SLOSpec(
            name="api", kind="expr", objective=0.99, window_s=3600.0, fast_window_s=300.0,
            burn_threshold=2.0,
            expr="sum(increase(errs[$window])) / sum(increase(reqs[$window]))",
            extra_pairs=({"fast_window_s": 21600.0, "window_s": 259200.0,
                          "burn_threshold": 1.0},))
        db = _open(pkg, tmp_path / pkg, capacity=720)
        total = err = 0.0
        t = now - 3 * 86400
        while t < now - 2 * 3600:  # silence for the last 2 h
            total += 100.0
            err += 5.0
            db.add("reqs", {}, total, "counter", t)
            db.add("errs", {}, err, "counter", t)
            t += 600.0
        db.flush_once(seal=True)
        db.stop()
        db = _open(pkg, tmp_path / pkg, capacity=720)
        eng = slo.SLOEngine(db, specs=[spec], interval_s=9999.0)
        eng.evaluate_once(now=now)
        st = eng.status("api").to_dict()
        states[pkg] = (st["state"], st["pairs"])
        db.stop()
    assert states["port"] == states["jax"]
    assert states["port"][0] in ("pending", "firing")
    pairs = states["port"][1]
    assert pairs[0]["fast_burn"] is None and pairs[1]["slow_burn"] == pytest.approx(5.0, rel=0.15)


def test_offset_windows_read_through_to_disk_alike(tmp_path):
    rows = _stream(hours=3.0)
    exprs = ("increase(reqs_total[10m] offset 1h)",
             "sum(rate(reqs_total[30m] offset 2h)) / sum(rate(reqs_total[30m]))",
             "latency_p99 offset 90m",
             "quantile_over_time(0.5, latency_p99[20m] offset 2h)")
    got = {}
    for pkg in PKG:
        db = _open(pkg, tmp_path / pkg)
        _feed(db, rows, seal_every=600)
        got[pkg] = [PKG[pkg][3].evaluate_rows(db, e, now=rows[-1][4]) for e in exprs]
        db.stop()
    assert got["port"] == got["jax"]
    assert all(got["port"]) and got["port"][0][0]["value"] > 0


# -- the monitor, the console and the dashboard ---------------------------------------


def _durable_env(monkeypatch, path):
    monkeypatch.setenv("PIO_TSDB_DIR", str(path))
    monkeypatch.setenv("PIO_TSDB_FLUSH_S", "9999")
    monkeypatch.setenv("PIO_TSDB_COMPACT_S", "9999")
    monkeypatch.delenv("PIO_TSDB", raising=False)


def test_pio_tsdb_dir_builds_the_durable_tier(tmp_path, monkeypatch):
    _durable_env(monkeypatch, tmp_path / "t")
    mon = tmon.Monitor()
    assert isinstance(mon.tsdb, tdurable.DurableTSDB) and mon.snapshot_path is None
    token = mon.attach("t", tregistry.MetricsRegistry())
    names = {t.name for t in threading.enumerate()}
    assert "tsdb-wal" in names and "tsdb-compactor" in names
    mon.tsdb.add("x", {}, 1.0, "gauge", T0)
    payload = mon.tsdb_payload({})
    assert payload["durable"]["dir"] == str(tmp_path / "t")
    assert payload["durable"]["wal"]["pending"] == 1
    mon.detach(token)
    names = {t.name for t in threading.enumerate()}
    assert "tsdb-wal" not in names and "tsdb-compactor" not in names
    # the last detach drained the WAL: a new monitor replays the point
    again = tmon.Monitor().tsdb
    assert list(again.matching("x")[0].points) == [(T0, 1.0)]
    again.stop()


class _TsdbArgs:
    url = expr = name = labels = window = agg = q = last = None


def _seed_monitor_dir(path):
    db = _open("port", path)
    _feed(db, _stream(hours=1.0), seal_every=600)
    db.stop()


def test_console_tsdb_prints_what_the_jax_console_prints(tmp_path, monkeypatch, capsys):
    _durable_env(monkeypatch, tmp_path / "t")
    _seed_monitor_dir(tmp_path / "t")
    out = {}
    for name, mod, cmd in (("jax", jmon, lambda: jconsole.cmd_tsdb(_TsdbArgs())),
                           ("port", tmon, lambda: tconsole.tsdb_cmd(_TsdbArgs()))):
        monkeypatch.setattr(mod, "_monitor", mod.Monitor())
        assert cmd() == 0
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert "durable tier at" in out["port"] and "tier raw: 1 block(s), 3 series" in out["port"]


def test_dashboard_lists_the_durable_tiers_as_the_jax_one(tmp_path, monkeypatch):
    _durable_env(monkeypatch, tmp_path / "t")
    _seed_monitor_dir(tmp_path / "t")
    monkeypatch.setattr(jmon, "_monitor", jmon.Monitor())
    monkeypatch.setattr(tmon, "_monitor", tmon.Monitor())

    def panel(text):
        start = text.index("<h2>Durable tiers</h2>")
        return text[start:text.index("</table>", start)]

    handler = types.SimpleNamespace(_durable_html=tdashboard._Handler._durable_html)
    got = panel(tdashboard._Handler._tsdb_html(handler, {}))
    assert got == panel(jdashboard._Handler._tsdb_html(None, {}))
    assert "<td>raw</td><td>1</td><td>3</td>" in got
    storage = Storage(StorageConfig(
        sources={"S": SourceConfig("S", "sqlite", {"PATH": str(tmp_path / "pio.db")})},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"}))
    dash = tdashboard.Dashboard(storage, ip="127.0.0.1", port=0, monitor_targets="")
    port = dash.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            page = r.read().decode()
    finally:
        dash.stop()
    assert "<td>raw</td><td>1</td><td>3</td>" in panel(page)
