"""The port's replicated event store against the JAX package's.

Each case of the JAX package's ``tests/test_replication.py`` runs on the
port, and, wherever the protocol lets the packages meet, across them: a
shipper of one package feeds a replica of the other through an
in-process link (the ``replication`` DAO's method surface), and the
watermarks, ``{"gap": ...}`` answers, overlap trims, "fenced" errors,
published segments (their content hashes) and ``find_since`` reads are
held to the JAX package's own pairing of the same seeded events
(explicit ids, times and creation times). Besides: equal ``ship_state``
and ``ship_tail_after`` answers for the same inserts, one election
record store bid on by both packages, ``ReplicaReadStorage``'s routing,
the JAX client's ``replication_status`` against a port follower daemon,
the SLO preset, the ``REPL_KEYS`` defaults, the metric series, and the
consumer's ``name`` / ``migrate_from`` cursor records.
"""

import datetime as dt
import glob
import hashlib
import json
import os
import threading
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")

from predictionio_tpu.data import event as jevent  # noqa: E402
from predictionio_tpu.data.storage import base as jbase  # noqa: E402
from predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from predictionio_tpu.data.storage import replication as jrepl  # noqa: E402
from predictionio_tpu.data.storage import segmentfs as jseg  # noqa: E402
from predictionio_tpu.deploy import registry as jlife  # noqa: E402
from predictionio_tpu.fleet import election as jelect  # noqa: E402
from predictionio_tpu.obs import registry as jobs  # noqa: E402
from predictionio_tpu.online import consumer as jcons  # noqa: E402
from predictionio_tpu_torch.data import event as tevent  # noqa: E402
from predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from predictionio_tpu_torch.data.storage import replication as trepl  # noqa: E402
from predictionio_tpu_torch.data.storage import segmentfs as tseg  # noqa: E402
from predictionio_tpu_torch.deploy import registry as tlife  # noqa: E402
from predictionio_tpu_torch.fleet import election as telect  # noqa: E402
from predictionio_tpu_torch.obs import registry as tobs  # noqa: E402
from predictionio_tpu_torch.online import consumer as tcons  # noqa: E402

APP = 7
UTC = dt.timezone.utc
T0 = dt.datetime(2024, 1, 1, tzinfo=UTC)
PKG = {
    "port": SimpleNamespace(seg=tseg, repl=trepl, base=tbase, event=tevent, reg=treg,
                            obs=tobs, life=tlife, elect=telect, cons=tcons),
    "jax": SimpleNamespace(seg=jseg, repl=jrepl, base=jbase, event=jevent, reg=jreg,
                           obs=jobs, life=jlife, elect=jelect, cons=jcons),
}
# (shipper's package, replica's package): each case is held to jax→jax
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]
PAIR_IDS = [f"{a}-to-{b}" for a, b in PAIRS]


def _ev(pkg, k, u=None):
    """The JAX test's event, with an explicit id, event time and creation
    time so that both packages store the same rows."""
    uid = u or f"u{k}"
    return PKG[pkg].event.Event(
        event="rate", entity_type="user", entity_id=uid, target_entity_type="item",
        target_entity_id=f"i{k % 5}", properties={"rating": float(k % 5 + 1)},
        event_time=T0 + dt.timedelta(seconds=k), creation_time=T0,
        event_id=f"id-{uid}")


def _row(k):
    """A valid segmentfs row (the shape ship_tail_after emits)."""
    return [f"e{k}", "rate", "user", f"u{k}", "item", "i1", {"rating": 1.0}, 0, None, None, 0]


def _cfg(pkg, tmp, name, **over):
    cfg = {"PATH": str(tmp / name), "SEAL_INTERVAL_S": "3600", "SEAL_AGE_S": "3600",
           "SEAL_EVENTS": "1000000", "METRICS_REGISTRY": PKG[pkg].obs.MetricsRegistry()}
    cfg.update(over)
    return cfg


def _primary(pkg, tmp, name="primary", **over):
    s = PKG[pkg].seg.SegmentFSEventStore(_cfg(pkg, tmp, name, **over))
    s.init_app(APP)
    return s


def _replica(pkg, tmp, name="replica", **over):
    r = PKG[pkg].repl.ReplicaEventStore(_cfg(pkg, tmp, name, **over))
    r.init_app(APP)
    return r


class _DirectLink:
    """A FollowerLink stand-in calling a replica in process (the
    ``replication`` DAO's methods), logging the methods called."""

    def __init__(self, replica, name="direct:0"):
        self.replica = replica
        self.name = name
        self.lock = threading.Lock()
        self.calls = []

    def call(self, method, *args, **kwargs):
        self.calls.append(method)
        return getattr(self.replica, method)(*args, **kwargs)


def _shipper(pkg, primary, replica, epoch=1, **over):
    p = PKG[pkg]
    cfg = p.repl.ReplicationConfig(followers=("direct:0",), **over)
    sh = p.repl.SegmentShipper(primary, cfg, epoch=epoch, metrics=p.obs.MetricsRegistry())
    sh.links = [_DirectLink(replica)]
    return sh


def _props(e):
    p = e.properties
    return p.to_dict() if hasattr(p, "to_dict") else dict(p)


def _keys(store, after=0):
    """Every field of every event find_since gives, in order."""
    return [(e.event_id, e.event, e.entity_id, e.target_entity_id,
             json.dumps(_props(e), sort_keys=True), e.event_time, e.creation_time,
             e.revision) for e in store.find_since(APP, after)]


def _revs(store):
    return [e.revision for e in store.find_since(APP, 0)]


def _err(fn, *args):
    """The StorageError message a call raises (either package's)."""
    with pytest.raises((tbase.StorageError, jbase.StorageError)) as ei:
        fn(*args)
    return str(ei.value)


def _published_hashes(store):
    """name → the published segment's content hash, recomputed from disk."""
    ns_dir = os.path.join(store.base, f"app_{APP}")
    return {n: tseg.segment_content_hash(os.path.join(ns_dir, n))
            for n in sorted(os.listdir(ns_dir)) if n.startswith("seg-")}


def _both(run, pair, tmp_path):
    """`run(ship_pkg, rep_pkg, dir)` for `pair` and for jax→jax, each in
    a directory of its own; the two observations must be equal."""
    got = run(*pair, tmp_path / "case")
    want = run("jax", "jax", tmp_path / "reference")
    assert got == want
    return got


# ---------------------------------------------------------------------------
# the primary's seam: the same inserts give the same shipper's view
# ---------------------------------------------------------------------------


def test_ship_state_and_tail_frames_equal_across_packages(tmp_path):
    out = {}
    for pkg in PKG:
        p = _primary(pkg, tmp_path / pkg)
        p.insert_batch([_ev(pkg, k) for k in range(40)], APP)
        p.seal(APP)
        p.insert_batch([_ev(pkg, k, u=f"t{k}") for k in range(9)], APP)
        p.insert_batch([_ev(pkg, 3, u="t3")], APP)  # supersedes: a hole in the tail
        p.delete(f"id-u{5}", APP)
        st = p.ship_state(APP, None)
        name = list(st["segments"])[0]
        out[pkg] = {
            "namespaces": p.ship_namespaces(), "state": st,
            "tail": [json.loads(json.dumps(p.ship_tail_after(APP, None, a, n), default=str))
                     for a, n in ((0, 100), (41, 3), (44, 512), (50, 10))],
            "path": os.path.basename(p.ship_segment_path(APP, None, name)),
            "gone": p.ship_segment_path(APP, None, "seg-nope"),
            "tombstones": p.ship_tombstones(APP, None),
            "hash": tseg.segment_content_hash(p.ship_segment_path(APP, None, name)),
        }
    assert out["port"] == out["jax"]
    assert out["port"]["state"]["tombstone_ops"] == 1
    assert [r[0] for r in out["port"]["tail"][0]["rows"]][-1] == "id-t3"


def test_commit_hook_called_under_the_lock_with_the_jax_arguments(tmp_path):
    seen = {}
    for pkg in PKG:
        p = _primary(pkg, tmp_path / pkg)
        calls = seen[pkg] = []

        def hook(app, ch, first, rows, head, p=p, calls=calls):
            # re-entrant lock: the hook runs inside insert_batch's hold
            calls.append((app, ch, first, json.loads(json.dumps(rows, default=str)), head,
                          p._lock._is_owned()))

        p.set_commit_hook(hook)
        p.insert_batch([_ev(pkg, k) for k in range(3)], APP)
        p.insert_batch([_ev(pkg, k, u=f"b{k}") for k in range(2)], APP)

        def failing(*_a):
            raise tbase.StorageError("follower down")

        p.set_commit_hook(failing)
        with pytest.raises(tbase.StorageError, match="follower down"):
            p.insert_batch([_ev(pkg, 9)], APP)
        p.set_commit_hook(None)
        calls.append(_revs(p))  # the failed batch stays durable
    assert seen["port"] == seen["jax"]
    assert all(c[5] for c in seen["port"][:2]) and seen["port"][2] == [1, 2, 3, 4, 5, 6]


# ---------------------------------------------------------------------------
# the frame protocol
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_ship_and_apply_parity(pair, tmp_path):
    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        primary.insert_batch([_ev(sp, k) for k in range(120)], APP)
        primary.seal(APP)
        primary.insert_batch([_ev(sp, k, u=f"t{k}") for k in range(8)], APP)
        sh = _shipper(sp, primary, replica)
        sh.pass_once()
        assert replica.latest_revision(APP) == primary.latest_revision(APP)
        assert _keys(replica) == _keys(primary)
        assert replica.data_signature(APP) == primary.data_signature(APP)
        lag = replica.replication_lag(APP)
        assert lag["lag"] == 0 and lag["role"] == "replica"
        before = _keys(replica)
        sh.pass_once()  # a second pass is a no-op, not a re-apply
        assert _keys(replica) == before
        return {"keys": before, "lag": lag, "calls": sh.links[0].calls,
                "hashes": _published_hashes(replica),
                "primary_hashes": _published_hashes(primary)}

    out = _both(run, pair, tmp_path)
    assert out["hashes"] == out["primary_hashes"]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_duplicate_frame_is_idempotent(pair, tmp_path):
    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        primary.insert_batch([_ev(sp, k) for k in range(6)], APP)
        t = primary.ship_tail_after(APP, None, 0, 100)
        frame = (APP, None, 1, 0, list(t["revs"]),
                 json.loads(json.dumps(t["rows"], default=str)), t["head"])
        r1 = replica.replication_apply_wal(*frame)
        r2 = replica.replication_apply_wal(*frame)  # a retried RPC
        assert r1["watermark"] == r2["watermark"] == 6
        assert _revs(replica) == [1, 2, 3, 4, 5, 6]
        return r1, r2, _keys(replica)

    _both(run, pair, tmp_path)


@pytest.mark.parametrize("rp", ["port"])
def test_gap_frame_answers_watermark_and_applies_nothing(rp, tmp_path):
    answers = {}
    for pkg in (rp, "jax"):
        replica = _replica(pkg, tmp_path / pkg)
        answers[pkg] = replica.replication_apply_wal(
            APP, None, 1, 5, [6, 7], [["x"] * 11, ["y"] * 11], 7)
        assert replica.latest_revision(APP) == 0
    assert answers[rp] == answers["jax"] == {"gap": True, "watermark": 0, "epoch": 1}


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_torn_wal_frame_at_epoch_boundary(pair, tmp_path):
    """A frame torn mid-ship at an epoch bump: the follower's WAL ends in
    a torn line, recovery skips it, and the resumed stream at the new
    epoch neither skips nor repeats a revision."""

    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        primary.insert_batch([_ev(sp, k) for k in range(10)], APP)
        _shipper(sp, primary, replica, epoch=1).pass_once()
        assert replica.latest_revision(APP) == 10
        primary.insert_batch([_ev(sp, k, u=f"p{k}") for k in range(6)], APP)
        wal = sorted(glob.glob(os.path.join(replica.base, f"app_{APP}", "wal-*.jsonl")))[-1]
        with open(wal, "a") as f:
            f.write('[11,[["torn-row-never-com')  # no newline, no close
        replica.close()
        replica2 = PKG[rp].repl.ReplicaEventStore(_cfg(rp, d, "replica"))
        wm = replica2.latest_revision(APP)
        assert wm == 10  # the torn record was skipped
        _shipper(sp, primary, replica2, epoch=2).pass_once()
        assert replica2.epoch == 2
        assert _revs(replica2) == list(range(1, 17))
        assert _keys(replica2) == _keys(primary)
        return wm, _keys(replica2)

    _both(run, pair, tmp_path)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_out_of_order_frame_after_gap_backfills(pair, tmp_path):
    """A gap answer makes the commit hook's frame backfill from the
    follower's watermark."""

    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        sh = _shipper(sp, primary, replica, min_acks=1)
        primary.set_commit_hook(sh._commit_hook)
        primary.insert_batch([_ev(sp, k) for k in range(3)], APP)
        assert replica.latest_revision(APP) == 3
        # the follower loses its state (a fresh directory: lost frames)
        sh.links[0].replica = _replica(rp, d, "replica-b")
        primary.insert_batch([_ev(sp, k, u=f"b{k}") for k in range(3)], APP)
        assert _revs(sh.links[0].replica) == [1, 2, 3, 4, 5, 6]
        return _keys(sh.links[0].replica), sh.links[0].calls

    _both(run, pair, tmp_path)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_min_acks_failure_raises_but_keeps_rows_durable(pair, tmp_path):
    class _DownLink:
        name = "down:0"

        def call(self, *a, **k):
            raise OSError("connection refused")

    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        sh = _shipper(sp, primary, replica, min_acks=1)
        sh.links = [_DownLink()]
        primary.set_commit_hook(sh._commit_hook)
        msg = _err(primary.insert_batch, [_ev(sp, 1)], APP)
        assert "ack floor" in msg
        assert primary.latest_revision(APP) == 1
        sh.links = [_DirectLink(replica)]
        sh.pass_once()
        assert _revs(replica) == [1]
        return msg, _keys(replica)

    _both(run, pair, tmp_path)


# ---------------------------------------------------------------------------
# segment shipping
# ---------------------------------------------------------------------------


def _files(seg_path):
    return sorted(n for n in os.listdir(seg_path) if not n.startswith("."))


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_ship_resumes_after_follower_restart(pair, tmp_path):
    """Staged files outlive a follower restart (``repl-`` is not seal
    garbage) and the resumed ship sends only the missing ones."""

    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        primary.insert_batch([_ev(sp, k) for k in range(50)], APP)
        primary.seal(APP)
        name = list(primary.ship_state(APP, None)["segments"])[0]
        seg_path = primary.ship_segment_path(APP, None, name)
        fnames = _files(seg_path)
        assert len(fnames) > 2
        for fname in fnames[:2]:
            with open(os.path.join(seg_path, fname), "rb") as f:
                data = f.read()
            replica.replication_segment_file(APP, None, 1, name, fname, data,
                                             hashlib.sha256(data).hexdigest())
        replica.close()
        replica2 = PKG[rp].repl.ReplicaEventStore(_cfg(rp, d, "replica"))
        man = replica2.replication_segment_manifest(APP, None, name)
        assert sorted(man["staged"]) == fnames[:2]
        sh = _shipper(sp, primary, replica2)
        link = sh.links[0]
        sh._ship_segment(link, APP, None, name)
        sent = link.calls.count("replication_segment_file")
        assert sent == len(fnames) - 2
        assert replica2.replication_segment_manifest(APP, None, name)["published"]
        assert _revs(replica2) == list(range(1, 51))
        assert _published_hashes(replica2) == _published_hashes(primary)
        return man, sent, _keys(replica2), _published_hashes(replica2)

    _both(run, pair, tmp_path)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_commit_rejects_corrupted_staged_file(pair, tmp_path):
    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        primary.insert_batch([_ev(sp, k) for k in range(30)], APP)
        primary.seal(APP)
        name = list(primary.ship_state(APP, None)["segments"])[0]
        sh = _shipper(sp, primary, replica)
        link = sh.links[0]
        sh._ship_segment(link, APP, None, name)
        assert replica.replication_segment_manifest(APP, None, name)["published"]
        primary.insert_batch([_ev(sp, k, u=f"c{k}") for k in range(30)], APP)
        primary.seal(APP)
        name2 = [n for n in primary.ship_state(APP, None)["segments"] if n != name][0]
        seg2 = primary.ship_segment_path(APP, None, name2)
        files = {}
        for fname in _files(seg2):
            with open(os.path.join(seg2, fname), "rb") as f:
                data = f.read()
            files[fname] = hashlib.sha256(data).hexdigest()
            replica.replication_segment_file(APP, None, 1, name2, fname, data, files[fname])
        staged = os.path.join(replica.base, f"app_{APP}", f"repl-{name2}")
        victim = sorted(n for n in os.listdir(staged) if n != "footer.json")[0]
        with open(os.path.join(staged, victim), "r+b") as f:
            f.write(b"\x00garbage\x00")
        with open(os.path.join(seg2, "footer.json")) as f:
            chash = json.load(f)["content_hash"]
        msg = _err(replica.replication_commit_segment, APP, None, 1, name2, files, chash)
        assert "re-ship" in msg or "hash" in msg
        assert not replica.replication_segment_manifest(APP, None, name2)["published"]
        # a file corrupted in flight is refused before it is staged
        bad = _err(replica.replication_segment_file, APP, None, 1, name2, "rev.npy",
                   b"\x00", files["rev.npy"])
        sh._ship_segment(link, APP, None, name2)
        assert replica.replication_segment_manifest(APP, None, name2)["published"]
        assert _revs(replica) == list(range(1, 61))
        assert _published_hashes(replica) == _published_hashes(primary)
        return msg, bad, _keys(replica), _published_hashes(replica)

    _both(run, pair, tmp_path)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_replica_survives_restart_with_sealed_and_tail(pair, tmp_path):
    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        primary.insert_batch([_ev(sp, k) for k in range(40)], APP)
        primary.seal(APP)
        primary.insert_batch([_ev(sp, k, u=f"t{k}") for k in range(5)], APP)
        _shipper(sp, primary, replica).pass_once()
        assert replica.latest_revision(APP) == 45
        replica.close()
        replica2 = PKG[rp].repl.ReplicaEventStore(_cfg(rp, d, "replica"))
        assert _revs(replica2) == list(range(1, 46))
        # the replica's find_frame equals the primary's, bit for bit
        q = PKG[rp].base.EventQuery(app_id=APP, entity_type="user", event_names=["rate"])
        qp = PKG[sp].base.EventQuery(app_id=APP, entity_type="user", event_names=["rate"])
        fr, fp = (s.find_frame(qq, value_prop="rating") for s, qq in ((replica2, q),
                                                                       (primary, qp)))
        frames = [(f.entity_idx.tobytes(), f.target_idx.tobytes(), f.value.tobytes(),
                   f.time_ms.tobytes(), f.entity_vocab.to_dict(), f.target_vocab.to_dict())
                  for f in (fr, fp)]
        assert frames[0] == frames[1]
        return _keys(replica2), frames[0]

    _both(run, pair, tmp_path)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_tombstones_replicate(pair, tmp_path):
    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        primary.insert_batch([_ev(sp, k) for k in range(10)], APP)
        victim = primary.find_since(APP, 0)[3]
        sh = _shipper(sp, primary, replica)
        sh.pass_once()
        primary.delete(victim.event_id, APP)
        sh.pass_once()
        ids = [e.event_id for e in replica.find_since(APP, 0)]
        assert victim.event_id not in ids and len(ids) == 9
        assert replica.data_signature(APP) == primary.data_signature(APP)
        return _keys(replica), replica.ship_tombstones(APP, None)

    _both(run, pair, tmp_path)


# ---------------------------------------------------------------------------
# fencing, promotion, election
# ---------------------------------------------------------------------------


def test_stale_epoch_is_fenced_and_newer_adopted_durably(tmp_path):
    out = {}
    for pkg in PKG:
        d = tmp_path / pkg
        replica = _replica(pkg, d)
        replica.replication_apply_wal(APP, None, 3, 0, [1], [_row(1)], 1)
        assert replica.epoch == 3
        msg = _err(replica.replication_apply_wal, APP, None, 2, 1, [2], [["x"] * 11], 2)
        assert "fenced" in msg
        replica.close()
        replica2 = PKG[pkg].repl.ReplicaEventStore(_cfg(pkg, d, "replica"))
        assert replica2.epoch == 3  # the adoption outlived the restart
        with open(os.path.join(replica2.base, "replication.json")) as f:
            meta = json.load(f)
        out[pkg] = (msg, meta, replica2.latest_revision(APP))
    assert out["port"] == out["jax"]


def test_replica_is_read_only_until_promoted(tmp_path):
    out = {}
    for pkg in PKG:
        replica = _replica(pkg, tmp_path / pkg)
        errs = [_err(replica.insert_batch, [_ev(pkg, 1)], APP),
                _err(replica.delete_batch, ["nope"], APP)]
        assert all("read-only" in e for e in errs)
        promoted = replica.promote(5)
        replica.insert_batch([_ev(pkg, 1)], APP)
        assert replica.latest_revision(APP) == 1
        errs.append(_err(replica.replication_apply_wal, APP, None, 6, 1, [2],
                         [["x"] * 11], 2))
        assert "promoted" in errs[-1]
        out[pkg] = (errs, promoted, _keys(replica))
    assert out["port"] == out["jax"]


def test_stale_promotion_raises_and_role_survives_restart(tmp_path):
    out = {}
    for pkg in PKG:
        d = tmp_path / pkg
        replica = _replica(pkg, d)
        replica.replication_apply_wal(APP, None, 4, 0, [1], [_row(1)], 1)
        msg = _err(replica.promote, 4)  # a zombie's claim at the seen epoch
        assert "stale promotion" in msg
        first = replica.promote(5)
        again = replica.promote(5)  # the same epoch again: a no-op
        replica.close()
        replica2 = PKG[pkg].repl.ReplicaEventStore(_cfg(pkg, d, "replica"))
        assert replica2.role == "primary" and replica2.epoch == 5
        replica2.insert_batch([_ev(pkg, 2)], APP)
        out[pkg] = (msg, first, again, _keys(replica2))
    assert out["port"] == out["jax"]


def _mem_storage(pkg):
    r = PKG[pkg].reg
    return r.Storage(r.StorageConfig(
        sources={"M": r.SourceConfig("M", "memory", {})},
        repositories={"METADATA": "M", "EVENTDATA": "M", "MODELDATA": "M"}))


def _sqlite_storage(pkg, path):
    r = PKG[pkg].reg
    return r.Storage(r.StorageConfig(
        sources={"DB": r.SourceConfig("DB", "sqlite", {"PATH": str(path)})},
        repositories={"METADATA": "DB", "EVENTDATA": "DB", "MODELDATA": "DB"}))


def _state(el):
    s = el.state()
    return (s.leader, s.generation, s.claim_token, s.claimed_at)


@pytest.mark.parametrize("pkg", list(PKG))
def test_cas_election_first_bid_wins(pkg):
    p = PKG[pkg]
    records = p.life.LifecycleRecordStore(_mem_storage(pkg))
    el_a = p.elect.CasElection(records, "events-primary")
    el_b = p.elect.CasElection(records, "events-primary")
    assert el_a.claim("node-a") == 1
    assert el_a.state().leader == "node-a"
    # a bid already landed for generation 2: the late bidder loses
    records.append("pio_election_bid", "events-primary",
                   {"generation": 2, "claim_token": "other", "candidate": "x",
                    "bid_at": 0.0})
    assert el_b.claim("node-b") is None
    assert el_b.claim("node-b", generation=3) == 3
    assert el_b.state() == el_a.state()
    assert el_a.state().generation == 3
    assert records.events("pio_election_bid", "events-primary")
    assert el_a.gc_bids() == 4  # generations 1, 2 (twice) and 3
    assert not records.events("pio_election_bid", "events-primary")


def test_cas_election_across_packages_on_one_record_store(tmp_path):
    """A JAX and a port candidate bid for one generation over one sqlite
    record store: exactly one wins, and both read the same state."""
    db = tmp_path / "records.db"
    bids_landed = threading.Barrier(2)

    def bids_seen_together(records):
        # a candidate resolves only once both generation-2 bids are in the
        # store: otherwise a bid built (and timed) before the other's but
        # written after that one resolved makes both win, or neither
        append = records.append

        def wrapped(entity_type, entity_id, props):
            out = append(entity_type, entity_id, props)
            if entity_type == "pio_election_bid" and props.get("generation") == 2:
                bids_landed.wait(timeout=30)
            return out

        records.append = wrapped
        return records

    tel = telect.CasElection(bids_seen_together(
        tlife.LifecycleRecordStore(_sqlite_storage("port", db))), "g")
    jel = jelect.CasElection(bids_seen_together(
        jlife.LifecycleRecordStore(_sqlite_storage("jax", db))), "g")
    # each package opens its connection here, one after the other: two
    # first connections switching one new file to WAL at once can find
    # it locked
    assert _state(tel) == _state(jel) == (None, 0, None, 0.0)
    results = {}
    barrier = threading.Barrier(2)

    def stand(name, el):
        barrier.wait()
        results[name] = el.claim(name, settle_s=0.2, generation=2)

    threads = [threading.Thread(target=stand, args=a) for a in (("port", tel), ("jax", jel))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    winners = [n for n, g in results.items() if g is not None]
    assert len(winners) == 1 and results[winners[0]] == 2
    assert _state(tel) == _state(jel) and tel.state().leader == winners[0]
    # the loser's next claim wins the next generation, read alike
    loser = jel if winners[0] == "port" else tel
    assert loser.claim("late") == 3
    assert _state(tel) == _state(jel) and tel.state().generation == 3
    assert tel.gc_bids() == 3
    assert jel.gc_bids() == 0


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_elect_and_promote_catch_up_gate(pair, tmp_path):
    def run(sp, rp, d):
        p = PKG[rp]
        primary = _primary(sp, d)
        ahead, behind = _replica(rp, d), _replica(rp, d, "replica-behind")
        primary.insert_batch([_ev(sp, k) for k in range(8)], APP)
        _shipper(sp, primary, ahead).pass_once()
        t = primary.ship_tail_after(APP, None, 0, 4)
        behind.replication_apply_wal(APP, None, 1, 0, list(t["revs"][:4]),
                                     json.loads(json.dumps(t["rows"][:4], default=str)), 4)
        assert (ahead.latest_revision(APP), behind.latest_revision(APP)) == (8, 4)
        records = p.life.LifecycleRecordStore(_mem_storage(rp))
        # the lagging follower withdraws: a reachable peer is ahead
        lost = p.repl.elect_and_promote(records, behind, "behind",
                                        peers=[_DirectLink(ahead)])
        assert lost is None and behind.role == "replica"
        gen = p.repl.elect_and_promote(records, ahead, "ahead", peers=[_DirectLink(behind)])
        assert gen == 2 and ahead.role == "primary" and ahead.epoch == 2
        ahead.insert_batch([_ev(rp, 99, u="post-failover")], APP)
        assert ahead.latest_revision(APP) == 9
        el = p.elect.CasElection(records, p.repl.ELECTION_GROUP).state()
        return lost, gen, el.leader, el.generation, _keys(ahead)

    _both(run, pair, tmp_path)


# ---------------------------------------------------------------------------
# the read side: lag, read-your-writes, the consumer's routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_lag_watermark_and_wait_for_revision(pair, tmp_path):
    def run(sp, rp, d):
        primary, replica = _primary(sp, d), _replica(rp, d)
        primary.insert_batch([_ev(sp, k) for k in range(5)], APP)
        t = primary.ship_tail_after(APP, None, 0, 3)
        replica.replication_apply_wal(APP, None, 1, 0, list(t["revs"][:3]),
                                      json.loads(json.dumps(t["rows"][:3], default=str)), 5)
        lag = replica.replication_lag(APP)
        assert lag == {"watermark": 3, "head": 5, "lag": 2, "epoch": 1, "role": "replica"}
        waits = [replica.wait_for_revision(APP, 3, timeout_s=0.1),
                 replica.wait_for_revision(APP, 5, timeout_s=0.1)]
        assert waits == [True, False]
        _shipper(sp, primary, replica).pass_once()
        waits.append(replica.wait_for_revision(APP, 5, timeout_s=0.1))
        assert waits[-1] and replica.replication_lag(APP)["lag"] == 0
        return lag, waits, replica.replication_status()

    _both(run, pair, tmp_path)


def test_replica_read_storage_routes_reads_not_writes(tmp_path):
    out = {}
    for pkg in PKG:
        p = PKG[pkg]
        control = _mem_storage(pkg)
        control.get_events().init_app(APP)
        control.get_events().init_app(APP + 1)
        replica = _replica(pkg, tmp_path / pkg)
        replica.replication_apply_wal(APP, None, 1, 0, [1, 2, 3],
                                      [_row(k) for k in range(3)], 3)
        view = p.repl.ReplicaReadStorage(control, replica, [APP])
        ev = view.get_events()
        got = [[e.revision for e in ev.find_since(APP, 0)], ev.latest_revision(APP)]
        ev.insert_batch([_ev(pkg, 1)], APP + 1)  # a write goes to control
        got += [ev.latest_revision(APP + 1), control.get_events().latest_revision(APP + 1),
                [e.revision for e in ev.find_since(APP + 1, 0)],
                [k for k, _s, _sh in ev.revision_streams()],
                view.get_meta_data_apps() is control.get_meta_data_apps(),
                ev.replication_lag(APP)["watermark"],
                ev.get("e1", APP).entity_id, ev.data_signature(APP),
                _err(replica.insert_batch, [_ev(pkg, 2)], APP)]
        q = p.base.EventQuery(app_id=APP, entity_type="user")
        got.append([e.event_id for e in ev.find(q)])
        got.append(ev.find_frame(q).entity_vocab.to_dict())
        out[pkg] = got
    assert out["port"] == out["jax"]
    assert out["port"][:7] == [[1, 2, 3], 3, 1, 1, [1], ["0"], True]
    # the port's fold-in history read routes as the reads do
    control = _mem_storage("port")
    control.get_events().init_app(APP)
    replica = _replica("port", tmp_path / "edges")
    replica.replication_apply_wal(APP, None, 1, 0, [1, 2], [_row(1), _row(2)], 2)
    ev = trepl.ReplicaReadStorage(control, replica, [APP]).get_events()
    assert ev.find_edges(APP, "user", "item", ["rate"], entity_ids=["u2", "u1"]) == [
        ("u2", "i1", "rate", {"rating": 1.0}), ("u1", "i1", "rate", {"rating": 1.0})]
    assert control.get_events().find_edges(APP, "user", "item", ["rate"],
                                           entity_ids=["u1"]) == []


# ---------------------------------------------------------------------------
# the storage daemon's transport
# ---------------------------------------------------------------------------


def _follower_storage(pkg, path):
    r = PKG[pkg].reg
    return r.Storage(r.StorageConfig(
        sources={"REP": r.SourceConfig("REP", "segmentfs-replica",
                                       {"PATH": str(path), "SEAL_INTERVAL_S": "3600"}),
                 "M": r.SourceConfig("M", "memory", {})},
        repositories={"METADATA": "M", "EVENTDATA": "REP", "MODELDATA": "M"}))


@pytest.mark.parametrize("sp", list(PKG))
def test_ship_over_storage_daemon(sp, tmp_path):
    """A shipper of either package to a port follower daemon; then the
    port client and the JAX client read the follower's state alike."""
    from predictionio_tpu.data.storage.remote import RemoteEventStore as JRemote
    from predictionio_tpu_torch.data.api.storage_server import StorageServer
    from predictionio_tpu_torch.data.storage.remote import RemoteEventStore

    follower = _follower_storage("port", tmp_path / "replica")
    daemon = StorageServer(follower, host="127.0.0.1", port=0).start()
    try:
        replica = follower.get_events()
        assert isinstance(replica, trepl.ReplicaEventStore)
        replica.init_app(APP)
        primary = _primary(sp, tmp_path)
        primary.insert_batch([_ev(sp, k) for k in range(60)], APP)
        primary.seal(APP)
        primary.insert_batch([_ev(sp, k, u=f"t{k}") for k in range(4)], APP)
        p = PKG[sp]
        cfg = p.repl.ReplicationConfig(followers=(f"127.0.0.1:{daemon.port}",), timeout_s=10.0)
        sh = p.repl.SegmentShipper(primary, cfg, epoch=1, metrics=p.obs.MetricsRegistry())
        assert isinstance(sh.links[0], p.repl.FollowerLink)
        sh.pass_once()
        assert _keys(replica) == _keys(primary)
        assert _published_hashes(replica) == _published_hashes(primary)
        src = {"HOST": "127.0.0.1", "PORT": str(daemon.port)}
        answers = []
        for client in (RemoteEventStore(src), JRemote(src)):
            lag = client.replication_lag(APP)
            assert lag["lag"] == 0 and lag["watermark"] == 64
            assert client.wait_for_revision(APP, 64, timeout_s=1.0)
            assert not client.wait_for_revision(APP, 65, timeout_s=0.05)
            status = client.replication_status()
            assert status["role"] == "replica" and str(APP) in status["namespaces"]
            answers.append((lag, status))
        assert answers[0] == answers[1]
        assert answers[0][1] == replica.replication_status()
    finally:
        daemon.shutdown()


# ---------------------------------------------------------------------------
# knobs, presets, metrics, the consumer's cursor records
# ---------------------------------------------------------------------------


def test_repl_keys_and_config_match_jax(monkeypatch):
    from predictionio_tpu.utils import env as jenv
    from predictionio_tpu_torch.utils import env as tenv

    for name, default in tenv.REPL_KEYS.items():
        assert jenv.KNOBS[name].default == default, name
    assert set(tenv.REPL_KEYS) == {k for k in jenv.KNOBS if k.startswith("PIO_REPL_")}
    assert vars(trepl.ReplicationConfig.from_env()) == vars(jrepl.ReplicationConfig.from_env())
    monkeypatch.setenv("PIO_REPL_FOLLOWERS", " a:1, b:2 ,")
    monkeypatch.setenv("PIO_REPL_MIN_ACKS", "2")
    monkeypatch.setenv("PIO_REPL_SHIP_INTERVAL_S", "0.05")
    monkeypatch.setenv("PIO_REPL_WAL_BATCH", "64")
    got = trepl.ReplicationConfig.from_env(auth_key="k")
    assert vars(got) == vars(jrepl.ReplicationConfig.from_env(auth_key="k"))
    assert got.followers == ("a:1", "b:2") and got.min_acks == 2


def test_replication_slo_presets_match_jax(monkeypatch):
    from predictionio_tpu.obs.monitor import slo as jslo
    from predictionio_tpu_torch.obs.monitor import slo as tslo

    for arg in (None, 250, 0):
        assert [s.to_dict() for s in tslo.replication_slo_presets(arg)] == \
            [s.to_dict() for s in jslo.replication_slo_presets(arg)]
    monkeypatch.setenv("PIO_REPL_MAX_LAG_REVISIONS", "77")
    [spec] = tslo.replication_slo_presets()
    assert spec.to_dict() == jslo.replication_slo_presets()[0].to_dict()
    assert spec.expr.endswith("/ 77")


def test_metric_series_match_jax(tmp_path):
    texts = {}
    for pkg in PKG:
        p = PKG[pkg]
        reg = p.obs.MetricsRegistry()
        m = p.repl._repl_metrics(reg)
        m["ship_total"].inc(kind="wal")
        m["ship_bytes"].inc(10)
        m["ship_errors"].inc(follower="a:1")
        m["applied"].inc(kind="segment")
        m["fenced"].inc()
        m["lag"].set(3, app="7")
        m["epoch"].set(2)
        texts[pkg] = reg.render()
    assert texts["port"] == texts["jax"]


class _StubHost:
    scope = "server"

    def __init__(self):
        self.runtime = object()

    def current(self):
        return self.runtime

    def swap(self, old, new):
        if self.runtime is old:
            self.runtime = new
            return True
        return False


def _cursor_records(pkg, storage):
    recs = PKG[pkg].life.LifecycleRecordStore(storage).fold(tcons.CURSOR_ENTITY)
    return {k: {f: v for f, v in d.items() if f != "updated_at"} for k, d in recs.items()}


def test_consumer_name_and_migration_records_match_jax(tmp_path):
    out = {}
    for pkg in PKG:
        p = PKG[pkg]
        storage = _mem_storage(pkg)
        storage.get_events().init_app(APP)
        records = p.life.LifecycleRecordStore(storage)
        records.append(p.cons.CURSOR_ENTITY, f"online/{APP}/server", {
            "cursor": {"0": 5}, "events_consumed": 5, "events_folded": 4,
            "users_folded": 2, "items_folded": 1, "ticks": 3, "scope": "server",
            "app_id": APP, "baseline_instance": "inst-1", "baseline_cursor": {"0": 1}})
        cfg = p.cons.OnlineConsumerConfig
        named = p.cons.OnlineConsumer(storage, _StubHost(), APP,
                                      cfg(tick_s=3600, name=f"online/{APP}/replica-a"))
        migrated = p.cons.OnlineConsumer(
            storage, _StubHost(), APP,
            cfg(tick_s=3600, name=f"online/{APP}/replica-b",
                migrate_from=f"online/{APP}/server"))
        again = p.cons.OnlineConsumer(
            storage, _StubHost(), APP,
            cfg(tick_s=3600, name=f"online/{APP}/replica-b",
                migrate_from=f"online/{APP}/server"))
        default = p.cons.OnlineConsumer(storage, _StubHost(), APP, cfg(tick_s=3600))
        out[pkg] = {
            "ids": [c.cursor_id for c in (named, migrated, again, default)],
            "cursors": [dict(c.cursor) for c in (named, migrated, again, default)],
            "counters": [dict(c.counters) for c in (named, migrated, again, default)],
            "migrated_from": [c.migrated_from for c in (named, migrated, again)],
            "records": _cursor_records(pkg, storage),
        }
    assert out["port"] == out["jax"]
    recs = out["port"]["records"]
    assert recs[f"online/{APP}/replica-b"]["migrated_from"] == f"online/{APP}/server"
    assert recs[f"online/{APP}/replica-b"]["cursor"] == {"0": 5}
    assert f"online/{APP}/replica-a" not in recs
    assert out["port"]["cursors"][0] == {} and out["port"]["cursors"][1] == {"0": 5}


# ---------------------------------------------------------------------------
# a retrain over a promoted replica store
# ---------------------------------------------------------------------------


def _promoted_storage(pkg, tmp, rows):
    """`pkg`'s primary segmentfs store holds the first 70 % of `rows`
    (sealed, then a tail), ships them to a replica, and the replica is
    promoted at epoch 2 and takes the rest as acknowledged live writes;
    then a Storage over the promoted replica's PATH (its role survives
    the reopen) with the app registered as APP."""
    from test_torch_workflow import _events

    p = PKG[pkg]
    events = _events(p.event.Event, rows)
    cut = int(0.7 * len(events))
    primary, replica = _primary(pkg, tmp), _replica(pkg, tmp)
    primary.insert_batch(events[:cut // 2], APP)
    primary.seal(APP)
    primary.insert_batch(events[cut // 2:cut], APP)
    _shipper(pkg, primary, replica).pass_once()
    assert replica.latest_revision(APP) == cut
    assert replica.promote(2) is not None
    for n in range(cut, len(events), 7):
        assert replica.insert_batch(events[n:n + 7], APP) == [
            e.event_id for e in events[n:n + 7]]
    primary.close()
    replica.close()
    r = p.reg
    storage = r.Storage(r.StorageConfig(
        sources={"REP": r.SourceConfig("REP", "segmentfs-replica",
                                       {"PATH": str(tmp / "replica"), "SEAL_INTERVAL_S": "3600"}),
                 "M": r.SourceConfig("M", "memory", {})},
        repositories={"METADATA": "M", "EVENTDATA": "REP", "MODELDATA": "M"}))
    assert storage.get_meta_data_apps().insert(p.base.App(APP, "wfapp")) == APP
    store = storage.get_events()
    assert store.role == "primary" and store.epoch == 2
    return storage, store, events


def test_retrain_over_a_promoted_replica_store(tmp_path):
    """A train over a promoted replica: the data view's frame (segmentfs
    `find_frame`: the sealed rows' cache and the tail) equals
    `EventFrame.from_events` of the winner's own `find`, column for
    column, holding every shipped and every acknowledged live event once;
    from the same initial factors, the port's factors correlate > 0.9999
    with the JAX package's retrain over its own promoted replica."""
    import numpy as np

    from predictionio_tpu.data.store import columnar as jcolumnar
    from predictionio_tpu.data.view import DataView as JDataView
    from predictionio_tpu.workflow import core as jcore
    from predictionio_tpu_torch.data.store import columnar as tcolumnar
    from predictionio_tpu_torch.data.view import DataView as TDataView
    from predictionio_tpu_torch.workflow import core as tcore
    from test_torch_workflow import J_VARIANT, VARIANT, _same_start

    # a 40-item app (whole dense trains are held on 40 items: on 8-24
    # the implicit solves amplify f32 rounding past the bar)
    rng = np.random.RandomState(7)
    rows = [("rate", f"u{u}", f"i{i}", float(rng.randint(1, 6)))
            for u in range(60) for i in rng.choice(40, 12, replace=False)]
    kwargs = dict(app_name="wfapp", entity_type="user", target_entity_type="item",
                  event_names=["rate", "buy"], value_prop="rating", default_value=1.0)
    factors = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("PIO_DENSE_ALS", "1")  # the dense path, as the card's retrain takes
        mp.setenv("PIO_PALLAS_DENSE", "interpret")  # the JAX dense kernel itself
        paths = _same_start(mp)
        for pkg, view, columnar, core, variant in (
                ("port", TDataView, tcolumnar, tcore, VARIANT),
                ("jax", JDataView, jcolumnar, jcore, J_VARIANT)):
            storage, store, events = _promoted_storage(pkg, tmp_path / pkg, rows)
            frame = view(str(tmp_path / pkg / "view")).find_frame(storage, **kwargs)
            q = PKG[pkg].base.EventQuery(app_id=APP, entity_type="user",
                                         target_entity_type="item", event_names=["rate", "buy"])
            found = list(store.find(q))
            ref = columnar.EventFrame.from_events(found, value_prop="rating", default_value=1.0)
            for col in ("event_code", "entity_idx", "target_idx", "time_ms", "value"):
                a, b = getattr(frame, col), getattr(ref, col)
                assert a.dtype == b.dtype and np.array_equal(a, b), (pkg, col)
            for voc in ("event_vocab", "entity_vocab", "target_vocab"):
                assert getattr(frame, voc).to_dict() == getattr(ref, voc).to_dict(), (pkg, voc)
            ids = [e.event_id for e in found]
            assert sorted(ids) == sorted(e.event_id for e in events) and len(set(ids)) == len(ids)
            variant = dict(variant)
            variant["datasource"] = {"params": {**variant["datasource"]["params"],
                                                "use_data_view": True,
                                                "data_view_dir": str(tmp_path / pkg / "view")}}
            if pkg == "port":
                inst = core.run_train(storage, variant, device="cpu")
                [model] = tcore.prepare_deploy_models(storage, inst, device="cpu")[2]
            else:
                inst = core.run_train(storage, variant)
                [model] = core.prepare_deploy_models(storage, inst)[2]
            assert inst.status == "COMPLETED"
            factors[pkg] = model.factors
    finally:
        mp.undo()
    assert paths == ["_train_dense"]
    t, j = factors["port"], factors["jax"]
    assert t.user_vocab.to_dict() == j.user_vocab.to_dict()
    assert t.item_vocab.to_dict() == j.item_vocab.to_dict()
    for side in ("user_factors", "item_factors"):
        got, want = np.asarray(getattr(t, side)), np.asarray(getattr(j, side))
        assert np.all(np.isfinite(got))
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999, side


def test_data_view_reads_a_replicated_app_through_replica_read_storage(tmp_path):
    """The data view's segment branch over `ReplicaReadStorage` counts the
    replica's sealed-rows cache (a miss, then a hit) and gives the
    replica's frame; the JAX facade passes `frame_cache_stats` to the
    control store, which has none, so the same read raises there (a
    fault of the JAX package the port does not keep)."""
    from predictionio_tpu.data.view import DataView as JDataView
    from predictionio_tpu_torch.data.view import DataView as TDataView

    out = {}
    for pkg, view in (("port", TDataView), ("jax", JDataView)):
        p = PKG[pkg]
        (tmp_path / pkg).mkdir()
        control = _sqlite_storage(pkg, tmp_path / pkg / "ctl.db")
        assert control.get_meta_data_apps().insert(p.base.App(APP, "replapp")) == APP
        replica = _replica(pkg, tmp_path / pkg)
        primary = _primary(pkg, tmp_path / pkg)
        primary.insert_batch([_ev(pkg, k) for k in range(40)], APP)
        primary.seal(APP)
        primary.insert_batch([_ev(pkg, k, u=f"t{k}") for k in range(5)], APP)
        _shipper(pkg, primary, replica).pass_once()
        storage = p.repl.ReplicaReadStorage(control, replica, [APP])
        kwargs = dict(app_name="replapp", entity_type="user", target_entity_type="item",
                      value_prop="rating")
        dv = view(str(tmp_path / pkg / "view"))
        if pkg == "jax":
            with pytest.raises(AttributeError, match="frame_cache_stats"):
                dv.find_frame(storage, **kwargs)
            continue
        view.stats.update(hits=0, misses=0)
        frames = [dv.find_frame(storage, **kwargs) for _ in range(2)]
        assert view.stats == {"hits": 1, "misses": 1}
        q = p.base.EventQuery(app_id=APP, entity_type="user", target_entity_type="item")
        want = replica.find_frame(q, value_prop="rating")
        for f in frames:
            assert len(f) == 45
            for col in ("event_code", "entity_idx", "target_idx", "time_ms", "value"):
                assert getattr(f, col).tobytes() == getattr(want, col).tobytes(), col
        out[pkg] = len(frames[0])
    assert out == {"port": 45}
