"""The replicated event store: segment shipping, WAL-tail frames and
fenced failover.

Counterpart of the JAX package's ``data/storage/replication.py``, with
its frame protocol, RPC names, files and metric series, so that a
shipper of either package feeds a follower of the other. A segmentfs
primary holds the only copy of every acknowledged event; this module
adds the second copy with the same durability discipline:

- **`SegmentShipper`** (the primary's side) streams two things to N
  follower storage daemons over the daemon's RPC transport (its retry,
  per-DAO breaker and deadline shed): the sealed segment directories,
  addressed by the footer's ``content_hash`` and shipped file by file
  so that a broken transfer resumes at the first missing file, and the
  live WAL tail as revision-watermarked frames. With ``MIN_ACKS > 0``
  it installs segmentfs's commit hook: an insert acks only after that
  many followers applied its frame, so an acknowledged write is on at
  least MIN_ACKS + 1 disks.
- **`ReplicaEventStore`** (the follower's side) is a segmentfs store
  whose mutations arrive as replication RPCs: a shipped segment is
  published by the sealer's crash rule (stage, verify the hashes,
  rename), a WAL frame goes to the follower's own fsync'd WAL and then
  to the unsealed tail, so a follower crash recovers as any segmentfs
  restart does. The reads (`find_since`, `find_frame`,
  `latest_revision`) are segmentfs's own; `replication_lag` gives the
  watermark, so that a reader chooses read-your-writes
  (`wait_for_revision`) or bounded staleness.
- **Fenced failover**: every frame carries the primary's *epoch*, the
  generation of the ``fleet.election.CasElection`` record that made it
  primary. A follower refuses frames below its epoch, so once a
  promotion is seen a zombie primary's late frames cannot be replayed;
  on the old primary's own host segmentfs's writer lock already stops a
  second writer process. `elect_and_promote` stands a follower only
  when no reachable peer is further ahead, then claims, then promotes
  at the won generation.
- **`ReplicaReadStorage`** points an online fold-in consumer at its
  local follower: event reads of the replicated apps go to the
  replica; every other read (the lifecycle records that hold the
  cursors among them) and every write go to the shared control
  storage.

Frame protocol (JSON over the daemon's ``replication`` DAO):
``(epoch, prev_rev, revs, rows, head)``. `revs` is explicit (the live
tail has holes where rows were superseded) and `prev_rev` is the newest
revision the shipper believes the follower holds: a follower below it
answers ``{"gap": ...}`` (a frame was lost: ship again from my
watermark) instead of applying out of order, and a follower above it
trims the overlap (a retried RPC whose first attempt applied is a
no-op). A frame torn mid-ship is a lost frame: the resumed stream
neither skips nor repeats the batch.

The JAX package's lock-sanitizer hook on the follower link's send lock
(``analysis/tsan.py``) is left out: the port has no ``analysis/``.
Standard library only: shippers and replicas live in storage daemons.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from predictionio_tpu_torch.data.storage.base import StorageError
from predictionio_tpu_torch.data.storage.segmentfs import (
    _ROW_ID,
    SegmentFSEventStore,
    _Segment,
    segment_content_hash,
)
from predictionio_tpu_torch.obs.registry import MetricsRegistry, get_default_registry
from predictionio_tpu_torch.utils.env import repl_knob

log = logging.getLogger(__name__)

# the replication election's group (one a store tier)
ELECTION_GROUP = "events-primary"


def _repl_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    reg = registry if registry is not None else get_default_registry()
    return {
        "ship_total": reg.counter(
            "replication_ship_total", "Replication payloads shipped to followers",
            ("kind",)),  # label-bound: literal wal|segment|tombstones
        "ship_bytes": reg.counter(
            "replication_ship_bytes_total", "Serialized bytes shipped to followers"),
        "ship_errors": reg.counter(
            "replication_ship_errors_total",
            "Ship attempts that failed after client-side retries",
            ("follower",)),  # label-bound: PIO_REPL_FOLLOWERS host list
        "applied": reg.counter(
            "replication_applied_total", "Replication payloads applied by this replica",
            ("kind",)),  # label-bound: literal wal|segment|tombstones
        "fenced": reg.counter(
            "replication_fenced_total", "Frames rejected for carrying a stale epoch"),
        "lag": reg.gauge(
            "replication_lag_revisions",
            "Primary head minus this replica's applied watermark",
            ("app",)),  # label-bound: the store's initialized app ids
        "epoch": reg.gauge(
            "replication_epoch", "Current replication epoch (election generation)"),
    }


def _ns_key(app_id: int, channel_id: Optional[int]) -> str:
    return f"{app_id}" if channel_id is None else f"{app_id}:{channel_id}"


def _jsonsafe_rows(rows: Sequence[list]) -> tuple[list, int]:
    """Rows as the local WAL persists them (a JSON round trip with
    default=str) and their serialized size: the follower's tail then
    holds what a primary restart would rebuild from its own WAL."""
    s = json.dumps(list(rows), separators=(",", ":"), default=str)
    return json.loads(s), len(s)


def _contiguous_runs(pairs: Sequence[tuple[int, list]]) -> list[tuple[int, list[list]]]:
    """(rev, row) pairs, revision-ascending with holes, split into the
    maximal contiguous runs a WAL record can frame."""
    runs: list[tuple[int, list[list]]] = []
    for rev, row in pairs:
        if runs and runs[-1][0] + len(runs[-1][1]) == rev:
            runs[-1][1].append(row)
        else:
            runs.append((rev, [row]))
    return runs


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# The follower: ReplicaEventStore
# ---------------------------------------------------------------------------


class ReplicaEventStore(SegmentFSEventStore):
    """The segmentfs follower, storage TYPE ``segmentfs-replica``: a
    follower daemon's events store is the replica, the daemon's
    ``replication`` DAO routes the shipper's RPCs here, and the ordinary
    read RPCs hit segmentfs's reads.

    A store opens as ``replica`` (read-only: inserts and deletes raise)
    unless its persisted ``replication.json`` says it was promoted.
    `promote(epoch)` makes it ``primary`` (writable, the sealer on,
    replication frames refused), durably."""

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self._repl_meta_path = os.path.join(self.base, "replication.json")
        self.epoch = 0
        self.role = "replica"
        self._load_repl_meta()
        # (app, channel) → the newest primary head seen, for the lag gauge
        self._heads: dict[tuple[int, Optional[int]], int] = {}
        self._m = _repl_metrics((config or {}).get("METRICS_REGISTRY"))
        self._m["epoch"].set(self.epoch)

    # -- role and epoch ----------------------------------------------------
    def _load_repl_meta(self) -> None:
        if not os.path.exists(self._repl_meta_path):
            return
        try:
            with open(self._repl_meta_path) as f:
                d = json.load(f)
            self.epoch = int(d.get("epoch", 0))
            self.role = str(d.get("role", "replica"))
        except (OSError, ValueError):
            log.exception("replica meta unreadable; starting at epoch 0")

    def _persist_repl_meta(self) -> None:
        tmp = self._repl_meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": self.epoch, "role": self.role}, f)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self._repl_meta_path)

    def _fence(self, epoch: int) -> None:
        """Under the store lock: refuse a stale epoch; adopt a newer one
        durably BEFORE applying anything stamped with it."""
        epoch = int(epoch)
        if self.role == "primary":
            self._m["fenced"].inc()
            raise StorageError(f"store was promoted at epoch {self.epoch}; it no longer "
                               "accepts replication frames")
        if epoch < self.epoch:
            self._m["fenced"].inc()
            raise StorageError(f"fenced: frame epoch {epoch} < replica epoch {self.epoch} "
                               "(zombie primary?)")
        if epoch > self.epoch:
            self.epoch = epoch
            self._persist_repl_meta()
            self._m["epoch"].set(epoch)

    # -- writes are the primary's until a promotion ------------------------
    def insert_batch(self, events, app_id, channel_id=None):
        with self._lock:
            if self.role != "primary":
                raise StorageError("replica is read-only (role=replica); writes go to the "
                                   "primary — promote() this store only through election")
        return super().insert_batch(events, app_id, channel_id)

    def delete_batch(self, event_ids, app_id, channel_id=None):
        with self._lock:
            if self.role != "primary":
                raise StorageError("replica is read-only (role=replica); deletes go to the "
                                   "primary — promote() this store only through election")
        return super().delete_batch(event_ids, app_id, channel_id)

    def close(self) -> None:
        if self.role == "primary":
            super().close()
            return
        # no close-time seal on a replica: its segment boundaries are the
        # primary's, and a tail sealed here would overlap the primary's
        # segment of those revisions. The tail stays in the WAL
        self._stop.set()
        t = self._sealer
        if t is not None:
            t.join(timeout=10)
            self._sealer = None
        with self._lock:
            for ns in self._ns.values():
                ns.close()
        self._release_writer_lock()

    # -- the replication RPCs ----------------------------------------------
    def replication_status(self) -> dict[str, Any]:
        out: dict[str, Any] = {"epoch": self.epoch, "role": self.role, "namespaces": {}}
        for app, ch in self.ship_namespaces():
            out["namespaces"][_ns_key(app, ch)] = self.ship_state(app, ch)
        return out

    def replication_lag(self, app_id: int, channel_id: Optional[int] = None) -> dict[str, Any]:
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            wm = ns.next_rev - 1
            head = max(self._heads.get((app_id, channel_id), 0), wm)
            return {"watermark": wm, "head": head, "lag": max(0, head - wm),
                    "epoch": self.epoch, "role": self.role}

    def wait_for_revision(self, app_id: int, revision: int, timeout_s: float = 5.0,
                          channel_id: Optional[int] = None) -> bool:
        """Read-your-writes: wait until the watermark reaches `revision`
        (True) or the timeout passes (False)."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                if self._namespace(app_id, channel_id).next_rev - 1 >= revision:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def replication_apply_wal(self, app_id: int, channel_id: Optional[int], epoch: int,
                              prev_rev: int, revs: Sequence[int], rows: Sequence[list],
                              head: int) -> dict[str, Any]:
        """One WAL-tail frame: fence, trim what is already applied,
        refuse a gap, then the follower's own fsync'd WAL (one write and
        one fsync a frame) before the tail, the primary's order."""
        with self._lock:
            self._fence(epoch)
            ns = self._namespace(app_id, channel_id)
            wm = ns.next_rev - 1
            pairs = [(int(r), row) for r, row in zip(revs, rows) if int(r) > wm]
            if not pairs:
                # a retry of an applied frame
                self._note_head(app_id, channel_id, int(head), wm)
                return {"watermark": wm, "epoch": self.epoch}
            if int(prev_rev) > wm:
                # a frame before this one never arrived: applying would
                # skip revisions, so answer with the watermark to ship from
                return {"gap": True, "watermark": wm, "epoch": self.epoch}
            ns.wal_append("".join(
                json.dumps([first, run], separators=(",", ":"), default=str) + "\n"
                for first, run in _contiguous_runs(pairs)))
            was_empty = not ns.tail_by_id
            for rev, row in pairs:
                # holes keep tail index ↔ revision affine, as WAL replay does
                while ns.tail_base + len(ns.tail) < rev:
                    ns.tail.append(None)
                ns._tail_append(row, rev)
                if rev >= ns.next_rev:
                    ns.next_rev = rev + 1
            if was_empty:
                ns.tail_since = time.monotonic()
            new_wm = ns.next_rev - 1
            self._m["applied"].inc(kind="wal")
            self._note_head(app_id, channel_id, int(head), new_wm)
            self._invalidate_frames(app_id, channel_id)
            return {"watermark": new_wm, "epoch": self.epoch}

    def replication_apply_tombstones(self, app_id: int, channel_id: Optional[int],
                                     epoch: int, deleted: dict, ops: int) -> dict[str, Any]:
        with self._lock:
            self._fence(epoch)
            ns = self._namespace(app_id, channel_id)
            for eid, rev in deleted.items():
                rev = int(rev)
                live = ns.id_rev.get(eid)
                if live is not None and live <= rev:
                    ns.tombstones[eid] = rev
                    ns._mask_dead(eid)
            ns.delete_ops = max(ns.delete_ops, int(ops))
            ns.persist_tombstones()
            self._m["applied"].inc(kind="tombstones")
            self._invalidate_frames(app_id, channel_id)
            return {"ops": ns.delete_ops}

    # -- segment shipping, the receiving side ------------------------------
    @staticmethod
    def _staging_dir(ns_path: str, name: str) -> str:
        # not "tmp-": segmentfs recovery wipes tmp-* as unpublished seals,
        # but a half-shipped staging directory is resumable (the
        # manifest lets a shipper skip the files staged intact, across
        # follower restarts too)
        return os.path.join(ns_path, f"repl-{name}")

    def replication_segment_manifest(self, app_id: int, channel_id: Optional[int],
                                     name: str) -> dict[str, Any]:
        """What the follower has of segment `name`: published, or the
        staged files (name → sha256) a resumed ship may skip."""
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            if any(os.path.basename(s.path) == name for s in ns.segments):
                return {"published": True, "staged": {}}
            staging = self._staging_dir(ns.path, name)
        staged: dict[str, str] = {}
        if os.path.isdir(staging):
            for fname in sorted(os.listdir(staging)):
                if not fname.endswith(".part"):
                    staged[fname] = _sha256_file(os.path.join(staging, fname))
        return {"published": False, "staged": staged}

    def replication_segment_file(self, app_id: int, channel_id: Optional[int], epoch: int,
                                 name: str, fname: str, data: bytes, sha256_hex: str) -> bool:
        if "/" in fname or fname.startswith("."):
            raise StorageError(f"invalid segment file name {fname!r}")
        with self._lock:
            self._fence(epoch)
            staging = self._staging_dir(self._namespace(app_id, channel_id).path, name)
        if hashlib.sha256(data).hexdigest() != sha256_hex:
            raise StorageError(f"segment file {name}/{fname} corrupted in flight "
                               "(sha256 mismatch)")
        os.makedirs(staging, exist_ok=True)
        tmp = os.path.join(staging, fname + ".part")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(staging, fname))
        return True

    def replication_commit_segment(self, app_id: int, channel_id: Optional[int], epoch: int,
                                   name: str, files: dict, content_hash: str) -> dict[str, Any]:
        """Verify the staged segment (each file's sha256, then the footer's
        content hash), publish it by a rename (the sealer's crash rule)
        and integrate it into the replica's state."""
        with self._lock:
            self._fence(epoch)
            ns = self._namespace(app_id, channel_id)
            if any(os.path.basename(s.path) == name for s in ns.segments):
                return {"published": True, "watermark": ns.next_rev - 1}
            staging = self._staging_dir(ns.path, name)
        # the hashes outside the lock (disk and CPU)
        for fname, sha in files.items():
            p = os.path.join(staging, fname)
            try:
                got = _sha256_file(p)
            except FileNotFoundError:
                raise StorageError(f"segment {name}: staged file {fname} missing; re-ship it")
            if got != sha:
                os.remove(p)
                raise StorageError(f"segment {name}: staged file {fname} hash mismatch; "
                                   "re-ship it")
        if segment_content_hash(staging) != content_hash:
            shutil.rmtree(staging, ignore_errors=True)
            raise StorageError(f"segment {name}: content hash mismatch after staging; "
                               "staging wiped for a clean re-ship")
        with self._lock:
            self._fence(epoch)
            ns = self._namespace(app_id, channel_id)
            if any(os.path.basename(s.path) == name for s in ns.segments):
                shutil.rmtree(staging, ignore_errors=True)
                return {"published": True, "watermark": ns.next_rev - 1}
            final = os.path.join(ns.path, name)
            os.rename(staging, final)
            self._integrate_segment(ns, _Segment(final))
            self._m["applied"].inc(kind="segment")
            self._invalidate_frames(app_id, channel_id)
            return {"published": True, "watermark": ns.next_rev - 1}

    def _integrate_segment(self, ns, seg: _Segment) -> None:
        """Register a freshly published shipped segment, under the store
        lock: recovery's later-occurrence-wins id walk over the new
        segment's ids only."""
        # a shipped segment that covers existing ones is the primary's
        # compaction of a run this replica had: it replaces them
        covered = [s for s in ns.segments
                   if s.min_rev >= seg.min_rev and s.max_rev <= seg.max_rev]
        ns.segments = [s for s in ns.segments if s not in covered]
        ns.segments.append(seg)
        ns.segments.sort(key=lambda s: s.min_rev)
        for i, (eid, rev) in enumerate(zip(seg.ids(), seg.col("rev").tolist())):
            cur = ns.id_rev.get(eid)
            if cur is None:
                ns.id_rev[eid] = rev
            elif cur < rev:
                ns._mask_dead(eid)
                ns.id_rev[eid] = rev
            elif cur > rev:
                seg.dead.add(i)
            # cur == rev: the same row came earlier in a WAL frame; its
            # tail copy drops with the prefix cut below
        for eid, trev in list(ns.tombstones.items()):
            live = ns.id_rev.get(eid)
            if live is not None and live <= trev:
                ns._mask_dead(eid)
        # the tail prefix the segment now covers (the frames' copies)
        cut = max(0, min(len(ns.tail), seg.max_rev - ns.tail_base + 1))
        del ns.tail[:cut]
        ns.tail_base += cut
        if not ns.tail and ns.tail_base <= seg.max_rev:
            ns.tail_base = seg.max_rev + 1
        ns.tail_by_id = {row[_ROW_ID]: i for i, row in enumerate(ns.tail) if row is not None}
        if seg.max_rev >= ns.next_rev:
            ns.next_rev = seg.max_rev + 1
        ns.persist_rev_floor()
        for s in covered:
            shutil.rmtree(s.path, ignore_errors=True)
        self._reclaim_replica_wal(ns)

    @staticmethod
    def _reclaim_replica_wal(ns) -> None:
        """Drop the closed WAL files that published segments made
        redundant, under the store lock. A replica's WAL files gather
        frames continuously (no rotation at a seal cut, as the sealer
        has), so each closed file's newest framed revision is checked
        against the sealed floor."""
        from predictionio_tpu_torch.resilience.wal import EventWAL

        floor = ns.tail_base - 1
        for p in ns.wal_rotate():
            try:
                mx = 0
                for rec in EventWAL._read_records(p):
                    mx = max(mx, int(rec[0]) + len(rec[1]) - 1)
                if mx <= floor:
                    os.remove(p)
            except FileNotFoundError:
                pass
            except Exception:  # noqa: BLE001 — the next publish retries
                log.debug("replica WAL reclaim skipped %s", p, exc_info=True)

    # -- promotion ---------------------------------------------------------
    def promote(self, epoch: int) -> dict[str, Any]:
        """Fenced promotion to primary at `epoch` (the won generation),
        durably. The same epoch again is a no-op; an epoch at or below
        the one this replica has seen is a stale claim and raises."""
        epoch = int(epoch)
        with self._lock:
            if self.role == "primary" and epoch <= self.epoch:
                return {"role": self.role, "epoch": self.epoch}
            if epoch <= self.epoch:
                raise StorageError(f"stale promotion: epoch {epoch} <= observed {self.epoch}")
            self.role = "primary"
            self.epoch = epoch
            self._persist_repl_meta()
            self._m["epoch"].set(epoch)
            log.info("promoted to primary at epoch %d (base=%s)", epoch, self.base)
            return {"role": "primary", "epoch": epoch}

    def _note_head(self, app_id: int, channel_id: Optional[int], head: int, wm: int) -> None:
        key = (app_id, channel_id)
        head = max(head, self._heads.get(key, 0), wm)
        self._heads[key] = head
        self._m["lag"].set(max(0, head - wm), app=str(app_id))


# ---------------------------------------------------------------------------
# The primary: SegmentShipper
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReplicationConfig:
    followers: tuple[str, ...] = ()
    min_acks: int = 0
    ship_interval_s: float = 0.25
    wal_batch: int = 512
    auth_key: Optional[str] = None
    timeout_s: float = 30.0

    @classmethod
    def from_env(cls, auth_key: Optional[str] = None) -> "ReplicationConfig":
        spec = repl_knob("PIO_REPL_FOLLOWERS").strip()
        return cls(
            followers=tuple(s.strip() for s in spec.split(",") if s.strip()),
            min_acks=repl_knob("PIO_REPL_MIN_ACKS"),
            ship_interval_s=repl_knob("PIO_REPL_SHIP_INTERVAL_S"),
            wal_batch=repl_knob("PIO_REPL_WAL_BATCH"),
            auth_key=auth_key,
        )


class FollowerLink:
    """One follower endpoint: a RemoteClient and a send lock that keeps
    one replication RPC in flight a follower, so that frames arrive in
    the order they were made. The send lock is inner to the store lock
    (the sync hook holds store → link; the background pass reads the
    store first, then takes only the link lock): no deadlock."""

    def __init__(self, hostport: str, auth_key: Optional[str] = None,
                 timeout_s: float = 30.0):
        from predictionio_tpu_torch.data.storage.remote import RemoteClient

        host, _, port = hostport.partition(":")
        if not port:
            raise StorageError(f"follower spec {hostport!r} must be host:port")
        self.name = hostport
        cfg = {"HOST": host, "PORT": port, "TIMEOUT": str(timeout_s)}
        if auth_key:
            cfg["AUTH_KEY"] = auth_key
        self.client = RemoteClient(cfg)
        self.lock = threading.Lock()

    def call(self, method: str, *args: Any, **kwargs: Any) -> Any:
        with self.lock:
            return self.client.call("replication", method, *args, **kwargs)


class SegmentShipper:
    """The primary's side of replication. `start()` starts the background
    ship thread (``repl-shipper``; `stop()` joins it) and, at
    ``min_acks > 0``, installs the store's commit hook, so that inserts
    ack through the followers. Each background pass a follower: its
    status once, the missing segments (resumable, hash-verified), the
    tombstones, then the WAL tail from its watermark to the head."""

    thread_name = "repl-shipper"

    def __init__(self, store: SegmentFSEventStore, config: ReplicationConfig,
                 epoch: int = 1, metrics: Optional[MetricsRegistry] = None):
        if not config.followers:
            raise StorageError("SegmentShipper needs at least one follower")
        self.store = store
        self.config = config
        self.epoch = int(epoch)
        self.links = [FollowerLink(f, config.auth_key, config.timeout_s)
                      for f in config.followers]
        self._m = _repl_metrics(metrics)
        self._m["epoch"].set(self.epoch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self.config.min_acks > 0:
            self.store.set_commit_hook(self._commit_hook)
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name=self.thread_name,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.store.set_commit_hook(None)
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            if not t.is_alive():
                self._thread = None
            # on a timeout the handle stays, so that a later stop() joins

    def _loop(self) -> None:
        while not self._stop.wait(self.config.ship_interval_s):
            try:
                self.pass_once()
            except Exception:  # noqa: BLE001 — the next pass retries
                log.exception("replication ship pass failed; will retry")

    # -- the synchronous path (the commit hook) ----------------------------
    def _commit_hook(self, app_id: int, channel_id: Optional[int], first_rev: int,
                     rows: Sequence[list], head: int) -> None:
        """Called by insert_batch under the store lock (frames leave in
        revision order). Raises when fewer than min_acks followers
        applied the frame: the rows stay durable here and the background
        pass ships them again, but the caller sees the failure."""
        safe_rows, nbytes = _jsonsafe_rows(rows)
        revs = list(range(first_rev, first_rev + len(safe_rows)))
        acks = 0
        errors: list[str] = []
        for link in self.links:
            try:
                self._send_frame(link, app_id, channel_id, first_rev - 1, revs, safe_rows,
                                 head, nbytes)
                acks += 1
            except Exception as e:  # noqa: BLE001 — one follower's failure is its own
                self._m["ship_errors"].inc(follower=link.name)
                errors.append(f"{link.name}: {e}")
        if acks < self.config.min_acks:
            raise StorageError(
                f"replication ack floor not met ({acks}/{self.config.min_acks}); events are "
                "durable locally and will re-ship, but this batch is under-replicated: "
                + "; ".join(errors))

    def _send_frame(self, link, app_id: int, channel_id: Optional[int], prev_rev: int,
                    revs: list[int], rows: list, head: int, nbytes: int) -> dict:
        resp = link.call("replication_apply_wal", app_id, channel_id, self.epoch, prev_rev,
                         revs, rows, head)
        if resp.get("gap"):
            # the follower lacks earlier frames: backfill from its
            # watermark, which delivers this frame's rows too
            self._catch_up_wal(link, app_id, channel_id, int(resp["watermark"]))
        else:
            self._m["ship_total"].inc(kind="wal")
            self._m["ship_bytes"].inc(nbytes)
        return resp

    # -- the background pass -----------------------------------------------
    def pass_once(self) -> None:
        namespaces = self.store.ship_namespaces()
        for link in self.links:
            try:
                status = link.call("replication_status")
            except Exception:  # noqa: BLE001 — an unreachable follower waits
                self._m["ship_errors"].inc(follower=link.name)
                log.debug("follower %s unreachable this pass", link.name, exc_info=True)
                continue
            follower_ns = status.get("namespaces", {})
            for app, ch in namespaces:
                try:
                    self._sync_ns(link, app, ch, follower_ns.get(_ns_key(app, ch), {}))
                except Exception:  # noqa: BLE001 — the next pass retries
                    self._m["ship_errors"].inc(follower=link.name)
                    log.debug("ship of app %s to %s failed this pass", app, link.name,
                              exc_info=True)

    def _sync_ns(self, link, app_id: int, channel_id: Optional[int],
                 follower_state: dict) -> None:
        st = self.store.ship_state(app_id, channel_id)
        have = set(follower_state.get("segments", {}))
        for name in st["segments"]:
            if name not in have:
                self._ship_segment(link, app_id, channel_id, name)
        if st["tombstone_ops"] > int(follower_state.get("tombstone_ops", 0)):
            deleted, ops = self.store.ship_tombstones(app_id, channel_id)
            link.call("replication_apply_tombstones", app_id, channel_id, self.epoch,
                      deleted, ops)
            self._m["ship_total"].inc(kind="tombstones")
        wm = int(link.call("replication_lag", app_id, channel_id)["watermark"])
        self._catch_up_wal(link, app_id, channel_id, wm)

    def _catch_up_wal(self, link, app_id: int, channel_id: Optional[int],
                      watermark: int) -> None:
        """Live-tail frames from `watermark` until the follower reaches
        the head, or stops advancing (sealed rows only a segment ship
        gives)."""
        while True:
            t = self.store.ship_tail_after(app_id, channel_id, watermark,
                                           self.config.wal_batch)
            if t["floor"] > watermark:
                # the follower needs sealed revisions the tail no longer
                # holds: this pass's segment ship (or the next) has them
                return
            if not t["revs"]:
                return
            rows, nbytes = _jsonsafe_rows(t["rows"])
            resp = link.call("replication_apply_wal", app_id, channel_id, self.epoch,
                             watermark, list(map(int, t["revs"])), rows, t["head"])
            new_wm = int(resp.get("watermark", watermark))
            if not resp.get("gap"):
                self._m["ship_total"].inc(kind="wal")
                self._m["ship_bytes"].inc(nbytes)
            if new_wm <= watermark:
                return  # no progress: stop rather than spin
            watermark = new_wm
            if watermark >= int(t["head"]):
                return

    def _ship_segment(self, link, app_id: int, channel_id: Optional[int], name: str) -> None:
        path = self.store.ship_segment_path(app_id, channel_id, name)
        if path is None:
            return  # compacted away; the next pass ships the merged segment
        man = link.call("replication_segment_manifest", app_id, channel_id, name)
        if man.get("published"):
            return
        staged = man.get("staged", {})
        try:
            fnames = sorted(n for n in os.listdir(path) if not n.startswith("."))
            with open(os.path.join(path, "footer.json")) as f:
                footer = json.load(f)
            # a footer without the field is hashed here (the hash never
            # reads the footer)
            content_hash = footer.get("content_hash") or segment_content_hash(path)
            files: dict[str, str] = {}
            for fname in fnames:
                with open(os.path.join(path, fname), "rb") as f:
                    data = f.read()
                sha = hashlib.sha256(data).hexdigest()
                files[fname] = sha
                if staged.get(fname) == sha:
                    continue  # a resumed ship: staged intact already
                link.call("replication_segment_file", app_id, channel_id, self.epoch, name,
                          fname, data, sha)
                self._m["ship_bytes"].inc(len(data))
        except FileNotFoundError:
            return  # compaction took it mid-read; the next pass
        link.call("replication_commit_segment", app_id, channel_id, self.epoch, name, files,
                  content_hash)
        self._m["ship_total"].inc(kind="segment")


# ---------------------------------------------------------------------------
# Fenced failover
# ---------------------------------------------------------------------------


def elect_and_promote(records, store: ReplicaEventStore, candidate: str,
                      peers: Sequence[Any] = (), group: str = ELECTION_GROUP,
                      settle_s: float = 0.0) -> Optional[int]:
    """Promote `store` through a fenced CAS election: the new epoch, or
    None when this candidate lost or was not caught up.

    The catch-up gate: a follower stands only when no REACHABLE peer
    reports a higher watermark of any namespace (the dead primary does
    not answer and does not vote; a sibling further ahead makes this one
    withdraw). The won generation is the store's epoch, so a follower
    that sees one frame of the new epoch (or the promotion itself)
    fences the old primary's epoch."""
    from predictionio_tpu_torch.fleet.election import CasElection

    local = store.replication_status()["namespaces"]
    for peer in peers:
        try:
            peer_status = peer.call("replication_status")
        except Exception:  # noqa: BLE001 — an unreachable peer does not vote
            continue
        for key, pns in peer_status.get("namespaces", {}).items():
            local_wm = int(local.get(key, {}).get("watermark", 0))
            if int(pns.get("watermark", 0)) > local_wm:
                log.info("withdrawing %s: peer ahead on %s (%s > %s)", candidate, key,
                         pns.get("watermark"), local_wm)
                return None
    election = CasElection(records, group)
    # the bid must pass both the settled generation and the epoch this
    # follower saw in frames: an original primary that never ran an
    # election still stamped an epoch, and a generation at or below it
    # would make promote() a stale claim
    generation = election.claim(candidate, settle_s=settle_s,
                                generation=max(election.state().generation + 1,
                                               store.epoch + 1))
    if generation is None:
        return None
    store.promote(generation)
    return generation


# ---------------------------------------------------------------------------
# Reads for a consumer beside a follower
# ---------------------------------------------------------------------------


class ReplicaReadStorage:
    """A Storage view for fold-in consumers beside a follower: event
    READS of the replicated apps come from the local replica (bounded
    staleness, no hop to another host); writes and every other
    namespace (the lifecycle records that hold the cursors, the model
    registry, the election) stay on the shared control storage. All
    but `get_events` passes through."""

    def __init__(self, control, replica, app_ids: Sequence[int]):
        self._control = control
        self._events = _ReplicaReadEvents(control.get_events(), replica,
                                          frozenset(int(a) for a in app_ids))

    def get_events(self):
        return self._events

    def __getattr__(self, name: str) -> Any:
        return getattr(self._control, name)


class _ReplicaReadEvents:
    """The event store facade routing by app id: reads of replicated
    apps → the replica; everything else, and every write → control."""

    def __init__(self, control, replica, app_ids: frozenset):
        self._control = control
        self._replica = replica
        self._app_ids = app_ids

    def _route(self, app_id: int):
        return self._replica if int(app_id) in self._app_ids else self._control

    def get(self, event_id, app_id, channel_id=None):
        return self._route(app_id).get(event_id, app_id, channel_id)

    def find(self, query):
        return self._route(query.app_id).find(query)

    def find_since(self, app_id, after_revision, channel_id=None, limit=None, shard=None):
        return self._route(app_id).find_since(app_id, after_revision, channel_id=channel_id,
                                              limit=limit, shard=shard)

    def latest_revision(self, app_id, channel_id=None):
        return self._route(app_id).latest_revision(app_id, channel_id)

    def data_signature(self, app_id, channel_id=None):
        return self._route(app_id).data_signature(app_id, channel_id)

    def find_frame(self, query, value_prop=None, default_value=1.0):
        return self._route(query.app_id).find_frame(query, value_prop, default_value)

    def find_frame_parts(self, query, value_prop=None, default_value=1.0):
        return self._route(query.app_id).find_frame_parts(query, value_prop, default_value)

    def find_entities_batch(self, app_id, *args, **kwargs):
        return self._route(app_id).find_entities_batch(app_id, *args, **kwargs)

    def find_single_entity(self, app_id, *args, **kwargs):
        return self._route(app_id).find_single_entity(app_id, *args, **kwargs)

    def find_edges(self, app_id, *args, **kwargs):
        # the port's fold-in history read (the JAX package's fold reads
        # through find)
        return self._route(app_id).find_edges(app_id, *args, **kwargs)

    def revision_streams(self):
        # one stream whose reads route by app: replica revisions ARE the
        # primary's, so they stay comparable
        return [("0", self, None)]

    def replication_lag(self, app_id, channel_id=None):
        if hasattr(self._replica, "replication_lag"):
            return self._replica.replication_lag(app_id, channel_id)
        return {"watermark": 0, "head": 0, "lag": 0}

    @property
    def frame_cache_stats(self) -> dict:
        # the data view's segment branch reads the sealed-rows cache's
        # counts around a read: the replica's, which serves the
        # replicated apps' frames (the JAX facade passes this to the
        # control store, which has none, and a train through the data
        # view over it fails)
        return getattr(self._replica, "frame_cache_stats", {"hits": 0, "misses": 0})

    # everything else (writes, app admin) goes to control
    def __getattr__(self, name: str) -> Any:
        return getattr(self._control, name)
