"""segmentfs: the columnar event store (an fsync'd WAL sealed into column
segments).

Counterpart of the JAX package's ``data/storage/segmentfs.py``, with
the same on-disk layout, so that a PATH written by either package is
read by the other: the same file names, ``footer.json`` keys, ``.npy``
dtypes, WAL lines and content hash.

- **Ingest** appends to a per-(app, channel) WAL: one JSON line per
  ``insert_batch`` (``[first_revision, [row, ...]]``, the positional row
  layout below), fsync'd before the ack; a torn last line from a crash
  mid-append is skipped on reopen, as ``resilience/wal.py`` skips one.
  The accepted rows stay in memory as the unsealed tail, and the store
  assigns the insert revisions the online consumer tails by.
- A background **sealer** (the ``segmentfs-sealer`` thread, or
  ``maintain``) turns the tail into an immutable segment: event code,
  entity, target, time and revision columns as ``.npy`` files, float32
  columns of the numeric properties, the ids and the other fields as
  JSON sidecars, and a ``footer.json`` with the vocabularies in
  first-seen order, the revision and time ranges and a bloom filter of
  the entity ids. The build runs outside the store lock (ingest goes on
  into a fresh WAL file); the segment is published by an atomic rename.
  Revisions survive sealing and compaction, so a consumer's cursor reads
  each revision once across both.
- **find_frame** is the training read: mmapped columns concatenated and
  their vocabularies remapped with numpy, bit-identical to
  ``EventFrame.from_events(find(q))``. The sealed rows' arrays are cached
  under the segment ids, so a retrain after tail-only ingest folds only
  the tail; ``find_frame_parts`` lays the rows out sealed-first for the
  device stager (``parallel/loader.py``).
- **Compaction** merges small adjacent segments and drops the rows that
  later writes superseded or deleted.
- ``data_signature`` is (max revision, delete ops): every mutation
  either assigns a revision or counts a delete.

Durability: an acknowledged insert is in the fsync'd WAL (``FSYNC`` 0
skips the fsync); a crash between a seal and the WAL's reclaim replays
nothing twice, since recovery skips WAL records at or below the last
sealed revision. An insert of an existing event id supersedes the old
row (the SQL stores' INSERT OR REPLACE). One writer process per PATH:
an exclusive ``fcntl.lockf`` on ``<PATH>/.writer.lock`` refuses a second
process with a StorageError (a second open in the same process is
allowed, as after a crash).

Layout under PATH::

    app_{appId}[_{channelId}]/
      wal-{seq:06d}.jsonl           # unsealed tail, [first_rev, [row,...]] per batch
      tombstones.json               # {"deleted": {id: rev}, "ops": N}
      meta.json                     # {"rev_floor": high-water revision}
      seg-{minrev:012d}-{maxrev:012d}/
        rev.npy event_code.npy etype_code.npy entity_idx.npy
        ttype_code.npy target_idx.npy time_ms.npy ctime_ms.npy
        val-{k}.npy                 # one float32 column per numeric prop
        ids.json rows.json          # sidecars: event ids; [props, tags, prId]
        footer.json                 # vocabs + min/max rev + bloom

Configure::

    PIO_STORAGE_SOURCES_<NAME>_TYPE=segmentfs
    PIO_STORAGE_SOURCES_<NAME>_PATH=/var/pio/segments
    # optional: SEAL_EVENTS (8192), SEAL_AGE_S (2.0), SEAL_INTERVAL_S
    # (0.25), COMPACT_SEGMENTS (8), COMPACT_MAX_ROWS (65536), FSYNC (1)

and point PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE at it: segmentfs
stores events only, so METADATA and MODELDATA stay on another source
(docfs, sqlite, localfs). A partitioned read (``EventQuery.shard``,
``find_since``'s ``shard``) filters the sealed rows through each
segment's entity vocabulary and the tail row by row. The replication
seam (``set_commit_hook`` and the ``ship_*`` methods) is what
``replication.py``'s shipper reads a primary through.
"""

from __future__ import annotations

import bisect
import datetime as _dt
import hashlib
import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any, Iterator, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import EventQuery, StorageError
from predictionio_tpu_torch.data.store.bimap import BiMap
from predictionio_tpu_torch.data.store.columnar import EventFrame, _float_prop

log = logging.getLogger(__name__)

_UTC = _dt.timezone.utc


def _ms(t: _dt.datetime) -> int:
    return int(t.timestamp() * 1000)


def _from_ms(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, _UTC)


# numeric properties made columns per segment; the others are read from
# the rows.json sidecar
_MAX_VALUE_PROPS = 16

# positional row layout of the WAL, the unsealed tail and the seal build
# [0]=event_id [1]=event [2]=entity_type [3]=entity_id
# [4]=target_entity_type [5]=target_entity_id [6]=properties dict
# [7]=event_time_ms [8]=tags list|None [9]=pr_id [10]=creation_time_ms
_ROW_ID, _ROW_EVENT, _ROW_ETYPE, _ROW_EID = 0, 1, 2, 3
_ROW_TTYPE, _ROW_TID, _ROW_PROPS, _ROW_TIME = 4, 5, 6, 7
_ROW_TAGS, _ROW_PRID, _ROW_CTIME = 8, 9, 10

#: rows a materialized page: bounds the decoded columns of a large scan
_PAGE_ROWS = 2048


def _event_row(e: Event, eid: str) -> list:
    return [
        eid, e.event, e.entity_type, e.entity_id,
        e.target_entity_type, e.target_entity_id,
        dict(e.properties), _ms(e.event_time),
        list(e.tags) if e.tags else None, e.pr_id,
        _ms(e.creation_time),
    ]


def _row_event(row: Sequence, rev: int) -> Event:
    """Row → Event without validation: every row was validated when its
    event was first inserted."""
    e = object.__new__(Event)
    d = e.__dict__
    d["event"] = row[_ROW_EVENT]
    d["entity_type"] = row[_ROW_ETYPE]
    d["entity_id"] = row[_ROW_EID]
    d["target_entity_type"] = row[_ROW_TTYPE]
    d["target_entity_id"] = row[_ROW_TID]
    d["properties"] = dict(row[_ROW_PROPS] or {})
    d["event_time"] = _from_ms(row[_ROW_TIME])
    d["tags"] = tuple(row[_ROW_TAGS] or ())
    d["pr_id"] = row[_ROW_PRID]
    d["creation_time"] = _from_ms(row[_ROW_CTIME])
    d["event_id"] = row[_ROW_ID]
    d["revision"] = rev
    return e


def _gen_ids(n: int) -> list[str]:
    """`n` event ids from one read of the entropy source, each 32 hex
    characters like uuid4().hex."""
    raw = os.urandom(16 * n).hex()
    return [raw[i << 5 : (i + 1) << 5] for i in range(n)]


# ---------------------------------------------------------------------------
# Bloom filter over a segment's entity ids (footer metadata): the cheap
# first gate of an entity-scoped read; the footer's exact vocabulary is
# the second.
# ---------------------------------------------------------------------------


def _bloom_build(ids: Sequence[str], bits_per_key: int = 10) -> tuple[bytes, int]:
    n_bits = max(64, len(ids) * bits_per_key)
    arr = bytearray((n_bits + 7) // 8)
    for s in ids:
        for salt in (0, 0x9E3779B9, 0x85EBCA6B):
            h = zlib.crc32(s.encode(), salt) % n_bits
            arr[h >> 3] |= 1 << (h & 7)
    return bytes(arr), n_bits


def _bloom_maybe(bloom: bytes, n_bits: int, s: str) -> bool:
    for salt in (0, 0x9E3779B9, 0x85EBCA6B):
        h = zlib.crc32(s.encode(), salt) % n_bits
        if not (bloom[h >> 3] & (1 << (h & 7))):
            return False
    return True


# ---------------------------------------------------------------------------
# Sealed segment
# ---------------------------------------------------------------------------


class _Segment:
    """One immutable sealed segment: the footer read at open, columns
    and sidecars mmapped or parsed on first use and kept."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "footer.json")) as f:
            self.footer = json.load(f)
        self.min_rev: int = self.footer["min_rev"]
        self.max_rev: int = self.footer["max_rev"]
        self.n_rows: int = self.footer["n_rows"]
        self._bloom = bytes.fromhex(self.footer["entity_bloom"])
        self._bloom_bits: int = self.footer["bloom_bits"]
        # rows that later overwrites and deletes masked (rebuilt from the
        # ids at open; added to by live mutations)
        self.dead: set[int] = set()
        self._cols: dict[str, np.ndarray] = {}
        self._ids: Optional[list[str]] = None
        self._ids_np: Optional[np.ndarray] = None
        self._rows: Optional[list] = None
        self._vocab_np: dict[str, np.ndarray] = {}

    def col(self, name: str) -> np.ndarray:
        a = self._cols.get(name)
        if a is None:
            a = np.load(os.path.join(self.path, f"{name}.npy"), mmap_mode="r")
            self._cols[name] = a
        return a

    def value_col(self, prop: str) -> Optional[np.ndarray]:
        """The float32 column of a numeric property (NaN where a row has
        none); None when the property was not made a column."""
        idx = self.footer["value_props"].get(prop)
        if idx is None:
            return None
        return self.col(f"val-{idx}")

    def ids(self) -> list[str]:
        if self._ids is None:
            with open(os.path.join(self.path, "ids.json")) as f:
                self._ids = json.load(f)
        return self._ids

    def ids_np(self) -> np.ndarray:
        if self._ids_np is None:
            self._ids_np = np.asarray(self.ids())
        return self._ids_np

    def vocab_np(self, key: str) -> np.ndarray:
        """A footer vocabulary as a numpy string array (rows decode as
        vocab_np[code column])."""
        a = self._vocab_np.get(key)
        if a is None:
            vals = self.footer[key]
            a = np.asarray(vals) if vals else np.asarray([""], dtype=str)
            self._vocab_np[key] = a
        return a

    def sidecar_rows(self) -> list:
        """[properties, tags, pr_id] a row (only the Event reads use it)."""
        if self._rows is None:
            with open(os.path.join(self.path, "rows.json")) as f:
                self._rows = json.load(f)
        return self._rows

    def row_of_rev(self, rev: int) -> Optional[int]:
        """The row holding revision `rev`, or None: revisions ascend
        within a segment (gaps after compaction), so a searchsorted."""
        col = self.col("rev")
        i = int(np.searchsorted(col, rev))
        if i < len(col) and int(col[i]) == rev:
            return i
        return None

    def maybe_has_entity(self, entity_id: str) -> bool:
        return _bloom_maybe(self._bloom, self._bloom_bits, entity_id)

    def has_target(self, target_id: str) -> bool:
        """Exact posting check: the footer's target vocabulary."""
        return target_id in self.footer["target_ids"]

    def row(self, i: int) -> list:
        """Row `i` in the positional layout (the compaction's input)."""
        props, tags, pr_id = self.sidecar_rows()[i]
        ttype_i = int(self.col("ttype_code")[i])
        tgt_i = int(self.col("target_idx")[i])
        return [
            self.ids()[i],
            self.footer["event_names"][int(self.col("event_code")[i])],
            self.footer["entity_types"][int(self.col("etype_code")[i])],
            self.footer["entity_ids"][int(self.col("entity_idx")[i])],
            self.footer["target_types"][ttype_i] if ttype_i >= 0 else None,
            self.footer["target_ids"][tgt_i] if tgt_i >= 0 else None,
            props,
            int(self.col("time_ms")[i]),
            tags or None,
            pr_id,
            int(self.col("ctime_ms")[i]),
        ]

    def event(self, i: int) -> Event:
        """Row `i` as an Event."""
        return _row_event(self.row(i), int(self.col("rev")[i]))

    def events_page(self, rows: np.ndarray) -> list[Event]:
        """A page of rows as Events: each column gathered for the whole
        page by one numpy fancy index into Python values, then one Event
        a row."""
        rows = np.asarray(rows, np.int64)
        if not len(rows):
            return []
        ft = self.footer
        en, et, ei = ft["event_names"], ft["entity_types"], ft["entity_ids"]
        tt, ti = ft["target_types"], ft["target_ids"]
        all_ids, sidecar = self.ids(), self.sidecar_rows()
        new, setattr_, fromts = object.__new__, object.__setattr__, _dt.datetime.fromtimestamp
        out: list[Event] = []
        for i, rev, ec, tc, xc, ttc, tic, ms, cms in zip(
                rows.tolist(), *(np.asarray(self.col(c))[rows].tolist() for c in (
                    "rev", "event_code", "etype_code", "entity_idx", "ttype_code",
                    "target_idx", "time_ms", "ctime_ms"))):
            props, tags, pr_id = sidecar[i]
            e = new(Event)
            setattr_(e, "__dict__", {
                "event": en[ec], "entity_type": et[tc], "entity_id": ei[xc],
                "target_entity_type": tt[ttc] if ttc >= 0 else None,
                "target_entity_id": ti[tic] if tic >= 0 else None,
                "properties": dict(props or {}),
                "event_time": fromts(ms / 1000.0, _UTC), "tags": tuple(tags or ()),
                "pr_id": pr_id, "creation_time": fromts(cms / 1000.0, _UTC),
                "event_id": all_ids[i], "revision": rev})
            out.append(e)
        return out


def _in_shard(seg: _Segment, shard: tuple[int, int]) -> np.ndarray:
    """Whether each of the segment's distinct entities is in partition
    `shard` = (i, n): one hash an entity, looked up by a row's code."""
    sidx, n = shard
    vocab = seg.footer["entity_ids"]
    return np.fromiter((base.shard_of(eid, n) == sidx for eid in vocab),
                       dtype=bool, count=len(vocab))


def _rank_first_seen(sel: np.ndarray) -> tuple[list[str], np.ndarray]:
    """Interning in first-seen order (``BiMap.string_int``), vectorized:
    (vocabulary, int32 codes of `sel`). The seal's columns and the
    frame's vocabularies both use it, so the two cannot diverge."""
    uniq, first, inv = np.unique(sel, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int32)
    rank[order] = np.arange(len(uniq), dtype=np.int32)
    return [str(uniq[j]) for j in order], rank[inv].astype(np.int32)


def _first_seen(values: Sequence) -> tuple[list, np.ndarray]:
    """Interning of a column that may hold None: (vocabulary in
    first-seen order, int32 codes, -1 for None)."""
    arr = np.asarray(["" if v is None else v for v in values], dtype=str)
    valid = np.asarray([v is not None for v in values], dtype=bool)
    sel = arr[valid]
    if not len(sel):
        return [], np.full(len(values), -1, np.int32)
    vocab, codes_sel = _rank_first_seen(sel)
    codes = np.full(len(values), -1, np.int32)
    codes[valid] = codes_sel
    return vocab, codes


def segment_content_hash(seg_dir: str) -> str:
    """Content address of a segment directory: sha256 over each data
    file's (name, sha256 of its bytes) in name order, footer.json (which
    holds the hash) and dot files left out."""
    acc = hashlib.sha256()
    for fname in sorted(os.listdir(seg_dir)):
        if fname == "footer.json" or fname.startswith("."):
            continue
        h = hashlib.sha256()
        with open(os.path.join(seg_dir, fname), "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        acc.update(fname.encode())
        acc.update(h.digest())
    return acc.hexdigest()


def _write_segment(ns_dir: str, rows: Sequence[Sequence], revs: Sequence[int]) -> str:
    """One immutable segment from revision-ordered rows, published by a
    temporary directory's rename. Returns its path."""
    assert rows
    min_rev, max_rev = int(revs[0]), int(revs[-1])
    name = f"seg-{min_rev:012d}-{max_rev:012d}"
    tmp = os.path.join(ns_dir, f"tmp-{name}-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)

    (ids, names, etypes, eids, ttypes, tids, props, times, tags, prids,
     ctimes) = zip(*rows)

    event_names, event_code = _first_seen(names)
    entity_types, etype_code = _first_seen(etypes)
    entity_ids, entity_idx = _first_seen(eids)
    target_types, ttype_code = _first_seen(ttypes)
    target_ids, target_idx = _first_seen(tids)

    cols: dict[str, np.ndarray] = {
        "rev": np.asarray(revs, np.int64),
        "event_code": event_code,
        "etype_code": etype_code,
        "entity_idx": entity_idx,
        "ttype_code": ttype_code,
        "target_idx": target_idx,
        "time_ms": np.asarray(times, np.int64),
        "ctime_ms": np.asarray(ctimes, np.int64),
    }

    # each top-level property that is a number (not a bool) on every row
    # that has it becomes a float32 column, NaN where absent, most
    # frequent first
    candidates: dict[str, int] = {}
    for p in props:
        for k in p:
            candidates[k] = candidates.get(k, 0) + 1
    value_props: dict[str, int] = {}
    for prop, _n in sorted(candidates.items(), key=lambda kv: -kv[1]):
        if len(value_props) >= _MAX_VALUE_PROPS:
            break
        col = np.full(len(rows), np.nan, np.float32)
        ok = True
        for i, p in enumerate(props):
            v = p.get(prop)
            if v is None:
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                col[i] = v
            else:
                ok = False
                break
        if ok:
            idx = len(value_props)
            value_props[prop] = idx
            cols[f"val-{idx}"] = col

    for cname, arr in cols.items():
        np.save(os.path.join(tmp, f"{cname}.npy"), arr)
    # json.dumps, not json.dump: the same bytes through the C encoder
    with open(os.path.join(tmp, "ids.json"), "w") as f:
        f.write(json.dumps(list(ids)))
    with open(os.path.join(tmp, "rows.json"), "w") as f:
        f.write(json.dumps([[p, tg or [], pr] for p, tg, pr in zip(props, tags, prids)],
                           default=str))
    bloom, n_bits = _bloom_build(entity_ids)
    times_arr = cols["time_ms"]
    content_hash = segment_content_hash(tmp)
    with open(os.path.join(tmp, "footer.json"), "w") as f:
        json.dump(
            {
                "min_rev": min_rev,
                "max_rev": max_rev,
                "content_hash": content_hash,
                "n_rows": len(rows),
                "event_names": event_names,
                "entity_types": entity_types,
                "entity_ids": entity_ids,
                "target_types": target_types,
                "target_ids": target_ids,
                "value_props": value_props,
                "time_min_ms": int(times_arr.min()),
                "time_max_ms": int(times_arr.max()),
                "entity_bloom": bloom.hex(),
                "bloom_bits": n_bits,
            },
            f,
        )
    final = os.path.join(ns_dir, name)
    os.rename(tmp, final)
    return final


# ---------------------------------------------------------------------------
# Per-namespace state
# ---------------------------------------------------------------------------


class _Namespace:
    """The mutable state of one (app, channel): the unsealed tail (rows;
    tail[i] holds revision tail_base + i, None when superseded), the
    sealed segments, id → latest revision, the tombstones. Read and
    written under the store's lock; seal and compaction builds take a
    snapshot under it and publish under it."""

    def __init__(self, path: str, fsync: bool):
        self.path = path
        self.fsync = fsync
        os.makedirs(path, exist_ok=True)
        self.segments: list[_Segment] = []
        self.tail: list[Optional[list]] = []
        self.tail_base = 1  # revision of tail[0]
        self.tail_by_id: dict[str, int] = {}  # id → tail index
        self.id_rev: dict[str, int] = {}  # live id → latest revision
        self.tombstones: dict[str, int] = {}  # deleted id → revision at delete
        self.delete_ops = 0
        self.next_rev = 1
        self.tail_since = 0.0  # monotonic time of the oldest tail event
        # one seal and one compaction at a time a namespace (their builds
        # run outside the store's lock)
        self.sealing = False
        self.compacting = False
        self.removed = False
        self._meta_path = os.path.join(path, "meta.json")
        self._wal_seq = 0
        self._wal_file = None
        self._recover()

    # -- open and crash recovery -------------------------------------------
    def _recover(self) -> None:
        from predictionio_tpu_torch.resilience.wal import EventWAL

        # tmp- directories are seals a crash left unpublished: the WAL
        # still holds their events
        for n in os.listdir(self.path):
            if n.startswith("tmp-"):
                shutil.rmtree(os.path.join(self.path, n), ignore_errors=True)
        segs = sorted(n for n in os.listdir(self.path) if n.startswith("seg-"))
        self.segments = [_Segment(os.path.join(self.path, n)) for n in segs]
        self.segments.sort(key=lambda s: s.min_rev)
        tomb_path = os.path.join(self.path, "tombstones.json")
        if os.path.exists(tomb_path):
            with open(tomb_path) as f:
                d = json.load(f)
            self.tombstones = {k: int(v) for k, v in d["deleted"].items()}
            self.delete_ops = int(d["ops"])
        # the high-water revision: a seal reclaims WAL files, and a tail
        # whose newest rows were deleted would otherwise lose it, so that
        # a reopened store went on from a revision it had given out
        rev_floor = 0
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                rev_floor = int(json.load(f).get("rev_floor", 0))
        # id → latest revision; a later row of an id masks the earlier
        where: dict[str, tuple[int, int]] = {}  # id → (segment index, row)
        max_rev = 0
        for sx, seg in enumerate(self.segments):
            max_rev = max(max_rev, seg.max_rev)
            # one conversion of the column: a memmap's item reads are a
            # Python call each
            for i, (eid, rev) in enumerate(zip(seg.ids(), seg.col("rev").tolist())):
                prev = where.get(eid)
                if prev is not None:
                    self.segments[prev[0]].dead.add(prev[1])
                where[eid] = (sx, i)
                self.id_rev[eid] = rev
        # WAL replay: a record at or below the last sealed revision was
        # sealed before a crash kept its WAL file from being reclaimed
        self.tail_base = max_rev + 1
        for name in self._wal_files():
            self._wal_seq = max(self._wal_seq, int(name.split("-")[1].split(".")[0]))
            for rec in EventWAL._read_records(os.path.join(self.path, name)):
                first = int(rec[0])
                for k, row in enumerate(rec[1]):
                    rev = first + k
                    if rev <= max_rev:
                        continue
                    # holes keep tail index ↔ revision affine
                    while self.tail_base + len(self.tail) < rev:
                        self.tail.append(None)
                    self._tail_append(row, rev, where)
                    max_rev = max(max_rev, rev)
        self.next_rev = max(max_rev, rev_floor) + 1
        for eid, rev in list(self.tombstones.items()):
            live = self.id_rev.get(eid)
            if live is None:
                del self.tombstones[eid]
            elif live <= rev:
                self._mask_dead(eid, where)
            else:
                del self.tombstones[eid]  # inserted again after the delete
        if self.tail:
            self.tail_since = time.monotonic()

    def _tail_append(self, row: list, rev: int, where: Optional[dict] = None) -> None:
        eid = row[_ROW_ID]
        prev_tail = self.tail_by_id.get(eid)
        if prev_tail is not None:
            self.tail[prev_tail] = None
        elif eid in self.id_rev:
            self._mask_sealed_dead(eid, where)
        self.tail_by_id[eid] = len(self.tail)
        self.tail.append(row)
        self.id_rev[eid] = rev

    def _mask_sealed_dead(self, eid: str, where: Optional[dict] = None) -> None:
        rev = self.id_rev.get(eid)
        if rev is None:
            return
        if where is not None:
            loc = where.get(eid)
            if loc is not None:
                self.segments[loc[0]].dead.add(loc[1])
                return
        seg = self.segment_for_rev(rev)
        if seg is not None:
            row = seg.row_of_rev(rev)
            if row is not None:
                seg.dead.add(row)

    def _mask_dead(self, eid: str, where: Optional[dict] = None) -> None:
        """Mask the id's current row (tombstone or overwrite) and drop
        its revision."""
        ti = self.tail_by_id.pop(eid, None)
        if ti is not None:
            self.tail[ti] = None
        else:
            self._mask_sealed_dead(eid, where)
        self.id_rev.pop(eid, None)

    # -- WAL ---------------------------------------------------------------
    def _wal_files(self) -> list[str]:
        """WAL file names, oldest first (fixed-width sequence numbers)."""
        try:
            return sorted(n for n in os.listdir(self.path)
                          if n.startswith("wal-") and n.endswith(".jsonl"))
        except FileNotFoundError:
            return []

    def wal_append(self, line: str) -> None:
        if self._wal_file is None:
            self._wal_seq += 1
            self._wal_file = open(
                os.path.join(self.path, f"wal-{self._wal_seq:06d}.jsonl"), "a")
        self._wal_file.write(line)
        self._wal_file.flush()
        if self.fsync:
            # under the store's lock by design: the fsync before the ack
            # and the revisions' assignment are one critical section
            os.fsync(self._wal_file.fileno())

    def wal_rotate(self) -> list[str]:
        """Close the current WAL file (the next append opens a new one);
        returns the existing files' paths, which hold exactly the records
        assigned so far and may be reclaimed once those are sealed."""
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = None
        return [os.path.join(self.path, n) for n in self._wal_files()]

    def persist_rev_floor(self) -> None:
        """Record the high-water revision before a seal reclaims the WAL
        files (fsync'd temporary file, atomic replace)."""
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"rev_floor": self.next_rev - 1}, f)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self._meta_path)

    def persist_tombstones(self) -> None:
        tmp = os.path.join(self.path, "tombstones.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"deleted": self.tombstones, "ops": self.delete_ops}, f)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, "tombstones.json"))

    # -- lookups -----------------------------------------------------------
    def segment_for_rev(self, rev: int) -> Optional[_Segment]:
        keys = [s.min_rev for s in self.segments]
        i = bisect.bisect_right(keys, rev) - 1
        if 0 <= i < len(self.segments) and self.segments[i].max_rev >= rev:
            return self.segments[i]
        return None

    def live_tail(self) -> list[tuple[int, list]]:
        """(revision, row) of every live unsealed row, in revision order."""
        return [(self.tail_base + i, row) for i, row in enumerate(self.tail)
                if row is not None]

    def close(self) -> None:
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = None


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


class SegmentFSEventStore(base.EventStore):
    """The columnar event store; the module docstring gives its layout
    and contracts."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        path = config.get("PATH")
        if not path:
            raise StorageError("segmentfs requires a PATH setting")
        self.base = path
        os.makedirs(self.base, exist_ok=True)
        self.fsync = str(config.get("FSYNC", "1")).strip() not in ("0", "false", "no")
        self.seal_events = int(config.get("SEAL_EVENTS", 8192))
        self.seal_age_s = float(config.get("SEAL_AGE_S", 2.0))
        self.seal_interval_s = float(config.get("SEAL_INTERVAL_S", 0.25))
        self.compact_segments = int(config.get("COMPACT_SEGMENTS", 8))
        self.compact_max_rows = int(config.get("COMPACT_MAX_ROWS", 65536))
        self._lock = threading.RLock()
        # one writer process per PATH: a second process appending to the
        # WAL and sealing would corrupt the revision sequence silently.
        # lockf locks are per process, so a reopen in the same process
        # (after a crash, in tests) still works.
        self._writer_lock_file = self._acquire_writer_lock()
        self._ns: dict[tuple[int, Optional[int]], _Namespace] = {}
        # the sealed rows' frame arrays: query key → (validity token, arrays)
        self._frame_cache: dict[tuple, tuple[tuple, dict]] = {}
        self.frame_cache_stats = {"hits": 0, "misses": 0}
        self.segments_scanned = 0  # segments a pruned read opened
        self._stop = threading.Event()
        self._sealer: Optional[threading.Thread] = None
        # the replication seam: when set (a shipper at MIN_ACKS > 0),
        # called under the store lock after the WAL append and the state
        # update with (app_id, channel_id, first_rev, rows, head); its
        # raise reaches the caller, so that an ack means replicated
        self._commit_hook = None

    # -- the writer guard --------------------------------------------------
    def _acquire_writer_lock(self):
        """An exclusive fcntl.lockf on <PATH>/.writer.lock, held until
        close() (or the process's end, so a restart after SIGKILL reopens
        at once). A second process gets a StorageError naming the
        holder's pid."""
        try:
            import fcntl
        except ImportError:  # not POSIX: no guard
            return None
        lock_path = os.path.join(self.base, ".writer.lock")
        f = open(lock_path, "a+")
        try:
            fcntl.lockf(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            try:
                f.seek(0)
                holder = f.read().strip() or "unknown"
            except OSError:
                holder = "unknown"
            f.close()
            raise StorageError(
                f"segmentfs store at {self.base!r} is already open for "
                f"writing by another process (pid {holder}); segmentfs "
                "allows ONE writer process per PATH — route writes "
                "through the storage daemon, or close the other process"
            )
        f.truncate(0)
        f.write(f"{os.getpid()}\n")
        f.flush()
        return f

    def _release_writer_lock(self) -> None:
        f = self._writer_lock_file
        if f is None:
            return
        self._writer_lock_file = None
        try:
            import fcntl

            fcntl.lockf(f, fcntl.LOCK_UN)
        except Exception:  # noqa: BLE001 — closing releases it anyway
            pass
        try:
            f.close()
        except OSError:
            pass

    # -- the sealer thread -------------------------------------------------
    def _ensure_sealer(self) -> None:
        if self._sealer is not None and self._sealer.is_alive():
            return
        with self._lock:
            if self._sealer is not None and self._sealer.is_alive():
                return
            self._stop.clear()
            self._sealer = threading.Thread(
                target=self._sealer_loop, name="segmentfs-sealer", daemon=True)
            self._sealer.start()

    def _sealer_loop(self) -> None:
        while not self._stop.wait(self.seal_interval_s):
            try:
                self.maintain()
            except Exception:  # noqa: BLE001 — the next pass retries
                log.exception("segmentfs sealer pass failed; will retry")

    def maintain(self) -> None:
        """One seal and compaction pass over every namespace: a tail of
        SEAL_EVENTS rows or older than SEAL_AGE_S is sealed, more than
        COMPACT_SEGMENTS segments are compacted."""
        with self._lock:
            keys = list(self._ns)
        now = time.monotonic()
        for key in keys:
            with self._lock:
                ns = self._ns.get(key)
                if ns is None:
                    continue
                n_tail = len(ns.tail_by_id)
                due = n_tail >= self.seal_events or (
                    n_tail > 0 and now - ns.tail_since >= self.seal_age_s)
                do_compact = len(ns.segments) > self.compact_segments
            # the builds run outside the lock and check their own guards
            if due:
                self._seal_ns(ns)
            if do_compact:
                self._compact_ns(ns)

    def close(self) -> None:
        """Stop the sealer, seal every tail (a clean shutdown leaves no
        WAL to replay) and release the writer lock."""
        self._stop.set()
        t = self._sealer
        if t is not None:
            t.join(timeout=10)
            self._sealer = None
        with self._lock:
            namespaces = list(self._ns.values())
        for ns in namespaces:
            try:
                self._seal_ns(ns)
            except Exception:  # noqa: BLE001 — the WAL keeps the tail
                log.exception("segmentfs close-time seal failed")
            ns.close()
        self._release_writer_lock()

    # -- namespaces --------------------------------------------------------
    def _dir(self, app_id: int, channel_id: Optional[int]) -> str:
        name = f"app_{app_id}" + (f"_{channel_id}" if channel_id else "")
        return os.path.join(self.base, name)

    def _namespace(self, app_id: int, channel_id: Optional[int]) -> _Namespace:
        key = (app_id, channel_id)
        ns = self._ns.get(key)
        if ns is None:
            ns = _Namespace(self._dir(app_id, channel_id), self.fsync)
            self._ns[key] = ns
        return ns

    def init_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            self._namespace(app_id, channel_id)
        return True

    def remove_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            ns = self._ns.pop((app_id, channel_id), None)
            if ns is not None:
                ns.removed = True
                ns.close()
            d = self._dir(app_id, channel_id)
            if os.path.isdir(d):
                shutil.rmtree(d)
            self._invalidate_frames(app_id, channel_id)
        return True

    def _invalidate_frames(self, app_id, channel_id) -> None:
        for k in [k for k in self._frame_cache if k[0] == (app_id, channel_id)]:
            del self._frame_cache[k]

    # -- writes ------------------------------------------------------------
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list[str]:
        if not events:
            return []
        self._ensure_sealer()
        fresh = iter(_gen_ids(sum(1 for e in events if e.event_id is None)))
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            first = ns.next_rev
            rows = [_event_row(e, e.event_id or next(fresh)) for e in events]
            # one encode, one write and one fsync a batch; the WAL first,
            # the state second: if the append raises (a full disk), no
            # state changed, so the sealer cannot persist rows the caller
            # was told failed
            try:
                ns.wal_append(json.dumps([first, rows], separators=(",", ":"),
                                         default=str) + "\n")
            except BaseException:
                # spend the claimed revisions: the record may be whole on
                # disk (the fsync raised after the write), and a later
                # batch under the same revisions would make recovery drop
                # that acknowledged batch as a duplicate
                ns.next_rev += len(events)
                ns.tail.extend([None] * len(events))
                raise
            was_empty = not ns.tail_by_id
            ns.next_rev += len(events)
            for i, row in enumerate(rows):
                ns._tail_append(row, first + i)
            if was_empty:
                ns.tail_since = time.monotonic()
            hook = self._commit_hook
            if hook is not None:
                # still under the store lock, so that frames reach the
                # followers in revision order. On a raise the rows stay
                # durable here (the WAL is fsync'd) and the background
                # pass ships them again, but the caller sees the failure
                hook(app_id, channel_id, first, rows, ns.next_rev - 1)
            return [row[_ROW_ID] for row in rows]

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        return self.delete_batch([event_id], app_id, channel_id) == 1

    def delete_batch(self, event_ids: Sequence[str], app_id: int,
                     channel_id: Optional[int] = None) -> int:
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            hits = 0
            for eid in dict.fromkeys(event_ids):
                rev = ns.id_rev.get(eid)
                if rev is None:
                    continue
                ns.tombstones[eid] = rev
                ns._mask_dead(eid)
                ns.delete_ops += 1
                hits += 1
            if hits:
                ns.persist_tombstones()
        return hits

    # -- reads -------------------------------------------------------------
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            rev = ns.id_rev.get(event_id)
            if rev is None:
                return None
            ti = ns.tail_by_id.get(event_id)
            if ti is not None:
                return _row_event(ns.tail[ti], rev)
            seg = ns.segment_for_rev(rev)
            if seg is None:
                return None
            row = seg.row_of_rev(rev)
            return seg.event(row) if row is not None else None

    def _iter_live(self, ns: _Namespace, query: EventQuery) -> Iterator[Event]:
        """The namespace's live events, segments pruned where the query
        allows: an entity read by the bloom filter and the exact
        vocabulary, a target read by the footer's target set, a time
        range by the footer's stamps. The caller holds the lock."""
        for seg in ns.segments:
            if query.entity_id is not None and not (
                    seg.maybe_has_entity(query.entity_id)
                    and query.entity_id in seg.footer["entity_ids"]):
                continue
            if (query.target_entity_id is not None
                    and not seg.has_target(query.target_entity_id)):
                continue
            if (query.start_time is not None
                    and seg.footer["time_max_ms"] < _ms(query.start_time)):
                continue
            if (query.until_time is not None
                    and seg.footer["time_min_ms"] >= _ms(query.until_time)):
                continue
            self.segments_scanned += 1
            dead = seg.dead
            # a point filter on the target or the entity selects its rows
            # by one vectorized code compare; only those become Events
            if query.target_entity_id is not None:
                code = seg.footer["target_ids"].index(query.target_entity_id)
                rows = np.nonzero(seg.col("target_idx") == code)[0]
            elif query.entity_id is not None:
                code = seg.footer["entity_ids"].index(query.entity_id)
                rows = np.nonzero(seg.col("entity_idx") == code)[0]
            else:
                rows = np.arange(seg.n_rows)
            if dead:
                rows = rows[~np.isin(rows, np.fromiter(dead, np.int64))]
            if query.shard is not None:  # a partition's rows only become Events
                rows = rows[_in_shard(seg, query.shard)[seg.col("entity_idx")[rows]]]
            for lo in range(0, len(rows), _PAGE_ROWS):
                yield from seg.events_page(rows[lo : lo + _PAGE_ROWS])
        for rev, row in ns.live_tail():
            yield _row_event(row, rev)

    def find(self, query: EventQuery) -> Iterator[Event]:
        with self._lock:
            ns = self._namespace(query.app_id, query.channel_id)
            matches = [e for e in self._iter_live(ns, query) if query.matches(e)]
        matches.sort(key=lambda e: (e.event_time, e.event_id or ""),
                     reverse=query.reversed)
        if query.limit is not None and query.limit >= 0:
            matches = matches[: query.limit]
        return iter(matches)

    def find_entities_batch(
        self,
        app_id: int,
        entity_type: str,
        entity_ids: Sequence[str],
        event_names: Optional[Sequence[str]] = None,
        limit_per_entity: Optional[int] = None,
        channel_id: Optional[int] = None,
        reversed: bool = True,
    ) -> dict[str, list[Event]]:
        """One `find_single_entity` an id (each a bloom-pruned read)."""
        return {
            eid: list(self.find_single_entity(
                app_id, entity_type, eid, channel_id=channel_id,
                event_names=event_names, limit=limit_per_entity,
                reversed=reversed))
            for eid in dict.fromkeys(entity_ids)
        }

    def find_edges(self, app_id: int, entity_type: str, target_entity_type: str,
                   event_names: Sequence[str], entity_ids: Optional[Sequence[str]] = None,
                   target_ids: Optional[Sequence[str]] = None,
                   channel_id: Optional[int] = None) -> list[tuple[str, str, str, dict]]:
        """The online fold's history read (the base class gives the
        contract) in one pass: each segment's rows of the wanted ids by
        one compare of its code column against their footer codes, and
        the tail read once, where a `find` an id would decode the whole
        tail for every id."""
        by_target = target_ids is not None
        if by_target == (entity_ids is not None):
            raise ValueError("find_edges takes entity_ids or target_ids")
        keys = list(dict.fromkeys(target_ids if by_target else entity_ids))
        want = set(keys)
        names = set(event_names)
        groups: dict[str, list[Event]] = {k: [] for k in keys}
        vocab_key, col, at = (("target_ids", "target_idx", _ROW_TID) if by_target
                              else ("entity_ids", "entity_idx", _ROW_EID))

        def add(e: Event) -> None:
            if (e.event in names and e.entity_type == entity_type
                    and e.target_entity_type == target_entity_type
                    and e.target_entity_id is not None):
                groups[e.target_entity_id if by_target else e.entity_id].append(e)

        with self._lock:
            ns = self._namespace(app_id, channel_id)
            for seg in ns.segments:
                codes = [j for j, v in enumerate(seg.footer[vocab_key]) if v in want]
                if not codes:
                    continue
                rows = np.nonzero(np.isin(seg.col(col), codes))[0]
                if seg.dead:
                    rows = rows[~np.isin(rows, np.fromiter(seg.dead, np.int64))]
                for lo in range(0, len(rows), _PAGE_ROWS):
                    for e in seg.events_page(rows[lo : lo + _PAGE_ROWS]):
                        add(e)
            for rev, row in ns.live_tail():
                if row[at] in want:
                    add(_row_event(row, rev))
        out = []
        for k in keys:
            group = sorted(groups[k], key=lambda e: (e.event_time, e.event_id or ""))
            out.extend((e.entity_id, e.target_entity_id, e.event, e.properties) for e in group)
        return out

    # -- revisions (the online consumer's tail) ----------------------------
    def latest_revision(self, app_id: int, channel_id: Optional[int] = None) -> int:
        with self._lock:
            return self._namespace(app_id, channel_id).next_rev - 1

    def find_since(
        self,
        app_id: int,
        after_revision: int,
        channel_id: Optional[int] = None,
        limit: Optional[int] = None,
        shard: Optional[tuple[int, int]] = None,
    ) -> list[Event]:
        """An indexed tail read: segments are keyed by revision range, so
        the cursor finds its segment by a binary search and reads on; a
        `shard` keeps that partition's events only."""
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            out: list[Event] = []

            def full() -> bool:
                return limit is not None and 0 <= limit <= len(out)

            keys = [s.max_rev for s in ns.segments]
            sx = bisect.bisect_left(keys, after_revision + 1)
            for seg in ns.segments[sx:]:
                if full():
                    break
                revs = seg.col("rev")
                start = int(np.searchsorted(revs, after_revision + 1))
                rows = np.arange(start, seg.n_rows)
                if seg.dead:
                    rows = rows[~np.isin(rows, np.fromiter(seg.dead, np.int64))]
                # pages shrink toward a small limit, so that a tail read
                # decodes little past what it returns
                lo = 0
                while lo < len(rows) and not full():
                    chunk = _PAGE_ROWS
                    if limit is not None and limit >= 0:
                        # a shard passes about 1/n of the rows
                        need = (limit - len(out)) * (shard[1] if shard else 1)
                        chunk = max(64, min(_PAGE_ROWS, need))
                    for e in seg.events_page(rows[lo : lo + chunk]):
                        if full():
                            break
                        if shard is not None and base.shard_of(
                                e.entity_id, shard[1]) != shard[0]:
                            continue
                        out.append(e)
                    lo += chunk
            for rev, row in ns.live_tail():
                if full():
                    break
                if rev <= after_revision:
                    continue
                if shard is not None and base.shard_of(
                        row[_ROW_EID], shard[1]) != shard[0]:
                    continue
                out.append(_row_event(row, rev))
        return out

    def data_signature(self, app_id: int, channel_id: Optional[int] = None) -> str:
        # every mutation assigns a revision (insert, overwrite) or counts
        # a delete
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            return f"{ns.next_rev - 1}:{ns.delete_ops}"

    # -- seal and compaction -----------------------------------------------
    def seal(self, app_id: int, channel_id: Optional[int] = None) -> int:
        """Seal the namespace's tail now; returns the rows sealed."""
        with self._lock:
            ns = self._namespace(app_id, channel_id)
        return self._seal_ns(ns)

    def _seal_ns(self, ns: _Namespace) -> int:
        """The tail's snapshot into one segment: built outside the lock
        (ingest goes on into a fresh WAL file), published under it, with
        the rows deleted or overwritten meanwhile masked dead."""
        with self._lock:
            if ns.sealing or ns.removed or not ns.tail:
                return 0
            ns.sealing = True
            live = ns.live_tail()
            cut = len(ns.tail)
            old_wals = ns.wal_rotate()
        path: Optional[str] = None
        try:
            if live:
                path = _write_segment(ns.path, [row for _rev, row in live],
                                      [rev for rev, _row in live])
        except BaseException:
            # the tail and its WAL files stay: publishing here would
            # reclaim the WAL without a segment; the next pass retries
            with self._lock:
                ns.sealing = False
            raise
        with self._lock:
            if ns.removed:
                if path is not None:
                    shutil.rmtree(path, ignore_errors=True)
                ns.sealing = False
                return 0
            if path is not None:
                seg = _Segment(path)
                # rows whose id moved on to a later revision meanwhile
                for row_ix, (rev, row) in enumerate(live):
                    if ns.id_rev.get(row[_ROW_ID]) != rev:
                        seg.dead.add(row_ix)
                ns.segments.append(seg)
                ns.segments.sort(key=lambda s: s.min_rev)
            # the sealed prefix is in the segment now: record the
            # high-water revision, then reclaim its WAL files (a crash
            # between the two replays nothing: recovery skips revisions at
            # or below the sealed maximum and the floor)
            del ns.tail[:cut]
            ns.tail_base += cut
            ns.tail_by_id = {row[_ROW_ID]: i for i, row in enumerate(ns.tail)
                             if row is not None}
            ns.tail_since = time.monotonic()
            ns.persist_rev_floor()
            for p in old_wals:
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
            ns.sealing = False
        return len(live)

    def compact(self, app_id: int, channel_id: Optional[int] = None) -> int:
        """Merge small adjacent segments, dropping dead rows; returns the
        segments merged away."""
        with self._lock:
            ns = self._namespace(app_id, channel_id)
        return self._compact_ns(ns)

    def _compact_ns(self, ns: _Namespace) -> int:
        """Runs of adjacent segments of at most COMPACT_MAX_ROWS rows, each
        merged into one, dead rows dropped: built outside the lock from
        immutable segments, swapped under it with liveness checked again.
        Only adjacent segments merge, so revision ranges never overlap."""
        with self._lock:
            if ns.compacting or ns.removed:
                return 0
            runs: list[list[_Segment]] = []
            cur: list[_Segment] = []
            for seg in ns.segments:
                if seg.n_rows <= self.compact_max_rows:
                    cur.append(seg)
                else:
                    if len(cur) > 1:
                        runs.append(cur)
                    cur = []
            if len(cur) > 1:
                runs.append(cur)
            if not runs:
                return 0
            ns.compacting = True
        removed = 0
        try:
            for run in runs:
                # revision values are kept, so cursors and the signature
                # stay valid
                rows: list[list] = []
                revs: list[int] = []
                for seg in run:
                    dead = seg.dead
                    rev_col = seg.col("rev")
                    for i in range(seg.n_rows):
                        if i not in dead:
                            rows.append(seg.row(i))
                            revs.append(int(rev_col[i]))
                merged_path = _write_segment(ns.path, rows, revs) if rows else None
                with self._lock:
                    if ns.removed:
                        if merged_path is not None:
                            shutil.rmtree(merged_path, ignore_errors=True)
                        return removed
                    keep = [s for s in ns.segments if s not in run]
                    if merged_path is not None:
                        merged = _Segment(merged_path)
                        for row_ix, (row, rev) in enumerate(zip(rows, revs)):
                            if ns.id_rev.get(row[_ROW_ID]) != rev:
                                merged.dead.add(row_ix)
                        keep.append(merged)
                    keep.sort(key=lambda s: s.min_rev)
                    ns.segments = keep
                    for seg in run:
                        shutil.rmtree(seg.path, ignore_errors=True)
                removed += len(run) - (1 if rows else 0)
        finally:
            with self._lock:
                ns.compacting = False
        return removed

    def segment_stats(self, app_id: int, channel_id: Optional[int] = None) -> dict[str, Any]:
        """The namespace's shape (`pio status`, ``GET /segments/stats``)."""
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            return {
                "segments": len(ns.segments),
                "sealed_rows": sum(s.n_rows for s in ns.segments),
                "dead_rows": sum(len(s.dead) for s in ns.segments),
                "tail_rows": len(ns.tail_by_id),
                "max_revision": ns.next_rev - 1,
                "tombstones": len(ns.tombstones),
            }

    # -- the replication seam ----------------------------------------------
    def set_commit_hook(self, hook) -> None:
        """Install (or clear, with None) the synchronous replication
        hook; `insert_batch` gives its calling contract."""
        with self._lock:
            self._commit_hook = hook

    def ship_namespaces(self) -> list[tuple[int, Optional[int]]]:
        """Every (app_id, channel_id) the store holds: the opened ones and
        the directories on disk not opened yet in this process."""
        with self._lock:
            keys = set(self._ns)
        try:
            names = os.listdir(self.base)
        except FileNotFoundError:
            names = []
        for n in names:
            if not n.startswith("app_"):
                continue
            parts = n.split("_")
            try:
                app = int(parts[1])
                ch = int(parts[2]) if len(parts) > 2 else None
            except (IndexError, ValueError):
                continue
            keys.add((app, ch))
        return sorted(keys, key=lambda k: (k[0], k[1] is not None, k[1] or 0))

    def ship_state(self, app_id: int, channel_id: Optional[int] = None) -> dict[str, Any]:
        """One namespace as a shipper sees it: the watermark, the sealed
        floor, the segments by name with their revision ranges, and the
        delete counter."""
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            return {
                "watermark": ns.next_rev - 1,
                "tail_floor": ns.tail_base - 1,
                "segments": {os.path.basename(s.path): [s.min_rev, s.max_rev]
                             for s in ns.segments},
                "tombstone_ops": ns.delete_ops,
            }

    def ship_tail_after(self, app_id: int, channel_id: Optional[int], after_rev: int,
                        limit: int) -> dict[str, Any]:
        """At most `limit` live unsealed rows with revision > after_rev,
        in revision order. `floor` is the last sealed revision: above
        after_rev, the follower lacks sealed rows that only a segment
        ship gives. A tail row is never mutated once appended (a
        supersede nulls its slot), so the references are safe to
        serialize outside the lock."""
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            revs: list[int] = []
            rows: list[list] = []
            for rev, row in ns.live_tail():
                if rev <= after_rev:
                    continue
                revs.append(rev)
                rows.append(row)
                if len(revs) >= limit:
                    break
            return {"revs": revs, "rows": rows, "head": ns.next_rev - 1,
                    "floor": ns.tail_base - 1}

    def ship_segment_path(self, app_id: int, channel_id: Optional[int],
                          name: str) -> Optional[str]:
        """A sealed segment's path by name, or None once compaction took
        it (the next pass ships the merged segment)."""
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            for seg in ns.segments:
                if os.path.basename(seg.path) == name:
                    return seg.path
        return None

    def ship_tombstones(self, app_id: int,
                        channel_id: Optional[int] = None) -> tuple[dict[str, int], int]:
        with self._lock:
            ns = self._namespace(app_id, channel_id)
            return dict(ns.tombstones), ns.delete_ops

    # -- the columnar training read ----------------------------------------
    @staticmethod
    def _frame_key(query: EventQuery, value_prop: Optional[str],
                   default_value: float) -> tuple:
        return (
            (query.app_id, query.channel_id),
            query.start_time, query.until_time, query.entity_type,
            tuple(query.event_names) if query.event_names else None,
            query.target_entity_type, query.filter_target_absent,
            query.shard, value_prop, default_value,
        )

    @staticmethod
    def _sealed_rows(snapshot: Sequence[tuple[_Segment, frozenset]], query: EventQuery,
                     value_prop: Optional[str], default_value: float) -> dict[str, np.ndarray]:
        """Every sealed segment's filtered rows as concatenated arrays
        ({time_ms, ids, names, etypes, ents, ttypes, ttype_ok, tgts,
        tgt_ok, values}): mmap, column concat and vectorized remap. A pure
        function of the (segment, dead set) snapshot, so it runs without
        the lock and a cold read stalls no ingest ack."""
        parts: list[dict[str, np.ndarray]] = []
        for seg, dead in snapshot:
            mask = np.ones(seg.n_rows, dtype=bool)
            if dead:
                mask[np.fromiter(dead, dtype=np.int64)] = False
            times = seg.col("time_ms")
            if query.start_time is not None:
                mask &= times >= _ms(query.start_time)
            if query.until_time is not None:
                mask &= times < _ms(query.until_time)
            names_v = seg.vocab_np("event_names")
            codes = seg.col("event_code")
            if query.event_names is not None:
                keep_codes = [i for i, n in enumerate(seg.footer["event_names"])
                              if n in query.event_names]
                mask &= np.isin(codes, keep_codes)
            if query.entity_type is not None:
                try:
                    et_code = seg.footer["entity_types"].index(query.entity_type)
                    mask &= seg.col("etype_code") == et_code
                except ValueError:
                    mask[:] = False
            tgt = seg.col("target_idx")
            if query.filter_target_absent:
                mask &= tgt < 0
            elif query.target_entity_type is not None:
                try:
                    tt_code = seg.footer["target_types"].index(query.target_entity_type)
                    mask &= seg.col("ttype_code") == tt_code
                except ValueError:
                    mask[:] = False
            ent = seg.col("entity_idx")
            if query.shard is not None:
                mask &= _in_shard(seg, query.shard)[ent]
            idx = np.nonzero(mask)[0]
            if not len(idx):
                continue
            if value_prop is None:
                values = np.full(len(idx), default_value, np.float32)
            else:
                col = seg.value_col(value_prop)
                if col is not None:
                    v = np.asarray(col[idx], np.float32)
                    values = np.where(np.isnan(v), default_value, v)
                else:
                    # not a column in this segment (not numeric on every
                    # row, or past the cap): the sidecar
                    rows = seg.sidecar_rows()
                    values = np.fromiter(
                        (default_value
                         if (v := _float_prop(rows[i][0], value_prop)) is None else v
                         for i in idx),
                        np.float32, count=len(idx))
            tgt_i = tgt[idx]
            parts.append({
                "time_ms": np.asarray(times[idx], np.int64),
                "ids": seg.ids_np()[idx],
                "names": names_v[codes[idx]],
                "etypes": seg.vocab_np("entity_types")[seg.col("etype_code")[idx]],
                "ents": seg.vocab_np("entity_ids")[ent[idx]],
                "ttypes": seg.vocab_np("target_types")[
                    np.maximum(seg.col("ttype_code")[idx], 0)],
                "ttype_ok": seg.col("ttype_code")[idx] >= 0,
                "tgts": seg.vocab_np("target_ids")[np.maximum(tgt_i, 0)],
                "tgt_ok": tgt_i >= 0,
                "values": values,
            })
        if parts:
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        return _empty_arrays()

    @staticmethod
    def _tail_rows(tail: Sequence[tuple[int, list]], query: EventQuery,
                   value_prop: Optional[str], default_value: float) -> dict[str, np.ndarray]:
        """The unsealed tail as row arrays: the frame read's only loop a
        row, bounded by the seal threshold."""
        sel: list[list] = []
        t0 = _ms(query.start_time) if query.start_time else None
        t1 = _ms(query.until_time) if query.until_time else None
        names = set(query.event_names) if query.event_names is not None else None
        for _rev, r in tail:
            if t0 is not None and r[_ROW_TIME] < t0:
                continue
            if t1 is not None and r[_ROW_TIME] >= t1:
                continue
            if names is not None and r[_ROW_EVENT] not in names:
                continue
            if query.entity_type is not None and r[_ROW_ETYPE] != query.entity_type:
                continue
            if query.filter_target_absent:
                if r[_ROW_TTYPE] is not None or r[_ROW_TID] is not None:
                    continue
            elif (query.target_entity_type is not None
                  and r[_ROW_TTYPE] != query.target_entity_type):
                continue
            if not query.shard_matches(r[_ROW_EID]):
                continue
            sel.append(r)
        if not sel:
            return _empty_arrays()
        values = []
        for r in sel:
            v = _float_prop(r[_ROW_PROPS], value_prop) if value_prop is not None else None
            values.append(default_value if v is None else v)
        return {
            "time_ms": np.asarray([r[_ROW_TIME] for r in sel], np.int64),
            "ids": np.asarray([r[_ROW_ID] for r in sel], dtype=str),
            "names": np.asarray([r[_ROW_EVENT] for r in sel], dtype=str),
            "etypes": np.asarray([r[_ROW_ETYPE] for r in sel], dtype=str),
            "ents": np.asarray([r[_ROW_EID] for r in sel], dtype=str),
            "ttypes": np.asarray([r[_ROW_TTYPE] or "" for r in sel], dtype=str),
            "ttype_ok": np.asarray([r[_ROW_TTYPE] is not None for r in sel], bool),
            "tgts": np.asarray([r[_ROW_TID] or "" for r in sel], dtype=str),
            "tgt_ok": np.asarray([r[_ROW_TID] is not None for r in sel], bool),
            "values": np.asarray(values, np.float32),
        }

    @staticmethod
    def _first_seen_codes(keys: np.ndarray, valid: Optional[np.ndarray] = None
                          ) -> tuple[np.ndarray, dict[str, int]]:
        """``BiMap.string_int`` over a string array: (int32 codes, -1
        where not `valid`; vocabulary dict)."""
        sel = keys[valid] if valid is not None else keys
        if not len(sel):
            return (np.full(len(keys), -1, np.int32) if valid is not None
                    else np.zeros(0, np.int32)), {}
        vocab_list, codes_sel = _rank_first_seen(sel)
        vocab = {v: j for j, v in enumerate(vocab_list)}
        if valid is None:
            return codes_sel, vocab
        codes = np.full(len(keys), -1, np.int32)
        codes[valid] = codes_sel
        return codes, vocab

    def find_frame(self, query: EventQuery, value_prop: Optional[str] = None,
                   default_value: float = 1.0):
        """The training read, bit-identical to
        ``EventFrame.from_events(self.find(query), ...)``: rows in
        (event_time, event_id) order, vocabularies in first-seen order
        over them, assembled from the sealed segments' columns (cached
        under the segment ids) and the tail."""
        if self._exotic(query):
            return EventFrame.from_events(self.find(query), value_prop=value_prop,
                                          default_value=default_value)
        arrays, _n_sealed, _token = self._frame_arrays(query, value_prop, default_value)
        order = np.lexsort((arrays["ids"], arrays["time_ms"]))
        arrays = {k: v[order] for k, v in arrays.items()}
        return self._arrays_to_frame(arrays)

    @staticmethod
    def _exotic(query: EventQuery) -> bool:
        """Filters the columnar read does not push down (entity or target
        point reads, the keyset cursor, limits, reversed scans): they take
        the row path."""
        return (query.entity_id is not None
                or query.target_entity_id is not None
                or query.start_after is not None
                or query.limit is not None
                or query.reversed)

    def find_frame_parts(self, query: EventQuery, value_prop: Optional[str] = None,
                         default_value: float = 1.0):
        """The stager's read: the frame's content with the rows laid out
        sealed first (revision order), so that a stager can keep the
        sealed prefix under the returned segment token and copy only the
        tail at the next retrain. Returns (frame, segment token, sealed
        rows). The sealed prefix's codes are stable under tail-only
        growth (first-seen order over an unchanged prefix)."""
        if self._exotic(query):
            raise StorageError(
                "find_frame_parts supports training-shaped queries only "
                "(no entity/target point filter, cursor, limit, reversed)")
        arrays, n_sealed, token = self._frame_arrays(query, value_prop, default_value)
        return self._arrays_to_frame(arrays), token, n_sealed

    def _frame_arrays(self, query: EventQuery, value_prop, default_value
                      ) -> tuple[dict[str, np.ndarray], int, tuple]:
        key = self._frame_key(query, value_prop, default_value)
        # one lock hold snapshots (segments, dead sets, tail); the
        # corpus-sized work below runs unlocked
        with self._lock:
            ns = self._namespace(query.app_id, query.channel_id)
            snapshot = [(s, frozenset(s.dead)) for s in ns.segments]
            token = (tuple(s.path for s, _d in snapshot),
                     sum(len(d) for _s, d in snapshot), ns.delete_ops)
            tail_rows = ns.live_tail()
            cached = self._frame_cache.get(key)
        if cached is not None and cached[0] == token:
            self.frame_cache_stats["hits"] += 1
            sealed = cached[1]
        else:
            self.frame_cache_stats["misses"] += 1
            sealed = self._sealed_rows(snapshot, query, value_prop, default_value)
            with self._lock:
                # at most 8 query shapes, least recently stored first out:
                # a rolling window's fresh start time a retrain would
                # otherwise keep one dead corpus-sized entry a run
                self._frame_cache.pop(key, None)
                self._frame_cache[key] = (token, sealed)
                while len(self._frame_cache) > 8:
                    self._frame_cache.pop(next(iter(self._frame_cache)))
        tail = self._tail_rows(tail_rows, query, value_prop, default_value)
        n_sealed = len(sealed["time_ms"])
        if not len(tail["time_ms"]):
            return dict(sealed), n_sealed, token
        if not n_sealed:
            return tail, 0, token
        merged = {}
        for k in sealed:
            a, b = sealed[k], tail[k]
            if a.dtype.kind == "U" and b.dtype.kind == "U":
                width = max(a.dtype.itemsize, b.dtype.itemsize) // 4
                a = a.astype(f"U{max(width, 1)}")
                b = b.astype(f"U{max(width, 1)}")
            merged[k] = np.concatenate([a, b])
        return merged, n_sealed, token

    def _arrays_to_frame(self, arrays: dict[str, np.ndarray]):
        event_code, ev_vocab = self._first_seen_codes(arrays["names"])
        entity_idx, ent_vocab = self._first_seen_codes(arrays["ents"])
        target_idx, tgt_vocab = self._first_seen_codes(arrays["tgts"],
                                                        valid=arrays["tgt_ok"])
        etype = str(arrays["etypes"][0]) if len(arrays["etypes"]) else None
        ttype = None
        if len(arrays["ttype_ok"]):
            tt_at = np.nonzero(arrays["ttype_ok"])[0]
            if len(tt_at):
                ttype = str(arrays["ttypes"][tt_at[0]])
        return EventFrame(
            event_code=event_code,
            entity_idx=entity_idx,
            target_idx=target_idx,
            time_ms=np.asarray(arrays["time_ms"], np.int64),
            value=np.asarray(arrays["values"], np.float32),
            event_vocab=BiMap(ev_vocab),
            entity_vocab=BiMap(ent_vocab),
            target_vocab=BiMap(tgt_vocab),
            entity_type=etype,
            target_entity_type=ttype,
        )


def _empty_arrays() -> dict[str, np.ndarray]:
    return {
        "time_ms": np.zeros(0, np.int64),
        "ids": np.zeros(0, dtype=str),
        "names": np.zeros(0, dtype=str),
        "etypes": np.zeros(0, dtype=str),
        "ents": np.zeros(0, dtype=str),
        "ttypes": np.zeros(0, dtype=str),
        "ttype_ok": np.zeros(0, bool),
        "tgts": np.zeros(0, dtype=str),
        "tgt_ok": np.zeros(0, bool),
        "values": np.zeros(0, np.float32),
    }
