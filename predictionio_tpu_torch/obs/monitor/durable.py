"""Durable long-horizon tier under the in-memory TSDB ring.

Counterpart of the JAX package's ``obs/monitor/durable.py``, the port's
own copy; the on-disk format is the same byte for byte, so either
package opens the other's directory. The ring (tsdb.py) keeps ~12
minutes of history at a 1 s tick and loses it on restart. Underneath it:

- every accepted ``add()`` also lands in an fsync'd write-ahead log
  (JSON lines, one segment file a seal window, one fsync a flush on the
  ``tsdb-wal`` thread);
- a full enough or old enough segment seals into an immutable columnar
  block: per series, delta-of-delta varint times (milliseconds) and
  float64 value columns, with a JSON footer index keyed by (name, sorted
  label pairs), so a query reads only its series' bytes. Blocks are
  written tmp → fsync → rename and never modified;
- the compactor (compact.py) rolls raw blocks into 5m and 1h tiers (a
  bucket's count/sum/min/max/first/last and ``inc``, its reset-aware
  counter increase, so ``increase()`` and ``rate()`` stay exact over
  full buckets) and enforces each tier's retention
  (``PIO_TSDB_RETENTION_{RAW,5M,1H}``);
- reads stitch: a window's disk prefix (points older than the ring's
  floor) comes from the coarsest tier that answers it at enough
  resolution, joined reset-aware onto the ring's suffix, so
  ``/debug/tsdb``, the expression evaluator and the SLO engine's long
  burn windows see history they do not know is on disk;
- at construction the durable tail (a checkpoint, the WAL segments and
  the newest raw blocks) replays into the ring, so a monitor killed with
  SIGKILL restarts with its history, and its counters continue across
  the restart without a phantom reset.

Error bound of the downsampled tiers: ``increase`` over a window is
exact but at the two edge buckets, where a partial bucket gives its
whole in-bucket increase (at most one ``bucket_s`` of slop an edge).
``quantile_over_time`` reads one value a bucket (``last``), so its error
is bounded by the bucket's [min, max]. Raw-tier answers carry no bound.

Standard library only: the data-plane processes that import it never
load torch.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
from typing import Any, Iterable, Optional

from predictionio_tpu_torch.obs.monitor.tsdb import (
    TSDB,
    LabelPairs,
    Series,
    _label_key,
    increase_of,
)
from predictionio_tpu_torch.utils.env import durable_knob

log = logging.getLogger(__name__)

#: tier name → bucket seconds (0 = raw resolution)
TIER_BUCKETS: dict[str, float] = {"raw": 0.0, "5m": 300.0, "1h": 3600.0}
#: coarse→fine stitch preference
TIER_ORDER: tuple[str, ...] = ("1h", "5m", "raw")
#: downsampled-block column order (raw blocks carry a single "v" column)
DS_COLS: tuple[str, ...] = (
    "count", "sum", "min", "max", "first", "last", "inc",
)

BLOCK_SUFFIX = ".blk"
BLOCK_MAGIC = b"PTSB1\x00"
BLOCK_TAIL = b"PTSE1\x00"
WAL_SUFFIX = ".log"
#: the replay checkpoint: a ring snapshot and the WAL high-water mark it
#: covers, so a restart parses only the bytes past the mark
CKPT_NAME = "ckpt.json"

#: a stitch tier must offer at least this many buckets per window
MIN_BUCKETS_PER_WINDOW = 4


# -- varint / zigzag ---------------------------------------------------------

def _uvarint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    n = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _zigzag(n: int) -> int:
    return (n << 1) if n >= 0 else ((-n << 1) - 1)


def _unzigzag(u: int) -> int:
    return (u >> 1) if not (u & 1) else -((u + 1) >> 1)


def _encode_times(ts_ms: list[int]) -> bytes:
    """Delta-of-delta varint encoding: absolute first stamp, first
    delta, then the (usually tiny) second differences."""
    out = bytearray()
    _uvarint(out, ts_ms[0])
    prev_delta = 0
    prev = ts_ms[0]
    for t in ts_ms[1:]:
        delta = t - prev
        _uvarint(out, _zigzag(delta - prev_delta))
        prev_delta = delta
        prev = t
    return bytes(out)


def _decode_times(buf: bytes, pos: int, count: int) -> tuple[list[int], int]:
    first, pos = _read_uvarint(buf, pos)
    out = [first]
    prev = first
    delta = 0
    for _ in range(count - 1):
        dod, pos = _read_uvarint(buf, pos)
        delta += _unzigzag(dod)
        prev += delta
        out.append(prev)
    return out, pos


# -- block write / read ------------------------------------------------------

def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds: rename alone must do
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_block(path: str, tier: str,
                rows: Iterable[tuple[str, LabelPairs, str,
                                     list[int], dict[str, list[float]]]],
                ) -> Optional[dict]:
    """Write one immutable columnar block (tmp→fsync→rename). Each row
    is (name, label_pairs, kind, sorted ts_ms, columns); raw rows carry
    a single "v" column, downsampled rows the full DS_COLS set.
    Returns the footer dict, or None for an empty row set."""
    payload = bytearray(BLOCK_MAGIC)
    index: list[dict[str, Any]] = []
    min_t: Optional[float] = None
    max_t: Optional[float] = None
    cols_order = ("v",) if TIER_BUCKETS[tier] == 0 else DS_COLS
    for name, labels, kind, ts_ms, cols in rows:
        if not ts_ms:
            continue
        off = len(payload)
        payload += _encode_times(ts_ms)
        for col in cols_order:
            vals = cols[col]
            payload += struct.pack(f"<{len(vals)}d", *vals)
        lo, hi = ts_ms[0] / 1000.0, ts_ms[-1] / 1000.0
        min_t = lo if min_t is None else min(min_t, lo)
        max_t = hi if max_t is None else max(max_t, hi)
        index.append({
            "n": name, "l": [list(p) for p in labels], "k": kind,
            "off": off, "len": len(payload) - off, "count": len(ts_ms),
            "min_t": lo, "max_t": hi,
        })
    if not index:
        return None
    footer = {
        "v": 1, "tier": tier, "bucket_s": TIER_BUCKETS[tier],
        "min_t": min_t, "max_t": max_t, "series": index,
    }
    fbytes = json.dumps(footer, separators=(",", ":")).encode()
    payload += fbytes
    payload += struct.pack("<Q", len(fbytes))
    payload += BLOCK_TAIL
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    return footer


class BlockHandle:
    """One sealed block's footer index + on-demand series decode."""

    __slots__ = ("path", "tier", "bucket_s", "min_t", "max_t", "size",
                 "series")

    def __init__(self, path: str, footer: dict, size: int):
        self.path = path
        self.tier = footer["tier"]
        self.bucket_s = float(footer["bucket_s"])
        self.min_t = float(footer["min_t"])
        self.max_t = float(footer["max_t"])
        self.size = size
        self.series: dict[tuple[str, LabelPairs], dict] = {}
        for entry in footer["series"]:
            key = (entry["n"], tuple((k, v) for k, v in entry["l"]))
            self.series[key] = entry

    @classmethod
    def load(cls, path: str) -> "BlockHandle":
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            tail = struct.calcsize("<Q") + len(BLOCK_TAIL)
            if size < len(BLOCK_MAGIC) + tail:
                raise ValueError("truncated block")
            f.seek(size - tail)
            flen_raw = f.read(struct.calcsize("<Q"))
            if f.read(len(BLOCK_TAIL)) != BLOCK_TAIL:
                raise ValueError("bad tail magic")
            (flen,) = struct.unpack("<Q", flen_raw)
            f.seek(size - tail - flen)
            footer = json.loads(f.read(flen))
            f.seek(0)
            if f.read(len(BLOCK_MAGIC)) != BLOCK_MAGIC:
                raise ValueError("bad magic")
        if footer.get("v") != 1:
            raise ValueError(f"unknown block version {footer.get('v')!r}")
        return cls(path, footer, size)

    def read_series(self, key: tuple[str, LabelPairs]
                    ) -> Optional[tuple[list[float], dict[str, list[float]]]]:
        """(timestamps_s, columns) for one series, or None when the
        block does not carry it."""
        entry = self.series.get(key)
        if entry is None:
            return None
        with open(self.path, "rb") as f:
            f.seek(entry["off"])
            buf = f.read(entry["len"])
        count = entry["count"]
        ts_ms, pos = _decode_times(buf, 0, count)
        cols_order = ("v",) if self.bucket_s == 0 else DS_COLS
        cols: dict[str, list[float]] = {}
        for col in cols_order:
            width = 8 * count
            cols[col] = list(struct.unpack(f"<{count}d", buf[pos:pos + width]))
            pos += width
        return [t / 1000.0 for t in ts_ms], cols


class TierIndex:
    """Footer index over one tier directory's sealed blocks."""

    def __init__(self, root: str, tier: str):
        self.root = root
        self.tier = tier
        self.bucket_s = TIER_BUCKETS[tier]
        self._lock = threading.Lock()
        self._handles: dict[str, BlockHandle] = {}
        self._dirty = True
        os.makedirs(root, exist_ok=True)

    def invalidate(self) -> None:
        with self._lock:
            self._dirty = True

    def _rescan_locked(self) -> None:
        try:
            names = {
                n for n in os.listdir(self.root)
                if n.endswith(BLOCK_SUFFIX)
            }
        except OSError:
            names = set()
        for gone in set(self._handles) - names:
            del self._handles[gone]
        # blocks are immutable once sealed: a size change means the
        # file was truncated/corrupted underneath us — reload it (and
        # let the footer parse decide whether it is still readable)
        for name, h in list(self._handles.items()):
            try:
                if os.path.getsize(h.path) != h.size:
                    del self._handles[name]
            except OSError:
                del self._handles[name]
        for name in sorted(names - set(self._handles)):
            path = os.path.join(self.root, name)
            try:
                self._handles[name] = BlockHandle.load(path)
            except (OSError, ValueError, KeyError, json.JSONDecodeError):
                log.warning("ignoring unreadable TSDB block %s", path,
                            exc_info=True)
        self._dirty = False

    def blocks(self, lo: Optional[float] = None,
               hi: Optional[float] = None) -> list[BlockHandle]:
        """Handles overlapping [lo, hi), sorted by min_t."""
        with self._lock:
            if self._dirty:
                self._rescan_locked()
            out = list(self._handles.values())
        if lo is not None:
            out = [b for b in out if b.max_t >= lo]
        if hi is not None:
            out = [b for b in out if b.min_t < hi]
        out.sort(key=lambda b: (b.min_t, b.path))
        return out

    def series_keys(self) -> dict[tuple[str, LabelPairs], str]:
        """(name, labels) → kind across every block footer."""
        out: dict[tuple[str, LabelPairs], str] = {}
        for b in self.blocks():
            for key, entry in b.series.items():
                out.setdefault(key, entry.get("k", "gauge"))
        return out

    def min_time(self) -> Optional[float]:
        bs = self.blocks()
        return bs[0].min_t if bs else None

    def remove_blocks(self, paths: Iterable[str]) -> int:
        removed = 0
        for path in paths:
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
        if removed:
            self.invalidate()
            _fsync_dir(self.root)
        return removed

    def stats(self) -> dict[str, Any]:
        bs = self.blocks()
        return {
            "blocks": len(bs),
            "bytes": sum(b.size for b in bs),
            "series": len(self.series_keys()),
            "min_t": round(bs[0].min_t, 3) if bs else None,
            "max_t": round(max(b.max_t for b in bs), 3) if bs else None,
        }


# -- the durable store -------------------------------------------------------

def _merge_series(blocks: list[BlockHandle], key: tuple[str, LabelPairs],
                  lo: float, hi: float,
                  ) -> tuple[list[float], dict[str, list[float]]]:
    """One series' (ts, columns) merged across blocks, time-sorted and
    clipped to [lo, hi)."""
    rows: list[tuple[float, tuple[float, ...]]] = []
    cols_order: tuple[str, ...] = ("v",)
    for b in blocks:
        got = b.read_series(key)
        if got is None:
            continue
        ts, cols = got
        cols_order = ("v",) if b.bucket_s == 0 else DS_COLS
        series_cols = [cols[c] for c in cols_order]
        for i, t in enumerate(ts):
            if lo <= t < hi:
                rows.append((t, tuple(col[i] for col in series_cols)))
    rows.sort(key=lambda r: r[0])
    ts_out = [t for t, _ in rows]
    cols_out = {
        c: [vals[j] for _, vals in rows]
        for j, c in enumerate(cols_order)
    }
    return ts_out, cols_out


def _join_delta(prev_last: Optional[float], first: float) -> float:
    """Reset-aware increase between two adjacent counter observations:
    a drop means the counter restarted, so the later value IS the
    delta (the increase_of semantic, applied across a bucket/tier
    boundary)."""
    if prev_last is None:
        return 0.0
    return (first - prev_last) if first >= prev_last else first


class DurableTSDB(TSDB):
    """TSDB whose rings are backed by a WAL + sealed-block disk tier.

    ``add()`` is the only write path: accepted points also queue for
    the WAL. The ``tsdb-wal`` flusher thread batches them to the active
    segment (fsync per flush) and seals full/old segments into raw
    columnar blocks named ``b-<min_ms>-<max_ms>-w<seq>.blk`` — the
    ``w<seq>`` ties a block to the WAL segment it sealed, which is what
    makes seal crash-consistent: a segment whose block already exists
    is deleted (not replayed) at startup.
    """

    thread_name = "tsdb-wal"

    def __init__(self, directory: str, capacity: int = 720,
                 max_series: int = 4096, flush_interval_s: float = 2.0,
                 seal_points: int = 50000, seal_age_s: float = 300.0,
                 replay: bool = True, ckpt_points: Optional[int] = None):
        super().__init__(capacity, max_series)
        self.dir = directory
        self.flush_interval_s = max(0.05, float(flush_interval_s))
        self.seal_points = max(1, int(seal_points))
        self.seal_age_s = max(0.1, float(seal_age_s))
        if ckpt_points is None:
            ckpt_points = durable_knob("PIO_TSDB_CKPT_POINTS")
        self.ckpt_points = max(0, int(ckpt_points))
        self.wal_dir = os.path.join(directory, "wal")
        os.makedirs(self.wal_dir, exist_ok=True)
        self.tiers: dict[str, TierIndex] = {
            name: TierIndex(os.path.join(directory, name), name)
            for name in TIER_BUCKETS
        }
        self._dlock = threading.Lock()
        self._pending: list[tuple[float, str, LabelPairs, str, float]] = []
        self._wal_f: Optional[Any] = None
        self._wal_seq = self._next_wal_seq()
        self._wal_points = 0
        self._wal_opened_at = 0.0
        self.wal_flushed_points = 0
        self._ckpt_flushed = 0  # points flushed since the last checkpoint
        self.ckpt_written = 0
        self.ckpt_seeded_points = 0
        self.replayed_points = 0
        self.replayed_series = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._drop_sealed_wal_segments()
        if replay:
            self._replay()

    # -- WAL write path ------------------------------------------------------

    def add(self, name: str, labels: Optional[dict], value: float,
            kind: str = "gauge", t: Optional[float] = None) -> bool:
        now = time.time() if t is None else t
        if not super().add(name, labels, value, kind, now):
            return False
        with self._dlock:
            self._pending.append(
                (now, name, _label_key(labels), kind, float(value))
            )
        return True

    def _wal_segments(self) -> list[tuple[int, str]]:
        """(seq, path) of every on-disk WAL segment, oldest first."""
        out = []
        try:
            names = os.listdir(self.wal_dir)
        except OSError:
            names = []
        for n in names:
            if n.startswith("w-") and n.endswith(WAL_SUFFIX):
                try:
                    seq = int(n[2:-len(WAL_SUFFIX)])
                except ValueError:
                    continue
                out.append((seq, os.path.join(self.wal_dir, n)))
        out.sort()
        return out

    def _next_wal_seq(self) -> int:
        segs = self._wal_segments()
        blocks = self.tiers["raw"].blocks()
        sealed = [
            int(b.path.rsplit("-w", 1)[1][:-len(BLOCK_SUFFIX)])
            for b in blocks if "-w" in os.path.basename(b.path)
        ]
        return max(
            [s for s, _ in segs] + sealed + [0]
        ) + 1

    def _drop_sealed_wal_segments(self) -> None:
        """Crash between block rename and segment unlink leaves both on
        disk; the block's w<seq> name identifies the stale segment."""
        sealed = set()
        for b in self.tiers["raw"].blocks():
            base = os.path.basename(b.path)
            if "-w" in base:
                try:
                    sealed.add(int(base.rsplit("-w", 1)[1][:-len(BLOCK_SUFFIX)]))
                except ValueError:
                    pass
        for seq, path in self._wal_segments():
            if seq in sealed:
                try:
                    os.remove(path)
                except OSError:
                    pass

    @staticmethod
    def _read_wal_segment(path: str, offset: int = 0
                          ) -> list[tuple[float, str, LabelPairs, str, float]]:
        points = []
        try:
            with open(path, "rb") as f:
                if offset:
                    f.seek(offset)
                for line in f:
                    try:
                        rec = json.loads(line)
                        points.append((
                            float(rec["t"]), str(rec["n"]),
                            tuple((str(k), str(v)) for k, v in rec["l"]),
                            str(rec.get("k", "gauge")), float(rec["v"]),
                        ))
                    except (ValueError, KeyError, TypeError):
                        continue  # torn tail line after a crash
        except OSError:
            pass
        return points

    def flush_once(self, now: Optional[float] = None,
                   seal: Optional[bool] = None) -> int:
        """Drain pending points to the active WAL segment (one fsync),
        then seal full/old segments. `seal=True` forces a seal of
        everything buffered (tests, clean shutdown); `seal=False`
        skips seal checks. Returns points flushed."""
        now = time.time() if now is None else now
        with self._dlock:
            batch, self._pending = self._pending, []
            if batch:
                if self._wal_f is None:
                    path = os.path.join(
                        self.wal_dir, f"w-{self._wal_seq:08d}{WAL_SUFFIX}"
                    )
                    self._wal_f = open(path, "ab")
                    self._wal_opened_at = now
                lines = [
                    json.dumps(
                        {"t": t, "n": n, "l": [list(p) for p in lbls],
                         "k": k, "v": v},
                        separators=(",", ":"),
                    )
                    for t, n, lbls, k, v in batch
                ]
                self._wal_f.write(("\n".join(lines) + "\n").encode())
                self._wal_f.flush()
                os.fsync(self._wal_f.fileno())
                self._wal_points += len(batch)
                self.wal_flushed_points += len(batch)
                self._ckpt_flushed += len(batch)
            want_ckpt = (
                self.ckpt_points > 0
                and self._ckpt_flushed >= self.ckpt_points
            )
            want_seal = seal is True or (
                seal is None
                and self._wal_points > 0
                and (self._wal_points >= self.seal_points
                     or now - self._wal_opened_at >= self.seal_age_s)
            )
            if want_seal and self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None
                self._wal_points = 0
                self._wal_seq += 1
        if want_ckpt:
            self._write_checkpoint()
        if seal is not False and self._seal_closed_segments():
            self.tiers["raw"].invalidate()
        return len(batch)

    # -- replay checkpoint ---------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.wal_dir, CKPT_NAME)

    def checkpoint_once(self) -> dict:
        """Flush pending points, then persist a replay cursor: the full
        ring snapshot plus the WAL (segment seq, byte offset) high-water
        mark it covers. The next attach seeds the rings from the
        snapshot and parses only WAL bytes past the mark instead of the
        whole unsealed tail. Returns the written cursor's position."""
        self.flush_once(seal=False)
        return self._write_checkpoint()

    def _write_checkpoint(self) -> dict:
        # position FIRST, snapshot second: a point racing in between is
        # in both the snapshot and the post-mark WAL bytes — replay sees
        # it twice, a harmless identical-sample dup (delta 0 for
        # counters). The opposite order could LOSE the point.
        with self._dlock:
            seq = self._wal_seq
            if self._wal_f is not None:
                off = self._wal_f.tell()
            else:
                # stop() closes the active file without bumping seq —
                # cover what is already on disk instead of re-reading it
                try:
                    off = os.path.getsize(
                        os.path.join(
                            self.wal_dir, f"w-{seq:08d}{WAL_SUFFIX}"
                        )
                    )
                except OSError:
                    off = 0
            self._ckpt_flushed = 0
        series_out = []
        with self._lock:
            rows = [
                (s.name, s.labels, s.kind, list(s.points))
                for s in self._series.values()
            ]
        for name, labels, kind, pts in rows:
            if not pts:
                continue
            series_out.append({
                "n": name, "l": [list(p) for p in labels], "k": kind,
                "pts": [[t, v] for t, v in pts],
            })
        doc = {"v": 1, "seq": seq, "off": off, "t": time.time(),
               "series": series_out}
        tmp = self._ckpt_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._ckpt_path())
        _fsync_dir(self.wal_dir)
        self.ckpt_written += 1
        return {"seq": seq, "off": off}

    def _load_checkpoint(self) -> Optional[dict]:
        try:
            with open(self._ckpt_path()) as f:
                doc = json.load(f)
            if doc.get("v") != 1:
                return None
            int(doc["seq"]); int(doc["off"])
            return doc
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _seal_closed_segments(self) -> int:
        """Convert every non-active WAL segment into a raw block, then
        unlink the segment (block first — a crash in between is healed
        by _drop_sealed_wal_segments)."""
        with self._dlock:
            active = self._wal_seq if self._wal_f is not None else None
        sealed = 0
        for seq, path in self._wal_segments():
            if seq == active:
                continue
            points = self._read_wal_segment(path)
            if points:
                per: dict[tuple[str, LabelPairs], list] = {}
                kinds: dict[tuple[str, LabelPairs], str] = {}
                for t, n, lbls, k, v in points:
                    key = (n, lbls)
                    per.setdefault(key, []).append((t, v))
                    kinds[key] = k
                rows = []
                lo = hi = None
                for key, pts in sorted(per.items()):
                    pts.sort()
                    ts_ms = [int(round(t * 1000.0)) for t, _ in pts]
                    # millisecond quantization can tie adjacent stamps;
                    # dod decoding needs monotone non-decreasing times
                    for i in range(1, len(ts_ms)):
                        if ts_ms[i] < ts_ms[i - 1]:
                            ts_ms[i] = ts_ms[i - 1]
                    rows.append((
                        key[0], key[1], kinds[key], ts_ms,
                        {"v": [v for _, v in pts]},
                    ))
                    lo = ts_ms[0] if lo is None else min(lo, ts_ms[0])
                    hi = ts_ms[-1] if hi is None else max(hi, ts_ms[-1])
                block_path = os.path.join(
                    self.tiers["raw"].root,
                    f"b-{lo}-{hi}-w{seq:08d}{BLOCK_SUFFIX}",
                )
                write_block(block_path, "raw", rows)
            try:
                os.remove(path)
            except OSError:
                pass
            sealed += 1
        if sealed:
            _fsync_dir(self.wal_dir)
        return sealed

    # -- flusher thread ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=self.thread_name, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # final drain so a clean stop loses nothing (seal left to the
        # next process: its replay reads the segment directly)
        self.flush_once(seal=False)
        with self._dlock:
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            try:
                self.flush_once()
            except Exception:
                log.warning("TSDB WAL flush failed; points stay queued",
                            exc_info=True)

    # -- replay --------------------------------------------------------------

    def _replay(self, max_blocks: int = 64) -> None:
        """Reload the durable tail into the memory rings — at most
        `capacity` newest points per series, added oldest-first via the
        time-ordered insert path. With a checkpoint present the rings seed from its snapshot and only
        WAL bytes past the (seq, offset) high-water mark are parsed;
        without one, every WAL segment is read in full."""
        per: dict[tuple[str, LabelPairs], list[tuple[float, float]]] = {}
        kinds: dict[tuple[str, LabelPairs], str] = {}
        ck = self._load_checkpoint()
        ck_seq, ck_off = -1, 0
        # newest snapshotted stamp per series: the block-backfill filter
        # (a block may hold a pre-mark segment whose points the snapshot
        # already carries)
        ck_last: dict[tuple[str, LabelPairs], float] = {}
        if ck is not None:
            ck_seq, ck_off = int(ck["seq"]), int(ck["off"])
            for s in ck.get("series", ()):
                try:
                    key = (str(s["n"]),
                           tuple((str(k), str(v)) for k, v in s["l"]))
                    pts = [(float(t), float(v)) for t, v in s["pts"]]
                except (ValueError, KeyError, TypeError):
                    continue
                if not pts:
                    continue
                per[key] = pts
                ck_last[key] = pts[-1][0]
                kinds[key] = str(s.get("k", "gauge"))
                self.ckpt_seeded_points += len(pts)
        for seq, path in self._wal_segments():
            if seq < ck_seq:
                continue  # fully covered by the snapshot
            off = ck_off if seq == ck_seq else 0
            for t, n, lbls, k, v in self._read_wal_segment(path, off):
                key = (n, lbls)
                per.setdefault(key, []).append((t, v))
                kinds.setdefault(key, k)
        raw_blocks = self.tiers["raw"].blocks()
        for b in sorted(raw_blocks, key=lambda b: -b.max_t)[:max_blocks]:
            for key, entry in b.series.items():
                have = per.get(key)
                full = have is not None and len(have) >= self.capacity
                if full and (
                    key not in ck_last or b.max_t <= ck_last[key]
                ):
                    continue
                got = b.read_series(key)
                if got is None:
                    continue
                ts, cols = got
                pts = zip(ts, cols["v"])
                if key in ck_last:
                    # only what the snapshot has not seen (a segment
                    # sealed after the ckpt holds post-snapshot points)
                    pts = ((t, v) for t, v in pts if t > ck_last[key])
                per.setdefault(key, []).extend(pts)
                kinds.setdefault(key, entry.get("k", "gauge"))
        for key, pts in per.items():
            pts.sort()
            labels = dict(key[1])
            ok = True
            for t, v in pts[-self.capacity:]:
                ok = TSDB.add(self, key[0], labels, v, kinds[key], t)
                if not ok:
                    break  # cardinality cap: counted by add()
                self.replayed_points += 1
            if ok:
                self.replayed_series += 1

    # -- tier-stitched reads -------------------------------------------------

    def _disk_series_map(self) -> dict[tuple[str, LabelPairs], str]:
        out: dict[tuple[str, LabelPairs], str] = {}
        for name in TIER_ORDER:
            for key, kind in self.tiers[name].series_keys().items():
                out.setdefault(key, kind)
        return out

    def _pick_tier(self, window_s: float, cutoff: float) -> str:
        """The coarsest tier that can answer the window: adequate
        resolution (>= MIN_BUCKETS_PER_WINDOW buckets per window) and
        coverage reaching the window start, else the adequate tier
        that reaches back furthest."""
        adequate = [
            name for name in TIER_ORDER
            if TIER_BUCKETS[name] == 0
            or TIER_BUCKETS[name] * MIN_BUCKETS_PER_WINDOW <= window_s
        ] or ["raw"]
        best = None
        best_min = None
        for name in adequate:
            lo = self.tiers[name].min_time()
            if lo is None:
                continue
            if lo <= cutoff:
                return name
            if best_min is None or lo < best_min:
                best, best_min = name, lo
        return best or "raw"

    def _disk_points(self, key: tuple[str, LabelPairs], lo: float,
                     hi: float, window_s: float,
                     tier: Optional[str] = None) -> list[tuple[float, float]]:
        """Value points for [lo, hi) from the chosen tier; downsampled
        buckets surface as (bucket_t, last)."""
        tier = tier or self._pick_tier(window_s, lo)
        idx = self.tiers[tier]
        blocks = idx.blocks(lo, hi)
        if not blocks:
            return []
        ts, cols = _merge_series(blocks, key, lo, hi)
        vals = cols.get("v") if idx.bucket_s == 0 else cols.get("last")
        if not ts or vals is None:
            return []
        return list(zip(ts, vals))

    def _disk_values(self, key: tuple[str, LabelPairs], lo: float,
                     hi: float, window_s: float,
                     tier: Optional[str] = None) -> list[float]:
        return [v for _t, v in self._disk_points(key, lo, hi, window_s, tier)]

    def _disk_increase(self, key: tuple[str, LabelPairs], cutoff: float,
                       edge: float, window_s: float,
                       tier: Optional[str] = None,
                       edge_complete: bool = False,
                       ) -> tuple[float, Optional[float]]:
        """Reset-aware counter increase over the disk span
        [cutoff, edge), baselined like TSDB.series_increase (the last
        observation before the window seeds the first delta). Returns
        (increase, last_value) — last_value joins onto the memory
        suffix."""
        tier = tier or self._pick_tier(window_s, cutoff)
        idx = self.tiers[tier]
        # reach one bucket (or a retention-bounded slice) behind the
        # cutoff so the pre-window baseline sample is in range
        back = idx.bucket_s if idx.bucket_s else window_s
        blocks = idx.blocks(cutoff - back, edge)
        if not blocks:
            return 0.0, None
        ts, cols = _merge_series(blocks, key, cutoff - back, edge)
        if not ts:
            return 0.0, None
        if idx.bucket_s == 0:
            pts = list(zip(ts, cols["v"]))
            idx0 = 0
            for idx0, (t, _v) in enumerate(pts):
                if t >= cutoff:
                    break
            else:
                return 0.0, pts[-1][1]
            windowed = pts[idx0:]
            if idx0 > 0:
                windowed = [pts[idx0 - 1]] + windowed
            return increase_of(windowed), pts[-1][1]
        # downsampled: whole buckets overlapping the window, joined
        # reset-aware on first/last continuity; the bucket straddling
        # the cutoff contributes wholly (documented edge bound). When
        # the span ends at the memory floor (`edge_complete`), a bucket
        # straddling the edge is EXCLUDED — its `last` was observed
        # inside the memory window and would read as a phantom reset at
        # the join; the join itself covers the resulting gap exactly.
        total = 0.0
        prev_last: Optional[float] = None
        last_val: Optional[float] = None
        for i, bt in enumerate(ts):
            in_window = bt + idx.bucket_s > cutoff and bt < edge
            if edge_complete and bt + idx.bucket_s > edge:
                in_window = False
            if in_window:
                total += _join_delta(prev_last, cols["first"][i])
                total += cols["inc"][i]
                last_val = cols["last"][i]
            prev_last = cols["last"][i]
        return total, last_val

    def _key_of(self, series: Series) -> tuple[str, LabelPairs]:
        return (series.name, series.labels)

    def matching(self, name: str,
                 match: Optional[dict] = None) -> list[Series]:
        """Memory series plus synthetic (empty-ring) handles for series
        that now live only on disk — a long SLO window must see a dead
        instance's counters."""
        out = super().matching(name, match)
        have = {self._key_of(s) for s in out}
        want = None if match is None else _label_key(match)
        with self._lock:
            in_memory = {
                k for k in self._series if k[0] == name
            }
        for key, kind in self._disk_series_map().items():
            if key[0] != name or key in have or key in in_memory:
                continue
            if want is not None and not set(want) <= set(key[1]):
                continue
            out.append(Series(name, key[1], kind, capacity=2))
        return out

    def points(self, series: Series, window_s: Optional[float] = None,
               now: Optional[float] = None) -> list[tuple[float, float]]:
        now = time.time() if now is None else now
        mem = super().points(series, None, now)
        if window_s is None:
            if mem:
                return mem
            # disk-only series with no window bound: the newest ring's
            # worth from the finest tier that has it
            key = self._key_of(series)
            for tier in reversed(TIER_ORDER):
                lo = self.tiers[tier].min_time()
                if lo is None:
                    continue
                pts = self._disk_points(key, lo, now + 1.0, 0.0, tier)
                if pts:
                    return pts[-self.capacity:]
            return []
        cutoff = now - window_s
        mem_floor = mem[0][0] if mem else None
        mem_win = [p for p in mem if p[0] >= cutoff]
        if mem_floor is not None and mem_floor <= cutoff:
            return mem_win
        edge = mem_floor if mem_floor is not None else now + 1.0
        disk = self._disk_points(self._key_of(series), cutoff, edge,
                                 window_s)
        return disk + mem_win

    def series_increase(self, series: Series,
                        window_s: Optional[float] = None,
                        now: Optional[float] = None) -> float:
        if window_s is None:
            return super().series_increase(series, None, now)
        now = time.time() if now is None else now
        cutoff = now - window_s
        mem = super().points(series, None, now)
        mem_floor = mem[0][0] if mem else None
        if mem_floor is not None and mem_floor <= cutoff:
            return super().series_increase(series, window_s, now)
        edge = mem_floor if mem_floor is not None else now + 1.0
        disk_inc, disk_last = self._disk_increase(
            self._key_of(series), cutoff, edge, window_s,
            edge_complete=bool(mem),
        )
        if not mem:
            return disk_inc
        total = disk_inc + _join_delta(disk_last, mem[0][1])
        return total + increase_of(mem)

    def latest_point(self, name: str, match: Optional[dict] = None
                     ) -> Optional[tuple[float, float]]:
        best = super().latest_point(name, match)
        if best is not None:
            return best
        want = None if match is None else _label_key(match)
        now = time.time()
        for tier in reversed(TIER_ORDER):
            idx = self.tiers[tier]
            lo = idx.min_time()
            if lo is None:
                continue
            for key in idx.series_keys():
                if key[0] != name:
                    continue
                if want is not None and not set(want) <= set(key[1]):
                    continue
                pts = self._disk_points(key, lo, now + 1.0, 0.0, tier)
                if pts and (best is None or pts[-1][0] > best[0]):
                    best = pts[-1]
            if best is not None:
                return best
        return best

    # -- introspection -------------------------------------------------------

    def durable_stats(self) -> dict[str, Any]:
        with self._dlock:
            wal = {
                "segments": len(self._wal_segments()),
                "pending": len(self._pending),
                "active_points": self._wal_points,
                "flushed_points": self.wal_flushed_points,
                "ckpt_pending_points": self._ckpt_flushed,
            }
        return {
            "dir": self.dir,
            "wal": wal,
            "tiers": {name: self.tiers[name].stats() for name in TIER_ORDER},
            "replayed_points": self.replayed_points,
            "replayed_series": self.replayed_series,
            "ckpt_written": self.ckpt_written,
            "ckpt_seeded_points": self.ckpt_seeded_points,
        }

    def summary(self, limit: int = 0) -> dict[str, Any]:
        out = super().summary(limit)
        out["durable"] = self.durable_stats()
        return out
