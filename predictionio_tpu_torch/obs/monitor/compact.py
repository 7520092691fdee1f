"""The durable TSDB tier's downsampling compactor and retention.

Counterpart of the JAX package's ``obs/monitor/compact.py``, the port's
own copy; it writes the JAX package's block names and bytes. The
``tsdb-compactor`` thread rolls sealed raw blocks into the 5m tier and
5m blocks into the 1h tier, then enforces each tier's retention
(``PIO_TSDB_RETENTION_{RAW,5M,1H}``).

Each downsampled bucket stores count/sum/min/max/first/last and
``inc``: the reset-aware counter increase within the bucket, computed
here from the raw points while they exist. A window's increase is then
the sum of its buckets' ``inc`` and the reset-aware first/last joins
between adjacent buckets: exact over full buckets, so ``rate()`` and
``increase()`` survive the tiering (the slop is confined to the window's
two partial edge buckets). ``quantile_over_time`` reads one value a
bucket (``last``), its error bounded by the bucket's [min, max]. The
5m → 1h roll aggregates the same columns without the raw data: ``inc``
sums and the joins inside the hour.

A bucket is compacted only once it can no longer grow: its end must be
older than ``grace_s`` (the seal age and flush slack), so every raw
point of it is sealed. Retention deletes a source block only after the
next tier's watermark has passed it, so it never removes data that was
not yet downsampled.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Any, Optional

from predictionio_tpu_torch.obs.monitor.durable import (
    BLOCK_SUFFIX,
    DS_COLS,
    TIER_BUCKETS,
    DurableTSDB,
    _join_delta,
    _merge_series,
    write_block,
)
from predictionio_tpu_torch.obs.monitor.tsdb import increase_of

log = logging.getLogger(__name__)

#: source → target downsampling edges, in application order
TIER_CHAIN: tuple[tuple[str, str], ...] = (("raw", "5m"), ("5m", "1h"))

DEFAULT_RETENTION: dict[str, float] = {
    "raw": 6 * 3600.0,
    "5m": 3 * 86400.0,
    "1h": 14 * 86400.0,
}


def _bucket_rows_from_raw(ts: list[float], vals: list[float],
                          bucket_s: float, lo_bs: Optional[float],
                          hi_end: float) -> tuple[list[int],
                                                  dict[str, list[float]]]:
    """Bucket raw (t, v) points into complete buckets: starts aligned
    to `bucket_s`, >= lo_bs (watermark), ending by `hi_end`."""
    per: dict[float, list[float]] = {}
    for t, v in zip(ts, vals):
        bs = math.floor(t / bucket_s) * bucket_s
        if lo_bs is not None and bs < lo_bs:
            continue
        if bs + bucket_s > hi_end:
            continue
        per.setdefault(bs, []).append(v)
    out_ts: list[int] = []
    cols: dict[str, list[float]] = {c: [] for c in DS_COLS}
    for bs in sorted(per):
        vs = per[bs]
        out_ts.append(int(round(bs * 1000.0)))
        cols["count"].append(float(len(vs)))
        cols["sum"].append(math.fsum(vs))
        cols["min"].append(min(vs))
        cols["max"].append(max(vs))
        cols["first"].append(vs[0])
        cols["last"].append(vs[-1])
        cols["inc"].append(increase_of((0.0, v) for v in vs))
    return out_ts, cols


def _bucket_rows_from_ds(ts: list[float], cols: dict[str, list[float]],
                         bucket_s: float, lo_bs: Optional[float],
                         hi_end: float, src_bucket_s: float
                         ) -> tuple[list[int], dict[str, list[float]]]:
    """Re-bucket downsampled rows into coarser complete buckets,
    preserving exact counter ``inc`` via interior first/last joins."""
    per: dict[float, list[int]] = {}
    for i, t in enumerate(ts):
        bs = math.floor(t / bucket_s) * bucket_s
        if lo_bs is not None and bs < lo_bs:
            continue
        # the whole source bucket must fit inside the target bucket
        if t + src_bucket_s > bs + bucket_s or bs + bucket_s > hi_end:
            continue
        per.setdefault(bs, []).append(i)
    out_ts: list[int] = []
    out: dict[str, list[float]] = {c: [] for c in DS_COLS}
    for bs in sorted(per):
        idxs = sorted(per[bs], key=lambda i: ts[i])
        inc = 0.0
        prev_last: Optional[float] = None
        for j, i in enumerate(idxs):
            if j > 0:
                inc += _join_delta(prev_last, cols["first"][i])
            inc += cols["inc"][i]
            prev_last = cols["last"][i]
        out_ts.append(int(round(bs * 1000.0)))
        out["count"].append(math.fsum(cols["count"][i] for i in idxs))
        out["sum"].append(math.fsum(cols["sum"][i] for i in idxs))
        out["min"].append(min(cols["min"][i] for i in idxs))
        out["max"].append(max(cols["max"][i] for i in idxs))
        out["first"].append(cols["first"][idxs[0]])
        out["last"].append(cols["last"][idxs[-1]])
        out["inc"].append(inc)
    return out_ts, out


class Compactor:
    """Background downsample+retention pass over a DurableTSDB's tiers.
    `stop()` joins the thread, as every monitor thread's stop does."""

    thread_name = "tsdb-compactor"

    def __init__(self, durable: DurableTSDB, interval_s: float = 30.0,
                 retention: Optional[dict[str, float]] = None,
                 grace_s: Optional[float] = None):
        self.durable = durable
        self.interval_s = max(0.1, float(interval_s))
        self.retention = dict(DEFAULT_RETENTION)
        if retention:
            self.retention.update(retention)
        if grace_s is None:
            grace_s = durable.seal_age_s + 2.0 * durable.flush_interval_s
        self.grace_s = max(0.0, float(grace_s))
        self._lock = threading.Lock()
        self.compacted_blocks = 0
        self.compacted_buckets = 0
        self.removed_blocks = 0
        self.passes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one pass ------------------------------------------------------------

    def _watermark(self, tier: str) -> Optional[float]:
        """Exclusive bucket-start floor for the next compaction into
        `tier`: everything before it is already downsampled."""
        blocks = self.durable.tiers[tier].blocks()
        if not blocks:
            return None
        bucket_s = TIER_BUCKETS[tier]
        newest = max(b.max_t for b in blocks)
        return math.floor(newest / bucket_s) * bucket_s + bucket_s

    def _downsample_edge(self, src_name: str, dst_name: str, now: float,
                         force: bool) -> int:
        d = self.durable
        src = d.tiers[src_name]
        dst = d.tiers[dst_name]
        bucket_s = TIER_BUCKETS[dst_name]
        lo_bs = self._watermark(dst_name)
        hi_end = now + bucket_s if force else now - self.grace_s
        src_blocks = src.blocks(lo_bs, hi_end)
        if not src_blocks:
            return 0
        keys = {}
        for b in src_blocks:
            for key, entry in b.series.items():
                keys.setdefault(key, entry.get("k", "gauge"))
        rows = []
        lo_ms = hi_ms = None
        buckets = 0
        for key in sorted(keys):
            ts, cols = _merge_series(
                src_blocks, key, lo_bs if lo_bs is not None else 0.0,
                hi_end,
            )
            if not ts:
                continue
            if src.bucket_s == 0:
                out_ts, out_cols = _bucket_rows_from_raw(
                    ts, cols["v"], bucket_s, lo_bs, hi_end
                )
            else:
                out_ts, out_cols = _bucket_rows_from_ds(
                    ts, cols, bucket_s, lo_bs, hi_end, src.bucket_s
                )
            if not out_ts:
                continue
            rows.append((key[0], key[1], keys[key], out_ts, out_cols))
            buckets += len(out_ts)
            lo_ms = out_ts[0] if lo_ms is None else min(lo_ms, out_ts[0])
            hi_ms = out_ts[-1] if hi_ms is None else max(hi_ms, out_ts[-1])
        if not rows:
            return 0
        path = os.path.join(
            dst.root, f"b-{lo_ms}-{hi_ms}-d{int(bucket_s)}{BLOCK_SUFFIX}"
        )
        write_block(path, dst_name, rows)
        dst.invalidate()
        with self._lock:
            self.compacted_blocks += 1
            self.compacted_buckets += buckets
        return buckets

    def _enforce_retention(self, now: float) -> int:
        d = self.durable
        removed = 0
        next_of = {"raw": "5m", "5m": "1h", "1h": None}
        for tier, nxt in next_of.items():
            keep_s = float(self.retention.get(tier, 0.0))
            if keep_s <= 0:
                continue
            cutoff = now - keep_s
            next_wm = None
            if nxt is not None:
                blocks = d.tiers[nxt].blocks()
                next_wm = max((b.max_t for b in blocks), default=None)
                if next_wm is not None:
                    # a ds block's max_t is its newest bucket START;
                    # data is rolled up through that bucket's END
                    next_wm += TIER_BUCKETS[nxt]
            doomed = []
            for b in d.tiers[tier].blocks():
                if b.max_t >= cutoff:
                    continue
                # never prune data the next tier has not rolled up yet
                if nxt is not None and (next_wm is None
                                        or b.max_t > next_wm):
                    continue
                doomed.append(b.path)
            removed += d.tiers[tier].remove_blocks(doomed)
        if removed:
            with self._lock:
                self.removed_blocks += removed
        return removed

    def run_once(self, now: Optional[float] = None,
                 force: bool = False) -> dict[str, int]:
        """One compaction pass. `force` ignores the grace window and
        compacts every sealed bucket (tests, shutdown)."""
        now = time.time() if now is None else now
        buckets = 0
        for src_name, dst_name in TIER_CHAIN:
            buckets += self._downsample_edge(src_name, dst_name, now, force)
        removed = self._enforce_retention(now)
        with self._lock:
            self.passes += 1
        return {"buckets": buckets, "removed_blocks": removed}

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "passes": self.passes,
                "compacted_blocks": self.compacted_blocks,
                "compacted_buckets": self.compacted_buckets,
                "removed_blocks": self.removed_blocks,
                "grace_s": self.grace_s,
                "retention": dict(self.retention),
            }

    # -- thread lifecycle ----------------------------------------------------

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

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception:
                log.warning("TSDB compaction pass failed; retrying next "
                            "tick", exc_info=True)
