"""Durable local write-ahead spill for accepted events.

Counterpart of the JAX package's ``resilience/wal.py``, with its record
layout and segment names, so that either package replays the other's
segments. When the Event Server's storage is unreachable (the breaker
open, the retries spent) or its ``event.insert`` fault fires, an
accepted event lands here instead of being dropped: one JSON line a
record in an append-only segment, fsync'd before the server answers
202. A background replayer drains the segments in arrival order once
storage answers again.

No loss and no duplicates:

- every record carries a `req_id` minted at spill time (and stamped as
  the event id when the client sent none); the replayer hands it to the
  storage client, whose daemon dedupes on it, so a replayed insert is
  idempotent even when the replayer died between applying the write and
  acking it here;
- each replayed record's req_id is appended to the segment's ``.ack``
  sidecar (fsync'd), so that a restart resumes where it stopped;
- a segment whose records are all acked is deleted with its sidecar.

Layout under the WAL directory::

    wal-<epoch_ms>-<seq>-<pid>.jsonl      # records: {"req_id", "app_id",
                                          #   "channel_id", "event", "ts"}
    wal-<epoch_ms>-<seq>-<pid>.jsonl.ack  # one replayed req_id a line

The fixed-width epoch-ms prefix makes the name order the creation order,
across restarts and pids. The JAX package declares the append lock to
its lock sanitizer (``analysis/tsan.py``), which the port does not have;
nothing else differs. Standard library only.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Optional


class EventWAL:
    def __init__(self, directory: str, fsync: bool = True):
        self.dir = directory
        self.fsync = fsync
        os.makedirs(self.dir, exist_ok=True)
        # the append path and the pending count: held across the spill's
        # fsync by design (fsync before the ack and the count are one step)
        self._lock = threading.Lock()
        self._replay_lock = threading.Lock()  # one replay pass at a time
        self._seq = 0
        self._current_path: Optional[str] = None
        self._current_file = None
        self._pending = self._scan_pending()

    # -- bookkeeping -------------------------------------------------------
    def _segments(self) -> list[str]:
        """Segment paths, oldest first (the name order)."""
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("wal-") and n.endswith(".jsonl"))
        except FileNotFoundError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    @staticmethod
    def _read_records(path: str) -> list[dict[str, Any]]:
        records = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        # a torn tail from a crash mid-append: that record
                        # was never acked to its client
                        continue
        except FileNotFoundError:
            pass
        return records

    @staticmethod
    def _read_acks(path: str) -> set[str]:
        try:
            with open(path + ".ack") as f:
                return {line.strip() for line in f if line.strip()}
        except FileNotFoundError:
            return set()

    def _scan_pending(self) -> int:
        n = 0
        for seg in self._segments():
            acked = self._read_acks(seg)
            n += sum(1 for r in self._read_records(seg) if r.get("req_id") not in acked)
        return n

    def pending(self) -> int:
        with self._lock:
            return self._pending

    # -- spill -------------------------------------------------------------
    def append(self, event: Any, app_id: int, channel_id: Optional[int]) -> str:
        """Spill one admitted event; returns its replay req_id. The record
        is flushed and fsync'd before the return: the 202 the caller sends
        promises durability."""
        return self.append_batch([event], app_id, channel_id)[0]

    def append_batch(self, events: list, app_id: int,
                     channel_id: Optional[int]) -> list[str]:
        """Spill a batch's admitted events in order under one flush and
        one fsync (the JAX package fsyncs each of them; the records, and
        the promise each 202 makes, are the same); returns their req_ids."""
        req_ids, lines = [], []
        for event in events:
            req_id = uuid.uuid4().hex
            # the req_id is the event id when the client gave none: a
            # replayed insert then overwrites in the store instead of adding
            # a row, so a batched replay that re-sends a torn ack's suffix
            # stays exact
            event_d = event.to_json_dict()
            event_d.setdefault("eventId", req_id)
            rec = {"req_id": req_id, "app_id": app_id, "channel_id": channel_id,
                   "event": event_d, "ts": round(time.time(), 3)}
            req_ids.append(req_id)
            lines.append(json.dumps(rec, separators=(",", ":")) + "\n")
        with self._lock:
            if self._current_file is None:
                self._seq += 1
                self._current_path = os.path.join(
                    self.dir,
                    f"wal-{int(time.time() * 1000):015d}-{self._seq:06d}-{os.getpid()}.jsonl",
                )
                self._current_file = open(self._current_path, "a")
            self._current_file.write("".join(lines))
            self._current_file.flush()
            if self.fsync:
                os.fsync(self._current_file.fileno())
            self._pending += len(lines)
        return req_ids

    def _rotate(self) -> None:
        with self._lock:
            if self._current_file is not None:
                self._current_file.close()
                self._current_file = None
                self._current_path = None

    # -- replay ------------------------------------------------------------
    def _todo(self, seg: str) -> Optional[list[dict]]:
        """The unacked records of a closed segment; None for the segment
        an append reopened during this pass (the next pass takes it:
        deleting a live segment would drop its events)."""
        with self._lock:
            if seg == self._current_path:
                return None
        acked = self._read_acks(seg)
        return [r for r in self._read_records(seg) if r["req_id"] not in acked]

    def _ack(self, ack_f, records: list[dict],
             on_replayed: Optional[Callable[[dict], None]]) -> None:
        ack_f.write("".join(r["req_id"] + "\n" for r in records))
        ack_f.flush()
        if self.fsync:
            os.fsync(ack_f.fileno())
        with self._lock:
            self._pending -= len(records)
        if on_replayed is not None:
            for r in records:
                try:
                    on_replayed(r)
                except Exception:
                    pass

    @staticmethod
    def _reclaim(seg: str) -> None:
        for path in (seg, seg + ".ack"):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    def replay(
        self,
        insert_fn: Callable[[Any, int, Optional[int], str], Any],
        on_replayed: Optional[Callable[[dict], None]] = None,
    ) -> tuple[int, Optional[Exception]]:
        """Drain the pending records in order through ``insert_fn(event,
        app_id, channel_id, req_id)``. Stops at the first failure (a later
        event must not overtake a stuck one) and returns
        ``(replayed, error or None)``."""
        from predictionio_tpu_torch.data.event import Event

        if not self._replay_lock.acquire(blocking=False):
            return (0, None)  # another pass is running
        try:
            self._rotate()  # appends go to a fresh segment
            replayed = 0
            for seg in self._segments():
                todo = self._todo(seg)
                if todo is None:
                    continue
                if todo:
                    with open(seg + ".ack", "a") as ack_f:
                        for rec in todo:
                            try:
                                insert_fn(Event.from_json_dict(rec["event"]), rec["app_id"],
                                          rec.get("channel_id"), rec["req_id"])
                            except Exception as e:
                                return (replayed, e)
                            self._ack(ack_f, [rec], on_replayed)
                            replayed += 1
                self._reclaim(seg)
            return (replayed, None)
        finally:
            self._replay_lock.release()

    def replay_batched(
        self,
        insert_batch_fn: Callable[[list, int, Optional[int], str], Any],
        max_batch: int = 50,
        on_replayed: Optional[Callable[[dict], None]] = None,
    ) -> tuple[int, Optional[Exception]]:
        """Ordered replay through a bulk insert: consecutive unacked
        records of one (app, channel) namespace go in chunks of at most
        `max_batch` as one ``insert_batch_fn(events, app_id, channel_id,
        batch_req_id)`` call, one storage RPC a chunk.

        Exactly once: the batch req_id is ``walb-`` + the first member's
        req_id, and a chunk's members follow from the ack state (the same
        prefix gives the same id), so a re-send after a lost response
        replays the daemon's recorded outcome; the spill-time event ids
        make any residual re-insert an overwrite. The chunk's acks land
        in one write after the batch succeeds."""
        from predictionio_tpu_torch.data.event import Event

        if not self._replay_lock.acquire(blocking=False):
            return (0, None)
        try:
            self._rotate()
            replayed = 0
            for seg in self._segments():
                todo = self._todo(seg)
                if todo is None:
                    continue
                chunks: list[list[dict]] = []
                for rec in todo:
                    key = (rec["app_id"], rec.get("channel_id"))
                    if (chunks and len(chunks[-1]) < max_batch
                            and (chunks[-1][0]["app_id"],
                                 chunks[-1][0].get("channel_id")) == key):
                        chunks[-1].append(rec)
                    else:
                        chunks.append([rec])
                if chunks:
                    with open(seg + ".ack", "a") as ack_f:
                        for chunk in chunks:
                            try:
                                insert_batch_fn(
                                    [Event.from_json_dict(r["event"]) for r in chunk],
                                    chunk[0]["app_id"], chunk[0].get("channel_id"),
                                    f"walb-{chunk[0]['req_id']}")
                            except Exception as e:
                                return (replayed, e)
                            self._ack(ack_f, chunk, on_replayed)
                            replayed += len(chunk)
                self._reclaim(seg)
            return (replayed, None)
        finally:
            self._replay_lock.release()

    def close(self) -> None:
        self._rotate()
