"""Sharded event store: one app's events over N stores by entity hash.

Counterpart of the JAX package's ``data/storage/sharded.py``. The
reference's event store at scale is HBase: events spread over region
servers by row key (entity first, HBEventsUtil.scala:47-106) and scanned
a region at a time in parallel (HBPEvents.scala:84-90). Here N child
stores take that role, as a rule ``remote`` storage daemons on hosts of
their own. Each event's home is the shard ``shard_of(entity_id, N)``,
the hash of the partitioned read (``EventQuery.shard``): all of one
entity's events sit on one shard, ingest and volume split about evenly,
and a training read of ``shard=(i, N)`` goes to shard i alone.

Configure::

  PIO_STORAGE_SOURCES_<NAME>_TYPE=sharded
  PIO_STORAGE_SOURCES_<NAME>_SHARDS=host1:port1,host2:port2,...
  PIO_STORAGE_SOURCES_<NAME>_REPLICAS=2        # optional, default 1
  PIO_STORAGE_SOURCES_<NAME>_ALLOW_PARTIAL=1   # optional
  PIO_STORAGE_SOURCES_<NAME>_RETRIES=2         # optional
  PIO_STORAGE_SOURCES_<NAME>_HEDGED_READS=0    # optional, see below

Every other setting (``AUTH_KEY``, ``TIMEOUT``, ...) goes to each
child. METADATA and MODELDATA are not sharded: point them at one other
source.

Failures:

- A child call that fails for connectivity (``StorageUnreachableError``
  or ``OSError``) is retried ``RETRIES`` times, attempt i after
  ``BACKOFF_BASE * 2**i`` seconds; then it raises ``ShardDownError``,
  which names the shard and its address. Other storage errors pass
  through at once.
- ``ALLOW_PARTIAL=1`` lets broadcast reads (a find with no entity or
  shard scope, ``get``, ``aggregate_properties``) skip a down shard;
  the skipped shards are on ``last_degraded_shards``. Writes are never
  partial: a batch whose home shard is down raises
  ``PartialBatchWriteError`` with the ids of the events that persisted,
  position by position.
- ``REPLICAS=R`` writes each event to its home and the next R-1 shards.
  The write succeeds when the home commits; a failed copy is logged and
  not retried (no hinted handoff: a down shard's copies catch up only by
  a new import). A scoped read fails over to a copy holder, and the
  merged find reads each shard's primaries only (``shard=(i, N)``, the
  copies carry another hash) with failover a partition. The merged find
  reads every shard at once, a page ahead on a thread a shard.
- ``HEDGED_READS`` (on when R > 1): ``find_entities_batch``, the serving
  history read, sends the same read to the copy holder when the home has
  not answered within the recent p95, and the first answer wins
  (``storage_hedged_reads_total{outcome}``). A copy may hold a shorter
  history than its home; set ``HEDGED_READS=0`` where that matters.
- ``health()`` pings every shard (the self-check of ``console status``).

``revision_streams()`` gives one stream a shard, filtered to the shard's
primaries, so a consumer folds every event once at any R; ``find_since``
on the whole store refuses, as the JAX store does. ``find_edges`` (the
port's fold history read; the JAX fold reads through ``find``) reads a
home shard's entities in one bulk call.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import logging
import queue
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor, as_completed
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Iterator, Optional, Sequence

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    EventQuery,
    StorageError,
    StorageUnreachableError,
    shard_of,
)

# the failures retried and attributed as "shard down": connectivity only
_TRANSIENT = (StorageUnreachableError, OSError)

log = logging.getLogger(__name__)


class PartialBatchWriteError(StorageError):
    """A batch write that landed on some shards and not on others. `ids`
    follows the input positions: the event's id where it persisted, None
    where its shard failed, so that a batch endpoint answers each event
    truly (a blanket failure invites a retry that duplicates the events
    that did persist)."""

    def __init__(self, ids, cause: Exception):
        n_fail = sum(1 for i in ids if i is None)
        super().__init__(f"bulk write failed on {n_fail}/{len(ids)} events: {cause}")
        self.ids = list(ids)
        self.cause = cause


class ShardDownError(StorageError):
    """A shard that stayed unreachable through the retries."""

    def __init__(self, shard_index: int, address: str, cause: Exception):
        super().__init__(f"shard {shard_index} ({address}) is down: {cause}")
        self.shard_index = shard_index
        self.address = address
        self.cause = cause


class _Done:
    """A finished call's outcome with a future's `result()`."""

    def __init__(self, value=None, err: Optional[Exception] = None):
        self._value, self._err = value, err

    def result(self):
        if self._err is not None:
            raise self._err
        return self._value


class ShardedEventStore(base.EventStore):
    """Entity-hash composite over N child event stores."""

    # a write with an explicit event id first deletes that id from every
    # other shard (the entity may have moved): a writer with a fresh id
    # of its own (the Event Server) leaves the id to the store instead
    EVICTS_EXPLICIT_IDS = True

    # attempt i of a retried call sleeps BACKOFF_BASE * 2**i first
    BACKOFF_BASE = 0.05

    # the hedge: the recent reads' p95 over a window, a default before 20
    # reads, and a floor so that a store's microsecond p95 does not
    # duplicate every read
    HEDGE_WINDOW = 512
    HEDGE_DEFAULT_DELAY_S = 0.05
    HEDGE_MIN_DELAY_S = 0.002

    def __init__(
        self,
        config: Optional[dict] = None,
        stores: Optional[Sequence[base.EventStore]] = None,
        allow_partial: Optional[bool] = None,
        retries: Optional[int] = None,
    ):
        config = config or {}
        if stores is not None:  # composed directly
            self._stores = list(stores)
        else:
            addrs = [a.strip() for a in config.get("SHARDS", "").split(",") if a.strip()]
            if not addrs:
                raise StorageError("sharded backend needs SHARDS=host:port[,host:port...]")
            from predictionio_tpu_torch.data.storage.remote import RemoteEventStore

            child_cfg = {k: v for k, v in config.items()
                         if k not in ("SHARDS", "ALLOW_PARTIAL", "RETRIES", "REPLICAS",
                                      "HEDGED_READS")}
            self._stores = []
            for addr in addrs:
                host, _, port = addr.rpartition(":")
                self._stores.append(RemoteEventStore(
                    dict(child_cfg, HOST=host or "127.0.0.1", PORT=port)))
        if not self._stores:
            raise StorageError("sharded backend needs at least one shard")
        self.allow_partial = (
            allow_partial if allow_partial is not None
            else str(config.get("ALLOW_PARTIAL", "")).strip() in ("1", "true", "yes"))
        self.retries = int(retries) if retries is not None else int(config.get("RETRIES", "2"))
        self.replicas = max(1, min(int(config.get("REPLICAS", "1")), len(self._stores)))
        self.hedged_reads = self.replicas > 1 and str(
            config.get("HEDGED_READS", "1")).strip() not in ("0", "false", "no")
        self._read_lat: list[float] = []
        self._lat_lock = threading.Lock()
        from predictionio_tpu_torch.obs.registry import get_default_registry

        self._hedge_counter = get_default_registry().counter(
            "storage_hedged_reads_total", "hedged idempotent replica reads by outcome",
            ("outcome",),  # label-bound: the four outcomes of _hedged_call
        )
        # the shards the last broadcast read skipped (empty: it was
        # complete); a diagnostic, not synchronized between readers
        self.last_degraded_shards: list[int] = []
        # broadcasts fan out at once; sized for several concurrent callers
        # (the Event Server's writers), not one
        self._pool = ThreadPoolExecutor(max_workers=max(8, 4 * len(self._stores)),
                                        thread_name_prefix="shardcast")
        # children in this process share its interpreter lock: a small
        # write runs inline, where the pool's hop costs more than the
        # write; children that wait on the network (IO_PARALLEL_WRITES)
        # fan out
        self._all_local_children = not any(
            getattr(s, "IO_PARALLEL_WRITES", False) for s in self._stores)
        # hedged reads run on a pool of their own: they are submitted from
        # the broadcast pool's tasks, which a full broadcast pool would
        # deadlock
        self._hedge_pool = ThreadPoolExecutor(max_workers=max(4, 2 * len(self._stores)),
                                              thread_name_prefix="shardhedge")

    @property
    def n_shards(self) -> int:
        return len(self._stores)

    def shard_address(self, sx: int) -> str:
        """Shard `sx`'s name in errors and health lines."""
        s = self._stores[sx]
        client = getattr(s, "_client", None)
        if client is not None and hasattr(client, "host"):
            return f"{client.host}:{client.port}"
        return f"local[{sx}]:{type(s).__name__}"

    def _for_entity(self, entity_id: str) -> int:
        return shard_of(entity_id, self.n_shards)

    def _replica_chain(self, home: int) -> list[int]:
        """The home shard, then its R-1 successors (the copy holders)."""
        return [(home + k) % self.n_shards for k in range(self.replicas)]

    # -- hedged reads -------------------------------------------------------
    def _record_read_latency(self, seconds: float) -> None:
        with self._lat_lock:
            self._read_lat.append(seconds)
            if len(self._read_lat) > self.HEDGE_WINDOW:
                del self._read_lat[: -self.HEDGE_WINDOW]

    def hedge_delay_s(self) -> float:
        """The hedge's trigger: the recent reads' p95 (at least
        HEDGE_MIN_DELAY_S), or HEDGE_DEFAULT_DELAY_S before 20 reads."""
        with self._lat_lock:
            lat = sorted(self._read_lat)
        if len(lat) < 20:
            return self.HEDGE_DEFAULT_DELAY_S
        return max(self.HEDGE_MIN_DELAY_S, lat[min(len(lat) - 1, int(0.95 * len(lat)))])

    def _hedged_call(self, chain: Sequence[int], make_call):
        """An idempotent read on `chain[0]`, sent also to `chain[1]` when
        the first has not answered within `hedge_delay_s()`; the first
        answer wins and the other runs out in the pool. `make_call(sx)`
        gives the zero-argument call on shard sx. Outcomes counted:
        primary_fast (answered before the hedge), primary (after it),
        hedge (the copy won), failover (the home raised)."""

        def serial(shards: Sequence[int]):
            last: Optional[ShardDownError] = None
            for sx in shards:
                try:
                    t0 = time.monotonic()
                    out = self._shard_call(sx, make_call(sx))
                    self._record_read_latency(time.monotonic() - t0)
                    return out
                except ShardDownError as e:
                    last = e
                    log.warning("shard %d down for read; trying replica", sx)
            raise last  # type: ignore[misc]

        if len(chain) < 2 or not self.hedged_reads:
            return serial(chain)
        t0 = time.monotonic()
        primary = self._hedge_pool.submit(self._shard_call, chain[0], make_call(chain[0]))
        try:
            out = primary.result(timeout=self.hedge_delay_s())
            self._record_read_latency(time.monotonic() - t0)
            self._hedge_counter.inc(outcome="primary_fast")
            return out
        except FuturesTimeout:
            pass
        except ShardDownError:
            self._hedge_counter.inc(outcome="failover")
            return serial(chain[1:])
        hedge = self._hedge_pool.submit(self._shard_call, chain[1], make_call(chain[1]))
        errors: list[Exception] = []
        for f in as_completed([primary, hedge]):
            try:
                out = f.result()
            except Exception as e:
                errors.append(e)
                continue
            self._record_read_latency(time.monotonic() - t0)
            if f is primary:
                outcome = "primary"
            else:
                outcome = "hedge" if not errors else "failover"
            self._hedge_counter.inc(outcome=outcome)
            return out
        if len(chain) > 2:  # both failed: the deeper copies, in turn
            self._hedge_counter.inc(outcome="failover")
            return serial(chain[2:])
        raise errors[0]

    # -- retries and attribution ---------------------------------------------
    def _shard_call(self, sx: int, fn: Callable, *args, retries: Optional[int] = None):
        """One child call, retried on connectivity failures with backoff,
        then ShardDownError. `retries=0` for calls that must not run
        twice: an insert's second call would mint a new request id and
        defeat the daemon's dedupe (the remote client's own same-id retry
        covers a lost answer)."""
        budget = self.retries if retries is None else retries
        last: Optional[Exception] = None
        for attempt in range(budget + 1):
            try:
                return fn(*args)
            except _TRANSIENT as e:
                last = e
                if attempt < budget:
                    time.sleep(self.BACKOFF_BASE * (2 ** attempt))
        raise ShardDownError(sx, self.shard_address(sx), last)  # type: ignore[arg-type]

    def _broadcast(self, calls: Sequence[tuple[int, Callable, tuple]], partial_ok: bool = False,
                   retries: Optional[int] = None) -> dict[int, Any]:
        """(shard, fn, args) calls at once; {shard: result}. With
        `partial_ok` and ALLOW_PARTIAL a down shard is skipped and
        recorded on last_degraded_shards; otherwise the first error
        raises once every call has ended."""
        futs = {sx: self._pool.submit(self._shard_call, sx, fn, *args, retries=retries)
                for sx, fn, args in calls}
        out: dict[int, Any] = {}
        degraded: list[int] = []
        first_err: Optional[Exception] = None
        for sx, f in futs.items():
            try:
                out[sx] = f.result()
            except ShardDownError as e:
                if partial_ok and self.allow_partial:
                    degraded.append(sx)
                    log.warning("degraded read: skipping %s", e)
                elif first_err is None:
                    first_err = e
            except Exception as e:  # drain the rest before raising
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        if partial_ok:
            self.last_degraded_shards = degraded
        return out

    # -- lifecycle -------------------------------------------------------------
    def init_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        res = self._broadcast([(sx, s.init_app, (app_id, channel_id))
                               for sx, s in enumerate(self._stores)])
        return all(res.values())

    def remove_app(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        res = self._broadcast([(sx, s.remove_app, (app_id, channel_id))
                               for sx, s in enumerate(self._stores)])
        return all(res.values())

    def close(self) -> None:
        for s in self._stores:
            if hasattr(s, "close"):
                s.close()
        self._pool.shutdown(wait=False)
        self._hedge_pool.shutdown(wait=False)

    def health(self) -> list[dict]:
        """[{shard, address, alive, error}] for every shard, pinged at
        once. A child without a transport (in this process) is alive."""

        def probe(s: base.EventStore) -> dict:
            client = getattr(s, "_client", None)
            try:
                if client is not None and hasattr(client, "ping"):
                    alive = bool(client.ping())
                    return {"alive": alive, "error": None if alive else "ping failed"}
                return {"alive": True, "error": None}
            except Exception as e:  # health never raises
                return {"alive": False, "error": str(e)}

        futs = [self._pool.submit(probe, s) for s in self._stores]
        return [{"shard": sx, "address": self.shard_address(sx), **futs[sx].result()}
                for sx in range(self.n_shards)]

    # -- the revision tail -----------------------------------------------------
    def revision_streams(self):
        """One stream a shard, filtered to the shard's primaries
        (`shard=(sx, N)`: a copy on a successor has another hash), so a
        consumer that folds every stream sees each event once at any R.
        Revisions rise within a stream."""
        return [(f"shard{sx}", s, (sx, self.n_shards)) for sx, s in enumerate(self._stores)]

    def find_since(self, app_id: int, after_revision: int, channel_id: Optional[int] = None,
                   limit: Optional[int] = None, shard: Optional[tuple[int, int]] = None):
        raise StorageError("sharded stores have no single revision sequence; tail the "
                           "per-shard streams from revision_streams() instead")

    # -- writes, routed by entity hash -------------------------------------------
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        home = self._for_entity(event.entity_id)
        if event.event_id:
            # an explicit id may live on another shard (the entity
            # changed): evict it everywhere but home first, copy holders
            # too (they get the new copy next; a stale one there would
            # pass the primaries-only filters)
            self._broadcast([(sx, s.delete, (event.event_id, app_id, channel_id))
                             for sx, s in enumerate(self._stores) if sx != home])
        eid = self._shard_call(home, self._stores[home].insert, event, app_id, channel_id,
                               retries=0)
        self._replicate([(event.with_id(eid), home)], app_id, channel_id)
        return eid

    def insert_with_req_id(self, event: Event, app_id: int, channel_id: Optional[int],
                           req_id: str) -> str:
        """An insert under the caller's request id (the WAL replay's),
        through the home child's own deduped insert where it has one."""
        home = self._for_entity(event.entity_id)
        fn = getattr(self._stores[home], "insert_with_req_id", None)
        if fn is None:
            return self.insert(event, app_id, channel_id)
        eid = self._shard_call(home, fn, event, app_id, channel_id, req_id, retries=0)
        self._replicate([(event.with_id(eid), home)], app_id, channel_id)
        return eid

    def _replicate(self, primaries: Sequence[tuple[Event, int]], app_id: int,
                   channel_id: Optional[int]) -> None:
        """Copy committed primaries (events with their ids, home shard)
        to the successors. A failed copy is logged, not raised."""
        if self.replicas <= 1 or not primaries:
            return
        per_follower: dict[int, list[Event]] = {}
        for e, home in primaries:
            for sx in self._replica_chain(home)[1:]:
                per_follower.setdefault(sx, []).append(e)
        futs = {sx: self._pool.submit(self._shard_call, sx, self._stores[sx].insert_batch,
                                      evs, app_id, channel_id, retries=0)
                for sx, evs in per_follower.items()}
        for sx, f in futs.items():
            try:
                f.result()
            except Exception as e:
                log.error("replica write to shard %d failed — %d event(s) have reduced "
                          "redundancy: %s", sx, len(per_follower[sx]), e)

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list[str]:
        return self._insert_batch_impl(events, app_id, channel_id, None)

    def insert_batch_with_req_id(self, events: Sequence[Event], app_id: int,
                                 channel_id: Optional[int], req_id: str) -> list[str]:
        """A batch under one request id of the caller's (the WAL's batched
        replay): each shard's group lands under ``{req_id}/s{shard}``. The
        groups follow from the batch, so a replay re-forms them under the
        same ids and each daemon's dedupe replays its answer."""
        return self._insert_batch_impl(events, app_id, channel_id, req_id)

    def _insert_batch_impl(self, events: Sequence[Event], app_id: int,
                           channel_id: Optional[int], req_id: Optional[str]) -> list[str]:
        if not events:
            return []
        # one batch a shard; the ids come back in input order
        groups: dict[int, list[tuple[int, Event]]] = {}
        explicit: list[tuple[int, str]] = []  # (home, event id)
        for pos, e in enumerate(events):
            sx = self._for_entity(e.entity_id)
            groups.setdefault(sx, []).append((pos, e))
            if e.event_id:
                explicit.append((sx, e.event_id))
        # explicit ids: evicted from every shard but their home, one bulk
        # delete a shard
        evict_calls = []
        for sx in range(self.n_shards):
            ids = [eid for home, eid in explicit if home != sx]
            if ids:
                evict_calls.append((sx, self._stores[sx].delete_batch, (ids, app_id, channel_id)))
        if evict_calls:
            self._broadcast(evict_calls)

        def plan(sx: int):
            child = self._stores[sx]
            evs = [e for _p, e in groups[sx]]
            batch_fn = (getattr(child, "insert_batch_with_req_id", None)
                        if req_id is not None else None)
            if batch_fn is not None:
                return batch_fn, (evs, app_id, channel_id, f"{req_id}/s{sx}")
            return child.insert_batch, (evs, app_id, channel_id)

        def run_inline(sx: int) -> _Done:
            batch_fn, args = plan(sx)
            try:
                return _Done(self._shard_call(sx, batch_fn, *args, retries=0))
            except Exception as e:  # collected like any shard's failure
                return _Done(err=e)

        order = list(groups)
        futs: dict[int, Any] = {}
        if self._all_local_children and len(events) < 256:
            for sx in order:
                futs[sx] = run_inline(sx)
        else:
            # the caller's thread takes the last group
            for sx in order[:-1]:
                batch_fn, args = plan(sx)
                futs[sx] = self._pool.submit(self._shard_call, sx, batch_fn, *args, retries=0)
            futs[order[-1]] = run_inline(order[-1])
        out: list[Optional[str]] = [None] * len(events)
        committed: list[tuple[Event, int]] = []
        stamp = self.replicas > 1  # ids on copies only when copies are made
        first_err: Optional[Exception] = None
        for sx, pairs in groups.items():
            try:
                ids = futs[sx].result()
            except Exception as e:
                if first_err is None:
                    first_err = e
                continue
            for (pos, e), eid in zip(pairs, ids):
                out[pos] = eid
                if stamp:
                    committed.append((e.with_id(eid), sx))
        self._replicate(committed, app_id, channel_id)
        if first_err is not None:
            raise PartialBatchWriteError(out, first_err)
        return out  # type: ignore[return-value]

    # -- by id: the id does not name its shard, so every shard is asked -------
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        futs = {self._pool.submit(self._shard_call, sx, s.get, event_id, app_id, channel_id): sx
                for sx, s in enumerate(self._stores)}
        first_err: Optional[ShardDownError] = None
        degraded: list[int] = []
        try:
            for f in as_completed(futs):
                try:
                    e = f.result()
                except ShardDownError as err:
                    degraded.append(futs[f])
                    if first_err is None:
                        first_err = err
                    continue
                if e is not None:
                    # a hit is the answer even with a shard down: an
                    # overwrite evicts before it rewrites, so every live
                    # copy of an id is the same
                    return e
        finally:
            for f in futs:
                f.cancel()
        if first_err is not None and not self.allow_partial:
            raise first_err  # absence needs every shard's answer
        if first_err is not None:
            self.last_degraded_shards = degraded
            log.warning("degraded get(%s): %s", event_id, first_err)
        return None

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        res = self._broadcast([(sx, s.delete, (event_id, app_id, channel_id))
                               for sx, s in enumerate(self._stores)])
        return any(res.values())

    def delete_batch(self, event_ids: Sequence[str], app_id: int,
                     channel_id: Optional[int] = None) -> int:
        """One bulk delete a shard. At R > 1 the count is of copies."""
        ids = list(event_ids)
        res = self._broadcast([(sx, s.delete_batch, (ids, app_id, channel_id))
                               for sx, s in enumerate(self._stores)])
        return sum(res.values())

    # -- reads ---------------------------------------------------------------------
    def _degrade(self, sx: int) -> None:
        if sx not in self.last_degraded_shards:
            self.last_degraded_shards.append(sx)

    def _guarded_stream(self, sx: int, query: EventQuery,
                        partial_ok: bool = False) -> Iterator[Event]:
        """Shard sx's find, its connectivity failures attributed to it. A
        failure before the first event retries on a new iterator (nothing
        was yielded); one mid-stream raises at once (a replay would
        repeat events). Only broadcast reads (`partial_ok`) degrade: an
        empty answer to a scoped read would pass for "no events"."""

        def down(e: Exception) -> Optional[ShardDownError]:
            err = ShardDownError(sx, self.shard_address(sx), e)
            if partial_ok and self.allow_partial:
                self._degrade(sx)
                log.warning("degraded read: %s", err)
                return None
            return err

        first: Optional[Event] = None
        it: Optional[Iterator[Event]] = None
        for attempt in range(self.retries + 1):
            try:
                it = iter(self._stores[sx].find(query))
                first = next(it)
                break
            except StopIteration:
                return
            except _TRANSIENT as e:
                if attempt < self.retries:
                    time.sleep(self.BACKOFF_BASE * (2 ** attempt))
                    continue
                err = down(e)
                if err is None:
                    return
                raise err from e
        yield first  # type: ignore[misc]
        try:
            yield from it  # type: ignore[misc]
        except _TRANSIENT as e:
            err = down(e)
            if err is not None:
                raise err from e

    def _failover_stream(self, chain: Sequence[int], query: EventQuery,
                         partial_ok: bool = False) -> Iterator[Event]:
        """`query` from the first live shard of `chain` (the home, then
        its copy holders, which hold the same events for this scope).
        Failover only before the first event: a cut mid-stream raises (or
        degrades, for a broadcast read under ALLOW_PARTIAL)."""
        last: Optional[ShardDownError] = None
        for j, sx in enumerate(chain):
            yielded = False
            try:
                for e in self._guarded_stream(sx, query):
                    yielded = True
                    yield e
                return
            except ShardDownError as err:
                if yielded:
                    if partial_ok and self.allow_partial:
                        self._degrade(chain[0])
                        log.warning("degraded read: stream cut mid-flight; %s", err)
                        return
                    raise
                last = err
                if j + 1 < len(chain):
                    log.warning("shard %d down; reading partition from replica on shard %d",
                                sx, chain[j + 1])
        if last is not None:
            if partial_ok and self.allow_partial:
                self._degrade(chain[0])
                log.warning("degraded read: %s", last)
                return
            raise last

    def _read_ahead(self, sx: int, stream: Iterator[Event]) -> Iterator[Event]:
        """`stream` (shard sx's part of a merged find) read on a thread of
        its own, started now, a page ahead, so that the shards' daemons
        serve one merged read at once (the parallel region scan). An error
        raises in the reader after the events read before it, where the
        stream raised it; the thread ends when the stream does or the
        reader lets go."""
        page = max(1, int(getattr(self._stores[sx], "FIND_PAGE", 1024)))
        chunks: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    chunks.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def pump() -> None:
            chunk: list = []
            try:
                for e in stream:
                    chunk.append(e)
                    if len(chunk) == page:
                        if not put((chunk, None)):
                            return
                        chunk = []
                if put((chunk, None)):
                    put(None)
            except BaseException as e:  # noqa: BLE001 — handed to the reader
                put((chunk, e))

        threading.Thread(target=pump, name=f"shardscan-{sx}", daemon=True).start()

        def read() -> Iterator[Event]:
            try:
                while (item := chunks.get()) is not None:
                    chunk, err = item
                    yield from chunk
                    if err is not None:
                        raise err
            finally:
                stop.set()

        reader = read()
        weakref.finalize(reader, stop.set)  # a reader dropped before its first event
        return reader

    def find(self, query: EventQuery) -> Iterator[Event]:
        if query.entity_id is not None:
            # one shard (and its copies) holds the entity: never partial
            return self._failover_stream(
                self._replica_chain(self._for_entity(query.entity_id)), query)
        if (query.shard is not None and query.shard[1] == self.n_shards
                and 0 <= query.shard[0] < self.n_shards):
            # partition i of N is shard i's primaries: one daemon's stream
            # (the child filters too, which picks partition i's events out
            # of a copy holder on failover)
            return self._failover_stream(self._replica_chain(query.shard[0]), query)
        self.last_degraded_shards = []
        if self.replicas > 1:
            # each shard's primaries only, with failover a partition; a
            # caller's shard filter of another count applies on top
            caller_shard = query.shard

            def partition(i: int) -> Iterator[Event]:
                # the limit goes down to each child unless the caller's
                # filter drops rows after it
                q_i = dataclasses.replace(
                    query, shard=(i, self.n_shards),
                    limit=None if caller_shard is not None else query.limit)
                stream = self._failover_stream(self._replica_chain(i), q_i, partial_ok=True)
                if caller_shard is None:
                    return stream
                j, m = caller_shard
                return (e for e in stream if shard_of(e.entity_id, m) == j)

            streams = [partition(i) for i in range(self.n_shards)]
        else:
            streams = [self._guarded_stream(sx, query, partial_ok=True)
                       for sx in range(self.n_shards)]
        readers = [self._read_ahead(sx, st) for sx, st in enumerate(streams)]
        merged = heapq.merge(*readers, key=lambda e: (e.event_time, e.event_id or ""),
                             reverse=query.reversed)
        if query.limit is not None and query.limit >= 0:
            return itertools.islice(merged, query.limit)
        return merged

    def find_entities_batch(self, app_id, entity_type, entity_ids, event_names=None,
                            limit_per_entity=None, channel_id=None, reversed=True):
        """One bulk read a home shard, all at once, hedged to the copy
        holder at R > 1 (the serving tier's history read). Never partial:
        a missing history would pass for a new user. A winning hedge may
        hold a shorter history than a slow home (HEDGED_READS=0 where
        that matters)."""
        groups: dict[int, list[str]] = {}
        for eid in dict.fromkeys(entity_ids):
            groups.setdefault(self._for_entity(eid), []).append(eid)

        def one(home: int, ids: list) -> dict:
            def make_call(c: int):
                return lambda: self._stores[c].find_entities_batch(
                    app_id, entity_type, ids, channel_id=channel_id,
                    event_names=event_names, limit_per_entity=limit_per_entity,
                    reversed=reversed)

            return self._hedged_call(self._replica_chain(home), make_call)

        res = self._broadcast([(sx, one, (sx, ids)) for sx, ids in groups.items()])
        out: dict = {}
        for part in res.values():
            out.update(part)
        return out

    def find_edges(self, app_id, entity_type, target_entity_type, event_names,
                   entity_ids=None, target_ids=None, channel_id=None):
        """The fold's history read (the base class gives the contract). By
        entity: one bulk read a home shard (`find_entities_batch`, oldest
        first), failing over to a copy holder and never hedged (a hedge
        may read a shorter history), where the base class makes a `find`
        an id: over daemons, one RPC an entity. By target: the base
        class's reads."""
        if entity_ids is None or target_ids is not None:
            return super().find_edges(app_id, entity_type, target_entity_type, event_names,
                                      entity_ids=entity_ids, target_ids=target_ids,
                                      channel_id=channel_id)
        ids = list(dict.fromkeys(entity_ids))
        groups: dict[int, list[str]] = {}
        for eid in ids:
            groups.setdefault(self._for_entity(eid), []).append(eid)

        def one(home: int, group: list) -> dict:
            last: Optional[ShardDownError] = None
            for sx in self._replica_chain(home):
                try:
                    return self._shard_call(sx, lambda c=self._stores[sx]: c.find_entities_batch(
                        app_id, entity_type, group, channel_id=channel_id,
                        event_names=list(event_names), reversed=False))
                except ShardDownError as e:
                    last = e
            raise last  # type: ignore[misc]

        res = self._broadcast([(sx, one, (sx, group)) for sx, group in groups.items()])
        histories: dict = {}
        for part in res.values():
            histories.update(part)
        return [(e.entity_id, e.target_entity_id, e.event, e.properties)
                for eid in ids for e in histories.get(eid, ())
                if e.target_entity_type == target_entity_type
                and e.target_entity_id is not None]

    def data_signature(self, app_id: int, channel_id: Optional[int] = None) -> str:
        res = self._broadcast([(sx, s.data_signature, (app_id, channel_id))
                               for sx, s in enumerate(self._stores)])
        return "|".join(res[sx] for sx in range(self.n_shards))

    def aggregate_properties(self, app_id: int, entity_type: str,
                             channel_id: Optional[int] = None, **kw: Any) -> dict:
        """Entities are disjoint across shards, so the shards' folds
        union. At R > 1 an entity comes from its home only (a copy may be
        partial), and a down home's entities from its first live copy
        holder: complete then, so no ALLOW_PARTIAL is needed unless the
        whole chain is down."""

        def agg(s: base.EventStore) -> dict:
            return s.aggregate_properties(app_id, entity_type, channel_id=channel_id, **kw)

        if self.replicas <= 1:
            res = self._broadcast([(sx, agg, (s,)) for sx, s in enumerate(self._stores)],
                                  partial_ok=True)
            out: dict = {}
            for sx in sorted(res):
                out.update(res[sx])
            return out
        futs = {sx: self._pool.submit(self._shard_call, sx, agg, s)
                for sx, s in enumerate(self._stores)}
        res, errs = {}, {}
        for sx, f in futs.items():
            try:
                res[sx] = f.result()
            except ShardDownError as e:
                errs[sx] = e
        degraded: list[int] = []
        out = {}
        for sx in range(self.n_shards):
            src = res.get(sx)
            if src is None:  # home down: the first live copy holder
                src = next((res[c] for c in self._replica_chain(sx)[1:] if c in res), None)
            if src is None:  # the whole chain down
                if not self.allow_partial:
                    raise errs[sx]
                degraded.append(sx)
                log.warning("degraded aggregate: %s", errs[sx])
                continue
            out.update({k: v for k, v in src.items() if self._for_entity(k) == sx})
        self.last_degraded_shards = degraded
        return out
