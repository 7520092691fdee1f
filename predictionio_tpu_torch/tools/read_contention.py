"""The online consumer's sqlite reads behind busy interpreter threads.

A row-by-row sqlite fetch releases and retakes the interpreter lock at
every row; behind threads that keep the lock busy (a query server's
handlers and clients in the same process), each retake can wait out a
switch interval. This script times one consumer tick's reads both ways
on a table of ML-100K's shape (100,000 ratings by 943 users of 1,682
items, then 8,000 ratings by 1,143 users of 1,882 items, seeded):

- one-step: `find_since` (512 events), `find_edges` for those events'
  users, `find_edges` for 64 new items; each statement folds its rows
  into one JSON row;
- row by row: the same tail fetched a row at a time,
  `find_entities_batch` for the users (one SELECT an entity) and one
  `find` an item.

Each with no busy thread and with `--busy` threads of pure-Python work
(about 1 ms, then a 0.5 ms sleep, in a loop). A case still running after
`--timeout` seconds is reported as null (the busy threads then stop and
the case is let finish). Run: ``python -m
predictionio_tpu_torch.tools.read_contention [--busy 16] [--timeout 120]``.
Prints one JSON object of seconds.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.sqlite import SqliteEventStore

APP, NAMES = 1, ("rate", "buy")
T0 = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)


def _fill(store: SqliteEventStore, seed: int) -> int:
    rng = np.random.default_rng(seed)
    n = 0
    for n_users, n_items, count in ((943, 1_682, 100_000), (1_143, 1_882, 8_000)):
        users = rng.integers(0, n_users, count)
        items = rng.integers(0, n_items, count)
        ratings = rng.integers(1, 6, count)
        events = [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                        target_entity_type="item", target_entity_id=f"i{i}",
                        properties={"rating": int(r)},
                        event_time=T0 + dt.timedelta(seconds=n + k))
                  for k, (u, i, r) in enumerate(zip(users, items, ratings))]
        for b in range(0, count, 5_000):
            store.insert_batch(events[b:b + 5_000], APP)
        n += count
    return 100_000  # the tick's cursor: the second batch is its tail


def _one_step(store, cursor):
    evs = store.find_since(APP, cursor, limit=512)
    users = list(dict.fromkeys(e.entity_id for e in evs))
    store.find_edges(APP, "user", "item", NAMES, entity_ids=users)
    store.find_edges(APP, "user", "item", NAMES,
                     target_ids=[f"i{1_700 + k}" for k in range(64)])


def _row_by_row(store, cursor):
    name = store._ensure_table(APP)  # noqa: SLF001 — the same table
    with store._client.lock:  # noqa: SLF001
        rows = store._client.conn.execute(  # noqa: SLF001
            f"SELECT {store._COLUMNS} FROM {name} WHERE revision > ? "  # noqa: SLF001
            "ORDER BY revision ASC LIMIT 512", (cursor,)).fetchall()
    evs = [store._to_event(r) for r in rows]  # noqa: SLF001
    users = list(dict.fromkeys(e.entity_id for e in evs))
    store.find_entities_batch(APP, "user", users, event_names=list(NAMES))
    base.EventStore.find_edges(store, APP, "user", "item", NAMES,
                               target_ids=[f"i{1_700 + k}" for k in range(64)])


def _busy(stop: threading.Event) -> None:
    while not stop.is_set():
        s = 0
        for k in range(20_000):
            s += k
        time.sleep(0.0005)


def _timed(fn, busy: int, timeout: float):
    stop = threading.Event()
    workers = [threading.Thread(target=_busy, args=(stop,)) for _ in range(busy)]
    for w in workers:
        w.start()
    out: dict = {}

    def run():
        t0 = time.perf_counter()
        fn()
        out["s"] = time.perf_counter() - t0

    case = threading.Thread(target=run)
    case.start()
    case.join(timeout)
    stop.set()
    for w in workers:
        w.join()
    case.join()
    return out["s"] if out["s"] <= timeout else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--busy", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        store = SqliteEventStore({"PATH": str(Path(tmp) / "events.db")})
        cursor = _fill(store, args.seed)
        result = {"busy_threads": args.busy, "timeout_s": args.timeout}
        for label, fn in (("one_step", _one_step), ("row_by_row", _row_by_row)):
            for busy in (0, args.busy):
                result[f"{label}_busy{busy}_s"] = _timed(
                    lambda fn=fn: fn(store, cursor), busy, args.timeout)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
