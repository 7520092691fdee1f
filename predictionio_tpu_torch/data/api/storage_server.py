"""Storage daemon: the client-server backend's server half.

Counterpart of the JAX package's ``data/api/storage_server.py``, with
its routes, method allow-list, wire format and request-id dedupe, so
that either package's client talks to it. It takes the role of the
reference's storage servers (HBase region servers, a Postgres instance
behind the JDBC DAOs; Storage.scala:140-142): the Event Server, train,
the deploy server and the operator servers share an app's state only
through it. The daemon fronts the port's embedded stores (sqlite and
localfs as a rule) behind JSON-RPC over HTTP:

  GET  /health          → {"status": "alive"}
  POST /rpc             → {"ok", "result"} or {"ok": false, "error"}:
                          one DAO method of the allow-list below, with
                          ``X-PIO-Storage-Key`` checked when the daemon
                          has a key, and shed (``"shed": true``) when
                          the caller's ``X-PIO-Deadline`` has expired
  GET  /metrics, /debug/traces, /debug/tsdb, /debug/profile,
  GET/POST /debug/faults (the routes every port server mounts)

A write carries a ``req_id``: the answer is kept (the last 4,096), and a
retry of an applied request replays it; a retry that arrives while the
first attempt still runs waits for it, so that a request id applies
once. A find with paging arguments answers one page by keyset
(``_paged_find``). A partitioned read (``EventQuery.shard``,
``find_since``'s ``shard``) is filtered by the daemon's store, so only
that partition's events cross the wire. One thread a connection; the
stores serialize their own writes, so writes from every process
serialize once, here.

The ``replication`` DAO is the shipper's RPC surface on a follower
daemon, whose events store is a ``ReplicaEventStore``
(``data/storage/replication.py``); it routes through the events getter.
``main`` with ``PIO_REPL_FOLLOWERS`` set makes this daemon a primary: it
starts a ``SegmentShipper`` to those followers (inserts ack through
them at ``PIO_REPL_MIN_ACKS`` > 0) and stops it on shutdown.
``console storageserver`` starts no shipper. Standard library only: the
daemon loads no torch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import threading
from collections import OrderedDict
from typing import Any, Optional

from predictionio_tpu_torch.data.storage import wire
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.obs import server_registry
from predictionio_tpu_torch.resilience import deadline as _deadline
from predictionio_tpu_torch.utils.http import HttpError, JsonHandler, ThreadedServer

log = logging.getLogger(__name__)

DEDUPE_KEPT = 4096  # answers kept for request-id replays

# DAO name → (Storage getter, allowed methods); any other method is refused:
# the RPC surface is the DAO contract, not arbitrary attributes
_DAO_TABLE: dict[str, tuple[str, frozenset[str]]] = {
    "events": ("get_events", frozenset({
        "init_app", "remove_app", "insert", "insert_batch", "delete", "delete_batch",
        "get", "find", "find_entities_batch", "data_signature", "find_since",
        "latest_revision"})),
    "apps": ("get_meta_data_apps", frozenset({
        "insert", "get", "get_by_name", "get_all", "update", "delete"})),
    "access_keys": ("get_meta_data_access_keys", frozenset({
        "insert", "get", "get_all", "get_by_app_id", "update", "delete"})),
    "channels": ("get_meta_data_channels", frozenset({
        "insert", "get", "get_by_app_id", "delete"})),
    "engine_instances": ("get_meta_data_engine_instances", frozenset({
        "insert", "get", "get_all", "get_latest_completed", "get_completed", "update",
        "delete"})),
    "evaluation_instances": ("get_meta_data_evaluation_instances", frozenset({
        "insert", "get", "get_all", "get_completed", "update", "delete"})),
    "engine_manifests": ("get_meta_data_engine_manifests", frozenset({
        "insert", "get", "get_all", "update", "delete"})),
    "models": ("get_model_data_models", frozenset({"insert", "get", "delete"})),
    # the shipper's RPCs on a follower: routed through the events getter
    # (the replica is the events store)
    "replication": ("get_events", frozenset({
        "replication_status", "replication_lag", "wait_for_revision",
        "replication_apply_wal", "replication_apply_tombstones",
        "replication_segment_manifest", "replication_segment_file",
        "replication_commit_segment", "promote"})),
}


class _Handler(JsonHandler):
    # JsonHandler: HTTP/1.1 keep-alive, Nagle off, and the middleware that
    # times each RPC into http_request_seconds{server="storage",path="/rpc"}
    # and records its server span under the caller's X-Parent-Span
    server_version = "pio-storage/1.0"

    def _reply(self, code: int, payload: dict) -> None:
        self._respond(code, json.dumps(payload, separators=(",", ":")))

    def do_GET(self):
        self._drain_body()
        path = self.path.split("?")[0]
        if path == "/health":
            self._reply(200, {"status": "alive"})
        elif path == "/metrics":
            self._serve_metrics()
        elif path == "/debug/traces":
            self._serve_debug_traces()
        elif path == "/debug/tsdb":
            self._serve_debug_tsdb()
        elif path == "/debug/profile":
            self._serve_debug_profile()
        elif path == "/debug/faults":
            self._serve_debug_faults()
        else:
            self._reply(404, {"ok": False, "error": "not found"})

    def do_POST(self):
        self._drain_body()
        if self.path.split("?")[0] == "/debug/faults":
            try:
                self._serve_debug_faults_set()
            except HttpError as e:
                self._respond(e.status, {"message": e.message})
            return
        if self.path != "/rpc":
            self._reply(404, {"ok": False, "error": "not found"})
            return
        # the caller's remaining budget came in as X-PIO-Deadline: a call
        # whose caller gave up must not hold the store; "shed" lets the
        # client raise DeadlineExceeded rather than a storage error
        if _deadline.expired():
            self._reply(200, {"ok": False, "shed": True,
                              "error": "deadline expired; rpc shed"})
            return
        auth_key = self.server.auth_key
        if auth_key and self.headers.get("X-PIO-Storage-Key") != auth_key:
            self._reply(401, {"ok": False, "error": "bad storage key"})
            return
        try:
            req = json.loads(self._raw_body)
            dao_name, method = req["dao"], req["method"]
            req_id = req.get("req_id")
            args = [wire.decode(a) for a in req.get("args", [])]
            kwargs = {k: wire.decode(v) for k, v in req.get("kwargs", {}).items()}
        except Exception as e:  # a malformed request
            self._reply(400, {"ok": False, "error": f"bad request: {e}"})
            return
        entry = _DAO_TABLE.get(dao_name)
        if entry is None or method not in entry[1]:
            self._reply(400, {"ok": False, "error": f"unknown rpc {dao_name}.{method}"})
            return
        self.server.metrics.counter(
            "storage_rpc_total", "storage RPCs by DAO and method",
            ("dao", "method"),  # label-bound: checked against the DAO table above
        ).inc(dao=dao_name, method=method)
        inflight_done = None
        if req_id is not None:
            cached, inflight_done = self._dedupe_enter(req_id)
            if cached is not None:
                self._reply(200, cached)
                return
        try:
            dao = getattr(self.server.storage, entry[0])()
            if dao_name == "events" and method == "find":
                result: Any = self._paged_find(dao, args, kwargs)
            else:
                result = getattr(dao, method)(*args, **kwargs)
            encoded = ({"$list": [wire.encode(v) for v in result]}
                       if isinstance(result, list) else wire.encode(result))
            payload = {"ok": True, "result": encoded}
        except Exception as e:
            log.exception("storage rpc %s.%s failed", dao_name, method)
            payload = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if req_id is not None:
            self._dedupe_leave(req_id, payload, inflight_done)
        self._reply(200, payload)

    def _dedupe_enter(self, req_id: str):
        """(the recorded answer, None) for an applied request id; else
        (None, the event its waiters wait on) once this request runs it.
        A retry that arrives while the first attempt still runs waits
        for it (two minutes at most, then runs unguarded)."""
        srv = self.server
        while True:
            with srv.dedupe_lock:
                cached = srv.dedupe_cache.get(req_id)
                if cached is not None:
                    return cached, None
                waiter = srv.dedupe_inflight.get(req_id)
                if waiter is None:
                    done = srv.dedupe_inflight[req_id] = threading.Event()
                    return None, done
            if not waiter.wait(timeout=120):
                return None, None

    def _dedupe_leave(self, req_id: str, payload: dict,
                      done: Optional[threading.Event]) -> None:
        srv = self.server
        with srv.dedupe_lock:
            srv.dedupe_cache[req_id] = payload
            while len(srv.dedupe_cache) > DEDUPE_KEPT:
                srv.dedupe_cache.popitem(last=False)
            if done is not None:
                srv.dedupe_inflight.pop(req_id, None)
        if done is not None:
            done.set()

    def _paged_find(self, dao: Any, args: list, kwargs: dict) -> Any:
        """A find cut to the daemon's page, continued by keyset: the
        client sends the last (eventTime, event_id) it saw (`_after`),
        pushed down as ``EventQuery.start_after`` (an indexed range clause
        on sqlite), so that a page is O(page) however deep the scan and
        exact under concurrent writes. One event past the page (the +1
        sentinel) says whether another follows. A call with no paging
        arguments gets the whole list."""
        query = args[0]
        if "_page" not in kwargs and "_after" not in kwargs:
            return list(dao.find(query))
        max_page = self.server.find_page_size
        page = min(int(kwargs.pop("_page", 0)) or max_page, max_page)
        after = kwargs.pop("_after", None)
        q2 = query
        if after is not None:
            q2 = dataclasses.replace(q2, start_after=(after["t"], after["id"]))
        eff_limit = page + 1
        if after is None and query.limit is not None and query.limit >= 0:
            # a limited query's first page; the client shrinks `_page` to
            # what remains of the limit for the later ones
            eff_limit = min(eff_limit, query.limit)
        items = list(dao.find(dataclasses.replace(q2, limit=eff_limit)))
        return {"events": items[:page], "more": len(items) > page}


class StorageServer:
    """The daemon, embeddable: `serve_forever()` blocks, `start()` serves
    on a thread of its own; port 0 binds a free port."""

    def __init__(
        self,
        storage: Optional[Storage] = None,
        host: str = "127.0.0.1",
        port: int = 7077,
        auth_key: Optional[str] = None,
        find_page_size: int = 10_000,
    ):
        self.storage = storage or Storage()
        if host not in ("127.0.0.1", "localhost", "::1") and not auth_key:
            log.warning("storage server binding %s WITHOUT --auth-key: all app data "
                        "is readable and writable by any network peer", host)
        self.httpd = ThreadedServer((host, port), _Handler)
        self.httpd.storage = self.storage
        self.httpd.metrics = server_registry()
        self.httpd.metrics_label = "storage"
        self.httpd.auth_key = auth_key
        self.httpd.find_page_size = find_page_size
        self.httpd.dedupe_lock = threading.Lock()
        self.httpd.dedupe_cache = OrderedDict()
        self.httpd.dedupe_inflight = {}
        self._thread: Optional[threading.Thread] = None
        self._monitor_token: Optional[int] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def _attach_monitor(self) -> None:
        # the daemon owns its lifecycle (no ServerProcess), so it attaches
        # its registry to the process monitor itself
        if self._monitor_token is None:
            from predictionio_tpu_torch.obs.monitor import get_monitor

            self._monitor_token = get_monitor().attach("storage", self.httpd.metrics)

    def start(self) -> "StorageServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="pio-storage", daemon=True)
        self._thread.start()
        self._attach_monitor()
        return self

    def serve_forever(self) -> None:
        self._attach_monitor()
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        if self._monitor_token is not None:
            from predictionio_tpu_torch.obs.monitor import get_monitor

            get_monitor().detach(self._monitor_token)
            self._monitor_token = None
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="pio storage-server",
        description="Shared storage service for multi-process deployments")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7077)
    ap.add_argument("--auth-key", default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = StorageServer(host=args.host, port=args.port, auth_key=args.auth_key)
    # a primary: with PIO_REPL_FOLLOWERS set, this daemon ships its event
    # store to the follower daemons (and acks inserts through them at
    # PIO_REPL_MIN_ACKS > 0)
    from predictionio_tpu_torch.data.storage.replication import (
        ReplicationConfig,
        SegmentShipper,
    )
    from predictionio_tpu_torch.utils.env import repl_knob

    shipper = None
    repl_cfg = ReplicationConfig.from_env(auth_key=args.auth_key)
    if repl_cfg.followers:
        shipper = SegmentShipper(server.storage.get_events(), repl_cfg,
                                 epoch=repl_knob("PIO_REPL_EPOCH"))
        shipper.start()
        log.info("replication shipper started: %d follower(s), min_acks=%d",
                 len(repl_cfg.followers), repl_cfg.min_acks)
    log.info("storage server listening on %s:%d", args.host, server.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        if shipper is not None:
            shipper.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
