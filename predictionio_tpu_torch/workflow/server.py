"""Deploy query server: ``POST /queries.json`` answered by one engine's
algorithm and model, with concurrent queries coalesced into one
``batch_predict`` per drain.

Counterpart of the JAX package's ``workflow/server.py``, cut to the main
route: no continuous batching, tenancy, rollout, online learning,
deadlines or feedback.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
import typing
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Optional

from predictionio_tpu_torch.engines.recommendation.engine import Query
from predictionio_tpu_torch.ops import recommend as _recommend
from predictionio_tpu_torch.utils.http import (
    HttpError,
    JsonHandler,
    ServerProcess,
    ThreadedServer,
)

log = logging.getLogger(__name__)


@dataclass
class QueryServerConfig:
    ip: str = "0.0.0.0"
    port: int = 8000
    # micro-batching: coalesce concurrent queries into one device call.
    # The window adapts between batch_window_ms and max_window_ms: it
    # doubles when a drain fills max_batch (queue pressure) and halves
    # back when traffic is light, so a lone query waits ~2 ms while a
    # burst batches deeply
    micro_batch: bool = True
    batch_window_ms: float = 2.0
    max_window_ms: float = 60.0
    max_batch: int = 64


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()  # numpy scalar → python
        except (TypeError, ValueError):
            pass
    return obj


def _matches(val: Any, ann: Any) -> bool:
    origin = typing.get_origin(ann)
    if origin is typing.Union:
        return any(_matches(val, a) for a in typing.get_args(ann))
    if ann is type(None):
        return val is None
    if origin is list:
        (arg,) = typing.get_args(ann) or (Any,)
        return isinstance(val, list) and all(_matches(v, arg) for v in val)
    if ann is int:
        return isinstance(val, int) and not isinstance(val, bool)
    if ann is float:
        return isinstance(val, (int, float)) and not isinstance(val, bool)
    if ann is Any:
        return True
    return isinstance(val, ann)


def extract_query(cls: type, obj: Any) -> Any:
    """Build a query dataclass from a JSON object, strictly: unknown keys,
    missing required keys and mistyped values raise HttpError(400)."""
    if not isinstance(obj, dict):
        raise HttpError(400, "query must be a JSON object")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(obj) - set(fields)
    if unknown:
        raise HttpError(
            400, f"unknown query fields: {sorted(unknown)} (valid: {sorted(fields)})"
        )
    missing = [
        n for n, f in fields.items()
        if n not in obj
        and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    ]
    if missing:
        raise HttpError(400, f"missing query fields: {missing}")
    hints = typing.get_type_hints(cls)
    for key, val in obj.items():
        if not _matches(val, hints[key]):
            raise HttpError(
                400, f"query field {key!r} got {type(val).__name__} ({val!r})"
            )
    return cls(**obj)


class _Pending:
    __slots__ = ("query", "fut")

    def __init__(self, query, fut):
        self.query = query
        self.fut = fut


class _BatchDispatcher:
    """Coalesces concurrent queries into one `batch_predict` call.

    Handler threads submit a query and block on a Future; one named
    daemon thread takes the first queued query, gathers arrivals for up
    to the current window (or until `max_batch`), and runs the batch.
    A batch that fails is retried query by query, so each waiter gets
    its own result or its own error."""

    def __init__(
        self, owner: "QueryServer", window_ms: float, max_batch: int,
        max_window_ms: float,
    ):
        self.owner = owner
        self.min_window_s = window_ms / 1000.0
        self.max_window_s = max(max_window_ms, window_ms) / 1000.0
        self.window_s = self.min_window_s
        self.max_batch = max(1, int(max_batch))
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="query-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, query: Any, timeout: float = 30.0) -> Any:
        fut: Future = Future()
        self._queue.put(_Pending(query, fut))
        return fut.result(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # fail any waiters still queued so their handlers return now
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if not p.fut.done():
                p.fut.set_exception(RuntimeError("query server stopped"))

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            if len(batch) >= self.max_batch:
                self.window_s = min(self.max_window_s, self.window_s * 2)
            else:
                self.window_s = max(self.min_window_s, self.window_s / 2)
            self._run(batch)

    def _run(self, batch: list) -> None:
        owner = self.owner
        t0 = time.perf_counter()
        try:
            preds = dict(owner.algorithm.batch_predict(
                None, owner.model, [(i, p.query) for i, p in enumerate(batch)]
            ))
        except Exception:  # noqa: BLE001 — retried per query below
            log.exception("batch predict failed; retrying query by query")
            for p in batch:
                t0 = time.perf_counter()
                try:
                    result = owner.algorithm.predict(owner.model, p.query)
                    owner.count_batch(time.perf_counter() - t0)
                    p.fut.set_result(result)
                except Exception as e:  # noqa: BLE001 — the waiter's error
                    p.fut.set_exception(e)
            return
        owner.count_batch(time.perf_counter() - t0)
        for i, p in enumerate(batch):
            p.fut.set_result(preds[i])


class _Handler(JsonHandler):
    server: "_Server"  # type: ignore[assignment]

    def _path(self) -> str:
        return self.path.split("?")[0].rstrip("/") or "/"

    def do_GET(self):
        self._drain_body()
        if self._path() == "/":
            self._respond(200, self.server.owner.status())
        else:
            self._respond(404, {"message": f"no route {self._path()}"})

    def do_POST(self):
        raw = self._drain_body()
        if self._path() != "/queries.json":
            self._respond(404, {"message": f"no route {self._path()}"})
            return
        owner = self.server.owner
        try:
            try:
                obj = json.loads(raw.decode() or "null")
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise HttpError(400, f"invalid query JSON: {e}")
            query = extract_query(Query, obj)
            try:
                prediction = owner.predict(query)
            except ValueError as e:
                # query-level contract violations (e.g. a category
                # filter without category data)
                raise HttpError(400, str(e))
            self._respond(200, _to_jsonable(prediction))
        except HttpError as e:
            self._respond(e.status, {"message": e.message})
        except Exception as e:  # noqa: BLE001 — the server keeps serving
            log.exception("query failed")
            self._respond(500, {"message": str(e)})


class _Server(ThreadedServer):
    owner: "QueryServer"


class QueryServer(ServerProcess):
    """Deploy-server process: serves one algorithm over one model.
    `start()` warms the algorithm up (staging the model on its device)
    before it accepts queries."""

    _name = "query-server"

    def __init__(
        self,
        algorithm: Any,
        model: Any,
        config: Optional[QueryServerConfig] = None,
    ):
        super().__init__()
        self.algorithm = algorithm
        self.model = model
        self.config = config or QueryServerConfig()
        self._count_lock = threading.Lock()
        self._requests = 0  # guarded-by: _count_lock
        self._batches = 0  # guarded-by: _count_lock
        self._batch_s = 0.0  # guarded-by: _count_lock
        self.dispatcher: Optional[_BatchDispatcher] = None

    def start(self) -> int:
        warmup = getattr(self.algorithm, "warmup", None)
        if callable(warmup):
            warmup(self.model)
        if self.config.micro_batch:
            self.dispatcher = _BatchDispatcher(
                self, self.config.batch_window_ms, self.config.max_batch,
                self.config.max_window_ms,
            )
        return super().start()

    def stop(self) -> None:
        super().stop()
        if self.dispatcher is not None:
            self.dispatcher.stop()
            self.dispatcher = None

    def _make_server(self) -> _Server:
        server = _Server((self.config.ip, self.config.port), _Handler)
        server.owner = self
        return server

    def predict(self, query: Any) -> Any:
        with self._count_lock:
            self._requests += 1
        if self.dispatcher is not None:
            return self.dispatcher.submit(query)
        t0 = time.perf_counter()
        result = self.algorithm.predict(self.model, query)
        self.count_batch(time.perf_counter() - t0)
        return result

    def count_batch(self, seconds: float) -> None:
        """Book one device batch and the host seconds its predict took
        (staging, the kernel, the copy back, building results)."""
        with self._count_lock:
            self._batches += 1
            self._batch_s += seconds

    def status(self) -> dict:
        with self._count_lock:
            requests, batches, batch_s = (
                self._requests, self._batches, self._batch_s
            )
        return {
            "status": "alive",
            "requests": requests,
            "batches": batches,
            "batch_predict_seconds": batch_s,
            "kernel_launches": _recommend.LAUNCHES,
            "device": str(getattr(self.model, "device", None)),
        }
