"""Deploy query server: ``POST /queries.json`` answered by an engine's
algorithms and models through its Serving stage (supplement, each
algorithm's prediction, serve), with concurrent queries coalesced into
one ``batch_predict`` per algorithm per drain. The query class is the
one the first algorithm's ``predict`` takes, so the same server serves
the ALS and the Universal Recommender templates.

A server is built from an ``EngineRuntime`` (``build_runtime`` rehydrates
a trained engine instance from storage, as ``console deploy
--engine-json`` does) or from one algorithm and its model, served
through ``FirstServing``.

When the first algorithm has a query serializer
(``BaseAlgorithm.query_serializer``), a query is the raw parsed JSON,
which need not be an object, handed to its ``query_from_json`` (a
ValueError there is a 400), and the answer goes out through its
``result_to_json``; without one, a query is a JSON object extracted
strictly into the query dataclass.

A server over storage swaps its runtime in place: ``reload()`` (``GET``
or ``POST /reload``) builds the variant's newest COMPLETED instance and
swaps it in under the swap lock, and an online consumer
(``attach_online``; ``GET /online/status``, ``POST
/online/pause|resume``) swaps in each fold under the same lock. Queries
carry the runtime they were read against, and the dispatcher serves
each group of a drain with its own, so a query that spans a swap is
answered by one runtime.

Counterpart of the JAX package's ``workflow/server.py``, cut to these
routes: no continuous batching, tenancy, rollout, replicas, deadlines
or feedback.
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

from predictionio_tpu_torch.controller.dase import FirstServing
from predictionio_tpu_torch.core.base import RuntimeContext
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops import recommend as _recommend
from predictionio_tpu_torch.utils.http import (
    HttpError,
    JsonHandler,
    ServerProcess,
    ThreadedServer,
)
from predictionio_tpu_torch.workflow.core import prepare_deploy_models

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


@dataclass
class EngineRuntime:
    """Everything needed to answer queries (the JAX package's
    ``EngineRuntime``)."""

    instance: Optional[EngineInstance]
    engine: Any
    engine_params: Any
    algorithms: list[Any]
    models: list[Any]
    serving: Any
    query_class: type
    # the first algorithm's query serializer, or None
    query_serializer: Any = None


def _serializer(algorithm: Any) -> Any:
    make = getattr(algorithm, "query_serializer", None)
    return make() if callable(make) else None


def build_runtime(storage, instance: EngineInstance, device=None) -> EngineRuntime:
    """Rehydrate a COMPLETED instance into a servable runtime on `device`
    (the first CUDA device when None): models loaded from its MODELDATA
    blob and bound to the device, each algorithm given the serving
    context (the event store, for live history reads), then warmed up
    (reference CreateServer.scala:206). A failed warmup raises."""
    dev = str(resolve_device(device))
    engine, engine_params, models = prepare_deploy_models(
        storage, instance, device=dev
    )
    algorithms = engine.make_algorithms(engine_params)
    serving = engine.make_serving(engine_params)
    ctx = RuntimeContext(storage=storage, mode="serve", device=dev)
    for algo in algorithms:
        algo.set_serving_context(ctx)
    _warmup(algorithms, models)
    return EngineRuntime(
        instance=instance, engine=engine, engine_params=engine_params,
        algorithms=algorithms, models=models, serving=serving,
        query_class=query_class(algorithms[0]),
        query_serializer=_serializer(algorithms[0]),
    )


def latest_completed_runtime(
    storage, engine_id: str, engine_version: str, variant_id: str, device=None
) -> EngineRuntime:
    """The runtime of the variant's newest COMPLETED train."""
    instance = storage.get_meta_data_engine_instances().get_latest_completed(
        engine_id, engine_version, variant_id
    )
    if instance is None:
        raise RuntimeError(
            f"no COMPLETED engine instance for {engine_id}/{engine_version}/"
            f"{variant_id}: run train first"
        )
    return build_runtime(storage, instance, device=device)


def _warmup(algorithms, models) -> None:
    for algo, model in zip(algorithms, models):
        warmup = getattr(algo, "warmup", None)
        if callable(warmup):
            warmup(model)


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


def query_class(algorithm: Any) -> type:
    """The query dataclass an algorithm serves: the `query` annotation
    of its `predict` (the JAX package's ``BaseAlgorithm.query_class``)."""
    ann = typing.get_type_hints(algorithm.predict).get("query")
    if not (isinstance(ann, type) and dataclasses.is_dataclass(ann)):
        raise TypeError(
            f"{type(algorithm).__name__}.predict must annotate `query` "
            f"with a dataclass, got {ann!r}"
        )
    return ann


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
    __slots__ = ("query", "runtime", "fut")

    def __init__(self, query, runtime, fut):
        self.query = query
        self.runtime = runtime  # the runtime the query was read against
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

    def submit(self, query: Any, runtime: "EngineRuntime",
               timeout: float = 30.0) -> Any:
        fut: Future = Future()
        self._queue.put(_Pending(query, runtime, fut))
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
            # group by runtime: queries that span a swap are served by the
            # runtime they were read against
            groups: dict[int, tuple[Any, list]] = {}
            for p in batch:
                groups.setdefault(id(p.runtime), (p.runtime, []))[1].append(p)
            for runtime, group in groups.values():
                self._run(runtime, group)

    def _run(self, runtime: "EngineRuntime", batch: list) -> None:
        owner = self.owner
        t0 = time.perf_counter()
        try:
            preds = owner.predict_batch([p.query for p in batch], runtime)
        except Exception:  # noqa: BLE001 — retried per query below
            log.exception("batch predict failed; retrying query by query")
            for p in batch:
                t0 = time.perf_counter()
                try:
                    result = owner.predict_batch([p.query], runtime)[0]
                    owner.count_batch(time.perf_counter() - t0)
                    p.fut.set_result(result)
                except Exception as e:  # noqa: BLE001 — the waiter's error
                    p.fut.set_exception(e)
            return
        owner.count_batch(time.perf_counter() - t0)
        for p, result in zip(batch, preds):
            p.fut.set_result(result)


class _Handler(JsonHandler):
    server: "_Server"  # type: ignore[assignment]

    def _path(self) -> str:
        return self.path.split("?")[0].rstrip("/") or "/"

    def do_GET(self):
        self._drain_body()
        path, owner = self._path(), self.server.owner
        if path == "/":
            self._respond(200, owner.status())
        elif path == "/online/status":
            self._respond(200, owner.online_status())
        elif path == "/reload":
            self._reload()
        else:
            self._respond(404, {"message": f"no route {path}"})

    def _reload(self) -> None:
        try:
            self.server.owner.reload()
        except Exception as e:  # noqa: BLE001 — the old runtime serves on
            log.exception("reload failed")
            self._respond(500, {"message": str(e)})
        else:
            self._respond(200, {"message": "Reload successful"})

    def _online(self, path: str) -> None:
        owner = self.server.owner
        if owner.online is None:
            self._respond(404, {"message": "no online consumer attached"})
        elif path == "/online/pause":
            try:
                body = self._json_body()
            except HttpError as e:
                self._respond(e.status, {"message": e.message})
                return
            reason = (body.get("reason") if isinstance(body, dict) else None
                      ) or "operator pause"
            owner.online.pause(reason)
            self._respond(200, owner.online_status())
        else:
            owner.online.resume()
            self._respond(200, owner.online_status())

    def do_POST(self):
        raw = self._drain_body()
        path = self._path()
        if path == "/reload":
            self._reload()
            return
        if path in ("/online/pause", "/online/resume"):
            self._online(path)
            return
        if path != "/queries.json":
            self._respond(404, {"message": f"no route {path}"})
            return
        owner = self.server.owner
        try:
            try:
                obj = json.loads(raw.decode() or "null")
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise HttpError(400, f"invalid query JSON: {e}")
            # one runtime reads, answers and renders the query, even if a
            # swap lands while it is in flight
            rt = owner.runtime
            custom_from = getattr(rt.query_serializer, "query_from_json", None)
            if custom_from is None:
                query = extract_query(rt.query_class, obj)
            else:
                try:
                    query = custom_from(obj)
                except ValueError as e:
                    raise HttpError(400, f"query serializer rejected: {e}")
            try:
                prediction = owner.predict(query, rt)
            except ValueError as e:
                # query-level contract violations (e.g. a category
                # filter without category data)
                raise HttpError(400, str(e))
            custom_to = getattr(rt.query_serializer, "result_to_json", None)
            self._respond(200, custom_to(prediction) if custom_to is not None
                          else _to_jsonable(prediction))
        except HttpError as e:
            self._respond(e.status, {"message": e.message})
        except Exception as e:  # noqa: BLE001 — the server keeps serving
            log.exception("query failed")
            self._respond(500, {"message": str(e)})


class _Server(ThreadedServer):
    owner: "QueryServer"


class QueryServer(ServerProcess):
    """Deploy-server process: serves an EngineRuntime, or one algorithm
    over one model (through FirstServing). `start()` warms each algorithm
    up (staging its model on its device) before it accepts queries,
    unless the runtime came warmed from `build_runtime`. `reload` and
    `attach_online` need the `storage` the runtime came from."""

    _name = "query-server"

    def __init__(
        self,
        algorithm: Any = None,
        model: Any = None,
        config: Optional[QueryServerConfig] = None,
        runtime: Optional[EngineRuntime] = None,
        storage: Any = None,
    ):
        super().__init__()
        if (runtime is None) == (algorithm is None):
            raise TypeError("QueryServer takes a runtime or an algorithm and its model")
        self._warm = runtime is not None
        if runtime is None:
            runtime = EngineRuntime(
                instance=None, engine=None, engine_params=None,
                algorithms=[algorithm], models=[model], serving=FirstServing(),
                query_class=query_class(algorithm),
                query_serializer=_serializer(algorithm),
            )
        self.runtime = runtime
        self.storage = storage
        self.query_class = runtime.query_class
        self.config = config or QueryServerConfig()
        # serializes the writers of `runtime` (reload, the online
        # consumer's publish); queries read it without the lock
        self._swap_lock = threading.RLock()
        self.online = None  # Optional[OnlineConsumer]
        self._count_lock = threading.Lock()
        self._requests = 0  # guarded-by: _count_lock
        self._batches = 0  # guarded-by: _count_lock
        self._batch_s = 0.0  # guarded-by: _count_lock
        self._launch_base = self._select_base = 0
        self.dispatcher: Optional[_BatchDispatcher] = None

    @property
    def algorithm(self) -> Any:
        return self.runtime.algorithms[0]

    @property
    def model(self) -> Any:
        return self.runtime.models[0]

    def start(self) -> int:
        if not self._warm:
            _warmup(self.runtime.algorithms, self.runtime.models)
            self._warm = True
        self._launch_base, self._select_base = _launches(), _select_launches()
        if self.config.micro_batch:
            self.dispatcher = _BatchDispatcher(
                self, self.config.batch_window_ms, self.config.max_batch,
                self.config.max_window_ms,
            )
        return super().start()

    def stop(self) -> None:
        if self.online is not None:
            self.online.stop()  # the consumer thread joins with the server
        super().stop()
        if self.dispatcher is not None:
            self.dispatcher.stop()
            self.dispatcher = None

    def _make_server(self) -> _Server:
        server = _Server((self.config.ip, self.config.port), _Handler)
        server.owner = self
        return server

    def predict_batch(self, queries: list, rt: EngineRuntime) -> list:
        """The answers of runtime `rt` to `queries`: supplemented by the
        Serving stage, one `batch_predict` per algorithm with the
        algorithm's serving context (the deploy's storage, for live store
        reads, and its device), combined by `serve`."""
        supplemented = [rt.serving.supplement(q) for q in queries]
        indexed = list(enumerate(supplemented))
        per_algo = [
            dict(algo.batch_predict(algo.serving_context, model, indexed))
            for algo, model in zip(rt.algorithms, rt.models)
        ]
        return [
            rt.serving.serve(q, [preds[i] for preds in per_algo])
            for i, q in indexed
        ]

    def predict(self, query: Any, runtime: Optional[EngineRuntime] = None) -> Any:
        """The answer to `query` of `runtime` (the current runtime when
        None: one snapshot per query)."""
        with self._count_lock:
            self._requests += 1
        if runtime is None:
            runtime = self.runtime
        if self.dispatcher is not None:
            return self.dispatcher.submit(query, runtime)
        t0 = time.perf_counter()
        result = self.predict_batch([query], runtime)[0]
        self.count_batch(time.perf_counter() - t0)
        return result

    def count_batch(self, seconds: float) -> None:
        """Book one device batch and the host seconds its predict took
        (staging, the kernel, the copy back, building results)."""
        with self._count_lock:
            self._batches += 1
            self._batch_s += seconds

    def reload(self) -> None:
        """Swap in the variant's newest COMPLETED instance, built on the
        current model's device; queries in flight keep the runtime they
        were read against. Serialized under the swap lock."""
        with self._swap_lock:
            inst = self.runtime.instance
            if self.storage is None or inst is None:
                raise RuntimeError("reload needs a server built over "
                                   "storage from an engine instance")
            self.runtime = latest_completed_runtime(
                self.storage, inst.engine_id, inst.engine_version,
                inst.engine_variant,
                device=getattr(self.model, "device", None),
            )

    def attach_online(self, app_id: int, config=None, consumer=None):
        """Attach and start a fold-in consumer: the events of `app_id`'s
        default channel tail into this server's runtime between
        retrains. A `consumer` passed
        in replaces the default wiring."""
        from predictionio_tpu_torch.online import (
            OnlineConsumer,
            ServerApplyHost,
        )

        if self.online is not None:
            self.online.stop()
            if not self.online.stopped():
                # a wedged tick: a replacement would be a second writer
                # of the same cursor record
                raise RuntimeError("the previous online consumer did not "
                                   "stop; refusing a second writer")
        if consumer is None:
            if self.storage is None:
                raise RuntimeError("attach_online needs a server built "
                                   "over storage")
            consumer = OnlineConsumer(self.storage, ServerApplyHost(self),
                                      app_id, config=config)
        self.online = consumer
        self.online.start()
        return self.online

    def online_status(self) -> dict:
        if self.online is None:
            return {"state": "detached"}
        return dict(self.online.status(), state="attached")

    def status(self) -> dict:
        """Counts since the server started serving (warmup excluded):
        `kernel_launches` is the top-k kernels' launches in this process,
        `select_launches` those of them on the select route."""
        with self._count_lock:
            requests, batches, batch_s = (
                self._requests, self._batches, self._batch_s
            )
        instance = self.runtime.instance
        return {
            "status": "alive",
            "engine_instance": instance.id if instance is not None else None,
            "requests": requests,
            "batches": batches,
            "batch_predict_seconds": batch_s,
            "kernel_launches": _launches() - self._launch_base,
            "select_launches": _select_launches() - self._select_base,
            "device": str(getattr(self.model, "device", None)),
        }


def _launches() -> int:
    return _recommend.LAUNCHES + _recommend.MASKED_LAUNCHES


def _select_launches() -> int:
    return (_recommend.ROUTE_LAUNCHES["select"]
            + _recommend.MASKED_ROUTE_LAUNCHES["select"])
