"""Deploy query server: ``POST /queries.json`` answered by an engine's
algorithms and models through its Serving stage (supplement, each
algorithm's prediction, serve), with concurrent queries coalesced into
one ``batch_predict`` per algorithm per device batch. The query class
is the one the first algorithm's ``predict`` takes, so the same server
serves the ALS and the Universal Recommender templates.

A server is built from an ``EngineRuntime`` (``build_runtime`` rehydrates
a trained engine instance from storage, as ``console deploy
--engine-json`` does) or from one algorithm and its model, served
through ``FirstServing``.

When the first algorithm has a query serializer
(``BaseAlgorithm.query_serializer``), a query is the raw parsed JSON,
which need not be an object, handed to its ``query_from_json`` (a
ValueError there is a 400), and the answer goes out through its
``result_to_json``; without one, a query is a JSON object extracted
strictly into the query dataclass. Output blockers (``plugins`` of
``plugin_type`` ``outputblocker``) rewrite each answer before it goes
out; output sniffers observe it, and their failures never reach the
client.

Batching (``_BatchDispatcher``): a handler submits its query and waits
on a future; the ``query-batcher`` thread assembles device batches and
hands each to a pool of ``pipeline_depth`` workers (``query-batch_N``),
so that batch N+1 is assembled, and launched, while batch N finishes.
``batching="continuous"`` keeps admitting arrivals into the assembling
batch until a batch in flight retires; ``"windowed"`` lingers up to a
window instead. A query whose deadline passes is shed at drain time and
again just before the device call, so no device time goes to an answer
nobody waits for. A batch that fails is retried query by query, and a
serve failure stays with its query.

Deadlines and shedding: ``X-PIO-Deadline`` (the caller's remaining ms)
is the request's ambient deadline. An expired one is shed before parsing
(503, ``Retry-After: 1``, ``queries_shed_total{reason="deadline"}``);
one that passes while queued is a 503 too (``expired_in_queue`` or
``cancelled``). The ``dispatch.device`` fault point fires before each
batch's device call, scoped by rollout variant, and, scoped specs only,
in the per-query retry.

A server over storage swaps its runtime in place: ``reload()`` (``GET``
or ``POST /reload``) builds the variant's newest COMPLETED instance and
swaps it in under the swap lock, and an online consumer
(``attach_online``; ``GET /online/status``, ``POST
/online/pause|resume``) swaps in each fold under the same lock. Queries
carry the runtime they were read against, and the dispatcher serves
each group of a batch with its own, so a query that spans a swap is
answered by one runtime.

Canary rollout (``deploy/rollout.py``): ``POST /rollout/start`` builds a
registered version's runtime as the candidate and routes a sticky
hash-of-body fraction of queries to it (or, in shadow mode, mirrors
that fraction off the response path and scores agreement); ``GET
/rollout/status`` and ``POST /rollout/abort`` read and end it. A server
restarted mid-canary re-adopts it. Each query after routing books its
serve time and error to its variant (``variant_serve_seconds``,
``variant_requests_total``, ``variant_errors_total``). With
``feedback``, each answer is posted to the Event Server as a
``predict`` event of entity type ``pio_pr``.

Observability (the JAX package's): the server binds a registry
(``server_registry``: the CUDA and device-profile gauges) to ``GET
/metrics`` with ``serve_seconds``, ``predict_seconds``, ``batch_size``,
``batch_device_seconds`` and ``batch_queue_wait_seconds`` (fed by the
dispatcher's queue-wait spans through the span recorder's bridge, set
on start and removed on stop); ``GET /debug/traces`` and ``GET
/debug/profile`` read the process's span recorder and device profiler,
``GET /debug/tsdb`` and ``GET /alerts`` the process monitor's history
and alert states (the server's registry is sampled while it serves);
``POST /debug/traces/capture`` keeps the next N batches' traces (409
without a dispatcher) and ``POST /debug/profile/capture`` opens a
``torch.profiler`` window on the dispatcher's thread, which runs the
batches itself while the window is open; ``GET|POST /debug/faults`` read
and set the fault specs. Each query's trace holds its
``server.request`` span and, from the dispatcher, ``batch.queue_wait``,
``batch.assemble`` and the ``batch.device_dispatch`` span of the batch
that carried it.

Counterpart of the JAX package's ``workflow/server.py``, cut to these
routes: no tenancy (its fair queue, ``admission_cap`` and
``tenant_drain``), replicas or log shipping.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
import typing
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Optional

from predictionio_tpu_torch.controller.dase import FirstServing
from predictionio_tpu_torch.core.base import RuntimeContext
from predictionio_tpu_torch.data.storage.base import EngineInstance, StorageError
from predictionio_tpu_torch.deploy.registry import ModelRegistry
from predictionio_tpu_torch.deploy.rollout import (
    RolloutConfig,
    RolloutController,
    resume_rollout,
    sticky_candidate,
)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.obs import BATCH_SIZE_BUCKETS, server_registry
from predictionio_tpu_torch.obs import spans as _spans
from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.ops import recommend as _recommend
from predictionio_tpu_torch.resilience import deadline as _deadline
from predictionio_tpu_torch.resilience import faults as _faults
from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded
from predictionio_tpu_torch.utils.http import (
    HttpError,
    JsonHandler,
    ServerProcess,
    ThreadedServer,
)
from predictionio_tpu_torch.workflow.core import prepare_deploy_models

log = logging.getLogger(__name__)

OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


@dataclass
class QueryServerConfig:
    ip: str = "0.0.0.0"
    port: int = 8000
    # the feedback loop: each answer posted to the Event Server as a
    # `predict` event (reference CreateServer.scala:534-596)
    feedback: bool = False
    event_server_url: Optional[str] = None  # e.g. http://127.0.0.1:7070
    access_key: Optional[str] = None
    # output blockers and sniffers, by their plugin_type
    plugins: list = field(default_factory=list)
    # micro-batching: coalesce concurrent queries into one device call
    micro_batch: bool = True
    batch_window_ms: float = 2.0
    max_window_ms: float = 60.0
    max_batch: int = 64
    # device batches in flight: the dispatcher hands each batch to a pool
    # of this many workers and goes on assembling the next
    pipeline_depth: int = 4
    # "continuous": arrivals join the assembling batch until a batch in
    # flight retires; "windowed": it lingers up to max_window_ms
    batching: str = "continuous"
    # remote log shipping (reference CreateServer.scala:441-452 --log-url):
    # server log records POST to this collector as JSON lines, best-effort
    log_url: Optional[str] = None


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
    (reference CreateServer.scala:206). A failed warmup raises. The
    ``model.load`` fault point fires first: a failed load leaves the
    runtime serving before it in place."""
    _faults.fire("model.load")
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


def runtime_device(rt: EngineRuntime) -> Optional[str]:
    """The device a runtime serves on: its first model's, else its first
    algorithm's serving context's; None when neither names one. A
    runtime built beside it (a reload, a canary) goes to the same one."""
    dev = getattr(rt.models[0], "device", None) if rt.models else None
    if dev is None and rt.algorithms:
        ctx = getattr(rt.algorithms[0], "serving_context", None)
        dev = getattr(ctx, "device", None)
    return None if dev is None else str(dev)


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


def read_query(rt: EngineRuntime, obj: Any) -> Any:
    """The query of runtime `rt` from parsed JSON: through its query
    serializer where it has one, else strictly into its query class."""
    custom_from = getattr(rt.query_serializer, "query_from_json", None)
    if custom_from is None:
        return extract_query(rt.query_class, obj)
    try:
        return custom_from(obj)
    except ValueError as e:
        raise HttpError(400, f"query serializer rejected: {e}")


def render_result(rt: EngineRuntime, prediction: Any) -> Any:
    """An answer of runtime `rt` as JSON: through its serializer's
    ``result_to_json`` where it has one."""
    custom_to = getattr(rt.query_serializer, "result_to_json", None)
    return custom_to(prediction) if custom_to is not None else _to_jsonable(prediction)


def _device_stage(rt: EngineRuntime, queries: list) -> tuple[list, list]:
    """Supplement `queries` by the Serving stage and run one
    `batch_predict` per algorithm with the algorithm's serving context:
    (the supplemented queries, each algorithm's {index: prediction})."""
    supplemented = [rt.serving.supplement(q) for q in queries]
    indexed = list(enumerate(supplemented))
    per_algo = [
        dict(algo.batch_predict(algo.serving_context, model, indexed))
        for algo, model in zip(rt.algorithms, rt.models)
    ]
    return supplemented, per_algo


def _serve(rt: EngineRuntime, supplemented: list, per_algo: list, i: int) -> Any:
    return rt.serving.serve(supplemented[i], [preds[i] for preds in per_algo])


class _Pending:
    """One queued query. `deadline` is an absolute ``time.monotonic()``
    bound (None: unbounded); `cancelled` is set by the submitting handler
    once it stopped waiting, so the dispatcher skips the entry instead of
    spending a device call on an answer nobody reads."""

    __slots__ = ("query", "runtime", "fut", "t_submit", "tctx", "deadline",
                 "cancelled")

    def __init__(self, query, runtime, fut, t_submit, tctx, deadline=None):
        self.query = query
        self.runtime = runtime  # the runtime the query was read against
        self.fut = fut
        self.t_submit = t_submit
        self.tctx = tctx  # (trace id, span id) of the submitting request
        self.deadline = deadline
        self.cancelled = False


class _Call:
    """A function the dispatcher's thread runs with no batch in flight.
    `serial` True puts the dispatcher in serial mode once `fn` ran (the
    groups run on the dispatcher's thread, not the pool's), False ends
    it, None leaves it."""

    __slots__ = ("fn", "fut", "serial")

    def __init__(self, fn, fut, serial=None):
        self.fn = fn
        self.fut = fut
        self.serial = serial

    def run(self, dispatcher: "_BatchDispatcher") -> None:
        if not self.fut.set_running_or_notify_cancel():
            return  # the caller gave up waiting
        try:
            result = self.fn()
        except Exception as e:  # noqa: BLE001 — the caller's error
            if self.serial is False:
                dispatcher._serial = False
            self.fut.set_exception(e)
            return
        if self.serial is not None:
            dispatcher._serial = self.serial
        self.fut.set_result(result)


class _BatchDispatcher:
    """Coalesces concurrent queries into device batches.

    Handler threads submit a query and block on a Future. The
    ``query-batcher`` thread takes the first queued query, gathers
    arrivals into the assembling batch, sheds the entries that are dead
    already, groups the rest by runtime and hands each group to a
    ``pipeline_depth``-wide worker pool; a bounded semaphore holds the
    groups in flight to the depth, so queue pressure backs up into the
    assembly, not into device memory. With the pipeline idle, a batch
    goes once arrivals pause; with batches in flight, ``continuous`` mode
    keeps admitting arrivals until one retires (its slot is then free),
    and ``windowed`` mode lingers up to max(max_window, 1.2 x the last
    batch's time). A group that fails is retried query by query, so each
    waiter gets its own answer or its own error.

    All groups launch on the current CUDA stream of their worker, the
    default one: the kernels' wrappers read it, and a tensor crossing
    workers needs no stream bookkeeping. A ``torch.profiler`` window
    (`capture_runner`) runs the groups on this thread while it is open:
    CUPTI keeps the kernels of the thread that opens and closes it."""

    def __init__(
        self, owner: "QueryServer", window_ms: float, max_batch: int,
        max_window_ms: Optional[float] = None, pipeline_depth: int = 4,
        batching: str = "continuous",
    ):
        if batching not in ("continuous", "windowed"):
            raise ValueError(
                f"batching must be continuous|windowed, got {batching!r}")
        self.owner = owner
        self.min_window_s = window_ms / 1000.0
        self.max_window_s = max(max_window_ms or window_ms, window_ms) / 1000.0
        self.max_batch = max(1, int(max_batch))
        self.batching = batching
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.last_batch_sec = 0.0
        self._last_dispatch = 0.0
        self._retired = 0  # groups retired: continuous mode's signal
        # set and read on the dispatcher's thread (a timed-out call that
        # ends serial mode clears it from the caller's)
        self._serial = False
        self._pool = ThreadPoolExecutor(
            max_workers=self.pipeline_depth, thread_name_prefix="query-batch")
        self._inflight = threading.BoundedSemaphore(self.pipeline_depth)
        self._active_cond = threading.Condition()
        self._active = 0  # guarded-by: _active_cond
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="query-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, query: Any, runtime: "EngineRuntime",
               timeout: float = 30.0, deadline: Optional[float] = None) -> Any:
        """Queue `query` against the runtime it was read against and wait
        for its answer. The wait ends at `timeout` or at `deadline` (an
        absolute ``time.monotonic()``), whichever is first: the entry is
        then marked cancelled, so the dispatcher skips it, and
        DeadlineExceeded is raised (a 503 at the handler)."""
        fut: Future = Future()
        tctx = (_tracing.current_trace_id(), _spans.current_span_id())
        p = _Pending(query, runtime, fut, time.perf_counter(), tctx, deadline)
        self._queue.put(p)
        wait = timeout
        if deadline is not None:
            wait = min(wait, max(0.0, deadline - time.monotonic()))
        try:
            return fut.result(timeout=wait)
        except TimeoutError:
            p.cancelled = True
            raise DeadlineExceeded(
                "query abandoned: deadline passed while queued for dispatch")

    def call(self, fn, timeout: Optional[float] = 30.0,
             serial: Optional[bool] = None) -> Any:
        """Run `fn` on the dispatcher's thread once the batch in hand is
        dispatched and every group in flight has retired; return its
        result or raise its error. TimeoutError where the thread did not
        take it within `timeout` (it then never runs); None waits.
        `serial` as `_Call` takes it."""
        fut: Future = Future()
        self._queue.put(_Call(fn, fut, serial))
        try:
            return fut.result(timeout=timeout)
        except TimeoutError:
            if fut.cancel():
                if serial is False:
                    self._serial = False
                raise
            return fut.result()  # already running: its own result

    def capture_runner(self):
        """A `run_on` for ``devprof.capture_trace``: its first call (the
        window's start) runs on this thread and puts the dispatcher in
        serial mode, its second (the stop) runs here and ends it, so the
        window holds the kernels of every batch it spans."""
        modes = iter((True, False))
        return lambda fn: self.call(fn, serial=next(modes, False))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        with self._active_cond:
            idle = self._active_cond.wait_for(lambda: self._active == 0,
                                              timeout=5.0)
        self._pool.shutdown(wait=idle)
        # fail the waiters still queued so their handlers return now
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if not p.fut.done():
                p.fut.set_exception(RuntimeError("query server stopped"))

    # -- the drain loop ------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if isinstance(first, _Call):
                self._run_call(first)
                continue
            batch, calls = [first], []

            def take(item) -> None:
                (calls if isinstance(item, _Call) else batch).append(item)

            retired_mark = self._retired
            now = time.monotonic()
            hard_deadline = now + max(self.max_window_s, self.last_batch_sec * 1.2)
            # continuous mode's backstop for a wedged batch in flight: before
            # the first batch retires there is no batch time yet, so an
            # unmeasured flight gets several windows
            wedge_deadline = now + max(10.0 * self.max_window_s,
                                       self.last_batch_sec * 1.2)
            while len(batch) < self.max_batch:
                try:
                    take(self._queue.get_nowait())
                    continue
                except queue.Empty:
                    pass
                with self._active_cond:
                    active = self._active
                if active == 0:
                    # the pipeline is idle: dispatch once arrivals pause.
                    # Under recent load the pause scales with the batch
                    # time (a closed-loop burst of responses spreads over
                    # it); after a quiet second it drops to the window
                    patience = self.min_window_s
                    if time.monotonic() - self._last_dispatch < 1.0:
                        patience = max(patience, min(0.1 * self.last_batch_sec, 0.02))
                    try:
                        take(self._queue.get(timeout=patience))
                        continue
                    except queue.Empty:
                        break
                if self.batching == "continuous":
                    if self._retired != retired_mark:
                        break  # a group retired: dispatch onto its slot
                    if time.monotonic() >= wedge_deadline:
                        break
                    try:
                        take(self._queue.get(timeout=0.002))
                    except queue.Empty:
                        pass
                    continue
                remaining = hard_deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    take(self._queue.get(timeout=min(remaining, 0.002)))
                except queue.Empty:
                    pass
            # entries whose waiter gave up, or whose deadline passed while
            # queued, go here: before the semaphore and the device
            ready = self._shed_dead(batch)
            # group by runtime: queries that span a swap are served by the
            # runtime they were read against
            groups: dict[int, tuple[Any, list]] = {}
            for p in ready:
                groups.setdefault(id(p.runtime), (p.runtime, []))[1].append(p)
            for rt, group in groups.values():
                self._dispatch(rt, group)
            for call in calls:
                self._run_call(call)

    def _dispatch(self, rt: "EngineRuntime", group: list) -> None:
        """Take a pipeline slot (polling, so that stop() is seen) and run
        the group on the pool, or on this thread in serial mode."""
        acquired = False
        while not self._stop.is_set():
            if self._inflight.acquire(timeout=0.2):
                acquired = True
                break
        if acquired:
            with self._active_cond:
                self._active += 1
            self._last_dispatch = time.monotonic()
            if self._serial:
                self._run_group_released(rt, group)
                return
            try:
                self._pool.submit(self._run_group_released, rt, group)
                return
            except RuntimeError:  # the pool shut down
                self._retire()
        for p in group:
            if not p.fut.done():
                p.fut.set_exception(RuntimeError("query server stopped"))

    def _run_call(self, call: _Call) -> None:
        with self._active_cond:
            while self._active and not self._stop.is_set():
                if call.fut.cancelled():
                    return
                self._active_cond.wait(0.2)
        call.run(self)

    def _retire(self) -> None:
        with self._active_cond:
            self._active -= 1
            self._retired += 1
            self._active_cond.notify_all()
        self._inflight.release()

    def _run_group_released(self, rt: "EngineRuntime", group: list) -> None:
        try:
            self._run_group(rt, group)
        except Exception as e:  # noqa: BLE001 — every waiter gets an answer
            log.exception("device group failed")
            for p in group:
                if not p.fut.done():
                    p.fut.set_exception(e)
        finally:
            self._retire()

    def _shed_dead(self, entries: list) -> list:
        """Drop cancelled and deadline-expired entries, failing their
        futures with DeadlineExceeded (a 503 + Retry-After at the handler)
        and counting the shed. Returns the live entries."""
        now = time.monotonic()
        live = []
        shed = getattr(self.owner, "count_shed", None)
        for p in entries:
            if p.cancelled or (p.deadline is not None and now >= p.deadline):
                if not p.fut.done():
                    p.fut.set_exception(DeadlineExceeded(
                        "deadline expired before device dispatch"))
                if shed is not None:
                    shed("cancelled" if p.cancelled else "expired_in_queue")
                continue
            live.append(p)
        return live

    def _run_group(self, runtime: "EngineRuntime", batch: list) -> None:
        # the last-chance shed: entries expire or are given up while the
        # group waits for its slot
        batch = self._shed_dead(batch)
        if not batch:
            return
        owner = self.owner
        recorder = _spans.get_default_recorder()
        t0 = time.perf_counter()
        now_wall = time.time()
        # an armed POST /debug/traces/capture spends one batch credit here
        # and keeps every trace riding this batch
        capture_id = recorder.consume_capture()
        if capture_id is not None:
            for p in batch:
                if p.tctx[0]:
                    recorder.force_keep(p.tctx[0], capture_id)
        first_submit = min(p.t_submit for p in batch)
        # the per-query device span ids exist before the call, so that the
        # batch's work runs under the first traced query's device span
        dev_ids = [_spans.new_span_id() if p.tctx[0] else None for p in batch]

        def child(i: int, name: str, start: float, dur: float,
                  span_id: Optional[str] = None, error: bool = False) -> None:
            tid, parent = batch[i].tctx
            if tid is not None:
                recorder.record(_spans.Span(
                    trace_id=tid, span_id=span_id or _spans.new_span_id(),
                    parent_span_id=parent, name=name, start=start, duration=dur,
                    attrs={"server": "query", "batch_size": len(batch)}, error=error))

        for i, p in enumerate(batch):
            # queue wait: submit to the device call; assemble: the batch's
            # first arrival to the call
            child(i, "batch.queue_wait", now_wall - (t0 - p.t_submit), t0 - p.t_submit)
            child(i, "batch.assemble", now_wall - (t0 - first_submit), t0 - first_submit)
        owner.batch_size_hist.observe(len(batch))
        # the group's variant scopes the fault point: a spec on
        # dispatch.device@candidate fails a canary's batches only
        variant_of = getattr(owner, "variant_of", None)
        variant = variant_of(runtime) if variant_of is not None else "live"
        rep = next((i for i, d in enumerate(dev_ids) if d), None)
        tok_t = tok_s = None
        if rep is not None:
            tok_t = _tracing.set_trace_id(batch[rep].tctx[0])
            tok_s = _spans.set_current_span(dev_ids[rep])
        try:
            try:
                _faults.fire("dispatch.device", scope=variant)
                supplemented, per_algo = _device_stage(runtime, [p.query for p in batch])
            except Exception as e:  # noqa: BLE001 — retried per query below
                if isinstance(e, _faults.FaultInjected):  # a chaos run's: no trace
                    log.warning("batch predict failed (%s); retrying query by query", e)
                else:
                    log.exception("batch predict failed; retrying query by query")
                for i in range(len(batch)):
                    child(i, "batch.device_dispatch", now_wall,
                          time.perf_counter() - t0, span_id=dev_ids[i], error=True)
                for p in batch:
                    if p.cancelled:  # its waiter is gone: no retry
                        continue
                    t1 = time.perf_counter()
                    try:
                        # scoped specs only: a scope-less spec fails the
                        # batch and lets this retry through; a variant's
                        # fails its queries, the canary verdict's input
                        _faults.fire("dispatch.device", scope=variant, scoped_only=True)
                        one, algo_one = _device_stage(runtime, [p.query])
                        result = _serve(runtime, one, algo_one, 0)
                        owner.count_batch(time.perf_counter() - t1, 1)
                        p.fut.set_result(result)
                    except Exception as e:  # noqa: BLE001 — the waiter's error
                        if not p.fut.done():
                            p.fut.set_exception(e)
                return
            # a serve failure is its query's alone
            results: list = []
            for i in range(len(batch)):
                try:
                    results.append((True, _serve(runtime, supplemented, per_algo, i)))
                except Exception as e:  # noqa: BLE001 — the waiter's error
                    results.append((False, e))
        finally:
            if tok_s is not None:
                _spans.reset_current_span(tok_s)
            if tok_t is not None:
                _tracing.reset_trace_id(tok_t)
        seconds = time.perf_counter() - t0
        self.last_batch_sec = seconds
        for i in range(len(batch)):
            child(i, "batch.device_dispatch", now_wall, seconds, span_id=dev_ids[i])
        owner.count_batch(seconds, len(batch))
        for p, (ok, value) in zip(batch, results):
            if ok:
                p.fut.set_result(value)
            else:
                p.fut.set_exception(value)


class RolloutConflict(RuntimeError):
    """A rollout operation conflicts with the server's state (one already
    active, or none to abort): a 409 at the HTTP edge."""


class _Handler(JsonHandler):
    server: "_Server"  # type: ignore[assignment]

    def _path(self) -> str:
        return self.path.split("?")[0].rstrip("/") or "/"

    def do_GET(self):
        self._drain_body()
        path, owner = self._path(), self.server.owner
        if path == "/":
            self._respond(200, owner.status())
        elif path == "/rollout/status":
            self._respond(200, owner.rollout_status())
        elif path == "/online/status":
            self._respond(200, owner.online_status())
        elif path == "/reload":
            self._reload()
        elif path == "/metrics":
            self._serve_metrics()
        elif path == "/alerts":
            self._serve_alerts()
        elif path == "/debug/traces":
            self._serve_debug_traces()
        elif path == "/debug/tsdb":
            self._serve_debug_tsdb()
        elif path == "/debug/profile":
            self._serve_debug_profile()
        elif path == "/debug/faults":
            self._serve_debug_faults()
        else:
            self._respond(404, {"message": f"no route {path}"})

    def _device_thread(self):
        """The dispatcher's capture runner, so that a profiler capture
        opens and closes its window on the thread that then launches the
        batches' kernels; None without micro-batching."""
        d = self.server.owner.dispatcher
        return d.capture_runner() if d is not None else None

    def _debug_post(self, path: str) -> None:
        try:
            if path == "/debug/profile/capture":
                self._serve_profile_capture()
            elif path == "/debug/faults":
                self._serve_debug_faults_set()
            elif self.server.owner.dispatcher is None:
                self._respond(409, {"message": "micro-batching is disabled: no "
                                               "dispatcher to capture batches from"})
            else:
                self._serve_traces_capture()
        except HttpError as e:
            self._respond(e.status, {"message": e.message})
        except Exception as e:  # noqa: BLE001 — the server keeps serving
            log.exception("%s failed", path)
            self._respond(500, {"message": str(e)})

    def _reload(self) -> None:
        try:
            self.server.owner.reload()
        except RolloutConflict as e:
            self._respond(409, {"message": str(e)})
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

    def _rollout(self, path: str) -> None:
        owner = self.server.owner
        try:
            body = self._json_body()
            if not isinstance(body, dict):
                body = {}
            if path == "/rollout/start":
                self._respond(200, owner.start_rollout(body))
            else:
                self._respond(200, owner.abort_rollout(
                    body.get("reason") or "operator abort"))
        except HttpError as e:
            self._respond(e.status, {"message": e.message})
        except ValueError as e:
            self._respond(400, {"message": str(e)})
        except RolloutConflict as e:
            self._respond(409, {"message": str(e)})
        except Exception as e:  # noqa: BLE001 — the server keeps serving
            log.exception("rollout request failed")
            self._respond(500, {"message": str(e)})

    def do_POST(self):
        self._drain_body()
        path = self._path()
        if path == "/queries.json":
            self._queries()
        elif path == "/reload":
            self._reload()
        elif path in ("/online/pause", "/online/resume"):
            self._online(path)
        elif path in ("/rollout/start", "/rollout/abort"):
            self._rollout(path)
        elif path in ("/debug/traces/capture", "/debug/profile/capture",
                      "/debug/faults"):
            self._debug_post(path)
        else:
            self._respond(404, {"message": f"no route {path}"})

    def _queries(self) -> None:
        """The serving path (reference CreateServer.scala:490-613)."""
        owner = self.server.owner
        t0 = time.perf_counter()
        # a gateway's routing hash (X-PIO-Route-Hash) decides the canary
        # as it does on every replica; without one, the body's crc32
        bucket: Optional[int] = None
        rh = self.headers.get("X-PIO-Route-Hash")
        if rh:
            try:
                bucket = int(rh) % 10_000
            except ValueError:
                bucket = None
        # the client stopped waiting: refuse before parsing, batching or
        # device time
        if _deadline.expired():
            owner.count_shed("deadline")
            self._respond(503, {"message": "deadline expired; request shed"},
                          headers={"Retry-After": "1"})
            return
        variant: Optional[str] = None  # set once routing lands
        booked = False
        try:
            try:
                obj = json.loads(self._raw_body.decode() or "null")
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise HttpError(400, f"invalid query JSON: {e}")
            # one runtime reads, answers and renders the query, even if a
            # swap lands while it is in flight
            rt, variant = owner.pick_runtime(self._raw_body, bucket=bucket)
            query = read_query(rt, obj)
            try:
                prediction = owner.predict(query, rt, deadline=_deadline.current())
            except ValueError as e:
                # query-level contract violations (e.g. a category
                # filter without category data)
                raise HttpError(400, str(e))
            result = render_result(rt, prediction)
            # shadow agreement compares the answer before the output
            # blockers, which may stamp per-request data into it
            shadow_reference = result
            for plugin in owner.output_blockers:
                result = plugin.process(obj, result, {})
            seconds = time.perf_counter() - t0
            owner.serve_hist.observe(seconds)
            owner.bookkeep_variant(variant, seconds, error=False)
            booked = True
            owner.maybe_shadow(self._raw_body, obj, shadow_reference, bucket=bucket)
            owner.feedback_async(obj, result)
            for plugin in owner.output_sniffers:
                try:
                    plugin.process(obj, result, {})
                except Exception:  # noqa: BLE001 — never the client's
                    log.exception("output sniffer failed")
            self._respond(200, result)
        except HttpError as e:
            # a post-routing 4xx feeds its variant's window: a candidate
            # that refuses what live serves must show as an error delta.
            # A failure before routing reached no variant and books none
            if variant is not None:
                owner.bookkeep_variant(variant, time.perf_counter() - t0, error=True)
            self._respond(e.status, {"message": e.message})
        except DeadlineExceeded as e:
            # expired in the queue: "retry later", and the shed counts
            # against its variant (the dispatcher counted the shed)
            if variant is not None:
                owner.bookkeep_variant(variant, time.perf_counter() - t0, error=True)
            self._respond(503, {"message": str(e)}, headers={"Retry-After": "1"})
        except Exception as e:  # noqa: BLE001 — the server keeps serving
            if isinstance(e, _faults.FaultInjected):
                log.warning("query failed: %s", e)
            else:
                log.exception("query failed")
            # a failure after the success was booked (writing the 200)
            # must not book the request twice
            if variant is not None and not booked:
                owner.bookkeep_variant(variant, time.perf_counter() - t0, error=True)
            self._respond(500, {"message": str(e)})



class _Server(ThreadedServer):
    owner: "QueryServer"


class QueryServer(ServerProcess):
    """Deploy-server process: serves an EngineRuntime, or one algorithm
    over one model (through FirstServing). `start()` warms each algorithm
    up (staging its model on its device) before it accepts queries,
    unless the runtime came warmed from `build_runtime`, and re-adopts a
    canary persisted before a restart. `reload`, `attach_online` and the
    rollout need the `storage` the runtime came from."""

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
        self.output_blockers = [p for p in self.config.plugins
                                if getattr(p, "plugin_type", "") == OUTPUT_BLOCKER]
        self.output_sniffers = [p for p in self.config.plugins
                                if getattr(p, "plugin_type", "") == OUTPUT_SNIFFER]
        # serializes the writers of `runtime` and `candidate` (reload, the
        # rollout's attach, promote and detach, the online consumer's
        # publish); queries read them without the lock
        self._swap_lock = threading.RLock()
        self.candidate: Optional[EngineRuntime] = None  # guarded-by: _swap_lock
        self.rollout = None  # Optional[RolloutController]; guarded-by: _swap_lock
        self.online = None  # Optional[OnlineConsumer]
        self._count_lock = threading.Lock()
        self._requests = 0  # guarded-by: _count_lock
        self._batches = 0  # guarded-by: _count_lock
        self._batch_s = 0.0  # guarded-by: _count_lock
        self._launch_base = self._select_base = 0
        # feedback POST threads in flight: stop() joins them
        self._feedback_lock = threading.Lock()
        self._feedback_threads: set[threading.Thread] = set()  # guarded-by: _feedback_lock
        self.dispatcher: Optional[_BatchDispatcher] = None
        self.metrics = server_registry()
        self.serve_hist = self.metrics.histogram(
            "serve_seconds", "end-to-end query serve time (parse to response JSON built)")
        self.predict_hist = self.metrics.histogram(
            "predict_seconds", "device-side predict time per query (model compute + fetch)")
        self.batch_size_hist = self.metrics.histogram(
            "batch_size", "queries per coalesced device batch",
            buckets=BATCH_SIZE_BUCKETS, lower_bound=1)
        self.batch_device_hist = self.metrics.histogram(
            "batch_device_seconds", "device time per coalesced batch (dispatch to fetch)")
        queue_wait = self.metrics.histogram(
            "batch_queue_wait_seconds", "micro-batch queue wait, submit to device dispatch")
        # the dispatcher's queue-wait span is the one source of this
        # histogram: one bridge a span name on the process recorder, the
        # newest server's winning
        self._queue_wait_bridge = lambda sp, _h=queue_wait: _h.observe(sp.duration)
        self._shed_counter = self.metrics.counter(
            "queries_shed_total",
            "queries shed before device dispatch (503 + Retry-After)",
            ("reason",),  # label-bound: literal shed-reason set
        )
        self._variant_serve_hist = self.metrics.histogram(
            "variant_serve_seconds", "end-to-end serve time by rollout variant",
            ("variant",),  # label-bound: literal live|candidate
        )
        self._variant_requests = self.metrics.counter(
            "variant_requests_total", "queries served by rollout variant",
            ("variant",),  # label-bound: literal live|candidate
        )
        self._variant_errors = self.metrics.counter(
            "variant_errors_total",
            "failed queries (4xx/5xx/shed) by rollout variant",
            ("variant",),  # label-bound: literal live|candidate
        )

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
        _spans.get_default_recorder().bridge("batch.queue_wait", self._queue_wait_bridge)
        if self.config.micro_batch:
            self.dispatcher = _BatchDispatcher(
                self, self.config.batch_window_ms, self.config.max_batch,
                self.config.max_window_ms, self.config.pipeline_depth,
                self.config.batching,
            )
        port = super().start()
        # a restart mid-canary re-adopts the persisted bake
        if self.storage is not None and self.runtime.instance is not None:
            try:
                resume_rollout(self)
            except Exception:  # noqa: BLE001 — live serving goes on
                log.exception("rollout re-adoption failed; serving continues")
        return port

    def stop(self) -> None:
        if self.online is not None:
            self.online.stop()  # the consumer thread joins with the server
        if self.rollout is not None:
            self.rollout.stop()
        super().stop()
        if self.dispatcher is not None:
            self.dispatcher.stop()
            self.dispatcher = None
        _spans.get_default_recorder().unbridge("batch.queue_wait", self._queue_wait_bridge)
        with self._feedback_lock:
            pending = list(self._feedback_threads)
        for t in pending:
            t.join(timeout=11)  # the POST's timeout is 10 s

    def _make_server(self) -> _Server:
        server = _Server((self.config.ip, self.config.port), _Handler)
        server.owner = self
        server.metrics = self.metrics
        server.metrics_label = "query"
        return server

    def predict_batch(self, queries: list, rt: EngineRuntime) -> list:
        """The answers of runtime `rt` to `queries`: supplemented by the
        Serving stage, one `batch_predict` per algorithm with the
        algorithm's serving context (the deploy's storage, for live store
        reads, and its device), combined by `serve`."""
        supplemented, per_algo = _device_stage(rt, queries)
        return [_serve(rt, supplemented, per_algo, i) for i in range(len(queries))]

    def predict(self, query: Any, runtime: Optional[EngineRuntime] = None,
                deadline: Optional[float] = None) -> Any:
        """The answer to `query` of `runtime` (the current runtime when
        None: one snapshot per query), through the dispatcher, which sheds
        it once `deadline` (absolute ``time.monotonic()``) passes."""
        with self._count_lock:
            self._requests += 1
        if runtime is None:
            runtime = self.runtime
        if self.dispatcher is not None:
            return self.dispatcher.submit(query, runtime, deadline=deadline)
        return self._predict_inline(query, runtime)

    def _predict_inline(self, query: Any, runtime: EngineRuntime) -> Any:
        t0 = time.perf_counter()
        result = self.predict_batch([query], runtime)[0]
        self.count_batch(time.perf_counter() - t0, 1)
        return result

    def count_batch(self, seconds: float, size: int) -> None:
        """Book one device batch of `size` queries and the host seconds
        its predict took (staging, the kernel, the copy back, building
        results): the status counts and the batch histograms."""
        with self._count_lock:
            self._batches += 1
            self._batch_s += seconds
        self.batch_device_hist.observe(seconds)
        self.predict_hist.observe(seconds / max(1, size))

    def count_shed(self, reason: str) -> None:
        self._shed_counter.inc(reason=reason)

    def reload(self) -> None:
        """Swap in the variant's newest COMPLETED instance, built on the
        current model's device; queries in flight keep the runtime they
        were read against. Serialized under the swap lock, and refused
        while a canary is active (it would change the verdict's baseline
        and be overwritten by the promote)."""
        with self._swap_lock:
            rollout = self.rollout
            if rollout is not None and rollout.st.state in ("starting", "canary"):
                raise RolloutConflict(f"rollout of {rollout.st.version.id} is "
                                      "active; abort it before reloading")
            inst = self.runtime.instance
            if self.storage is None or inst is None:
                raise RuntimeError("reload needs a server built over "
                                   "storage from an engine instance")
            self.runtime = latest_completed_runtime(
                self.storage, inst.engine_id, inst.engine_version,
                inst.engine_variant, device=runtime_device(self.runtime),
            )

    # -- canary rollout ------------------------------------------------------
    def pick_runtime(self, raw_request: bytes,
                     bucket: Optional[int] = None) -> tuple[EngineRuntime, str]:
        """Route one request: a sticky hash-of-body fraction goes to the
        candidate while a rollout that is not shadow is active. The
        references are read once, so a swap cannot split a request."""
        candidate, rollout = self.candidate, self.rollout
        if (candidate is not None and rollout is not None
                and not rollout.config.shadow
                and sticky_candidate(raw_request, rollout.config.fraction,
                                     bucket=bucket)):
            return candidate, "candidate"
        return self.runtime, "live"

    def variant_of(self, rt: EngineRuntime) -> str:
        return "candidate" if rt is self.candidate else "live"

    def bookkeep_variant(self, variant: str, seconds: float, error: bool) -> None:
        self._variant_serve_hist.observe(seconds, variant=variant)
        self._variant_requests.inc(variant=variant)
        if error:
            self._variant_errors.inc(variant=variant)
        rollout = self.rollout
        if rollout is not None:
            rollout.record(variant, seconds, error)

    def maybe_shadow(self, raw: bytes, query_json: Any, result: Any,
                     bucket: Optional[int] = None) -> None:
        """Shadow mode: mirror a fraction of live traffic to the candidate
        off the response path and score agreement. The mirror runs the
        candidate's own serving path (its query extraction and
        supplement), so a candidate is judged on its own behaviour.
        Bounded concurrency; a mirror's failure counts as a candidate
        error."""
        candidate, rollout = self.candidate, self.rollout
        if (candidate is None or rollout is None or not rollout.config.shadow
                or not sticky_candidate(raw, rollout.config.fraction, bucket=bucket)
                or not rollout.try_shadow()):
            return

        def mirror():
            t0 = time.perf_counter()
            try:
                query = read_query(candidate, query_json)
                dispatcher = self.dispatcher
                prediction = (dispatcher.submit(query, candidate)
                              if dispatcher is not None
                              else self._predict_inline(query, candidate))
                shadow_result = render_result(candidate, prediction)
                rollout.record("candidate", time.perf_counter() - t0, error=False)
                rollout.record_agreement(shadow_result == result)
            except Exception:  # noqa: BLE001 — a candidate error
                rollout.record("candidate", time.perf_counter() - t0, error=True)
                rollout.record_agreement(False)
            finally:
                rollout.shadow_done()

        rollout.run_shadow(mirror)

    def attach_rollout(self, controller, candidate: EngineRuntime) -> None:
        """Called by RolloutController.start() once the candidate built."""
        with self._swap_lock:
            if self.rollout is not None and self.rollout.st.state in (
                    "starting", "canary"):
                raise RolloutConflict(
                    f"rollout of {self.rollout.st.version.id} is already active")
            self.candidate = candidate
            self.rollout = controller

    def complete_rollout(self, controller, promote: bool) -> None:
        """The end of a canary: promote swaps candidate → live (the old
        runtime drains: queries in flight keep their snapshot), rollback
        detaches the candidate."""
        with self._swap_lock:
            if self.rollout is not controller:
                return  # a stale controller: a newer rollout replaced it
            if promote and self.candidate is not None:
                self.runtime = self.candidate
            self.candidate = None

    def start_rollout(self, body: dict) -> dict:
        """POST /rollout/start: canary a registered model version (the
        variant's newest ``trained`` one when the body names none). A
        candidate that cannot be built (a ``model.load`` fault, a missing
        blob, an engine of another package) is a ValueError ("canary
        start failed", a 400) and leaves live serving as it was."""
        if self.storage is None or self.runtime.instance is None:
            raise RolloutConflict("a rollout needs a server built over storage "
                                  "from an engine instance")
        registry = ModelRegistry(self.storage)
        vid = body.get("version")
        if vid:
            version = registry.get(vid)
            if version is None:
                raise ValueError(f"no model version {vid!r}")
        else:
            inst = self.runtime.instance
            trained = registry.list(inst.engine_id, inst.engine_variant,
                                    status="trained")
            if not trained:
                raise ValueError(
                    f"no trained model version for {inst.engine_id}/"
                    f"{inst.engine_variant}: train (or `console jobs submit`) first")
            version = trained[0]
        overrides = {k: body[k] for k in (
            "fraction", "window_s", "interval_s", "min_requests",
            "max_error_delta", "max_p99_ratio", "bake_s", "shadow",
            "min_agreement") if k in body}
        config = RolloutConfig.from_env(**overrides)
        controller = RolloutController(self, version, config)
        try:
            controller.start()
        except (RolloutConflict, StorageError):
            # a conflict is a 409; a storage outage is the server's
            # trouble (500), not a malformed request
            raise
        except Exception as e:  # noqa: BLE001 — the canary never started
            raise ValueError(f"canary start failed: {e}")
        return controller.status()

    def abort_rollout(self, reason: str) -> dict:
        rollout = self.rollout
        if rollout is None or rollout.st.state != "canary":
            raise RolloutConflict("no active rollout to abort")
        # stop the verdict thread first, then look again: it may have
        # promoted or rolled back meanwhile, and an abort must not mark a
        # now-live version rolled_back
        rollout.stop()
        if rollout.st.state != "canary":
            raise RolloutConflict(
                f"rollout already {rollout.st.state}; nothing to abort")
        rollout.abort(reason)
        return rollout.status()

    def rollout_status(self) -> dict:
        rollout = self.rollout
        if rollout is None:
            return {"state": "none"}
        return rollout.status()

    # -- the feedback loop (reference CreateServer.scala:534-596) -----------
    def feedback_async(self, query_json: Any, result: Any) -> None:
        """Post the answer to the Event Server as a ``predict`` event of
        entity type ``pio_pr`` (the answer's ``pr_id``, else the engine
        instance's id), off the response path."""
        if not self.config.feedback:
            return
        if not (self.config.event_server_url and self.config.access_key):
            log.warning("feedback enabled but event server url/key missing")
            return

        def post():
            try:
                pr_id = (result.get("pr_id")
                         if isinstance(result, dict) and result.get("pr_id")
                         else getattr(self.runtime.instance, "id", None))
                event = {
                    "event": "predict",
                    "entityType": "pio_pr",
                    "entityId": pr_id,
                    "properties": {"query": query_json, "prediction": result},
                    "prId": pr_id,
                }
                req = urllib.request.Request(
                    f"{self.config.event_server_url}/events.json"
                    f"?accessKey={self.config.access_key}",
                    data=json.dumps(event).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                urllib.request.urlopen(req, timeout=10).read()
            except Exception:  # noqa: BLE001 — never the client's
                log.exception("feedback event POST failed")
            finally:
                with self._feedback_lock:
                    self._feedback_threads.discard(threading.current_thread())

        t = threading.Thread(target=post, name="feedback-post", daemon=True)
        with self._feedback_lock:
            self._feedback_threads.add(t)
        t.start()

    # -- online learning ------------------------------------------------------
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
