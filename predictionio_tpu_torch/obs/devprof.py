"""Device profiling: per-function device seconds, work counts and roofline.

Counterpart of the JAX package's ``obs/devprof.py``, in PyTorch's idiom.
Every top-level device function the port runs (the ALS train loops,
the dense passes, the serving verbs, the fold, the UR and classify
steps) is wrapped by ``instrument(name, fn, cost=...)``, and the
process-wide ``DeviceProfiler`` records, per named function:

- its invocations and device seconds. A call on a CUDA device is timed
  by a pair of ``torch.cuda.Event(enable_timing=True)`` recorded on the
  device's current stream (every kernel of the port launches there)
  around it, then ``end.synchronize()``: the wrapper returns with the
  call's work done, as the JAX wrapper's ``block_until_ready`` does, and
  adds no second synchronize. A call on the CPU is timed by
  ``time.perf_counter()``. The device is the one the call's first tensor
  argument lies on;
- the operations and bytes its call does, from the call's shapes: the
  site's ``cost(args, kwargs)`` returns an ``obs.costs.Work``, the same
  formulas ``chip_smoke.py``'s bounds use. ``scale_by="iterations"``
  names a keyword whose value multiplies a per-iteration count, as in
  the JAX package (the report keeps ``flops_scaled_by``);
- argument and output bytes from the tensors and, for wrappers built
  with ``memory=True``, temp bytes: the ``torch.cuda.max_memory_allocated``
  rise over the bytes allocated before the call, on a signature's first
  call only, under a lock of its own (resetting the peak is
  process-wide, so two such calls never overlap);
- kernel-build seconds (``compile_seconds`` in the report, the JAX
  name): ``obs.cudamon``'s build counter is diffed around a signature's
  first call, and a build paid inside the timed window is taken out of
  the device seconds, as the JAX package does with compiles.

From those it derives MFU (executed operations a second over the
platform's peak for the call's operand type) and the fraction of the
memory roof, against a peak table keyed on the device's name
(``PEAK_TABLE``/``PEAK_DTYPE_TABLE``; ``PIO_PEAK_FLOPS``,
``PIO_PEAK_FLOPS_INT8``, ``PIO_PEAK_FLOPS_F32`` and ``PIO_PEAK_HBM_BPS``
override). Both clamp at 1.0 as in the JAX package; each executable's
row also carries them unclamped (``mfu_raw``,
``hbm_fraction_of_roof_raw``), so a count that overshoots shows.

A wrapper called while another instrumented call runs on the same
thread passes straight through, untimed and uncounted (the passes
inside a train loop add no synchronize of their own and no work twice).

Padding waste: the engines call ``record_batch_padding(real, padded,
flops=...)`` per device batch; the ratio feeds a ``batch_padding_ratio``
histogram and a wasted-operations counter on the process-default
registry, which ``/metrics`` and ``/debug/profile`` both read.

Degradation contract, as in the JAX package: a bookkeeping failure
degrades to an unprofiled call (counted in the executable's
``timing_errors``); the wrapped function runs exactly once and its
exceptions propagate untouched; serving never fails because profiling
broke. ``PIO_DEVPROF_STRICT=1`` makes a bookkeeping failure raise
instead (tests, and the on-card smoke, where a silently unprofiled call
would hide the device). ``PIO_DEVPROF=0`` turns every wrapper into a
passthrough, read at each call.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Callable, NamedTuple, Optional

from predictionio_tpu_torch.obs import cudamon as _cudamon
from predictionio_tpu_torch.obs.registry import MetricsRegistry, get_default_registry
from predictionio_tpu_torch.utils.env import env_bool, env_opt_float

# -- platform peaks ---------------------------------------------------------

#: device-name substring (lowercase) → (peak FLOP/s of the default
#: column, peak memory bytes/s); the longest match wins. The H100 row
#: is the card's dense bf16 tensor-core peak and its HBM3 rate, keyed
#: on the name ``torch.cuda.get_device_name()`` reports for the SXM
#: card: another H100 variant (PCIe, NVL) gets no peak and no MFU
#: rather than a wrong one. The CPU row is a round fallback so MFU stays
#: a small honest fraction on a host.
PEAK_TABLE: dict[str, tuple[float, float]] = {
    "nvidia h100 80gb hbm3": (989e12, 3.35e12),
    "cpu": (2e11, 50e9),
}

#: per-type peaks beside the default (bf16) column
PEAK_DTYPE_TABLE: dict[str, dict[str, float]] = {
    "nvidia h100 80gb hbm3": {"f32": 67e12, "int8": 1979e12},
    "cpu": {"f32": 2e11, "int8": 2e11},
}

#: batch padding ratio lives in [0, 1); these resolve the interesting
#: shapes (exact fills at 0, the pow2-bucket half/quarter fills, tails)
PADDING_RATIO_BUCKETS: tuple[float, ...] = (
    0.0, 0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 0.984375,
)


class DevprofError(RuntimeError):
    """A bookkeeping failure, raised only under ``PIO_DEVPROF_STRICT=1``."""


def _device_identity() -> tuple[Optional[str], Optional[str]]:
    """(platform, device kind): "gpu" and the current CUDA device's name
    once this process has initialised CUDA; "cpu" while torch is loaded
    without it; (None, None) in a process that never loaded torch
    (nothing here imports torch or initialises a device)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None, None
    try:
        if torch.cuda.is_initialized():
            return "gpu", torch.cuda.get_device_name(torch.cuda.current_device())
    except Exception:  # noqa: BLE001 — a torch without CUDA support
        pass
    return "cpu", "cpu"


def platform_info(dtype: Optional[str] = None) -> dict:
    """Platform and resolved peaks. `dtype` ("int8" | "f32" | "bf16" |
    None) selects the peak-FLOPs column; None and "bf16" keep the
    default one. Environment overrides apply first."""
    platform, kind = _device_identity()
    dt = dtype if dtype in ("int8", "f32") else None
    env_name = {
        "int8": "PIO_PEAK_FLOPS_INT8", "f32": "PIO_PEAK_FLOPS_F32",
    }.get(dt, "PIO_PEAK_FLOPS")
    peak_flops = env_opt_float(env_name)
    if peak_flops is None and dt is not None:
        # a fleet pinning only PIO_PEAK_FLOPS pins every type
        peak_flops = env_opt_float("PIO_PEAK_FLOPS")
    peak_hbm = env_opt_float("PIO_PEAK_HBM_BPS")
    source = "env" if (peak_flops or peak_hbm) else None
    if peak_flops is None or peak_hbm is None:
        best = None
        for key in (kind, platform):
            if not key:
                continue
            lowered = str(key).lower()
            for entry, peaks in PEAK_TABLE.items():
                if entry in lowered and (best is None or len(entry) > len(best[0])):
                    best = (entry, peaks)
            if best is not None:
                break
        if best is not None:
            source = source or "table"
            if peak_flops is None:
                peak_flops = best[1][0]
                if dt is not None:
                    peak_flops = PEAK_DTYPE_TABLE.get(best[0], {}).get(dt, peak_flops)
            if peak_hbm is None:
                peak_hbm = best[1][1]
    return {
        "platform": platform,
        "device_kind": kind,
        "peak_flops": peak_flops,
        "peak_hbm_bps": peak_hbm,
        "peak_source": source or "none",
        **({"peak_dtype": dt} if dt is not None else {}),
    }


def mfu(flops: float, seconds: float, dtype: Optional[str] = None) -> Optional[float]:
    """Executed-operations utilization against the platform's peak for
    `dtype` (default bf16), clamped to 1.0; None when an input or the
    peak is unknown."""
    peak = platform_info(dtype)["peak_flops"]
    if not peak or seconds <= 0 or flops <= 0:
        return None
    return min(1.0, flops / seconds / peak)


def hbm_fraction(nbytes: float, seconds: float) -> Optional[float]:
    """Memory-traffic fraction of the platform's roof (same contract as
    mfu)."""
    peak = platform_info()["peak_hbm_bps"]
    if not peak or seconds <= 0 or nbytes <= 0:
        return None
    return min(1.0, nbytes / seconds / peak)


# -- per-executable accounting ---------------------------------------------


@dataclass
class _SigAnalysis:
    """What one call signature of an executable does."""

    flops: float = 0.0  # per call (per iteration when scaled)
    bytes_accessed: float = 0.0
    arg_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    code_bytes: float = 0.0
    cost_ok: bool = False
    memory_ok: bool = False
    dtype: Optional[str] = None


@dataclass
class _Exec:
    name: str
    scale_by: Optional[str] = None
    signatures: dict = field(default_factory=dict)  # sig key → _SigAnalysis
    invocations: int = 0
    device_seconds: float = 0.0
    compile_seconds: float = 0.0
    flops_total: float = 0.0
    bytes_total: float = 0.0
    timing_errors: int = 0
    last_error: str = ""
    # dtype → [flops, device_seconds, invocations]: a mixed-type
    # executable rooflines each type against its own peak
    dtype_totals: dict = field(default_factory=dict)
    # device type ("cuda", "cpu") → [invocations, seconds, flops, bytes]:
    # the roofline reads the platform's own device's calls only
    by_device: dict = field(default_factory=dict)


class ProfTotals(NamedTuple):
    """Cumulative device accounting: stage spans and phases diff it.
    `card_seconds` counts the calls timed on a CUDA device only."""

    flops: float
    bytes: float
    device_seconds: float
    invocations: int
    card_seconds: float = 0.0


_FIELDS: dict[type, tuple[str, ...]] = {}


def _dataclass_fields(t: type) -> tuple[str, ...]:
    """The field names of dataclass type `t` (empty for other types),
    looked up once a type."""
    names = _FIELDS.get(t)
    if names is None:
        names = _FIELDS[t] = (tuple(f.name for f in fields(t))
                              if is_dataclass(t) else ())
    return names


def _walk(x: Any, visit: Callable[[Any], Any]) -> Any:
    if isinstance(x, (tuple, list)):
        return tuple(_walk(v, visit) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _walk(v, visit)) for k, v in x.items()))
    names = _dataclass_fields(type(x))
    if names:
        return tuple((n, _walk(getattr(x, n), visit)) for n in names)
    return visit(x)


def _leaf_sig(obj: Any) -> Any:
    shape = getattr(obj, "shape", None)
    dtype = getattr(obj, "dtype", None)
    if shape is not None and dtype is not None:
        dev = getattr(obj, "device", None)
        return ("arr", tuple(shape), str(dtype), str(getattr(dev, "type", "")))
    if isinstance(obj, float):
        # λ, α sweeps share one signature
        return ("f",)
    if obj is None or isinstance(obj, (bool, int, str)):
        return ("v", obj)
    # anything else by type only: a signature key holds no reference to
    # the caller's objects
    return ("t", type(obj).__name__)


def _signature(args: tuple, kwargs: dict) -> tuple:
    return (_walk(args, _leaf_sig), _walk(kwargs, _leaf_sig))


def _nbytes(x: Any) -> float:
    total = 0.0

    def visit(v: Any) -> None:
        nonlocal total
        if hasattr(v, "element_size") and hasattr(v, "nelement"):
            total += float(v.nelement() * v.element_size())
        else:
            n = getattr(v, "nbytes", None)
            if isinstance(n, (int, float)):
                total += n

    _walk(x, visit)
    return total


def _call_device(x: Any):
    """The device of the first tensor in the call's arguments (None: no
    tensor)."""
    if hasattr(x, "element_size") and hasattr(x, "device"):
        return x.device
    if isinstance(x, (tuple, list)):
        items = x
    elif isinstance(x, dict):
        items = x.values()
    else:
        names = _dataclass_fields(type(x))
        if not names:
            return None
        items = (getattr(x, n) for n in names)
    for v in items:
        dev = _call_device(v)
        if dev is not None:
            return dev
    return None


_local = threading.local()


def _depth() -> int:
    return getattr(_local, "depth", 0)


class _Timer:
    """Times one call: a pair of CUDA events on the device's current
    stream for a CUDA device (one pair a thread and device, reused: the
    nested calls a pair would have to outlive pass through untimed), the
    host clock otherwise. `mark()` ends the window; `seconds()` waits for
    the device to pass the mark and reads it, so host bookkeeping done
    between the two overlaps the device's work."""

    def __init__(self, device):
        self.cuda = device is not None and device.type == "cuda"
        if self.cuda:
            import torch

            self.stream = torch.cuda.current_stream(device)
            index = device.index if device.index is not None else torch.cuda.current_device()
            pairs = getattr(_local, "events", None)
            if pairs is None:
                pairs = _local.events = {}
            pair = pairs.get(index)
            if pair is None:
                pair = pairs[index] = (torch.cuda.Event(enable_timing=True),
                                       torch.cuda.Event(enable_timing=True))
            self.start, self.end = pair
            self.start.record(self.stream)
        self.t0 = self.t1 = time.perf_counter()

    def mark(self) -> None:
        if self.cuda:
            self.end.record(self.stream)
        else:
            self.t1 = time.perf_counter()

    def seconds(self) -> float:
        if not self.cuda:
            return self.t1 - self.t0
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


#: slot reservation for a signature whose first call is still in flight
_ANALYSIS_PENDING = _SigAnalysis()


def _strict() -> bool:
    return env_bool("PIO_DEVPROF_STRICT", False)


class DeviceProfiler:
    """Thread-safe registry of profiled executables."""

    def __init__(self):
        self._lock = threading.Lock()
        self._execs: dict[str, _Exec] = {}  # guarded-by: _lock
        # a signature's first memory=True call resets the device's
        # process-wide peak: one at a time
        self._memory_lock = threading.Lock()

    # -- recording --------------------------------------------------------
    def _error(self, rec: Optional[_Exec], name: str, exc: BaseException) -> None:
        with self._lock:
            if rec is None:
                rec = self._execs.setdefault(name, _Exec(name))
            rec.timing_errors += 1
            rec.last_error = f"{type(exc).__name__}: {exc}"
        if _strict():
            raise DevprofError(f"{name}: device profiling failed: {exc}") from exc

    def call(self, wrapper: "_Instrumented", args: tuple, kwargs: dict):
        """Run the wrapped function once, with fenced accounting."""
        fn = wrapper.__wrapped__
        rec = None
        new_sig = pending_race = False
        sig: tuple = ("?",)
        timer = None
        b0 = mem0 = 0.0
        dev = None
        mem_locked = False
        try:
            sig = _signature(args, kwargs)
            with self._lock:
                rec = self._execs.get(wrapper.name)
                if rec is None:
                    rec = self._execs[wrapper.name] = _Exec(
                        wrapper.name, scale_by=wrapper.scale_by)
                existing = rec.signatures.get(sig)
                if existing is None:
                    rec.signatures[sig] = _ANALYSIS_PENDING
                    new_sig = True
                elif existing is _ANALYSIS_PENDING:
                    # another thread's first call may be building the
                    # kernel this call waits on: the same deduction
                    pending_race = True
            dev = _call_device((args, kwargs))
            _, b0 = _cudamon.build_snapshot()
            if new_sig and wrapper.memory and dev is not None and dev.type == "cuda":
                import torch

                self._memory_lock.acquire()
                mem_locked = True
                torch.cuda.reset_peak_memory_stats(dev)
                mem0 = float(torch.cuda.memory_allocated(dev))
            timer = _Timer(dev)
        except Exception as e:  # noqa: BLE001 — degrade to an unprofiled call
            if mem_locked:
                self._memory_lock.release()
                mem_locked = False
            self._unreserve(rec, sig, new_sig)
            rec = None
            self._error(None, wrapper.name, e)
        _local.depth = _depth() + 1
        try:
            try:
                out = fn(*args, **kwargs)
            except BaseException:
                if mem_locked:
                    self._memory_lock.release()
                # the reserved slot must not poison the signature
                self._unreserve(rec, sig, new_sig)
                raise
            if rec is not None:
                self._account(wrapper, rec, sig, new_sig, pending_race, timer, b0, dev,
                              mem0, mem_locked, args, kwargs, out)
        finally:
            _local.depth -= 1
        return out

    def _account(self, wrapper, rec, sig, new_sig, pending_race, timer, b0, dev, mem0,
                 mem_locked, args, kwargs, out) -> None:
        """One finished call's bookkeeping: the work count and a new
        signature's analysis are taken on the host while the device
        finishes, then the timer's wait, then the totals under the lock."""
        try:
            try:
                timer.mark()
                work = wrapper.work(args, kwargs)
                analysis = None
                if new_sig:
                    analysis = self._analyze(wrapper, args, kwargs, out, dev, mem0,
                                             mem_locked)
                dt = timer.seconds()
                build_sec = 0.0
                if new_sig or pending_race:
                    _, b1 = _cudamon.build_snapshot()
                    build_sec = max(0.0, b1 - b0)
                    dt = max(0.0, dt - build_sec)
            finally:
                if mem_locked:
                    self._memory_lock.release()
            scale = 1.0
            if wrapper.scale_by is not None:
                try:
                    scale = float(kwargs.get(wrapper.scale_by) or 1)
                except (TypeError, ValueError):
                    scale = 1.0
            with self._lock:
                if new_sig:
                    rec.signatures[sig] = analysis
                    rec.compile_seconds += build_sec
                else:
                    analysis = rec.signatures.get(sig)
                    if analysis is None or analysis is _ANALYSIS_PENDING:
                        analysis = _ANALYSIS_PENDING
                if work is not None and analysis is not _ANALYSIS_PENDING:
                    analysis.flops = work.flops
                    analysis.bytes_accessed = work.bytes
                    analysis.cost_ok = True
                flops = work.flops * scale if work is not None else 0.0
                nbytes = work.bytes * scale if work is not None else 0.0
                rec.invocations += 1
                rec.device_seconds += dt
                rec.flops_total += flops
                rec.bytes_total += nbytes
                d = rec.by_device.setdefault("cuda" if timer.cuda else "cpu",
                                             [0, 0.0, 0.0, 0.0])
                d[0] += 1
                d[1] += dt
                d[2] += flops
                d[3] += nbytes
                if analysis.dtype is not None:
                    t = rec.dtype_totals.setdefault(analysis.dtype, [0.0, 0.0, 0])
                    t[0] += flops
                    t[1] += dt
                    t[2] += 1
        except Exception as e:  # noqa: BLE001 — the call's result stands
            self._unreserve(rec, sig, new_sig)
            self._error(rec, wrapper.name, e)

    def _unreserve(self, rec, sig, new_sig) -> None:
        if rec is not None and new_sig:
            with self._lock:
                if rec.signatures.get(sig) is _ANALYSIS_PENDING:
                    del rec.signatures[sig]

    def _analyze(self, wrapper: "_Instrumented", args: tuple, kwargs: dict,
                 out: Any, dev, mem0: float, memory: bool) -> _SigAnalysis:
        """One signature's argument, output and (memory=True) temp bytes
        and its operand type."""
        res = _SigAnalysis(arg_bytes=_nbytes((args, kwargs)), output_bytes=_nbytes(out))
        if wrapper.dtype_of is not None:
            res.dtype = wrapper.dtype_of(args, kwargs)
        if memory:
            import torch

            peak = float(torch.cuda.max_memory_allocated(dev))
            res.temp_bytes = max(0.0, peak - mem0 - res.output_bytes)
            res.memory_ok = True
        return res

    def record_external(self, name: str, seconds: float,
                        invocations: int = 1) -> None:
        """Attribute externally measured device seconds to a named
        executable (callers that own their timing)."""
        with self._lock:
            rec = self._execs.get(name)
            if rec is None:
                rec = self._execs[name] = _Exec(name)
            rec.device_seconds += max(0.0, seconds)
            rec.invocations += invocations

    # -- reading ----------------------------------------------------------
    def snapshot(self) -> ProfTotals:
        with self._lock:
            return ProfTotals(
                flops=sum(e.flops_total for e in self._execs.values()),
                bytes=sum(e.bytes_total for e in self._execs.values()),
                device_seconds=sum(e.device_seconds for e in self._execs.values()),
                invocations=sum(e.invocations for e in self._execs.values()),
                card_seconds=sum(e.by_device.get("cuda", (0, 0.0))[1]
                                 for e in self._execs.values()),
            )

    def executable_count(self) -> int:
        with self._lock:
            return len(self._execs)

    def compile_seconds_total(self) -> float:
        with self._lock:
            return sum(e.compile_seconds for e in self._execs.values())

    def executable(self, name: str) -> Optional[dict]:
        plat = platform_info()
        with self._lock:
            rec = self._execs.get(name)
            if rec is None:
                return None
            return self._exec_dict(rec, plat, {})

    def _exec_dict(self, rec: _Exec, plat: dict, dtype_peaks: dict) -> dict:
        sigs = [s for s in rec.signatures.values() if s is not _ANALYSIS_PENDING]
        latest = sigs[-1] if sigs else _SigAnalysis()
        out = {
            "name": rec.name,
            "signatures": len(rec.signatures),
            "invocations": rec.invocations,
            "compile_seconds": round(rec.compile_seconds, 4),
            "device_seconds": round(rec.device_seconds, 6),
            "flops_per_call": latest.flops,
            "bytes_per_call": latest.bytes_accessed,
            "flops_total": rec.flops_total,
            "bytes_total": rec.bytes_total,
            "argument_bytes": latest.arg_bytes,
            "output_bytes": latest.output_bytes,
            "temp_bytes": latest.temp_bytes,
            "generated_code_bytes": latest.code_bytes,
            "cost_analysis_ok": any(s.cost_ok for s in sigs),
            "memory_analysis_ok": any(s.memory_ok for s in sigs),
            "timing_errors": rec.timing_errors,
        }
        if rec.last_error:
            out["last_error"] = rec.last_error
        if rec.scale_by is not None:
            out["flops_scaled_by"] = rec.scale_by
        peak_f, peak_h = plat.get("peak_flops"), plat.get("peak_hbm_bps")

        def dtyped_peak(dt: str):
            if dt not in dtype_peaks:
                dtype_peaks[dt] = platform_info(dt).get("peak_flops")
            return dtype_peaks[dt]

        if latest.dtype is not None:
            out["dtype"] = latest.dtype
            if latest.dtype in ("int8", "f32"):
                dt_peak = dtyped_peak(latest.dtype)
                if dt_peak:
                    peak_f = dt_peak
                    out["peak_flops_dtype"] = dt_peak
        if rec.dtype_totals:
            cols = {}
            for dt, (fl, sec, inv) in sorted(rec.dtype_totals.items()):
                col = {"flops_total": fl, "device_seconds": round(sec, 6),
                       "invocations": inv}
                dt_peak = (dtyped_peak(dt) if dt in ("int8", "f32")
                           else plat.get("peak_flops"))
                if dt_peak:
                    col["peak_flops"] = dt_peak
                    if sec > 0 and fl > 0:
                        col["mfu_raw"] = fl / sec / dt_peak
                        col["mfu"] = round(min(1.0, col["mfu_raw"]), 8)
                cols[dt] = col
            out["dtypes"] = cols
        if rec.by_device:
            out["devices"] = {k: {"invocations": v[0], "device_seconds": round(v[1], 6),
                                  "flops_total": v[2], "bytes_total": v[3]}
                              for k, v in sorted(rec.by_device.items())}
        # the roofline against the platform's peaks reads only the calls
        # on the platform's device (a CUDA process checking its answers
        # on the host runs the same function on the CPU too)
        if rec.by_device:
            on = rec.by_device.get("cuda" if plat.get("platform") == "gpu" else "cpu",
                                   [0, 0.0, 0.0, 0.0])
            secs, flops, nbytes = on[1], on[2], on[3]
        else:
            secs, flops, nbytes = rec.device_seconds, rec.flops_total, rec.bytes_total
        if peak_f and secs > 0 and flops > 0:
            out["mfu_raw"] = flops / secs / peak_f
            out["mfu"] = round(min(1.0, out["mfu_raw"]), 8)
            out["flops_per_sec"] = flops / secs
        if peak_h and secs > 0 and nbytes > 0:
            out["hbm_fraction_of_roof_raw"] = nbytes / secs / peak_h
            out["hbm_fraction_of_roof"] = round(min(1.0, out["hbm_fraction_of_roof_raw"]), 8)
            out["hbm_bytes_per_sec"] = nbytes / secs
        return out

    def report(self) -> dict:
        """The ``GET /debug/profile`` payload: platform and peaks, every
        profiled executable with its roofline, padding waste, totals."""
        plat = platform_info()
        dtype_peaks: dict = {}
        with self._lock:
            rows = [self._exec_dict(r, plat, dtype_peaks) for r in self._execs.values()]
        rows.sort(key=lambda r: -r["device_seconds"])
        totals = self.snapshot()
        peak_f = plat.get("peak_flops")
        return {
            "platform": plat,
            "executables": rows,
            "totals": {
                "flops": totals.flops,
                "bytes": totals.bytes,
                "device_seconds": round(totals.device_seconds, 6),
                "invocations": totals.invocations,
                "mfu": (
                    min(1.0, totals.flops / totals.device_seconds / peak_f)
                    if peak_f and totals.device_seconds > 0 and totals.flops > 0
                    else None
                ),
            },
            "padding": padding_summary(),
        }

    def clear(self) -> None:
        with self._lock:
            self._execs.clear()


_profiler = DeviceProfiler()


def get_profiler() -> DeviceProfiler:
    return _profiler


def snapshot() -> ProfTotals:
    """Module-level convenience: the stage-span diff pattern."""
    return _profiler.snapshot()


def report() -> dict:
    return _profiler.report()


def _enabled() -> bool:
    return env_bool("PIO_DEVPROF", True)


# -- the device-function hook ----------------------------------------------


class _Instrumented:
    """Callable wrapper around a device function: a passthrough when
    profiling is disabled or an instrumented call already runs on this
    thread; other attributes forward to the wrapped function."""

    def __init__(self, name: str, fn: Callable, scale_by: Optional[str] = None,
                 memory: bool = False, dtype_of: Optional[Callable] = None,
                 cost: Optional[Callable] = None):
        self.name = name
        self.__wrapped__ = fn
        self.scale_by = scale_by
        self.memory = memory
        self.dtype_of = dtype_of
        self.cost = cost
        self.__doc__ = getattr(fn, "__doc__", None)

    def work(self, args: tuple, kwargs: dict):
        """The call's `obs.costs.Work` (per iteration when scaled), or
        None without a cost function."""
        return None if self.cost is None else self.cost(args, kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if _depth() > 0 or not _enabled():
            return self.__wrapped__(*args, **kwargs)
        return _profiler.call(self, args, kwargs)

    def __getattr__(self, item: str) -> Any:
        return getattr(self.__wrapped__, item)


def instrument(name: str, fn: Callable, *, scale_by: Optional[str] = None,
               memory: bool = False, dtype_of: Optional[Callable] = None,
               cost: Optional[Callable] = None) -> Callable:
    """Hook a top-level device function into the profiler.

    `cost(args, kwargs)` returns the call's ``obs.costs.Work`` from its
    shapes; `scale_by` names a keyword whose value multiplies it (the
    train loops' per-iteration counts). `memory=True` measures a
    signature's temp bytes on its first call. `dtype_of(args, kwargs)`
    declares the call's operand type ("int8"/"f32"/"bf16"), so the
    roofline uses that type's peak; None keeps the default (bf16)
    column."""
    return _Instrumented(name, fn, scale_by=scale_by, memory=memory,
                         dtype_of=dtype_of, cost=cost)


# -- padding-waste accounting ----------------------------------------------


def _padding_hist(reg: MetricsRegistry):
    return reg.histogram(
        "batch_padding_ratio",
        "fraction of each coalesced device batch that was padding",
        buckets=PADDING_RATIO_BUCKETS,
    )


def _padding_counters(reg: MetricsRegistry):
    return (
        reg.counter("batch_rows_real_total",
                    "live query rows through device batches"),
        reg.counter("batch_rows_padded_total",
                    "total rows (live + padding) through device batches"),
        reg.counter("batch_padding_wasted_flops_total",
                    "device FLOPs spent computing padding rows"),
    )


def record_batch_padding(real_rows: int, padded_rows: int, flops: float = 0.0,
                         registry: Optional[MetricsRegistry] = None) -> None:
    """Account one padded device batch: `real_rows` live queries ran in a
    `padded_rows`-shaped call, so (padded-real)/padded of its work
    (`flops`, typically a profiler snapshot diff across the call) was
    waste."""
    if padded_rows <= 0:
        return
    real_rows = max(0, min(real_rows, padded_rows))
    ratio = (padded_rows - real_rows) / padded_rows
    reg = registry if registry is not None else get_default_registry()
    _padding_hist(reg).observe(ratio)
    real_c, padded_c, wasted_c = _padding_counters(reg)
    real_c.inc(real_rows)
    padded_c.inc(padded_rows)
    if flops > 0 and ratio > 0:
        wasted_c.inc(flops * ratio)


def padding_summary(registry: Optional[MetricsRegistry] = None) -> dict:
    """The padding section of `report()`, read back off the registry the
    pad sites record into."""
    reg = registry if registry is not None else get_default_registry()
    hist = _padding_hist(reg)
    real_c, padded_c, wasted_c = _padding_counters(reg)
    return {
        "batches": hist.count,
        "mean_padding_ratio": round(hist.mean, 6),
        "p50_padding_ratio": round(hist.quantile(0.5), 6),
        "rows_real": real_c.total,
        "rows_padded": padded_c.total,
        "wasted_flops": wasted_c.total,
    }


# -- /metrics gauges --------------------------------------------------------


def install_devprof_gauges(registry: MetricsRegistry) -> None:
    """Mount the profiler's cumulative totals as scrape-time callback
    gauges (idempotent per registry)."""
    registry.gauge_callback(
        "devprof_executables", "distinct profiled executables in this process",
        lambda: float(_profiler.executable_count()))
    registry.gauge_callback(
        "devprof_invocations_total", "profiled executable invocations",
        lambda: float(_profiler.snapshot().invocations))
    registry.gauge_callback(
        "devprof_device_seconds_total",
        "cumulative device seconds across profiled executables",
        lambda: _profiler.snapshot().device_seconds)
    registry.gauge_callback(
        "devprof_flops_total",
        "cumulative executed FLOPs across profiled executables",
        lambda: _profiler.snapshot().flops)
    registry.gauge_callback(
        "devprof_bytes_total",
        "cumulative HBM bytes accessed across profiled executables",
        lambda: _profiler.snapshot().bytes)
    registry.gauge_callback(
        "devprof_compile_seconds_total",
        "cumulative kernel-build seconds attributed to profiled executables",
        _profiler.compile_seconds_total)

    def _lifetime_mfu() -> float:
        totals = _profiler.snapshot()  # one snapshot: coherent num/denom
        return mfu(totals.flops, totals.device_seconds) or 0.0

    registry.gauge_callback(
        "devprof_mfu", "process-lifetime model FLOPs utilization (0 when unknown)",
        _lifetime_mfu)


# -- on-demand torch.profiler capture --------------------------------------

_capture_lock = threading.Lock()


def capture_trace(directory: str, seconds: float, run_on=None) -> dict:
    """Open a ``torch.profiler`` window for `seconds` (host activity and,
    with CUDA in use, every kernel the process launches meanwhile) and
    write it as Chrome trace-event JSON under `directory` (load it at
    https://ui.perfetto.dev). Returns the file, the device records it
    holds, their count by kernel name and the thread the window ran on.
    Raises RuntimeError when torch is not loaded in this process or a
    capture is already running (callers map those to 409), ValueError
    for seconds outside (0, 60].

    `run_on(fn)`, where given, runs `fn` on the thread that launches the
    device work and returns its result (the query server's dispatcher
    `call`); the window then opens and closes there. CUPTI keeps the
    kernel records of the thread that opens and closes a window, but in
    a long process it drops those of other threads for stretches of
    tens of seconds: a window opened on a handler's thread can hold
    every launch of the serving thread and none of its kernels."""
    seconds = float(seconds)
    if not 0.0 < seconds <= 60.0:
        raise ValueError("capture seconds must be in (0, 60]")
    if "torch" not in sys.modules:
        raise RuntimeError("torch is not loaded in this process — nothing to capture")
    if not _capture_lock.acquire(blocking=False):
        raise RuntimeError("a profiler capture is already running")
    run = run_on or (lambda fn: fn())
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "trace.json")
        prof = profile(activities=activities)

        def start() -> str:
            prof.start()
            return threading.current_thread().name

        try:
            thread = run(start)
        except TimeoutError:
            raise RuntimeError("the device thread did not take the capture in time")
        try:
            time.sleep(seconds)
        finally:
            try:
                run(prof.stop)
            except Exception:  # noqa: BLE001 — the thread is gone: stop here
                prof.stop()
        prof.export_chrome_trace(path)
    finally:
        _capture_lock.release()
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels: dict[str, int] = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            name = str(ev.get("name", ""))
            kernels[name] = kernels.get(name, 0) + 1
    return {"dir": directory, "seconds": seconds, "trace": path, "thread": thread,
            "device_events": sum(kernels.values()), "kernels": kernels}
