"""Which thread's kernels a ``torch.profiler`` window keeps.

One thread launches device work in a loop (a (2048, 2048) by (2048, 64)
product and a top-10 over its columns, a synchronize, a 1 ms sleep), as
a query server's dispatcher does. A second thread opens `--windows`
windows of `--window-s` seconds (host and CUDA activity), 0.3 s apart,
and counts each window's kernel records and the launch records of the
CUDA runtime. Two ways, each in a process of its own, run side by side:

- ``caller``: the window opens and closes on the counting thread;
- ``worker``: it opens and closes on the launching thread, between two
  of its iterations (as ``obs/devprof.capture_trace`` does through the
  query server's dispatcher).

Run: ``python -m predictionio_tpu_torch.tools.capture_threads
[--windows 60] [--window-s 0.5]``. Needs a CUDA card. Prints one JSON
object: for each way, the windows, how many held no kernel record, and
each window's kernel and launch records.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time


def _window_counts(path: str) -> tuple[int, int]:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and "Launch" in str(e.get("name", "")))
    return kernels, launches


def run_way(way: str, windows: int, window_s: float) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("capture_threads needs a CUDA card")
    a = torch.randn(2048, 2048, device="cuda")
    b = torch.randn(2048, 64, device="cuda")
    stop, calls = threading.Event(), queue.Queue()

    def work() -> None:
        while not stop.is_set():
            try:
                fn, done = calls.get_nowait()
                fn()
                done.set()
            except queue.Empty:
                pass
            torch.topk(a @ b, 10, dim=0)
            torch.cuda.synchronize()
            time.sleep(0.001)

    def on_worker(fn) -> None:
        done = threading.Event()
        calls.put((fn, done))
        done.wait()

    run = on_worker if way == "worker" else (lambda fn: fn())
    worker = threading.Thread(target=work, name="launcher")
    worker.start()
    out = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            for _ in range(windows):
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                run(prof.start)
                time.sleep(window_s)
                run(prof.stop)
                prof.export_chrome_trace(path)
                out.append(_window_counts(path))
                time.sleep(0.3)
    finally:
        stop.set()
        worker.join()
    return {"windows": len(out), "without_kernels": sum(1 for k, _ in out if k == 0),
            "kernels": [k for k, _ in out], "launches": [n for _, n in out]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=60)
    ap.add_argument("--window-s", type=float, default=0.5)
    ap.add_argument("--way", choices=("caller", "worker"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.way:
        print(json.dumps(run_way(args.way, args.windows, args.window_s)))
        return
    procs = {way: subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--way", way, "--windows", str(args.windows),
         "--window-s", str(args.window_s)], stdout=subprocess.PIPE, text=True)
        for way in ("caller", "worker")}
    result, rc = {}, 0
    for way, p in procs.items():
        out, _ = p.communicate()
        rc = rc or p.returncode
        result[way] = json.loads(out.strip().splitlines()[-1]) if p.returncode == 0 else None
    print(json.dumps(result))
    sys.exit(rc)


if __name__ == "__main__":
    main()
