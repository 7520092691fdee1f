"""Phases 27 (rollout) and 28 (monitor) of ``chip_smoke.py`` on random
ML-20M-width factors, without the trains before them; with ``--ab``,
phase 27 (a)'s three batching modes with the process monitor off, with
its sampler at the 5 s default tick and at phase 28's 0.25 s, in turns
(off, 5 s, 0.25 s, 0.25 s, 5 s, off, twice), each mode's qps medians
printed per arm.

    python -m predictionio_tpu_torch.tools.monitor_probe [--ab]

Run from a checkout of the repository (``chip_smoke.py`` is loaded from
its root) on a CUDA card; the kernels are built first, as the script
builds them. Results go to ``chiprun_out/monitor_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _random_factors(cs, rng, perturbed=False):
    from predictionio_tpu_torch import convert

    uf = rng.standard_normal((cs.N_USERS, cs.RANK)).astype("float32")
    itf = rng.standard_normal((cs.N_ITEMS, cs.RANK)).astype("float32")
    users = [f"u{i}" for i in range(cs.N_USERS)]
    items = [f"i{i}" for i in range(cs.N_ITEMS)]
    return (convert.als_factors_from_numpy(uf, itf, users, items, {}),
            convert.als_factors_from_numpy(
                uf + 1e-3 * rng.standard_normal(uf.shape).astype("float32"),
                itf, users, items, {}))


def _ab(cs, factors, smi) -> dict:
    """Phase 27 (a)'s modes per arm, in turns; returns the qps runs and
    medians by arm and mode."""
    import numpy as np

    from predictionio_tpu_torch.obs.monitor import get_monitor

    queries = cs._queries(np.random.default_rng(cs.SEED + 270), cs.N_USERS)
    bodies = [json.dumps(q).encode() for q in queries]
    cpu_alg = cs.ALSAlgorithm(cs.ALSAlgorithmParams(rank=cs.RANK))
    cpu_model = cs.ALSModel(factors, device="cpu")
    want = [cs._to_jsonable(cpu_alg.predict(cpu_model, cs.Query(**q))) for q in queries]
    store = ROOT / "build" / "monitor_probe" / "store"
    shutil.rmtree(store.parent, ignore_errors=True)
    store.mkdir(parents=True)
    arms = {"off": None, "tick5": 5.0, "tick0.25": 0.25}
    runs: dict = {arm: {} for arm in arms}
    mon = get_monitor()
    saved = mon.sampler_interval_s
    try:
        with cs._loop_storage(store):
            storage = cs.Storage()
            runtime = cs.build_runtime(storage, cs._rollout_persist(storage, factors))
            for arm in ["off", "tick5", "tick0.25", "tick0.25", "tick5", "off"] * 2:
                tick = arms[arm]
                # read at each server's start: the monitor attaches nothing
                # with PIO_TSDB=0
                os.environ["PIO_TSDB"] = "0" if tick is None else "1"
                if tick is not None:
                    mon.sampler_interval_s = tick
                out = cs._rollout_modes(runtime, storage, bodies, want, {},
                                        f"{smi} [{arm}]")
                for mode, o in out.items():
                    if isinstance(o, dict):
                        runs[arm].setdefault(mode, []).append(o["qps"])
    finally:
        os.environ.pop("PIO_TSDB", None)
        mon.sampler_interval_s = saved
    summary = {arm: {m: {"runs": v, "median": statistics.median(v)} for m, v in modes.items()}
               for arm, modes in runs.items()}
    for arm, modes in summary.items():
        for m, d in modes.items():
            print(f"[ab] {smi} | {arm:8s} {m:14s} qps median {d['median']:.1f} runs "
                  f"{', '.join(f'{x:.1f}' for x in d['runs'])}", flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", action="store_true",
                    help="phase 27 (a)'s modes with the monitor off / 5 s / 0.25 s")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs

    os.environ["PIO_DEVPROF_STRICT"] = "1"
    report: dict = {"busy": {}}
    shared: dict = {}
    cs.phase_device(report, shared)
    cs.phase_build(report, shared)
    shared["factors"], shared["plain_factors"] = _random_factors(
        cs, np.random.default_rng(7))
    if args.ab:
        result = {"ab": _ab(cs, shared["factors"], report["nvidia_smi"])}
    else:
        cs.phase_rollout(report, shared)
        cs.phase_monitor(report, shared)
        result = {k: report[k] for k in ("rollout", "monitor")}
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "monitor_probe.json").write_text(json.dumps(result, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
