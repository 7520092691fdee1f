#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure prints what failed and exits non-zero:

1. device   needs CUDA; prints the card's name and power limit
            (nvidia-smi) and turns TF32 off.
2. build    compiles every ``predictionio_tpu_torch/ops/csrc/*.cu`` into
            ``build/kernels/`` and loads the library.
3. sweep    the fused score+top-k kernel against its plain PyTorch
            version on the card, at the ML-20M item slab: f32/bf16/int8,
            no mask / packed bits / row list, unscaled and scaled,
            B in {1, 8, 64}, k in {1, 10, 128, 1024, n_items}, a fully
            masked row, crafted cross-chunk ties on integer-valued
            factors, and B=1 vs B=64 bit-identity. Indices must be equal;
            values within rtol 1e-5 (the kernel and the plain version do
            the same rounded operations, so they are in fact equal).
4. serve    ML-20M-sized factors from a seed (138,493 users x 26,744
            items, rank 10) written as a JAX-format npz blob, loaded
            through ``convert.load_jax_als_blob`` and served by the
            port's ``QueryServer`` on the card; 16 client threads send
            500 ``POST /queries.json`` (some with blacklists or
            whitelists). Every answer must equal the plain version's on
            the CPU; kernel launches must equal device batches.
5. times    CUDA-event medians at B in {1, 64}, k=128, per dtype: the
            kernel, the plain version, ``torch.topk(q @ itf.T)`` as a
            yardstick the port never calls, and the card's bound.
6. report   one ``{"kernels": [...]}`` line, then the device line last.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import http.client
import json
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

try:
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        ALSModel,
    )
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.ops import recommend as rec
    from predictionio_tpu_torch.workflow.server import (
        QueryServer,
        QueryServerConfig,
        _to_jsonable,
    )
except ImportError as exc:  # run outside a checkout of the repository
    _IMPORT_ERROR: ImportError | None = exc
else:
    _IMPORT_ERROR = None

SEED = 20
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 10  # ML-20M
K_LADDER = (1, 10, 128, 1024, N_ITEMS)
N_QUERIES, N_CLIENTS = 500, 16
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# operations/s per operand type (f32 on CUDA cores, bf16/int8 tensor cores)
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
SOURCE = "predictionio_tpu_torch/ops/csrc/recommend_topk.cu"
REPLACES = "predictionio_tpu/ops/recommend_pallas.py:412"
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device(report):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    report["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report["device"] = torch.cuda.get_device_name(0)
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    print(f"[device] {report['device']} | {report['nvidia_smi']} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)


def phase_build(report):
    t0 = time.perf_counter()
    paths = _build.build()
    rec._kernel_lib()
    report["build_s"] = time.perf_counter() - t0
    report["build_log"] = {
        n: [ln for ln in log.splitlines() if "ptxas" in ln]
        for n, log in _build.BUILD_LOGS.items()
    }
    print(f"[build] {len(paths)} source(s) in {report['build_s']:.2f} s: "
          f"{', '.join(sorted(paths))}", flush=True)
    for n, lines in report["build_log"].items():
        for ln in lines:
            if "registers" in ln or "Compiling entry" in ln:
                print(f"[build] {n}: {ln.strip()}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version on the card
# ---------------------------------------------------------------------------


def _slab(rng, dtype, integer=False):
    """(q (64, K), itf (I_p, K)) on the card, with int8 scales."""
    i_p = rec.pad_items(N_ITEMS)
    if integer:
        uf = rng.integers(-2, 3, (64, RANK)).astype(np.float32)
        itf = rng.integers(-2, 3, (N_ITEMS, RANK)).astype(np.float32)
    else:
        uf = (rng.standard_normal((64, RANK)) / np.sqrt(RANK)).astype(np.float32)
        itf = (rng.standard_normal((N_ITEMS, RANK)) / np.sqrt(RANK)).astype(np.float32)
    qs = isc = None
    if dtype == "int8":
        uq, us = rec.quantize_rows_np(uf)
        iq, iscale = rec.quantize_rows_np(itf)
        uf, itf = uq, iq
        qs = torch.from_numpy(np.ascontiguousarray(us[:, None])).cuda()
        isc_np = np.ones((1, i_p), np.float32)
        isc_np[0, :N_ITEMS] = iscale
        isc = torch.from_numpy(isc_np).cuda()
    items = np.zeros((i_p, RANK), itf.dtype)
    items[:N_ITEMS] = itf
    q = torch.from_numpy(uf).cuda().to(TORCH_DT[dtype])
    it = torch.from_numpy(items).cuda().to(TORCH_DT[dtype])
    return q, it, qs, isc


def _masks(rng, b, i_p):
    mask = rng.random((b, N_ITEMS)) < 0.3
    mask[0] = True  # a fully masked row
    bits = torch.from_numpy(rec.pack_mask_np(mask, i_p)).cuda()
    rows = np.full((b, 16), -1, np.int32)
    rows[:, :12] = rng.integers(0, N_ITEMS, (b, 12))
    rows[0, 12] = i_p + 5  # out of range: inert
    return {None: (None, None), "bits": (bits, None),
            "rows": (None, torch.from_numpy(rows).cuda())}


def _compare(args, k, exact, tally, label):
    kv, ki = rec.fused_recommend_topk(*args, k=k, n_items=N_ITEMS)
    pv, pi = rec.fused_recommend_topk_plain(*args, k=k, n_items=N_ITEMS)
    torch.cuda.synchronize()
    check(torch.equal(ki, pi), f"{label}: indices differ from the plain version")
    if exact:
        check(torch.equal(kv, pv), f"{label}: values differ (exact inputs)")
    else:
        check(torch.allclose(kv, pv, rtol=1e-5, atol=0.0),
              f"{label}: values beyond rtol 1e-5")
    tally["max_abs_err"] = max(tally["max_abs_err"],
                               float((kv - pv).abs().max()))
    tally["bit_equal"] += int(torch.equal(kv, pv))
    tally["cases"] += 1
    return kv, ki


def phase_sweep(report):
    rng = np.random.default_rng(SEED)
    i_p = rec.pad_items(N_ITEMS)
    tally = {"cases": 0, "bit_equal": 0, "max_abs_err": 0.0}
    t0 = time.perf_counter()
    for dtype in ("f32", "bf16", "int8"):
        q64, itf, qs8, isc8 = _slab(rng, dtype)
        if dtype == "int8":
            try:
                rec.fused_recommend_topk(q64, itf, k=5, n_items=N_ITEMS)
            except ValueError:
                pass
            else:
                raise PhaseError("int8 without scales did not raise")
        cos_q = torch.from_numpy(
            rng.uniform(0.5, 2.0, (64, 1)).astype(np.float32)).cuda()
        cos_i = torch.from_numpy(
            rng.uniform(0.5, 2.0, (1, i_p)).astype(np.float32)).cuda()
        scalings = {"int8": [(qs8, isc8)],
                    "f32": [(None, None), (cos_q, cos_i)],
                    "bf16": [(None, None), (cos_q, cos_i)]}[dtype]
        for qs, isc in scalings:
            for b in (1, 8, 64):
                masks = _masks(rng, b, i_p)
                for kind, (bits, rows) in masks.items():
                    args = (q64[:b].contiguous(), itf,
                            None if qs is None else qs[:b].contiguous(), isc,
                            bits, rows)
                    for k in K_LADDER:
                        label = (f"{dtype} scaled={qs is not None} mask={kind} "
                                 f"B={b} k={k}")
                        kv, ki = _compare(args, k, dtype == "int8", tally, label)
                        if kind == "bits":  # row 0 is fully masked
                            n = min(k, N_ITEMS)
                            check(bool((kv[0, :n] == rec.NEG_INF).all())
                                  and torch.equal(ki[0, :n].cpu(),
                                                  torch.arange(n, dtype=torch.int32)),
                                  f"{label}: fully masked row")
        # batch invariance: row 0 alone equals row 0 of the B=64 batch
        sc = scalings[-1]
        one = rec.fused_recommend_topk(
            q64[:1].contiguous(), itf,
            None if sc[0] is None else sc[0][:1].contiguous(), sc[1],
            k=128, n_items=N_ITEMS)
        full = rec.fused_recommend_topk(q64, itf, sc[0], sc[1], k=128,
                                        n_items=N_ITEMS)
        torch.cuda.synchronize()
        check(torch.equal(one[0][0], full[0][0]) and torch.equal(one[1][0], full[1][0]),
              f"{dtype}: B=1 row differs from row 0 at B=64")
    # crafted cross-chunk ties: integer factors in [-2, 2] make every
    # score an exact small integer, so thousands of items tie across
    # chunks and the order is decided by the index alone
    for dtype in ("f32", "bf16"):
        q64, itf, _, _ = _slab(rng, dtype, integer=True)
        for k in (128, 1024, N_ITEMS):
            _compare((q64, itf, None, None, None, None), k, True, tally,
                     f"ties {dtype} k={k}")
    report["sweep"] = dict(tally, seconds=time.perf_counter() - t0)
    print(f"[sweep] {tally['cases']} cases, indices equal in all, values "
          f"bit-equal in {tally['bit_equal']}, max |kernel - plain| "
          f"{tally['max_abs_err']:.3g}, {report['sweep']['seconds']:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 4: the main path, served
# ---------------------------------------------------------------------------


def _queries(rng, n_users):
    qs = []
    for _ in range(N_QUERIES):
        q = {"user": f"u{int(rng.integers(n_users))}",
             "num": int(rng.choice([5, 10, 20, 50, 200]))}
        r = rng.random()
        if r < 0.2:
            q["blacklist"] = [f"i{int(x)}" for x in
                              rng.integers(0, N_ITEMS, int(rng.integers(3, 11)))]
        elif r < 0.3:
            q["whitelist"] = [f"i{int(x)}" for x in rng.integers(0, N_ITEMS, 50)]
        qs.append(q)
    return qs


def _client(port, bodies, out, lock):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        for n, body in bodies:
            t0 = time.perf_counter()
            conn.request("POST", "/queries.json", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = resp.read()
            dt = time.perf_counter() - t0
            with lock:
                out[n] = (resp.status, json.loads(payload), dt)
    finally:
        conn.close()


def _status(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def phase_serve(report):
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    uf = (rng.standard_normal((N_USERS, RANK)) / np.sqrt(RANK)).astype(np.float32)
    itf = (rng.standard_normal((N_ITEMS, RANK)) / np.sqrt(RANK)).astype(np.float32)
    blob = convert.als_factors_from_numpy(
        uf, itf, [f"u{n}" for n in range(N_USERS)],
        [f"i{n}" for n in range(N_ITEMS)], {"rank": RANK},
    ).to_bytes()
    factors = convert.load_jax_als_blob(blob)
    check(np.array_equal(factors.item_factors, itf), "blob round trip")
    setup_s = time.perf_counter() - t0
    params = ALSAlgorithmParams(rank=RANK)
    server = QueryServer(
        ALSAlgorithm(params), ALSModel(factors),
        QueryServerConfig(ip="127.0.0.1", port=0),
    )
    t0 = time.perf_counter()
    port = server.start()  # warms up: stages the slab, runs the ladder
    warm_s = time.perf_counter() - t0
    try:
        queries = _queries(rng, N_USERS)
        before = _status(port)
        out: dict = {}
        lock = threading.Lock()
        work = list(enumerate(queries))
        threads = [threading.Thread(target=_client,
                                    args=(port, work[c::N_CLIENTS], out, lock))
                   for c in range(N_CLIENTS)]
        rec.LAUNCHES = 0  # every count to 0 just before the main path
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = rec.LAUNCHES
        check(not any(t.is_alive() for t in threads), "clients hung")
        after = _status(port)
        batches = after["batches"] - before["batches"]
        batch_s = (after["batch_predict_seconds"]
                   - before["batch_predict_seconds"])
    finally:
        server.stop()
    check(server._thread is None, "server thread not joined")
    check(len(out) == N_QUERIES, f"{len(out)} of {N_QUERIES} answered")
    # the plain version on the CPU from the same factors
    cpu_model = ALSModel(factors, device="cpu")
    cpu_alg = ALSAlgorithm(params)
    from predictionio_tpu_torch.engines.recommendation.engine import Query

    for n, q in enumerate(queries):
        status, body, _ = out[n]
        check(status == 200, f"query {n}: HTTP {status} {body}")
        expected = _to_jsonable(cpu_alg.predict(cpu_model, Query(**q)))
        check(body == expected, f"query {n} ({q}) differs from the CPU plain version")
        if "whitelist" not in q:
            check(len(body["item_scores"]) == q["num"], f"query {n}: length")
    lat = sorted(v[2] for v in out.values())
    check(launches > 0, "the main path launched no kernel")
    check(launches == batches,
          f"kernel launches {launches} != device batches {batches}")
    report["serve"] = {
        "setup_s": setup_s, "warmup_s": warm_s, "wall_s": wall,
        "qps": N_QUERIES / wall,
        "p50_ms": 1e3 * lat[len(lat) // 2],
        "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "batches": batches, "launches": launches,
        "mean_batch": N_QUERIES / batches,
        "batch_predict_ms": 1e3 * batch_s / batches,
        "requests": after["requests"] - before["requests"],
    }
    s = report["serve"]
    print(f"[serve] {N_QUERIES} queries from {N_CLIENTS} clients, all equal to "
          f"the CPU plain version: p50 {s['p50_ms']:.3f} ms, p99 "
          f"{s['p99_ms']:.3f} ms, {s['qps']:.1f} qps, {batches} batches "
          f"(mean {s['mean_batch']:.2f} queries, {s['batch_predict_ms']:.3f} "
          f"ms of batch_predict each), kernel launches {launches}; warmup "
          f"{warm_s:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def _time_ms(fn, iters, repeats=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / iters)
    return statistics.median(per)


def _bound(dtype, b, i_p, k, scaled):
    esz = {"f32": 4, "bf16": 2, "int8": 1}[dtype]
    nbytes = (b + i_p) * RANK * esz + b * k * 8
    if scaled:
        nbytes += (b + i_p) * 4
    dot_s = 2.0 * b * i_p * RANK / PEAK_OPS[dtype]
    scale_s = (2.0 * b * i_p / PEAK_OPS["f32"]) if scaled else 0.0
    bytes_s = nbytes / HBM_BPS
    ops_s = dot_s + scale_s
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def phase_times(report):
    rng = np.random.default_rng(SEED + 1)
    i_p = rec.pad_items(N_ITEMS)
    rows = []
    for dtype in ("f32", "bf16", "int8"):
        q64, itf, qs8, isc8 = _slab(rng, dtype)
        lib_it = itf.float() if dtype == "int8" else itf
        for b in (1, 64):
            q = q64[:b].contiguous()
            qs = None if qs8 is None else qs8[:b].contiguous()
            args = (q, itf, qs, isc8)
            lib_q = q.float() if dtype == "int8" else q
            kernel = _time_ms(
                lambda: rec.fused_recommend_topk(*args, k=128, n_items=N_ITEMS), 50)
            plain = _time_ms(
                lambda: rec.fused_recommend_topk_plain(
                    *args, None, None, k=128, n_items=N_ITEMS), 10)
            library = _time_ms(
                lambda: torch.topk(lib_q @ lib_it.T, 128, dim=1), 50)
            bound, by = _bound(dtype, b, i_p, 128, dtype == "int8")
            rows.append({"dtype": dtype, "B": b, "k": 128, "ms": kernel,
                         "plain_ms": plain, "library_ms": library,
                         "bound_ms": bound, "bound_by": by})
            print(f"[times] {dtype} B={b} k=128: kernel {kernel:.4f} ms, plain "
                  f"{plain:.4f} ms, torch.topk(q@itf.T) {library:.4f} ms, bound "
                  f"{bound:.5f} ms ({by})", flush=True)
    report["times"] = rows


def main() -> int:
    if _IMPORT_ERROR is not None:
        print(f"chip_smoke: the port is not importable here ({_IMPORT_ERROR}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    report: dict = {}
    for name, phase in (("device", phase_device), ("build", phase_build),
                        ("sweep", phase_sweep), ("serve", phase_serve),
                        ("times", phase_times)):
        try:
            phase(report)
        except Exception:  # noqa: BLE001 — report the phase, then fail
            traceback.print_exc()
            print(f"FAILED phase {name}", flush=True)
            return 1
    main_row = next(r for r in report["times"]
                    if r["dtype"] == "f32" and r["B"] == 64)
    kernels = {"kernels": [{
        "name": "fused_recommend_topk", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": report["serve"]["launches"],
        "max_abs_err": report["sweep"]["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(report["nvidia_smi"])
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
