#!/usr/bin/env python3
"""Drive the PyTorch port's train and serve paths on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure prints what failed and exits non-zero:

1. device   needs CUDA; prints the card's name and power limit
            (nvidia-smi) and turns TF32 off.
2. build    compiles every ``predictionio_tpu_torch/ops/csrc/*.cu`` into
            ``build/kernels/`` (one nvcc per source, all started
            together) and loads the libraries.
3. sweep    the fused score+top-k kernel against its plain PyTorch
            version on the card, at the ML-20M item slab: f32/bf16/int8,
            no mask / packed bits / row list, unscaled and scaled,
            B in {1, 8, 64}, k in {1, 10, 128, 1024, n_items}, a fully
            masked row, crafted cross-chunk ties on integer-valued
            factors, and B=1 vs B=64 bit-identity. Indices must be equal;
            values within rtol 1e-5 (the kernel and the plain version do
            the same rounded operations, so they are in fact equal).
4. data     ML-20M-shaped ratings from SEED with numpy: 138,493 users x
            26,744 items, 20,000,263 unique pairs with skewed degrees
            anchored on ML-20M's published counts (users 20 to 9,254
            ratings, items up to 67,310), half-star ratings 0.5-5.0 (so
            staging picks int8 storage with scale 2).
5. dense    the dense ALS row/col pass kernels against their plain
            versions on the card: implicit and explicit, signed ratings,
            scale in {1, 2, 10}, K in {1, 8, 10, 32} at 2048 x 256, and
            the full ML-20M slab (139,264 x 26,880 int8, K = 10,
            implicit). Per element |kernel - plain| <= 1e-5 * S, S the
            same pass over the absolute terms; a second launch must give
            the same bits.
6. train    the main path: ``ALSAlgorithm.train`` on the phase-4 data at
            the template defaults with 5 iterations. Both pass kernels
            must launch once per iteration, every factor must be finite,
            and the same train through the plain passes on the card, from
            the same seeded init, must correlate > 0.9999 (users and
            items). Prints gate, staging, densify and per-iteration
            seconds, all from the one main-path call.
7. serve    the trained factors, through ``to_bytes`` and
            ``convert.load_jax_als_blob`` (as ``console train`` then
            ``console deploy`` would), served by the port's
            ``QueryServer`` on the card; 16 client threads send 500
            ``POST /queries.json`` (some with blacklists or whitelists).
            Every answer must equal the plain version's on the CPU;
            kernel launches must equal device batches.
8. times    CUDA-event medians: top-k at B in {1, 64}, k=128, per dtype
            (kernel, plain, ``torch.topk(q @ itf.T)`` as a yardstick the
            port never calls, bound); the dense passes at the ML-20M slab,
            K = 10 (kernel, plain, the port's two-matmul ``ops.dense``
            pass on the same R in bf16 storage as the yardstick, bound),
            and the kernel again on a uniform R with as many ratings.
9. report   one ``{"kernels": [...]}`` line, then the device line last.

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
    from predictionio_tpu_torch.data.store.bimap import BiMap
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        ALSModel,
        RuntimeContext,
        TrainingData,
    )
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import _build, dense
    from predictionio_tpu_torch.ops import dense_fused as df
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
N_EDGES = 20_000_263  # ML-20M's unique (user, item) ratings
# fewest and most ratings of a user and of an item in ML-20M
USER_DEGREES, ITEM_DEGREES = (20, 9_254), (1, 67_310)
TRAIN_ITERATIONS = 5
K_LADDER = (1, 10, 128, 1024, N_ITEMS)
N_QUERIES, N_CLIENTS = 500, 16
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# operations/s per operand type (f32 on CUDA cores, bf16/int8 tensor cores)
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
SOURCE = "predictionio_tpu_torch/ops/csrc/recommend_topk.cu"
REPLACES = "predictionio_tpu/ops/recommend_pallas.py:412"
DENSE_SOURCE = "predictionio_tpu_torch/ops/csrc/dense_pass.cu"
DENSE_REPLACES = {"row": "predictionio_tpu/ops/dense_pallas.py:122",
                  "col": "predictionio_tpu/ops/dense_pallas.py:175"}
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device(report, shared):
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


def phase_build(report, shared):
    t0 = time.perf_counter()
    paths = _build.build()
    rec._kernel_lib()
    df._kernel_lib()
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


def phase_sweep(report, shared):
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
# phase 4: ML-20M-width ratings
# ---------------------------------------------------------------------------


def _degree_targets(n, total, lo, hi):
    """n integer degrees summing to `total`, each in [lo, hi]: lo plus
    the lognormal quantiles exp(mu + sigma * z_k), z_k the normal
    quantile of (k + 1/2) / n, with mu and sigma set so that the largest
    is hi and the sum is total."""
    inv = statistics.NormalDist().inv_cdf
    z = np.array([inv((k + 0.5) / n) for k in range(n)])
    span, target = hi - lo, (total - n * lo) / n  # the lognormal part's max, mean
    low, high = 0.0, 20.0  # sigma: the mean falls as sigma grows
    for _ in range(100):
        sigma = (low + high) / 2
        if span * np.exp(sigma * (z - z[-1])).mean() > target:
            low = sigma
        else:
            high = sigma
    d = lo + span * np.exp(sigma * (z - z[-1]))
    base = np.floor(d).astype(np.int64)
    extra = total - int(base.sum())  # largest remainders take one more
    base[np.argsort(base - d)[:extra]] += 1
    return base


def _pairs_with_degrees(rng, d_user, d_item, max_rounds=500):
    """Unique (user, item) pairs, as keys user * n_items + item, in which
    user u has exactly d_user[u] items and item i exactly d_item[i]
    users: the configuration model (item stubs shuffled against user
    stubs), then each repeated pair swaps items with a random other pair
    where both new pairs are new, which keeps every degree."""
    n_users, n_items = len(d_user), len(d_item)
    u = np.repeat(np.arange(n_users, dtype=np.int64), d_user)
    it = rng.permutation(np.repeat(np.arange(n_items, dtype=np.int64), d_item))
    key = u * n_items + it
    order = np.argsort(key, kind="stable")
    repeat = np.zeros(len(key), bool)
    repeat[order[1:]] = key[order[1:]] == key[order[:-1]]
    pending = np.flatnonzero(repeat)  # edges whose pair an earlier edge holds
    present = np.unique(key)  # sorted: the pairs held
    del order, repeat

    def held(keys, table):
        pos = np.searchsorted(table, keys)
        return table[np.minimum(pos, len(table) - 1)] == keys

    for rounds in range(1, max_rounds + 1):
        if not len(pending):
            return np.sort(u * n_items + it), rounds - 1
        partner = rng.integers(0, len(key), len(pending))
        p_key = u[partner] * n_items + it[partner]
        new_a = u[pending] * n_items + it[partner]  # the repeated pair's user
        new_b = u[partner] * n_items + it[pending]  # the partner's user
        ok = ~held(new_a, present) & ~held(new_b, present) & (new_a != new_b)
        # a partner must hold its pair alone and take part in one swap
        ok &= ~held(p_key, np.sort(u[pending] * n_items + it[pending]))
        _, first, count = np.unique(partner, return_index=True, return_counts=True)
        once = np.zeros(len(pending), bool)
        once[first[count == 1]] = True
        ok &= once
        new = np.concatenate([new_a[ok], new_b[ok]])
        _, inv, count = np.unique(new, return_inverse=True, return_counts=True)
        clash = (count[inv] > 1).reshape(2, -1).any(axis=0)
        idx = np.flatnonzero(ok)[~clash]
        a, b = pending[idx], partner[idx]
        gone = p_key[idx]
        present = np.delete(present, np.searchsorted(present, gone))
        added = np.sort(np.concatenate([new_a[idx], new_b[idx]]))
        present = np.insert(present, np.searchsorted(present, added), added)
        it[a], it[b] = it[b], it[a].copy()
        keep = np.ones(len(pending), bool)
        keep[idx] = False
        pending = pending[keep]
    raise PhaseError(f"{len(pending)} repeated pairs left after {max_rounds} rounds")


def _tile_load(deg, tile):
    """Largest and mean ratings per tile of `tile` consecutive ids."""
    per = np.add.reduceat(deg, np.arange(0, len(deg), tile))
    return int(per.max()), float(per.mean())


def phase_data(report, shared):
    """ML-20M's shape from SEED: N_EDGES unique (user, item) pairs with
    ML-20M's skewed degrees, half-star ratings 0.5-5.0 drawn uniformly.

    Degrees are lognormal quantiles anchored on ML-20M's published
    counts (GroupLens ML-20M README: 138,493 users, 20,000,263 ratings,
    every user has at least 20; the most-rated movie, Pulp Fiction, has
    67,310 ratings and the most active user 9,254): users 20 + a
    lognormal part with mean 144.4 and top 9,254, items 1 + a lognormal
    part with mean 747.8 and top 67,310. Both sequences are shuffled
    over the ids, as ML-20M's ids are not in order of activity, and the
    pairs hold both exactly."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    d_user = rng.permutation(_degree_targets(N_USERS, N_EDGES, *USER_DEGREES))
    d_item = rng.permutation(_degree_targets(N_ITEMS, N_EDGES, *ITEM_DEGREES))
    keys, rounds = _pairs_with_degrees(rng, d_user, d_item)
    check(len(keys) == N_EDGES, f"{len(keys)} unique pairs drawn, not {N_EDGES}")
    rows = (keys // N_ITEMS).astype(np.int32)
    cols = (keys % N_ITEMS).astype(np.int32)
    del keys
    vals = (rng.integers(1, 11, N_EDGES) / 2.0).astype(np.float32)
    check(dense.int8_scale(vals) == 2.0, "half-star ratings must stage as int8, s=2")
    shared["coo"] = (rows, cols, vals)
    u_deg = np.bincount(rows, minlength=N_USERS)
    i_deg = np.bincount(cols, minlength=N_ITEMS)
    check(np.array_equal(u_deg, d_user) and np.array_equal(i_deg, d_item),
          "degrees differ from their targets")
    row_tile, col_tile = _tile_load(u_deg, 64), _tile_load(i_deg, 32)
    report["data"] = {
        "users": N_USERS, "items": N_ITEMS, "edges": N_EDGES,
        "user_degree": {"min": int(u_deg.min()), "median": float(np.median(u_deg)),
                        "max": int(u_deg.max())},
        "item_degree": {"min": int(i_deg.min()), "median": float(np.median(i_deg)),
                        "max": int(i_deg.max())},
        # ratings per CTA of the row pass (64 users) and col pass (32 items)
        "row_tile_max_mean": row_tile, "col_tile_max_mean": col_tile,
        "swap_rounds": rounds, "seconds": time.perf_counter() - t0,
    }
    d = report["data"]
    print(f"[data] {N_USERS} users x {N_ITEMS} items, {N_EDGES} unique "
          f"ratings, ML-20M-skewed degrees: users min/median/max "
          f"{d['user_degree']['min']}/{d['user_degree']['median']:.0f}/"
          f"{d['user_degree']['max']}, items min/median/max "
          f"{d['item_degree']['min']}/{d['item_degree']['median']:.0f}/"
          f"{d['item_degree']['max']}; ratings per "
          f"64-user tile max {row_tile[0]} mean {row_tile[1]:.0f}, per 32-item "
          f"tile max {col_tile[0]} mean {col_tile[1]:.0f}; {rounds} swap "
          f"rounds, {d['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 5: dense pass kernels vs plain versions on the card
# ---------------------------------------------------------------------------


def _dense_compare(r, x, ascale, implicit, which, tally, label):
    fn = df.fused_row_pass if which == "row" else df.fused_col_pass
    plain = df.fused_row_pass_plain if which == "row" else df.fused_col_pass_plain
    kb, kc = fn(r, x, ascale, implicit=implicit)
    kb2, kc2 = fn(r, x, ascale, implicit=implicit)
    pb, pc = plain(r, x, ascale, implicit=implicit)
    sb, sc = plain(r, x, ascale, implicit=implicit, magnitude=True)
    torch.cuda.synchronize()
    check(torch.equal(kb, kb2) and torch.equal(kc, kc2),
          f"{label}: a second launch gave other bits")
    for got, want, mag, what in ((kb, pb, sb, "b"), (kc, pc, sc, "corr")):
        check(bool(torch.isfinite(got).all()), f"{label} {what}: not finite")
        err = (got - want).abs()
        ratio = float((err / (1e-5 * mag).clamp_min(1e-30)).max())
        check(bool((err <= 1e-5 * mag).all()),
              f"{label} {what}: |kernel - plain| beyond 1e-5*S "
              f"(ratio {ratio:.3g})")
        t = tally[which]
        t["max_abs_err"] = max(t["max_abs_err"], float(err.max()))
        t["max_ratio"] = max(t["max_ratio"], ratio)
    tally[which]["cases"] += 1


def _small_ratings(rng, scale, n_rows=2048, n_cols=256, density=0.05):
    """Signed ratings on the scale's grid (integers, halves, tenths in
    [-5, 5], no zeros), densified on the card as int8 round(r * s)."""
    mask = rng.random((n_rows, n_cols)) < density
    rows, cols = np.nonzero(mask)
    steps = rng.integers(1, int(5 * scale) + 1, len(rows))
    vals = (steps / scale * rng.choice([-1.0, 1.0], len(rows))).astype(np.float32)
    return dense.densify(
        torch.from_numpy(rows).cuda(), torch.from_numpy(cols).cuda(),
        torch.from_numpy(vals).cuda(), n_rows_p=n_rows, n_cols_p=n_cols,
        dense_dtype="int8", scale=scale)


def phase_dense(report, shared):
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    tally = {w: {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0}
             for w in ("row", "col")}
    for scale in (1.0, 2.0, 10.0):
        r = _small_ratings(rng, scale)
        for implicit in (True, False):
            # alpha 1.7: 1 + a*q exercises the weights' bf16 rounding
            ascale = float(np.float32(1.7 / scale if implicit else 1.0 / scale))
            for k in (1, 8, 10, 32):
                for which in ("row", "col"):
                    n_side = r.shape[1] if which == "row" else r.shape[0]
                    x = torch.from_numpy((rng.standard_normal((n_side, k))
                                          / np.sqrt(k)).astype(np.float32)).cuda()
                    _dense_compare(r, x, ascale, implicit, which, tally,
                                   f"{which} implicit={implicit} s={scale} K={k}")
    # the full ML-20M slab, as staging lays it out
    rows, cols, vals = shared["coo"]
    n_u_p = -(-N_USERS // dense.ROW_BLOCK) * dense.ROW_BLOCK
    n_i_p = -(-N_ITEMS // dense.COL_PAD) * dense.COL_PAD
    r = dense.densify(
        torch.from_numpy(rows).cuda().long(), torch.from_numpy(cols).cuda().long(),
        torch.from_numpy(vals).cuda(), n_rows_p=n_u_p, n_cols_p=n_i_p,
        dense_dtype="int8", scale=2.0)
    shared["slab"] = r
    ascale = float(np.float32(1.0 / 2.0))  # alpha 1.0 / s 2
    for which, n_side in (("row", n_i_p), ("col", n_u_p)):
        x = torch.from_numpy((rng.standard_normal((n_side, RANK))
                              / np.sqrt(RANK)).astype(np.float32)).cuda()
        _dense_compare(r, x, ascale, True, which, tally,
                       f"ML-20M slab {n_u_p}x{n_i_p} {which}")
    report["dense_sweep"] = dict(tally, seconds=time.perf_counter() - t0)
    for w in ("row", "col"):
        t = tally[w]
        print(f"[dense] {w} pass: {t['cases']} cases within 1e-5*S, second "
              f"launch bit-equal in all; max |kernel - plain| "
              f"{t['max_abs_err']:.3g}, largest |kernel - plain| / (1e-5*S) "
              f"{t['max_ratio']:.3g}", flush=True)


# ---------------------------------------------------------------------------
# phase 6: the main path, trained
# ---------------------------------------------------------------------------


class _PlainPasses:
    """Route the dense half-step through the plain pass versions (on the
    card) for the comparison train; restores the wrappers on exit."""

    def __enter__(self):
        self.saved = (df.fused_row_pass, df.fused_col_pass)
        df.fused_row_pass = df.fused_row_pass_plain
        df.fused_col_pass = df.fused_col_pass_plain

    def __exit__(self, *exc):
        df.fused_row_pass, df.fused_col_pass = self.saved


class _Observed:
    """Around the main-path train: time the dense gate and keep the
    StagedDenseTrain it builds, so that neither runs a second time for
    the breakdown and the plain comparison."""

    def __enter__(self):
        self.saved = (als.dense_eligible, als.stage_dense)
        gate, stage = self.saved

        def timed_gate(*args, **kwargs):
            t0 = time.perf_counter()
            out = gate(*args, **kwargs)
            self.gate_s = time.perf_counter() - t0
            return out

        def kept_stage(*args, **kwargs):
            self.staged = stage(*args, **kwargs)
            return self.staged

        als.dense_eligible, als.stage_dense = timed_gate, kept_stage
        return self

    def __exit__(self, *exc):
        als.dense_eligible, als.stage_dense = self.saved


def _corr(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def phase_train(report, shared):
    rows, cols, vals = shared["coo"]
    td = TrainingData(
        rows=rows, cols=cols, vals=vals, n_users=N_USERS, n_items=N_ITEMS,
        user_vocab=BiMap({f"u{n}": n for n in range(N_USERS)}),
        item_vocab=BiMap({f"i{n}": n for n in range(N_ITEMS)}),
    )
    td.sanity_check()
    params = ALSAlgorithmParams(num_iterations=TRAIN_ITERATIONS)  # template defaults
    df.PASS_LAUNCHES.update(row=0, col=0)  # every count to 0 just before the main path
    with _Observed() as seen:
        t0 = time.perf_counter()
        model = ALSAlgorithm(params).train(RuntimeContext(), td)
        train_s = time.perf_counter() - t0
    launches = dict(df.PASS_LAUNCHES)
    f = model.factors
    check(launches["row"] == launches["col"] == TRAIN_ITERATIONS,
          f"pass kernel launches {launches} != one row and one col pass "
          f"per iteration ({TRAIN_ITERATIONS})")
    check(f.user_factors.shape == (N_USERS, RANK)
          and f.item_factors.shape == (N_ITEMS, RANK), "factor shapes")
    check(bool(np.isfinite(f.user_factors).all()
               and np.isfinite(f.item_factors).all()), "non-finite factors")
    shared["factors"] = f
    del model

    # breakdown and the plain comparison, from the main path's staging
    staged, gate_s = seen.staged, seen.gate_s
    check(staged.dense_dtype == "int8" and staged.static_kwargs["scale"] == 2.0,
          "staging did not pick int8, s=2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uf, itf = staged.factors(*staged.run())
    run_s = time.perf_counter() - t0
    check(np.array_equal(uf, f.user_factors) and np.array_equal(itf, f.item_factors),
          "a second kernel train from the same seed gave other factors")
    with _PlainPasses():
        t0 = time.perf_counter()
        puf, pitf = staged.factors(*staged.run())
        plain_s = time.perf_counter() - t0
    host_prep_s, densify_s = staged.host_prep_sec, staged.transfer_sec
    del staged, seen
    cu, ci = _corr(f.user_factors, puf), _corr(f.item_factors, pitf)
    du = float(np.abs(f.user_factors - puf).max())
    di = float(np.abs(f.item_factors - pitf).max())
    check(cu > 0.9999 and ci > 0.9999,
          f"kernel vs plain train: corrcoef users {cu}, items {ci}")
    report["train"] = {
        "iterations": TRAIN_ITERATIONS, "rank": RANK, "edges": N_EDGES,
        "main_path_s": train_s, "launches": launches, "gate_s": gate_s,
        "staging_s": host_prep_s + densify_s,
        "host_prep_s": host_prep_s, "densify_s": densify_s,
        "per_iteration_s": run_s / TRAIN_ITERATIONS,
        "plain_per_iteration_s": plain_s / TRAIN_ITERATIONS,
        "corr_users": cu, "corr_items": ci,
        "max_abs_diff_users": du, "max_abs_diff_items": di,
    }
    t = report["train"]
    print(f"[train] ALSAlgorithm.train at ML-20M width ({N_EDGES} ratings, rank "
          f"{RANK}, {TRAIN_ITERATIONS} iterations, int8 s=2): {train_s:.2f} s "
          f"end to end; pass kernel launches row {launches['row']} col "
          f"{launches['col']}; gate (dense_eligible) {gate_s:.2f} s, staging "
          f"{t['staging_s']:.2f} s (host prep "
          f"{t['host_prep_s']:.2f} s, copy + densify {t['densify_s']:.3f} s), "
          f"{t['per_iteration_s']:.4f} s per iteration (plain passes "
          f"{t['plain_per_iteration_s']:.4f} s); vs the plain-pass train: "
          f"corrcoef users {cu:.8f} items {ci:.8f}, max |diff| users "
          f"{du:.3g} items {di:.3g}", flush=True)


# ---------------------------------------------------------------------------
# phase 7: the trained factors, served
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


def phase_serve(report, shared):
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    trained = shared["factors"]  # phase 6's ALSFactors
    blob = trained.to_bytes()  # what ``console train`` writes
    factors = convert.load_jax_als_blob(blob)  # what ``console deploy`` reads
    check(np.array_equal(factors.item_factors, trained.item_factors)
          and np.array_equal(factors.user_factors, trained.user_factors),
          "blob round trip")
    check(factors.user_vocab.to_dict() == trained.user_vocab.to_dict(),
          "blob round trip: user ids")
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
# phase 8: times
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


def phase_times(report, shared):
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


def _dense_bound(n_rows, n_cols, k, which):
    """Least time for one pass: R read once, the factor input read once,
    both outputs written once, over HBM; or the dense-equivalent
    2*n_r*n_c*(K+K^2) operations at the bf16 tensor-core peak."""
    n_in, n_out = (n_cols, n_rows) if which == "row" else (n_rows, n_cols)
    nbytes = n_rows * n_cols + n_in * k * 4 + n_out * (k + k * k) * 4
    ops = 2.0 * n_rows * n_cols * (k + k * k)
    bytes_s, ops_s = nbytes / HBM_BPS, ops / PEAK_OPS["bf16"]
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def _uniform_slab(like):
    """R of the main path's shape, on its device, with the same expected
    number of ratings (half-stars, stored x2) at one density everywhere:
    the load the skewed data is compared with."""
    dev = like.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    density = N_EDGES / (N_USERS * N_ITEMS)
    r = torch.zeros_like(like)
    for s in range(0, N_USERS, dense.ROW_BLOCK):
        e = min(s + dense.ROW_BLOCK, N_USERS)
        live = torch.rand((e - s, N_ITEMS), generator=gen, device=dev) < density
        q = torch.randint(1, 11, (e - s, N_ITEMS), generator=gen, device=dev,
                          dtype=torch.int8)
        r[s:e, :N_ITEMS] = q * live
    return r


def phase_dense_times(report, shared):
    rng = np.random.default_rng(SEED + 3)
    r = shared.pop("slab")  # the main path's ratings
    n_rows, n_cols = r.shape
    ru = _uniform_slab(r)
    report["uniform_slab_ratings"] = int(torch.count_nonzero(ru))
    # the yardstick's storage: the same ratings as bf16 (r = q / 2, exact)
    r16 = torch.empty((n_rows, n_cols), dtype=torch.bfloat16, device=r.device)
    for s in range(0, n_rows, dense.ROW_BLOCK):
        r16[s : s + dense.ROW_BLOCK] = (r[s : s + dense.ROW_BLOCK].float() / 2.0
                                        ).to(torch.bfloat16)
    r0 = torch.zeros_like(r)
    ascale = float(np.float32(1.0 / 2.0))
    rows = []
    for which, n_side in (("row", n_cols), ("col", n_rows)):
        x = torch.from_numpy((rng.standard_normal((n_side, RANK))
                              / np.sqrt(RANK)).astype(np.float32)).cuda()
        fn = df.fused_row_pass if which == "row" else df.fused_col_pass
        plain = df.fused_row_pass_plain if which == "row" else df.fused_col_pass_plain
        lib = dense.dense_row_pass if which == "row" else dense.dense_col_pass
        kernel = _time_ms(lambda: fn(r, x, ascale, implicit=True), 5, repeats=5)
        uniform = _time_ms(lambda: fn(ru, x, ascale, implicit=True), 5, repeats=5)
        # the same pass over an all-zero R: the tile stream and the scan
        # alone, no per-rating work (a diagnostic, not a yardstick)
        zero = _time_ms(lambda: fn(r0, x, ascale, implicit=True), 5, repeats=5)
        plain_ms = _time_ms(lambda: plain(r, x, ascale, implicit=True), 1, repeats=3)
        library = _time_ms(lambda: lib(r16, x, implicit=True, alpha=1.0),
                           1, repeats=3)
        bound, by = _dense_bound(n_rows, n_cols, RANK, which)
        rows.append({"pass": which, "n_rows": n_rows, "n_cols": n_cols, "K": RANK,
                     "ms": kernel, "uniform_ms": uniform, "zero_r_ms": zero,
                     "plain_ms": plain_ms,
                     "library_ms": library,
                     "bound_ms": bound, "bound_by": by})
        print(f"[times] dense {which} pass {n_rows}x{n_cols} int8, K={RANK}: "
              f"kernel {kernel:.4f} ms on the main path's skewed R (uniform R "
              f"{uniform:.4f} ms, all-zero R {zero:.4f} ms), plain "
              f"{plain_ms:.4f} ms, ops.dense "
              f"two-matmul on bf16 R {library:.4f} ms, bound {bound:.4f} ms "
              f"({by})", flush=True)
    del r16, r, r0, ru
    report["dense_times"] = rows


def main() -> int:
    if _IMPORT_ERROR is not None:
        print(f"chip_smoke: the port is not importable here ({_IMPORT_ERROR}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    report: dict = {}
    shared: dict = {}
    t_start = time.perf_counter()
    for name, phase in (("device", phase_device), ("build", phase_build),
                        ("sweep", phase_sweep), ("data", phase_data),
                        ("dense", phase_dense), ("train", phase_train),
                        ("serve", phase_serve), ("times", phase_times),
                        ("dense times", phase_dense_times)):
        try:
            phase(report, shared)
        except Exception:  # noqa: BLE001 — report the phase, then fail
            traceback.print_exc()
            print(f"FAILED phase {name}", flush=True)
            return 1
    report["seconds"] = time.perf_counter() - t_start
    main_row = next(r for r in report["times"]
                    if r["dtype"] == "f32" and r["B"] == 64)
    kernels = [{
        "name": "fused_recommend_topk", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": report["serve"]["launches"],
        "max_abs_err": report["sweep"]["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    for row in report["dense_times"]:
        which = row["pass"]
        kernels.append({
            "name": f"fused_{which}_pass", "route": "cuda",
            "source": DENSE_SOURCE, "replaces": DENSE_REPLACES[which],
            "launches": report["train"]["launches"][which],
            "max_abs_err": report["dense_sweep"][which]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"[done] {report['seconds']:.1f} s", flush=True)
    print(report["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
