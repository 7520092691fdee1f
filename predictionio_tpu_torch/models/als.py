"""ALS: training, factor persistence, staged serving state and the
serving verbs.

Counterpart of the JAX package's ``models/als.py``. Factors persist in
the same npz format, so a blob written by the JAX package's
``ALSFactors.to_bytes`` loads here and one written here loads there.

``train`` takes the path the JAX package's gate picks for the same
input:

- dense-W (``dense_eligible`` → ``stage_dense`` → the alternating loop
  of ``_dense_half_step``): the rating matrix lives dense on the device
  and each half-step is one edge pass over it plus the batched CG
  solve. int8 storage runs the edge pass through ``ops.dense_fused`` (a
  hand-written kernel on the card); f32 and bf16 storage through
  ``ops.dense``.
- windowed, rank ≤ 32 (``stage_windowed`` → the loop of
  ``_half_step_windowed``): the edges, blocked by ``ops.windowed.
  plan_windows``, live on the device; each half-step is one windowed
  edge pass (``ops.windowed_fused``, hand-written kernels on the card)
  plus the batched CG solve. It sums repeated (user, item) pairs.
- scatter, rank > 32 (the loop of ``_half_step_implicit`` /
  ``_half_step_explicit``): matrix-free CG over the dst-sorted edge
  list with ``ops.segment``'s gather and ``index_add_`` sums.

``train_grid`` trains a tuning grid over one staging of the data (the
evaluation workflow's grid path): each point runs the staged loop with
its own params and equals a serial ``train`` of them bit for bit.

``warm_start_factors`` maps a parent model's factors onto a new
training vocabulary (a retrain's warm start, the JAX package's function
bit for bit); ``train`` takes them as ``init_factors``.

Serving stages the factor matrices on a device once (padded to
``ITEM_PAD`` rows, quantized for int8); every verb then sends only the
row ids and, when filters apply, the packed exclusion words or row
list, and runs ``ops.recommend.fused_recommend_topk``.

The online fold-in re-solves a tick's dirty rows against the fixed
opposite side (``fold_in_rows``, torch einsums and the batched CG: the
JAX package leaves it to XLA, so no kernel of its own) and publishes
them into the staged state row by row (``serving_publish_rows``,
copy-on-write off shared tables).

The device functions are instrumented for ``obs.devprof`` under the JAX
package's names: the train loops (``als.train_dense``,
``als.train_windowed``, ``als.train_edge``, per iteration), the grids
(``als.train_dense_grid``, ``als.train_windowed_grid``), the serving
verbs (``als.recommend_serving``, ``als.similar_serving``,
``als.similar_vecs_serving``), the publish's row writes
(``als.publish_rows_cow``/``_donated``, ``als.publish_cols_cow``/
``_donated``) and the fold (``als.fold_in``).
"""

from __future__ import annotations

import io
import json
import logging
import math
import time
from dataclasses import dataclass, field
from itertools import chain
from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.data.store.bimap import BiMap
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.obs import costs, devprof
from predictionio_tpu_torch.ops import dense, dense_fused
from predictionio_tpu_torch.ops import recommend as _rp
from predictionio_tpu_torch.ops.segment import (
    batched_cg,
    chunked_edge_matvec,
    chunked_gram_edge_sum,
    chunked_weighted_edge_sum,
    f32_gram,
    full_f32,
)
from predictionio_tpu_torch.ops.windowed import (
    WINDOW_ROWS,
    flat_gram_matvec,
    plan_windows,
    windowed_gram_b,
)
from predictionio_tpu_torch.utils.env import env_int, env_str

log = logging.getLogger(__name__)

# ranks up to this solve via explicitly built per-row K×K operators (one
# edge pass per half-step); beyond it the matrix-free CG scatter path
# takes over
GRAM_SOLVER_MAX_RANK = 32


@dataclass(frozen=True)
class ALSParams:
    rank: int = 10
    iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0  # implicit confidence scale
    implicit_prefs: bool = True
    cg_iterations: int = 3
    seed: int = 3
    # max edges per device program step in training
    edge_chunk_size: int = 1 << 21


@dataclass
class ALSFactors:
    """Trained factor matrices + id vocabularies."""

    user_factors: np.ndarray  # (U, K) float32
    item_factors: np.ndarray  # (I, K) float32
    user_vocab: BiMap  # user id → row
    item_vocab: BiMap  # item id → row
    params: ALSParams = field(default_factory=ALSParams)

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.savez_compressed(
            buf,
            user_factors=self.user_factors,
            item_factors=self.item_factors,
            user_ids=np.array(list(self.user_vocab.to_dict().keys()), dtype=object),
            user_idx=np.array(list(self.user_vocab.to_dict().values()), dtype=np.int64),
            item_ids=np.array(list(self.item_vocab.to_dict().keys()), dtype=object),
            item_idx=np.array(list(self.item_vocab.to_dict().values()), dtype=np.int64),
            params=np.frombuffer(
                json.dumps(self.params.__dict__).encode(), dtype=np.uint8
            ),
        )
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "ALSFactors":
        with np.load(io.BytesIO(data), allow_pickle=True) as z:
            params = ALSParams(
                **json.loads(bytes(z["params"].tobytes()).decode())
            )
            user_vocab = BiMap(
                dict(zip(z["user_ids"].tolist(), z["user_idx"].tolist()))
            )
            item_vocab = BiMap(
                dict(zip(z["item_ids"].tolist(), z["item_idx"].tolist()))
            )
            return ALSFactors(
                user_factors=z["user_factors"],
                item_factors=z["item_factors"],
                user_vocab=user_vocab,
                item_vocab=item_vocab,
                params=params,
            )


# -- training: the dense-W path ----------------------------------------------

# auto-dispatch bound for the dense rating matrix; PIO_DENSE_ALS=0
# disables, =1 forces where it fits, PIO_DENSE_ALS_BYTES overrides the
# budget
DENSE_DEFAULT_BYTES = 9_000_000_000
# below this edge count auto mode keeps the windowed path unless
# PIO_DENSE_ALS=1 opts in
DENSE_AUTO_MIN_EDGES = 1_000_000


def _dense_half_step(
    r: torch.Tensor,
    fixed: torch.Tensor,  # factors of the side NOT being solved
    degree: torch.Tensor,  # (n_solved_p,) — -1 marks padding rows
    x0: torch.Tensor,
    *,
    solve_rows: bool,  # True: solve R's row side; False: its column side
    implicit: bool,
    lam: float,
    alpha: float,
    cg_iterations: int,
    scale: float = 1.0,
) -> torch.Tensor:
    """One ALS half-step with b/gram built by one edge pass over R.

    int8 storage runs the one-R-read pass of ``ops.dense_fused`` (the
    kernel on the card, its plain version on the CPU); f32 and bf16
    storage run ``ops.dense``. Operator assembly and CG are the JAX
    package's. Padding rows have all-zero R and b=0, x0=0, so CG keeps
    them at zero."""
    k = x0.shape[1]
    if r.dtype == torch.int8:
        # α/s in Python double, then rounded to f32 once
        ascale = float(np.float32(alpha / scale if implicit else 1.0 / scale))
        fused = (
            dense_fused.fused_row_pass if solve_rows
            else dense_fused.fused_col_pass
        )
        b, corr_flat = fused(r, fixed, ascale, implicit=implicit)
    else:
        edge_pass = dense.dense_row_pass if solve_rows else dense.dense_col_pass
        b, corr_flat = edge_pass(r, fixed, implicit=implicit, alpha=alpha)
    eye = torch.eye(k, dtype=torch.float32, device=r.device)
    if implicit:
        base = f32_gram(fixed) + lam * eye
        a_flat = corr_flat + base.reshape(1, k * k)
    else:
        reg = lam * torch.clamp(degree, min=1.0)
        a_flat = corr_flat + reg[:, None] * eye.reshape(1, k * k)
    return batched_cg(lambda v: flat_gram_matvec(a_flat, v), b, x0,
                      cg_iterations)


def _seeded_init(n_users_p, n_items_p, rank, user_deg, item_deg, seed):
    """Both factor matrices' start: ``normal / sqrt(rank)`` drawn on the
    CPU by a ``torch.Generator`` seeded with `seed` (users first), moved
    to the degrees' device, zero on padding rows (degree -1). Drawn on
    the CPU so that a seed starts the card and the CPU from the same
    factors. This cannot equal the JAX package's threefry draw, so tests
    that compare the two pass init factors to both."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))

    def draw(n_p, deg):
        x = torch.randn((n_p, rank), generator=gen, dtype=torch.float32)
        return (x / math.sqrt(rank)).to(deg.device) * (deg >= 0)[:, None]

    return draw(n_users_p, user_deg), draw(n_items_p, item_deg)


def _train_loop_dense(
    r, user_deg, item_deg, uf0=None, itf0=None, *, rank, iterations,
    implicit, lam, alpha, cg_iterations, seed, scale=1.0,
):
    """The whole alternating loop on the dense-W path (counterpart of the
    JAX package's ``_train_jit_dense``); without init factors it starts
    from `_seeded_init`."""
    n_users_p, n_items_p = r.shape
    if uf0 is not None and itf0 is not None:
        uf, itf = uf0, itf0
    else:
        uf, itf = _seeded_init(n_users_p, n_items_p, rank, user_deg,
                               item_deg, seed)
    step = dict(implicit=implicit, lam=lam, alpha=alpha,
                cg_iterations=cg_iterations, scale=scale)
    for _ in range(iterations):
        uf = _dense_half_step(r, itf, user_deg, uf, solve_rows=True, **step)
        itf = _dense_half_step(r, uf, item_deg, itf, solve_rows=False, **step)
    return uf, itf


def _dense_iteration(r, rank, cg_iterations, implicit) -> costs.Work:
    return costs.dense_train_iteration(int(r.shape[0]), int(r.shape[1]), rank,
                                       cg_iterations, dense.STORAGE_NAMES[r.dtype], implicit)


_train_loop_dense = devprof.instrument(
    "als.train_dense", _train_loop_dense, scale_by="iterations",
    cost=lambda args, kw: _dense_iteration(args[0], kw["rank"], kw["cg_iterations"],
                                           kw["implicit"]),
    dtype_of=lambda args, kw: dense.pass_dtype(args, kw),
)


@dataclass
class _StagedTrain:
    """A train with its data resident on the device, built once per
    training set; `run()` re-runs the alternating loop with no further
    host→device traffic and returns the padded device factors."""

    device_args: tuple
    static_kwargs: dict
    n_users: int
    n_items: int
    host_prep_sec: float
    transfer_sec: float

    def factors(self, uf, itf) -> tuple[np.ndarray, np.ndarray]:
        return (
            uf[: self.n_users].cpu().numpy(),
            itf[: self.n_items].cpu().numpy(),
        )


@dataclass
class StagedDenseTrain(_StagedTrain):
    """A dense-path train, built by `stage_dense`: `device_args` are (r,
    user_deg, item_deg, uf0 | None, itf0 | None). `transfer_sec` is the
    host→device copy of the edges plus the densify, to the device's
    completion."""

    @property
    def dense_dtype(self) -> str:
        """R's storage mode: "f32", "bf16" or "int8"."""
        return {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.int8: "int8"}[self.device_args[0].dtype]

    def run(self) -> tuple[torch.Tensor, torch.Tensor]:
        return _train_loop_dense(*self.device_args, **self.static_kwargs)


def dense_matrix_bytes(
    n_users: int, n_items: int, dense_dtype: str = "bf16"
) -> int:
    """Padded dense-R footprint — the auto-dispatch gate's input."""
    n_u_p = -(-n_users // dense.ROW_BLOCK) * dense.ROW_BLOCK
    n_i_p = -(-n_items // dense.COL_PAD) * dense.COL_PAD
    return n_u_p * n_i_p * dense.BYTES_PER_CELL.get(dense_dtype, 2)


def dense_eligible(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_users: int,
    n_items: int,
    params: ALSParams,
    dense_dtype: str = "bf16",
) -> bool:
    """Gate for the dense-W path, the JAX package's on one device.

    Requires: env not opting out, rank within the gram-solver bound, the
    padded matrix within the byte budget, unique (user, item) pairs (a
    dense cell holds one rating; the windowed path sums duplicates), and
    — explicit mode only — no zero-valued ratings (a dense zero must
    mean "unobserved"). Auto mode also requires DENSE_AUTO_MIN_EDGES
    unless PIO_DENSE_ALS=1 opts in."""
    env = env_str("PIO_DENSE_ALS").strip()
    if env == "0":
        return False
    if params.rank > GRAM_SOLVER_MAX_RANK:
        return False
    if env != "1" and len(rows) < DENSE_AUTO_MIN_EDGES:
        return False
    budget = env_int("PIO_DENSE_ALS_BYTES", DENSE_DEFAULT_BYTES)
    if dense_dtype == "bf16":  # the default: predict what auto picks
        if dense.int8_scale(vals) is not None:
            dense_dtype = "int8"
    if dense_matrix_bytes(n_users, n_items, dense_dtype) > budget:
        return False
    if not params.implicit_prefs and np.any(vals == 0.0):
        return False
    key = rows.astype(np.int64) * np.int64(n_items) + cols.astype(np.int64)
    if np.unique(key).size != len(key):
        logging.getLogger(__name__).info(
            "dense ALS path skipped: duplicate (user, item) pairs"
        )
        return False
    return True


def _degrees(idx: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(idx, minlength=n).astype(np.float32)


def _pad_deg(deg: np.ndarray, n_padded: int) -> np.ndarray:
    out = np.full(n_padded, -1.0, np.float32)  # -1 marks padding
    out[: len(deg)] = deg
    return out


def _padded_init(init_factors, n_users, n_items, rank, n_u_p, n_i_p):
    """`init_factors` (uf, itf) zero-padded to (n_u_p, K) and (n_i_p, K),
    or (None, None) without them."""
    if init_factors is None:
        return None, None
    uf_in = np.asarray(init_factors[0], np.float32)
    itf_in = np.asarray(init_factors[1], np.float32)
    if uf_in.shape != (n_users, rank) or itf_in.shape != (n_items, rank):
        raise ValueError(
            "init_factors shapes do not match (n_users/n_items, rank)"
        )
    uf0 = np.zeros((n_u_p, rank), np.float32)
    uf0[:n_users] = uf_in
    itf0 = np.zeros((n_i_p, rank), np.float32)
    itf0[:n_items] = itf_in
    return uf0, itf0


def stage_dense(
    rows, cols, vals, n_users, n_items, params,
    user_deg=None, item_deg=None, init_factors=None,
    dense_dtype: str = "auto",
    device=None,
) -> StagedDenseTrain:
    """Stage the dense-path train on the card (or `device`): pad dims to
    the block quanta, copy the COO arrays once, densify on the device,
    and keep the matrix resident.

    dense_dtype "auto" prefers int8 storage when every rating is exactly
    round(r·s) for a small scale s (ML-style ratings are); otherwise
    bf16. "f32" is the exactness mode."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    scale = 1.0
    if dense_dtype in ("auto", "int8"):
        s_q = dense.int8_scale(vals)
        if s_q is not None:
            dense_dtype, scale = "int8", s_q
        elif dense_dtype == "int8":
            raise ValueError(
                "dense_dtype='int8' but ratings are not exactly int8-"
                "quantizable; use 'bf16' or 'auto'"
            )
        else:
            dense_dtype = "bf16"
    n_u_p = -(-n_users // dense.ROW_BLOCK) * dense.ROW_BLOCK
    n_i_p = -(-n_items // dense.COL_PAD) * dense.COL_PAD
    if user_deg is None:
        user_deg = _degrees(rows, n_users)
    if item_deg is None:
        item_deg = _degrees(cols, n_items)
    uf0, itf0 = _padded_init(init_factors, n_users, n_items, params.rank,
                             n_u_p, n_i_p)
    host_prep = time.perf_counter() - t0

    def put(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    t0 = time.perf_counter()
    r = dense.densify(
        put(rows).long(), put(cols).long(), put(vals),
        n_rows_p=n_u_p, n_cols_p=n_i_p, dense_dtype=dense_dtype,
        scale=scale,
    )
    device_args = (
        r, put(_pad_deg(user_deg, n_u_p)), put(_pad_deg(item_deg, n_i_p)),
        put(uf0), put(itf0),
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    transfer = time.perf_counter() - t0
    return StagedDenseTrain(
        device_args=device_args,
        static_kwargs=dict(
            rank=params.rank,
            iterations=params.iterations,
            implicit=params.implicit_prefs,
            lam=params.lambda_,
            alpha=params.alpha,
            cg_iterations=params.cg_iterations,
            seed=params.seed,
            scale=scale,
        ),
        n_users=n_users,
        n_items=n_items,
        host_prep_sec=host_prep,
        transfer_sec=transfer,
    )


def _train_dense(
    rows, cols, vals, n_users, n_items, params,
    user_deg, item_deg, user_vocab, item_vocab, init_factors,
    dense_dtype: str = "auto",
    device=None,
) -> ALSFactors:
    staged = stage_dense(
        rows, cols, vals, n_users, n_items, params,
        user_deg=user_deg, item_deg=item_deg, init_factors=init_factors,
        dense_dtype=dense_dtype, device=device,
    )
    return _run_staged(staged, params, user_vocab, item_vocab,
                       f"{staged.dense_dtype} R")


def _run_staged(staged, params, user_vocab, item_vocab, what) -> ALSFactors:
    """Run a staged train's loop; one log line names the staging (the
    train job's log shows which path a job took)."""
    log.info("ALS train staged %s (%s): %d users x %d items, rank %d, "
             "%d iterations", type(staged).__name__, what, staged.n_users,
             staged.n_items, params.rank, params.iterations)
    return _als_factors(*staged.factors(*staged.run()), params, user_vocab,
                        item_vocab)


def _als_factors(uf, itf, params, user_vocab, item_vocab) -> ALSFactors:
    return ALSFactors(
        user_factors=uf,
        item_factors=itf,
        user_vocab=user_vocab or BiMap({}),
        item_vocab=item_vocab or BiMap({}),
        params=params,
    )


# -- training: the windowed path ---------------------------------------------


def _half_step_windowed(
    fixed: torch.Tensor,  # (N_fixed_padded, K) — pad rows are exactly zero
    src: torch.Tensor,  # (n_blocks_p, B_E) int32 — rows into `fixed`
    val: torch.Tensor,  # (n_blocks_p, B_E) — ratings (0 on pads)
    ok: torch.Tensor,  # (n_blocks_p, B_E) — 1.0 real edge / 0.0 padding
    loc: torch.Tensor,  # (n_blocks_p, B_E) int32 — dst % WINDOW_ROWS
    bwin: torch.Tensor,  # (n_blocks_p,) int32 — output window per block
    degree: torch.Tensor,  # (N_dst_padded,) — ALS-WR reg (explicit only)
    x0: torch.Tensor,  # (N_dst_padded, K) warm start
    *,
    n_windows: int,
    implicit: bool,
    lam: float,
    alpha: float,
    cg_iterations: int,
) -> torch.Tensor:
    """One ALS half-step with the windowed reduction: one edge pass
    (`ops.windowed.windowed_gram_b`) builds b and every row's gram
    correction, then CG runs on the flat (N, K²) operators. Weights and
    operators are the JAX package's:

        implicit: w_b = c·1[v>0]·ok, w_g = (c − 1)·ok, c = 1 + α|v|;
                  A = YᵀY + λI + Σ w_g y yᵀ
        explicit: w_b = v·ok, w_g = ok;  A = Σ_obs y yᵀ + λ·max(deg, 1)·I
    """
    k = x0.shape[1]
    eye = torch.eye(k, dtype=torch.float32, device=x0.device)
    if implicit:
        conf = 1.0 + alpha * torch.abs(val)
        pref = (val > 0).to(torch.float32)
        b, corr_flat = windowed_gram_b(
            fixed, src, conf * pref * ok, (conf - 1.0) * ok, loc, bwin,
            n_windows,
        )
        base = f32_gram(fixed) + lam * eye
        a_flat = corr_flat + base.reshape(1, k * k)
    else:
        b, corr_flat = windowed_gram_b(
            fixed, src, val * ok, ok, loc, bwin, n_windows,
        )
        reg = lam * torch.clamp(degree, min=1.0)
        a_flat = corr_flat + reg[:, None] * eye.reshape(1, k * k)
    return batched_cg(lambda v: flat_gram_matvec(a_flat, v), b, x0,
                      cg_iterations)


def _train_loop_windowed(
    u_src, u_val, u_ok, u_loc, u_bwin,  # user-side plan (solving users)
    i_src, i_val, i_ok, i_loc, i_bwin,  # item-side plan (solving items)
    user_deg, item_deg, uf0=None, itf0=None, *,
    n_user_windows, n_item_windows, rank, iterations, implicit, lam,
    alpha, cg_iterations, seed,
):
    """The whole alternating loop on the windowed path (counterpart of
    the JAX package's ``_train_jit_windowed`` on one device). Factor
    matrices are window-padded; without init factors they start from
    `_seeded_init`, whose padding rows are zero, and CG keeps them at
    zero (b = 0, x0 = 0), so they never reach the fixed-side gram."""
    if uf0 is not None and itf0 is not None:
        uf, itf = uf0, itf0
    else:
        uf, itf = _seeded_init(n_user_windows * WINDOW_ROWS,
                               n_item_windows * WINDOW_ROWS, rank, user_deg,
                               item_deg, seed)
    step = dict(implicit=implicit, lam=lam, alpha=alpha,
                cg_iterations=cg_iterations)
    for _ in range(iterations):
        uf = _half_step_windowed(itf, u_src, u_val, u_ok, u_loc, u_bwin,
                                 user_deg, uf, n_windows=n_user_windows,
                                 **step)
        itf = _half_step_windowed(uf, i_src, i_val, i_ok, i_loc, i_bwin,
                                  item_deg, itf, n_windows=n_item_windows,
                                  **step)
    return uf, itf


def _windowed_iteration(args, rank, cg_iterations, implicit, n_user_windows,
                        n_item_windows) -> costs.Work:
    """One windowed iteration's work; the edges that carry weight are
    counted on the device (`ok`), the rest from the shapes."""
    u_src, u_ok, i_src, i_ok = args[0], args[2], args[5], args[7]
    n_u_p, n_i_p = n_user_windows * WINDOW_ROWS, n_item_windows * WINDOW_ROWS
    sides = (
        (int(u_src.numel()), n_i_p, int(u_src.shape[0]), n_user_windows, n_u_p,
         int(torch.count_nonzero(u_ok))),
        (int(i_src.numel()), n_u_p, int(i_src.shape[0]), n_item_windows, n_i_p,
         int(torch.count_nonzero(i_ok))),
    )
    return costs.windowed_train_iteration(sides, rank, cg_iterations, WINDOW_ROWS,
                                          implicit)


_train_loop_windowed = devprof.instrument(
    "als.train_windowed", _train_loop_windowed, scale_by="iterations",
    cost=lambda args, kw: _windowed_iteration(
        args, kw["rank"], kw["cg_iterations"], kw["implicit"],
        kw["n_user_windows"], kw["n_item_windows"]),
    dtype_of=lambda args, kw: "f32",
)


@dataclass
class StagedWindowedTrain(_StagedTrain):
    """A windowed-path train, built by `stage_windowed`: `device_args`
    are both sides' plans (src, val, ok, local, block_window), the
    padded degrees and the init factors (or None). `host_prep_sec` is the
    argsorts, the two plans and the re-indexing through them;
    `transfer_sec` the host→device copies, to the device's completion."""

    def run(self) -> tuple[torch.Tensor, torch.Tensor]:
        return _train_loop_windowed(*self.device_args, **self.static_kwargs)


def stage_windowed(
    rows, cols, vals, n_users, n_items, params,
    user_deg=None, item_deg=None, init_factors=None, device=None,
) -> StagedWindowedTrain:
    """Host plans and device staging for the windowed path, on the card
    unless `device` says otherwise: the edges sorted by user and by item,
    each order blocked by `plan_windows` (one part), every per-slot array
    laid out (n_blocks_p, B_E) and copied to the device once."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    if user_deg is None:
        user_deg = _degrees(rows, n_users)
    if item_deg is None:
        item_deg = _degrees(cols, n_items)
    by_user = np.argsort(rows, kind="stable")
    by_item = np.argsort(cols, kind="stable")
    plan_u = plan_windows(rows[by_user], n_users)
    plan_i = plan_windows(cols[by_item], n_items)
    uf0, itf0 = _padded_init(init_factors, n_users, n_items, params.rank,
                             plan_u.n_rows_padded, plan_i.n_rows_padded)

    def side(plan, src, val):
        def flat(a):
            return a.reshape(plan.n_blocks_p, -1)

        return (flat(plan.take(src)), flat(plan.take(val)),
                flat(plan.chunked_valid()), flat(plan.chunked_local()),
                plan.block_window)

    host_args = (
        *side(plan_u, cols[by_user], vals[by_user]),
        *side(plan_i, rows[by_item], vals[by_item]),
        _pad_deg(user_deg, plan_u.n_rows_padded),
        _pad_deg(item_deg, plan_i.n_rows_padded),
        uf0, itf0,
    )
    host_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    device_args = tuple(
        None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in host_args
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    transfer = time.perf_counter() - t0
    return StagedWindowedTrain(
        device_args=device_args,
        static_kwargs=dict(
            n_user_windows=plan_u.n_windows,
            n_item_windows=plan_i.n_windows,
            rank=params.rank,
            iterations=params.iterations,
            implicit=params.implicit_prefs,
            lam=params.lambda_,
            alpha=params.alpha,
            cg_iterations=params.cg_iterations,
            seed=params.seed,
        ),
        n_users=n_users,
        n_items=n_items,
        host_prep_sec=host_prep,
        transfer_sec=transfer,
    )


def _train_windowed(
    rows, cols, vals, n_users, n_items, params,
    user_deg, item_deg, user_vocab, item_vocab, init_factors, device=None,
) -> ALSFactors:
    staged = stage_windowed(
        rows, cols, vals, n_users, n_items, params,
        user_deg=user_deg, item_deg=item_deg, init_factors=init_factors,
        device=device,
    )
    return _run_staged(staged, params, user_vocab, item_vocab, "edge blocks")


# -- training: the scatter path (rank > 32) ----------------------------------


def _half_step_implicit(
    fixed: torch.Tensor,  # (N_fixed, K)
    src_idx: torch.Tensor,  # (E,) int64 — edge rows into `fixed`
    dst_idx: torch.Tensor,  # (E,) int64 — edge rows being solved (sorted)
    conf: torch.Tensor,  # (E,) confidence c = 1 + α|r|
    pref: torch.Tensor,  # (E,) preference p = 1[r > 0]
    valid: torch.Tensor,  # (E,) 1.0 real edge / 0.0 padding
    x0: torch.Tensor,  # (N_dst, K) warm start
    lam: float,
    cg_iterations: int,
    n_chunks: int = 1,
) -> torch.Tensor:
    """Implicit half-step (MLlib trainImplicit semantics). Up to
    GRAM_SOLVER_MAX_RANK one edge pass builds every row's operator;
    beyond it CG runs matrix-free, one edge pass per matvec."""
    n_dst, k = x0.shape
    gram = f32_gram(fixed)
    b = chunked_weighted_edge_sum(
        fixed, src_idx, dst_idx, conf * pref * valid, n_dst, n_chunks
    )
    w_g = (conf - 1.0) * valid
    if k <= GRAM_SOLVER_MAX_RANK:
        corr = chunked_gram_edge_sum(fixed, src_idx, dst_idx, w_g, n_dst,
                                     n_chunks)
        eye = torch.eye(k, dtype=torch.float32, device=x0.device)
        a_flat = corr + (gram + lam * eye).reshape(1, k * k)
        return batched_cg(lambda v: flat_gram_matvec(a_flat, v), b, x0,
                          cg_iterations)

    def matvec(v):
        with full_f32():
            base = v @ gram + lam * v
        return base + chunked_edge_matvec(fixed, v, src_idx, dst_idx, w_g,
                                          n_dst, n_chunks)

    return batched_cg(matvec, b, x0, cg_iterations)


def _half_step_explicit(
    fixed: torch.Tensor,
    src_idx: torch.Tensor,
    dst_idx: torch.Tensor,
    ratings: torch.Tensor,
    valid: torch.Tensor,  # (E,) 1.0 real edge / 0.0 padding
    degree: torch.Tensor,  # (N_dst,) observation counts for ALS-WR
    x0: torch.Tensor,
    lam: float,
    cg_iterations: int,
    n_chunks: int = 1,
) -> torch.Tensor:
    """Explicit (ALS-WR) half-step: A = Σ_obs y yᵀ + λ·max(deg, 1)·I,
    built once up to GRAM_SOLVER_MAX_RANK, matrix-free beyond it."""
    n_dst, k = x0.shape
    b = chunked_weighted_edge_sum(
        fixed, src_idx, dst_idx, ratings * valid, n_dst, n_chunks
    )
    reg = lam * torch.clamp(degree, min=1.0)
    if k <= GRAM_SOLVER_MAX_RANK:
        obs = chunked_gram_edge_sum(fixed, src_idx, dst_idx, valid, n_dst,
                                    n_chunks)
        eye_flat = torch.eye(k, dtype=torch.float32,
                             device=x0.device).reshape(1, k * k)
        a_flat = obs + reg[:, None] * eye_flat
        return batched_cg(lambda v: flat_gram_matvec(a_flat, v), b, x0,
                          cg_iterations)

    def matvec(v):
        return reg[:, None] * v + chunked_edge_matvec(
            fixed, v, src_idx, dst_idx, valid, n_dst, n_chunks)

    return batched_cg(matvec, b, x0, cg_iterations)


def _train_loop_scatter(
    u_src, u_dst, u_val, u_ok,  # edges sorted by user (solving users)
    i_src, i_dst, i_val, i_ok,  # edges sorted by item (solving items)
    user_deg, item_deg, uf0=None, itf0=None, *,
    n_users, n_items, rank, iterations, implicit, lam, alpha,
    cg_iterations, seed, n_chunks,
):
    """The whole alternating loop on the scatter path (counterpart of the
    JAX package's ``_train_jit`` without a mesh); without init factors
    it starts from `_seeded_init` (no padding rows here)."""
    if uf0 is not None and itf0 is not None:
        uf, itf = uf0, itf0
    else:
        uf, itf = _seeded_init(n_users, n_items, rank, user_deg, item_deg,
                               seed)
    if implicit:
        # confidence from |r| (a dislike still raises it), preference
        # only for r > 0: the operator stays SPD for CG
        u_w, i_w = 1.0 + alpha * torch.abs(u_val), 1.0 + alpha * torch.abs(i_val)
        u_p, i_p = (u_val > 0).to(torch.float32), (i_val > 0).to(torch.float32)
        for _ in range(iterations):
            uf = _half_step_implicit(itf, u_src, u_dst, u_w, u_p, u_ok, uf,
                                     lam, cg_iterations, n_chunks)
            itf = _half_step_implicit(uf, i_src, i_dst, i_w, i_p, i_ok, itf,
                                      lam, cg_iterations, n_chunks)
    else:
        for _ in range(iterations):
            uf = _half_step_explicit(itf, u_src, u_dst, u_val, u_ok, user_deg,
                                     uf, lam, cg_iterations, n_chunks)
            itf = _half_step_explicit(uf, i_src, i_dst, i_val, i_ok, item_deg,
                                      itf, lam, cg_iterations, n_chunks)
    return uf, itf


# the JAX package's name for its scatter-path loop
_train_loop_scatter = devprof.instrument(
    "als.train_edge", _train_loop_scatter, scale_by="iterations",
    cost=lambda args, kw: costs.scatter_train_iteration(
        int(args[0].numel()), kw["n_users"], kw["n_items"], kw["rank"],
        kw["cg_iterations"], kw["rank"] <= GRAM_SOLVER_MAX_RANK),
    dtype_of=lambda args, kw: "f32",
)


def _train_scatter(
    rows, cols, vals, n_users, n_items, params,
    user_deg, item_deg, user_vocab, item_vocab, init_factors, device=None,
) -> ALSFactors:
    """Stage the edge list sorted by user and by item (padded with
    weight-0 edges to a multiple of the chunk count) and run the scatter
    loop, on the card unless `device` says otherwise."""
    dev = resolve_device(device)
    valid = np.ones(len(rows), np.float32)
    n_chunks = max(1, -(-len(rows) // max(1, params.edge_chunk_size)))
    pad = (-len(rows)) % n_chunks
    if pad:
        rows = np.concatenate([rows, np.zeros(pad, np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, np.float32)])
        valid = np.concatenate([valid, np.zeros(pad, np.float32)])
    by_user = np.argsort(rows, kind="stable")
    by_item = np.argsort(cols, kind="stable")
    uf0, itf0 = _padded_init(init_factors, n_users, n_items, params.rank,
                             n_users, n_items)

    def idx(a):
        return torch.from_numpy(a.astype(np.int64)).to(dev)

    def put(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    uf, itf = _train_loop_scatter(
        idx(cols[by_user]), idx(rows[by_user]), put(vals[by_user]),
        put(valid[by_user]),
        idx(rows[by_item]), idx(cols[by_item]), put(vals[by_item]),
        put(valid[by_item]),
        put(user_deg), put(item_deg), put(uf0), put(itf0),
        n_users=n_users, n_items=n_items, rank=params.rank,
        iterations=params.iterations, implicit=params.implicit_prefs,
        lam=params.lambda_, alpha=params.alpha,
        cg_iterations=params.cg_iterations, seed=params.seed,
        n_chunks=n_chunks,
    )
    return _als_factors(uf.cpu().numpy(), itf.cpu().numpy(), params,
                        user_vocab, item_vocab)


def train(
    rows: np.ndarray,  # (E,) user indices
    cols: np.ndarray,  # (E,) item indices
    vals: np.ndarray,  # (E,) ratings / interaction weights
    n_users: int,
    n_items: int,
    params: ALSParams = ALSParams(),
    user_vocab: Optional[BiMap] = None,
    item_vocab: Optional[BiMap] = None,
    init_factors: Optional[tuple[np.ndarray, np.ndarray]] = None,
    device=None,
) -> ALSFactors:
    """Train factors from a COO interaction list, on the card unless
    `device` says otherwise.

    `init_factors=(uf, itf)` (numpy) warm-starts the alternating loop.
    The path is the one the JAX package's gate picks on one device:
    dense-W where `dense_eligible` holds, else windowed up to
    GRAM_SOLVER_MAX_RANK, else scatter."""
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    user_deg = _degrees(rows, n_users)
    item_deg = _degrees(cols, n_items)
    if dense_eligible(rows, cols, vals, n_users, n_items, params):
        path = _train_dense
    elif params.rank <= GRAM_SOLVER_MAX_RANK:
        path = _train_windowed
    else:
        path = _train_scatter
    return path(
        rows, cols, vals, n_users, n_items, params,
        user_deg, item_deg, user_vocab, item_vocab, init_factors,
        device=device,
    )


def train_grid(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_users: int,
    n_items: int,
    params_list: Sequence[ALSParams],
    user_vocab: Optional[BiMap] = None,
    item_vocab: Optional[BiMap] = None,
    device=None,
) -> list[ALSFactors]:
    """Train an ALS hyperparameter grid over one staging of the data, on
    the card unless `device` says otherwise (counterpart of the JAX
    package's ``train_grid``).

    The gate runs once, on the first point, and one `stage_dense` or
    `stage_windowed` serves every point: neither staged form depends on
    the rank, λ or α. Each point then runs the alternating loop over the
    shared device arguments with its own params, so its factors equal a
    serial `train` of the same params on the same device bit for bit.
    Results come back in input order. ValueError (the caller trains
    point by point) for ranks above GRAM_SOLVER_MAX_RANK, and for a grid
    that mixes implicit and explicit points: the gate depends on
    `implicit_prefs`, so their serial trains may take different paths."""
    for p in params_list:
        if p.rank > GRAM_SOLVER_MAX_RANK:
            raise ValueError(
                f"train_grid supports rank <= {GRAM_SOLVER_MAX_RANK}"
            )
    if len({p.implicit_prefs for p in params_list}) > 1:
        raise ValueError("train_grid needs one implicit_prefs for the grid")
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    base = params_list[0]
    use_dense = dense_eligible(rows, cols, vals, n_users, n_items, base)
    stage = stage_dense if use_dense else stage_windowed
    staged = stage(rows, cols, vals, n_users, n_items, base, device=device)
    grid = _train_dense_grid if use_dense else _train_windowed_grid
    return [_als_factors(uf, itf, p, user_vocab, item_vocab)
            for (uf, itf), p in zip(grid(staged, list(params_list)), params_list)]


def _grid_points(staged: _StagedTrain, params_list: list) -> list:
    """Each point's loop over the staged data, its factors on the host;
    the loop's own wrapper passes through inside this one."""
    run = (_train_loop_dense if isinstance(staged, StagedDenseTrain)
           else _train_loop_windowed)
    out = []
    for p in params_list:
        kwargs = dict(staged.static_kwargs)  # keeps the staged int8 scale
        kwargs.update(
            rank=p.rank, iterations=p.iterations,
            cg_iterations=p.cg_iterations, implicit=p.implicit_prefs,
            seed=p.seed, lam=p.lambda_, alpha=p.alpha,
        )
        out.append(staged.factors(*run(*staged.device_args, **kwargs)))
    return out


def _grid_cost(args, kwargs) -> costs.Work:
    staged, params_list = args
    work = costs.NONE
    for p in params_list:
        if isinstance(staged, StagedDenseTrain):
            it = _dense_iteration(staged.device_args[0], p.rank, p.cg_iterations,
                                  p.implicit_prefs)
        else:
            kw = staged.static_kwargs
            it = _windowed_iteration(staged.device_args, p.rank, p.cg_iterations,
                                     p.implicit_prefs, kw["n_user_windows"],
                                     kw["n_item_windows"])
        work = work + it.scaled(p.iterations)
    return work


_train_dense_grid = devprof.instrument(
    "als.train_dense_grid", _grid_points, cost=_grid_cost,
    dtype_of=lambda args, kw: dense.pass_dtype(args[0].device_args, kw))
_train_windowed_grid = devprof.instrument(
    "als.train_windowed_grid", _grid_points, cost=_grid_cost,
    dtype_of=lambda args, kw: "f32")


def warm_start_factors(
    parent: ALSFactors,
    user_vocab: BiMap,
    item_vocab: BiMap,
    params: ALSParams,
) -> tuple[np.ndarray, np.ndarray]:
    """A parent version's factors mapped onto a new training vocabulary
    (the JAX package's function, bit for bit): a row whose id survives
    copies the parent's first min(rank, parent rank) columns; every other
    entry keeps the scaled gaussian init of ``np.random.RandomState(
    params.seed)``, drawn for the users first. ALS is memoryless in its
    factor state, so a warm start changes the trajectory, not the fixed
    point."""
    rng = np.random.RandomState(params.seed)

    def align(old_vocab: BiMap, new_vocab: BiMap, old: np.ndarray, n: int):
        out = (rng.standard_normal((n, params.rank)).astype(np.float32)
               / np.sqrt(params.rank))
        k = min(params.rank, old.shape[1]) if old.size else 0
        for ident, new_row in new_vocab.items():
            old_row = old_vocab.get(ident)
            if old_row is not None and old_row < old.shape[0] and k:
                out[new_row, :k] = old[old_row, :k]
        return out

    uf0 = align(parent.user_vocab, user_vocab, parent.user_factors,
                len(user_vocab))
    itf0 = align(parent.item_vocab, item_vocab, parent.item_factors,
                 len(item_vocab))
    return uf0, itf0


# -- staged serving state ----------------------------------------------------


SERVE_DTYPES = ("f32", "bf16", "int8")


@dataclass(frozen=True)
class ServingFactors:
    """Device-resident serving-side factor state, staged once and reused
    by every call.

    `items` is row-padded to `ops.recommend.ITEM_PAD`; `n_items` is the
    live extent (pad rows are dead inside the selector). dtype "int8"
    holds both matrices per-row symmetric-quantized with their scale
    vectors (users (U, 1), items (1, I_p)); "bf16" halves the factor
    stream with no scale vectors. `item_inv_norm` carries the items'
    f32-row inverse L2 norms, so the cosine verbs serve off the same
    slab: cosine is the scaled dot, never a normalized copy."""

    users: torch.Tensor  # (U, K) f32 | bf16 | int8
    items: torch.Tensor  # (I_p, K) f32 | bf16 | int8 — pad rows zero
    user_scale: Optional[torch.Tensor]  # (U, 1) f32 when int8
    item_scale: Optional[torch.Tensor]  # (1, I_p) f32 when int8
    n_items: int
    dtype: str  # "f32" | "bf16" | "int8"
    item_inv_norm: torch.Tensor  # (1, I_p) f32 — cosine

    @property
    def n_users(self) -> int:
        return int(self.users.shape[0])

    @property
    def device(self) -> torch.device:
        return self.items.device

    def device_nbytes(self) -> float:
        tensors = [self.users, self.items, self.item_inv_norm]
        if self.user_scale is not None:
            tensors += [self.user_scale, self.item_scale]
        return float(sum(t.nelement() * t.element_size() for t in tensors))


def stage_serving(
    factors: ALSFactors, serve_dtype: str = "f32", device=None
) -> ServingFactors:
    """Stage (and for "int8", quantize) the factor matrices for serving,
    on the card unless `device` says otherwise."""
    return _stage_arrays(
        np.asarray(factors.user_factors, np.float32),
        np.asarray(factors.item_factors, np.float32),
        serve_dtype, device,
    )


def stage_item_serving(
    item_matrix: np.ndarray, serve_dtype: str = "f32", device=None
) -> ServingFactors:
    """Item-only staging for cosine-only models: same ServingFactors
    contract with an empty user side — `similar_serving` is the only
    verb that makes sense here."""
    itf = np.asarray(item_matrix, np.float32)
    return _stage_arrays(
        np.zeros((0, itf.shape[1] if itf.ndim == 2 else 0), np.float32),
        itf, serve_dtype, device,
    )


def _stage_arrays(
    uf: np.ndarray, itf: np.ndarray, serve_dtype: str, device
) -> ServingFactors:
    if serve_dtype not in SERVE_DTYPES:
        raise ValueError(
            f"serve_dtype must be one of {SERVE_DTYPES}, got "
            f"{serve_dtype!r}"
        )
    dev = resolve_device(device)
    n_items, k = itf.shape if itf.ndim == 2 else (0, uf.shape[1])
    i_p = _rp.pad_items(n_items)
    # inverse norms from the PRE-quantization f32 rows: the cosine verbs
    # normalize by the true magnitudes, identically across dtypes
    inv = torch.from_numpy(_rp.inv_norms_np(itf, i_p)).to(dev)
    if serve_dtype == "int8":
        uq, us = _rp.quantize_rows_np(uf)
        iq, isc = _rp.quantize_rows_np(itf)
        items = np.zeros((i_p, k), np.int8)
        items[:n_items] = iq
        iscale = np.ones((1, i_p), np.float32)
        iscale[0, :n_items] = isc
        return ServingFactors(
            users=torch.from_numpy(uq).to(dev),
            items=torch.from_numpy(items).to(dev),
            user_scale=torch.from_numpy(
                np.ascontiguousarray(us[:, None])
            ).to(dev),
            item_scale=torch.from_numpy(iscale).to(dev),
            n_items=n_items,
            dtype="int8",
            item_inv_norm=inv,
        )
    items = np.zeros((i_p, k), np.float32)
    items[:n_items] = itf
    torch_dt = torch.bfloat16 if serve_dtype == "bf16" else torch.float32
    return ServingFactors(
        users=torch.from_numpy(np.ascontiguousarray(uf)).to(dev).to(torch_dt),
        items=torch.from_numpy(items).to(dev).to(torch_dt),
        user_scale=None,
        item_scale=None,
        n_items=n_items,
        dtype=serve_dtype,
        item_inv_norm=inv,
    )


def _serve_recommend(rows, sv: ServingFactors, bits, ex, *, k):
    """Gather the query block from the resident user matrix and run the
    fused selector; int8 gathers the dequant scales with it."""
    int8 = sv.items.dtype == torch.int8
    q = sv.users[rows]
    qs = sv.user_scale[rows] if int8 else None
    isc = sv.item_scale if int8 else None
    return _rp.fused_recommend_topk(
        q, sv.items, qs, isc, bits, ex, k=k, n_items=sv.n_items
    )


def _serve_similar(rows, sv: ServingFactors, bits, ex, *, k):
    """Cosine `similar` off the same resident item slab as recommend:
    cosine(q, x) = (q·x)·(1/|q|)·(1/|x|) — the inverse norms ride the
    selector's scale inputs. int8 composes: the effective scales are
    (dequant scale · inverse norm) per side."""
    q = sv.items[rows]
    inv_q = sv.item_inv_norm[0, rows][:, None]  # (B, 1)
    if sv.items.dtype == torch.int8:
        qs = sv.item_scale[0, rows][:, None] * inv_q
        isc = sv.item_scale * sv.item_inv_norm
    else:
        qs = inv_q
        isc = sv.item_inv_norm
    return _rp.fused_recommend_topk(
        q, sv.items, qs, isc, bits, ex, k=k, n_items=sv.n_items
    )


def _serve_similar_vecs(vecs, inv_q, sv: ServingFactors, bits, ex, *, k):
    """Cosine top-k against arbitrary f32 query vectors, `inv_q` (B, 1)
    their inverse norms: the query side quantizes per call for int8
    slabs; norms fold into the scale product like every other cosine
    verb."""
    if sv.items.dtype == torch.int8:
        q, qscale = _rp.quantize_rows(vecs)
        qs = qscale * inv_q
        isc = sv.item_scale * sv.item_inv_norm
    else:
        q = vecs.to(sv.items.dtype)
        qs = inv_q
        isc = sv.item_inv_norm
    return _rp.fused_recommend_topk(
        q, sv.items, qs, isc, bits, ex, k=k, n_items=sv.n_items
    )


def _serve_cost(b, sv: ServingFactors, k, bits, ex, scaled):
    mask = sum(float(t.nelement() * t.element_size()) for t in (bits, ex) if t is not None)
    return costs.topk(int(b), int(sv.items.shape[0]), int(sv.items.shape[1]), int(k),
                      sv.dtype, scaled, mask)


# the serving verbs measure their temp bytes on a signature's first call;
# each roofs against its slab's type
_serve_recommend = devprof.instrument(
    "als.recommend_serving", _serve_recommend, memory=True,
    cost=lambda a, kw: _serve_cost(a[0].shape[0], a[1], kw["k"], a[2], a[3],
                                   a[1].dtype == "int8"),
    dtype_of=lambda a, kw: a[1].dtype)
_serve_similar = devprof.instrument(
    "als.similar_serving", _serve_similar, memory=True,
    cost=lambda a, kw: _serve_cost(a[0].shape[0], a[1], kw["k"], a[2], a[3], True),
    dtype_of=lambda a, kw: a[1].dtype)
_serve_similar_vecs = devprof.instrument(
    "als.similar_vecs_serving", _serve_similar_vecs, memory=True,
    cost=lambda a, kw: _serve_cost(a[0].shape[0], a[2], kw["k"], a[3], a[4], True),
    dtype_of=lambda a, kw: a[2].dtype)


def _exclusion_device_args(
    serving: ServingFactors,
    batch: int,
    exclude_mask: Optional[np.ndarray],
    exclude_rows: Optional[np.ndarray],
    extra_rows: Optional[np.ndarray] = None,
):
    """Host-side exclusion packing shared by the serving verbs: a row
    list (the common small-blacklist case) ships (B, E) int32 at a
    pow2-bucketed width; anything wider — or a dense mask — packs to
    bit words at 1/32 the f32 bytes. `extra_rows` appends one
    always-excluded row per query (similar's exclude_self)."""
    dev = serving.device
    i_p = int(serving.items.shape[0])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if exclude_mask is not None:
        mask = np.asarray(exclude_mask, bool)
        if extra_rows is not None:
            mask = mask.copy()
            mask[np.arange(batch), np.asarray(extra_rows)] = True
        return put(_rp.pack_mask_np(mask, i_p)), None
    if exclude_rows is not None and extra_rows is None:
        # fast path: an already -1-padded (B, E) int32 array (the
        # engine's _exclusion_args builds exactly this) ships as-is
        ex = np.asarray(exclude_rows, np.int32)
        if ex.shape[1] <= _rp.ROWLIST_MAX:
            return None, (put(ex) if ex.shape[1] else None)
    lists: list[list[int]] = [[] for _ in range(batch)]
    if exclude_rows is not None:
        for b, row in enumerate(exclude_rows):
            lists[b] = [int(x) for x in row if int(x) >= 0]
    if extra_rows is not None:
        for b, r in enumerate(np.asarray(extra_rows)):
            lists[b].append(int(r))
    widest = max((len(r) for r in lists), default=0)
    if widest == 0:
        return None, None
    if widest > _rp.ROWLIST_MAX:
        # too wide for the per-column compare: scatter host-side into
        # packed words instead (still 1/32 the f32 mask bytes)
        mask = np.zeros((batch, i_p), bool)
        for b, row in enumerate(lists):
            hits = np.asarray(row, np.int64)
            hits = hits[(hits >= 0) & (hits < i_p)]
            mask[b, hits] = True
        return put(_rp.pack_mask_np(mask, i_p)), None
    return None, put(_rp.rowlist_np(lists))


def _host(vals, idx):
    return vals.cpu().numpy(), idx.cpu().numpy()


def recommend_serving(
    serving: ServingFactors,
    user_indices: np.ndarray,
    k: int,
    exclude_mask: Optional[np.ndarray] = None,  # (B, n_items) bool
    exclude_rows: Optional[np.ndarray] = None,  # (B, E) int, -1 padded
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k items from staged serving state: (scores (B, k) f32,
    indices (B, k) int32). One selector call; only the row ids (and the
    exclusion words / row list, when filters apply) cross to the
    device."""
    k = min(int(k), serving.n_items)
    if k <= 0 or serving.n_users == 0:
        b = len(np.asarray(user_indices))
        return (
            np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int64),
        )
    rows_np = np.asarray(user_indices, np.int64)
    bits, ex = _exclusion_device_args(
        serving, len(rows_np), exclude_mask, exclude_rows
    )
    rows = torch.from_numpy(rows_np).to(serving.device)
    return _host(*_serve_recommend(rows, serving, bits, ex, k=k))


def similar_serving(
    serving: ServingFactors,
    item_indices: np.ndarray,
    k: int,
    exclude_self: bool = True,
    exclude_mask: Optional[np.ndarray] = None,
    exclude_rows: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Cosine top-k for a batch of item rows off the staged state.
    exclude_self rides the row-list path (one entry per query) unless
    a dense mask is already in play."""
    k = min(int(k), serving.n_items)
    rows_np = np.asarray(item_indices, np.int64)
    if k <= 0 or serving.n_items == 0:
        return (
            np.zeros((len(rows_np), 0), np.float32),
            np.zeros((len(rows_np), 0), np.int64),
        )
    bits, ex = _exclusion_device_args(
        serving, len(rows_np), exclude_mask, exclude_rows,
        extra_rows=rows_np if exclude_self else None,
    )
    rows = torch.from_numpy(rows_np).to(serving.device)
    return _host(*_serve_similar(rows, serving, bits, ex, k=k))


def similar_vectors_serving(
    serving: ServingFactors,
    vectors: np.ndarray,  # (B, K) f32 query vectors
    k: int,
    exclude_mask: Optional[np.ndarray] = None,
    exclude_rows: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Cosine top-k against arbitrary query vectors (a basket mean) from
    the staged state."""
    k = min(int(k), serving.n_items)
    vecs = np.asarray(vectors, np.float32)
    if k <= 0 or serving.n_items == 0:
        return (
            np.zeros((len(vecs), 0), np.float32),
            np.zeros((len(vecs), 0), np.int64),
        )
    bits, ex = _exclusion_device_args(
        serving, len(vecs), exclude_mask, exclude_rows
    )
    # the inverse norms on the host: the same bits whichever device
    # serves, so an answer on the card equals the plain version's on the
    # CPU
    inv_q = 1.0 / (np.linalg.norm(vecs, axis=-1, keepdims=True) + np.float32(1e-9))
    v = torch.from_numpy(np.ascontiguousarray(vecs)).to(serving.device)
    inv = torch.from_numpy(np.ascontiguousarray(inv_q, np.float32)).to(serving.device)
    return _host(*_serve_similar_vecs(v, inv, serving, bits, ex, k=k))


# -- fold-in publish: dirty rows into the staged serving state -----------------
#
# A published ServingFactors is shared: the query dispatcher may still be
# serving a batch against it when the next state is built. Its tensors are
# never written after publish. A row write off a shared table clones it
# first (copy-on-write); only a table this publish grew itself, which no
# reader has seen, is written in place. The consumer thread and the
# dispatcher both launch their work on the device's default stream, so a
# query launched after the swap is ordered after every write of the
# publish, and the caching allocator reuses an old table's memory only
# behind the kernels that read it.


def _set_rows(table: torch.Tensor, rows: torch.Tensor, values: torch.Tensor,
              private: bool) -> torch.Tensor:
    """table[rows] = values, in place only into a `private` table."""
    out = table if private else table.clone()
    out[rows] = values.to(out.dtype)
    return out


def _set_cols(table: torch.Tensor, cols: torch.Tensor, values: torch.Tensor,
              private: bool) -> torch.Tensor:
    """table[0, cols] = values for the (1, N) scale rows."""
    out = table if private else table.clone()
    out[0, cols] = values
    return out


def _publish_cost(args, kwargs) -> costs.Work:
    table, idx, values, private = args
    row = float(values.nelement() * values.element_size()) / max(1, int(idx.numel()))
    copied = 0.0 if private else float(table.nelement() * table.element_size())
    return costs.publish_rows(copied, int(idx.numel()), row)


_set_rows_cow = devprof.instrument("als.publish_rows_cow", _set_rows, cost=_publish_cost)
_set_rows_donated = devprof.instrument("als.publish_rows_donated", _set_rows,
                                       cost=_publish_cost)
_set_cols_cow = devprof.instrument("als.publish_cols_cow", _set_cols, cost=_publish_cost)
_set_cols_donated = devprof.instrument("als.publish_cols_donated", _set_cols,
                                       cost=_publish_cost)


def _write_rows(table, rows, values, private):
    """`_set_rows` under its publish name: in place into a private
    table, else copy-on-write."""
    return (_set_rows_donated if private else _set_rows_cow)(table, rows, values, private)


def _write_cols(table, cols, values, private):
    return (_set_cols_donated if private else _set_cols_cow)(table, cols, values, private)


def _grow_table(table: torch.Tensor, n: int, fill: float = 0.0,
                axis: int = 0) -> torch.Tensor:
    """`table` extended to `n` along `axis` with `fill`: a new tensor,
    private to the caller."""
    extra = n - int(table.shape[axis])
    if extra <= 0:
        return table
    shape = list(table.shape)
    shape[axis] = extra
    return torch.cat(
        [table, torch.full(shape, fill, dtype=table.dtype, device=table.device)],
        dim=axis,
    )


def serving_publish_rows(
    serving: ServingFactors,
    user_rows: Optional[np.ndarray] = None,
    user_vals: Optional[np.ndarray] = None,  # (Ru, K) f32 solved rows
    item_rows: Optional[np.ndarray] = None,
    item_vals: Optional[np.ndarray] = None,  # (Ri, K) f32 solved rows
    n_users: Optional[int] = None,
    n_items: Optional[int] = None,
) -> ServingFactors:
    """A fold tick's dirty rows published into a new staged state
    without restaging a factor matrix (the JAX package's
    ``serving_publish_rows``): only the dirty rows are quantized (int8)
    or cast (bf16) and written. Tables written off `serving` are copies;
    `serving`'s tensors stay as they were. Growth fills with
    `_stage_arrays`' values (zero factor rows, user and item scale 1.0,
    inverse norm 0.0), and the item slab grows to `pad_items(n_items)`
    rows, so once every live row has been published the state is
    bit-equal to `stage_serving` of the same factors."""
    n_users = max(serving.n_users, 0 if n_users is None else int(n_users))
    n_items_new = max(serving.n_items, 0 if n_items is None else int(n_items))
    users, uscale = serving.users, serving.user_scale
    items, iscale = serving.items, serving.item_scale
    inv = serving.item_inv_norm
    int8 = serving.dtype == "int8"
    dev = serving.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    grown = n_users > serving.n_users
    if grown:
        users = _grow_table(users, n_users)
        if int8:
            uscale = _grow_table(uscale, n_users, 1.0)
    if user_rows is not None and len(user_rows) > 0:
        ur = put(np.asarray(user_rows, np.int64))
        uv = np.asarray(user_vals, np.float32)
        if int8:
            q, s = _rp.quantize_rows_np(uv)
            users = _write_rows(users, ur, put(q), grown)
            uscale = _write_rows(uscale, ur, put(s[:, None]), grown)
        else:
            users = _write_rows(users, ur, put(uv), grown)

    i_p_new = _rp.pad_items(n_items_new)
    grown = i_p_new > int(items.shape[0])  # past the staged pad headroom
    if grown:
        items = _grow_table(items, i_p_new)
        inv = _grow_table(inv, i_p_new, 0.0, axis=1)
        if int8:
            iscale = _grow_table(iscale, i_p_new, 1.0, axis=1)
    if item_rows is not None and len(item_rows) > 0:
        ir = put(np.asarray(item_rows, np.int64))
        iv = np.asarray(item_vals, np.float32)
        if int8:
            q, s = _rp.quantize_rows_np(iv)
            items = _write_rows(items, ir, put(q), grown)
            iscale = _write_cols(iscale, ir, put(s), grown)
        else:
            items = _write_rows(items, ir, put(iv), grown)
        # the cosine verbs' inverse norms follow the rows' new f32 values
        inv = _write_cols(inv, ir, put(_rp.inv_norms_np(iv)[0]), grown)

    return ServingFactors(
        users=users, items=items, user_scale=uscale, item_scale=iscale,
        n_items=n_items_new, dtype=serving.dtype, item_inv_norm=inv,
    )


# -- online fold-in: one side's rows re-solved against the other ---------------


def _fold_in(fixed, edge_idx, edge_val, edge_ok, lam, alpha, *, implicit,
             cg_iterations):
    """Solve R dirty rows' K×K regularized normal equations against the
    fixed opposite factor matrix: one ALS half-step restricted to those
    rows, over a dense (R, E) edge block (the JAX package's
    ``_fold_in_jit``, the same operator assembly as the half-steps).
    Padded slots carry edge_ok = 0 and add nothing."""
    k = fixed.shape[1]
    y = fixed[edge_idx]  # (R, E, K)
    eye = torch.eye(k, dtype=torch.float32, device=fixed.device)
    with full_f32():
        if implicit:
            conf = 1.0 + alpha * torch.abs(edge_val)
            pref = (edge_val > 0).to(torch.float32)
            w_b = conf * pref * edge_ok
            w_g = (conf - 1.0) * edge_ok
            gram = f32_gram(fixed)
            b = torch.einsum("re,rek->rk", w_b, y)
            a = (torch.einsum("rek,rel->rkl", w_g[:, :, None] * y, y)
                 + gram[None, :, :] + lam * eye)
        else:
            b = torch.einsum("re,rek->rk", edge_val * edge_ok, y)
            reg = lam * torch.clamp(torch.sum(edge_ok, dim=1), min=1.0)
            a = (torch.einsum("rek,rel->rkl", edge_ok[:, :, None] * y, y)
                 + reg[:, None, None] * eye)
        return batched_cg(lambda v: torch.einsum("rkl,rl->rk", a, v), b,
                          torch.zeros_like(b), cg_iterations)


_fold_in = devprof.instrument(
    "als.fold_in", _fold_in, memory=True,
    cost=lambda a, kw: costs.fold_in(int(a[1].shape[0]), int(a[1].shape[1]),
                                     int(a[0].shape[0]), int(a[0].shape[1]),
                                     kw["cg_iterations"]),
    dtype_of=lambda a, kw: "f32")


def _fold_edge_bucket(n: int) -> int:
    """Pow2 ladder with a floor of 8 for the per-row edge axis: a few
    distinct shapes for the stream of ticks."""
    return max(8, 1 << (max(n, 1) - 1).bit_length())


def fold_in_rows(
    fixed,  # (N, K) opposite-side factors, numpy or a tensor
    edges: Sequence[Sequence[tuple[int, float]]],  # per row: (fixed row, value)
    params: ALSParams,
    device=None,
) -> np.ndarray:
    """Re-solve each dirty row's regularized least squares against the
    FIXED opposite factor matrix and return the (R, K) solved factors,
    on the card unless `device` says otherwise (the JAX package's
    ``fold_in_rows``). Rows pad to `batch_bucket`, edges to
    `_fold_edge_bucket`; padded rows and slots carry edge_ok = 0. A row
    with no edges solves to exactly zero."""
    from predictionio_tpu_torch.utils.bucket import batch_bucket

    if not edges:
        return np.zeros((0, params.rank), np.float32)
    dev = resolve_device(device)
    r_pad = batch_bucket(len(edges))
    e_pad = _fold_edge_bucket(max(len(e) for e in edges))
    idx = np.zeros((r_pad, e_pad), np.int64)
    val = np.zeros((r_pad, e_pad), np.float32)
    ok = np.zeros((r_pad, e_pad), np.float32)
    # packed without a Python loop over the edges: the consumer packs up
    # to ~30,000 a tick while the query threads want the interpreter
    lens = np.fromiter(map(len, edges), np.int64, len(edges))
    flat = np.fromiter(chain.from_iterable(chain.from_iterable(edges)),
                       np.float64, 2 * int(lens.sum())).reshape(-1, 2)
    rows = np.repeat(np.arange(len(edges)), lens)
    slots = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    idx[rows, slots] = flat[:, 0].astype(np.int64)
    val[rows, slots] = flat[:, 1]
    ok[rows, slots] = 1.0
    fx = (fixed.to(dev, torch.float32) if isinstance(fixed, torch.Tensor)
          else torch.from_numpy(np.ascontiguousarray(fixed, np.float32)).to(dev))

    def put(a):
        return torch.from_numpy(a).to(dev)

    solved = _fold_in(fx, put(idx), put(val), put(ok), params.lambda_,
                      params.alpha, implicit=params.implicit_prefs,
                      cg_iterations=params.cg_iterations)
    return solved[:len(edges)].cpu().numpy()
