"""The work each instrumented device function does, counted from its
call's shapes.

XLA reports a compiled program's flops and bytes (``cost_analysis``);
torch has no counterpart, so every ``devprof.instrument`` site passes a
cost function built from these formulas, and ``chip_smoke.py``'s
bounds use the same ones: the profiler's roofline and the times phases'
bounds reckon the same work.

A ``Work`` is the operations by operand type (``"f32"``, ``"bf16"``,
``"int8"``: each runs at its own peak) and the bytes the function must
move: each input read once, each output written once. Operations are
multiplies and adds, two a multiply-add. Counts are exact for the
kernels (``topk``, ``masked_topk``, ``dense_pass``, ``block_partials``,
``combine_windows``) and the dominant terms elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple

_ESIZE = {"f32": 4, "bf16": 2, "int8": 1}


class Work(NamedTuple):
    ops: dict  # operand type → operations
    bytes: float

    @property
    def flops(self) -> float:
        return float(sum(self.ops.values()))

    def __add__(self, other: "Work") -> "Work":  # type: ignore[override]
        ops = dict(self.ops)
        for dt, n in other.ops.items():
            ops[dt] = ops.get(dt, 0.0) + n
        return Work(ops, self.bytes + other.bytes)

    def scaled(self, n: float) -> "Work":
        return Work({dt: v * n for dt, v in self.ops.items()}, self.bytes * n)

    def bound(self, hbm_bps: float, peaks: dict) -> tuple[float, str]:
        """(least seconds, "bytes" or "operations"): the bytes over the
        memory rate against each type's operations over its peak."""
        bytes_s = self.bytes / hbm_bps
        ops_s = sum(n / peaks[dt] for dt, n in self.ops.items())
        return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


NONE = Work({}, 0.0)


def topk(b: int, i_p: int, rank: int, k: int, dtype: str, scaled: bool,
         mask_bytes: float = 0.0) -> Work:
    """The scored top-k selector: the query block and the item slab
    read, (score, index) pairs written; 2·B·I_p·K products in the
    slab's type, with the scale products in f32 when scaled (int8 and
    the cosine verbs)."""
    esz = _ESIZE[dtype]
    nbytes = (b + i_p) * rank * esz + b * k * 8 + mask_bytes
    ops = {dtype: 2.0 * b * i_p * rank}
    if scaled:
        nbytes += (b + i_p) * 4
        ops["f32"] = ops.get("f32", 0.0) + 2.0 * b * i_p
    return Work(ops, float(nbytes))


def masked_topk(b: int, i_p: int, k: int, mask_bytes: float | None = None) -> Work:
    """The masked top-k over precomputed scores: the f32 scores and the
    exclusion (bit words unless `mask_bytes` says otherwise) read, the
    pairs written (compares are not counted)."""
    mask = b * (i_p // 32) * 4 if mask_bytes is None else mask_bytes
    return Work({}, float(b * i_p * 4 + mask + b * k * 8))


def dense_pass(n_rows: int, n_cols: int, k: int, which: str,
               storage: str = "int8") -> Work:
    """One dense edge pass: R read once, the factor input read once,
    both outputs (K + K² columns) written once. The int8 kernel takes
    2·n_r·n_c·(K + K(K+1)/2) bf16 tensor-core operations (corr is
    symmetric: one product a pair i <= j); the f32 and bf16 storage
    passes are f32 matrix products over the full K²."""
    n_in, n_out = (n_cols, n_rows) if which == "row" else (n_rows, n_cols)
    nbytes = n_rows * n_cols * _ESIZE[storage] + n_in * k * 4 + n_out * (k + k * k) * 4
    if storage == "int8":
        ops = {"bf16": 2.0 * n_rows * n_cols * (k + k * (k + 1) // 2)}
    else:
        ops = {"f32": 2.0 * n_rows * n_cols * (k + k * k)}
    return Work(ops, float(nbytes))


def densify(n_edges: int, n_rows_p: int, n_cols_p: int, storage: str) -> Work:
    """The dense rating matrix written once and the COO triples read."""
    return Work({}, float(n_rows_p * n_cols_p * _ESIZE[storage] + n_edges * 20))


def block_partials(slots: int, n_src: int, n_blocks_p: int, s_rows: int, k: int,
                   edges: int | None = None) -> Work:
    """`block_partials`: 16 B a slot (source row, two weights, local
    row) and the factors read once, the partials written once; 2·E·(K +
    K²) f32 operations, E the edges that carry weight (every slot when
    not given)."""
    d = k + k * k
    nbytes = slots * 16 + n_src * k * 4 + n_blocks_p * s_rows * d * 4
    e = slots if edges is None else edges
    return Work({"f32": 2.0 * e * d}, float(nbytes))


def combine_windows(n_blocks_p: int, s_rows: int, n_windows: int, k: int) -> Work:
    """The combine: the partials and block ids read once, the window
    sums written once (its adds, far fewer, not counted)."""
    d = k + k * k
    parts = n_blocks_p * s_rows * d * 4
    return Work({}, float(parts + n_blocks_p * 4 + n_windows * s_rows * d * 4))


def cg(n: int, k: int, iterations: int, flat: bool = True) -> Work:
    """`iterations` steps of batched CG over n rows of K: with the flat
    (n, K²) operators, each step reads them once (a matvec of 2·K²
    operations a row) and does ~10·K vector operations a row."""
    ops = 2.0 * n * k * k + 10.0 * n * k if flat else 10.0 * n * k
    nbytes = n * k * k * 4 + 6 * n * k * 4 if flat else 6 * n * k * 4
    return Work({"f32": ops}, float(nbytes)).scaled(iterations)


def gram(n: int, k: int) -> Work:
    """YᵀY of an (n, K) factor matrix."""
    return Work({"f32": 2.0 * n * k * k}, float(n * k * 4 + k * k * 4))


def dense_train_iteration(n_rows: int, n_cols: int, k: int, cg_iterations: int,
                          storage: str = "int8", implicit: bool = True) -> Work:
    """One iteration of the dense alternating loop: a row pass and a col
    pass over R, the operators' CG on both sides, and (implicit) the
    fixed side's gram for each."""
    w = (dense_pass(n_rows, n_cols, k, "row", storage)
         + dense_pass(n_rows, n_cols, k, "col", storage)
         + cg(n_rows, k, cg_iterations) + cg(n_cols, k, cg_iterations))
    if implicit:
        w = w + gram(n_cols, k) + gram(n_rows, k)
    return w


def windowed_train_iteration(sides, k: int, cg_iterations: int, s_rows: int,
                             implicit: bool = True) -> Work:
    """One iteration of the windowed loop. `sides` holds each half-step's
    (slots, n_src, n_blocks_p, n_windows, n_dst_p, edges): its
    `block_partials`, the combine, CG over the solved rows and the fixed
    side's gram."""
    w = NONE
    for slots, n_src, n_blocks_p, n_windows, n_dst_p, edges in sides:
        w = (w + block_partials(slots, n_src, n_blocks_p, s_rows, k, edges)
             + combine_windows(n_blocks_p, s_rows, n_windows, k)
             + cg(n_dst_p, k, cg_iterations))
        if implicit:
            w = w + gram(n_src, k)
    return w


def scatter_train_iteration(n_edges: int, n_users: int, n_items: int, k: int,
                            cg_iterations: int, flat: bool) -> Work:
    """One iteration of the scatter loop: per side, b and the gram
    corrections by gathers and `index_add_` over the edges (up to rank
    32 one pass builds the flat operators; above it CG runs matrix-free,
    one edge pass a matvec), and CG over the solved rows."""
    w = NONE
    for n_dst, n_src in ((n_users, n_items), (n_items, n_users)):
        gather = Work({"f32": 2.0 * n_edges * k}, float(n_edges * (k * 4 + 24)))
        if flat:
            corr = Work({"f32": 2.0 * n_edges * k * k},
                        float(n_edges * (k * 4 + 16) + n_dst * k * k * 4))
            w = w + gather + corr + cg(n_dst, k, cg_iterations) + gram(n_src, k)
        else:
            matvec = Work({"f32": 4.0 * n_edges * k},
                          float(n_edges * (2 * k * 4 + 16))).scaled(cg_iterations)
            w = w + gather + matvec + cg(n_dst, k, cg_iterations, flat=False) + gram(n_src, k)
    return w


def fold_in(n_rows: int, n_slots: int, n_fixed: int, k: int, cg_iterations: int) -> Work:
    """The fold solve of R rows over E edge slots: the gathered factors,
    b and the per-row operators by einsum, the fixed side's gram, CG."""
    re = n_rows * n_slots
    einsums = Work({"f32": 2.0 * re * k + 2.0 * re * k * k},
                   float(re * (k * 4 + 16) + n_rows * k * k * 4))
    return einsums + gram(n_fixed, k) + cg(n_rows, k, cg_iterations)


def publish_rows(table_bytes: float, rows: int, row_bytes: float) -> Work:
    """A copy-on-write row publish: the tables copied (read and written)
    and the dirty rows written."""
    return Work({}, float(2 * table_bytes + rows * row_bytes))


def cooccurrence_topn(n_users: int, n_items: int, n_cols: int, top_n: int) -> Work:
    """One CCO item block: the (I, J) count product over the users, the
    LLR of every cell (~40 f32 operations) and the top-n."""
    ops = 2.0 * n_users * n_items * n_cols + 40.0 * n_items * n_cols
    nbytes = (n_users * (n_items + n_cols) * 4 + 2 * n_items * n_cols * 4
              + n_items * top_n * 8)
    return Work({"f32": ops}, float(nbytes))


def history_scores(b: int, n_items: int, i_p: int, correlators) -> Work:
    """The UR history scoring: per indicator (T correlators an item, J
    target items), each item's correlators read and one multiply and
    one add a (query, correlator); the (B, I_p) scores written."""
    ops = 0.0
    nbytes = float(b * i_p * 4)
    for t, j in correlators:
        ops += 2.0 * b * n_items * t
        nbytes += n_items * t * 8 + b * (j + 1) * 4
    return Work({"f32": ops}, nbytes)


def matmul(m: int, n: int, k: int, out_bytes: float | None = None) -> Work:
    """An (m, k) @ (k, n) f32 product: operands read, output written."""
    nbytes = (m * k + k * n) * 4 + (m * n * 4 if out_bytes is None else out_bytes)
    return Work({"f32": 2.0 * m * n * k}, float(nbytes))
