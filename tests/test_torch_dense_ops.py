"""Port parity for the dense ALS edge passes and the solver primitives.

The same inputs, made with numpy from a seed, go through the JAX
package (``ops/dense_pallas.py`` in interpret mode, the XLA passes of
``ops/dense.py``, ``ops/segment.py``, ``ops/windowed.py``) and the
port's counterparts on the CPU, where the fused wrappers run their
plain PyTorch versions.

Tolerances:
- fused passes: ``|port − jax| ≤ 1e-5 · S`` elementwise, where S is
  the same pass over the absolute terms (|w1|·|y|, |wg|·|z|). Both
  sides take exact bf16×bf16 products and f32 sums, so they differ
  only in summation order, which moves a sum by at most a few f32 ulps
  of S. The same bar holds the kernel to its plain version on the card.
- f32 passes: rtol = atol = 1e-4, the JAX package's own bar against a
  per-edge fold (tests/test_dense_als.py).
- primitives: rtol 1e-5, atol 1e-6 (f32 sums in another order).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.ops import dense as jdense  # noqa: E402
from predictionio_tpu.ops import dense_pallas as jdp  # noqa: E402
from predictionio_tpu.ops import segment as jseg  # noqa: E402
from predictionio_tpu.ops import windowed as jwin  # noqa: E402
from predictionio_tpu_torch.ops import dense as tdense  # noqa: E402
from predictionio_tpu_torch.ops import dense_fused as tdf  # noqa: E402
from predictionio_tpu_torch.ops import segment as tseg  # noqa: E402
from predictionio_tpu_torch.ops import windowed as twin  # noqa: E402

SCALE, ALPHA = 2.0, 1.7


def _ratings(rng, n_rows, n_cols, signed, density=0.05):
    lo = -10 if signed else 1
    q = rng.integers(lo, 11, (n_rows, n_cols)).astype(np.int8)
    q[rng.random((n_rows, n_cols)) > density] = 0
    return q


def _ascale(implicit):
    return float(np.float32(ALPHA / SCALE if implicit else 1.0 / SCALE))


def _outer(x):
    return (x[:, :, None] * x[:, None, :]).reshape(x.shape[0], -1)


def _within_order_bound(got, want, mag, what):
    got, want, mag = (np.asarray(a, np.float64) for a in (got, want, mag))
    excess = np.abs(got - want) - 1e-5 * mag
    assert excess.max() <= 0.0, (
        f"{what}: |Δ| beyond 1e-5·S by {excess.max():.3g} at "
        f"{np.unravel_index(excess.argmax(), excess.shape)}"
    )


# ---------------------------------------------------------------------------
# the fused (one R read) passes vs the JAX Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("k", [10, 32])
@pytest.mark.parametrize("which", ["row", "col"])
def test_fused_pass_matches_pallas_interpret(which, k, implicit, signed):
    rng = np.random.default_rng(100 + k + 2 * implicit + signed)
    n = 512
    q = _ratings(rng, n, n, signed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    asc = _ascale(implicit)
    jfn = jdp.fused_row_pass if which == "row" else jdp.fused_col_pass
    jb, jc = jfn(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(_outer(x)),
        jnp.asarray([asc], jnp.float32), implicit=implicit,
        interpret=True, row_tile=256, col_tile=256,
    )
    plain = (tdf.fused_row_pass_plain if which == "row"
             else tdf.fused_col_pass_plain)
    rt, xt = torch.from_numpy(q), torch.from_numpy(x)
    tb, tc = plain(rt, xt, asc, implicit=implicit)
    sb, sc = plain(rt, xt, asc, implicit=implicit, magnitude=True)
    assert tb.shape == (n, k) and tc.shape == (n, k * k)
    _within_order_bound(tb, jb, sb, f"{which} b")
    _within_order_bound(tc, jc, sc, f"{which} corr")
    assert float(sc.min()) >= 0.0 and float(sc.max()) > 0.0


@pytest.mark.parametrize("which", ["row", "col"])
def test_fused_wrapper_runs_plain_on_cpu(which):
    """On a CPU tensor the wrapper is the plain version, bit for bit,
    and launches nothing; ragged dims and K = 1 are fine."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_ratings(rng, 300, 77, True, density=0.2))
    n_side = 77 if which == "row" else 300
    for k in (1, 5):
        x = torch.from_numpy(rng.standard_normal((n_side, k)).astype(np.float32))
        before = dict(tdf.PASS_LAUNCHES)
        fn = tdf.fused_row_pass if which == "row" else tdf.fused_col_pass
        plain = (tdf.fused_row_pass_plain if which == "row"
                 else tdf.fused_col_pass_plain)
        got = fn(q, x, 0.5, implicit=True)
        want = plain(q, x, 0.5, implicit=True)
        assert tdf.PASS_LAUNCHES == before
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_fused_wrapper_rejects_bad_inputs():
    r = torch.zeros((8, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        tdf.fused_row_pass(r.float(), torch.zeros((16, 4)), 1.0, implicit=True)
    with pytest.raises(ValueError, match="factors"):
        tdf.fused_row_pass(r, torch.zeros((8, 4)), 1.0, implicit=True)
    with pytest.raises(ValueError, match="rank"):
        tdf.fused_col_pass(r, torch.zeros((8, 33)), 1.0, implicit=True)


def test_zero_cells_contribute_nothing():
    """Both kernels and the plain versions multiply zero cells. With
    finite factors their terms are exactly zero, so an all-zero matrix
    gives exact zeros."""
    x = torch.randn((64, 6))
    for implicit in (True, False):
        b, c = tdf.fused_col_pass_plain(
            torch.zeros((64, 40), dtype=torch.int8), x, 0.5, implicit=implicit)
        assert not b.any() and not c.any()


def _csrc_constant(name):
    import re

    src = (Path(tdf.__file__).parent / "csrc" / "dense_pass.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_row_operand_constants_match_the_kernel_source():
    assert tdf.OPERAND_BLOCK_COLS == 8 * _csrc_constant("TC_TILES")
    assert tdf.ROW_STRIP == 16 * _csrc_constant("TC_WARPS")
    assert tdf.MAX_RANK == _csrc_constant("MAX_K")


@pytest.mark.parametrize("n_rows,k,ctas", [
    (139_264, 10, 1_088),              # the ML-20M slab: one column block
    (139_264, 32, 8_704),              # eight column blocks
    (8_388_608, 32, 524_288),          # past 65,535 strips (8,388,480 rows)
    (35_000_000, 32, 2_187_504),       # the dense gate's widest user count
    ((2**31 - 1) * 128, 1, 2**31 - 1),  # one column block: the grid's limit
])
def test_row_pass_ctas(n_rows, k, ctas):
    """The row pass kernel's 1-D grid (strips x column blocks) holds any
    user count the dense gate admits: no cap at 65,535 strips."""
    assert tdf.row_pass_ctas(n_rows, k) == ctas


def test_row_pass_ctas_refuses_past_the_grid():
    with pytest.raises(ValueError, match="CTAs"):
        tdf.row_pass_ctas((2**31 - 1) // 8 * 128 + 128, 32)


def _pad8(n):
    return -(-n // 8) * 8


@pytest.mark.parametrize("k", [1, 8, 10, 11, 16, 32])
def test_row_operand_matches_jax_y16_z16(k):
    """The pass kernels' B operand [Y16 | Z16], formed by the
    wrapper, holds the JAX package's kernel operands bit for bit: y16 =
    bf16(y) (dense_pallas.fused_row_pass) and z16 = bf16(y_i · y_j
    formed in f32) (als._dense_half_step's z32), at the pairs i ≤ j in
    row-major order (corr is symmetric), zeros in the pads up to whole
    column blocks."""
    rng = np.random.default_rng(200 + k)
    n = 300
    y = rng.standard_normal((n, k)).astype(np.float32)
    jy = jnp.asarray(y)
    y16 = np.asarray(jy.astype(jnp.bfloat16)).view(np.int16)
    z32 = (jy[:, :, None] * jy[:, None, :]).reshape(n, k * k).astype(jnp.float32)
    z16 = np.asarray(z32.astype(jnp.bfloat16)).view(np.int16)
    iu, ju = np.triu_indices(k)
    # the symmetric half is the same bits
    assert np.array_equal(z16[:, iu * k + ju], z16[:, ju * k + iu])
    op = tdf.pass_operand(torch.from_numpy(y))
    kp, pairs = _pad8(k), len(iu)
    width = tdf.operand_column_blocks(k) * tdf.OPERAND_BLOCK_COLS
    assert op.dtype == torch.bfloat16 and tuple(op.shape) == (n, width)
    assert width - tdf.OPERAND_BLOCK_COLS < kp + _pad8(pairs) <= width
    assert op.is_contiguous()
    bits = op.view(torch.int16).numpy()
    assert np.array_equal(bits[:, :k], y16)
    assert np.array_equal(bits[:, kp:kp + pairs], z16[:, iu * k + ju])
    assert not bits[:, k:kp].any() and not bits[:, kp + pairs:].any()


def _operand_col_pass(q, x, ascale, implicit):
    """The col pass kernel's layout in plain torch: w1 and wg of R
    transposed times the operand [X16 | Z16] over R's rows, b from its
    first K columns, each pair i <= j of corr (from column K rounded up
    to 8, row-major) stored to (i, j) and (j, i)."""
    k = x.shape[1]
    op = tdf.pass_operand(x).float()
    w1, wg = tdf._fused_weights(q.float(), torch.tensor(ascale), implicit)
    kp = _pad8(k)
    iu, ju = torch.triu_indices(k, k)
    b = w1.T @ op[:, :k]
    pairs = wg.T @ op[:, kp:kp + len(iu)]
    corr = torch.empty((q.shape[1], k, k))
    corr[:, iu, ju] = pairs
    corr[:, ju, iu] = pairs
    return b, corr.reshape(q.shape[1], k * k)


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("k", [1, 10, 11, 16, 32])
def test_col_pass_operand_layout_matches_plain_and_pallas(k, implicit):
    """The contraction the col pass kernel does (the operand's rows in
    R's row order, the pairs expanded as it stores them) equals the
    plain col pass and the JAX kernel in interpret mode within 1e-5·S."""
    rng = np.random.default_rng(300 + k + implicit)
    n_rows, n_cols = 384, 256
    q = _ratings(rng, n_rows, n_cols, signed=True, density=0.2)
    x = rng.standard_normal((n_rows, k)).astype(np.float32)
    asc = _ascale(implicit)
    rt, xt = torch.from_numpy(q), torch.from_numpy(x)
    ob, oc = _operand_col_pass(rt, xt, asc, implicit)
    pb, pc = tdf.fused_col_pass_plain(rt, xt, asc, implicit=implicit)
    sb, sc = tdf.fused_col_pass_plain(rt, xt, asc, implicit=implicit,
                                      magnitude=True)
    jb, jc = jdp.fused_col_pass(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(_outer(x)),
        jnp.asarray([asc], jnp.float32), implicit=implicit,
        interpret=True, row_tile=128, col_tile=128,
    )
    for want, what in (((pb, pc), "plain"), ((jb, jc), "pallas")):
        _within_order_bound(ob, want[0], sb, f"operand b vs {what}")
        _within_order_bound(oc, want[1], sc, f"operand corr vs {what}")
    assert float(sc.max()) > 0.0


@pytest.mark.parametrize("k,blocks", [(1, 1), (10, 1), (11, 2), (16, 3), (32, 8)])
def test_row_column_blocks(k, blocks):
    """One column block (one read of R) up to K = 10: 16 + 56 = 72
    columns; K = 32 needs 32 + 528 = 560 columns, eight blocks."""
    assert tdf.operand_column_blocks(k) == blocks


# ---------------------------------------------------------------------------
# the XLA-counterpart passes (f32 / bf16 / int8 storage)
# ---------------------------------------------------------------------------


def _coo(n_users, n_items, n_edges, seed, signed=False):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, n_users, n_edges).astype(np.int32)
    cols = rng.randint(0, n_items, n_edges).astype(np.int32)
    key = rows.astype(np.int64) * n_items + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = (rng.randint(1, 11, len(rows)) / 2.0).astype(np.float32)
    if signed:
        vals *= rng.choice([-1.0, 1.0], len(rows)).astype(np.float32)
    return rows, cols, vals


def _both_dense(rows, cols, vals, nup, nip, dense_dtype, scale=1.0):
    jr = jdense.densify(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        n_rows_p=nup, n_cols_p=nip, dense_dtype=dense_dtype, scale=scale,
    )
    tr = tdense.densify(
        torch.from_numpy(rows).long(), torch.from_numpy(cols).long(),
        torch.from_numpy(vals), n_rows_p=nup, n_cols_p=nip,
        dense_dtype=dense_dtype, scale=scale,
    )
    return jr, tr


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("implicit", [True, False])
def test_f32_passes_match_jax(implicit, signed):
    nu, ni, k = 100, 70, 8
    rows, cols, vals = _coo(nu, ni, 900, seed=1, signed=signed)
    nup, nip = 2048, 256
    jr, tr = _both_dense(rows, cols, vals, nup, nip, "f32")
    rng = np.random.RandomState(2)
    y = np.zeros((nip, k), np.float32)
    y[:ni] = rng.randn(ni, k)
    x = np.zeros((nup, k), np.float32)
    x[:nu] = rng.randn(nu, k)
    kw = dict(implicit=implicit, alpha=2.0)
    for jfn, tfn, f in ((jdense.dense_row_pass, tdense.dense_row_pass, y),
                        (jdense.dense_col_pass, tdense.dense_col_pass, x)):
        jb, jc = jfn(jr, jnp.asarray(f), dense_dtype="f32", **kw)
        tb, tc = tfn(tr, torch.from_numpy(f), **kw)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("implicit", [True, False])
def test_bf16_passes_match_jax(implicit):
    """bf16 storage computes in bf16: weights in bf16 arithmetic, bf16
    operands, f32 sums. Both sides round the same bf16 operands, so only
    the summation order differs (f32 noise on sums of order 10)."""
    nu, ni, k = 120, 90, 6
    rows, cols, vals = _coo(nu, ni, 1500, seed=3, signed=True)
    nup, nip = 2048, 256
    jr, tr = _both_dense(rows, cols, vals, nup, nip, "bf16")
    rng = np.random.RandomState(4)
    y = np.zeros((nip, k), np.float32)
    y[:ni] = rng.randn(ni, k)
    x = np.zeros((nup, k), np.float32)
    x[:nu] = rng.randn(nu, k)
    kw = dict(implicit=implicit, alpha=1.5)
    for jfn, tfn, f in ((jdense.dense_row_pass, tdense.dense_row_pass, y),
                        (jdense.dense_col_pass, tdense.dense_col_pass, x)):
        jb, jc = jfn(jr, jnp.asarray(f), dense_dtype="bf16", **kw)
        tb, tc = tfn(tr, torch.from_numpy(f), **kw)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dense_dtype,scale",
                         [("f32", 1.0), ("bf16", 1.0), ("int8", 2.0), ("int8", 10.0)])
def test_densify_matches_jax(dense_dtype, scale):
    rows, cols, vals = _coo(50, 40, 400, seed=5, signed=True)
    if scale == 10.0:
        vals = (np.round(vals * 5) / 10).astype(np.float32)  # tenths
    jr, tr = _both_dense(rows, cols, vals, 64, 48, dense_dtype, scale)
    want = np.asarray(jr.astype(jnp.float32))
    assert tr.dtype == tdense.storage_dtype(dense_dtype)
    np.testing.assert_array_equal(tr.float().numpy(), want)


def test_densify_rounds_half_to_even():
    vals = np.array([0.25, 0.75, -0.25, 1.25], np.float32)  # ×2: .5 ties
    idx = np.arange(4, dtype=np.int32)
    jr, tr = _both_dense(idx, idx, vals, 4, 4, "int8", 2.0)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tr.diagonal().tolist() == [0, 2, 0, 2]


@pytest.mark.parametrize("vals", [
    [0.5, 1.0, 4.5, 5.0], [1, 2, 127], [3, 200], [0.1, 0.3], [0.0],
    [], [0.333], [-2.5, 1.5], [0.05, 1.0], [1e-3],
])
def test_int8_scale_matches_jax(vals):
    v = np.asarray(vals, np.float32)
    assert tdense.int8_scale(v) == jdense.int8_scale(v)


def test_dense_passes_refuse_other_storage():
    r = torch.zeros((8, 16), dtype=torch.int8)
    y = torch.zeros((16, 3))
    with pytest.raises(ValueError, match="dense_fused"):
        tdense.dense_row_pass(r, y, implicit=True, alpha=1.0)
    with pytest.raises(ValueError, match="bf16"):
        tdense.dense_col_pass(r.half(), torch.zeros((8, 3)), implicit=True,
                              alpha=1.0)


def test_bytes_per_cell_and_storage_dtype():
    assert tdense.BYTES_PER_CELL == jdense.BYTES_PER_CELL
    assert (tdense.ROW_BLOCK, tdense.COL_PAD) == (jdense.ROW_BLOCK, jdense.COL_PAD)
    for mode in ("f32", "bf16", "int8"):
        assert (str(tdense.storage_dtype(mode)).split(".")[-1]
                == {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}[mode])


def test_f32_gram_matches_jax():
    a = np.random.default_rng(6).standard_normal((3000, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tseg.f32_gram(torch.from_numpy(a)).numpy(),
        np.asarray(jseg.f32_gram(jnp.asarray(a))), rtol=1e-5, atol=1e-6 * 3000,
    )


def test_full_f32_restores_the_tf32_flags():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tseg.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]


def _spd_flat(rng, n, k):
    m = rng.standard_normal((n, k, k)).astype(np.float32)
    a = np.einsum("nij,nkj->nik", m, m) / k + np.eye(k, dtype=np.float32)
    return a.reshape(n, k * k).astype(np.float32)


@pytest.mark.parametrize("k", [1, 10, 32])
def test_flat_gram_matvec_matches_jax(k):
    rng = np.random.default_rng(8 + k)
    a = _spd_flat(rng, 200, k)
    v = rng.standard_normal((200, k)).astype(np.float32)
    np.testing.assert_allclose(
        twin.flat_gram_matvec(torch.from_numpy(a), torch.from_numpy(v)).numpy(),
        np.asarray(jwin.flat_gram_matvec(jnp.asarray(a), jnp.asarray(v))),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("iterations", [1, 3, 5])
def test_batched_cg_matches_jax(iterations):
    rng = np.random.default_rng(9)
    n, k = 300, 8
    a = _spd_flat(rng, n, k)
    b = rng.standard_normal((n, k)).astype(np.float32)
    x0 = np.zeros((n, k), np.float32)
    x0[::3] = rng.standard_normal((n // 3, k))
    b[5] = 0.0  # a converged row: frozen by the tolerance
    x0[5] = 0.0
    ta = torch.from_numpy(a)
    got = tseg.batched_cg(lambda v: twin.flat_gram_matvec(ta, v),
                          torch.from_numpy(b), torch.from_numpy(x0), iterations)
    ja = jnp.asarray(a)
    want = jseg.batched_cg(lambda v: jwin.flat_gram_matvec(ja, v),
                           jnp.asarray(b), jnp.asarray(x0), iterations)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not got[5].any()
