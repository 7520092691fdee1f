"""The UR train phase's card check in `chip_smoke.py`, on the CPU.

The phase holds the card's CCO tables to the same block train on the
host CPU in float32 at the LLR tolerance (atol = 16 eps N ln N). A host
whose float32 `log` is poor can disagree with a right card beyond it
(one correlator read 15.4140625 on such a host, 15.2421875 on the card
and 15.2398 in float64). Where the two disagree on a row, the float64
LLR of the same counts decides, at the same atol, with indices compared
as sets inside tie groups. These tests give the check seeded tables: a
host off on one row (passes, the row reported as disputed), a card off
on a value or an index (fails), and the float64 rows against the
float32 block train.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from predictionio_tpu_torch.models import cco

U, I, TOP = 400, 64, 12


def _indicator(seed):
    rng = np.random.default_rng(seed)
    hot = rng.random(I) ** 2  # skewed item popularity
    p = (rng.random((U, I)) < 0.02 + 0.2 * hot).astype(np.float32)
    return torch.from_numpy(p)


def _tables(p, s, exclude_diagonal):
    v, i = cco._cco_topn(p, s, U, 0, top_n=TOP, exclude_diagonal=exclude_diagonal)
    return v.numpy().copy(), i.numpy().copy()


@pytest.mark.parametrize("exclude_diagonal", [True, False])
def test_the_float64_rows_match_the_float32_block_train(exclude_diagonal):
    p = _indicator(1)
    s = p if exclude_diagonal else _indicator(2)
    v, i = _tables(p, s, exclude_diagonal)
    atol = chip_smoke._llr_atol(U)
    for r in range(I):
        fv, fi = chip_smoke._llr_f64_row(p, s, r, U, TOP, exclude_diagonal)
        assert np.abs(fv - v[r]).max() <= atol
        assert chip_smoke._row_mismatches(fv, fi, i[r], atol) == 0
    assert (v > 0).any()


def test_a_host_off_on_one_row_is_settled_by_float64():
    p = _indicator(3)
    card = _tables(p, p, True)
    cpu = (card[0].copy(), card[1].copy())
    atol = chip_smoke._llr_atol(U)
    row = int(np.argmax(card[0][:, 0]))
    cpu[0][row, 0] += 4 * atol  # the host's float32 log is off here
    dv, disputed = chip_smoke._hold_ur_block(p, p, 0, cpu, card, U, True)
    assert dv == 0.0 and [d["item"] for d in disputed] == [row]
    d = disputed[0]
    assert d["card_vs_f64"] <= atol < d["cpu_vs_f64"]
    assert d["card_index_mismatches_vs_f64"] == 0


def test_an_agreeing_host_disputes_nothing():
    p = _indicator(4)
    card = _tables(p, p, True)
    dv, disputed = chip_smoke._hold_ur_block(p, p, 0, card, card, U, True)
    assert dv == 0.0 and disputed == []


def test_a_card_off_the_float64_llr_fails():
    p = _indicator(5)
    cpu = _tables(p, p, True)
    atol = chip_smoke._llr_atol(U)
    card = (cpu[0].copy(), cpu[1].copy())
    row = int(np.argmax(cpu[0][:, 0]))
    card[0][row, 0] -= 4 * atol
    with pytest.raises(chip_smoke.PhaseError, match="off the float64 LLR"):
        chip_smoke._hold_ur_block(p, p, 0, cpu, card, U, True)


def test_a_card_index_out_of_its_tie_group_fails():
    p = _indicator(6)
    cpu = _tables(p, p, True)
    atol = chip_smoke._llr_atol(U)
    v, i = cpu
    # a row whose first two correlators are apart by more than atol, and
    # not the last run: swapping their indices is a real mismatch
    row = next(r for r in range(I)
               if v[r, 0] - v[r, 1] > atol and v[r, 1] - v[r, 2] > atol and i[r, 2] >= 0)
    card = (v.copy(), i.copy())
    card[1][row, [0, 1]] = card[1][row, [1, 0]]
    with pytest.raises(chip_smoke.PhaseError, match="off the float64 LLR"):
        chip_smoke._hold_ur_block(p, p, 0, cpu, card, U, True)
