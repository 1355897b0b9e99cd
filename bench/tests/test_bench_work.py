"""The frozen work counts and peaks against hand-computed values."""
import pytest

from mfbench import peaks, work


def test_herm_work_by_hand():
    # 10 ratings over 3 rows, f = 4, gathered from a 5-row factor:
    # 10 * (4 * 5 + 2 * 4) ops; 5*4*4 + 10*8 + 3*8 + 3*16*4 + 3*4*4 bytes
    assert work.herm_work(10, 3, 4, 5) == (280.0, 424.0)


def test_solve_work_by_hand():
    # 3 solves of 4 x 4: 3 * (64/3 + 32) ops; A (3*16*4) and B, x (2*3*4*4) bytes
    ops, nbytes = work.solve_work(3, 4)
    assert ops == pytest.approx(160.0)
    assert nbytes == 288.0


def test_iteration_ops_adds_both_sides_and_the_evaluation():
    users, items, train, test, f = 7, 5, 20, 4, 3
    expect = (work.herm_work(train, users, f, items)[0] + work.herm_work(train, items, f, users)[0]
              + work.solve_work(users, f)[0] + work.solve_work(items, f)[0] + 2 * (train + test) * f)
    assert work.als_iteration_ops(users, items, train, test, f) == pytest.approx(expect)


def test_sgd_work_by_hand():
    # 6 f ops a rating; X and Theta read and written, 8 B a rating, 4 B a row count
    assert work.sgd_work(10, 4, 6, 5, 2, 3) == (240.0, 2 * 6 * 16 + 2 * 5 * 16 + 80 + 24)


def test_bound_takes_the_larger_term():
    assert peaks.PEAK_FP32_FLOPS == 67e12 and peaks.PEAK_HBM_BYTES_S == 3.35e12
    assert peaks.bound_s(67e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 6.7e12) == pytest.approx(2.0)
