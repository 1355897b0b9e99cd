"""Operations and bytes of the ALS and SGD work, from shapes alone.

The counts are those of the port's on-card smoke test (its phases 7 and
8), frozen here: each input byte is counted once, each output byte once,
whatever a kernel reads again.
"""
from __future__ import annotations


def herm_work(nnz: int, rows: int, f: int, fixed_rows: int) -> tuple[float, float]:
    """(ops, bytes) of A_u = sum theta_v theta_v^T + lam n_u I and
    B_u = Theta^T r_u over ``rows`` rows holding ``nnz`` ratings, gathered
    from a fixed factor of ``fixed_rows`` rows: the symmetric half of each
    outer product and the B products; the fixed factor, the ratings'
    indices and values, the counts and the diagonal read, A and B written."""
    ops = nnz * (f * (f + 1) + 2 * f)
    nbytes = fixed_rows * f * 4 + nnz * 8 + rows * 8 + rows * f * f * 4 + rows * f * 4
    return float(ops), float(nbytes)


def solve_work(rows: int, f: int) -> tuple[float, float]:
    """(ops, bytes) of ``rows`` Cholesky solves of f x f: the factorization
    and the two triangular solves; A and B read, x written."""
    ops = rows * (f ** 3 / 3 + 2 * f * f)
    nbytes = rows * f * f * 4 + 2 * rows * f * 4
    return float(ops), float(nbytes)


def eval_ops(nnz: int, f: int) -> float:
    """Operations of the predictions of ``nnz`` ratings (one dot product
    each)."""
    return float(2 * nnz * f)


def als_iteration_ops(users: int, items: int, train_nnz: int, test_nnz: int,
                      f: int) -> float:
    """The algorithm's operations in one ALS iteration: both Hermitians,
    both solves, and the train and test RMSE's predictions."""
    return (herm_work(train_nnz, users, f, items)[0]
            + herm_work(train_nnz, items, f, users)[0]
            + solve_work(users, f)[0] + solve_work(items, f)[0]
            + eval_ops(train_nnz + test_nnz, f))


def sgd_work(live: int, f: int, x_rows: int, theta_rows: int, g: int,
             mb: int) -> tuple[float, float]:
    """(ops, bytes) of one SGD sweep over ``live`` ratings of a diagonal
    set: 6 f operations a rating; X and the set's Theta blocks read and
    written once, each rating's index and value read, the row counts
    read."""
    ops = 6 * f * live
    nbytes = 2 * x_rows * f * 4 + 2 * theta_rows * f * 4 + live * 8 + g * mb * 4
    return float(ops), float(nbytes)
