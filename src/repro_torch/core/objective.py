"""Objective and evaluation metrics for ALS MF (paper eq. (1)).

The squared error gathers ``theta[idx]`` ([m, K, f]); it is taken in row
chunks of at most :data:`GATHER_ELEMS` gathered floats so evaluating a
full-size matrix never holds the whole gather on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as kref

#: gathered floats per chunk of the squared error (256 MB in fp32)
GATHER_ELEMS = 1 << 26


def _sq_err_padded(x, theta, idx, val, cnt):
    """Sum of squared errors over the nonzeros of a padded-ELL batch, and
    the nonzero count.

    x     [m, f]  row factors for these rows
    theta [n, f]  column factors
    idx   [m, K], val [m, K], cnt [m]
    """
    m, K = idx.shape
    step = max(1, GATHER_ELEMS // max(K * theta.shape[1], 1))
    sse = torch.zeros((), dtype=x.dtype, device=x.device)
    for lo in range(0, m, step):
        hi = min(lo + step, m)
        g = theta[idx[lo:hi].long()]                    # [rows, K, f]
        pred = torch.einsum("uf,ukf->uk", x[lo:hi], g)
        mask = kref.mask_from_cnt(cnt[lo:hi], K, x.dtype)
        err = (val[lo:hi] - pred) * mask
        sse = sse + torch.sum(err * err)
    return sse, torch.sum(cnt)


def rmse_padded(x, theta, idx, val, cnt) -> torch.Tensor:
    """Root mean squared error over the nonzeros of (idx, val, cnt)."""
    sse, n = _sq_err_padded(x, theta, idx, val, cnt)
    return torch.sqrt(sse / torch.clamp(n, min=1))


def objective_j(x, theta, idx, val, cnt_rows, cnt_cols, lam) -> torch.Tensor:
    """Paper eq. (1): squared error + weighted-lambda regularizer.

    cnt_rows [m] = n_{x_u}; cnt_cols [n] = n_{theta_v}.
    """
    sse, _ = _sq_err_padded(x, theta, idx, val, cnt_rows)
    reg = lam * (
        torch.sum(cnt_rows.to(x.dtype) * torch.sum(x * x, dim=1))
        + torch.sum(cnt_cols.to(x.dtype) * torch.sum(theta * theta, dim=1))
    )
    return sse + reg
