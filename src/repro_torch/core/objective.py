"""Objective and evaluation metrics for ALS MF (paper eq. (1)).

The squared error is :func:`repro_torch.kernels.ops.sq_err`: the kernel
``csrc/sq_err.cu`` for tensors on the card (one pass over the ratings,
nothing gathered into device memory), its plain version (the chunked
``theta[idx]`` gather and einsum) for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def _sq_err_padded(x, theta, idx, val, cnt):
    """Sum of squared errors over the nonzeros of a padded-ELL batch, and
    the nonzero count.

    x     [m, f]  row factors for these rows
    theta [n, f]  column factors
    idx   [m, K], val [m, K], cnt [m]
    """
    sse, n = kops.sq_err(x, theta, idx, val, cnt)
    return sse.to(x.dtype), n.to(torch.int64)


def rmse_padded(x, theta, idx, val, cnt) -> torch.Tensor:
    """Root mean squared error over the nonzeros of (idx, val, cnt)."""
    sse, n = kops.sq_err(x, theta, idx, val, cnt)
    return torch.sqrt(sse / torch.clamp(n, min=1)).to(x.dtype)


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
