"""The two ops the ALS driver calls, dispatching plain torch or the kernels
(the reference's ``kernels/ops.py``).

- ``mode="ref"``: the plain PyTorch version, on whatever device the
  tensors lie (gather + ``einsum``, ``torch.linalg`` Cholesky).
- ``mode="kernel"``: the hand-written CUDA kernels; on CPU tensors their
  wrappers run the plain version.

``mode=None`` takes :func:`repro_torch.backend.default_mode` of the
tensors' device.  The reference's TPU tile knobs (``tm``/``tk``/``tb``/
``f_mult``) have no counterpart: the kernels take f <= 128 and any K, m
unpadded.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.backend import Mode, default_mode
from repro_torch.kernels.batch_solve import batch_solve_cuda, batch_solve_plain
from repro_torch.kernels.hermitian import fused_herm_cuda, fused_herm_plain


def _mode(mode: Optional[Mode], t: torch.Tensor) -> Mode:
    mode = default_mode(t.device) if mode is None else mode
    if mode not in ("kernel", "ref"):
        raise ValueError(f"unknown mode {mode!r}")
    return mode


def fused_herm(
    theta: torch.Tensor,   # [n, f] feature matrix (the fixed side)
    idx: torch.Tensor,     # [m, K] padded column indices (int32)
    val: torch.Tensor,     # [m, K] padded rating values
    cnt: torch.Tensor,     # [m]    true nnz per row (int32)
    lam: float,
    *,
    mode: Optional[Mode] = None,
    diag_fallback: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (A [m, f, f], B [m, f]) of paper eq. (2) with weighted-lambda reg.

    A_u = sum_{v: r_uv != 0} theta_v theta_v^T + lambda n_u I
    B_u = Theta^T R_{u*}^T

    ``diag_fallback`` puts I on the diagonal of empty rows so the solve
    stays nonsingular (x_u = 0).  Partial Hermitians that are summed
    before the solve set it to False and apply the guard afterwards.
    """
    mode = _mode(mode, theta)
    diag = lam * cnt.to(torch.float32)
    if diag_fallback:
        diag = torch.where(cnt > 0, diag, torch.ones_like(diag))
    if mode == "kernel":
        return fused_herm_cuda(theta, idx, val, cnt, diag)
    return fused_herm_plain(theta, idx, val, cnt, diag)


def batch_solve(A: torch.Tensor, B: torch.Tensor, *,
                mode: Optional[Mode] = None) -> torch.Tensor:
    """x_u = A_u^{-1} B_u (batched Cholesky solve)."""
    if _mode(mode, A) == "kernel":
        return batch_solve_cuda(A, B)
    return batch_solve_plain(A, B)


def als_update_factor(
    theta: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    cnt: torch.Tensor,
    lam: float,
    *,
    mode: Optional[Mode] = None,
) -> torch.Tensor:
    """One half-iteration: given fixed theta, solve all rows of X (paper Alg. 1/2)."""
    A, B = fused_herm(theta, idx, val, cnt, lam, mode=mode)
    return batch_solve(A, B, mode=mode)
