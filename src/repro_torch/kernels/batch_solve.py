"""Batched SPD solve: wrapper of the CUDA kernel ``csrc/batch_solve.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/batch_solve.py``
``batch_solve_pallas``: a blocked Cholesky with the right-hand side
carried as one more row, one warp per system and several systems a CTA
(``budgets.solve_systems_per_cta``), no padding of the batch:
empty rows already arrive as A = I (``ops.fused_herm``'s
``diag_fallback`` and ``core.als.solve_accumulated``'s guard).

``batch_solve_cuda`` launches the kernel for tensors on the card and runs
:func:`batch_solve_plain` for tensors on the CPU; its launches are counted
in the process registry (``kernel/batch_solve/...``; read with
``repro_torch.obs.kernel_launches``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref
from repro_torch.obs.metrics import kernel_counters

MAX_F = 128
_LAUNCHES, _CUDA_LAUNCHES = kernel_counters("batch_solve")


@functools.cache
def _launcher():
    fn = build.load("batch_solve").batch_solve_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(A, B) -> None:
    if A.dim() != 3 or A.shape[1] != A.shape[2] or A.dtype != torch.float32:
        raise ValueError(f"A must be [m, f, f] float32, got {tuple(A.shape)} {A.dtype}")
    if B.shape != A.shape[:2] or B.dtype != torch.float32:
        raise ValueError(f"B must be [m, f] float32 to match A, got {tuple(B.shape)} {B.dtype}")
    if not 0 < A.shape[1] <= MAX_F:
        raise ValueError(f"f={A.shape[1]} outside the kernel's 1..{MAX_F}")
    if A.device != B.device:
        raise ValueError(f"A on {A.device}, B on {B.device}")


#: plain PyTorch version (Cholesky through ``torch.linalg``)
batch_solve_plain = kref.batch_solve_ref


def batch_solve_cuda(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """x_u = A_u^{-1} B_u for every SPD A_u [m, f, f], B_u [m, f]."""
    _check(A, B)
    if A.device.type == "cpu":
        return batch_solve_plain(A, B)
    m, f, _ = A.shape
    X = torch.empty((m, f), dtype=torch.float32, device=A.device)
    if m == 0:
        return X
    A, B = A.contiguous(), B.contiguous()
    rc = _launcher()(A.data_ptr(), B.data_ptr(), X.data_ptr(), m, f,
                     A.device.index or 0,
                     torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"batch_solve kernel launch failed: cudaError {rc} "
                           f"(m={m}, f={f})")
    _LAUNCHES.inc()
    _CUDA_LAUNCHES.inc()
    return X
