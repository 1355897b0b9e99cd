"""Fused Hermitian: wrapper of the CUDA kernel ``csrc/hermitian.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/hermitian.py``
``fused_herm_pallas`` and the ``theta[idx]`` gather in front of it: the
kernel gathers the rated theta rows itself, so the ``[m, K, f]`` tensor is
never built on the card.  What bounds it and how it is laid out is noted
in the CUDA source.

``fused_herm_cuda`` launches the kernel for tensors on the card and runs
:func:`fused_herm_plain` for tensors on the CPU; ``fused_herm_cuda.launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

MAX_F = 128


@functools.cache
def _launcher():
    fn = build.load("hermitian").fused_herm_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(theta, idx, val, cnt, diag) -> None:
    m, K = idx.shape
    if theta.dim() != 2 or theta.dtype != torch.float32:
        raise ValueError(f"theta must be [n, f] float32, got {tuple(theta.shape)} {theta.dtype}")
    if not 0 < theta.shape[1] <= MAX_F:
        raise ValueError(f"f={theta.shape[1]} outside the kernel's 1..{MAX_F}")
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise ValueError("idx and cnt must be int32")
    if val.dtype != torch.float32 or diag.dtype != torch.float32:
        raise ValueError("val and diag must be float32")
    if val.shape != (m, K) or cnt.shape != (m,) or diag.shape != (m,):
        raise ValueError(f"shapes disagree: idx {tuple(idx.shape)}, val "
                         f"{tuple(val.shape)}, cnt {tuple(cnt.shape)}, diag {tuple(diag.shape)}")
    devices = {t.device for t in (theta, idx, val, cnt, diag)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def fused_herm_plain(theta, idx, val, cnt, diag):
    """Plain PyTorch version: gather, then :func:`kref.herm_ref`."""
    g = theta[idx.long()]
    return kref.herm_ref(g, val, kref.mask_from_cnt(cnt, idx.shape[1], theta.dtype), diag)


def fused_herm_cuda(
    theta: torch.Tensor,   # [n, f] float32, the fixed factor
    idx: torch.Tensor,     # [m, K] int32 padded column indices
    val: torch.Tensor,     # [m, K] float32 ratings
    cnt: torch.Tensor,     # [m]    int32 true nnz per row
    diag: torch.Tensor,    # [m]    float32 diagonal added to A_u
) -> tuple[torch.Tensor, torch.Tensor]:
    """A [m, f, f] = sum_{k<cnt} g g^T + diag I and B [m, f] = sum_{k<cnt} val g,
    with g = theta[idx[u, k]]."""
    _check(theta, idx, val, cnt, diag)
    if theta.device.type == "cpu":
        return fused_herm_plain(theta, idx, val, cnt, diag)
    m, K = idx.shape
    n, f = theta.shape
    A = torch.empty((m, f, f), dtype=torch.float32, device=theta.device)
    B = torch.empty((m, f), dtype=torch.float32, device=theta.device)
    if m == 0:
        return A, B
    theta, idx, val, cnt, diag = (t.contiguous() for t in (theta, idx, val, cnt, diag))
    rc = _launcher()(theta.data_ptr(), idx.data_ptr(), val.data_ptr(),
                     cnt.data_ptr(), diag.data_ptr(), A.data_ptr(), B.data_ptr(),
                     m, K, f, n, theta.device.index or 0,
                     torch.cuda.current_stream(theta.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_herm kernel launch failed: cudaError {rc} "
                           f"(m={m}, K={K}, f={f}, n={n})")
    fused_herm_cuda.launches += 1
    return A, B


fused_herm_cuda.launches = 0
