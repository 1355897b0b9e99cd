"""Hermitians: wrappers of the CUDA kernels ``csrc/hermitian.cu`` and
``csrc/herm_hbm_accum.cu``.

``fused_herm_cuda`` replaces the reference's Pallas kernel
``repro/kernels/hermitian.py`` ``fused_herm_pallas`` and the
``theta[idx]`` gather in front of it: the kernel gathers the rated theta
rows itself, so the ``[m, K, f]`` tensor is never built on the card.  A
bin with more than :func:`split_slots` slots per row is split over
several CTAs per row, whose partials a second kernel sums in a fixed
order; the wrapper allocates their scratch.

``herm_hbm_accum_cuda`` replaces the reference's ``herm_hbm_accum``, the
paper's Fig. 7 ablation: the same A and B, but one launch per bin of
``tk`` slots, each writing its partial to device memory, added into the
running sum between launches.  It is never on the ALS main path.

What bounds each kernel and how it is laid out is noted in its CUDA
source.  Each ``*_cuda`` wrapper launches its kernel for tensors on the
card and runs its ``*_plain`` version for tensors on the CPU, and counts
its launching calls and the CUDA kernels they started in the process
registry (``kernel/fused_herm/...``, ``kernel/herm_hbm_accum/...``; read
with ``repro_torch.obs.kernel_launches``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref
from repro_torch.obs.metrics import kernel_counters

MAX_F = 128
_HERM_LAUNCHES, _HERM_CUDA_LAUNCHES = kernel_counters("fused_herm")
_HBM_LAUNCHES, _HBM_CUDA_LAUNCHES = kernel_counters("herm_hbm_accum")


@functools.cache
def _launcher():
    fn = build.load("hermitian").fused_herm_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scratch_floats():
    fn = build.load("hermitian").fused_herm_scratch_floats
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn


@functools.cache
def split_slots() -> int:
    """Slots per CTA of a split row (``kSplit`` in ``csrc/herm_tile.cuh``);
    builds the library.  Bins with K above it take two CUDA launches."""
    fn = build.load("hermitian").fused_herm_split_slots
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


@functools.cache
def _bin_launcher():
    fn = build.load("herm_hbm_accum").herm_bin_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    n_scratch = _scratch_floats()(m, K, f)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=theta.device) \
        if n_scratch else None
    rc = _launcher()(theta.data_ptr(), idx.data_ptr(), val.data_ptr(),
                     cnt.data_ptr(), diag.data_ptr(), A.data_ptr(), B.data_ptr(),
                     scratch.data_ptr() if scratch is not None else None,
                     m, K, f, n, theta.device.index or 0,
                     torch.cuda.current_stream(theta.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_herm kernel launch failed: cudaError {rc} "
                           f"(m={m}, K={K}, f={f}, n={n})")
    _HERM_LAUNCHES.inc()
    _HERM_CUDA_LAUNCHES.inc(2 if scratch is not None else 1)
    return A, B


def herm_hbm_accum_plain(theta, idx, val, cnt, diag, *, tk: int):
    """Plain PyTorch version: :func:`kref.herm_ref` on each bin of ``tk``
    slots of the gather, summed, then the diagonal."""
    m, K = idx.shape
    f = theta.shape[1]
    mask = kref.mask_from_cnt(cnt, K, theta.dtype)
    zero = torch.zeros(m, dtype=theta.dtype, device=theta.device)
    A = torch.zeros((m, f, f), dtype=theta.dtype, device=theta.device)
    B = torch.zeros((m, f), dtype=theta.dtype, device=theta.device)
    for k0 in range(0, K, tk):
        bin_ = slice(k0, k0 + tk)
        dA, dB = kref.herm_ref(theta[idx[:, bin_].long()], val[:, bin_], mask[:, bin_], zero)
        A, B = A + dA, B + dB
    return A + diag[:, None, None] * torch.eye(f, dtype=A.dtype, device=A.device), B


def herm_hbm_accum_cuda(
    theta: torch.Tensor,   # [n, f] float32, the fixed factor
    idx: torch.Tensor,     # [m, K] int32 padded column indices
    val: torch.Tensor,     # [m, K] float32 ratings
    cnt: torch.Tensor,     # [m]    int32 true nnz per row
    diag: torch.Tensor,    # [m]    float32 diagonal added to A_u
    *,
    tk: int,               # slots per bin; the last bin may be short
) -> tuple[torch.Tensor, torch.Tensor]:
    """The A, B of :func:`fused_herm_cuda`, accumulated in device memory
    bin by bin (paper Fig. 7, "without registers")."""
    _check(theta, idx, val, cnt, diag)
    if tk <= 0:
        raise ValueError(f"tk={tk} must be positive")
    if theta.device.type == "cpu":
        return herm_hbm_accum_plain(theta, idx, val, cnt, diag, tk=tk)
    m, K = idx.shape
    n, f = theta.shape
    A = torch.zeros((m, f, f), dtype=torch.float32, device=theta.device)
    B = torch.zeros((m, f), dtype=torch.float32, device=theta.device)
    if m == 0:
        return A, B
    theta, idx, val, cnt, diag = (t.contiguous() for t in (theta, idx, val, cnt, diag))
    dA = torch.empty_like(A)
    dB = torch.empty_like(B)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    for k0 in range(0, K, tk):
        k1 = min(k0 + tk, K)
        rc = _bin_launcher()(theta.data_ptr(), idx.data_ptr(), val.data_ptr(),
                             cnt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                             m, K, f, n, k0, k1, theta.device.index or 0, stream)
        if rc != 0:
            raise RuntimeError(f"herm_hbm_accum kernel launch failed: cudaError {rc} "
                               f"(m={m}, K={K}, f={f}, n={n}, bin [{k0}, {k1}))")
        _HBM_LAUNCHES.inc()
        _HBM_CUDA_LAUNCHES.inc()
        A += dA          # the round trip through device memory per bin
        B += dB
    A.diagonal(dim1=1, dim2=2).add_(diag[:, None])
    return A, B
