"""The objective's squared error: wrapper of the CUDA kernel ``csrc/sq_err.cu``.

Replaces no TPU kernel: the reference's objective
(``repro/core/objective.py`` ``_sq_err_padded``) is a ``jnp`` gather and
einsum, which :func:`sq_err_plain` keeps as the plain version.  The
kernel takes one pass over the ratings in its place: it reads each rated
theta row once per rating, walks only a row's ``cnt`` slots, and writes
no intermediate to device memory.  What bounds it and how it is laid out
is noted in its CUDA source.

Both versions return ``(sse, nnz)`` as a float64 ``[2]`` tensor on the
tensors' device, added into ``out`` where it is given, so that several
batches (the degree bins of one matrix) share one total and the host
reads it once.  ``rows`` maps the batch's rows to rows of ``x``.

``sq_err_cuda`` launches the kernel for tensors on the card and runs
:func:`sq_err_plain` for tensors on the CPU; its launching calls and the
CUDA launches they made (two a call) are counted in the process registry
(``kernel/sq_err/...``; read with ``repro_torch.obs.kernel_launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref
from repro_torch.obs.metrics import kernel_counters

MAX_F = 128
#: gathered floats per chunk of the plain version (256 MB in fp32)
GATHER_ELEMS = 1 << 26
_LAUNCHES, _CUDA_LAUNCHES = kernel_counters("sq_err")


@functools.cache
def _launcher():
    fn = build.load("sq_err").sq_err_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scratch_doubles(device: int) -> int:
    fn = build.load("sq_err").sq_err_scratch_doubles
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    n = fn(device)
    if n < 0:
        raise RuntimeError(f"sq_err grid query failed: cudaError {-n}")
    return n


def _check(x, theta, idx, val, cnt, rows, out) -> None:
    m, K = idx.shape
    if theta.dim() != 2 or theta.dtype != torch.float32:
        raise ValueError(f"theta must be [n, f] float32, got {tuple(theta.shape)} {theta.dtype}")
    f = theta.shape[1]
    if not 0 < f <= MAX_F:
        raise ValueError(f"f={f} outside the kernel's 1..{MAX_F}")
    if x.dim() != 2 or x.shape[1] != f or x.dtype != torch.float32:
        raise ValueError(f"x must be [*, {f}] float32, got {tuple(x.shape)} {x.dtype}")
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise ValueError("idx and cnt must be int32")
    if val.dtype != torch.float32:
        raise ValueError("val must be float32")
    if val.shape != (m, K) or cnt.shape != (m,):
        raise ValueError(f"shapes disagree: idx {tuple(idx.shape)}, val {tuple(val.shape)}, "
                         f"cnt {tuple(cnt.shape)}")
    if rows is None and x.shape[0] < m:
        raise ValueError(f"x has {x.shape[0]} rows for {m} rows of ratings and no row map")
    if rows is not None and (rows.dtype != torch.int64 or rows.shape != (m,)):
        raise ValueError(f"rows must be [{m}] int64, got {tuple(rows.shape)} {rows.dtype}")
    if out is not None and (out.dtype != torch.float64 or out.shape != (2,)
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [2] float64, got {tuple(out.shape)} "
                         f"{out.dtype}")
    devices = {t.device for t in (x, theta, idx, val, cnt, rows, out) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def _total(out: Optional[torch.Tensor], device) -> torch.Tensor:
    return torch.zeros(2, dtype=torch.float64, device=device) if out is None else out


def sq_err_plain(x, theta, idx, val, cnt, rows=None, out=None) -> torch.Tensor:
    """Plain PyTorch version: ``theta[idx]`` gathered ([rows, K, f]) and an
    einsum, in row chunks of at most :data:`GATHER_ELEMS` gathered floats
    so that a full-size matrix never holds the whole gather; the sse is
    summed in x's dtype."""
    if rows is not None:
        x = x[rows]
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
    out = _total(out, x.device)
    out[0] += sse
    out[1] += torch.sum(cnt)
    return out


def sq_err_cuda(
    x: torch.Tensor,       # [*, f] float32 row factors (batch row u: x[rows[u]], else x[u])
    theta: torch.Tensor,   # [n, f] float32 column factors
    idx: torch.Tensor,     # [m, K] int32 padded column indices
    val: torch.Tensor,     # [m, K] float32 ratings
    cnt: torch.Tensor,     # [m]    int32 true nnz per row
    rows: Optional[torch.Tensor] = None,   # [m] int64 rows of x
    out: Optional[torch.Tensor] = None,    # [2] float64 (sse, nnz) to add into
) -> torch.Tensor:
    """``(sse, nnz)`` with sse = sum_{u, k < cnt_u} (val[u, k] -
    x[rows[u]] . theta[idx[u, k]])^2 and nnz = sum_u cnt_u, added into
    ``out`` (returned) or a new float64 ``[2]`` tensor."""
    _check(x, theta, idx, val, cnt, rows, out)
    if theta.device.type == "cpu":
        return sq_err_plain(x, theta, idx, val, cnt, rows, out)
    out = _total(out, theta.device)
    m, K = idx.shape
    if m == 0 or K == 0:
        return out
    x, theta, idx, val, cnt = (t.contiguous() for t in (x, theta, idx, val, cnt))
    rows = rows.contiguous() if rows is not None else None
    device = theta.device.index or 0
    scratch = torch.empty(_scratch_doubles(device), dtype=torch.float64, device=theta.device)
    n, f = theta.shape
    rc = _launcher()(x.data_ptr(), theta.data_ptr(), idx.data_ptr(), val.data_ptr(),
                     cnt.data_ptr(), rows.data_ptr() if rows is not None else None,
                     scratch.data_ptr(), out.data_ptr(), m, K, f, n, device,
                     torch.cuda.current_stream(theta.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sq_err kernel launch failed: cudaError {rc} "
                           f"(m={m}, K={K}, f={f}, n={n})")
    _LAUNCHES.inc()
    _CUDA_LAUNCHES.inc(2)
    return out
