"""Batch-Hogwild SGD tile sweep: wrapper of the CUDA kernel ``csrc/sgd_update.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/sgd_update.py``
``sgd_tile_pallas``.  The kernel takes any mb, nb and K and f <= 128
unpadded, so the reference's tile knobs (``row_mult``, ``col_mult``,
``f_mult``) have no counterpart.  What bounds it and how it is laid out
(two launches per slot, 64-bit fixed-point collision sums, so two runs
give bit-equal outputs) is noted in the CUDA source.

``sgd_tile_cuda`` launches the kernel for tensors on the card and runs
:func:`sgd_tile_plain` for tensors on the CPU; ``sgd_tile_cuda.launches``
counts its calls that launched the kernel (each one sweeps all K slots,
2K CUDA launches).  Like the reference's, the function is pure: it
returns fresh tensors and leaves its inputs unchanged.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.backend import Mode, default_mode
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

MAX_F = 128


@functools.cache
def _launcher():
    fn = build.load("sgd_update").sgd_tile_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, theta, idx, val, cnt) -> None:
    mb, K = idx.shape
    if x.dim() != 2 or theta.dim() != 2 or x.shape[1] != theta.shape[1]:
        raise ValueError(f"x [mb, f] and theta [nb, f] disagree: {tuple(x.shape)}, "
                         f"{tuple(theta.shape)}")
    if x.dtype != torch.float32 or theta.dtype != torch.float32 or val.dtype != torch.float32:
        raise ValueError("x, theta and val must be float32")
    if not 0 < x.shape[1] <= MAX_F:
        raise ValueError(f"f={x.shape[1]} outside the kernel's 1..{MAX_F}")
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise ValueError("idx and cnt must be int32")
    if x.shape[0] != mb or val.shape != (mb, K) or cnt.shape != (mb,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, idx {tuple(idx.shape)}, "
                         f"val {tuple(val.shape)}, cnt {tuple(cnt.shape)}")
    devices = {t.device for t in (x, theta, idx, val, cnt)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


#: plain PyTorch version (the K-slot loop with ``index_add_`` collisions)
sgd_tile_plain = kref.sgd_block_ref


def sgd_tile_cuda(
    x: torch.Tensor,       # [mb, f] float32 user factors
    theta: torch.Tensor,   # [nb, f] float32 item factors
    idx: torch.Tensor,     # [mb, K] int32 item index per slot (< nb)
    val: torch.Tensor,     # [mb, K] float32 ratings
    cnt: torch.Tensor,     # [mb]    int32 live slots per row
    lr: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x', theta') after the batch-Hogwild sweep of all K slots."""
    _check(x, theta, idx, val, cnt)
    if x.device.type == "cpu":
        return sgd_tile_plain(x, theta, idx, val, cnt, lr, lam)
    mb, K = idx.shape
    nb, f = theta.shape
    x_out = x.contiguous().clone()
    t_out = theta.contiguous().clone()
    if mb == 0 or K == 0:
        return x_out, t_out
    idx, val, cnt = (t.contiguous() for t in (idx, val, cnt))
    acc = torch.zeros((nb, f), dtype=torch.int64, device=x.device)
    hits = torch.zeros(nb, dtype=torch.int32, device=x.device)
    bad = torch.zeros(nb, dtype=torch.int32, device=x.device)
    rc = _launcher()(x_out.data_ptr(), t_out.data_ptr(), idx.data_ptr(),
                     val.data_ptr(), cnt.data_ptr(), acc.data_ptr(),
                     hits.data_ptr(), bad.data_ptr(), mb, nb, K, f,
                     float(lr), float(lam), x.device.index or 0,
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sgd_tile kernel launch failed: cudaError {rc} "
                           f"(mb={mb}, nb={nb}, K={K}, f={f})")
    sgd_tile_cuda.launches += 1
    return x_out, t_out


sgd_tile_cuda.launches = 0


def sgd_block_update(
    x: torch.Tensor,      # [mb, f]  user-block factor slice
    theta: torch.Tensor,  # [nb, f]  item-block factor slice
    idx: torch.Tensor,    # [mb, K]  block-local item indices
    val: torch.Tensor,    # [mb, K]
    cnt: torch.Tensor,    # [mb]
    lr: float,
    lam: float,
    *,
    mode: Optional[Mode] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch-Hogwild sweep over a tile; returns (x', theta').

    ``mode="kernel"`` runs :func:`sgd_tile_cuda` (the plain version on
    CPU tensors), ``"ref"`` the plain version on any device, ``None`` the
    default of the tensors' device.
    """
    mode = default_mode(x.device) if mode is None else mode
    if mode == "kernel":
        return sgd_tile_cuda(x, theta, idx, val, cnt, lr, lam)
    if mode == "ref":
        return sgd_tile_plain(x, theta, idx, val, cnt, lr, lam)
    raise ValueError(f"unknown mode {mode!r}")
