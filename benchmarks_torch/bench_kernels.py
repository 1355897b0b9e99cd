"""Kernel-level microbenches on the card: the fused A+B pass (one sweep,
the gather in the kernel) against the paper's two-pass structure, and the
batched Cholesky solve."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.kernels import ref as kref
from repro_torch.kernels.batch_solve import batch_solve_cuda
from repro_torch.kernels.hermitian import fused_herm_cuda

from benchmarks_torch.common import emit, time_fn


def _problem(m=2048, n=4096, K=256, f=64, seed=0, device="cuda"):
    """The reference's problem (same numpy draws), plus the weighted-lambda
    diagonal both passes add (lam 0.05, 1 on empty rows)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    theta = torch.tensor(rng.standard_normal((n, f)), dtype=torch.float32, device=dev)
    idx = torch.tensor(rng.integers(0, n, (m, K)), dtype=torch.int32, device=dev)
    cnt = torch.tensor(rng.integers(K // 2, K + 1, (m,)), dtype=torch.int32, device=dev)
    val = torch.tensor(rng.standard_normal((m, K)), dtype=torch.float32, device=dev)
    diag = torch.where(cnt > 0, 0.05 * cnt.float(), torch.ones_like(cnt, dtype=torch.float32))
    return theta, idx, val, cnt, diag


def one_pass(theta, idx, val, cnt, diag):
    """Fused: A and B from one sweep (the port's kernel)."""
    return fused_herm_cuda(theta, idx, val, cnt, diag)


def two_pass(theta, idx, val, cnt, diag):
    """cuMF structure in plain PyTorch: a get_hermitian pass and a
    separate B pass, each over its own materialized gather."""
    m, K = idx.shape
    f = theta.shape[1]
    rows = idx.reshape(-1).long()
    mask = kref.mask_from_cnt(cnt, K, theta.dtype)
    g = theta.index_select(0, rows).view(m, K, f)
    A = torch.einsum("ukf,ukg->ufg", g * mask[..., None], g)
    g2 = theta.index_select(0, rows).view(m, K, f)
    B = torch.einsum("uk,ukf->uf", val * mask, g2)
    A.diagonal(dim1=1, dim2=2).add_(diag[:, None])
    return A, B


def run(device: str = "cuda"):
    args = _problem(device=device)
    us1 = time_fn(one_pass, *args)
    us2 = time_fn(two_pass, *args)
    emit("kern_fused_AB_one_pass", us1, "passes=1")
    emit("kern_paper_two_pass", us2,
         f"passes=2;fusion_speedup={us2 / us1:.2f}x")
    A, B = one_pass(*args)
    us3 = time_fn(batch_solve_cuda, A, B)
    m, f = B.shape
    emit("kern_batch_solve", us3,
         f"batch={m};f={f};gflops={(m * f**3 / 3) / (us3 * 1e-6) / 1e9:.1f}")


if __name__ == "__main__":
    run()
