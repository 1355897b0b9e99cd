"""Paper Fig. 8 on the card: the benefit of gathering Theta rows inside the
Hermitian kernel.

cuMF reads Theta^T through the read-only texture cache (25-35 % faster).
``fused_herm_cuda`` gathers each rating's Theta row with ``cp.async``
straight into shared memory.  The materialized variant first writes the
gathered ``[m*K, f]`` rows to device memory (``index_select``) and then
runs the *same kernel* on them with identity indices, so the only
difference is the extra write and read of the gathered rows.  Unlike the
reference's A-only einsums, the kernel also computes B and the diagonal,
in both rows alike."""
from __future__ import annotations

import torch

from repro_torch.kernels.hermitian import fused_herm_cuda

from benchmarks_torch.bench_kernels import _problem
from benchmarks_torch.common import emit, time_fn


def gather_fused(theta, idx, val, cnt, diag):
    return fused_herm_cuda(theta, idx, val, cnt, diag)


def gather_materialized(theta, idx, val, cnt, diag, ident):
    g = theta.index_select(0, idx.reshape(-1).long())       # [m*K, f] in memory
    return fused_herm_cuda(g, ident, val, cnt, diag)


def run(device: str = "cuda"):
    args = _problem(device=device)
    m, K = args[1].shape
    f = args[0].shape[1]
    ident = torch.arange(m * K, dtype=torch.int32, device=args[1].device).view(m, K)
    us_f = time_fn(gather_fused, *args)
    us_m = time_fn(gather_materialized, *args, ident)
    extra = m * K * f * 4 * 2  # write + read of the materialized gather
    emit("fig8_texture_fused_gather", us_f, "extra_hbm_bytes=0;computes=A+B+diag")
    emit("fig8_texture_materialized", us_m,
         f"extra_hbm_bytes={extra};slowdown={us_m / us_f:.2f}x;computes=A+B+diag")


if __name__ == "__main__":
    run()
