"""Paper Fig. 7 on the card: accumulator placement ablation.

cuMF's biggest single win (2.5x on Netflix) is keeping A_u in the register
file instead of round-tripping global memory per bin.  Both strategies
run as hand-written kernels here: ``fused_herm_cuda`` keeps each A_u in
registers for the whole row, ``herm_hbm_accum_cuda`` (the port of the
reference's ``herm_hbm_accum`` TPU kernel) launches once per bin of K/8
slots and adds each bin's A, B into device memory.  The row reports the
measured ratio and the modelled write ratio (one A write per row vs one
per bin)."""
from __future__ import annotations

from repro_torch.kernels.hermitian import fused_herm_cuda, herm_hbm_accum_cuda

from benchmarks_torch.bench_kernels import _problem
from benchmarks_torch.common import emit, time_fn

BINS = 8


def fused_accum(theta, idx, val, cnt, diag):
    """Register strategy: one pass, the accumulator never leaves the SM."""
    return fused_herm_cuda(theta, idx, val, cnt, diag)


def binned_hbm_accum(theta, idx, val, cnt, diag):
    """No-register strategy: A, B through device memory per bin (Fig. 7 'w/o')."""
    return herm_hbm_accum_cuda(theta, idx, val, cnt, diag, tk=idx.shape[1] // BINS)


def run(device: str = "cuda"):
    args = _problem(device=device)
    m, K = args[1].shape
    f = args[0].shape[1]
    us_fused = time_fn(fused_accum, *args)
    us_binned = time_fn(binned_hbm_accum, *args)
    # device-memory writes of the accumulator: once per row vs once per bin
    write_ratio = BINS  # m*f^2*bins vs m*f^2
    emit("fig7_register_fused", us_fused,
         f"A_hbm_writes={m * f * f}")
    emit("fig7_register_hbm_binned", us_binned,
         f"A_hbm_writes={m * f * f * BINS};slowdown={us_binned / us_fused:.2f}x;"
         f"modeled_write_ratio={write_ratio}x")


if __name__ == "__main__":
    run()
