"""Declared per-kernel shared-memory budgets — the static memory contract
of the port's CUDA kernels on Hopper.

The reference's ``repro/kernels/budgets.py`` sizes each Pallas kernel's
blocks against the TPU's VMEM.  On the H100 the fast memory a kernel
sizes itself against is the CTA's dynamic shared memory: a launch that
asks for more than the card's opt-in per-block maximum (227 KiB on
sm_90, ``cudaDevAttrMaxSharedMemoryPerBlockOptin``) fails.  Each
kernel's footprint here mirrors its launch configuration in the CUDA
source, so the streaming driver's ledger can record budget against
launched (``smem/<kernel>``):

- ``fused_herm`` and ``herm_hbm_accum`` (``csrc/herm_tile.cuh``
  ``smem_bytes(f)``): the two cp.async chunk buffers of ``kChunk`` gathered
  rows (``Fs = 8 * ceil((f + 1) / 8)`` floats each, plus the row id) or the
  staged ``A_u`` and ``B_u`` of the epilogue (``f * (f + 1)`` floats),
  whichever is larger.  The split path's reduction kernel stages the same
  ``f * (f + 1)`` floats, so it never needs more.
- ``batch_solve`` (``csrc/batch_solve.cu`` ``smem_floats(f)``): the
  transposed panel (``kNB`` rows of ``pw = 4 * ceil((f + 1) / 4)``
  floats), the packed lower triangle of ``A_u`` with ``b_u``, and three
  vectors of ``f``.

The SGD tile kernel (``csrc/sgd_update.cu``) keeps its rows in registers
and uses no dynamic shared memory, so it has no entry.  Worst case under
the declared bound f <= 128: 66048 B for the Hermitians, 43520 B for the
solve, both far under the limit.
"""
from __future__ import annotations

import dataclasses

#: opt-in dynamic shared memory per block on sm_90 (H100): 227 KiB
SMEM_BYTES = 227 * 1024

# constants of the CUDA sources the footprints mirror
HERM_CHUNK = 32          # kChunk, csrc/herm_tile.cuh
SOLVE_NB = 16            # kNB, csrc/batch_solve.cu


@dataclasses.dataclass(frozen=True)
class KernelBudget:
    """Static shared-memory contract of one CUDA kernel's launches."""

    smem_limit: int              # bytes the footprint must fit in
    dim_bounds: dict             # dim name -> worst-case value
    note: str = ""               # where the footprint comes from


def _herm_smem(f: int) -> int:
    fs = 8 * ((f + 1 + 7) // 8)
    chunks = 2 * HERM_CHUNK * (fs * 4 + 4)
    staged = f * (f + 1) * 4
    return max(chunks, staged)


def _solve_smem(f: int) -> int:
    pw = (f + 1 + 3) // 4 * 4
    tri = f * (f + 1) // 2
    return 4 * (pw * SOLVE_NB + (tri + f + 3) // 4 * 4 + 3 * f)


def footprint_bytes(name: str, *, f: int) -> int:
    """Dynamic shared memory one CTA of kernel ``name`` asks for at latent
    dimension ``f`` — the bytes its launch passes to ``<<<...>>>``."""
    if name not in BUDGETS:
        raise KeyError(f"no footprint model for kernel {name!r}; "
                       f"known: {sorted(BUDGETS)}")
    if not 0 < f <= BUDGETS[name].dim_bounds["f"]:
        raise ValueError(f"f={f} outside 1..{BUDGETS[name].dim_bounds['f']}")
    return _solve_smem(f) if name == "batch_solve" else _herm_smem(f)


BUDGETS: dict[str, KernelBudget] = {
    "fused_herm": KernelBudget(
        smem_limit=SMEM_BYTES, dim_bounds={"f": 128},
        note="csrc/herm_tile.cuh smem_bytes(f): chunk buffers or staged "
             "A_u/B_u; the split path's reduction stages f*(f+1) floats"),
    "herm_hbm_accum": KernelBudget(
        smem_limit=SMEM_BYTES, dim_bounds={"f": 128},
        note="the Fig. 7 ablation: herm_tile.cuh's template, same launch"),
    "batch_solve": KernelBudget(
        smem_limit=SMEM_BYTES, dim_bounds={"f": 128},
        note="csrc/batch_solve.cu smem_floats(f): transposed panel, packed "
             "triangle with b, three vectors"),
}
