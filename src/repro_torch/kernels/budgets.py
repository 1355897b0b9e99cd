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
- ``batch_solve`` (``csrc/batch_solve.cu`` ``batch_solve_smem_bytes(f)``):
  :func:`solve_systems_per_cta` systems, one a warp, each holding the lower
  triangle of ``W = [A_u ; b_u^T]`` in 4x4 blocks, block-row ``a`` (rows
  ``4a..4a+3``) of ``a + 1`` blocks and one float4 of padding, for block-rows
  ``0..f // 4``: ``16 * a (2a + 3)`` bytes with ``a = f // 4 + 1``, then two
  buffers of ``SOLVE_NB`` floats.  A CTA
  takes as many systems as fit in ``SOLVE_CTA_SMEM`` (half an SM's shared
  memory, less a CTA's reserve), at most ``SOLVE_MAX_SYS``.

The SGD tile kernel (``csrc/sgd_update.cu``) and the squared error
(``csrc/sq_err.cu``) keep their rows in registers and use no dynamic
shared memory, so they have no entry: their libraries are declared in
:data:`SMEM_FREE`.  Worst case under the declared bound
f <= 128: 66048 B for the Hermitians, 115040 B for the solve (five
systems of 23008 B at f = 100 to 103), both under the limit.

Nothing here is read from the CUDA sources at run time, so the constants
the footprints rest on are copies.  :data:`MIRRORS` declares each copy
beside the ``constexpr`` it mirrors, and each entry's f bound copies
``kMaxF`` of its ``source``; the port's
lint (``python -m repro_torch.analysis``, rule ``smem-budget``) reads the
sources as text and holds every pair equal.  Each source exports its
launch's bytes as ``<kernel>_smem_bytes(f)``, which ``chip_smoke.py``
holds equal to :func:`footprint_bytes` on the card.
"""
from __future__ import annotations

import dataclasses

#: opt-in dynamic shared memory per block on sm_90 (H100): 227 KiB
SMEM_BYTES = 227 * 1024

# constants of the CUDA sources the footprints mirror
HERM_CHUNK = 32          # kChunk, csrc/herm_tile.cuh
SOLVE_NB = 16            # kNB, csrc/batch_solve.cu
SOLVE_MAX_SYS = 5        # kMaxSys, csrc/batch_solve.cu
SOLVE_CTA_SMEM = 115712  # kCtaSmem, csrc/batch_solve.cu

#: Python copies of the CUDA sources' constants: (module in ``kernels/``,
#: its module-level constant, source in ``kernels/csrc/``, the constexpr)
MIRRORS = (
    ("budgets.py", "HERM_CHUNK", "herm_tile.cuh", "kChunk"),
    ("budgets.py", "SOLVE_NB", "batch_solve.cu", "kNB"),
    ("budgets.py", "SOLVE_MAX_SYS", "batch_solve.cu", "kMaxSys"),
    ("budgets.py", "SOLVE_CTA_SMEM", "batch_solve.cu", "kCtaSmem"),
    ("hermitian.py", "MAX_F", "herm_tile.cuh", "kMaxF"),
    ("batch_solve.py", "MAX_F", "batch_solve.cu", "kMaxF"),
    ("sgd_update.py", "MAX_F", "sgd_update.cu", "kMaxF"),
    ("sq_err.py", "MAX_F", "sq_err.cu", "kMaxF"),
)

#: libraries (``kernels/build.load`` names) whose kernels use no dynamic
#: shared memory, so they need no budget
SMEM_FREE = ("sgd_update", "sq_err")


@dataclasses.dataclass(frozen=True)
class KernelBudget:
    """Static shared-memory contract of one CUDA kernel's launches."""

    smem_limit: int              # bytes the footprint must fit in
    dim_bounds: dict             # dim name -> worst-case value
    library: str                 # the ``build.load`` name of its source
    source: str                  # the file under ``csrc/`` whose kMaxF bounds f
    note: str = ""               # where the footprint comes from


def _herm_smem(f: int) -> int:
    fs = 8 * ((f + 1 + 7) // 8)
    chunks = 2 * HERM_CHUNK * (fs * 4 + 4)
    staged = f * (f + 1) * 4
    return max(chunks, staged)


def solve_system_bytes(f: int) -> int:
    """Shared memory one system of the solve takes at ``f``: W's blocks and
    two buffers of ``SOLVE_NB`` floats."""
    a = f // 4 + 1
    return 16 * a * (2 * a + 3) + 2 * 4 * SOLVE_NB


def solve_systems_per_cta(f: int) -> int:
    """Systems (warps) one CTA of the solve takes at ``f``: the
    ``batch_solve_systems_per_cta(f)`` of ``csrc/batch_solve.cu``."""
    return max(1, min(SOLVE_MAX_SYS, SOLVE_CTA_SMEM // solve_system_bytes(f)))


def _solve_smem(f: int) -> int:
    return solve_systems_per_cta(f) * solve_system_bytes(f)


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
        smem_limit=SMEM_BYTES, dim_bounds={"f": 128}, library="hermitian",
        source="herm_tile.cuh",
        note="csrc/herm_tile.cuh smem_bytes(f): chunk buffers or staged "
             "A_u/B_u; the split path's reduction stages f*(f+1) floats"),
    "herm_hbm_accum": KernelBudget(
        smem_limit=SMEM_BYTES, dim_bounds={"f": 128}, library="herm_hbm_accum",
        source="herm_tile.cuh",
        note="the Fig. 7 ablation: herm_tile.cuh's template, same launch"),
    "batch_solve": KernelBudget(
        smem_limit=SMEM_BYTES, dim_bounds={"f": 128}, library="batch_solve",
        source="batch_solve.cu",
        note="csrc/batch_solve.cu batch_solve_smem_bytes(f): "
             "solve_systems_per_cta(f) systems, each W's lower triangle in "
             "4x4 blocks with a float4 of padding a block-row"),
}
