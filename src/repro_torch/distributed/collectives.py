"""Topology-aware parallel reduction (paper §4.2) over the cells of a mesh.

The paper's one-phase scheme (Fig. 5a) — every GPU reduces 1/p of all
partial A matrices — is a **reduce-scatter**.  Its two-phase
topology-aware scheme (Fig. 5b) — reduce within a PCIe socket first, then
cross the slower inter-socket link with only partial results — is a
**hierarchical reduce-scatter**: scatter over the fast axis first, then
reduce over the slow axis with only the already-scattered 1/p-sized
slice.

The reference computes these with XLA collectives inside ``shard_map``.
Here one host program drives every cell, so each function takes the
cells' tensors as a list (cell ``c`` of a group at position ``c``; for a
two-level group, position ``s * n_fast + f`` for slow index s and fast
index f), sums in ascending cell order, and leaves each owner's slice on
that owner's device.  A slice that crosses cards is a peer copy; cells
that share a card exchange views.

Bytes over the slow link:  flat = (P-1)/P * |T|  per device,
hierarchical = |T| / p_fast per device — a p_fast-times reduction.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _sum_to(pieces: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``pieces[0] + pieces[1] + ...`` (a left fold in list order) on
    ``device``; the inputs are left as they were."""
    acc = pieces[0].to(device, copy=True)
    for piece in pieces[1:]:
        acc += piece.to(device)
    return acc


def reduce_scatter_flat(parts: Sequence[torch.Tensor],
                        scatter_axis: int = 0) -> list[torch.Tensor]:
    """One-phase parallel reduction (Fig. 5a): cell c receives chunk c of
    the sum of all cells' tensors, on its own device."""
    n_cells = len(parts)
    size = parts[0].shape[scatter_axis]
    if size % n_cells:
        raise ValueError(f"axis {scatter_axis} of size {size} does not split "
                         f"over {n_cells} cells")
    chunk = size // n_cells
    return [_sum_to([p.narrow(scatter_axis, c * chunk, chunk) for p in parts],
                    owner.device)
            for c, owner in enumerate(parts)]


def hierarchical_reduce_scatter(parts: Sequence[torch.Tensor], n_fast: int,
                                scatter_axis: int = 0) -> list[torch.Tensor]:
    """Two-phase topology-aware reduction (Fig. 5b) over cells ordered
    slow-major (``len(parts) // n_fast`` groups of ``n_fast``).

    Phase 1 (intra-socket): reduce-scatter within each fast group — cell
    (s, f) is left with chunk f of its group's sum.  Phase 2
    (inter-socket): all-reduce the scattered chunk over the slow axis —
    only |T|/n_fast bytes cross the slow link.  Every cell ends with
    chunk f of the total, replicated over the slow axis.
    """
    if len(parts) % n_fast:
        raise ValueError(f"{len(parts)} cells do not form groups of {n_fast}")
    n_slow = len(parts) // n_fast
    fast = [reduce_scatter_flat(parts[s * n_fast:(s + 1) * n_fast], scatter_axis)
            for s in range(n_slow)]
    if n_slow == 1:
        return fast[0]
    return [_sum_to([fast[s2][f] for s2 in range(n_slow)], fast[s][f].device)
            for s in range(n_slow) for f in range(n_fast)]


def two_level_reduce_scatter(parts: Sequence[torch.Tensor], n_fast: int,
                             scatter_axis: int = 0) -> list[torch.Tensor]:
    """Two-phase reduce-scatter down to 1/P of the total a cell, the
    reduction SU-ALS runs (Fig. 5b with a scattered slow phase): reduce-
    scatter within each fast group, then reduce-scatter each fast chunk
    over the slow axis.  Cells ordered slow-major as in
    :func:`hierarchical_reduce_scatter`; cell (s, f) is left with sub-slice
    s of chunk f.  :func:`hierarchical_reduce_scatter` (the reference's
    export) all-reduces the slow phase instead, replicating chunk f."""
    if len(parts) % n_fast:
        raise ValueError(f"{len(parts)} cells do not form groups of {n_fast}")
    n_slow = len(parts) // n_fast
    fast = [reduce_scatter_flat(parts[s * n_fast:(s + 1) * n_fast], scatter_axis)
            for s in range(n_slow)]
    slow = [reduce_scatter_flat([fast[s][f] for s in range(n_slow)], scatter_axis)
            for f in range(n_fast)]
    return [slow[f][s] for s in range(n_slow) for f in range(n_fast)]


def all_gather(parts: Sequence[torch.Tensor], axis: int = 0) -> list[torch.Tensor]:
    """The inverse of a reduce-scatter: every cell receives the cells'
    slices concatenated in cell order, on its own device (one tensor per
    distinct device, shared by the cells on it)."""
    out: dict[torch.device, torch.Tensor] = {}
    for p in parts:
        if p.device not in out:
            out[p.device] = torch.cat([q.to(p.device) for q in parts], dim=axis)
    return [out[p.device] for p in parts]


def all_reduce(parts: Sequence[torch.Tensor], dtype=None) -> list[torch.Tensor]:
    """The sum of one group's tensors (a left fold in list order, widened
    to at least float32) cast once to ``dtype`` (default: the inputs'),
    given to every cell on its own device (one tensor per distinct device,
    shared by the cells on it).  The inputs are left as they were."""
    wide = torch.promote_types(parts[0].dtype, torch.float32)
    total = _sum_to([p.to(wide) for p in parts], parts[0].device)
    total = total.to(dtype or parts[0].dtype)
    out: dict[torch.device, torch.Tensor] = {parts[0].device: total}
    for p in parts:
        if p.device not in out:
            out[p.device] = total.to(p.device)
    return [out[p.device] for p in parts]


def collective_bytes_reduce(nbytes: int, p_fast: int, p_slow: int) -> dict:
    """Analytic per-device traffic of both schemes for a |T| = nbytes tensor."""
    flat_fast = nbytes * (p_fast - 1) / p_fast
    # the flat scheme crosses the slow link with un-reduced full-size data:
    flat_slow = nbytes * (p_slow - 1) / p_slow if p_slow > 1 else 0.0
    hier_fast = nbytes * (p_fast - 1) / p_fast
    # two-phase: only the scattered slice crosses the slow link (ring allreduce)
    hier_slow = 2 * (nbytes / p_fast) * (p_slow - 1) / p_slow if p_slow > 1 else 0.0
    return {
        "flat": {"fast_link": flat_fast, "slow_link": flat_slow},
        "hierarchical": {"fast_link": hier_fast, "slow_link": hier_slow},
        "slow_link_saving": (flat_slow / hier_slow) if hier_slow else 1.0,
    }
