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

Inside :func:`counting` every collective here (and the exchanges that
flash-decode, the ring decode, the MoE, the loss, the replica gradient
sums and the pod sync make) counts itself: its kind, its per-cell result
bytes r, the mesh axes its group spans and the cells that take part; the
backward of a gather counts its reduce-scatter and the backward of a sum
its all-reduce, when autograd reaches them.  :func:`wire_bytes` prices a
record by the ring formulas the reference's ``parse_collectives`` uses.
Outside the context counting costs one ``None`` test a call.

Autograd runs through :func:`all_gather` and :func:`all_reduce` as they
are (``torch.cat``, ``Tensor.to`` and the in-place adds into
:func:`_sum_to`'s own copy are differentiable): the gradient of an
all-reduce's input is the sum of its outputs' gradients, and the gradient
of a gathered block is the sum of the slices of every cell's gradient that
used it — a reduce-scatter.  :func:`all_gather_over` is the ZeRO-3 gather
of the LM's FSDP layout built on it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Mapping, Optional, Sequence

import torch


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def wire_bytes(kind: str, r: float, g: int) -> float:
    """Bytes through each cell's links for one collective whose per-cell
    result is ``r`` bytes over a group of ``g`` cells, by the ring formulas
    (the reference's ``launch/dryrun.py`` ``parse_collectives``):
    all-gather r(g-1)/g, reduce-scatter r(g-1), all-reduce 2r(g-1)/g,
    all-to-all r(g-1)/g, collective-permute r."""
    if kind == "all-gather":
        return r * (g - 1) / g
    if kind == "reduce-scatter":
        return r * (g - 1)
    if kind == "all-reduce":
        return 2.0 * r * (g - 1) / g
    if kind == "all-to-all":
        return r * (g - 1) / g
    if kind == "collective-permute":
        return float(r)
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass(frozen=True)
class Record:
    """One collective: ``kind``, its per-cell result bytes ``r``, the mesh
    ``axes`` its group spans, the group's size ``g`` on the deployment and
    the ``cells`` of the counted program that took part."""
    kind: str
    r: float
    axes: tuple
    g: int
    cells: int


class Counter:
    """The records of one counted run over ``n_cells`` cells.  ``sizes``
    (axis -> size) gives a group's size from its axes: the deployment's,
    which may be larger than the counted mesh's (a unit run on a mesh whose
    data axes are cut to 1 counts the gathers over "data" at the
    deployment's group size).  Without it a group is the cells it names."""

    def __init__(self, n_cells: int, sizes: Optional[Mapping[str, int]] = None):
        self.n_cells, self.sizes = int(n_cells), dict(sizes or {})
        self.records: list[Record] = []

    def group_size(self, axes, cells: int) -> int:
        axes = _axes_of(axes)
        if axes and all(a in self.sizes for a in axes):
            return math.prod(self.sizes[a] for a in axes)
        return int(cells)

    def note(self, kind: str, r: float, axes=None, cells: int = 1, *,
             scatter_of: bool = False) -> None:
        """Count one collective; ``scatter_of``: ``r`` is the gathered
        whole, the per-cell result is r / g."""
        axes = _axes_of(axes)
        g = self.group_size(axes, cells)
        if g <= 1:
            return
        self.records.append(Record(kind, r / g if scatter_of else float(r), axes, g, int(cells)))

    def summary(self, mult: float = 1.0) -> dict:
        """Per cell, times ``mult``: the reference's ``{"bytes": {kind:
        wire bytes}, "count": {kind: n}, "total_bytes"}`` plus
        ``"bytes_by_axis"`` (a group over several axes under their names
        joined by "+").  A record weighs the share of the cells that took
        part."""
        by_kind: dict = {}
        count: dict = {}
        by_axis: dict = {}
        for rec in self.records:
            share = rec.cells / self.n_cells * mult
            w = wire_bytes(rec.kind, rec.r, rec.g) * share
            by_kind[rec.kind] = by_kind.get(rec.kind, 0.0) + w
            count[rec.kind] = count.get(rec.kind, 0.0) + share
            key = "+".join(rec.axes) or "cells"
            by_axis[key] = by_axis.get(key, 0.0) + w
        count = {k: int(round(v)) if abs(v - round(v)) < 1e-9 else v for k, v in count.items()}
        return {"bytes": by_kind, "count": count, "total_bytes": sum(by_kind.values()),
                "bytes_by_axis": by_axis}


_COUNTER: Optional[Counter] = None


def _axes_of(axes) -> tuple:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    out: tuple = ()
    for a in axes:
        out += _axes_of(a)
    return out


@contextlib.contextmanager
def counting(n_cells: int, sizes: Optional[Mapping[str, int]] = None):
    """Count every collective run inside (see the module docstring): yields
    the :class:`Counter`.  Contexts nest; the innermost counts."""
    global _COUNTER
    prev, _COUNTER = _COUNTER, Counter(n_cells, sizes)
    try:
        yield _COUNTER
    finally:
        _COUNTER = prev


def counting_active() -> bool:
    """Whether a :func:`counting` context is open (for callers whose count
    takes work of its own to compute)."""
    return _COUNTER is not None


def note(kind: str, r: float, axes=None, cells: int = 1) -> None:
    """Count one collective in the open :func:`counting` context, if any."""
    if _COUNTER is not None:
        _COUNTER.note(kind, r, axes, cells)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _note_with_backward(t: torch.Tensor, kind: str, back: str, axes, cells: int) -> None:
    """Count ``kind`` with result ``t`` and, once autograd reaches ``t``,
    its backward ``back`` (a reduce-scatter of a gather: its result the
    gathered whole over g; an all-reduce of a sum: the same bytes)."""
    ctr = _COUNTER
    if ctr is None:
        return
    r = _nbytes(t)
    ctr.note(kind, r, axes, cells)
    if t.requires_grad and torch.is_grad_enabled():
        t.register_hook(lambda _: ctr.note(back, r, axes, cells,
                                           scatter_of=back == "reduce-scatter"))


def _sum_to(pieces: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``pieces[0] + pieces[1] + ...`` (a left fold in list order) on
    ``device``; the inputs are left as they were."""
    acc = pieces[0].to(device, copy=True)
    for piece in pieces[1:]:
        acc += piece.to(device)
    return acc


def reduce_scatter_flat(parts: Sequence[torch.Tensor],
                        scatter_axis: int = 0, axes=None) -> list[torch.Tensor]:
    """One-phase parallel reduction (Fig. 5a): cell c receives chunk c of
    the sum of all cells' tensors, on its own device.  ``axes``: the mesh
    axes the cells span (for :func:`counting`)."""
    n_cells = len(parts)
    size = parts[0].shape[scatter_axis]
    if size % n_cells:
        raise ValueError(f"axis {scatter_axis} of size {size} does not split "
                         f"over {n_cells} cells")
    chunk = size // n_cells
    note("reduce-scatter", _nbytes(parts[0]) // n_cells, axes, n_cells)
    return [_sum_to([p.narrow(scatter_axis, c * chunk, chunk) for p in parts],
                    owner.device)
            for c, owner in enumerate(parts)]


def hierarchical_reduce_scatter(parts: Sequence[torch.Tensor], n_fast: int,
                                scatter_axis: int = 0, fast_axes=None,
                                slow_axes=None) -> list[torch.Tensor]:
    """Two-phase topology-aware reduction (Fig. 5b) over cells ordered
    slow-major (``len(parts) // n_fast`` groups of ``n_fast``).

    Phase 1 (intra-socket): reduce-scatter within each fast group — cell
    (s, f) is left with chunk f of its group's sum.  Phase 2
    (inter-socket): all-reduce the scattered chunk over the slow axis —
    only |T|/n_fast bytes cross the slow link.  Every cell ends with
    chunk f of the total, replicated over the slow axis.  ``fast_axes`` /
    ``slow_axes``: the mesh axes of each phase (for :func:`counting`).
    """
    if len(parts) % n_fast:
        raise ValueError(f"{len(parts)} cells do not form groups of {n_fast}")
    n_slow = len(parts) // n_fast
    fast = [reduce_scatter_flat(parts[s * n_fast:(s + 1) * n_fast], scatter_axis, fast_axes)
            for s in range(n_slow)]
    if n_slow == 1:
        return fast[0]
    for f in range(n_fast):
        note("all-reduce", _nbytes(fast[0][f]), slow_axes, n_slow)
    return [_sum_to([fast[s2][f] for s2 in range(n_slow)], fast[s][f].device)
            for s in range(n_slow) for f in range(n_fast)]


def two_level_reduce_scatter(parts: Sequence[torch.Tensor], n_fast: int,
                             scatter_axis: int = 0, fast_axes=None,
                             slow_axes=None) -> list[torch.Tensor]:
    """Two-phase reduce-scatter down to 1/P of the total a cell, the
    reduction SU-ALS runs (Fig. 5b with a scattered slow phase): reduce-
    scatter within each fast group, then reduce-scatter each fast chunk
    over the slow axis.  Cells ordered slow-major as in
    :func:`hierarchical_reduce_scatter`; cell (s, f) is left with sub-slice
    s of chunk f.  :func:`hierarchical_reduce_scatter` (the reference's
    export) all-reduces the slow phase instead, replicating chunk f.
    ``fast_axes`` / ``slow_axes`` as there."""
    if len(parts) % n_fast:
        raise ValueError(f"{len(parts)} cells do not form groups of {n_fast}")
    n_slow = len(parts) // n_fast
    fast = [reduce_scatter_flat(parts[s * n_fast:(s + 1) * n_fast], scatter_axis, fast_axes)
            for s in range(n_slow)]
    slow = [reduce_scatter_flat([fast[s][f] for s in range(n_slow)], scatter_axis, slow_axes)
            for f in range(n_fast)]
    return [slow[f][s] for s in range(n_slow) for f in range(n_fast)]


def all_gather(parts: Sequence[torch.Tensor], axis: int = 0, axes=None) -> list[torch.Tensor]:
    """The inverse of a reduce-scatter: every cell receives the cells'
    slices concatenated in cell order, on its own device (one tensor per
    distinct device, shared by the cells on it).  ``axes``: the mesh axes
    the cells span (for :func:`counting`)."""
    out = _gather(parts, axis)
    _note_with_backward(out[0], "all-gather", "reduce-scatter", axes, len(parts))
    return out


def _gather(parts: Sequence[torch.Tensor], axis: int) -> list[torch.Tensor]:
    out: dict[torch.device, torch.Tensor] = {}
    for p in parts:
        if p.device not in out:
            out[p.device] = torch.cat([q.to(p.device) for q in parts], dim=axis)
    return [out[p.device] for p in parts]


def all_gather_over(parts: Sequence[torch.Tensor], mesh, axes, dim: int) -> list[torch.Tensor]:
    """Every cell's block gathered along ``dim`` over the mesh axes ``axes``
    (a spec entry: its blocks in that entry's order, the major axis first).
    ``parts[c]`` is cell c's block (cells in row-major order); each cell
    gets its group's blocks concatenated, one tensor per distinct device
    and group of blocks, shared by the cells that have both.  Its backward
    is the reduce-scatter: each block's gradient is the sum of the
    matching slices of the gradients of every cell that used the gathered
    tensor.  With no axes the blocks are returned as they are."""
    from repro_torch.distributed.sharding import groups_over

    out = list(parts)
    if axes is None or axes == ():
        return out
    shared: dict = {}             # groups of the same blocks share one gather
    for g in groups_over(mesh, axes):
        shared.setdefault(tuple(id(parts[c]) for c in g), []).append(g)
    for gs in shared.values():
        res = _gather([parts[c] for c in gs[0]], axis=dim)
        _note_with_backward(res[0], "all-gather", "reduce-scatter", axes,
                            sum(len(g) for g in gs))
        for g in gs:
            for c, t in zip(g, res):
                out[c] = t
    return out


def all_gather_dims(leaf, dims, li: Optional[int] = None) -> list[torch.Tensor]:
    """Each cell's block of a ``sharding.Sharded`` leaf (layer ``li`` of a
    layer-stacked leaf: dims count from the stacked shape) with ``dims``
    gathered over the axes that split them (:func:`all_gather_over`)."""
    parts = leaf.cells
    if li is not None:                 # one view a distinct tensor
        views: dict = {}
        for t in parts:
            if id(t) not in views:
                views[id(t)] = t[li]
        parts = [views[id(t)] for t in parts]
    off = 0 if li is None else 1
    for d in sorted(dims):
        parts = all_gather_over(parts, leaf.mesh, leaf.spec[d], d - off)
    return list(parts)


def all_reduce(parts: Sequence[torch.Tensor], dtype=None, *, axes=None,
               count: bool = True) -> list[torch.Tensor]:
    """The sum of one group's tensors (a left fold in list order, widened
    to at least float32) cast once to ``dtype`` (default: the inputs'),
    given to every cell on its own device (one tensor per distinct device,
    shared by the cells on it).  The inputs are left as they were.
    ``axes``: the mesh axes the cells span; ``count=False``: the caller
    counts it (for :func:`counting`)."""
    wide = torch.promote_types(parts[0].dtype, torch.float32)
    total = _sum_to([p.to(wide) for p in parts], parts[0].device)
    total = total.to(dtype or parts[0].dtype)
    if count:
        _note_with_backward(total, "all-reduce", "all-reduce", axes, len(parts))
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
