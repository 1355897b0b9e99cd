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
that share a card exchange views.  A caller that gives up its parts
(``donate``, as SU-ALS does with its partial Hermitians) has each owner's
slice built in place in its own part, and the slices that cross cards
streamed in slabs over copy streams, every direction at once
(:func:`_fold_donated`); the sums are the same, bit for bit.

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

Every run, counted or not, also adds each collective to the process
registry (``obs.metrics``): ``collective/<kind>/calls`` and
``collective/<kind>/bytes`` (``reduce_scatter``, ``all_gather``,
``all_reduce``, ...), the bytes each cell receives from the others by the
same ring formulas over the cells that took part, summed over those cells.
A reduce-scatter of a ``|T|``-byte tensor over g cells counts ``(g - 1)
|T|``: each cell receives every other cell's part of its own chunk.  Of
those, ``collective/reduce_scatter/streamed_bytes`` counts the bytes that
the copy streams of a donated reduction delivered.

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
import itertools
import math
from typing import Mapping, Optional, Sequence

import torch

from repro_torch.obs.metrics import process_registry


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


def _tally(kind: str, r: float, cells: int) -> None:
    """One collective in the process registry (module docstring): its
    calls, and the bytes its ``cells`` receive, each a result of ``r``
    bytes, by :func:`wire_bytes` over the cells as one group."""
    if cells <= 1:
        return
    reg, key = process_registry(), kind.replace("-", "_")
    reg.counter(f"collective/{key}/calls").inc()
    reg.counter(f"collective/{key}/bytes").inc(wire_bytes(kind, r, cells) * cells)


def note(kind: str, r: float, axes=None, cells: int = 1) -> None:
    """Count one collective in the process registry and in the open
    :func:`counting` context, if any."""
    _tally(kind, r, cells)
    if _COUNTER is not None:
        _COUNTER.note(kind, r, axes, cells)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _note_with_backward(t: torch.Tensor, kind: str, back: str, axes, cells: int) -> None:
    """Count ``kind`` with result ``t`` and, once autograd reaches ``t``,
    its backward ``back`` (a reduce-scatter of a gather: its result the
    gathered whole over g; an all-reduce of a sum: the same bytes)."""
    r = _nbytes(t)
    _tally(kind, r, cells)
    ctr = _COUNTER
    if ctr is None:
        return
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


def _fold_into(pieces: Sequence[torch.Tensor], k: int) -> torch.Tensor:
    """``pieces[k]`` made, in place, the left fold of ``pieces`` in list
    order, bit for bit :func:`_sum_to`'s (a float sum of two terms is the
    same either way round): the terms before it summed first (one term
    as it is, more in a staging buffer), then each later one added.  The
    other pieces are left as they were."""
    own, dev = pieces[k], pieces[k].device
    if k:
        own += pieces[0].to(dev) if k == 1 else _sum_to(pieces[:k], dev)
    for piece in pieces[k + 1:]:
        own += piece.to(dev)
    return own


#: bytes of one slab of a chunk streamed between cards: the owner adds
#: slab i while slab i + 1 lands.  At NVLink's rate a slab keeps a copy
#: engine busy for about 0.6 ms, long beside the host's cost of issuing
#: it; the last slab's add, about 0.3 ms, is what a phase does not hide.
SLAB_BYTES = 256 << 20
#: slabs of each peer's chunk an owner's receive buffer holds
SLAB_DEPTH = 2

#: the copy streams of each direction between two cards, made once a
#: process (``torch.cuda.Stream`` hands out a fixed pool in turn, so
#: streams made a call would come round to other work's)
_LINKS: dict = {}


def _link(src: torch.device, dst: torch.device) -> tuple:
    """The copy streams of the direction ``src`` -> ``dst``: the copy runs
    on the first, on ``src``; the second, on ``dst``, runs nothing and is
    current there while a copy is issued.  PyTorch fences a copy between
    cards against both cards' current streams, so these two tie each
    direction to no other work of either card."""
    key = (src.index, dst.index)
    if key not in _LINKS:
        _LINKS[key] = (torch.cuda.Stream(src), torch.cuda.Stream(dst))
    return _LINKS[key]


def _fold_donated(jobs: Sequence[tuple], axis: int) -> list[torch.Tensor]:
    """Folds each job ``(pieces, k)`` into its owner's chunk ``pieces[k]``
    in place (:func:`_fold_into`) and returns the owners' chunks: where
    every piece is on the owner's device, in one go; where some lie on
    other CUDA cards, streamed along ``axis`` (:func:`_stream_folds`)."""
    streamed = []
    for pieces, k in jobs:
        own = pieces[k]
        far = [j for j, p in enumerate(pieces)
               if p.device != own.device and p.device.type == own.device.type == "cuda"]
        if far:
            streamed.append(_Fold(pieces, k, far, axis))
        else:
            _fold_into(pieces, k)
    if streamed:
        _stream_folds(streamed, axis)
    return [pieces[k] for pieces, k in jobs]


def _head(t: torch.Tensor, axis: int, m: int) -> torch.Tensor:
    """The first ``m`` rows of ``t`` along ``axis`` (``t`` itself if all)."""
    return t if t.shape[axis] == m else t.narrow(axis, 0, m)


class _Fold:
    """One owner's chunk ``pieces[k]`` in :func:`_stream_folds`: the
    positions ``far`` of the pieces on other cards, its slabs (start,
    rows) of :data:`SLAB_BYTES` along the axis, and for each of the
    :data:`SLAB_DEPTH` slots of its receive buffer a slab of each far
    piece, the events of their copies and the event of the fold that
    last read the slot."""

    def __init__(self, pieces: Sequence[torch.Tensor], k: int, far: list, axis: int):
        own = pieces[k]
        self.pieces, self.k, self.far = pieces, k, far
        n = own.shape[axis]
        step = max(1, SLAB_BYTES * n // max(_nbytes(own), 1))
        self.slabs = [(lo, min(step, n - lo)) for lo in range(0, n, step)]
        shape = list(own.shape)
        shape[axis] = min(step, n)
        bufs = own.new_empty((SLAB_DEPTH, len(far), *shape)).unbind(0) if n else ()
        self.slots = [buf.unbind(0) for buf in bufs]
        self.landed = [[torch.cuda.Event() for _ in far] for _ in bufs]
        self.freed = [torch.cuda.Event() for _ in bufs]


def _stream_folds(folds: Sequence[_Fold], axis: int) -> None:
    """The folds whose pieces lie on other cards, slab by slab: a far
    piece's slabs come over its direction's copy streams (:func:`_link`)
    into the owner's receive buffer, and the owner folds slab i on its
    current stream while slab i + 1 lands.  Every fold's copies of a slab
    are issued before the folds of the slab before it, so both directions
    of every pair move at once.  Only events order the work: a copy waits
    for its sender's and its owner's current streams as they were once
    the buffers were made, and for the fold that last read its slot (an
    event not yet recorded is no wait); a fold waits for its slabs to
    land.  Before it returns, both cards' current streams of every
    direction wait for its copies, so the pieces' memory, held until
    then, is not handed on while a copy reads it."""
    links = {(f.pieces[j].device, f.pieces[f.k].device) for f in folds for j in f.far}
    cur = {}
    for dev in {d for link in links for d in link}:
        cur[dev] = torch.cuda.current_stream(dev)
        ready = torch.cuda.Event()
        ready.record(cur[dev])
        for src, dst in links:
            if dev in (src, dst):
                _link(src, dst)[0].wait_event(ready)

    def receive(fold: _Fold, i: int) -> None:
        lo, m = fold.slabs[i]
        dst, slot = fold.pieces[fold.k].device, i % SLAB_DEPTH
        for r, j in enumerate(fold.far):
            src = fold.pieces[j]
            send, recv = _link(src.device, dst)
            send.wait_event(fold.freed[slot])
            # each card's copy stream current while the copy is issued
            torch.cuda.set_stream(send)
            torch.cuda.set_stream(recv)
            _head(fold.slots[slot][r], axis, m).copy_(src.narrow(axis, lo, m))
            torch.cuda.set_stream(cur[dst])
            torch.cuda.set_stream(cur[src.device])
            fold.landed[slot][r].record(send)

    def fold_slab(fold: _Fold, i: int) -> None:
        lo, m = fold.slabs[i]
        slot = i % SLAB_DEPTH
        stream = cur[fold.pieces[fold.k].device]
        terms = [p.narrow(axis, lo, m) if j not in fold.far else None
                 for j, p in enumerate(fold.pieces)]
        for r, j in enumerate(fold.far):
            stream.wait_event(fold.landed[slot][r])
            terms[j] = _head(fold.slots[slot][r], axis, m)
        _fold_into(terms, fold.k)
        fold.freed[slot].record(stream)

    ahead = SLAB_DEPTH - 1
    # set_stream makes the stream's card the current device: restore it
    with torch.cuda.device(torch.cuda.current_device()):
        for f in folds:
            for i in range(min(ahead, len(f.slabs))):
                receive(f, i)
        for i in range(max(len(f.slabs) for f in folds)):
            for f in folds:
                if i + ahead < len(f.slabs):
                    receive(f, i + ahead)
            for f in folds:
                if i < len(f.slabs):
                    fold_slab(f, i)
    for src, dst in links:
        send = _link(src, dst)[0]
        cur[src].wait_stream(send)
        cur[dst].wait_stream(send)
    process_registry().counter("collective/reduce_scatter/streamed_bytes").inc(
        sum(len(f.far) * _nbytes(f.pieces[f.k]) for f in folds))


def _chunks(size: int, n_cells: int, ragged: bool) -> list[tuple[int, int]]:
    """(start, length) of each cell's chunk of ``size`` rows: equal chunks,
    or with ``ragged`` chunks of ``ceil(size / n_cells)`` rows, the last
    ones short (or empty)."""
    if not ragged and size % n_cells:
        raise ValueError(f"an axis of size {size} does not split over {n_cells} cells")
    step = -(-size // n_cells)
    return [(min(c * step, size), min(step, max(size - c * step, 0))) for c in range(n_cells)]


def reduce_scatter_flat(parts: Sequence[torch.Tensor], scatter_axis: int = 0, axes=None,
                        *, ragged: bool = False, donate: bool = False) -> list[torch.Tensor]:
    """One-phase parallel reduction (Fig. 5a): cell c receives chunk c of
    the sum of all cells' tensors, on its own device.  ``axes``: the mesh
    axes the cells span (for :func:`counting`).  The axis must split evenly
    over the cells unless ``ragged`` (:func:`_chunks`).  ``donate``: the
    parts are the caller's to give up (distinct tensors, read by nothing
    else until this returns); cell c's chunk of the sum is then built in
    place in its own part, which it returns a view of, streamed between
    cards (:func:`_fold_donated`), bit for bit the sum made without."""
    return _reduce_scatter([parts], scatter_axis, axes, ragged, donate)[0]


def _reduce_scatter(groups: Sequence[Sequence[torch.Tensor]], scatter_axis: int, axes,
                    ragged: bool, donate: bool) -> list[list[torch.Tensor]]:
    """:func:`reduce_scatter_flat` of each group; donated groups' chunks
    folded together, so that every group's copies move at once."""
    jobs = []
    for parts in groups:
        n_cells = len(parts)
        chunks = _chunks(parts[0].shape[scatter_axis], n_cells, ragged)
        note("reduce-scatter", _nbytes(parts[0]) / n_cells, axes, n_cells)
        jobs += [([p.narrow(scatter_axis, lo, n) for p in parts], c)
                 for c, (lo, n) in enumerate(chunks)]
    if donate:
        out = _fold_donated(jobs, scatter_axis)
    else:
        out = [_sum_to(pieces, pieces[c].device) for pieces, c in jobs]
    ends = itertools.accumulate(len(parts) for parts in groups)
    return [out[end - len(parts):end] for parts, end in zip(groups, ends)]


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
                             slow_axes=None, *, ragged: bool = False,
                             phase=None, donate: bool = False) -> list[torch.Tensor]:
    """Two-phase reduce-scatter down to 1/P of the total a cell, the
    reduction SU-ALS runs (Fig. 5b with a scattered slow phase): reduce-
    scatter within each fast group, then reduce-scatter each fast chunk
    over the slow axis.  Cells ordered slow-major as in
    :func:`hierarchical_reduce_scatter`; cell (s, f) is left with sub-slice
    s of chunk f.  :func:`hierarchical_reduce_scatter` (the reference's
    export) all-reduces the slow phase instead, replicating chunk f.
    ``fast_axes`` / ``slow_axes`` as there; ``ragged`` as in
    :func:`reduce_scatter_flat`, in both phases.  ``phase(name, nbytes)``,
    where given, is the context each phase runs in (``"fast"``, then
    ``"slow"``), with the bytes the phase's cells receive, summed over
    them; a donated phase's copies have all landed in it.  ``donate`` as
    in :func:`reduce_scatter_flat`: cell (s, f)'s sub-slice is built in
    place in its own part, the slow phase folding into the fast phase's
    chunks, every group of a phase at once."""
    if len(parts) % n_fast:
        raise ValueError(f"{len(parts)} cells do not form groups of {n_fast}")
    n_slow = len(parts) // n_fast
    total = _nbytes(parts[0])
    with contextlib.nullcontext() if phase is None else phase("fast", n_slow * (n_fast - 1) * total):
        fast = _reduce_scatter([parts[s * n_fast:(s + 1) * n_fast] for s in range(n_slow)],
                               scatter_axis, fast_axes, ragged, donate)
    with contextlib.nullcontext() if phase is None else phase("slow", (n_slow - 1) * total):
        slow = _reduce_scatter([[fast[s][f] for s in range(n_slow)] for f in range(n_fast)],
                               scatter_axis, slow_axes, ragged, donate)
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
